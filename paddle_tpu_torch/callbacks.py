"""paddle.callbacks namespace of the port (reference:
python/paddle/callbacks.py — re-exports the hapi callback family)."""
from .hapi.callbacks import (Callback, CallbackList,  # noqa: F401
                             EarlyStopping, LRScheduler, ModelCheckpoint,
                             ProgBarLogger)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping"]
