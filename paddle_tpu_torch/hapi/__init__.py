"""paddle.hapi of the port (counterpart of paddle_tpu/hapi; reference:
python/paddle/hapi — the Model trainer, its callbacks and summary). The
JAX package's `flops` traces a jaxpr and is not ported (ROADMAP.md
section 1 item 6)."""
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
)
from .model import Model, summary  # noqa: F401
