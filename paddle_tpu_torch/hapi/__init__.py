"""paddle.hapi of the port (counterpart of paddle_tpu/hapi; reference:
python/paddle/hapi — the Model trainer, its callbacks, summary and
flops)."""
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
)
from .flops import flops  # noqa: F401
from .model import Model, summary  # noqa: F401
