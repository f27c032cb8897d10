"""The train step of the port (counterpart of paddle_tpu.parallel), on
one GPU."""
from .fused_optimizer import FusedOptimizer  # noqa: F401
from .trainer import (AdamWState, adamw_update,  # noqa: F401
                      init_adamw_state, make_train_step)
