"""The training and communication layer of the port (counterpart of
paddle_tpu.parallel): the train step on one GPU or over a data-parallel
mesh of ranks (`make_train_step(mesh=)`, `DataParallel`), the ranks and
their process groups (`ranks`, `mesh`, `env`), the collectives as graph
operators and the quantized wire (`collectives`), Paddle's collective API
on torch tensors (`collective`) and the sharded checkpoint
(`checkpoint`)."""
from .checkpoint import Shard, load_state_dict, save_state_dict  # noqa
from .collectives import quantized_psum_tree  # noqa: F401
from .data_parallel import DataParallel, scale_batch  # noqa: F401
from .env import ParallelEnv, get_rank, get_world_size  # noqa: F401
from .fused_optimizer import FusedOptimizer  # noqa: F401
from .mesh import (HybridCommunicateGroup, build_mesh,  # noqa: F401
                   get_global_mesh, set_global_mesh)
from .trainer import (AdamWState, adamw_update,  # noqa: F401
                      init_adamw_state, make_train_step)
