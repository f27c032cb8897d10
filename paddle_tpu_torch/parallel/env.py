"""The distributed environment (counterpart of paddle_tpu/parallel/env.py;
Paddle's ``paddle.distributed.parallel.ParallelEnv``).

One process a rank under torch.distributed: `get_rank` / `get_world_size`
read the default process group when one is initialized, and else the
launcher's environment (``RANK`` / ``WORLD_SIZE``, as
``parallel.launch`` exports them), then Paddle's (``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM``), as the JAX functions fall back to Paddle's
variables when JAX has no process index.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["ParallelEnv", "get_rank", "get_world_size"]


def _env_int(names, default: int) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def get_rank(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return _env_int(("RANK", "PADDLE_TRAINER_ID"), 0)


def get_world_size(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return _env_int(("WORLD_SIZE", "PADDLE_TRAINERS_NUM"), 1)


class ParallelEnv:
    """Paddle's ParallelEnv over the process model above."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def local_rank(self) -> int:
        return _env_int(("LOCAL_RANK", "PADDLE_LOCAL_RANK"), get_rank())

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def device_id(self) -> int:
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else 0

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                              "127.0.0.1:6170").split(",")

