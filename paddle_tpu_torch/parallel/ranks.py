"""The serving ranks' process model: one process per rank under
torch.distributed, SPMD (the JAX package runs one controller over a
``cp x mp`` mesh instead, paddle_tpu/parallel/mesh.py `serving_mesh`).

- Rank layout: rank = c * mp + m. The mp group of rank r holds the ranks
  of its c, the cp group those of its m (`serving_groups`).
- Device: rank r takes ``cuda:(r % torch.cuda.device_count())``, or the
  CPU when asked (`rank_device`).
- Backend rule (`backend_for`), decided when the group is made, never a
  fallback: NCCL where every rank has a GPU of its own, gloo where ranks
  share a GPU or run on the CPU. NCCL refuses two ranks on one GPU; gloo
  runs the engine's programs eagerly, since a gloo collective cannot be
  captured in a CUDA graph.

`init_ranks` reads the rendezvous the launcher exports (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``; see
`parallel.launch.main`) and initializes the default group; a failing
init raises.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["backend_for", "rank_device", "init_ranks", "serving_groups"]

LAUNCHER = "python -m paddle_tpu_torch.parallel.launch --nproc_per_node N"


def backend_for(world_size: int, device) -> str:
    """'nccl' when every one of `world_size` ranks has a GPU of its own,
    else 'gloo' (ranks on the CPU, or several ranks sharing a GPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def rank_device(rank: int, device=None) -> torch.device:
    """Rank `rank`'s device: the CPU when `device` names it, else
    ``cuda:(rank % device_count)``."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "serving ranks run on CUDA devices by default and "
            "torch.cuda.is_available() is False; pass device='cpu' for "
            "ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_ranks(device=None, backend: Optional[str] = None,
               timeout_s: float = 600.0):
    """Initialize the default process group from the launcher's
    environment. Returns (rank, world_size, device); the device is made
    current for CUDA ranks."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = backend_for(world, dev)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return rank, world, dev


# the groups made over the current default group: {(mp, cp): (mp group,
# cp group)}, dropped when the default group is replaced; every rank makes
# every group in the same order, as new_group requires
_GROUPS = {"world": None, "groups": {}}


def serving_groups(mp: int, cp: int):
    """This rank's (mp group, cp group) of a ``cp x mp`` layout over the
    default group (which must hold exactly mp * cp ranks)."""
    world = dist.group.WORLD
    if _GROUPS["world"] is not world:
        _GROUPS["world"], _GROUPS["groups"] = world, {}
    key = (int(mp), int(cp))
    if key not in _GROUPS["groups"]:
        rank = dist.get_rank()
        mp_group = cp_group = None
        for c in range(cp):
            g = dist.new_group([c * mp + m for m in range(mp)])
            if rank // mp == c:
                mp_group = g
        for m in range(mp):
            g = dist.new_group([c * mp + m for c in range(cp)])
            if rank % mp == m:
                cp_group = g
        _GROUPS["groups"][key] = (mp_group, cp_group)
    return _GROUPS["groups"][key]
