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

Group references: a collective operator's schema cannot take a
``ProcessGroup``, so the collectives (`parallel.collectives`) name their
group by a `GroupRef`: a registry key (``"<axis>@<ranks>"``, e.g.
``"mp@0,1"``), the group's size and this rank's index in it. The key
resolves to a live group through `resolve_group` (a missing group
raises); the size alone shapes a traced program, so a program can be
traced with no live process group at all (`traced_rank`, the tuner's
sharded candidates).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["GroupRef", "backend_for", "group_ref", "init_ranks",
           "rank_device", "register_group", "resolve_group",
           "serving_group_keys", "serving_groups", "traced_rank",
           "tracing_rank"]

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


@dataclasses.dataclass(frozen=True)
class GroupRef:
    """A process group as a collective operator names it: the registry
    `key` (``"<axis>@<ranks>"``), the group's `size` and this rank's
    index in it (`rank`)."""

    key: str
    size: int
    rank: int = 0


def ranks_key(axis: str, ranks: Sequence[int]) -> str:
    return f"{axis}@" + ",".join(str(int(r)) for r in ranks)


# the registry: key -> ProcessGroup over the current default group,
# dropped when the default group is replaced
_REGISTRY = {"world": None, "groups": {}}
# the rank a program is traced as with no live group (`traced_rank`)
_TRACED = {"rank": None}


def _registry() -> dict:
    world = dist.group.WORLD if dist.is_initialized() else None
    if _REGISTRY["world"] is not world:
        _REGISTRY["world"], _REGISTRY["groups"] = world, {}
    return _REGISTRY["groups"]


def register_group(axis: str, ranks: Sequence[int], group) -> GroupRef:
    """Register `group` (over the default group's `ranks`) under the key
    ``axis@ranks``; returns this rank's reference to it."""
    key = ranks_key(axis, ranks)
    _registry()[key] = group
    me = dist.get_rank() if dist.is_initialized() else 0
    idx = list(ranks).index(me) if me in ranks else 0
    return GroupRef(key, len(ranks), idx)


def resolve_group(key: str):
    """The live ProcessGroup a key names; raises when none is registered
    (a collective never falls back to another group or to no exchange)."""
    if key == "world" and dist.is_initialized():
        return dist.group.WORLD
    group = _registry().get(key) if dist.is_initialized() else None
    if group is None:
        raise RuntimeError(
            f"collective over process group {key!r}, which is not "
            "registered on this rank: start the ranks with "
            f"`{LAUNCHER} script.py`, call init_ranks() and build the "
            "groups (serving_groups, parallel.mesh.build_mesh) first")
    return group


def group_ref(group=None, axis: str = "group") -> GroupRef:
    """A GroupRef for `group`: a GroupRef passes through; None is the
    default group (key "world"); a ProcessGroup is registered under its
    ranks (`axis` names it)."""
    if isinstance(group, GroupRef):
        return group
    if not dist.is_initialized():
        raise RuntimeError(
            "a collective needs an initialized default process group: "
            f"start the ranks with `{LAUNCHER} script.py` and call "
            "init_ranks() (or torch.distributed.init_process_group)")
    if group is None or group is dist.group.WORLD:
        return GroupRef("world", dist.get_world_size(), dist.get_rank())
    ranks = dist.get_process_group_ranks(group)
    return register_group(axis, ranks, group)


def tracing_rank() -> Optional[int]:
    """The rank `traced_rank` stands in for, or None."""
    return _TRACED["rank"]


@contextlib.contextmanager
def traced_rank(rank: int = 0):
    """Build sharded programs as `rank` with no live process group: a
    ServingTP binds to the group keys that rank would hold and registers
    nothing, so its programs can be traced (fake tensors) but a real
    collective raises. The tuner scores sharded candidates so."""
    prev = _TRACED["rank"]
    _TRACED["rank"] = int(rank)
    try:
        yield
    finally:
        _TRACED["rank"] = prev


def serving_groups(mp: int, cp: int):
    """This rank's (mp group, cp group) of a ``cp x mp`` layout over the
    default group (which must hold exactly mp * cp ranks), registered
    under ``mp@<ranks>`` and ``cp@<ranks>`` (`serving_group_keys`)."""
    world = dist.group.WORLD
    if _GROUPS["world"] is not world:
        _GROUPS["world"], _GROUPS["groups"] = world, {}
    key = (int(mp), int(cp))
    if key not in _GROUPS["groups"]:
        rank = dist.get_rank()
        mp_group = cp_group = None
        for c in range(cp):
            ranks = [c * mp + m for m in range(mp)]
            g = dist.new_group(ranks)
            if rank // mp == c:
                mp_group = g
                register_group("mp", ranks, g)
        for m in range(mp):
            ranks = [c * mp + m for c in range(cp)]
            g = dist.new_group(ranks)
            if rank % mp == m:
                cp_group = g
                register_group("cp", ranks, g)
        _GROUPS["groups"][key] = (mp_group, cp_group)
    return _GROUPS["groups"][key]


def serving_group_keys(mp: int, cp: int, rank: int):
    """(mp GroupRef, cp GroupRef) of rank `rank` in a ``cp x mp`` layout
    (rank = c * mp + m): what `serving_groups` registers, computed with no
    process group."""
    c, m = rank // mp, rank % mp
    mp_ranks = [c * mp + j for j in range(mp)]
    cp_ranks = [i * mp + m for i in range(cp)]
    return (GroupRef(ranks_key("mp", mp_ranks), mp, m),
            GroupRef(ranks_key("cp", cp_ranks), cp, c))
