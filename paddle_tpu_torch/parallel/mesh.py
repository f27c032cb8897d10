"""The hybrid-parallel topology (counterpart of paddle_tpu/parallel/mesh.py;
Paddle's ``HybridCommunicateGroup``, fleet/base/topology.py).

The JAX package's mesh is one ``jax.sharding.Mesh`` of named axes over a
single controller's devices. Here a `Mesh` is a set of process groups, one
per axis, over the default group's ranks (one process a rank): rank r's
coordinates are r's row-major digits over the axis sizes, and the group of
axis a holds the ranks that differ from r in a alone. Each group is
registered under ``"<axis>@<ranks>"`` (`parallel.ranks.register_group`),
so the collectives and the communication audit name it by its axis.

Every axis may exceed 1: ``dp``, ``pp`` (pipeline), ``sharding``
(ZeRO), ``sep`` (sequence and context parallel) and ``mp``
(tensor-parallel), and axes of other names (`make_train_step(mesh=)`,
`DataParallel`, ``hapi.Model.fit`` over dp, ``shard_llama``,
``models.llama_pipe.make_llama_pp_train_step`` and
`parallel.pipeline_spmd` over pp, `parallel.sequence_parallel`,
`parallel.ulysses` and `parallel.ring_attention` over sep). The ranks
take their coordinates in the JAX package's device order
(`HYBRID_AXES`, row-major), so pp stage s of rank r is the stage JAX's
device r runs; a rank's pp group holds the stages in order, and
`pp_neighbours` names the ranks before and after it.
Beside the one-axis groups, every set of two or more of the summed axes
(`SUM_AXES`: ``dp``, ``sharding`` and ``sep``, those above 1) gets one
group of its own, registered as ``"<a>+<b>@<ranks>"`` (``"dp+sharding"``,
``"dp+sep"``, ``"sharding+sep"``, ``"dp+sharding+sep"``): a batch's rows
split over dp and sharding and its tokens over sep, while every
parameter is replicated over sep, so the loss and the gradients of what
those axes replicate are summed over them together.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

from .ranks import GroupRef, ranks_key, register_group

__all__ = [
    "BATCH_AXES", "CP_AXIS", "HYBRID_AXES", "HybridCommunicateGroup",
    "HybridParallelInfo", "MP_AXIS", "Mesh", "PP_AXIS", "SEP_AXIS",
    "SUM_AXES", "auto_mesh", "build_mesh", "divisible_prefix",
    "get_global_mesh", "set_global_mesh",
]

# the reference's ["data", "pipe", "sharding", "sep", "model"] order
HYBRID_AXES = ("dp", "pp", "sharding", "sep", "mp")
# the axes a data batch shards over (dp and the ZeRO axis)
BATCH_AXES = ("dp", "sharding")
MP_AXIS = "mp"
CP_AXIS = "cp"
PP_AXIS = "pp"
# the sequence axis: a batch's tokens split over it
SEP_AXIS = "sep"
# the axes a training step's loss and gradients are summed over
SUM_AXES = BATCH_AXES + (SEP_AXIS,)


@dataclasses.dataclass
class Mesh:
    """Named axes over the default group's ranks: `shape` maps each axis
    to its size (axes of size 1 kept), `refs` each axis to this rank's
    group on it."""

    shape: Dict[str, int]
    refs: Dict[str, GroupRef]
    multi_refs: Dict[tuple, GroupRef] = dataclasses.field(
        default_factory=dict)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_ref(self, axis: str) -> GroupRef:
        return self.refs[axis]

    def axis_rank(self, axis: str) -> int:
        return self.refs[axis].rank

    def axis_ranks(self, axis: str) -> List[int]:
        """The default group's ranks of this rank's group on `axis`, in
        the axis's order."""
        key = self.refs[axis].key
        return [int(r) for r in key.split("@", 1)[1].split(",")]

    def pp_neighbours(self, axis: str = PP_AXIS):
        """(previous, next) stage's rank in the default group on this
        rank's pp group, None at the first / last stage (and without a pp
        axis above 1)."""
        if self.shape.get(axis, 1) <= 1:
            return None, None
        ranks, s = self.axis_ranks(axis), self.axis_rank(axis)
        return (ranks[s - 1] if s > 0 else None,
                ranks[s + 1] if s + 1 < len(ranks) else None)

    def group_ref(self, axes) -> Optional[GroupRef]:
        """The group over `axes` (a name or a tuple; axes of size 1
        dropped): None when none is left, the axis group for one, the
        registered multi-axis group for several."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)
        if not axes:
            return None
        if len(axes) == 1:
            return self.refs[axes[0]]
        if axes not in self.multi_refs:
            raise ValueError(f"no process group over {axes} on this mesh "
                             f"(built: {sorted(self.multi_refs)})")
        return self.multi_refs[axes]


def divisible_prefix(mesh, dim: int, names) -> tuple:
    """Longest prefix of `names` (those in `mesh`) whose product divides
    `dim` (the JAX rule behind batch sharding specs)."""
    kept, size = [], 1
    for n in names:
        if n not in mesh.axis_names:
            continue
        if dim % (size * int(mesh.shape[n])) == 0:
            kept.append(n)
            size *= int(mesh.shape[n])
        else:
            break
    return tuple(kept)


def _axis_groups(sizes: List[int], axes) -> List[List[int]]:
    """Every group of ranks that differ only in the digits `axes` (an
    index or a tuple of them; row-major digits over `sizes`), in a fixed
    order, each group's ranks ascending."""
    axes = (axes,) if isinstance(axes, int) else tuple(axes)
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    others = [i for i in range(len(sizes)) if i not in axes]
    inner = [0]
    for i in axes:
        inner = [o + k * strides[i] for o in inner for k in range(sizes[i])]
    out = []
    for combo in range(math.prod(sizes[i] for i in others)):
        base, rem = 0, combo
        for i in reversed(others):
            base += (rem % sizes[i]) * strides[i]
            rem //= sizes[i]
        out.append(sorted(base + o for o in inner))
    return out


def build_mesh(shape, axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """A Mesh from {axis: size} (or sizes with `axis_names`, default the
    hybrid order). Its size must be the default group's world size (1
    without a process group). Every rank must call it, in the same order:
    each axis above 1 makes its process groups (``new_group`` is
    collective)."""
    if isinstance(shape, dict):
        names = tuple(shape)
        sizes = [int(v) for v in shape.values()]
    else:
        sizes = [int(v) for v in shape]
        names = tuple(axis_names or HYBRID_AXES[:len(sizes)])
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = math.prod(sizes)
    if n != world:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} needs {n} "
                         f"ranks, the default group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    refs = {}
    for i, name in enumerate(names):
        if sizes[i] == 1:
            refs[name] = GroupRef(ranks_key(name, [rank]), 1, 0)
            continue
        for ranks in _axis_groups(sizes, i):
            g = dist.new_group(ranks)
            if rank in ranks:
                refs[name] = register_group(name, ranks, g)
    multi = {}
    summed = [i for i, a in enumerate(names) if a in SUM_AXES
              and sizes[i] > 1]
    for picked in itertools.chain.from_iterable(
            itertools.combinations(summed, k)
            for k in range(2, len(summed) + 1)):
        key = tuple(names[i] for i in picked)
        for ranks in _axis_groups(sizes, picked):
            g = dist.new_group(ranks)
            if rank in ranks:
                multi[key] = register_group("+".join(key), ranks, g)
    return Mesh(dict(zip(names, sizes)), refs, multi)


_global_mesh: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    _global_mesh = mesh


def get_global_mesh() -> Optional[Mesh]:
    return _global_mesh


def auto_mesh(**degrees: int) -> Mesh:
    """Build and install a hybrid mesh, the dp degree inferred from the
    world size (the reference's HybridCommunicateGroup check)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    known = math.prod(degrees.values()) if degrees else 1
    if n % known:
        raise ValueError(f"{degrees} does not divide the world size {n}")
    shape = dict(degrees)
    if "dp" not in shape:
        shape = {"dp": n // known, **shape}
    mesh = build_mesh(shape)
    set_global_mesh(mesh)
    return mesh


@dataclasses.dataclass
class HybridParallelInfo:
    """Per-axis degree / rank view (the reference's
    get_*_parallel_world_size / rank accessors)."""

    mesh: Mesh

    def degree(self, axis: str) -> int:
        return int(self.mesh.shape.get(axis, 1))

    def axis_rank(self, axis: str) -> int:
        return self.mesh.axis_rank(axis) if axis in self.mesh.shape else 0

    def get_data_parallel_world_size(self):
        return self.degree("dp")

    def get_model_parallel_world_size(self):
        return self.degree("mp")

    def get_pipe_parallel_world_size(self):
        return self.degree("pp")

    def get_sharding_parallel_world_size(self):
        return self.degree("sharding")

    def get_sep_parallel_world_size(self):
        return self.degree("sep")

    def get_data_parallel_rank(self):
        return self.axis_rank("dp")

    def get_model_parallel_rank(self):
        return self.axis_rank("mp")

    def get_sep_parallel_rank(self):
        return self.axis_rank(SEP_AXIS)

    def get_sep_parallel_group(self) -> GroupRef:
        """This rank's group on the sep axis (its registry entry)."""
        return self.mesh.axis_ref(SEP_AXIS)

    def get_sep_parallel_group_src_rank(self) -> int:
        """The default group's rank of the sep group's first rank."""
        return self.mesh.axis_ranks(SEP_AXIS)[0]

    def get_dp_sep_parallel_group(self) -> Optional[GroupRef]:
        """The group over dp and sep together (Paddle's ``dp_sep`` group:
        a batch's rows and tokens), or the one axis above 1 (None when
        neither is)."""
        return self.mesh.group_ref(("dp", SEP_AXIS))


class HybridCommunicateGroup(HybridParallelInfo):
    """API-parity facade over the mesh (the reference's topology.py)."""

    def __init__(self, mesh: Optional[Mesh] = None, **degrees: int):
        if mesh is None:
            mesh = get_global_mesh() or auto_mesh(**degrees)
        super().__init__(mesh)

    @property
    def nranks(self) -> int:
        return self.mesh.size

    def topology(self) -> List[int]:
        return [self.degree(a) for a in self.mesh.axis_names]
