"""Placements and the process mesh of the semi-auto API (counterpart of
paddle_tpu/parallel/placement.py; Paddle's placement_types.h
``Placement`` / ``Shard`` / ``Replicate`` / ``Partial`` and
``ProcessMesh``).

The JAX package holds one global ``jax.Array`` a tensor and turns a
placement list into a ``NamedSharding``. Here every rank is a process
holding its own block, so a distributed tensor is a local tensor plus a
`DistAttr`: the mesh, the spec (one entry a global dim: None, an axis
name, or a tuple of axis names, major first; the JAX ``PartitionSpec``'s
entries), the axes on which the block holds a partial sum, and the global
shape. The attribute rides on the tensor (``t._dist``), so a parameter
keeps it when it is bound to a module.

A rank's block of a dim sharded over axes (a, b) is block ``i_a * n_b +
i_b`` of ``n_a * n_b`` equal blocks, ``i`` the rank's coordinate on each
axis (`parallel.mesh`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DistAttr", "Partial", "Placement", "ProcessMesh", "Replicate",
           "Shard", "block_offsets", "block_slices", "dist_attr",
           "placements_to_spec", "spec_axes", "spec_to_placements"]


class Placement:
    def is_shard(self, dim: Optional[int] = None) -> bool:
        return False

    def is_replicated(self) -> bool:
        return False

    def is_partial(self) -> bool:
        return False


class Replicate(Placement):
    def is_replicated(self) -> bool:
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, o):
        return isinstance(o, Replicate)

    def __hash__(self):
        return hash("r")


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = dim

    def get_dim(self) -> int:
        return self.dim

    def is_shard(self, dim: Optional[int] = None) -> bool:
        return dim is None or dim == self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, o):
        return isinstance(o, Shard) and o.dim == self.dim

    def __hash__(self):
        return hash(("s", self.dim))


class Partial(Placement):
    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def is_partial(self) -> bool:
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, o):
        return isinstance(o, Partial) and o.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("p", self.reduce_type))


class ProcessMesh:
    """Paddle's ``ProcessMesh`` over the port's `parallel.mesh.Mesh`:
    `mesh` is a Mesh (its axes and sizes) or an array of process ids
    with `dim_names`. The Mesh of an id array is built on first use
    (`mesh`), since building makes process groups."""

    def __init__(self, mesh=None, dim_names: Optional[Sequence[str]] = None,
                 shape: Optional[Sequence[int]] = None):
        from .mesh import Mesh

        self._mesh = None
        if isinstance(mesh, Mesh):
            self._mesh = mesh
            self._shape = list(mesh.shape.values())
            self._dim_names = list(mesh.axis_names)
            return
        if mesh is None and shape is not None:
            mesh = np.arange(int(np.prod(shape))).reshape(shape)
        arr = np.asarray(mesh)
        self._shape = list(arr.shape)
        self._dim_names = list(dim_names) if dim_names else [
            f"d{i}" for i in range(arr.ndim)]

    @property
    def shape(self) -> List[int]:
        return list(self._shape)

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def process_ids(self) -> List[int]:
        return list(range(int(np.prod(self._shape))))

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def mesh(self):
        """The port Mesh (built here, collectively, when given ids)."""
        if self._mesh is None:
            from .mesh import build_mesh

            self._mesh = build_mesh(dict(zip(self._dim_names, self._shape)))
        return self._mesh

    def get_dim_size(self, name: str) -> int:
        return self._shape[self._dim_names.index(name)]

    def __eq__(self, o):
        return (isinstance(o, ProcessMesh) and o._shape == self._shape
                and o._dim_names == self._dim_names)

    def __repr__(self):
        return (f"ProcessMesh(shape={self._shape}, "
                f"dim_names={self._dim_names})")


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_to_spec(placements: Sequence[Placement], mesh,
                       ndim: int) -> tuple:
    """[p_axis0, p_axis1, ...] -> a spec over the tensor's dims (JAX's
    PartitionSpec entries: a dim sharded by several axes lists them in
    mesh order)."""
    per_dim: List[List[str]] = [[] for _ in range(ndim)]
    for axis_idx, p in enumerate(placements):
        if isinstance(p, Shard):
            per_dim[p.dim % max(ndim, 1)].append(mesh.axis_names[axis_idx])
    return tuple((tuple(names) if len(names) > 1 else names[0])
                 if names else None for names in per_dim)


def spec_to_placements(spec, mesh, partial: Sequence[str] = ()
                       ) -> List[Placement]:
    """Inverse of `placements_to_spec`; `partial` names the axes whose
    placement is Partial."""
    placements: List[Placement] = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(tuple(spec)):
        for n in spec_axes(entry):
            placements[list(mesh.axis_names).index(n)] = Shard(dim)
    for n in partial:
        placements[list(mesh.axis_names).index(n)] = Partial()
    return placements


@dataclasses.dataclass(frozen=True)
class DistAttr:
    """A local block's place in its global tensor (module docstring)."""

    mesh: object
    spec: tuple
    global_shape: tuple
    partial: tuple = ()

    @property
    def placements(self) -> List[Placement]:
        return spec_to_placements(self.spec, self.mesh, self.partial)

    def sharded_axes(self) -> Tuple[str, ...]:
        """The axes (size > 1) over which ranks hold distinct blocks."""
        out = []
        for entry in self.spec:
            for a in spec_axes(entry):
                if self.mesh.shape.get(a, 1) > 1:
                    out.append(a)
        return tuple(out)


def dist_attr(t) -> Optional[DistAttr]:
    """The `DistAttr` a tensor carries, or None (a plain tensor)."""
    return getattr(t, "_dist", None)


def _coord(mesh, axis: str) -> int:
    return mesh.axis_rank(axis) if mesh.shape.get(axis, 1) > 1 else 0


def block_offsets(mesh, spec, global_shape) -> Tuple[Tuple[int, int], ...]:
    """(offset, length) a dim of this rank's block; raises where a dim
    does not split evenly."""
    out = []
    spec = tuple(spec) + (None,) * (len(global_shape) - len(spec))
    for d, (entry, size) in enumerate(zip(spec, global_shape)):
        axes = spec_axes(entry)
        n = math.prod(int(mesh.shape.get(a, 1)) for a in axes)
        if size % n:
            raise ValueError(f"dim {d} ({size}) does not split over "
                             f"{axes} ({n} blocks)")
        idx = 0
        for a in axes:
            idx = idx * int(mesh.shape.get(a, 1)) + _coord(mesh, a)
        out.append((idx * (size // n), size // n))
    return tuple(out)


def block_slices(mesh, spec, global_shape) -> tuple:
    """This rank's block of a global tensor, as a tuple of slices."""
    return tuple(slice(o, o + n)
                 for o, n in block_offsets(mesh, spec, global_shape))
