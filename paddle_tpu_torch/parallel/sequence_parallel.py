"""Sequence and context parallelism for long sequences (counterpart of
paddle_tpu/parallel/sequence_parallel.py; Paddle's
fleet/utils/sequence_parallel_utils.py and the ``sep`` topology axis).

The JAX functions annotate a global array's sharding and let XLA move the
data. Here every rank holds a block, and each function gives the rank's
block of the global value that JAX's annotation leaves:

- `split_seq` (``ScatterOp``, ``ReduceScatterOp``): the rank's slice of
  the sequence over the sequence axis (`_seq_axis`: ``sep``, else
  ``mp``); its backward all-gathers (`collectives.c_split`);
- `gather_seq` (``GatherOp``, ``AllGatherOp``): the slices all-gathered;
  its backward takes the rank's slice (`collectives.c_concat`);
- `ulysses_alltoall` / `sep_attention_context`: the Ulysses swap of which
  of (sequence, heads) is split (`parallel.ulysses`); `sep_attention`
  runs an attention over the whole sequence by it, or by gathering the
  sequence where the heads do not split;
- `SegmentParallel`: a model trained over sep, each rank on its slice of
  every input's sequence.

`seq_sharded` marks the tokens a model is handed as the rank's slice of
the sep axis (the train step and `SegmentParallel` enter it): a Llama
model then rotates them at their global positions and attends over the
whole sequence (`models.llama`, ``attention_impl`` "ulysses" or "ring").
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from . import mesh as mesh_mod
from .collectives import (all_gather, all_reduce, broadcast_tree, c_concat,
                          c_split)
from .ulysses import head_to_seq, seq_to_head, ulysses_available

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "SegmentParallel", "SeqShard", "mark_as_sequence_parallel_parameter",
    "split_seq", "gather_seq", "seq_shard", "seq_sharded",
    "ulysses_alltoall", "sep_attention", "sep_attention_context",
]


def _seq_axis(mesh=None) -> Optional[str]:
    """The axis a sequence splits over: sep, else mp (above 1), else
    None."""
    m = mesh or mesh_mod.get_global_mesh()
    if m is None:
        return None
    for cand in ("sep", "mp"):
        if cand in m.axis_names and int(m.shape[cand]) > 1:
            return cand
    return None


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """The tokens a model is handed are this rank's slice of the `axis`
    ranks' sequence on `mesh` (slice i of n holds positions i * s ..
    (i + 1) * s - 1 for s local tokens)."""

    mesh: object
    axis: str = mesh_mod.SEP_AXIS

    @property
    def ref(self):
        return self.mesh.axis_ref(self.axis)

    @property
    def size(self) -> int:
        return self.ref.size

    @property
    def rank(self) -> int:
        return self.ref.rank


_SEQ: contextvars.ContextVar = contextvars.ContextVar("seq_shard",
                                                      default=None)


@contextlib.contextmanager
def seq_sharded(mesh, axis: str = mesh_mod.SEP_AXIS):
    """Inside the block, the tokens a model is handed are this rank's
    slice of `axis` (a no-op where the axis is 1)."""
    shard = SeqShard(mesh, axis) if mesh is not None and \
        int(mesh.shape.get(axis, 1)) > 1 else None
    token = _SEQ.set(shard)
    try:
        yield shard
    finally:
        _SEQ.reset(token)


def seq_shard() -> Optional[SeqShard]:
    """The `SeqShard` of the innermost `seq_sharded` block, or None."""
    return _SEQ.get()


def split_seq(x, seq_dim: int = 1):
    """The rank's slice of the sequence dim (Paddle's ScatterOp); the
    backward all-gathers the gradient."""
    mesh = mesh_mod.get_global_mesh()
    axis = _seq_axis(mesh)
    if axis is None:
        return x
    return c_split(x, mesh.axis_ref(axis), seq_dim)


def gather_seq(x, seq_dim: int = 1):
    """The ranks' slices gathered into the whole sequence (Paddle's
    GatherOp / AllGatherOp); the backward takes the rank's slice."""
    mesh = mesh_mod.get_global_mesh()
    axis = _seq_axis(mesh)
    if axis is None:
        return x
    return c_concat(x, mesh.axis_ref(axis), seq_dim)


# Paddle's PyLayer classes, as JAX's aliases
class ScatterOp:
    apply = staticmethod(split_seq)


class GatherOp:
    apply = staticmethod(gather_seq)


class AllGatherOp:
    apply = staticmethod(gather_seq)


class ReduceScatterOp:
    apply = staticmethod(split_seq)


def mark_as_sequence_parallel_parameter(param):
    """Tag a parameter whose gradient is summed over the sequence group
    (Paddle's sequence_parallel_utils)."""
    param.is_sequence_parallel = True
    return param


def _head_split(mesh, head_axes) -> int:
    return math.prod(int(mesh.shape[a]) for a in head_axes
                     if a in mesh.axis_names)


def ulysses_alltoall(x, scatter_dim: int, gather_dim: int,
                     axis: str = "sep", mesh=None,
                     head_axes: Tuple[str, ...] = ("mp",)):
    """DeepSpeed-Ulysses all-to-all: swap which of (heads, sequence) is
    split over `axis` of `mesh` (default: the global mesh). For the [b, s,
    h, d] layout with {scatter_dim, gather_dim} = {1, 2} where the swap
    applies (`ulysses_available` on the global sizes, the heads already
    split over `head_axes`) it is `seq_to_head` (scatter_dim 2) or
    `head_to_seq` (scatter_dim 1). Otherwise the rank's block moves from
    `gather_dim` to `scatter_dim` (JAX's re-annotation): the blocks
    gathered along `gather_dim`, the rank's block of `scatter_dim`
    taken."""
    mesh = mesh if mesh is not None else mesh_mod.get_global_mesh()
    if mesh is None or axis not in mesh.axis_names \
            or int(mesh.shape[axis]) == 1:
        return x
    n = int(mesh.shape[axis])
    if x.ndim == 4 and {scatter_dim, gather_dim} == {1, 2}:
        g = _head_split(mesh, head_axes)
        if scatter_dim == 2:        # [b, s/n, H/g, d] -> [b, s, H/(g n), d]
            heads, seq = x.shape[2] * g, x.shape[1] * n
        else:
            heads, seq = x.shape[2] * g * n, x.shape[1]
        if ulysses_available(mesh, heads, seq, axis, head_axes):
            swap = seq_to_head if scatter_dim == 2 else head_to_seq
            return swap(x, mesh, axis)
    ref = mesh.axis_ref(axis)
    full = all_gather(x, ref, gather_dim, grad="reduce_scatter")
    if full.shape[scatter_dim] % n:
        raise ValueError(f"ulysses_alltoall: dim {scatter_dim} "
                         f"({full.shape[scatter_dim]}) does not split into "
                         f"{n} ranks")
    k = full.shape[scatter_dim] // n
    return full.narrow(scatter_dim, ref.rank * k, k)


def sep_attention_context(q, k, v, seq_dim: int = 1, head_dim: int = 2,
                          axis: str = "sep", mesh=None,
                          head_axes: Tuple[str, ...] = ("mp",)):
    """q, k and v split over heads instead of the sequence for the
    attention block (the Ulysses pattern)."""
    return tuple(ulysses_alltoall(t, head_dim, seq_dim, axis, mesh,
                                  head_axes) for t in (q, k, v))


def sep_attention(q, k, v, attend, mesh, axis: str = "sep",
                  head_axes: Tuple[str, ...] = ("mp",)):
    """``attend(q, k, v)`` over the whole sequence for the rank's slice of
    it (q, k, v [b, s/n, heads, d], the heads already split over
    `head_axes`), the rank's slice of the result: where the q and kv
    heads both split over `head_axes` and `axis`, the Ulysses swap to the
    rank's heads (`sep_attention_context`) and back; otherwise (JAX
    reshards by constraint) the sequence all-gathered, attended at the
    heads the rank holds, and its rows taken."""
    n = int(mesh.shape[axis])
    g, seq = _head_split(mesh, head_axes), q.shape[1] * n
    if all(ulysses_available(mesh, t.shape[2] * g, seq, axis, head_axes)
           for t in (q, k)):
        q, k, v = sep_attention_context(q, k, v, axis=axis, mesh=mesh,
                                        head_axes=head_axes)
        return ulysses_alltoall(attend(q, k, v), 1, 2, axis, mesh,
                                head_axes)
    ref, s = mesh.axis_ref(axis), q.shape[1]
    q, k, v = (all_gather(t, ref, 1, grad="reduce_scatter")
               for t in (q, k, v))
    return attend(q, k, v).narrow(1, ref.rank * s, s)


class SegmentParallel(nn.Module):
    """Paddle's ``SegmentParallel(layers, hcg, strategy)``
    (fleet/meta_parallel/segment_parallel.py) over the sep axis of `hcg`'s
    mesh (default: the global mesh), one process a rank. At wrap time
    every parameter and buffer is broadcast from the sep group's first
    rank; a hook sums over the sep group the gradient each backward
    brings a parameter, before it is added to ``.grad``, since each
    rank's backward sees only its tokens (backward passes that
    accumulate into ``.grad`` are summed once each). The forward splits
    every tensor argument of two or more dims along dim 1 (the
    sequence), runs the layers on the rank's slice inside `seq_sharded`,
    and gathers each output of two or more dims back along dim 1, so
    every rank returns the global output (its backward takes the rank's
    slice). Layers that do not declare ``handles_seq_shard`` (a Llama
    model does) compute over the tokens they are handed alone, so they
    run on the whole sequence on every rank, which then replicates them
    (no split, no sum). Without a sep axis above 1 it passes through."""

    def __init__(self, layers: nn.Module, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._mesh = hcg.mesh if hcg is not None \
            else mesh_mod.get_global_mesh()
        self._ref = None
        self._hooks = []
        if self._mesh is not None and int(self._mesh.shape.get(
                mesh_mod.SEP_AXIS, 1)) > 1:
            ref = self._mesh.axis_ref(mesh_mod.SEP_AXIS)
            broadcast_tree([t.data for t in list(layers.parameters())
                            + list(layers.buffers())], ref, 0)
            if getattr(layers, "handles_seq_shard", False):
                self._ref = ref
                self._hooks = [p.register_hook(self._sum)
                               for p in layers.parameters()
                               if p.requires_grad]

    @torch.no_grad()
    def _sum(self, grad: torch.Tensor) -> torch.Tensor:
        return all_reduce(grad, self._ref)

    def forward(self, *args, **kwargs):
        if self._ref is None:
            return self._layers(*args, **kwargs)

        def split(a):
            return c_split(a, self._ref, 1) \
                if isinstance(a, torch.Tensor) and a.ndim >= 2 else a

        def gather(a):
            return c_concat(a, self._ref, 1) \
                if isinstance(a, torch.Tensor) and a.ndim >= 2 else a

        with seq_sharded(self._mesh):
            out = self._layers(*map(split, args), **kwargs)
        if isinstance(out, (tuple, list)):
            return type(out)(map(gather, out))
        return gather(out)
