"""Tensor-parallel (Megatron-style) layers over the ``mp`` mesh axis
(counterpart of paddle_tpu/parallel/mpu.py; Paddle's mp_layers.py
``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear``, ``ParallelCrossEntropy`` and mp_ops.py's
autograd-aware collectives).

The JAX layers hold the global weight with a ``NamedSharding`` over mp
and XLA inserts the collectives. Here each rank holds its block (Paddle's
own per-rank shards, a `placement.DistAttr` on it) and the layers call
the collectives of `collectives`: ``c_identity`` (f) before a
column-parallel product, ``mp_allreduce`` (g) after a row-parallel one,
``c_concat`` / ``c_split`` between the two layouts. A layer builds its
global weight with the initializer JAX uses, broadcast from the group's
first rank, and keeps its block, on `device` (default: the card; the
tests pass ``device="cpu"``). Without an mp axis above 1 in the global
mesh (or `mp_group`), a layer is the plain one.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from . import mesh as mesh_mod
from .api import shard_tensor
from .collectives import (all_reduce, broadcast, c_concat, c_identity,
                          c_split, mp_allreduce)
from .placement import Replicate, Shard

__all__ = [
    "VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
    "ParallelCrossEntropy", "get_rng_state_tracker", "RNGStatesTracker",
]


def _mp(mp_group=None):
    """(the mesh, the mp GroupRef) of `mp_group` or the global mesh's mp
    axis; (None, None) without one above 1."""
    if mp_group is not None:
        return None, getattr(mp_group, "ref", mp_group)
    mesh = mesh_mod.get_global_mesh()
    if mesh is None or mesh.shape.get("mp", 1) <= 1:
        return None, None
    return mesh, mesh.axis_ref("mp")


class RNGStatesTracker:
    """Named random streams for dropout inside and outside TP regions
    (Paddle's mpu/random.py ``RNGStatesTracker``): `add(name, seed)`
    starts a stream; inside ``rng_state(name)`` the torch generators (the
    CPU's and the current card's) draw from it, and it resumes there next
    time."""

    def __init__(self):
        self.states_ = {}
        self._gen = {}

    def add(self, name, seed):
        if name in self.states_:
            raise ValueError(f"state {name!r} already exists")
        self.states_[name] = seed
        with torch.random.fork_rng(devices=self._devices()):
            torch.manual_seed(int(seed))
            self._gen[name] = self._get()

    def reset(self):
        self.states_, self._gen = {}, {}

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.reset()
        for name, seed in dict(states).items():
            self.add(name, seed)

    @staticmethod
    def _devices():
        return [torch.cuda.current_device()] if torch.cuda.is_available() \
            else []

    def _get(self):
        cuda = torch.cuda.get_rng_state() if torch.cuda.is_available() \
            else None
        return torch.get_rng_state(), cuda

    @contextlib.contextmanager
    def rng_state(self, name="global_seed"):
        if name not in self._gen:
            raise ValueError(f"state {name!r} does not exist")
        with torch.random.fork_rng(devices=self._devices()):
            cpu, cuda = self._gen[name]
            torch.set_rng_state(cpu)
            if cuda is not None:
                torch.cuda.set_rng_state(cuda)
            yield
            self._gen[name] = self._get()


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def _global_param(shape, init, ref, mesh, placement_axis: Optional[int],
                  device=None):
    """The global parameter made by `init` on `device` (default: the
    card) on the group's first rank (and broadcast), this rank's block of
    it over mp on `placement_axis` (where mp divides it), as a Parameter
    carrying its DistAttr when a mesh is known."""
    w = torch.empty(shape, device=resolve_device(device))
    init(w)
    if ref is None:
        return nn.Parameter(w)
    w = broadcast(w, ref, 0)
    if placement_axis is None or shape[placement_axis] % ref.size:
        return nn.Parameter(w)
    if mesh is not None:
        pl = [Shard(placement_axis) if a == "mp" else Replicate()
              for a in mesh.axis_names]
        return shard_tensor(nn.Parameter(w), mesh, pl)
    n = shape[placement_axis] // ref.size
    return nn.Parameter(w.narrow(placement_axis, ref.rank * n, n).clone())


def _split(p, ref, dim) -> bool:
    return ref is not None and p.shape[dim] != _full_dim(p, dim)


def _full_dim(p, dim):
    attr = getattr(p, "_dist", None)
    return attr.global_shape[dim] if attr is not None else p.shape[dim]


class ColumnParallelLinear(nn.Module):
    """Y = X @ W + b, W [in, out] split on out (columns) over mp: this
    rank computes its columns after f; `gather_output` gathers them
    (Paddle's c_concat), else the output stays split on its last dim."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        mesh, self._ref = _mp(mp_group)
        self.weight = _global_param([in_features, out_features],
                                    nn.init.xavier_normal_, self._ref,
                                    mesh, 1, device)
        self.bias = _global_param([out_features], nn.init.zeros_,
                                  self._ref, mesh, 0, device) \
            if has_bias else None

    def forward(self, x):
        if not _split(self.weight, self._ref, 1):
            out = x @ self.weight
            return out + self.bias if self.bias is not None else out
        out = c_identity(x, self._ref) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        return c_concat(out, self._ref, -1) if self.gather_output else out


class RowParallelLinear(nn.Module):
    """Y = X @ W + b, W [in, out] split on in (rows) over mp: the rank's
    partial product summed by g, then the (whole) bias; an input not
    `input_is_parallel` is split first (Paddle's c_split)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        mesh, self._ref = _mp(mp_group)
        self.weight = _global_param([in_features, out_features],
                                    nn.init.xavier_normal_, self._ref,
                                    mesh, 0, device)
        self.bias = _global_param([out_features], nn.init.zeros_,
                                  self._ref, mesh, None, device) \
            if has_bias else None

    def forward(self, x):
        if not _split(self.weight, self._ref, 0):
            out = x @ self.weight
        else:
            if not self.input_is_parallel:
                x = c_split(x, self._ref, -1)
            out = mp_allreduce(x @ self.weight, self._ref)
        return out + self.bias if self.bias is not None else out


class VocabParallelEmbedding(nn.Module):
    """An embedding whose vocab is split over mp (Paddle's mp_layers.py:47):
    each rank looks up the ids in its range (zeros elsewhere) and g sums
    the ranks' rows."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        mesh, self._ref = _mp(mp_group)
        self.weight = _global_param([num_embeddings, embedding_dim],
                                    nn.init.xavier_uniform_, self._ref,
                                    mesh, 0, device)

    def forward(self, ids):
        if not _split(self.weight, self._ref, 0):
            return self.weight[ids]
        n = self.weight.shape[0]
        lo = self._ref.rank * n
        inside = (ids >= lo) & (ids < lo + n)
        local = torch.where(inside, ids - lo, torch.zeros_like(ids))
        out = self.weight[local] * inside[..., None].to(self.weight.dtype)
        return mp_allreduce(out, self._ref)


class ParallelCrossEntropy(nn.Module):
    """Cross entropy over logits whose vocab is split over mp (Paddle's
    mp_layers.py:742): `input` is this rank's vocab block; the max, the
    sum of exponentials and the label's logit are summed over the group.
    Labels equal to `ignore_index` give 0. Returns the loss [..., 1], as
    the JAX layer."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        _, self._ref = _mp(mp_group)

    def forward(self, input, label):
        lbl = label.long()
        if lbl.ndim == input.ndim:
            lbl = lbl[..., 0]
        ignored = lbl == self.ignore_index
        safe = torch.where(ignored, torch.zeros_like(lbl), lbl)
        if self._ref is None or self._ref.size == 1:
            logp = input - torch.logsumexp(input, dim=-1, keepdim=True)
            picked = torch.gather(logp, -1, safe[..., None])[..., 0]
            loss = torch.where(ignored, torch.zeros_like(picked), -picked)
            return loss[..., None]
        n = input.shape[-1]
        lo = self._ref.rank * n
        gmax = all_reduce(input.detach().amax(dim=-1, keepdim=True),
                          self._ref, op="max")
        shifted = input - gmax
        sum_exp = mp_allreduce(torch.exp(shifted).sum(-1), self._ref)
        inside = (safe >= lo) & (safe < lo + n)
        idx = torch.where(inside, safe - lo, torch.zeros_like(safe))
        mine = torch.gather(shifted, -1, idx[..., None])[..., 0]
        picked = mp_allreduce(mine * inside.to(mine.dtype), self._ref)
        loss = torch.log(sum_exp) - picked
        loss = torch.where(ignored, torch.zeros_like(loss), loss)
        return loss[..., None]
