"""The semi-automatic SPMD API over a rank's blocks (counterpart of
paddle_tpu/parallel/api.py; Paddle's auto_parallel/api.py
``shard_tensor`` / ``reshard`` / ``shard_layer`` / ``shard_optimizer``).

The JAX package's distributed tensor is a global ``jax.Array`` with a
``NamedSharding``, and XLA picks every collective. Here each rank holds
its block with a `placement.DistAttr` (``t._dist``), and a change of
placements calls the collectives itself, per mesh axis:

    S -> R   all-gather          (backward: the slice)
    P -> R   all-reduce          (backward: identity)
    R -> S   this rank's slice   (backward: all-gather)
    P -> S   reduce-scatter      (backward: all-gather)
    R -> P   the value at coordinate 0 of the axis, zeros elsewhere

so `reshard` and `shard_constraint` are differentiable. As in JAX, a
Shard on a dim the axis does not divide is laid out Replicate.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from . import mesh as mesh_mod
from .collectives import all_gather, all_reduce, c_split, reduce_scatter
from .placement import (DistAttr, Partial, Placement, ProcessMesh,
                        Replicate, Shard, block_slices, dist_attr,
                        placements_to_spec, spec_axes, spec_to_placements)

__all__ = [
    "shard_tensor", "reshard", "shard_layer", "shard_optimizer",
    "dtensor_from_fn", "unshard_dtensor", "get_placements",
    "shard_constraint", "global_shape", "ProcessMesh", "Shard",
    "Replicate", "Partial",
]


def _resolve_mesh(mesh):
    if isinstance(mesh, ProcessMesh):
        return mesh.mesh
    if mesh is None:
        mesh = mesh_mod.get_global_mesh()
        if mesh is None:
            raise ValueError("no mesh given and no global mesh set "
                             "(parallel.set_global_mesh)")
    return mesh


def _normalize(placements, mesh, shape) -> list:
    """Placements padded to the mesh with Replicate; a Shard on a dim its
    axis does not divide becomes Replicate (JAX's rule)."""
    out = list(placements or [])
    while len(out) < len(mesh.axis_names):
        out.append(Replicate())
    for i, p in enumerate(out):
        if isinstance(p, Shard):
            n = int(mesh.shape[mesh.axis_names[i]])
            if p.dim >= len(shape) or shape[p.dim] % n:
                out[i] = Replicate()
    return out


def _with_attr(t: torch.Tensor, attr: DistAttr) -> torch.Tensor:
    t._dist = attr
    return t


def _coord(mesh, axis: str) -> int:
    return mesh.axis_rank(axis) if mesh.shape[axis] > 1 else 0


def global_shape(t: torch.Tensor) -> tuple:
    """The global shape of a block (its own shape for a plain tensor)."""
    attr = dist_attr(t)
    return tuple(attr.global_shape) if attr else tuple(t.shape)


def shard_tensor(data, mesh=None, placements: Optional[Sequence[Placement]]
                 = None, dtype=None, place=None, stop_gradient=None
                 ) -> torch.Tensor:
    """This rank's block of the global tensor `data` (every rank passes the
    same value) under `placements`, carrying its DistAttr: the global shape
    and the placements read back (`global_shape`, `get_placements`). A
    Partial axis keeps the value at coordinate 0 and zeros elsewhere. A
    Parameter stays a Parameter. A tensor keeps its device; other data is
    placed on `place` (default: the card)."""
    mesh = _resolve_mesh(mesh)
    t = data if isinstance(data, torch.Tensor) \
        else torch.as_tensor(data, device=resolve_device(place))
    if dtype is not None:
        t = t.to(dtype)
    shape = tuple(t.shape)
    placements = _normalize(placements, mesh, shape)
    spec = placements_to_spec(placements, mesh, t.ndim)
    partial = tuple(a for a, p in zip(mesh.axis_names, placements)
                    if isinstance(p, Partial))
    with torch.no_grad():
        block = t.detach()[block_slices(mesh, spec, shape)].clone()
        if any(_coord(mesh, a) for a in partial):
            block.zero_()
    if isinstance(data, nn.Parameter):
        out = nn.Parameter(block, requires_grad=data.requires_grad
                           if stop_gradient is None else not stop_gradient)
    else:
        out = block.requires_grad_(
            t.requires_grad if stop_gradient is None else not stop_gradient)
    return _with_attr(out, DistAttr(mesh, spec, shape, partial))


def reshard(dist_tensor: torch.Tensor, mesh=None, placements=None
            ) -> torch.Tensor:
    """The block of the same global tensor under new `placements`
    (module docstring's collectives, axis by axis; differentiable)."""
    attr = dist_attr(dist_tensor)
    mesh = _resolve_mesh(mesh if mesh is not None else
                         (attr.mesh if attr else None))
    shape = tuple(attr.global_shape) if attr else tuple(dist_tensor.shape)
    ndim = len(shape)
    cur_spec = list(attr.spec) if attr else [None] * ndim
    cur_partial = list(attr.partial) if attr else []
    tgt = _normalize(placements, mesh, shape)
    tgt_spec = placements_to_spec(tgt, mesh, ndim)
    tgt_partial = [a for a, p in zip(mesh.axis_names, tgt)
                   if isinstance(p, Partial)]
    x = dist_tensor
    # 1. reduce the partial sums: straight into a shard where the target
    # shards an otherwise unsharded dim by that axis alone
    for a in list(cur_partial):
        if a in tgt_partial:
            continue
        ref = mesh.axis_ref(a)
        d = next((d for d, e in enumerate(tgt_spec)
                  if spec_axes(e) == (a,) and not spec_axes(cur_spec[d])),
                 None)
        if d is not None:
            x = reduce_scatter(x, ref, d)
            cur_spec[d] = a
        else:
            x = all_reduce(x, ref)
        cur_partial.remove(a)
    # 2. gather every dim whose current axes are not a prefix of the
    # target's (minor axis first), 3. then slice the target's extra axes
    for d in range(ndim):
        have, want = spec_axes(cur_spec[d]), spec_axes(tgt_spec[d])
        if have != want[:len(have)]:
            for a in reversed(have):
                x = all_gather(x, mesh.axis_ref(a), d, grad="slice")
            have = ()
        for a in want[len(have):]:
            x = c_split(x, mesh.axis_ref(a), d)
        cur_spec[d] = tgt_spec[d]
    # 4. a new partial axis keeps coordinate 0's value
    for a in tgt_partial:
        if a not in cur_partial and _coord(mesh, a):
            x = x * 0
    if x is dist_tensor:
        x = x.view_as(x)
    return _with_attr(x, DistAttr(mesh, tuple(cur_spec), shape,
                                  tuple(tgt_partial)))


def shard_constraint(x: torch.Tensor, placements, mesh=None):
    """Lay `x` (a block, or a plain tensor taken as replicated) out under
    `placements` inside a training step: `reshard`, differentiable."""
    return reshard(x, mesh, placements)


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """Build the global tensor with `fn`, then shard it."""
    return shard_tensor(fn(*args, **kwargs), mesh=mesh,
                        placements=placements)


def unshard_dtensor(dist_tensor: torch.Tensor) -> torch.Tensor:
    """The global tensor, gathered on every rank (a plain tensor passes
    through)."""
    attr = dist_attr(dist_tensor)
    if attr is None:
        return dist_tensor
    out = reshard(dist_tensor, attr.mesh,
                  [Replicate()] * len(attr.mesh.axis_names))
    del out._dist
    return out


def get_placements(t: torch.Tensor, mesh=None):
    """The placements of a block (all Replicate for a plain tensor)."""
    attr = dist_attr(t)
    if attr is not None:
        return spec_to_placements(attr.spec, attr.mesh, attr.partial)
    mesh = _resolve_mesh(mesh)
    return [Replicate()] * len(mesh.axis_names)


def shard_layer(layer: nn.Module, process_mesh=None, shard_fn=None,
                input_fn=None, output_fn=None) -> nn.Module:
    """Shard every parameter of `layer`: `shard_fn(name, sublayer, mesh)`
    may replace a sublayer's parameters (by `shard_tensor`); by default
    each is laid out replicated over the mesh. `input_fn(inputs, mesh)` /
    `output_fn(outputs, mesh)` become forward hooks."""
    mesh = process_mesh if process_mesh is not None else _resolve_mesh(None)
    port_mesh = _resolve_mesh(mesh)

    def default_shard(name, sublayer, mesh_):
        for pname, p in list(sublayer._parameters.items()):
            if p is not None and dist_attr(p) is None:
                sublayer._parameters[pname] = shard_tensor(
                    p, port_mesh, [Replicate()] * len(port_mesh.axis_names))

    fn = shard_fn or default_shard
    for name, sub in layer.named_modules():
        fn(name, sub, mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda mod, inp: input_fn(inp, mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda mod, inp, out: output_fn(out, mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None):
    """Make an optimizer's state follow its parameters' placements: each
    accumulator is created on the parameter's block and carries its
    DistAttr, or `shard_fn(name, param, state)` lays it out."""
    orig = optimizer._create_accumulators

    def create(p):
        state = orig(p)
        attr = dist_attr(p)
        for k, arr in list(state.items()):
            if shard_fn is not None:
                state[k] = shard_fn(k, p, arr)
            elif attr is not None and arr.shape == p.shape:
                arr._dist = attr
        return state

    optimizer._create_accumulators = create
    return optimizer
