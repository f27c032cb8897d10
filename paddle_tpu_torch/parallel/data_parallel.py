"""The DataParallel wrapper and its gradient sync (counterpart of
paddle_tpu/parallel/data_parallel.py; Paddle's ``paddle.DataParallel``).

In the JAX package data parallelism is batch sharding over the mesh's dp
axis and the gradient all-reduce is the compiler's. Here each rank is a
process holding its own rows, so the sync is explicit:

- at wrap time every parameter and buffer is broadcast from the group's
  first rank, as Paddle's DataParallel does, so the ranks start equal;
- a post-accumulate-grad hook on each trainable parameter all-reduces its
  gradient over the dp group and divides by the group size (the mean
  over ranks), once the backward has accumulated it;
- `no_sync()` suspends the hooks (gradient accumulation: the gradients of
  the window sum locally, and the first backward outside it syncs the
  sum).

The group is the global mesh's dp axis when one is set
(`parallel.mesh`), else the default group. Forward passes through.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from . import mesh as mesh_mod
from .collectives import all_reduce, broadcast
from .ranks import group_ref

__all__ = ["DataParallel", "scale_batch"]


def dp_group_ref(group=None):
    """The dp group's reference: `group`, else the global mesh's dp axis,
    else the default group."""
    if group is not None:
        return group_ref(getattr(group, "ref", group), axis="dp")
    mesh = mesh_mod.get_global_mesh()
    if mesh is not None and "dp" in mesh.refs:
        return mesh.axis_ref("dp")
    return group_ref(None)


def scale_batch(x, axis_name: str = "dp"):
    """This rank's rows of a global batch `x` along dim 0 over the global
    mesh's `axis_name` (the JAX function lays the batch over dp; here
    every rank holds the global batch and takes its share). Without such
    an axis, or with one of size 1, `x` is returned."""
    mesh = mesh_mod.get_global_mesh()
    if mesh is None or axis_name not in mesh.refs:
        return x
    ref = mesh.axis_ref(axis_name)
    if ref.size == 1:
        return x
    if x.shape[0] % ref.size:
        raise ValueError(f"scale_batch: dim 0 ({x.shape[0]}) does not "
                         f"split over {axis_name}={ref.size}")
    n = x.shape[0] // ref.size
    return x[ref.rank * n:(ref.rank + 1) * n]


class DataParallel(nn.Module):
    """Paddle's ``DataParallel(layers, strategy=None, comm_buffer_size=25,
    last_comm_buffer_size=1, find_unused_parameters=False, group=None)``
    over one process a rank (the buffer sizes are accepted and unused: a
    gradient is synced when the backward has accumulated it)."""

    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size=25, last_comm_buffer_size=1,
                 find_unused_parameters=False, group=None):
        super().__init__()
        self._layers = layers
        self._sync = True
        self._ref = dp_group_ref(group)
        self._hooks = []
        if self._ref.size > 1:
            with torch.no_grad():
                for t in list(layers.parameters()) + list(layers.buffers()):
                    t.copy_(broadcast(t.detach(), self._ref, 0))
            for p in layers.parameters():
                if p.requires_grad:
                    self._hooks.append(
                        p.register_post_accumulate_grad_hook(self._sync_grad))

    @torch.no_grad()
    def _sync_grad(self, p: torch.Tensor) -> None:
        if self._sync and p.grad is not None:
            p.grad.copy_(all_reduce(p.grad, self._ref) / self._ref.size)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Gradient accumulation: the backward passes inside accumulate
        locally; the next one outside syncs the sum."""
        self._sync = False
        try:
            yield
        finally:
            self._sync = True

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict
