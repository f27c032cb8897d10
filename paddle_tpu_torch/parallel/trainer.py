"""The train step (counterpart of paddle_tpu/parallel/trainer.py), on one
GPU or over a data-parallel mesh of ranks.

    step_fn, params, opt_state = make_train_step(model, loss_fn, None, ...)
    loss, params, opt_state = step_fn(params, opt_state, x, y)

the JAX package's calling convention, so one loop drives both packages.
JAX jits a pure (params, opt_state, batch) -> (loss, params', opt_state')
function with donated buffers; here the step runs eagerly under autograd
and updates the params and the optimizer state in place (the donation's
effect, stated: the returned dicts are the ones passed in). `params` maps
``model.named_parameters()`` keys to the model's own ``nn.Parameter``s,
so the model must hold trainable weights (``load_params(...,
trainable=True)`` or ``init_train_params``).

Ported: the default fused AdamW (``adamw_update``: global-norm clip at
1.0, moments in the params' dtype, decay on ndim > 1 only), the
``optimizer=`` route through ``FusedOptimizer``, and the strategy
sections ``amp``, ``recompute`` and ``gradient_merge`` (a dict of
section dicts). ``sharding`` (ZeRO, ROADMAP section 1 item 5 step 3) and
a whole-loss checkpoint for a model without a ``config.recompute`` knob
are refused ("Trainer options the port refuses").

Data parallelism (``mesh=``, default the global mesh of
`parallel.mesh`): the JAX step lays the global batch over ``("dp",
"sharding")`` and the compiler reduces the gradients. Here every rank is
handed the same global batch and takes its rows (rank r of dp = n the
r-th of n equal row blocks); its loss is its rows' mean weighted by its
share of the rows, so the gradients summed over dp (one all-reduce a
dtype, `collectives.all_reduce_tree`, or with ``quantized_collectives``
the int8 `quantized_psum_tree`) are the global mean's, and so is the
returned loss. The sum lands before clipping and the update, so every
rank applies the same update and the parameters stay bitwise equal
across ranks (they are broadcast from dp rank 0 when the step is built).
With gradient merge the micro-batches accumulate locally and sync once.
A batch whose rows dp does not divide (or a 0-d leaf) runs whole on every
rank, with a warning: JAX replicates such a batch.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from ..device import resolve_device
from . import mesh as mesh_mod
from .collectives import all_reduce, all_reduce_tree, broadcast, \
    quantized_psum_tree
from .fused_optimizer import FusedOptimizer


class AdamWState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: int


def init_adamw_state(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Zero moments shaped and typed like each param (JAX zeros_like)."""
    return AdamWState(m={k: torch.zeros_like(p) for k, p in params.items()},
                      v={k: torch.zeros_like(p) for k, p in params.items()},
                      step=0)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr, *, beta1=0.9,
                 beta2=0.999, eps=1e-8, weight_decay=0.01,
                 grad_clip_norm: Optional[float] = 1.0):
    """AdamW with global-norm clipping over the params that have a grad,
    in place (JAX ``adamw_update``, op for op: the moments are computed
    in f32 and stored in their own dtype). Weight decay applies to params
    with ndim > 1 only. Returns (params, new state)."""
    step = state.step + 1
    names = sorted(n for n in params if n in grads)
    gs = [grads[n] for n in names]
    if grad_clip_norm is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in gs))
        scale = torch.clamp(grad_clip_norm / (gnorm + 1e-6), max=1.0)
        gs = [g * scale.to(g.dtype) for g in gs]
    c1 = 1.0 - beta1 ** step
    c2 = 1.0 - beta2 ** step
    for n, g in zip(names, gs):
        p, m, v = params[n], state.m[n], state.v[n]
        g32 = g.to(torch.float32)
        m_ = beta1 * m + (1 - beta1) * g32
        v_ = beta2 * v + (1 - beta2) * torch.square(g32)
        p32 = p.to(torch.float32)
        wd = weight_decay if p.ndim > 1 else 0.0
        p.copy_(p32 - lr * ((m_ / c1) / (torch.sqrt(v_ / c2) + eps)
                            + wd * p32))
        m.copy_(m_)
        v.copy_(v_)
    return params, AdamWState(m=state.m, v=state.v, step=step)


_SECTIONS = ("amp", "recompute", "sharding", "gradient_merge", "pipeline")


def _resolve_strategy(strategy) -> Dict[str, dict]:
    """A strategy dict (or None) -> one plain dict per section."""
    out = {s: {} for s in _SECTIONS}
    if strategy is None:
        return out
    for s in _SECTIONS:
        if isinstance(strategy.get(s), dict):
            out[s] = dict(strategy[s])
    return out


def _grad(p: torch.Tensor) -> torch.Tensor:
    # a param the loss does not reach gets a zero grad, as jax.grad gives
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _bind(model: nn.Module, params: Dict[str, nn.Parameter]) -> None:
    """Make `params` the model's parameters (by key)."""
    for name, p in params.items():
        path, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(path)
        if getattr(mod, leaf) is not p:
            setattr(mod, leaf, p)


def dp_ref_of(mesh):
    """The dp axis' GroupRef of `mesh` when it exceeds 1, else None."""
    if mesh is None:
        return None
    for axis, n in mesh.shape.items():
        if n > 1 and axis not in mesh_mod.PORTED_AXES:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {n}: the port trains over dp "
                f"only ({mesh_mod.LATER_STEPS})")
    if mesh.shape.get("dp", 1) <= 1:
        return None
    return mesh.axis_ref("dp")


def local_rows(batch, dp):
    """(this rank's rows of every leaf, its share of the rows), or None
    when a leaf is 0-d or dp does not divide its rows."""
    n = dp.size
    if not batch or any(b.ndim == 0 or b.shape[0] % n for b in batch):
        return None
    rows = batch[0].shape[0] // n
    return (tuple(b[dp.rank * rows:(dp.rank + 1) * rows] for b in batch),
            1.0 / n)


def sync_grads(grads: Dict[str, torch.Tensor], dp, quantized: bool):
    """The dp gradient sum (`all_reduce_tree`, or `quantized_psum_tree`)."""
    if quantized:
        return quantized_psum_tree(grads, dp)
    return all_reduce_tree(grads, dp)


def make_train_step(model: nn.Module, loss_fn: Callable, mesh=None,
                    lr: float = 1e-4, weight_decay: float = 0.01,
                    grad_clip_norm: Optional[float] = 1.0, optimizer=None,
                    strategy=None, device=None,
                    quantized_collectives: bool = False):
    """Build (step_fn, params, opt_state) for `model` on `device`
    (default: the CUDA card; the model's params must live there).

    `loss_fn(output, *batch_rest) -> scalar`. `optimizer`: an Optimizer
    built over the model's parameters, run through ``FusedOptimizer``
    (its update rule, per-group decay, ``apply_decay_param_fun``, clip
    and LR schedule); without it, ``adamw_update(lr, weight_decay,
    grad_clip_norm)``. `strategy` sections:
      - amp.enable: f32 params run forward and backward as bf16 copies;
        the grads come back in f32 and the update is f32.
      - recompute.enable[, recompute_skip, remat_policy]: the model's
        own per-layer recompute for this step (its config flipped and
        restored).
      - gradient_merge.enable + k_steps[, avg]: the batch in k_steps
        micro-batches, grads summed in f32, averaged unless avg=False.
    `mesh` (default: the global mesh) with dp > 1 trains data-parallel
    (the module docstring); `quantized_collectives` makes its gradient
    sync the int8 `quantized_psum_tree`.
    """
    strat = _resolve_strategy(strategy)
    if strat["sharding"].get("enable"):
        raise NotImplementedError(
            "the sharding strategy (ZeRO) is not ported: ROADMAP section 1 "
            "item 5 step 3 (\"Trainer options the port refuses\")")
    dp = dp_ref_of(mesh if mesh is not None else mesh_mod.get_global_mesh())
    dev = resolve_device(device)
    params = dict(model.named_parameters())
    for name, p in params.items():
        if p.device != dev:
            raise ValueError(f"{name} lives on {p.device}, the step on {dev}"
                             " (load the params there first)")
    if dp is not None:
        # every rank starts from dp rank 0's parameters
        with torch.no_grad():
            for p in params.values():
                p.copy_(broadcast(p.detach(), dp, 0))
    fused = FusedOptimizer(optimizer, model) if optimizer is not None \
        else None
    trainable = fused.trainable if fused is not None else frozenset(
        n for n, p in params.items() if p.requires_grad)
    opt_state = fused.init_state(params) if fused is not None \
        else init_adamw_state({n: params[n] for n in trainable})
    amp = bool(strat["amp"].get("enable"))

    knobs = {}
    model_cfg = getattr(model, "config", None)
    if strat["recompute"].get("enable"):
        if not hasattr(model_cfg, "recompute"):
            raise NotImplementedError(
                "recompute: the port recomputes through the model's own "
                "config.recompute knob only, not a whole-loss checkpoint "
                "(ROADMAP \"Trainer options the port refuses\")")
        knobs = {"recompute": True}
        for knob in ("recompute_skip", "remat_policy"):
            if strat["recompute"].get(knob) is not None:
                knobs[knob] = strat["recompute"][knob]
    gm = strat["gradient_merge"]
    k_steps = int(gm.get("k_steps", 1)) if gm.get("enable") else 1
    gm_avg = bool(gm.get("avg", True))

    def compute_loss(*batch):
        if amp:
            batch = tuple(b.to(torch.bfloat16) if b.dtype == torch.float32
                          else b for b in batch)
        loss = loss_fn(model(batch[0]), *batch[1:]).to(torch.float32)
        return loss * share if share != 1.0 else loss

    share = 1.0

    def loss_and_grads(work, *batch):
        """Forward and backward over `work` (the bound params); returns
        (loss, {name: grad}) with grads in the masters' dtypes."""
        if k_steps <= 1:
            loss = compute_loss(*batch)
            loss.backward()
            return loss.detach(), {n: _grad(work[n]).to(params[n].dtype)
                                   for n in trainable}
        micro = [b.reshape((k_steps, b.shape[0] // k_steps) + b.shape[1:])
                 for b in batch]
        acc = {n: torch.zeros(params[n].shape, dtype=torch.float32,
                              device=dev) for n in trainable}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(k_steps):
            loss = compute_loss(*(b[i] for b in micro))
            loss.backward()
            for n in trainable:
                acc[n] += _grad(work[n]).to(torch.float32)
                work[n].grad = None
            loss_sum = loss_sum + loss.detach()
        scale = 1.0 / k_steps if gm_avg else 1.0
        return loss_sum / k_steps, {n: (acc[n] * scale).to(params[n].dtype)
                                    for n in trainable}

    warned = []

    def step_fn(p, state, *batch):
        nonlocal share
        batch = tuple(torch.as_tensor(b, device=dev) for b in batch)
        synced = dp
        if dp is not None:
            split = local_rows(batch, dp)
            if split is None:
                synced = None
                if not warned:
                    warned.append(True)
                    warnings.warn(
                        f"make_train_step: dp={dp.size} does not divide a "
                        "batch leaf's rows (or a leaf is 0-d): the batch "
                        "runs whole on every rank, no gradient sync")
            else:
                batch, share = split
        work = p
        if amp:
            work = {n: nn.Parameter(t.detach().to(torch.bfloat16),
                                    requires_grad=n in trainable)
                    if t.dtype == torch.float32 else t for n, t in p.items()}
        saved = {k: getattr(model_cfg, k) for k in knobs}
        try:
            for k, v in knobs.items():
                setattr(model_cfg, k, v)
            _bind(model, work)
            for n in trainable:
                work[n].grad = None
            loss, grads = loss_and_grads(work, *batch)
        finally:
            for k, v in saved.items():
                setattr(model_cfg, k, v)
            _bind(model, p)
        for n in trainable:
            work[n].grad = None
        share = 1.0
        if synced is not None:
            grads = sync_grads(grads, synced, quantized_collectives)
            loss = all_reduce(loss, synced)
        if fused is not None:
            p, state = fused.update(p, grads, state, fused.host_lr())
            fused.host_tick()
        else:
            p, state = adamw_update(p, grads, state, lr,
                                    weight_decay=weight_decay,
                                    grad_clip_norm=grad_clip_norm)
        return loss, p, state

    return step_fn, params, opt_state
