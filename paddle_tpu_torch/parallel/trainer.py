"""The train step (counterpart of paddle_tpu/parallel/trainer.py), on one
GPU or over a mesh of ranks.

    step_fn, params, opt_state = make_train_step(model, loss_fn, None, ...)
    loss, params, opt_state = step_fn(params, opt_state, x, y)

the JAX package's calling convention, so one loop drives both packages.
JAX jits a pure (params, opt_state, batch) -> (loss, params', opt_state')
function with donated buffers; here the step runs eagerly under autograd
and updates the params and the optimizer state in place (the donation's
effect, stated: the returned dicts are the ones passed in). `params` maps
``model.named_parameters()`` keys to the model's own ``nn.Parameter``s
(on a sharded mesh, this rank's blocks), so the model must hold trainable
weights (``load_params(..., trainable=True)`` or ``init_train_params``).

Ported: the default fused AdamW (``adamw_update``: global-norm clip at
1.0, moments in the params' dtype, decay on ndim > 1 only), the
``optimizer=`` route through ``FusedOptimizer``, and the strategy
sections ``amp``, ``recompute``, ``gradient_merge`` and ``sharding`` (a
dict of section dicts). A whole-loss checkpoint for a model without a
``config.recompute`` knob is refused ("Trainer options the port
refuses").

**Over a mesh** (``mesh=``, default the global mesh of `parallel.mesh`;
axes ``dp``, ``sharding``, ``sep``, ``mp``). JAX lays the global batch
over `batch_spec` (default ``(("dp", "sharding"), "sep")``: the rows over
the longest prefix of dp x sharding whose product divides them, the
sequence over sep where it divides it) and the compiler makes every
collective. Here every rank is handed the same global batch and takes
its rows (the row-major block of its coordinates on those axes) and, over
sep, its slice of their sequence (`seq_axes`). Only a model that
declares ``handles_seq_shard`` is handed a slice (a Llama model: it runs
inside `sequence_parallel.seq_sharded`, so it rotates the slice at its
global positions and attends over the whole sequence), and its loss must
be a mean over the tokens; any other model runs the whole sequence on
every sep rank, which then replicates the step. A rank's loss is its
tokens' mean weighted by its share of the rows x tokens, so sums over
the row axes and sep give the global mean's gradients and loss. The
gradients follow the batch, not the layout:

- over a row axis and over sep (which replicates every parameter) they
  are summed: by the reduce-scatter of a sharded
  parameter's gather (stage 3, ``shard_llama``), by the stage-2 hooks'
  reduce-scatter as the backward produces them, else by all-reduces (one
  a dtype and set of axes, `collectives.all_reduce_tree`, or with
  ``quantized_collectives`` the int8 `quantized_psum_tree`; the groups
  of ``dp``, ``sharding`` and ``sep`` together are the mesh's summed
  groups);
- over an axis the rows were not split on, each rank holds the whole
  gradient already and takes its block;
- over ``mp`` the rows are replicated: a parameter's gradient is its
  block's (the model's f / g operators make it whole).

The sum lands before the clip and the update. The global-norm clip sums
each block's squares over the axes on which the blocks differ (a
replicated leaf counts once). ZeRO (``sharding`` section: ``enable``,
``stage`` 1 / 2 / 3, default 2, ``axis``, default "sharding";
`parallel.sharding`, whose `ZeroState` holds the layout, the gradient
sync, the clip's sums and the gather for this step and the eager
optimizer alike): stage 3 shards each parameter's free dim 0 over the
axis; every stage keeps the optimizer state sharded there too, so a rank
updates its rows of a parameter the axis does not shard and the rows are
all-gathered after the update. Parameters an axis replicates are
broadcast from its first rank when the step is built, so the ranks hold
equal values and, step after step, stay bitwise equal.

With gradient merge the micro-batches accumulate locally and sum once
(a stage-3 gather reduces its gradient in each micro-batch's backward).
A batch whose rows the row axes do not divide (or a 0-d leaf) runs whole
on every rank, with a warning: JAX replicates such a batch.

A ``pp`` axis above 1 is one more replica axis here, as in JAX's
``make_train_step`` (which has no pipeline code: its step is replicated
over pp, so each pp rank runs the whole step on the same rows and the
ranks stay equal). Pipeline training is
``models.llama_pipe.make_llama_pp_train_step`` over
`parallel.pipeline_spmd`, whose schedule, microbatches and interleave
degree the strategy's ``pipeline`` section may set (`resolve_pipeline`).
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..kernels._build import tracing
from . import mesh as mesh_mod
from .collectives import all_gather, all_reduce, broadcast_tree
from .fused_optimizer import FusedOptimizer
from .sequence_parallel import seq_sharded
from .sharding import ShardPlan, ZeroState, apply_plan, shard_dim0_spec


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
                 grad_clip_norm: Optional[float] = 1.0, reduce_sq=None):
    """AdamW with global-norm clipping over the params that have a grad,
    in place (JAX ``adamw_update``, op for op: the moments are computed
    in f32 and stored in their own dtype). Weight decay applies to params
    with ndim > 1 only. `reduce_sq` maps the per-leaf sums of squares to
    the global tensors' (a sharded step's blocks). Returns (params, new
    state)."""
    step = state.step + 1
    names = sorted(n for n in params if n in grads)
    gs = [grads[n] for n in names]
    if grad_clip_norm is not None:
        sqs = [torch.sum(torch.square(g.to(torch.float32))) for g in gs]
        if reduce_sq is not None:
            sqs = reduce_sq(names, sqs)
        gnorm = torch.sqrt(sum(sqs))
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
    """A strategy dict, an object with section attributes, or None -> one
    plain dict per section."""
    out = {s: {} for s in _SECTIONS}
    if strategy is None:
        return out
    for s in _SECTIONS:
        val = strategy.get(s) if isinstance(strategy, dict) \
            else getattr(strategy, s, None)
        if isinstance(val, dict):
            out[s] = dict(val)
    return out


def resolve_pipeline(strategy, schedule=None, n_micro=None,
                     vpp_degree=None):
    """(schedule, n_micro, vpp_degree) of a pipeline step: the explicit
    arguments win over the strategy's ``pipeline`` section
    (``schedule_mode``, ``accumulate_steps``, ``vpp_degree``; a section
    with ``enable`` False is ignored), which wins over the defaults
    (1F1B, n_micro None: the pp degree, vpp_degree 2). An
    ``accumulate_steps`` of 1 or less is the pass's own default, not a
    request for a one-microbatch pipeline (JAX's rule)."""
    if strategy is not None:
        pipe = _resolve_strategy(strategy)["pipeline"]
        if pipe.get("enable", True):
            if pipe.get("schedule_mode") and schedule is None:
                schedule = pipe["schedule_mode"]
            if n_micro is None and int(
                    pipe.get("accumulate_steps") or 0) > 1:
                n_micro = int(pipe["accumulate_steps"])
            if pipe.get("vpp_degree") and vpp_degree is None:
                vpp_degree = int(pipe["vpp_degree"])
    return (schedule or "1F1B", n_micro,
            2 if vpp_degree is None else int(vpp_degree))


def _grad(p: torch.Tensor) -> torch.Tensor:
    # a param the loss does not reach gets a zero grad, as jax.grad gives
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _stand_ins(params: Dict[str, torch.Tensor]) -> bool:
    """Whether `params` are the stand-ins of an analysis trace
    (`analysis.graph` traces a whole step on fake tensors), not
    ``nn.Parameter``s."""
    return tracing() and any(not isinstance(p, nn.Parameter)
                             for p in params.values())


def _bind(model: nn.Module, params: Dict[str, nn.Parameter]) -> None:
    """Make `params` the model's parameters (by key). A tensor that is no
    ``nn.Parameter`` takes the parameter's slot only as a trace's
    stand-in (`_stand_ins`); otherwise it raises."""
    trace = _stand_ins(params)
    for name, p in params.items():
        path, _, leaf = name.rpartition(".")   # a top-level param: path ""
        mod = model.get_submodule(path)
        if getattr(mod, leaf) is p:
            continue
        if isinstance(p, nn.Parameter):
            setattr(mod, leaf, p)
        elif trace:
            mod._parameters[leaf] = p
        else:
            raise TypeError(f"{name}: the step's params must be the "
                            f"model's nn.Parameters, not {type(p).__name__}"
                            " (load_params(..., trainable=True))")


def row_axes(mesh, batch, batch_spec=None) -> tuple:
    """The axes a batch's rows split over (JAX's `batch_sharding` on dim
    0: the longest prefix of batch_spec[0]'s axes whose product divides
    the rows), or () when a leaf is 0-d or the leaves' rows differ."""
    if mesh is None or not batch:
        return ()
    if any(b.ndim == 0 or b.shape[0] != batch[0].shape[0] for b in batch):
        return ()
    dims = batch_spec or (("dp", "sharding"), "sep")
    d0 = dims[0] if dims else None
    names = (d0,) if isinstance(d0, str) else tuple(d0 or ())
    kept = mesh_mod.divisible_prefix(mesh, batch[0].shape[0], names)
    return tuple(a for a in kept if mesh.shape[a] > 1)


def seq_axes(mesh, batch, batch_spec=None, model=None) -> tuple:
    """("sep",) when the batch's tokens split over the sep axis (JAX's
    `batch_sharding` on dim 1: batch_spec[1] names sep, above 1, and it
    divides the sequence of every leaf, all of one length) and `model`
    declares ``handles_seq_shard``, else (): a sequence that sep does not
    divide stays whole, as JAX keeps it, and so does the sequence of a
    model that computes over its tokens alone (each sep rank then runs
    the whole step). A later dim laid over another axis stays whole too
    (the values are JAX's global ones either way)."""
    sep = mesh_mod.SEP_AXIS
    if mesh is None or not batch or mesh.shape.get(sep, 1) <= 1 \
            or not getattr(model, "handles_seq_shard", False):
        return ()
    dims = batch_spec or (("dp", "sharding"), "sep")
    d1 = dims[1] if len(dims) > 1 else None
    if sep not in ((d1,) if isinstance(d1, str) else tuple(d1 or ())):
        return ()
    if any(b.ndim < 2 or b.shape[1] != batch[0].shape[1] for b in batch) \
            or batch[0].shape[1] % mesh.shape[sep]:
        return ()
    return (sep,)


def take_rows(mesh, batch, axes, seq=()):
    """(this rank's rows of every leaf over `axes` and its slice of their
    sequence over `seq`, its share of the batch's rows x tokens)."""
    n = math.prod(mesh.shape[a] for a in axes)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.axis_rank(a)
    rows = batch[0].shape[0] // n
    out = tuple(b[idx * rows:(idx + 1) * rows] for b in batch)
    if seq:
        m, j = mesh.shape[seq[0]], mesh.axis_rank(seq[0])
        s = batch[0].shape[1] // m
        out = tuple(b[:, j * s:(j + 1) * s] for b in out)
        n *= m
    return out, 1.0 / n


def _broadcast_replicas(mesh, params, layout) -> None:
    """Every parameter from the first rank of each axis that replicates
    it (the ranks start equal, as JAX's one global value)."""
    for axis in mesh.axis_names:
        if mesh.shape[axis] <= 1:
            continue
        same = [p.data for n, p in params.items()
                if axis not in layout.axes(layout.pspec[n])]
        broadcast_tree(same, mesh.axis_ref(axis), 0)


def make_train_step(model: nn.Module, loss_fn: Callable, mesh=None,
                    lr: float = 1e-4, weight_decay: float = 0.01,
                    grad_clip_norm: Optional[float] = 1.0,
                    batch_spec: Optional[Tuple] = None, optimizer=None,
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
      - sharding.enable + stage / axis: ZeRO stage 1 / 2 / 3 over the
        mesh's axis (the module docstring).
    `mesh` (default: the global mesh) trains over its axes (the module
    docstring; pp replicates the step), the rows laid by `batch_spec`;
    `quantized_collectives` makes the all-reduce of the gradients the
    int8 `quantized_psum_tree`.
    """
    strat = _resolve_strategy(strategy)
    mesh = mesh if mesh is not None else mesh_mod.get_global_mesh()
    dev = resolve_device(device)
    params = dict(model.named_parameters())
    for name, p in params.items():
        if p.device != dev:
            raise ValueError(f"{name} lives on {p.device}, the step on {dev}"
                             " (load the params there first)")
    shard_cfg = strat["sharding"]
    shard_axis = shard_cfg.get("axis", "sharding")
    stage = int(shard_cfg.get("stage", 2)) if shard_cfg.get("enable") \
        and mesh is not None and shard_axis in mesh.axis_names else 0
    sharded = mesh is not None and mesh.size > 1
    plan = getattr(model, "_shard_plan", None)
    hooks = None
    if stage >= 3:
        lay = ZeroState(mesh, params, (), 0, shard_axis)
        specs = {n: shard_dim0_spec(lay.pspec[n], lay.shapes[n], mesh,
                                    shard_axis) for n in params}
        if any(specs[n] != lay.pspec[n] for n in params):
            plan = ShardPlan(mesh, specs, lay.shapes)
            hooks = apply_plan(model, plan)
            params = dict(model.named_parameters())
    fused = FusedOptimizer(optimizer, model) if optimizer is not None \
        else None
    trainable = fused.trainable if fused is not None else frozenset(
        n for n, p in params.items() if p.requires_grad)
    layout = ZeroState(mesh, params, trainable, stage, shard_axis) \
        if sharded else None
    if hooks is not None:
        plan = hooks.plan
    if sharded:
        _broadcast_replicas(mesh, params, layout)
    views = {n: layout.view(n, params[n]) if layout else params[n]
             for n in trainable}
    opt_state = fused.init_state(views) if fused is not None \
        else init_adamw_state(views)
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
    # stage 2's reduce-scatter as the backward produces each gradient
    hook_scatter = sharded and stage == 2 and k_steps <= 1
    scattered = layout.scattered if sharded else {}

    def compute_loss(*batch):
        if amp:
            batch = tuple(b.to(torch.bfloat16) if b.dtype == torch.float32
                          else b for b in batch)
        with seq_sharded(mesh if seq else None):
            out = model(batch[0])
        loss = loss_fn(out, *batch[1:]).to(torch.float32)
        return loss * share if share != 1.0 else loss

    share, seq = 1.0, ()

    def loss_and_grads(work, *batch):
        """Forward and backward over `work` (the bound params); returns
        (loss, {name: grad}) with grads in the masters' dtypes."""
        if k_steps <= 1:
            loss = compute_loss(*batch)
            loss.backward()
            return loss.detach(), {n: _grad(work[n]).to(params[n].dtype)
                                   for n in trainable
                                   if n not in scattered}
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
    d0 = (batch_spec or (("dp", "sharding"),))[0] if sharded else None
    wanted = tuple(a for a in ((d0,) if isinstance(d0, str) else d0 or ())
                   if mesh.shape.get(a, 1) > 1)

    def step_fn(p, state, *batch):
        nonlocal share, seq
        batch = tuple(torch.as_tensor(b, device=dev) for b in batch)
        axes = ()
        if sharded:
            axes = row_axes(mesh, batch, batch_spec)
            seq = seq_axes(mesh, batch, batch_spec, model)
            if axes or seq:
                batch, share = take_rows(mesh, batch, axes, seq)
            if not axes and not warned and wanted:
                warned.append(True)
                warnings.warn(
                    f"make_train_step: the row axes {wanted} do not divide "
                    "a batch leaf's rows (or a leaf is 0-d): the batch's "
                    "rows run whole on every rank, no gradient sum over "
                    "them")
        if plan is not None:
            plan.row_axes = axes
        work = p
        if amp:
            work = {n: nn.Parameter(t.detach().to(torch.bfloat16),
                                    requires_grad=n in trainable)
                    if t.dtype == torch.float32 else t for n, t in p.items()}
        saved = {k: getattr(model_cfg, k) for k in knobs}
        live = dict(model.named_parameters())
        handles = []
        try:
            for k, v in knobs.items():
                setattr(model_cfg, k, v)
            _bind(model, work)
            for n in trainable:
                work[n].grad = None
            if hook_scatter:
                handles = [work[n].register_post_accumulate_grad_hook(
                    layout.scatter_hook(n, axes, params[n].dtype))
                    for n in sorted(layout.extra)]
            loss, grads = loss_and_grads(work, *batch)
        finally:
            for h in handles:
                h.remove()
            for k, v in saved.items():
                setattr(model_cfg, k, v)
            # a trace's stand-ins leave, the model keeps its own params
            _bind(model, live if _stand_ins(p) else p)
        for n in trainable:
            work[n].grad = None
        # the tokens split over sep: each rank's gradients and loss are
        # its tokens' part, summed with the rows' over the row axes
        summed = axes + seq
        share, seq = 1.0, ()
        if sharded:
            grads = layout.sync(grads, summed, quantized_collectives)
            if summed:
                loss = all_reduce(loss, mesh.group_ref(summed))
        upd = {n: layout.view(n, p[n]) if layout else p[n]
               for n in trainable}
        reduce_sq = layout.reduce_sq if sharded else None
        if fused is not None:
            _, state = fused.update(upd, grads, state, fused.host_lr(),
                                    reduce_sq=reduce_sq)
            fused.host_tick()
        else:
            _, state = adamw_update(upd, grads, state, lr,
                                    weight_decay=weight_decay,
                                    grad_clip_norm=grad_clip_norm,
                                    reduce_sq=reduce_sq)
        if sharded:
            layout.gather(p)
        return loss, p, state

    if fused is not None:
        step_fn.fused_optimizer = fused
    step_fn.layout = layout
    return step_fn, params, opt_state


def make_eval_step(model: nn.Module, mesh=None, batch_spec=None,
                   device=None):
    """``fwd(params, inputs) -> outputs`` of the whole batch (JAX's
    ``make_eval_step``) on `device` (default: the CUDA card, where the
    model's params must live): `params` (the step's dict, or None for the
    model's own) bound to the model, every rank runs its rows of `inputs`
    under no_grad in eval mode and the outputs are all-gathered over the
    row axes, so each rank returns the global batch's."""
    mesh = mesh if mesh is not None else mesh_mod.get_global_mesh()
    dev = resolve_device(device)

    def fwd(p, inputs):
        inputs = torch.as_tensor(inputs, device=dev)
        axes, seq = (), ()
        if mesh is not None and mesh.size > 1:
            axes = row_axes(mesh, (inputs,), batch_spec)
            seq = seq_axes(mesh, (inputs,), batch_spec, model)
        if axes or seq:
            (inputs,), _ = take_rows(mesh, (inputs,), axes, seq)
        plan = getattr(model, "_shard_plan", None)
        if plan is not None:
            plan.row_axes = axes
        was = model.training
        live = dict(model.named_parameters())
        try:
            if p is not None:
                _bind(model, p)
            model.train(False)
            with torch.no_grad(), seq_sharded(mesh if seq else None):
                out = model(inputs)
        finally:
            model.train(was)
            if p is not None:
                _bind(model, live)
        if seq:
            out = all_gather(out, mesh.axis_ref(seq[0]), 1)
        if axes:
            out = all_gather(out, mesh.group_ref(axes), 0)
        return out

    return fwd
