"""ZeRO stages 1-3 over the ``sharding`` mesh axis (counterpart of
paddle_tpu/parallel/sharding.py; Paddle's group_sharded_parallel,
group_sharded_stage2 / stage3).

The JAX package states every stage as a sharding spec on a global array
and lets XLA insert the collectives. Here each rank holds its block, and
the collectives are called:

- stage 1 (``"os"``): the optimizer state is sharded (dim 0 over the
  axis, on top of the parameter's own layout); the gradients are summed
  whole, each rank updates its rows, and the parameters are all-gathered;
- stage 2 (``"os_g"``): stage 1, and the gradients are reduce-scattered
  as the backward produces them (post-accumulate-grad hooks), so no rank
  holds the whole gradient set at once;
- stage 3 (``"p_g_os"``): stage 2, and the parameters live sharded. A
  weight is all-gathered just before its use and its gradient is
  reduce-scattered in the backward. A Llama model's projections gather
  through `gather_linear`, whose backward gathers again instead of
  keeping the gathered copy (so the copy lives only while it is used);
  other modules get the gathered weights swapped in by forward hooks
  (`ZeroHooks`), which save the block for the backward in place of the
  gathered weight and gather it again there.

`ShardPlan` is the layout of a model's parameters on this rank (a spec a
parameter, JAX's PartitionSpec entries over the global shape), and
`WeightDist` one weight's view of it; `ZeroState` the stages' optimizer
state, gradient cut, clip sums and gather after the update. The train step
(`parallel.trainer.make_train_step`) drives all three stages from the
``sharding`` strategy section; `group_sharded_parallel` is the eager
``loss.backward(); optimizer.step()`` API over the axis, as
`DataParallel` is over dp: every rank feeds its own rows and the
gradients are the ranks' mean.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from . import mesh as mesh_mod
from .collectives import (_all_gather_op, _key_rank, _reduce_scatter_op,
                          all_gather, all_reduce, broadcast_tree,
                          psum_tree, reduce_scatter)
from .placement import DistAttr, block_slices, dist_attr, spec_axes
from .ranks import GroupRef

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "shard_params_stage3", "shard_accumulators", "ShardPlan",
           "WeightDist", "ZeroHooks", "ZeroState", "gather_linear",
           "gather_tensor", "shard_dim0_spec"]

MP_AXIS = "mp"


def _pad(spec, ndim: int) -> tuple:
    spec = tuple(spec or ())
    return (spec + (None,) * ndim)[:ndim]


def shard_dim0_spec(spec, shape, mesh, axis: str) -> tuple:
    """`spec` with dim 0 sharded over `axis` where dim 0 is free, its size
    a multiple of the axis size and at least it (JAX's `_shard_dim0` and
    `_shardable`: one predicate for stage-3 params and stage-1/2 state);
    else `spec`. An axis the spec already uses is not used twice."""
    ndim = len(shape)
    spec = _pad(spec, ndim)
    if ndim == 0 or axis in [a for e in spec for a in spec_axes(e)]:
        return spec
    n = int(mesh.shape[axis])
    if spec[0] is None and shape[0] % n == 0 and shape[0] >= n:
        return (axis,) + spec[1:]
    return spec


class ShardPlan:
    """The parameters' layout on this rank: `specs` and global `shapes`
    by parameter name, over `mesh`. `row_axes` are the axes the current
    step's batch rows were split over (the train step sets them): a
    gathered weight's gradient is reduce-scattered over such an axis and
    sliced over any other (every rank then holds the whole gradient)."""

    def __init__(self, mesh, specs: Dict[str, tuple],
                 shapes: Dict[str, tuple]):
        self.mesh = mesh
        self.specs = {k: _pad(v, len(shapes[k])) for k, v in specs.items()}
        self.shapes = dict(shapes)
        self.row_axes: tuple = ()

    def gathers(self, name: str):
        """(axis, dim) a non-mp axis of size > 1 shards the parameter on,
        in gather order (a dim's minor axis first)."""
        out = []
        for d, entry in enumerate(self.specs[name]):
            for a in reversed(spec_axes(entry)):
                if a != MP_AXIS and self.mesh.shape.get(a, 1) > 1:
                    out.append((a, d))
        return out

    def mp_dim(self, name: str) -> Optional[int]:
        """The dim the mp axis (size > 1) splits, or None."""
        if self.mesh.shape.get(MP_AXIS, 1) <= 1:
            return None
        for d, entry in enumerate(self.specs[name]):
            if MP_AXIS in spec_axes(entry):
                return d
        return None

    def attr(self, name: str) -> DistAttr:
        return DistAttr(self.mesh, self.specs[name], self.shapes[name])

    def grad_mode(self, axis: str) -> str:
        return "reduce_scatter" if axis in self.row_axes else "slice"

    def gather_args(self, name: str) -> tuple:
        """The (key, size, dim, grad) of each gather of `name`'s block."""
        out = []
        for a, d in self.gathers(name):
            ref = self.mesh.axis_ref(a)
            out.append((ref.key, ref.size, d, self.grad_mode(a)))
        return tuple(out)


def _gather_raw(w, gathers):
    for key, size, dim, _ in gathers:
        w = _all_gather_op(w.contiguous(), key, size, dim, "slice")
    return w


def _reduce_raw(g, gathers):
    for key, size, dim, grad in reversed(gathers):
        if grad == "reduce_scatter":
            g = _reduce_scatter_op(g.contiguous(), key, size, dim)
        else:
            n = g.shape[dim] // size
            g = g.narrow(dim, _key_rank(key) * n, n)
    return g


class _GatherLinear(torch.autograd.Function):
    """y = x @ W (or x @ W.T) for W gathered from this rank's block `w`.
    Saves the block, not W: the backward gathers W again, then returns
    dx and the reduced gradient of the block. The products are autograd's
    own for a dense ``x @ W`` (its mm backward formulas), so a group of
    one gives a dense product's results bit for bit."""

    @staticmethod
    def forward(ctx, x, w, gathers, transpose):
        ctx.gathers, ctx.transpose = gathers, transpose
        ctx.save_for_backward(x, w)
        full = _gather_raw(w, gathers)
        return x @ (full.t() if transpose else full)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        full = _gather_raw(w, ctx.gathers)
        x2 = x.reshape(-1, x.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            mat = full if ctx.transpose else full.t()
            dx = dy2.mm(mat).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dfull = dy2.t().mm(x2) if ctx.transpose else x2.t().mm(dy2)
            dw = _reduce_raw(dfull, ctx.gathers)
        return dx, dw, None, None


def gather_linear(x: torch.Tensor, w: torch.Tensor, gathers=(),
                  transpose: bool = False):
    """x @ W for W all-gathered from the block `w` by `gathers` (the
    (key, size, dim, grad) tuples of `ShardPlan.gather_args`; empty: a
    plain product), with the ZeRO-3 backward (`_GatherLinear`)."""
    if not gathers:
        return x @ (w.t() if transpose else w)
    return _GatherLinear.apply(x, w, tuple(gathers), transpose)


def gather_full(w: torch.Tensor, gathers):
    """The weight gathered from its block through the autograd-aware
    all-gather (backward: reduce-scatter or slice, per `gathers`)."""
    for key, size, dim, grad in gathers:
        w = all_gather(w, GroupRef(key, size, _key_rank(key)), dim,
                       grad=grad)
    return w


class WeightDist:
    """One weight's place in a `ShardPlan`: a module that holds a sharded
    weight computes with `full` / `linear`, which gather its non-mp axes
    (the mp split stays the module's tensor-parallel business)."""

    def __init__(self, plan: ShardPlan, name: str):
        self.plan, self.name = plan, name

    @property
    def mp_dim(self) -> Optional[int]:
        return self.plan.mp_dim(self.name)

    def full(self, w: torch.Tensor) -> torch.Tensor:
        return gather_full(w, self.plan.gather_args(self.name))

    def linear(self, x, w, transpose: bool = False):
        return gather_linear(x, w, self.plan.gather_args(self.name),
                             transpose)


def gather_tensor(t: torch.Tensor) -> torch.Tensor:
    """The global tensor of a block (its DistAttr's sharded axes
    all-gathered, no gradient); a plain tensor comes back detached."""
    attr = dist_attr(t)
    if attr is None:
        return t.detach()
    out = t.detach()
    with torch.no_grad():
        for d, entry in enumerate(attr.spec):
            for a in reversed(spec_axes(entry)):
                if attr.mesh.shape.get(a, 1) > 1:
                    out = all_gather(out, attr.mesh.axis_ref(a), d)
        for a in attr.partial:
            out = all_reduce(out, attr.mesh.axis_ref(a))
    return out


def slice_params(model: nn.Module, plan: ShardPlan) -> None:
    """Make every parameter named in `plan` this rank's block of it under
    its spec, in place (the Parameter object stays, its data becomes the
    block and carries its DistAttr). A parameter already sharded keeps
    the axes it has: the new spec may only add axes (no exchange)."""
    for name, p in list(model.named_parameters()):
        if name not in plan.specs:
            continue
        old = dist_attr(p)
        spec = plan.specs[name]
        if old is not None and tuple(old.spec) == spec:
            continue
        shape = plan.shapes[name]
        if old is None:
            local = p.detach()[block_slices(plan.mesh, spec, shape)]
        else:
            local = p.detach()
            for d, (was, now) in enumerate(zip(old.spec, spec)):
                have, want = spec_axes(was), spec_axes(now)
                if want[:len(have)] != have:
                    raise ValueError(f"{name}: cannot reshard {old.spec} "
                                     f"to {spec} without an exchange")
                for a in want[len(have):]:
                    n = int(plan.mesh.shape.get(a, 1))
                    size = local.shape[d] // n
                    c = plan.mesh.axis_rank(a) if n > 1 else 0
                    local = local.narrow(d, c * size, size)
        # in place: an optimizer built over the parameters keeps them
        p.data = local.clone()
        p._dist = plan.attr(name)


def _regather_hooks(fulls):
    """(pack, unpack) for `torch.autograd.graph.saved_tensors_hooks`: a
    saved tensor that is a gathered weight of `fulls` ((full, block,
    gathers) triples), or a view of one, is saved as its block and the
    view's geometry, and gathered again when the backward unpacks it;
    any other tensor is saved as it is. The hooks outlive the call (the
    graph keeps them), so they hold the gathered weights by id only: the
    pack hook runs during the call, while the weights are alive."""
    by_id = {id(full): (block, gathers) for full, block, gathers in fulls}

    def pack(t):
        hit = by_id.get(id(t)) or (t._base is not None
                                   and by_id.get(id(t._base)))
        if hit:
            block, gathers = hit
            return (block.detach(), gathers, t.size(), t.stride(),
                    t.storage_offset())
        return t

    def unpack(saved):
        if not isinstance(saved, tuple):
            return saved
        block, gathers, size, stride, offset = saved
        return _gather_raw(block, gathers).as_strided(size, stride, offset)
    return pack, unpack


class ZeroHooks:
    """Stage 3 on a module with no sharding of its own: forward hooks on
    every submodule that owns a sharded parameter swap the gathered weight
    in for the call (its gradient reduced into the block) and the block
    back after. While the submodule runs, what autograd saves of a
    gathered weight is saved as the block and gathered again in the
    backward (`_regather_hooks`), so the gathered copy lives only during
    the call and again during its backward, as `gather_linear`'s."""

    def __init__(self, model: nn.Module, plan: ShardPlan):
        self.plan = plan
        by_mod: Dict[int, list] = {}
        mods = dict(model.named_modules())
        for name in plan.specs:
            if not plan.gathers(name):
                continue
            path, _, leaf = name.rpartition(".")
            by_mod.setdefault(id(mods[path]), [mods[path], path, []])[
                2].append((leaf, name))
        for mod, path, leaves in by_mod.values():
            mod.register_forward_pre_hook(self._pre(leaves))
            mod.register_forward_hook(self._post(leaves), always_call=True)

    def _pre(self, leaves):
        def hook(mod, inputs):
            blocks, fulls = {}, []
            for leaf, name in leaves:
                block = mod._parameters[leaf]
                gathers = self.plan.gather_args(name)
                full = gather_full(block, gathers)
                blocks[leaf] = block
                fulls.append((full, block, gathers))
                mod._parameters[leaf] = full
            saving = torch.autograd.graph.saved_tensors_hooks(
                *_regather_hooks(fulls))
            saving.__enter__()
            mod._zero_blocks, mod._zero_saving = blocks, saving
        return hook

    @staticmethod
    def _post(leaves):
        def hook(mod, inputs, output):
            saving = getattr(mod, "_zero_saving", None)
            if saving is None:
                return
            saving.__exit__(None, None, None)
            for leaf, _ in leaves:
                mod._parameters[leaf] = mod._zero_blocks[leaf]
            mod._zero_blocks, mod._zero_saving = {}, None
        return hook


def apply_plan(model: nn.Module, plan: ShardPlan):
    """Lay `model` out by `plan`: a model that shards itself (a Llama
    model's ``apply_shard_plan``) takes the plan; any other gets its
    blocks sliced and `ZeroHooks` (returned, else None)."""
    own = getattr(model, "apply_shard_plan", None)
    if own is not None:
        own(plan)
        return None
    slice_params(model, plan)
    return ZeroHooks(model, plan) if any(plan.gathers(n)
                                         for n in plan.specs) else None


def _mesh_and_axis(mesh, axis):
    mesh = mesh or mesh_mod.get_global_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return None
    return mesh


def shard_params_stage3(model: nn.Module, mesh=None, axis: str = "sharding"):
    """Lay every parameter out Shard(0) over the axis where dim 0 is free
    and divisible (stage 3), from each rank's same full weights. Without
    a mesh holding the axis, `model` is returned unchanged."""
    mesh = _mesh_and_axis(mesh, axis)
    if mesh is None:
        return model
    params = dict(model.named_parameters())
    shapes = {n: tuple(dist_attr(p).global_shape) if dist_attr(p)
              else tuple(p.shape) for n, p in params.items()}
    specs = {n: shard_dim0_spec(dist_attr(p).spec if dist_attr(p) else (),
                                shapes[n], mesh, axis)
             for n, p in params.items()}
    plan = ShardPlan(mesh, specs, shapes)
    plan.row_axes = (axis,)     # each rank feeds its own rows
    apply_plan(model, plan)
    return model


class ZeroState:
    """ZeRO's state over one mesh axis for a set of named parameters: the
    one object behind the train step (`parallel.trainer.make_train_step`)
    and the eager ``Optimizer.step`` (`shard_accumulators`).

    - `pspec[name]` is the parameter's own spec, `sspec[name]` its
      optimizer state's (from stage 1, dim 0 over `axis` where free:
      `shard_dim0_spec`), `shapes[name]` the global shape. `extra` holds
      the names whose state the axis shards and whose parameter it does
      not: a rank updates its rows of them (`view`), and the rows are
      all-gathered after the update (`gather`).
    - `sync` sums the gradients over the axes the batch rows were split
      on and cuts them to the state blocks: over `axis` a reduce-scatter
      where it is a row axis, else the rank's slice (from stage 2 as the
      backward produces each gradient: `scatter_hook`); over the other row
      axes an all-reduce (one a dtype and set of axes). A gradient that
      is a block already (a stage-3 gather's backward reduced it) is only
      summed over the axes left. The result is times `scale` (the eager
      path's mean over the axis).
    - `reduce_sq` turns the clip's per-leaf sums of squares of the state
      blocks into the global leaves': each summed over the axes its
      blocks differ on, so a replicated leaf counts once."""

    def __init__(self, mesh, params: Dict[str, torch.Tensor], trainable,
                 stage: int, axis: str = "sharding", scale: float = 1.0):
        self.mesh, self.stage, self.axis, self.scale = mesh, stage, axis, \
            scale
        self.shapes, self.pspec, self.sspec = {}, {}, {}
        for n, p in params.items():
            attr = dist_attr(p)
            self.shapes[n] = tuple(attr.global_shape) if attr \
                else tuple(p.shape)
            self.pspec[n] = _pad(attr.spec if attr else (), p.ndim)
        self.extra = set()
        for n in trainable:
            s = self.pspec[n]
            if stage >= 1:
                s = shard_dim0_spec(s, self.shapes[n], mesh, axis)
            self.sspec[n] = s
            if s != self.pspec[n] and mesh.shape[axis] > 1:
                self.extra.add(n)
        # stage 2: the blocks the hooks cut during the backward
        self.scattered: Dict[str, torch.Tensor] = {}

    def axes(self, spec) -> tuple:
        """The axes of a spec above size 1, in mesh order."""
        used = {a for e in spec for a in spec_axes(e)}
        return tuple(a for a in self.mesh.axis_names
                     if a in used and self.mesh.shape[a] > 1)

    def view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rows of `t` (a parameter block) this rank updates."""
        if name not in self.extra:
            return t
        ref = self.mesh.axis_ref(self.axis)
        rows = t.shape[0] // ref.size
        return t.narrow(0, ref.rank * rows, rows)

    def attr(self, name: str) -> DistAttr:
        """The place of `name`'s state blocks in the global state."""
        return DistAttr(self.mesh, self.sspec[name], self.shapes[name])

    def cut(self, g: torch.Tensor, row_axes) -> torch.Tensor:
        """This rank's rows of a whole gradient over the axis: summed
        (reduce-scatter) where the axis split the batch rows, else
        sliced."""
        ref = self.mesh.axis_ref(self.axis)
        if self.axis in row_axes:
            return reduce_scatter(g, ref, 0)
        rows = g.shape[0] // ref.size
        return g.narrow(0, ref.rank * rows, rows)

    def scatter_hook(self, name: str, row_axes, dtype=None):
        """A post-accumulate-grad hook that cuts the gradient of `name`
        as the backward produces it (stage 2) and frees the whole one."""
        @torch.no_grad()
        def hook(param):
            if param.grad is None:
                return
            self.scattered[name] = self.cut(param.grad, row_axes).to(
                dtype or param.grad.dtype, copy=True)
            param.grad = None
        return hook

    def sync(self, grads: Dict[str, torch.Tensor], row_axes,
             quantized: bool = False) -> Dict[str, torch.Tensor]:
        """`grads` (and the hooks' blocks) summed over the row axes and
        cut to the state blocks (the class docstring); `quantized` sums
        through the int8 `quantized_psum_tree`."""
        out, trees = {}, {}
        grads = {**grads, **self.scattered}
        for n in sorted(grads):   # the same collectives in the same order
            g = grads[n]
            done = set(self.axes(self.pspec[n]))
            if n in self.scattered:
                done.add(self.axis)
            elif n in self.extra and self.stage >= 2:
                g = self.cut(g, row_axes)
                done.add(self.axis)
            rest = tuple(a for a in row_axes if a not in done)
            out[n] = g
            trees.setdefault(rest, {})[n] = g
        self.scattered.clear()
        for rest, tree in trees.items():
            if rest:
                out.update(psum_tree(tree, self.mesh.group_ref(rest),
                                     quantized))
        for n in out:
            if self.stage == 1 and n in self.extra:
                out[n] = self.view(n, out[n])
            if self.scale != 1.0:
                out[n] = out[n] * self.scale
        return out

    def reduce_sq(self, names, sqs):
        """Per-leaf sums of squares of the state blocks -> the global
        leaves'."""
        groups: Dict[tuple, list] = {}
        for i, n in enumerate(names):
            groups.setdefault(self.axes(self.sspec[n]), []).append(i)
        out = list(sqs)
        for axes, idx in groups.items():
            if not axes:
                continue
            red = torch.stack([sqs[i] for i in idx])
            for a in axes:
                red = all_reduce(red, self.mesh.axis_ref(a))
            for j, i in enumerate(idx):
                out[i] = red[j]
        return out

    @torch.no_grad()
    def gather(self, params: Dict[str, torch.Tensor]) -> None:
        """Every rank's updated rows, all-gathered into the blocks (one
        gather a dtype)."""
        names = [n for n in sorted(self.extra) if n in params]
        if not names:
            return
        ref = self.mesh.axis_ref(self.axis)
        for dtype in dict.fromkeys(params[n].dtype for n in names):
            same = [n for n in names if params[n].dtype == dtype]
            flat = torch.cat([self.view(n, params[n]).reshape(-1)
                              for n in same])
            got = all_gather(flat[None], ref, 0)
            off = 0
            for n in same:
                p = params[n]
                k = self.view(n, p).numel()
                p.copy_(got[:, off:off + k].reshape(p.shape))
                off += k


def shard_accumulators(optimizer, mesh=None, axis: str = "sharding",
                       stage: int = 1):
    """Stage 1 (2 with `stage`): the optimizer keeps its state for its
    rows of each parameter whose dim 0 the axis divides, updates only
    those rows and all-gathers the parameters after its step; gradients
    are averaged over the axis (reduce-scattered as produced at stage 2).
    The state is a `ZeroState` over the parameters named by their place
    in the optimizer (``optimizer._zero``, ``_zero_names``). Without a
    mesh holding the axis, `optimizer` is returned unchanged."""
    mesh = _mesh_and_axis(mesh, axis)
    if mesh is None:
        return optimizer
    params = {str(i): p for i, p in enumerate(optimizer._parameter_list)}
    zero = ZeroState(mesh, params, [n for n, p in params.items()
                                    if p.requires_grad], stage, axis,
                     scale=1.0 / mesh.shape[axis])
    if stage >= 2:
        for n in sorted(zero.extra):
            params[n].register_post_accumulate_grad_hook(
                zero.scatter_hook(n, (axis,)))
    optimizer._zero = zero
    optimizer._zero_names = {id(p): n for n, p in params.items()}
    return optimizer


def group_sharded_parallel(model: nn.Module, optimizer, level: str = "p_g_os",
                           scaler=None, group=None, offload=False,
                           sync_buffers=False, buffer_max_size=2 ** 23,
                           segment_size=2 ** 20, sync_comm=False,
                           dp_group=None, exclude_layer=None):
    """Paddle's ``group_sharded_parallel(model, optimizer, level)`` with
    level "os" (stage 1), "os_g" (stage 2) or "p_g_os" (stage 3) over the
    global mesh's ``sharding`` axis (unchanged without one). Every rank
    starts from its axis group's first rank's parameters, feeds its own
    rows, and the gradients are the ranks' mean."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"level must be os|os_g|p_g_os, got {level}")
    mesh = _mesh_and_axis(None, "sharding")
    if mesh is not None:
        broadcast_tree([p.data for p in model.parameters()],
                       mesh.axis_ref("sharding"), 0)
        if level == "p_g_os":
            model = shard_params_stage3(model, mesh)
        optimizer = shard_accumulators(optimizer, mesh, "sharding",
                                       stage=1 if level == "os" else 2)
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


def save_group_sharded_model(model: nn.Module, output: str, optimizer=None):
    """Gather the shards and save the model's state (``output.pdparams``,
    and ``output.pdopt`` with `optimizer`) from the axis group's first
    rank; every rank calls it."""
    from ..framework.io import save

    import torch.distributed as dist

    params = dict(model.named_parameters())
    state = {k: gather_tensor(params.get(k, v))
             for k, v in model.state_dict().items()}
    opt_state = None
    if optimizer is not None:
        opt_state = {k: gather_tensor(v) if isinstance(v, torch.Tensor)
                     else v for k, v in optimizer.state_dict().items()}

    if dist.is_initialized() and dist.get_rank() != 0:
        return
    out = str(output)
    save(state, out if out.endswith(".pdparams") else out + ".pdparams")
    if opt_state is not None:
        save(opt_state, out + ".pdopt")
