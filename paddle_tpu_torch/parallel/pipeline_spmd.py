"""Pipeline parallelism over the ``pp`` mesh axis on torch.distributed
ranks (counterpart of paddle_tpu/parallel/pipeline_spmd.py).

The JAX package runs a pipeline as ONE ``shard_map`` program: a
``lax.scan`` over ticks whose boundary activations move by
``lax.ppermute``, the backward by autodiff of the scan or a hand-written
tick body. Here each pp rank is a process that runs its own stage's
schedule in Python: a tick table (the JAX scan's, tick for tick:
`parallel.pipeline_viz.pipeline_timeline` draws it) of forward slots,
backward slots and, at the end of every tick, the boundary exchange with
the neighbouring stages, each hop one ``paddle_tpu_comm::ppermute``
operator (`collectives.send_recv`, so the communication audit sees it).
A slot is plain autograd: a forward keeps its graph from a detached input
that requires grad, a backward is ``torch.autograd.backward`` of the
stage's output with the cotangent the next stage sent back, and the
input's gradient goes to the previous stage.

- `pipeline_forward` (GPipe / FThenB) and `pipeline_vpp_forward` (VPP:
  `vpp_degree` interleaved chunks a rank, Megatron's assignment) are
  differentiable: one autograd Function whose forward runs every forward
  slot and keeps each microbatch's graph (the GPipe memory profile), and
  whose backward replays the ticks in reverse. Their output is the last
  stage's, broadcast to every pp rank (JAX returns it replicated); the
  backward takes the last stage's cotangent (every rank computes the same
  downstream), and the input's gradient lands on the first stage (zero on
  the others: summed over pp it is JAX's).
- `pipeline_1f1b`, `pipeline_zb1f1b`, `pipeline_eager_1f1b` run forward
  and backward in one pass with the head (``head_fn``: the last stage's
  norm, head and loss) inside the pipeline, and return JAX's
  ``(loss, d_stages, d_head, d_x)``: the loss the mean over
  microbatches, on every rank; the rank's block of the stage gradients
  (f32, leading stage dim 1); the head's and the input's gradients whole
  on every rank. 1F1B keeps a microbatch's graph from its forward slot
  to its backward slot (in flight at most 2(S - s) - 1 microbatches at
  stage s, no recompute); Eager1F1B doubles the tick stride so every
  received boundary rests one tick before it is used (JAX's comm slack,
  more in flight); ZBH1's backward slot computes the activation gradient
  alone (the stage ran on detached weights, so ``torch.autograd.grad``
  to the input skips every weight product) and saves (input, cotangent),
  and after the last tick one batched forward and backward over all
  microbatches makes the weight gradients (JAX's vmapped W pass).
  With ``head_specs`` the head is cooperative: the last stage's output is
  broadcast over pp each tick and every rank evaluates its own shard of
  the head (a leaf whose spec names the axis is sliced over it); the
  head function combines its pieces with collectives over the axis
  itself (``models.llama_pipe``'s ``coop_head_fn``), and the cotangent
  of the hidden is the sum of the ranks' parts, which hop to the last
  stage.

Every rank makes its collectives and hops in the same order, tick by
tick (a mismatch hangs gloo). The errors are JAX's: a batch not divisible
by n_micro, a stage dim other than the pp degree, VPP's n_micro not a
multiple of pp, Eager combined with deferred weight gradients.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from . import mesh as mesh_mod
from .collectives import all_gather, all_reduce, broadcast, send_recv
from .placement import DistAttr, dist_attr, spec_axes

__all__ = ["pipeline_forward", "pipeline_1f1b", "pipeline_eager_1f1b",
           "pipeline_vpp_forward", "pipeline_zb1f1b", "stack_stage_params",
           "unstack_stage_params", "record_slots", "slot_times"]


# ---------------------------------------------------------------------------
# stage parameters
# ---------------------------------------------------------------------------

def _pp(mesh, axis: str):
    """(mesh, this rank's GroupRef on `axis`), the ref None where the axis
    is missing or of size 1."""
    mesh = mesh if mesh is not None else mesh_mod.get_global_mesh()
    if mesh is None or axis not in mesh.axis_names \
            or int(mesh.shape[axis]) == 1:
        return mesh, None
    return mesh, mesh.axis_ref(axis)


def stack_stage_params(per_stage_params: list, mesh=None, axis: str = "pp"):
    """Stack a list of per-stage trees along a new leading stage dim. On a
    mesh whose `axis` exceeds 1 each rank keeps its stage's block (stage
    dim 1, a `DistAttr` naming the global shape): the pp analog of ZeRO
    partitioning, as JAX shards the stage dim over the axis."""
    stacked = pytree.tree_map(lambda *xs: torch.stack(xs),
                              per_stage_params[0], *per_stage_params[1:])
    mesh, ref = _pp(mesh, axis)
    if ref is None:
        return stacked

    def block(x):
        b = x[ref.rank:ref.rank + 1].clone()
        b._dist = DistAttr(mesh, (axis,) + (None,) * (x.ndim - 1),
                           tuple(x.shape))
        return b

    return pytree.tree_map(block, stacked)


def unstack_stage_params(stacked, n_stages: int):
    return [pytree.tree_map(lambda x, i=i: x[i], stacked)
            for i in range(n_stages)]


def _rank_block(stacked, n_stages: int, rank: int, axis: str):
    """The rank's block (stage dim 1) of a stacked tree given whole
    (stage dim n_stages) or as the rank's block (stage dim 1, or a
    `DistAttr` over the axis); raises where the global stage dim is not
    `n_stages`."""
    def one(x):
        attr = dist_attr(x)
        if attr is not None and attr.spec and axis in spec_axes(
                attr.spec[0]):
            n, blk = int(attr.global_shape[0]), x
        elif x.shape[0] == 1:
            n, blk = n_stages, x
        else:
            n, blk = int(x.shape[0]), x[rank:rank + 1]
        if n != n_stages:
            raise ValueError(
                f"stacked stage dim {n} != pp axis size {n_stages}; group "
                "layers into exactly one block per pp rank")
        return blk

    return pytree.tree_map(one, stacked)


def _micro(x, n_micro: int):
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro "
                         f"{n_micro}")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# slot timing (chip_smoke's measured bubble share)
# ---------------------------------------------------------------------------

_SLOTS = {"on": False, "marks": []}


def record_slots(on: bool = True) -> None:
    """Start (or stop) recording the compute slots' spans: CUDA events
    around each forward, head, backward and weight slot on a CUDA rank,
    host clocks on the CPU. `slot_times` reads them."""
    _SLOTS["on"] = bool(on)
    _SLOTS["marks"] = []


class _slot:
    def __init__(self, kind: str, device):
        self.kind, self.cuda = kind, torch.device(device).type == "cuda"

    def __enter__(self):
        if not _SLOTS["on"]:
            return self
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not _SLOTS["on"]:
            return False
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
        else:
            t1 = time.perf_counter()
        _SLOTS["marks"].append((self.kind, self.t0, t1))
        return False


def slot_times() -> list:
    """[(kind, ms)] of the slots recorded since `record_slots(True)`
    (synchronizes the card first)."""
    out = []
    for kind, t0, t1 in _SLOTS["marks"]:
        if isinstance(t0, float):
            out.append((kind, 1e3 * (t1 - t0)))
        else:
            t1.synchronize()
            out.append((kind, t0.elapsed_time(t1)))
    return out


# ---------------------------------------------------------------------------
# the hop
# ---------------------------------------------------------------------------

def _hop(ref, send: Optional[torch.Tensor], dst: int, recv: bool, src: int,
         like):
    """One exchange of a tick in one direction: `send` to stage `dst`
    (None: nothing), a tensor shaped like `like` (shape, dtype, device)
    from stage `src` when `recv`. Returns the received tensor or None."""
    if send is None and not recv:
        return None
    shape, dtype, device = like
    x = send if send is not None else torch.empty(shape, dtype=dtype,
                                                  device=device)
    got = send_recv(x, ref, dst if send is not None else -1,
                    src if recv else -1)
    return got if recv else None


# ---------------------------------------------------------------------------
# GPipe / FThenB and VPP: one differentiable forward
# ---------------------------------------------------------------------------

def _interleaved_table(S: int, V: int, M: int):
    """table[r][t] = (chunk v, microbatch m) rank r runs at tick t, or
    None (JAX's pipeline_vpp_forward clock; V = 1 is pipeline_forward's)."""
    SV, T = S * V, M * V + S - 1
    table = []
    for r in range(S):
        row = []
        for t in range(T):
            u = t - r
            if 0 <= u < M * V:
                g, w = u // SV, u % SV
                row.append((w // S, g * S + (w % S)))
            else:
                row.append(None)
        table.append(row)
    return table


class _InterleavedRun:
    """One call's ticks: `forward` runs the forward slots keeping their
    graphs, `backward` replays them in reverse."""

    def __init__(self, fn, treedef, ref, V: int, n_micro: int):
        self.fn, self.treedef, self.ref = fn, treedef, ref
        self.S, self.r, self.V, self.M = ref.size, ref.rank, V, n_micro
        self.table = _interleaved_table(self.S, V, n_micro)

    def _chunk(self, blocks, v):
        if self.V == 1:
            return pytree.tree_unflatten([b[0] for b in blocks],
                                         self.treedef)
        return pytree.tree_unflatten([b[0, v] for b in blocks],
                                     self.treedef)

    def _is_last(self, r, v):
        return r == self.S - 1 and v == self.V - 1

    def forward(self, x, leaves):
        S, r, M = self.S, self.r, self.M
        self.blocks = [b.detach().requires_grad_(True) for b in leaves]
        with torch.enable_grad():   # a Function's forward runs without
            chunks = [self._chunk(self.blocks, v) for v in range(self.V)]
        micro = _micro(x, M)
        like = (tuple(micro.shape[1:]), x.dtype, x.device)
        self.like = like
        prev, nxt = (r - 1) % S, (r + 1) % S
        inbox, outs, self.saved = {}, {}, {}
        for t in range(len(self.table[r])):
            cell, send = self.table[r][t], None
            if cell is not None:
                v, m = cell
                xin = micro[m] if (r == 0 and v == 0) else inbox.pop((v, m))
                x_leaf = xin.detach().requires_grad_(True)
                with _slot("F", x.device), torch.enable_grad():
                    y = self.fn(chunks[v], x_leaf)
                self.saved[t] = (x_leaf, y)
                if self._is_last(r, v):
                    outs[m] = y
                else:
                    send = y.detach()
            pc = self.table[prev][t]
            recv = pc is not None and not self._is_last(prev, pc[0])
            got = _hop(self.ref, send, nxt, recv, prev, like)
            if recv:
                # the chunk after prev's (v, m) runs here at t + 1
                pv, pm = pc
                inbox[(pv + 1 if prev == S - 1 else pv, pm)] = got
        if r == S - 1:
            out = torch.cat([outs[m].detach() for m in range(M)])
        else:
            out = torch.empty(tuple(x.shape), dtype=x.dtype, device=x.device)
        return broadcast(out, self.ref, S - 1)

    def backward(self, g):
        S, r, M = self.S, self.r, self.M
        prev, nxt = (r - 1) % S, (r + 1) % S
        g_micro = _micro(g, M) if r == S - 1 else None
        inbox, dxs = {}, {}
        for t in reversed(range(len(self.table[r]))):
            cell, send = self.table[r][t], None
            if cell is not None:
                v, m = cell
                x_leaf, y = self.saved.pop(t)
                gy = g_micro[m] if self._is_last(r, v) else inbox.pop((v, m))
                with _slot("B", g.device):
                    torch.autograd.backward(y, gy.to(y.dtype))
                if r == 0 and v == 0:
                    dxs[m] = x_leaf.grad
                else:
                    send = x_leaf.grad
            nc = self.table[nxt][t]
            recv = nc is not None and not (nxt == 0 and nc[0] == 0)
            got = _hop(self.ref, send, prev, recv, nxt, self.like)
            if recv:
                # the cotangent of the chunk before nxt's (v, m): run here
                nv, nm = nc
                inbox[(nv - 1 if nxt == 0 else nv, nm)] = got
        dx = torch.cat([dxs[m] for m in range(M)]) if r == 0 else None
        grads = [b.grad for b in self.blocks]
        self.blocks = self.saved = None
        return dx, grads


class _Interleaved(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *leaves):
        ctx.run = run
        return run.forward(x, leaves)

    @staticmethod
    def backward(ctx, g):
        dx, grads = ctx.run.backward(g.contiguous())
        ctx.run = None
        return (None, dx, *grads)


def pipeline_forward(stage_fn: Callable, stacked_params, x, *, mesh=None,
                     axis: str = "pp", n_micro: Optional[int] = None):
    """Run x through the pp stages with microbatching (GPipe / FThenB).

    stage_fn(stage_params, h) -> h, h's shape kept. `stacked_params`:
    leaves with a leading stage dim, whole or the rank's block
    (`stack_stage_params`). Returns the last stage's output [batch, ...]
    on every pp rank, differentiable (module docstring). Without a pp
    axis above 1 the stages run in order in this process."""
    mesh, ref = _pp(mesh, axis)
    if ref is None:
        n_stages = pytree.tree_leaves(stacked_params)[0].shape[0]
        h = x
        for i in range(n_stages):
            h = stage_fn(pytree.tree_map(lambda t, i=i: t[i],
                                         stacked_params), h)
        return h
    block = _rank_block(stacked_params, ref.size, ref.rank, axis)
    leaves, treedef = pytree.tree_flatten(block)
    n_micro = n_micro or ref.size
    _micro(x, n_micro)
    run = _InterleavedRun(stage_fn, treedef, ref, 1, n_micro)
    return _Interleaved.apply(run, x, *leaves)


def pipeline_vpp_forward(chunk_fn: Callable, chunked_params, x, *,
                         mesh=None, axis: str = "pp",
                         n_micro: Optional[int] = None):
    """Interleaved (VPP) pipeline forward. `chunked_params` leaves are
    [S, V, ...] (element [r, v] is model chunk v * S + r, whole or the
    rank's block [1, V, ...]); microbatch m flows through chunks 0 ..
    S * V - 1 in order, every chunk boundary moving rank r -> r + 1 mod
    S, produced at one tick and used at the next (JAX's clock: T =
    n_micro * V + S - 1 chunk ticks). Needs n_micro % S == 0."""
    mesh, ref = _pp(mesh, axis)
    leaves = pytree.tree_leaves(chunked_params)
    if ref is None:
        S_dim, V = int(leaves[0].shape[0]), int(leaves[0].shape[1])
        h = x
        for c in range(S_dim * V):
            h = chunk_fn(pytree.tree_map(
                lambda t, c=c: t[c % S_dim, c // S_dim], chunked_params), h)
        return h
    S = ref.size
    attr = dist_attr(leaves[0])
    S_dim = int(attr.global_shape[0]) if attr is not None \
        else int(leaves[0].shape[0])
    if S_dim == 1:      # the rank's block
        S_dim = S
    if S_dim != S:
        raise ValueError(f"chunk rank-dim {S_dim} != pp axis {S}")
    V = int(leaves[0].shape[1])
    n_micro = n_micro or S
    _micro(x, n_micro)
    if n_micro % S:
        raise ValueError(
            f"VPP needs n_micro ({n_micro}) divisible by pp ({S}) — the "
            "reference interleaved schedule has the same constraint")
    block = _rank_block(chunked_params, S, ref.rank, axis)
    flat, treedef = pytree.tree_flatten(block)
    run = _InterleavedRun(chunk_fn, treedef, ref, V, n_micro)
    return _Interleaved.apply(run, x, *flat)


# ---------------------------------------------------------------------------
# the 1F1B family: forward and backward in one pass, the head inside
# ---------------------------------------------------------------------------

def pipeline_zb1f1b(stage_fn: Callable, head_fn: Callable, stacked_params,
                    head_params, x, labels, *, mesh=None, axis: str = "pp",
                    n_micro: Optional[int] = None, head_specs=None):
    """Zero-bubble-style 1F1B (ZBH1): backward slots compute the
    activation gradient alone, and all weight gradients are made after
    the last tick in one batched forward and backward over the saved
    (input, cotangent) pairs. Same contract as `pipeline_1f1b`."""
    return _pipeline_1f1b_impl(stage_fn, head_fn, stacked_params,
                               head_params, x, labels, mesh=mesh, axis=axis,
                               n_micro=n_micro, defer_weight_grads=True,
                               head_specs=head_specs)


def pipeline_1f1b(stage_fn: Callable, head_fn: Callable, stacked_params,
                  head_params, x, labels, *, mesh=None, axis: str = "pp",
                  n_micro: Optional[int] = None, head_specs=None):
    """One-pass forward + backward pipeline with the 1F1B memory profile:
    the forward of microbatch i at stage s at tick s + i, its backward at
    tick 2S - 1 - s + i, the head at the last stage's backward tick.

    stage_fn(stage_params, h) -> h; head_fn(head_params, h, labels_mb) ->
    the microbatch's mean loss. Returns (loss, d_stacked, d_head, d_x)
    (module docstring). `head_specs` ({name: spec}) makes the head
    cooperative over the axis."""
    return _pipeline_1f1b_impl(stage_fn, head_fn, stacked_params,
                               head_params, x, labels, mesh=mesh, axis=axis,
                               n_micro=n_micro, defer_weight_grads=False,
                               head_specs=head_specs)


def pipeline_eager_1f1b(stage_fn: Callable, head_fn: Callable,
                        stacked_params, head_params, x, labels, *,
                        mesh=None, axis: str = "pp",
                        n_micro: Optional[int] = None, head_specs=None):
    """Eager-1F1B: the forward of microbatch i at stage s at tick 2s + i,
    its backward at 4S - 4 - 2s + i, so a boundary produced at tick t is
    used at t + 2 (one tick of slack for the hop), at the cost of more
    microbatches in flight. Same contract as `pipeline_1f1b`."""
    return _pipeline_1f1b_impl(stage_fn, head_fn, stacked_params,
                               head_params, x, labels, mesh=mesh, axis=axis,
                               n_micro=n_micro, defer_weight_grads=False,
                               head_specs=head_specs, eager=True)


def _spec_dim(spec, axis: str) -> Optional[int]:
    for d, e in enumerate(spec or ()):
        if axis in spec_axes(e):
            return d
    return None


class _F32Acc:
    """Gradient accumulators in f32 for a list of leaves (JAX's f32
    carries): an f32 leaf accumulates in its own .grad, a lower-precision
    leaf's .grad is added to an f32 buffer after each backward."""

    def __init__(self, leaves):
        self.leaves = leaves
        self.acc = [None] * len(leaves)

    def take(self):
        for i, leaf in enumerate(self.leaves):
            if leaf.dtype == torch.float32 or leaf.grad is None:
                continue
            g = leaf.grad.to(torch.float32)
            self.acc[i] = g if self.acc[i] is None else self.acc[i] + g
            leaf.grad = None

    def grads(self):
        self.take()
        out = []
        for leaf, a in zip(self.leaves, self.acc):
            if leaf.dtype == torch.float32:
                a = leaf.grad
            out.append(a if a is not None else torch.zeros(
                leaf.shape, dtype=torch.float32, device=leaf.device))
        return out


def _serial_1f1b(stage_fn, head_fn, stacked_params, head_params, x,
                 labels):
    """No pp axis above 1: the stages in order and the head, one
    autograd pass (JAX's value_and_grad of the serial loss)."""
    st_leaves, st_def = pytree.tree_flatten(stacked_params)
    hp_leaves, hp_def = pytree.tree_flatten(head_params)
    st = [t.detach().requires_grad_(True) for t in st_leaves]
    hp = [t.detach().requires_grad_(True) for t in hp_leaves]
    xx = x.detach().requires_grad_(True)
    stacked = pytree.tree_unflatten(st, st_def)
    with torch.enable_grad():
        h = xx
        for i in range(st[0].shape[0]):
            h = stage_fn(pytree.tree_map(lambda t, i=i: t[i], stacked), h)
        loss = head_fn(pytree.tree_unflatten(hp, hp_def), h, labels)
        loss = loss.to(torch.float32)
        grads = torch.autograd.grad(loss, st + hp + [xx],
                                    allow_unused=True)
    z = [g if g is not None else torch.zeros_like(t)
         for g, t in zip(grads, st + hp + [xx])]
    return (loss.detach(), pytree.tree_unflatten(z[:len(st)], st_def),
            pytree.tree_unflatten(z[len(st):-1], hp_def), z[-1])


def _pipeline_1f1b_impl(stage_fn, head_fn, stacked_params, head_params, x,
                        labels, *, mesh, axis, n_micro, defer_weight_grads,
                        head_specs=None, eager=False):
    if eager and defer_weight_grads:
        raise ValueError("eager comm-slack scheduling composes with plain "
                         "1F1B only (ZBH1 already restructures the ticks)")
    mesh, ref = _pp(mesh, axis)
    if ref is None:
        return _serial_1f1b(stage_fn, head_fn, stacked_params, head_params,
                            x, labels)
    S, r = ref.size, ref.rank
    block = _rank_block(stacked_params, S, r, axis)
    n_micro = n_micro or S
    M = n_micro
    micro_x, micro_lb = _micro(x, M), _micro(labels, M)
    inv_m = 1.0 / M
    dev = x.device
    like = (tuple(micro_x.shape[1:]), x.dtype, dev)
    coop = head_specs is not None

    # the stage's weights: leaves that collect their gradients, and (ZBH1)
    # detached twins the tick slots run on (no weight products backward)
    blk_leaves, blk_def = pytree.tree_flatten(block)
    p_leaves = [b[0].detach().requires_grad_(True) for b in blk_leaves]
    p_stage = pytree.tree_unflatten(p_leaves, blk_def)
    p_tick = pytree.tree_unflatten([p.detach() for p in p_leaves],
                                   blk_def) if defer_weight_grads \
        else p_stage
    p_acc = _F32Acc(p_leaves)

    # the head's weights: a cooperative leaf whose spec names the axis is
    # this rank's slice of it
    hp_leaves, hp_def = pytree.tree_flatten(head_params)
    names = [None] * len(hp_leaves)
    if coop:
        if not isinstance(head_params, dict):
            raise ValueError("head_specs needs head_params as a dict")
        names = sorted(head_params)
        hp_leaves = [head_params[k] for k in names]
    dims = [(_spec_dim(head_specs.get(k), axis) if coop else None)
            for k in names]
    h_leaves = []
    for t, d in zip(hp_leaves, dims):
        if d is not None:
            n = t.shape[d] // S
            t = t.narrow(d, r * n, n)
        h_leaves.append(t.detach().requires_grad_(True))
    h_acc = _F32Acc(h_leaves)

    def head_tree():
        if coop:
            return dict(zip(names, h_leaves))
        return pytree.tree_unflatten(h_leaves, hp_def)

    def run_head(hidden, lb):
        """loss_i (detached) and the cotangent of `hidden`; cooperative,
        the ranks' parts hop to the last rank, which sums them in rank
        order (None on the others)."""
        h_in = hidden.detach().requires_grad_(True)
        with _slot("H", dev), torch.enable_grad():
            loss_i = head_fn(head_tree(), h_in, lb).to(torch.float32)
            loss_i.backward(torch.full_like(loss_i, inv_m))
        h_acc.take()
        dy = h_in.grad
        if coop:
            if r < S - 1:
                _hop(ref, dy, S - 1, False, -1, like)
                return loss_i.detach(), None
            parts = [_hop(ref, None, -1, True, src, like)
                     for src in range(S - 1)]
            dy = sum(parts[1:], parts[0]) + dy
        return loss_i.detach(), dy

    f_off = 2 * r if eager else r
    b_off = (4 * S - 4 - 2 * r) if eager else (2 * S - 1 - r)
    h_off = (2 * S - 2) if eager else S
    T = M + (4 * S - 4 if eager else 2 * S - 1)

    def f_mb(s, t):
        i = t - (2 * s if eager else s)
        return i if 0 <= i < M else None

    def b_mb(s, t):
        i = t - ((4 * S - 4 - 2 * s) if eager else (2 * S - 1 - s))
        return i if 0 <= i < M else None

    fwd_in, bwd_in, saved, head_dy = {}, {}, {}, {}
    dxs, xs_w, dys_w = {}, {}, {}
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(T):
        send_f = send_b = None
        # ---- forward slot ----
        i_f = t - f_off
        if 0 <= i_f < M:
            xin = micro_x[i_f] if r == 0 else fwd_in.pop(i_f)
            x_leaf = xin.detach().requires_grad_(True)
            with _slot("F", dev), torch.enable_grad():
                y = stage_fn(p_tick, x_leaf)
            saved[i_f] = (x_leaf, y)
            if r < S - 1:
                send_f = y.detach()
        # ---- the cooperative head: every rank, the last rank's output ----
        if coop:
            i_h = t - h_off
            if 0 <= i_h < M:
                hid = saved[i_h][1].detach() if r == S - 1 else torch.empty(
                    like[0], dtype=like[1], device=dev)
                hid = broadcast(hid, ref, S - 1)
                loss_i, dy = run_head(hid, micro_lb[i_h])
                loss = loss + loss_i * inv_m
                if r == S - 1:
                    head_dy[i_h] = dy
        # ---- backward slot ----
        i_b = t - b_off
        if 0 <= i_b < M:
            x_leaf, y = saved.pop(i_b)
            if r < S - 1:
                dy = bwd_in.pop(i_b)
            elif coop:
                dy = head_dy.pop(i_b)
            else:
                loss_i, dy = run_head(y, micro_lb[i_b])
                loss = loss + loss_i * inv_m
            with _slot("B", dev):
                if defer_weight_grads:
                    (dx,) = torch.autograd.grad(y, x_leaf, dy.to(y.dtype))
                    xs_w[i_b], dys_w[i_b] = x_leaf.detach(), dy.to(y.dtype)
                else:
                    torch.autograd.backward(y, dy.to(y.dtype))
                    dx = x_leaf.grad
            if not defer_weight_grads:
                p_acc.take()
            if r > 0:
                send_b = dx
            else:
                dxs[i_b] = dx
            del y, x_leaf
        # ---- the boundary exchange ----
        recv_f = r > 0 and f_mb(r - 1, t) is not None
        got = _hop(ref, send_f, r + 1, recv_f, r - 1, like)
        if recv_f:
            fwd_in[f_mb(r - 1, t)] = got
        recv_b = r < S - 1 and b_mb(r + 1, t) is not None
        got = _hop(ref, send_b, r - 1, recv_b, r + 1, like)
        if recv_b:
            bwd_in[b_mb(r + 1, t)] = got
    if defer_weight_grads:
        # the W pass: every microbatch's weight products in one batched
        # forward and backward (JAX's vmapped vjp, summed)
        xw = torch.cat([xs_w[i] for i in range(M)]).requires_grad_(False)
        dyw = torch.cat([dys_w[i] for i in range(M)])
        with _slot("W", dev), torch.enable_grad():
            yw = stage_fn(p_stage, xw)
            torch.autograd.backward(yw, dyw)
        del yw
    d_stage = pytree.tree_unflatten([g[None] for g in p_acc.grads()],
                                    blk_def)
    # the head's gradient whole on every rank: a cooperative shard
    # gathered, a replicated leaf's parts summed; else the last rank's
    hg = h_acc.grads()
    out = []
    for g, d in zip(hg, dims):
        if coop:
            out.append(all_gather(g, ref, d) if d is not None
                       else all_reduce(g, ref))
        else:
            out.append(broadcast(g, ref, S - 1))
    d_head = dict(zip(names, out)) if coop \
        else pytree.tree_unflatten(out, hp_def)
    if r == 0:
        d_x = torch.cat([dxs[i] for i in range(M)])
    else:
        d_x = torch.empty(tuple(x.shape), dtype=x.dtype, device=dev)
    d_x = broadcast(d_x, ref, 0)
    if not coop:
        loss = broadcast(loss, ref, S - 1)
    return loss, d_stage, d_head, d_x
