"""Collectives over torch.distributed process groups, as graph nodes,
and the quantized wire (counterpart of paddle_tpu/parallel/collectives.py).

The JAX functions take a mesh axis name inside ``shard_map``; these take
a process group (None = the default group, a ``ProcessGroup``, or a
`parallel.ranks.GroupRef`) and run on every rank of it, SPMD.

**Collectives as operators.** Each plain collective (``all_gather``,
``all_reduce``, ``all_to_all``, ``broadcast``, and the point-to-point hop
``ppermute``) is one ``torch.library`` operator
``paddle_tpu_comm::<name>`` (the precedent is
``kernels/_build.kernel_op``), so ``make_fx`` records it as one node
that the communication audit (``analysis/comms.py``) reads:

- the schema names the group by its registry key and size (a schema
  cannot take a ``ProcessGroup``; `parallel.ranks.resolve_group` looks
  the key up and raises when it is missing);
- the real implementation is the exchange: on a gloo group a CUDA
  tensor is copied to the host, exchanged there and copied back (gloo
  has no CUDA path for all_to_all and only a host-staged one for the
  rest; ranks that share one card run gloo, since NCCL refuses two ranks
  on one GPU), on NCCL device tensors are exchanged directly;
- the fake implementation gives the output's shape from the group size,
  so a program traces on fake tensors with no live group.

The namespace is not the kernels' (``paddle_tpu``): a collective node is
never counted as a kernel launch. Size-1 groups never reach an operator
(the functions return their input).

**Autograd.** Each operator that exchanges in its forward carries its
backward (``torch.library.register_autograd``), so a training step's
collectives are graph nodes too, forward and backward:

- ``reduce_scatter`` (this rank's chunk of the sum; on gloo, which has
  none, an all-reduce and a slice; on NCCL ``reduce_scatter_tensor``):
  backward, an all-gather;
- ``all_gather``: its backward is named by the caller (``grad``):
  ``"reduce_scatter"`` where the ranks' consumers differ (a ZeRO-3
  weight, k / v gathered for a rank's heads), ``"slice"`` where they
  compute the same thing (Megatron's ``c_concat``: the embedding's
  columns, the logits' vocab);
- ``all_reduce``: identity backward (Megatron's ``g`` after a
  row-parallel product: the loss downstream is the same on every rank);
- ``all_to_all``: backward, the same exchange (it is its own adjoint:
  each block's cotangent goes back to the rank it came from), so the
  Ulysses swap (`parallel/ulysses.py`, the tiled ``all_to_all``) is
  differentiated through it;
- ``ppermute`` (`send_recv`: this rank's tensor to one peer of the group,
  another peer's into a new tensor; on NCCL ``batch_isend_irecv``, on
  gloo ``isend`` / ``irecv`` of host copies): backward, the same hop the
  other way (the transpose of ``lax.ppermute``), which holds where every
  rank's received tensor feeds the loss, as in a ring. The pipelines
  (`parallel/pipeline_spmd.py`) send their activations and cotangents
  forward and back explicitly, tick by tick, and use no autograd across
  ranks.

Two functions exchange in their backward only, so their forward is no
graph node: ``c_identity`` (Megatron's ``f`` before a column-parallel
product: identity forward, all-reduce backward) and ``c_split`` (a slice,
all-gather backward).

**The wire format** is the JAX package's, byte for byte:

- ``quantize_blocks`` / ``dequantize_blocks``: symmetric absmax int8 in
  blocks of 128 along the last dim (scale = absmax / 127; an all-zero
  block keeps scale 0 and dequantizes to exact zeros; a block holding
  NaN / inf stores a non-finite scale, so its dequant stays visibly
  poisoned);
- ``_pack_scales`` / ``_unpack_scales``: the f32 sidecar bitcast to
  int8 and concatenated onto the payload's last axis, so each hop ships
  ONE int8 buffer;
- ``quantized_all_gather``: quantize, gather one buffer, dequantize;
- ``quantized_psum``: the two-hop exchange -- an all_to_all of
  per-destination quantized chunks, f32 dequant-accumulate, then an
  all-gather of the re-quantized reduced chunk;
- ``quantized_psum_prequant``: hops 2 and 3 for a payload the producer
  quantized already (the decode megakernel's ``quantize_out``);
- ``quantized_reduce_scatter``: the first hop alone;
- ``quantized_psum_tree``: the dp gradient sync, one ``quantized_psum``
  over the float leaves of a tree concatenated in JAX's leaf order
  (``all_reduce_tree`` is the unquantized sync: one all-reduce a dtype).

Each quantized hop is one int8 node of the plain operators above, which
is how the audit recognizes the rewrite (JAX's `_mark_quantized`).
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from ..framework.flags import flag as _flag
from .ranks import group_ref, resolve_group, tracing_rank

__all__ = [
    "COMM_NAMESPACE", "QCOLL_BLOCK", "QCOLL_FALLBACK_MSG",
    "resolve_quantized_collectives", "quantize_blocks", "dequantize_blocks",
    "quantized_all_gather", "quantized_psum", "quantized_psum_prequant",
    "quantized_psum_tree", "quantized_reduce_scatter", "all_gather",
    "all_reduce", "all_reduce_tree", "all_to_all", "WIRE_COUNTS",
    "reset_wire_counts", "broadcast", "broadcast_tree", "c_concat",
    "c_identity", "c_split", "group_size", "mp_allreduce", "psum_tree",
    "reduce_scatter", "tree_leaves", "send_recv", "ppermute",
]

# lane-width blocks along the last dim (one f32 scale per 128 int8 bytes)
QCOLL_BLOCK = 128

QCOLL_FALLBACK_MSG = (
    "payload cannot be block-quantized; falling back to the "
    "unquantized collective (full-width wire bytes, exact numerics)")

COMM_NAMESPACE = "paddle_tpu_comm"


def resolve_quantized_collectives(quantized: Optional[bool] = None) -> bool:
    """The quantized-collectives switch, from the argument or
    FLAGS_quantized_collectives. Read at engine-build time; False keeps
    every wire byte-identical to a build without the flag."""
    if quantized is None:
        quantized = _flag("quantized_collectives")
    return bool(quantized)


# ---------------------------------------------------------------------------
# the plain collectives: one operator each
# ---------------------------------------------------------------------------

_OPS = torch.library.Library(COMM_NAMESPACE, "DEF")
_REDUCE = {"sum": "SUM", "max": "MAX", "min": "MIN"}

# what the real implementations exchanged, by operator: calls, the bytes
# this rank handed in, the bytes of other ranks' data its result holds (a
# gather's (n-1)/n, an all-to-all's (n-1)/n, a reduction's n-1
# contributions, a reduce-scatter's n-1 contributions to its chunk, a
# broadcast's payload off the source), and the host seconds inside the
# implementation (on gloo the host staging and the exchange; on NCCL the
# enqueue). Moved only by a real exchange: a traced (fake) call counts
# nothing.
WIRE_COUNTS = {}


def _count(kind: str, handed: int, received: int, t0: float) -> None:
    c = WIRE_COUNTS.setdefault(kind, {"calls": 0, "handed_bytes": 0,
                                      "received_bytes": 0, "seconds": 0.0})
    c["calls"] += 1
    c["handed_bytes"] += int(handed)
    c["received_bytes"] += int(received)
    c["seconds"] += time.perf_counter() - t0


def reset_wire_counts() -> None:
    WIRE_COUNTS.clear()


def _staged(x: torch.Tensor, pg, inplace: bool = False):
    """(tensor to hand the backend, whether it was copied to the host);
    `inplace` exchanges write into it, so it must be a copy."""
    staged = x.is_cuda and dist.get_backend(pg) == "gloo"
    if staged:
        return x.cpu().contiguous(), True
    return (x.clone() if inplace else x).contiguous(), False


def _key_rank(key: str) -> int:
    """This rank's index in the group a registry key names (the key's
    ranks; under `parallel.ranks.traced_rank`, the traced rank's)."""
    if key == "world":
        return dist.get_rank() if dist.is_initialized() else 0
    ranks = [int(r) for r in key.split("@", 1)[1].split(",")]
    traced = tracing_rank()
    me = traced if traced is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    return ranks.index(me) if me in ranks else 0


def _all_gather_impl(x, group: str, size: int, dim: int, grad: str):
    t0 = time.perf_counter()
    pg = resolve_group(group)
    src, staged = _staged(x, pg)
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=pg)
    out = torch.cat(parts, dim=dim)
    nb = src.numel() * src.element_size()
    _count("all_gather", nb, nb * (size - 1), t0)
    return out.to(x.device) if staged else out


def _all_gather_fake(x, group: str, size: int, dim: int, grad: str):
    shape = list(x.shape)
    shape[dim] *= size
    return x.new_empty(shape)


def _all_reduce_impl(x, group: str, size: int, op: str):
    t0 = time.perf_counter()
    pg = resolve_group(group)
    out, staged = _staged(x, pg, inplace=True)
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _REDUCE[op]), group=pg)
    nb = out.numel() * out.element_size()
    _count("all_reduce", nb, nb * (size - 1), t0)
    return out.to(x.device) if staged else out


def _reduce_scatter_impl(x, group: str, size: int, dim: int):
    t0 = time.perf_counter()
    pg = resolve_group(group)
    src, staged = _staged(x, pg, inplace=True)
    n = src.shape[dim] // size
    if dist.get_backend(pg) == "nccl":
        moved = src.movedim(dim, 0).contiguous()
        out = moved.new_empty((n,) + tuple(moved.shape[1:]))
        dist.reduce_scatter_tensor(out, moved, group=pg)
        out = out.movedim(0, dim).contiguous()
    else:
        # gloo has no reduce-scatter: the sum, then this rank's chunk
        dist.all_reduce(src, group=pg)
        out = src.narrow(dim, dist.get_rank(pg) * n, n).contiguous()
    nb = out.numel() * out.element_size()
    _count("reduce_scatter", nb * size, nb * (size - 1), t0)
    return out.to(x.device) if staged else out


def _reduce_scatter_fake(x, group: str, size: int, dim: int):
    shape = list(x.shape)
    shape[dim] //= size
    return x.new_empty(shape)


def _all_to_all_impl(x, group: str, size: int):
    t0 = time.perf_counter()
    pg = resolve_group(group)
    src, staged = _staged(x, pg)
    # the single-tensor form: gloo implements it (alltoall_base), not the
    # list form
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=pg)
    nb = src.numel() * src.element_size()
    _count("all_to_all", nb, nb * (size - 1) // size, t0)
    return out.to(x.device) if staged else out


def _broadcast_impl(x, group: str, size: int, src: int):
    t0 = time.perf_counter()
    pg = resolve_group(group)
    out, staged = _staged(x, pg, inplace=True)
    dist.broadcast(out, src=dist.get_global_rank(pg, src)
                   if pg is not dist.group.WORLD else src, group=pg)
    nb = out.numel() * out.element_size()
    _count("broadcast", nb, 0 if dist.get_rank(pg) == src else nb, t0)
    return out.to(x.device) if staged else out


def _peer(pg, idx: int) -> int:
    """The default group's rank of the group's rank `idx`."""
    return idx if pg is dist.group.WORLD else dist.get_global_rank(pg, idx)


def _ppermute_impl(x, group: str, size: int, dst: int, src: int):
    t0 = time.perf_counter()
    pg = resolve_group(group)
    staged = x.is_cuda and dist.get_backend(pg) == "gloo"
    nccl = dist.get_backend(pg) == "nccl"
    out = None
    ops = []
    if dst >= 0:
        buf = x.detach().cpu().contiguous() if staged else x.contiguous()
        ops.append((dist.isend, buf, _peer(pg, dst)))
    if src >= 0:
        out = torch.empty(x.shape, dtype=x.dtype,
                          device="cpu" if staged else x.device)
        ops.append((dist.irecv, out, _peer(pg, src)))
    if nccl:
        works = dist.batch_isend_irecv(
            [dist.P2POp(fn, t, peer, group=pg) for fn, t, peer in ops])
    else:
        works = [fn(t, peer, group=pg) for fn, t, peer in ops]
    for w in works:
        w.wait()
    nb = x.numel() * x.element_size()
    _count("ppermute", nb if dst >= 0 else 0, nb if src >= 0 else 0, t0)
    if out is None:
        return x.new_empty((0,))
    return out.to(x.device) if staged else out


def _ppermute_fake(x, group: str, size: int, dst: int, src: int):
    return x.new_empty(tuple(x.shape) if src >= 0 else (0,))


def _same_fake(x, *args):
    return torch.empty_like(x)


def _comm_op(name, schema, impl, fake):
    _OPS.define(name + schema)
    for key in ("CPU", "CUDA"):
        _OPS.impl(name, impl, key)
    torch.library.register_fake(f"{COMM_NAMESPACE}::{name}", fake, lib=_OPS)
    return getattr(getattr(torch.ops, COMM_NAMESPACE), name).default


_all_gather_op = _comm_op(
    "all_gather",
    "(Tensor x, str group, int size, int dim, str grad) -> Tensor",
    _all_gather_impl, _all_gather_fake)
_all_reduce_op = _comm_op(
    "all_reduce", "(Tensor x, str group, int size, str op) -> Tensor",
    _all_reduce_impl, _same_fake)
_reduce_scatter_op = _comm_op(
    "reduce_scatter", "(Tensor x, str group, int size, int dim) -> Tensor",
    _reduce_scatter_impl, _reduce_scatter_fake)
_all_to_all_op = _comm_op(
    "all_to_all", "(Tensor x, str group, int size) -> Tensor",
    _all_to_all_impl, _same_fake)
_broadcast_op = _comm_op(
    "broadcast", "(Tensor x, str group, int size, int src) -> Tensor",
    _broadcast_impl, _same_fake)
_ppermute_op = _comm_op(
    "ppermute", "(Tensor x, str group, int size, int dst, int src) -> Tensor",
    _ppermute_impl, _ppermute_fake)


# the backward formulas (module docstring, "Autograd")

def _setup(ctx, inputs, output):
    ctx.args = inputs[1:]


def _gather_backward(ctx, g):
    group, size, dim, grad = ctx.args
    if grad == "slice":
        n = g.shape[dim] // size
        out = g.narrow(dim, _key_rank(group) * n, n)
    else:
        out = _reduce_scatter_op(g.contiguous(), group, size, dim)
    return out, None, None, None, None


def _reduce_backward(ctx, g):
    if ctx.args[2] != "sum":
        raise NotImplementedError(
            f"all_reduce(op={ctx.args[2]!r}) has no gradient")
    return g, None, None, None


def _scatter_backward(ctx, g):
    group, size, dim = ctx.args
    return (_all_gather_op(g.contiguous(), group, size, dim,
                           "reduce_scatter"), None, None, None)


def _all_to_all_backward(ctx, g):
    # self-adjoint: row j of the result came from rank j's row of this
    # rank, so its cotangent goes back there by the same exchange
    group, size = ctx.args
    return _all_to_all_op(g.contiguous(), group, size), None, None


def _ppermute_setup(ctx, inputs, output):
    x = inputs[0]
    ctx.args = inputs[1:]
    ctx.like = (tuple(x.shape), x.dtype, x.device)


def _ppermute_backward(ctx, g):
    # the hop the other way: the cotangent of what this rank received goes
    # back to its source, that of what it sent comes back from its peer
    group, size, dst, src = ctx.args
    shape, dtype, device = ctx.like
    send = src >= 0 and g is not None
    tmpl = g.contiguous() if send else torch.empty(shape, dtype=dtype,
                                                   device=device)
    out = _ppermute_op(tmpl, group, size, src if send else -1, dst)
    return (out if dst >= 0 else None), None, None, None, None


for _name, _bwd in (("all_gather", _gather_backward),
                    ("all_reduce", _reduce_backward),
                    ("reduce_scatter", _scatter_backward),
                    ("all_to_all", _all_to_all_backward)):
    torch.library.register_autograd(f"{COMM_NAMESPACE}::{_name}", _bwd,
                                    setup_context=_setup, lib=_OPS)
torch.library.register_autograd(f"{COMM_NAMESPACE}::ppermute",
                                _ppermute_backward,
                                setup_context=_ppermute_setup, lib=_OPS)


def group_size(group=None) -> int:
    return group_ref(group).size


GATHER_GRADS = ("reduce_scatter", "slice")


def all_gather(x: torch.Tensor, group=None, dim: int = 0,
               grad: str = "reduce_scatter") -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order (the JAX
    ``all_gather(tiled=True)``). `grad` names its backward: the
    reduce-scatter of the gradient (the adjoint, where each rank's
    consumer differs) or this rank's slice of it (``c_concat``, where
    every rank computes the same thing downstream)."""
    if grad not in GATHER_GRADS:
        raise ValueError(f"all_gather: grad {grad!r} is not one of "
                         f"{GATHER_GRADS}")
    ref = group_ref(group)
    if ref.size == 1:
        return x
    return _all_gather_op(x, ref.key, ref.size, dim % max(x.ndim, 1), grad)


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's chunk, along `dim`, of the sum of every rank's `x`
    (the dim must split evenly); backward, an all-gather."""
    ref = group_ref(group)
    if ref.size == 1:
        return x
    dim = dim % max(x.ndim, 1)
    if x.shape[dim] % ref.size:
        raise ValueError(f"reduce_scatter: dim {dim} ({x.shape[dim]}) does "
                         f"not split into {ref.size} ranks")
    return _reduce_scatter_op(x.contiguous(), ref.key, ref.size, dim)


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, size):
        ctx.key, ctx.size = key, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_op(g.contiguous(), ctx.key, ctx.size,
                              "sum"), None, None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, size, rank, dim):
        ctx.key, ctx.size, ctx.dim = key, size, dim
        n = x.shape[dim] // size
        return x.narrow(dim, rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_all_gather_op(g.contiguous(), ctx.key, ctx.size, ctx.dim,
                               "slice"), None, None, None, None)


def c_identity(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's f (Paddle's ``_c_identity``): identity forward, the
    gradient all-reduced over the group backward. It sits before a
    column-parallel product, whose input gradient is partial a rank."""
    ref = group_ref(group)
    if ref.size == 1:
        return x
    return _CIdentity.apply(x, ref.key, ref.size)


def mp_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's g (Paddle's ``_mp_allreduce``): the sum over the group
    forward, identity backward. It sits after a row-parallel product."""
    return all_reduce(x, group)


def c_concat(x: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """Paddle's ``_c_concat``: the ranks' blocks gathered along `dim`,
    this rank's slice of the gradient backward."""
    return all_gather(x, group, dim, grad="slice")


def c_split(x: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """Paddle's ``_c_split``: this rank's block of `x` along `dim`,
    the gradient all-gathered backward."""
    ref = group_ref(group)
    if ref.size == 1:
        return x
    dim = dim % max(x.ndim, 1)
    if x.shape[dim] % ref.size:
        raise ValueError(f"c_split: dim {dim} ({x.shape[dim]}) does not "
                         f"split into {ref.size} ranks")
    return _CSplit.apply(x, ref.key, ref.size, ref.rank, dim)


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """A new tensor holding the sum (or max, min) of every rank's `x`."""
    ref = group_ref(group)
    if ref.size == 1:
        return x
    if op not in _REDUCE:
        raise ValueError(f"all_reduce: op {op!r} is not one of "
                         f"{sorted(_REDUCE)}")
    return _all_reduce_op(x, ref.key, ref.size, op)


def all_to_all(x: torch.Tensor, group=None, split_dim: Optional[int] = None,
               concat_dim: Optional[int] = None) -> torch.Tensor:
    """x [n, ...] -> [n, ...]: row j goes to rank j, and row j of the
    result came from rank j (the JAX ``all_to_all(split_axis=0,
    concat_axis=0)``). With `split_dim` and `concat_dim` it is tiled (the
    JAX ``all_to_all(..., tiled=True)``): `split_dim` is cut into n
    blocks, block j goes to rank j, and the blocks that arrive are
    concatenated along `concat_dim` in rank order. Differentiable: the
    backward is the exchange that sends each block back."""
    ref = group_ref(group)
    n = ref.size
    if split_dim is None:
        if x.shape[0] != n:
            raise ValueError(f"all_to_all: leading dim {x.shape[0]} is not "
                             f"the group size {n}")
        return x if n == 1 else _all_to_all_op(x, ref.key, n)
    split_dim, concat_dim = split_dim % x.ndim, concat_dim % x.ndim
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} ({x.shape[split_dim]})"
                         f" does not split into {n} ranks")
    if n == 1:
        return x
    blocks = x.unflatten(split_dim, (n, x.shape[split_dim] // n))
    got = _all_to_all_op(blocks.movedim(split_dim, 0).contiguous(), ref.key,
                         n)
    return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


def broadcast(x: torch.Tensor, group=None, src: int = 0) -> torch.Tensor:
    """A new tensor holding the group's rank `src`'s `x` on every rank."""
    ref = group_ref(group)
    if ref.size == 1:
        return x
    return _broadcast_op(x, ref.key, ref.size, int(src))


def send_recv(x: torch.Tensor, group=None, dst: int = -1,
              src: int = -1) -> torch.Tensor:
    """One point-to-point hop over the group (ranks by their index in
    it): this rank's `x` to rank `dst` and rank `src`'s tensor, shaped
    and typed like `x`, into a new tensor that is returned (-1: no send,
    no receive; with no receive an empty tensor). Every send must meet
    its peer's receive in the same call on both ranks."""
    ref = group_ref(group)
    if ref.size == 1:
        return x if src >= 0 else x.new_empty((0,))
    return _ppermute_op(x.contiguous(), ref.key, ref.size, int(dst),
                        int(src))


def ppermute(x: torch.Tensor, group=None, perm=()) -> torch.Tensor:
    """JAX's ``lax.ppermute``: `perm` is a list of (source, destination)
    group ranks; this rank sends `x` where it is a source and returns
    what it receives (zeros where it is no destination)."""
    ref = group_ref(group)
    dst = next((d for s, d in perm if s == ref.rank), -1)
    src = next((s for s, d in perm if d == ref.rank), -1)
    if ref.size == 1:
        return x if src >= 0 else torch.zeros_like(x)
    out = send_recv(x, ref, dst, src)
    return out if src >= 0 else torch.zeros_like(x)


def broadcast_tree(tensors, group=None, src: int = 0) -> None:
    """Overwrite every tensor of the list with the group's rank `src`'s
    values, in place: one broadcast a dtype (the tensors concatenated
    flat)."""
    if group_ref(group).size == 1 or not tensors:
        return
    with torch.no_grad():
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            same = [t for t in tensors if t.dtype == dtype]
            got, off = broadcast(torch.cat([t.reshape(-1) for t in same]),
                                 group, src), 0
            for t in same:
                t.copy_(got[off:off + t.numel()].reshape(t.shape))
                off += t.numel()


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------

def _quantizable(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.ndim >= 1 and x.numel() > 0
            and x.is_floating_point())


def quantize_blocks(x: torch.Tensor, block: int = QCOLL_BLOCK):
    """x [..., d] float -> (q int8 [..., nb * be], scale f32 [..., nb])
    with be = min(block, d), nb = ceil(d / be); the last partial block
    pads with zeros. The JAX function's ops in its order: absmax in f32,
    scale = absmax / 127, divide by the scale (1 where it is 0), round
    half to even, cast."""
    d = int(x.shape[-1])
    be = min(int(block), d)
    nb = -(-d // be)
    xf = x.to(torch.float32)
    pad = nb * be - d
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    xb = xf.reshape(*x.shape[:-1], nb, be)
    amax = torch.amax(torch.abs(xb), dim=-1)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which can round one bit away from the division JAX
    # (and the CPU, and the megakernel's quantize_out) make
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(xb / safe[..., None]).to(torch.int8)
    return q.reshape(*x.shape[:-1], nb * be), scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      out_dim: Optional[int] = None, dtype=None):
    """Inverse of `quantize_blocks`: the block width comes from the
    operand shapes, so gathered payloads dequantize with the same call."""
    nb = int(scale.shape[-1])
    be = int(q.shape[-1]) // nb
    xb = q.to(torch.float32).reshape(*scale.shape, be)
    x = (xb * scale[..., None]).reshape(q.shape)
    if out_dim is not None and out_dim != x.shape[-1]:
        x = x[..., :out_dim]
    return x.to(dtype) if dtype is not None else x


def _pack_scales(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q [..., nb * be] int8 + s [..., nb] f32 -> one int8 buffer
    [..., nb * be + 4 * nb] (the scales' bytes, little-endian, as JAX's
    bitcast lays them out)."""
    sb = s.to(torch.float32).contiguous().view(torch.int8)
    return torch.cat([q, sb], dim=-1)


def _unpack_scales(packed: torch.Tensor, nb: int):
    split = packed.shape[-1] - 4 * nb
    q = packed[..., :split]
    s = packed[..., split:].contiguous().view(torch.float32)
    return q, s


# ---------------------------------------------------------------------------
# the quantized collectives
# ---------------------------------------------------------------------------

def quantized_all_gather(x: torch.Tensor, group=None, *, dim: int = 0,
                         block: int = QCOLL_BLOCK) -> torch.Tensor:
    """`all_gather` along `dim` shipping int8 blocks with the packed f32
    sidecar; one rounding per element. Gathering along the block axis
    (the last dim), non-float and empty payloads fall back to the plain
    gather with a warning, as in JAX."""
    nd = x.ndim
    if not _quantizable(x) or dim % max(nd, 1) == nd - 1:
        warnings.warn(f"quantized_all_gather: {QCOLL_FALLBACK_MSG}",
                      stacklevel=2)
        return all_gather(x, group, dim)
    q, s = quantize_blocks(x, block)
    pg = all_gather(_pack_scales(q, s), group, dim)
    qg, sg = _unpack_scales(pg, int(s.shape[-1]))
    return dequantize_blocks(qg, sg, out_dim=int(x.shape[-1]), dtype=x.dtype)


def _reduce_and_gather(qx, sx, size, n, group, block):
    """Hops 2 and 3 of the quantized psum: dequantize the n received
    chunks, sum in f32, re-quantize the reduced chunk and all-gather it.
    Returns the flat f32 sum [size]."""
    red = torch.sum(dequantize_blocks(qx, sx), dim=0)          # f32 [chunk]
    q2, s2 = quantize_blocks(red, block)
    pg = all_gather(_pack_scales(q2, s2)[None], group, 0)      # [n, ...]
    qg, sg = _unpack_scales(pg, int(s2.shape[-1]))
    return dequantize_blocks(qg, sg).reshape(-1)[:size]


def quantized_psum(x: torch.Tensor, group=None, *,
                   block: int = QCOLL_BLOCK) -> torch.Tensor:
    """The sum of every rank's `x` as the two-hop quantized exchange
    (EQuARX): chunk, quantize and all_to_all; dequantize-accumulate in
    f32; re-quantize and all-gather. Two roundings per element whatever
    the group size. Non-float payloads take the plain sum with a
    warning."""
    if not _quantizable(x):
        warnings.warn(f"quantized_psum: {QCOLL_FALLBACK_MSG}", stacklevel=2)
        return all_reduce(x, group)
    n = group_size(group)
    if n == 1:
        return x
    flat = x.to(torch.float32).reshape(-1)
    size = flat.numel()
    chunk = -(-size // (n * block)) * block
    padded = torch.nn.functional.pad(flat, (0, n * chunk - size))
    q, s = quantize_blocks(padded.reshape(n, chunk), block)
    px = all_to_all(_pack_scales(q, s), group)
    qx, sx = _unpack_scales(px, int(s.shape[-1]))
    out = _reduce_and_gather(qx, sx, size, n, group, block)
    return out.reshape(x.shape).to(x.dtype)


def quantized_psum_prequant(q: torch.Tensor, scale: torch.Tensor,
                            group=None, *, shape, dtype,
                            block: int = QCOLL_BLOCK) -> torch.Tensor:
    """`quantized_psum` of a payload the producer quantized already (the
    decode megakernel's ``quantize_out``): `q` int8 with `scale` f32 in
    the `quantize_blocks` layout of the row-major f32 partial, one scale
    per `block` flat elements. Needs q.numel() % (n * block) == 0 (the
    caller gates on it); hops 2 and 3 are `quantized_psum`'s, so the
    result is bitwise `quantized_psum` of the same partial."""
    n = group_size(group)
    size = int(q.numel())
    if n == 1:
        return dequantize_blocks(q.reshape(1, size),
                                 scale.to(torch.float32).reshape(1, -1)
                                 ).reshape(shape).to(dtype)
    if size % (n * block):
        raise ValueError(
            f"quantized_psum_prequant: payload size {size} does not split "
            f"into {n} destinations of whole {block}-blocks; the caller "
            "must gate on size % (n * block) == 0")
    chunk = size // n
    qp = q.reshape(n, chunk)
    sp = scale.to(torch.float32).reshape(n, chunk // block)
    px = all_to_all(_pack_scales(qp, sp), group)
    qx, sx = _unpack_scales(px, chunk // block)
    out = _reduce_and_gather(qx, sx, size, n, group, block)
    return out.reshape(shape).to(dtype)


def quantized_reduce_scatter(x: torch.Tensor, group=None, *,
                             block: int = QCOLL_BLOCK) -> torch.Tensor:
    """x [N, ...] (N divisible by the group size) -> this rank's summed
    shard [N / n, ...] over an int8 wire: the first hop of
    `quantized_psum`, f32 accumulation of once-rounded contributions."""
    n = group_size(group)
    if not _quantizable(x):
        warnings.warn(f"quantized_reduce_scatter: {QCOLL_FALLBACK_MSG}",
                      stacklevel=2)
        full = all_reduce(x, group)
        return full.reshape(n, -1, *x.shape[1:])[group_ref(group).rank]
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(
            f"quantized_reduce_scatter: leading dim {x.shape[0]} does not "
            f"divide the group size {n}")
    parts = x.to(torch.float32).reshape(n, x.shape[0] // n, *x.shape[1:])
    q, s = quantize_blocks(parts, block)
    px = all_to_all(_pack_scales(q, s), group)
    qx, sx = _unpack_scales(px, int(s.shape[-1]))
    red = torch.sum(dequantize_blocks(qx, sx, out_dim=int(x.shape[-1])),
                    dim=0)
    return red.to(x.dtype)


# ---------------------------------------------------------------------------
# the dp gradient sync
# ---------------------------------------------------------------------------

def tree_leaves(tree):
    """The leaves of a nest of dicts, lists and tuples in JAX's order
    (``jax.tree.flatten``: a dict's keys sorted), with a function that
    rebuilds the nest from a list of new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [tree_leaves(tree[k]) for k in keys]
        leaves = [leaf for sub_leaves, _ in subs for leaf in sub_leaves]

        def build(new):
            out, off = {}, 0
            for k, (sub_leaves, sub_build) in zip(keys, subs):
                out[k] = sub_build(new[off:off + len(sub_leaves)])
                off += len(sub_leaves)
            return out

        return leaves, build
    if isinstance(tree, (list, tuple)):
        subs = [tree_leaves(v) for v in tree]
        leaves = [leaf for sub_leaves, _ in subs for leaf in sub_leaves]

        def build(new):
            out, off = [], 0
            for sub_leaves, sub_build in subs:
                out.append(sub_build(new[off:off + len(sub_leaves)]))
                off += len(sub_leaves)
            return type(tree)(out) if isinstance(tree, list) \
                else tuple(out)

        return leaves, build
    return [tree], lambda new: new[0]


def all_reduce_tree(tree, group=None):
    """The unquantized dp gradient sync: the sum over the group of a tree
    of tensors, as ONE all-reduce per dtype (the leaves of a dtype
    concatenated flat in JAX's leaf order and split back), where JAX's
    ``psum`` of the tree is one collective over all its leaves."""
    leaves, build = tree_leaves(tree)
    if group_ref(group).size == 1:
        return build(list(leaves))
    out = list(leaves)
    for dtype in dict.fromkeys(leaf.dtype for leaf in leaves):
        idx = [i for i, leaf in enumerate(leaves) if leaf.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        red, off = all_reduce(flat, group), 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = red[off:off + n].reshape(leaves[i].shape)
            off += n
    return build(out)


def quantized_psum_tree(tree, group=None, *, block: int = QCOLL_BLOCK):
    """The dp gradient sync: the sum over the group of a tree of float
    leaves (a grads dict) through ONE quantized exchange. The float
    leaves flatten and concatenate into one f32 vector in JAX's leaf
    order (a dict's keys sorted: the 128-wide blocks, and so every
    scale, depend on that order), `quantized_psum` sums it, and the
    result splits back at each leaf's shape and dtype. Non-float leaves
    take a plain sum."""
    leaves, build = tree_leaves(tree)
    qleaves = [leaf for leaf in leaves if _quantizable(leaf)]
    if not qleaves:
        return build([all_reduce(leaf, group) for leaf in leaves])
    flat = torch.cat([leaf.to(torch.float32).reshape(-1)
                      for leaf in qleaves])
    red = quantized_psum(flat, group, block=block)
    out, off = [], 0
    for leaf in leaves:
        if _quantizable(leaf):
            n = leaf.numel()
            out.append(red[off:off + n].reshape(leaf.shape).to(leaf.dtype))
            off += n
        else:
            out.append(all_reduce(leaf, group))
    return build(out)


def psum_tree(tree, group=None, quantized: bool = False):
    """The gradient sum over the group: the int8 `quantized_psum_tree`
    with `quantized`, else `all_reduce_tree`."""
    if quantized:
        return quantized_psum_tree(tree, group)
    return all_reduce_tree(tree, group)
