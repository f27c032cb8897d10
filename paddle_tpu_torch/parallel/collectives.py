"""Quantized collectives over torch.distributed process groups
(counterpart of paddle_tpu/parallel/collectives.py).

The JAX functions take a mesh axis name inside ``shard_map``; these take
a process group (None = the default group) and run on every rank of it,
SPMD. The wire format is the JAX package's, byte for byte:

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
- ``quantized_reduce_scatter``: the first hop alone.

The plain collectives below them (``all_gather``, ``all_reduce``,
``all_to_all``) are the only calls into torch.distributed the serving
seams make. gloo has no CUDA path for all_to_all and only a host-staged
one for the rest, so on a gloo group a CUDA tensor is copied to the host,
exchanged there and copied back: the call that works for every op, taken
on purpose (ranks that share one card run gloo; NCCL refuses two ranks on
one GPU). NCCL groups exchange device tensors directly.

The tree psum of dp gradients (`quantized_psum_tree`) serves training and
is not here yet (ROADMAP.md section 1 item 5).
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist

from ..framework.flags import flag as _flag

__all__ = [
    "QCOLL_BLOCK", "QCOLL_FALLBACK_MSG", "resolve_quantized_collectives",
    "quantize_blocks", "dequantize_blocks", "quantized_all_gather",
    "quantized_psum", "quantized_psum_prequant", "quantized_reduce_scatter",
    "all_gather", "all_reduce", "all_to_all", "group_size",
]

# lane-width blocks along the last dim (one f32 scale per 128 int8 bytes)
QCOLL_BLOCK = 128

QCOLL_FALLBACK_MSG = (
    "payload cannot be block-quantized; falling back to the "
    "unquantized collective (full-width wire bytes, exact numerics)")


def resolve_quantized_collectives(quantized: Optional[bool] = None) -> bool:
    """The quantized-collectives switch, from the argument or
    FLAGS_quantized_collectives. Read at engine-build time; False keeps
    every wire byte-identical to a build without the flag."""
    if quantized is None:
        quantized = _flag("quantized_collectives")
    return bool(quantized)


# ---------------------------------------------------------------------------
# the plain collectives (the only torch.distributed calls of the seams)
# ---------------------------------------------------------------------------

def group_size(group=None) -> int:
    return dist.get_world_size(group)


def _host_staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order (the JAX
    ``all_gather(tiled=True)``)."""
    n = group_size(group)
    if n == 1:
        return x
    staged = _host_staged(x, group)
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """A new tensor holding the sum (or max) of every rank's `x`."""
    if group_size(group) == 1:
        return x
    staged = _host_staged(x, group)
    out = x.cpu() if staged else x.clone()
    out = out.contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return out.to(x.device) if staged else out


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """x [n, ...] -> [n, ...]: row j goes to rank j, and row j of the
    result came from rank j (the JAX ``all_to_all(split_axis=0,
    concat_axis=0)``)."""
    n = group_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} is not the "
                         f"group size {n}")
    staged = _host_staged(x, group)
    src = (x.cpu() if staged else x).contiguous()
    # the single-tensor form: gloo implements it (alltoall_base), not the
    # list form
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if staged else out


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
        return full.reshape(n, -1, *x.shape[1:])[dist.get_rank(group)]
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
