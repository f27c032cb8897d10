"""Single-token decode attention (counterpart of
paddle_tpu/kernels/decode_attention.py): ``paged_decode_attention`` over
paged pools, and ``decode_attention`` / ``gqa_decode_attention`` over
contiguous per-layer caches.

Contiguous caches: q [B, Hq, D]; k/v caches [B, Hkv, max_seq, D] in q's
dtype; lens [B] int32 = tokens cached before the current one, whose K/V
is already written at position lens[b] -- positions <= lens[b] are
attended. ``decode_attention`` takes equal heads (Hq == Hkv),
``gqa_decode_attention`` any Hq that is a multiple of Hkv; CUDA tensors
launch ``csrc/decode_attention.cu`` (one kernel for both, each wrapper
with its own launch counter), CPU tensors run
``decode_attention_reference``.

Paged pools (``paged_decode_attention``): q [B, Hq, D]; key/value pools
[max_pages, Hkv, block_size, D]; block tables [B, W] int32 page ids
covering positions [0, W*block_size); lens [B] int32 = tokens cached
before the current one, whose K/V is already written at position
lens[b] -- so positions <= lens[b] are attended (an inclusive mask).

int8 pools (``kv_cache_dtype="int8"``) pass their per-(page, kv head)
f32 absmax scales ``k_scale`` / ``v_scale`` [max_pages, Hkv]: a stored
value x of page p, kv head h stands for x * scale[p, h].

CUDA tensors launch ``csrc/paged_decode_attention.cu`` (one kernel for
every group size Hq/Hkv >= 1, i.e. both the JAX package's GQA grid and
its equal-heads grid, with an int8-pool variant that applies the scales
inside its f32 accumulation); CPU tensors run
``paged_decode_attention_reference``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30


def paged_decode_attention_reference(q, key_cache, value_cache,
                                     block_tables, lens,
                                     scale: Optional[float] = None, *,
                                     k_scale=None, v_scale=None):
    """Plain PyTorch paged decode: gather the table's pages, mask
    positions > lens, softmax in f32. Page ids are clamped into the
    pool, as the CUDA kernel clamps them. int8 pages are dequantized in
    f32 against `k_scale` / `v_scale` [max_pages, Hkv] (never through a
    narrower type)."""
    b, hq, d = q.shape
    n_pages, hkv, bs, _ = key_cache.shape
    w = block_tables.shape[1]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tbl = block_tables.to(torch.int64).clamp(0, n_pages - 1)

    def gather(pool, sc):  # [B, W, Hkv, bs, D] -> [B, Hkv, W*bs, D] f32
        pages = pool[tbl].to(torch.float32)
        if sc is not None:
            pages = pages * sc.to(torch.float32)[tbl][..., None, None]
        return pages.permute(0, 2, 1, 3, 4).reshape(b, hkv, w * bs, d)

    k, v = gather(key_cache, k_scale), gather(value_cache, v_scale)
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) * scale
    pos = torch.arange(w * bs, device=q.device)
    valid = pos[None, :] <= lens.to(torch.int64)[:, None]       # [B, T]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v) / p.sum(-1, keepdim=True)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, key_cache: torch.Tensor,
                           value_cache: torch.Tensor,
                           block_tables: torch.Tensor, lens: torch.Tensor,
                           scale: Optional[float] = None, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One decode step over a paged cache. Returns [B, Hq, D]."""
    quant = _build.int8_pools(key_cache, k_scale, v_scale)
    b, hq, d = q.shape
    n_pages, hkv, bs, _ = key_cache.shape
    if hq % hkv:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, key_cache, value_cache, block_tables, lens, scale,
            k_scale=k_scale, v_scale=v_scale)
    what = "paged_decode_attention"
    scales = (k_scale, v_scale) if quant else ()
    dev = _build.require_cuda(what, q, key_cache, value_cache,
                              block_tables, lens, *scales)
    _build.require_contiguous(what, q=q, key_cache=key_cache,
                              value_cache=value_cache,
                              block_tables=block_tables, lens=lens)
    if quant:
        _build.require_q8_operands(what, key_cache, value_cache, k_scale,
                                   v_scale)
    elif not (q.dtype == key_cache.dtype == value_cache.dtype):
        raise ValueError(f"{what}: q and pools must share a dtype, got "
                         f"{q.dtype}/{key_cache.dtype}/{value_cache.dtype}")
    if value_cache.shape != key_cache.shape or key_cache.shape[3] != d:
        raise ValueError(f"{what}: pools must be [P, {hkv}, bs, {d}], got "
                         f"{list(key_cache.shape)} / "
                         f"{list(value_cache.shape)}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"{what}: block_tables and lens must be int32")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or lens.shape != (b,):
        raise ValueError(f"{what}: block_tables [{b}, W] and lens [{b}] "
                         f"expected, got {list(block_tables.shape)} / "
                         f"{list(lens.shape)}")
    if hkv > 65535:
        raise ValueError(f"{what}: {hkv} kv heads exceed the grid")
    out = torch.empty_like(q)
    lib = _build.library(what)
    dims = (b, hq, hkv, d, bs, block_tables.shape[1], n_pages, float(scale),
            _build.dtype_code(q.dtype), _build.stream_ptr(dev))
    if quant:
        code = lib.paged_decode_attention_q8_launch(
            q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
            lens.data_ptr(), out.data_ptr(), *dims)
        what += _build.INT8_SUFFIX
    else:
        code = lib.paged_decode_attention_launch(
            q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(), *dims)
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return out


def decode_attention_reference(q, k_cache, v_cache, lens,
                               scale: Optional[float] = None):
    """Plain PyTorch decode over contiguous caches [B, Hkv, max_seq, D]:
    mask positions > lens, softmax in f32, any group size."""
    b, hq, d = q.shape
    hkv, max_seq = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    s = torch.einsum("bhgd,bhtd->bhgt", qg,
                     k_cache.to(torch.float32)) * scale
    pos = torch.arange(max_seq, device=q.device)
    valid = pos[None, :] <= lens.to(torch.int64)[:, None]       # [B, T]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, _NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    out = torch.einsum("bhgt,bhtd->bhgd", p, v_cache.to(torch.float32)) \
        / p.sum(-1, keepdim=True)
    return out.reshape(b, hq, d).to(q.dtype)


def _contiguous_decode(what: str, q, k_cache, v_cache, lens, scale):
    b, hq, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: caches must be [{b}, Hkv, max_seq, {d}], "
                         f"got {list(k_cache.shape)} / "
                         f"{list(v_cache.shape)}")
    hkv, max_seq = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lens, scale)
    dev = _build.require_cuda(what, q, k_cache, v_cache, lens)
    _build.require_contiguous(what, q=q, k_cache=k_cache, v_cache=v_cache,
                              lens=lens)
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"{what}: q and caches must share a dtype, got "
                         f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if lens.dtype != torch.int32 or lens.shape != (b,):
        raise ValueError(f"{what}: lens must be int32 [{b}], got "
                         f"{lens.dtype} {list(lens.shape)}")
    if hkv > 65535:
        raise ValueError(f"{what}: {hkv} kv heads exceed the grid")
    out = torch.empty_like(q)
    lib = _build.library("decode_attention")
    code = lib.contiguous_decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, hq, hkv, d, max_seq, float(scale),
        _build.dtype_code(q.dtype), _build.stream_ptr(dev))
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lens: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One decode step over contiguous caches with equal heads: q
    [B, H, D], caches [B, H, max_seq, D]. Returns [B, H, D]."""
    if k_cache.ndim == 4 and k_cache.shape[1] != q.shape[1]:
        raise ValueError(f"decode_attention: equal heads expected, got Hq "
                         f"{q.shape[1]} and Hkv {k_cache.shape[1]} (use "
                         "gqa_decode_attention)")
    return _contiguous_decode("decode_attention", q, k_cache, v_cache, lens,
                              scale)


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lens: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """One grouped-query decode step over contiguous caches: q
    [B, Hq, D], caches [B, Hkv, max_seq, D], Hq % Hkv == 0. Returns
    [B, Hq, D]."""
    return _contiguous_decode("gqa_decode_attention", q, k_cache, v_cache,
                              lens, scale)
