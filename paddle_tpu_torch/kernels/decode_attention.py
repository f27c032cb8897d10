"""Paged single-token decode attention (counterpart of
paddle_tpu/kernels/decode_attention.py ``paged_decode_attention``).

Layouts match the JAX function: q [B, Hq, D]; key/value pools
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
