"""Paged prefix-prefill attention (counterpart of
paddle_tpu/kernels/prefix_prefill.py ``prefix_prefill_attention``).

A request whose prompt head hit the block-aligned prefix cache prefills
only its bucketed suffix: the suffix queries attend over (a) the cached
prefix K/V in the paged pools, named page by page by the row's table, and
(b) the suffix itself, causally. Layouts match the JAX function: q
[b, sb, Hq, D]; suffix k/v [b, sb, Hkv, D]; pools [max_pages, Hkv, page, D];
prefix_tables [b, w_pre] int32; prefix_lens [b] (whole pages);
suffix_lens [b] (true suffix lengths; rows past them are pad rows and come
out as exact zeros).

int8 pools (``kv_cache_dtype="int8"``) pass their per-(page, kv head) f32
absmax scales ``k_scale`` / ``v_scale`` [max_pages, Hkv]; the suffix K/V
stay in q's dtype.

CUDA tensors launch ``csrc/paged_prefill_attention.cu``, the one kernel
behind this function and ``ragged_attention.ragged_paged_attention`` (with
an int8-pool variant that applies the scales inside its f32
accumulation); CPU tensors run ``prefix_prefill_reference``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .flash_attention import KERNEL_HEAD_DIMS

_NEG_INF = -1e30


def paged_prefill_reference(q, k_new, v_new, key_cache, value_cache,
                            block_tables, cached_lens, new_lens,
                            scale: float, k_scale=None, v_scale=None):
    """The masked-softmax math both JAX kernels compute: gather the
    table's pages, append the window, mask (cached position t < cached_len;
    window key j <= query i and j < new_len), softmax in f32. Page ids are
    clamped into the pool, as the CUDA kernel clamps them. Rows at window
    positions >= new_len are exact zeros. int8 pages are dequantized in
    f32 against `k_scale` / `v_scale` and stay f32 into the einsum, as in
    the JAX references (a round trip through q's dtype there would be a
    rounding the kernels do not have). Returns [b, tn, Hq, D] in f32."""
    b, tn, nh, dh = q.shape
    n_pages, nkv, page, _ = key_cache.shape
    w = block_tables.shape[1]
    span = w * page
    group = nh // nkv
    dev = q.device
    tbl = block_tables.to(torch.int64).clamp(0, n_pages - 1)
    # dequantized int8 pages are joined in f32, bf16 pages in q's dtype
    cat_dtype = torch.float32 if k_scale is not None else q.dtype

    def gather(pool, sc, new):  # [b, span + tn, nkv, dh]
        pages = pool[tbl]                       # [b, w, nkv, page, dh]
        if sc is not None:
            pages = pages.to(torch.float32) \
                * sc.to(torch.float32)[tbl][..., None, None]
        pages = pages.permute(0, 1, 3, 2, 4).reshape(b, span, nkv, dh)
        return torch.cat([pages.to(cat_dtype), new.to(cat_dtype)], dim=1)

    keys = gather(key_cache, k_scale, k_new)
    vals = gather(value_cache, v_scale, v_new)
    clen = cached_lens.to(torch.int64)
    nlen = new_lens.to(torch.int64)
    cache_ok = torch.arange(span, device=dev)[None, :] < clen[:, None]
    pos = torch.arange(tn, device=dev)
    causal = pos[None, :] <= pos[:, None]
    win_ok = causal[None] & (pos[None, None, :] < nlen[:, None, None])
    mask = torch.cat([cache_ok[:, None, :].expand(b, tn, span), win_ok],
                     dim=-1)
    q5 = q.reshape(b, tn, nkv, group, dh).to(torch.float32)
    s = torch.einsum("bsngd,btnd->bsngt", q5, keys.to(torch.float32)) * scale
    s = torch.where(mask[:, :, None, None, :], s,
                    torch.full_like(s, _NEG_INF))
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bsngt,btnd->bsngd", probs, vals.to(torch.float32))
    live = pos[None, :] < nlen[:, None]
    ctx = torch.where(live[:, :, None, None, None], ctx,
                      torch.zeros_like(ctx))
    return ctx.reshape(b, tn, nh, dh)


def launch_paged_prefill(what: str, q, k_new, v_new, key_cache, value_cache,
                         block_tables, cached_lens, new_lens,
                         scale: float, k_scale=None,
                         v_scale=None) -> torch.Tensor:
    """Check the operands and launch the CUDA kernel (its int8-pool
    variant when `k_scale` / `v_scale` are given); `what` names the JAX
    function the caller stands for (its launch counter, plus "_int8" over
    int8 pools)."""
    b, tn, nh, dh = q.shape
    n_pages, nkv, page, _ = key_cache.shape
    quant = k_scale is not None
    scales = (k_scale, v_scale) if quant else ()
    dev = _build.require_cuda(what, q, k_new, v_new, key_cache, value_cache,
                              block_tables, cached_lens, new_lens, *scales)
    _build.require_contiguous(what, q=q, k_new=k_new, v_new=v_new,
                              key_cache=key_cache, value_cache=value_cache,
                              block_tables=block_tables,
                              cached_lens=cached_lens, new_lens=new_lens)
    if quant:
        _build.require_q8_operands(what, key_cache, value_cache, k_scale,
                                   v_scale)
    dtypes = {q.dtype, k_new.dtype, v_new.dtype} \
        | (set() if quant else {key_cache.dtype, value_cache.dtype})
    if len(dtypes) != 1:
        raise ValueError(f"{what}: q, window k/v and pools must share a "
                         f"dtype, got {sorted(map(str, dtypes))}")
    code = _build.dtype_code(q.dtype)
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {dh} not in {KERNEL_HEAD_DIMS}")
    if k_new.shape != (b, tn, nkv, dh) or v_new.shape != k_new.shape:
        raise ValueError(f"{what}: window k/v must be [{b}, {tn}, {nkv}, "
                         f"{dh}], got {list(k_new.shape)} / "
                         f"{list(v_new.shape)}")
    if value_cache.shape != key_cache.shape or key_cache.shape[3] != dh:
        raise ValueError(f"{what}: pools must be [P, {nkv}, page, {dh}], "
                         f"got {list(key_cache.shape)} / "
                         f"{list(value_cache.shape)}")
    if block_tables.dtype != torch.int32 or cached_lens.dtype != torch.int32 \
            or new_lens.dtype != torch.int32:
        raise ValueError(f"{what}: tables and lengths must be int32")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or cached_lens.shape != (b,) or new_lens.shape != (b,):
        raise ValueError(f"{what}: tables [{b}, W] and lengths [{b}] "
                         f"expected, got {list(block_tables.shape)} / "
                         f"{list(cached_lens.shape)} / "
                         f"{list(new_lens.shape)}")
    if b * nkv > 65535:
        raise ValueError(f"{what}: batch*kv heads {b * nkv} exceed the grid")
    if any(t.data_ptr() % 16 for t in (q, k_new, v_new, key_cache,
                                       value_cache)):
        raise ValueError(f"{what}: q, window k/v and pools must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    lib = _build.library("paged_prefill_attention")
    pools = (key_cache.data_ptr(), value_cache.data_ptr())
    rest = (block_tables.data_ptr(), cached_lens.data_ptr(),
            new_lens.data_ptr(), out.data_ptr(), b, tn, nh, nkv, dh, page,
            block_tables.shape[1], n_pages, float(scale), code,
            _build.stream_ptr(dev))
    window = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr())
    if quant:
        rc = lib.paged_prefill_attention_q8_launch(
            *window, *pools, k_scale.data_ptr(), v_scale.data_ptr(), *rest)
        what += _build.INT8_SUFFIX
    else:
        rc = lib.paged_prefill_attention_launch(*window, *pools, *rest)
    _build.check(lib, rc, what)
    _build.LAUNCHES[what] += 1
    return out


def prefix_prefill_reference(q, k_suf, v_suf, key_cache, value_cache,
                             prefix_tables, prefix_lens,
                             suffix_lens: Optional[torch.Tensor] = None, *,
                             scale: Optional[float] = None,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None):
    """Plain twin of the JAX ``prefix_prefill_reference``, with
    `suffix_lens`: rows at positions >= suffix_lens are exact zeros, as
    the kernel's output is (the JAX reference leaves them unspecified).
    Returns [b, sb, Hq, D] in f32."""
    _build.int8_pools(key_cache, k_scale, v_scale)
    b, sb, _, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if suffix_lens is None:
        suffix_lens = torch.full((b,), sb, dtype=torch.int32,
                                 device=q.device)
    return paged_prefill_reference(q, k_suf, v_suf, key_cache, value_cache,
                                   prefix_tables, prefix_lens, suffix_lens,
                                   scale, k_scale, v_scale)


def prefix_prefill_attention(q: torch.Tensor, k_suf: torch.Tensor,
                             v_suf: torch.Tensor, key_cache: torch.Tensor,
                             value_cache: torch.Tensor,
                             prefix_tables: torch.Tensor,
                             prefix_lens: torch.Tensor,
                             suffix_lens: Optional[torch.Tensor] = None, *,
                             scale: Optional[float] = None,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Suffix-query attention over a cached paged prefix plus the causal
    suffix, without gathering the prefix. Returns [b, sb, Hq, D] in q's
    dtype; rows at positions >= suffix_lens[b] are zeros."""
    b, sb, nh, dh = q.shape
    nkv, page = key_cache.shape[1], key_cache.shape[2]
    if nh % nkv:
        raise ValueError(f"Hq {nh} not a multiple of Hkv {nkv}")
    if sb % page:
        raise ValueError(f"suffix bucket {sb} is not a whole number of "
                         f"{page}-token KV pages")
    if prefix_tables.shape[1] < 1:
        raise ValueError("prefix_tables must be at least one page wide "
                         "(pad with the scratch page and prefix_lens 0)")
    _build.int8_pools(key_cache, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if suffix_lens is None:
        suffix_lens = torch.full((b,), sb, dtype=torch.int32,
                                 device=q.device)
    if q.device.type == "cpu":
        return prefix_prefill_reference(
            q, k_suf, v_suf, key_cache, value_cache, prefix_tables,
            prefix_lens, suffix_lens, scale=scale, k_scale=k_scale,
            v_scale=v_scale).to(q.dtype)
    return launch_paged_prefill("prefix_prefill_attention", q, k_suf, v_suf,
                                key_cache, value_cache, prefix_tables,
                                prefix_lens, suffix_lens, scale, k_scale,
                                v_scale)
