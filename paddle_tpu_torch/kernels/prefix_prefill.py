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
accumulation); CPU tensors run ``prefix_prefill_reference``. On bf16 /
f16 operands the kernel splits the cached phase across blocks when the
grid is small (``decode_attention.prefill_split_plan``) and merges the
splits in the same launch; ``split_prefill_reference`` is the plain twin
of that split-and-merge and of its P V arithmetic (tests and the card
check hold the kernel against it; the wrappers never call it).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .decode_attention import (PREFILL_TILE, prefill_split_plan,
                               split_scratch)
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


def split_prefill_reference(q, k_new, v_new, key_cache, value_cache,
                            block_tables, cached_lens, new_lens,
                            scale: Optional[float] = None, *,
                            k_scale=None, v_scale=None,
                            tiles_per_split: Optional[int] = None):
    """The plain twin of the CUDA kernel's arithmetic on 16-bit operands,
    in f32: the W * page cached positions in tiles of PREFILL_TILE keys,
    `tiles_per_split` tiles a split (default ``prefill_split_plan``'s),
    split 0 also holding the window. Per split: m = max logit (scale,
    then an int8 key's scale; masked as in ``paged_prefill_reference``),
    p = exp(s - m), l = sum p, acc = P V where P is p times the value's
    scale on int8 pools, carried as hi = T(P) plus lo = T(P - hi) (T q's
    dtype; f32: P itself), and V is the pool's stored values. Splits that
    start at or past cached_len weigh 0 (split 0 never does); then out =
    sum_s w_s acc_s / sum_s w_s l_s with w_s = exp(m_s - max m). Pad rows
    are exact zeros. Returns [b, tn, Hq, D] in q's dtype."""
    b, tn, nh, dh = q.shape
    n_pages, nkv, page, _ = key_cache.shape
    w = block_tables.shape[1]
    span, group = w * page, nh // nkv
    f32, dev = torch.float32, q.device
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    tbl = block_tables.to(torch.int64).clamp(0, n_pages - 1)
    kc, vc = (pool[tbl].to(f32).permute(0, 1, 3, 2, 4)
              .reshape(b, span, nkv, dh) for pool in (key_cache, value_cache))
    ks = vs = torch.ones(b, span, nkv, dtype=f32, device=dev)
    if k_scale is not None:     # per position: its page's scale
        ks, vs = (sc.to(f32)[tbl].repeat_interleave(page, dim=1)
                  for sc in (k_scale, v_scale))
    tps = tiles_per_split or prefill_split_plan(span, tn, group, b, nkv)[0]
    n_tiles = -(-span // PREFILL_TILE)
    n_split = -(-n_tiles // tps)
    width = tps * PREFILL_TILE
    pad = n_split * width - span
    kc, vc = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
              for x in (kc, vc))
    ks, vs = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (ks, vs))
    clen = cached_lens.to(torch.int64).clamp(0, span)
    nlen = new_lens.to(torch.int64)
    qg = q.reshape(b, tn, nkv, group, dh).to(f32)
    s_c = torch.einsum("bsngd,btnd->bsngt", qg, kc) * scale \
        * ks.permute(0, 2, 1)[:, None, :, None, :]
    pos = torch.arange(n_split * width, device=dev)
    s_c = torch.where((pos[None, :] < clen[:, None])[:, None, None, None],
                      s_c, torch.full_like(s_c, _NEG_INF))
    s_w = torch.einsum("bsngd,btnd->bsngt", qg, k_new.to(f32)) * scale
    win = torch.arange(tn, device=dev)
    win_ok = (win[None, :] <= win[:, None])[None] \
        & (win[None, None, :] < nlen[:, None, None])       # [b, s, t]
    s_w = torch.where(win_ok[:, :, None, None, :], s_w,
                      torch.full_like(s_w, _NEG_INF))
    vs_t = vs.permute(0, 2, 1)[:, None, :, None, :]       # [b, 1, n, 1, t]
    lo_t = q.dtype if q.dtype != f32 else None

    def part(s, v, vmul):
        m = torch.amax(s, dim=-1)
        p = torch.exp(s - m[..., None])
        pv = p * vmul
        hi = pv.to(lo_t).to(f32) if lo_t else pv
        acc = torch.einsum("bsngt,btnd->bsngd", hi, v)
        if lo_t:
            acc = acc + torch.einsum("bsngt,btnd->bsngd",
                                     (pv - hi).to(lo_t).to(f32), v)
        return m, p.sum(-1), acc

    ms, ls, accs = [], [], []
    for sp in range(n_split):
        cut = slice(sp * width, (sp + 1) * width)
        s, v, vmul = s_c[..., cut], vc[:, cut], vs_t[..., cut]
        if sp == 0:
            s = torch.cat([s, s_w], dim=-1)
            v = torch.cat([v, v_new.to(f32)], dim=1)
            vmul = torch.cat([vmul.expand(*s_w.shape[:-1], width),
                              torch.ones_like(s_w)], dim=-1)
        m, l, acc = part(s, v, vmul)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    live = (torch.arange(n_split, device=dev)[:, None] * width
            < clen[None, :]) | (torch.arange(n_split, device=dev) == 0
                                )[:, None]                  # [S, b]
    live = live[:, :, None, None, None]
    m = torch.where(live, m, torch.full_like(m, _NEG_INF))
    wgt = torch.exp(m - torch.amax(m, dim=0, keepdim=True))
    wgt = torch.where(live, wgt, torch.zeros_like(wgt))
    out = (wgt[..., None] * acc).sum(0) / (wgt * l).sum(0)[..., None]
    out = torch.where((win[None, :] < nlen[:, None])[:, :, None, None, None],
                      out, torch.zeros_like(out))
    return out.reshape(b, tn, nh, dh).to(q.dtype)


def _paged_prefill_cuda(what: str, q, k_new, v_new, key_cache, value_cache,
                        block_tables, cached_lens, new_lens, scale: float,
                        k_scale=None, v_scale=None) -> torch.Tensor:
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
    w = block_tables.shape[1]
    # f32 operands keep the unsplit CUDA-core body
    tps, splits = (1, 1) if q.dtype == torch.float32 else \
        prefill_split_plan(w * page, tn, nh // nkv, b, nkv)
    row_tiles = -(-tn * (nh // nkv) // PREFILL_TILE)
    scratch = split_scratch(dev, b * nkv * row_tiles, splits, PREFILL_TILE,
                            dh)
    lib = _build.library("paged_prefill_attention")
    pools = (key_cache.data_ptr(), value_cache.data_ptr())
    rest = (block_tables.data_ptr(), cached_lens.data_ptr(),
            new_lens.data_ptr(), out.data_ptr(), *scratch, b, tn, nh, nkv,
            dh, page, w, n_pages, tps, splits, float(scale), code,
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


# one operator for the two JAX functions the kernel serves (`what` names
# the launch counter: prefix_prefill_attention or ragged_paged_attention)
paged_prefill_op = _build.kernel_op(
    "paged_prefill_attention",
    "(str what, Tensor q, Tensor k_new, Tensor v_new, Tensor key_cache, "
    "Tensor value_cache, Tensor block_tables, Tensor cached_lens, "
    "Tensor new_lens, float scale, Tensor? k_scale, Tensor? v_scale) "
    "-> Tensor",
    cuda=_paged_prefill_cuda,
    cpu=lambda what, q, *a: paged_prefill_reference(q, *a).to(q.dtype),
    fake=lambda what, q, *a: torch.empty_like(q))


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
    return paged_prefill_op("prefix_prefill_attention", q, k_suf, v_suf,
                            key_cache, value_cache, prefix_tables,
                            prefix_lens, suffix_lens, float(scale), k_scale,
                            v_scale)
