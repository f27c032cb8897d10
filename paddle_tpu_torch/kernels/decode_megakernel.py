"""The decode megakernel ladder (counterpart of
paddle_tpu/kernels/decode_megakernel.py): the serving decode step of one
layer, or of every layer, in one kernel launch.

Three wrappers, one per rung, with the JAX package's signatures:

- ``decode_layer_megakernel`` (rung ``attn``): one layer's attention
  block -- rms_norm, the q/k/v projections, rotary, paged GQA attention
  over the layer's pool, the commit of the current token's K/V into its
  page, the o projection and the residual add;
- ``decode_layer_megakernel_full`` (rung ``full``): the same plus the
  MLP half (post-attention rms_norm, gate and up, silu(gate) * up, down,
  residual) -- ``decode_layers_megakernel`` at one layer;
- ``decode_layers_megakernel`` (rung ``scan``): every layer of the
  decoder in one launch, over weights stacked along a leading layer axis
  and one layer-major pool [n_layers * max_pages, Hkv, block, D] (layer
  l owns pages [l * max_pages, (l + 1) * max_pages); the block table
  holds per-layer page ids).

Operands: h [b, 1, H]; lens [b] int32 = tokens cached before the
current one (its position); tables [b, W] int32; dense weights [K, N]
in h's dtype or weight-only int8 pairs (int8 [N, K], f32 scale [N]), all
of one kind; pools bf16 / f32 in h's dtype, or int8 with ``k_scale`` /
``v_scale`` [pages, Hkv] f32. The pools are updated IN PLACE (the JAX
functions return new arrays): exactly one page per (layer, row, kv head)
is rewritten, the page the current token lands in. Returns (h_out
[b, 1, H], k_cache, v_cache), or (h_out, (k_cache, k_scale), (v_cache,
v_scale)) on int8 pools.

Numerics are the megakernel's own, not the multi-kernel step's
(decode_megakernel.py:319-440, :1071-1115): streamed positions are
masked strictly below lens and the current token's k / v join the
softmax unquantized from the projection; attention reads the commit
page before the commit rewrites it; rotary runs in the compute dtype
from f32 tables of ``rope_freqs(position_ids=lens)``; the o projection
and down projection sum in f32, apply a weight-only scale after the
whole sum, add the residual in f32 and round once; gate and up round to
the compute dtype before ``silu(gate) * up``. The int8 commit is the q8
helpers' read-modify-write, op for op (slot 0 resets the page's scale).

CUDA tensors launch ``csrc/decode_megakernel.cu`` (one persistent
kernel per call; counters ``decode_layer_megakernel``,
``decode_layer_megakernel_full`` and ``decode_layers_megakernel``, each
with ``_int8`` for int8 pools); CPU tensors run the ``*_reference``
plain versions. The kernel's shared memory (``smem_bytes``, exact, for
the planner on meta tensors) is computed here from the shapes; the
launch's grid, the GEMV phases' K splits and the scratch they need are
the card's (``card_geometry``). ``megakernel_attention_pieces`` (the
pieces phase 2 cuts from lens over the grid) and
``split_attend_current_reference`` (its split-and-merge attention) are
the plain twins of the kernel's phase 2: the CPU tests hold them against
the unsplit plain attention and JAX; the wrappers never call them.
``residual=False`` and ``quantize_out=True`` serve the JAX package's
tensor-parallel decode and are not ported (ROADMAP.md section 1 item 5).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .rms_norm import rms_norm_reference

_NEG_INF = -1e30

# the CUDA kernel's own limits and layout (csrc/decode_megakernel.cu): the
# planner sizes its shared memory on meta tensors, with no card
CARD_MAX_ROWS = 16               # rows of h one launch takes (MAXB)
CARD_SMEM_BYTES = 232448         # shared memory one block may use (H100)
CARD_DTYPES = (torch.float32, torch.bfloat16)
_THREADS = 256
_RING_STAGES = 4                 # STAGES: the weight ring's depth
_MISC_BYTES = 512
# the GEMV tile of each weight kind (`Geo`), as far as shared memory
# needs it: output channels a tile, k a ring stage, staged rows of a
# stage and their bytes (each padded by 16), warps sharing a tile's
# channels along k
_GEO = {"int8": dict(tn=16, tk=1024, rows=16, row=1024, kg=8),
        torch.bfloat16: dict(tn=64, tk=128, rows=128, row=128, kg=2),
        torch.float32: dict(tn=64, tk=64, rows=64, row=256, kg=2)}

_TP_ONLY = ("is the tensor-parallel decode seam, not ported yet "
            "(ROADMAP.md section 1 item 5)")


# ---------------------------------------------------------------------------
# support checks (the JAX reasons, with the card's limits in place of the
# TPU's VMEM budget)
# ---------------------------------------------------------------------------

def _unpack_weight(w, n_out, n_in):
    """(array, scale_or_None, is_quant) for a decode weight: dense
    [n_in, n_out], or a weight-only pair (int8 [n_out, n_in], scale
    [n_out]). Packed int4 (K // 2 columns) returns is_quant=None."""
    if isinstance(w, tuple):
        wq, sc = w
        if tuple(wq.shape) != (n_out, n_in):
            return None, None, None  # packed int4 or foreign layout
        return wq, sc, True
    if tuple(w.shape) != (n_in, n_out):
        return None, None, None
    return w, None, False


@functools.lru_cache(maxsize=256)
def _card_reason(b, H, F, nh, nkv, dh, bs, quant_w, quant_kv, dtype):
    """None when the CUDA kernel takes these shapes, else the card's
    limit they exceed (the kernel's shared memory is sized per launch).
    Kept per shape: the engine launches one shape again and again."""
    if dtype not in CARD_DTYPES:
        return (f"card limit: the CUDA megakernel takes float32 or "
                f"bfloat16 activations, got {dtype}")
    if b > CARD_MAX_ROWS:
        return (f"card limit: the CUDA megakernel takes at most "
                f"{CARD_MAX_ROWS} rows per launch, got {b}")
    unit = 16 if quant_w else 16 // dtype.itemsize
    if any(k % unit for k in (H, nh * dh, F or unit)):
        kind = "int8" if quant_w else str(dtype).replace("torch.", "")
        return (f"card limit: {kind} weights need every contraction width "
                f"(H {H}, Hq*D {nh * dh}, F {F}) to be a multiple of "
                f"{unit} (16-byte weight and input copies)")
    if dh % 16 or dh > 256:
        return (f"card limit: the CUDA megakernel takes head_dim a "
                f"multiple of 16 up to 256, got {dh}")
    smem = smem_bytes(b, H, nh, nkv, dh, bs, quant_w, quant_kv, dtype)
    if smem > CARD_SMEM_BYTES:
        return (f"card limit: the CUDA megakernel needs {smem} bytes of "
                f"shared memory per block, over the card's "
                f"{CARD_SMEM_BYTES}")
    return None


def _geometry(quant_w, dtype):
    return _GEO["int8" if quant_w else dtype]


def _attn_bytes(group, dh, st, kv_itemsize) -> int:
    """Phase 2's shared memory (`AttnLayout`): f32 q, acc per key split of
    P V, scores, m / l / corr, the merge flag; a ring of four stages of
    K and V tiles (two on f32 pools); the current token's k, v, weights
    and a block reduction."""
    lpr = 1
    while lpr < dh // 8:
        lpr *= 2
    rows = _THREADS // lpr
    key_splits = 1 if group >= rows else rows // group
    stages = 2 if kv_itemsize == 4 else 4
    f32 = 4 * (group * dh * (1 + key_splits) + group * st + 3 * group + 1)
    ring = -(-f32 // 16) * 16 + 2 * stages * st * dh * kv_itemsize
    return -(-(ring + 4 * (2 * dh + group + 8)) // 16) * 16


@functools.lru_cache(maxsize=256)
def smem_bytes(b, H, nh, nkv, dh, bs, quant_w, quant_kv, dtype) -> int:
    """Dynamic shared memory of one block (`Layout`), exact: a misc area,
    the weight ring, the k groups' partial tiles, and the larger of the
    staged phase input (b rows of max(H, Hq*D) padded to a ring stage's k)
    and phase 2's area."""
    from .decode_attention import decode_tile_rows

    geo = _geometry(quant_w, dtype)
    it = dtype.itemsize
    ring = _RING_STAGES * geo["rows"] * (geo["row"] + 16)
    red = geo["kg"] * b * geo["tn"] * 4
    kp = -(-max(H, nh * dh) // geo["tk"]) * geo["tk"]
    xpad = 4 if dtype == torch.float32 else (16 if quant_w else 8)
    x = b * (kp + xpad) * it
    attn = _attn_bytes(nh // nkv, dh, decode_tile_rows(bs),
                       1 if quant_kv else it)
    return int(_MISC_BYTES + ring + red + max(x, attn))


def page_fits_card(cfg, bs: int, quant_kv: bool) -> bool:
    """Whether the CUDA megakernel takes `bs`-token pages of this model at
    all: a one-row launch (the least shared memory any launch needs) over
    bf16 or int8 weights fits the card's shared memory. The page enters
    through phase 2's key tiles (`decode_tile_rows(bs)` rows a stage)."""
    nh, nkv, dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    return any(smem_bytes(1, cfg.hidden_size, nh, nkv, dh, bs, quant_w,
                          quant_kv, torch.bfloat16) <= CARD_SMEM_BYTES
               for quant_w in (False, True))


def megakernel_attention_pieces(lens, W, bs, nkv, blocks):
    """Phase 2's pieces, as the kernel cuts them from lens over a grid of
    `blocks`: every (row, kv head)'s tiles (decode_tile_rows(bs)
    positions each, the row's ceil(lens / rows) capped at W pages) in one
    list, row-major with a row's heads one after another; block i of the
    first n = min(blocks, T) takes tiles [i T / n, (i + 1) T / n). Returns
    {(row, head): [tile boundaries]}, 0 first and the row's tile count
    last ([0, 0] for a row with no position)."""
    from .decode_attention import decode_tile_rows

    st = decode_tile_rows(bs)
    rt = [min(W * (bs // st), -(-int(n) // st)) for n in lens]
    total = sum(rt) * nkv
    n = max(1, min(blocks, total))
    cuts = {(i * total) // n for i in range(n + 1)}
    out, start = {}, 0
    for row, n in enumerate(rt):
        for h in range(nkv):
            inner = sorted(c - start for c in cuts if start < c < start + n)
            out[(row, h)] = [0] + inner + [n]
            start += n
    return out


def megakernel_supported(h, w_in, wq, wk, wv, wo, k_cache, v_cache,
                         tables, *, k_scale=None, v_scale=None,
                         on_card: Optional[bool] = None) -> Optional[str]:
    """None when `decode_layer_megakernel` can serve these operands, a
    reason otherwise. `on_card` (default: whether the pool is a CUDA
    tensor) adds the CUDA kernel's limits; shape-only, so meta tensors
    serve as spec views."""
    return _attn_reason(h, wq, wk, wv, wo, k_cache, k_scale, v_scale,
                        on_card, F=None)


def _attn_reason(h, wq, wk, wv, wo, k_cache, k_scale, v_scale, on_card,
                 F):
    if h.ndim != 3 or h.shape[1] != 1:
        return f"hidden states must be [b, 1, H], got {tuple(h.shape)}"
    b, _, H = h.shape
    if k_cache.ndim != 4:
        return f"paged pools required, got cache rank {k_cache.ndim}"
    _, nkv, bs, dh = k_cache.shape
    if dh % 2:
        return f"head_dim {dh} is odd (rotary needs paired halves)"
    quant_kv = k_cache.dtype == torch.int8
    if quant_kv and (k_scale is None or v_scale is None):
        return "int8 pools need k_scale/v_scale"
    qs = []
    for w, (no, ni) in ((wq, (None, H)), (wk, (nkv * dh, H)),
                        (wv, (nkv * dh, H)), (wo, (H, None))):
        shp = tuple(w[0].shape) if isinstance(w, tuple) \
            else tuple(w.shape)[::-1]
        n_out = shp[0] if no is None else no
        n_in = shp[1] if ni is None else ni
        _, _, q = _unpack_weight(w, n_out, n_in)
        if q is None:
            return "unsupported weight layout (packed int4?)"
        qs.append(q)
    if len(set(qs)) != 1:
        return "mixed dense/quantized projection weights"
    nh = (wq[0].shape[0] if isinstance(wq, tuple) else wq.shape[1]) // dh
    if nh % nkv:
        return f"Hq {nh} not a multiple of Hkv {nkv}"
    if on_card is None:
        on_card = k_cache.device.type == "cuda"
    if on_card:
        return _card_reason(b, H, F, nh, nkv, dh, bs, qs[0], quant_kv,
                            h.dtype)
    return None


def megakernel_full_supported(h, w_in, w_post, wq, wk, wv, wo, wg, wu,
                              wd, k_cache, v_cache, tables, *,
                              k_scale=None, v_scale=None,
                              on_card: Optional[bool] = None
                              ) -> Optional[str]:
    """None when the full-layer rung (attention + MLP) can serve these
    per-layer operands, a reason otherwise (a reason here still permits
    the attn rung)."""
    H = h.shape[-1]
    F = wg[0].shape[0] if isinstance(wg, tuple) else wg.shape[1]
    reason = _attn_reason(h, wq, wk, wv, wo, k_cache, k_scale, v_scale,
                          on_card, F=F)
    if reason is not None:
        return reason
    qs = []
    for w, (no, ni) in ((wg, (F, H)), (wu, (F, H)), (wd, (H, F))):
        _, _, q = _unpack_weight(w, no, ni)
        if q is None:
            return "unsupported MLP weight layout (packed int4?)"
        qs.append(q)
    if len(set(qs)) != 1:
        return "mixed dense/quantized MLP weights"
    if qs[0] != isinstance(wq, tuple):
        return "attention and MLP weights disagree on quantization"
    return None


def _drop_lead(w):
    """Layer 0's view of a stacked weight (or pair)."""
    if isinstance(w, tuple):
        return (w[0][0], w[1][0])
    return w[0]


def megakernel_scan_supported(h, w_in, w_post, wq, wk, wv, wo, wg, wu,
                              wd, k_cache, v_cache, tables, *,
                              n_layers, k_scale=None, v_scale=None,
                              on_card: Optional[bool] = None
                              ) -> Optional[str]:
    """None when the layer-scanned rung can serve these STACKED operands
    (a leading layer axis on every weight, a layer-major page axis on
    the pools), a reason otherwise (a reason here still permits the full
    rung on per-layer operands)."""
    L = int(n_layers)
    if L < 1:
        return f"need at least one layer, got {n_layers}"
    stacked = (("input_layernorm", w_in),
               ("post_attention_layernorm", w_post),
               ("q_proj", wq), ("k_proj", wk), ("v_proj", wv),
               ("o_proj", wo), ("gate_proj", wg), ("up_proj", wu),
               ("down_proj", wd))
    for name, w in stacked:
        for a in (w if isinstance(w, tuple) else (w,)):
            if a.ndim < 2 or a.shape[0] != L:
                return (f"{name} is not stacked along a leading "
                        f"{L}-layer axis (shape {tuple(a.shape)})")
    if k_cache.ndim != 4:
        return f"paged pools required, got cache rank {k_cache.ndim}"
    if k_cache.shape[0] % L:
        return (f"pool page axis {k_cache.shape[0]} not divisible by "
                f"{L} layers")
    pool_view = k_cache[: k_cache.shape[0] // L]
    sc_view = None
    if k_scale is not None:
        if k_scale.shape[0] % L:
            return "pool scale page axis not divisible by layer count"
        sc_view = k_scale[: k_scale.shape[0] // L]
    if on_card is None:
        on_card = k_cache.device.type == "cuda"
    return megakernel_full_supported(
        h, *(_drop_lead(w) for _, w in stacked), pool_view, pool_view,
        tables, k_scale=sc_view, v_scale=sc_view, on_card=on_card)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _proj(x, w):
    """x [b, K] (compute dtype) against a decode weight, summed in f32:
    x32 @ w32 (dense [K, N]), or x32 @ q32^T * scale (an int8 pair, the
    scale after the whole sum). Returns f32 [b, N]."""
    if isinstance(w, tuple):
        wq, sc = w
        return (x.float() @ wq.float().t()) * sc.float()
    return x.float() @ w.float()


def _rotate(x, cos, sin):
    """The neox rotate-half in x's dtype: x [b, n, D], cos/sin [b, D/2]
    already in x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attend_current(q, k_cur, v_cur, pool_k, pool_v, tables, lens, scale,
                    k_scale, v_scale):
    """Attention of q [b, Hq, D] (f32) over each row's pool positions
    strictly below lens plus the current token (k_cur / v_cur [b, Hkv,
    D], f32). int8 pages dequantize in f32 (score * k scale, v * v
    scale). One f32 softmax over both. Returns f32 [b, Hq, D]."""
    b, hq, d = q.shape
    n_pages, hkv, bs, _ = pool_k.shape
    w = tables.shape[1]
    g = hq // hkv
    tbl = tables.to(torch.int64).clamp(0, n_pages - 1)
    k = pool_k[tbl].float()                           # [b, W, Hkv, bs, D]
    v = pool_v[tbl].float()
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bwhtd->bhgwt", qg, k) * scale
    if k_scale is not None:
        s = s * k_scale.float()[tbl].permute(0, 2, 1)[:, :, None, :, None]
        v = v * v_scale.float()[tbl][..., None, None]
    s = s.reshape(b, hkv, g, w * bs)
    pos = torch.arange(w * bs, device=q.device)
    valid = pos[None, :] < lens.to(torch.int64)[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    s_cur = torch.einsum("bhgd,bhd->bhg", qg, k_cur)[..., None] * scale
    s = torch.cat([s, s_cur], dim=-1)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    vs = v.permute(0, 2, 1, 3, 4).reshape(b, hkv, w * bs, d)
    vs = torch.cat([vs, v_cur[:, :, None, :]], dim=2)
    out = torch.einsum("bhgt,bhtd->bhgd", p, vs) / p.sum(-1, keepdim=True)
    return out.reshape(b, hq, d)


def split_attend_current_reference(q, k_cur, v_cur, pool_k, pool_v, tables,
                                   lens, scale, k_scale, v_scale, *,
                                   tile_rows: int, pieces):
    """The plain twin of the CUDA kernel's phase 2 split-and-merge (the
    wrappers never call it; the CPU tests hold it against
    `_attend_current` and, in the plain layer, against JAX's kernel; the
    card tests hold the kernel against the plain layer).
    `pieces[(row, head)]`: the tile boundaries (tiles of `tile_rows`
    positions, a page or a piece of one) the row's positions strictly
    below lens are cut at
    (`megakernel_attention_pieces`). Per piece the f32 (m, l, acc) of its
    positions (int8 pages: the k scale multiplies the score after the
    softmax scale, the v scale the page's values); the pieces merged in
    order (M = max m, L = sum exp(m - M) l, acc = sum exp(m - M) acc);
    then the current token joins: s = q k_cur scale, M' = max(M, s), out
    = (acc exp(M - M') + exp(s - M') v_cur) / (L exp(M - M') + exp(s -
    M')). A row with no position has one empty piece. Same operands and
    result as `_attend_current`: f32 [b, Hq, D]."""
    b, hq, d = q.shape
    n_pages, hkv, bs, _ = pool_k.shape
    w = tables.shape[1]
    g = hq // hkv
    tbl = tables.to(torch.int64).clamp(0, n_pages - 1)
    k, v = (p[tbl].float().permute(0, 2, 1, 3, 4).reshape(b, hkv, w * bs, d)
            for p in (pool_k, pool_v))
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) * scale
    if k_scale is not None:
        ks, vs = (sc.float()[tbl].permute(0, 2, 1).repeat_interleave(
            bs, dim=2) for sc in (k_scale, v_scale))
        s = s * ks[:, :, None, :]
        v = v * vs[..., None]
    pos = torch.arange(w * bs, device=q.device)
    out = torch.empty(b, hkv, g, d, dtype=torch.float32, device=q.device)
    for row in range(b):
        for h in range(hkv):
            cut = pieces[(row, h)]
            parts = []
            for j0, j1 in zip(cut[:-1], cut[1:]):
                lo, hi = j0 * tile_rows, j1 * tile_rows
                sv = s[row, h, :, lo:hi]
                ok = pos[lo:hi] < int(lens[row])
                sv = torch.where(ok, sv, torch.full_like(sv, _NEG_INF))
                m = sv.amax(-1) if hi > lo else torch.full(
                    (g,), _NEG_INF, device=q.device)
                p = torch.where(ok, torch.exp(sv - m[:, None]),
                                torch.zeros_like(sv))
                parts.append((m, p.sum(-1), p @ v[row, h, lo:hi]))
            big = torch.stack([m for m, _, _ in parts]).amax(0)
            el = torch.zeros_like(big)
            acc = torch.zeros(g, d, device=q.device)
            for m, l, a in parts:                 # piece order
                wgt = torch.exp(m - big)
                el = el + wgt * l
                acc = acc + wgt[:, None] * a
            s_cur = (qg[row, h] * k_cur[row, h].float()).sum(-1) * scale
            top = torch.maximum(big, s_cur)
            corr, p_cur = torch.exp(big - top), torch.exp(s_cur - top)
            out[row, h] = (acc * corr[:, None] + p_cur[:, None]
                           * v_cur[row, h].float()) \
                / (el * corr + p_cur)[:, None]
    return out.reshape(b, hq, d)


def _commit(kct, vct, k_cur, v_cur, tables, lens, bs):
    """The current token's K/V into its page, in place: the bf16 slot
    write, or the q8 helpers' read-modify-write (models/llama.py)."""
    from ..models.llama import make_paged_kv_helpers, make_paged_kv_q8_helpers

    b, nkv, dh = k_cur.shape
    helpers = make_paged_kv_q8_helpers if isinstance(kct, tuple) \
        else make_paged_kv_helpers
    _, write = helpers(b, 0, nkv, dh, bs, tables)
    write(kct, vct, k_cur[:, None], v_cur[:, None], lens)


def _layer_reference(h, lens, tables, cos, sin, w_in, wq, wk, wv, wo,
                     kct, vct, *, eps, scale, mlp=None):
    """One layer of the megakernel in plain PyTorch. h [b, H] in the
    compute dtype; tables already offset to this layer's pages; kct/vct
    pools or (int8 pool, scale) pairs, committed in place; `mlp` =
    (w_post, wg, wu, wd) for the full rung. Returns h_out [b, H]."""
    cdt = h.dtype
    b = h.shape[0]
    kc = kct[0] if isinstance(kct, tuple) else kct
    nkv, bs, dh = kc.shape[1], kc.shape[2], kc.shape[3]
    x = rms_norm_reference(h, w_in, eps)
    q = _proj(x, wq).to(cdt).reshape(b, -1, dh)
    k = _proj(x, wk).to(cdt).reshape(b, nkv, dh)
    v = _proj(x, wv).to(cdt).reshape(b, nkv, dh)
    c, s = cos.to(cdt), sin.to(cdt)
    q, k = _rotate(q, c, s), _rotate(k, c, s)
    ksc = vsc = None
    if isinstance(kct, tuple):
        (kc, ksc), (vc, vsc) = kct, vct
    else:
        vc = vct
    ctx = _attend_current(q.float(), k.float(), v.float(), kc, vc, tables,
                          lens, scale, ksc, vsc)
    _commit(kct, vct, k, v, tables, lens, bs)      # attend before commit
    proj = _proj(ctx.to(cdt).reshape(b, -1), wo)
    h = (h.float() + proj).to(cdt)
    if mlp is None:
        return h
    w_post, wg, wu, wd = mlp
    x2 = rms_norm_reference(h, w_post, eps)
    y = F.silu(_proj(x2, wg).to(cdt)) * _proj(x2, wu).to(cdt)
    return (h.float() + _proj(y, wd)).to(cdt)


def _rope_tables(lens, dh, rope_base):
    """f32 cos/sin [b, D/2] at the current positions: rope_freqs's ops,
    with its inverse frequencies kept per (D, base, device)."""
    inv = _inv_freqs(dh, float(rope_base), lens.device)
    freqs = lens.to(torch.float32)[..., None] * inv
    return torch.cos(freqs), torch.sin(freqs)


@functools.lru_cache(maxsize=16)
def _inv_freqs(dh, rope_base, device):
    return 1.0 / (rope_base ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                             device=device) / dh))


def _pools(k_cache, v_cache, k_scale, v_scale):
    if k_cache.dtype == torch.int8:
        return (k_cache, k_scale), (v_cache, v_scale)
    return k_cache, v_cache


def _returns(h_out, b, H, k_cache, v_cache, k_scale, v_scale):
    h_out = h_out.reshape(b, 1, H)
    if k_cache.dtype == torch.int8:
        return h_out, (k_cache, k_scale), (v_cache, v_scale)
    return h_out, k_cache, v_cache


def decode_layer_megakernel_reference(h, lens, tables, w_in, wq, wk, wv, wo,
                                      k_cache, v_cache, *,
                                      rope_base: float = 10000.0,
                                      eps: float = 1e-6,
                                      scale: Optional[float] = None,
                                      k_scale=None, v_scale=None):
    """Plain version of `decode_layer_megakernel` (pools in place)."""
    b, _, H = h.shape
    dh = k_cache.shape[3]
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    cos, sin = _rope_tables(lens, dh, rope_base)
    kct, vct = _pools(k_cache, v_cache, k_scale, v_scale)
    out = _layer_reference(h.reshape(b, H), lens, tables, cos, sin, w_in,
                           wq, wk, wv, wo, kct, vct, eps=eps, scale=scale)
    return _returns(out, b, H, k_cache, v_cache, k_scale, v_scale)


def _layer_of(w, i):
    if isinstance(w, tuple):
        return (w[0][i], w[1][i])
    return w[i]


def decode_layers_megakernel_reference(h, lens, tables, w_in, w_post, wq,
                                       wk, wv, wo, wg, wu, wd, k_cache,
                                       v_cache, *, n_layers: int,
                                       rope_base: float = 10000.0,
                                       eps: float = 1e-6,
                                       scale: Optional[float] = None,
                                       k_scale=None, v_scale=None):
    """Plain version of `decode_layers_megakernel`: the one-layer full
    body over each layer's weight slice, with the table offset to the
    layer's pages of the layer-major pool (pools in place)."""
    L = int(n_layers)
    b, _, H = h.shape
    dh = k_cache.shape[3]
    stride = k_cache.shape[0] // L
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    cos, sin = _rope_tables(lens, dh, rope_base)
    kct, vct = _pools(k_cache, v_cache, k_scale, v_scale)
    x = h.reshape(b, H)
    for i in range(L):
        ws = [_layer_of(w, i) for w in (w_in, wq, wk, wv, wo)]
        mlp = tuple(_layer_of(w, i) for w in (w_post, wg, wu, wd))
        x = _layer_reference(x, lens, tables + i * stride, cos, sin, *ws,
                             kct, vct, eps=eps, scale=scale, mlp=mlp)
    return _returns(x, b, H, k_cache, v_cache, k_scale, v_scale)


def decode_layer_megakernel_full_reference(h, lens, tables, w_in, w_post,
                                           wq, wk, wv, wo, wg, wu, wd,
                                           k_cache, v_cache, **kw):
    """Plain version of `decode_layer_megakernel_full`."""
    return decode_layers_megakernel_reference(
        h, lens, tables, *(_stack_one(w) for w in (
            w_in, w_post, wq, wk, wv, wo, wg, wu, wd)),
        k_cache, v_cache, n_layers=1, **kw)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _stack_one(w):
    """A one-layer stacked view (no copy) of a weight or pair."""
    if isinstance(w, tuple):
        return (w[0].unsqueeze(0), w[1].unsqueeze(0))
    return w.unsqueeze(0)


def _tp_seam(residual, quantize_out):
    if not residual or quantize_out:
        what = "residual=False" if not residual else "quantize_out=True"
        raise NotImplementedError(f"{what} {_TP_ONLY}")


def decode_layer_megakernel(h, lens, tables, w_in, wq, wk, wv, wo,
                            k_cache, v_cache, *, rope_base: float = 10000.0,
                            eps: float = 1e-6, scale: Optional[float] = None,
                            k_scale=None, v_scale=None,
                            residual: bool = True,
                            quantize_out: bool = False):
    """One decoder layer's attention block, fused (rung ``attn``)."""
    _tp_seam(residual, quantize_out)
    reason = megakernel_supported(h, w_in, wq, wk, wv, wo, k_cache,
                                  v_cache, tables, k_scale=k_scale,
                                  v_scale=v_scale)
    if reason is not None:
        raise ValueError(f"decode megakernel unsupported here: {reason}")
    return _megakernel("decode_layer_megakernel", h, lens, tables,
                       [_stack_one(w) for w in (w_in, wq, wk, wv, wo)],
                       k_cache, v_cache, 1, False, rope_base, eps, scale,
                       k_scale, v_scale)


def decode_layers_megakernel(h, lens, tables, w_in, w_post, wq, wk, wv,
                             wo, wg, wu, wd, k_cache, v_cache, *,
                             n_layers: int, rope_base: float = 10000.0,
                             eps: float = 1e-6, scale: Optional[float] = None,
                             k_scale=None, v_scale=None):
    """Every decoder layer's attention block and MLP half in one launch
    (rung ``scan``) over stacked weights and a layer-major pool."""
    return _layers_megakernel(
        "decode_layers_megakernel", h, lens, tables, w_in, w_post, wq, wk,
        wv, wo, wg, wu, wd, k_cache, v_cache, n_layers=n_layers,
        rope_base=rope_base, eps=eps, scale=scale, k_scale=k_scale,
        v_scale=v_scale)


def _layers_megakernel(what, h, lens, tables, w_in, w_post, wq, wk, wv,
                       wo, wg, wu, wd, k_cache, v_cache, *, n_layers,
                       rope_base, eps, scale, k_scale, v_scale):
    reason = megakernel_scan_supported(
        h, w_in, w_post, wq, wk, wv, wo, wg, wu, wd, k_cache, v_cache,
        tables, n_layers=n_layers, k_scale=k_scale, v_scale=v_scale)
    if reason is not None:
        raise ValueError(f"decode scan megakernel unsupported here: "
                         f"{reason}")
    weights = [w_in, wq, wk, wv, wo, w_post, wg, wu, wd]
    return _megakernel(what, h, lens, tables, weights, k_cache, v_cache,
                       int(n_layers), True, rope_base, eps, scale, k_scale,
                       v_scale)


def _megakernel(what, h, lens, tables, weights, k_cache, v_cache, L, mlp,
                rope_base, eps, scale, k_scale, v_scale):
    """The operator's call: `weights` stacked [L, ...] (w_in, wq, wk, wv,
    wo, then w_post, wg, wu, wd with the MLP), a weight-only pair split
    into the weight list and the scale list. Returns (h_out, pools)."""
    b, _, H = h.shape
    if scale is None:
        scale = 1.0 / math.sqrt(k_cache.shape[3])
    ws = [w[0] if isinstance(w, tuple) else w for w in weights]
    ss = [w[1] if isinstance(w, tuple) else None for w in weights]
    h_out = _megakernel_op(what, h, lens, tables, ws, ss, k_cache, v_cache,
                           k_scale, v_scale, int(L), bool(mlp),
                           float(rope_base), float(eps), float(scale))
    return _returns(h_out, b, H, k_cache, v_cache, k_scale, v_scale)


def _weights_of(ws, ss):
    return [w if s is None else (w, s) for w, s in zip(ws, ss)]


def _megakernel_cuda(what, h, lens, tables, ws, ss, k_cache, v_cache,
                     k_scale, v_scale, L, mlp, rope_base, eps, scale):
    return _launch(what, h, lens, tables, _weights_of(ws, ss), k_cache,
                   v_cache, L, mlp=mlp, rope_base=rope_base, eps=eps,
                   scale=scale, k_scale=k_scale, v_scale=v_scale)[0]


def _megakernel_cpu(what, h, lens, tables, ws, ss, k_cache, v_cache,
                    k_scale, v_scale, L, mlp, rope_base, eps, scale):
    kw = dict(rope_base=rope_base, eps=eps, scale=scale, k_scale=k_scale,
              v_scale=v_scale)
    w = _weights_of(ws, ss)
    if not mlp:
        return decode_layer_megakernel_reference(
            h, lens, tables, *(_layer_of(x, 0) for x in w), k_cache,
            v_cache, **kw)[0]
    w_in, wq, wk, wv, wo, w_post, wg, wu, wd = w
    return decode_layers_megakernel_reference(
        h, lens, tables, w_in, w_post, wq, wk, wv, wo, wg, wu, wd, k_cache,
        v_cache, n_layers=L, **kw)[0]


# one operator for the three rungs (`what` names the launch counter);
# it writes the current token's K/V into the pools in place
_megakernel_op = _build.kernel_op(
    "decode_megakernel",
    "(str what, Tensor h, Tensor lens, Tensor tables, Tensor[] weights, "
    "Tensor?[] weight_scales, Tensor(a!) k_cache, Tensor(b!) v_cache, "
    "Tensor(c!)? k_scale, Tensor(d!)? v_scale, int n_layers, bool mlp, "
    "float rope_base, float eps, float scale) -> Tensor",
    cuda=_megakernel_cuda, cpu=_megakernel_cpu,
    fake=lambda what, h, *a: torch.empty_like(h))


def decode_layer_megakernel_full(h, lens, tables, w_in, w_post, wq, wk,
                                 wv, wo, wg, wu, wd, k_cache, v_cache,
                                 *, rope_base: float = 10000.0,
                                 eps: float = 1e-6,
                                 scale: Optional[float] = None,
                                 k_scale=None, v_scale=None):
    """One decoder layer's attention block AND MLP half in one launch
    (rung ``full``): `decode_layers_megakernel` at one layer over
    one-layer views of the weights; the pools keep their per-layer
    layout."""
    return _layers_megakernel(
        "decode_layer_megakernel_full", h, lens, tables,
        *(_stack_one(w) for w in (w_in, w_post, wq, wk, wv, wo, wg, wu,
                                  wd)),
        k_cache, v_cache, n_layers=1, rope_base=rope_base, eps=eps,
        scale=scale, k_scale=k_scale, v_scale=v_scale)


# (device, launch ints) -> the launch's geometry (one query per shape and
# device)
_GEOMETRY = {}


def card_geometry(dev, *, L, b, H, F, nh, nkv, dh, bs, W, pages, mlp,
                  quant_w, quant_kv, dtype):
    """The card's plan of a launch at these shapes (pages: the pool's
    pages per layer): {"grid": resident blocks, "smem": dynamic shared
    memory bytes, "partial_floats" / "counters": the scratch of the GEMV
    phases' K splits and phase 2's pieces}. Builds the kernel's library."""
    from .decode_attention import decode_tile_rows

    ints = (L, b, H, F, nh, nkv, dh, bs, W, pages, int(mlp), int(quant_w),
            int(quant_kv), _build.dtype_code(dtype), decode_tile_rows(bs))
    dev = torch.device(dev)
    key = (dev.index, ints)
    got = _GEOMETRY.get(key)
    if got is None:
        lib = _build.library("decode_megakernel")
        arr = (ctypes.c_int * len(ints))(*ints)
        out = (ctypes.c_int64 * 4)()
        with torch.cuda.device(dev):
            code = lib.decode_megakernel_resident(
                ctypes.cast(arr, ctypes.c_void_p),
                ctypes.cast(out, ctypes.c_void_p))
        _build.check(lib, code, "decode_megakernel_resident")
        grid, smem, part, cnt = (int(x) for x in out)
        got = _GEOMETRY[key] = {"ints": ints, "grid": grid, "smem": smem,
                                "partial_floats": part, "counters": cnt}
    return got


def _launch(what, h, lens, tables, weights, k_cache, v_cache, L, *, mlp,
            rope_base, eps, scale, k_scale, v_scale):
    """Check the operands and launch csrc/decode_megakernel.cu. `weights`
    are stacked [L, ...]: w_in, wq, wk, wv, wo (+ w_post, wg, wu, wd)."""
    quant_kv = _build.int8_pools(k_cache, k_scale, v_scale)
    b, _, H = h.shape
    n_pool, nkv, bs, dh = k_cache.shape
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    w_in, wq, wk, wv, wo = weights[:5]
    w_post, wg, wu, wd = weights[5:] if mlp else (None,) * 4
    quant_w = isinstance(wq, tuple)
    pairs = [w for w in (wq, wk, wv, wo, wg, wu, wd) if w is not None]
    arrays = [a for w in pairs for a in (w if quant_w else (w,))]
    norms = [w for w in (w_in, w_post) if w is not None]
    scales = (k_scale, v_scale) if quant_kv else ()
    dev = _build.require_cuda(what, h, lens, tables, k_cache, v_cache,
                              *arrays, *norms, *scales)
    _build.require_contiguous(what, lens=lens, tables=tables,
                              k_cache=k_cache, v_cache=v_cache)
    for i, a in enumerate(arrays + norms + [k_cache, v_cache]):
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{what}: weight and pool operand {i} must be "
                             "contiguous and 16-byte aligned")
    if quant_kv:
        _build.require_q8_operands(what, k_cache, v_cache, k_scale, v_scale)
    elif not (h.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"{what}: h and pools must share a dtype, got "
                         f"{h.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if quant_w:
        if any(a.dtype != torch.int8 for w in pairs for a in w[:1]) or any(
                w[1].dtype != torch.float32 for w in pairs):
            raise ValueError(f"{what}: weight-only pairs must be int8 "
                             "weights with float32 scales")
    elif any(a.dtype != h.dtype for a in arrays):
        raise ValueError(f"{what}: dense weights must be {h.dtype}")
    if any(n.dtype != h.dtype for n in norms):
        raise ValueError(f"{what}: norm weights must be {h.dtype}")
    if lens.dtype != torch.int32 or tables.dtype != torch.int32 \
            or lens.shape != (b,) or tables.ndim != 2 \
            or tables.shape[0] != b:
        raise ValueError(f"{what}: lens [{b}] and tables [{b}, W] must be "
                         "int32")
    nh = (wq[0].shape[1] if quant_w else wq.shape[2]) // dh
    F_ = 0
    if mlp:
        F_ = wg[0].shape[1] if quant_w else wg.shape[2]
    reason = _card_reason(b, H, F_ or None, nh, nkv, dh, bs, quant_w,
                          quant_kv, h.dtype)
    if reason is not None:
        raise ValueError(f"{what}: {reason}")
    cdt = h.dtype
    hc = h.reshape(b, H).contiguous()
    if hc.data_ptr() % 16:
        hc = hc.clone()
    out = torch.empty_like(hc)
    cos, sin = (t.contiguous() for t in _rope_tables(lens, dh, rope_base))
    lib = _build.library("decode_megakernel")
    geo = card_geometry(dev, L=L, b=b, H=H, F=F_, nh=nh, nkv=nkv, dh=dh,
                        bs=bs, W=tables.shape[1], pages=n_pool // L,
                        mlp=mlp, quant_w=quant_w, quant_kv=quant_kv,
                        dtype=cdt)
    # one workspace for q, k, v, ctx and y (each a multiple of 16 bytes),
    # the split partials, and the zeroed counters (barrier first)
    widths = (nh * dh, nkv * dh, nkv * dh, nh * dh, max(F_, 1))
    ws = torch.empty(b * sum(widths), dtype=cdt, device=dev)
    offs = [0]
    for wdt in widths:
        offs.append(offs[-1] + b * wdt)
    part = torch.empty(max(geo["partial_floats"], 1), dtype=torch.float32,
                       device=dev)
    counters = torch.zeros(2 + geo["counters"], dtype=torch.int32,
                           device=dev)

    def ptr(w, j=0):
        if w is None:
            return 0
        return (w[j] if isinstance(w, tuple) else w).data_ptr()

    def sptr(w):
        return w[1].data_ptr() if isinstance(w, tuple) else 0

    mats = (wq, wk, wv, wo, wg, wu, wd)
    base, it = ws.data_ptr(), ws.element_size()
    ptrs = [hc.data_ptr(), out.data_ptr(), lens.data_ptr(),
            tables.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            ptr(w_in), ptr(w_post)] + [ptr(w) for w in mats] \
        + [sptr(w) for w in mats] \
        + [k_cache.data_ptr(), v_cache.data_ptr(),
           k_scale.data_ptr() if quant_kv else 0,
           v_scale.data_ptr() if quant_kv else 0] \
        + [base + o * it for o in offs[:5]] \
        + [part.data_ptr(), counters.data_ptr()]
    ints = [*geo["ints"], part.numel(), geo["counters"]]
    parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    iarr = (ctypes.c_int * len(ints))(*ints)
    code = lib.decode_megakernel_launch(
        ctypes.cast(parr, ctypes.c_void_p), ctypes.cast(iarr, ctypes.c_void_p),
        float(scale), float(eps), _build.stream_ptr(dev))
    if quant_kv:
        what += _build.INT8_SUFFIX
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return _returns(out, b, H, k_cache, v_cache, k_scale, v_scale)


# ---------------------------------------------------------------------------
# the roofline (decode_megakernel.py `_megakernel_fused_roofline`)
# ---------------------------------------------------------------------------

def megakernel_roofline(*, b, H, F, nh, nkv, dh, bs, n_layers,
                        weight_bytes, positions, kv_itemsize, row_itemsize,
                        mlp=True):
    """Least work of one launch: {"flops", "hbm_bytes"}. Weights count
    once per layer; the pools count the positions this run's lens stream
    (`positions` = sum of lens over rows, per layer) plus the scales of
    the pages they name on int8 pools; the commit writes one page per
    (layer, row, kv head); h is read once and written once."""
    L = int(n_layers)
    kv_bytes = 2 * L * positions * nkv * dh * kv_itemsize
    if kv_itemsize == 1:
        kv_bytes += 2 * L * nkv * 4 * -(-positions // bs)
    row_bytes = 2 * b * H * row_itemsize
    commit_bytes = 2 * L * b * nkv * bs * dh * kv_itemsize
    proj_flops = 2 * b * L * H * (2 * nh * dh + 2 * nkv * dh
                                  + (3 * F if mlp else 0))
    attn_flops = 4 * L * nh * dh * (positions + b)
    return {"flops": int(proj_flops + attn_flops),
            "hbm_bytes": int(weight_bytes + kv_bytes + row_bytes
                             + commit_bytes)}
