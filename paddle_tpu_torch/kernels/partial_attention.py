"""Partial-emitting paged attention for context-parallel serving
(counterpart of paddle_tpu/kernels/partial_attention.py, which is plain
jnp: this is plain PyTorch, op for op).

Under ``serving_cp`` the pools shard along the PAGE axis: one rank never
sees a request's whole context, so each rank streams its own pages and
emits the online-softmax state (running max m, normalizer l, weighted
accumulator acc) un-normalized; ``ServingTP.merge_attn_partials`` merges
the ranks' states with the recurrence the paged kernels run between
tiles. The fresh-token window is computed on every rank alike (new K/V
come from replicated activations) and combined once, after the merge.

All partials are f32. Masked and empty rows carry the finite sentinel
``_NEG_INF`` (-1e30), never -inf, so ``exp(m - M)`` stays 1 on an empty
shard instead of NaN, and `finalize_partials` zeros rows with l == 0.

A cp rank's pool holds its `pps` pages and one sink row after them
(row `pps`): writes to pages another rank owns are aimed at the sink
(`cp_write_rows`), the torch stand-in for JAX's out-of-range drop, so no
write needs a data-dependent shape.
"""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def cp_local_view(tables: torch.Tensor, pps: int, cp_index: int):
    """(local, owned) of a global-id block table on cp rank `cp_index`:
    global page g lives on rank g // pps at local row g % pps. `local`
    clamps pages other ranks own to row 0 (their scores are masked by
    `owned`); writes use `cp_write_rows` instead."""
    owned = torch.div(tables, pps, rounding_mode="floor") == cp_index
    return torch.where(owned, tables % pps, torch.zeros_like(tables)), owned


def cp_write_rows(pages: torch.Tensor, pps: int, cp_index: int):
    """Local rows for page writes on cp rank `cp_index`: owned pages at
    their local row, every other page at the sink row `pps`."""
    owned = torch.div(pages, pps, rounding_mode="floor") == cp_index
    return torch.where(owned, pages % pps, torch.full_like(pages, pps))


def paged_partials(q, key_cache, value_cache, tables, valid, *,
                   scale=None, k_scale=None, v_scale=None):
    """Online-softmax partials of q [b, tn, nh, dh] against this rank's
    pool pages. key_cache / value_cache [pps(+1), nkv, page, dh] (int8
    with `k_scale` / `v_scale` [pps(+1), nkv], dequantized in f32 at the
    gather); tables [b, w] local rows (`cp_local_view`); valid [b, w *
    page] bool: gathered positions that are both in length and owned.
    Returns (m [b, tn, nh], l [b, tn, nh], acc [b, tn, nh, dh]) f32;
    rows with no valid position: m = _NEG_INF, l = 0, acc = 0."""
    b, tn, nh, dh = q.shape
    nkv, page = key_cache.shape[1], key_cache.shape[2]
    P = tables.shape[1] * page
    group = nh // nkv
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    tbl = tables.to(torch.int64)
    gk = key_cache[tbl]                     # [b, w, nkv, page, dh]
    gv = value_cache[tbl]
    if key_cache.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 KV pools need k_scale/v_scale")
        gk = gk.to(torch.float32) * k_scale[tbl][..., None, None]
        gv = gv.to(torch.float32) * v_scale[tbl][..., None, None]
    pk = gk.permute(0, 1, 3, 2, 4).reshape(b, P, nkv, dh)
    pv = gv.permute(0, 1, 3, 2, 4).reshape(b, P, nkv, dh)
    q5 = q.reshape(b, tn, nkv, group, dh)
    s = torch.einsum("bsngd,btnd->bsngt", q5.to(torch.float32),
                     pk.to(torch.float32)) * scale
    mask = valid[:, None, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1)
    # exp under the mask, not of the sentinel-filled scores: on an
    # all-masked row exp(s - m) would be 1 per masked column
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bsngt,btnd->bsngd", p, pv.to(torch.float32))
    return (m.reshape(b, tn, nh), l.reshape(b, tn, nh),
            acc.reshape(b, tn, nh, dh))


def decode_paged_partials(q1, key_cache, value_cache, tables, lens, owned,
                          *, scale=None, k_scale=None, v_scale=None):
    """Decode twin of `paged_partials`: q1 [b, nh, dh], lens [b] with the
    decode kernels' inclusive visibility (positions <= lens are live: the
    current token was committed at lens). Returns (m [b, nh], l [b, nh],
    acc [b, nh, dh]) f32."""
    page = key_cache.shape[2]
    P = tables.shape[1] * page
    pos_ok = torch.arange(P, device=q1.device)[None, :] \
        <= lens.to(torch.int64)[:, None]
    valid = pos_ok & torch.repeat_interleave(owned, page, dim=1)
    m, l, acc = paged_partials(q1[:, None], key_cache, value_cache, tables,
                               valid, scale=scale, k_scale=k_scale,
                               v_scale=v_scale)
    return m[:, 0], l[:, 0], acc[:, 0]


def causal_window_partials(q, k_new, v_new, new_lens=None, *, scale=None):
    """Online-softmax partials of the fresh-token window against itself,
    causally: column j is visible to row i iff j <= i and (with
    `new_lens` [b]) j < new_lens. q / k_new / v_new [b, tn, nh / nkv,
    dh]. Returns (m, l, acc) f32 shaped like `paged_partials`."""
    b, tn, nh, dh = q.shape
    nkv = k_new.shape[2]
    group = nh // nkv
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    ar = torch.arange(tn, device=q.device)
    causal = ar[None, :] <= ar[:, None]
    if new_lens is None:
        mask = causal[None].expand(b, tn, tn)
    else:
        mask = causal[None] & (ar[None, None, :]
                               < new_lens.to(torch.int64)[:, None, None])
    q5 = q.reshape(b, tn, nkv, group, dh)
    s = torch.einsum("bsngd,btnd->bsngt", q5.to(torch.float32),
                     k_new.to(torch.float32)) * scale
    mk = mask[:, :, None, None, :]
    s = torch.where(mk, s, torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.where(mk, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bsngt,btnd->bsngd", p, v_new.to(torch.float32))
    return (m.reshape(b, tn, nh), l.reshape(b, tn, nh),
            acc.reshape(b, tn, nh, dh))


def combine_partials(a, b):
    """Merge two (m, l, acc) states over the same rows."""
    ma, la, acca = a
    mb, lb, accb = b
    m = torch.maximum(ma, mb)
    wa = torch.exp(ma - m)
    wb = torch.exp(mb - m)
    return (m, la * wa + lb * wb,
            acca * wa[..., None] + accb * wb[..., None])


def finalize_partials(m, l, acc, live=None):
    """acc / l, with the kernels' pad contract: rows with l == 0 emit
    exact zeros, and `live` (bool, broadcastable to l) zeros rows the
    caller knows are pad. f32 in, f32 out."""
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = acc / safe[..., None]
    dead = l <= 0 if live is None else (l <= 0) | ~live
    return torch.where(dead[..., None], torch.zeros_like(out), out)
