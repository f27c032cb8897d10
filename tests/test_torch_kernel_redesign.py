"""The plain versions of the redesigned kernels' algorithms against the
JAX package, on the CPU.

Split-and-merge decode: ``split_decode_reference`` is the plain twin of
the CUDA decode body (each row's positions cut into splits of
``tiles_per_split`` tiles, an f32 partial (m, l, acc) per split, the
partials merged in split order). The same numpy inputs go through it and
through the JAX ``gqa_decode_attention``, ``decode_attention`` and
``paged_decode_attention`` (Pallas in interpret mode, as the JAX package's
tests run them), contiguous and paged, f32 / bf16 / int8 pools, at
split sizes of 1, 2 and 3 tiles and the card's own plan, with lens at 0,
on split edges (the last position of a split and the first of the next)
and at max_seq - 1 (paged: past the table too). f32: the same math in
another summation order, atol 1e-5. bf16: both round once from f32, so
they may differ by one bf16 step (2^-7 relative, floored at 1).

The delta pre-pass of the flash backward's dkv kernel:
``flash_attention_bwd_delta_reference`` against ``jnp.sum(do * o, -1)``
in f32 (the expression both JAX backward kernels evaluate per tile),
atol 1e-6 per unit of the row's sum of |do * o| (the two sum the same
products in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.decode_attention import (
    CONTIG_TILE, MAX_TILE_ROWS, decode_split_plan, decode_tile_rows,
    split_decode_reference)
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd_delta, flash_attention_bwd_delta_reference)
from paddle_tpu_torch.models.llama import quantize_kv_pages

# tiles per split: 1, 2, 3 tiles, and the card's plan (None)
SPLITS = [1, 2, 3, None]
HEADS = [(4, 4, 16), (4, 4, 128), (8, 2, 16), (4, 1, 16)]
HEAD_IDS = ["group1", "group1-equal-heads-kernel", "group4", "mqa"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    got = got.to(torch.float32).numpy()
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (np.abs(got - want)
                <= 2.0 ** -7 * np.maximum(np.abs(want), 1.0)).all(), \
            float(np.abs(got - want).max())


def _edges(tps, st, last):
    """lens on the edges of splits of `tps` tiles of `st` positions."""
    return [0, tps * st - 1, tps * st, 2 * tps * st - 1, last]


@pytest.mark.parametrize("tps", SPLITS)
@pytest.mark.parametrize("hq,hkv,dh", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_split_decode_contiguous_matches_jax(dtype, hq, hkv, dh, tps):
    """max_seq 200 = 3 tiles and a ragged last one of 8 positions."""
    max_seq = 200
    lens_l = sorted({min(n, max_seq - 1) for n in _edges(
        tps or 1, CONTIG_TILE, max_seq - 1)} | {max_seq - 2})
    b = len(lens_l)
    rng = np.random.default_rng(hq + hkv + dh + (tps or 0))
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, hkv, max_seq, dh)).astype(np.float32)
              for _ in range(2))
    lens = np.asarray(lens_l, np.int32)
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    jfn = jda.decode_attention if hq == hkv else jda.gqa_decode_attention
    want = _np(jfn(*(jnp.asarray(a, jdt) for a in (q, kc, vc)),
                   jnp.asarray(lens)))
    got = split_decode_reference(
        *(torch.from_numpy(a).to(tdt) for a in (q, kc, vc)),
        torch.from_numpy(lens), tiles_per_split=tps)
    assert got.shape == (b, hq, dh) and got.dtype == tdt
    _close(got, want, dtype)


def _paged_inputs(rng, hq, hkv, dh, bs, w, lens_l):
    b = len(lens_l)
    n_pages = b * w + 2
    q = rng.standard_normal((b, hq, dh)).astype(np.float32)
    pools = [rng.standard_normal((n_pages, hkv, bs, dh)).astype(np.float32)
             for _ in range(2)]
    perm = rng.permutation(np.arange(1, n_pages))
    tables = perm[: b * w].reshape(b, w).astype(np.int32)
    return q, pools, tables, np.asarray(lens_l, np.int32)


@pytest.mark.parametrize("tps", SPLITS)
@pytest.mark.parametrize("hq,hkv,dh", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("pools", ["float32", "bfloat16", "int8"])
def test_split_decode_paged_matches_jax(pools, hq, hkv, dh, tps):
    """16-position pages, 8 table columns (8 tiles); lens on split edges,
    at the last position and past the table."""
    bs, w = 16, 8
    lens_l = sorted(set(_edges(tps or 1, bs, w * bs - 1)) | {w * bs + 3})
    rng = np.random.default_rng(hq * 7 + hkv + dh + (tps or 0))
    q, (kc, vc), tables, lens = _paged_inputs(rng, hq, hkv, dh, bs, w,
                                              lens_l)
    tq = torch.from_numpy(q)
    kw, jkw = {}, {}
    if pools == "int8":
        (k8, ksc), (v8, vsc) = (quantize_kv_pages(torch.from_numpy(p))
                                for p in (kc, vc))
        tk, tv = k8, v8
        kw = dict(k_scale=ksc, v_scale=vsc)
        jkw = dict(k_scale=jnp.asarray(ksc.numpy()),
                   v_scale=jnp.asarray(vsc.numpy()))
        jargs = [jnp.asarray(q), jnp.asarray(k8.numpy()),
                 jnp.asarray(v8.numpy())]
    else:
        tdt = getattr(torch, pools)
        tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, kc, vc))
        jargs = [jnp.asarray(a, getattr(jnp, pools)) for a in (q, kc, vc)]
    want = _np(jda.paged_decode_attention(
        *jargs, jnp.asarray(tables), jnp.asarray(lens), **jkw))
    got = split_decode_reference(tq, tk, tv, torch.from_numpy(lens),
                                 block_tables=torch.from_numpy(tables),
                                 tiles_per_split=tps, **kw)
    assert got.shape == q.shape and got.dtype == tq.dtype
    _close(got, want, np.float32 if pools != "bfloat16" else "bfloat16")


def test_split_decode_paged_clamps_page_ids_and_pieces_large_pages():
    """Pages of 128 rows walk in 64-row tiles; an out-of-range page id is
    clamped into the pool, as the JAX wrapper's page map clamps it."""
    bs, w = 128, 3
    rng = np.random.default_rng(3)
    q, (kc, vc), tables, lens = _paged_inputs(rng, 8, 2, 16, bs, w,
                                              [0, 63, 64, 200, 383])
    tables[2, 1] = 10 ** 6
    assert decode_tile_rows(bs) == MAX_TILE_ROWS
    want = _np(jda.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, tables, lens))))
    for tps in (1, 2, None):
        got = split_decode_reference(
            *(torch.from_numpy(a) for a in (q, kc, vc)),
            torch.from_numpy(lens), block_tables=torch.from_numpy(tables),
            tiles_per_split=tps)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_tiles,b,hkv", [
    (16, 8, 8), (128, 8, 8), (128, 1, 8), (9, 8, 8), (16, 8, 32),
    (1, 4, 8), (3, 1, 1), (17, 64, 8), (200, 2, 2)])
def test_decode_split_plan_covers_every_tile(n_tiles, b, hkv):
    """Every tile in exactly one split, splits of tps tiles but the last,
    at most one split per tile (more splits than tiles are never asked
    for), and at least two waves of 132 SMs when the tiles allow."""
    tps, splits = decode_split_plan(n_tiles, b, hkv)
    assert tps >= 1 and 1 <= splits <= n_tiles
    assert (splits - 1) * tps < n_tiles <= splits * tps
    if n_tiles >= -(-2 * 132 // (b * hkv)):
        assert splits * b * hkv >= 2 * 132
    else:
        assert tps == 1 and splits == n_tiles


def test_split_decode_more_splits_than_tiles_is_one_split_a_tile():
    """A plan wanting more splits than the row has tiles takes one split
    per tile; the twin at tiles_per_split=1 is that plan."""
    max_seq = 96
    tps, splits = decode_split_plan(-(-max_seq // CONTIG_TILE), 1, 1)
    assert (tps, splits) == (1, 2)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 2, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 1, max_seq, 16)).astype(np.float32)
              for _ in range(2))
    lens = np.asarray([0, 64, 95], np.int32)
    want = _np(jda.gqa_decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, lens))))
    got = split_decode_reference(*(torch.from_numpy(a)
                                   for a in (q, kc, vc, lens)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,s,h,d", [(2, 37, 4, 128), (1, 64, 2, 64)])
def test_delta_prepass_matches_jax(dtype, b, s, h, d):
    """delta = rowsum(dO * O) in f32 from the rounded output, in lse's
    [B*Hq, Sq] layout; JAX's is jnp.sum(do * o, -1) over [BH, S, D]."""
    rng = np.random.default_rng(b * s + h + d)
    o, do = (rng.standard_normal((b, s, h, d)).astype(np.float32)
             for _ in range(2))
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    jo, jdo = (jnp.asarray(a, jdt).astype(jnp.float32)
               .transpose(0, 2, 1, 3).reshape(b * h, s, d) for a in (o, do))
    want = np.asarray(jnp.sum(jdo * jo, axis=-1))
    to, tdo = (torch.from_numpy(a).to(tdt) for a in (o, do))
    _build.reset_launch_counts()
    got = flash_attention_bwd_delta_reference(to, tdo)
    assert got.dtype == torch.float32 and got.shape == (b * h, s)
    # atol 1e-6 per unit of the row's sum of |do * o|: two f32 sums of
    # the same D products in other orders differ by a few ulps of that sum
    # (5.7e-6 at D 128 on rows of N(0, 1), whose terms sum to about 100)
    mag = np.asarray(jnp.sum(jnp.abs(jdo * jo), axis=-1))
    assert (np.abs(got.numpy() - want) <= 1e-6 * np.maximum(mag, 1.0)).all()
    # the wrapper runs the plain twin for CPU tensors and launches nothing
    assert torch.equal(flash_attention_bwd_delta(to, tdo), got)
    assert not any(_build.launch_counts().values())
