"""The plain twin of the redesigned paged prefill kernel against the JAX
package, on the CPU.

``split_prefill_reference`` is the plain twin of the CUDA kernel's
arithmetic on 16-bit operands: the cached positions cut into 64-key tiles
and the tiles into splits of ``tiles_per_split`` (split 0 also holding the
new-token window), an f32 partial (m, l, acc) per split with P carried as
two 16-bit parts (hi = T(p), lo = T(p - hi)), the partials merged in split
order. The same numpy inputs go through it and through the JAX
``ragged_paged_attention`` / ``prefix_prefill_attention`` (their Pallas
kernels in interpret mode, as the JAX package's tests run them), bf16 and
int8 pools, D 64 and 128, group 1 and 4, at 1 and 2 tiles a split and the
card's own plan (``prefill_split_plan``), with cached lengths 0, mid-page,
on a split's edge and past the table's tiles of shorter rows. Both round
once to bf16 from f32 sums, so they may differ by one bf16 step
(|a - b| <= 2^-7 * max(|ref|, 1)); f32 inputs (P kept whole): the same
math in another order, atol 1e-5. Pad rows are exact zeros on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import prefix_prefill as jpp
from paddle_tpu.kernels import ragged_attention as jra
from paddle_tpu_torch.kernels.decode_attention import (
    PREFILL_TILE, decode_split_plan, prefill_split_plan)
from paddle_tpu_torch.kernels.prefix_prefill import (
    paged_prefill_reference, split_prefill_reference)
from paddle_tpu_torch.models.llama import quantize_kv_pages

# tiles per split: 1, 2, and the card's plan (None)
SPLITS = [1, 2, None]
HEADS = [(4, 4), (8, 2)]
HEAD_IDS = ["group1", "group4"]


def _within(got, want, dtype):
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (np.abs(got - want)
                <= 2.0 ** -7 * np.maximum(np.abs(want), 1.0)).all(), \
            float(np.abs(got - want).max())


def _inputs(rng, b, tn, nh, nkv, dh, page, cached, q8):
    """numpy inputs: q, window k/v, pools (int8 with f32 scales when q8)
    holding every row's pages plus page 0, permuted tables."""
    w = max(1, max(-(-c // page) for c in cached))
    n_pages = b * w + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kn, vn = f(b, tn, nh, dh), f(b, tn, nkv, dh), f(b, tn, nkv, dh)
    pools = [f(n_pages, nkv, page, dh) for _ in range(2)]
    scales = None
    if q8:
        pairs = [quantize_kv_pages(torch.from_numpy(p)) for p in pools]
        pools = [p.numpy() for p, _ in pairs]
        scales = [s.numpy() for _, s in pairs]
    tables = (rng.permutation(n_pages - 1)[:b * w].reshape(b, w) + 1
              ).astype(np.int32)
    return q, kn, vn, pools, scales, tables


def _jax_and_torch(dtype, q, kn, vn, pools, scales, tables, cached, new):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp = [jnp.asarray(p) if scales else jnp.asarray(p, jdt) for p in pools]
    tp = [torch.from_numpy(p) if scales else torch.from_numpy(p).to(tdt)
          for p in pools]
    jkw = tkw = {}
    if scales:
        jkw = dict(k_scale=jnp.asarray(scales[0]),
                   v_scale=jnp.asarray(scales[1]))
        tkw = dict(k_scale=torch.from_numpy(scales[0]),
                   v_scale=torch.from_numpy(scales[1]))
    jargs = [jnp.asarray(a, jdt) for a in (q, kn, vn)] + jp + [
        jnp.asarray(tables), jnp.asarray(np.asarray(cached, np.int32)),
        jnp.asarray(np.asarray(new, np.int32))]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, kn, vn)] + tp + [
        torch.from_numpy(tables), torch.tensor(cached, dtype=torch.int32),
        torch.tensor(new, dtype=torch.int32)]
    return jargs, jkw, targs, tkw


@pytest.mark.parametrize("tps", SPLITS, ids=["tps1", "tps2", "plan"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("nh,nkv", HEADS, ids=HEAD_IDS)
@pytest.mark.parametrize("pools", ["bfloat16", "int8"])
def test_split_prefill_matches_jax_ragged(pools, nh, nkv, dh, tps):
    """Ragged rows over pages of 8 (64-key tiles cross pages): a cold
    prefill (cached 0), a mid-page cached length with a decode-like row,
    one on the edge of a 2-tile split (128) and a long one; pad rows."""
    cached, new = [0, 13, 128, 200], [16, 1, 9, 0]
    rng = np.random.default_rng(nh * dh + (tps or 0))
    q, kn, vn, pl, sc, tables = _inputs(rng, 4, 16, nh, nkv, dh, 8, cached,
                                        pools == "int8")
    jargs, jkw, targs, tkw = _jax_and_torch("bfloat16", q, kn, vn, pl, sc,
                                            tables, cached, new)
    want = np.asarray(jnp.asarray(jra.ragged_paged_attention(*jargs, **jkw),
                                  jnp.float32))
    got = split_prefill_reference(*targs, tiles_per_split=tps, **tkw)
    assert got.dtype == torch.bfloat16
    for row, n in enumerate(new):
        assert (got[row, n:] == 0).all() and (want[row, n:] == 0).all()
    _within(got, want, "bfloat16")


@pytest.mark.parametrize("tps", SPLITS, ids=["tps1", "tps2", "plan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pools", ["same", "int8"])
def test_split_prefill_matches_jax_prefix(pools, dtype, tps):
    """Whole-page prefixes of 0 to 12 pages of 16 (3 tiles; group 4,
    D 64): the JAX prefix-prefill kernel against the twin."""
    cached, new = [0, 64, 192], [32, 1, 20]
    rng = np.random.default_rng(3 + (tps or 0))
    q, kn, vn, pl, sc, tables = _inputs(rng, 3, 32, 8, 2, 64, 16, cached,
                                        pools == "int8")
    jargs, jkw, targs, tkw = _jax_and_torch(dtype, q, kn, vn, pl, sc,
                                            tables, cached, new)
    want = np.asarray(jnp.asarray(jpp.prefix_prefill_attention(*jargs,
                                                               **jkw),
                                  jnp.float32))
    got = split_prefill_reference(*targs, tiles_per_split=tps, **tkw)
    for row, n in enumerate(new):
        assert (got[row, n:] == 0).all()
    _within(got, want, dtype)


@pytest.mark.parametrize("tps", [1, 2, 3, None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pools", ["same", "int8"])
def test_split_prefill_matches_plain(pools, dtype, tps):
    """Against the port's plain version (one softmax over every position,
    P in f32): cached lengths 0, mid-page, on split edges (64, 128, 192)
    and the whole table; pages of 16; MQA (group 8), D 128."""
    cached, new = [0, 37, 64, 128, 192, 255], [24, 24, 1, 7, 24, 0]
    rng = np.random.default_rng(11 + (tps or 0))
    q, kn, vn, pl, sc, tables = _inputs(rng, 6, 24, 8, 1, 128, 16, cached,
                                        pools == "int8")
    _, _, targs, tkw = _jax_and_torch(dtype, q, kn, vn, pl, sc, tables,
                                      cached, new)
    want = paged_prefill_reference(*targs, 128 ** -0.5, **tkw)
    got = split_prefill_reference(*targs, tiles_per_split=tps, **tkw)
    _within(got, want.float().numpy(), dtype)


@pytest.mark.parametrize("span,tn,group,b,hkv", [
    (64, 1, 1, 1, 1),          # one tile, one row
    (2112, 256, 4, 1, 8),      # the unified window (phase 4): 16 row tiles
    (1408, 256, 4, 2, 8),      # phase 1's ragged case
    (512, 128, 4, 4, 8),       # phase 1's prefix case
    (8, 16, 1, 3, 2),          # a span shorter than a tile
    (65, 64, 8, 8, 8),         # a ragged last tile
    (131072, 8, 1, 1, 1),      # many tiles, one small row
    (4096, 2048, 4, 8, 8),     # a grid past the card: no split
])
def test_prefill_split_plan_covers_every_tile(span, tn, group, b, hkv):
    """Every 64-key tile of the table's span is in exactly one split:
    tps >= 1, splits * tps >= tiles > (splits - 1) * tps; the rule is
    decode_split_plan's over the grid's row tiles."""
    tps, splits = prefill_split_plan(span, tn, group, b, hkv)
    n_tiles = -(-span // PREFILL_TILE)
    row_tiles = -(-tn * group // PREFILL_TILE)
    assert tps >= 1 and splits >= 1
    assert splits * tps >= n_tiles > (splits - 1) * tps
    assert (tps, splits) == decode_split_plan(n_tiles, b * row_tiles, hkv)
    if b * row_tiles * hkv >= 4 * 132:
        assert splits == 1


def test_split_prefill_live_splits():
    """Splits that start at or past cached_len carry no weight: a row's
    result does not depend on how its dead splits' table entries are
    filled, and rows of cached_len 0 are the window alone."""
    cached, new = [0, 64, 100], [8, 8, 8]
    rng = np.random.default_rng(5)
    q, kn, vn, pl, sc, tables = _inputs(rng, 3, 8, 4, 2, 64, 8, cached,
                                        False)
    _, _, targs, _ = _jax_and_torch("float32", q, kn, vn, pl, sc, tables,
                                    cached, new)
    base = split_prefill_reference(*targs, tiles_per_split=1)
    other = list(targs)
    other[5] = targs[5].clone()
    other[5][0] = 0                       # row 0 names no cached token
    other[5][1, 8:] = 0                   # row 1's pages past 64 tokens
    torch.testing.assert_close(
        split_prefill_reference(*other, tiles_per_split=1), base, atol=0,
        rtol=0)
    window_only = [t[:1] for t in targs[:3]] + targs[3:5] + [
        t[:1] for t in targs[5:]]
    torch.testing.assert_close(
        split_prefill_reference(*window_only, tiles_per_split=1)[0],
        base[0], atol=1e-6, rtol=0)
