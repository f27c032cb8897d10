"""The redesigned decode megakernel's plain twins and limits, on the CPU.

The CUDA kernel (csrc/decode_megakernel.cu) splits each (row, kv head)'s
positions across its grid's blocks and merges the splits' f32 partials in
the same launch, joining the current token last. The wrapper computes the
kernel's shared memory and the card's limits in Python, from the shapes
alone (the engine plans on meta tensors, with no card); the grid and the
GEMV phases' K splits are the card's (tests/test_torch_cuda.py).

- ``megakernel_attention_pieces`` cuts every (row, kv head)'s tiles into
  pieces as the kernel does from lens: one list of all tiles, equal
  contiguous shares a block. ``split_attend_current_reference``, the
  plain twin of the split and merge over those pieces, equals the unsplit
  ``_attend_current`` within 1e-6 (f32; the sums only change order) at
  grids of 1 to 264 blocks and at tiles of a page or of a piece of one;
  in place of ``_attend_current`` inside the
  port's plain layer it matches JAX's ``decode_layer_megakernel`` (Pallas
  in interpret mode) within tests/test_torch_megakernel.py's tolerances
  (f32 1e-5, bf16 5e-2 on h; pools: every page no row commits into
  byte-identical, each commit page within one step). Cases: f32 / bf16,
  bf16 / int8 pools, lens 0 (no position read, scratch page 0 still
  committed), 63, 64 (the commit opens a fresh page), W * 64 (a row frozen
  at its table's end, committing into its last page) and mid-cache.
- The commit rule: the current token lands in exactly one page and slot
  per (row, kv head) and layer, the one JAX's kernel writes (column
  min(lens // bs, W - 1) of the row's table, slot lens % bs).
- The limits (``smem_bytes``, ``_card_reason``): at Llama-3-8B's widths
  every row count 1-16 and both pool dtypes fit the card's 227 KB, as do
  the card tests' narrow widths; widths the kernel cannot take are
  refused in the card's words; phase 2's pieces cover every row's tiles
  once, and each block's share is within one tile of even.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import decode_megakernel as jmk
from paddle_tpu_torch.kernels import decode_megakernel as tmk
from paddle_tpu_torch.kernels.decode_attention import decode_tile_rows
from test_torch_megakernel import (DT, _call, _case, _check_pools, _jax_ops,
                                   _np, _torch_ops)

# a row of each kind in row 0, beside rows mid-cache, one page, one token
LENS = {"zero": 0, "63": 63, "64": 64, "frozen": 3 * 64, "mid": 150}


def _attn_operands(b=4, hq=8, hkv=2, d=16, bs=64, w=3, seed=0, q8=False):
    rng = np.random.default_rng(seed)
    pages = b * w + 1

    def rnd(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q, kc, vc = rnd(b, hq, d), rnd(b, hkv, d), rnd(b, hkv, d)
    pk, pv = rnd(pages, hkv, bs, d), rnd(pages, hkv, bs, d)
    ks = vs = None
    if q8:
        ks = torch.from_numpy(rng.uniform(0.01, 0.03, (pages, hkv)).astype(
            np.float32))
        vs = torch.from_numpy(rng.uniform(0.01, 0.03, (pages, hkv)).astype(
            np.float32))
        pk, pv = (torch.clamp(torch.round(p * 40), -127, 127).to(torch.int8)
                  for p in (pk, pv))
    tables = torch.from_numpy(
        (rng.permutation(pages - 1)[:b * w].reshape(b, w) + 1).astype(
            np.int32))
    return q, kc, vc, pk, pv, tables, ks, vs


@pytest.mark.parametrize("q8", [False, True], ids=["f32-pools", "int8-pools"])
@pytest.mark.parametrize("bs,blocks", [(64, 264), (64, 132), (64, 7), (64, 5),
                                       (64, 3), (64, 2), (64, 1), (128, 264),
                                       (128, 132), (128, 7), (128, 3),
                                       (128, 1)])
def test_split_twin_equals_unsplit_attention(bs, blocks, q8):
    w = 3
    q, kc, vc, pk, pv, tables, ks, vs = _attn_operands(bs=bs, w=w, q8=q8)
    st = decode_tile_rows(bs)
    for lens in ([0, 63, 64, w * bs], [150, 1, bs - 1, 2 * bs + 3]):
        pieces = tmk.megakernel_attention_pieces(lens, w, bs, 2, blocks)
        lens = torch.tensor(lens, dtype=torch.int32)
        want = tmk._attend_current(q, kc, vc, pk, pv, tables, lens, 0.25,
                                   ks, vs)
        got = tmk.split_attend_current_reference(
            q, kc, vc, pk, pv, tables, lens, 0.25, ks, vs, tile_rows=st,
            pieces=pieces)
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_split_twin_row_without_positions_is_the_current_value():
    """lens 0: no page is read; the output is the current token's v."""
    q, kc, vc, pk, pv, tables, _, _ = _attn_operands()
    lens = torch.zeros(4, dtype=torch.int32)
    got = tmk.split_attend_current_reference(
        q, kc, vc, pk, pv, tables, lens, 0.25, None, None, tile_rows=64,
        pieces=tmk.megakernel_attention_pieces([0] * 4, 3, 64, 2, 132))
    want = vc.repeat_interleave(4, dim=1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def _commit_target(c):
    """(row, kv head) -> (pool page, slot) JAX's kernel commits into."""
    b, w = c["tables"].shape
    bs = c["pools"][0].shape[2]
    out = {}
    for r in range(b):
        col = min(int(c["lens"][r]) // bs, w - 1)
        for h in range(c["pools"][0].shape[1]):
            out[(r, h)] = (int(c["tables"][r, col]), int(c["lens"][r]) % bs)
    return out


@pytest.mark.parametrize("blocks", [5, 132])
@pytest.mark.parametrize("lens", list(LENS))
@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_split_twin_in_the_layer_matches_jax(monkeypatch, dt, pools, lens,
                                             blocks):
    """The port's plain attn layer with the split twin in place of
    _attend_current, against JAX's decode_layer_megakernel: the pieces of
    a 5-block grid (rows cut into one to three pieces, some spanning
    tiles) and of a 132-block one (a piece a tile, as on the H100)."""
    jdt, tdt, tol = DT[dt]
    row_lens = [LENS[lens], 100, 5, 130]
    c = _case(nh=4, nkv=2, bs=64, W=3, int8_pools=pools == "int8",
              lens=row_lens)
    pieces = tmk.megakernel_attention_pieces(row_lens, 3, 64, 2, blocks)
    assert max(len(p) for p in pieces.values()) > 2     # a merge happens
    monkeypatch.setattr(tmk, "_attend_current", functools.partial(
        tmk.split_attend_current_reference, tile_rows=decode_tile_rows(64),
        pieces=pieces))
    jops = _jax_ops(c, jdt)
    tops = _torch_ops(jops, tdt)
    pools_in = [_np(p).copy() for p in tops[4]]
    got = _call(tmk, "attn", tops)
    want = jax.jit(lambda *a: _call(jmk, "attn", a))(*jops)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=tol, rtol=0)
    _check_pools(c, got, want, tdt)
    # the commit rule: one page per (row, kv head), the one JAX writes;
    # on bf16 / f32 pools one slot of it
    target = _commit_target(c)
    for i in (1, 2):
        for res in (got, want):
            moved = np.argwhere((_np(res[i]) != pools_in[i - 1]).any(-1))
            pages = {(int(p), int(h)) for p, h, _ in moved}
            assert pages <= {(p, h) for (_, h), (p, _) in target.items()}
            if pools == "bf16":
                slots = {(int(p), int(h), int(s)) for p, h, s in moved}
                assert slots == {(p, h, s) for (_, h), (p, s) in
                                 target.items()}


@pytest.mark.parametrize("q8", [False, True], ids=["bf16-pools", "int8-pools"])
@pytest.mark.parametrize("quant_w", [False, True], ids=["bf16-w", "int8-w"])
def test_plan_fits_llama3_8b_for_every_row_count(quant_w, q8):
    for b in range(1, 17):
        assert tmk._card_reason(b, 4096, 14336, 32, 8, 128, 64, quant_w, q8,
                                torch.bfloat16) is None
        assert tmk.smem_bytes(b, 4096, 32, 8, 128, 64, quant_w, q8,
                              torch.bfloat16) <= tmk.CARD_SMEM_BYTES


@pytest.mark.parametrize("args,words", [
    ((17, 4096, 14336, 32, 8, 128, 64, True, False, torch.bfloat16),
     "at most 16 rows"),
    ((8, 4096, 14336, 32, 8, 128, 64, False, False, torch.float16),
     "float32 or bfloat16"),
    ((8, 4104, 14336, 32, 8, 128, 64, True, False, torch.bfloat16),
     "multiple of 16"),
    ((8, 4096, 14340, 32, 8, 128, 64, False, False, torch.bfloat16),
     "multiple of 8"),
    ((8, 4096, 14336, 32, 8, 136, 64, False, False, torch.bfloat16),
     "head_dim"),
    ((16, 4096, 14336, 32, 8, 128, 64, False, False, torch.float32),
     "shared memory"),
])
def test_card_limits_are_refused_in_the_cards_words(args, words):
    reason = tmk._card_reason(*args)
    assert reason is not None and reason.startswith("card limit")
    assert words in reason


def test_card_refusal_reaches_the_planner_on_meta_tensors():
    """megakernel_supported on spec views refuses an int8-weight width the
    kernel cannot copy in 16-byte pieces only on the card."""
    h = torch.empty(8, 1, 4104, dtype=torch.bfloat16, device="meta")
    w_in = torch.empty(4104, dtype=torch.bfloat16, device="meta")

    def pair(n_out, n_in):
        return (torch.empty(n_out, n_in, dtype=torch.int8, device="meta"),
                torch.empty(n_out, dtype=torch.float32, device="meta"))

    pool = torch.empty(137, 8, 64, 128, dtype=torch.bfloat16, device="meta")
    tables = torch.empty(8, 17, dtype=torch.int32, device="meta")
    args = (h, w_in, pair(4096, 4104), pair(1024, 4104), pair(1024, 4104),
            pair(4104, 4096), pool, pool, tables)
    assert tmk.megakernel_supported(*args, on_card=False) is None
    assert "multiple of 16" in tmk.megakernel_supported(*args, on_card=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("q8", [False, True], ids=["float-pools",
                                                   "int8-pools"])
@pytest.mark.parametrize("quant_w", [False, True], ids=["dense-w", "int8-w"])
def test_card_tests_widths_are_taken(quant_w, q8, dtype):
    """tests/test_torch_cuda.py's megakernel shapes (H 256, Hq 8, Hkv 2,
    D 64, F 512, pages of 16) pass the card's limits at every row count
    those tests launch, with and without the MLP half."""
    for b in (1, 6, 8, 9, 16):
        for F in (None, 512):
            assert tmk._card_reason(b, 256, F, 8, 2, 64, 16, quant_w, q8,
                                    dtype) is None


@pytest.mark.parametrize("blocks", [264, 132, 33, 7, 2, 1])
@pytest.mark.parametrize("lens", [[520, 576, 600, 630, 660, 700, 720, 743],
                                  [0, 1, 63, 64, 65, 1088, 5000, 0]])
def test_attention_pieces_cover_every_tile_once(lens, blocks):
    """Every row's tiles (at most W pages) are cut into contiguous pieces
    from 0 to the row's count; the pieces' cut points are exactly the
    shares' edges inside the row, and each share holds T / blocks tiles
    within one."""
    W, bs, nkv = 17, 64, 8
    pieces = tmk.megakernel_attention_pieces(lens, W, bs, nkv, blocks)
    counts = [min(W, -(-n // bs)) for n in lens]
    total = sum(counts) * nkv
    start, edges = 0, set()
    for row, n in enumerate(counts):
        for h in range(nkv):
            cut = pieces[(row, h)]
            assert cut[0] == 0 and cut[-1] == n
            assert all(x < y for x, y in zip(cut[:-1], cut[1:])) or n == 0
            edges |= {start + c for c in cut}
            start += n
    shares = [(i * total) // blocks for i in range(blocks + 1)]
    assert {e for e in shares if 0 < e < total} <= edges
    sizes = [y - x for x, y in zip(shares[:-1], shares[1:])]
    assert max(sizes) - min(sizes) <= 1
