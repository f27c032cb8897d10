"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels are CUDA C++ for sm_90a with no interpret mode, so every test
here is marked `cuda` and skips where torch.cuda.is_available() is false.
The file imports neither jax nor paddle_tpu, so it runs on a machine
without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: rms_norm, paged decode and paged prefill attention compute
in f32 from the same inputs and round once, so they may differ by one
bf16 rounding step (|a - b| <= 2^-7 * max(|ref|, 1)), or by 1e-5 in f32
(paged prefill's tensor-core body carries P as two 16-bit parts, about
16 bits, far inside that step); flash attention's plain twin rounds the
scores to bf16 where the kernel keeps f32 (atol 3e-2 on N(0, 1)). Every
input comes from a seeded generator, and the redesigned kernels (flash
forward, paged prefill with its split-and-merge) are also held bitwise
equal across two launches. Paged prefill attention's pad query
rows must be exact zeros on the card too. The int8-pool kernels are held
against the same plain versions on the same int8 pools and scales (pages
quantized by the port's own quantize_kv_pages), with the same bars: the
kernel folds the scales into its f32 sums, the plain version dequantizes
in f32 first.

The weight-only GEMV (int4 and int8, bf16 or f16 x on the tensor cores)
and the contiguous decode kernel compute in f32 from the same inputs and
round once, so their results are within one rounding step of the plain
version (bf16 2^-7, f16 2^-10 relative); the GEMV also of the plain twin
of its K split (``weight_only_split_reference`` under the card's plan),
and two of its launches are bitwise equal.

The engine's programs (the decode chunk, the unified step's window, the
verify window and a draft model's program) are CUDA graphs on the card:
the same engine and traffic, replayed and run eagerly (its programs'
`graphed` turned off), must give identical greedy streams, bitwise-equal
pool pages (the scratch page aside) and equal launch counts, on every
rung, both pool dtypes and every weight kind. A draft model over the
target's own weights must see at least a fifth of its drafts accepted,
and a disaggregated engine must give the colocated engine's tokens.
The split path's prefill programs are held the same way (cold and
prefix, both pool dtypes, the scan stride), and so is each layout of
``jit_generate``'s program (contiguous, weight-only, quant-only, paged
over bf16 and int8 pools, the full megakernel), with exact launches.

The decode fleet: an engine's programs replayed from a thread that did
not capture them (as a fleet worker's serve loop runs them) give the
building thread's streams, launches and pool pages; a two-worker fleet
over one params dict, with one-request prefills, serves the lone
engine's streams with compile_stats() steady, and so do first-use
captures and a warm()ing joiner beside the other worker's replays (the
card's device gate); a chaos kill's recovered
requests keep their delivered tokens and pass a plain forward's rank
gate (0.5 logit: the re-prefill rounds differently from the decode steps
that made those tokens); a FileStore serve_worker on the card serves the
in-process engine's streams, and the fleet smoke CLI runs under a kill.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.decode_attention import (
    CONTIG_TILE, decode_split_plan, decode_tile_rows, paged_decode_attention,
    paged_decode_attention_reference, split_decode_reference)
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)
from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a "
                    "and have no interpret mode")
    return torch.device("cuda")


def _within_one_bf16_step(got, ref):
    g, r = got.float(), ref.float()
    assert ((g - r).abs() <= 2.0 ** -7 * r.abs().clamp(min=1.0)).all(), \
        float((g - r).abs().max())


def _split_edges(n_tiles, b, hkv, st, last):
    """lens on the kernels' split edges for rows of `n_tiles` tiles of
    `st` positions: the last position of the first split and the first
    position of the second, plus 0 and `last`."""
    tps = decode_split_plan(n_tiles, b, hkv)[0]
    return [0, tps * st - 1, tps * st, last]


def _launched(name, fn):
    before = _build.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("rows,dim", [(64, 4096), (3, 100)])
def test_rms_norm(dev, rows, dim):
    g = torch.Generator(device=dev).manual_seed(rows + dim)
    x = torch.randn(rows, dim, generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.randn(dim, generator=g, device=dev, dtype=torch.bfloat16)
    got = _launched("rms_norm", lambda: rms_norm(x, w))
    _within_one_bf16_step(got, rms_norm_reference(x, w))


def _flash_inputs(dev, b, sq, sk, hq, hkv, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g, device=dev,
                        dtype=torch.bfloat16)
            for s, h in ((sq, hq), (sk, hkv), (sk, hkv))]


@pytest.mark.parametrize("sq,sk,hq,hkv,d", [
    (200, 333, 32, 8, 128), (64, 64, 8, 8, 64), (1, 77, 4, 1, 128)])
def test_flash_attention(dev, sq, sk, hq, hkv, d):
    q, k, v = _flash_inputs(dev, 2, sq, sk, hq, hkv, d, seed=sq + sk + d)
    got, lse = _launched("flash_attention_fwd", lambda: flash_attention(
        q, k, v, causal=True, return_lse=True))
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True,
                                             return_lse=True)
    assert (got.float() - ref.float()).abs().max() <= 3e-2
    assert (lse - ref_lse).abs().max() <= 1e-2


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 300, 300, 16, 4, 128, True),    # ragged q tiles, GQA
    (1, 64, 200, 8, 8, 64, True),       # Sq < Sk: the diagonal offset
    (1, 100, 77, 4, 1, 128, False),     # not causal, ragged keys
])
def test_flash_attention_deterministic(dev, b, sq, sk, hq, hkv, d, causal):
    """Two launches on the same inputs: bitwise-equal O and lse; and the
    plain twin's bars."""
    q, k, v = _flash_inputs(dev, b, sq, sk, hq, hkv, d, seed=7 + sq)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    out2, lse2 = flash_attention(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    assert (out.float() - ref.float()).abs().max() <= 3e-2
    assert (lse - ref_lse).abs().max() <= 1e-2


def test_flash_attention_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 8, 2, 128, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q, q, causal=True)
    qb = torch.randn(1, 8, 2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(qb, qb, qb, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv", [(32, 8), (32, 32), (8, 1)])
def test_paged_decode(dev, dtype, hq, hkv):
    g = torch.Generator().manual_seed(5)
    n_pages, bs, d, w = 40, 64, 128, 6
    kc, vc = (torch.randn(n_pages, hkv, bs, d, generator=g)
              for _ in range(2))
    q = torch.randn(6, hq, d, generator=g)
    perm = torch.randperm(n_pages - 1, generator=g) + 1
    tables = perm[: 6 * w].reshape(6, w).to(torch.int32)
    tables[3] = 0                              # a free row: scratch page
    lens = torch.tensor([0, bs - 1, bs, 0, 300, w * bs + 9], dtype=torch.int32)
    args = [t.to(dev, dtype) for t in (q, kc, vc)] + [tables.to(dev),
                                                      lens.to(dev)]
    got = _launched("paged_decode_attention",
                    lambda: paged_decode_attention(*args))
    ref = paged_decode_attention_reference(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    else:
        _within_one_bf16_step(got, ref)
    _paged_long_rows(dev, dtype, hq, hkv, q8=False)


def _paged_long_rows(dev, dtype, hq, hkv, q8):
    """B1 (the most splits) over 128 pages (8192 positions), lens on the
    split edges, against the plain version (f32 atol 1e-5, bf16 one
    step) and the split twin, and bitwise equal across two launches."""
    g = torch.Generator().manual_seed(9)
    bs, w, d = 64, 128, 128
    pools = [torch.randn(w + 1, hkv, bs, d, generator=g) for _ in range(2)]
    if q8:
        (kc, ksc), (vc, vsc) = (_q8_pool(p) for p in pools)
        kw = dict(k_scale=ksc.to(dev), v_scale=vsc.to(dev))
        kc, vc = kc.to(dev), vc.to(dev)
    else:
        kw = {}
        kc, vc = (p.to(dev, dtype) for p in pools)
    q = torch.randn(1, hq, d, generator=g).to(dev, dtype)
    tables = (torch.randperm(w, generator=g) + 1).reshape(1, w).to(
        torch.int32).to(dev)
    for n in _split_edges(w * bs // decode_tile_rows(bs), 1, hkv,
                          decode_tile_rows(bs), w * bs - 1):
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        args = (q, kc, vc, tables, lens)
        got = paged_decode_attention(*args, **kw)
        assert torch.equal(got, paged_decode_attention(*args, **kw))
        for ref in (paged_decode_attention_reference(*args, **kw),
                    split_decode_reference(q, kc, vc, lens,
                                           block_tables=tables, **kw)):
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
            else:
                _within_one_bf16_step(got, ref)


def _q8_pool(pool):
    """A float pool [P, Hkv, bs, D] -> (int8 pool, f32 scales [P, Hkv])."""
    from paddle_tpu_torch.models.llama import quantize_kv_pages

    return quantize_kv_pages(pool)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv", [(32, 8), (32, 32), (8, 1)])
def test_paged_decode_int8(dev, dtype, hq, hkv):
    """int8 pools: group 4, group 1 and MQA; ragged lens including 0, a
    page boundary and a row past its table; a free row on page 0."""
    g = torch.Generator().manual_seed(7)
    n_pages, bs, d, w = 40, 64, 128, 6
    (kc, ksc), (vc, vsc) = (_q8_pool(torch.randn(n_pages, hkv, bs, d,
                                                 generator=g))
                            for _ in range(2))
    q = torch.randn(6, hq, d, generator=g)
    perm = torch.randperm(n_pages - 1, generator=g) + 1
    tables = perm[: 6 * w].reshape(6, w).to(torch.int32)
    tables[3] = 0
    lens = torch.tensor([0, bs - 1, bs, 0, 300, w * bs + 9], dtype=torch.int32)
    args = [q.to(dev, dtype), kc.to(dev), vc.to(dev), tables.to(dev),
            lens.to(dev)]
    sc = dict(k_scale=ksc.to(dev), v_scale=vsc.to(dev))
    got = _launched("paged_decode_attention_int8",
                    lambda: paged_decode_attention(*args, **sc))
    ref = paged_decode_attention_reference(*args, **sc)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    else:
        _within_one_bf16_step(got, ref)
    _paged_long_rows(dev, dtype, hq, hkv, q8=True)


def test_paged_decode_refuses_int64_tables(dev):
    q = torch.randn(1, 4, 128, device=dev, dtype=torch.bfloat16)
    kc = torch.randn(2, 2, 64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, kc, kc, torch.zeros(1, 1, device=dev,
                                                      dtype=torch.int64),
                               torch.zeros(1, device=dev, dtype=torch.int32))


def _prefill_inputs(dev, dtype, b, tn, hq, hkv, d, page, cached, new, seed):
    """Permuted tables covering each row's cached tokens; pools hold
    every row's pages plus page 0, which stands for the scratch page."""
    g = torch.Generator().manual_seed(seed)
    w = max(1, max(-(-c // page) for c in cached))
    n_pages = b * w + 1
    kc, vc = (torch.randn(n_pages, hkv, page, d, generator=g)
              for _ in range(2))
    q = torch.randn(b, tn, hq, d, generator=g)
    kn, vn = (torch.randn(b, tn, hkv, d, generator=g) for _ in range(2))
    tables = (torch.randperm(n_pages - 1, generator=g)[: b * w] + 1
              ).reshape(b, w).to(torch.int32)
    lens = [torch.tensor(x, dtype=torch.int32).to(dev) for x in (cached, new)]
    return [t.to(dev, dtype) for t in (q, kn, vn, kc, vc)] \
        + [tables.to(dev)] + lens


def _q8_args(args):
    """_prefill_inputs' operands with the two pools quantized: (args with
    int8 pools, {k_scale, v_scale})."""
    (kc, ksc), (vc, vsc) = _q8_pool(args[3].float()), _q8_pool(
        args[4].float())
    return args[:3] + [kc, vc] + args[5:], dict(k_scale=ksc, v_scale=vsc)


def _check_paged_prefill(got, ref, new, dtype):
    """Pad rows exact zeros, nothing NaN; live rows within 1e-5 (f32:
    same f32 math, other summation order) or one bf16 rounding step
    (both compute in f32 from the same inputs and round once)."""
    assert torch.isfinite(got.float()).all()
    for row, n in enumerate(new):
        assert (got[row, n:] == 0).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref.to(dtype), atol=1e-5, rtol=0)
    else:
        _within_one_bf16_step(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (8, 8, 64), (8, 1, 128)])
def test_prefix_prefill_kernel(dev, dtype, hq, hkv, d):
    """Whole-page prefixes of 0..8 pages, suffix lengths with pad rows
    and a one-token suffix."""
    from paddle_tpu_torch.kernels.prefix_prefill import (
        prefix_prefill_attention, prefix_prefill_reference)

    page, sb = 64, 128
    cached, new = [0, 64, 256, 512], [128, 1, 77, 100]
    args = _prefill_inputs(dev, dtype, 4, sb, hq, hkv, d, page, cached,
                           new, seed=hq + d)
    got = _launched("prefix_prefill_attention",
                    lambda: prefix_prefill_attention(*args))
    _check_paged_prefill(got, prefix_prefill_reference(*args), new, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cached,new,tn", [
    ([0, 1344 + 37], [256, 100], 256),             # mid-page cached length
    ([0, 5, 63, 64, 65, 130, 700, 0], [1, 1, 1, 1, 1, 1, 1, 64], 64),
    ([9, 0, 200], [0, 40, 3], 40),                 # window not page-sized
])
def test_ragged_paged_attention_kernel(dev, dtype, cached, new, tn):
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)

    args = _prefill_inputs(dev, dtype, len(cached), tn, 32, 8, 128, 64,
                           cached, new, seed=tn)
    got = _launched("ragged_paged_attention",
                    lambda: ragged_paged_attention(*args))
    _check_paged_prefill(got, ragged_paged_attention_reference(*args), new,
                         dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (8, 8, 64), (8, 1, 128)])
def test_prefix_prefill_kernel_int8(dev, dtype, hq, hkv, d):
    """int8 pools: whole-page prefixes of 0..8 pages, pad rows and a
    one-token suffix; group 4, group 1 (D 64) and MQA."""
    from paddle_tpu_torch.kernels.prefix_prefill import (
        prefix_prefill_attention, prefix_prefill_reference)

    cached, new = [0, 64, 256, 512], [128, 1, 77, 100]
    args, sc = _q8_args(_prefill_inputs(dev, dtype, 4, 128, hq, hkv, d, 64,
                                        cached, new, seed=hq + d + 1))
    got = _launched("prefix_prefill_attention_int8",
                    lambda: prefix_prefill_attention(*args, **sc))
    _check_paged_prefill(got, prefix_prefill_reference(*args, **sc), new,
                         dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cached,new,tn,page", [
    ([0, 1344 + 37], [256, 100], 256, 64),        # mid-page cached length
    ([0, 5, 63, 64, 65, 130, 700, 0], [1, 1, 1, 1, 1, 1, 1, 64], 64, 64),
    ([9, 0, 200], [0, 40, 3], 40, 64),            # window not page-sized
    ([13, 100, 37], [16, 5, 0], 16, 8),           # 64-key tiles cross pages
])
def test_ragged_paged_attention_kernel_int8(dev, dtype, cached, new, tn,
                                            page):
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)

    args, sc = _q8_args(_prefill_inputs(dev, dtype, len(cached), tn, 32, 8,
                                        128, page, cached, new,
                                        seed=tn + page))
    got = _launched("ragged_paged_attention_int8",
                    lambda: ragged_paged_attention(*args, **sc))
    _check_paged_prefill(got, ragged_paged_attention_reference(*args, **sc),
                         new, dtype)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("tps", [1, 2, None], ids=["tps1", "tps2", "plan"])
def test_paged_prefill_split_deterministic(dev, monkeypatch, q8, tps):
    """The split-and-merge path: cached lengths 0, mid-page and past a
    split's edge (pages of 8, so 64-key tiles cross pages), a decode-like
    row and pad rows, at 1 and 2 tiles a split and the plan's own. Two
    launches are bitwise equal; the kernel is within one bf16 step of
    both the plain version and the plain twin of its split and merge."""
    from paddle_tpu_torch.kernels import prefix_prefill as pp
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)

    if tps is not None:
        def plan(span, *_):
            return tps, -(-(-(-span // pp.PREFILL_TILE)) // tps)
        monkeypatch.setattr(pp, "prefill_split_plan", plan)
    cached, new = [0, 37, 200, 130], [64, 1, 50, 0]
    args = _prefill_inputs(dev, torch.bfloat16, 4, 64, 32, 8, 128, 8,
                           cached, new, seed=17)
    kw = {}
    if q8:
        args, kw = _q8_args(args)
    got = ragged_paged_attention(*args, **kw)
    assert torch.equal(got, ragged_paged_attention(*args, **kw))
    _check_paged_prefill(got, ragged_paged_attention_reference(*args, **kw),
                         new, torch.bfloat16)
    twin = pp.split_prefill_reference(*args, tiles_per_split=tps, **kw)
    _within_one_bf16_step(got, twin)


@pytest.mark.parametrize("q8", [False, True], ids=["f16", "f16-int8"])
def test_paged_prefill_f16(dev, q8):
    """f16 operands take the tensor-core body with f16 fragments."""
    from paddle_tpu_torch.kernels.prefix_prefill import (
        prefix_prefill_attention, prefix_prefill_reference)

    cached, new = [0, 64, 256, 512], [128, 1, 77, 100]
    args = _prefill_inputs(dev, torch.float16, 4, 128, 32, 8, 128, 64,
                           cached, new, seed=23)
    kw = {}
    if q8:
        args, kw = _q8_args(args)
    got = prefix_prefill_attention(*args, **kw)
    assert torch.equal(got, prefix_prefill_attention(*args, **kw))
    ref = prefix_prefill_reference(*args, **kw)
    assert torch.isfinite(got.float()).all()
    for row, n in enumerate(new):
        assert (got[row, n:] == 0).all()
    g, r = got.float(), ref.float()   # one f16 step: 2^-10 relative
    assert ((g - r).abs() <= 2.0 ** -10 * r.abs().clamp(min=1.0)).all(), \
        float((g - r).abs().max())


def test_int8_pools_launch_only_the_int8_kernels(dev):
    """An int8 launch counts under its own counter, never the bf16 one."""
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_paged_attention)

    args, sc = _q8_args(_prefill_inputs(dev, torch.bfloat16, 2, 16, 8, 2,
                                        128, 64, [70, 0], [16, 3], seed=1))
    _build.reset_launch_counts()
    ragged_paged_attention(*args, **sc)
    q1 = args[0][:, 0].contiguous()
    paged_decode_attention(q1, args[3], args[4], args[5], args[6], **sc)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts["ragged_paged_attention_int8"] == 1
    assert counts["paged_decode_attention_int8"] == 1
    assert sum(counts.values()) == 2


def test_paged_prefill_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels.prefix_prefill import (
        prefix_prefill_attention)
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_paged_attention)

    args = _prefill_inputs(dev, torch.bfloat16, 1, 64, 4, 2, 128, 64, [64],
                           [64], seed=0)
    with pytest.raises(ValueError, match="whole number"):
        prefix_prefill_attention(*[a[:, :48] if i < 3 else a
                                   for i, a in enumerate(args)])
    bad = list(args)
    bad[5] = bad[5].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        ragged_paged_attention(*bad)
    odd = _prefill_inputs(dev, torch.bfloat16, 1, 64, 4, 2, 48, 64, [64],
                          [64], seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        ragged_paged_attention(*odd)


# ---------------------------------------------------------------------------
# weight-only GEMV and contiguous decode
# ---------------------------------------------------------------------------

def _quant_pair(dev, k, n, quant, seed):
    from paddle_tpu_torch.nn.quant import weight_quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(k, n, generator=g, device=dev) * 0.02
    return weight_quantize(w, algo=quant)


# (K, N) of a Llama-3-8B decode step: gate / up, q / o, k / v, down, lm_head
GEMV_STEP_SHAPES = [(4096, 14336), (4096, 4096), (4096, 1024),
                    (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("quant", ["weight_only_int4", "weight_only_int8"])
@pytest.mark.parametrize("m,k,n", [
    (m, k, n) for m in (8, 1, 16, 33, 64) for k, n in GEMV_STEP_SHAPES] + [
    # K on the split edges: ranks of unequal stage counts, a last stage
    # of 32 k; ragged N and a partial k block; the smallest shape
    (8, 4096 + 32, 4096), (33, 4096 - 32, 1024), (64, 14336 - 224, 4096),
    (5, 288, 1000), (1, 32, 16)])
def test_weight_only_gemv(dev, quant, m, k, n):
    """The kernel within one bf16 step of the plain version and of the
    plain twin of its order of sums under the card's own plan, and two
    launches bitwise equal."""
    from paddle_tpu_torch.kernels.int4_matmul import (
        card_plan, int4_matmul, int4_matmul_reference, int8_weight_matmul,
        int8_weight_matmul_reference, weight_only_split_reference)

    int4 = quant == "weight_only_int4"
    fn, ref_fn, name = (
        (int4_matmul, int4_matmul_reference, "int4_matmul") if int4 else
        (int8_weight_matmul, int8_weight_matmul_reference,
         "int8_weight_matmul"))
    wq, sc = _quant_pair(dev, k, n, quant, seed=m + k + n)
    g = torch.Generator(device=dev).manual_seed(m * k + n)
    x = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
    got = _launched(name, lambda: fn(x, wq, sc))
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _within_one_bf16_step(got, ref_fn(x, wq, sc))
    _within_one_bf16_step(
        got, weight_only_split_reference(x, wq, sc, card_plan(x, wq, int4)))
    assert torch.equal(got, fn(x, wq, sc))


def test_weight_only_gemv_plan_is_the_twins(dev):
    """The kernel's host plan (read back through its C entry point) is
    gemv_plan's, on this card's SM count and on an H100's."""
    import ctypes

    from paddle_tpu_torch.kernels.int4_matmul import GemvPlan, gemv_plan

    lib = _build.library("weight_only_gemv")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = (ctypes.c_int * 7)()
    for card in (sms, 132, 7):
        for m in (1, 5, 8, 9, 16, 33, 64):
            for k, n in GEMV_STEP_SHAPES + [(288, 1000), (4128, 4096),
                                            (32, 16), (544, 150)]:
                for int4 in (True, False):
                    lib.weight_only_gemv_plan(m, n, k, int(int4), card,
                                              ctypes.addressof(out))
                    assert GemvPlan(m, n, k, int4, *out) == \
                        gemv_plan(m, n, k, int4, card), (card, m, k, n, int4)


@pytest.mark.parametrize("quant", ["weight_only_int4", "weight_only_int8"])
def test_weight_only_gemv_f16(dev, quant):
    """float16 x (the f16 tensor-core path): within one f16 rounding step
    (2^-10 relative) of the plain version."""
    from paddle_tpu_torch.kernels.int4_matmul import (
        int4_matmul, int4_matmul_reference, int8_weight_matmul,
        int8_weight_matmul_reference)

    fn, ref_fn = ((int4_matmul, int4_matmul_reference)
                  if quant == "weight_only_int4" else
                  (int8_weight_matmul, int8_weight_matmul_reference))
    wq, sc = _quant_pair(dev, 14336, 520, quant, seed=1)
    x = torch.randn(9, 14336, device=dev, dtype=torch.float16)
    got, ref = fn(x, wq, sc).float(), ref_fn(x, wq, sc).float()
    assert ((got - ref).abs() <= 2.0 ** -10 * ref.abs().clamp(min=1.0)).all()


@pytest.mark.parametrize("quant", ["weight_only_int4", "weight_only_int8"])
def test_weight_only_large_m_route(dev, quant):
    """M > 64 takes the dequantize-then-matmul route under its own counter
    and launches no GEMV; the result is the plain version's within one
    bf16 step (both sum in f32 and round once)."""
    from paddle_tpu_torch.kernels.int4_matmul import (
        int4_matmul, int4_matmul_reference, int8_weight_matmul,
        int8_weight_matmul_reference)

    fn, ref_fn, name = (
        (int4_matmul, int4_matmul_reference, "int4_matmul")
        if quant == "weight_only_int4" else
        (int8_weight_matmul, int8_weight_matmul_reference,
         "int8_weight_matmul"))
    wq, sc = _quant_pair(dev, 4096, 1024, quant, seed=2)
    x = torch.randn(65, 4096, device=dev, dtype=torch.bfloat16)
    _build.reset_launch_counts()
    got = fn(x, wq, sc)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts[name + "_large_m"] == 1 and counts[name] == 0
    _within_one_bf16_step(got, ref_fn(x, wq, sc))


def test_weight_only_gemv_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels.int4_matmul import (int4_matmul,
                                                      int8_weight_matmul)

    wq, sc = _quant_pair(dev, 48, 64, "weight_only_int4", seed=0)
    x = torch.randn(2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 32"):
        int4_matmul(x, wq, sc)
    w8, s8 = _quant_pair(dev, 64, 64, "weight_only_int8", seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        int8_weight_matmul(torch.randn(64, 2, device=dev,
                                       dtype=torch.bfloat16).t(), w8, s8)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        int8_weight_matmul(torch.randn(2, 64, device=dev), w8, s8)
    with pytest.raises(ValueError, match="CUDA device"):
        int8_weight_matmul(torch.randn(2, 64, device=dev), w8.cpu(), s8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv,max_seq", [
    (32, 8, 1024), (32, 32, 1024), (8, 1, 544), (32, 8, 96),
    (32, 8, 8192)])
def test_contiguous_decode(dev, dtype, hq, hkv, max_seq):
    """Ragged lens including 0 and max_seq - 1; max_seq not a multiple of
    the kernel's 64-position tile (544 = 8.5 tiles, 96 = 1.5); then B1
    (the most splits) with lens on the split edges, against the plain
    version and the split twin, bitwise equal across two launches."""
    from paddle_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference, gqa_decode_attention)

    g = torch.Generator().manual_seed(hq + max_seq)
    b, d = 6, 128
    q = torch.randn(b, hq, d, generator=g)
    kc, vc = (torch.randn(b, hkv, max_seq, d, generator=g) for _ in range(2))
    lens = torch.tensor([0, 63, 64, max_seq // 2 + 5, max_seq - 2,
                         max_seq - 1], dtype=torch.int32)
    args = [t.to(dev, dtype) for t in (q, kc, vc)] + [lens.to(dev)]
    fn, name = ((decode_attention, "decode_attention") if hq == hkv
                else (gqa_decode_attention, "gqa_decode_attention"))
    got = _launched(name, lambda: fn(*args))
    ref = decode_attention_reference(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    else:
        _within_one_bf16_step(got, ref)
    for n in _split_edges(-(-max_seq // CONTIG_TILE), 1, hkv, CONTIG_TILE,
                          max_seq - 1):
        one = [args[0][:1], args[1][:1], args[2][:1],
               torch.tensor([n], dtype=torch.int32, device=dev)]
        got = fn(*one)
        assert torch.equal(got, fn(*one))
        for ref in (decode_attention_reference(*one),
                    split_decode_reference(*one)):
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
            else:
                _within_one_bf16_step(got, ref)


# ---------------------------------------------------------------------------
# the decode megakernels
# ---------------------------------------------------------------------------

def _mk_case(dev, dtype, quant_w, int8_pools, n_layers, seed=0, b=6, H=256,
             nh=8, nkv=2, dh=64, F=512, bs=16, w=5, lens=None,
             structured=False):
    """Stacked weights [L, ...] (dense in `dtype`, or weight-only int8
    pairs), a layer-major pool of L * (b * w + 1) pages, permuted tables,
    and lens: 0 (a free row on the scratch page 0), mid-page, a page
    boundary, a row frozen at its table's end (commits into its last
    page), mid-cache (repeated with offsets past six rows). `structured`:
    each row of h one-hot, every projection's output channel n holding
    (n % 64 - 32) / 64 at every k (exact in bf16 and int8 x 1/64), so a
    channel computed from the wrong weights shows by its value."""
    from paddle_tpu_torch.models.llama import quantize_kv_pages
    from paddle_tpu_torch.nn.quant import weight_quantize

    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=g) * s

    def channel_values(shp):
        n = torch.arange(shp[1], dtype=torch.float32)
        return ((n % 64 - 32) / 64).expand(shp).clone()

    shapes = {"wq": (H, nh * dh), "wk": (H, nkv * dh), "wv": (H, nkv * dh),
              "wo": (nh * dh, H), "wg": (H, F), "wu": (H, F), "wd": (F, H)}
    ws = {}
    for name, shp in shapes.items():
        per = [channel_values(shp) if structured else rnd(*shp, s=0.05)
               for _ in range(n_layers)]
        if quant_w:
            pairs = [weight_quantize(x, algo="weight_only_int8") for x in per]
            ws[name] = (torch.stack([p[0] for p in pairs]).to(dev),
                        torch.stack([p[1] for p in pairs]).to(dev))
        else:
            ws[name] = torch.stack(per).to(dev, dtype)
    norms = [(1 + 0.1 * rnd(n_layers, H)).to(dev, dtype) for _ in range(2)]
    pages = b * w + 1
    pools = [rnd(n_layers * pages, nkv, bs, dh) for _ in range(2)]
    kw = {}
    if int8_pools:
        (kc, ks), (vc, vs) = (quantize_kv_pages(p) for p in pools)
        pools = [kc.to(dev), vc.to(dev)]
        kw = dict(k_scale=ks.to(dev), v_scale=vs.to(dev))
    else:
        pools = [p.to(dev, dtype) for p in pools]
    perm = torch.randperm(pages - 1, generator=g) + 1
    tables = perm[: b * w].reshape(b, w).to(torch.int32)
    if lens is None:
        base = [0, 7, bs, w * bs, 3 * bs + 5, 2 * bs - 1]
        lens = [base[0]] + [min(base[1 + (i - 1) % 5] + (i - 1) // 5,
                                w * bs) for i in range(1, b)]
    lens = torch.tensor(lens, dtype=torch.int32)
    tables[lens == 0] = 0
    if structured:
        h = torch.zeros(b, 1, H)
        h[torch.arange(b), 0, (3 * torch.arange(b) + 1) % H] = 1.0
    else:
        h = rnd(b, 1, H, s=0.5)
    h = h.to(dev, dtype)
    weights = [norms[0], norms[1]] + [ws[n] for n in
                                      ("wq", "wk", "wv", "wo", "wg", "wu",
                                       "wd")]
    return h, lens.to(dev), tables.to(dev), weights, pools, kw


def _mk_call(rung, fns, h, lens, tables, weights, pools, kw, n_layers):
    """Call rung `rung` of `fns` (attn, full, scan callables) on clones
    of the pools; returns (h_out, k pool, v pool, k scale, v scale)."""
    pools = [p.clone() for p in pools]
    kw = {k: v.clone() for k, v in kw.items()}
    w_in, w_post, wq, wk, wv, wo, wg, wu, wd = weights

    def one(w):
        return (w[0][0], w[1][0]) if isinstance(w, tuple) else w[0]

    if rung == "attn":
        out = fns[0](h, lens, tables, *(one(w) for w in (w_in, wq, wk, wv,
                                                          wo)),
                     *pools, **kw)
    elif rung == "full":
        out = fns[1](h, lens, tables, *(one(w) for w in weights[:2]),
                     *(one(w) for w in weights[2:]), *pools, **kw)
    else:
        out = fns[2](h, lens, tables, w_in, w_post, wq, wk, wv, wo, wg, wu,
                     wd, *pools, n_layers=n_layers, **kw)
    return out[0], pools[0], pools[1], kw.get("k_scale"), kw.get("v_scale")


def _to_f32(x):
    if isinstance(x, tuple):
        return x
    return x.float() if x.is_floating_point() else x


_MK_RUNGS = {"attn": "decode_layer_megakernel",
             "full": "decode_layer_megakernel_full",
             "scan": "decode_layers_megakernel"}


def _mk_fns(plain):
    from paddle_tpu_torch.kernels import decode_megakernel as mk

    sfx = "_reference" if plain else ""
    return tuple(getattr(mk, name + sfx) for name in _MK_RUNGS.values())


def _check_megakernel(dev, rung, dtype, weights, pools, later_rms=False,
                      **case):
    """Launch rung `rung` once on a `_mk_case` and hold it against its
    plain version (test_decode_megakernel's bars); returns (the kernel's
    outputs, the case). `later_rms`: on bf16 activations a later layer's
    commit pages (scan) are held to chip_smoke's rule for them instead
    (they come from hidden states that already differ by rounding): no
    further from the f32 plain version's than the bf16 plain version's
    are, x1.25 + 1e-3, relative RMS; the first layer's keep the one-step
    bar, and f32 activations keep it on every layer."""
    L = 2 if rung == "scan" else 1
    ops = _mk_case(dev, dtype, weights == "int8", pools == "int8", L, **case)
    h, lens, tables, ws, pl, kw = ops
    name = _MK_RUNGS[rung] + ("_int8" if pools == "int8" else "")
    got = _launched(name, lambda: _mk_call(rung, _mk_fns(False), *ops, L))
    ref = _mk_call(rung, _mk_fns(True), *ops, L)
    assert torch.isfinite(got[0].float()).all()
    ref32 = _mk_call(rung, _mk_fns(True), h.float(), lens, tables,
                     [_to_f32(w) for w in ws], [_to_f32(p) for p in pl], kw,
                     L)

    def rel(a, want):
        return float((a.float() - want).pow(2).mean().sqrt()
                     / want.pow(2).mean().sqrt())

    if dtype == torch.float32:
        torch.testing.assert_close(got[0], ref[0], atol=1e-4, rtol=1e-4)
    else:
        assert rel(got[0], ref32[0]) <= 1.25 * rel(ref[0], ref32[0]) + 1e-3
    first = pl[0].shape[0] // L          # pages of the first layer
    for i, (a, r) in enumerate(((got[1], ref[1]), (got[2], ref[2]))):
        diff = (a != r).flatten(1).any(1)
        assert diff.sum() <= L * lens.numel()       # commit pages only
        if later_rms and dtype != torch.float32 and bool(diff[first:].any()):
            later = diff.clone()
            later[:first] = False
            diff[first:] = False
            want = ref32[1 + i][later].float()
            if pools == "int8":
                sc = ref32[3 + i][later][..., None, None]
                want = want * sc
                e_k = rel(a[later].float() * got[3 + i][later][..., None, None],
                          want)
                e_p = rel(r[later].float() * ref[3 + i][later][..., None, None],
                          want)
            else:
                e_k, e_p = rel(a[later], want), rel(r[later], want)
            assert e_k <= 1.25 * e_p + 1e-3, (e_k, e_p)
        err = (a[diff].float() - r[diff].float()).abs()
        if pools == "int8":
            assert (err <= 1).all()
        else:
            bad = err > 2.0 ** -7 * r[diff].float().abs().clamp(min=1.0)
            # name the pages and the head's channels that moved
            assert not bad.any(), (diff.nonzero()[:, 0].tolist(), sorted(set(
                bad.nonzero()[:, -1].tolist())))
    if pools == "int8":
        torch.testing.assert_close(got[3], ref[3], rtol=1e-2, atol=1e-6)
        torch.testing.assert_close(got[4], ref[4], rtol=1e-2, atol=1e-6)
    return got, ops


@pytest.mark.parametrize("pools", ["float", "int8"])
@pytest.mark.parametrize("weights", ["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rung", ["attn", "full", "scan"])
def test_decode_megakernel(dev, rung, dtype, weights, pools):
    """The kernel against its plain version on the same operands. f32:
    within 1e-4. bf16: h no further from the plain version run in f32
    than the bf16 plain version is (x1.25 + 1e-3, relative RMS); both
    versions commit the same pages, every other page byte-identical,
    committed values within one bf16 step (int8: one integer step, scales
    within 1e-2 relative)."""
    _check_megakernel(dev, rung, dtype, weights, pools)


@pytest.mark.parametrize("pools", ["float", "int8"])
@pytest.mark.parametrize("weights", ["dense", "int8"])
@pytest.mark.parametrize("rung", ["attn", "full", "scan"])
def test_decode_megakernel_deterministic(dev, rung, weights, pools):
    """Two launches on the same operands (pools cloned) give bitwise
    equal hidden states, pools and scales: every sum has a fixed order
    (the K splits' and the attention splits' partials meet in split
    order, no float atomics)."""
    got, ops = _check_megakernel(dev, rung, torch.bfloat16, weights, pools)
    L = 2 if rung == "scan" else 1
    again = _mk_call(rung, _mk_fns(False), *ops, L)
    for a, r in zip(got, again):
        if a is not None:
            assert torch.equal(a, r)


@pytest.mark.parametrize("weights", ["dense", "int8"])
@pytest.mark.parametrize("rung", ["attn", "full", "scan"])
def test_decode_megakernel_structured(dev, rung, weights):
    """One-hot rows of h and projections whose channel n holds (n % 64 -
    32) / 64: a tile-map or ldmatrix.trans error moves channels of the
    committed k / v, which the failure names."""
    _check_megakernel(dev, rung, torch.bfloat16, weights, "float",
                      structured=True)


@pytest.mark.parametrize("b", [1, 9, 16])
@pytest.mark.parametrize("weights", ["dense", "int8"])
@pytest.mark.parametrize("rung", ["attn", "full", "scan"])
def test_decode_megakernel_rows(dev, rung, weights, b):
    """One row, nine (the second n8 tile of the products) and the
    kernel's sixteen; the second layer's commits of scan by chip_smoke's
    rule for later layers."""
    _check_megakernel(dev, rung, torch.bfloat16, weights, "float", b=b,
                      later_rms=True)
    _check_megakernel(dev, rung, torch.float32, weights, "int8", b=b,
                      later_rms=True)


@pytest.mark.parametrize("w", [9, 128], ids=["tile-pieces", "long-pieces"])
@pytest.mark.parametrize("pools", ["float", "int8"])
def test_decode_megakernel_split_edges(dev, pools, w):
    """lens on page edges (a tile's last position and the next one's
    first, a page boundary where the commit opens a fresh page, a row
    frozen at its table's end), with phase 2's tiles fewer than the
    grid's blocks (pieces of one tile) and, over tables of 128 pages, more
    (pieces of several tiles that start and end inside rows)."""
    from paddle_tpu_torch.kernels import decode_megakernel as mk

    b, nkv, bs = 8, 2, 16
    lens = [0, bs - 1, bs, bs + 1, 2 * bs, 1, 5 * bs - 1, w * bs]
    if w > 9:
        lens[5:7] = [(w // 2) * bs + 3, (w - 3) * bs - 1]
    grid = mk.card_geometry(
        dev, L=1, b=b, H=256, F=512, nh=8, nkv=nkv, dh=64, bs=bs, W=w,
        pages=b * w + 1, mlp=True, quant_w=True, quant_kv=pools == "int8",
        dtype=torch.bfloat16)["grid"]
    tiles = nkv * sum(min(w, -(-n // bs)) for n in lens)
    assert (tiles > grid) == (w > 9)
    pieces = mk.megakernel_attention_pieces(lens, w, bs, nkv, grid)
    assert max(len(p) for p in pieces.values()) > 2     # merges happen
    for rung in ("full", "scan"):
        _check_megakernel(dev, rung, torch.bfloat16, "int8", pools, b=b,
                          w=w, lens=lens, later_rms=True)


@pytest.mark.parametrize("rung", ["attn", "full", "scan"])
def test_decode_megakernel_smem_at_llama3_8b(dev, rung):
    """At Llama-3-8B's widths (H 4096, Hq 32, Hkv 8, D 128, F 14336,
    pages of 64) the launch's shared memory, as the kernel computes it,
    equals the wrapper's smem_bytes (the planner's number, taken on meta
    tensors), and fits, for B 1, 8, 16, both weight kinds, both pools;
    the grid holds at least a block an SM and the scratch the plan asks
    for holds phase 2's partials."""
    from paddle_tpu_torch.kernels import decode_megakernel as mk

    mlp = rung != "attn"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (1, 8, 16):
        for quant_w in (False, True):
            for q8 in (False, True):
                geo = mk.card_geometry(
                    dev, L=2 if rung == "scan" else 1, b=b, H=4096,
                    F=14336 if mlp else 0, nh=32, nkv=8, dh=128, bs=64,
                    W=17, pages=137, mlp=mlp, quant_w=quant_w, quant_kv=q8,
                    dtype=torch.bfloat16)
                want = mk.smem_bytes(b, 4096, 32, 8, 128, 64, quant_w, q8,
                                     torch.bfloat16)
                assert geo["smem"] == want <= mk.CARD_SMEM_BYTES
                assert geo["grid"] >= sms
                assert geo["partial_floats"] >= (geo["grid"] + b * 8) * (
                    4 * 128 + 8)
                assert geo["counters"] >= b * 8


def test_decode_megakernel_refuses_the_tp_seam(dev):
    from paddle_tpu_torch.kernels import decode_megakernel as mk

    h, lens, tables, ws, pl, kw = _mk_case(dev, torch.bfloat16, False,
                                           False, 1)
    one = [w[0] for w in ws]
    args = (h, lens, tables, one[0], *one[2:6], *pl)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mk.decode_layer_megakernel(*args, residual=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mk.decode_layer_megakernel(*args, residual=False, quantize_out=True)


def test_megakernel_engine_int4_steps_down_and_scan_serves(dev):
    """A packed-int4 engine asked for 'scan' warns once per rung and
    serves 'off' (the int4 GEMV, no megakernel); an int8-weight engine
    at 'scan' launches one decode_layers_megakernel per decode step."""
    from paddle_tpu_torch.models import (LlamaConfig,
                                         init_quant_serving_params)
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, intermediate_size=512)
    kw = dict(slots=2, prompt_bucket=64, max_prompt_len=64,
              max_new_tokens=9, block_size=64, steps_per_sync=4,
              decode_megakernel="scan", device=dev)
    p4 = init_quant_serving_params(cfg, "weight_only_int4", device=dev)
    with pytest.warns(UserWarning, match="decode_megakernel rung") as rec:
        eng = ContinuousBatchingEngine(cfg, p4, **kw)
    assert eng.megakernel_rung == "off"
    assert len([r for r in rec if "rung" in str(r.message)]) == 3
    p8 = init_quant_serving_params(cfg, "weight_only_int8", device=dev)
    for params, mega in ((p4, 0), (p8, 1)):
        eng = ContinuousBatchingEngine(cfg, params, **kw)
        eng.warm()      # its eager warm-up launches count apart
        _build.reset_launch_counts()
        eng.add_request([3, 4, 5])
        eng.run(max_iters=20)
        torch.cuda.synchronize()
        n = _build.launch_counts()
        assert n["decode_layers_megakernel"] == mega * eng.device_steps * 4
        assert len(eng.finished[0].tokens) == 9


# ---------------------------------------------------------------------------
# the engine's programs as CUDA graphs
# ---------------------------------------------------------------------------

def _graph_model(dev, weights):
    """A small model the kernels take (head_dim 128, widths the
    megakernel takes), bf16 weights from a seed, optionally weight-only."""
    from paddle_tpu_torch.models import (LlamaConfig, decode_params,
                                         init_serving_params)

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, intermediate_size=512,
                           max_position_embeddings=512)
    params = init_serving_params(cfg, seed=0, device=dev)
    if weights != "dense":
        params = decode_params(params, weights)
    return cfg, params


# every prompt bucket up to max_prompt_len 192, and the prefix width of
# the one cached page `_graph_prompts` share: the prefill programs the
# test traffic reaches
WARM = dict(buckets=[64, 128, 192], prefix_widths=[1])


def _graph_engine(dev, cfg, params, graphed=True, **kw):
    """The engine, warmed for the test traffic's buckets; with
    `graphed=False` its programs, prefill programs included, run their
    eager bodies on the card (the yardstick the graphs are held to)."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(cfg, params, **{**dict(
        slots=4, prompt_bucket=64, max_prompt_len=192, max_new_tokens=16,
        block_size=64, steps_per_sync=4, token_budget=64,
        dtype=torch.bfloat16, device=dev), **kw})
    if not graphed:
        eng.graphed = False
    eng.warm(**WARM)
    return eng


def _programs(stats):
    """compile_stats() without the prefill programs' entries."""
    return {k: n for k, n in stats.items() if not k.startswith("prefill:")}


def _graph_prompts(vocab):
    """Two prompts sharing a 64-token head (a cache hit), four cold ones,
    one wider than a 64-token window."""
    rng = np.random.default_rng(17)
    shared = rng.integers(1, vocab, 64).tolist()
    return ([shared + rng.integers(1, vocab, n).tolist() for n in (20, 70)]
            + [rng.integers(1, vocab, n).tolist() for n in (5, 150, 33, 64)])


def _graph_serve(eng, prompts, **run):
    reqs = [eng.add_request(p, max_new=3 + 4 * (i % 4))
            for i, p in enumerate(prompts)]
    eng.run(**run)
    torch.cuda.synchronize()
    assert all(r.done for r in reqs)
    return [list(r.tokens) for r in reqs]


def _pool_pages(eng):
    """Every pool tensor without the scratch page (free rows and window
    pad scatter there with repeated ids, in no defined order; nothing
    attends it)."""
    out = []
    for pool in eng.kcs + eng.vcs:
        for t in (pool if isinstance(pool, tuple) else (pool,)):
            rows = torch.arange(t.shape[0], device=t.device)
            keep = rows % eng.mgr.max_pages != eng.scratch_page
            out.append(t[keep])
    return out


GRAPH_CASES = [
    ("dense", "off", "bf16", False),
    ("dense", "off", "int8", False),
    ("dense", "off", "bf16", True),
    ("dense", "attn", "bf16", False),
    ("weight_only_int8", "full", "bf16", False),
    ("weight_only_int8", "full", "int8", True),
    ("weight_only_int8", "scan", "bf16", False),
    ("weight_only_int4", "off", "bf16", False),
    ("weight_only_int8", "off", "int8", True),
]


@pytest.mark.parametrize("weights,rung,kv,unified", GRAPH_CASES,
                         ids=["-".join(map(str, c)) for c in GRAPH_CASES])
def test_engine_graphs_replay_the_eager_bodies(dev, weights, rung, kv,
                                               unified):
    """The same engine and traffic with its programs (the split path's
    cold and prefix prefill programs included: bf16 and int8 pools, the
    scan rung's layer-major stride) replayed as CUDA graphs and run
    eagerly: identical greedy streams, bitwise-equal pool pages, equal
    launch counts (each replay adds its capture's launches), and
    compile_stats() unchanged by traffic after warm()."""
    cfg, params = _graph_model(dev, weights)
    prompts = _graph_prompts(cfg.vocab_size)
    runs = {}
    for graphed in (True, False):
        eng = _graph_engine(dev, cfg, params, graphed, kv_cache_dtype=kv,
                            decode_megakernel=rung, unified_step=unified)
        assert eng.megakernel_rung == rung
        stats = eng.compile_stats()
        assert _programs(stats) == ({"decode": 1, "unified": 1} if unified
                                    else {"decode": 1})
        prefill = eng._prefill_cache.values()
        assert len(prefill) == (0 if unified else 18)   # 3 x 3 x 2
        _build.reset_launch_counts()
        toks = _graph_serve(eng, prompts)
        runs[graphed] = (toks, _build.launch_counts(), _pool_pages(eng))
        assert eng.compile_stats() == stats
        assert eng.prefix_hit_tokens > 0
        assert (eng._programs["decode"].graph is not None) == graphed
        assert all((p.graph is not None) == graphed for p in prefill)
    (g_toks, g_n, g_pools), (e_toks, e_n, e_pools) = runs[True], runs[False]
    assert g_toks == e_toks
    assert g_n == e_n and any(g_n.values())
    for a, b in zip(g_pools, e_pools):
        assert torch.equal(a, b)
    _build.reset_launch_counts()


def test_sampled_engine_replays(dev):
    """Sampling inside the graphs: top_k=1 leaves one candidate, so the
    sampled stream equals greedy; and each replay advances the engine's
    generator (it is registered with the graphs), so one prompt served
    twice in turn, at temperature 1 over the whole vocabulary, draws two
    different streams of in-vocabulary tokens."""
    cfg, params = _graph_model(dev, "dense")
    prompts = _graph_prompts(cfg.vocab_size)
    greedy = _graph_serve(_graph_engine(dev, cfg, params), prompts)
    top1 = _graph_serve(_graph_engine(dev, cfg, params, do_sample=True,
                                      top_k=1, temperature=0.7, seed=3),
                        prompts)
    assert top1 == greedy
    eng = _graph_engine(dev, cfg, params, do_sample=True, temperature=1.0,
                        seed=5)
    a = _graph_serve(eng, prompts[2:3])[0]
    b = _graph_serve(eng, prompts[2:3])[0]
    assert len(a) == len(b) == 3 and a != b
    assert all(0 <= t < cfg.vocab_size for t in a + b)
    assert eng._programs["decode"].graph is not None


@pytest.mark.parametrize("unified", [False, True], ids=["split", "unified"])
def test_double_buffer_equals_sync(dev, unified):
    """double_buffer=True on the card: the synchronous engine's tokens,
    no fewer chunks, the sync-wait counters in metrics()."""
    cfg, params = _graph_model(dev, "dense")
    prompts = _graph_prompts(cfg.vocab_size)
    sync = _graph_engine(dev, cfg, params, unified_step=unified)
    db = _graph_engine(dev, cfg, params, unified_step=unified,
                       double_buffer=True)
    assert _graph_serve(db, prompts) == _graph_serve(sync, prompts)
    assert db.device_steps >= sync.device_steps
    m = db.metrics()
    assert m["sync_wait_s"] >= 0.0 and m["blocked_syncs"] >= 0
    assert m["compile_stats"] == sync.compile_stats()


def test_failed_capture_raises_with_the_program_name(dev):
    """A body that syncs with the host cannot be captured: capture raises
    naming the program, and the program never runs eagerly in its place.
    In a process of its own: a capture that fails leaves PyTorch's default
    CUDA generator mid-capture, so no later random draw of that process
    works."""
    import subprocess
    import sys
    from pathlib import Path

    code = """if True:
        import torch
        from paddle_tpu_torch.serving.engine import _Program
        prog = _Program("probe", lambda x: (x + float(x.sum()),),
                        (torch.zeros(4, device="cuda"),))
        try:
            prog.capture(torch.cuda.graph_pool_handle(), torch.cuda.Stream())
        except RuntimeError as e:
            assert "capturing the engine's probe" in str(e), e
        else:
            raise AssertionError("capture did not raise")
        assert prog.graph is None and prog.captures == 0
        try:
            prog()
        except RuntimeError as e:
            assert "never captured" in str(e), e
        else:
            raise AssertionError("an uncaptured program ran")
        print("refused")
        """
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "refused" in res.stdout, res.stderr


# ---------------------------------------------------------------------------
# speculative decoding and disaggregation
# ---------------------------------------------------------------------------

# the verify window of 8 slots at spec_k 4: cached lengths with 0, a page
# edge and windows straddling two pages, new lengths 1-5
VERIFY_CACHED = [0, 64, 62, 127, 300, 511, 700, 1381]
VERIFY_NEW = [1, 5, 5, 3, 2, 4, 5, 1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q8", [False, True], ids=["pools", "int8"])
def test_ragged_verify_window(dev, dtype, q8):
    """The ragged kernel at the verify window's shape (b 8, Hq 32, Hkv 8,
    D 128, tn 5): within one bf16 step (1e-5 in f32) of the plain version
    and, on bf16 operands, of the plain twin of its split and merge; pad
    rows exact zeros; two launches bitwise equal."""
    from paddle_tpu_torch.kernels import prefix_prefill as pp
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)

    args = _prefill_inputs(dev, dtype, 8, 5, 32, 8, 128, 64, VERIFY_CACHED,
                           VERIFY_NEW, seed=5)
    kw, name = {}, "ragged_paged_attention"
    if q8:
        (args, kw), name = _q8_args(args), name + "_int8"
    got = _launched(name, lambda: ragged_paged_attention(*args, **kw))
    assert torch.equal(got, ragged_paged_attention(*args, **kw))
    _check_paged_prefill(got, ragged_paged_attention_reference(*args, **kw),
                         VERIFY_NEW, dtype)
    if dtype == torch.bfloat16:
        _within_one_bf16_step(got, pp.split_prefill_reference(*args, **kw))


def _spec_engine(dev, cfg, params, graphed=True, drafter=None, **kw):
    """`_graph_engine` with speculation: the n-gram drafter, or a draft
    model over the target's own weights; `graphed=False` runs the draft
    program eagerly too."""
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          DraftModelDrafter)

    d = DraftModelDrafter(cfg, params) if drafter == "draft" else None
    eng = ContinuousBatchingEngine(cfg, params, **{**dict(
        slots=4, prompt_bucket=64, max_prompt_len=192, max_new_tokens=16,
        block_size=64, steps_per_sync=4, token_budget=64,
        dtype=torch.bfloat16, device=dev,
        speculative="draft" if d is not None else "ngram", spec_k=4,
        drafter=d), **kw})
    if not graphed:
        eng.graphed = False
    eng.warm(**WARM)
    return eng


def _spec_prompts(vocab):
    """`_graph_prompts` plus two prompts of a repeated phrase (n-gram
    drafts)."""
    rng = np.random.default_rng(23)
    phrase = rng.integers(1, vocab, 6).tolist()
    return _graph_prompts(vocab) + [[3] + phrase * 12, [5, 7] + phrase * 20]


SPEC_CASES = [
    ("dense", "off", "bf16", False, "ngram"),
    ("weight_only_int8", "scan", "int8", True, "ngram"),
    ("dense", "off", "int8", False, "draft"),
    ("dense", "attn", "bf16", True, "draft"),
]


@pytest.mark.parametrize("weights,rung,kv,unified,drafter", SPEC_CASES,
                         ids=["-".join(map(str, c)) for c in SPEC_CASES])
def test_spec_graphs_replay_the_eager_bodies(dev, weights, rung, kv, unified,
                                             drafter):
    """The verify window (and a draft model's program) replayed as CUDA
    graphs and run eagerly: identical greedy streams, bitwise-equal pool
    pages, equal launch counts, compile_stats() unchanged by traffic."""
    cfg, params = _graph_model(dev, weights)
    prompts = _spec_prompts(cfg.vocab_size)
    runs = {}
    for graphed in (True, False):
        eng = _spec_engine(dev, cfg, params, graphed, drafter,
                           kv_cache_dtype=kv, decode_megakernel=rung,
                           unified_step=unified)
        stats = eng.compile_stats()
        want = {"decode": 1, "verify": 1}
        want.update({"unified": 1} if unified else {})
        want.update({"draft": 1} if drafter == "draft" else {})
        assert _programs(stats) == want
        _build.reset_launch_counts()
        toks = _graph_serve(eng, prompts)
        runs[graphed] = (toks, _build.launch_counts(), _pool_pages(eng))
        assert eng.compile_stats() == stats
        assert eng.spec_steps > 0 and eng.spec_drafted > 0
        assert (eng._programs["verify"].graph is not None) == graphed
        if drafter == "draft":
            assert (eng._drafter._prog.graph is not None) == graphed
    (g_toks, g_n, g_pools), (e_toks, e_n, e_pools) = runs[True], runs[False]
    assert g_toks == e_toks
    assert g_n == e_n
    ragged = "ragged_paged_attention" + ("_int8" if kv == "int8" else "")
    assert g_n[ragged] > 0
    for a, b in zip(g_pools, e_pools):
        assert torch.equal(a, b)
    _build.reset_launch_counts()


def test_spec_self_acceptance_floor(dev):
    """DraftModelDrafter over the target's own weights, int8 pools: its
    drafts are the decode step's argmax, so a verify window that scores
    the right positions accepts most of them (a wrong window position or
    scatter gives about 0)."""
    cfg, params = _graph_model(dev, "dense")
    eng = _spec_engine(dev, cfg, params, drafter="draft",
                       kv_cache_dtype="int8")
    _graph_serve(eng, _spec_prompts(cfg.vocab_size))
    m = eng.metrics()
    assert m["spec_drafted"] > 0 and m["acceptance_rate"] >= 0.2, m


@pytest.mark.parametrize("unified", [False, True], ids=["split", "unified"])
@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_disaggregated_equals_colocated(dev, unified, spec):
    """disaggregated=True on the card: the same tokens as the engine
    without it, every request handed off once."""
    cfg, params = _graph_model(dev, "dense")
    prompts = _graph_prompts(cfg.vocab_size)
    kw = dict(unified_step=unified, speculative=spec)
    base = _graph_serve(_graph_engine(dev, cfg, params, **kw), prompts)
    eng = _graph_engine(dev, cfg, params, disaggregated=True, **kw)
    assert _graph_serve(eng, prompts) == base
    assert eng.metrics()["prefill_handoffs"] == len(prompts)


def test_speculative_smoke_module(dev):
    """`python -m paddle_tpu_torch.serving.speculative` on the card: exit
    0 with token_match 1.0 and accepted drafts."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.speculative"],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:] + res.stdout
    row = json.loads(res.stdout.strip().splitlines()[-1])
    assert row["token_match"] == 1.0 and row["spec_accepted"] > 0
    assert row["compile_stats"] == {"decode": 1, "unified": 1, "verify": 1}


# ---------------------------------------------------------------------------
# the generation entry points: jit_generate's programs, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sk,hq,hkv,d", [
    (8, 1, 32, 8, 128), (8, 77, 32, 8, 128), (2, 600, 8, 8, 64),
    (4, 333, 4, 1, 128)])
def test_flash_attention_single_query(dev, b, sk, hq, hkv, d):
    """A decode step of generate(): one query row against the Sk keys of
    the concat cache, not causal. The kernel launches (no fallback to the
    plain path), meets the plain twin's bars, and two launches are
    bitwise equal."""
    q, k, v = _flash_inputs(dev, b, 1, sk, hq, hkv, d, seed=sk + d)
    got, lse = _launched("flash_attention_fwd", lambda: flash_attention(
        q, k, v, causal=False, return_lse=True))
    ref, ref_lse = flash_attention_reference(q, k, v, causal=False,
                                             return_lse=True)
    assert (got.float() - ref.float()).abs().max() <= 3e-2
    assert (lse - ref_lse).abs().max() <= 1e-2
    assert torch.equal(got, flash_attention(q, k, v, causal=False))


RAGGED = dict(cache_layout="paged", seq_lens=[100, 37, 64, 99])
# (kwargs, flags, the decode attention kernel launched once a layer a step)
GEN_MODES = [
    ("contiguous", {}, {}, "gqa_decode_attention"),
    ("int8", dict(quant="weight_only_int8"), {}, "gqa_decode_attention"),
    ("int4-quant-only", dict(quant="weight_only_int4",
                             prefill_with_quant=True), {},
     "gqa_decode_attention"),
    ("paged", RAGGED, {}, "paged_decode_attention"),
    ("paged-int8-pools", RAGGED, dict(kv_cache_dtype="int8"),
     "paged_decode_attention_int8"),
    ("paged-full-int8-weights", {**RAGGED, "quant": "weight_only_int8"},
     dict(decode_megakernel="full"), "decode_layer_megakernel_full"),
    ("paged-scan", dict(cache_layout="paged"),
     dict(decode_megakernel="scan"), "decode_layer_megakernel_full"),
]


@pytest.mark.parametrize("kw,flags,attention", [m[1:] for m in GEN_MODES],
                         ids=[m[0] for m in GEN_MODES])
def test_generate_programs_replay_the_eager_bodies(dev, kw, flags, attention):
    """jit_generate's program of each layout, replayed as a CUDA graph and
    run as its eager body: identical tokens and launches; one capture for
    the signature; the flash forward once a layer (the prefill) and the
    decode attention once a layer a step."""
    import warnings

    from paddle_tpu_torch.framework import get_flags, set_flags
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg, params = _graph_model(dev, "dense")
    model = LlamaForCausalLM(cfg).load_params(params)
    ids = torch.tensor(np.random.default_rng(31).integers(
        1, cfg.vocab_size, (4, 100)), device=dev)
    L, max_new = cfg.num_hidden_layers, 12
    old = get_flags(list(flags))
    set_flags(flags)
    try:
        def call():
            return model.jit_generate(ids, max_new_tokens=max_new,
                                      bucket_size=64, **kw)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # scan steps down to full
            call()
            (entry,) = model._jit_gen_cache.values()
            runs = {}
            for graphed in (True, False):
                model._gen_site.graphed = graphed
                _build.reset_launch_counts()
                toks = call()
                torch.cuda.synchronize()
                runs[graphed] = (toks, _build.launch_counts())
    finally:
        set_flags(old)
    (g, g_n), (e, e_n) = runs[True], runs[False]
    assert torch.equal(g, e) and g_n == e_n
    assert entry.captures == 1 and entry.prog.graph is not None
    assert len(model._jit_gen_cache) == 1
    assert g.shape == (4, 100 + max_new)
    assert int(g.max()) < cfg.vocab_size and int(g.min()) >= 0
    assert g_n["flash_attention_fwd"] == L
    assert g_n[attention] == L * (max_new - 1)
    _build.reset_launch_counts()


def test_generate_programs_share_one_site(dev):
    """Four signatures kept alive at once in the model's one graph pool,
    replayed in turn (contiguous, int8, paged, paged int8 weights, then
    again in reverse): every replay gives the tokens of its first call and
    of its eager body, the two int8 signatures hold one quantized set, and
    nothing is captured twice."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg, params = _graph_model(dev, "dense")
    model = LlamaForCausalLM(cfg).load_params(params)
    ids = torch.tensor(np.random.default_rng(37).integers(
        1, cfg.vocab_size, (4, 100)), device=dev)
    kws = [dict(), dict(quant="weight_only_int8"), RAGGED,
           {**RAGGED, "quant": "weight_only_int8"}]

    def call(kw):
        return model.jit_generate(ids, max_new_tokens=8, bucket_size=64,
                                  **kw)

    first = [call(kw) for kw in kws]
    again = [call(kw) for kw in reversed(kws)][::-1]
    model._gen_site.graphed = False
    eager = [call(kw) for kw in kws]
    model._gen_site.graphed = True
    for f, a, e in zip(first, again, eager):
        assert torch.equal(f, a) and torch.equal(f, e)
    progs = list(model._jit_gen_cache.values())
    assert len(progs) == len(kws) == model._gen_site.captures
    assert all(p.captures == 1 and p.prog.graph is not None for p in progs)
    assert progs[1]._weights[-1] is progs[3]._weights[-1]


def test_generate_program_samples_on_the_card(dev):
    """Sampling inside a generation graph: the program's generator is
    registered with the graph and reseeded every call, so one seed gives
    one stream, draw for draw the program's eager body's for that seed,
    and another seed another, with no new capture. (top_k=1 against
    greedy is the CPU test's: bf16 logits tie often enough at the top
    that the two may pick different tied tokens.)"""
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg, params = _graph_model(dev, "dense")
    model = LlamaForCausalLM(cfg).load_params(params)
    ids = torch.tensor(np.random.default_rng(35).integers(
        1, cfg.vocab_size, (4, 64)), device=dev)
    kw = dict(max_new_tokens=10, bucket_size=64, do_sample=True, top_k=5,
              temperature=1.0)
    a, b, c = (model.jit_generate(ids, seed=s, **kw) for s in (9, 9, 10))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < cfg.vocab_size
    (entry,) = model._jit_gen_cache.values()
    model._gen_site.graphed = False
    assert torch.equal(model.jit_generate(ids, seed=9, **kw), a)
    model._gen_site.graphed = True
    assert entry.captures == 1 and entry.prog.graph is not None


def test_generate_on_the_card(dev):
    """generate(): a forward a token over the concat caches (the flash
    forward once a layer each: the prompt, then Sq 1 non-causal steps);
    its first token is jit_generate's (the same prompt forward when the
    prompt fills its bucket)."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg, params = _graph_model(dev, "dense")
    model = LlamaForCausalLM(cfg).load_params(params)
    ids = torch.tensor(np.random.default_rng(33).integers(
        1, cfg.vocab_size, (2, 128)), device=dev)
    _build.reset_launch_counts()
    out = model.generate(ids, max_new_tokens=6)
    torch.cuda.synchronize()
    n = _build.launch_counts()
    assert out.shape == (2, 134)
    assert n["flash_attention_fwd"] == cfg.num_hidden_layers * 6
    assert torch.equal(out[:, :128], ids)
    jit = model.jit_generate(ids, max_new_tokens=6, bucket_size=64)
    assert torch.equal(out[:, 128], jit[:, 128])
    _build.reset_launch_counts()


# ---------------------------------------------------------------------------
# training: flash backward, SwiGLU, one train step
# ---------------------------------------------------------------------------

def _rel_rms(a, b):
    a, b = a.float(), b.float()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def _no_worse_than_plain(kernel, plain, ref32, what):
    """The rule of chip_smoke.py's phases 2-3: the kernel's relative RMS
    distance from the f32 plain result is at most 1.25x the bf16 plain
    version's, plus 1e-3 (both round at other places)."""
    e_k, e_p = _rel_rms(kernel, ref32), _rel_rms(plain, ref32)
    assert torch.isfinite(kernel.float()).all(), what
    assert e_k <= 1.25 * e_p + 1e-3, (what, e_k, e_p)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 200, 333, 32, 8, 128, True),    # ragged tiles, Sq < Sk, D 128
    (2, 256, 256, 16, 4, 128, True),    # bench.py's heads (opt-in smem)
    (2, 64, 64, 8, 8, 64, True),        # group 1, D 64
    (1, 77, 77, 4, 1, 128, False),      # MQA, not causal
    (1, 100, 300, 8, 2, 64, False),     # not causal, Sq < Sk
])
def test_flash_attention_backward(dev, b, sq, sk, hq, hkv, d, causal):
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_delta, flash_attention_bwd_delta_reference,
        flash_attention_bwd_dkv, flash_attention_bwd_dq)

    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(b, sq, hq, d, generator=g, device=dev)
    k = torch.randn(b, sk, hkv, d, generator=g, device=dev)
    v = torch.randn(b, sk, hkv, d, generator=g, device=dev)
    do = torch.randn(b, sq, hq, d, generator=g, device=dev)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    scale = d ** -0.5
    out, lse = flash_attention(*bf[:3], causal=causal, return_lse=True)
    dq = _launched("flash_attention_bwd_dq", lambda: flash_attention_bwd_dq(
        *bf[:3], out, lse, bf[3], causal, scale))
    dk, dv = _launched("flash_attention_bwd_dkv",
                       lambda: flash_attention_bwd_dkv(
                           *bf[:3], out, lse, bf[3], causal, scale))
    # deterministic: two launches bitwise equal
    dk2, dv2 = flash_attention_bwd_dkv(*bf[:3], out, lse, bf[3], causal,
                                       scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, flash_attention_bwd_dq(*bf[:3], out, lse, bf[3],
                                                  causal, scale))
    # the backward kernels' delta pre-pass against its plain twin (f32,
    # the same products summed in another order)
    delta = _launched("flash_attention_bwd_delta",
                      lambda: flash_attention_bwd_delta(out, bf[3]))
    # dq and dkv with the pre-pass's delta handed in equal the calls that
    # launch it themselves, bitwise
    assert torch.equal(dq, flash_attention_bwd_dq(
        *bf[:3], out, lse, bf[3], causal, scale, delta=delta))
    assert all(torch.equal(a, c) for a, c in zip(
        (dk, dv), flash_attention_bwd_dkv(*bf[:3], out, lse, bf[3], causal,
                                          scale, delta=delta)))
    torch.testing.assert_close(
        delta, flash_attention_bwd_delta_reference(out, bf[3]), atol=1e-4,
        rtol=1e-5)
    # the plain backward in bf16 (same out / lse) and in f32 (f32 forward)
    from paddle_tpu_torch.kernels.flash_attention import (
        _plain_bwd, flash_attention_reference)
    plain = _plain_bwd(*bf[:3], out, lse, bf[3], causal, scale)
    f32 = [t.float() for t in bf]
    out32, lse32 = flash_attention_reference(*f32[:3], causal, scale, True)
    ref32 = _plain_bwd(*f32[:3], out32, lse32, f32[3], causal, scale)
    for name, got, p, r in zip(("dq", "dk", "dv"), (dq, dk, dv), plain,
                               ref32):
        assert got.shape == p.shape and got.dtype == torch.bfloat16
        _no_worse_than_plain(got, p, r, name)


def _moved(got, ref):
    """Where two [M, F] results differ beyond one bf16 step: the count and
    the first rows and columns, to tell a swizzle or transpose fault from
    noise."""
    g, r = got.float(), ref.float()
    bad = (g - r).abs() > 2.0 ** -7 * r.abs().clamp(min=1.0)
    rows = bad.any(1).nonzero().flatten()[:8].tolist()
    cols = bad.any(0).nonzero().flatten()[:8].tolist()
    return int(bad.sum()), rows, cols


@pytest.mark.parametrize("m,k,f,one_hot", [
    pytest.param(512, 512, 512, False, id="512-512-512"),
    pytest.param(1024, 2048, 1536, False, id="1024-2048-1536"),
    pytest.param(512, 4096, 14336, False, id="512-4096-14336"),
    pytest.param(512, 512, 512, True, id="one-hot-512-512-512"),
    pytest.param(1024, 4096, 1536, True, id="one-hot-1024-4096-1536")])
def test_swiglu_kernels(dev, m, k, f, one_hot):
    """Both directions within one bf16 step of their plain versions, and
    two launches bitwise equal. With `one_hot`, row i of x picks k = (7 i
    + 3) mod K, so g and u of row i are rows of Wg and Wu and every output
    has a known source: a fault in the swizzle, the MN-major descriptor or
    the accumulator layout shows as the rows and columns it moved."""
    from paddle_tpu_torch.kernels.swiglu import (swiglu_bwd,
                                                 swiglu_bwd_reference,
                                                 swiglu_fwd,
                                                 swiglu_fwd_reference)

    g = torch.Generator(device=dev).manual_seed(14 if one_hot else 12)
    if one_hot:
        pick = (7 * torch.arange(m, device=dev) + 3) % k
        x = torch.zeros(m, k, device=dev, dtype=torch.bfloat16)
        x[torch.arange(m, device=dev), pick] = 1
        scale = 1.0
    else:
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        scale = k ** -0.5
    wg, wu = ((torch.randn(k, f, generator=g, device=dev) * scale).to(
        torch.bfloat16) for _ in range(2))
    dout = torch.randn(m, f, generator=g, device=dev).to(torch.bfloat16)
    out = _launched("swiglu_fwd", lambda: swiglu_fwd(x, wg, wu))
    ref = swiglu_fwd_reference(x, wg, wu)
    assert _moved(out, ref)[0] == 0, _moved(out, ref)
    dh = _launched("swiglu_bwd", lambda: swiglu_bwd(x, wg, wu, dout))
    for got, ref in zip(dh, swiglu_bwd_reference(x, wg, wu, dout)):
        assert _moved(got, ref)[0] == 0, _moved(got, ref)
    # deterministic: two launches bitwise equal, both directions
    assert torch.equal(out, swiglu_fwd(x, wg, wu))
    assert all(torch.equal(a, c) for a, c in zip(dh, swiglu_bwd(x, wg, wu,
                                                                 dout)))


def test_swiglu_wgmma_probe(dev):
    """One 64 x 128 x 64 tile through the kernel's TMA boxes, descriptors
    and wgmma products against torch.matmul (the test's oracle only; f32
    sums of bf16 products)."""
    lib = _build.library("swiglu")
    g = torch.Generator(device=dev).manual_seed(15)
    a = torch.randn(64, 64, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(64, 128, generator=g, device=dev).to(torch.bfloat16)
    c = torch.empty(64, 128, device=dev)
    code = lib.swiglu_wgmma_probe_launch(a.data_ptr(), b.data_ptr(),
                                         c.data_ptr(), _build.stream_ptr(dev))
    _build.check(lib, code, "swiglu_wgmma_probe")
    torch.cuda.synchronize()
    torch.testing.assert_close(c, a.float() @ b.float(), atol=1e-3,
                               rtol=1e-4)


def test_swiglu_persistent_grid_equals_a_cta_a_tile(dev):
    """The kernel on the wrapper's persistent grid (CTAs walking several
    tiles), on one CTA a tile and on 7 CTAs gives bitwise-equal results."""
    from paddle_tpu_torch.kernels.swiglu import swiglu_fwd

    m, k, f = 2048, 512, 2048
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    wg, wu = ((torch.randn(k, f, generator=g, device=dev) * k ** -0.5).to(
        torch.bfloat16) for _ in range(2))
    want = swiglu_fwd(x, wg, wu)
    lib = _build.library("swiglu")
    for grid in ((m // 128) * (f // 128), 7):
        out = torch.empty_like(want)
        _build.check(lib, lib.swiglu_fwd_launch(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), out.data_ptr(), m,
            k, f, grid, _build.stream_ptr(dev)), "swiglu_fwd")
        assert torch.equal(out, want), grid


def test_training_wrappers_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_dq)
    from paddle_tpu_torch.kernels.swiglu import swiglu_bwd, swiglu_fwd

    x = torch.randn(512, 512, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        swiglu_fwd(x, x, x)                                   # f32
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 512"):
        swiglu_fwd(xb[:500], xb, xb)                          # misaligned
    with pytest.raises(ValueError, match="CUDA device"):
        swiglu_bwd(xb, xb, xb.cpu(), xb)                      # mixed
    q = torch.randn(1, 64, 2, 128, device=dev, dtype=torch.bfloat16)
    out, lse = flash_attention(q, q, q, causal=True, return_lse=True)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bwd_dq(q, q, q, out, lse.cpu(), q, True, 0.1)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_dq(q, q, q, out, lse[:1], q, True, 0.1)


def _tiny_train_model(dev, recompute=False, use_kernels=True, dtype=None):
    """Two layers, head_dim 128, FFN 1024 (512-aligned: fused SwiGLU)."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         init_train_params)

    cfg = LlamaConfig.tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=1024,
                           vocab_size=256, max_position_embeddings=256,
                           fused_swiglu=True, recompute=recompute,
                           dtype="bfloat16")
    params = init_train_params(cfg, seed=3, device=dev, dtype=dtype)
    return LlamaForCausalLM(cfg, use_kernels=use_kernels).load_params(
        params, trainable=True)


def _grads(model, ids, labels):
    from paddle_tpu_torch.models import LlamaPretrainingCriterion

    loss = LlamaPretrainingCriterion()(model(ids), labels)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


def test_tiny_bf16_train_step_kernels_vs_plain(dev):
    g = torch.Generator(device=dev).manual_seed(13)
    ids, labels = (torch.randint(0, 256, (2, 256), generator=g, device=dev)
                   for _ in range(2))
    _build.reset_launch_counts()
    loss, got = _grads(_tiny_train_model(dev), ids, labels)
    torch.cuda.synchronize()
    assert all(_build.launch_counts()[n] for n in (
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "swiglu_fwd",
        "swiglu_bwd"))
    plain_loss, plain = _grads(_tiny_train_model(dev, use_kernels=False),
                               ids, labels)
    _, ref = _grads(_tiny_train_model(dev, use_kernels=False,
                                      dtype=torch.float32), ids, labels)
    assert abs(float(loss.detach()) - float(plain_loss.detach())) < 2e-2
    for name in got:
        _no_worse_than_plain(got[name], plain[name], ref[name], name)


@pytest.mark.parametrize("recompute", [False, True])
def test_train_step_launch_counts(dev, recompute):
    """One make_train_step step of the 2-layer model: each forward kernel
    once per layer (twice with recompute), each backward kernel once (dq,
    dkv and their delta pre-pass), rms_norm twice per layer plus the final
    norm."""
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import make_train_step

    model = _tiny_train_model(dev, recompute=recompute)
    crit = LlamaPretrainingCriterion()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step, p, s = make_train_step(model, lambda lg, lb: crit(lg, lb), None,
                                 optimizer=opt)
    ids = torch.randint(0, 256, (2, 256), device=dev)
    _build.reset_launch_counts()
    loss, p, s = step(p, s, ids, ids)
    torch.cuda.synchronize()
    n = _build.launch_counts()
    fwd = 2 * (2 if recompute else 1)
    assert n["flash_attention_fwd"] == fwd and n["swiglu_fwd"] == fwd
    assert n["flash_attention_bwd_dq"] == n["flash_attention_bwd_dkv"] \
        == n["flash_attention_bwd_delta"] == 2
    assert n["swiglu_bwd"] == 2
    assert n["rms_norm"] == 2 * fwd + 1
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the checkpoint loader, observability and the watchdog on the card
# ---------------------------------------------------------------------------

def _write_safetensors(path, tensors):
    """A safetensors file of `tensors` (name -> tensor, any device), by
    the format's own layout (the card's machine needs no safetensors
    package): u64 header length, JSON header, the bytes."""
    import json
    import struct

    tags = {torch.bfloat16: "BF16", torch.float16: "F16",
            torch.float32: "F32", torch.int8: "I8", torch.uint8: "U8"}
    header, off, blobs = {}, 0, []
    for name, t in tensors.items():
        host = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        header[name] = {"dtype": tags[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + host.numel()]}
        off += host.numel()
        blobs.append(host.numpy().tobytes())
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + b"".join(blobs))


@pytest.mark.parametrize("quant", [None, "weight_only_int8",
                                   "weight_only_int4"])
def test_checkpoint_loader_on_the_card(dev, tmp_path, quant):
    """load_quant_serving_params from an HF-layout file onto the card:
    byte-identical to decode_params of the same bf16 weights, and its
    transient device peak (max allocated over the load, less what was
    allocated before and the loaded set) at most 4x the largest weight's
    f32 bytes."""
    from paddle_tpu_torch.models import (decode_params,
                                         load_quant_serving_params)

    from paddle_tpu_torch.models import LlamaConfig, init_serving_params

    # the lm_head spans four of weight_quantize's 4096-channel blocks, as
    # Llama-3-8B's 128256 do, so the peak is a block's, not the weight's
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, intermediate_size=512,
                           vocab_size=16384)
    params = init_serving_params(cfg, seed=0, device=dev)
    hf = {("model." + k[len("llama."):] if k.startswith("llama.") else k):
          (v.t() if v.ndim == 2 and "embed_tokens" not in k else v)
          for k, v in params.items()}
    path = str(tmp_path / "model.safetensors")
    _write_safetensors(path, hf)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = load_quant_serving_params(cfg, path, quant, device=dev)
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for v in got.values()
               for t in (v if isinstance(v, tuple) else (v,)))
    transient = torch.cuda.max_memory_allocated() - base - held
    assert transient <= 4 * 4 * max(t.numel() for t in params.values())
    want = decode_params(params, quant)
    assert set(got) == set(want)
    for k, w in want.items():
        for a, b in zip(got[k], w) if isinstance(w, tuple) \
                else [(got[k], w)]:
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), k


def test_trace_during_graph_capture_raises(dev):
    """A span, instant, counter or complete emitted while the current
    stream captures a CUDA graph raises TraceUnderJitError before any
    CUDA call, so the capture stays valid and replays."""
    from paddle_tpu_torch.observability import Tracer, TraceUnderJitError

    tr = Tracer()
    x = torch.ones(8, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for emit in (lambda: tr.span("s").__enter__(),
                         lambda: tr.instant("i"),
                         lambda: tr.counter("c", 1),
                         lambda: tr.complete("x", 0, 1)):
                with pytest.raises(TraceUnderJitError):
                    emit()
            y = x * 2
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 2)) and tr.events() == []
    tr.instant("after")
    assert [e["name"] for e in tr.events()] == ["after"]


@pytest.mark.parametrize("unified", [False, True], ids=["split", "unified"])
def test_traced_engine_on_the_card(dev, unified):
    """warm() with a tracer and a registry armed raises nothing and
    records no span (no site sits in a captured body); the traced
    engine's tokens, launches and captures equal an untraced engine's."""
    from paddle_tpu_torch.observability import MetricsRegistry, Tracer

    cfg, params = _graph_model(dev, "dense")
    prompts = _graph_prompts(cfg.vocab_size)
    tr, mt = Tracer(), MetricsRegistry()
    traced = _graph_engine(dev, cfg, params, unified_step=unified,
                           tracer=tr, metrics=mt)
    assert tr.events() == [] and mt.snapshot()["counters"] == {}
    plain = _graph_engine(dev, cfg, params, unified_step=unified,
                          tracer=False, metrics=False)
    runs = []
    for eng in (traced, plain):
        _build.reset_launch_counts()
        runs.append((_graph_serve(eng, prompts), _build.launch_counts(),
                     eng.compile_stats()))
    assert runs[0] == runs[1]
    names = {e["name"] for e in tr.events()}
    assert {"req.enqueue", "req.admit", "prefill.dispatch",
            "decode.dispatch", "decode.sync_wait", "req.retire"} <= names
    assert mt.snapshot()["histograms"]["ttft_s"]["count"] == len(prompts)


@pytest.mark.parametrize("db", [False, True], ids=["sync", "db"])
def test_watchdog_on_a_graphed_engine(dev, db):
    """hang:decode under a deadline on a graphed engine: one victim (the
    lowest live slot) fails, the others' tokens equal an undisturbed
    engine's, and once the hang has elapsed the abandoned thread has
    launched nothing and written no pool."""
    import time

    from paddle_tpu_torch.resilience import chaos

    cfg, params = _graph_model(dev, "dense")
    prompts = _graph_prompts(cfg.vocab_size)
    # every request takes a slot in the first step, so no later admission
    # batches rows differently from the undisturbed run
    want = _graph_serve(_graph_engine(dev, cfg, params, slots=8), prompts)
    eng = _graph_engine(dev, cfg, params, slots=8)
    reqs = [eng.add_request(p, max_new=3 + 4 * (i % 4))
            for i, p in enumerate(prompts)]
    chaos.install("hang:decode:3")
    try:
        t0 = time.perf_counter()
        eng.run(watchdog_timeout=1.0, double_buffer=db)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        pools = [t.clone() for t in eng.kcs + eng.vcs]
        time.sleep(max(0.0, 3.5 - (time.perf_counter() - t0)))
        torch.cuda.synchronize()
    finally:
        chaos.uninstall()
    assert eng.hung_retired == 1
    assert [r.failed for r in reqs] == [True] + [False] * (len(reqs) - 1)
    assert reqs[0].slot == 0
    assert [r.tokens for r in reqs[1:]] == want[1:]
    assert _build.launch_counts() == launches
    assert all(torch.equal(a, b) for a, b in zip(pools, eng.kcs + eng.vcs))


# ---------------------------------------------------------------------------
# the decode fleet: worker threads, a chaos kill, a subprocess worker
# ---------------------------------------------------------------------------

# one-request prefills: a stream's math then does not depend on which
# requests share its worker (the decode chunk's rows are independent)
FLEET_KW = dict(prefill_batch=1, prefix_cache=False)


def _fleet(dev, cfg, params, n_workers, **kw):
    """A fleet of `n_workers` in-process workers over `_graph_engine`'s
    geometry (one shared params dict), each warmed for the test traffic
    before it joins, and its router."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine, Fleet, \
        Router

    def factory(*, metrics, tracer):
        return ContinuousBatchingEngine(cfg, params, **{**dict(
            slots=4, prompt_bucket=64, max_prompt_len=192,
            max_new_tokens=16, block_size=64, steps_per_sync=4,
            dtype=torch.bfloat16, device=dev, metrics=metrics,
            tracer=tracer), **FLEET_KW, **kw})

    fleet = Fleet(factory, heartbeat_s=0.5)
    router = Router(fleet)
    for _ in range(n_workers):
        fleet.add_worker(warm=True, warm_kwargs=WARM)
    return fleet, router


def _gate_ranks(cfg, params, reqs, dev, limit=0.5):
    """Every served token within `limit` logit of the teacher-forced
    bf16 plain forward's argmax."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    for r in reqs:
        ids = torch.tensor([r.prompt + r.tokens[:-1]], device=dev)
        with torch.no_grad():
            rows = plain(ids)[0, len(r.prompt) - 1:].float()
        gen = torch.tensor(r.tokens, device=dev)
        gap = rows.max(-1).values - rows.gather(1, gen[:, None])[:, 0]
        assert float(gap.max()) <= limit, (r.req_id, float(gap.max()))


def test_fleet_worker_threads_replay_the_building_threads_programs(dev):
    """An engine's programs replayed from a thread that did not capture
    them (under the building thread's device, stream and grad mode, as a
    fleet worker runs) give the building thread's streams, launches and pool
    pages; a two-worker fleet over one params dict serves the lone
    engine's streams with compile_stats() steady."""
    import threading

    cfg, params = _graph_model(dev, "dense")
    prompts = _graph_prompts(cfg.vocab_size)
    runs = []
    for threaded in (False, True):
        eng = _graph_engine(dev, cfg, params, **FLEET_KW)
        stats = eng.compile_stats()
        _build.reset_launch_counts()
        if threaded:
            reqs = [eng.add_request(p, max_new=3 + 4 * (i % 4))
                    for i, p in enumerate(prompts)]
            t = threading.Thread(target=eng._on_this_thread_state(eng.run))
            t.start()
            t.join(120)
            assert not t.is_alive()
            torch.cuda.synchronize()
            toks = [list(r.tokens) for r in reqs]
        else:
            toks = _graph_serve(eng, prompts)
        runs.append((toks, _build.launch_counts(), _pool_pages(eng)))
        assert eng.compile_stats() == stats
    (toks, n, pages), (t_toks, t_n, t_pages) = runs
    assert t_toks == toks and t_n == n
    assert all(torch.equal(a, b) for a, b in zip(pages, t_pages))

    fleet, router = _fleet(dev, cfg, params, 2)
    try:
        workers = fleet.live()
        assert all(w.engine.p is params for w in workers.values())
        stats = {wid: w.engine.compile_stats() for wid, w in workers.items()}
        reqs = [router.submit(p, 3 + 4 * (i % 4))
                for i, p in enumerate(prompts)]
        router.join(timeout=120)
    finally:
        fleet.stop()
    assert [r.tokens for r in reqs] == toks
    assert {r.worker_id for r in reqs} == {"w0", "w1"}
    assert {wid: w.engine.compile_stats()
            for wid, w in workers.items()} == stats


def test_fleet_chaos_kill_recovers_on_the_card(dev):
    """kill_worker on one of two graphed workers mid-request: one death,
    the victim's requests requeued with their delivered tokens kept and
    finished on the survivor (re-prefilled, so within the rank gate of a
    plain forward), the others' streams the lone engine's."""
    import time

    from paddle_tpu_torch.resilience import chaos

    cfg, params = _graph_model(dev, "dense")
    prompts = _graph_prompts(cfg.vocab_size)
    # one token a loop step and 64 of them: a step of this model takes a
    # few ms, so the kill one step after w1's first token lands while its
    # requests are in flight
    kw = dict(max_new_tokens=64, steps_per_sync=1)
    eng = _graph_engine(dev, cfg, params, **FLEET_KW, **kw)
    reqs = [eng.add_request(p, max_new=64) for p in prompts]
    eng.run()
    want = [list(r.tokens) for r in reqs]
    fleet, router = _fleet(dev, cfg, params, 2, **kw)
    try:
        reqs = [router.submit(p, 64) for p in prompts]
        target = fleet.workers["w1"]
        deadline = time.monotonic() + 60
        while not any(r.worker_id == "w1" and r.tokens and not r.done
                      for r in reqs):
            assert time.monotonic() < deadline, "no progress on w1"
            time.sleep(0.002)
        chaos.install(f"kill_worker:1@{target.steps + 1}")
        target.join(60)
        assert target.killed
        with router._lock:
            kept = {r.req_id: list(r.tokens)
                    for r in router._dispatched.get("w1", {}).values()}
        router.join(timeout=120)
    finally:
        chaos.uninstall()
        fleet.stop()
    m = router.metrics()
    assert (m["worker_deaths"], m["poison_failed"]) == (1.0, 0.0)
    assert m["requeued"] >= 1 and "w1" in fleet.fenced
    assert fleet.deaths[0]["reason"] == "chaos_kill"
    assert any(kept.values())
    for r, w in zip(reqs, want):
        assert r.state == "finished" and len(r.tokens) == 64
        if r.kills:
            assert r.tokens[:len(kept[r.req_id])] == kept[r.req_id]
        else:
            assert r.tokens == w
    _gate_ranks(cfg, params, [r for r in reqs if r.kills], dev)


def test_fleet_captures_beside_replays_keep_the_streams(dev):
    """Captures while another worker serves: w0 is warmed for the 64-token
    bucket only, so its first 128- and 192-token prompts capture their
    prefill graphs at first use, and w1 joins with warm=True once w0
    holds in-flight work. Both hold the card's device gate, so every
    stream is the lone engine's (one-request prefills)."""
    import time

    cfg, params = _graph_model(dev, "dense")
    prompts = _graph_prompts(cfg.vocab_size)
    kw = dict(max_new_tokens=64, steps_per_sync=1)
    eng = _graph_engine(dev, cfg, params, **FLEET_KW, **kw)
    reqs = [eng.add_request(p, max_new=64) for p in prompts]
    eng.run()
    want = [list(r.tokens) for r in reqs]
    fleet, router = _fleet(dev, cfg, params, 0, **kw)
    try:
        w0 = fleet.workers[fleet.add_worker(
            warm=True, warm_kwargs=dict(WARM, buckets=[64]))]
        stats = w0.engine.compile_stats()
        reqs = [router.submit(p, 64) for p in prompts]
        deadline = time.monotonic() + 60
        while not any(r.tokens and not r.done for r in reqs):
            assert time.monotonic() < deadline, "no progress on w0"
            time.sleep(0.002)
        w1 = fleet.add_worker(warm=True, warm_kwargs=WARM)
        router.join(timeout=120)
        torch.cuda.synchronize()
    finally:
        fleet.stop()
    assert len(w0.engine.compile_stats()) > len(stats)
    assert fleet.workers[w1].gate is w0.gate
    assert [r.tokens for r in reqs] == want


def test_subprocess_serve_worker_on_the_card(dev, tmp_path):
    """A FileStore serve_worker on --device cuda (weights from the same
    seed, the same geometry) serves every request within the rank gate
    of a plain forward over the same weights and drains to exit code 0;
    the fleet smoke CLI runs on the card under a kill_worker fault."""
    import json
    import os
    import subprocess
    import sys

    from paddle_tpu_torch.resilience.store import FileStore
    from paddle_tpu_torch.serving import Fleet, Router

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PYTHONPATH": repo}
    cfg, params = _graph_model(dev, "dense")
    prompts = _graph_prompts(cfg.vocab_size)
    over = dict(hidden_size=256, num_attention_heads=2,
                num_key_value_heads=1, intermediate_size=512,
                max_position_embeddings=512)
    args = ["--model", "tiny", "--config", json.dumps(over), "--device",
            "cuda", "--seed", "0", "--slots", "4", "--prompt-bucket", "64",
            "--max-prompt-len", "192", "--max-new", "16", "--block-size",
            "64", "--steps-per-sync", "4", "--warm-buckets", "64", "128",
            "192", "--prefix-widths", "1"]
    fleet = Fleet(lambda **kw: None, store=FileStore(str(tmp_path)),
                  job_id="card", heartbeat_s=0.5)
    router = Router(fleet)
    wid = fleet.add_subprocess_worker(extra_args=args, env=env,
                                      ready_timeout_s=300)
    w = fleet.workers[wid]
    try:
        reqs = [router.submit(p, 3 + 4 * (i % 4))
                for i, p in enumerate(prompts)]
        router.join(timeout=120)
        assert [len(r.tokens) for r in reqs] == \
            [3 + 4 * (i % 4) for i in range(len(prompts))]
        _gate_ranks(cfg, params, reqs, dev)
        fleet.remove_worker(wid, drain=True, timeout=120)
        assert w.proc.returncode == 0
    finally:
        if w.proc.poll() is None:
            w.proc.kill()
            w.proc.wait(timeout=60)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.fleet",
         "--workers", "2", "--requests", "6"], capture_output=True,
        text=True, cwd=repo, timeout=600,
        env={**os.environ, **env, "PADDLE_TPU_CHAOS": "kill_worker:1@6"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["ok"] and row["worker_deaths"] == 1.0


# ---------------------------------------------------------------------------
# the hapi trainer over the resilience runtime on the card
# ---------------------------------------------------------------------------

def test_async_checkpoint_of_card_tensors_snapshots_before_mutation(
        dev, tmp_path):
    """An async save of CUDA tensors mutated in place right after save()
    returns restores the values from before (the device-to-host snapshot
    is taken inside save())."""
    from paddle_tpu_torch.resilience import CheckpointManager

    g = torch.Generator(device=dev).manual_seed(17)
    w = torch.randn(1024, 1024, generator=g, device=dev)
    m = torch.randn(4096, generator=g, device=dev, dtype=torch.bfloat16)
    before = {"w": w.cpu().clone(), "m": m.cpu().clone()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"w": w, "m": m}, step=1, blocking=False)
    w.add_(1.0)
    m.mul_(3.0)
    mgr.wait()
    ck = mgr.restore()
    assert torch.equal(ck.value["w"], before["w"])
    assert torch.equal(ck.value["m"], before["m"])


def test_bf16_checkpoint_round_trip_on_the_card(dev, tmp_path):
    from paddle_tpu_torch.resilience import CheckpointManager

    g = torch.Generator(device=dev).manual_seed(18)
    state = {"bf16": torch.randn(257, 33, generator=g, device=dev,
                                 dtype=torch.bfloat16),
             "i64": torch.arange(7, device=dev),
             "f32": torch.randn(5, generator=g, device=dev)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=3)
    got = mgr.restore().value
    for k, t in state.items():
        assert got[k].dtype == t.dtype and got[k].device.type == "cpu"
        assert torch.equal(got[k].to(dev), t), k


def _hapi_tiny(dev, seed=3):
    """A 2-layer Llama of head_dim 128 on the card through hapi.Model,
    with AdamW over the structural names."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion,
                                         init_train_params)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=1024,
                           vocab_size=256, max_position_embeddings=256,
                           dtype="bfloat16")
    net = LlamaForCausalLM(cfg).load_params(
        init_train_params(cfg, seed=seed, device=dev), trainable=True)
    model = hapi.Model(net)
    model.prepare(optimizer=AdamW(1e-3, parameters=net.named_parameters()),
                  loss=LlamaPretrainingCriterion())
    return model


def _hapi_batches(n, seed=19):
    g = torch.Generator().manual_seed(seed)
    return [tuple(torch.randint(0, 256, (2, 256), generator=g)
                  for _ in range(2)) for _ in range(n)]


def test_hapi_fit_launches_the_training_kernels_exactly(dev):
    """fit on the card: per train step one flash forward and one of each
    backward kernel per layer, rms_norm twice a layer plus the final
    norm; per eval / predict batch the forward kernels only."""
    model = _hapi_tiny(dev)
    batches = _hapi_batches(3)
    _build.reset_launch_counts()
    model.fit(batches, epochs=1, verbose=0)
    torch.cuda.synchronize()
    n = _build.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_delta"):
        assert n[name] == 2 * 3, (name, n)
    assert n["rms_norm"] == 5 * 3 and n["swiglu_fwd"] == 0, n
    _build.reset_launch_counts()
    logs = model.evaluate(batches[:2], verbose=0)
    out = model.predict([(batches[0][0],)])
    n = _build.launch_counts()
    assert n["flash_attention_fwd"] == 2 * 3 and n["rms_norm"] == 5 * 3, n
    assert n["flash_attention_bwd_dq"] == 0 and n["flash_attention_bwd_dkv"] \
        == 0 and n["flash_attention_bwd_delta"] == 0, n
    assert np.isfinite(logs["loss"][0])
    assert out[0][0].dtype == np.float32 and out[0][0].shape == (2, 256, 256)


def test_hapi_resumed_step_is_bitwise_the_live_one(dev, tmp_path):
    """A fresh model and optimizer resumed from fit's generation hold the
    live ones' bytes, and the next step gives the live step's loss and
    parameters bitwise."""
    batches = _hapi_batches(4)
    live = _hapi_tiny(dev)
    live.fit(batches, epochs=1, verbose=0, checkpoint_dir=str(tmp_path),
             checkpoint_freq=4)
    fresh = _hapi_tiny(dev, seed=4)
    ids = [id(p) for p in fresh.network.parameters()]
    fresh.fit(batches, epochs=1, verbose=0, checkpoint_dir=str(tmp_path),
              resume=True)
    assert fresh.restored_generation == 1
    assert ids == [id(p) for p in fresh.network.parameters()]
    x, y = batches[0]
    a = live.train_batch([x], [y])[0]
    b = fresh.train_batch([x], [y])[0]
    assert a == b
    for (n, p), (_, q) in zip(live.network.named_parameters(),
                              fresh.network.named_parameters()):
        assert torch.equal(p, q), n


# ---------------------------------------------------------------------------
# the kernel operators, the static audits and the shared-memory loader
# ---------------------------------------------------------------------------

def test_kernel_operators_record_into_a_cuda_graph(dev):
    """The operators' CUDA implementations launch on the capture stream:
    a graph of rms_norm, the flash forward and paged decode replays to
    the eager results, and the launches counted at capture equal one
    eager run's."""
    g = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    x, w = rnd(16, 256), rnd(256)
    q, k, v = rnd(1, 128, 4, 128), rnd(1, 128, 2, 128), rnd(1, 128, 2, 128)
    pools = [rnd(8, 2, 64, 128) for _ in range(2)]
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    lens = torch.tensor([70, 100], dtype=torch.int32, device=dev)
    qd = rnd(2, 4, 128)

    def body():
        return (rms_norm(x, w), flash_attention(q, k, v, causal=True),
                paged_decode_attention(qd, *pools, tables, lens))

    _build.reset_launch_counts()
    eager = body()
    torch.cuda.synchronize()
    counted = _build.launch_counts()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    _build.reset_launch_counts()
    with torch.cuda.graph(graph):
        outs = body()
    assert _build.launch_counts() == counted
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(outs, eager):
        assert torch.equal(a, b)


def _audited_engine(dev):
    cfg, params = _graph_model(dev, "dense")
    return _graph_engine(dev, cfg, params)


def test_audits_allocate_nothing_and_touch_no_tensor(dev):
    """warm()'s audits trace on fakes: the card's allocated bytes, the
    launch counters, the pools and the params are unchanged across
    audit_memory + audit_roofline, and the reports cover every program."""
    eng = _audited_engine(dev)
    torch.cuda.synchronize()
    snap = [t.clone() for t in _pool_pages(eng)]
    weights = {k: (v[0] if isinstance(v, tuple) else v).clone()
               for k, v in eng.p.items()}
    _build.reset_launch_counts()
    before = torch.cuda.memory_allocated(dev)
    mem = eng.audit_memory()
    roof = eng.audit_roofline()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == before
    assert not any(_build.launch_counts().values())
    assert all(torch.equal(a, b) for a, b in zip(_pool_pages(eng), snap))
    assert all(torch.equal((v[0] if isinstance(v, tuple) else v),
                           weights[k]) for k, v in eng.p.items())
    names = set(eng.compile_stats()) - {"draft"}
    assert set(mem["programs"]) == names == set(roof["programs"])
    assert mem["donation_clean"] and roof["device"] == "h100-sxm"


def test_kernel_nodes_equal_one_eager_runs_launches(dev):
    """Each program's kernel nodes equal what one eager run of its body
    adds to the launch counters."""
    from paddle_tpu_torch.analysis import kernel_launches

    cfg, params = _graph_model(dev, "dense")
    eng = _graph_engine(dev, cfg, params, graphed=False)
    graphs = dict(eng._traced_inventory())
    for name, fn, ins in eng._program_inventory():
        _build.reset_launch_counts()
        fn(eng.p, eng.kcs, eng.vcs, *ins)
        torch.cuda.synchronize()
        got = {k: n for k, n in _build.launch_counts().items() if n}
        assert got == kernel_launches(graphs[name]), name


class _CardDS:
    def __len__(self):
        return 32

    def __getitem__(self, i):
        return torch.full((4, 8), float(i), dtype=torch.bfloat16), i


def test_shared_memory_loader_beside_a_cuda_context(dev):
    """Four spawned workers (hidden from the card) feed a process that
    holds a CUDA context; the batches equal the thread loader's and land
    on the card."""
    import multiprocessing as mp

    from paddle_tpu_torch.io import DataLoader

    torch.ones(1, device=dev).sum().item()       # a live context
    procs = list(DataLoader(_CardDS(), batch_size=4, num_workers=4))
    threads = list(DataLoader(_CardDS(), batch_size=4, num_workers=4,
                              use_shared_memory=False))
    assert len(procs) == 8
    for (a, i), (b, j) in zip(procs, threads):
        assert torch.equal(a, b) and torch.equal(i, j)
        assert torch.equal(a.to(dev).cpu(), b)
    assert mp.active_children() == []


# ---------------------------------------------------------------------------
# the static autotuner and the kernel build cache
# ---------------------------------------------------------------------------

def test_autotune_on_the_card_allocates_and_launches_nothing(dev):
    """autotune over every rung and both pool dtypes of the narrow model
    (head_dim 128, 64-token pages) builds and traces each candidate on
    fakes: the card's allocated bytes are unchanged, its peak rises by
    under 256 MiB, no kernel launches, the params are untouched, and the
    winner is no slower than the baseline, which is feasible."""
    import gc

    from paddle_tpu_torch.analysis import autotune, tuner

    cfg, params = _graph_model(dev, "dense")
    kw = dict(slots=4, prompt_bucket=64, max_prompt_len=192,
              max_new_tokens=16, block_size=64, steps_per_sync=4,
              unified_step=False, dtype=torch.bfloat16, device=dev)
    base = tuner.baseline_config(cfg, kw)
    space = {k: [v] for k, v in base.items()}
    space.update(block_size=[32, 64], kv_cache_dtype=["bf16", "int8"],
                 decode_megakernel=["off", "attn", "full", "scan"])
    weights = {k: v.clone() for k, v in params.items()}
    # earlier tests' engines sit in reference cycles: autotune's own
    # collection would free them inside the measured span
    gc.collect()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    peak0 = torch.cuda.max_memory_allocated(dev)
    rep = autotune(cfg, params, engine_kwargs=kw, space=space)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == before
    assert torch.cuda.max_memory_allocated(dev) - peak0 < 256 << 20
    assert not any(_build.launch_counts().values())
    assert all(torch.equal(params[k], weights[k]) for k in weights)
    assert rep.device == "h100-sxm" and rep.n_candidates == 16
    assert rep.baseline.feasible and len(rep.ranking) == 16
    assert rep.best.predicted_step_ms <= rep.baseline.predicted_step_ms


def test_fresh_process_warms_over_the_build_directory_with_no_miss(dev):
    """This process built the kernels; a fresh process warming an engine
    over the same build directory builds nothing: cache_misses 0 and
    cache_hits == compile_requests > 0."""
    import json
    import os
    import subprocess
    import sys

    from paddle_tpu_torch.serving import compile_cache

    _build.library("rms_norm")          # the directory holds every library
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m",
                          "paddle_tpu_torch.serving.restart_probe"],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr[-2000:]
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["persistent_cache_dir"] == compile_cache.cache_dir()
    assert stats["cache_misses"] == 0
    assert stats["cache_hits"] == stats["compile_requests"] \
        == len(_build.SIGNATURES)
