"""The weight-only GEMV's launch plan and the plain twin of its order of
sums, on the CPU, against the port's plain version and the JAX package.

The plan: ``gemv_plan`` is the twin of the CUDA kernel's host plan
(csrc/weight_only_gemv.cu ``make_plan``; a card test holds the two
equal). Its blocks must cover every (channel, k) of the product exactly
once -- ragged N, every M class from 1 to 64, K multiples of 32 that
split unevenly over the stages and the ranks -- within the kernel's
limits (at most 8 A tiles a block, clusters of 1 or 2, a grid.y and a
shared memory the card takes), and at the shapes of a Llama-3-8B decode
step it must put blocks on all 132 SMs of an H100 in whole waves (k / v
on 128: see the test).

The split twin: ``weight_only_split_reference`` (one f32 partial per
block and k group, k groups then K ranks summed in order, the f32 scale,
one rounding) against the port's plain version and the JAX package's
(the int4 Pallas kernel in interpret mode, as
tests/test_torch_weight_quant.py runs it; ``_mm``'s int8 branch) on the
same bf16 inputs made with numpy. All three sum exact integer weights
times bf16 x in f32, in different orders, and round once to bf16, so
they may differ by one bf16 rounding step: |a - b| <= 2^-7 * max(|b|, 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import int4_matmul as jim
from paddle_tpu.models import llama as jl
from paddle_tpu.nn import quant as jq
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.int4_matmul import (
    ATILE, MAX_CLUSTER, MAX_CT, GemvPlan, gemv_blocks, gemv_plan,
    int4_matmul, int4_matmul_reference, int8_weight_matmul,
    int8_weight_matmul_reference, weight_only_split_reference)

H100_SMS = 132
# the card's shared memory a block may opt into (bytes)
SMEM_LIMIT = 232448
# (K, N) of a Llama-3-8B decode step: gate / up, q / o, k / v, down, lm_head
STEP_SHAPES = [(4096, 14336), (4096, 4096), (4096, 1024), (14336, 4096),
               (4096, 128256)]
QUANTS = ["weight_only_int4", "weight_only_int8"]


def _check_cover(plan: GemvPlan):
    """Every (channel, k) of [0, N) x [0, K) lies in exactly one block:
    the groups cut N into contiguous channel ranges, the ranks of each
    group cut K into contiguous k ranges."""
    blocks = list(gemv_blocks(plan))
    assert len(blocks) == plan.groups * plan.cluster
    chans = sorted({(b.c0, b.c1) for b in blocks})
    assert len(chans) == plan.groups
    assert chans[0][0] == 0 and chans[-1][1] == plan.n
    for (_, c1), (c0, _) in zip(chans, chans[1:]):
        assert c1 == c0
    for c0, c1 in chans:
        assert 0 < c1 - c0 <= MAX_CT * ATILE
        ks = sorted((b.k0, b.k1) for b in blocks if (b.c0, b.c1) == (c0, c1))
        assert len(ks) == plan.cluster
        assert ks[0][0] == 0 and ks[-1][1] == plan.k
        for (_, k1), (k0, _) in zip(ks, ks[1:]):
            assert k1 == k0
    # the channels and k counted cell by cell
    cover = np.zeros((plan.n, plan.k), np.int32)
    if plan.n * plan.k <= 4_000_000:
        for b in blocks:
            cover[b.c0:b.c1, b.k0:b.k1] += 1
        assert (cover == 1).all()
    # the kernel's limits
    assert 1 <= plan.cluster <= MAX_CLUSTER == 2
    assert plan.groups <= 65535
    assert plan.smem <= SMEM_LIMIT
    assert plan.row_tiles == -(-plan.m // 8)
    for b in blocks:
        ct = -(-(b.c1 - b.c0) // ATILE)
        assert 1 <= b.k_groups and ct * b.k_groups <= 8


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("m", [1, 5, 8, 9, 33, 64])
@pytest.mark.parametrize("n,k", [
    (1, 32), (17, 96), (200, 288), (1000, 1056), (4100, 4128),
    (14336, 4096), (4096, 14336), (1024, 4096 + 32)])
def test_plan_covers_every_channel_and_k_once(quant, m, n, k):
    _check_cover(gemv_plan(m, n, k, quant == "weight_only_int4", H100_SMS))


@pytest.mark.parametrize("sms", [1, 3, 8, 114])
@pytest.mark.parametrize("quant", QUANTS)
def test_plan_covers_on_other_cards(quant, sms):
    """Fewer SMs (a smaller card, a test's made-up one): still a partition
    within the kernel's limits."""
    for m, n, k in ((8, 4096, 4096), (64, 1000, 1056), (3, 128256, 4096),
                    (17, 4096, 14336)):
        _check_cover(gemv_plan(m, n, k, quant == "weight_only_int4", sms))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("m", [1, 8, 16, 32, 64])
@pytest.mark.parametrize("k,n", STEP_SHAPES)
def test_plan_fills_every_sm_at_llama3_8b_step_shapes(quant, m, k, n):
    """Every matmul of a decode step puts blocks on all 132 SMs, in whole
    waves of equal blocks (the ranks' and groups' sizes differ by at most
    one stage and one A tile) -- except k / v (N 1024: 64 A tiles), which
    takes 128: each A tile's K in two ranks. The clusters of 3 and 4 that
    would cover all 132 SMs measured slower there (PERF.md §6)."""
    p = gemv_plan(m, n, k, quant == "weight_only_int4", H100_SMS)
    blocks = p.groups * p.cluster
    if n == 1024:
        assert (p.groups, p.cluster) == (64, 2), p
    else:
        assert blocks >= H100_SMS and blocks % H100_SMS == 0, p
    sizes = {(b.c1 - b.c0) for b in gemv_blocks(p)}
    assert max(sizes) - min(sizes) <= ATILE
    _check_cover(p)


@pytest.mark.parametrize("quant", QUANTS)
def test_plan_clusters(quant):
    """At M 8 every step shape but the lm_head splits K over clusters of
    2, two blocks an SM; the lm_head (1056 groups, eight waves) keeps whole
    K. At M 64 gate / up and the lm_head keep whole K: their rings no
    longer fit two to an SM, and one pass of 132 groups costs less."""
    int4 = quant == "weight_only_int4"
    for k, n in STEP_SHAPES:
        want = 1 if n == 128256 else 2
        assert gemv_plan(8, n, k, int4, H100_SMS).cluster == want
    for k, n in ((4096, 14336), (4096, 128256)):
        assert gemv_plan(64, n, k, int4, H100_SMS).cluster == 1


def _jq(w, algo):
    wq, sc = jq.weight_quantize(paddle.to_tensor(w), algo=algo)
    return np.array(wq._array), np.array(sc._array)


def _close(got, want):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape
    assert (np.abs(g - w) <= 2.0 ** -7 * np.maximum(np.abs(w), 1.0)).all(), \
        float(np.abs(g - w).max())


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# plans that split: the card's (132 SMs), one with whole K in few large
# groups (3 SMs: 8 A tiles a block, one k group), and forced clusters of 2
# and 3 over ragged stages
def _plans(m, n, k, int4):
    yield gemv_plan(m, n, k, int4, H100_SMS)
    yield gemv_plan(m, n, k, int4, 3)
    base = gemv_plan(m, n, k, int4, 8)
    for c in (2, 3):        # 3: the twin takes any cluster size
        spr = -(-base.stages // c)
        yield base._replace(cluster=c, stages_per_rank=spr)


@pytest.mark.parametrize("m", [1, 5, 8, 9, 33, 64])
def test_split_twin_int4_matches_plain_and_jax(m):
    """int4: the twin under several plans vs the port's plain version and
    the JAX Pallas kernel (interpret mode) on the same bf16 x."""
    rng = np.random.default_rng(100 + m)
    k, n = 1056, 200          # 4 whole stages + 32 k; 13 A tiles, ragged
    jwq, jsc = _jq(rng.standard_normal((k, n)).astype(np.float32) * 0.05,
                   "weight_only_int4")
    x = _bf16(rng.standard_normal((m, k)))
    want = np.asarray(jim.int4_matmul(jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(jwq), jnp.asarray(jsc))
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    twq, tsc = torch.from_numpy(jwq), torch.from_numpy(jsc)
    plain = int4_matmul_reference(tx, twq, tsc)
    _close(plain, want)
    _build.reset_launch_counts()
    torch.testing.assert_close(int4_matmul(tx, twq, tsc), plain, atol=0,
                               rtol=0)
    assert not any(_build.launch_counts().values())
    for plan in _plans(m, n, k, True):
        got = weight_only_split_reference(tx, twq, tsc, plan)
        assert got.dtype == torch.bfloat16
        _close(got, want)
        _close(got, plain.float().numpy())


@pytest.mark.parametrize("m", [1, 5, 8, 9, 33, 64])
def test_split_twin_int8_matches_plain_and_jax(m):
    """int8: the twin vs the port's plain version and the JAX serving
    matmul's int8 branch (``_mm``, XLA's fused convert + dot)."""
    rng = np.random.default_rng(200 + m)
    k, n = 544, 150           # 4 stages + 32 k of int8; 10 A tiles, ragged
    jwq, jsc = _jq(rng.standard_normal((k, n)).astype(np.float32) * 0.05,
                   "weight_only_int8")
    x = _bf16(rng.standard_normal((m, k)))
    want = np.asarray(jl._mm(jnp.asarray(x, jnp.bfloat16),
                             (jnp.asarray(jwq), jnp.asarray(jsc)))
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    twq, tsc = torch.from_numpy(jwq), torch.from_numpy(jsc)
    plain = int8_weight_matmul_reference(tx, twq, tsc)
    _close(plain, want)
    torch.testing.assert_close(int8_weight_matmul(tx, twq, tsc), plain,
                               atol=0, rtol=0)
    for plan in _plans(m, n, k, False):
        got = weight_only_split_reference(tx, twq, tsc, plan)
        _close(got, want)
        _close(got, plain.float().numpy())


@pytest.mark.parametrize("quant", QUANTS)
def test_split_twin_f32_order_only(quant):
    """In f32 (no rounding step to hide in) the twin differs from the plain
    version only by the order of its f32 sums."""
    rng = np.random.default_rng(7)
    k, n, m = 800, 70, 12
    jwq, jsc = _jq(rng.standard_normal((k, n)).astype(np.float32),
                   quant)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    twq, tsc = torch.from_numpy(jwq), torch.from_numpy(jsc)
    ref = (int4_matmul_reference if quant == "weight_only_int4"
           else int8_weight_matmul_reference)(x, twq, tsc)
    for plan in _plans(m, n, k, quant == "weight_only_int4"):
        got = weight_only_split_reference(x, twq, tsc, plan)
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)


def test_wrapper_takes_k_zero_on_the_cpu():
    """An empty sum is zeros (the card's wrapper returns them without a
    launch)."""
    wq = torch.zeros(5, 0, dtype=torch.int8)
    out = int8_weight_matmul(torch.zeros(3, 0), wq, torch.ones(5))
    assert out.shape == (3, 5) and not out.any()
