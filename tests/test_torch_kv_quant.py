"""The port's int8 paged KV pools against the JAX package, on the CPU.

Kernel functions: the same numpy inputs -- int8 pools with f32
per-(page, kv head) scales -- go through the JAX ``paged_decode_attention``,
``prefix_prefill_attention`` and ``ragged_paged_attention`` with
``k_scale`` / ``v_scale`` (their q8 Pallas kernels in interpret mode, as
tests/test_kv_quant.py runs them) and through the port's functions on CPU
tensors, which run the plain versions. The cases: GQA groups 1, 2 and 4
and full MQA (group 1 at head_dim 128 reaches the equal-heads
``_paged_decode_q8_kernel``), ragged lengths including 0, an empty
prefix, a partial last page and pad rows (exact zeros on both sides).
Tolerance 1e-5 in f32: the same f32 math in another summation order.

Quantization: ``quantize_kv_pages`` and the decode commit
``kv_write_q8`` run op for op as in JAX (absmax in f32, / 127, divide by
the scale, round half to even, clip), so identical f32 inputs must give
identical bytes.

Engines: the port's int8 engine and the JAX int8 engine serve the same
shared-prefix traffic on ``tiny()`` in f32, on the split path with the
prefix cache and on the unified step; greedy tokens must be identical (up
to a JAX near-tie, the rule of tests/test_torch_engine.py) with equal
scheduling counters, and afterwards the pools agree within one int8 step
and the scales within 1e-5 relative. The scratch page is left out of
that comparison: free rows and window pads all write it (repeated page
ids in one scatter, where either framework may keep any of the writes),
and nothing attends it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import decode_attention as jda
from paddle_tpu.kernels import prefix_prefill as jpp
from paddle_tpu.kernels import ragged_attention as jra
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.decode_attention import paged_decode_attention
from paddle_tpu_torch.kernels.prefix_prefill import prefix_prefill_attention
from paddle_tpu_torch.kernels.ragged_attention import ragged_paged_attention
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models import llama as pl
from paddle_tpu_torch.models.llama import PagedKVManager
from paddle_tpu_torch.serving import ContinuousBatchingEngine

NEAR_TIE = 1e-4


def _q8_pools(rng, n_pages, nkv, bs, dh):
    """Two int8 pools and their f32 scales (one page of each pool left
    all-zero with scale 0, as a fresh page is)."""
    out = []
    for _ in range(2):
        pool = rng.integers(-127, 128, (n_pages, nkv, bs, dh)).astype(np.int8)
        sc = rng.uniform(0.005, 0.05, (n_pages, nkv)).astype(np.float32)
        pool[0] = 0
        sc[0] = 0.0
        out += [pool, sc]
    return out   # kc, ksc, vc, vsc


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the kernel functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv,dh", [(4, 4, 16), (4, 4, 128), (4, 2, 16),
                                       (8, 2, 16), (4, 1, 16)],
                         ids=["group1", "group1-equal-heads-kernel",
                              "group2", "group4", "mqa"])
def test_paged_decode_q8_matches_jax(hq, hkv, dh):
    """Ragged lens: 0, mid-page, a page boundary, a row past its table
    (every position valid) and a free row on the all-zero page 0."""
    rng = np.random.default_rng(hq * 10 + hkv + dh)
    n_pages, bs, w = 14, 4, 3
    kc, ksc, vc, vsc = _q8_pools(rng, n_pages, hkv, bs, dh)
    q = rng.standard_normal((5, hq, dh)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.stack([perm[0:w], perm[w:2 * w], perm[2 * w:3 * w],
                       np.zeros(w, np.int64),
                       perm[3 * w:4 * w]]).astype(np.int32)
    lens = np.asarray([0, 6, 8, 0, w * bs + 2], np.int32)
    want = jda.paged_decode_attention(
        *_j(q, kc, vc, tables, lens), k_scale=jnp.asarray(ksc),
        v_scale=jnp.asarray(vsc))
    tq, tk, tv, ttbl, tl, tks, tvs = _t(q, kc, vc, tables, lens, ksc, vsc)
    got = paged_decode_attention(tq, tk, tv, ttbl, tl, k_scale=tks,
                                 v_scale=tvs)
    assert got.dtype == torch.float32 and got.shape == (5, hq, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("b,sb,nh,nkv,blocks,slens", [
    (3, 16, 4, 2, (3, 1, 0), (16, 9, 5)),
    (2, 16, 4, 4, (2, 0), (16, 3)),
    (2, 16, 8, 2, (1, 2), (8, 16)),
    (2, 16, 4, 1, (1, 2), (8, 16)),
], ids=["group2-pad-empty-prefix", "group1", "group4", "mqa"])
def test_prefix_prefill_q8_matches_jax(b, sb, nh, nkv, blocks, slens):
    rng = np.random.default_rng(sum(slens) + nh)
    dh, bs, w = 16, 8, 3
    n_pages = b * w + 2
    kc, ksc, vc, vsc = _q8_pools(rng, n_pages, nkv, bs, dh)
    q, ks, vs = (rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sb, nh, dh), (b, sb, nkv, dh),
                           (b, sb, nkv, dh)))
    tables = (rng.permutation(n_pages - 1)[:b * w].reshape(b, w) + 1
              ).astype(np.int32)
    plens = np.asarray([n * bs for n in blocks], np.int32)
    sl = np.asarray(slens, np.int32)
    want = np.asarray(jpp.prefix_prefill_attention(
        *_j(q, ks, vs, kc, vc, tables, plens, sl),
        k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc)))
    tq, tks_, tvs_, tkc, tvc, ttbl, tpl, tsl, tksc, tvsc = _t(
        q, ks, vs, kc, vc, tables, plens, sl, ksc, vsc)
    got = prefix_prefill_attention(tq, tks_, tvs_, tkc, tvc, ttbl, tpl, tsl,
                                   k_scale=tksc, v_scale=tvsc).numpy()
    for row in range(b):
        assert (got[row, slens[row]:] == 0).all()
        assert (want[row, slens[row]:] == 0).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("cached,new,nh,nkv", [
    ([24, 0, 16, 0], [1, 16, 8, 0], 4, 2),
    ([5, 13, 21], [1, 4, 16], 4, 2),
    ([10, 0, 17], [2, 16, 5], 2, 2),
    ([10, 0, 17], [2, 16, 5], 8, 2),
    ([10, 0, 17], [2, 16, 5], 4, 1),
], ids=["mixed-rows-pad", "partial-last-page", "group1", "group4", "mqa"])
def test_ragged_q8_matches_jax(cached, new, nh, nkv):
    rng = np.random.default_rng(sum(cached) + nh * nkv)
    b, tn, dh, page = len(cached), 16, 16, 8
    w = max(1, -(-max(cached) // page))
    n_pages = 2 * b * w + 2
    kc, ksc, vc, vsc = _q8_pools(rng, n_pages, nkv, page, dh)
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((b, tn, nh, dh), (b, tn, nkv, dh),
                           (b, tn, nkv, dh)))
    tables = (rng.permutation(n_pages - 1)[:b * w].reshape(b, w) + 1
              ).astype(np.int32)
    cl, nl = np.asarray(cached, np.int32), np.asarray(new, np.int32)
    want = np.asarray(jra.ragged_paged_attention(
        *_j(q, kn, vn, kc, vc, tables, cl, nl), k_scale=jnp.asarray(ksc),
        v_scale=jnp.asarray(vsc)))
    tq, tkn, tvn, tkc, tvc, ttbl, tcl, tnl, tksc, tvsc = _t(
        q, kn, vn, kc, vc, tables, cl, nl, ksc, vsc)
    got = ragged_paged_attention(tq, tkn, tvn, tkc, tvc, ttbl, tcl, tnl,
                                 k_scale=tksc, v_scale=tvsc).numpy()
    assert np.isfinite(got).all()
    for row, n in enumerate(new):
        assert (got[row, n:] == 0).all() and (want[row, n:] == 0).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_q8_references_keep_dequantized_pages_in_f32():
    """bf16 queries over int8 pools: the plain versions dequantize in f32
    and never round a dequantized page to bf16, as the JAX references
    (cat_dtype f32). Against the JAX references on the same bf16 inputs,
    both in f32 before the one output rounding: within 1e-5."""
    rng = np.random.default_rng(5)
    b, tn, nh, nkv, dh, page = 2, 8, 4, 2, 16, 8
    kc, ksc, vc, vsc = _q8_pools(rng, 6, nkv, page, dh)
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((b, tn, nh, dh), (b, tn, nkv, dh),
                           (b, tn, nkv, dh)))
    tables = np.asarray([[1, 2], [3, 4]], np.int32)
    cl = np.asarray([13, 16], np.int32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, kn, vn)]
    want = np.asarray(jra.ragged_paged_attention_reference(
        *jb, *_j(kc, vc, tables, cl), k_scale=jnp.asarray(ksc),
        v_scale=jnp.asarray(vsc)))
    tb = [t.to(torch.bfloat16) for t in _t(q, kn, vn)]
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_paged_attention_reference)
    got = ragged_paged_attention_reference(
        *tb, *_t(kc, vc, tables, cl), k_scale=torch.from_numpy(ksc),
        v_scale=torch.from_numpy(vsc))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_q8_argument_checks_match_jax():
    """int8 pools without scales and scales on a float pool raise
    ValueError in every wrapper, as in JAX; CPU tensors launch nothing."""
    rng = np.random.default_rng(2)
    kc, ksc, vc, vsc = _t(*_q8_pools(rng, 4, 2, 8, 16))
    q1 = torch.randn(1, 4, 16)
    q = torch.randn(1, 8, 4, 16)
    kn = torch.randn(1, 8, 2, 16)
    tbl = torch.ones(1, 1, dtype=torch.int32)
    lens = torch.full((1,), 8, dtype=torch.int32)
    calls = [
        lambda **kw: paged_decode_attention(q1, kc, vc, tbl, lens, **kw),
        lambda **kw: prefix_prefill_attention(q, kn, kn, kc, vc, tbl, lens,
                                              **kw),
        lambda **kw: ragged_paged_attention(q, kn, kn, kc, vc, tbl, lens,
                                            **kw),
    ]
    _build.reset_launch_counts()
    for call in calls:
        with pytest.raises(ValueError, match="k_scale / v_scale"):
            call()
        with pytest.raises(ValueError, match="k_scale / v_scale"):
            call(k_scale=ksc)
        assert torch.isfinite(call(k_scale=ksc, v_scale=vsc)).all()
    kf = kc.float()
    with pytest.raises(ValueError, match="only apply to int8"):
        paged_decode_attention(q1, kf, kf, tbl, lens, k_scale=ksc,
                               v_scale=vsc)
    assert not any(_build.launch_counts().values())


# ---------------------------------------------------------------------------
# quantize-on-scatter and the decode commit: byte-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_pages_is_byte_exact(dtype):
    """[b, n_pre, nkv, block, dh] page stacks, one page all zeros (scale
    0, exact zeros), one with a single loud element, and pages whose
    values sit on half steps of their scale (where dividing by the scale
    and multiplying by its reciprocal round apart)."""
    rng = np.random.default_rng(7)
    kv = rng.standard_normal((2, 3, 2, 8, 16)).astype(np.float32) * 3
    kv[0, 1, 0] = 0.0
    kv[1, 2, 1, 3, 5] = 200.0
    for i, amax in enumerate((3.7, 0.013, 91.1)):
        step = np.float32(amax) / np.float32(127.0)
        half = (np.arange(128, dtype=np.float32) - 127.5) * step
        page = rng.permutation(np.concatenate([half, -half]))[:128]
        page[0] = np.float32(amax)
        kv[1, i // 2, i % 2] = page.reshape(8, 16)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    jq, js = jl.quantize_kv_pages(jnp.asarray(kv, jd))
    tq, ts = pl.quantize_kv_pages(torch.from_numpy(kv).to(td))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 1, 0] == 0 and (tq[0, 1, 0] == 0).all()


def test_kv_write_q8_is_byte_exact():
    """A stream of per-token commits through two rows' pages, byte for
    byte against the JAX commit after every token: quiet tokens, a louder
    token growing a page's scale (stored rows rescale), a row frozen past
    its table (clamped page column, re-committing into its last page),
    and a recycled page whose stale large scale the `slot == 0` reset
    drops."""
    rng = np.random.default_rng(11)
    b, nkv, dh, bs, w, n_pages = 2, 2, 16, 4, 3, 8
    tables = np.asarray([[3, 5, 6], [1, 2, 7]], np.int32)
    pools = [np.zeros((n_pages, nkv, bs, dh), np.int8) for _ in range(2)]
    scales = [np.zeros((n_pages, nkv), np.float32) for _ in range(2)]
    # page 5 is "recycled": stale content with a huge scale
    for p, s in zip(pools, scales):
        p[5] = rng.integers(-127, 128, (nkv, bs, dh)).astype(np.int8)
        s[5] = 1e3
    _, jw = jl.make_paged_kv_q8_helpers(b, 0, nkv, dh, bs,
                                        jnp.asarray(tables))
    _, tw = pl.make_paged_kv_q8_helpers(b, 0, nkv, dh, bs,
                                        torch.from_numpy(tables))
    jk = (jnp.asarray(pools[0]), jnp.asarray(scales[0]))
    jv = (jnp.asarray(pools[1]), jnp.asarray(scales[1]))
    tk = tuple(torch.from_numpy(a.copy()) for a in (pools[0], scales[0]))
    tv = tuple(torch.from_numpy(a.copy()) for a in (pools[1], scales[1]))
    lens = np.asarray([0, 0], np.int32)
    for step in range(w * bs + 2):
        k = rng.standard_normal((b, 1, nkv, dh)).astype(np.float32)
        v = rng.standard_normal((b, 1, nkv, dh)).astype(np.float32)
        if step in (2, 5):
            k *= 10.0       # louder than the page's absmax so far
            v *= 10.0
        jk, jv = jw(jk, jv, jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(lens))
        tw(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
           torch.from_numpy(lens))
        for (tp, ts), (jp, js) in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        # row 1 freezes at its table's end (lens == W*bs)
        lens = np.minimum(lens + 1, [w * bs + 5, w * bs])
    assert float(tk[1][5].max()) < 1e3      # the stale scale was reset
    assert float(tk[1][3].max()) > 0


# ---------------------------------------------------------------------------
# the model bodies over int8 pools
# ---------------------------------------------------------------------------

def _setup(nkv=2, seed=21):
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=nkv)
    paddle.seed(seed)
    jm = JaxModel(jcfg)
    raw = dict(jm.raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=nkv)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    return jcfg, jm, raw, cfg, p


@pytest.fixture(scope="module")
def model():
    return _setup()


@pytest.mark.parametrize("body", ["prefix", "chunk"])
def test_window_prefills_over_int8_pools_match_jax(model, body):
    """The cached-prefix suffix prefill and the unified chunk lane over
    (int8 pool, scale) pairs: hidden states within 1e-4, window K/V within
    1e-5 of the JAX functions'."""
    jcfg, _, raw, cfg, p = model
    rng = np.random.default_rng(3)
    n_layers, dh, bs = cfg.num_hidden_layers, cfg.head_dim, 8
    pools = [_q8_pools(rng, 9, 2, bs, dh) for _ in range(n_layers)]
    jk = [(jnp.asarray(a[0]), jnp.asarray(a[1])) for a in pools]
    jv = [(jnp.asarray(a[2]), jnp.asarray(a[3])) for a in pools]
    tk = [tuple(_t(a[0], a[1])) for a in pools]
    tv = [tuple(_t(a[2], a[3])) for a in pools]
    if body == "prefix":
        b, tn = 3, 16
        tbl = np.asarray([[3, 5], [0, 0], [7, 0]], np.int32)
        cached = np.asarray([16, 0, 8], np.int32)
        new = np.asarray([16, 5, 11], np.int32)
        jfn = jl._make_prefill_with_prefix(jcfg, b, tn, 2, bs)
        tfn = pl._make_prefill_with_prefix(cfg, b, tn, 2, bs)
    else:
        b, tn = 1, 16
        tbl = np.asarray([[4, 2, 7, 1]], np.int32)
        cached = np.asarray([13], np.int32)
        new = np.asarray([9], np.int32)
        jfn = jl._make_chunk_prefill(jcfg, tn)
        tfn = pl._make_chunk_prefill(cfg, tn)
    ids = rng.integers(1, cfg.vocab_size, (b, tn))
    jh, jkvs = jfn(raw, jk, jv, *_j(ids, tbl, cached, new))
    th, tkvs = tfn(p, tk, tv, *_t(ids, tbl, cached, new))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    for (a, c), (jx, jy) in zip(tkvs, jkvs):
        np.testing.assert_allclose(a.numpy(), np.asarray(jx), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the engine with int8 pools
# ---------------------------------------------------------------------------

KW = dict(slots=2, prompt_bucket=8, max_prompt_len=32, max_new_tokens=6,
          block_size=8, steps_per_sync=3, prefix_cache=True,
          kv_cache_dtype="int8")
COUNTERS = ("prefill_calls", "device_steps", "prefill_chunks",
            "chunk_tokens", "prompt_tokens", "prefix_hit_tokens",
            "prefix_inserts")


def _shared_prefix_prompts(vocab, rng):
    """Rows sharing a 16-token head (two pages), rows sharing 8 tokens of
    it, cold rows, and long rows that take several unified windows; pages
    recycle through two slots."""
    shared = rng.integers(1, vocab, (16,)).tolist()
    return ([shared + rng.integers(1, vocab, (n,)).tolist()
             for n in (3, 9, 1)]
            + [shared[:8] + rng.integers(1, vocab, (n,)).tolist()
               for n in (6, 13)]
            + [rng.integers(1, vocab, (n,)).tolist() for n in (5, 30, 21)])


def _serve(eng, prompts):
    reqs = [eng.add_request(pr, max_new=2 + i % 5)
            for i, pr in enumerate(prompts)]
    eng.run(max_iters=500)
    assert all(r.done for r in reqs)
    assert eng.mgr.n_available == eng.mgr.max_pages - 1   # drained
    return {r.req_id: list(r.tokens) for r in reqs}


@pytest.fixture(scope="module")
def traffic(model):
    jcfg, _, raw, cfg, p = model
    prompts = _shared_prefix_prompts(cfg.vocab_size,
                                     np.random.default_rng(4))
    out = {}
    for unified in (False, True):
        jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, unified_step=unified,
                         **KW)
        teng = ContinuousBatchingEngine(cfg, p, device="cpu",
                                        dtype=torch.float32,
                                        unified_step=unified, **KW)
        out[unified] = (_serve(jeng, prompts), jeng, _serve(teng, prompts),
                        teng)
    return prompts, out


@pytest.mark.parametrize("unified", [False, True], ids=["split", "unified"])
def test_int8_engine_matches_jax(model, traffic, unified):
    jm = model[1]
    prompts, out = traffic
    theirs, jeng, ours, teng = out[unified]
    assert sorted(ours) == sorted(theirs)
    for rid, prompt in enumerate(prompts):
        a, b = ours[rid], theirs[rid]
        assert len(a) == len(b)
        if a != b:   # allowed only at a near-tie of the JAX model
            i = next(j for j in range(len(a)) if a[j] != b[j])
            logits = np.sort(np.asarray(jm(paddle.to_tensor(
                np.asarray([prompt + b[:i]]))).numpy())[0, -1])
            assert float(logits[-1] - logits[-2]) < NEAR_TIE, (rid, i)
    for name in COUNTERS:
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.mgr.prefix_evictions == jeng.mgr.prefix_evictions
    assert teng.prefix_hit_tokens > 0 and teng.prefix_inserts > 0
    if unified:
        assert teng.prefill_chunks > len(prompts)
    m = teng.metrics()
    assert m["kv_cache_dtype"] == "int8"
    assert m["n_cacheable_pages"] == teng.mgr.max_pages - 1
    assert m["kv_pool_bytes"] == teng.mgr.kv_pool_bytes()


@pytest.mark.parametrize("unified", [False, True], ids=["split", "unified"])
def test_int8_engine_pools_match_jax(traffic, unified):
    """After the run: every page but the scratch page within one int8
    step of the JAX engine's, every scale within 1e-5 relative."""
    _, out = traffic
    _, jeng, _, teng = out[unified]
    keep = np.arange(teng.mgr.max_pages) != teng.scratch_page
    assert teng.scratch_page == jeng.scratch_page
    assert isinstance(teng.kcs[0], tuple) and teng.kcs[0][0].dtype == \
        torch.int8
    for tpairs, jpairs in ((teng.kcs, jeng.kcs), (teng.vcs, jeng.vcs)):
        for (tp, ts), (jp, js) in zip(tpairs, jpairs):
            tp = tp.numpy()[keep].astype(np.int32)
            jp = np.asarray(jp)[keep].astype(np.int32)
            assert np.abs(tp - jp).max() <= 1
            assert (tp != 0).any()
            np.testing.assert_allclose(ts.numpy()[keep],
                                       np.asarray(js)[keep], rtol=1e-5,
                                       atol=0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_kv_pool_bytes_sizes_the_pool_as_jax(model, kv):
    """The same byte budget gives the JAX engine's max_pages at either
    pool dtype; an int8 pool holds at least 1.8x the bf16 pages at the
    bf16 pool's own bytes (tests/test_kv_quant.py:352-366)."""
    jcfg, _, raw, cfg, p = model
    kw = dict(slots=2, prompt_bucket=8, max_prompt_len=16, max_new_tokens=6,
              block_size=8, prefix_cache=True)
    budget = ContinuousBatchingEngine(cfg, p, device="cpu",
                                      kv_cache_dtype="bf16",
                                      **kw).mgr.kv_pool_bytes()
    for b in (budget, 3 * budget + 1000):
        teng = ContinuousBatchingEngine(cfg, p, device="cpu",
                                        kv_cache_dtype=kv, kv_pool_bytes=b,
                                        **kw)
        jeng = JaxEngine(jcfg, raw, kv_cache_dtype=kv, kv_pool_bytes=b,
                         **kw)
        assert teng.mgr.max_pages == jeng.mgr.max_pages
        assert teng.n_cacheable_pages == jeng.n_cacheable_pages
        assert teng.mgr.kv_pool_bytes() <= b
        m = teng.metrics()
        assert m["kv_pool_bytes"] == teng.mgr.kv_pool_bytes()
        assert m["kv_cache_dtype"] == kv
    if kv == "int8":
        bf = ContinuousBatchingEngine(cfg, p, device="cpu", **kw)
        q8 = ContinuousBatchingEngine(cfg, p, device="cpu",
                                      kv_cache_dtype="int8",
                                      kv_pool_bytes=budget, **kw)
        assert q8.n_cacheable_pages >= int(1.8 * bf.n_cacheable_pages)
    with pytest.raises(ValueError, match="not both"):
        ContinuousBatchingEngine(cfg, p, device="cpu", kv_cache_dtype=kv,
                                 kv_pool_bytes=budget, max_pages=8, **kw)
    with pytest.raises(ValueError, match="holds only"):
        ContinuousBatchingEngine(cfg, p, device="cpu", kv_cache_dtype=kv,
                                 kv_pool_bytes=PagedKVManager.page_bytes(
                                     8, n_layers=cfg.num_hidden_layers,
                                     num_kv_heads=2, head_dim=cfg.head_dim,
                                     kv_cache_dtype=kv) * 3, **kw)
