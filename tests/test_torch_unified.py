"""The port's ragged paged attention, the unified step's chunk prefill, and
the engine's prefix cache on both schedulers, against the JAX package on
the CPU.

Kernel functions: the same numpy inputs go through the JAX
``ragged_paged_attention`` (Pallas in interpret mode) and the port's (its
plain version on CPU tensors), with the cases of
tests/test_ragged_attention.py: mixed decode / cold / chunk / pad rows,
mid-page cached lengths, decode rows at every depth, GQA groups 1/2/4 and
MQA, a window that is not a whole number of pages, bf16. f32 within 1e-5;
bf16 within 2e-2; pad rows exact zeros.

Engines: the port's split engine with the prefix cache and its unified
engine run the row-class traffic of tests/test_unified_step.py
(cached-prefix, cold and chunked rows through a two-slot engine) against
the JAX engines in f32 on the same weights. Greedy tokens must be
identical; a divergence is allowed only where the JAX model's top-2 logit
margin is below 1e-4 (a near-tie that summation order may break either
way, the rule of tests/test_torch_engine.py), and the scheduling counters
must be equal. bf16 unified-vs-split identity is not used as an oracle:
the reference's own bf16 identity test fails under the installed jax.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import ragged_attention as jra
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch.kernels.ragged_attention import (
    ragged_paged_attention, ragged_paged_attention_reference)
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models import llama as pl
from paddle_tpu_torch.serving import ContinuousBatchingEngine

NEAR_TIE = 1e-4


# ---------------------------------------------------------------------------
# the kernel function
# ---------------------------------------------------------------------------

def _ragged_inputs(cached, tn, nh, nkv, dh, page, seed):
    rng = np.random.default_rng(seed)
    b = len(cached)
    w = max(1, -(-max(cached) // page))
    n_pages = max(2 * b * w, 8)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    arrays = [f(b, tn, nh, dh), f(b, tn, nkv, dh), f(b, tn, nkv, dh),
              f(n_pages, nkv, page, dh), f(n_pages, nkv, page, dh)]
    tables = rng.permutation(n_pages)[:b * w].reshape(b, w).astype(np.int32)
    return arrays, tables


@pytest.mark.parametrize("cached,new,tn,nh,nkv,dtype", [
    ([24, 0, 16, 0], [1, 16, 8, 0], 16, 4, 2, "float32"),
    ([5, 13, 21], [1, 4, 16], 16, 4, 2, "float32"),
    ([1, 8, 9, 24], [1, 1, 1, 1], 16, 4, 2, "float32"),
    ([10, 0, 17], [2, 16, 5], 16, 2, 2, "float32"),
    ([10, 0, 17], [2, 16, 5], 16, 8, 2, "float32"),
    ([10, 0, 17], [2, 16, 5], 16, 4, 1, "float32"),
    ([8, 16], [12, 1], 12, 4, 2, "float32"),
    ([20, 0, 7], [1, 16, 9], 16, 4, 2, "bfloat16"),
], ids=["mixed-rows", "mid-page", "decode-rows", "group1", "group4", "mqa",
        "window-not-page-granular", "bf16"])
def test_ragged_paged_attention_matches_jax(cached, new, tn, nh, nkv, dtype):
    arrays, tables = _ragged_inputs(cached, tn, nh, nkv, 32, 8,
                                    seed=nh * 10 + nkv + tn)
    cl = np.asarray(cached, np.int32)
    nl = np.asarray(new, np.int32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    ref = jra.ragged_paged_attention(
        *[jnp.asarray(a, jd) for a in arrays], jnp.asarray(tables),
        jnp.asarray(cl), jnp.asarray(nl))
    out = ragged_paged_attention(
        *[torch.from_numpy(a).to(td) for a in arrays],
        torch.from_numpy(tables), torch.from_numpy(cl), torch.from_numpy(nl))
    assert out.dtype == td
    got = out.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(ref, jnp.float32))
    assert np.isfinite(got).all()
    for row, n in enumerate(new):
        assert (got[row, n:] == 0).all() and (want[row, n:] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_ragged_reference_is_the_jax_reference():
    arrays, tables = _ragged_inputs([5, 13, 0], 8, 4, 2, 16, 8, seed=9)
    cl = np.asarray([5, 13, 0], np.int32)
    nl = np.asarray([1, 8, 3], np.int32)
    want = jra.ragged_paged_attention_reference(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(tables),
        jnp.asarray(cl), jnp.asarray(nl))
    got = ragged_paged_attention_reference(
        *[torch.from_numpy(a) for a in arrays], torch.from_numpy(tables),
        torch.from_numpy(cl), torch.from_numpy(nl))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_ragged_refuses_int8_and_empty_tables():
    arrays, tables = _ragged_inputs([8], 8, 4, 2, 16, 8, seed=3)
    t = [torch.from_numpy(a) for a in arrays]
    lens = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="at least one page"):
        ragged_paged_attention(*t, torch.zeros(1, 0, dtype=torch.int32),
                               lens)
    with pytest.raises(ValueError, match="only apply to int8"):
        ragged_paged_attention(*t, torch.from_numpy(tables), lens,
                               k_scale=torch.ones(16, 2),
                               v_scale=torch.ones(16, 2))
    q8 = t[3].to(torch.int8)
    with pytest.raises(ValueError, match="k_scale / v_scale"):
        ragged_paged_attention(*t[:3], q8, q8, torch.from_numpy(tables),
                               lens)


# ---------------------------------------------------------------------------
# the chunk-lane model body
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


@pytest.mark.parametrize("cached,new", [(13, 16), (0, 5), (24, 1)])
def test_make_chunk_prefill_matches_jax(cached, new):
    """One window of 16 tokens at a token-granular cached length (13 ends
    mid-page), a cold short window and a one-token window. Hidden states
    within 1e-4, window K/V within 1e-5."""
    jcfg, _, raw, cfg, p = _setup()
    rng = np.random.default_rng(cached + new)
    tn, bs, n_pages, n_layers = 16, 8, 9, cfg.num_hidden_layers
    pools = [rng.standard_normal((n_pages, 2, bs, cfg.head_dim)).astype(
        np.float32) for _ in range(2 * n_layers)]
    ids = rng.integers(1, cfg.vocab_size, (1, tn))
    tbl = np.asarray([[4, 2, 7, 1, 0, 0]], np.int32)
    cl = np.asarray([cached], np.int32)
    nl = np.asarray([new], np.int32)
    jh, jkvs = jl._make_chunk_prefill(jcfg, tn)(
        raw, [jnp.asarray(a) for a in pools[:n_layers]],
        [jnp.asarray(a) for a in pools[n_layers:]], jnp.asarray(ids),
        jnp.asarray(tbl), jnp.asarray(cl), jnp.asarray(nl))
    th, tkvs = pl._make_chunk_prefill(cfg, tn)(
        p, [torch.from_numpy(a) for a in pools[:n_layers]],
        [torch.from_numpy(a) for a in pools[n_layers:]],
        torch.from_numpy(ids), torch.from_numpy(tbl), torch.from_numpy(cl),
        torch.from_numpy(nl))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    for (tk, tv), (jk, jv) in zip(tkvs, jkvs):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the engine: prefix cache on the split path, and the unified step
# ---------------------------------------------------------------------------

KW = dict(slots=2, prompt_bucket=8, max_prompt_len=32, max_new_tokens=6,
          block_size=8, steps_per_sync=3, prefix_cache=True)
COUNTERS = ("prefill_calls", "device_steps", "prefill_chunks",
            "chunk_tokens", "prompt_tokens", "prefix_hit_tokens",
            "prefix_inserts")


def _row_class_prompts(vocab, rng):
    """tests/test_unified_step.py's trace: cached-prefix rows (a shared
    8-token head), cold short rows, and chunked rows wider than the
    8-token budget, sized so pages recycle through two slots."""
    shared = rng.integers(1, vocab, (8,)).tolist()
    return ([shared + rng.integers(1, vocab, (n,)).tolist()
             for n in (3, 7, 2)]
            + [rng.integers(1, vocab, (n,)).tolist() for n in (5, 2)]
            + [rng.integers(1, vocab, (n,)).tolist() for n in (30, 22, 17)])


def _serve(eng, prompts, varied=True):
    """Serve `prompts` (max_new 2..5 by index when `varied`, else the
    engine budget) and check the pool drains."""
    reqs = [eng.add_request(pr, max_new=2 + i % 4 if varied else None)
            for i, pr in enumerate(prompts)]
    eng.run(max_iters=500)
    assert all(r.done for r in reqs)
    assert eng.mgr.n_available == eng.mgr.max_pages - 1   # drained
    return {r.req_id: list(r.tokens) for r in reqs}


def _port(cfg, p, **kw):
    return ContinuousBatchingEngine(cfg, p, device="cpu",
                                    dtype=torch.float32, **{**KW, **kw})


def _jax(jcfg, raw, **kw):
    return JaxEngine(jcfg, raw, dtype=jnp.float32, **{**KW, **kw})


def _assert_same_tokens(jm, prompts, ours, theirs):
    """Identical greedy streams, up to near-ties of the JAX model."""
    assert sorted(ours) == sorted(theirs)
    for rid, prompt in enumerate(prompts):
        a, b = ours[rid], theirs[rid]
        assert len(a) == len(b)
        if a == b:
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        ctx = np.asarray([prompt + b[:i]])
        logits = np.sort(np.asarray(jm(paddle.to_tensor(ctx)).numpy())[0,
                                                                     -1])
        assert float(logits[-1] - logits[-2]) < NEAR_TIE, (rid, i)


@pytest.fixture(scope="module")
def model():
    return _setup()


@pytest.fixture(scope="module")
def traffic(model):
    jcfg, jm, raw, cfg, p = model
    prompts = _row_class_prompts(cfg.vocab_size, np.random.default_rng(3))
    out = {}
    for unified in (False, True):
        jeng = _jax(jcfg, raw, unified_step=unified)
        teng = _port(cfg, p, unified_step=unified)
        out[unified] = (_serve(jeng, prompts), jeng, _serve(teng, prompts),
                        teng)
    return prompts, out


@pytest.mark.parametrize("unified", [False, True], ids=["split", "unified"])
def test_engine_with_prefix_cache_matches_jax(model, traffic, unified):
    jm = model[1]
    prompts, out = traffic
    theirs, jeng, ours, teng = out[unified]
    _assert_same_tokens(jm, prompts, ours, theirs)
    for name in COUNTERS:
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.prefix_hit_tokens > 0 and teng.prefix_inserts > 0
    if unified:
        assert teng.prefill_chunks > len(prompts) and teng.prefill_calls == 0
    m = teng.metrics()
    assert m["prefix_hit_rate"] == pytest.approx(
        teng.prefix_hit_tokens / teng.prompt_tokens)
    assert {k: m[k] for k in COUNTERS} \
        == {k: getattr(teng, k) for k in COUNTERS}


def test_unified_matches_the_split_engine(model, traffic):
    """The port's two schedulers serve the same tokens (f32)."""
    jm = model[1]
    prompts, out = traffic
    _assert_same_tokens(jm, prompts, out[True][2], out[False][2])


@pytest.mark.parametrize("unified,hit", [(True, 24), (False, 16)],
                         ids=["unified-never-trimmed", "split-trimmed"])
def test_full_prefix_hit(model, unified, hit):
    """A repeat 25-token prompt: the unified planner reserves exact pages,
    so all 3 full blocks hit; the split planner trims the hit to 16 tokens
    so that cached + bucketed-suffix pages stay within the cold path's
    (tests/test_unified_step.py:166, tests/test_serving_engine.py:286)."""
    _, _, _, cfg, p = model
    prompt = np.random.default_rng(12).integers(1, cfg.vocab_size,
                                                (25,)).tolist()
    eng = _port(cfg, p, unified_step=unified, slots=1, prompt_bucket=16,
                max_new_tokens=8, steps_per_sync=4)
    r1, r2 = eng.add_request(prompt), eng.add_request(prompt)
    eng.run(max_iters=200)
    assert r1.done and r2.done and r1.tokens == r2.tokens
    assert r2.cached_tokens == hit
    assert eng.mgr.n_available == eng.mgr.max_pages - 1


@pytest.mark.parametrize("unified", [False, True], ids=["split", "unified"])
def test_lru_eviction_through_a_small_pool(model, unified):
    """Distinct 9-token prompts each cache one full block; the pool (7
    pages) cannot hold them beside live reservations, so refcount-0
    cached pages are evicted oldest first instead of failing an alloc --
    the same evictions, inserts and tokens as the JAX engine's."""
    jcfg, jm, raw, cfg, p = model
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab_size, (9,)).tolist()
               for _ in range(5)]
    kw = dict(max_prompt_len=16, max_new_tokens=4, steps_per_sync=4,
              unified_step=unified)
    jeng, teng = _jax(jcfg, raw, **kw), _port(cfg, p, **kw)
    assert teng.mgr.max_pages == 7
    theirs = _serve(jeng, prompts, varied=False)
    ours = _serve(teng, prompts, varied=False)
    _assert_same_tokens(jm, prompts, ours, theirs)
    assert teng.prefix_inserts > 2 and teng.mgr.prefix_evictions > 0
    assert teng.mgr.prefix_evictions == jeng.mgr.prefix_evictions
    assert teng.prefix_inserts == jeng.prefix_inserts
    assert teng.metrics()["prefix_evictions"] == teng.mgr.prefix_evictions


def test_token_budget_validation(model):
    _, _, _, cfg, p = model
    with pytest.raises(ValueError, match="token_budget"):
        _port(cfg, p, unified_step=True, token_budget=12)
    with pytest.raises(ValueError, match="token_budget"):
        _port(cfg, p, unified_step=True, token_budget=4)


def test_prefix_cache_and_unified_defaults(model):
    """prefix_cache defaults to on, as in the JAX engine; unified_step
    'auto' is the split path."""
    _, _, _, cfg, p = model
    eng = ContinuousBatchingEngine(cfg, p, device="cpu", prompt_bucket=8,
                                   block_size=8, unified_step="auto")
    assert eng.prefix_cache and not eng.unified and eng._unified is None
