"""The port's context-parallel serving (``serving_cp``: page-sharded
pools) against the JAX engine, on the CPU, in f32 on
``LlamaConfig.tiny()``, and `kernels/partial_attention.py` against the
JAX functions.

The ranks are spawned processes over gloo (tests/torch_rank_pool.py).
Rank 0's greedy streams must equal the JAX engine's at the same degrees
through prefix churn (up to the JAX model's near-ties, the rule of
tests/test_torch_serving_mp.py), every rank's must be equal, and so must
the scheduling counters. Cases: cp = 2 on the split path, the unified
step and int8 pools, cp2 x mp2 on four ranks, the budget that walls cp =
1 and serves cp = 2, the megakernel's fallback under cp, and the
refusal of speculation under cp.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import partial_attention as jpa
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.kernels import partial_attention as tpa
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models import llama as pl
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from test_torch_serving_mp import (KW, _jax_serve, _prompts, _ranks,
                                   assert_same_up_to_ties)
from torch_rank_pool import RankPool, serve_rank


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=2)
    paddle.seed(21)
    raw = {k: np.asarray(v) for k, v in dict(JaxModel(jcfg).raw_state())
           .items()}
    return jcfg, raw


RUNS = {
    "cp2-split": (2, dict(serving_cp=2)),
    "cp2-unified": (2, dict(serving_cp=2, unified_step=True)),
    "cp2-int8-pools": (2, dict(serving_cp=2, kv_cache_dtype="int8")),
    "cp2-disaggregated": (2, dict(serving_cp=2, disaggregated=True)),
    "cp2xmp2": (4, dict(serving_cp=2, serving_mp=2)),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_cp_engine_matches_jax(pool, model, run):
    jcfg, raw = model
    world, over = RUNS[run]
    prompts, max_new = _prompts(jcfg.vocab_size)
    kw = dict(KW, **over)
    jeng, theirs = _jax_serve(jcfg, raw, prompts, max_new, **kw)
    ours = _ranks(pool, world, dict(num_key_value_heads=2), raw, kw, prompts,
                  max_new)[0]
    assert_same_up_to_ties(jcfg, raw, prompts, ours["tokens"], theirs)
    for k, v in ours["counters"].items():
        assert v == getattr(jeng, k), k
    assert ours["counters"]["prefix_hit_tokens"] > 0
    assert ours["metrics"]["serving_cp"] == 2
    assert ours["metrics"]["serving_backend"] == "gloo"
    # the fleet's page count rounds to whole cp shards, and a rank holds
    # max_pages / cp of them (at its kv heads)
    assert ours["max_pages"] == jeng.mgr.max_pages
    assert ours["max_pages"] % 2 == 0
    assert ours["pool_bytes"] == jeng.mgr.kv_pool_bytes()
    assert ours["n_available"] == ours["max_pages"] - 1       # drained


def test_halved_budget_walls_cp1_and_serves_cp2(pool, model):
    """A per-rank byte budget holding half of one request's pages: the
    cp = 1 build refuses it (its pool cannot hold the context), cp = 2
    serves the same depth from the same per-rank bytes, with JAX's
    tokens."""
    jcfg, raw = model
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    cap = -(-(16 + 6) // 8)
    pb = pl.PagedKVManager.page_bytes(
        8, n_layers=cfg.num_hidden_layers,
        num_kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim)
    budget = ((cap + 3) // 2) * pb
    with pytest.raises(ValueError, match="holds only"):
        ContinuousBatchingEngine(cfg, params_from_jax(raw, device="cpu"),
                                 device="cpu", dtype=torch.float32,
                                 kv_pool_bytes=budget, **KW)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, (15,)).tolist()]
    kw = dict(KW, serving_cp=2, kv_pool_bytes=budget)
    _, theirs = _jax_serve(jcfg, raw, prompts, [4], **kw)
    ours = _ranks(pool, 2, dict(num_key_value_heads=2), raw, kw, prompts,
                  [4])[0]
    assert len(ours["tokens"][0]) == 4
    assert ours["pool_bytes"] <= budget
    assert_same_up_to_ties(jcfg, raw, prompts, ours["tokens"], theirs)


def test_megakernel_falls_back_under_cp_and_speculation_refuses(pool, model):
    """The fused kernel has no online-softmax partials for the cp merge:
    every rung steps down to off with the reason; speculation does not
    compose with cp (as in JAX)."""
    jcfg, raw = model
    prompts, max_new = _prompts(jcfg.vocab_size, seed=9)
    kw = dict(KW, serving_cp=2, decode_megakernel="attn")
    ours = _ranks(pool, 2, dict(num_key_value_heads=2), raw, kw, prompts,
                  max_new)[0]
    assert ours["rung"] == "off"
    assert any("serving_cp > 1" in w for w in ours["warnings"])
    with pytest.raises(RuntimeError, match="serving_cp"):
        pool.run(2, serve_rank, dict(num_key_value_heads=2), raw,
                 dict(KW, serving_cp=2, speculative="ngram"), prompts,
                 max_new)


# ---------------------------------------------------------------------------
# the partial-attention functions against JAX's
# ---------------------------------------------------------------------------

def _pa_case(seed, b=3, tn=4, nh=4, nkv=2, dh=16, page=8, w=3, pps=6,
             int8=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, kn, vn = f(b, tn, nh, dh), f(b, tn, nkv, dh), f(b, tn, nkv, dh)
    kc, vc = f(pps, nkv, page, dh), f(pps, nkv, page, dh)
    tables = rng.integers(0, pps, (b, w)).astype(np.int32)
    valid = rng.random((b, w * page)) < 0.6
    valid[0] = False                          # an empty row
    kw = {}
    if int8:
        (kq, ks), (vq, vs) = (jl.quantize_kv_pages(jnp.asarray(x))
                              for x in (kc, vc))
        kc, vc = np.asarray(kq), np.asarray(vq)
        kw = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    return q, kn, vn, kc, vc, tables, valid, kw


def _close(got, want, atol=1e-5):
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_partials_match_jax(int8):
    q, kn, vn, kc, vc, tables, valid, kw = _pa_case(1, int8=int8)
    T = torch.from_numpy
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: T(v) for k, v in kw.items()}
    want = jpa.paged_partials(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(tables),
                              jnp.asarray(valid), **jkw)
    got = tpa.paged_partials(T(q), T(kc), T(vc), T(tables), T(valid), **tkw)
    _close(got, want)
    # the empty row: the sentinel, l = 0, acc = 0
    assert (got[0][0] == tpa._NEG_INF).all() and (got[1][0] == 0).all()
    lens = np.asarray([0, 9, 23], np.int32)
    owned = np.random.default_rng(2).random(tables.shape) < 0.5
    want = jpa.decode_paged_partials(
        jnp.asarray(q[:, 0]), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(owned), **jkw)
    got = tpa.decode_paged_partials(T(q[:, 0]), T(kc), T(vc), T(tables),
                                    T(lens), T(owned), **tkw)
    _close(got, want)


def test_window_combine_finalize_match_jax():
    q, kn, vn, kc, vc, tables, valid, _ = _pa_case(4)
    T = torch.from_numpy
    new = np.asarray([4, 2, 0], np.int32)
    for lens in (None, new):
        want = jpa.causal_window_partials(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            None if lens is None else jnp.asarray(lens))
        got = tpa.causal_window_partials(
            T(q), T(kn), T(vn), None if lens is None else T(lens))
        _close(got, want)
    a_j = jpa.paged_partials(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), jnp.asarray(tables),
                             jnp.asarray(valid))
    b_j = jpa.causal_window_partials(jnp.asarray(q), jnp.asarray(kn),
                                     jnp.asarray(vn), jnp.asarray(new))
    a_t = tpa.paged_partials(T(q), T(kc), T(vc), T(tables), T(valid))
    b_t = tpa.causal_window_partials(T(q), T(kn), T(vn), T(new))
    live = np.arange(4)[None, :] < new[:, None]
    want = jpa.finalize_partials(*jpa.combine_partials(a_j, b_j),
                                 jnp.asarray(live)[..., None])
    got = tpa.finalize_partials(*tpa.combine_partials(a_t, b_t),
                                T(live)[..., None])
    _close([got], [want])
    assert (got[2] == 0).all()                   # a row with nothing live
    # the merged partials of two page shards equal one pass over both
    half = valid.copy()
    half[:, : half.shape[1] // 2] = False
    rest = valid & ~half
    both = tpa.combine_partials(
        tpa.paged_partials(T(q), T(kc), T(vc), T(tables), T(half)),
        tpa.paged_partials(T(q), T(kc), T(vc), T(tables), T(rest)))
    one = tpa.paged_partials(T(q), T(kc), T(vc), T(tables), T(valid))
    torch.testing.assert_close(tpa.finalize_partials(*both),
                               tpa.finalize_partials(*one), atol=1e-5,
                               rtol=1e-5)


def test_cp_views_are_the_owner_arithmetic():
    tables = torch.tensor([[0, 5, 6, 11], [3, 9, 2, 7]], dtype=torch.int32)
    loc, owned = tpa.cp_local_view(tables, 6, 1)
    assert owned.tolist() == [[False, False, True, True],
                              [False, True, False, True]]
    assert loc.tolist() == [[0, 0, 0, 5], [0, 3, 0, 1]]
    assert tpa.cp_write_rows(tables, 6, 0).tolist() == [[0, 5, 6, 6],
                                                         [3, 6, 2, 6]]
    assert math.isclose(tpa._NEG_INF, -1e30)
