"""The port's tensor-parallel serving (``serving_mp``) against the JAX
engine, on the CPU, in f32 on ``LlamaConfig.tiny()``.

The JAX engine runs its single controller on the 8-device CPU mesh
(tests/conftest.py); the port runs one process a rank over gloo (a pool
of spawned ranks per module, tests/torch_rank_pool.py), each rank slicing
the full params with `shard_serving_params`. Rank 0's greedy streams must
equal the JAX engine's at the same degree through prefix churn (up to the
JAX model's near-ties, tests/test_torch_engine.py's rule: a first
divergence only where the JAX top-2 logit margin is below 1e-4), every
rank's streams must be equal, and so must the scheduling counters. The
f32 stream's head gather ships bf16 on both sides (`gather_heads`).
Cases: the split path, the unified step, int8 pools, disaggregated,
mp = 4, the MQA fallback (warning, replicated pools), the megakernel attn
rung (plain version), a scan request stepping down to attn, and
`build_paged_generate` at mp = 2; each rank's pool against JAX's shard
of the pool and the port's one-rank pool; the geometry errors.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models import llama as pl
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from torch_rank_pool import RankPool, generate_rank, serve_rank

NEAR_TIE = 1e-4
# unified_step is explicit: 'auto' is the unified step in JAX off-TPU and
# the split path in the port
KW = dict(slots=2, prompt_bucket=8, max_prompt_len=16, max_new_tokens=6,
          block_size=8, steps_per_sync=3, unified_step=False)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _model(nkv, seed=21):
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=nkv)
    paddle.seed(seed)
    raw = {k: np.asarray(v) for k, v in dict(JaxModel(jcfg).raw_state())
           .items()}
    return jcfg, raw


@pytest.fixture(scope="module")
def model():
    return _model(2)


def _prompts(vocab, seed=7):
    """Shared-prefix and cold prompts: a two-slot engine recycles pages
    and the prefix cache takes hits."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, (8,)).tolist()
    prompts = ([shared + rng.integers(1, vocab, (n,)).tolist()
                for n in (3, 5, 2)]
               + [rng.integers(1, vocab, (n,)).tolist() for n in (7, 9, 4)])
    return prompts, [2 + i % 4 for i in range(len(prompts))]


def _jax_serve(jcfg, raw, prompts, max_new, **kw):
    eng = JaxEngine(jcfg, {k: jnp.asarray(v) for k, v in raw.items()},
                    dtype=jnp.float32, **kw)
    reqs = [eng.add_request(p, max_new=m) for p, m in zip(prompts, max_new)]
    eng.run(max_iters=1000)
    assert all(r.done for r in reqs)
    return eng, [list(r.tokens) for r in reqs]


def _jax_logits(jcfg, raw, ids):
    jdec = {k: jnp.asarray(v) for k, v in raw.items()}
    h, _ = jl._make_prefill(jcfg, 1, len(ids))(jdec,
                                              jnp.asarray([ids], jnp.int32))
    return np.asarray(jl._make_head_logits(jcfg)(h, jdec))[0, -1]


def assert_same_up_to_ties(jcfg, raw, prompts, ours, theirs):
    for prompt, a, b in zip(prompts, ours, theirs):
        assert len(a) == len(b)
        if a != b:
            i = next(j for j in range(len(a)) if a[j] != b[j])
            row = np.sort(_jax_logits(jcfg, raw, prompt + b[:i]))
            assert float(row[-1] - row[-2]) < NEAR_TIE, i


def _ranks(pool, world, cfg_kw, raw, kw, prompts, max_new, **extra):
    outs = pool.run(world, serve_rank, cfg_kw, raw, kw, prompts, max_new,
                    *extra.values())
    for o in outs[1:]:
        assert o["tokens"] == outs[0]["tokens"]      # lockstep ranks
        assert o["counters"] == outs[0]["counters"]
    return outs


# (port engine kwargs beyond KW, with the JAX engine's the same)
RUNS = {
    "split": dict(serving_mp=2),
    "unified": dict(serving_mp=2, unified_step=True),
    "int8-pools": dict(serving_mp=2, kv_cache_dtype="int8"),
    "disaggregated": dict(serving_mp=2, disaggregated=True),
    "megakernel-attn": dict(serving_mp=2, decode_megakernel="attn"),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_mp2_engine_matches_jax(pool, model, run):
    jcfg, raw = model
    prompts, max_new = _prompts(jcfg.vocab_size)
    kw = dict(KW, **RUNS[run])
    jeng, theirs = _jax_serve(jcfg, raw, prompts, max_new, **kw)
    outs = _ranks(pool, 2, dict(num_key_value_heads=2), raw, kw, prompts,
                  max_new)
    ours = outs[0]
    assert_same_up_to_ties(jcfg, raw, prompts, ours["tokens"], theirs)
    for k, v in ours["counters"].items():
        assert v == getattr(jeng, k), k
    assert ours["counters"]["prefix_hit_tokens"] > 0
    assert ours["metrics"] == dict(serving_mp=2, serving_cp=1,
                                   quantized_collectives=False,
                                   serving_backend="gloo")
    assert ours["graphs"] is False
    assert ours["n_available"] == ours["max_pages"] - 1       # drained
    assert ours["rung"] == jeng.megakernel_rung
    # kv-head sharding: each rank's pools are half the one-device bytes
    assert ours["pool_bytes"] == jeng.mgr.kv_pool_bytes()
    one = ContinuousBatchingEngine(
        LlamaConfig.tiny(num_key_value_heads=2),
        params_from_jax(raw, device="cpu"), device="cpu",
        dtype=torch.float32, **dict(kw, serving_mp=1))
    assert 2 * ours["pool_bytes"] == one.mgr.kv_pool_bytes()


def test_scan_request_steps_down_to_attn(pool, model):
    """Under mp the scan and full rungs fuse the MLP past the o-proj
    psum: a scan request serves the attn rung, one warning a refused
    rung, tokens as JAX's."""
    jcfg, raw = model
    prompts, max_new = _prompts(jcfg.vocab_size, seed=11)
    kw = dict(KW, serving_mp=2, decode_megakernel="scan")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng, theirs = _jax_serve(jcfg, raw, prompts, max_new, **kw)
    ours = _ranks(pool, 2, dict(num_key_value_heads=2), raw, kw, prompts,
                  max_new)[0]
    assert ours["rung"] == jeng.megakernel_rung == "attn"
    refused = [w for w in ours["warnings"] if "unsupported" in w]
    assert len(refused) == 2 and all("serving_mp > 1" in w
                                     for w in refused)
    assert_same_up_to_ties(jcfg, raw, prompts, ours["tokens"], theirs)


@pytest.mark.parametrize("nkv,mp", [(4, 4), (1, 2)], ids=["mp4", "mqa"])
def test_mp4_and_mqa_fallback_match_jax(pool, nkv, mp):
    """mp = 4 over four kv heads (one head a rank), and the MQA fallback
    (one kv head at mp = 2): the pools replicate, q shards, one warning
    names the fallback."""
    jcfg, raw = _model(nkv)
    prompts, max_new = _prompts(jcfg.vocab_size, seed=5)
    kw = dict(KW, serving_mp=mp)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng, theirs = _jax_serve(jcfg, raw, prompts, max_new, **kw)
    outs = _ranks(pool, mp, dict(num_key_value_heads=nkv), raw, kw, prompts,
                  max_new, pools=True)
    ours = outs[0]
    assert_same_up_to_ties(jcfg, raw, prompts, ours["tokens"], theirs)
    assert ours["pool_bytes"] == jeng.mgr.kv_pool_bytes()
    pool0 = ours["pools"][0][0]
    if nkv == 1:
        assert any(pl.SERVING_MP_FALLBACK_MSG in w for w in ours["warnings"])
        assert pool0.shape[1] == 1                      # replicated
        for o in outs[1:]:
            np.testing.assert_array_equal(o["pools"][0][0], pool0)
    else:
        assert pool0.shape[1] == nkv // mp


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_rank_pools_are_the_jax_shards(pool, model, kv):
    """Each rank's pool is JAX's mp = 2 pool's kv-head shard (f32 within
    1e-5 at layer 0 and a bf16 step past the first head gather; int8
    within one step, scales within 1e-3 relative), the scratch
    page left out (free rows and pad rows write there in any order). Layer
    0, which no head gather precedes, is byte for byte the port's
    one-rank pool's heads: kv-head sharding moves no commit (later layers
    see the bf16 gather of the f32 stream, as in JAX)."""
    jcfg, raw = model
    prompts, max_new = _prompts(jcfg.vocab_size, seed=3)
    kw = dict(KW, serving_mp=2, kv_cache_dtype=kv, prefix_cache=False)
    jeng, theirs = _jax_serve(jcfg, raw, prompts, max_new, **kw)
    outs = _ranks(pool, 2, dict(num_key_value_heads=2), raw, kw, prompts,
                  max_new, pools=True)
    one = pool.run(1, serve_rank, dict(num_key_value_heads=2), raw,
                   dict(kw, serving_mp=1), prompts, max_new, True)[0]
    keep = [p for p in range(jeng.mgr.max_pages) if p != jeng.scratch_page]
    for m, o in enumerate(outs):
        sl = slice(m, m + 1)
        for layer, (kc, vc) in enumerate(o["pools"]):
            for j, (got, want) in enumerate(((kc, jeng.kcs[layer]),
                                             (vc, jeng.vcs[layer]))):
                full = one["pools"][layer][j]
                if kv == "int8":
                    (gq, gs), (fq, fs) = got, full
                    wq, ws = (np.asarray(a)[keep] for a in want)
                    if layer == 0:
                        np.testing.assert_array_equal(gq, fq[:, sl])
                        np.testing.assert_array_equal(gs, fs[:, sl])
                    gq, gs = gq[keep], gs[keep]
                    assert np.abs(gq.astype(np.int32)
                                  - wq[:, sl].astype(np.int32)).max() <= 1
                    np.testing.assert_allclose(gs, ws[:, sl], rtol=1e-3,
                                               atol=1e-9)
                else:
                    # layer 0: f32 within 1e-5; past a bf16 head gather a
                    # one-ulp rounding difference of the gathered
                    # activations moves K/V by up to a bf16 step
                    tol = 1e-5 if layer == 0 else 2.0 ** -7
                    if layer == 0:
                        np.testing.assert_array_equal(got, full[:, sl])
                    np.testing.assert_allclose(
                        got[keep], np.asarray(want)[keep][:, sl], atol=tol,
                        rtol=0 if layer == 0 else tol)


def test_paged_generate_mp2_matches_jax(pool, model):
    """build_paged_generate(serving_mp=2): every rank returns the JAX
    program's tokens (a ragged batch of two rows)."""
    jcfg, raw = model
    b, sb, max_new = 2, 16, 5
    rng = np.random.default_rng(4)
    ids = rng.integers(1, jcfg.vocab_size, (b, sb)).astype(np.int64)
    s0 = np.asarray([16, 11], np.int64)
    total = sb + max_new
    mgr = jl.PagedKVManager(b * -(-total // 8), 8)
    tables, _ = mgr.tables_for_batch([total] * b)
    tables = np.asarray(tables, np.int32)
    jrun = jl.build_paged_generate(jcfg, b, sb, max_new, block_size=8,
                                   serving_mp=2)
    want = np.asarray(jrun({k: jnp.asarray(v) for k, v in raw.items()},
                           jnp.asarray(ids, jnp.int32),
                           jnp.asarray(s0, jnp.int32), jnp.asarray(tables),
                           jax.random.PRNGKey(0), 1.0, 1.0))
    outs = pool.run(2, generate_rank, dict(num_key_value_heads=2), raw, b,
                    sb, max_new, ids, s0, tables)
    np.testing.assert_array_equal(outs[0], outs[1])
    for row in range(b):
        assert_same_up_to_ties(
            jcfg, raw, [ids[row, :s0[row]].tolist()],
            [outs[0][row].tolist()], [want[row].tolist()])


# ---------------------------------------------------------------------------
# geometry errors and the process-group check (plain Python)
# ---------------------------------------------------------------------------

GEOMETRY = {
    "q-heads-do-not-divide": (dict(num_attention_heads=4,
                                   num_key_value_heads=2), 3, 1,
                              "does not divide num_attention_heads"),
    "gqa-grouping-broken": (dict(num_attention_heads=6,
                                 num_key_value_heads=4, hidden_size=48),
                            2, 1, "breaks the GQA grouping"),
    "mqa-without-whole-groups": (dict(num_attention_heads=4,
                                      num_key_value_heads=3), 2, 1,
                                 "not a whole number of kv groups"),
    "cp-below-one": (dict(), 1, 0, "serving_cp must be >= 1"),
}


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_geometry_errors_match_jax(name):
    over, mp, cp, msg = GEOMETRY[name]
    jcfg = dataclasses.replace(JaxConfig.tiny(), **over)
    cfg = LlamaConfig.tiny(**over)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match=msg):
            jl.ServingTP(jcfg, mp, cp=cp)
        with pytest.raises(ValueError, match=msg):
            pl.ServingTP(cfg, mp, cp=cp)


def test_non_divisible_pages_raise_the_named_error():
    for mod in (jl, pl):
        mgr = mod.PagedKVManager(7, 8)
        with pytest.raises(mod.PageShardingError, match="not divisible"):
            mgr.set_pool_geometry(n_layers=2, num_kv_heads=2, head_dim=16,
                                  cp=2)


def test_engine_without_a_process_group_names_the_launcher(model):
    _, raw = model
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    p = params_from_jax(raw, device="cpu")
    with pytest.raises(ValueError, match="parallel.launch"):
        ContinuousBatchingEngine(cfg, p, device="cpu", dtype=torch.float32,
                                 serving_mp=2, **KW)


def test_shard_serving_params_slices_the_head_axes(model):
    """q / k / v split on their output heads (dense [in, out] columns,
    weight-only pairs' rows and scales); everything else is the caller's
    tensor; a slice passes through."""
    _, raw = model
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    p = params_from_jax(raw, device="cpu")
    tp = pl.ServingTP(cfg, 2)
    dh = cfg.head_dim
    for rank in range(2):
        loc = pl.shard_serving_params(p, tp, rank)
        for name in ("q", "k", "v"):
            key = f"llama.layers.0.self_attn.{name}_proj.weight"
            n = loc[key].shape[1]
            assert n == (2 if name == "q" else 1) * dh
            torch.testing.assert_close(loc[key],
                                       p[key][:, rank * n:(rank + 1) * n],
                                       rtol=0, atol=0)
        key = "llama.layers.0.self_attn.o_proj.weight"
        assert loc[key] is p[key]
        assert pl.shard_serving_params(loc, tp, rank)[
            "llama.layers.0.self_attn.q_proj.weight"].shape[1] == 2 * dh
    q8 = pl.decode_params(p, "weight_only_int8")
    loc = pl.shard_serving_params(q8, tp, 1)
    w, sc = q8["llama.layers.1.self_attn.q_proj.weight"]
    lw, lsc = loc["llama.layers.1.self_attn.q_proj.weight"]
    n = w.shape[0] // 2
    torch.testing.assert_close(lw, w[n:], rtol=0, atol=0)
    torch.testing.assert_close(lsc, sc[n:], rtol=0, atol=0)
