"""The port's continuous-batching engine (paddle_tpu_torch.serving)
against the JAX engine, on the CPU, in f32 on ``LlamaConfig.tiny()``.

The JAX engine is built on the same split path as the port's engine
(``unified_step=False, prefix_cache=False``, f32 pools), on the same
weights. Greedy token streams must be identical; a divergence is
allowed only at a step where the JAX model's top-2 logit margin is below
1e-4 (a near-tie that summation order may break either way), and the
test asserts that margin at every divergence it accepts.

The scheduling cases of tests/test_serving_engine.py (page recycling,
EOS retirement, mid-stream admission, batched admission) are mirrored
against the port's own solo greedy decode, and every option the port
does not serve yet must raise NotImplementedError. Every metrics() key
both engines report holds the JAX engine's value on the same traffic
(the exceptions are named at the test).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     params_from_jax)
from paddle_tpu_torch.serving import ContinuousBatchingEngine

NEAR_TIE = 1e-4


def _setup(nkv=2, seed=21):
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=nkv)
    paddle.seed(seed)
    jm = JaxModel(jcfg)
    raw = dict(jm.raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=nkv)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    return jcfg, jm, raw, cfg, p


def _engine(cfg, p, **kw):
    return ContinuousBatchingEngine(cfg, p, device="cpu",
                                    dtype=torch.float32, **kw)


def _solo_greedy(model, prompt, n):
    """Greedy decode of one prompt by full forwards (no cache)."""
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([ids]))[0, -1]
            ids.append(int(torch.argmax(logits)))
    return ids[len(prompt):]


def test_engine_tokens_match_jax_engine():
    jcfg, jm, raw, cfg, p = _setup()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).tolist()
               for n in (3, 7, 9, 5, 8, 2)]
    kw = dict(slots=2, prompt_bucket=8, max_prompt_len=16,
              max_new_tokens=6, block_size=8, steps_per_sync=3,
              prefix_cache=False)
    jeng = JaxEngine(jcfg, raw, unified_step=False, dtype=jnp.float32,
                     **kw)
    teng = _engine(cfg, p, **kw)
    for pr in prompts:
        jeng.add_request(pr)
        teng.add_request(pr)
    jeng.run(max_iters=100)
    teng.run(max_iters=100)
    ours = {r.req_id: r.tokens for r in teng.finished}
    theirs = {r.req_id: r.tokens for r in jeng.finished}
    assert sorted(ours) == sorted(theirs) == list(range(len(prompts)))
    assert teng.prefill_calls == jeng.prefill_calls
    assert teng.device_steps == jeng.device_steps
    for rid, prompt in enumerate(prompts):
        a, b = ours[rid], theirs[rid]
        assert len(a) == len(b) == 6
        if a == b:
            continue
        i = next(j for j in range(6) if a[j] != b[j])
        ctx = np.asarray([prompt + b[:i]])
        logits = np.sort(np.asarray(jm(paddle.to_tensor(ctx)).numpy())[0,
                                                                     -1])
        margin = float(logits[-1] - logits[-2])
        assert margin < NEAR_TIE, (rid, i, margin)


def test_pages_recycle_through_small_pool():
    _, _, _, cfg, p = _setup()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, (5,)).tolist()
               for _ in range(6)]
    cap = (8 + 6 + 7) // 8
    max_pages = 2 * cap + 1
    eng = _engine(cfg, p, slots=2, prompt_bucket=8, max_prompt_len=8,
                  max_new_tokens=6, block_size=8, steps_per_sync=4,
                  max_pages=max_pages)
    for pr in prompts:
        eng.add_request(pr)
    eng.run(max_iters=100)
    assert len(eng.finished) == 6
    assert eng.mgr.n_free == max_pages - 1
    model = LlamaForCausalLM(cfg).load_params(p)
    for req in eng.finished:
        assert req.tokens == _solo_greedy(model, req.prompt, 6)


def test_eos_retires_early_and_frees_slot():
    _, _, _, cfg, p = _setup()
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, cfg.vocab_size, (6,)).tolist()
    model = LlamaForCausalLM(cfg).load_params(p)
    solo = _solo_greedy(model, prompt, 8)
    eos = solo[2]
    assert eos not in solo[:2]
    eng = _engine(cfg, p, slots=1, prompt_bucket=8, max_prompt_len=8,
                  max_new_tokens=8, block_size=8, steps_per_sync=8,
                  eos_token_id=eos)
    r1 = eng.add_request(prompt)
    r2 = eng.add_request(rng.integers(1, cfg.vocab_size, (4,)).tolist())
    eng.run(max_iters=100)
    assert r1.done and r2.done
    assert r1.tokens == solo[:3]
    assert eng.mgr.n_free == eng.mgr.max_pages - 1


def test_mid_stream_admission():
    _, _, _, cfg, p = _setup()
    rng = np.random.default_rng(6)
    eng = _engine(cfg, p, slots=2, prompt_bucket=8, max_prompt_len=8,
                  max_new_tokens=6, block_size=8, steps_per_sync=2)
    first = eng.add_request(rng.integers(1, cfg.vocab_size, (5,)).tolist())
    eng.step()
    assert not first.done
    late = eng.add_request(rng.integers(1, cfg.vocab_size, (3,)).tolist())
    eng.run(max_iters=100)
    assert first.done and late.done
    model = LlamaForCausalLM(cfg).load_params(p)
    assert late.tokens == _solo_greedy(model, late.prompt, 6)
    assert first.tokens == _solo_greedy(model, first.prompt, 6)


def test_batched_admission_one_call_same_tokens():
    _, _, _, cfg, p = _setup(nkv=4)   # group 1
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).tolist()
               for n in (3, 6, 5)]   # 3 rows pad to a batch of 4
    eng = _engine(cfg, p, slots=4, prompt_bucket=8, max_prompt_len=8,
                  max_new_tokens=5, block_size=8, steps_per_sync=5,
                  prefill_batch=4)
    for pr in prompts:
        eng.add_request(pr)
    eng.run(max_iters=50)
    assert eng.prefill_calls == 1
    model = LlamaForCausalLM(cfg).load_params(p)
    for req in eng.finished:
        assert req.tokens == _solo_greedy(model, req.prompt, 5)


def test_admission_limits_and_fail_fast():
    _, _, _, cfg, p = _setup()
    eng = _engine(cfg, p, slots=1, prompt_bucket=8, max_prompt_len=8,
                  max_new_tokens=16, block_size=8, steps_per_sync=2,
                  max_pages=3)
    with pytest.raises(ValueError, match="pool holds only"):
        eng.add_request([1, 2, 3])
    with pytest.raises(ValueError, match="outside"):
        eng.add_request(list(range(1, 12)))
    req = eng.add_request([1, 2, 3], max_new=1)
    eng.run(max_iters=10)
    assert req.done and len(req.tokens) == 1


def test_warm_metrics_and_cpu_launch_counts():
    _, _, _, cfg, p = _setup()
    eng = _engine(cfg, p, slots=2, prompt_bucket=8, max_prompt_len=8,
                  max_new_tokens=4, block_size=8, steps_per_sync=2)
    eng.warm()
    _build.reset_launch_counts()
    eng.add_request([5, 6, 7])
    eng.run(max_iters=10)
    m = eng.metrics()
    assert m["requests_finished"] == 1 and m["prefill_calls"] == 1
    assert m["device_steps"] == 2
    # CPU tensors take the plain versions: no kernel launched
    assert m["kernel_launches"] == {n: 0 for n in _build.COUNTERS}


# a tuned-config artifact is applied (tests/test_torch_tuner.py); one whose
# knobs ask for a serving mesh reaches the engine's process-group check:
# serving_mp / serving_cp > 1 needs the ranks the launcher starts
_MESH_ARTIFACT = dict(schema_version=1, device="h100-sxm",
                      model="llama:h64:l2:q4:kv2:d16:i128:v128",
                      space_hash="0", knobs={"serving_mp": 2})


@pytest.mark.parametrize("kwargs", [
    dict(config=_MESH_ARTIFACT),
    dict(decode_megakernel="scan", serving_mp=2),
    dict(decode_megakernel="attn", serving_cp=2),
    dict(serving_mp=2), dict(serving_cp=2)])
def test_unported_options_raise(kwargs):
    _, _, _, cfg, p = _setup()
    with pytest.raises(ValueError, match="parallel.launch"):
        _engine(cfg, p, **kwargs)


def test_weight_only_params_build():
    """Weight-only quantized params build an engine (they are served
    since the weight-only slice)."""
    _, _, _, cfg, p = _setup()
    from paddle_tpu_torch.models import decode_params
    eng = _engine(cfg, decode_params(p, "weight_only_int4"))
    assert isinstance(eng.p["lm_head.weight"], tuple)


def test_sampled_engine_with_top_k_one_is_greedy():
    """do_sample draws with the engine's seeded torch.Generator (its
    stream differs from jax.random's); top_k=1 leaves one candidate, so
    the stream must equal greedy decoding."""
    _, _, _, cfg, p = _setup()
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).tolist()
               for n in (4, 7)]

    def serve(**kw):
        eng = _engine(cfg, p, slots=2, prompt_bucket=8, max_prompt_len=8,
                      max_new_tokens=5, block_size=8, steps_per_sync=2,
                      **kw)
        for pr in prompts:
            eng.add_request(pr)
        eng.run(max_iters=20)
        return {r.req_id: r.tokens for r in eng.finished}

    assert serve(do_sample=True, top_k=1, temperature=0.8, seed=3) \
        == serve()


# metrics() keys the port does not hold equal to the JAX engine's: the
# host-time total of sync waits
METRICS_NOT_COMPARED = {"sync_wait_s"}
# mid-serve only: the port captures every step program at its first
# dispatch, the JAX engine compiles each at its first call
METRICS_NOT_COMPARED_MID_SERVE = {"compile_stats"}
# JAX's keys the port lacks: none since the comms audit ("comms_audit",
# None until an audit ran on either engine)
METRICS_ITEM_5 = set()
# reported by the port only: host timings, the kernel launch counts and
# the ranks' process-group backend (None on one device)
METRICS_PORT_ONLY = {"decode_s", "prefill_s", "kernel_launches",
                     "serving_backend"}


@pytest.mark.parametrize("unified", [False, True], ids=["split", "unified"])
def test_metrics_keys_and_values_match_jax(unified):
    """Both engines serve the same traffic (the prefix cache on, a pool
    small enough to evict): every metrics() key both report holds the
    same value, pool occupancy (`pages_in_use`, `pool_occupancy`) and the
    parallelism fields (`serving_mp` 1, `serving_cp` 1,
    `quantized_collectives` False) included, mid-serve and drained. The
    JAX engine's key the port lacks is the item-5 one; `tuned_config`
    and `warm_compile_stats` (None: no artifact, no warm()) are held
    equal."""
    jcfg, _, raw, cfg, p = _setup()
    rng = np.random.default_rng(5)
    shared = rng.integers(1, cfg.vocab_size, (8,)).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab_size, (n,)).tolist()
               for n in (3, 6, 2, 7)] \
        + [rng.integers(1, cfg.vocab_size, (n,)).tolist()
           for n in (5, 9, 12, 16, 10)]
    kw = dict(slots=2, prompt_bucket=8, max_prompt_len=16,
              max_new_tokens=5, block_size=8, steps_per_sync=2,
              max_pages=7, unified_step=unified)
    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, **kw)
    teng = _engine(cfg, p, **kw)
    for e in (jeng, teng):
        # every counted readback blocked: blocked_syncs is a count
        e.stall_threshold_s = -1.0
        for pr in prompts:
            e.add_request(pr)

    def compare(skip=frozenset()):
        mj, mt = jeng.metrics(), teng.metrics()
        assert set(mj) - set(mt) == METRICS_ITEM_5
        assert set(mt) - set(mj) == METRICS_PORT_ONLY
        both = set(mj) & set(mt) - METRICS_NOT_COMPARED - skip
        assert {k: mt[k] for k in both} == {k: mj[k] for k in both}
        return mt

    for _ in range(3):
        jeng.step()
        teng.step()
        mid = compare(METRICS_NOT_COMPARED_MID_SERVE)
    assert mid["pages_in_use"] > 1 and 0 < mid["pool_occupancy"] < 1
    jeng.run(max_iters=200)
    teng.run(max_iters=200)
    end = compare()
    assert (end["serving_mp"], end["serving_cp"],
            end["quantized_collectives"]) == (1, 1, False)
    assert end["prefix_evictions"] > 0 and end["blocked_syncs"] > 0
    # drained: the scratch page is the one page not reclaimable
    assert end["pages_in_use"] == 1
