"""The port's prefill/decode disaggregation against the JAX engine, on the
CPU, in f32 on ``LlamaConfig.tiny()`` with two kv heads.

With ``disaggregated=True`` admission prefills up to `slots` requests
ahead into a handoff queue and decode slots take them FIFO as they free;
the pools are shared, so the handoff is bookkeeping. Each run serves the
same traffic through the JAX engine and the port's with
``disaggregated=True`` (and the port's engine without it): tokens equal
up to the JAX model's near-ties (tests/test_torch_engine.py's rule), equal
to the port's non-disaggregated tokens, and equal prefill_handoffs,
prefill_calls, device_steps and chunk counters. The runs cover the split
path and the unified step, bf16 (f32 here) and int8 pools, with and
without ``double_buffer`` and speculation (one with int8 weights and
n-gram depth 8), and traffic in which one request's first token is EOS
and one asks for a single token: both retire at the handoff without ever
taking a decode slot.
"""
import dataclasses

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
from paddle_tpu_torch.serving import ContinuousBatchingEngine

NEAR_TIE = 1e-4
COUNTERS = ("prefill_handoffs", "prefill_calls", "device_steps",
            "prefill_chunks", "chunk_tokens", "prompt_tokens",
            "prefix_hit_tokens", "prefix_inserts", "spec_steps",
            "spec_drafted", "spec_accepted")


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=2)
    paddle.seed(21)
    jm = JaxModel(jcfg)
    raw = dict(jm.raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    return jcfg, jm, raw, cfg


def _np_pairs(dec):
    return {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v) for k, v in dec.items()}


def _port(cfg, p, **kw):
    return ContinuousBatchingEngine(cfg, p, device="cpu",
                                    dtype=torch.float32, **kw)


def _prompts(vocab):
    """Two slots' worth of churn: rows sharing a 16-token head (prefix
    hits), a repeated phrase (n-gram drafts) and cold rows, more requests
    than slots so the handoff queue fills."""
    rng = np.random.default_rng(17)
    shared = rng.integers(1, vocab, (16,)).tolist()
    phrase = rng.integers(1, vocab, (5,)).tolist()
    return ([shared + phrase * 2 + rng.integers(1, vocab, (n,)).tolist()
             for n in (2, 6, 3)]
            + [rng.integers(1, vocab, (n,)).tolist() for n in (4, 9, 21, 3)])


def _serve(eng, prompts, max_new):
    reqs = [eng.add_request(pr, max_new=m) for pr, m in zip(prompts,
                                                           max_new)]
    eng.run(max_iters=1000)
    assert all(r.done for r in reqs) and not eng.has_work
    assert eng.mgr.n_available == eng.mgr.max_pages - 1   # drained
    return reqs


def _jax_logits(jcfg, jdec, ids):
    h, _ = jl._make_prefill(jcfg, 1, len(ids))(jdec,
                                              jnp.asarray([ids], jnp.int32))
    return np.asarray(jl._make_head_logits(jcfg)(h, jdec))[0, -1]


def _assert_same_up_to_ties(jcfg, jdec, prompts, ours, theirs):
    for prompt, a, b in zip(prompts, ours, theirs):
        assert len(a) == len(b)
        if a != b:
            i = next(j for j in range(len(a)) if a[j] != b[j])
            row = np.sort(_jax_logits(jcfg, jdec, prompt + b[:i]))
            assert float(row[-1] - row[-2]) < NEAR_TIE, i


# (unified, pool dtype, double_buffer, speculative, weights, eos/max_new=1
#  requests)
RUNS = [
    (False, "bf16", False, "off", "dense", True),
    (True, "int8", True, "off", "dense", False),
    (False, "int8", True, "ngram", "weight_only_int8", False),
    (True, "bf16", False, "ngram", "dense", True),
]


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_disaggregated_matches_jax(model, run):
    unified, kv, db, spec, weights, edge = run
    jcfg, jm, raw, cfg = model
    jdec = raw if weights == "dense" else jm._decode_params(raw, weights)
    p = params_from_jax(_np_pairs(jdec), device="cpu")
    prompts = _prompts(cfg.vocab_size)
    max_new = [6] * len(prompts)
    kw = dict(slots=2, prompt_bucket=8, max_prompt_len=32,
              max_new_tokens=6, block_size=8, steps_per_sync=3,
              prefill_batch=2, prefix_cache=True, unified_step=unified,
              kv_cache_dtype=kv, double_buffer=db, speculative=spec,
              spec_k=8 if weights != "dense" else 4)
    if edge:
        # request 4's first token becomes EOS and request 5 asks for one
        # token: both finish at their prefill
        first = _serve(_port(cfg, p, **kw), prompts, max_new)
        kw["eos_token_id"] = first[4].tokens[0]
        max_new[5] = 1
    base = _serve(_port(cfg, p, **kw), prompts, max_new)
    jeng = JaxEngine(jcfg, jdec, dtype=jnp.float32, disaggregated=True,
                     **kw)
    theirs = _serve(jeng, prompts, max_new)
    eng = _port(cfg, p, disaggregated=True, **kw)
    ours = _serve(eng, prompts, max_new)
    assert [r.tokens for r in ours] == [r.tokens for r in base]
    _assert_same_up_to_ties(jcfg, jdec, prompts, [r.tokens for r in ours],
                            [r.tokens for r in theirs])
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng.metrics()["prefill_handoffs"] == eng.prefill_handoffs \
        == len(prompts)
    assert eng.prefix_hit_tokens > 0
    if spec != "off":
        assert eng.spec_accepted > 0
    if edge:
        # finished at the handoff: one token, never a decode slot
        for r in (ours[4], ours[5]):
            assert r.tokens == [r.tokens[0]] and r.slot is None
        assert ours[4].tokens == [kw["eos_token_id"]]
        assert all(r.slot is not None for i, r in enumerate(ours)
                   if i not in (4, 5))


def test_handoff_headroom_and_install(model):
    """Split admission is bounded by handoff headroom (slots - parked),
    not by free slots: with both slots busy, admission still prefills up
    to `slots` requests ahead; each step installs parked requests FIFO
    into the slots that free."""
    jcfg, _, raw, cfg = model
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    eng = _port(cfg, p, slots=2, prompt_bucket=8, max_prompt_len=16,
                max_new_tokens=6, block_size=8, steps_per_sync=2,
                prefill_batch=4, prefix_cache=False, max_pages=16,
                disaggregated=True)
    reqs = [eng.add_request([3 + i, 5, 7, 9], max_new=6) for i in range(6)]
    eng._admit()
    assert eng.prefill_calls == 1 and len(eng._handoff) == 2
    assert eng.n_active == 0 and eng.has_work
    eng._install_handoffs()
    assert [s.req for s in eng._slots] == reqs[:2] and not eng._handoff
    eng._admit()                    # both slots busy: 2 more prefill ahead
    assert [r.req_id for r in eng._handoff] == [2, 3]
    eng._admit()                    # headroom spent
    assert eng.prefill_calls == 2 and len(eng.waiting) == 2
    eng.run(max_iters=200)
    assert all(r.done for r in reqs) and eng.prefill_handoffs == 6
    assert eng.metrics()["prefill_handoffs"] == 6
