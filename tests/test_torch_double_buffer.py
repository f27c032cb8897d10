"""The port's double-buffered scheduler and its engine programs against the
JAX engine, on the CPU, in f32 on ``LlamaConfig.tiny()``.

Engines: each case serves the same traffic through the JAX engine with
``double_buffer=True``, the port's engine with ``double_buffer=True`` and
the port's synchronous engine, on the same weights (``params_from_jax``),
with ``unified_step`` pinned. The port's two schedules must give
identical tokens (the pipeline changes when host work happens, never
what the device computes). Against the JAX engine a divergence is
allowed only where the JAX model's top-2 logit margin is below 1e-4 (a
near-tie that summation order may break either way, the rule of
tests/test_torch_engine.py), and the scheduling counters must be equal:
the pipeline dispatches the same chunks as the JAX engine's. The cases
are the JAX engine's double-buffer tests (tests/test_serving_engine.py
``TestDoubleBuffer``, tests/test_unified_step.py
``test_db_and_disaggregated_identity``) and every pool dtype, megakernel
rung (their plain versions on the CPU) and weight kind.

Plumbing: the chain's override mask after admission and retirement, the
alternating host-buffer sets, ``compile_stats()`` and the sync-wait
counters, and the launch accounting of a replayed program (a fake graph
stands in for the card's CUDA graph).
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
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from paddle_tpu_torch.serving.engine import _Program

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


@pytest.fixture(scope="module")
def model():
    return _setup()


def _np_pairs(dec):
    return {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else np.asarray(v) for k, v in dec.items()}


def _port(cfg, p, **kw):
    return ContinuousBatchingEngine(cfg, p, device="cpu",
                                    dtype=torch.float32, **kw)


def _serve(eng, prompts, max_new=None):
    """Serve `prompts` (max_new per request from `max_new(i)`, else the
    engine budget) and check the pool drains."""
    reqs = [eng.add_request(pr, max_new=max_new(i) if max_new else None)
            for i, pr in enumerate(prompts)]
    eng.run(max_iters=500)
    assert all(r.done for r in reqs)
    assert eng.mgr.n_available == eng.mgr.max_pages - 1   # drained
    return {r.req_id: list(r.tokens) for r in reqs}


def _jax_logits(jcfg, jdec, ids):
    """Teacher-forced JAX logits of the last position over the decode
    params (dense or weight-only pairs)."""
    h, _ = jl._make_prefill(jcfg, 1, len(ids))(jdec,
                                              jnp.asarray([ids], jnp.int32))
    return np.asarray(jl._make_head_logits(jcfg)(h, jdec))[0, -1]


def _assert_same_up_to_ties(jcfg, jdec, prompts, ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for rid, prompt in enumerate(prompts):
        a, b = ours[rid], theirs[rid]
        assert len(a) == len(b)
        if a != b:
            i = next(j for j in range(len(a)) if a[j] != b[j])
            row = np.sort(_jax_logits(jcfg, jdec, prompt + b[:i]))
            assert float(row[-1] - row[-2]) < NEAR_TIE, (rid, i)


def _churn_prompts(vocab):
    """tests/test_serving_engine.py TestDoubleBuffer's churn trace: six
    prompts sharing an 8-token head through two slots and a pool small
    enough to recycle pages."""
    rng = np.random.default_rng(3)
    shared = rng.integers(1, vocab, (8,)).tolist()
    return [shared + rng.integers(1, vocab, (n,)).tolist()
            for n in (3, 7, 2, 5, 6, 4)]


def _row_class_prompts(vocab, rng):
    """tests/test_unified_step.py's trace: cached-prefix rows, cold short
    rows and chunked rows wider than the 8-token budget."""
    shared = rng.integers(1, vocab, (8,)).tolist()
    return ([shared + rng.integers(1, vocab, (n,)).tolist()
             for n in (3, 7, 2)]
            + [rng.integers(1, vocab, (n,)).tolist() for n in (5, 2)]
            + [rng.integers(1, vocab, (n,)).tolist() for n in (30, 22, 17)])


COUNTERS = ("prefill_calls", "device_steps", "prefill_chunks",
            "chunk_tokens", "prompt_tokens", "prefix_hit_tokens",
            "prefix_inserts")


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def test_db_split_prefix_churn_matches_jax_and_sync(model):
    """The split path with the prefix cache, double-buffered, through a
    pool that forces retire / recycle churn: the JAX engine's tokens and
    chunks, the synchronous port engine's tokens (on the cold path, as the
    JAX test holds it), no fewer chunks than it, and a drained pool."""
    jcfg, _, raw, cfg, p = model
    prompts = _churn_prompts(cfg.vocab_size)
    kw = dict(slots=2, prompt_bucket=8, max_prompt_len=16,
              max_new_tokens=6, block_size=8, steps_per_sync=3,
              prefill_batch=2, unified_step=False)
    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, prefix_cache=True,
                     double_buffer=True, **kw)
    theirs = _serve(jeng, prompts)
    db = _port(cfg, p, prefix_cache=True, double_buffer=True, **kw)
    ours = _serve(db, prompts)
    sync = _port(cfg, p, prefix_cache=False, **kw)
    _assert_same_up_to_ties(jcfg, raw, prompts, ours, theirs)
    _assert_same_up_to_ties(jcfg, raw, prompts, ours, _serve(sync, prompts))
    for name in COUNTERS:
        assert getattr(db, name) == getattr(jeng, name), name
    assert db.prefix_hit_tokens > 0
    # the speculative pipeline dispatches more chunks than the
    # synchronous engine commits, never fewer
    assert db.device_steps >= sync.device_steps


def test_db_eos_mid_chunk_stale_tokens_discarded(model):
    """A row that hits EOS inside chunk N keeps generating in the already
    dispatched chunk N+1; the readback discards that stale output while
    the freed slot serves the next request (tests/test_serving_engine.py
    TestDoubleBuffer)."""
    jcfg, jm, raw, cfg, p = model
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, cfg.vocab_size, (6,)).tolist()
    solo = jm.jit_generate(paddle.to_tensor(np.asarray([prompt])),
                           max_new_tokens=8, bucket_size=8).numpy()[0][6:]
    eos = int(solo[2])                      # the 3rd greedy token as EOS
    assert eos not in solo[:2].tolist()
    second = rng.integers(1, cfg.vocab_size, (4,)).tolist()
    kw = dict(slots=1, prompt_bucket=8, max_prompt_len=8, max_new_tokens=8,
              block_size=8, steps_per_sync=2, eos_token_id=eos,
              double_buffer=True, unified_step=False)
    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, **kw)
    eng = _port(cfg, p, **kw)
    theirs = _serve(jeng, [prompt, second])
    ours = _serve(eng, [prompt, second])
    assert ours[0] == solo[:3].tolist()     # ends AT eos
    assert len(ours[1]) == 8
    _assert_same_up_to_ties(jcfg, raw, [prompt, second], ours, theirs)
    assert eng.device_steps == jeng.device_steps


def test_db_unified_matches_jax_and_sync(model):
    """The unified step double-buffered: pure-decode chunks pipeline
    between mixed steps, each mixed step drains the chunk in flight
    (tests/test_unified_step.py test_db_and_disaggregated_identity)."""
    jcfg, _, raw, cfg, p = model
    prompts = _row_class_prompts(cfg.vocab_size, np.random.default_rng(11))
    kw = dict(slots=2, prompt_bucket=8, max_prompt_len=32,
              max_new_tokens=6, block_size=8, steps_per_sync=3,
              prefix_cache=True, unified_step=True)

    def max_new(i):
        return 2 + i % 4

    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, double_buffer=True, **kw)
    theirs = _serve(jeng, prompts, max_new)
    db = _port(cfg, p, double_buffer=True, **kw)
    ours = _serve(db, prompts, max_new)
    sync = _port(cfg, p, **kw)
    assert ours == _serve(sync, prompts, max_new)
    _assert_same_up_to_ties(jcfg, raw, prompts, ours, theirs)
    for name in COUNTERS:
        assert getattr(db, name) == getattr(jeng, name), name
    assert db.prefill_chunks > len(prompts) and db.prefix_hit_tokens > 0


# (weights, megakernel rung, pool dtype, unified): both pool dtypes on
# both schedulers, every rung, dense, int8 and int4 weights
RUNS = [
    ("dense", "off", "int8", False),
    ("dense", "off", "int8", True),
    ("dense", "attn", "bf16", False),
    ("dense", "full", "int8", True),
    ("dense", "scan", "bf16", False),
    ("dense", "scan", "int8", True),
    ("weight_only_int8", "off", "bf16", True),
    ("weight_only_int4", "off", "int8", False),
]


def _mk_prompts(vocab):
    """tests/test_torch_megakernel.py's traffic: two rows sharing an
    8-token head, five cold rows."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, vocab, (8,)).tolist()
    return ([shared + rng.integers(1, vocab, (n,)).tolist() for n in (3, 5)]
            + [rng.integers(1, vocab, (n,)).tolist()
               for n in (2, 9, 14, 4, 11)])


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_db_engines_match_jax_and_sync(model, run):
    """Each pool dtype, rung and weight kind double-buffered: the JAX
    engine's double-buffered tokens and chunks, the synchronous port
    engine's tokens; the synchronous engine then serves the same traffic
    again through run(double_buffer=True) to the same tokens."""
    weights, rung, kv, unified = run
    jcfg, jm, raw, cfg, _ = model
    jdec = raw if weights == "dense" else jm._decode_params(raw, weights)
    p = params_from_jax(_np_pairs(jdec), device="cpu")
    prompts = _mk_prompts(cfg.vocab_size)
    kw = dict(slots=2, prompt_bucket=8, max_prompt_len=16,
              max_new_tokens=6, block_size=8, steps_per_sync=3,
              prefill_batch=1, prefix_cache=True, kv_cache_dtype=kv,
              decode_megakernel=rung, unified_step=unified)

    def max_new(i):
        return 2 + i % 4

    jeng = JaxEngine(jcfg, jdec, dtype=jnp.float32, double_buffer=True,
                     **kw)
    theirs = _serve(jeng, prompts, max_new)
    db = _port(cfg, p, double_buffer=True, **kw)
    assert db.megakernel_rung == jeng.megakernel_rung == rung
    ours = _serve(db, prompts, max_new)
    sync = _port(cfg, p, **kw)
    assert ours == _serve(sync, prompts, max_new)
    _assert_same_up_to_ties(jcfg, jdec, prompts, ours, theirs)
    for name in COUNTERS:
        assert getattr(db, name) == getattr(jeng, name), name
    # an engine built without double_buffer pipelines on request
    n0 = len(sync.finished)
    for i, pr in enumerate(prompts):
        sync.add_request(pr, max_new=max_new(i))
    sync.run(max_iters=500, double_buffer=True)
    again = [r.tokens for r in sync.finished[n0:]]
    assert sorted(again) == sorted(ours.values())
    assert sync.mgr.n_available == sync.mgr.max_pages - 1


# ---------------------------------------------------------------------------
# the plumbing
# ---------------------------------------------------------------------------

def _small(cfg, p, **kw):
    return _port(cfg, p, **{**dict(slots=2, prompt_bucket=8,
                                   max_prompt_len=8, max_new_tokens=5,
                                   block_size=8, steps_per_sync=2), **kw})


def test_override_mask_after_admission_and_retirement(model):
    """Admission and retirement mark their slot for the host's values; a
    chained dispatch clears the mask and chains from the decode program's
    outputs; a synchronous dispatch invalidates the chain. A request that
    arrives mid-stream into a slot that never served must be marked too,
    or it would chain from that slot's frozen outputs."""
    _, _, _, cfg, p = model
    eng = _small(cfg, p, prefix_cache=False)
    assert eng._override.all() and eng._chain_tok is None
    a = eng.add_request([5, 6, 7], max_new=3)
    eng._admit()
    assert eng._override[a.slot]
    rec = eng._dispatch_chunk(chain=True)
    assert not eng._override.any()
    out, lens, _ = eng._programs["decode"].outputs
    assert torch.equal(eng._chain_tok, out[:, -1])
    assert eng._chain_lens is lens
    b = eng.add_request([9, 10], max_new=5)
    eng._admit()
    assert b.slot != a.slot and eng._override[b.slot]
    assert not eng._override[a.slot]
    eng._commit_chunk(rec)                  # 1 + 2 tokens: a retires
    assert a.done and eng._override[a.slot]
    eng._dispatch_chunk(chain=False)
    assert eng._override.all() and eng._chain_tok is None


def test_chained_inputs_take_host_values_only_where_overridden(model):
    """The device-side where: a slot the host left alone rides the last
    chunk's token and length, a slot the host changed takes the host's."""
    _, _, _, cfg, p = model
    eng = _small(cfg, p, prefix_cache=False, max_new_tokens=5)
    for pr in ([5, 6, 7], [8, 9]):
        eng.add_request(pr, max_new=5)
    eng._admit()
    rec = eng._dispatch_chunk(chain=True)
    out = eng._chain_tok.clone()
    lens = eng._chain_lens.clone()
    eng._tokens[:] = (99, 77)       # only slot 1's is taken
    eng._override[1] = True
    eng._dispatch_chunk(chain=True)
    toks_in, lens_in = eng._programs["decode"].inputs[:2]
    assert int(toks_in[0]) == int(out[0]) and int(out[0]) != 99
    assert int(lens_in[0]) == int(lens[0]) == eng._slots[0].length + 2
    assert int(toks_in[1]) == 77
    assert int(lens_in[1]) == eng._slots[1].length
    eng._commit_chunk(rec)


def test_host_sets_alternate(model):
    """Consecutive dispatches use the two host sets in turn, so chunk N's
    outputs are never overwritten by chunk N+1's copies."""
    _, _, _, cfg, p = model
    eng = _small(cfg, p, prefix_cache=False, max_new_tokens=5)
    eng.add_request([5, 6, 7], max_new=5)
    eng._admit()
    r1 = eng._dispatch_chunk(chain=True)
    r2 = eng._dispatch_chunk(chain=True)
    assert r1["host"] is not r2["host"]
    first = [t.clone() for t in r1["host"].outputs]
    eng._commit_chunk(r1)
    r3 = eng._dispatch_chunk(chain=True)
    assert r3["host"] is r1["host"]
    assert not all(torch.equal(a, b)
                   for a, b in zip(first, r3["host"].outputs))
    sets = eng._host["decode"].sets
    assert len(sets) == 2 and sets[0].event is None   # no events on CPU
    # the decode program's host set mirrors its inputs plus the chain mask
    assert len(sets[0].inputs) == len(eng._programs["decode"].inputs) + 1


@pytest.mark.parametrize("unified", [False, True], ids=["split", "unified"])
def test_compile_stats_and_sync_wait(model, unified):
    """compile_stats() counts each program's captures: none before
    warm(), one after (on the split path also one per prefill program
    warm() makes for its default bucket, max_prompt_len: batches 1 and 2,
    cold and at the one prefix width), unchanged by traffic.
    sync_wait_s / blocked_syncs take the JAX engine's rule: they count
    decode and verify readbacks only, never a prefill's first-token
    readback. With a negative stall threshold every counted readback is
    blocked, so the port's blocked_syncs must equal the JAX engine's on
    the same traffic, and the metrics registry's blocked_syncs counter
    must agree with metrics()."""
    from paddle_tpu_torch.observability import MetricsRegistry

    jcfg, _, raw, cfg, p = model
    kw = dict(slots=2, prompt_bucket=8, max_prompt_len=8, max_new_tokens=5,
              block_size=8, steps_per_sync=2, unified_step=unified)
    reg = MetricsRegistry()
    eng = _port(cfg, p, metrics=reg, **kw)
    want = {"decode": 1, "unified": 1} if unified else {"decode": 1}
    assert eng.compile_stats() == {k: 0 for k in want}
    if not unified:
        want.update({"prefill:" + ":".join(map(str, eng._prefill_key(*k))): 1
                     for k in (("cold", 8, 1), ("prefix", 8, 1, 1),
                               ("cold", 8, 2), ("prefix", 8, 2, 1))})
    eng.warm()
    eng.warm()
    assert eng.compile_stats() == want
    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, double_buffer=True, **kw)
    prompts = ([5, 6, 7], [8, 9, 10, 11], [3, 4])
    for e in (eng, jeng):
        e.stall_threshold_s = -1.0
        for pr in prompts:
            e.add_request(pr)
    eng.run(max_iters=50, double_buffer=True)
    jeng.run(max_iters=50)
    m, jm = eng.metrics(), jeng.metrics()
    assert m["compile_stats"] == want
    assert m["sync_wait_s"] == eng.sync_wait_s >= 0.0
    assert (m["sync_wait_s"] > 0.0) == (jm["sync_wait_s"] > 0.0)
    assert m["blocked_syncs"] == jm["blocked_syncs"] == eng.blocked_syncs
    assert m["blocked_syncs"] == reg.counter("blocked_syncs").value
    # one counted readback per committed chunk (a mixed step's window and
    # decode lane are one), none for the prefills
    assert m["device_steps"] == jm["device_steps"]
    assert 1 <= m["blocked_syncs"] <= m["device_steps"]


class _FakeGraph:
    def __init__(self, fail=False):
        self.replays = 0
        self.fail = fail

    def replay(self):
        if self.fail:
            raise RuntimeError("CUDA error: an illegal memory access")
        self.replays += 1


class _FakeProgram(_Program):
    """A program 'captured' on the CPU: its body counts launches the way a
    wrapper does on the card, its graph only counts replays."""

    def __init__(self, body, inputs, fail=None):
        super().__init__("decode", body, inputs)
        self.site.graphed = True
        self.fail = fail

    def _warm_up(self, stream):
        self.body(*self.inputs)

    def _record(self, pool, stream):
        outputs = self.body(*self.inputs)
        if self.fail == "capture":
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return _FakeGraph(self.fail == "replay"), outputs


def _counting_body(x):
    _build.LAUNCHES["rms_norm"] += 2
    _build.LAUNCHES["paged_decode_attention"] += 1
    return (x + 1,)


def test_replay_adds_the_captured_launch_delta():
    """The warm-up counts its launches, the recording none; each replay
    adds the delta stored at capture."""
    _build.reset_launch_counts()
    prog = _FakeProgram(_counting_body, (torch.zeros(3),))
    with pytest.raises(RuntimeError, match="never captured"):
        prog()
    prog.capture()
    got = _build.launch_counts()
    assert (got["rms_norm"], got["paged_decode_attention"]) == (2, 1)
    assert prog.launches == {"rms_norm": 2, "paged_decode_attention": 1}
    assert prog.captures == 1
    for _ in range(3):
        assert prog()[0].tolist() == [1.0, 1.0, 1.0]
    got = _build.launch_counts()
    assert (got["rms_norm"], got["paged_decode_attention"]) == (8, 4)
    assert prog.graph.replays == 3
    _build.reset_launch_counts()


@pytest.mark.parametrize("fail", ["capture", "replay"])
def test_failed_capture_or_replay_raises_with_the_program_name(fail):
    _build.reset_launch_counts()
    prog = _FakeProgram(_counting_body, (torch.zeros(3),), fail=fail)
    if fail == "capture":
        with pytest.raises(RuntimeError, match="capturing the engine's "
                                               "decode program"):
            prog.capture()
        assert prog.captures == 0 and prog.graph is None
        # the aborted recording counted nothing
        assert _build.launch_counts()["rms_norm"] == 2
    else:
        prog.capture()
        with pytest.raises(RuntimeError, match="replaying the engine's "
                                               "decode program"):
            prog()
        assert _build.launch_counts()["rms_norm"] == 2
    _build.reset_launch_counts()


def test_engine_launch_counts_add_the_delta_per_dispatch(model):
    """An engine whose decode program replays a (fake) graph: every
    dispatch adds the launches its capture counted to metrics()."""
    _, _, _, cfg, p = model
    eng = _small(cfg, p, prefix_cache=False)
    real = eng._programs["decode"]

    def body(*ins):
        _build.LAUNCHES["paged_decode_attention"] += 4
        return real.body(*ins)

    fake = _FakeProgram(body, real.inputs)
    eng._programs["decode"] = fake
    eng.warm()
    assert fake.launches == {"paged_decode_attention": 4}
    _build.reset_launch_counts()
    for pr in ([5, 6, 7], [8, 9]):
        eng.add_request(pr)
    eng.run(max_iters=20)
    assert eng.device_steps == fake.graph.replays > 0
    assert eng.metrics()["kernel_launches"]["paged_decode_attention"] \
        == 4 * eng.device_steps
    _build.reset_launch_counts()
