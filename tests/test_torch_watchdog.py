"""The port's watchdog (paddle_tpu_torch.resilience.watchdog) and the
engine's ``run(watchdog_timeout=, requeue_hung=)`` on the CPU, against
the JAX package.

``hang:decode:S`` (chaos) stalls the first decode dispatch for S seconds
under a deadline D < S, through the JAX engine and the port's engine
(f32, ``LlamaConfig.tiny()``, the same weights), on the split and the
unified path, synchronous and double-buffered, retiring or requeueing
the victim (and once on the speculative path). The two engines must
agree on hung_retired / hung_requeued,
the victim, every request's tokens (the survivors' and, requeued, the
victim's), and the chain of events in the metrics log (chaos.hang ->
watchdog.timeout -> watchdog.retire_hung_slot or requeue_hung_slot).
After the abandoned thread has unwound (S waited out) the port engine's
state is unchanged. Deadlines are 1.5 s: a warmed step of these engines
takes milliseconds.
"""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.resilience import chaos as jax_chaos
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.chaos import ChaosHang
from paddle_tpu_torch.resilience.watchdog import StepTimeout, Watchdog
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from paddle_tpu_torch.serving.engine import _AbandonedStep

DEADLINE = 1.5
HANG = 2.5


# ---------------------------------------------------------------------------
# the watchdog alone
# ---------------------------------------------------------------------------

def test_timeout_carries_phase():
    wd = Watchdog(0.15, name="train.step")

    def hang():
        wd.phase = "allreduce"
        time.sleep(1.0)

    t0 = time.monotonic()
    with pytest.raises(StepTimeout) as ei:
        wd.call(hang)
    assert time.monotonic() - t0 < 0.9
    assert ei.value.phase == "allreduce" and ei.value.name == "train.step"
    assert wd.timeouts == 1


def test_fast_call_and_exception_pass_through():
    wd = Watchdog(5.0)
    assert wd.call(lambda a, b: a + b, 2, 3) == 5

    def boom():
        raise ValueError("inner")

    with pytest.raises(ValueError, match="inner"):
        wd.call(boom)
    assert wd.timeouts == 0
    with pytest.raises(ValueError, match="timeout_s"):
        Watchdog(0.0)


def test_wrap_and_timeout_event():
    reg = obs_metrics.enable()
    try:
        slow = Watchdog(0.1, name="w").wrap(lambda: time.sleep(0.5))
        with pytest.raises(StepTimeout):
            slow()
        (ev,) = reg.events("watchdog.timeout")
        assert ev["watchdog"] == "w" and ev["timeout_s"] == 0.1
    finally:
        obs_metrics.disable()


def test_chaos_hang_fires_once_then_raises():
    m = chaos.ChaosMonkey("hang:decode:0.05")
    t0 = time.monotonic()
    with pytest.raises(ChaosHang):
        m.maybe_hang("decode")
    assert time.monotonic() - t0 >= 0.05
    m.maybe_hang("decode")          # fired: a no-op now
    m.maybe_hang("prefill")         # another seam: never armed
    assert m.counters == {"hang": 1}


def test_chaos_grammar_matches_jax():
    spec = ("io_error:0.25:shard_read,preempt_at:10,hang:decode:1.5,"
            "corrupt:0.5,preempt_host:1@7,kill_worker:2@3")
    ours, theirs = chaos.ChaosMonkey(spec, 4), jax_chaos.ChaosMonkey(spec, 4)
    assert [vars(f) for f in ours.faults] == [vars(f) for f in theirs.faults]
    data = bytes(range(64))
    assert ours.corrupt("ckpt.write", data) \
        == theirs.corrupt("ckpt.write", data)
    with pytest.raises(ValueError, match="unknown chaos fault"):
        chaos.ChaosMonkey("explode:1")
    with pytest.raises(ValueError, match="K@N"):
        chaos.ChaosMonkey("kill_worker:3")
    with pytest.raises(chaos.ChaosKilled):
        chaos.ChaosMonkey("kill_worker:2@3").maybe_kill_worker(2, 3)


def test_chaos_armed_from_flags_and_environment(monkeypatch):
    chaos.uninstall()
    assert chaos.get_chaos() is None
    set_flags({"tpu_chaos": "io_error:1.0:only_here", "tpu_chaos_seed": 3})
    try:
        with pytest.raises(chaos.ChaosError):
            chaos.maybe_io_error("only_here")
        chaos.maybe_io_error("elsewhere")
        assert chaos.get_chaos().seed == 3
    finally:
        set_flags({"tpu_chaos": "", "tpu_chaos_seed": 0})
        chaos.uninstall()
    monkeypatch.setenv("PADDLE_TPU_CHAOS", "hang:x:0.01")
    assert chaos.get_chaos().faults[0].kind == "hang"
    monkeypatch.delenv("PADDLE_TPU_CHAOS")
    chaos.uninstall()
    assert chaos.get_chaos() is None


# ---------------------------------------------------------------------------
# the engine under hang:decode, against the JAX engine
# ---------------------------------------------------------------------------

KW = dict(slots=2, prompt_bucket=8, max_prompt_len=16, max_new_tokens=4,
          block_size=8, steps_per_sync=2, prefix_cache=False)


@pytest.fixture(scope="module")
def engines():
    """One warmed JAX engine and one port engine per path, reused by
    every scenario (a drained engine holds no request), with a metrics
    registry each that the chaos and watchdog seams report to too."""
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=2)
    paddle.seed(21)
    raw = dict(JaxModel(jcfg).raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    jreg, reg = jax_metrics.enable(), obs_metrics.enable()
    out = {}
    for path, kw in (("split", dict(unified_step=False)),
                     ("unified", dict(unified_step=True)),
                     ("spec", dict(unified_step=False,
                                   speculative="ngram", spec_k=2))):
        jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, metrics=jreg,
                         **KW, **kw)
        eng = ContinuousBatchingEngine(cfg, p, device="cpu",
                                       dtype=torch.float32, metrics=reg,
                                       **KW, **kw)
        for e in (jeng, eng):
            e.warm(buckets=[8])
        out[path] = (jeng, eng)
    out["regs"] = (jreg, reg)
    out["cfg"] = cfg
    yield out
    jax_metrics.disable()
    obs_metrics.disable()
    jax_chaos.uninstall()
    chaos.uninstall()


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(1, cfg.vocab_size, (n,)).tolist()
            for n in (5, 7, 6)]


def _hung_run(eng, reg, install, prompts, db, requeue):
    """Serve `prompts` under one `hang:decode` and the deadline; returns
    the requests, the counters' growth and the events logged."""
    n_ev = len(reg.events())
    before = (eng.hung_retired, eng.hung_requeued)
    reqs = [eng.add_request(pr) for pr in prompts]
    install(f"hang:decode:{HANG}")
    t0 = time.monotonic()
    eng.run(max_iters=200, watchdog_timeout=DEADLINE, double_buffer=db,
            requeue_hung=requeue)
    wall = time.monotonic() - t0
    grown = (eng.hung_retired - before[0], eng.hung_requeued - before[1])
    return reqs, grown, [e["event"] for e in reg.events()[n_ev:]], wall


@pytest.mark.parametrize("requeue", [False, True], ids=["retire", "requeue"])
@pytest.mark.parametrize("db", [False, True], ids=["sync", "db"])
@pytest.mark.parametrize("path", ["split", "unified"])
def test_hung_step_matches_jax(engines, path, db, requeue):
    jeng, eng = engines[path]
    jreg, reg = engines["regs"]
    prompts = _prompts(engines["cfg"])
    jreqs, jgrown, jevents, _ = _hung_run(jeng, jreg, jax_chaos.install,
                                          prompts, db, requeue)
    reqs, grown, events, wall = _hung_run(eng, reg, chaos.install, prompts,
                                          db, requeue)
    assert wall < DEADLINE + HANG       # the live loop never waited it out
    assert grown == jgrown == ((0, 1) if requeue else (1, 0))
    assert [r.failed for r in reqs] == [r.failed for r in jreqs]
    assert [r.requeued for r in reqs] == [r.requeued for r in jreqs]
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert events == jevents
    assert events[:2] == ["chaos.hang", "watchdog.timeout"]
    assert events[2] == ("watchdog.requeue_hung_slot" if requeue
                         else "watchdog.retire_hung_slot")
    assert all(r.done for r in reqs)
    if requeue:
        assert not any(r.failed for r in reqs)
        assert all(len(r.tokens) == KW["max_new_tokens"] for r in reqs)
    else:
        (victim,) = [r for r in reqs if r.failed]
        assert "deadline" in victim.error
    assert eng.mgr.n_available == eng.mgr.max_pages - 1
    # the abandoned thread unwinds once the hang has elapsed: it
    # touches nothing
    state = ([list(r.tokens) for r in reqs], eng.device_steps,
             eng.prefill_calls, eng.mgr.n_available, len(eng.finished))
    time.sleep(max(0.0, HANG - wall) + 0.2)
    assert state == ([list(r.tokens) for r in reqs], eng.device_steps,
                     eng.prefill_calls, eng.mgr.n_available,
                     len(eng.finished))


def test_hung_speculative_step_matches_jax(engines):
    """The same hang on the speculative path (n-gram drafts, the verify
    window): the JAX engine's victim, tokens and events."""
    jeng, eng = engines["spec"]
    jreg, reg = engines["regs"]
    prompts = _prompts(engines["cfg"])
    prompts[1] = (prompts[1][:3] * 3)[:7]       # repetitive: drafts hit
    jreqs, jgrown, jevents, _ = _hung_run(jeng, jreg, jax_chaos.install,
                                          prompts, False, False)
    reqs, grown, events, _ = _hung_run(eng, reg, chaos.install, prompts,
                                       False, False)
    assert grown == jgrown == (1, 0)
    assert [r.failed for r in reqs] == [r.failed for r in jreqs]
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert events == jevents == ["chaos.hang", "watchdog.timeout",
                                 "watchdog.retire_hung_slot"]
    assert eng.spec_steps > 0


@pytest.fixture
def small():
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=2)
    paddle.seed(21)
    raw = dict(JaxModel(jcfg).raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    yield cfg, p
    chaos.uninstall()


def _port(cfg, p, **kw):
    return ContinuousBatchingEngine(cfg, p, device="cpu",
                                    dtype=torch.float32, **{**KW, **kw})


def test_no_live_slot_reraises(small):
    """A timeout with nothing to blame (no live slot, nothing
    prefilling) re-raises: the engine itself is stuck."""
    cfg, p = small
    eng = _port(cfg, p)
    assert not eng._retire_hung_slot(
        StepTimeout("engine.step", "admit", 1.0, 1.0))

    def stuck_admit(token=None):
        time.sleep(0.6)

    eng._admit = stuck_admit
    eng.add_request([5, 6, 7])
    with pytest.raises(StepTimeout, match="admit"):
        eng.run(watchdog_timeout=0.2)
    assert eng.hung_retired == eng.hung_requeued == 0


def test_abandoned_step_raises_at_its_next_owner_check(small):
    """A step whose epoch is gone raises _AbandonedStep at its next owner
    check: no host-set write, no replay, no commit."""
    cfg, p = small
    eng = _port(cfg, p)
    req = eng.add_request([5, 6, 7, 8])
    eng.warm(buckets=[8])
    eng._admit(eng._step_epoch)
    token = eng._step_epoch
    eng._step_epoch += 1                        # the live loop moved on
    turn = eng._host["decode"]._turn
    with pytest.raises(_AbandonedStep):
        eng._dispatch_chunk(token)
    assert eng.device_steps == 0 and eng._host["decode"]._turn == turn
    rec = eng._dispatch_chunk(eng._step_epoch)
    eng._step_epoch += 1
    waited = eng.sync_wait_s
    with pytest.raises(_AbandonedStep):
        eng._commit_chunk(rec, eng._step_epoch - 1)
    assert len(req.tokens) == 1 and eng.sync_wait_s == waited
    assert eng._commit_chunk(rec, eng._step_epoch) == 2
    late = eng.add_request([9, 10])
    with pytest.raises(_AbandonedStep):
        eng._admit(token)
    assert eng.waiting == [late] and late.pages is None


def test_hung_retire_keeps_a_shared_prefix_page(small):
    """The watchdog retires the slot that owns a cached prefix block; a
    surviving slot still maps it (refcount), so its tokens come out as
    on an engine without the cache, and the block stays cached."""
    cfg, p = small
    rng = np.random.default_rng(3)
    shared = rng.integers(1, cfg.vocab_size, (8,)).tolist()
    pa = shared + rng.integers(1, cfg.vocab_size, (5,)).tolist()
    pb = shared + rng.integers(1, cfg.vocab_size, (4,)).tolist()
    ref = _port(cfg, p)
    ref_b = ref.add_request(pb)
    ref.run(max_iters=100)
    eng = _port(cfg, p, prefix_cache=True)
    ra = eng.add_request(pa)
    eng.warm(buckets=[8, 16])
    eng.step()                  # A prefills and inserts the shared block
    rb = eng.add_request(pb)    # admitted next step: it hits the block
    chaos.install(f"hang:decode:{HANG}")
    eng.run(watchdog_timeout=DEADLINE)
    assert ra.failed and not rb.failed and eng.hung_retired == 1
    assert rb.cached_tokens == 8 and rb.tokens == ref_b.tokens
    assert eng.mgr.n_available == eng.mgr.max_pages - 1
    assert eng.mgr.n_cached >= 1


def test_requeued_twice_fails(small):
    """The second timeout of the same request fails it: requeue_hung is
    one retry."""
    cfg, p = small
    eng = _port(cfg, p, slots=1)
    req = eng.add_request([5, 6, 7, 8, 9])
    eng.warm(buckets=[8])
    chaos.install("hang:decode:1.8,hang:decode:1.8")
    eng.run(watchdog_timeout=0.6, requeue_hung=True)
    assert req.failed and req.requeued
    assert eng.hung_requeued == eng.hung_retired == 1
    assert eng.mgr.n_available == eng.mgr.max_pages - 1


def test_step_timeout_flag_arms_the_watchdog(small):
    """watchdog_timeout=None reads FLAGS_step_timeout_s."""
    cfg, p = small
    eng = _port(cfg, p)
    eng.add_request([5, 6, 7])
    eng.warm(buckets=[8])
    set_flags({"step_timeout_s": DEADLINE})
    try:
        chaos.install(f"hang:decode:{HANG}")
        eng.run()
    finally:
        set_flags({"step_timeout_s": 0.0})
    assert eng.hung_retired == 1 and eng.finished[0].failed
