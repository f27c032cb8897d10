"""The port's SLO router and fault-tolerant decode fleet
(paddle_tpu_torch.serving.router / .fleet, the engine's drain hooks,
parallel/launch/serve_worker) against the JAX package's, on the CPU.

Setup of tests/test_fleet.py: ``LlamaConfig.tiny()`` with two kv heads,
weights from seed 21 (the JAX model's, carried into the port with
``params_from_jax``), 2 slots, 8-token pages and prompt buckets, f32.

- Engine hooks: `pause_admission` / `take_waiting` / `export_progress` /
  `drain` on the split, unified and disaggregated engines give the JAX
  engine's rows, the same taken requests and, after resuming, the same
  tokens.
- Router admission: both routers run one script against fake workers
  (no engine), and every answer (`Request` or `Rejected(reason,
  retry_after_s, detail)`), the `metrics()` dict and the
  `prometheus_text()` exposition must be equal. Worker threads
  reporting at once lose no update.
- Chaos recovery: a `kill_worker` fault kills one of two in-process
  workers mid-request; every request must finish with the tokens of the
  JAX lone engine and of the port's lone engine, with the JAX fleet's
  death / requeue / fencing counters on the same script. A second kill
  under the same request fails it (requeue-once), counter for counter
  with the JAX fleet.
- Elastic drain and overload bias (the JAX tests' shapes).
- Subprocesses: the port's fleet smoke CLI under ``kill_worker`` exits 0,
  and a FileStore ``serve_worker --device cpu`` serves the in-process
  port engine's tokens. Its oracle is the port's own engine over
  ``init_serving_params(cfg, seed)``: the JAX worker draws its weights
  from ``jax.random``, so the two workers serve different weights.

Every wait is bounded (threads joined with a timeout, subprocesses run
with one); the heartbeat leases are long enough for a loaded CPU, and a
lapsed lease on a live worker is never a death.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability.metrics as jax_metrics
import paddle_tpu.resilience.chaos as jax_chaos
import paddle_tpu.serving.fleet as jax_fleet
import paddle_tpu.serving.router as jax_router
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
import paddle_tpu_torch.observability.metrics as port_metrics
import paddle_tpu_torch.resilience.chaos as port_chaos
import paddle_tpu_torch.serving.fleet as port_fleet
import paddle_tpu_torch.serving.router as port_router
from paddle_tpu_torch.models import (LlamaConfig, init_serving_params,
                                     params_from_jax)
from paddle_tpu_torch.resilience.store import FileStore
from paddle_tpu_torch.serving import ContinuousBatchingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_KW = dict(slots=2, prompt_bucket=8, max_prompt_len=32,
           max_new_tokens=8, block_size=8, steps_per_sync=2)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=2)
    paddle.seed(21)
    raw = dict(JaxModel(jcfg).raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    return jcfg, raw, cfg, p


def _port_engine(cfg, p, **over):
    return ContinuousBatchingEngine(cfg, p, device="cpu",
                                    dtype=torch.float32, **{**_KW, **over})


def _jax_engine(jcfg, raw, **over):
    return JaxEngine(jcfg, dict(raw), dtype=jnp.float32, **{**_KW, **over})


def _factories(model, **over):
    jcfg, raw, cfg, p = model

    def port(*, metrics, tracer):
        return _port_engine(cfg, p, metrics=metrics, tracer=tracer, **over)

    def jax(*, metrics, tracer):
        return _jax_engine(jcfg, raw, metrics=metrics, tracer=tracer,
                           **over)

    return {"port": port, "jax": jax}


# the two packages' fleet, router, chaos and metrics modules
PKGS = {"port": (port_fleet, port_router, port_chaos, port_metrics),
        "jax": (jax_fleet, jax_router, jax_chaos, jax_metrics)}


def _prompts(vocab, n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (int(rng.integers(3, 9)),)).tolist()
            for _ in range(n)]


def _wait(pred, timeout=90.0, poll=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return False


def _join(router, fleet, timeout):
    """router.join, re-raised with the fleet's state on a timeout."""
    try:
        return router.join(timeout=timeout)
    except TimeoutError as e:
        state = {"deaths": fleet.deaths, "fenced": sorted(fleet.fenced),
                 "live": sorted(fleet.live()),
                 "requests": [(r.req_id, r.state, r.kills, len(r.tokens))
                              for r in router.requests]}
        raise TimeoutError(f"{e}; fleet: {state}") from None


def _lone_tokens(eng, prompts, max_new):
    reqs = [eng.add_request(pr, max_new=max_new) for pr in prompts]
    eng.run(max_iters=1000)
    return [list(r.tokens) for r in reqs]


# ---------------------------------------------------------------------
# the engine's fleet hooks
# ---------------------------------------------------------------------

HOOK_CASES = {
    "split": dict(unified_step=False),
    "unified": dict(unified_step=True, token_budget=8),
    "disaggregated": dict(unified_step=False, disaggregated=True),
}


def _hook_script(eng, prompts):
    """The JAX engine-hook test's script, recording every observable:
    rows while all wait, rows after a step (and after one more admission
    pass), the drain's leftovers and finished streams, a late request
    held by the paused admission, then a resume over the leftovers."""
    out = {}
    reqs = [eng.add_request(p, max_new=3, priority=("high", "normal")[i % 2],
                            deadline_s=60.0 if i == 0 else None)
            for i, p in enumerate(prompts)]
    out["rows0"] = eng.export_progress()
    eng.step()
    out["rows1"] = eng.export_progress()
    eng._admit()
    out["rows2"] = eng.export_progress()
    left = eng.drain()
    out["left"] = [r.req_id for r in left]
    out["finished"] = {r.req_id: list(r.tokens) for r in eng.finished}
    out["active_after_drain"] = eng.n_active
    late = eng.add_request(prompts[0], max_new=2)
    eng.step()
    out["late_waiting"] = (eng.n_active, late in eng.waiting)
    out["late_taken"] = [r.req_id for r in eng.take_waiting()]
    eng.pause_admission(False)
    resumed = [eng.add_request(r.prompt, max_new=r.max_new) for r in left]
    eng.run(max_iters=500)
    out["resumed"] = [list(r.tokens) for r in resumed]
    out["all"] = sorted(r.req_id for r in reqs)
    return out


@pytest.mark.parametrize("case", sorted(HOOK_CASES))
def test_engine_hooks_match_jax(model, case):
    jcfg, raw, cfg, p = model
    rng = np.random.default_rng(11)
    # a prompt wider than the unified step's 8-token window first, so a
    # unified engine holds it mid-prefill after one step
    prompts = [rng.integers(1, cfg.vocab_size, (20,)).tolist()] \
        + _prompts(cfg.vocab_size, 4, seed=11)
    ours = _hook_script(_port_engine(cfg, p, **HOOK_CASES[case]), prompts)
    theirs = _hook_script(_jax_engine(jcfg, raw, **HOOK_CASES[case]),
                          prompts)
    assert ours == theirs
    states = {row["state"] for k in ("rows0", "rows1", "rows2")
              for row in ours[k]}
    assert {row["state"] for row in ours["rows0"]} == {"waiting"}
    want = {"unified": "prefilling", "disaggregated": "handoff",
            "split": "active"}[case]
    assert want in states, states
    assert ours["left"], "the drain found no queued request to hand back"
    assert set(ours["left"]) | set(ours["finished"]) == set(ours["all"])
    assert all(len(t) == 3 for t in ours["finished"].values())
    assert ours["late_waiting"] == (0, True)


# ---------------------------------------------------------------------
# router admission: both routers on one script over fake workers
# ---------------------------------------------------------------------

class _FakeWorker:
    def __init__(self, wid, lease, registry, slots=2):
        self.worker_id = wid
        self.lease_epoch = lease
        self.slots = slots
        self.max_prompt_len = 32
        self.max_new_budget = 8
        self.metrics = registry()
        self.tracer = None
        self.alive = True
        self.submitted = []

    def submit(self, d):
        self.submitted.append(d)

    def queue_len(self):
        return len(self.submitted)

    def heartbeat_age_s(self):
        return 0.0


class _FakeFleet:
    def __init__(self, *workers):
        self.workers = {w.worker_id: w for w in workers}
        self.epoch = len(workers)
        self._sink = None
        self.pending_deaths = []

    def bind(self, sink):
        self._sink = sink

    def live(self):
        return dict(self.workers)

    def check_health(self):
        dead, self.pending_deaths = self.pending_deaths, []
        for wid, _lease, _r in dead:
            self.workers.pop(wid, None)
        if dead:
            self.epoch += 1
        return dead

    def kill(self, wid, reason="chaos_kill"):
        w = self.workers[wid]
        w.alive = False
        self.pending_deaths.append((wid, w.lease_epoch, reason))


def _answer(r):
    if r.__class__.__name__ == "Rejected":
        return ("rejected", r.reason, r.retry_after_s, r.detail)
    return ("request", r.req_id, r.state, r.worker_id, list(r.tokens),
            r.kills, r.requeues, r.error)


def _router_script(pkg):
    """JAX tests/test_fleet.py's admission cases in one script, with
    arrival and first-token times given so that the TTFT histograms do
    not depend on the clock. Returns every answer, the dispatches the
    workers saw, metrics() and prometheus_text() at the end."""
    _, router_mod, _, metrics_mod = PKGS[pkg]
    Router, reg = router_mod.Router, metrics_mod.MetricsRegistry
    out = []

    def W(wid, lease):
        return _FakeWorker(wid, lease, reg)

    # no workers; too large
    out.append(_answer(Router(_FakeFleet(), max_queue=4).submit([1, 2, 3])))
    r = Router(_FakeFleet(W("a", 1)), max_queue=4)
    out += [_answer(r.submit([1] * 40)), _answer(r.submit([1, 2], 99))]
    out.append(r.metrics()["shed_by_reason"])
    # depth caps: low 1 / normal 2 / high 4 at max_queue=1
    r = Router(_FakeFleet(W("a", 1)), max_queue=1)
    for prio in ("low", "low", "normal", "normal", "high", "high", "high"):
        out.append(_answer(r.submit([1, 2], 4, priority=prio,
                                    arrival_time=0.0)))
    out.append(r.metrics())
    # measured SLO sheds
    w = W("a", 1)
    w.metrics.histogram("tpot_s", "t").observe(0.5)
    w.metrics.histogram("ttft_s", "t").observe(1.0)
    r = Router(_FakeFleet(w), max_queue=8)
    out.append(_answer(r.submit([1, 2], 4, tpot_deadline_s=0.1)))
    for _ in range(6):
        out.append(_answer(r.submit([1, 2], 8, arrival_time=0.0)))
    out.append(_answer(r.submit([1, 2], 8, ttft_deadline_s=1.1)))
    out.append(r.predicted_ttft_s("normal"))
    out.append(_answer(r.submit([1, 2], 2, priority="high",
                                ttft_deadline_s=600.0, arrival_time=0.0)))
    # requeue once, fencing, the poison breaker
    fleet = _FakeFleet(W("a", 1))
    r = Router(fleet, max_queue=8)
    req = r.submit([5, 6, 7], 6, arrival_time=0.0)
    d = fleet.workers["a"].submitted[0]
    r._on_event("a", 1, "progress", d, {"tokens": [9, 8],
                                        "prefill_time": 0.25})
    fleet.kill("a")
    r.poll()
    out.append(_answer(req))
    r._on_event("a", 1, "finished", d, {"tokens": [9, 8, 1, 1, 1, 1]})
    out.append(_answer(req))
    fleet.workers["b"] = W("b", 3)
    r.poll()
    d2 = fleet.workers["b"].submitted[0]
    out.append((d2.prompt, d2.max_new, d2.base, d2.priority))
    fleet.kill("b")
    r.poll()
    out += [_answer(req), r.metrics()]
    # a drain requeue rejoins the queue, then finishes elsewhere
    fleet = _FakeFleet(W("a", 1), W("b", 2))
    r = Router(fleet, max_queue=8)
    reqs = [r.submit([1, 2, 3], 4, priority=p, arrival_time=0.0)
            for p in ("high", "normal", "low")]
    first = reqs[0]
    wid = first.worker_id
    d = fleet.workers[wid].submitted[0]
    r._on_event(wid, fleet.workers[wid].lease_epoch, "requeued", d, {})
    out.append(_answer(first))
    r.poll()
    out.append(_answer(first))
    for q in reqs:
        w = fleet.workers[q.worker_id]
        dq = [x for x in w.submitted if x.req is q][-1]
        r._on_event(q.worker_id, w.lease_epoch, "finished", dq,
                    {"tokens": [4], "prefill_time": 0.5})
    r._on_event(wid, 1, "failed", d, {"error": "late"})   # already done
    r.poll()
    out += [[_answer(q) for q in reqs], r.metrics()]
    # the exposition, with one shed and one finished request
    fleet = _FakeFleet(W("a", 1))
    r = Router(fleet, max_queue=2)
    q = r.submit([1, 2], 2, arrival_time=0.0)
    r.submit([1] * 40)
    r._on_event("a", 1, "finished", fleet.workers["a"].submitted[0],
                {"tokens": [3], "prefill_time": 0.125})
    r.poll()
    out += [_answer(q), r.metrics()]
    return out, r.prometheus_text()


def test_router_admission_matches_jax():
    ours, ours_text = _router_script("port")
    theirs, theirs_text = _router_script("jax")
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, (i, a, b)
    assert ours_text == theirs_text
    assert "paddle_tpu_router_shed_too_large_total" in ours_text
    assert "paddle_tpu_router_router_ttft_s_normal_bucket" in ours_text
    reasons = {a[1] for a in ours if isinstance(a, tuple)
               and a and a[0] == "rejected"}
    assert reasons == {"no_workers", "too_large", "overloaded", "tpot",
                       "deadline"}


def test_router_under_concurrent_worker_events():
    """Worker threads report into the router at once (more threads than
    cores, a tiny switch interval) while the main thread polls: no lost
    update, every request finished once, counters and the TTFT histogram
    agree."""
    import threading

    n_workers, per = 12, 20
    fleet = _FakeFleet(*[_FakeWorker(f"w{i}", i + 1,
                                     port_metrics.MetricsRegistry,
                                     slots=per)
                         for i in range(n_workers)])
    router = port_router.Router(fleet, max_queue=n_workers * per,
                                dispatch_depth=1)
    reqs = [router.submit([1, 2, 3], 4, priority=("high", "normal")[i % 2],
                          arrival_time=0.0)
            for i in range(n_workers * per)]
    assert not any(isinstance(r, port_router.Rejected) for r in reqs)

    def report(w):
        for d in list(w.submitted):
            for n in (1, 2, 3):
                router._on_event(w.worker_id, w.lease_epoch, "progress", d,
                                 {"tokens": [7] * n, "prefill_time": 0.5})
            router._on_event(w.worker_id, w.lease_epoch, "finished", d,
                             {"tokens": [7] * 4, "prefill_time": 0.5})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=report, args=(w,))
                   for w in fleet.workers.values()]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            router.poll()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    router.poll()
    m = router.metrics()
    assert all(r.state == "finished" and r.tokens == [7] * 4 for r in reqs)
    assert m["requests_finished"] == len(reqs) and m["inflight"] == 0
    assert sum(router.mt.histogram(f"router_ttft_s_{p}").count
               for p in ("high", "normal")) == len(reqs)


def test_router_default_queue_bound_is_the_flag():
    from paddle_tpu_torch.framework import flags

    r = port_router.Router(_FakeFleet())
    assert r.max_queue == flags.flag("router_max_queue") == 64
    f = port_fleet.Fleet(lambda **kw: None)
    assert f.heartbeat_s == flags.flag("fleet_heartbeat_s") == 0.25


# ---------------------------------------------------------------------
# chaos: kill one of two workers mid-request
# ---------------------------------------------------------------------

COUNTERS = ("submitted", "admitted", "shed", "worker_deaths",
            "poison_failed", "fenced_reports", "drain_requeued",
            "deadline_miss", "requests_finished", "requests_failed",
            "membership_epoch", "queue_depth", "inflight")


def _kill_run(model, pkg, prompts):
    """JAX tests/test_fleet.py's kill test on package `pkg`'s fleet (one
    decode step a chunk): once w1 holds in-flight work with delivered
    tokens, kill_worker:1 two loop steps ahead. Returns the streams, the
    router's metrics, the fleet's deaths and fenced set, and the merged
    trace's lanes."""
    fleet_mod, router_mod, chaos, _ = PKGS[pkg]
    # one token a loop step: a kill two steps after the first delivered
    # token always lands while w1's slots are mid-request
    fleet = fleet_mod.Fleet(_factories(model, steps_per_sync=1)[pkg],
                            heartbeat_s=0.25, trace=True)
    router = router_mod.Router(fleet, max_queue=32)
    try:
        fleet.add_worker(warm=True)
        fleet.add_worker(warm=True)
        reqs = []
        for p in prompts:
            reqs.append(router.submit(p, 6))
            router.poll()
        target = fleet.workers["w1"]
        assert _wait(lambda: any(r.worker_id == "w1" and r.tokens
                                 and not r.done for r in reqs)), \
            "no in-flight progress on w1"
        chaos.install(f"kill_worker:1@{target.steps + 2}")
        assert _wait(lambda: not target.alive), "the chaos kill did not fire"
        assert target.killed
        # the tokens w1 delivered before it died
        kept = {r.req_id: list(r.tokens)
                for r in router._dispatched.get("w1", {}).values()}
        _join(router, fleet, 180.0)
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "fleet.json")
            assert fleet.export_merged_trace(out) == out
            with open(out) as f:
                lanes = {e["args"]["name"]
                         for e in json.load(f)["traceEvents"]
                         if e["name"] == "process_name"}
        return (reqs, kept, router.metrics(), list(fleet.deaths),
                dict(fleet.fenced), lanes)
    finally:
        chaos.uninstall()
        fleet.stop()


def test_chaos_kill_recovers_to_the_lone_engines_tokens(model):
    jcfg, raw, cfg, p = model
    prompts = _prompts(cfg.vocab_size, 8)
    want = _lone_tokens(_jax_engine(jcfg, raw), prompts, 6)
    assert _lone_tokens(_port_engine(cfg, p), prompts, 6) == want
    runs = {pkg: _kill_run(model, pkg, prompts) for pkg in ("port", "jax")}
    reqs, kept, m, deaths, fenced, lanes = runs["port"]
    for r, w in zip(reqs, want):
        assert r.state == "finished"
        assert r.tokens == w, \
            f"req {r.req_id} diverged after {r.kills} kill(s)"
    recovered = [r for r in reqs if r.kills]
    assert recovered and any(kept.get(r.req_id) for r in recovered)
    for r in recovered:
        assert r.tokens[:len(kept[r.req_id])] == kept[r.req_id]
    assert m["requeued"] >= 1 and m["poison_failed"] == 0
    assert [d["reason"] for d in deaths] == ["chaos_kill"]
    assert "w1" in fenced and lanes == {"worker:w0"}
    jm = runs["jax"][2]
    assert jm["requeued"] >= 1
    assert {k: m[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert m["worker_deaths"] == 1.0 and m["membership_epoch"] == 3
    assert set(m) == set(jm)
    assert (runs["jax"][3], set(runs["jax"][4]), runs["jax"][5]) \
        == (deaths, set(fenced), lanes)


def _poison_run(model, pkg, prompt):
    """JAX tests/test_fleet.py's second-kill test on package `pkg`."""
    fleet_mod, router_mod, chaos, _ = PKGS[pkg]
    fleet = fleet_mod.Fleet(_factories(model, max_new_tokens=16,
                                       steps_per_sync=1)[pkg],
                            heartbeat_s=0.25)
    router = router_mod.Router(fleet, max_queue=8)
    try:
        w0 = fleet.add_worker(warm=True)
        req = router.submit(prompt, 16)
        target = fleet.workers[w0]
        assert _wait(lambda: len(req.tokens) > 0), "no progress on w0"
        chaos.install(f"kill_worker:0@{target.steps + 2}")
        assert _wait(lambda: not target.alive)
        router.poll()
        first = (req.state, req.kills, list(req.tokens))
        w1 = fleet.add_worker(warm=True)
        router.poll()
        target = fleet.workers[w1]
        kept = first[2]
        assert _wait(lambda: len(req.tokens) > len(kept)), \
            "no progress on the replacement worker"
        chaos.install(f"kill_worker:1@{target.steps + 2}")
        assert _wait(lambda: not target.alive)
        router.poll()
        return first, req, router.metrics()
    finally:
        chaos.uninstall()
        fleet.stop()


def test_second_kill_fails_the_poison_request(model):
    _, _, cfg, _ = model
    prompt = _prompts(cfg.vocab_size, 1, seed=3)[0]
    runs = {pkg: _poison_run(model, pkg, prompt) for pkg in ("port", "jax")}
    first, req, m = runs["port"]
    assert first[:2] == ("queued", 1) and first[2]
    assert (req.state, req.kills) == ("failed", 2)
    assert "died twice" in req.error
    jfirst, jreq, jm = runs["jax"]
    assert (jfirst[:2], jreq.state, jreq.kills) == (first[:2], "failed", 2)
    assert req.tokens[:len(first[2])] == first[2]
    skip = {"per_worker"}
    assert {k: v for k, v in m.items() if k not in skip} \
        == {k: v for k, v in jm.items() if k not in skip}
    assert (m["worker_deaths"], m["poison_failed"], m["requeued"]) \
        == (2.0, 1.0, 1.0)


# ---------------------------------------------------------------------
# elastic scale-in and the overload bias
# ---------------------------------------------------------------------

def test_scale_in_drains_and_the_survivor_finishes(model):
    _, _, cfg, p = model
    prompts = _prompts(cfg.vocab_size, 6, seed=5)
    want = _lone_tokens(_port_engine(cfg, p), prompts, 8)
    fleet = port_fleet.Fleet(_factories(model)["port"], heartbeat_s=0.25)
    router = port_router.Router(fleet, max_queue=16)
    try:
        w0 = fleet.add_worker(warm=True)
        epoch = fleet.epoch
        reqs = [router.submit(pr, 8) for pr in prompts]
        assert not any(isinstance(r, port_router.Rejected) for r in reqs)
        fleet.remove_worker(w0, drain=True, timeout=120)
        assert w0 not in fleet.workers and w0 in fleet.fenced
        assert fleet.epoch == epoch + 1
        m = router.metrics()
        assert m["drain_requeued"] >= 1.0 and m["worker_deaths"] == 0.0
        w1 = fleet.add_worker(warm=True)
        assert fleet.epoch == epoch + 2
        _join(router, fleet, 180.0)
    finally:
        fleet.stop()
    assert [r.tokens for r in reqs] == want
    assert all(r.state == "finished" for r in reqs)
    assert all(r.worker_id == w1 for r in reqs if r.requeues)


def test_device_gate_keeps_engines_off_the_device_at_once(model):
    """Every in-process worker of a device holds its gate around a step
    and around a joining worker's warm(): with two workers serving and a
    third joining mid-serve, no two of those calls ever overlap, and the
    streams are the lone engine's."""
    _, _, cfg, p = model
    busy, peak, lock = [0], [0], threading.Lock()

    def exclusive(fn):
        def call(*a, **k):
            with lock:
                busy[0] += 1
                peak[0] = max(peak[0], busy[0])
            try:
                time.sleep(0.002)  # widen the window an overlap needs
                return fn(*a, **k)
            finally:
                with lock:
                    busy[0] -= 1
        return call

    def factory(*, metrics, tracer):
        eng = _port_engine(cfg, p, metrics=metrics, tracer=tracer,
                           steps_per_sync=1)
        eng.step, eng.warm = exclusive(eng.step), exclusive(eng.warm)
        return eng

    prompts = _prompts(cfg.vocab_size, 8, seed=11)
    want = _lone_tokens(_port_engine(cfg, p), prompts, 6)
    fleet = port_fleet.Fleet(factory, heartbeat_s=0.25)
    router = port_router.Router(fleet, max_queue=16)
    try:
        fleet.add_worker(warm=True)
        fleet.add_worker(warm=True)
        reqs = [router.submit(pr, 6) for pr in prompts]
        assert _wait(lambda: sum(bool(r.tokens) and not r.done
                                 for r in reqs) >= 2), "no progress"
        w2 = fleet.add_worker(warm=True)
        _join(router, fleet, 180.0)
    finally:
        fleet.stop()
    assert peak[0] == 1
    assert len({id(w.gate) for w in fleet.workers.values()}) == 1
    assert fleet.workers[w2].gate is port_fleet.device_gate("cpu")
    assert [r.tokens for r in reqs] == want
    assert all(r.state == "finished" for r in reqs)


def test_overload_sheds_only_low_and_normal_high_ttft_holds(model):
    _, _, cfg, _ = model
    fleet = port_fleet.Fleet(_factories(model)["port"], heartbeat_s=0.25)
    # max_queue=1: caps low 1, normal 2, high 4; the 2-slot worker takes
    # up to 4, so the burst saturates the depth at once
    router = port_router.Router(fleet, max_queue=1)
    try:
        fleet.add_worker(warm=True)
        pr = _prompts(cfg.vocab_size, 10, seed=9)
        high = [router.submit(p, 2, priority="high", ttft_deadline_s=120.0)
                for p in pr[:4]]
        low = [router.submit(p, 2, priority="low") for p in pr[4:7]]
        norm = [router.submit(p, 2, priority="normal") for p in pr[7:]]
        assert not any(isinstance(r, port_router.Rejected) for r in high)
        assert all(isinstance(r, port_router.Rejected)
                   and r.reason == "overloaded" for r in low + norm)
        _join(router, fleet, 180.0)
    finally:
        fleet.stop()
    m = router.metrics()
    assert m["requests_finished"] == 4.0
    assert m["deadline_miss"]["ttft"] == 0.0
    assert m["ttft_high"]["p99"] < 120.0
    assert m["shed_by_reason"]["overloaded"] == 6.0


# ---------------------------------------------------------------------
# subprocesses: the smoke CLI and a FileStore serve_worker
# ---------------------------------------------------------------------

def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.update(extra)
    return env


def test_fleet_smoke_cli_under_a_chaos_kill():
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.fleet",
         "--workers", "2", "--requests", "8", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=_env(PADDLE_TPU_CHAOS="kill_worker:1@6"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(row) == {"bench", "workers", "submitted", "finished", "shed",
                        "worker_deaths", "requeued", "membership_epoch",
                        "chaos", "ok"}
    assert row["bench"] == "fleet_smoke" and row["ok"]
    assert row["finished"] + row["shed"] == 8
    assert row["chaos"].get("kill_worker") == 1
    assert row["worker_deaths"] == 1.0 and row["membership_epoch"] == 3


def test_cli_entry_points_need_the_card_unless_told_cpu():
    """Both CLIs default to the CUDA card; without one they raise (the
    machine here has none) instead of quietly serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with tempfile.TemporaryDirectory() as td:
        for argv in (["-m", "paddle_tpu_torch.serving.fleet",
                      "--requests", "1"],
                     ["-m", "paddle_tpu_torch.parallel.launch.serve_worker",
                      "--store", td]):
            proc = subprocess.run([sys.executable, *argv],
                                  capture_output=True, text=True, cwd=REPO,
                                  timeout=120, env=_env())
            assert proc.returncode != 0
            assert "torch.cuda.is_available() is False" in proc.stderr


def test_filestore_serve_worker_serves_the_port_engines_tokens():
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    params = init_serving_params(cfg, seed=21, device="cpu",
                                 dtype=torch.float32)
    prompts = _prompts(cfg.vocab_size, 4, seed=13)
    want = _lone_tokens(ContinuousBatchingEngine(
        cfg, params, device="cpu", dtype=torch.float32,
        **{**_KW, "max_new_tokens": 6}), prompts, 5)
    with tempfile.TemporaryDirectory() as td:
        fleet = port_fleet.Fleet(lambda **kw: None, store=FileStore(td),
                                 job_id="t", heartbeat_s=0.5)
        router = port_router.Router(fleet, max_queue=8)
        wid = fleet.add_subprocess_worker(
            extra_args=("--max-new", "6", "--seed", "21", "--device", "cpu",
                        "--warm-buckets", "8"),
            env=_env(), ready_timeout_s=180.0)
        w = fleet.workers[wid]
        try:
            assert w.heartbeat_age_s() is not None
            assert (w.slots, w.max_prompt_len, w.max_new_budget) == (2, 32, 6)
            reqs = [router.submit(pr, 5) for pr in prompts]
            _join(router, fleet, 240.0)
            assert [r.tokens for r in reqs] == want
            assert all(r.state == "finished" for r in reqs)
            fleet.remove_worker(wid, drain=True, timeout=60)
            assert wid not in fleet.workers
            assert w.proc.returncode == 0
            assert fleet.store.get(f"fleet/t/hb/{wid}") is None
        finally:
            if w.proc.poll() is None:
                w.proc.kill()
                w.proc.wait(timeout=30)
