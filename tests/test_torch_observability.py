"""The port's observability (paddle_tpu_torch.observability) on the CPU.

The recorder, histogram, registry and disabled-fast-path cases of
tests/test_observability.py run against the port's modules (the capture
guard by simulating a capture on the CPU; the card test in
tests/test_torch_cuda.py captures a real CUDA graph). Then the same
traffic is served through the JAX engine and the port's engine (f32,
``LlamaConfig.tiny()``, the same weights), each with a tracer and a
metrics registry: the same span names with the same count per name, the
same req_id coverage of the lifecycle instants, equal counters (all but
``blocked_syncs``, a wall-clock threshold) and equal histogram counts,
and identical tokens.
"""
import dataclasses
import io
import json
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import Tracer as JaxTracer
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import trace as obs_trace
from paddle_tpu_torch.observability.metrics import (Histogram,
                                                    MetricsRegistry)
from paddle_tpu_torch.observability.trace import (Tracer,
                                                  TraceUnderJitError,
                                                  write_chrome_trace)
from paddle_tpu_torch.serving import ContinuousBatchingEngine


@pytest.fixture(autouse=True)
def _globals_off():
    obs_trace.disable()
    obs_metrics.disable()
    yield
    obs_trace.disable()
    obs_metrics.disable()


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_nested_spans_contained_on_one_track():
    tr = Tracer()
    with tr.span("outer", kind="test"):
        with tr.span("inner"):
            pass
        tr.instant("mark", k=1)
    evs = [e for e in tr.events() if e["ph"] != "M"]
    assert [e["name"] for e in evs] == ["inner", "mark", "outer"]
    outer, inner, mark = (next(e for e in evs if e["name"] == n)
                          for n in ("outer", "inner", "mark"))
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    assert outer["ts"] <= mark["ts"]
    assert outer["args"] == {"kind": "test"}


def test_thread_safety_and_per_thread_tracks():
    tr = Tracer(capacity=100000)
    n_threads, n_spans = 8, 200
    errors = []
    gate = threading.Barrier(n_threads)

    def work(i):
        try:
            gate.wait(timeout=10)
            tr.set_thread_name(f"worker-{i}")
            for k in range(n_spans):
                with tr.span("w", i=i, k=k):
                    pass
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    evs = tr.events()
    spans = [e for e in evs if e["ph"] == "X"]
    assert len(spans) == n_threads * n_spans
    assert len({e["tid"] for e in spans}) == n_threads
    assert len([e for e in evs if e["ph"] == "M"
                and e["name"] == "thread_name"]) == n_threads


def test_ring_buffer_bounds_memory():
    tr = Tracer(capacity=8)
    for i in range(20):
        tr.instant("e", i=i)
    evs = [e for e in tr.events() if e["ph"] != "M"]
    assert len(evs) == 8 and tr.dropped == 12 and tr.n_recorded == 20
    assert evs[-1]["args"]["i"] == 19 and evs[0]["args"]["i"] == 12


def test_chrome_trace_json_schema():
    tr = Tracer()
    tr.set_thread_name("main")
    with tr.span("a", x=1):
        tr.instant("i")
    tr.counter("q", 3)
    with tempfile.TemporaryDirectory() as d:
        with open(tr.export(d + "/t.json", metadata={"run": "test"})) as f:
            doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    assert doc["metadata"]["run"] == "test"
    phases = set()
    for e in doc["traceEvents"]:
        assert {"name", "ph", "pid"} <= set(e)
        phases.add(e["ph"])
        if e["ph"] != "M":
            assert "ts" in e and "tid" in e
        if e["ph"] == "X":
            assert e["dur"] >= 0
        if e["ph"] == "C":
            assert "value" in e["args"]
    assert phases == {"M", "X", "i", "C"}


def test_merge_chrome_traces_restamps_pids():
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(2):
            tr = Tracer()
            tr.instant("w", i=i)
            paths.append(tr.export(f"{d}/w{i}.json"))
        doc = obs.merge_chrome_traces(paths, out=d + "/all.json",
                                      labels=["a", "b"])
        with open(d + "/all.json") as f:
            assert json.load(f)["traceEvents"] == doc["traceEvents"]
    names = [e for e in doc["traceEvents"] if e["name"] == "process_name"]
    assert [(e["pid"], e["args"]["name"]) for e in names] == [(0, "a"),
                                                             (1, "b")]
    assert sorted(e["pid"] for e in doc["traceEvents"]
                  if e["name"] == "w") == [0, 1]


@pytest.mark.parametrize("what", ["cuda_capture", "compile"])
def test_emit_under_capture_raises(monkeypatch, what):
    """Every emitter raises TraceUnderJitError while this thread's stream
    captures a CUDA graph, or torch.compile traces (simulated on the CPU:
    the card test captures a real graph); the tracer stays usable."""
    tr = Tracer()
    if what == "cuda_capture":
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)

    def span():
        with tr.span("bad"):
            pass

    for emit in (span, lambda: tr.instant("bad"),
                 lambda: tr.counter("bad", 1),
                 lambda: tr.complete("bad", 0, 1)):
        with pytest.raises(TraceUnderJitError, match="capture"):
            emit()
    monkeypatch.undo()
    with tr.span("fine"):
        pass
    assert [e["name"] for e in tr.events()] == ["fine"]


def test_device_spans_open_profiler_ranges_only_when_live():
    """span(device=True) and step_span open a record_function range while
    a torch profiler records (the range shows in its events), and open
    nothing otherwise."""
    tr = Tracer()
    assert obs_trace.device_range("x") is obs_trace._NULL_SPAN
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("host.dev", device=True):
            torch.ones(4).sum()
        with tr.step_span("serve", 3):
            pass
    names = {e.name for e in prof.events()}
    assert {"host.dev", "serve#3"} <= names
    assert [e["name"] for e in tr.events()] == ["host.dev", "serve"]


def test_write_chrome_trace_plain():
    with tempfile.TemporaryDirectory() as d:
        path = write_chrome_trace(
            [{"name": "x", "ph": "X", "ts": 0, "dur": 1, "pid": 0,
              "tid": 0}], d + "/sub/dir/t.json")
        with open(path) as f:
            doc = json.load(f)
    assert len(doc["traceEvents"]) == 1 and "displayTimeUnit" not in doc


# ---------------------------------------------------------------------------
# histograms and the registry
# ---------------------------------------------------------------------------

def _within_bucket(h, samples, q):
    est, true = h.percentile(q), float(np.percentile(samples, q))
    bounds = (0.0,) + h.bounds
    idx = next((i for i in range(1, len(bounds)) if true <= bounds[i]),
               len(bounds) - 1)
    assert bounds[max(idx - 1, 0)] <= est <= bounds[min(idx + 1,
                                                        len(bounds) - 1)]


def test_percentiles_vs_numpy_quantiles():
    rng = np.random.default_rng(7)
    samples = np.exp(rng.uniform(np.log(2e-4), np.log(5.0), 5000))
    h = Histogram("lat")
    for s in samples:
        h.observe(float(s))
    assert h.count == len(samples)
    assert h.sum == pytest.approx(float(samples.sum()), abs=1e-6)
    assert h.min == float(samples.min()) and h.max == float(samples.max())
    for q in (10, 50, 90, 99):
        _within_bucket(h, samples, q)


def test_percentile_edge_cases():
    h = Histogram("x", bounds=(1.0, 2.0, 4.0))
    assert h.percentile(50) is None
    h.observe(0.5)
    assert h.percentile(50) <= 1.0
    h2 = Histogram("y", bounds=(1.0,))
    h2.observe(100.0)
    assert h2.percentile(99) == 100.0 and h2.percentile(100) == 100.0
    with pytest.raises(ValueError):
        Histogram("bad", bounds=(2.0, 1.0))


def test_percentile_overflow_bucket_mid_rank_not_max():
    h = Histogram("z", bounds=(0.5, 1.0))
    for _ in range(100):
        h.observe(2.0)
    h.observe(600.0)
    assert h.percentile(50) == 2.0 and h.percentile(100) == 600.0
    h.observe(0.4)
    assert h.percentile(50) == 1.0


def test_threaded_observe_counts_exact():
    h = Histogram("t")

    def work():
        for i in range(500):
            h.observe(1e-3 * (i + 1))

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert h.count == sum(h.counts) == 4000


def test_histogram_matches_jax_bitwise():
    """The same observations give the JAX histogram's buckets, sum and
    percentiles exactly (dashboards carry over)."""
    from paddle_tpu.observability.metrics import Histogram as JaxHistogram

    rng = np.random.default_rng(9)
    ours, theirs = Histogram("h"), JaxHistogram("h")
    for v in np.exp(rng.uniform(np.log(1e-5), np.log(100.0), 2000)):
        ours.observe(float(v))
        theirs.observe(float(v))
    assert ours.counts == theirs.counts
    assert ours.summary((1, 50, 99, 100)) == theirs.summary((1, 50, 99, 100))


def test_snapshot_and_events():
    m = MetricsRegistry()
    m.counter("reqs").inc()
    m.counter("reqs").inc(2)
    m.gauge("depth").set(7)
    m.histogram("lat").observe(0.01)
    m.event("watchdog.retire", slot=3)
    snap = m.snapshot()
    assert snap["counters"]["reqs"] == 3 and snap["gauges"]["depth"] == 7
    assert snap["histograms"]["lat"]["count"] == 1
    assert "p99" in snap["histograms"]["lat"] and snap["n_events"] == 1
    evs = m.events("watchdog.retire")
    assert evs[0]["slot"] == 3 and "t" in evs[0]
    json.dumps(snap)


def test_event_log_bounded():
    m = MetricsRegistry(max_events=4)
    for i in range(10):
        m.event("e", i=i)
    evs = m.events()
    assert len(evs) == 4 and evs[-1]["i"] == 9


def test_jsonl_emission():
    m = MetricsRegistry()
    m.counter("c").inc()
    buf = io.StringIO()
    m.emit_jsonl(buf, extra={"policy": "x"})
    m.emit_jsonl(buf)
    lines = buf.getvalue().strip().split("\n")
    assert len(lines) == 2
    doc = json.loads(lines[0])
    assert doc["policy"] == "x" and doc["counters"]["c"] == 1


def test_prometheus_text_exposition_matches_jax():
    def fill(m):
        m.counter("requests", doc="total requests").inc(5)
        m.gauge("pool_pages").set(42)
        h = m.histogram("ttft_s", bounds=(0.1, 1.0))
        for v in (0.05, 0.5, 10.0):
            h.observe(v)
        return m.prometheus_text()

    text = fill(MetricsRegistry())
    assert text == fill(JaxRegistry())
    for line in ("# TYPE paddle_tpu_requests_total counter",
                 "paddle_tpu_requests_total 5",
                 "# TYPE paddle_tpu_pool_pages gauge",
                 "paddle_tpu_pool_pages 42",
                 'paddle_tpu_ttft_s_bucket{le="0.1"} 1',
                 'paddle_tpu_ttft_s_bucket{le="1"} 2',
                 'paddle_tpu_ttft_s_bucket{le="+Inf"} 3',
                 "paddle_tpu_ttft_s_count 3"):
        assert line in text
    assert text.endswith("\n")


# ---------------------------------------------------------------------------
# the disabled fast path
# ---------------------------------------------------------------------------

def test_globals_off_by_default():
    obs_trace._resolved = obs_metrics._resolved = False
    assert obs_trace.get_tracer() is None
    assert obs_metrics.get_metrics() is None


def test_noop_span_is_singleton():
    a = obs_trace.span("x", k=1)
    b = obs_trace.span("y")
    assert a is b
    with a:
        pass
    obs_trace.instant("x")
    obs.record_event("x", k=2)
    assert obs_trace.export_global() is None


def test_zero_net_allocations_when_off():
    import gc
    import sys

    def loop(n):
        for _ in range(n):
            with obs_trace.span("hot"):
                pass
            obs_trace.instant("hot")

    loop(100)
    gc.collect()
    before = sys.getallocatedblocks()
    loop(10000)
    gc.collect()
    assert abs(sys.getallocatedblocks() - before) < 500


def test_flag_armed_after_first_use():
    obs_trace._resolved = obs_metrics._resolved = False
    assert obs_trace.get_tracer() is None
    assert obs_metrics.get_metrics() is None
    with tempfile.TemporaryDirectory() as d:
        set_flags({"trace": d + "/t.json", "metrics": True})
        try:
            assert obs_trace.get_tracer() is not None
            assert obs_metrics.get_metrics() is not None
            obs_trace.instant("armed")
            path = obs_trace.export_global()
            with open(path) as f:
                assert any(e["name"] == "armed"
                           for e in json.load(f)["traceEvents"])
        finally:
            set_flags({"trace": "", "metrics": False})


def test_enable_disable_roundtrip():
    tr = obs_trace.enable()
    assert obs_trace.get_tracer() is tr
    m = obs_metrics.enable()
    assert obs_metrics.get_metrics() is m
    obs.record_event("both", k=1)
    assert len(m.events("both")) == 1
    assert any(e["name"] == "both" for e in tr.events())
    obs_trace.disable()
    obs_metrics.disable()
    assert obs_trace.get_tracer() is None
    assert obs_metrics.get_metrics() is None


# ---------------------------------------------------------------------------
# the engine, against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(JaxConfig.tiny(), num_key_value_heads=2)
    paddle.seed(21)
    raw = dict(JaxModel(jcfg).raw_state())
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    p = params_from_jax({k: np.asarray(v) for k, v in raw.items()},
                        device="cpu")
    return jcfg, raw, cfg, p


KW = dict(slots=2, prompt_bucket=8, max_prompt_len=24, max_new_tokens=5,
          block_size=8, steps_per_sync=2)
# (engine options, run(double_buffer=)): the split path with the prefix
# cache; the unified step disaggregated and double-buffered; n-gram
# speculation on the split path
CASES = {
    "split-prefix": (dict(unified_step=False, prefix_cache=True), False),
    "unified-disagg-db": (dict(unified_step=True, token_budget=8,
                               disaggregated=True), True),
    "spec-ngram": (dict(unified_step=False, prefix_cache=False,
                        speculative="ngram", spec_k=2), False),
}


def _traffic(cfg):
    rng = np.random.default_rng(3)
    shared = rng.integers(1, cfg.vocab_size, (8,)).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab_size, (n,)).tolist()
               for n in (5, 9)]
    prompts += [rng.integers(1, cfg.vocab_size, (n,)).tolist()
                for n in (7, 3, 17)]
    # a repetitive prompt gives the n-gram drafter hits
    prompts.append((shared[:4] * 4)[:14])
    return prompts


def _serve(eng, prompts, db):
    reqs = [eng.add_request(pr, max_new=1 if i == 3 else None)
            for i, pr in enumerate(prompts)]
    eng.run(max_iters=500, double_buffer=db)
    return reqs


def _summary(tr, mt):
    evs = [e for e in tr.events() if e["ph"] != "M"]
    per_name = {}
    for e in evs:
        per_name[e["name"]] = per_name.get(e["name"], 0) + 1
    cover = {stage: sorted(e["args"]["req_id"] for e in evs
                           if e["name"] == stage)
             for stage in ("req.enqueue", "req.admit", "req.retire",
                           "req.handoff")}
    snap = mt.snapshot()
    counters = {k: v for k, v in snap["counters"].items()
                if k != "blocked_syncs"}
    hists = {k: h["count"] for k, h in snap["histograms"].items()}
    fields = {e["name"]: sorted(e.get("args", {})) for e in evs}
    return per_name, cover, counters, hists, sorted(snap["gauges"]), fields


@pytest.mark.parametrize("case", list(CASES))
def test_engine_spans_and_metrics_match_jax(model, case):
    jcfg, raw, cfg, p = model
    kw, db = CASES[case]
    prompts = _traffic(cfg)
    jtr, jmt = JaxTracer(), JaxRegistry()
    jeng = JaxEngine(jcfg, raw, dtype=jnp.float32, tracer=jtr, metrics=jmt,
                     **{**KW, **kw})
    jreqs = _serve(jeng, prompts, db)
    tr, mt = Tracer(), MetricsRegistry()
    eng = ContinuousBatchingEngine(cfg, p, device="cpu", dtype=torch.float32,
                                   tracer=tr, metrics=mt, **{**KW, **kw})
    reqs = _serve(eng, prompts, db)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    ours, theirs = _summary(tr, mt), _summary(jtr, jmt)
    for got, want in zip(ours, theirs):
        assert got == want
    per_name, cover = ours[0], ours[1]
    ids = list(range(len(prompts)))
    for stage in ("req.enqueue", "req.admit", "req.retire"):
        assert cover[stage] == ids
    if case == "spec-ngram":
        assert per_name["spec.verify"] == eng.spec_steps > 0
    else:
        assert per_name["decode.dispatch"] == eng.device_steps
    hists = ours[3]
    assert hists["ttft_s"] == hists["queue_wait_s"] == len(prompts)
    # the max_new=1 request emits no decode token, so no TPOT
    assert hists["tpot_s"] == len(prompts) - 1


def test_tracer_false_forces_off_despite_armed_globals(model):
    _, _, cfg, p = model
    tr, mt = obs_trace.enable(), obs_metrics.enable()
    off = ContinuousBatchingEngine(cfg, p, device="cpu", dtype=torch.float32,
                                   tracer=False, metrics=False, **KW)
    assert off._tracer is None and off._metrics is None
    off.add_request([5, 6, 7])
    off.run(max_iters=50)
    assert tr.events() == [] and mt.snapshot()["counters"] == {}
    on = ContinuousBatchingEngine(cfg, p, device="cpu", dtype=torch.float32,
                                  **KW)
    assert on._tracer is tr and on._metrics is mt


def test_disabled_engine_records_nothing(model):
    """With the globals off the engine holds None sinks: serving records
    nothing anywhere, and its tokens equal a traced engine's."""
    _, _, cfg, p = model
    eng = ContinuousBatchingEngine(cfg, p, device="cpu", dtype=torch.float32,
                                   **KW)
    assert eng._tracer is None and eng._metrics is None
    r = eng.add_request([5, 6, 7, 8])
    eng.run(max_iters=50)
    tr, mt = obs_trace.enable(), obs_metrics.enable()
    traced = ContinuousBatchingEngine(cfg, p, device="cpu",
                                      dtype=torch.float32, **KW)
    r2 = traced.add_request([5, 6, 7, 8])
    traced.run(max_iters=50)
    assert r.tokens == r2.tokens and len(r.tokens) == KW["max_new_tokens"]
    assert {e["name"] for e in tr.events()} >= {"req.enqueue", "req.retire"}
    obs_trace.disable()
    obs_metrics.disable()
    n = len(tr.events())
    eng.add_request([9, 10])
    eng.run(max_iters=50)
    assert len(tr.events()) == n
    m = eng.metrics()
    assert m["hung_retired"] == m["hung_requeued"] == 0
