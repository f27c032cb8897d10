"""paddle_tpu_torch.observability: tracing + metrics (counterpart of
paddle_tpu/observability).

Two halves, one activation story:

- `trace`: thread-safe monotonic-clock span recorder (bounded ring
  buffer, nested spans on per-thread tracks, instant/counter events)
  with Perfetto/chrome://tracing export, bridged to
  `torch.profiler.record_function` ranges while a torch profiler is
  live. Armed by `FLAGS_trace` / ``PADDLE_TPU_TRACE=<path>`` (the export
  path); `trace.enable(path)` programmatically.
- `metrics`: registry of counters / gauges / bucketed histograms (TTFT,
  time per output token, queue wait, prefill/decode chunk time, sync
  wait) plus a bounded structured-event log that folds the resilience
  telemetry (RetryStats give-ups, chaos firings, watchdog retirements)
  into one place. `snapshot()` for dicts, `emit_jsonl()` for logging,
  `prometheus_text()` for scraping. Armed by `FLAGS_metrics` /
  ``PADDLE_TPU_METRICS=1``; `metrics.enable()` programmatically.

Both are OFF by default: every instrumentation site resolves
`get_tracer()` / `get_metrics()` once and does a single ``is None``
check per event. Emitting while a CUDA graph capture records raises
`TraceUnderJitError`: tracing must never be captured into a program.

Instrumented: the serving engine's request lifecycle (enqueue -> admit
-> prefill dispatch -> handoff -> per-chunk decode -> retire, eviction,
watchdog retirement and requeue) and the resilience seams (retry,
chaos, watchdog).
"""
from __future__ import annotations

from . import metrics, trace  # noqa: F401
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, get_metrics)
from .trace import (Tracer, TraceUnderJitError,  # noqa: F401
                    get_tracer, merge_chrome_traces, write_chrome_trace)

__all__ = ["trace", "metrics", "Tracer", "TraceUnderJitError",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "get_tracer", "get_metrics", "record_event",
           "write_chrome_trace", "merge_chrome_traces"]


def record_event(name: str, **fields) -> None:
    """Fire-and-forget structured event into BOTH armed sinks (metrics
    event log + trace instant). The one-liner the resilience modules
    call from their hot paths: a no-op (two None checks) when
    observability is off, and it never raises (telemetry must not take
    down the step it observes), except under a graph capture, where the
    guard in `trace.instant` must propagate."""
    m = metrics.get_metrics()
    if m is not None:
        try:
            m.event(name, **fields)
        except Exception:  # pragma: no cover - defensive
            pass
    t = trace.get_tracer()
    if t is not None:
        t.instant(name, **fields)
