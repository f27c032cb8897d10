"""Host-side span tracing with Perfetto/chrome://tracing export
(counterpart of paddle_tpu/observability/trace.py).

One `Tracer` records the port's live host spans:

- **monotonic-clock spans** (`time.perf_counter_ns`) in a bounded ring
  buffer (`collections.deque(maxlen=...)`): a long-serving engine can
  trace forever without growing memory; old spans fall off the back;
- **nested spans, per-thread tracks**: spans are chrome "X" complete
  events keyed by thread id, so Perfetto renders nesting per track from
  timestamp containment; `set_thread_name` labels the track;
- **structured instant events** (`instant`) and counter series
  (`counter`) for point-in-time facts (retire, eviction, chaos fault,
  watchdog retirement);
- **device bridging**: `span(..., device=True)` and `step_span` also open
  a `torch.profiler.record_function` range, and `device_range` opens one
  alone, but only while a torch profiler is live: host spans then line
  up with the device rows of a `torch.profiler` trace;
- **capture guard**: a span, instant, counter or complete emitted while
  the current CUDA stream is capturing a graph, or while
  `torch.compile` traces, raises `TraceUnderJitError`. A host event
  recorded inside a capture would be timed once, at capture, and never
  on a replay.

Activation: `FLAGS_trace` / `PADDLE_TPU_TRACE=<path>` arms the global
tracer and `export_global()` (registered at exit on first use) writes
the chrome-trace JSON to `<path>`. When the flag is empty the module
functions are a single `is None` check: the disabled fast path
allocates nothing.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["Tracer", "TraceUnderJitError", "write_chrome_trace",
           "merge_chrome_traces", "get_tracer", "enable", "disable",
           "span", "instant", "export_global", "device_range"]


class TraceUnderJitError(RuntimeError):
    """A trace span/instant/counter was emitted while a program was being
    recorded: in the port, while the current CUDA stream is capturing a
    graph (`torch.cuda.is_current_stream_capturing()`) or while
    `torch.compile` traces (`torch.compiler.is_compiling()`). The event
    would be taken once, at capture, and never on a replay. Trace on the
    HOST between dispatches, never inside a captured or compiled body.
    (The name is the JAX package's, where the hazard is a jit trace.)"""


def _under_capture(kind: str = "event") -> bool:
    """True while this thread's current CUDA stream captures a graph or
    torch.compile traces. Cheap: two attribute checks unless CUDA is
    initialized in this process. Under an analysis trace of a program
    (``torch.fx``) the emitter leaves a host-call node for lint rule
    TPU602."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    build = sys.modules.get("paddle_tpu_torch.kernels._build")
    if build is not None:
        build.mark_host_call("observability.trace." + kind)
    if torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        return True
    compiler = getattr(torch, "compiler", None)
    return compiler is not None and compiler.is_compiling()


def _profiler_live() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def device_range(name: str, on: bool = True):
    """A `torch.profiler.record_function(name)` range while a torch
    profiler is live (and `on`), else the shared no-op context manager."""
    if not on or not _profiler_live():
        return _NULL_SPAN
    import torch

    return torch.profiler.record_function(name)


def write_chrome_trace(events, path: str, *, metadata: Optional[dict] = None,
                       display_time_unit: Optional[str] = None) -> str:
    """THE chrome://tracing / Perfetto JSON writer (JSON Object Format:
    {"traceEvents": [...]})."""
    doc = {"traceEvents": list(events)}
    if display_time_unit:
        doc["displayTimeUnit"] = display_time_unit
    if metadata:
        doc["metadata"] = metadata
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def merge_chrome_traces(paths, out: Optional[str] = None, *,
                        labels=None) -> dict:
    """Merge per-worker chrome traces into ONE Perfetto JSON document.

    Every input file becomes one PROCESS in the merged timeline: its
    events are re-stamped ``pid=i`` (in-process workers all share the
    real pid; without the re-stamp their tracks would interleave into
    one unreadable process) and a ``process_name`` metadata row names
    the track (``labels[i]`` or the file's basename). Wall-clock ``ts``
    values are left untouched. Returns the merged document; also writes
    it when `out` is given."""
    paths = list(paths)
    merged: list = []
    meta: dict = {"merged_from": []}
    for i, p in enumerate(paths):
        with open(p) as f:
            doc = json.load(f)
        if isinstance(doc, list):       # bare event-array form
            doc = {"traceEvents": doc}
        events = doc.get("traceEvents") or []
        label = labels[i] if labels and i < len(labels) else None
        if label is None:
            label = os.path.splitext(os.path.basename(p))[0]
        merged.append({"name": "process_name", "ph": "M", "pid": i,
                       "tid": 0, "args": {"name": label}})
        for ev in events:
            ev = dict(ev)
            ev["pid"] = i
            merged.append(ev)
        meta["merged_from"].append({"pid": i, "label": label,
                                    "path": str(p)})
        for k, v in (doc.get("metadata") or {}).items():
            meta.setdefault(k, v)
    doc = {"traceEvents": merged, "metadata": meta}
    if out:
        write_chrome_trace(merged, out, metadata=meta)
    return doc


class _SpanHandle:
    """Context manager for one live span (created only when tracing is
    ON; the disabled path never reaches here)."""

    __slots__ = ("tracer", "name", "args", "t0", "_ann", "_device")

    def __init__(self, tracer: "Tracer", name: str, args: dict,
                 device: bool):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0
        self._ann = None
        self._device = name if device else None

    def __enter__(self):
        if _under_capture("span"):
            raise TraceUnderJitError(
                f"span {self.name!r} opened while a CUDA graph capture "
                "(or a torch.compile trace) is recording: it would be "
                "taken once, at capture, never on a replay; trace on the "
                "host between dispatches instead")
        if self._device is not None:
            self._ann = device_range(self._device)
            self._ann.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self.tracer._record_complete(self.name, self.t0, t1, self.args)
        return False


class Tracer:
    """Thread-safe bounded span recorder with chrome-trace export.

    ::

        tr = Tracer(capacity=65536)
        with tr.span("decode.dispatch", chunk=n):
            ...
        tr.instant("req.retire", req_id=7)
        tr.export("trace.json")
    """

    def __init__(self, capacity: int = 65536, pid: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.pid = os.getpid() if pid is None else int(pid)
        self._lock = threading.Lock()
        self._events = deque(maxlen=self.capacity)
        self._thread_names = {}  # tid -> name (metadata, never evicted)
        self.dropped = 0         # spans the ring buffer evicted
        self.n_recorded = 0

    # -- recording -----------------------------------------------------
    def span(self, name: str, device: bool = False, **args) -> _SpanHandle:
        """Context manager recording a complete ("X") span on this
        thread's track. `device=True` also opens a
        `torch.profiler.record_function(name)` range while a torch
        profiler is live."""
        return _SpanHandle(self, name, args, device)

    def step_span(self, name: str, step: int) -> _SpanHandle:
        """Span for one training/serving step, bridged to a
        `record_function` range named ``name#step`` while a torch
        profiler is live (the profiler's own step ranges read the
        same)."""
        h = _SpanHandle(self, name, {"step": int(step)}, device=False)
        h._device = f"{name}#{int(step)}"
        return h

    def instant(self, name: str, **args) -> None:
        """Structured point-in-time event ("i" phase, thread scope)."""
        if _under_capture("instant"):
            raise TraceUnderJitError(
                f"instant {name!r} emitted while a CUDA graph capture "
                "(or a torch.compile trace) is recording")
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": time.perf_counter_ns() / 1e3,
              "pid": self.pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, value) -> None:
        """Counter-series sample ("C" phase): Perfetto renders these as
        a stacked value track."""
        if _under_capture("counter"):
            raise TraceUnderJitError(
                f"counter {name!r} sampled while a CUDA graph capture "
                "(or a torch.compile trace) is recording: it would record "
                "ONE capture-time point, never a per-replay series")
        self._push({"name": name, "ph": "C",
                    "ts": time.perf_counter_ns() / 1e3, "pid": self.pid,
                    "tid": threading.get_ident(),
                    "args": {"value": float(value)}})

    def complete(self, name: str, t0_ns: int, t1_ns: int, **args) -> None:
        """Record an already-measured interval retroactively (the
        engine's sync wait is timed anyway; this avoids a second pair
        of clock reads)."""
        if _under_capture():
            raise TraceUnderJitError(
                f"complete {name!r} recorded while a CUDA graph capture "
                "(or a torch.compile trace) is recording")
        self._record_complete(name, t0_ns, t1_ns, args)

    def set_thread_name(self, name: str, tid: Optional[int] = None) -> None:
        with self._lock:
            self._thread_names[tid if tid is not None
                               else threading.get_ident()] = str(name)

    # -- internals -----------------------------------------------------
    def _record_complete(self, name, t0_ns, t1_ns, args):
        ev = {"name": name, "ph": "X", "ts": t0_ns / 1e3,
              "dur": max(t1_ns - t0_ns, 0) / 1e3,
              "pid": self.pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._push(ev)

    def _push(self, ev):
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)
            self.n_recorded += 1

    # -- export --------------------------------------------------------
    def events(self) -> list:
        """Snapshot of buffered events (metadata rows first)."""
        with self._lock:
            meta = [{"name": "thread_name", "ph": "M", "pid": self.pid,
                     "tid": tid, "args": {"name": nm}}
                    for tid, nm in sorted(self._thread_names.items())]
            return meta + list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export(self, path: str, metadata: Optional[dict] = None) -> str:
        md = {"n_recorded": self.n_recorded, "dropped": self.dropped}
        if metadata:
            md.update(metadata)
        return write_chrome_trace(self.events(), path, metadata=md,
                                  display_time_unit="ms")


# -- global tracer, armed by FLAGS_trace / PADDLE_TPU_TRACE=<path> -----
_global: Optional[Tracer] = None
_global_path: Optional[str] = None
_resolved = False
_atexit_armed = False


def _resolve_from_flags():
    from ..framework.flags import flag

    path = str(flag("trace")).strip()
    if path:
        enable(path)


def enable(path: Optional[str] = None, capacity: int = 65536) -> Tracer:
    """Arm the global tracer (programmatic equivalent of
    PADDLE_TPU_TRACE=<path>); `path` is where `export_global` lands."""
    global _global, _global_path, _resolved, _atexit_armed
    _resolved = True
    _global = Tracer(capacity=capacity)
    _global_path = path
    if path and not _atexit_armed:
        import atexit

        atexit.register(export_global)
        _atexit_armed = True
    return _global


def disable() -> None:
    global _global, _global_path, _resolved
    _global, _global_path, _resolved = None, None, True


def get_tracer() -> Optional[Tracer]:
    """The armed global tracer, or None (THE disabled fast path: every
    instrumentation site holds this result and does one `is None` check
    per event). The flag is re-read on every unarmed call, so
    `set_flags({'trace': ...})` after an earlier instrumented call still
    arms tracing; only an explicit `enable()`/`disable()` latches the
    decision (`_resolved`)."""
    if _global is None and not _resolved:
        _resolve_from_flags()
    return _global


class _NullSpan:
    """Singleton no-op context manager: `span()` with tracing off returns
    this one shared object, allocating nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, **args):
    """Module-level span against the global tracer; a shared no-op when
    tracing is off."""
    tr = get_tracer()
    return _NULL_SPAN if tr is None else tr.span(name, **args)


def instant(name: str, **args) -> None:
    tr = get_tracer()
    if tr is not None:
        tr.instant(name, **args)


def export_global(path: Optional[str] = None) -> Optional[str]:
    """Write the global tracer's buffer to `path` (default: the
    FLAGS_trace path). No-op when tracing is off."""
    tr = get_tracer()
    if tr is None:
        return None
    p = path or _global_path
    return tr.export(p) if p else None
