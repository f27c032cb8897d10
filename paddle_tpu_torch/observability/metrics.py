"""Metrics registry: counters, gauges, bucketed histograms, events
(counterpart of paddle_tpu/observability/metrics.py; the JAX package's
default prefix and metric names, so dashboards carry over).

One registry for every number the port used to keep as ad-hoc
attributes (`eng.sync_wait_s`, `RetryStats`, chaos firing counters,
watchdog retirements). Design constraints:

- **bucketed histograms**, not sample lists: a serving process
  observing TTFT per request for days must hold O(buckets), not
  O(requests). Percentiles are linear interpolation inside the bucket
  containing the rank, exact to within one bucket's width;
- **thread-safe** (one lock per instrument): engine step threads and
  the watchdog's abandoned workers all emit;
- **cheap when off**: the module-level `get_metrics()` is None unless
  FLAGS_metrics / PADDLE_TPU_METRICS armed it; instrumentation sites
  hold the result and do one `is None` check;
- three export surfaces: `snapshot()` (one nested dict), `emit_jsonl`
  (append one JSON line per snapshot) and `prometheus_text` (text
  exposition format 0.0.4 for a scrape endpoint).

Default latency buckets span 100us..51.2s in x2 steps, tight enough
that a bucket-interpolated p99 is a usable SLO number.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_metrics", "enable", "disable",
           "DEFAULT_LATENCY_BUCKETS_S"]

# 1e-4 .. 51.2s in x2 steps (+inf overflow bucket is implicit)
DEFAULT_LATENCY_BUCKETS_S = tuple(1e-4 * 2 ** i for i in range(20))


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "doc", "_lock", "_value")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (pool occupancy, queue depth)."""

    __slots__ = ("name", "doc", "_lock", "_value")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-boundary bucketed histogram with interpolated percentiles.

    `bounds` are the UPPER edges of the finite buckets (ascending); one
    +inf overflow bucket rides at the end. `percentile(q)` walks the
    cumulative counts to the bucket containing rank q and interpolates
    linearly inside it (the overflow bucket reports its lower edge —
    there is no upper edge to interpolate toward; `max` is exact and
    tracked separately).
    """

    __slots__ = ("name", "doc", "bounds", "_lock", "counts", "count",
                 "sum", "min", "max")

    def __init__(self, name: str, doc: str = "",
                 bounds=DEFAULT_LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b2 <= b1 for b1, b2
                             in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram bounds must be non-empty ascending, got "
                f"{bounds}")
        self.name = name
        self.doc = doc
        self.bounds = bounds
        self._lock = threading.Lock()
        self.counts = [0] * (len(bounds) + 1)  # +1: overflow (+inf)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        # bisect over a ~20-entry tuple: fast enough, no numpy import
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self.counts[lo] += 1
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def _percentile_from(self, counts, count, vmin, vmax, q):
        """Percentile over a lock-consistent copy of the state
        (`bounds` is immutable, so only the mutables are copied)."""
        if not count:
            return None
        rank = q / 100.0 * count
        cum = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                if i < len(self.bounds):
                    hi = self.bounds[i]
                else:  # overflow bucket: no upper edge to interpolate
                    # toward — report its lower edge (clamped up to
                    # the exact min when ALL mass overflowed); only
                    # the terminal rank earns the exact max. Returning
                    # max for mid ranks would report p50 == max
                    # whenever the mass exceeds the top bound.
                    if rank >= count:
                        return vmax
                    return max(lo, vmin if vmin is not None else lo)
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return vmax  # pragma: no cover - rank <= count always

    def _state(self):
        with self._lock:
            return list(self.counts), self.count, self.sum, \
                self.min, self.max

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]. None when empty."""
        counts, count, _, vmin, vmax = self._state()
        return self._percentile_from(counts, count, vmin, vmax, q)

    def percentiles(self, qs=(50, 90, 99)) -> Dict[str, Optional[float]]:
        counts, count, _, vmin, vmax = self._state()
        return {f"p{q:g}": self._percentile_from(counts, count, vmin,
                                                 vmax, q) for q in qs}

    def summary(self, qs=(50, 90, 99)) -> dict:
        """count/sum/min/max/mean + percentiles from ONE consistent
        read — a scrape racing `observe()` must not report a count
        that disagrees with the sum/percentiles next to it."""
        counts, count, s, vmin, vmax = self._state()
        out = {"count": count, "sum": s, "min": vmin, "max": vmax,
               "mean": s / count if count else None}
        for q in qs:
            out[f"p{q:g}"] = self._percentile_from(counts, count, vmin,
                                                   vmax, q)
        return out

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self.sum / self.count if self.count else None


class MetricsRegistry:
    """Name-keyed instruments + a bounded structured-event log.

    ::

        m = MetricsRegistry()
        m.counter("requests").inc()
        m.histogram("ttft_s").observe(0.12)
        m.event("watchdog.retire", slot=3, phase="decode")
        m.snapshot()   # one nested dict
    """

    MAX_EVENTS = 4096

    def __init__(self, max_events: int = MAX_EVENTS):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._events = deque(maxlen=max_events)
        self._t0 = time.time() - time.perf_counter()

    # -- instrument access (get-or-create, stable across threads) ------
    def counter(self, name: str, doc: str = "") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, doc)
            return c

    def gauge(self, name: str, doc: str = "") -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, doc)
            return g

    def histogram(self, name: str, doc: str = "",
                  bounds=DEFAULT_LATENCY_BUCKETS_S) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, doc, bounds)
            return h

    def event(self, name: str, **fields) -> None:
        """Structured event (bounded log): resilience telemetry —
        chaos faults, watchdog retirements, retry give-ups — lands
        here with a wall-clock timestamp."""
        ev = {"event": name, "t": self._t0 + time.perf_counter()}
        if fields:
            ev.update(fields)
        with self._lock:
            self._events.append(ev)

    def events(self, name: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if name is None else [e for e in evs
                                         if e["event"] == name]

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Everything as one nested dict (bench rows embed a subset)."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = list(self._histograms.items())
            n_events = len(self._events)
        out_h = {n: h.summary() for n, h in hists}
        return {"counters": counters, "gauges": gauges,
                "histograms": out_h, "n_events": n_events}

    def emit_jsonl(self, path, extra: Optional[dict] = None) -> None:
        """Append one snapshot as a JSON line (path or open file)."""
        doc = {"ts": time.time(), **(extra or {}), **self.snapshot()}
        line = json.dumps(doc) + "\n"
        if hasattr(path, "write"):
            path.write(line)
        else:
            with open(path, "a") as f:
                f.write(line)

    def prometheus_text(self, prefix: str = "paddle_tpu") -> str:
        """Prometheus text exposition format 0.0.4 (counters, gauges,
        and cumulative-bucket histograms with +Inf, _sum, _count)."""
        def san(n):
            return "".join(ch if ch.isalnum() or ch == "_" else "_"
                           for ch in n)

        lines = []
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        for n, c in counters:
            fq = f"{prefix}_{san(n)}_total"
            if c.doc:
                lines.append(f"# HELP {fq} {c.doc}")
            lines.append(f"# TYPE {fq} counter")
            lines.append(f"{fq} {c.value}")
        for n, g in gauges:
            fq = f"{prefix}_{san(n)}"
            if g.doc:
                lines.append(f"# HELP {fq} {g.doc}")
            lines.append(f"# TYPE {fq} gauge")
            lines.append(f"{fq} {g.value}")
        for n, h in hists:
            fq = f"{prefix}_{san(n)}"
            if h.doc:
                lines.append(f"# HELP {fq} {h.doc}")
            lines.append(f"# TYPE {fq} histogram")
            with h._lock:
                cum = 0
                for bound, cnt in zip(h.bounds, h.counts):
                    cum += cnt
                    lines.append(f'{fq}_bucket{{le="{bound:g}"}} {cum}')
                cum += h.counts[-1]
                lines.append(f'{fq}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{fq}_sum {h.sum}")
                lines.append(f"{fq}_count {h.count}")
        return "\n".join(lines) + "\n"


# -- global registry, armed by FLAGS_metrics / PADDLE_TPU_METRICS ------
_global: Optional[MetricsRegistry] = None
_resolved = False


def _resolve_from_flags():
    global _global
    from ..framework.flags import flag

    if bool(flag("metrics")):
        _global = MetricsRegistry()


def enable() -> MetricsRegistry:
    global _global, _resolved
    _resolved = True
    _global = MetricsRegistry()
    return _global


def disable() -> None:
    global _global, _resolved
    _global, _resolved = None, True


def get_metrics() -> Optional[MetricsRegistry]:
    """The armed global registry, or None (the disabled fast path —
    hold the result, check `is None` once per site). Like
    `trace.get_tracer`, the flag is re-read on every unarmed call so
    `set_flags({'metrics': True})` after first use still arms the
    registry; explicit `enable()`/`disable()` latches (`_resolved`)."""
    if _global is None and not _resolved:
        _resolve_from_flags()
    return _global
