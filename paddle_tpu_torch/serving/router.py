"""SLO-aware serving front end (counterpart of
paddle_tpu/serving/router.py).

The admission half of the fleet's control plane: every request carries a
**priority class** (``high`` / ``normal`` / ``low``) and optional **TTFT /
TPOT deadline budgets**; the router decides, BEFORE the request costs a
slot, a page or a prefill, whether the fleet can plausibly serve it, and
answers either a live `Request` handle or a structured
`Rejected(reason, retry_after_s)`:

- **queue-depth bound** (`FLAGS_router_max_queue`): low priority is capped
  at the bound, normal at 2x, high at 4x; under overload the backlog stays
  bounded and the shed is biased, so an overloaded trace sheds only its
  low classes while high-priority TTFT holds;
- **predicted wait**: admission reads the engines' MEASURED ``ttft_s`` /
  ``tpot_s`` histograms (each worker's `MetricsRegistry`): predicted TTFT
  = measured prefill baseline + backlog-ahead-of-you tokens / fleet decode
  rate. A request whose TTFT budget the prediction already blows is shed
  with ``reason="deadline"`` and a `retry_after_s` sized to the backlog
  draining; a TPOT budget below what the fleet measurably sustains sheds
  with ``reason="tpot"`` (waiting cannot fix a per-token rate);
- **late binding**: queued requests live HERE, ordered (priority,
  arrival); a worker holds only about 2x its slot count, so shed and
  requeue decisions keep their options until the last moment;
- **recovery** (with `serving/fleet.py`): a worker death requeues its
  dispatched requests at the head of their class; delivered tokens are
  kept and the continuation re-prefills ``prompt + tokens`` on a surviving
  worker. Requeue-once: a second death under the same request fails it
  cleanly (``error="worker died twice ..."``, the poison-request breaker);
- **fencing**: every worker report is stamped with the worker's lease
  epoch; reports from a fenced ``(worker, lease)`` pair are counted
  (`fenced_reports`) and dropped, so a presumed-dead worker cannot
  double-commit a recovered request.

Observability: `metrics()` returns one dict (shed / requeued /
worker_deaths / deadline_miss counters and per-worker gauges), and
`prometheus_text()` is a scrape-ready exposition of the same registry.
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..observability.metrics import MetricsRegistry
from .fleet import _Dispatch

PRIORITIES = ("high", "normal", "low")
_RANK = {p: i for i, p in enumerate(PRIORITIES)}
# queue-depth multiplier per class over FLAGS_router_max_queue
_DEPTH_MULT = {"high": 4, "normal": 2, "low": 1}


def _resolve_max_queue(value) -> int:
    if value is not None:
        return int(value)
    from ..framework.flags import flag

    return int(flag("router_max_queue"))


@dataclass
class Rejected:
    """A structured shed: WHY the request was not admitted and when a
    retry could plausibly succeed. Reasons: ``no_workers`` |
    ``too_large`` | ``overloaded`` | ``deadline`` | ``tpot``."""
    reason: str
    retry_after_s: float = 0.0
    detail: str = ""


@dataclass
class Request:
    """One admitted request tracked by the router across dispatches,
    worker deaths, and recoveries. `tokens` is the delivered stream
    (recovered prefix + the current worker's progress)."""
    req_id: int
    prompt: list
    max_new: int
    priority: str = "normal"
    ttft_deadline_s: Optional[float] = None
    tpot_deadline_s: Optional[float] = None
    arrival_time: float = 0.0
    tokens: list = field(default_factory=list)
    state: str = "queued"   # queued|dispatched|finished|failed
    worker_id: Optional[str] = None
    kills: int = 0          # worker deaths while dispatched here
    requeues: int = 0       # recovery + drain requeues
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    error: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.state in ("finished", "failed")

    @property
    def failed(self) -> bool:
        return self.state == "failed"

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time


class Router:
    """The SLO front-end over a `Fleet` of decode workers."""

    def __init__(self, fleet, *, max_queue=None, dispatch_depth: int = 2,
                 metrics: Optional[MetricsRegistry] = None):
        self.fleet = fleet
        self.max_queue = _resolve_max_queue(max_queue)
        self.dispatch_depth = int(dispatch_depth)
        self.mt = metrics if metrics is not None else MetricsRegistry()
        self._lock = threading.RLock()
        self._heap: List[tuple] = []     # (rank, seq, req)
        self._seq = 0
        self._next_id = 0
        self.requests: List[Request] = []
        # worker_id -> {req_id -> Request} currently dispatched there
        self._dispatched: Dict[str, Dict[int, Request]] = {}
        self._fenced: set = set()        # (worker_id, lease_epoch)
        fleet.bind(self._on_event)

    # -- admission -----------------------------------------------------
    def submit(self, prompt, max_new: Optional[int] = None, *,
               priority: str = "normal",
               ttft_deadline_s: Optional[float] = None,
               tpot_deadline_s: Optional[float] = None,
               arrival_time: Optional[float] = None):
        """Admission control. Returns a live `Request` or a structured
        `Rejected` — never raises for load reasons (malformed
        arguments still raise)."""
        if priority not in _RANK:
            raise ValueError(f"priority must be one of {PRIORITIES}, "
                             f"got {priority!r}")
        prompt = [int(t) for t in prompt]
        now = time.perf_counter()
        arrival = arrival_time if arrival_time is not None else now
        with self._lock:
            self.mt.counter("submitted").inc()
            workers = self.fleet.live()
            if not workers:
                return self._shed("no_workers", 1.0,
                                  "the fleet has no live workers")
            cap_prompt = max(w.max_prompt_len for w in workers.values())
            cap_new = max(w.max_new_budget for w in workers.values())
            if max_new is None:
                max_new = cap_new
            max_new = int(max_new)
            if not 1 <= len(prompt) <= cap_prompt:
                return self._shed(
                    "too_large", 0.0,
                    f"prompt length {len(prompt)} outside "
                    f"[1, {cap_prompt}]")
            if not 1 <= max_new <= cap_new:
                return self._shed(
                    "too_large", 0.0,
                    f"max_new {max_new} outside [1, {cap_new}]")
            depth = len(self._heap) + sum(
                len(d) for d in self._dispatched.values())
            depth_cap = self.max_queue * _DEPTH_MULT[priority]
            if depth >= depth_cap:
                return self._shed(
                    "overloaded", self._drain_eta_s(),
                    f"depth {depth} >= {priority} cap {depth_cap}")
            tpot = self._measured_tpot_s()
            if tpot_deadline_s is not None and tpot is not None \
                    and tpot > tpot_deadline_s:
                return self._shed(
                    "tpot", 0.0,
                    f"fleet sustains {tpot:.4f}s/token > budget "
                    f"{tpot_deadline_s:.4f}s")
            if ttft_deadline_s is not None:
                pred = self.predicted_ttft_s(priority)
                if pred > ttft_deadline_s:
                    return self._shed(
                        "deadline", max(pred - ttft_deadline_s, 0.0),
                        f"predicted TTFT {pred:.3f}s > budget "
                        f"{ttft_deadline_s:.3f}s")
            req = Request(self._next_id, prompt, max_new,
                          priority=priority,
                          ttft_deadline_s=ttft_deadline_s,
                          tpot_deadline_s=tpot_deadline_s,
                          arrival_time=arrival)
            self._next_id += 1
            self.requests.append(req)
            self.mt.counter("admitted").inc()
            self._push(req)
            self._dispatch_locked()
            return req

    def _shed(self, reason: str, retry_after_s: float,
              detail: str) -> Rejected:
        self.mt.counter("shed").inc()
        self.mt.counter(f"shed_{reason}").inc()
        from ..observability import record_event

        record_event("router.shed", reason=reason, detail=detail)
        return Rejected(reason, retry_after_s, detail)

    def _push(self, req: Request) -> None:
        # seq keeps FIFO inside a class; a recovered request reuses its
        # original seq so it re-enters at the HEAD of its class
        self._seq += 1
        heapq.heappush(self._heap,
                       (_RANK[req.priority], req.req_id, self._seq, req))

    # -- prediction ----------------------------------------------------
    def _hist_totals(self, name: str):
        total, count = 0.0, 0
        for w in self.fleet.live().values():
            h = w.metrics.histogram(name)
            total += h.sum
            count += h.count
        return total, count

    def _measured_tpot_s(self) -> Optional[float]:
        s, n = self._hist_totals("tpot_s")
        return s / n if n else None

    def _measured_ttft_s(self) -> Optional[float]:
        s, n = self._hist_totals("ttft_s")
        return s / n if n else None

    def predicted_ttft_s(self, priority: str = "normal") -> float:
        """Measured prefill baseline + (decode backlog ahead of this
        class) / (measured fleet decode rate). Optimistically 0 before
        any measurement exists — the first requests must be admitted
        to produce the histograms the prediction reads."""
        base = self._measured_ttft_s() or 0.0
        tpot = self._measured_tpot_s()
        if tpot is None or tpot <= 0:
            return base
        rank = _RANK[priority]
        backlog = sum(
            max(r.max_new - len(r.tokens), 0)
            for _, _, _, r in self._heap
            if not r.done and _RANK[r.priority] <= rank)
        backlog += sum(
            max(r.max_new - len(r.tokens), 0)
            for d in self._dispatched.values() for r in d.values())
        slots = sum(w.slots for w in self.fleet.live().values()) or 1
        return base + backlog * tpot / slots

    def _drain_eta_s(self) -> float:
        tpot = self._measured_tpot_s() or 0.05
        backlog = sum(max(r.max_new - len(r.tokens), 0)
                      for _, _, _, r in self._heap if not r.done)
        slots = sum(w.slots for w in self.fleet.live().values()) or 1
        return backlog * tpot / slots

    # -- dispatch ------------------------------------------------------
    def _dispatch_locked(self) -> None:
        workers = self.fleet.live()
        while self._heap:
            target, room = None, 0
            for wid, w in workers.items():
                if getattr(w, "_draining", False) or not w.alive:
                    continue
                load = len(self._dispatched.get(wid, {}))
                cap = self.dispatch_depth * w.slots
                if load < cap and (target is None or load < room):
                    target, room = wid, load
            if target is None:
                return
            _, _, _, req = heapq.heappop(self._heap)
            if req.done or req.state == "dispatched":
                continue
            w = workers[target]
            remaining = req.max_new - len(req.tokens)
            if remaining <= 0:
                self._finish_locked(req, time.perf_counter())
                continue
            if req.tokens and (len(req.prompt) + len(req.tokens)
                               <= w.max_prompt_len):
                # host-bounce continuation: re-prefill prompt+delivered
                # through the survivor's prefix cache
                dprompt = req.prompt + req.tokens
                dmax, base = remaining, len(req.tokens)
            else:
                # progress too long to re-prefill (or none): restart —
                # greedy decode regenerates the same tokens
                req.tokens = []
                dprompt, dmax, base = req.prompt, req.max_new, 0
            req.state = "dispatched"
            req.worker_id = target
            self._dispatched.setdefault(target, {})[req.req_id] = req
            w.submit(_Dispatch(req, dprompt, dmax,
                               priority=req.priority,
                               deadline_s=req.ttft_deadline_s,
                               base=base))

    # -- worker events -------------------------------------------------
    def _on_event(self, worker_id: str, lease_epoch: int, kind: str,
                  d: _Dispatch, info: dict) -> None:
        with self._lock:
            if (worker_id, lease_epoch) in self._fenced:
                self.mt.counter("fenced_reports").inc()
                return
            req: Request = d.req
            if req.done:
                return
            now = time.perf_counter()
            if kind == "progress":
                req.tokens = req.tokens[:d.base] + list(info["tokens"])
                if req.first_token_time is None and req.tokens:
                    req.first_token_time = (
                        info.get("prefill_time") or now)
            elif kind == "finished":
                req.tokens = req.tokens[:d.base] + list(info["tokens"])
                if req.first_token_time is None and req.tokens:
                    req.first_token_time = (
                        info.get("prefill_time") or now)
                self._dispatched.get(worker_id, {}).pop(req.req_id,
                                                        None)
                self._finish_locked(req, now)
            elif kind == "failed":
                self._dispatched.get(worker_id, {}).pop(req.req_id,
                                                        None)
                req.state = "failed"
                req.error = info.get("error") or "engine failure"
                req.finish_time = now
                self.mt.counter("requests_failed").inc()
            elif kind == "requeued":
                # planned drain: back to the head of its class, no
                # penalty (the worker did not die under it)
                self._dispatched.get(worker_id, {}).pop(req.req_id,
                                                        None)
                req.state = "queued"
                req.worker_id = None
                req.requeues += 1
                self.mt.counter("drain_requeued").inc()
                self._push(req)

    def _finish_locked(self, req: Request, now: float) -> None:
        req.state = "finished"
        req.finish_time = now
        self.mt.counter("requests_finished").inc()
        ttft = req.ttft_s
        if ttft is not None:
            self.mt.histogram(
                f"router_ttft_s_{req.priority}",
                f"router-observed TTFT, {req.priority} class"
            ).observe(ttft)
            if req.ttft_deadline_s is not None \
                    and ttft > req.ttft_deadline_s:
                self.mt.counter("deadline_miss_ttft").inc()
        if req.first_token_time is not None and len(req.tokens) > 1:
            tpot = ((req.finish_time - req.first_token_time)
                    / (len(req.tokens) - 1))
            self.mt.histogram(
                f"router_tpot_s_{req.priority}",
                f"router-observed TPOT, {req.priority} class"
            ).observe(tpot)
            if req.tpot_deadline_s is not None \
                    and tpot > req.tpot_deadline_s:
                self.mt.counter("deadline_miss_tpot").inc()

    # -- health / recovery --------------------------------------------
    def poll(self) -> None:
        """One control-plane turn: detect deaths, fence, recover
        in-flight requests (requeue-once), refresh gauges, dispatch."""
        dead = self.fleet.check_health()
        with self._lock:
            for wid, lease, reason in dead:
                self._fenced.add((wid, lease))
                self.mt.counter("worker_deaths").inc()
                victims = self._dispatched.pop(wid, {})
                for req in victims.values():
                    req.kills += 1
                    req.worker_id = None
                    if req.kills >= 2:
                        # requeue-once: a poison request fails cleanly
                        # instead of crash-looping the fleet
                        req.state = "failed"
                        req.error = (f"worker died twice under this "
                                     f"request (last: {wid}, {reason})")
                        req.finish_time = time.perf_counter()
                        self.mt.counter("poison_failed").inc()
                    else:
                        req.state = "queued"
                        req.requeues += 1
                        self.mt.counter("requeued").inc()
                        self._push(req)
            live = self.fleet.live()
            self.mt.gauge("live_workers").set(len(live))
            self.mt.gauge("queue_depth").set(len(self._heap))
            self.mt.gauge("inflight").set(
                sum(len(d) for d in self._dispatched.values()))
            for wid, w in live.items():
                self.mt.gauge(f"worker_{wid}_inflight").set(
                    len(self._dispatched.get(wid, {})))
                self.mt.gauge(f"worker_{wid}_backlog").set(
                    w.queue_len())
            self._dispatch_locked()

    def join(self, timeout: Optional[float] = None,
             poll_s: float = 0.005) -> List[Request]:
        """Drive poll() until every admitted request is terminal (or
        the timeout passes); returns the terminal requests."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while True:
            self.poll()
            pending = [r for r in self.requests if not r.done]
            if not pending:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(pending)} requests still pending after "
                    f"{timeout}s (states: "
                    f"{sorted({r.state for r in pending})})")
            time.sleep(poll_s)
        return [r for r in self.requests if r.done]

    # -- observability -------------------------------------------------
    def metrics(self) -> dict:
        """Every router counter in one dict + per-worker gauges."""
        with self._lock:
            c = self.mt.counter
            live = self.fleet.live()
            per_worker = {}
            for wid, w in live.items():
                per_worker[wid] = {
                    "lease_epoch": w.lease_epoch,
                    "alive": w.alive,
                    "slots": w.slots,
                    "inflight": len(self._dispatched.get(wid, {})),
                    "backlog": w.queue_len(),
                    "heartbeat_age_s": w.heartbeat_age_s(),
                }
            out = {
                "submitted": c("submitted").value,
                "admitted": c("admitted").value,
                "shed": c("shed").value,
                "shed_by_reason": {
                    r: c(f"shed_{r}").value
                    for r in ("no_workers", "too_large", "overloaded",
                              "deadline", "tpot")},
                "requeued": c("requeued").value,
                "drain_requeued": c("drain_requeued").value,
                "worker_deaths": c("worker_deaths").value,
                "poison_failed": c("poison_failed").value,
                "fenced_reports": c("fenced_reports").value,
                "deadline_miss": {
                    "ttft": c("deadline_miss_ttft").value,
                    "tpot": c("deadline_miss_tpot").value},
                "requests_finished": c("requests_finished").value,
                "requests_failed": c("requests_failed").value,
                "queue_depth": len(self._heap),
                "inflight": sum(len(d)
                                for d in self._dispatched.values()),
                "membership_epoch": self.fleet.epoch,
                "per_worker": per_worker,
            }
            for p in PRIORITIES:
                h = self.mt.histogram(f"router_ttft_s_{p}")
                if h.count:
                    out[f"ttft_{p}"] = h.summary()
            return out

    def prometheus_text(self, prefix: str = "paddle_tpu_router") -> str:
        """Text exposition 0.0.4 scrape of the router registry (shed /
        requeue / death counters, queue gauges, per-class TTFT/TPOT
        histograms)."""
        return self.mt.prometheus_text(prefix=prefix)
