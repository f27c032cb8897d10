"""Fault-tolerant elastic decode fleet (counterpart of
paddle_tpu/serving/fleet.py).

A `Fleet` owns N decode workers: in-process engine threads
(`FleetWorker`) and store-backed subprocess workers (`SubprocessWorker`,
entry point `parallel/launch/serve_worker.py`), plus the membership
bookkeeping that makes a worker's death survivable:

- **heartbeat leases** ride `resilience/store.py`: every worker renews
  ``fleet/<job>/hb/<id>`` with a TTL (`FLAGS_fleet_heartbeat_s`); an
  expired lease or a dead worker thread is a detected death;
- **membership epochs**: every join, leave and death bumps
  ``fleet/<job>/epoch``. A worker's lease carries the epoch it joined
  at; after a death the pair ``(worker_id, lease_epoch)`` is FENCED: the
  router drops any late report stamped with it, so a worker that was
  only presumed dead (a slow heartbeat) cannot double-commit a request
  that already recovered elsewhere;
- **in-flight recovery**: in-process workers stream per-request progress
  after every committed chunk, so the router holds the tokens already
  delivered; on a death the request re-prefills ``prompt + delivered
  tokens`` on a surviving worker through the normal prefix-cache path
  (greedy decode is Markov in the sequence, so the continuation is the
  undisturbed stream up to the rounding of the prefill path).
  Requeue-once: a request whose worker dies TWICE is failed cleanly (a
  poison request must not crash-loop the fleet);
- **elastic scale-out / in**: `add_worker` mid-serve joins at a new
  epoch (with ``warm=True`` its engine captures its programs, CUDA
  graphs on the card, before it takes traffic, while the other workers
  of its device wait at the device gate); `remove_worker(drain=
  True)` pauses the engine's admission (`engine.pause_admission`),
  finishes in-flight slots and hands the untouched queue back to the
  router;
- **chaos**: the ``fleet.worker`` seam (`kill_worker:K@N` in
  `resilience/chaos.py`) hard-kills worker K at its loop step N: an
  in-process thread unwinds on `ChaosKilled` with no cleanup, no final
  report and no lease deregistration, like a SIGKILLed host.

Threads on the card: a worker's serve loop runs on its own thread under
the torch state of the thread that built the worker (the engine's
device, that thread's current stream and grad mode), so its replays and
host-set copies land on the stream its programs and host sets were made
for. Every in-process worker of a device holds that device's
`DeviceGate` around its engine's device work (each `step()`, with any
first-use capture in it, and the `warm()` of `add_worker`), so no
capture runs beside another engine's launches: the split attention
kernels share one scratch a device (`kernels.decode_attention`), and a
capture's eager warm-up runs on a stream of its own.

Smoke CLI::

    PADDLE_TPU_CHAOS=kill_worker:1@6 \\
        python -m paddle_tpu_torch.serving.fleet --workers 2 --requests 10

prints one JSON summary row and exits 0 iff every non-shed request
reached a terminal state. It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..observability import record_event
from ..observability.metrics import MetricsRegistry
from ..observability.trace import Tracer, merge_chrome_traces
from ..resilience import chaos
from ..resilience.store import DictStore


def _resolve_heartbeat_s(value) -> float:
    if value is not None:
        return float(value)
    from ..framework.flags import flag

    return float(flag("fleet_heartbeat_s"))


class DeviceGate:
    """The lock of one device that in-process engines hold, one at a
    time, around their device work. The holder's launches are ordered
    after everything the previous holder queued: on the card, when the
    two hold different streams, the new holder's stream waits for an
    event the previous one recorded on its own. With it no capture's
    eager warm-up (on its graph site's stream) runs beside another
    engine's split kernels, which share one scratch a device, and the
    launch counters see one thread at a time."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lock = threading.Lock()
        self._event = None     # recorded by the last holder on the card
        self._stream = None    # the stream it was recorded on

    def __enter__(self):
        self._lock.acquire()
        try:
            if self._stream is not None:
                cur = torch.cuda.current_stream(self.device)
                if cur != self._stream:
                    cur.wait_event(self._event)
        except BaseException:
            self._lock.release()
            raise
        return self

    def __exit__(self, *exc):
        try:
            if self.device.type == "cuda":
                if self._event is None:
                    self._event = torch.cuda.Event()
                self._stream = torch.cuda.current_stream(self.device)
                self._event.record(self._stream)
        finally:
            self._lock.release()
        return False


_GATES: Dict[str, DeviceGate] = {}
_GATES_LOCK = threading.Lock()


def device_gate(device) -> DeviceGate:
    """The process's one `DeviceGate` of `device` (every fleet of the
    process shares it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _GATES_LOCK:
        gate = _GATES.get(str(dev))
        if gate is None:
            gate = _GATES[str(dev)] = DeviceGate(dev)
        return gate


@dataclass
class _Dispatch:
    """One unit of work handed to a worker: the (possibly continuation)
    prompt plus the router-side request it reports back against. `base`
    is how many tokens of `req.tokens` were delivered before this
    dispatch (the recovered prefix)."""
    req: object
    prompt: list
    max_new: int
    priority: str = "normal"
    deadline_s: Optional[float] = None
    base: int = 0


class FleetWorker:
    """In-process decode worker: one engine served by one thread.

    The thread loop is the `fleet.worker` chaos seam: each iteration
    drains the dispatch mailbox into `engine.add_request`, runs one
    `engine.step()` and streams progress and completions to the fleet's
    event sink, stamped with its lease epoch (the router drops stamped
    reports once the worker is fenced). The loop runs under the torch
    state of the thread that built the worker, and each step holds the
    engine's `device_gate`. The heartbeat lease is renewed by a sidecar
    thread that stops the moment the serve thread dies: a step blocked on
    a first-use capture or at the gate cannot expire the lease, a killed
    or crashed worker still does."""

    def __init__(self, worker_id: str, index: int, engine_factory,
                 store, job_id: str, lease_epoch: int,
                 emit: Callable, *, heartbeat_s: float = 0.25,
                 heartbeat_ttl_s: Optional[float] = None,
                 trace: bool = False, poll_s: float = 0.002):
        self.worker_id = worker_id
        self.index = index
        self.store = store
        self.job_id = job_id
        self.lease_epoch = lease_epoch
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_ttl_s = (float(heartbeat_ttl_s)
                                if heartbeat_ttl_s is not None
                                else 4.0 * self.heartbeat_s)
        self.poll_s = float(poll_s)
        self.metrics = MetricsRegistry()
        self.tracer = Tracer() if trace else None
        self.engine = engine_factory(
            metrics=self.metrics,
            tracer=self.tracer if self.tracer is not None else False)
        self.gate = device_gate(self.engine.device)
        self._emit = emit
        self._lock = threading.Lock()
        self._mailbox: List[_Dispatch] = []
        self._stop = threading.Event()
        self._draining = False
        # terminal flags, read by Fleet.check_health
        self.clean_exit = False
        self.killed = False          # ChaosKilled (fleet.worker seam)
        self.crashed: Optional[BaseException] = None
        self.steps = 0
        # engine req_id -> (ServeRequest, _Dispatch)
        self._active: Dict[int, tuple] = {}
        self._fin_seen = 0
        self._last_len: Dict[int, int] = {}
        self._hb_key = f"fleet/{job_id}/hb/{worker_id}"
        # the first lease is written by the CALLER (add_worker), so a
        # health check racing the thread's start never sees it missing
        self._heartbeat(0)
        # this (the building) thread's device, stream and grad mode
        self._serve = self.engine._on_this_thread_state(self._serve_loop)
        self._hb_stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"fleet-worker-{worker_id}",
            daemon=True)
        self._thread.start()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name=f"fleet-hb-{worker_id}",
            daemon=True)
        self._hb_thread.start()

    # -- caller-side API ----------------------------------------------
    @property
    def slots(self) -> int:
        return self.engine.slots

    @property
    def max_prompt_len(self) -> int:
        return self.engine.max_prompt_len

    @property
    def max_new_budget(self) -> int:
        return self.engine.max_new

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def submit(self, d: _Dispatch) -> None:
        with self._lock:
            self._mailbox.append(d)

    def queue_len(self) -> int:
        """Approximate backlog (mailbox + engine queues + live slots):
        unlocked reads of host counters, a scheduling hint."""
        eng = self.engine
        return (len(self._mailbox) + len(eng.waiting)
                + len(eng._handoff) + eng.n_active
                + (1 if eng._prefilling is not None else 0))

    def request_drain(self) -> None:
        """Begin a graceful drain: finish in-flight slots, requeue the
        rest through the event sink, then exit cleanly."""
        self._draining = True

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def heartbeat_age_s(self) -> Optional[float]:
        raw = self.store.get(self._hb_key)
        if raw is None:
            return None
        try:
            return max(time.time() - float(json.loads(raw)["t"]), 0.0)
        except Exception:
            return None

    # -- worker thread ------------------------------------------------
    def _heartbeat(self, step: int) -> None:
        self.store.put(
            self._hb_key,
            json.dumps({"t": time.time(), "epoch": self.lease_epoch,
                        "step": step}),
            ttl=self.heartbeat_ttl_s)

    def _hb_loop(self) -> None:
        while not self._hb_stop.is_set() and self._thread.is_alive():
            self._heartbeat(self.steps)
            self._hb_stop.wait(self.heartbeat_s)

    def _run(self) -> None:
        if self.tracer is not None:
            self.tracer.set_thread_name(f"worker:{self.worker_id}")
        try:
            self._serve()
            self.clean_exit = True
            self._hb_stop.set()
            self.store.delete(self._hb_key)
        except chaos.ChaosKilled:
            # a hard death: no final report, no lease deregistration;
            # the lease expires, the fleet fences, the router recovers
            self.killed = True
        except BaseException as e:  # a crash: check_health reports it
            self.crashed = e

    def _serve_loop(self) -> None:
        eng = self.engine
        while not self._stop.is_set():
            # the fleet.worker chaos seam (kill_worker:K@N)
            chaos.maybe_kill_worker(self.index, self.steps)
            self._drain_mailbox()
            if self._draining:
                eng.pause_admission(True)
            if eng.n_active > 0 or eng._prefilling is not None \
                    or eng._handoff or (eng.waiting
                                        and not self._draining):
                with self.gate:
                    eng.step()
                self._report()
            elif self._draining:
                self._requeue_leftovers()
                return
            else:
                time.sleep(self.poll_s)
            self.steps += 1

    def _drain_mailbox(self) -> None:
        with self._lock:
            batch, self._mailbox = self._mailbox, []
        for d in batch:
            if self._draining:
                self._emit(self.worker_id, self.lease_epoch,
                           "requeued", d, {})
                continue
            try:
                ereq = self.engine.add_request(
                    d.prompt, d.max_new, priority=d.priority,
                    deadline_s=d.deadline_s)
            except Exception as e:
                self._emit(self.worker_id, self.lease_epoch, "failed",
                           d, {"error": str(e)})
                continue
            self._active[ereq.req_id] = (ereq, d)
            self._last_len[ereq.req_id] = 0

    def _report(self) -> None:
        fin = self.engine.finished
        while self._fin_seen < len(fin):
            ereq = fin[self._fin_seen]
            self._fin_seen += 1
            entry = self._active.pop(ereq.req_id, None)
            self._last_len.pop(ereq.req_id, None)
            if entry is None:
                continue
            _, d = entry
            kind = "failed" if ereq.failed else "finished"
            self._emit(self.worker_id, self.lease_epoch, kind, d,
                       {"tokens": list(ereq.tokens),
                        "error": ereq.error,
                        "prefill_time": ereq.prefill_time})
        for ereq, d in list(self._active.values()):
            n = len(ereq.tokens)
            if n > self._last_len.get(ereq.req_id, 0):
                self._last_len[ereq.req_id] = n
                self._emit(self.worker_id, self.lease_epoch,
                           "progress", d,
                           {"tokens": list(ereq.tokens),
                            "prefill_time": ereq.prefill_time})

    def _requeue_leftovers(self) -> None:
        """Planned drain: in-flight work is done; everything still queued
        goes back to the router (the engine hook take_waiting)."""
        for ereq in self.engine.take_waiting():
            entry = self._active.pop(ereq.req_id, None)
            self._last_len.pop(ereq.req_id, None)
            if entry is None:
                continue
            self._emit(self.worker_id, self.lease_epoch, "requeued",
                       entry[1], {})
        with self._lock:
            batch, self._mailbox = self._mailbox, []
        for d in batch:
            self._emit(self.worker_id, self.lease_epoch, "requeued",
                       d, {})


class SubprocessWorker:
    """Store-backed handle to a `parallel/launch/serve_worker.py`
    subprocess: the interface the router drives (`submit`, lease epoch,
    capacities, health flags), with the mailbox, progress and results on
    `FileStore` keys instead of memory; death is a dead process or an
    expired lease. Progress still streams (the worker writes
    ``prog/<wid>/<rid>`` per committed chunk), so in-flight recovery keeps
    delivered tokens across processes too."""

    def __init__(self, worker_id: str, index: int, proc, store,
                 job_id: str, lease_epoch: int, emit: Callable,
                 info: dict):
        self.worker_id = worker_id
        self.index = index
        self.proc = proc
        self.store = store
        self.job_id = job_id
        self.lease_epoch = lease_epoch
        self.metrics = MetricsRegistry()  # no cross-process histograms
        self.tracer = None
        self._emit = emit
        self._info = info
        self._lock = threading.Lock()
        self._pending: Dict[int, _Dispatch] = {}  # rid -> dispatch
        self._seq = 0
        self._draining = False
        self._pre = f"fleet/{job_id}"
        self._hb_key = f"{self._pre}/hb/{worker_id}"

    # -- the interface shared with FleetWorker -------------------------
    @property
    def slots(self) -> int:
        return int(self._info["slots"])

    @property
    def max_prompt_len(self) -> int:
        return int(self._info["max_prompt_len"])

    @property
    def max_new_budget(self) -> int:
        return int(self._info["max_new"])

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    @property
    def clean_exit(self) -> bool:
        return self.proc.returncode == 0

    @property
    def killed(self) -> bool:
        rc = self.proc.returncode
        return rc is not None and rc < 0

    def submit(self, d: _Dispatch) -> None:
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._pending[d.req.req_id] = d
        self.store.put(
            f"{self._pre}/req/{self.worker_id}/{seq:08d}",
            json.dumps({"rid": d.req.req_id, "prompt": d.prompt,
                        "max_new": d.max_new, "priority": d.priority,
                        "deadline_s": d.deadline_s}))

    def queue_len(self) -> int:
        return len(self._pending)

    def request_drain(self) -> None:
        self._draining = True
        self.store.put(f"{self._pre}/ctl/{self.worker_id}", "drain")

    def stop(self) -> None:
        self.store.put(f"{self._pre}/ctl/{self.worker_id}", "stop")

    def join(self, timeout: Optional[float] = None) -> None:
        try:
            self.proc.wait(timeout)
        except Exception:
            pass

    def heartbeat_age_s(self) -> Optional[float]:
        raw = self.store.get(self._hb_key)
        if raw is None:
            return None
        try:
            return max(time.time() - float(json.loads(raw)["t"]), 0.0)
        except Exception:
            return None

    def pump(self) -> None:
        """Relay store-written progress, result and requeue keys into the
        fleet's event sink (once per `check_health`)."""
        wid = self.worker_id
        for key, raw in self.store.prefix(
                f"{self._pre}/prog/{wid}/").items():
            try:
                rid = int(key.rsplit("/", 1)[1])
                tokens = json.loads(raw)["tokens"]
            except Exception:
                continue
            d = self._pending.get(rid)
            if d is not None:
                self._emit(wid, self.lease_epoch, "progress", d,
                           {"tokens": tokens})
        for key, raw in self.store.prefix(
                f"{self._pre}/done/{wid}/").items():
            self.store.delete(key)
            try:
                rid = int(key.rsplit("/", 1)[1])
                res = json.loads(raw)
            except Exception:
                continue
            d = self._pending.pop(rid, None)
            if d is None:
                continue
            kind = "failed" if res.get("failed") else "finished"
            self._emit(wid, self.lease_epoch, kind, d,
                       {"tokens": res.get("tokens") or [],
                        "error": res.get("error")})
        for key, _raw in self.store.prefix(
                f"{self._pre}/requeue/{wid}/").items():
            self.store.delete(key)
            try:
                rid = int(key.rsplit("/", 1)[1])
            except Exception:
                continue
            d = self._pending.pop(rid, None)
            if d is not None:
                self._emit(wid, self.lease_epoch, "requeued", d, {})


class Fleet:
    """Membership and health for a group of decode workers.

    The fleet owns WHO is serving (leases, epochs, fencing) and the
    router (`serving/router.py`) owns WHAT is served (queues, SLO
    admission, recovery placement). `bind()` connects them: worker
    events flow into the router's sink stamped ``(worker_id,
    lease_epoch)``."""

    def __init__(self, engine_factory, *, store=None,
                 job_id: str = "fleet", heartbeat_s=None,
                 trace: bool = False, worker_poll_s: float = 0.002):
        self.engine_factory = engine_factory
        self.store = store if store is not None else DictStore()
        self.job_id = job_id
        self.heartbeat_s = _resolve_heartbeat_s(heartbeat_s)
        self.trace = bool(trace)
        self.worker_poll_s = float(worker_poll_s)
        self.epoch = 0
        self.workers: Dict[str, FleetWorker] = {}
        self.fenced: Dict[str, int] = {}   # worker_id -> lease epoch
        self.deaths: List[dict] = []
        self._forced: List[tuple] = []     # (worker_id, reason)
        self._sink: Optional[Callable] = None
        self._next_index = 0
        self._lock = threading.Lock()

    # -- event plumbing ------------------------------------------------
    def bind(self, sink: Callable) -> None:
        """`sink(worker_id, lease_epoch, kind, dispatch, info)`, normally
        `Router._on_event`. Bound before work is submitted."""
        self._sink = sink

    def _emit(self, worker_id, lease_epoch, kind, dispatch, info):
        if self._sink is not None:
            self._sink(worker_id, lease_epoch, kind, dispatch, info)

    # -- membership ----------------------------------------------------
    def _bump_epoch(self) -> int:
        self.epoch += 1
        self.store.put(f"fleet/{self.job_id}/epoch", str(self.epoch))
        return self.epoch

    def add_worker(self, worker_id: Optional[str] = None, *,
                   warm: bool = False, warm_kwargs: Optional[dict] = None
                   ) -> str:
        """Elastic scale-OUT: join at a fresh membership epoch. With
        `warm=True` the new engine captures its programs
        (`engine.warm(**warm_kwargs)`) on the calling thread, holding the
        device gate, before the worker takes traffic."""
        with self._lock:
            index = self._next_index
            self._next_index += 1
            wid = worker_id or f"w{index}"
            if wid in self.workers:
                raise ValueError(f"worker {wid!r} already in the fleet")
            epoch = self._bump_epoch()
            worker = FleetWorker(
                wid, index, self.engine_factory, self.store,
                self.job_id, epoch, self._emit,
                heartbeat_s=self.heartbeat_s, trace=self.trace,
                poll_s=self.worker_poll_s)
            if warm:
                with worker.gate:
                    worker.engine.warm(**(warm_kwargs or {}))
            self.store.put(
                f"fleet/{self.job_id}/member/{wid}",
                json.dumps({"epoch": epoch, "index": index}))
            self.workers[wid] = worker
        record_event("fleet.join", worker=wid, epoch=epoch)
        return wid

    def add_subprocess_worker(self, worker_id: Optional[str] = None, *,
                              extra_args=(), env: Optional[dict] = None,
                              ready_timeout_s: float = 180.0) -> str:
        """Scale out with a `serve_worker` SUBPROCESS (its own engine,
        its own process). Requires a `FileStore` (the lease and mailbox
        must be visible across processes). Blocks until the worker
        publishes its ``info/<wid>`` readiness record."""
        import subprocess
        import sys

        root = getattr(self.store, "root", None)
        if root is None:
            raise ValueError(
                "subprocess workers need a FileStore-backed fleet "
                "(store=FileStore(dir)): a DictStore lease is invisible "
                "to another process")
        with self._lock:
            index = self._next_index
            self._next_index += 1
            wid = worker_id or f"w{index}"
            if wid in self.workers:
                raise ValueError(f"worker {wid!r} already in the fleet")
            epoch = self._bump_epoch()
        argv = [sys.executable, "-m",
                "paddle_tpu_torch.parallel.launch.serve_worker",
                "--store", str(root), "--job", self.job_id,
                "--worker-id", wid, "--index", str(index),
                "--lease-epoch", str(epoch),
                "--heartbeat-s", str(self.heartbeat_s),
                *extra_args]
        penv = dict(os.environ)
        if env:
            penv.update(env)
        proc = subprocess.Popen(argv, env=penv)
        info_key = f"fleet/{self.job_id}/info/{wid}"
        deadline = time.monotonic() + ready_timeout_s
        info = None
        while time.monotonic() < deadline:
            raw = self.store.get(info_key)
            if raw is not None:
                info = json.loads(raw)
                break
            if proc.poll() is not None:
                raise RuntimeError(
                    f"serve_worker {wid} exited rc={proc.returncode} "
                    "before publishing readiness")
            time.sleep(0.05)
        if info is None:
            proc.kill()
            proc.wait()
            raise TimeoutError(
                f"serve_worker {wid} not ready in {ready_timeout_s}s")
        worker = SubprocessWorker(wid, index, proc, self.store,
                                  self.job_id, epoch, self._emit, info)
        with self._lock:
            self.workers[wid] = worker
            self.store.put(
                f"fleet/{self.job_id}/member/{wid}",
                json.dumps({"epoch": epoch, "index": index,
                            "pid": info.get("pid")}))
        record_event("fleet.join", worker=wid, epoch=epoch,
                     subprocess=True)
        return wid

    def remove_worker(self, worker_id: str, *, drain: bool = True,
                      timeout: float = 60.0) -> None:
        """Elastic scale-IN: drain (finish in-flight, requeue the rest
        through the event sink) and leave at a fresh epoch."""
        worker = self.workers.get(worker_id)
        if worker is None:
            return
        if drain:
            worker.request_drain()
        else:
            worker.stop()
        worker.join(timeout)
        if not worker.clean_exit:
            # the worker died (or hung) DURING the drain: it stays a
            # member, so the next check_health reports the death and the
            # router recovers its in-flight requests
            return
        with self._lock:
            self.workers.pop(worker_id, None)
            self.fenced[worker_id] = worker.lease_epoch
            self._bump_epoch()
            self.store.delete(f"fleet/{self.job_id}/member/{worker_id}")
        record_event("fleet.leave", worker=worker_id, epoch=self.epoch)

    def fence(self, worker_id: str, reason: str = "manual") -> None:
        """Force-fence a worker: it is treated as dead at the next
        `check_health` even if its thread still runs; the router drops
        its stamped reports from then on."""
        with self._lock:
            self._forced.append((worker_id, reason))

    def live(self) -> Dict[str, FleetWorker]:
        with self._lock:
            return dict(self.workers)

    def membership(self) -> dict:
        with self._lock:
            return {"epoch": self.epoch,
                    "workers": {wid: w.lease_epoch
                                for wid, w in self.workers.items()},
                    "fenced": dict(self.fenced)}

    # -- health --------------------------------------------------------
    def check_health(self) -> List[tuple]:
        """Detect newly dead workers. Death = a chaos kill or a crash (the
        thread or process is gone without a clean exit), or an expired
        heartbeat lease on a worker that is NOT verifiably alive locally
        (for a local thread or process, direct liveness outranks a starved
        lease renewal). Dead workers are fenced at their lease epoch,
        removed from membership and returned as ``(worker_id, lease_epoch,
        reason)`` for the router to recover."""
        dead: List[tuple] = []
        stale: List[str] = []
        # relay store-backed workers' reports BEFORE the death check: a
        # finished-then-died worker's committed results still count
        for w in self.live().values():
            pump = getattr(w, "pump", None)
            if pump is not None:
                pump()
        with self._lock:
            forced, self._forced = self._forced, []
            for wid, reason in forced:
                w = self.workers.get(wid)
                if w is not None:
                    dead.append((wid, w.lease_epoch, reason))
                    w.stop()
            for wid, w in list(self.workers.items()):
                if any(d[0] == wid for d in dead):
                    continue
                if not w.alive and not w.clean_exit:
                    reason = "chaos_kill" if w.killed else "crash"
                    dead.append((wid, w.lease_epoch, reason))
                elif w.heartbeat_age_s() is None:
                    if w.alive:
                        # the lease lapsed but the worker is verifiably
                        # alive: renewal starvation, not a death. Fencing
                        # here would orphan its requests on a false
                        # positive; record it and move on
                        stale.append(wid)
                    elif not w.clean_exit:
                        dead.append((wid, w.lease_epoch, "heartbeat"))
                        w.stop()
            for wid, lease, reason in dead:
                self.workers.pop(wid, None)
                self.fenced[wid] = lease
                self.deaths.append({"worker": wid, "lease": lease,
                                    "reason": reason})
                self._bump_epoch()
                self.store.delete(f"fleet/{self.job_id}/member/{wid}")
        for wid, lease, reason in dead:
            record_event("fleet.worker_death", worker=wid, lease=lease,
                         reason=reason)
        for wid in stale:
            record_event("fleet.stale_lease", worker=wid)
        return dead

    # -- lifecycle and observability -----------------------------------
    def stop(self, timeout: float = 30.0) -> None:
        for w in list(self.workers.values()):
            w.stop()
        for w in list(self.workers.values()):
            w.join(timeout)

    def export_merged_trace(self, path: str) -> Optional[str]:
        """One Perfetto JSON for the whole fleet: each live worker's
        tracer exports to a sidecar file, then `merge_chrome_traces`
        stamps one process per worker (needs `trace=True` workers)."""
        import tempfile

        paths, labels = [], []
        with tempfile.TemporaryDirectory() as td:
            for wid, w in self.live().items():
                if w.tracer is None:
                    continue
                p = os.path.join(td, f"{wid}.json")
                w.tracer.export(p)
                paths.append(p)
                labels.append(f"worker:{wid}")
            if not paths:
                return None
            merge_chrome_traces(paths, path, labels=labels)
        return path


# ---------------------------------------------------------------------
# smoke CLI
# ---------------------------------------------------------------------

def _smoke(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.fleet",
        description="in-process fleet smoke: serve a tiny mixed trace "
                    "(optionally under kill_worker chaos) and print one "
                    "JSON summary row")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (raises "
                         "without one)")
    ap.add_argument("--format", choices=("json",), default="json")
    args = ap.parse_args(argv)

    import numpy as np

    from ..device import resolve_device
    from ..models import LlamaConfig, init_serving_params
    from .engine import ContinuousBatchingEngine
    from .router import Rejected, Router

    device = resolve_device(args.device)
    # a narrow model whose head_dim (128) and pages (64 tokens) the
    # card's kernels take
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, intermediate_size=512)
    params = init_serving_params(cfg, seed=args.seed, device=device)

    def factory(*, metrics, tracer):
        return ContinuousBatchingEngine(
            cfg, params, slots=2, prompt_bucket=64, max_prompt_len=64,
            max_new_tokens=max(args.max_new, 4), block_size=64,
            steps_per_sync=2, device=device, metrics=metrics, tracer=tracer)

    fleet = Fleet(factory, heartbeat_s=0.1)
    router = Router(fleet, max_queue=max(args.requests, 8))
    for _ in range(args.workers):
        # the trace's one prompt bucket; prompts under a page never map a
        # cached prefix
        fleet.add_worker(warm=True, warm_kwargs={"buckets": [64],
                                                 "prefix_widths": []})

    rng = np.random.default_rng(args.seed)
    prios = ("high", "normal", "low")
    results = []
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              (int(rng.integers(3, 9)),)).tolist()
        results.append(router.submit(
            prompt, args.max_new, priority=prios[i % 3],
            ttft_deadline_s=120.0))
        router.poll()
        time.sleep(0.01)
    router.join(timeout=120.0)
    fleet.stop()

    m = router.metrics()
    shed = sum(1 for r in results if isinstance(r, Rejected))
    done = sum(1 for r in results
               if not isinstance(r, Rejected) and r.done)
    row = {
        "bench": "fleet_smoke",
        "workers": args.workers,
        "submitted": args.requests,
        "finished": done,
        "shed": shed,
        "worker_deaths": m["worker_deaths"],
        "requeued": m["requeued"],
        "membership_epoch": m["membership_epoch"],
        "chaos": chaos.counters(),
        "ok": bool(done + shed == args.requests),
    }
    print(json.dumps(row))
    return 0 if row["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(_smoke())
