"""Deterministic fault injection for the resilience seams (counterpart
of paddle_tpu/resilience/chaos.py: the same grammar, and the same
``PADDLE_TPU_CHAOS`` spec and seed arm the same schedule).

Every recovery path is testable on the CPU because the faults
themselves are injectable: a seed-driven registry activated from the
environment monkey-patches nothing broad. The production code calls
narrow, named *seams* (`maybe_io_error("shard_read")`, `on_step("fit",
n)`, `maybe_hang("decode")`, `corrupt("ckpt.write", data)`) that are
no-ops unless a matching fault is armed.

Activation (see `framework/flags.py`)::

    PADDLE_TPU_CHAOS=io_error:0.1,hang:decode python serve.py
    PADDLE_TPU_CHAOS_SEED=7   # deterministic fault schedule

Fault grammar (comma-separated ``kind:arg[:arg2]``):

    io_error:P[:SEAM]   raise IOError with probability P at io seams
                        (optionally only at seams containing SEAM)
    corrupt:P[:SEAM]    flip a byte of written payloads with prob. P
    preempt_at:N        deliver a real SIGTERM at loop step N (once)
    preempt_host:K@N    HARD-kill gang rank K (SIGKILL, no grace) when it
                        executes loop step N exactly; the rank comes
                        from PADDLE_GANG_RANK, so the same spec can be
                        armed fleet-wide and fires on one host
    hang:SEAM[:SECS]    stall SEAM for SECS (default 60) once, then
                        raise ChaosHang so the abandoned worker thread
                        unwinds without side effects
    kill_worker:K@N     kill FLEET worker K at its `fleet.worker` loop
                        step N (exactly, once): an in-process worker
                        thread unwinds on ChaosKilled without
                        deregistering, flushing progress or returning
                        its queue

Faults count their firings in `.counters`. The port's serving engine
and checkpoint reader call `maybe_hang("decode")` and
`maybe_io_error("shard_read")`; the other seams wait for the trainer
and fleet layers.
"""
from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class ChaosError(IOError):
    """An injected I/O fault (subclasses IOError so the production
    retry allowlists treat it exactly like the real thing)."""


class ChaosHang(RuntimeError):
    """Raised after a chaos hang elapses — the stall is over and the
    (typically watchdog-abandoned) thread must unwind WITHOUT touching
    shared state it no longer owns."""


class ChaosKilled(BaseException):
    """An injected hard worker death (`kill_worker:K@N`). Deliberately
    NOT an Exception: a fleet worker's defensive `except Exception`
    around its serve loop must not swallow it — death means no final
    progress report, no heartbeat deregistration, no cleanup, exactly
    like a SIGKILLed process."""


@dataclass
class _Fault:
    kind: str            # io_error | corrupt | preempt_at | preempt_host | hang
    prob: float = 0.0    # io_error / corrupt
    step: int = -1       # preempt_at / preempt_host
    seam: str = ""       # seam filter (io_error/corrupt) or target (hang)
    seconds: float = 60.0  # hang duration
    rank: int = -1       # preempt_host victim (gang rank)
    fired: int = 0


def gang_rank() -> Optional[int]:
    """This process's gang rank (PADDLE_GANG_RANK, exported by the gang
    supervisor), or None outside a gang."""
    raw = os.environ.get("PADDLE_GANG_RANK")
    if raw is None or not raw.strip():
        return None
    try:
        return int(raw)
    except ValueError:
        return None


class ChaosMonkey:
    """A parsed fault schedule with its own deterministic RNG."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.faults: List[_Fault] = []
        self.counters: Dict[str, int] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            bits = part.split(":")
            kind = bits[0]
            if kind == "io_error" or kind == "corrupt":
                f = _Fault(kind, prob=float(bits[1]) if len(bits) > 1
                           else 1.0,
                           seam=bits[2] if len(bits) > 2 else "")
            elif kind == "preempt_at":
                f = _Fault(kind, step=int(bits[1]))
            elif kind == "preempt_host":
                rank_s, sep, step_s = (bits[1] if len(bits) > 1
                                       else "").partition("@")
                if not sep:
                    raise ValueError(
                        f"preempt_host needs K@N (kill rank K at step "
                        f"N), got {part!r} in spec {spec!r}")
                f = _Fault(kind, rank=int(rank_s), step=int(step_s))
            elif kind == "hang":
                f = _Fault(kind, seam=bits[1] if len(bits) > 1 else "",
                           seconds=float(bits[2]) if len(bits) > 2
                           else 60.0)
            elif kind == "kill_worker":
                rank_s, sep, step_s = (bits[1] if len(bits) > 1
                                       else "").partition("@")
                if not sep:
                    raise ValueError(
                        f"kill_worker needs K@N (kill fleet worker K at "
                        f"its step N), got {part!r} in spec {spec!r}")
                f = _Fault(kind, rank=int(rank_s), step=int(step_s))
            else:
                raise ValueError(
                    f"unknown chaos fault {kind!r} in spec {spec!r}; "
                    "known: io_error, corrupt, preempt_at, "
                    "preempt_host, hang, kill_worker")
            self.faults.append(f)

    def _count(self, fault: _Fault, seam: str = ""):
        fault.fired += 1
        self.counters[fault.kind] = self.counters.get(fault.kind, 0) + 1
        # chaos firings surface as structured observability events so a
        # chaos-soaked serve can attribute every absorbed fault from one
        # metrics snapshot; .counters stays authoritative
        from ..observability import record_event

        record_event("chaos." + fault.kind,
                     seam=seam or fault.seam or None)

    def _match(self, kind: str, seam: str) -> Optional[_Fault]:
        for f in self.faults:
            if f.kind == kind and (not f.seam or f.seam in seam):
                return f
        return None

    # -- seams ---------------------------------------------------------
    def maybe_io_error(self, seam: str):
        """Raise ChaosError(IOError) at an I/O seam with the armed
        probability."""
        f = self._match("io_error", seam)
        if f is None:
            return
        with self._lock:
            hit = self._rng.random() < f.prob
            if hit:
                self._count(f, seam)
        if hit:
            raise ChaosError(f"chaos: injected IOError at seam {seam!r} "
                             f"(p={f.prob}, seed={self.seed})")

    def corrupt(self, seam: str, data: bytes) -> bytes:
        """Possibly flip one byte of `data` (deterministic position)."""
        f = self._match("corrupt", seam)
        if f is None or not data:
            return data
        with self._lock:
            if self._rng.random() >= f.prob:
                return data
            self._count(f, seam)
            pos = self._rng.randrange(len(data))
        out = bytearray(data)
        out[pos] ^= 0xFF
        return bytes(out)

    def on_step(self, loop: str, step: int):
        """Called once per loop step; delivers SIGTERM at `preempt_at`'s
        step (once per fault), SIGKILL at `preempt_host:K@N` when THIS
        process is gang rank K executing step N."""
        for f in self.faults:
            if f.kind == "preempt_at" and not f.fired and step >= f.step \
                    and (not f.seam or f.seam in loop):
                self._count(f, loop)
                import signal

                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind == "preempt_host" and not f.fired \
                    and step == f.step and gang_rank() == f.rank:
                self._count(f, loop)
                # a HOST preemption: no grace window, no signal handler,
                # no emergency checkpoint — the process is simply gone.
                # Recovery is the gang protocol: peers trip BarrierTimeout
                # at the next coordinated checkpoint, the supervisor
                # relaunches, and everyone agrees on a restore generation.
                import signal

                os.kill(os.getpid(), signal.SIGKILL)

    def maybe_kill_worker(self, worker: int, step: int):
        """The `fleet.worker` seam: called once per fleet-worker loop
        iteration; raises ChaosKilled when THIS worker index executes
        the armed step exactly (once per fault — mirrors
        `preempt_host`'s one-shot equality so a recovered/requeued
        request does not re-kill a relaunched worker at the same
        step)."""
        for f in self.faults:
            if f.kind == "kill_worker" and not f.fired \
                    and step == f.step and worker == f.rank:
                self._count(f, f"fleet.worker:{worker}")
                raise ChaosKilled(
                    f"chaos: fleet worker {worker} killed at step "
                    f"{step} (kill_worker:{f.rank}@{f.step})")

    def maybe_hang(self, seam: str):
        """Stall once at `seam`, then raise ChaosHang (the stalled
        thread has usually been abandoned by a watchdog; raising lets it
        unwind without executing the rest of the step)."""
        for f in self.faults:
            if f.kind == "hang" and not f.fired and f.seam \
                    and f.seam in seam:
                with self._lock:
                    if f.fired:
                        continue
                    self._count(f, seam)
                time.sleep(f.seconds)
                raise ChaosHang(
                    f"chaos: hang at seam {seam!r} elapsed "
                    f"({f.seconds}s); abandoning step")


# -- activation --------------------------------------------------------
_installed: Optional[ChaosMonkey] = None
_env_cache: Dict[tuple, ChaosMonkey] = {}


def install(spec: str, seed: int = 0) -> ChaosMonkey:
    """Programmatic activation (tests); overrides the environment."""
    global _installed
    _installed = ChaosMonkey(spec, seed)
    return _installed


def uninstall():
    global _installed
    _installed = None
    _env_cache.clear()


def get_chaos() -> Optional[ChaosMonkey]:
    """The active injector, or None. Environment-armed injectors are
    cached per (spec, seed) so their RNG stream is continuous across
    seam calls."""
    if _installed is not None:
        return _installed
    spec = os.environ.get("PADDLE_TPU_CHAOS", "").strip()
    seed_raw = os.environ.get("PADDLE_TPU_CHAOS_SEED")
    if not spec:  # env unset: fall back to the flag registry (set_flags)
        from ..framework.flags import flag

        spec = str(flag("tpu_chaos")).strip()
        if seed_raw is None:
            seed_raw = flag("tpu_chaos_seed")
    if not spec:
        return None
    seed = int(seed_raw or 0)
    key = (spec, seed)
    if key not in _env_cache:
        _env_cache[key] = ChaosMonkey(spec, seed)
    return _env_cache[key]


# -- thin module-level seam helpers (no-ops when chaos is off) ---------
def maybe_io_error(seam: str):
    c = get_chaos()
    if c is not None:
        c.maybe_io_error(seam)


def corrupt(seam: str, data: bytes) -> bytes:
    c = get_chaos()
    return data if c is None else c.corrupt(seam, data)


def on_step(loop: str, step: int):
    c = get_chaos()
    if c is not None:
        c.on_step(loop, step)


def maybe_hang(seam: str):
    c = get_chaos()
    if c is not None:
        c.maybe_hang(seam)


def maybe_kill_worker(worker: int, step: int):
    c = get_chaos()
    if c is not None:
        c.maybe_kill_worker(worker, step)


def counters() -> Dict[str, int]:
    c = get_chaos()
    return {} if c is None else dict(c.counters)
