"""Step watchdog: wall-clock deadlines around step callables
(counterpart of paddle_tpu/resilience/watchdog.py).

A wedged collective, a hung host callback or a stuck storage mount all
present the same way: a step that never returns. The watchdog bounds
every step with a deadline and turns "the job is silently stuck" into a
structured `StepTimeout` carrying the last phase the step reported,
which the serving engine uses to retire the victim and keep the other
slots alive.

Implementation: the wrapped callable runs on a worker thread while the
calling thread monitors the deadline. Python cannot safely interrupt a
thread blocked in C (a hung kernel wait or a stalled read), so on
timeout the worker is *abandoned* (daemon thread; its eventual result or
exception is discarded) and the caller gets the exception. Callers must
therefore only pass steps whose abandonment is safe: the serving engine
injects its chaos hang *before* the device call and checks its owner
before every host-set write, replay and commit, so an abandoned worker
never touches the card again.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional


class StepTimeout(TimeoutError):
    """A watchdogged step blew its deadline.

    Attributes:
        name:    the watchdog's name (e.g. "engine.step").
        phase:   last phase the step reported before hanging.
        timeout_s / elapsed_s: the deadline and the observed wall time.
    """

    def __init__(self, name: str, phase: Optional[str], timeout_s: float,
                 elapsed_s: float):
        self.name = name
        self.phase = phase
        self.timeout_s = timeout_s
        self.elapsed_s = elapsed_s
        super().__init__(
            f"{name} exceeded its {timeout_s:.3g}s deadline "
            f"(ran {elapsed_s:.3g}s; last phase: {phase or 'unknown'})")


class Watchdog:
    """Deadline wrapper for step callables.

    ::

        wd = Watchdog(timeout_s=30.0, name="engine.step")
        try:
            out = wd.call(engine.step)        # step sets wd.phase = "..."
        except StepTimeout as e:
            handle(e.phase)

    `phase` is a thread-safe free-form label the step updates as it
    progresses; the timeout carries the last value, so the operator
    learns *where* it hung, not just that it hung.
    """

    def __init__(self, timeout_s: float, name: str = "step"):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.name = name
        self._lock = threading.Lock()
        self._phase: Optional[str] = None
        self.timeouts = 0  # telemetry: deadlines blown so far

    @property
    def phase(self) -> Optional[str]:
        with self._lock:
            return self._phase

    @phase.setter
    def phase(self, value: Optional[str]):
        with self._lock:
            self._phase = value

    def call(self, fn: Callable, *args, **kwargs) -> Any:
        """Run ``fn(*args, **kwargs)`` under the deadline. Returns its
        result, re-raises its exception, or raises `StepTimeout`.

        One worker thread is spawned per call (~100us): noise next to
        the multi-ms device steps this guards (the serving engine runs
        `steps_per_sync` decode tokens per call). The worker inherits
        none of the caller's thread-local torch state (current CUDA
        device and stream, grad mode): a callable that launches work
        sets them itself, as the engine's `run()` does."""
        result: list = []
        error: list = []

        def target():
            try:
                result.append(fn(*args, **kwargs))
            except BaseException as e:  # delivered to the caller below
                error.append(e)

        t0 = time.monotonic()
        worker = threading.Thread(target=target, daemon=True,
                                  name=f"watchdog:{self.name}")
        worker.start()
        worker.join(self.timeout_s)
        if worker.is_alive():
            self.timeouts += 1
            elapsed = time.monotonic() - t0
            from ..observability import record_event

            record_event("watchdog.timeout", watchdog=self.name,
                         phase=self.phase, timeout_s=self.timeout_s,
                         elapsed_s=round(elapsed, 4))
            raise StepTimeout(self.name, self.phase, self.timeout_s,
                              elapsed)
        if error:
            raise error[0]
        return result[0]

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form; the wrapped callable raises StepTimeout."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.watchdog = self
        return wrapped
