"""Preemption handling: turn SIGTERM into a step-boundary flag
(counterpart of paddle_tpu/resilience/preemption.py).

Preemptible machines get a termination notice (SIGTERM, then a hard
kill after a grace window). The only safe reaction is cooperative: flip
a flag in the signal handler and let the training loop notice it at the
next step boundary, write an emergency checkpoint, and exit cleanly —
never checkpoint *inside* the handler (the interpreter may be anywhere,
including mid-write of the previous checkpoint, or between two kernel
launches of a step).

`hapi.Model.fit(checkpoint_dir=...)` installs the module-level guard
for the duration of training; `paddle_tpu_torch.resilience.chaos`
delivers a real SIGTERM at a configured step
(``PADDLE_TPU_CHAOS=preempt_at:N``) so the whole path is testable on
the CPU.
"""
from __future__ import annotations

import os
import signal
import threading
from typing import Optional, Tuple

# exit code a preemption-terminated run should use once its emergency
# checkpoint is committed: 0 — the run did everything right, the
# scheduler (not the job) decided to stop it, and a nonzero code would
# trip retry-on-failure alerting.
EXIT_PREEMPTED = 0


class PreemptionGuard:
    """Installs signal handlers that flip `requested`.

    ::

        with PreemptionGuard() as guard:
            for step in range(n):
                train_step()
                if guard.requested:
                    save_emergency_checkpoint()
                    break

    The previous handlers are restored on uninstall, and the previous
    handler is *chained* (called after the flag flips) so an outer
    framework's handler still runs. Installation is only possible from
    the main thread (a CPython restriction); elsewhere the guard
    degrades to a manually-settable flag and `installed` stays False.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signals = tuple(signals)
        self._lock = threading.Lock()
        self._requested = False
        self._signum: Optional[int] = None
        self._count = 0
        self._previous = {}
        self.installed = False

    # -- flag ----------------------------------------------------------
    @property
    def requested(self) -> bool:
        with self._lock:
            return self._requested

    @property
    def signum(self) -> Optional[int]:
        with self._lock:
            return self._signum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def reset(self):
        with self._lock:
            self._requested = False
            self._signum = None
            self._count = 0

    def deliver(self, signum: int = signal.SIGTERM):
        """Flip the flag as if `signum` had arrived (tests, and the
        non-main-thread degraded mode)."""
        self._on_signal(signum, None)

    # -- handler lifecycle --------------------------------------------
    def _on_signal(self, signum, frame):
        with self._lock:
            self._requested = True
            self._signum = signum
            self._count += 1
        prev = self._previous.get(signum)
        # chain a USER-installed handler only. Python's
        # default_int_handler would raise KeyboardInterrupt right here —
        # mid-step, at an arbitrary bytecode — which is exactly the
        # abort-anywhere behaviour the step-boundary flag replaces.
        if callable(prev) and prev is not signal.default_int_handler \
                and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        if self.installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self  # degraded mode: flag-only, deliver() works
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._on_signal)
        self.installed = True
        return self

    def uninstall(self):
        if not self.installed:
            return
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # not main thread / torn down
                pass
        self._previous.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


# -- module-level default guard (what fit() and user loops share) ------
_guard: Optional[PreemptionGuard] = None
_guard_depth = 0
_guard_lock = threading.Lock()


def install(signals: Tuple[int, ...] = (signal.SIGTERM,
                                        signal.SIGINT)) -> PreemptionGuard:
    """Install (or re-enter) the shared process-wide guard. Nested
    installs share one guard; uninstall() unwinds when the outermost
    caller releases it."""
    global _guard, _guard_depth
    with _guard_lock:
        if _guard is None:
            _guard = PreemptionGuard(signals).install()
        _guard_depth += 1
        return _guard


def uninstall():
    global _guard, _guard_depth
    with _guard_lock:
        if _guard is None:
            return
        _guard_depth -= 1
        if _guard_depth <= 0:
            _guard.uninstall()
            _guard = None
            _guard_depth = 0


def requested() -> bool:
    """True once a preemption signal has been seen by the shared guard."""
    g = _guard
    return g.requested if g is not None else False


def self_preempt():
    """Deliver a real SIGTERM to this process (chaos `preempt_at`)."""
    os.kill(os.getpid(), signal.SIGTERM)
