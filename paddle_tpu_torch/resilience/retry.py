"""Retry with jittered exponential backoff (counterpart of
paddle_tpu/resilience/retry.py).

Transient I/O faults (a flaky blob store, a preempted NFS mount, a
throttled model hub) are the most common failure of a long job. This
module is the one retry implementation the port's I/O seams share: the
streaming checkpoint reader (`models/checkpoint._SafetensorsSource`).

Design constraints (all driven by testability on the CPU):

- the backoff sequence is a pure function of the policy + seed: tests
  assert the exact delays against a fake clock;
- ``sleep`` is injectable, so no test ever actually waits;
- attempt telemetry is kept on the policy (`RetryStats`), so callers can
  report how many faults the policy absorbed.
"""
from __future__ import annotations

import functools
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type


@dataclass
class RetryStats:
    """Telemetry the policy accumulates across calls (thread-safe via
    the policy's lock: concurrent readers share one policy)."""

    calls: int = 0        # .call() invocations
    attempts: int = 0     # function executions (>= calls)
    retries: int = 0      # sleeps taken after a retryable failure
    successes: int = 0
    giveups: int = 0      # exhausted attempts (last error re-raised)
    last_error: Optional[str] = None
    # most recent backoff sleeps only — a long-lived shared policy over
    # flaky storage must not grow memory per retry forever
    delays: list = field(default_factory=list)
    MAX_DELAYS = 64

    def as_dict(self) -> dict:
        return {"calls": self.calls, "attempts": self.attempts,
                "retries": self.retries, "successes": self.successes,
                "giveups": self.giveups, "last_error": self.last_error}


class RetryPolicy:
    """Jittered exponential backoff with an exception allowlist.

    delay(i) = min(max_delay, base_delay * multiplier**i)
               * (1 + jitter * U[0,1))            # seeded, deterministic

    Only exceptions in ``retry_on`` are retried; everything else
    propagates immediately (a KeyError from a missing tensor name must
    not burn three attempts — it will never succeed).

    Use as a callable wrapper or a decorator::

        policy = RetryPolicy(max_attempts=3, retry_on=(IOError,))
        data = policy.call(read_shard, path)

        @RetryPolicy(max_attempts=5)
        def fetch(url): ...
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.1,
                 retry_on: Tuple[Type[BaseException], ...] = (OSError,),
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 on_retry: Optional[Callable] = None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retry_on = tuple(retry_on)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._on_retry = on_retry
        self._lock = threading.Lock()
        self.stats = RetryStats()

    def __getstate__(self):
        # a DataLoader worker process gets its own copy, with a lock of
        # its own
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def delays(self):
        """The backoff sequence for one call (max_attempts - 1 sleeps).
        Consumes the policy RNG exactly as `.call` would."""
        for i in range(self.max_attempts - 1):
            base = min(self.max_delay, self.base_delay * self.multiplier ** i)
            yield base * (1.0 + self.jitter * self._rng.random())

    def call(self, fn: Callable, *args, **kwargs):
        with self._lock:
            self.stats.calls += 1
        delays = self.delays()
        for attempt in range(1, self.max_attempts + 1):
            with self._lock:
                self.stats.attempts += 1
            try:
                out = fn(*args, **kwargs)
            except self.retry_on as e:
                with self._lock:
                    self.stats.last_error = f"{type(e).__name__}: {e}"
                    if attempt >= self.max_attempts:
                        self.stats.giveups += 1
                        self._obs_event("retry.giveup", attempt=attempt,
                                        error=self.stats.last_error)
                        raise
                    delay = next(delays)
                    self.stats.retries += 1
                    self.stats.delays.append(delay)
                    del self.stats.delays[:-RetryStats.MAX_DELAYS]
                # RetryStats stays the per-policy source of truth; the
                # observability event log is where ALL resilience
                # telemetry converges
                self._obs_event("retry.backoff", attempt=attempt,
                                delay_s=round(delay, 4),
                                error=f"{type(e).__name__}: {e}")
                if self._on_retry is not None:
                    self._on_retry(attempt, e, delay)
                self._sleep(delay)
            else:
                with self._lock:
                    self.stats.successes += 1
                return out

    @staticmethod
    def _obs_event(name: str, **fields):
        from ..observability import record_event

        record_event(name, **fields)

    def wrap(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.retry_policy = self
        return wrapped

    # decorator form: @RetryPolicy(...) above a def
    def __call__(self, fn: Callable) -> Callable:
        if not callable(fn):
            raise TypeError(
                "RetryPolicy() is a decorator; to invoke a function "
                "through the policy use .call(fn, *args)")
        return self.wrap(fn)


def retry(**policy_kwargs) -> Callable:
    """``@retry(max_attempts=5, retry_on=(IOError,))`` decorator sugar."""
    policy = RetryPolicy(**policy_kwargs)
    return policy.wrap


def default_io_policy(**overrides) -> RetryPolicy:
    """The policy I/O seams share, sized by the FLAGS_io_retry_attempts
    flag (env: PADDLE_TPU_IO_RETRIES) and FLAGS_io_retry_base_delay_s.
    attempts=1 disables retrying."""
    from ..framework.flags import flag

    kw = dict(max_attempts=max(1, int(flag("io_retry_attempts"))),
              base_delay=float(flag("io_retry_base_delay_s")),
              retry_on=(OSError,))
    kw.update(overrides)
    return RetryPolicy(**kw)
