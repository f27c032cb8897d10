"""paddle_tpu_torch.resilience: surviving flaky storage and hung steps
(counterpart of paddle_tpu/resilience).

Ported so far:

- `chaos`    — deterministic seed-driven fault injection armed via
  ``PADDLE_TPU_CHAOS`` (io_error / corrupt / preempt_at /
  preempt_host:K@N / hang / kill_worker:K@N);
- `retry`    — the jittered-exponential-backoff `RetryPolicy` the I/O
  seams share (the streaming checkpoint reader);
- `watchdog` — wall-clock deadlines around step callables, raising a
  structured `StepTimeout` with the last-known phase;
- `store`    — the `DictStore` / `FileStore` key-value stores (TTL,
  prefix scans, atomic file writes) the decode fleet's leases and its
  subprocess workers' mailboxes ride on.

Still to port (ROADMAP.md section 1 item 4, with the trainer's hapi
layer): `checkpoint`, `coordination` and `preemption`.

Integration points: `serving.ContinuousBatchingEngine.run(
watchdog_timeout=..., requeue_hung=...)`, `models.checkpoint` shard
reads, and `serving.fleet` (the `kill_worker` seam and the stores).
"""
from . import chaos  # noqa: F401
from .chaos import ChaosError, ChaosHang, ChaosKilled, ChaosMonkey  # noqa: F401
from .retry import RetryPolicy, RetryStats, retry  # noqa: F401
from .store import DictStore, FileStore  # noqa: F401
from .watchdog import StepTimeout, Watchdog  # noqa: F401

__all__ = ["ChaosError", "ChaosHang", "ChaosKilled", "ChaosMonkey",
           "DictStore", "FileStore", "RetryPolicy", "RetryStats",
           "StepTimeout", "Watchdog", "chaos", "retry"]
