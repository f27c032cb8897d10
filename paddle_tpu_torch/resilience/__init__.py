"""paddle_tpu_torch.resilience: surviving flaky storage and hung steps
(counterpart of paddle_tpu/resilience).

Ported so far:

- `chaos`    — deterministic seed-driven fault injection armed via
  ``PADDLE_TPU_CHAOS`` (io_error / corrupt / preempt_at /
  preempt_host:K@N / hang / kill_worker:K@N);
- `retry`    — the jittered-exponential-backoff `RetryPolicy` the I/O
  seams share (the streaming checkpoint reader);
- `watchdog` — wall-clock deadlines around step callables, raising a
  structured `StepTimeout` with the last-known phase.

Still to port (ROADMAP.md section 1 item 4, with the trainer's hapi
layer and the fleet): `checkpoint`, `coordination`, `store` and
`preemption`.

Integration points: `serving.ContinuousBatchingEngine.run(
watchdog_timeout=..., requeue_hung=...)` and `models.checkpoint` shard
reads.
"""
from . import chaos  # noqa: F401
from .chaos import ChaosError, ChaosHang, ChaosKilled, ChaosMonkey  # noqa: F401
from .retry import RetryPolicy, RetryStats, retry  # noqa: F401
from .watchdog import StepTimeout, Watchdog  # noqa: F401

__all__ = ["ChaosError", "ChaosHang", "ChaosKilled", "ChaosMonkey",
           "RetryPolicy", "RetryStats", "StepTimeout", "Watchdog", "chaos",
           "retry"]
