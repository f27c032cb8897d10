"""paddle_tpu_torch.resilience: surviving preemptions, flaky storage
and hung steps (counterpart of paddle_tpu/resilience).

Seven pillars, each independently usable and all chaos-testable on the
CPU:

- `checkpoint`   — atomic, digest-verified, generation-counted pytree
  checkpoints with async save and corrupt-generation fallback, in the
  JAX package's on-disk format;
- `coordination` — multi-host gangs: store-backed barriers with
  structured `BarrierTimeout`s, two-phase group commit
  (`CheckpointManager(dir, coordinator=...)`), restore-generation
  agreement (min over digest-verified hosts), coordinated GC;
- `store`        — the `DictStore` / `FileStore` key-value stores (TTL,
  prefix scans, atomic file writes) the barriers, the decode fleet's
  leases and its subprocess workers' mailboxes ride on;
- `chaos`        — deterministic seed-driven fault injection armed via
  ``PADDLE_TPU_CHAOS`` (io_error / corrupt / preempt_at /
  preempt_host:K@N / hang / kill_worker:K@N);
- `preemption`   — SIGTERM/SIGINT -> step-boundary flag -> emergency
  checkpoint + clean exit;
- `watchdog`     — wall-clock deadlines around step callables, raising
  a structured `StepTimeout` with the last-known phase;
- `retry`        — the jittered-exponential-backoff `RetryPolicy` the
  I/O seams share (checkpoint shards, the streaming checkpoint reader,
  the DataLoader).

Integration points: `hapi.Model.fit(checkpoint_dir=..., resume=True,
coordinator=...)`, `parallel.launch.GangSupervisor` (subprocess gang
relaunch), `serving.ContinuousBatchingEngine.run(watchdog_timeout=...,
requeue_hung=...)`, `models.checkpoint` shard reads, and
`serving.fleet` (the `kill_worker` seam and the stores).
"""
from . import chaos  # noqa: F401
from .checkpoint import (  # noqa: F401
    Checkpoint, CheckpointCorruptError, CheckpointError,
    CheckpointManager, CheckpointNotFoundError, restore_checkpoint,
    save_checkpoint,
)
from .chaos import ChaosError, ChaosHang, ChaosKilled, ChaosMonkey  # noqa: F401
from .coordination import (  # noqa: F401
    Barrier, BarrierTimeout, Coordinator, GangCheckpointManager,
)
from .preemption import EXIT_PREEMPTED, PreemptionGuard  # noqa: F401
from .retry import RetryPolicy, RetryStats, retry  # noqa: F401
from .store import DictStore, FileStore  # noqa: F401
from .watchdog import StepTimeout, Watchdog  # noqa: F401

__all__ = [
    "Barrier", "BarrierTimeout", "Checkpoint", "CheckpointCorruptError",
    "CheckpointError", "CheckpointManager", "CheckpointNotFoundError",
    "ChaosError", "ChaosHang", "ChaosKilled", "ChaosMonkey",
    "Coordinator",
    "DictStore", "EXIT_PREEMPTED", "FileStore", "GangCheckpointManager",
    "PreemptionGuard", "RetryPolicy", "RetryStats", "StepTimeout",
    "Watchdog", "chaos", "restore_checkpoint", "retry",
    "save_checkpoint",
]
