"""Gang supervisor: spawn, watch, and relaunch a checkpoint-coordinated
worker gang (counterpart of paddle_tpu/parallel/launch/gang.py).

N subprocess workers form a gang, rendezvous through a shared
`resilience.store.FileStore` directory, and checkpoint through the
coordinated two-phase protocol (`resilience/coordination.py`). The
supervisor's job is the RECOVERY loop — detect a dead worker fast, tear
the survivors down (a gang whose member vanished is blocked at its next
barrier anyway), and relaunch everyone into ``fit(resume=True)`` where
generation agreement rolls the whole gang back to one common
checkpoint:

    sup = GangSupervisor([sys.executable, "train.py"], nprocs=4,
                         store_dir="/tmp/gang-store", max_restarts=3)
    result = sup.run()      # GangResult: attempts, restarts, success

Workers read their identity from the environment the supervisor
exports — ``PADDLE_GANG_RANK``, ``PADDLE_GANG_WORLD_SIZE``,
``PADDLE_GANG_STORE``, ``PADDLE_GANG_ATTEMPT``, ``PADDLE_GANG_JOB`` —
typically via ``resilience.coordination.from_env()``. Each relaunch
bumps the ATTEMPT, which namespaces every coordination key: a dead
incarnation's barrier arrivals can never satisfy the new gang's.

Restart semantics are whole-gang (the torchrun/MPI model): ANY nonzero
worker exit fails the attempt, survivors get SIGTERM (grace) then
SIGKILL, and all N ranks relaunch. A rank that already exited 0 is
relaunched too — its resumed run restores the agreed generation and
re-drains to completion, which is idempotent by construction.

Host code only: this module imports no torch and leaves
``CUDA_VISIBLE_DEVICES`` alone, so every rank of a one-card host shares
the card (pass a per-rank ``env`` to pin ranks to cards). Every wait is
bounded: a killed worker is reaped with a timeout, and `run(timeout=)`
bounds the whole supervision.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

__all__ = ["GangResult", "GangSupervisor"]

_Argv = Union[Sequence[str], Callable[[int], Sequence[str]]]
_Env = Union[None, Dict[str, str], Callable[[int, int], Dict[str, str]]]


@dataclass
class GangResult:
    """What a supervised gang run amounted to."""

    success: bool
    attempts: int                    # launch rounds actually run
    world_size: int
    exit_codes: List[int]            # final attempt, by rank
    # every relaunch decision: (rank, attempt_it_died_in, exit_code);
    # exit_code < 0 is -signal (e.g. -9 = SIGKILLed, a host preemption)
    restarts: List[tuple] = field(default_factory=list)
    wall_s: float = 0.0
    recovery_wall_s: float = 0.0     # death detected -> gang respawned

    def as_dict(self) -> dict:
        return {"success": self.success, "attempts": self.attempts,
                "world_size": self.world_size,
                "exit_codes": self.exit_codes,
                "restarts": [list(r) for r in self.restarts],
                "wall_s": round(self.wall_s, 3),
                "recovery_wall_s": round(self.recovery_wall_s, 3)}


class GangSupervisor:
    """Spawn/monitor/relaunch an N-worker gang (module docstring).

    Parameters:
      argv: worker command line (list), or ``rank -> list`` callable.
      nprocs: gang world size.
      store_dir: FileStore directory the gang rendezvouses through
        (created; also hosts per-attempt worker logs under ``logs/``).
      max_restarts: relaunch rounds after the first (0 = one shot).
      env: extra environment — a dict, or ``(rank, attempt) -> dict``
        callable. The per-attempt form is how a one-shot chaos fault
        (``PADDLE_TPU_CHAOS=preempt_host:K@N``) is armed on attempt 0
        only: a preemption is an external event, not a property of the
        worker, and re-arming it on the resumed run would re-kill the
        relaunched rank when it replays step N.
      terminate_grace_s: SIGTERM -> SIGKILL grace for survivors of a
        failed attempt.
      poll_interval: worker liveness poll period.
    """

    def __init__(self, argv: _Argv, nprocs: int, *, store_dir: str,
                 job_id: str = "gang", max_restarts: int = 3,
                 env: _Env = None, terminate_grace_s: float = 5.0,
                 poll_interval: float = 0.05):
        if nprocs < 1:
            raise ValueError(f"nprocs must be >= 1, got {nprocs}")
        self.argv = argv
        self.nprocs = nprocs
        self.store_dir = str(store_dir)
        self.job_id = job_id
        self.max_restarts = int(max_restarts)
        self.env = env
        self.terminate_grace_s = terminate_grace_s
        self.poll_interval = poll_interval
        os.makedirs(os.path.join(self.store_dir, "logs"), exist_ok=True)

    # -- per-worker plumbing -------------------------------------------
    def _argv_for(self, rank: int) -> List[str]:
        a = self.argv(rank) if callable(self.argv) else self.argv
        return [str(x) for x in a]

    def _env_for(self, rank: int, attempt: int) -> Dict[str, str]:
        env = dict(os.environ)
        extra = (self.env(rank, attempt) or {}) if callable(self.env) \
            else (self.env or {})
        # a None value means "unset" — Popen rejects non-str env values
        env.update({k: str(v) for k, v in extra.items() if v is not None})
        for k, v in extra.items():
            if v is None:
                env.pop(k, None)
        env.update({
            "PADDLE_GANG_RANK": str(rank),
            "PADDLE_GANG_WORLD_SIZE": str(self.nprocs),
            "PADDLE_GANG_STORE": self.store_dir,
            "PADDLE_GANG_ATTEMPT": str(attempt),
            "PADDLE_GANG_JOB": self.job_id,
        })
        return env

    def log_path(self, rank: int, attempt: int) -> str:
        return os.path.join(self.store_dir, "logs",
                            f"attempt{attempt:02d}-rank{rank:02d}.log")

    def _spawn(self, rank: int, attempt: int) -> subprocess.Popen:
        log = open(self.log_path(rank, attempt), "wb")
        try:
            return subprocess.Popen(
                self._argv_for(rank), env=self._env_for(rank, attempt),
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
        finally:
            log.close()  # the child holds its own fd

    @staticmethod
    def _terminate(procs: Dict[int, subprocess.Popen], grace: float):
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + grace
        for p in procs.values():
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.02)
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
                try:
                    p.wait(timeout=max(grace, 10.0))
                except subprocess.TimeoutExpired:
                    pass  # unkillable (uninterruptible I/O): not reaped

    # -- the recovery loop ---------------------------------------------
    def run(self, timeout: Optional[float] = None) -> GangResult:
        """Supervise until the whole gang exits 0, restarts are
        exhausted, or `timeout` (whole run, seconds) expires. Never
        raises on worker failure — inspect `GangResult.success` (and
        the per-attempt logs under ``{store_dir}/logs/``)."""
        from ...observability import record_event

        t_start = time.monotonic()
        deadline = t_start + timeout if timeout else None
        restarts: List[tuple] = []
        recovery_wall = 0.0
        t_detect = None  # of the failure that triggered this relaunch
        attempt = 0
        while True:
            procs = {r: self._spawn(r, attempt)
                     for r in range(self.nprocs)}
            if t_detect is not None:
                # death detected -> replacement gang fully respawned
                recovery_wall += time.monotonic() - t_detect
                t_detect = None
            failed_rank = None
            failed_code = 0
            while True:
                codes = {r: p.poll() for r, p in procs.items()}
                bad = {r: c for r, c in codes.items()
                       if c is not None and c != 0}
                if bad:
                    failed_rank = min(bad)
                    failed_code = bad[failed_rank]
                    break
                if all(c == 0 for c in codes.values()):
                    return GangResult(
                        True, attempt + 1, self.nprocs,
                        [codes[r] for r in range(self.nprocs)],
                        restarts, time.monotonic() - t_start,
                        recovery_wall)
                if deadline is not None and time.monotonic() > deadline:
                    self._terminate(procs, self.terminate_grace_s)
                    return GangResult(
                        False, attempt + 1, self.nprocs,
                        [procs[r].poll() if procs[r].poll() is not None
                         else -1 for r in range(self.nprocs)],
                        restarts, time.monotonic() - t_start,
                        recovery_wall)
                time.sleep(self.poll_interval)
            # a worker died (host preemption = -SIGKILL) or errored
            # (e.g. a survivor's BarrierTimeout): whole-gang restart
            t_detect = time.monotonic()
            self._terminate(procs, self.terminate_grace_s)
            if attempt >= self.max_restarts:
                return GangResult(
                    False, attempt + 1, self.nprocs,
                    [procs[r].poll() for r in range(self.nprocs)],
                    restarts, time.monotonic() - t_start, recovery_wall)
            for r in range(self.nprocs):
                restarts.append((r, attempt, procs[r].poll()))
                record_event("gang.worker_restart", rank=r,
                             attempt=attempt + 1,
                             prev_exit=procs[r].poll(),
                             failed_rank=failed_rank,
                             failed_exit=failed_code)
            attempt += 1


def _main(argv: List[str]) -> int:
    """``python -m paddle_tpu_torch.parallel.launch.gang -n N [--store
    DIR] [--max-restarts R] [--timeout S] -- CMD ...`` — supervise CMD
    as an N-worker gang."""
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.parallel.launch.gang")
    ap.add_argument("-n", "--nprocs", type=int, required=True)
    ap.add_argument("--store", default=None)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=None,
                    help="whole-run deadline in seconds")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("worker command required after --")
    store = args.store or tempfile.mkdtemp(prefix="ptpu-gang-")
    res = GangSupervisor(cmd, args.nprocs, store_dir=store,
                         max_restarts=args.max_restarts).run(
                             timeout=args.timeout)
    print(res.as_dict())
    return 0 if res.success else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(_main(sys.argv[1:]))
