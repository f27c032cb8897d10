"""Multi-host gang coordination: store-backed barriers, generation
agreement, and the gang checkpoint protocol (counterpart of
paddle_tpu/resilience/coordination.py).

A preempted worker of a multi-host gang must never deadlock its peers
or silently resume from a different checkpoint generation. Everything
here is host code over a key-value store: it runs the same on the CPU
(subprocess gangs in the tests) and beside the card.

Three layers, bottom-up:

- `Barrier(store, world_size, ...)` — a named rendezvous point over any
  pluggable KV store (`resilience.store.DictStore` in-process,
  `FileStore` across processes; the same implementations the decode
  fleet's leases ride on). A missing peer raises a
  structured `BarrierTimeout` that names WHO is missing and when each
  missing rank was last seen — never a silent hang.
- `Coordinator(store, rank, world_size)` — rank registration /
  rendezvous plus attempt-scoped key namespacing: every relaunch
  attempt gets a fresh namespace, so arrivals from a previous
  incarnation of the gang can never satisfy (or poison) this one's
  barriers. `from_env()` builds one from the `PADDLE_GANG_*`
  environment the gang supervisor (`parallel/launch/gang.py`) exports.
- `GangCheckpointManager` — `CheckpointManager(dir, coordinator=c)`
  resolves here. Per-host shard directories, commit promoted to a
  two-phase protocol, restore routed through
  `agree_restore_generation()` (each host publishes its newest
  *digest-verified* generation; all adopt the group **min**), and
  coordinated GC that never deletes the agreed restore floor.

Gang commit (generation g)::

    every rank                         rank 0 only
    ----------                         -----------
    stage: write host-{rank}/gen-g
      (atomic local os.replace)
            \\                         /
             barrier "ckpt/g/staged"        <- all staged, gens match
                                       write group/gen-g.json (atomic)
             barrier "ckpt/g/committed"     <- g is now VISIBLE
            /                         \\
    coordinated GC (keep window + agreed floor)

A crash before the group manifest lands leaves only invisible per-host
generations — restore falls back to the previous group generation on
every host, atomically for the whole gang.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional

from ..observability import record_event
from .checkpoint import (CheckpointError, CheckpointManager,
                         CheckpointNotFoundError, _GEN_PREFIX, _GEN_WIDTH)
from .store import DictStore, FileStore  # noqa: F401  (re-export)

__all__ = [
    "Barrier", "BarrierTimeout", "Coordinator", "GangCheckpointManager",
    "agree_restore_generation", "from_env",
]

_GROUP_FORMAT = 1


def _default_timeout() -> float:
    from ..framework.flags import flag

    return float(flag("barrier_timeout_s"))


class BarrierTimeout(RuntimeError):
    """A gang barrier expired: some rank never arrived.

    Structured so supervisors/operators see WHO is stuck, not just that
    something is: `missing` (sorted ranks that never arrived), `arrived`
    (ranks that did), `last_seen` ({missing rank: seconds since its
    last rendezvous heartbeat, or None if never seen}), `name`,
    `timeout_s`, `world_size`.
    """

    def __init__(self, name: str, world_size: int, missing: List[int],
                 arrived: List[int], last_seen: Dict[int, Optional[float]],
                 timeout_s: float):
        self.name = name
        self.world_size = world_size
        self.missing = list(missing)
        self.arrived = list(arrived)
        self.last_seen = dict(last_seen)
        self.timeout_s = timeout_s
        seen = ", ".join(
            f"{r}: " + (f"{ago:.1f}s ago" if ago is not None else "never")
            for r, ago in sorted(self.last_seen.items()))
        super().__init__(
            f"barrier {name!r} timed out after {timeout_s:.1f}s: "
            f"missing rank(s) {self.missing} of world_size {world_size} "
            f"(arrived: {self.arrived}; last seen: {{{seen}}})")


class Barrier:
    """A named all-arrive rendezvous over a pluggable KV store.

    Each rank `wait()`s by publishing an arrival key (optionally
    carrying a value — the gang checkpoint protocol rides generation
    numbers on these) and polling until `world_size` ranks are present.
    Returns {rank: value} of every arrival. On deadline, raises
    `BarrierTimeout` naming the missing ranks. Barrier names must be
    unique per logical rendezvous (the `Coordinator` namespaces them by
    job/attempt and a per-name use counter).
    """

    def __init__(self, store, world_size: int, *, name: str = "barrier",
                 timeout: Optional[float] = None,
                 poll_interval: float = 0.02,
                 last_seen_fn: Optional[Callable[[], Dict[int, float]]]
                 = None):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        self.store = store
        self.world_size = world_size
        self.name = name
        self.timeout = _default_timeout() if timeout is None else timeout
        self.poll_interval = poll_interval
        self._last_seen_fn = last_seen_fn

    def _arrivals(self) -> Dict[int, str]:
        got = self.store.prefix(self.name + "/")
        out = {}
        for k, v in got.items():
            try:
                out[int(k.rsplit("/", 1)[1])] = v
            except ValueError:
                continue
        return out

    def wait(self, rank: int, value: str = "1",
             timeout: Optional[float] = None) -> Dict[int, str]:
        timeout = self.timeout if timeout is None else timeout
        t0 = time.monotonic()
        self.store.put(f"{self.name}/{rank}", value)
        while True:
            arrived = self._arrivals()
            if len(arrived) >= self.world_size:
                record_event("barrier.wait", barrier=self.name,
                             wait_s=round(time.monotonic() - t0, 4))
                return arrived
            if time.monotonic() - t0 > timeout:
                missing = sorted(set(range(self.world_size))
                                 - set(arrived))
                seen = self._last_seen_fn() if self._last_seen_fn \
                    else {}
                now = time.time()
                last = {r: (now - seen[r] if r in seen else None)
                        for r in missing}
                record_event("barrier.timeout", barrier=self.name,
                             missing=str(missing),
                             timeout_s=timeout)
                raise BarrierTimeout(self.name, self.world_size,
                                     missing, sorted(arrived), last,
                                     timeout)
            time.sleep(self.poll_interval)


class Coordinator:
    """Rank registration + namespaced barriers for ONE gang attempt.

    Keys live under ``/paddle_tpu/gang/{job_id}/a{attempt}/`` — a
    relaunched gang (new attempt) starts in a fresh namespace, so a
    dead incarnation's barrier arrivals can never complete (or corrupt)
    the new one's. Registration publishes a rendezvous heartbeat
    (refreshed on every barrier entry) that `BarrierTimeout.last_seen`
    reports for missing ranks.

    Barriers are lockstep: every rank must issue the same coordinated
    operations in the same order (the SPMD discipline the gang
    checkpoint protocol already imposes); a per-name use counter makes
    repeated waits on the same logical name distinct rendezvous points.
    """

    def __init__(self, store, rank: int, world_size: int, *,
                 job_id: str = "default", attempt: int = 0,
                 timeout: Optional[float] = None,
                 poll_interval: float = 0.02):
        if not 0 <= rank < world_size:
            raise ValueError(
                f"rank {rank} outside [0, world_size={world_size})")
        self.store = store
        self.rank = rank
        self.world_size = world_size
        self.job_id = job_id
        self.attempt = int(attempt)
        self.timeout = _default_timeout() if timeout is None else timeout
        self.poll_interval = poll_interval
        self._prefix = f"/paddle_tpu/gang/{job_id}/a{self.attempt}/"
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        # barrier-wait telemetry
        self.barrier_wait_s = 0.0
        self.n_barriers = 0
        self.register()

    # -- rendezvous ----------------------------------------------------
    def register(self):
        """Publish this rank's rendezvous heartbeat."""
        self.store.put(self._prefix + f"rendezvous/{self.rank}",
                       json.dumps({"ts": time.time(),
                                   "pid": os.getpid()}))
        return self

    def peers(self) -> Dict[int, dict]:
        """{rank: {ts, pid}} of every registered rank (this attempt)."""
        pre = self._prefix + "rendezvous/"
        out = {}
        for k, v in self.store.prefix(pre).items():
            try:
                out[int(k[len(pre):])] = json.loads(v)
            except (ValueError, TypeError):
                continue
        return out

    def _last_seen(self) -> Dict[int, float]:
        return {r: info.get("ts", 0.0) for r, info in self.peers().items()}

    # -- namespaced KV -------------------------------------------------
    def put(self, key: str, value: str):
        self.store.put(self._prefix + key, value)

    def get(self, key: str) -> Optional[str]:
        return self.store.get(self._prefix + key)

    # -- barriers ------------------------------------------------------
    def barrier(self, name: str, timeout: Optional[float] = None,
                value: str = "1") -> Dict[int, str]:
        """All-arrive rendezvous at `name`; returns {rank: value}."""
        with self._lock:
            seq = self._counts.get(name, 0)
            self._counts[name] = seq + 1
        self.register()  # refresh the heartbeat peers report on timeout
        b = Barrier(self.store, self.world_size,
                    name=f"{self._prefix}barrier/{name}/{seq}",
                    timeout=self.timeout if timeout is None else timeout,
                    poll_interval=self.poll_interval,
                    last_seen_fn=self._last_seen)
        t0 = time.monotonic()
        try:
            return b.wait(self.rank, value)
        finally:
            self.barrier_wait_s += time.monotonic() - t0
            self.n_barriers += 1


def from_env(store=None) -> Optional[Coordinator]:
    """Build a Coordinator from the `PADDLE_GANG_*` environment the gang
    supervisor exports (rank, world size, FileStore directory, attempt,
    job id). Returns None outside a gang (PADDLE_GANG_RANK unset), so
    worker scripts can say ``fit(coordinator=from_env())``
    unconditionally."""
    rank = os.environ.get("PADDLE_GANG_RANK")
    if rank is None or not rank.strip():
        return None
    world = int(os.environ.get("PADDLE_GANG_WORLD_SIZE", "1"))
    if store is None:
        root = os.environ.get("PADDLE_GANG_STORE")
        if not root:
            raise ValueError(
                "PADDLE_GANG_RANK is set but PADDLE_GANG_STORE is not — "
                "a subprocess gang needs a FileStore directory to "
                "rendezvous through")
        store = FileStore(root)
    return Coordinator(
        store, int(rank), world,
        job_id=os.environ.get("PADDLE_GANG_JOB", "default"),
        attempt=int(os.environ.get("PADDLE_GANG_ATTEMPT", "0")))


# ---------------------------------------------------------------------------
# gang checkpoint manager
# ---------------------------------------------------------------------------

class GangCheckpointManager(CheckpointManager):
    """Coordinated multi-host checkpointing (`CheckpointManager(dir,
    coordinator=c)` resolves here).

    Layout (one shared directory, e.g. blob storage)::

        ckpt_dir/
          host-00000/gen-00000012/   # this host's shards — a full
          host-00001/gen-00000012/   #   single-host manager layout
          group/gen-00000012.json    # rank-0 group manifest = the
                                     #   gang-wide commit point

    - `save()` is the two-phase protocol (module docstring): a
      generation is VISIBLE only once every host staged it and rank 0
      committed the group manifest; `blocking=False` runs the stage +
      barriers on the background writer thread and surfaces
      `BarrierTimeout` at `wait()` like any other async save error.
    - `restore()` routes through `agree_restore_generation()`: each
      host publishes its newest digest-VERIFIED group generation and
      all adopt the min — a host whose newest copy is corrupt drags the
      whole gang back to the newest generation everyone can verify.
    - GC is coordinated: it runs only after a commit barrier (so every
      peer provably holds the new generation) and never deletes the
      agreed restore floor of this process's lifetime.
    - `world_size=1` with a coordinator exercises the same layout with
      degenerate barriers; NO coordinator is the unchanged single-
      writer manager.
    """

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = None,
                 digest: str = "crc32", coordinator: Coordinator = None):
        if coordinator is None:
            raise ValueError("GangCheckpointManager needs a coordinator; "
                             "use CheckpointManager(dir) for single-host")
        self.coord = coordinator
        self.root = str(directory)
        self.group_dir = os.path.join(self.root, "group")
        os.makedirs(self.group_dir, exist_ok=True)
        self._restore_floor: Optional[int] = None
        self._barrier_timeout: Optional[float] = None  # per-save stash
        self._agreed_ck = None  # verified load kept across agreement
        # the inherited machinery (stage/commit/load/async bookkeeping)
        # operates on THIS HOST's shard directory
        super().__init__(
            os.path.join(self.root,
                         f"host-{coordinator.rank:05d}"),
            max_to_keep=max_to_keep, digest=digest)

    # -- inventory -----------------------------------------------------
    def generations(self) -> List[int]:
        """GROUP-committed generations (ascending) — the only ones a
        restore may target. Per-host staged generations without a group
        manifest are invisible."""
        out = []
        try:
            names = os.listdir(self.group_dir)
        except FileNotFoundError:
            return []
        for n in names:
            if n.startswith(_GEN_PREFIX) and n.endswith(".json"):
                try:
                    out.append(int(n[len(_GEN_PREFIX):-len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def local_generations(self) -> List[int]:
        """This host's staged generations (committed or not group-wide)."""
        return CheckpointManager.generations(self)

    def group_manifest(self, gen: int) -> dict:
        with open(self._group_path(gen)) as f:
            return json.load(f)

    def _group_path(self, gen: int) -> str:
        return os.path.join(self.group_dir,
                            f"{_GEN_PREFIX}{gen:0{_GEN_WIDTH}d}.json")

    def _next_group_generation(self) -> int:
        # group manifests are the SHARED truth every rank derives the
        # next number from — a stale per-host staged gen (crashed gang
        # save) must not skew one rank's numbering away from its peers'
        with self._lock:
            group = self.generations()
            nxt = max(self._last_issued, group[-1] if group else 0) + 1
            self._last_issued = nxt
            return nxt

    # -- save: two-phase gang commit -----------------------------------
    def save(self, value, step: Optional[int] = None,
             meta: Optional[dict] = None, *, blocking: bool = True,
             barrier_timeout: Optional[float] = None) -> int:
        """Stage on every host, barrier, rank-0 group manifest, barrier,
        visible. `blocking=False` snapshots tensors now and runs the
        whole protocol (barriers included) on the background writer;
        a peer death surfaces as `BarrierTimeout` at `wait()`. The
        scaffolding (flatten, snapshot copy, async bookkeeping) is the
        base manager's — gang mode overrides only the generation
        numbering and the commit seam below."""
        # join any in-flight writer BEFORE stashing this save's barrier
        # timeout: the previous background commit reads the field
        self.wait()
        self._barrier_timeout = barrier_timeout
        return super().save(value, step=step, meta=meta,
                            blocking=blocking)

    def _issue_generation(self) -> int:
        return self._next_group_generation()

    def _commit_generation(self, gen, skeleton, tensors, step, meta):
        self._gang_write(gen, skeleton, tensors, step, meta,
                         self._barrier_timeout)

    def _gang_write(self, gen, skeleton, tensors, step, meta,
                    barrier_timeout):
        # reclaim stale LOCAL generations >= gen: staged by an earlier
        # gang save that never group-committed (invisible to restore);
        # os.replace cannot land a staging dir on a non-empty target
        for g in self.local_generations():
            if g >= gen:
                shutil.rmtree(self._gen_path(g), ignore_errors=True)
        # phase 1: stage this host's shards (atomic local commit)
        self._write_generation(gen, skeleton, tensors, step, meta)
        arrivals = self.coord.barrier(f"ckpt/{gen}/staged",
                                      timeout=barrier_timeout,
                                      value=str(gen))
        mismatched = {r: v for r, v in arrivals.items() if v != str(gen)}
        if mismatched:
            raise CheckpointError(
                f"gang checkpoint generation disagreement: this host "
                f"staged gen {gen} but peers staged {mismatched} — the "
                f"group manifests under {self.group_dir!r} have "
                f"diverged across hosts")
        # phase 2: rank 0 writes the group manifest — THE commit point
        if self.coord.rank == 0:
            self._write_group_manifest(gen, step, meta)
        self.coord.barrier(f"ckpt/{gen}/committed",
                           timeout=barrier_timeout)
        record_event("ckpt.gang_commit", generation=gen, step=step,
                     world_size=self.coord.world_size)
        self._gang_gc()

    def _write_group_manifest(self, gen, step, meta):
        manifest = {"format": _GROUP_FORMAT, "generation": gen,
                    "world_size": self.coord.world_size,
                    "job": self.coord.job_id, "step": step,
                    "meta": meta or {},
                    "hosts": [f"host-{r:05d}"
                              for r in range(self.coord.world_size)]}
        tmp = self._group_path(gen) + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._group_path(gen))
        self._fsync_dir(self.group_dir)

    def _gc(self):
        """No-op: the inherited `_write_generation` calls this BEFORE
        the commit barrier — deleting anything there could strand a
        peer that still needs to fall back. Gang GC is `_gang_gc`,
        which runs only after every host confirmed the new
        generation."""

    def _gang_gc(self):
        """Coordinated GC: keep the newest `max_to_keep` group
        generations PLUS the agreed restore floor (a generation the
        whole gang adopted this process lifetime — a peer may still
        fall back to it if everything newer rots). Runs strictly after
        a commit barrier, so every peer provably holds the generation
        that pushed the window."""
        if self.max_to_keep is None:
            return
        group = self.generations()
        keep = set(group[-self.max_to_keep:])
        if self._restore_floor is not None:
            keep.add(self._restore_floor)
        newest = group[-1] if group else -1
        for g in self.local_generations():
            # gens newer than the newest group manifest are a
            # concurrent in-flight stage — never touch them here
            if g in keep or g > newest:
                continue
            shutil.rmtree(self._gen_path(g), ignore_errors=True)
        if self.coord.rank == 0:
            for g in group:
                if g not in keep:
                    try:
                        os.unlink(self._group_path(g))
                    except OSError:
                        pass

    # -- restore: generation agreement ---------------------------------
    def agree_restore_generation(self,
                                 timeout: Optional[float] = None
                                 ) -> Optional[int]:
        """Each host publishes its newest digest-VERIFIED group
        generation; all adopt the group min (the newest state everyone
        can actually load). Returns None when NO host has any committed
        generation (a legitimately fresh gang). Raises
        `CheckpointNotFoundError` when some hosts have generations but
        another cannot verify any copy — restoring divergent state
        would be silent data corruption."""
        group = self.generations()
        mine = -1
        self._agreed_ck = None
        for g in reversed(group):
            try:
                # keep the verified load: when the gang adopts OUR
                # newest generation (the common healthy path), restore
                # returns this checkpoint instead of re-reading every
                # shard a second time
                self._agreed_ck = self._load_generation(g, True)
                mine = g
                break
            except CheckpointError:
                continue
        arrivals = self.coord.barrier("ckpt/agree", timeout=timeout,
                                      value=str(mine))
        gens = {r: int(v) for r, v in arrivals.items()}
        if all(v < 0 for v in gens.values()):
            return None
        missing = sorted(r for r, v in gens.items() if v < 0)
        if missing:
            raise CheckpointNotFoundError(
                f"gang restore: host rank(s) {missing} hold no "
                f"digest-verified copy of any group generation under "
                f"{self.root!r} (published per-host newest: {gens}); "
                f"refusing a divergent restore")
        agreed = min(gens.values())
        if self._agreed_ck is not None \
                and self._agreed_ck.generation != agreed:
            self._agreed_ck = None  # a peer dragged us further back
        self._restore_floor = agreed
        record_event("ckpt.agree_generation", generation=agreed,
                     per_host=json.dumps(gens))
        return agreed

    def restore(self, generation: Optional[int] = None, *,
                verify: bool = True,
                timeout: Optional[float] = None):
        """Load the gang-AGREED generation (or exactly `generation`,
        no agreement round). Unlike the single-host manager there is no
        silent newest-first fallback walk here: fallback is inside the
        agreement (each host publishes its newest generation that
        verifies), so every host lands on the SAME generation or the
        restore fails loudly."""
        self.wait()
        if generation is None:
            generation = self.agree_restore_generation(timeout=timeout)
            if generation is None:
                raise CheckpointNotFoundError(
                    f"no gang checkpoint generations under "
                    f"{self.root!r}")
            ck, self._agreed_ck = self._agreed_ck, None
            if ck is not None and ck.generation == generation:
                return ck  # already digest-verified during agreement
        return self._load_generation(generation, verify)


def agree_restore_generation(manager: GangCheckpointManager,
                             timeout: Optional[float] = None
                             ) -> Optional[int]:
    """Module-level convenience: `manager.agree_restore_generation()`."""
    return manager.agree_restore_generation(timeout=timeout)
