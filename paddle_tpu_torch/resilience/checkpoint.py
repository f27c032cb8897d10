"""Atomic, digest-verified, generation-counted checkpointing (counterpart
of paddle_tpu/resilience/checkpoint.py; the same on-disk format, so a
generation written by either package restores in the other).

A preempted worker must leave either the *previous* valid checkpoint or
the *new* valid checkpoint on disk — never a torn one — and a restore
must detect silent corruption instead of loading garbage into the
model.

Layout (one directory per checkpoint *generation*)::

    ckpt_dir/
      gen-00000012/
        manifest.json          # tree skeleton, shapes, dtypes, digests
        shard-00000.bin        # one raw-bytes shard per tensor leaf
        shard-00001.bin
      gen-00000013/ ...

Invariants:

- a generation directory appears only via ``os.replace`` of a finished
  staging dir — readers never observe a partial checkpoint;
- the generation counter is monotonic (scan + in-process watermark), so
  "latest" is a lexicographic max, no clock involved;
- every shard's digest (crc32 default, sha256 opt-in) is verified on
  restore; a corrupt generation is skipped and restore falls back to
  the newest older generation that verifies;
- ``save(..., blocking=False)`` snapshots every tensor leaf into a fresh
  host copy immediately (``t.detach().to("cpu", copy=True)``: on the
  card the device-to-host copy is the only part the train step waits
  for, and on the CPU a leaf the optimizer updates in place would
  otherwise be written with a later step's values) and writes/commits
  on a background thread; ``wait()``/``flush()`` is the barrier, and
  write errors surface there, not in the step loop;
- shards are digested, written and read on up to 4 threads (one by one
  while a chaos schedule is armed, so a seeded schedule is repeatable).

Tensor leaves may be torch tensors (any device) or numpy arrays; their
bytes go to disk raw and the manifest names the dtype as numpy does
("float32", "int64", "bfloat16"), so bf16 needs no ``ml_dtypes``.
Python scalars/strings ride inline in the manifest, so optimizer
state_dicts (nested dicts with ints and LR scheduler floats) round-trip
unchanged. Restored tensor leaves come back as CPU torch tensors (the
JAX package returns numpy arrays) — what ``nn.Module.load_state_dict``
and ``Optimizer.set_state_dict`` accept.

Saving while a CUDA graph is being captured raises `CheckpointError`:
a save must run on the host at a step boundary, never inside a captured
program.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import warnings
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kernels import _build
from . import chaos

_GEN_PREFIX = "gen-"
_GEN_WIDTH = 8
_MANIFEST = "manifest.json"
_FORMAT = 1

# torch dtype <-> the numpy name the manifest records
_DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


class CheckpointError(RuntimeError):
    pass


class CheckpointCorruptError(CheckpointError):
    """A generation failed digest/shape/manifest verification."""


class CheckpointNotFoundError(CheckpointError, FileNotFoundError):
    """No generation in the directory survived verification."""


@dataclass
class Checkpoint:
    """What `restore()` returns: the pytree plus its provenance."""

    value: Any
    generation: int
    step: Optional[int]
    meta: dict = field(default_factory=dict)
    path: str = ""


# ---------------------------------------------------------------------------
# pytree <-> (skeleton, tensor shards)
# ---------------------------------------------------------------------------

def _under_capture() -> bool:
    return torch.cuda.is_initialized() \
        and torch.cuda.is_current_stream_capturing()


def _to_host(x, path: str, copy: bool) -> torch.Tensor:
    """Leaf -> contiguous CPU tensor (this is where an async save
    synchronises). `copy` makes it a fresh host copy even where the leaf
    already lives on the host."""
    if _under_capture():
        raise CheckpointError(
            f"checkpoint leaf {path!r} saved while a CUDA graph capture "
            "is recording: checkpoint saves must run on the host at step "
            "boundaries, never inside a captured program")
    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.array(x, copy=copy) if copy else np.asarray(x)
        if arr.dtype.name not in _DTYPES:
            raise TypeError(f"cannot checkpoint numpy dtype {arr.dtype} "
                            f"at {path!r}")
        return torch.from_numpy(np.ascontiguousarray(arr))
    if x.dtype not in _DTYPE_NAMES:
        raise TypeError(f"cannot checkpoint dtype {x.dtype} at {path!r}")
    return x.detach().to("cpu", copy=copy).contiguous()


def _flatten(obj, path: str, tensors: List[torch.Tensor],
             copy: bool) -> Any:
    """obj -> JSON skeleton; tensor leaves appended to `tensors` (host
    tensors) and referenced by index."""
    if isinstance(obj, dict):
        items = []
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(
                    f"checkpoint dict keys must be str, got {k!r} "
                    f"at {path!r}")
            items.append([k, _flatten(v, f"{path}/{k}", tensors, copy)])
        return {"kind": "dict", "items": items}
    if isinstance(obj, (list, tuple)):
        return {"kind": "tuple" if isinstance(obj, tuple) else "list",
                "items": [_flatten(v, f"{path}[{i}]", tensors, copy)
                          for i, v in enumerate(obj)]}
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        tensors.append(_to_host(obj, path, copy))
        return {"kind": "tensor", "id": len(tensors) - 1, "key": path}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"kind": "value", "value": obj}
    raise TypeError(
        f"cannot checkpoint leaf of type {type(obj).__name__} at "
        f"{path!r}; supported: torch tensors, numpy arrays, "
        "int/float/bool/str/None, dict/list/tuple")


def _unflatten(skel, tensors: Dict[int, torch.Tensor]):
    kind = skel["kind"]
    if kind == "dict":
        return {k: _unflatten(v, tensors) for k, v in skel["items"]}
    if kind == "list":
        return [_unflatten(v, tensors) for v in skel["items"]]
    if kind == "tuple":
        return tuple(_unflatten(v, tensors) for v in skel["items"])
    if kind == "tensor":
        return tensors[skel["id"]]
    if kind == "value":
        return skel["value"]
    raise CheckpointCorruptError(f"unknown skeleton node kind {kind!r}")


def _raw(t: torch.Tensor) -> np.ndarray:
    """A contiguous CPU tensor's bytes as a uint8 numpy view (no copy)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _from_raw(buf: bytearray, dtype_name: str, shape) -> torch.Tensor:
    dtype = _DTYPES.get(dtype_name)
    if dtype is None:
        raise CheckpointCorruptError(f"unknown dtype {dtype_name!r}")
    if not buf:
        return torch.empty(shape, dtype=dtype)
    # frombuffer over the writable bytearray shares its memory: the
    # restored tensor owns the shard's bytes, read once
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(
        shape)


def _map_shards(fn, *iterables) -> list:
    """[fn(*args)] over the shards, in order. Digests (zlib and hashlib
    release the GIL) and file I/O run on up to 4 threads, at most half
    the cores (a background save shares them with the train loop's
    launches); with a chaos schedule armed the shards go one by one, so
    a seeded fault schedule meets them in a fixed order. The first
    shard's error in order is raised."""
    work = list(zip(*iterables))
    n = min(4, (os.cpu_count() or 1) // 2, len(work))
    if n <= 1 or chaos.get_chaos() is not None:
        return [fn(*a) for a in work]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(n, thread_name_prefix="ckpt-io") as pool:
        return list(pool.map(lambda a: fn(*a), work))


def _digest(algo: str, data) -> str:
    if algo == "crc32":
        return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"
    if algo == "sha256":
        return f"sha256:{hashlib.sha256(data).hexdigest()}"
    raise ValueError(f"unknown digest algo {algo!r} (crc32|sha256)")


def _verify_digest(stored: str, data) -> bool:
    algo = stored.split(":", 1)[0]
    return _digest(algo, data) == stored


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Save/restore generations under one directory.

    ::

        mgr = CheckpointManager("/ckpt/run7", max_to_keep=3)
        mgr.save(state, step=120)                  # blocking
        mgr.save(state, step=140, blocking=False)  # background write
        ...
        mgr.wait()                                 # barrier + error surface
        ck = mgr.restore()                         # newest VALID generation
        ck.value, ck.step, ck.generation

    With a tracer armed (`observability`), the background write records
    a ``ckpt.write`` span on the writer thread.
    """

    def __new__(cls, *args, **kwargs):
        # gang mode: `CheckpointManager(dir, coordinator=c)` builds the
        # multi-host manager — per-host shard dirs, two-phase barrier
        # commit, restore through generation agreement. The
        # coordinator-less path below is the single-writer manager.
        if cls is CheckpointManager \
                and kwargs.get("coordinator") is not None:
            from .coordination import GangCheckpointManager

            return object.__new__(GangCheckpointManager)
        return object.__new__(cls)

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = None,
                 digest: str = "crc32", coordinator=None):
        assert coordinator is None  # handled by __new__ dispatch
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        self.digest = digest
        _digest(digest, b"")  # validate algo now, not mid-save
        self._lock = threading.Lock()
        self._last_issued = 0
        self._pending: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        os.makedirs(self.directory, exist_ok=True)
        self._clean_stale_staging()

    # -- inventory -----------------------------------------------------
    def generations(self) -> List[int]:
        """Committed generation numbers, ascending."""
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        for n in names:
            if n.startswith(_GEN_PREFIX):
                try:
                    g = int(n[len(_GEN_PREFIX):])
                except ValueError:
                    continue
                if os.path.exists(os.path.join(self.directory, n,
                                               _MANIFEST)):
                    out.append(g)
        return sorted(out)

    def latest_generation(self) -> Optional[int]:
        gens = self.generations()
        return gens[-1] if gens else None

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.directory,
                            f"{_GEN_PREFIX}{gen:0{_GEN_WIDTH}d}")

    def _next_generation(self) -> int:
        with self._lock:
            gens = self.generations()
            nxt = max(self._last_issued, gens[-1] if gens else 0) + 1
            self._last_issued = nxt
            return nxt

    # -- save ----------------------------------------------------------
    def save(self, value, step: Optional[int] = None,
             meta: Optional[dict] = None, *, blocking: bool = True) -> int:
        """Write `value` as a new generation; returns its number.

        blocking=False snapshots every tensor into a fresh host copy NOW
        and commits on a background thread; call `wait()` (or the next
        save/restore, which waits implicitly) to surface write errors."""
        if _build.tracing():
            # an analysis trace of a program (torch.fx on fake tensors):
            # leave the host-call node lint rule TPU601 reports, write
            # nothing
            _build.mark_host_call("resilience.checkpoint.save")
            return -1
        self.wait()  # one in-flight async save; surfaces prior errors
        tensors: List[torch.Tensor] = []
        # the SNAPSHOT: a CPU leaf's .cpu() aliases the live storage,
        # which a train step mutates in place, so an async save copies
        # every leaf (a CUDA leaf's device-to-host copy is the copy)
        skeleton = _flatten(value, "", tensors, copy=not blocking)
        gen = self._issue_generation()
        if blocking:
            self._commit_generation(gen, skeleton, tensors, step, meta)
            return gen

        def writer():
            try:
                self._commit_generation(gen, skeleton, tensors, step,
                                        meta)
            except BaseException as e:
                self._async_error = e

        t = threading.Thread(target=writer, daemon=True,
                             name=f"ckpt-save:{gen}")
        self._pending = t
        t.start()
        return gen

    # the two seams gang mode overrides (coordination.py): generation
    # numbering from the shared group history, and commit promoted to
    # the two-phase barrier protocol — the save() scaffolding above
    # (wait/flatten/snapshot/async writer) exists exactly once
    def _issue_generation(self) -> int:
        return self._next_generation()

    def _commit_generation(self, gen, skeleton, tensors, step, meta):
        self._write_generation(gen, skeleton, tensors, step, meta)

    def wait(self):
        """Barrier for an in-flight async save; re-raises its error."""
        t, self._pending = self._pending, None
        if t is not None:
            t.join()
        err, self._async_error = self._async_error, None
        if err is not None:
            raise err

    flush = wait

    def _write_generation(self, gen: int, skeleton, tensors, step, meta):
        from ..observability import trace as obs_trace
        from .retry import default_io_policy

        tr = obs_trace.get_tracer()
        t0 = time.perf_counter_ns()
        final = self._gen_path(gen)
        staging = os.path.join(
            self.directory,
            f".tmp-{gen:0{_GEN_WIDTH}d}-{os.getpid()}-{threading.get_ident()}")
        retry = default_io_policy()
        os.makedirs(staging, exist_ok=True)
        try:
            def write_one(i, t):
                fname = f"shard-{i:05d}.bin"
                data = memoryview(_raw(t))
                # digest BEFORE the chaos corruption seam: the injected
                # bit-flip models on-disk/in-flight corruption, which
                # restore()'s digest verification must catch
                digest = _digest(self.digest, data)
                data = chaos.corrupt("ckpt.write", data)
                retry.call(self._write_shard,
                           os.path.join(staging, fname), data)
                return {"id": i, "file": fname, "shape": list(t.shape),
                        "dtype": _DTYPE_NAMES[t.dtype], "nbytes": len(data),
                        "digest": digest}

            entries = _map_shards(write_one, range(len(tensors)), tensors)
            manifest = {"format": _FORMAT, "generation": gen,
                        "step": step, "meta": meta or {},
                        "tree": skeleton, "tensors": entries}
            mpath = os.path.join(staging, _MANIFEST)
            with open(mpath, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            # the commit point: a crash before this line leaves only a
            # .tmp dir (ignored by restore); after it, a complete,
            # verified generation
            os.replace(staging, final)
            self._fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        if tr is not None:
            tr.complete("ckpt.write", t0, time.perf_counter_ns(),
                        generation=gen,
                        nbytes=sum(e["nbytes"] for e in entries))
        self._gc()

    @staticmethod
    def _write_shard(path: str, data):
        chaos.maybe_io_error("ckpt.write")
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    @staticmethod
    def _read_shard(path: str) -> bytearray:
        chaos.maybe_io_error("ckpt.read")
        with open(path, "rb") as f:
            buf = bytearray(os.fstat(f.fileno()).st_size)
            n = f.readinto(buf)
        return buf if n == len(buf) else buf[:n]

    @staticmethod
    def _fsync_dir(path: str):
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:  # not supported on this fs — best effort
            pass

    def _gc(self):
        if self.max_to_keep is None:
            return
        gens = self.generations()
        for g in gens[:-self.max_to_keep]:
            shutil.rmtree(self._gen_path(g), ignore_errors=True)

    def _clean_stale_staging(self):
        """Reclaim `.tmp-*` staging dirs left by a hard-killed writer
        (SIGKILL after the preemption grace window lands mid-write,
        skipping the in-process cleanup). The dir name embeds the
        writer's pid; only dirs whose pid is DEAD are removed — a live
        concurrent writer keeps its staging."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for n in names:
            if not n.startswith(".tmp-"):
                continue
            parts = n.split("-")
            try:
                pid = int(parts[2])
            except (IndexError, ValueError):
                continue
            if pid == os.getpid():
                continue  # our own (possibly in-flight async) staging
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                shutil.rmtree(os.path.join(self.directory, n),
                              ignore_errors=True)
            except OSError:
                continue  # alive but not ours (EPERM) — leave it

    # -- restore -------------------------------------------------------
    def restore(self, generation: Optional[int] = None, *,
                verify: bool = True) -> Checkpoint:
        """Load the newest generation that verifies (or exactly
        `generation`, no fallback). Corrupt generations are warned
        about and skipped — restoring stale-but-valid state beats
        loading garbage."""
        self.wait()
        if generation is not None:
            return self._load_generation(generation, verify)
        gens = self.generations()
        if not gens:
            raise CheckpointNotFoundError(
                f"no checkpoint generations under {self.directory!r}")
        errors = []
        for g in reversed(gens):
            try:
                return self._load_generation(g, verify)
            except CheckpointCorruptError as e:
                errors.append(str(e))
                warnings.warn(
                    f"checkpoint generation {g} failed verification "
                    f"({e}); falling back to the previous generation",
                    RuntimeWarning)
        raise CheckpointNotFoundError(
            f"every generation under {self.directory!r} failed "
            f"verification: {errors}")

    def verify_generation(self, generation: int) -> bool:
        """True when `generation` exists and every shard passes digest +
        shape verification. Reads the shards (restore-path cost) — meant
        for restore-time agreement across hosts, not for hot loops."""
        try:
            self._load_generation(generation, True)
            return True
        except CheckpointError:
            return False

    def _load_generation(self, gen: int, verify: bool) -> Checkpoint:
        path = self._gen_path(gen)
        mpath = os.path.join(path, _MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise CheckpointNotFoundError(
                f"generation {gen} not found under {self.directory!r}")
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointCorruptError(
                f"generation {gen}: unreadable manifest ({e})")
        if manifest.get("format") != _FORMAT:
            raise CheckpointCorruptError(
                f"generation {gen}: unknown format "
                f"{manifest.get('format')!r}")
        from .retry import default_io_policy

        retry = default_io_policy()
        def load_one(entry):
            spath = os.path.join(path, entry["file"])
            try:
                # transient read flakes are retried; only a PERSISTENT
                # failure condemns the generation and triggers fallback
                data = retry.call(self._read_shard, spath)
            except OSError as e:
                raise CheckpointCorruptError(
                    f"generation {gen}: shard {entry['file']} "
                    f"unreadable after {retry.max_attempts} attempts "
                    f"({e})")
            if len(data) != entry["nbytes"]:
                raise CheckpointCorruptError(
                    f"generation {gen}: shard {entry['file']} is "
                    f"{len(data)} bytes, manifest says {entry['nbytes']}")
            if verify and not _verify_digest(entry["digest"], data):
                raise CheckpointCorruptError(
                    f"generation {gen}: shard {entry['file']} digest "
                    f"mismatch (expected {entry['digest']})")
            try:
                return _from_raw(data, entry["dtype"], entry["shape"])
            except RuntimeError as e:  # bytes do not fit dtype x shape
                raise CheckpointCorruptError(
                    f"generation {gen}: shard {entry['file']} ({e})")

        entries = manifest["tensors"]
        tensors = dict(zip((e["id"] for e in entries),
                           _map_shards(load_one, entries)))
        value = _unflatten(manifest["tree"], tensors)
        return Checkpoint(value=value, generation=gen,
                          step=manifest.get("step"),
                          meta=manifest.get("meta") or {}, path=path)


# ---------------------------------------------------------------------------
# convenience functions
# ---------------------------------------------------------------------------

def save_checkpoint(directory: str, value, step: Optional[int] = None,
                    **kwargs) -> int:
    """One-shot `CheckpointManager(directory).save(...)`."""
    mgr_kw = {k: kwargs.pop(k) for k in ("max_to_keep", "digest")
              if k in kwargs}
    return CheckpointManager(directory, **mgr_kw).save(value, step=step,
                                                       **kwargs)


def restore_checkpoint(directory: str,
                       generation: Optional[int] = None,
                       **kwargs) -> Checkpoint:
    """One-shot `CheckpointManager(directory).restore(...)`."""
    mgr_kw = {k: kwargs.pop(k) for k in ("max_to_keep", "digest")
              if k in kwargs}
    return CheckpointManager(directory, **mgr_kw).restore(
        generation, **kwargs)
