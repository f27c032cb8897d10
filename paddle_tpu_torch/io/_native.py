"""ctypes binding of the shared-memory ring (``native/shm_ring.cpp``).

g++ builds the ring at first use into
``paddle_tpu_torch/_build/shm_ring-<hash>.so``; the hash covers the source
and the compiler flags, so an edited source rebuilds and an unchanged one
is reused, and a file lock keeps two processes from building at once (the
scheme of ``kernels/_build.py``). The C ABI keeps the binding free of
pybind11. A ring that will not build or open raises with the compiler's
or the system's message: the loader has no thread fallback.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "shm_ring.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpthread", "-lrt")

_lock = threading.Lock()
_lib = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"shm_ring-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the ring if its library is stale; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _target()
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not target.exists():
                tmp = target.with_suffix(f".tmp{os.getpid()}.so")
                cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
                try:
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True, timeout=120)
                except OSError as e:
                    raise RuntimeError(
                        f"building the shared-memory ring failed: {e}") \
                        from e
                if proc.returncode:
                    raise RuntimeError(
                        "building the shared-memory ring failed "
                        f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def get_lib() -> ctypes.CDLL:
    """The loaded ring library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()), use_errno=True)
        lib.shm_ring_create.restype = ctypes.c_void_p
        lib.shm_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                        ctypes.c_uint32]
        lib.shm_ring_open.restype = ctypes.c_void_p
        lib.shm_ring_open.argtypes = [ctypes.c_char_p]
        lib.shm_ring_push.restype = ctypes.c_int
        lib.shm_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_int]
        lib.shm_ring_pop.restype = ctypes.c_int64
        lib.shm_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64, ctypes.c_int]
        lib.shm_ring_close.restype = None
        lib.shm_ring_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.shm_ring_slot_size.restype = ctypes.c_uint64
        lib.shm_ring_slot_size.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class ShmRing:
    """A handle on one ring: `create` in the parent (which owns and
    unlinks the segment), `open` in the workers."""

    def __init__(self, handle, lib, name: str, owner: bool):
        self._h = handle
        self._lib = lib
        self.name = name
        self._owner = owner
        self.slot_size = int(lib.shm_ring_slot_size(handle))
        # one receive buffer per ring (the consumer is one thread): a
        # fresh slot-sized buffer per pop would clear tens of MB on every
        # empty poll
        self._rxbuf = None

    @classmethod
    def create(cls, name: str, slot_size: int, n_slots: int) -> "ShmRing":
        lib = get_lib()
        h = lib.shm_ring_create(name.encode(), slot_size, n_slots)
        if not h:
            raise OSError(ctypes.get_errno(),
                          f"creating the shared-memory ring {name} "
                          f"({n_slots} slots of {slot_size} bytes) failed")
        return cls(h, lib, name, owner=True)

    @classmethod
    def open(cls, name: str) -> "ShmRing":
        lib = get_lib()
        h = lib.shm_ring_open(name.encode())
        if not h:
            raise OSError(f"opening the shared-memory ring {name} failed")
        return cls(h, lib, name, owner=False)

    def push(self, data: bytes, timeout_ms: int = -1) -> int:
        """0 pushed; -1 timed out; -2 larger than a slot."""
        return self._lib.shm_ring_push(self._h, data, len(data), timeout_ms)

    def pop(self, timeout_ms: int = -1):
        """The next message as a bytearray the caller owns (the slot is
        free again when this returns), or None on timeout."""
        if self._rxbuf is None:
            self._rxbuf = ctypes.create_string_buffer(self.slot_size)
        n = self._lib.shm_ring_pop(self._h, self._rxbuf, self.slot_size,
                                   timeout_ms)
        if n < 0:
            return None
        return bytearray(memoryview(self._rxbuf)[:n])

    def close(self):
        if self._h:
            self._lib.shm_ring_close(self._h, 1 if self._owner else 0)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
