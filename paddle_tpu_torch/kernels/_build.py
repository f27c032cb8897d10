"""Build and load the port's hand-written CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is one kernel family with a
plain C interface. At first use every source is compiled by its own
``nvcc`` process, all started together, into
``paddle_tpu_torch/_build/<name>-<hash>.so`` (Hopper only:
``-gencode arch=compute_90a,code=sm_90a``), and loaded with ``ctypes``.
The hash covers the source, the shared headers and the compiler flags, so
an edited source rebuilds and an unchanged one is reused. A file lock
keeps two processes from building into the same directory at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# library -> {C entry point: argtypes}; pointers and the stream are
# c_void_p (a plain int would be cut to 32 bits); every entry point
# returns the cudaError_t of its launch as an int
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "rms_norm": {
        # x, w, out, rows, dim, eps, dtype, stream
        "rms_norm_launch": (_P, _P, _P, _L, _I, _F, _I, _P),
    },
    "flash_attention_fwd": {
        # q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, scale, causal, stream
        "flash_attention_fwd_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _F, _I, _P),
    },
    "paged_decode_attention": {
        # q, k_cache, v_cache, tables, lens, out, B, Hq, Hkv, D,
        # block_size, table_width, max_pages, scale, dtype, stream
        "paged_decode_attention_launch": (_P, _P, _P, _P, _P, _P, _I, _I,
                                          _I, _I, _I, _I, _I, _F, _I, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are compiled from paddle_tpu_torch/csrc at first use")


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(CSRC / (name + '.cu'))}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale library, one nvcc per source in parallel.
    Returns name -> library path. Raises with the compiler's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SIGNATURES}
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = {n: t for n, t in targets.items() if not t.exists()}
            if todo:
                nvcc = _nvcc()
                procs = {}
                for name, tgt in todo.items():
                    tmp = tgt.with_suffix(f".tmp{os.getpid()}.so")
                    cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
                           str(CSRC / (name + ".cu"))]
                    procs[name] = (subprocess.Popen(
                        cmd, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True), tmp)
                failed = []
                for name, (proc, tmp) in procs.items():
                    out, _ = proc.communicate()
                    if proc.returncode:
                        failed.append(f"--- {name}.cu ---\n{out}")
                    else:
                        os.replace(tmp, todo[name])
                if failed:
                    raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building every kernel first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            for lname, path in paths.items():
                if lname in _LIBS:
                    continue
                l = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[lname].items():
                    f = getattr(l, fn)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
                l.ptt_error_string.argtypes = [ctypes.c_int]
                l.ptt_error_string.restype = ctypes.c_char_p
                _LIBS[lname] = l
            lib = _LIBS[name]
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if code:
        msg = lib.ptt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")


def dtype_code(dtype) -> int:
    """The csrc/common.cuh PttDtype code of a torch dtype."""
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32/bfloat16/float16, "
                        f"got {dtype}")
    return codes[dtype]


def stream_ptr(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


# launches of each kernel since the last reset: every wrapper adds one
# where it launches its kernel, and nowhere else (a run can then show
# that its main path really went through the kernels)
LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of `tensors`; raises on any other device
    (the plain versions run only for CPU tensors, chosen by the caller)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"{what}: the CUDA kernel needs every operand on one CUDA "
                f"device, got {[str(x.device) for x in tensors]}")
    return dev


def require_contiguous(what: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
