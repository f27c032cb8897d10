"""Build and load the port's hand-written CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is one kernel family with a
plain C interface. At first use every source is compiled by its own
``nvcc`` process, all started together, into
``paddle_tpu_torch/_build/<name>-<hash>.so`` (Hopper only:
``-gencode arch=compute_90a,code=sm_90a``), and loaded with ``ctypes``.
The hash covers the source, the shared headers and the compiler flags, so
an edited source rebuilds and an unchanged one is reused. A file lock
keeps two processes from building into the same directory at once.
FLAGS_compile_cache (PADDLE_TPU_COMPILE_CACHE) names another build
directory; `BUILD_COUNTS` counts the libraries each build looked up, and
those it found built (``serving/compile_cache.py`` reads them).

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.

Every kernel is one operator ``paddle_tpu::<name>`` (`kernel_op`): its
CUDA implementation checks the operands, launches the kernel through
ctypes and counts the launch; its CPU implementation is the kernel's
plain version; its fake implementation gives the output's shapes. So a
trace of a program (``torch.fx`` over fake tensors, ``analysis/``) holds
one node per launch, on the CPU as on the card, and a CUDA graph capture
records the launch as before.
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
from torch.fx.experimental.proxy_tensor import get_proxy_mode

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"    # the build directory when no flag names one
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
    "flash_attention_bwd": {
        # q, k, v, delta (f32 [B*Hq, Sq], the pre-pass's), dO, lse, dq, B,
        # Sq, Sk, Hq, Hkv, D, scale, causal, stream
        "flash_attention_bwd_dq_launch": (_P, _P, _P, _P, _P, _P, _P, _I,
                                          _I, _I, _I, _I, _I, _F, _I, _P),
        # out, dO, delta, B, Sq, Hq, D, stream
        "flash_attention_bwd_delta_launch": (_P, _P, _P, _I, _I, _I, _I,
                                             _P),
        # q, k, v, dO, lse, delta, dk, dv, B, Sq, Sk, Hq, Hkv, D, scale,
        # causal, stream
        "flash_attention_bwd_dkv_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _I, _I, _F, _I,
                                           _P),
    },
    "swiglu": {
        # x, wg, wu, out, M, K, F, grid (CTAs), stream
        "swiglu_fwd_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        # x, wg, wu, dout, dh_g, dh_u, M, K, F, grid (CTAs), stream
        "swiglu_bwd_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        # a [64, 64], b [64, 128] bf16, c [64, 128] f32, stream
        "swiglu_wgmma_probe_launch": (_P, _P, _P, _P),
    },
    "paged_decode_attention": {
        # q, k_cache, v_cache, tables, lens, out, partials, counters, B,
        # Hq, Hkv, D, block_size, table_width, max_pages, tile rows,
        # tiles per split, splits, scale, dtype, stream
        "paged_decode_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _F, _I, _P),
        # int8 pools: q, k_cache, v_cache, k_scale, v_scale, tables, lens,
        # out, partials, counters, B, Hq, Hkv, D, block_size, table_width,
        # max_pages, tile rows, tiles per split, splits, scale, dtype (of
        # q), stream
        "paged_decode_attention_q8_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                             _P, _P, _I, _I, _I, _I, _I, _I,
                                             _I, _I, _I, _I, _F, _I, _P),
    },
    "paged_prefill_attention": {
        # q, k_new, v_new, k_cache, v_cache, tables, cached_lens, new_lens,
        # out, partials, counters, B, TN, Hq, Hkv, D, page, table_width,
        # max_pages, tiles per split, splits, scale, dtype, stream
        "paged_prefill_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                           _P, _P, _P, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _I, _I, _F, _I, _P),
        # int8 pools: q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
        # tables, cached_lens, new_lens, out, partials, counters, B, TN,
        # Hq, Hkv, D, page, table_width, max_pages, tiles per split,
        # splits, scale, dtype (of q), stream
        "paged_prefill_attention_q8_launch": (_P, _P, _P, _P, _P, _P, _P,
                                              _P, _P, _P, _P, _P, _P, _I, _I,
                                              _I, _I, _I, _I, _I, _I, _I, _I,
                                              _F, _I, _P),
    },
    "decode_attention": {
        # contiguous caches: q, k_cache, v_cache, lens, out, partials,
        # counters, B, Hq, Hkv, D, max_seq, tile rows, tiles per split,
        # splits, scale, dtype, stream
        "contiguous_decode_attention_launch": (_P, _P, _P, _P, _P, _P, _P,
                                               _I, _I, _I, _I, _I, _I, _I,
                                               _I, _F, _I, _P),
    },
    "weight_only_gemv": {
        # x, w, scale, out, M, N, K, int4, dtype, stream
        "weight_only_gemv_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # M, N, K, int4, SMs (0: the current device's), out int32 [7]: the
        # launch's plan (groups, cluster, stages a rank, stages, A tiles,
        # n8 row tiles, shared memory bytes)
        "weight_only_gemv_plan": (_I, _I, _I, _I, _I, _P),
    },
    "decode_megakernel": {
        # host arrays of the operand pointers and of the int dims (their
        # order is in csrc/decode_megakernel.cu), scale, eps, stream
        "decode_megakernel_launch": (_P, _P, _F, _F, _P),
        # the launch's ints, out int64 [4]: grid (resident blocks), shared
        # memory bytes, the partial floats and counters of its plan
        "decode_megakernel_resident": (_P, _P),
    },
}

# the operators of the hand-written kernels (the lower-level Library route:
# `torch.library.custom_op` costs several times its dispatch)
OPS = torch.library.Library("paddle_tpu", "DEF")
OP_NAMESPACE = "paddle_tpu"


def kernel_op(name: str, schema: str, *, cuda, cpu, fake):
    """Define ``paddle_tpu::<name><schema>`` with its CUDA (the launch),
    CPU (the plain version) and fake (output shapes) implementations;
    returns the operator."""
    OPS.define(name + schema)
    OPS.impl(name, cuda, "CUDA")
    OPS.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{OP_NAMESPACE}::{name}", fake, lib=OPS)
    return getattr(getattr(torch.ops, OP_NAMESPACE), name).default


# a host call made inside a program (a checkpoint save, a trace event)
# runs once, when the program is recorded, and never on a replay; under
# an analysis trace it leaves this node (lint rules TPU501 / 601 / 602)
OPS.define("host_callback(str name) -> ()")
OPS.impl("host_callback", lambda name: None, "CompositeExplicitAutograd")


def tracing() -> bool:
    """Whether a program is being traced (``torch.fx``, as ``analysis/``
    does on fake tensors)."""
    return get_proxy_mode() is not None


def mark_host_call(name: str) -> None:
    """Leave a ``paddle_tpu::host_callback(name)`` node in the program
    being traced, if any."""
    if tracing():
        torch.ops.paddle_tpu.host_callback(name)


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


def build_dir() -> Path:
    """Where the libraries are built and loaded from: FLAGS_compile_cache
    when set, else `BUILD_DIR`."""
    from ..framework.flags import flag

    named = str(flag("compile_cache") or "")
    return Path(named).resolve() if named else BUILD_DIR


def _target(name: str, where: Path) -> Path:
    return where / f"{name}-{_digest(CSRC / (name + '.cu'))}.so"


# libraries build_all looked up since the process started ("requests")
# and those it found already built ("hits"); the rest nvcc built
BUILD_COUNTS = {"requests": 0, "hits": 0}


def build_all() -> Dict[str, Path]:
    """Compile every stale library, one nvcc per source in parallel.
    Returns name -> library path. Raises with the compiler's output if
    any build fails."""
    where = build_dir()
    where.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name, where) for name in SIGNATURES}
    with open(where / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = {n: t for n, t in targets.items() if not t.exists()}
            BUILD_COUNTS["requests"] += len(targets)
            BUILD_COUNTS["hits"] += len(targets) - len(todo)
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


# launch counters, one per kernel function of the JAX package that a
# wrapper stands for and per pool dtype: a library serving two functions
# (paged prefill attention serves prefix_prefill_attention and
# ragged_paged_attention) has one counter per function, and a launch over
# int8 pools counts under the function's name plus "_int8". The
# weight-only matmuls also count their large-M route (the JAX package's
# dequantize-then-matmul form for M > 64, no kernel of this package) under
# the function's name plus "_large_m". The backward kernels' delta pre-pass,
# which has no JAX counterpart, counts under "flash_attention_bwd_delta"
INT8_SUFFIX = "_int8"
COUNTERS = ("rms_norm", "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "flash_attention_bwd_delta",
            "swiglu_fwd", "swiglu_bwd",
            "paged_decode_attention",
            "prefix_prefill_attention", "ragged_paged_attention",
            "paged_decode_attention_int8", "prefix_prefill_attention_int8",
            "ragged_paged_attention_int8", "decode_attention",
            "gqa_decode_attention", "int4_matmul", "int8_weight_matmul",
            "int4_matmul_large_m", "int8_weight_matmul_large_m",
            "decode_layer_megakernel", "decode_layer_megakernel_full",
            "decode_layers_megakernel", "decode_layer_megakernel_int8",
            "decode_layer_megakernel_full_int8",
            "decode_layers_megakernel_int8")

# launches of each kernel since the last reset: every wrapper adds one
# where it launches its kernel, and nowhere else (a run can then show
# that its main path really went through the kernels)
LAUNCHES: Dict[str, int] = {name: 0 for name in COUNTERS}


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


def int8_pools(key_cache: torch.Tensor, k_scale, v_scale) -> bool:
    """Whether the KV pools are int8, with the JAX wrappers' argument
    checks: int8 pools need their per-(page, kv head) scales, and scales
    apply to int8 pools only."""
    quant = key_cache.dtype == torch.int8
    if quant and (k_scale is None or v_scale is None):
        raise ValueError(
            "int8 KV pools need their per-(page, kv head) k_scale / "
            "v_scale arrays: a quantized pool without scales decodes "
            "garbage")
    if not quant and (k_scale is not None or v_scale is not None):
        raise ValueError("k_scale/v_scale only apply to int8 KV pools")
    return quant


def require_q8_operands(what: str, key_cache, value_cache, k_scale,
                        v_scale) -> None:
    """The int8 kernels' pool operands: int8 pools of one shape and f32
    scales [max_pages, Hkv], all contiguous."""
    if value_cache.dtype != torch.int8:
        raise ValueError(f"{what}: both pools must be int8, got "
                         f"{key_cache.dtype}/{value_cache.dtype}")
    want = tuple(key_cache.shape[:2])
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.dtype != torch.float32 or tuple(s.shape) != want:
            raise ValueError(f"{what}: {name} must be float32 {list(want)}, "
                             f"got {s.dtype} {list(s.shape)}")
    require_contiguous(what, k_scale=k_scale, v_scale=v_scale)
