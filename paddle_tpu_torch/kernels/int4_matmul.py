"""Weight-only dequant matmul for decode (counterpart of
paddle_tpu/kernels/int4_matmul.py ``int4_matmul``, and of the int8 branch
of the serving matmul ``_mm``, paddle_tpu/models/llama.py:685).

Layouts are ``weight_quantize``'s: x [M, K]; int4 weights packed
[N, K // 2] int8 (low nibble = even k, high nibble = odd k) or int8
weights [N, K]; per-channel scales [N] float32. Both compute
``(x @ W^T)`` with W's exact integer values, summed in f32, times the f32
scale, rounded once to x's dtype.

Routing is by M alone, as in the JAX package (``MAX_DECODE_M``):

- CUDA x with M <= 64 launches ``csrc/weight_only_gemv.cu`` (counters
  ``int4_matmul`` / ``int8_weight_matmul``; bf16 or f16 x, K a multiple
  of 32); a dtype or shape the kernel does not take raises;
- CUDA x with M > 64 (prefill, windows) runs the dequantize-then-matmul
  form, the JAX package's own XLA route for large M (counters
  ``int4_matmul_large_m`` / ``int8_weight_matmul_large_m``);
- CPU x runs ``int4_matmul_reference`` / ``int8_weight_matmul_reference``.
"""
from __future__ import annotations

import torch

from . import _build

# beyond this M the JAX package routes to its XLA form (int4_matmul.py:36)
MAX_DECODE_M = 64
# the kernel's threads read 32 k values at a time (16 bytes of int4)
K_MULTIPLE = 32

LARGE_M_SUFFIX = "_large_m"


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """[N, K // 2] packed bytes -> [N, K] int32 values in [-8, 7]
    (the kernel's ``((v & 15) ^ 8) - 8``)."""
    w32 = w_packed.to(torch.int32)
    lo = ((w32 & 15) ^ 8) - 8
    hi = (((w32 >> 4) & 15) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(w_packed.shape[0], -1)


def _reference(x, w_int, scale):
    out = x.to(torch.float32) @ w_int.to(torch.float32).t()
    return (out * scale.to(torch.float32)).to(x.dtype)


def int4_matmul_reference(x: torch.Tensor, w_packed: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack, f32 matmul, scale, one rounding."""
    return _reference(x, unpack_int4(w_packed), scale)


def int8_weight_matmul_reference(x: torch.Tensor, wq: torch.Tensor,
                                 scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 product ``_mm`` computes."""
    return _reference(x, wq, scale)


def _mm_f32(x, w):
    """x @ w.T with an f32 result (w widened to x's dtype, exactly)."""
    w = w.to(x.dtype).t()
    return x @ w if x.dtype == torch.float32 \
        else torch.mm(x, w, out_dtype=torch.float32)


def _large_m(x, wq, scale, int4: bool):
    """The large-M route, the JAX package's XLA forms: int8 weights widen
    to x's dtype (exact) into one matmul with an f32 result; packed int4
    splits into its sign-extended low and high nibbles by int8 shifts and
    meets x's even and odd columns in two such matmuls (int4_matmul.py
    ``_xla_fallback``). Then the f32 scale and one rounding."""
    if int4:
        lo = (wq.view(torch.uint8) << 4).view(torch.int8) >> 4   # even k
        out = _mm_f32(x[:, 0::2], lo)
        del lo
        out += _mm_f32(x[:, 1::2], wq >> 4)                       # odd k
    else:
        out = _mm_f32(x, wq)
    return (out * scale).to(x.dtype)


def _weight_only(what: str, x, wq, scale, int4: bool):
    if x.ndim != 2 or wq.ndim != 2:
        raise ValueError(f"{what}: x [M, K] and w [N, K'] expected, got "
                         f"{list(x.shape)} / {list(wq.shape)}")
    m, k = x.shape
    n, kw = wq.shape
    if kw * (2 if int4 else 1) != k:
        raise ValueError(f"{what}: w {list(wq.shape)} does not match K={k}")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.shape != (n,):
        raise ValueError(f"{what}: w must be int8 and scale float32 [{n}], "
                         f"got {wq.dtype} / {scale.dtype} "
                         f"{list(scale.shape)}")
    if x.device.type == "cpu":
        w_int = unpack_int4(wq) if int4 else wq
        return _reference(x, w_int, scale)
    dev = _build.require_cuda(what, x, wq, scale)
    if m > MAX_DECODE_M:
        out = _large_m(x, wq, scale, int4)
        _build.LAUNCHES[what + LARGE_M_SUFFIX] += 1
        return out
    _build.require_contiguous(what, x=x, w=wq, scale=scale)
    if x.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: the tensor-core GEMV takes bfloat16 or "
                         f"float16 x, got {x.dtype}")
    if k % K_MULTIPLE:
        raise ValueError(f"{what}: K={k} is not a multiple of "
                         f"{K_MULTIPLE} (the kernel's threads load "
                         f"{K_MULTIPLE} k values, 16-byte aligned)")
    for name, t in (("x", x), ("w", wq)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    lib = _build.library("weight_only_gemv")
    err = lib.weight_only_gemv_launch(x.data_ptr(), wq.data_ptr(),
                                      scale.data_ptr(), out.data_ptr(), m, n,
                                      k, int(int4),
                                      _build.dtype_code(x.dtype),
                                      _build.stream_ptr(dev))
    _build.check(lib, err, what)
    _build.LAUNCHES[what] += 1
    return out


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ unpack(w_packed [N, K // 2])^T * scale [N] -> [M, N] in
    x's dtype."""
    return _weight_only("int4_matmul", x, w_packed, scale, True)


def int8_weight_matmul(x: torch.Tensor, wq: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ wq [N, K]^T * scale [N] -> [M, N] in x's dtype."""
    return _weight_only("int8_weight_matmul", x, wq, scale, False)
