"""Fused RMSNorm (counterpart of paddle_tpu/kernels/rms_norm.py).

``rms_norm`` launches the hand-written CUDA kernel ``csrc/rms_norm.cu``
for CUDA tensors and runs ``rms_norm_reference`` for CPU tensors. Both
keep the statistics in f32 and round once: ``(x32 * inv * w32)`` cast to
x's dtype, the JAX kernel's order (its ``_rms_ref``), not the Hugging
Face order that casts before multiplying by w. Forward only.
"""
from __future__ import annotations

import torch

from . import _build


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch twin of the JAX ``_rms_ref``."""
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv * w.to(torch.float32)).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * w over the last axis."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, w, eps)
    what = "rms_norm"
    dev = _build.require_cuda(what, x, w)
    _build.require_contiguous(what, x=x, w=w)
    d = x.shape[-1]
    if w.shape != (d,) or w.dtype != x.dtype:
        raise ValueError(f"{what}: w must be [{d}] {x.dtype}, got "
                         f"{list(w.shape)} {w.dtype}")
    out = torch.empty_like(x)
    lib = _build.library(what)
    code = lib.rms_norm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                               x.numel() // max(d, 1), d, float(eps),
                               _build.dtype_code(x.dtype),
                               _build.stream_ptr(dev))
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return out
