"""Fused RMSNorm (counterpart of paddle_tpu/kernels/rms_norm.py).

``rms_norm`` launches the hand-written CUDA kernel ``csrc/rms_norm.cu``
for CUDA tensors and runs ``rms_norm_reference`` for CPU tensors. Both
keep the statistics in f32 and round once: ``(x32 * inv * w32)`` cast to
x's dtype, the JAX kernel's order (its ``_rms_ref``), not the Hugging
Face order that casts before multiplying by w.

Differentiable: when x or w requires grad, the forward runs inside a
``torch.autograd.Function`` whose backward is ``rms_norm_bwd_reference``,
the plain twin of the jnp ``_rms_bwd`` (the JAX package has no Pallas
backward for it either), in f32 and cast to the dtypes of x and w.
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


def rms_norm_bwd_reference(x: torch.Tensor, w: torch.Tensor,
                           dy: torch.Tensor, eps: float = 1e-6):
    """Twin of the jnp ``_rms_bwd``: (dx, dw) in f32, cast to x's and
    w's dtypes."""
    x32 = x.to(torch.float32)
    dy32 = dy.to(torch.float32)
    w32 = w.to(torch.float32)
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xhat = x32 * inv
    dw = torch.sum(dy32 * xhat, dim=tuple(range(x.ndim - 1)))
    g = dy32 * w32
    dx = inv * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dw.to(w.dtype)


def _rms_norm_cuda(x: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
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


_rms_norm_op = _build.kernel_op(
    "rms_norm", "(Tensor x, Tensor w, float eps) -> Tensor",
    cuda=_rms_norm_cuda, cpu=rms_norm_reference,
    fake=lambda x, w, eps: torch.empty_like(x))


def _rms_norm_fwd(x: torch.Tensor, w: torch.Tensor,
                  eps: float) -> torch.Tensor:
    return _rms_norm_op(x, w, float(eps))


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_norm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd_reference(x, w, dy, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * w over the last axis."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _rms_norm_fwd(x, w, eps)
