"""Fused SwiGLU: silu(x @ Wg) * (x @ Wu) (counterpart of
paddle_tpu/kernels/swiglu.py).

- ``swiglu_fwd`` / ``swiglu_bwd`` launch the hand-written CUDA kernel of
  ``csrc/swiglu.cu`` (warpgroup MMA fed by TMA; the ``_swiglu_fwd_kernel``
  / ``_swiglu_bwd_kernel`` counterparts, one template) on the grid of
  ``swiglu_grid`` for CUDA tensors and run ``swiglu_fwd_reference`` /
  ``swiglu_bwd_reference`` for CPU tensors. The kernels take bf16 only
  and raise otherwise; a CUDA call never falls back to the plain version.
- The custom vjp (JAX ``_swiglu_fused``) is a ``torch.autograd.Function``:
  its backward recomputes g and u inside the backward kernel (the two
  [M, F] products are never saved) and takes dx, dWg and dWu from three
  plain products, which JAX leaves to XLA's dots.
- ``swiglu_matmul(x, wg, wu, fused=None)`` keeps JAX's routing: the
  kernels only when ``fused=True`` and M, K and F are all multiples of
  512 (``_aligned``), ``_swiglu_ref`` otherwise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_BLOCK = 512  # the JAX kernels' tile edge, which the routing reads
# csrc/swiglu.cu's output tile edge (BM = BN): a CTA owns 128 x 128 outputs
SWIGLU_TILE = 128


def _aligned(m: int, f: int, k: int) -> bool:
    return m % _BLOCK == 0 and f % _BLOCK == 0 and k % _BLOCK == 0


def swiglu_grid(m: int, k: int, f: int, n_sms: int,
                what: str = "swiglu") -> int:
    """CTAs of the SwiGLU kernel's persistent grid for x [m, k], W [k, f]
    on a card of `n_sms` SMs: one a SM, each walking output tiles, and no
    more than there are tiles. Refuses shapes the routing does not send to
    the kernel."""
    if not _aligned(m, f, k):
        raise ValueError(f"{what}: M, K and F must be multiples of "
                         f"{_BLOCK}, got M {m}, K {k}, F {f}")
    return min((m // SWIGLU_TILE) * (f // SWIGLU_TILE), n_sms)


def _swiglu_ref(x, wg, wu):
    """silu(x @ wg) * (x @ wu) (the JAX ``_swiglu_ref``)."""
    return F.silu(x @ wg) * (x @ wu)


def _products(x2d, wg, wu):
    f32 = torch.float32
    return x2d.to(f32) @ wg.to(f32), x2d.to(f32) @ wu.to(f32)


def swiglu_fwd_reference(x2d, wg, wu):
    """The forward kernel's arithmetic: f32 sums g = x Wg and u = x Wu,
    silu(g) * u in f32, rounded once to x's dtype."""
    g, u = _products(x2d, wg, wu)
    return (g * torch.sigmoid(g) * u).to(x2d.dtype)


def swiglu_bwd_reference(x2d, wg, wu, dout):
    """The backward kernel's arithmetic (swiglu.py:157-166): g and u
    recomputed in f32, dh_g = dout * u * silu'(g) and dh_u = dout *
    silu(g) in f32, each rounded once to x's dtype."""
    g, u = _products(x2d, wg, wu)
    d = dout.to(torch.float32)
    sig = torch.sigmoid(g)
    dsilu = sig * (1.0 + g * (1.0 - sig))
    return (d * u * dsilu).to(x2d.dtype), (d * (g * sig)).to(x2d.dtype)


def _check_cuda(what, x2d, wg, wu, *more):
    dev = _build.require_cuda(what, x2d, wg, wu, *more)
    _build.require_contiguous(what, x=x2d, wg=wg, wu=wu)
    if any(t.dtype != torch.bfloat16 for t in (x2d, wg, wu, *more)):
        raise ValueError(f"{what}: the CUDA kernel takes bfloat16 operands, "
                         f"got {[str(t.dtype) for t in (x2d, wg, wu, *more)]}")
    m, k = x2d.shape
    f = wg.shape[1]
    if wg.shape != (k, f) or wu.shape != (k, f):
        raise ValueError(f"{what}: wg / wu must be [{k}, F], got "
                         f"{list(wg.shape)} / {list(wu.shape)}")
    grid = swiglu_grid(m, k, f, torch.cuda.get_device_properties(
        dev).multi_processor_count, what)
    if any(t.data_ptr() % 16 for t in (x2d, wg, wu, *more)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    return dev, m, k, f, grid


def _swiglu_fwd_cuda(x2d, wg, wu):
    what = "swiglu_fwd"
    dev, m, k, f, grid = _check_cuda(what, x2d, wg, wu)
    out = torch.empty((m, f), dtype=x2d.dtype, device=dev)
    lib = _build.library("swiglu")
    code = lib.swiglu_fwd_launch(x2d.data_ptr(), wg.data_ptr(),
                                 wu.data_ptr(), out.data_ptr(), m, k, f,
                                 grid, _build.stream_ptr(dev))
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return out


def _swiglu_bwd_cuda(x2d, wg, wu, dout):
    what = "swiglu_bwd"
    dout = dout.contiguous()
    dev, m, k, f, grid = _check_cuda(what, x2d, wg, wu, dout)
    if dout.shape != (m, f):
        raise ValueError(f"{what}: dout must be [{m}, {f}], got "
                         f"{list(dout.shape)}")
    dh_g = torch.empty((m, f), dtype=x2d.dtype, device=dev)
    dh_u = torch.empty_like(dh_g)
    lib = _build.library("swiglu")
    code = lib.swiglu_bwd_launch(x2d.data_ptr(), wg.data_ptr(),
                                 wu.data_ptr(), dout.data_ptr(),
                                 dh_g.data_ptr(), dh_u.data_ptr(), m, k, f,
                                 grid, _build.stream_ptr(dev))
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return dh_g, dh_u


def _mf(x2d, wg):
    return x2d.new_empty((x2d.shape[0], wg.shape[1]))


_swiglu_fwd_op = _build.kernel_op(
    "swiglu_fwd", "(Tensor x2d, Tensor wg, Tensor wu) -> Tensor",
    cuda=_swiglu_fwd_cuda, cpu=swiglu_fwd_reference,
    fake=lambda x2d, wg, wu: _mf(x2d, wg))

_swiglu_bwd_op = _build.kernel_op(
    "swiglu_bwd",
    "(Tensor x2d, Tensor wg, Tensor wu, Tensor dout) -> (Tensor, Tensor)",
    cuda=_swiglu_bwd_cuda,
    cpu=lambda *a: tuple(swiglu_bwd_reference(*a)),
    fake=lambda x2d, wg, wu, dout: (_mf(x2d, wg), _mf(x2d, wg)))


def swiglu_fwd(x2d, wg, wu):
    """silu(x2d @ wg) * (x2d @ wu) [M, F] (the ``_fwd_pallas``
    counterpart): the kernel on the card, the plain version on the CPU."""
    return _swiglu_fwd_op(x2d, wg, wu)


def swiglu_bwd(x2d, wg, wu, dout):
    """(dh_g, dh_u) [M, F] (the ``_bwd_pallas`` counterpart): the kernel
    on the card, the plain version on the CPU."""
    return _swiglu_bwd_op(x2d, wg, wu, dout)


class _SwiGLUFused(torch.autograd.Function):
    """The JAX ``_swiglu_fused`` custom vjp over a (fwd, bwd) pair: the
    kernels or their plain versions."""

    @staticmethod
    def forward(ctx, x2d, wg, wu, fwd, bwd):
        ctx.save_for_backward(x2d, wg, wu)
        ctx.bwd = bwd
        return fwd(x2d, wg, wu)

    @staticmethod
    def backward(ctx, dout):
        x2d, wg, wu = ctx.saved_tensors
        dh_g, dh_u = ctx.bwd(x2d, wg, wu, dout)
        dx = dh_g @ wg.T + dh_u @ wu.T
        return (dx.to(x2d.dtype), (x2d.T @ dh_g).to(wg.dtype),
                (x2d.T @ dh_u).to(wu.dtype), None, None)


def _swiglu_matmul(x, wg, wu, fused: Optional[bool], fwd, bwd):
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2d = x.reshape(-1, k)
    m, f = x2d.shape[0], wg.shape[1]
    if fused and _aligned(m, f, k):
        out = _SwiGLUFused.apply(x2d.contiguous(), wg, wu, fwd, bwd)
    else:
        out = _swiglu_ref(x2d, wg, wu)
    return out.reshape(*lead, f)


def swiglu_matmul(x, wg, wu, fused: Optional[bool] = None):
    """silu(x @ wg) * (x @ wu); x [..., K], wg / wu [K, F] -> [..., F].

    `fused=None` or False takes the plain composition, as in JAX (where
    XLA's dual matmul beat the Pallas kernel on the TPU); `fused=True`
    reaches the kernels when M, K and F are multiples of 512."""
    return _swiglu_matmul(x, wg, wu, fused, swiglu_fwd, swiglu_bwd)


def swiglu_matmul_reference(x, wg, wu, fused: Optional[bool] = None):
    """``swiglu_matmul`` with the kernels' plain versions on any device
    (the model's ``use_kernels=False`` path)."""
    return _swiglu_matmul(x, wg, wu, fused, swiglu_fwd_reference,
                          swiglu_bwd_reference)
