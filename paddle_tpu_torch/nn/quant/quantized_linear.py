"""Weight-only quantization of projection weights (counterpart of
paddle_tpu/nn/quant/quantized_linear.py ``weight_quantize`` /
``weight_dequantize``; plain PyTorch, no kernel).

Layouts are the JAX package's:

- ``weight_quantize(x [K, N])`` (``weight_only_int8`` or
  ``weight_only_int4``) returns ``(w_q, scale)`` with ``w_q``
  stored transposed, ``[N, K]`` int8; ``weight_only_int4`` packs two
  adjacent k values per byte, ``[N, K // 2]`` (low nibble = even k, high
  nibble = odd k);
- per-channel scales (``group_size=-1``) are ``[N]`` float32. That is the
  layout ``decode_params`` and ``init_quant_serving_params`` use; grouped
  scales (64 / 128) are not ported.

The arithmetic keeps the JAX op order, so identical inputs give identical
bytes: the weight is cast to f32, ``scale = max(absmax / qmax, 1e-8)``
(qmax 7 for int4, 127 for int8), values are divided by the scale (never
multiplied by its reciprocal), rounded half to even and clipped to
``[-qmax - 1, qmax]``. The work runs in chunks of output channels, so a
large weight never has a second full-size f32 copy beside it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...kernels.int4_matmul import unpack_int4

ALGOS = ("weight_only_int8", "weight_only_int4")
_CHUNK = 4096   # output channels quantized per step

__all__ = ["weight_quantize", "weight_dequantize", "ALGOS"]


def _check(algo: str, group_size: int) -> None:
    if algo not in ALGOS:
        raise ValueError(f"algo must be one of {ALGOS}, got {algo!r}")
    if group_size in (64, 128):
        raise NotImplementedError(
            f"group_size={group_size}: grouped weight-only scales are not "
            "ported yet (ROADMAP.md, 'Weight-only quantization'); "
            "group_size=-1 (per-channel) is")
    if group_size != -1:
        raise ValueError(
            f"group_size only supports -1/64/128, got {group_size}")


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[N, K] int8 values in [-8, 7] -> [N, K // 2] packed bytes (K even)."""
    q32 = q.to(torch.int32)
    packed = (q32[:, 0::2] & 0x0F) | ((q32[:, 1::2] & 0x0F) << 4)
    # 0..255 -> the int8 with the same bits
    return packed.to(torch.uint8).view(torch.int8)


def weight_quantize(x: torch.Tensor, algo: str = "weight_only_int8",
                    group_size: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a [K, N] weight per output channel. Returns (w_q [N, K]
    int8, or [N, K // 2] packed for int4; scale [N] float32), both
    contiguous, on x's device."""
    _check(algo, group_size)
    if x.ndim != 2:
        raise ValueError(
            f"weight_quantize expects a 2-D weight, got shape "
            f"{list(x.shape)}")
    k, n = x.shape
    int4 = algo == "weight_only_int4"
    if int4 and k % 2:
        # the packed layout carries no original K
        raise ValueError(
            f"weight_only_int4 requires an even input-feature dim, got K={k}")
    qmax = 7.0 if int4 else 127.0
    wq = torch.empty((n, k // 2 if int4 else k), dtype=torch.int8,
                     device=x.device)
    scale = torch.empty((n,), dtype=torch.float32, device=x.device)
    for n0 in range(0, n, _CHUNK):
        n1 = min(n, n0 + _CHUNK)
        wt = x[:, n0:n1].to(torch.float32).t()            # [nc, K]
        lo, hi = torch.aminmax(wt, dim=1)
        sc = torch.clamp(torch.maximum(-lo, hi) / qmax, min=1e-8)
        q = torch.round(wt / sc[:, None]).clamp_(-qmax - 1, qmax)
        q = q.to(torch.int8)
        wq[n0:n1] = _pack_int4(q) if int4 else q
        scale[n0:n1] = sc
    return wq, scale


def weight_dequantize(x: torch.Tensor, scale: torch.Tensor,
                      algo: str = "weight_only_int8",
                      out_dtype: torch.dtype = torch.float16,
                      group_size: int = -1) -> torch.Tensor:
    """Invert :func:`weight_quantize`: (w_q, scale) -> [K, N] in
    `out_dtype` (the value q * scale, computed in f32 and rounded once)."""
    _check(algo, group_size)
    w = unpack_int4(x) if algo == "weight_only_int4" else x
    deq = w.to(torch.float32) * scale.to(torch.float32)[:, None]
    return deq.t().contiguous().to(out_dtype)
