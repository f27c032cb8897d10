"""Rotary position embedding (counterpart of paddle_tpu/kernels/rope.py).

Plain PyTorch: the JAX module has no Pallas kernel either (the rotate and
multiply are elementwise work that fuses into its neighbours). The tables
are f32, computed from the positions, and are cast to q's dtype BEFORE the
rotation (rope.py:122-123), so a bf16 model rotates in bf16. The neox
style pairs the two halves of the head dim (the interleaved style and
explicit sin/cos tables of the JAX function are not used by the serving
path and are not ported).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_freqs(seq_len: int, head_dim: int, base: float = 10000.0,
               position_ids: Optional[torch.Tensor] = None,
               dtype=torch.float32, device=None):
    """cos/sin tables [..., S, D/2] (f32 for accuracy, cast at apply)."""
    if position_ids is not None:
        device = position_ids.device
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device)
           if position_ids is None else position_ids.to(torch.float32))
    freqs = pos[..., None] * inv
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def _rotate_neox(x, cos, sin):
    # x: [..., S, H, D]; cos/sin: [S, D/2] or [..., S, D/2]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos.unsqueeze(-2)  # broadcast over heads
    sin = sin.unsqueeze(-2)
    while cos.ndim < x.ndim:
        cos, sin = cos[None], sin[None]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rotary_emb(q, k=None, v=None, position_ids=None,
                     base: float = 10000.0):
    """Apply neox-style RoPE to q (and k) in the paddle layout
    [B, S, H, D] at `position_ids` ([S], or [B, S] such as decode's
    lens[:, None]; default 0..S-1). v passes through untouched. Returns
    as many tensors as it was given."""
    cos, sin = rope_freqs(q.shape[1], q.shape[-1], base=base,
                          position_ids=position_ids, device=q.device)
    cos = cos.to(q.dtype)
    sin = sin.to(q.dtype)
    outs: Tuple = (_rotate_neox(q, cos, sin),)
    if k is not None:
        outs += (_rotate_neox(k, cos, sin),)
    if v is not None:
        outs += (v,)
    return outs if len(outs) > 1 else outs[0]
