"""Flash attention forward (counterpart of paddle_tpu/kernels/flash_attention.py).

Public layout [batch, seqlen, heads, head_dim], like paddle's flash_attn.
KV heads may divide the query heads (GQA); the CUDA kernel
``csrc/flash_attention_fwd.cu`` maps each query head to its KV head
itself. CPU tensors run ``flash_attention_reference``, the twin of the
JAX ``_fwd_ref``. Forward only: the backward kernels are a later slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
# head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128)


def _fwd_ref(q, k, v, causal: bool, scale: float):
    """JAX ``_fwd_ref`` on [BH, S, D]: returns (out, lse [BH, Sq] f32)."""
    bh, sq, _ = q.shape
    bkv, sk, _ = k.shape
    if bkv != bh:
        rep = bh // bkv
        k = torch.repeat_interleave(k, rep, dim=0)
        v = torch.repeat_interleave(v, rep, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", (p / l).to(q.dtype), v)
    return out, (m + torch.log(l))[..., 0]


def _to_bh(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """Plain PyTorch attention in the [B, S, H, D] layout."""
    b, sq, hq, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    out, lse = _fwd_ref(_to_bh(q), _to_bh(k), _to_bh(v), causal, scale)
    out = out.reshape(b, hq, sq, dh).transpose(1, 2)
    return (out, lse) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    return_lse: bool = False):
    """Attention forward in the [B, S, H, D] layout. With `return_lse`
    also returns the row log-sum-exp [B*Hq, Sq] in f32 (the statistic a
    backward pass reads). The causal diagonal is aligned to the END of
    the keys (q_offset = Sk - Sq), as in the JAX kernel."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, return_lse)
    what = "flash_attention"
    dev = _build.require_cuda(what, q, k, v)
    _build.require_contiguous(what, q=q, k=k, v=v)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"{what}: the CUDA kernel takes bfloat16 q/k/v, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {dh} not in {KERNEL_HEAD_DIMS}")
    if k.shape != (b, sk, hkv, dh) or v.shape != k.shape:
        raise ValueError(f"{what}: k/v must be [{b}, Sk, Hkv, {dh}], got "
                         f"{list(k.shape)} / {list(v.shape)}")
    if hq % hkv:
        raise ValueError(f"{what}: Hq {hq} not a multiple of Hkv {hkv}")
    if causal and sq > sk:
        raise ValueError(f"{what}: causal with Sq {sq} > Sk {sk} leaves "
                         "query rows with no visible key")
    if b * hq > 65535:
        raise ValueError(f"{what}: batch*heads {b * hq} exceeds the grid")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: q/k/v must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((b * hq, sq), dtype=torch.float32, device=dev)
    lib = _build.library("flash_attention_fwd")
    code = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, hq, hkv, dh, float(scale), int(causal),
        _build.stream_ptr(dev))
    _build.check(lib, code, what)
    _build.LAUNCHES["flash_attention_fwd"] += 1
    return (out, lse) if return_lse else out


flash_attention_fwd = flash_attention
