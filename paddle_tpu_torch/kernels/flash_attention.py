"""Flash attention (counterpart of paddle_tpu/kernels/flash_attention.py).

Public layout [batch, seqlen, heads, head_dim], like paddle's flash_attn.
KV heads may divide the query heads (GQA); the CUDA kernels map each
query head to its KV head themselves.

- Forward: ``csrc/flash_attention_fwd.cu`` for CUDA tensors;
  ``flash_attention_reference`` (the twin of the JAX ``_fwd_ref``) for CPU
  tensors.
- Backward (FA2, the counterpart of ``_flash_core``'s vjp and its two
  Pallas kernels ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``):
  ``csrc/flash_attention_bwd.cu`` for CUDA tensors, read from the
  forward's lse [B*Hq, Sq]; ``flash_attention_bwd_reference`` for CPU
  tensors, the twin of the kernel pair's arithmetic (not of the jnp
  recompute branch). The dkv kernel sums dk / dv over each GQA group in
  f32 and rounds once, where the JAX pair rounds each q head's dk / dv to
  the input dtype and sums the group in that dtype. It reads delta =
  rowsum(dO * O) [B*Hq, Sq] f32 from a pre-pass in the same source
  (``flash_attention_bwd_delta``, plain twin
  ``flash_attention_bwd_delta_reference``), computed once per query row
  where the JAX kernels recompute it per tile. ``flash_attention_bwd``
  launches the pre-pass once and hands its delta to both dq and dkv.

``flash_attention`` is differentiable whenever an input requires grad.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
# head dims the CUDA kernels are instantiated for
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
        s = torch.where(_causal_mask(sq, sk, q.device), s,
                        torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", (p / l).to(q.dtype), v)
    return out, (m + torch.log(l))[..., 0]


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    # the diagonal sits at q_offset = sk - sq (the last query row sees
    # every key), as flash_attention.py:126 aligns it
    return torch.ones((sq, sk), dtype=torch.bool,
                      device=device).tril(diagonal=sk - sq)


def _to_bh(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _from_bh(x, b: int):
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def flash_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """Plain PyTorch attention in the [B, S, H, D] layout."""
    b, sq, hq, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    out, lse = _fwd_ref(_to_bh(q), _to_bh(k), _to_bh(v), causal, scale)
    out = _from_bh(out, b)
    return (out, lse) if return_lse else out


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal: bool,
                                  scale: float, delta=None):
    """The backward kernels' arithmetic on the gathered layout: q, out,
    do [BH, Sq, D], k, v [BKV, Sk, D], lse [BH, Sq] f32. s, p, dp, delta
    and dS in f32; p rounded to do's dtype before p^T dO, dS rounded to
    the input dtype before dS K and dS^T q (flash_attention.py:302-304,
    345-356); delta from the forward's rounded `out`, or the given
    `delta` [BH, Sq] f32 (the pre-pass's); sums in f32, each gradient
    rounded once. dk / dv are summed over the GQA group in f32.
    Returns (dq [BH, Sq, D], dk [BKV, Sk, D], dv [BKV, Sk, D])."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    rep = bh // bkv
    f32 = torch.float32
    kr = torch.repeat_interleave(k, rep, dim=0) if rep > 1 else k
    vr = torch.repeat_interleave(v, rep, dim=0) if rep > 1 else v
    s = torch.einsum("bqd,bkd->bqk", q.to(f32), kr.to(f32)) * scale
    if causal:
        s = torch.where(_causal_mask(sq, sk, q.device), s,
                        torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse[..., None])
    do32 = do.to(f32)
    dp = torch.einsum("bqd,bkd->bqk", do32, vr.to(f32))
    if delta is None:
        delta = torch.sum(do32 * out.to(f32), dim=-1, keepdim=True)
    else:
        delta = delta[..., None]
    ds = p * (dp - delta) * scale
    ds_r = ds.to(q.dtype).to(f32)
    dq = torch.einsum("bqk,bkd->bqd", ds_r, kr.to(f32))
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).to(f32), do32)
    dk = torch.einsum("bqk,bqd->bkd", ds_r, q.to(f32))
    if rep > 1:
        dk = dk.reshape(bkv, rep, sk, d).sum(1)
        dv = dv.reshape(bkv, rep, sk, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(what, q, k, v, causal, *more):
    """The CUDA kernels' operand rules (forward and backward)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = _build.require_cuda(what, q, k, v, *more)
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
    if any(t.data_ptr() % 16 for t in (q, k, v, *more)):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    return dev


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    what = "flash_attention"
    dev = _check_cuda(what, q, k, v, causal)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b * hq, sq), dtype=torch.float32, device=dev)
    lib = _build.library("flash_attention_fwd")
    code = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, hq, hkv, dh, float(scale), int(causal),
        _build.stream_ptr(dev))
    _build.check(lib, code, what)
    _build.LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def _flash_fwd_fake(q, k, v, causal, scale):
    b, sq, hq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b * hq, sq), dtype=torch.float32))


_flash_fwd_op = _build.kernel_op(
    "flash_attention_fwd",
    "(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
    "-> (Tensor, Tensor)",
    cuda=_flash_fwd_cuda,
    cpu=lambda q, k, v, causal, scale: flash_attention_reference(
        q, k, v, causal, scale, True),
    fake=_flash_fwd_fake)


def _flash_fwd(q, k, v, causal: bool, scale: float):
    """(out, lse [B*Hq, Sq] f32): the kernel on the card, the plain twin
    of ``_fwd_ref`` on the CPU."""
    return _flash_fwd_op(q, k, v, bool(causal), float(scale))


def _bwd_operands(what, q, k, v, out, lse, do, causal):
    """Checks of the backward kernels' extra operands; returns (device,
    contiguous dO)."""
    do = do.contiguous()
    dev = _check_cuda(what, q, k, v, causal, out, do, lse)
    _build.require_contiguous(what, out=out, lse=lse)
    b, sq, hq, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape \
            or out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"{what}: out / dO must be {list(q.shape)} "
                         f"{q.dtype}, got {list(out.shape)} {out.dtype} / "
                         f"{list(do.shape)} {do.dtype}")
    if lse.shape != (b * hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"{what}: lse must be float32 [{b * hq}, {sq}], "
                         f"got {lse.dtype} {list(lse.shape)}")
    return dev, do


def _plain_bwd(q, k, v, out, lse, do, causal, scale, delta=None):
    b = q.shape[0]
    dq, dk, dv = flash_attention_bwd_reference(
        _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(out), lse, _to_bh(do),
        causal, scale, delta)
    return _from_bh(dq, b), _from_bh(dk, b), _from_bh(dv, b)


def _given_delta(what, delta, q, dev):
    """The pre-pass's delta handed to a backward kernel: f32 [B*Hq, Sq],
    contiguous, on the kernels' device."""
    b, sq, hq, _ = q.shape
    if delta.device != dev or delta.dtype != torch.float32 \
            or delta.shape != (b * hq, sq) or not delta.is_contiguous():
        raise ValueError(f"{what}: delta must be contiguous float32 "
                         f"[{b * hq}, {sq}] on {dev}, got {delta.dtype} "
                         f"{list(delta.shape)} on {delta.device}")
    return delta


def _dq_cuda(q, k, v, out, lse, do, causal, scale, delta):
    what = "flash_attention_bwd_dq"
    dev, do = _bwd_operands(what, q, k, v, out, lse, do, causal)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    delta = _given_delta(what, delta, q, dev)
    dq = torch.empty_like(q)
    lib = _build.library("flash_attention_bwd")
    code = lib.flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), delta.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), b, sq, sk, hq, hkv,
        dh, float(scale), int(causal), _build.stream_ptr(dev))
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return dq


_BWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
               "Tensor do, bool causal, float scale, Tensor delta)")

_dq_op = _build.kernel_op(
    "flash_attention_bwd_dq", _BWD_SCHEMA + " -> Tensor", cuda=_dq_cuda,
    cpu=lambda *a: _plain_bwd(*a)[0],
    fake=lambda q, *a: torch.empty_like(q))


def flash_attention_bwd_dq(q, k, v, out, lse, do, causal: bool,
                           scale: float, delta=None) -> torch.Tensor:
    """dq [B, Sq, Hq, D] of attention in the [B, S, H, D] layout, from the
    forward's `out` and `lse` [B*Hq, Sq] f32 (the ``_bwd_dq_kernel``
    counterpart). The kernel reads delta = rowsum(dO * O) [B*Hq, Sq] f32:
    `delta` from ``flash_attention_bwd_delta``, or None to launch that
    pre-pass here."""
    if delta is None:
        delta = flash_attention_bwd_delta(out, do.contiguous())
    return _dq_op(q, k, v, out, lse, do, bool(causal), float(scale), delta)


def flash_attention_bwd_delta_reference(out, do):
    """delta = rowsum(dO * O) in f32 from the forward's rounded `out`, as
    [B*Hq, Sq] (lse's layout); out, do [B, Sq, Hq, D]."""
    f32 = torch.float32
    return _to_bh((do.to(f32) * out.to(f32)).sum(-1, keepdim=True))[..., 0]


def _delta_cuda(out, do):
    what = "flash_attention_bwd_delta"
    dev = _build.require_cuda(what, out, do)
    _build.require_contiguous(what, out=out, do=do)
    if out.dtype != torch.bfloat16 or do.dtype != torch.bfloat16 \
            or out.shape != do.shape or out.shape[-1] % 2:
        raise ValueError(f"{what}: out / dO must be bfloat16 of one shape "
                         f"with an even head_dim, got {out.dtype} "
                         f"{list(out.shape)} / {do.dtype} {list(do.shape)}")
    b, sq, hq, dh = out.shape
    delta = torch.empty((b * hq, sq), dtype=torch.float32, device=dev)
    lib = _build.library("flash_attention_bwd")
    code = lib.flash_attention_bwd_delta_launch(
        out.data_ptr(), do.data_ptr(), delta.data_ptr(), b, sq, hq, dh,
        _build.stream_ptr(dev))
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return delta


def _delta_fake(out, do):
    b, sq, hq, _ = out.shape
    return out.new_empty((b * hq, sq), dtype=torch.float32)


# the CPU implementation looks the twin up at call time (tests count its
# calls)
_delta_op = _build.kernel_op(
    "flash_attention_bwd_delta", "(Tensor out, Tensor do) -> Tensor",
    cuda=_delta_cuda,
    cpu=lambda out, do: flash_attention_bwd_delta_reference(out, do),
    fake=_delta_fake)


def flash_attention_bwd_delta(out, do) -> torch.Tensor:
    """The backward kernels' pre-pass: delta [B*Hq, Sq] f32 (the kernel
    on the card, ``flash_attention_bwd_delta_reference`` on the CPU).
    `out` and `do` are contiguous bf16 [B, Sq, Hq, D]."""
    return _delta_op(out, do)


def _dkv_cuda(q, k, v, out, lse, do, causal, scale, delta):
    what = "flash_attention_bwd_dkv"
    dev, do = _bwd_operands(what, q, k, v, out, lse, do, causal)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if -(-sk // 64) > 65535:
        raise ValueError(f"{what}: Sk {sk} exceeds the grid")
    delta = _given_delta(what, delta, q, dev)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.library("flash_attention_bwd")
    code = lib.flash_attention_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        sq, sk, hq, hkv, dh, float(scale), int(causal),
        _build.stream_ptr(dev))
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return dk, dv


_dkv_op = _build.kernel_op(
    "flash_attention_bwd_dkv", _BWD_SCHEMA + " -> (Tensor, Tensor)",
    cuda=_dkv_cuda, cpu=lambda *a: tuple(_plain_bwd(*a)[1:]),
    fake=lambda q, k, v, *a: (torch.empty_like(k), torch.empty_like(v)))


def flash_attention_bwd_dkv(q, k, v, out, lse, do, causal: bool,
                            scale: float, delta=None):
    """(dk, dv) [B, Sk, Hkv, D], summed over each kv head's group of
    query heads (the ``_bwd_dkv_kernel`` counterpart plus the caller's
    group sum, flash_attention.py:436-440). The kernel reads the delta
    pre-pass's result: `delta`, or None to launch the pre-pass here."""
    if delta is None:
        delta = flash_attention_bwd_delta(out, do.contiguous())
    return _dkv_op(q, k, v, out, lse, do, bool(causal), float(scale), delta)


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool, scale: float):
    """(dq, dk, dv) in the [B, S, H, D] layout: the delta pre-pass once,
    then the two backward kernels, both reading its delta (their plain
    versions on the CPU)."""
    delta = flash_attention_bwd_delta(out, do.contiguous())
    dq = flash_attention_bwd_dq(q, k, v, out, lse, do, causal, scale, delta)
    return (dq,) + tuple(flash_attention_bwd_dkv(q, k, v, out, lse, do,
                                                 causal, scale, delta))


class _FlashAttention(torch.autograd.Function):
    """The counterpart of ``_flash_core`` and its custom vjp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    return_lse: bool = False):
    """Attention in the [B, S, H, D] layout. With `return_lse` also
    returns the row log-sum-exp [B*Hq, Sq] in f32 (the statistic the
    backward reads). The causal diagonal is aligned to the END of the
    keys (q_offset = Sk - Sq), as in the JAX kernel. Differentiable in
    q, k and v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, bool(causal),
                                         float(scale))
    else:
        out, lse = _flash_fwd(q, k, v, causal, scale)
    return (out, lse) if return_lse else out


flash_attention_fwd = flash_attention
