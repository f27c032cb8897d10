"""Ring attention: exact attention over sequence-sharded q / k / v
(counterpart of paddle_tpu/parallel/ring_attention.py).

Each rank of the ``sep`` axis holds one chunk of the sequence. The k / v
chunks travel around the ring (rank i sends to (i + 1) % n, with the
`collectives.ppermute` operator), and each rank folds every chunk's
attention into its queries' online-softmax statistics (the blockwise
recurrence of flash / ring attention). A rank never holds more than one
[chunk, chunk] score block, never the whole S x S matrix.

Differentiable: each block's compute is recomputed in the backward
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` on its step), and
the backward of each hop is the ppermute operator's own formula, the hop
the other way. JAX computes a block with ``jnp.einsum`` outside any
Pallas kernel, and so does this port: the block is plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import mesh as mesh_mod
from .collectives import ppermute

__all__ = ["ring_attention"]

_NEG_INF = -1e30


def _block_attn(q, k, v, scale: float, q_off: int, k_off: int,
                causal: bool):
    """One block's contribution. q [B, Sq, Hq, D]; k / v [B, Sk, Hk, D]
    with Hk dividing Hq (GQA by a grouped einsum, no repeat); `q_off` /
    `k_off` the blocks' global positions. Returns (num [B, Sq, Hq, D],
    m [B, Sq, Hq, 1], l [B, Sq, Hq, 1]), all f32: the unnormalized output
    and the row statistics."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hk, hq // hk, d)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).to(torch.float32) * scale
    if causal:
        qpos = q_off + torch.arange(sq, device=q.device)
        kpos = k_off + torch.arange(sk, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s,
                        torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)                # [B,Hk,r,Sq,1]
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    num = torch.einsum("bhrqk,bkhd->bqhrd", p.to(v.dtype), v).to(
        torch.float32).reshape(b, sq, hq, d)

    def rows(t):     # [B, Hk, r, Sq, 1] -> [B, Sq, Hq, 1]
        return t[..., 0].movedim(3, 1).reshape(b, sq, hq)[..., None]

    return num, rows(m), rows(l)


def _combine(acc, block):
    num, m, l = acc
    bnum, bm, bl = block
    m_new = torch.maximum(m, bm)
    c_old = torch.exp(m - m_new)
    c_new = torch.exp(bm - m_new)
    return num * c_old + bnum * c_new, m_new, l * c_old + bl * c_new


def ring_attention(q, k, v, *, mesh=None, axis: str = "sep",
                   causal: bool = True, scale: Optional[float] = None):
    """Exact attention of this rank's sequence chunk: q [B, s, Hq, D] and
    k / v [B, s, Hk, D] are its chunk (chunk i of n holds global
    positions i * s .. (i + 1) * s - 1 of the `axis` ranks' sequence);
    returns its chunk of the output [B, s, Hq, D]. Without a mesh (the
    argument or the global one) holding `axis` above 1, it is one block
    over the given sequence."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mesh = mesh or mesh_mod.get_global_mesh()
    if mesh is None or axis not in mesh.axis_names \
            or int(mesh.shape[axis]) == 1:
        num, m, l = _block_attn(q, k, v, scale, 0, 0, causal)
        return (num / l).to(q.dtype)

    ref = mesh.axis_ref(axis)
    n, idx, chunk = ref.size, ref.rank, q.shape[1]
    if k.shape[1] != chunk or v.shape != k.shape:
        raise ValueError(f"ring_attention: q, k and v chunks differ "
                         f"({list(q.shape)}, {list(k.shape)}, "
                         f"{list(v.shape)})")
    perm = [(i, (i + 1) % n) for i in range(n)]
    b, _, h, _ = q.shape
    acc = (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
           torch.full((b, chunk, h, 1), _NEG_INF, dtype=torch.float32,
                      device=q.device),
           torch.zeros((b, chunk, h, 1), dtype=torch.float32,
                       device=q.device))
    kv = torch.stack((k, v))
    # n - 1 rotating steps, then the last block without a wasted rotation
    for r in range(n):
        src = (idx - r) % n          # the rank that produced this chunk
        acc = _combine(acc, checkpoint(
            _block_attn, q, kv[0], kv[1], scale, idx * chunk, src * chunk,
            causal, use_reentrant=False))
        if r < n - 1:
            kv = ppermute(kv, ref, perm)
    num, _, l = acc
    # rows with no visible key cannot occur in causal self-attention of
    # equal chunks; the floor guards the division all the same
    return (num / torch.clamp_min(l, 1e-30)).to(q.dtype)
