"""Ragged paged attention (counterpart of
paddle_tpu/kernels/ragged_attention.py ``ragged_paged_attention``).

Every batch row is ``(cached_len, new_len)``: a decode row is
``new_len=1``, a cold prefill row ``cached_len=0``, a chunked prefill row
has ``cached_len`` at the tokens already committed. Unlike
``prefix_prefill_attention``, cached lengths are token-granular (the last
page may be partial) and the new-token window need not be a whole number
of pages. Rows past ``new_len`` are exact zeros.

int8 pools (``kv_cache_dtype="int8"``) pass their per-(page, kv head) f32
absmax scales ``k_scale`` / ``v_scale`` [max_pages, Hkv]; the window K/V
stay in q's dtype.

CUDA tensors launch ``csrc/paged_prefill_attention.cu`` (the kernel that
also serves ``prefix_prefill_attention``, with its int8-pool variant; each
function has its own launch counter per pool dtype); CPU tensors run
``ragged_paged_attention_reference``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .prefix_prefill import paged_prefill_op, paged_prefill_reference


def ragged_paged_attention_reference(q, k_new, v_new, key_cache,
                                     value_cache, block_tables, cached_lens,
                                     new_lens: Optional[torch.Tensor] = None,
                                     *, scale: Optional[float] = None,
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None):
    """Plain twin of the JAX ``ragged_paged_attention_reference``:
    [b, tn, Hq, D] in f32, rows >= new_lens exact zeros."""
    _build.int8_pools(key_cache, k_scale, v_scale)
    b, tn, _, dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if new_lens is None:
        new_lens = torch.full((b,), tn, dtype=torch.int32, device=q.device)
    return paged_prefill_reference(q, k_new, v_new, key_cache, value_cache,
                                   block_tables, cached_lens, new_lens, scale,
                                   k_scale, v_scale)


def ragged_paged_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, key_cache: torch.Tensor,
                           value_cache: torch.Tensor,
                           block_tables: torch.Tensor,
                           cached_lens: torch.Tensor,
                           new_lens: Optional[torch.Tensor] = None, *,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Mixed decode / prefill / chunk attention over the paged pools in
    one launch. Returns [b, tn, Hq, D] in q's dtype."""
    b, tn, nh, dh = q.shape
    nkv = key_cache.shape[1]
    if nh % nkv:
        raise ValueError(f"Hq {nh} not a multiple of Hkv {nkv}")
    if block_tables.shape[1] < 1:
        raise ValueError("block_tables must be at least one page wide "
                         "(pad with the scratch page and cached_lens 0)")
    _build.int8_pools(key_cache, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if new_lens is None:
        new_lens = torch.full((b,), tn, dtype=torch.int32, device=q.device)
    return paged_prefill_op("ragged_paged_attention", q, k_new, v_new,
                            key_cache, value_cache, block_tables,
                            cached_lens, new_lens, float(scale), k_scale,
                            v_scale)
