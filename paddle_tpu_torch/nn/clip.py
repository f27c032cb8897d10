"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py; reference:
python/paddle/nn/clip.py).

A clip object is attached to an Optimizer (``grad_clip=...``) and applied
to the whole list of gradients before the update. Norms are taken in f32;
the scale stays a tensor on the gradients' device (no host sync).
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(g.to(torch.float32)))


class ClipGradBase:
    def apply(self, grads: List[torch.Tensor],
              reduce_sq=None) -> List[torch.Tensor]:
        """grads: tensors aligned with the params; returns a new list.
        `reduce_sq` maps the per-tensor sums of squares of blocks to the
        global tensors' (a sharded step: `parallel.trainer`)."""
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def apply(self, grads, reduce_sq=None):
        sqs = [_sq_sum(g) for g in grads]
        if reduce_sq is not None:
            sqs = reduce_sq(sqs)
        global_norm = torch.sqrt(sum(sqs))
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def apply(self, grads, reduce_sq=None):
        sqs = [_sq_sum(g) for g in grads]
        if reduce_sq is not None:
            sqs = reduce_sq(sqs)
        out = []
        for g, sq in zip(grads, sqs):
            n = torch.sqrt(sq)
            scale = self.clip_norm / torch.clamp(n, min=self.clip_norm)
            out.append((g.to(torch.float32) * scale).to(g.dtype))
        return out


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply(self, grads, reduce_sq=None):
        return [torch.clamp(g, self.min, self.max) for g in grads]
