"""Ulysses sequence-parallel attention: the seq <-> head swap over the
``sep`` axis (counterpart of paddle_tpu/parallel/ulysses.py; DeepSpeed
Ulysses, arXiv:2309.14509).

Activations enter attention with each rank holding its slice of the
sequence; attention needs the whole sequence of a head. One tiled
all-to-all over the sep group trades the sequence slices for head
slices (`seq_to_head`), the rank attends its heads over every position,
and the reverse swap (`head_to_seq`) restores the sequence slices.

JAX swaps a global array inside ``shard_map``; here each rank holds its
block and calls the exchange (`collectives.all_to_all`, tiled, whose
backward is the same exchange the other way). A rank's block is the one
JAX's specs give it: before the swap [b, s/sep, H/mp, d], the heads over
``mp``; after it [b, s, H/(mp*sep), d], the heads over ``(mp, sep)`` with
mp major, so rank (i, j) of (mp, sep) holds head block i * sep + j.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .collectives import all_to_all

__all__ = ["head_to_seq", "minimal_kv_repeat", "sep_degree", "seq_to_head",
           "ulysses_available"]


def _axes_size(mesh, names) -> int:
    return math.prod(int(mesh.shape[n]) for n in names)


def sep_degree(mesh, seq_axis: str = "sep") -> int:
    if mesh is None or seq_axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[seq_axis])


def ulysses_available(mesh, num_heads: int, seq_len: int,
                      seq_axis: str = "sep",
                      head_axes: Tuple[str, ...] = ("mp",)) -> bool:
    """True when the all-to-all path applies: sep > 1, and the `num_heads`
    heads split evenly over the head axes and sep, the `seq_len` global
    positions over sep."""
    if sep_degree(mesh, seq_axis) <= 1:
        return False
    g = _axes_size(mesh, [a for a in head_axes if a in mesh.axis_names])
    sep = int(mesh.shape[seq_axis])
    return num_heads % (g * sep) == 0 and seq_len % sep == 0


def minimal_kv_repeat(mesh, num_heads: int, num_kv_heads: int,
                      seq_axis: str = "sep",
                      head_axes: Tuple[str, ...] = ("mp",)) -> int:
    """The smallest repeat r of each kv head such that nkv * r splits
    evenly over the head axes and sep and still lines up with q's
    contiguous head blocks (num_heads % (nkv * r) == 0); else the full
    num_heads / nkv."""
    g = _axes_size(mesh, [a for a in head_axes if a in mesh.axis_names])
    g *= int(mesh.shape[seq_axis])
    full = num_heads // num_kv_heads
    r = g // math.gcd(num_kv_heads, g)
    if r <= full and num_heads % (num_kv_heads * r) == 0:
        return r
    return full


def seq_to_head(x: torch.Tensor, mesh,
                seq_axis: str = "sep") -> torch.Tensor:
    """The rank's [b, s/sep, H/mp, d] -> [b, s, H/(mp*sep), d]: one tiled
    all-to-all over the sep group (split heads, concatenate sequence);
    the axes the heads are already split over move nothing."""
    return all_to_all(x, mesh.axis_ref(seq_axis), split_dim=2, concat_dim=1)


def head_to_seq(x: torch.Tensor, mesh,
                seq_axis: str = "sep") -> torch.Tensor:
    """The rank's [b, s, H/(mp*sep), d] -> [b, s/sep, H/mp, d]: the
    reverse swap."""
    return all_to_all(x, mesh.axis_ref(seq_axis), split_dim=1, concat_dim=2)
