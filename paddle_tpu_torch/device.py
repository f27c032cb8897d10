"""Device selection for the PyTorch port.

Every entry point of the port runs on the CUDA card unless the caller asks
for the CPU. ``device=None`` means ``cuda``; without a usable CUDA device
that is an error, never a silent move to the CPU (the CPU path exists for
the parity tests, which ask for it explicitly).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is unavailable); anything
    else -> ``torch.device(device)``, checked the same way when it names
    a CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch reference path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # tensors report an indexed device; compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

