"""paddle.save / paddle.load of the port (counterpart of
paddle_tpu/framework/io.py; reference: python/paddle/framework/io.py:740
(save) / :982 (load)).

The JAX package's pickle layout: a nested state of dicts, lists and
tuples whose tensor leaves are ``("__tensor__", payload, dtype,
trainable)`` with a numpy payload, so either package reads a file the
other wrote. numpy has no bfloat16 without ``ml_dtypes``: a bf16 leaf's
payload is its exact float32 widening and its dtype field says
"bfloat16", which the port's `load` narrows back (the JAX package loads
it as float32).
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        payload = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return ("__tensor__", payload.copy(), _dtype_name(t),
                bool(obj.requires_grad))
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, tuple) and len(obj) == 4 and obj[0] == "__tensor__":
        _, arr, dtype, trainable = obj
        if return_numpy:
            return arr
        t = torch.from_numpy(np.array(arr))
        want = getattr(torch, str(dtype), None)
        if isinstance(want, torch.dtype) and want != t.dtype:
            t = t.to(want)
        return t.requires_grad_(bool(trainable)) \
            if t.is_floating_point() else t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """paddle.save (ref: python/paddle/framework/io.py:740)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """paddle.load (ref: python/paddle/framework/io.py:982): tensor
    leaves come back as CPU torch tensors (numpy with
    ``return_numpy=True``)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy=return_numpy)
