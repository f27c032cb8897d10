"""Global runtime flag registry of the PyTorch port.

Same contract as the JAX package's registry (``paddle_tpu/framework/
flags.py``): flags are plain Python values registered with a default,
overridable from the environment (``FLAGS_<name>``, or the first set
environment alias) and via ``set_flags``. The port keeps its own copy so
it never imports the JAX package. Only the serving flags this slice reads
are registered, with the JAX package's names and defaults.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def define_flag(name: str, default, doc: str = "", env_aliases=()):
    """Register a flag; `env_aliases` are extra environment variable
    names honoured besides FLAGS_<name> (first set one wins)."""
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    env = os.environ.get(name)
    for alias in env_aliases:
        if env is not None:
            break
        env = os.environ.get(alias)
    _REGISTRY[name] = _coerce(default, env) if env is not None else default
    return _REGISTRY[name]


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if not k.startswith("FLAGS_"):
            k = "FLAGS_" + k
        if k not in _REGISTRY:
            raise KeyError(f"unknown flag {k}; known: {sorted(_REGISTRY)}")
        _REGISTRY[k] = v


def get_flags(flags=None) -> Dict[str, Any]:
    if flags is None:
        return dict(_REGISTRY)
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        if not k.startswith("FLAGS_"):
            k = "FLAGS_" + k
        out[k] = _REGISTRY[k]
    return out


def flag(name: str):
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    return _REGISTRY[name]


# --- serving flags read by the port's engine ---
define_flag("prefix_prefill_kernel", True,
            "serve cached-prefix suffix prefills through the ragged "
            "paged prefix-prefill kernel (not ported yet: the port's "
            "engine refuses prefix_cache=True) "
            "(also: PADDLE_TPU_PREFIX_PREFILL_KERNEL)",
            env_aliases=("PADDLE_TPU_PREFIX_PREFILL_KERNEL",))
define_flag("kv_cache_dtype", "bf16",
            "element type of the paged serving KV pools: 'bf16' "
            "(default) or 'int8' (not ported yet). Read when an engine "
            "is BUILT (also: PADDLE_TPU_KV_CACHE_DTYPE)",
            env_aliases=("PADDLE_TPU_KV_CACHE_DTYPE",))
define_flag("decode_megakernel", "off",
            "fusion rung of the paged decode step: 'off' (default, the "
            "multi-kernel path) | 'attn' | 'full' | 'scan' (the fused "
            "rungs are not ported yet). Legacy booleans map onto the "
            "ladder (also: PADDLE_TPU_DECODE_MEGAKERNEL)",
            env_aliases=("PADDLE_TPU_DECODE_MEGAKERNEL",))
define_flag("unified_step", "auto",
            "serve mixed prefill+decode through the unified ragged step; "
            "'auto' (default) resolves to the split path in the port, "
            "'1'/'0' force (the unified step is not ported yet) "
            "(also: PADDLE_TPU_UNIFIED_STEP)",
            env_aliases=("PADDLE_TPU_UNIFIED_STEP",))
define_flag("serving_mp", 1,
            "tensor-parallel degree of the paged serving stack; 1 "
            "(default) = one device (also: PADDLE_TPU_SERVING_MP)",
            env_aliases=("PADDLE_TPU_SERVING_MP",))
define_flag("serving_cp", 1,
            "context-parallel degree of the paged serving stack; 1 "
            "(default) = one device (also: PADDLE_TPU_SERVING_CP)",
            env_aliases=("PADDLE_TPU_SERVING_CP",))
define_flag("speculative", "off",
            "speculative decoding policy: 'off' (default) | 'ngram' | "
            "'draft' (not ported yet) (also: PADDLE_TPU_SPECULATIVE)",
            env_aliases=("PADDLE_TPU_SPECULATIVE",))
