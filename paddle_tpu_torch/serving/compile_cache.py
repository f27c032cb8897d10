"""The kernel build cache as the serving engine's compile cache
(counterpart of paddle_tpu/serving/compile_cache.py).

The JAX engine's `warm()` compiles its program fleet, and a restart
compiles it again unless JAX's persistent compilation cache serves the
executables from disk. The port's programs are CUDA graphs, which live
in one process and are captured anew by every `warm()`; what a restart
can find on disk is the hand-written kernels' libraries, which
``kernels/_build.py`` compiles with nvcc from ``csrc/`` into its build
directory (keyed by a hash of the sources and flags) and loads once per
process. This module keeps the JAX module's calls and stats over that
cache:

- `enable_compile_cache(dir)` points the build directory at `dir`
  (FLAGS_compile_cache / PADDLE_TPU_COMPILE_CACHE is the zero-code path).
  It applies to the first kernel the process loads;
- `snapshot()` / `stats_since(snap)` count the libraries a build looked
  up (`compile_requests`), found built (`cache_hits`) and built with nvcc
  (`cache_misses`), so `warm()` reports `engine.warm_compile_stats`: a
  fresh process that warms an engine over a populated directory reports
  no miss (the "no compile storm" gate). A second engine in the same
  process requests nothing, its libraries are already loaded;
- the tuned-config artifact (`analysis/tuner.py`,
  ``.paddle_tpu_tune.json``) may live in the same directory.

The build cache is always on: with the flag empty the directory is
``paddle_tpu_torch/_build/``, and `cache_dir()` names it (the JAX module
returns None while its cache is off). The counters are the build's own,
so `counters_available` is always True.
"""
from __future__ import annotations

import os
from typing import Optional

from ..kernels import _build

__all__ = [
    "cache_dir", "enable_compile_cache", "snapshot", "stats_since",
]


def enable_compile_cache(directory: Optional[str] = None) -> \
        Optional[str]:
    """Build and load the kernels in `directory` (default:
    FLAGS_compile_cache; empty = no-op returning None, the default
    directory stays). Idempotent; it sets FLAGS_compile_cache, which the
    first kernel build of the process reads."""
    from ..framework.flags import flag, set_flags

    if directory is None:
        directory = str(flag("compile_cache") or "")
    if not directory:
        return None
    directory = os.path.abspath(str(directory))
    os.makedirs(directory, exist_ok=True)
    set_flags({"compile_cache": directory})
    return directory


def cache_dir() -> str:
    """The directory the kernels are built into and loaded from."""
    return str(_build.build_dir())


def snapshot() -> dict:
    """The build counters now; hand it to `stats_since` after a warm."""
    return dict(_build.BUILD_COUNTS)


def stats_since(snap: dict) -> dict:
    """Build-cache traffic since `snap`, under the JAX module's keys:
    libraries requested, found built (hits) and built by nvcc (misses)."""
    requests = _build.BUILD_COUNTS["requests"] - snap.get("requests", 0)
    hits = _build.BUILD_COUNTS["hits"] - snap.get("hits", 0)
    return {
        "persistent_cache_dir": cache_dir(),
        "counters_available": True,
        "compile_requests": requests,
        "cache_hits": hits,
        "cache_misses": requests - hits,
    }
