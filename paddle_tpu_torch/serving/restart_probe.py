"""What a restarted serving process finds in the kernel build cache.

Run in a fresh process, it builds a narrow engine (head_dim 128, 64-token
pages, bf16: the card tests' model) on the card, warms it, and prints
one JSON line: the engine's ``warm_compile_stats``
(`serving/compile_cache.py`) plus ``wall_s``, the seconds from the
probe's start (torch and its package already imported) to the warmed
engine. Over a build directory that an earlier process filled it
reports ``cache_misses == 0`` and ``cache_hits == compile_requests >
0``::

    python -m paddle_tpu_torch.serving.restart_probe

FLAGS_compile_cache (PADDLE_TPU_COMPILE_CACHE) names the build directory
it reads, as for any engine.
"""
from __future__ import annotations

import json
import time

_T0 = time.perf_counter()


def main() -> int:
    import torch

    from ..models import LlamaConfig, init_serving_params
    from . import ContinuousBatchingEngine

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, intermediate_size=512,
                           max_position_embeddings=512)
    eng = ContinuousBatchingEngine(
        cfg, init_serving_params(cfg, seed=0, device="cuda"), slots=4,
        prompt_bucket=64, max_prompt_len=192, max_new_tokens=16,
        block_size=64, steps_per_sync=4, dtype=torch.bfloat16,
        device="cuda")
    eng.warm(buckets=[64])
    print(json.dumps(dict(eng.metrics()["warm_compile_stats"],
                          wall_s=time.perf_counter() - _T0)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
