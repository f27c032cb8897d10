#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Build the hand-written kernels from paddle_tpu_torch/csrc (one nvcc
   per source, in parallel) and hold each kernel against its plain
   PyTorch version on the card at the serving path's shapes, timed with
   CUDA events beside its roofline bound and one PyTorch library call
   as a yardstick (the port never calls it); the paged attention kernels
   and the megakernel rungs also at the 32- and 128-token pages the
   tuner may pick (phase 26). Logs each kernel's share of its bound,
   the roofline's kernel_shares on the h100-sxm row.
2. Serve 16 requests through ContinuousBatchingEngine at Llama-3-8B full
   width (32 layers, random bf16 weights from a seed) on the cold split
   path (prefix_cache=False); then hold the served tokens against a
   teacher-forced plain forward. Every engine captures its programs (the
   decode chunk, the unified step's window, and on the split path one
   prefill program per bucket, batch and prefix width) as CUDA graphs in
   warm(buckets=, prefix_widths=), warmed for its traffic's cold and
   suffix buckets (warm_for), and replays them; compile_stats() must not
   grow under the traffic. Phases 2, 3, 7 and 10-12 serve their traffic a
   second time with every program run eagerly and must give the same
   tokens and launch counts, and log both runs' prefill_s, decode-chunk
   ms (CUDA events) and busy share.
2b. engine-db: phase 2's engine and traffic with double_buffer=True:
   phase 2's tokens; sync_wait_s, blocked_syncs and tokens/s beside the
   synchronous run.
3. The split path with the prefix cache (the JAX engine's default): 24
   requests sharing a 512-token system prompt; cache hits prefill their
   suffixes through prefix_prefill_attention.
4. The unified step: 16 requests, long prompts chunked into 256-token
   windows through ragged_paged_attention, some sharing a cached prefix.
5. int8 KV pools on the split path with the prefix cache: phase 3's
   traffic, the pool sized by kv_pool_bytes= at phase 3's bf16 pool
   bytes; decode and cache-hit prefills through the int8 kernels.
6. int8 KV pools on the unified step: phase 4's traffic; windows through
   the int8 ragged kernel beside the int8 decode lane.
7. int4-split: weight-only int4 params made on the card by
   init_quant_serving_params (no bf16 projection ever exists), served on
   the split path with the prefix cache over phase 3's traffic; decode
   matmuls through the int4 GEMV kernel, prefills through the large-M
   dequantize-then-matmul route.
8. int8w-int8kv-unified: int8 weights from decode_params over the bf16
   params, int8 KV pools, the unified step over phase 4's traffic.
9. quant-generate: build_quant_generate (contiguous caches) over phase
   7's int4 params, 8 prompts of 448 tokens, 32 new tokens each; decode
   attention through gqa_decode_attention. 9b: the same program on a
   2-layer Llama-2-7B (equal heads) with int8 weights, through
   decode_attention.
10-12. The decode megakernel ladder: mega-scan, mega-full, mega-attn.
15. spec-ngram: speculative decoding with the n-gram drafter (spec_k 4)
   on the split path with the prefix cache, bf16 weights and pools, 16
   repetitive prompts of 256-448 tokens: spec-off as the yardstick, then
   speculating, replayed and eagerly (the verify window a CUDA graph);
   ragged launches exactly 32 a verify step; tok/s, acceptance, the
   verify window's ms beside the decode step's.
16. spec-self: DraftModelDrafter on the target itself (its decode step's
   argmax as the draft; the draft program a CUDA graph), int8 pools, the
   split path; acceptance at least 0.2.
17. spec-scan-unified: int8 weights on the scan rung's unified step over
   phase 4's traffic, double-buffered, adaptive depth, a 2-layer draft
   model of Llama-3-8B's widths on its own random weights; replayed and
   eagerly; ragged launches exactly 32 x (windows + verify steps).
18. disagg: disaggregated=True over phase 3's and phase 4's traffic: their
   tokens exactly, every request handed off once.
19. generate: LlamaForCausalLM.jit_generate on Llama-3-8B (8 rows, 32 new
   tokens) in six layouts (contiguous, int8 weights, int4 quant-only,
   paged over bf16 and int8 pools with ragged seq_lens, paged full
   megakernel on int8 weights), each signature's program a CUDA graph
   held to its eager body (tokens, launches), one capture a signature,
   exact launches a call, rank gates; then generate (eager, concat
   caches) for 8 tokens.
20. checkpoint: the bf16 weights written as an HF sharded checkpoint (4
   shards + index, a writer of this script's own) and streamed back by
   load_quant_serving_params: int8 byte-identical to decode_params, the
   load's transient card peak at most 4x the lm_head's f32 bytes, phase
   8's tokens and launches served from it; 2-layer reads (bf16, int4,
   and int4 under injected shard-read faults).
21. observe: phase 3's traffic with a Tracer and a MetricsRegistry and
   with both off (identical tokens, launches and captures; TTFT / TPOT
   logged; the Perfetto export; the decode.dispatch profiler range);
   then hang:decode under a watchdog deadline, synchronous,
   double-buffered and requeueing: one victim, the others' tokens
   unchanged, nothing launched by the abandoned thread.
22. fleet: phase 3's configuration and traffic through a Router (three
   priority classes) over in-process fleet workers that share the
   weights, each warmed before it joins: two workers undisturbed, then a
   kill_worker chaos kill of one mid-request (recovery: re-prefill of
   prompt + delivered tokens on the survivor), then a drain of one
   beside a newly joined third, then a FileStore serve_worker subprocess
   on the card (Llama-3-8B from the same seed). Every stream within the
   rank gate of a plain forward, compile_stats() steady, the kernels
   launched; tok/s beside a lone engine's, router TTFT per class.
13. train, the training slice's main path: bench.py main()'s step on
   Llama-1B (16 layers, kv heads 4, bf16) with AdamW through
   make_train_step(optimizer=), batch 4 x 2048, a warm-up and 10 timed
   steps (tokens/s, ms per step, MFU against 989 TF/s, one profiled
   step); the flash backward kernels on every layer.
14. train-swiglu: Llama-3-8B's widths cut to 2 layers with
   fused_swiglu=True and recompute on, batch 4 x 2048, three steps; the
   SwiGLU kernels forward (twice, with recompute) and backward.
23. hapi, the trainer API over the resilience runtime: hapi.Model.fit on
   phase 13's Llama-1B (full depth, bf16, AdamW) over bench_batch's
   batch eight times, with async checkpoint generations at steps 4 and
   8 (8.4 GB each), then evaluate (2 batches) and predict (1 x 2048);
   exact launches per train step and per eval / predict batch, falling
   losses, both generations verified, a fresh model and optimizer
   resumed byte-identical, and one more step on each equal within 1e-3.
   Then chaos preempt_at:5 on 2 layers (an emergency generation, a
   resume to step 16 within 1e-3 of an uninterrupted oracle), and a
   2-rank GangSupervisor gang on the card with preempt_host:1@5 on its
   first attempt (one relaunch, one agreed generation, each rank's
   losses within 1e-3 of its in-process oracle).
24. loader, the shared-memory DataLoader: phase 23's fit for 8 steps over
   one seeded token dataset, fed by 4 worker threads and then by 4
   spawned worker processes over the shm ring; losses bitwise equal,
   exact launches per step, no ring segment or worker left; ms a step,
   the parent's wait for a batch, the ring's host rate on 64 MiB.
25. audit, the static audits: phase 2's engine (Llama-3-8B, bf16) runs
   warm(audit_memory=True, audit_roofline=True) (after phase 22), then
   fit's audit of phase 24's step and one fit(audit_memory=True,
   audit_roofline=True) step (after phase 24): nothing allocated or
   launched by the audits, TPU701 silent, kernel nodes equal each
   program's launches; each program's predicted time and peak beside
   its measured replay and the allocator's peak, the audits' wall time,
   and the card's launch cost (replayed and eager).
26. tune, the static autotuner: Llama-3-8B (phase 2's bf16 params and
   geometry) tuned on the card's row at phase 2's page, every megakernel
   rung and both pool dtypes (8 candidates, split path): nothing allocated or launched by the tuner,
   the baseline feasible and the winner predicted no slower; the
   winner's saved artifact builds ContinuousBatchingEngine(config=)
   (knobs as the artifact says); the winner on it, the baseline, the
   runner-up and the worst feasible candidate each serve phase 2's
   traffic (exact launches of the rung each serves, rank gates,
   compile_stats() steady) and replay decode chunks: predicted /
   measured and Kendall's tau printed; a fresh process warms an engine
   over the build directory phase 1 filled with no cache miss.
Then the kernel table as one JSON line (each kernel's launches from the
phase that drives it), the card's name and power limit, and the closing
{"ok": true, ...} line.

Phases 15-22, phase 25's engine part and phase 26 run after phase 12 and
before training; phase 23 runs after phase 14, then phase 24 and phase 25's
training part. Every phase resets
the kernel launch counters just before it serves and reads them just
after: a bf16 phase must launch no int8 kernel, an int8
phase no bf16 paged-attention kernel.

Exits non-zero (and prints no result) without a CUDA device, or when
the paddle_tpu_torch package is not beside this script.
"""
from __future__ import annotations

import gc
import glob
import itertools
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace as dataclasses_replace
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
SEED = 0
# int8 phases: a served token must rank within this many logits of the
# teacher-forced bf16 plain forward's argmax (that forward reads no
# quantized cache; the bf16 phases' bar is 0.5)
INT8_RANK_MARGIN = 1.0
PAGED_ATTENTION = ("paged_decode_attention", "prefix_prefill_attention",
                   "ragged_paged_attention")
# (K, N) of the decode matmuls of Llama-3-8B: q and o, k and v, gate and
# up, down, lm_head; per decode step each layer runs q, k, v, o, gate,
# up, down once and the model the lm_head once
GEMV_SHAPES = ((4096, 14336), (4096, 4096), (4096, 1024), (14336, 4096),
               (4096, 128256))
GEMV_PER_STEP = {(4096, 4096): 64, (4096, 1024): 64, (4096, 14336): 64,
                 (14336, 4096): 32, (4096, 128256): 1}
# weight-only matmuls per decode step: 7 per layer plus the lm_head
MATMULS_PER_LAYER = 7
L2_BYTES = 50e6
# decode rows of Llama-3-8B's 8k context (max_seq 8192): lens from 0 to
# 8191, on and beside the edges of the kernels' position splits (15 tiles
# of 64 positions a split at B8 Hkv8: edges at multiples of 960)
LENS_8K = [0, 959, 960, 1919, 4095, 5761, 8190, 8191]
# the speculative verify window's rows (spec_k 4, 8 slots): cached lengths
# with 0, a page edge (64), windows straddling two pages (62: positions
# 62-66; 127), and new lengths 1-5
VERIFY_CASE = ([0, 64, 62, 127, 300, 511, 700, 1381],
               [1, 5, 5, 3, 2, 4, 5, 1])


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn()` over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, operands, iters: int = 20) -> float:
    """Device time of one fn(*operands), cycling through enough copies of
    the operands (at least 2.5x the card's 50 MB L2 in all) that every
    launch reads them from device memory, as a decode step does: each
    layer's weights and cache are read once per step. The launches are
    captured in one CUDA graph and replayed, so the time is the kernels'
    own, back to back, without the Python wrapper's host time between
    launches (a few tens of microseconds, longer than the small decode
    kernels themselves)."""
    per = sum(t.numel() * t.element_size() for t in operands)
    n = max(1, math.ceil(2.5 * L2_BYTES / per))
    copies = [tuple(operands)] + [tuple(t.clone() for t in operands)
                                  for _ in range(n - 1)]
    reps = max(iters, n)
    for ops in copies:                       # warm-up, outside the capture
        fn(*ops)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for ops in itertools.islice(itertools.cycle(copies), reps):
            fn(*ops)
    graph.replay()                           # warm-up replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def queued_ms(fn, iters: int = 10) -> float:
    """The card's time of one fn() when calls run back to back with no
    host gap between them: the calls are queued behind a spin kernel
    (torch.cuda._sleep) that outlasts their host time, and CUDA events
    around them start once the spin ends. The time is all the card does
    for a call (a kernel and its wrapper's small kernels), whatever the
    wrapper's host time, read without the profiler. The spin is sized
    from one call's host time at no more than 2 GHz, and doubled until
    the first event was still waiting when the last call was queued (the
    queue never ran dry)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_s = 2 * iters * host_s + 0.005
    for _ in range(6):
        torch.cuda._sleep(int(spin_s * 2e9))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        dry = start.query()
        torch.cuda.synchronize()
        if not dry:
            return start.elapsed_time(end) / iters
        spin_s *= 2
    raise AssertionError("queued_ms: the spin never outlasted the calls' "
                         "host time")


def bound_ms(n_bytes: float, flops: float):
    """The least time the card could take: bytes at HBM rate vs flops at
    the bf16 tensor rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_check(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Both versions compute in f32 from the same inputs and round once to
    bf16; they may differ by one bf16 rounding step: |got - ref| <=
    2^-7 * max(|ref|, 1) elementwise (2^-7 = one bf16 ulp relative,
    floored at magnitude 1). Returns max |got - ref|."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    tol = 2.0 ** -7 * torch.clamp(r.abs(), min=1.0)
    bad = int((err > tol).sum())
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: {bad} elements beyond one bf16 ulp "
                             f"(max err {float(err.max()):.3e})")
    return float(err.max())


def gate_deterministic(name: str, first: torch.Tensor,
                       again: torch.Tensor) -> None:
    """Two launches on the same inputs give bitwise-equal results."""
    if not torch.equal(first, again):
        raise AssertionError(f"{name}: two launches differ")


# ---------------------------------------------------------------------------
# phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_rms_norm(rows: int, dim: int):
    from paddle_tpu_torch.kernels.rms_norm import (rms_norm,
                                                   rms_norm_reference)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(rows, dim, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    w = (1 + 0.1 * torch.randn(dim, generator=g, device="cuda")).to(
        torch.bfloat16)
    err = ulp_check("rms_norm", rms_norm(x, w, 1e-6),
                    rms_norm_reference(x, w, 1e-6))
    ms = time_ms(lambda: rms_norm(x, w, 1e-6))
    plain_ms = time_ms(lambda: rms_norm_reference(x, w, 1e-6))
    lib_ms = time_ms(lambda: F.rms_norm(x, (dim,), w, 1e-6))
    b_ms, by = bound_ms(2 * rows * dim * 2 + dim * 2, 0)
    return dict(case=f"[{rows}, {dim}] bf16", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=lib_ms)


def check_flash(b: int, sq: int, sk: int, hq: int, hkv: int, d: int):
    """Kernel vs plain on the same bf16 inputs (N(0,1)). The plain twin
    of the JAX _fwd_ref rounds the scores to bf16 before the softmax and
    the kernel keeps them in f32 (both round P to bf16 before P V), so
    they differ by the score rounding: ~2^-9 relative on O(1) logits,
    about 1e-2 on O(1) outputs. Tolerance: max |diff| <= 3e-2 (O) and
    1e-2 (LSE, f32)."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference)

    g = torch.Generator(device="cuda").manual_seed(SEED + sq)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v = rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    again = flash_attention(q, k, v, causal=True, return_lse=True)
    gate_deterministic("flash_attention O", out, again[0])
    gate_deterministic("flash_attention lse", lse, again[1])
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True,
                                             return_lse=True)
    err = float((out.float() - ref.float()).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    if not (err <= 3e-2 and lse_err <= 1e-2 and torch.isfinite(out).all()):
        raise AssertionError(f"flash_attention [{b},{sq},{sk}]: O err "
                             f"{err:.3e}, LSE err {lse_err:.3e}")
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(
        lambda: flash_attention_reference(q, k, v, causal=True), iters=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    off = sk - sq
    mask = torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril(off)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    # causal pairs this run needs: row i sees keys [0, i + off]
    pairs = sum(min(sk, max(0, i + off + 1)) for i in range(sq))
    flops = 4 * b * hq * d * pairs
    n_bytes = 2 * (2 * b * sq * hq * d + 2 * b * sk * hkv * d) \
        + 4 * b * hq * sq
    b_ms, by = bound_ms(n_bytes, flops)
    return dict(case=f"B{b} Sq{sq} Sk{sk} Hq{hq} Hkv{hkv} D{d} causal",
                max_abs_err=max(err, lse_err), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=lib_ms)


def quantized(pools):
    """bf16 pools -> [(int8 pool, f32 scales)] through the port's own
    quantize-on-scatter, and the bf16 pools those stand for (dequantized
    in f32, rounded once), which the library yardsticks read."""
    from paddle_tpu_torch.models.llama import quantize_kv_pages

    q8 = [quantize_kv_pages(p) for p in pools]
    deq = [(p.float() * s[..., None, None]).to(torch.bfloat16)
           for p, s in q8]
    return q8, deq


def check_paged_decode(b: int, hq: int, hkv: int, d: int, bs: int,
                       q8: bool = False, w: int = 9, lens_l=None):
    """Permuted tables, ragged lens including 0, a page boundary
    (lens = k*bs - 1 and k*bs) and a row past its table (lens >= W*bs).
    Both versions score and accumulate in f32 from the same bf16 inputs
    and round once: one bf16 ulp apart at most (ulp_check), against the
    plain version and against the plain twin of the kernel's
    split-and-merge; two launches are bitwise equal. `q8`: the same over
    int8 pools with their scales (the plain version dequantizes in f32
    first, the kernel folds the scales into its f32 sums). `w` table
    columns (9: 576 positions a row), `lens_l` the rows' lens. Kernel and
    library timed cold, as a decode step reads each layer's pages once
    (and without the wrapper's host time, which exceeds the kernel's)."""
    from paddle_tpu_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_reference,
        split_decode_reference)

    g = torch.Generator(device="cuda").manual_seed(SEED + hq)
    n_pages = b * w + 1
    pools = [torch.randn(n_pages, hkv, bs, d, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2)]
    q = torch.randn(b, hq, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(SEED)) + 1
    tables = perm[: b * w].reshape(b, w).to(torch.int32).cuda()
    lens_l = lens_l or [0, bs - 1, bs, 3 * bs + 17, 500, w * bs - 1,
                        w * bs + 5, 257]
    lens = torch.tensor((lens_l * b)[:b], dtype=torch.int32, device="cuda")
    kw = {}
    if q8:
        ((kc, ksc), (vc, vsc)), pools = quantized(pools)
        args = (q, kc, vc, tables, lens)
        kw = dict(k_scale=ksc, v_scale=vsc)
    else:
        args = (q, pools[0], pools[1], tables, lens)
    name = f"paged_decode_attention Hq{hq}/Hkv{hkv} block{bs} W{w} q8={q8}"
    got = paged_decode_attention(*args, **kw)
    err = ulp_check(name, got, paged_decode_attention_reference(*args, **kw))
    ulp_check(name + " (split twin)", got, split_decode_reference(
        args[0], args[1], args[2], lens, block_tables=tables, **kw))
    gate_deterministic(name, got, paged_decode_attention(*args, **kw))

    def kernel(*ops):
        sc = dict(zip(("k_scale", "v_scale"), ops[5:]))
        return paged_decode_attention(*ops[:5], **sc)

    ms = time_cold_ms(kernel, args + tuple(kw.values()))
    plain_ms = time_ms(lambda: paged_decode_attention_reference(*args, **kw))
    # library yardstick: SDPA over the cache gathered (and, for int8,
    # dequantized) beforehand
    tl = tables.long()
    kg, vg = (p[tl].permute(0, 2, 1, 3, 4).reshape(b, hkv, w * bs, d)
              for p in pools)
    mask = (torch.arange(w * bs, device="cuda")[None, :]
            <= lens.long()[:, None])[:, None, None, :]
    lib_ms = time_cold_ms(lambda q, kg, vg, mask: (
        F.scaled_dot_product_attention(q[:, :, None, :], kg, vg,
                                       attn_mask=mask, enable_gqa=True)),
        (q, kg, vg, mask))
    # pages this run's lens name: min(W, len // bs + 1) per row; an int8
    # page is 1 byte per element plus its two f32 scales per kv head
    pages = sum(min(w, int(n) // bs + 1) for n in lens.tolist())
    ctx = pages * bs
    pool_bytes = 2 * ctx * hkv * d + 2 * pages * hkv * 4 if q8 \
        else 2 * ctx * hkv * d * 2
    n_bytes = pool_bytes + 2 * b * hq * d * 2 + b * (w + 1) * 4
    b_ms, by = bound_ms(n_bytes, 4 * hq * d * ctx)
    return dict(case=f"B{b} Hq{hq} Hkv{hkv} D{d} block{bs} W{w} "
                     f"pages{pages}{' int8 pools' if q8 else ''}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=lib_ms)


def check_paged_prefill(name: str, b: int, tn: int, cached, new,
                        w: int = 0, hq: int = 32, hkv: int = 8,
                        d: int = 128, page: int = 64, q8: bool = False):
    """One launch path of csrc/paged_prefill_attention.cu against its
    plain version: permuted tables, page ids past the cached tokens left
    as pad (page 0), pad query rows (>= new) checked for exact zeros and
    nothing NaN. Both versions score and accumulate in f32 from the same
    bf16 inputs (the kernel carries P as two bf16 parts, about 16 bits)
    and round once: one bf16 rounding step apart at most (ulp_check), also
    against the plain twin of the kernel's split-and-merge
    (split_prefill_reference); two launches bitwise equal. `q8`: the same
    over int8 pools with their scales."""
    from paddle_tpu_torch.kernels.prefix_prefill import (
        prefix_prefill_attention, prefix_prefill_reference,
        split_prefill_reference)
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_paged_attention, ragged_paged_attention_reference)

    fn, ref_fn = {
        "prefix_prefill_attention": (prefix_prefill_attention,
                                     prefix_prefill_reference),
        "ragged_paged_attention": (ragged_paged_attention,
                                   ragged_paged_attention_reference),
    }[name]
    g = torch.Generator(device="cuda").manual_seed(SEED + tn + b)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    w = max(w, max(-(-c // page) for c in cached), 1)
    n_pages = b * w + 1
    kc, vc = rnd(n_pages, hkv, page, d), rnd(n_pages, hkv, page, d)
    q, kn, vn = rnd(b, tn, hq, d), rnd(b, tn, hkv, d), rnd(b, tn, hkv, d)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(SEED)) + 1
    tables = torch.zeros(b, w, dtype=torch.int32)
    for row, c in enumerate(cached):
        n = -(-c // page)
        tables[row, :n] = perm[row * w: row * w + n].to(torch.int32)
    tables = tables.cuda()
    cl = torch.tensor(cached, dtype=torch.int32, device="cuda")
    nl = torch.tensor(new, dtype=torch.int32, device="cuda")
    kw = {}
    if q8:
        ((kc, ksc), (vc, vsc)), (kd, vd) = quantized([kc, vc])
        kw = dict(k_scale=ksc, v_scale=vsc)
    args = (q, kn, vn, kc, vc, tables, cl, nl)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    if torch.isnan(out.float()).any():
        raise AssertionError(f"{name}: NaN in the output")
    for row, n in enumerate(new):
        if (out[row, n:] != 0).any():
            raise AssertionError(f"{name}: pad rows of row {row} not zero")
    gate_deterministic(f"{name} q8={q8}", out, fn(*args, **kw))
    err = ulp_check(f"{name} q8={q8}", out, ref_fn(*args, **kw))
    ulp_check(f"{name} q8={q8} vs the split twin", out,
              split_prefill_reference(*args, **kw))
    # the kernel and its library yardstick timed cold (graph-replayed past
    # the L2, as a window reads each layer's pages once; the kernel's own
    # time, not the wrapper's host time between launches)
    ms = time_cold_ms(lambda *ops: fn(*ops[:8], **dict(zip(kw, ops[8:]))),
                      args + tuple(kw.values()))
    plain_ms = time_ms(lambda: ref_fn(*args, **kw), iters=5)
    # library yardstick: SDPA over the cache gathered (and, for int8,
    # dequantized) beforehand and concatenated with the window, under the
    # same mask as an explicit one
    span = w * page
    tl = tables.long()
    keys, vals = (torch.cat([pool[tl].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, span, d), new_.transpose(1, 2)], dim=2)
        for pool, new_ in (((kd, kn), (vd, vn)) if q8
                           else ((kc, kn), (vc, vn))))
    pos = torch.arange(tn, device="cuda")
    cache_ok = torch.arange(span, device="cuda")[None, :] < cl[:, None]
    win_ok = (pos[None, :] <= pos[:, None])[None] \
        & (pos[None, None, :] < nl[:, None, None])
    mask = torch.cat([cache_ok[:, None, :].expand(b, tn, span), win_ok],
                     dim=-1)[:, None]
    lib_ms = time_cold_ms(
        lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=m_, enable_gqa=True),
        (q.transpose(1, 2), keys, vals, mask))
    # what this run's data needs: live query rows read, every output row
    # written, cached tokens' K/V and live window K/V read once (int8: one
    # byte per cached element plus two f32 scales per named page and kv
    # head); each live query of row r at window position i attends
    # cached[r] + i + 1 keys
    live = sum(new)
    named = sum(-(-c // page) for c in cached)
    cache_bytes = 2 * hkv * d * sum(cached) + 2 * 4 * hkv * named if q8 \
        else 2 * 2 * hkv * d * sum(cached)
    n_bytes = 2 * (hq * d * (live + b * tn) + 2 * hkv * d * live) \
        + cache_bytes + 4 * b * (w + 2)
    pairs = sum(n * c + n * (n + 1) // 2 for c, n in zip(cached, new))
    b_ms, by = bound_ms(n_bytes, 4 * hq * d * pairs)
    return dict(case=f"B{b} tn{tn} Hq{hq} Hkv{hkv} D{d} page{page} W{w} "
                     f"cached {list(cached)} new {list(new)}"
                     f"{' int8 pools' if q8 else ''}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=lib_ms)


def check_gemv(quant: str, m: int, k: int, n: int):
    """The weight-only GEMV (int4 or int8 weights) against its plain
    version and the plain twin of its K split under the card's own plan,
    on the same bf16 x and quantized weight: all sum exact integer weights
    times x in f32, scale in f32 and round once, so they are one bf16
    rounding step apart at most (ulp_check); two launches must be bitwise
    equal. The kernel's plan must be its Python twin's (gemv_plan on this
    card's SM count). Timed cold (each launch streams the weights from
    device memory, as a decode step does). Library yardstick: torch.matmul
    over the weight dequantized to bf16 beforehand (the dequantization is
    not timed)."""
    from paddle_tpu_torch.kernels.int4_matmul import (
        card_plan, gemv_plan, int4_matmul, int4_matmul_reference,
        int8_weight_matmul, int8_weight_matmul_reference,
        weight_only_split_reference)
    from paddle_tpu_torch.nn.quant import weight_dequantize, weight_quantize

    int4 = quant == "weight_only_int4"
    fn, ref_fn = ((int4_matmul, int4_matmul_reference) if int4 else
                  (int8_weight_matmul, int8_weight_matmul_reference))
    name = f"{quant} M{m} K{k} N{n}"
    g = torch.Generator(device="cuda").manual_seed(SEED + k + n)
    wq, sc = weight_quantize(
        torch.randn(k, n, generator=g, device="cuda") * 0.02, algo=quant)
    x = torch.randn(m, k, generator=g, device="cuda", dtype=torch.bfloat16)
    plan = card_plan(x, wq, int4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if plan != gemv_plan(m, n, k, int4, sms):
        raise AssertionError(f"{name}: the kernel's plan {plan} is not "
                             f"gemv_plan's")
    got = fn(x, wq, sc)
    gate_deterministic(name, got, fn(x, wq, sc))
    err = ulp_check(name, got, ref_fn(x, wq, sc))
    err = max(err, ulp_check(name + " vs the split twin", got,
                             weight_only_split_reference(x, wq, sc, plan)))
    ms = time_cold_ms(fn, (x, wq, sc))
    plain_ms = time_ms(lambda: ref_fn(x, wq, sc), iters=5)
    wd = weight_dequantize(wq, sc, algo=quant, out_dtype=torch.bfloat16)
    lib_ms = time_cold_ms(torch.matmul, (x, wd))
    del wd
    b_ms, by = bound_ms(wq.numel() + 4 * n + 2 * m * k + 2 * m * n,
                        2 * m * n * k)
    return dict(case=f"M{m} K{k} N{n} {quant[12:]} (groups {plan.groups}, "
                     f"cluster {plan.cluster})",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=lib_ms, shape=(m, k, n))


def check_contiguous_decode(name: str, b: int, hq: int, hkv: int, d: int,
                            max_seq: int, lens_l=None):
    """decode_attention / gqa_decode_attention over contiguous caches
    [B, Hkv, max_seq, D] against the plain version and the plain twin of
    the kernel's split-and-merge: ragged lens (`lens_l`; by default
    including 0 and max_seq - 1). Both score and accumulate in f32 from
    the same bf16 inputs and round once (ulp_check); two launches are
    bitwise equal. Timed cold (each layer's cache is read once per step).
    Library: SDPA (enable_gqa) with a length mask."""
    from paddle_tpu_torch.kernels.decode_attention import (
        decode_attention, decode_attention_reference, gqa_decode_attention,
        split_decode_reference)

    fn = {"decode_attention": decode_attention,
          "gqa_decode_attention": gqa_decode_attention}[name]
    g = torch.Generator(device="cuda").manual_seed(SEED + hq + hkv)
    q = torch.randn(b, hq, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    kc, vc = (torch.randn(b, hkv, max_seq, d, generator=g, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    lens_l = lens_l or [0, 63, 64, 300, 447, 500, max_seq - 2, max_seq - 1]
    lens = torch.tensor((lens_l * b)[:b], dtype=torch.int32, device="cuda")
    args = (q, kc, vc, lens)
    what = f"{name} Hq{hq}/Hkv{hkv} max_seq{max_seq}"
    got = fn(*args)
    err = ulp_check(what, got, decode_attention_reference(*args))
    ulp_check(what + " (split twin)", got, split_decode_reference(*args))
    gate_deterministic(what, got, fn(*args))
    ms = time_cold_ms(fn, args)
    plain_ms = time_ms(lambda: decode_attention_reference(*args))

    def sdpa(q, kc, vc, lens):
        mask = (torch.arange(max_seq, device="cuda")[None, :]
                <= lens.long()[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kc, vc, attn_mask=mask, enable_gqa=True)

    lib_ms = time_cold_ms(sdpa, args)
    ctx = sum(min(max_seq, int(n) + 1) for n in lens.tolist())
    n_bytes = 2 * ctx * hkv * d * 2 + 2 * b * hq * d * 2 + 4 * b
    b_ms, by = bound_ms(n_bytes, 4 * hq * d * ctx)
    return dict(case=f"B{b} Hq{hq} Hkv{hkv} D{d} max_seq{max_seq} "
                     f"positions{ctx}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=lib_ms)


def gate_rel_rms(name: str, kernel, plain, ref32):
    """Phase 2's rule for a bf16 result: the kernel's relative RMS
    distance from the f32 plain result is at most 1.25x the bf16 plain
    version's, plus 1e-3 (the two round at other places). Returns the
    kernel's max |diff| from the f32 result."""
    e_k, e_p = rel_rms(kernel.float(), ref32), rel_rms(plain.float(), ref32)
    if not torch.isfinite(kernel).all() or e_k > 1.25 * e_p + 1e-3:
        raise AssertionError(f"{name}: rel. RMS vs f32 {e_k:.3e}, bf16 "
                             f"plain {e_p:.3e}")
    log(f"[kernel] {name}: rel. RMS vs f32: kernel {e_k:.3e}, bf16 plain "
        f"{e_p:.3e}")
    return float((kernel.float() - ref32).abs().max())


def check_flash_bwd(b: int, s: int, hq: int, hkv: int, d: int):
    """The backward pair (causal, Sq = Sk = s) on N(0, 1) bf16 inputs and
    the kernel forward's out / lse: dq, dk and dv by gate_rel_rms against
    the plain backward in f32 (f32 forward) beside the bf16 one, each
    twice bitwise. The dq row times the kernel alone (the pre-pass's
    delta handed in), the dkv row its wrapper, pre-pass included. Bound:
    the five products FA2 needs at this run's causal pairs -- dkv's four
    (S, dP, dV, dK) on its row, dq's own product on its; the dq kernel's
    recompute of S and dP is its choice, not work. Library: SDPA forward
    plus backward minus forward, the whole backward, on both rows."""
    from paddle_tpu_torch.kernels.flash_attention import (
        _plain_bwd, flash_attention, flash_attention_bwd_delta,
        flash_attention_bwd_delta_reference, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_reference)

    g = torch.Generator(device="cuda").manual_seed(SEED + hq)
    q, do = (torch.randn(b, s, hq, d, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    scale = d ** -0.5
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    args = (q, k, v, out, lse, do, True, scale)
    # the pre-pass once, its delta handed to dq (as flash_attention_bwd
    # does); dkv's wrapper launches its own
    delta = flash_attention_bwd_delta(out, do)
    dq = flash_attention_bwd_dq(*args, delta=delta)
    dk, dv = flash_attention_bwd_dkv(*args)
    case = f"B{b} S{s} Hq{hq} Hkv{hkv} D{d} causal"
    # two launches bitwise equal (dq's second launches the pre-pass itself)
    for n, got, again in zip(("dq", "dk", "dv"), (dq, dk, dv),
                             (flash_attention_bwd_dq(*args),
                              *flash_attention_bwd_dkv(*args))):
        gate_deterministic(f"flash bwd {n} {case}", got, again)
    # the backward kernels' delta pre-pass against its plain twin (f32:
    # the same products summed in another order)
    delta_ref = flash_attention_bwd_delta_reference(out, do)
    delta_err = float((delta - delta_ref).abs().max())
    if delta_err > 1e-4 * max(1.0, float(delta_ref.abs().max())):
        raise AssertionError(f"flash bwd delta {case}: max err "
                             f"{delta_err:.3e}")
    plain = _plain_bwd(*args)
    f32 = [t.float() for t in (q, k, v, do)]
    out32, lse32 = flash_attention_reference(*f32[:3], True, scale, True)
    ref32 = _plain_bwd(*f32[:3], out32, lse32, f32[3], True, scale)
    del out32, lse32, f32
    errs = [gate_rel_rms(f"flash bwd {n} {case}", got, p, r)
            for n, got, p, r in zip(("dq", "dk", "dv"), (dq, dk, dv), plain,
                                    ref32)]
    del plain, ref32
    dq_ms = time_ms(lambda: flash_attention_bwd_dq(*args, delta=delta),
                    iters=10)
    dkv_ms = time_ms(lambda: flash_attention_bwd_dkv(*args), iters=10)
    delta_ms = time_ms(lambda: flash_attention_bwd_delta(out, do), iters=10)
    delta_plain = time_ms(lambda: flash_attention_bwd_delta_reference(
        out, do), iters=10)
    # the library yardstick of the pre-pass: one call of the same row sums
    # (bf16 in, its own [B, S, Hq] layout out)
    delta_lib = time_ms(lambda: torch.linalg.vecdot(do, out, dim=-1),
                        iters=10)
    plain_ms = time_ms(lambda: _plain_bwd(*args), iters=3, warmup=1)
    qt, kt, vt, dot = (t.transpose(1, 2).detach().requires_grad_()
                       for t in (q, k, v, do))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    fwd_ms = time_ms(sdpa, iters=10)
    both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                  dot), iters=10)
    lib_ms = both_ms - fwd_ms
    product = 2 * b * hq * d * s * (s + 1) // 2     # flops of one product
    io = 2 * b * s * d * (3 * hq + 2 * hkv) + 4 * b * hq * s
    # dq (delta handed in, O not read): q, dO, k, v, lse and delta read
    # once, dq written once
    dq_bytes = (2 * b * s * d * (2 * hq + 2 * hkv) + 2 * 4 * b * hq * s
                + 2 * b * s * hq * d)
    dq_bound = bound_ms(dq_bytes, product)
    dkv_bound = bound_ms(io + 2 * 2 * b * s * hkv * d, 4 * product)
    # delta: O and dO read once, delta written once; 2 flops an element
    delta_bound = bound_ms(2 * 2 * b * s * hq * d + 4 * b * hq * s,
                           2 * b * s * hq * d)
    return [dict(case=case, max_abs_err=errs[0], ms=dq_ms, plain_ms=plain_ms,
                 bound_ms=dq_bound[0], bound_by=dq_bound[1],
                 library_ms=lib_ms),
            dict(case=case, max_abs_err=max(errs[1:]), ms=dkv_ms,
                 plain_ms=plain_ms, bound_ms=dkv_bound[0],
                 bound_by=dkv_bound[1], library_ms=lib_ms),
            dict(case=case, max_abs_err=delta_err, ms=delta_ms,
                 plain_ms=delta_plain, bound_ms=delta_bound[0],
                 bound_by=delta_bound[1], library_ms=delta_lib)]


def check_swiglu(m: int, k: int, f: int):
    """The SwiGLU pair on bf16 x ~ N(0, 1), weights ~ N(0, 1/K), dout ~
    N(0, 1): the outputs by gate_rel_rms against the plain versions in
    f32 beside the bf16 ones, each twice bitwise. Bound: 4*M*K*F flops;
    bytes x, Wg, Wu and out (forward), plus dout and the second output
    (backward). Library:
    F.silu(x @ wg) * (x @ wu) in bf16, and for the backward the same two
    products plus the elementwise grads."""
    from paddle_tpu_torch.kernels.swiglu import (swiglu_bwd,
                                                 swiglu_bwd_reference,
                                                 swiglu_fwd,
                                                 swiglu_fwd_reference)

    g = torch.Generator(device="cuda").manual_seed(SEED + f)
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    wg, wu = ((torch.randn(k, f, generator=g, device="cuda") * k ** -0.5)
              .to(torch.bfloat16) for _ in range(2))
    dout = torch.randn(m, f, generator=g, device="cuda").to(torch.bfloat16)
    x32, wg32, wu32 = x.float(), wg.float(), wu.float()
    case = f"M{m} K{k} F{f}"
    out = swiglu_fwd(x, wg, wu)
    gate_deterministic(f"swiglu_fwd {case}", out, swiglu_fwd(x, wg, wu))
    fwd_err = gate_rel_rms(f"swiglu_fwd {case}", out,
                           swiglu_fwd_reference(x, wg, wu),
                           swiglu_fwd_reference(x32, wg32, wu32))
    del out
    dh = swiglu_bwd(x, wg, wu, dout)
    for n, got, again in zip(("dh_g", "dh_u"), dh,
                             swiglu_bwd(x, wg, wu, dout)):
        gate_deterministic(f"swiglu_bwd {n} {case}", got, again)
    bwd_err = max(gate_rel_rms(f"swiglu_bwd {n} {case}", got, p, r)
                  for n, got, p, r in zip(
                      ("dh_g", "dh_u"), dh,
                      swiglu_bwd_reference(x, wg, wu, dout),
                      swiglu_bwd_reference(x32, wg32, wu32, dout.float())))
    del dh
    del x32, wg32, wu32
    fwd_ms = time_ms(lambda: swiglu_fwd(x, wg, wu), iters=10)
    bwd_ms = time_ms(lambda: swiglu_bwd(x, wg, wu, dout), iters=10)
    fwd_plain = time_ms(lambda: swiglu_fwd_reference(x, wg, wu), iters=3,
                        warmup=1)
    bwd_plain = time_ms(lambda: swiglu_bwd_reference(x, wg, wu, dout),
                        iters=3, warmup=1)
    fwd_lib = time_ms(lambda: F.silu(x @ wg) * (x @ wu), iters=10)

    def lib_bwd():
        gg, u = x @ wg, x @ wu
        sig = torch.sigmoid(gg)
        return dout * u * (sig * (1 + gg * (1 - sig))), dout * gg * sig

    bwd_lib = time_ms(lib_bwd, iters=10)
    flops = 4 * m * k * f
    fb = bound_ms(2 * (m * k + 2 * k * f + m * f), flops)
    bb = bound_ms(2 * (m * k + 2 * k * f + 3 * m * f), flops)
    return ([dict(case=case, max_abs_err=fwd_err, ms=fwd_ms,
                  plain_ms=fwd_plain, bound_ms=fb[0], bound_by=fb[1],
                  library_ms=fwd_lib)],
            [dict(case=case, max_abs_err=bwd_err, ms=bwd_ms,
                  plain_ms=bwd_plain, bound_ms=bb[0], bound_by=bb[1],
                  library_ms=bwd_lib)])


# the megakernels at the shape of Llama-3-8B's decode step on the main
# path: 8 slots, 17 table columns of 64-token pages (137 pages a layer,
# as phase 10's engine), contexts like phase 3's (one row at a page
# boundary, where the commit resets an int8 page's scale); the other
# pages the tuner may pick (phase 26) keep the 1088 positions a row
MK_LENS = (520, 576, 600, 630, 660, 700, 720, 743)
MK_W = 17
MK_ROWS = 8
MK_PAGES = (32, 128)


def mk_operands(cfg, n_layers: int, quant: bool, q8: bool, bs: int = 64):
    """Stacked Llama-3-8B layer weights [L, ...] made on the card from
    SEED (bf16 dense, or weight-only int8 pairs), a layer-major pool of L
    x (8 W + 1) pages of `bs` tokens, W = 1088 / bs table columns (bf16,
    or int8 with scales), permuted tables, MK_LENS and h [8, 1, H]: (h,
    lens, tables, weights, pools, scale kwargs)."""
    from paddle_tpu_torch.models.llama import _layer_shapes, quantize_kv_pages
    from paddle_tpu_torch.nn.quant import weight_quantize

    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    w_cols = MK_W * 64 // bs
    b, pages = MK_ROWS, MK_ROWS * w_cols + 1
    weights = []
    for name, shape in _layer_shapes(cfg).items():
        if name.endswith("norm.weight"):
            weights.append((1 + 0.1 * torch.randn(
                (n_layers,) + shape, generator=g, device="cuda")).to(
                    torch.bfloat16))
            continue
        per = [torch.randn(shape, generator=g, device="cuda") * 0.02
               for _ in range(n_layers)]
        if quant:
            pairs = [weight_quantize(w, algo="weight_only_int8") for w in per]
            weights.append((torch.stack([q for q, _ in pairs]),
                            torch.stack([s for _, s in pairs])))
        else:
            weights.append(torch.stack(per).to(torch.bfloat16))
        del per
    shape = (n_layers * pages, cfg.num_key_value_heads, bs, cfg.head_dim)
    pools = [torch.randn(shape, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2)]
    kw = {}
    if q8:
        (kc, ks), (vc, vs) = (quantize_kv_pages(p) for p in pools)
        pools, kw = [kc, vc], dict(k_scale=ks, v_scale=vs)
    perm = torch.randperm(pages - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    tables = perm[: b * w_cols].reshape(b, w_cols).to(torch.int32).cuda()
    lens = torch.tensor(MK_LENS, dtype=torch.int32, device="cuda")
    h = torch.randn(b, 1, cfg.hidden_size, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    return h, lens, tables, weights, pools, kw


def mk_layers(ops, n_layers: int):
    """The first `n_layers` layers of stacked operands (views)."""
    h, lens, tables, weights, pools, kw = ops
    pages = n_layers * (tables.numel() + 1)
    cut = [(w[0][:n_layers], w[1][:n_layers]) if isinstance(w, tuple)
           else w[:n_layers] for w in weights]
    return (h, lens, tables, cut, [p[:pages] for p in pools],
            {k: v[:pages] for k, v in kw.items()})


def mk_call(rung: str, plain: bool, ops, clone: bool = True):
    """One megakernel rung (or its plain version) on clones of the pools
    (in place with clone=False): (h_out, k pool, v pool, k scale, v
    scale)."""
    from paddle_tpu_torch.kernels import decode_megakernel as mk

    h, lens, tables, weights, pools, kw = ops
    if clone:
        pools = [p.clone() for p in pools]
        kw = {k: v.clone() for k, v in kw.items()}
    sfx = "_reference" if plain else ""
    one = [(w[0][0], w[1][0]) if isinstance(w, tuple) else w[0]
           for w in weights]
    if rung == "attn":
        out = getattr(mk, "decode_layer_megakernel" + sfx)(
            h, lens, tables, one[0], *one[2:6], *pools, **kw)
    elif rung == "full":
        out = getattr(mk, "decode_layer_megakernel_full" + sfx)(
            h, lens, tables, *one, *pools, **kw)
    else:
        out = getattr(mk, "decode_layers_megakernel" + sfx)(
            h, lens, tables, *weights, *pools,
            n_layers=weights[0].shape[0], **kw)
    return out[0], pools[0], pools[1], kw.get("k_scale"), kw.get("v_scale")


def off_step(rung: str, ops):
    """The off rung's multi-kernel work for the same layers (the library
    column's yardstick): rms_norm, _mm projections, rotary, the paged
    commit and paged_decode_attention, o projection, and for full / scan
    the MLP half, per layer; pools updated in place."""
    from paddle_tpu_torch.kernels.decode_attention import \
        paged_decode_attention
    from paddle_tpu_torch.kernels.rms_norm import rms_norm
    from paddle_tpu_torch.kernels.rope import apply_rotary_emb
    from paddle_tpu_torch.models.llama import (_mm, make_paged_kv_helpers,
                                               make_paged_kv_q8_helpers)

    h, lens, tables, weights, pools, kw = ops
    b, _, H = h.shape
    n_layers = weights[0].shape[0]
    nkv, bs, dh = pools[0].shape[1:]
    stride = pools[0].shape[0] // n_layers
    q8 = bool(kw)
    for i in range(n_layers):
        w_in, w_post, wq, wk, wv, wo, wg, wu, wd = (
            (w[0][i], w[1][i]) if isinstance(w, tuple) else w[i]
            for w in weights)
        tbl = tables + i * stride
        helpers = make_paged_kv_q8_helpers if q8 else make_paged_kv_helpers
        _, write = helpers(b, 0, nkv, dh, bs, tbl)
        x = rms_norm(h, w_in)
        q = _mm(x, wq).reshape(b, 1, -1, dh)
        k = _mm(x, wk).reshape(b, 1, nkv, dh)
        v = _mm(x, wv).reshape(b, 1, nkv, dh)
        q, k = apply_rotary_emb(q, k, position_ids=lens[:, None],
                                base=10000.0)
        if q8:
            kct = (pools[0], kw["k_scale"])
            vct = (pools[1], kw["v_scale"])
            write(kct, vct, k, v, lens)
        else:
            write(pools[0], pools[1], k, v, lens)
        ctx = paged_decode_attention(q[:, 0].contiguous(), pools[0], pools[1],
                                     tbl, lens, **kw)
        h = h + _mm(ctx.reshape(b, 1, -1), wo)
        if rung != "attn":
            x2 = rms_norm(h, w_post)
            h = h + _mm(F.silu(_mm(x2, wg)) * _mm(x2, wu), wd)
    return h


def check_mk_commits(name, got, ref, ref32, L: int, q8: bool, pages: int):
    """The pools after a megakernel step against the plain version's: at
    most one commit page per (layer, row) differs, every other page
    byte-identical. The first layer's commits come from the same inputs
    and differ by the rounding of the projection: v within one bf16 step
    (2^-7 max(|v|, 1)); k within two steps of its rotate-half pair's norm
    (rotary subtracts two rounded products, so one step of either operand
    survives the cancellation; the pair's norm bounds both operands); on
    int8 pools compared dequantized, plus one step of the page's scale. A
    later layer's commits come from hidden states that already differ by
    rounding, so they meet phase 2's rule instead: no further from the
    f32 plain version's than the bf16 plain version's are (x1.25 + 1e-3,
    relative RMS, dequantized on int8). `pages`: a layer's pages."""

    def deq(res, i, mask):
        t = res[i][mask].float()
        return t * res[i + 2][mask][..., None, None] if q8 else t

    for i in (1, 2):
        diff = (got[i] != ref[i]).flatten(1).any(1)
        if q8:
            diff = diff | (got[i + 2] != ref[i + 2]).any(1)
        if int(diff.sum()) > L * MK_ROWS:
            raise AssertionError(f"{name}: {int(diff.sum())} pages differ")
        first = diff.clone()
        first[pages:] = False
        r = deq(ref, i, first)
        if i == 1:
            d2 = r.shape[-1] // 2
            norm = (r[..., :d2].square() + r[..., d2:].square()).sqrt()
            tol = 2.0 ** -6 * torch.cat([norm, norm], -1).clamp(min=1.0)
        else:
            tol = 2.0 ** -7 * r.abs().clamp(min=1.0)
        if q8:
            tol = tol + ref[i + 2][first][..., None, None]
        err = (deq(got, i, first) - r).abs()
        if bool((err > tol).any()):
            raise AssertionError(f"{name}: first-layer commit err "
                                 f"{float(err.max()):.3e} beyond its bound")
        later = diff.clone()
        later[:pages] = False
        if not bool(later.any()):
            continue
        want = deq(ref32, i, later)
        e_k = rel_rms(deq(got, i, later), want)
        e_p = rel_rms(deq(ref, i, later), want)
        if e_k > 1.25 * e_p + 1e-3:
            raise AssertionError(f"{name}: later layers' commits rel. RMS "
                                 f"vs f32 plain {e_k:.3e}, bf16 plain "
                                 f"{e_p:.3e}")


def check_megakernel(cfg, rung: str, quant: bool, q8: bool, ops):
    """One rung of csrc/decode_megakernel.cu against its plain version on
    the same operands at the main path's shape; two launches bitwise
    equal (h, pools, scales). Its ms is the card's time a call, queued
    back to back (`queued_ms`: the kernel and the wrapper's rope-table
    and counter kernels); call_ms is a call back to back as the engine
    makes it, where the wrapper's host time (validation, rope tables,
    workspaces, the launch) sets the pace. h: no further from the
    plain version run in f32 than the bf16 plain version is (x1.25 +
    1e-3, relative RMS, phase 2's rule). Pools: only commit pages change,
    committed values within one bf16 step (int8: one integer step, scales
    within 1e-2 relative), every other page byte-identical. Every launch
    streams its layers' weights (past the L2 cache); the library column
    is the off rung's multi-kernel work for the same layers (off_step,
    CUDA events back to back), there being no one PyTorch call for the
    function."""
    from paddle_tpu_torch.kernels.decode_megakernel import megakernel_roofline

    L = 2 if rung == "scan" else 1
    ops = mk_layers(ops, L)
    h, lens, tables, weights, pools, kw = ops
    got = mk_call(rung, False, ops)
    torch.cuda.synchronize()
    again = mk_call(rung, False, ops)
    for i, (a, r) in enumerate(zip(got, again)):
        if a is not None:
            gate_deterministic(f"megakernel {rung} output {i}", a, r)
    ref = mk_call(rung, True, ops)
    f32 = [(w if isinstance(w, tuple) else w.float()) for w in weights]
    ref32 = mk_call(rung, True, (h.float(), lens, tables, f32,
                                 [p if q8 else p.float() for p in pools],
                                 kw))
    e_k = rel_rms(got[0].float(), ref32[0])
    e_p = rel_rms(ref[0].float(), ref32[0])
    name = f"megakernel {rung} {'int8' if quant else 'bf16'} weights, " \
        f"{'int8' if q8 else 'bf16'} pools"
    if not torch.isfinite(got[0].float()).all() or e_k > 1.25 * e_p + 1e-3:
        raise AssertionError(f"{name}: rel. RMS vs f32 plain {e_k:.3e}, "
                             f"bf16 plain {e_p:.3e}")
    check_mk_commits(name, got, ref, ref32, L, q8, tables.numel() + 1)
    err = float((got[0].float() - ref[0].float()).abs().max())
    own = (h, lens, tables, weights, [p.clone() for p in pools],
           {k: v.clone() for k, v in kw.items()})
    ms = queued_ms(lambda: mk_call(rung, False, own, clone=False))
    call_ms = time_ms(lambda: mk_call(rung, False, own, clone=False),
                      iters=10)
    plain_ms = time_ms(lambda: mk_call(rung, True, own, clone=False),
                       iters=2, warmup=1)
    lib_ops = (h, lens, tables, weights, [p.clone() for p in pools],
               {k: v.clone() for k, v in kw.items()})
    lib_ms = time_ms(lambda: off_step(rung, lib_ops), iters=10)
    used = weights if rung != "attn" else [weights[i] for i in (0, 2, 3, 4, 5)]
    w_bytes = sum(t.numel() * t.element_size() for w in used
                  for t in (w if isinstance(w, tuple) else (w,)))
    bs = pools[0].shape[2]
    roof = megakernel_roofline(
        b=MK_ROWS, H=cfg.hidden_size, F=cfg.intermediate_size,
        nh=cfg.num_attention_heads, nkv=cfg.num_key_value_heads,
        dh=cfg.head_dim, bs=bs, n_layers=L, weight_bytes=w_bytes,
        positions=sum(MK_LENS), kv_itemsize=1 if q8 else 2, row_itemsize=2,
        mlp=rung != "attn")
    b_ms, by = bound_ms(roof["hbm_bytes"], roof["flops"])
    return dict(case=f"{name}, L{L} B8 H4096 Hq32 Hkv8 D128 block{bs} "
                     f"W{tables.shape[1]} positions {sum(MK_LENS)}; rel. RMS vs f32 plain "
                     f"{e_k:.3e} (bf16 plain {e_p:.3e}); ms = the card's "
                     f"time a call, queued; call_ms = a call back to back "
                     f"with the wrapper's host time; library = off-rung "
                     f"step",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=lib_ms)


def megakernel_cases(cfg):
    """Every rung over both weight kinds and both pool dtypes at 64-token
    pages, and over bf16 weights (phase 26's) at the other pages the
    tuner may pick (MK_PAGES). Returns {counter name: [cases]}, the first
    case of each at the configuration the main path serves it in (phases
    10-12)."""
    res = {}
    for quant, bs in ((True, 64), (False, 64)) \
            + tuple((False, p) for p in MK_PAGES):
        for q8 in (False, True):
            ops = mk_operands(cfg, 2, quant, q8, bs)
            for rung in ("scan", "full", "attn"):
                name = {"scan": "decode_layers_megakernel",
                        "full": "decode_layer_megakernel_full",
                        "attn": "decode_layer_megakernel"}[rung]
                name += "_int8" if q8 else ""
                res.setdefault(name, []).append(
                    ((quant, bs), check_megakernel(cfg, rung, quant, q8, ops)))
            del ops
            _release()
    # main configurations: int8 weights for scan / full (phases 10, 11),
    # bf16 weights for attn (phase 12), 64-token pages
    for name, cases in res.items():
        want = name.split("_int8")[0] != "decode_layer_megakernel"
        cases.sort(key=lambda qc: (qc[0][0] != want, qc[0][1] != 64))
        res[name] = [c for _, c in cases]
    return res


def gemv_step_totals(cases, m: int):
    """One Llama-3-8B decode step's weight-only matmuls at M = m, summed
    from the per-shape cases: (kernel ms, bound ms, library ms)."""
    tot = [0.0, 0.0, 0.0]
    for c in cases:
        mm, k, n = c["shape"]
        if mm == m:
            for i, key in enumerate(("ms", "bound_ms", "library_ms")):
                tot[i] += GEMV_PER_STEP[(k, n)] * c[key]
    return tot


def phase_kernels():
    """Returns {kernel name: [case results]}; the first case of each is
    at the shape the engine's main path gives it."""
    from paddle_tpu_torch.kernels import _build

    from paddle_tpu_torch.serving import compile_cache

    t0 = time.perf_counter()
    snap = compile_cache.snapshot()
    _build.build_all()
    BUILD.update(compile_cache.stats_since(snap),
                 s=time.perf_counter() - t0)
    log(f"[build] {sorted(_build.SIGNATURES)} in {BUILD['s']:.1f}s "
        f"({BUILD['cache_misses']} of {BUILD['compile_requests']} built by "
        f"nvcc, into {BUILD['persistent_cache_dir']})")
    res = {
        "rms_norm": [check_rms_norm(8 * 512, 4096), check_rms_norm(8, 4096)],
        # the serving case first; bench.py's training shape last
        "flash_attention_fwd": [check_flash(4, 512, 512, 32, 8, 128),
                                check_flash(1, 300, 300, 32, 8, 128),
                                check_flash(2, 200, 333, 32, 8, 128),
                                check_flash(4, 2048, 2048, 16, 4, 128)],
        "paged_decode_attention": [
            check_paged_decode(8, 32, 8, 128, 64),
            check_paged_decode(8, 32, 32, 128, 64),
            check_paged_decode(8, 32, 8, 128, 64, w=128, lens_l=LENS_8K)]
        + [check_paged_decode(8, 32, 8, 128, p, w=576 // p)
           for p in MK_PAGES],
        "prefix_prefill_attention": [
            check_paged_prefill("prefix_prefill_attention", 4, 128,
                                [0, 64, 256, 512], [128, 1, 77, 100], w=8)]
        + [check_paged_prefill("prefix_prefill_attention", 4, 128,
                               [0, 64, 256, 512], [128, 1, 77, 100],
                               page=p) for p in MK_PAGES],
        "ragged_paged_attention": [
            check_paged_prefill("ragged_paged_attention", 2, 256,
                                [0, 1344 + 37], [256, 100]),
            check_paged_prefill("ragged_paged_attention", 8, 64,
                                [0, 37, 64, 200, 511, 700, 1381, 256],
                                [1, 1, 1, 1, 1, 1, 1, 64]),
            # phase 4's window: one row, 1536 cached tokens, the engine's
            # table width (33 pages)
            check_paged_prefill("ragged_paged_attention", 1, 256, [1536],
                                [256], w=33),
            # the speculative verify window (spec_k 4): 8 slots of 5 rows
            check_paged_prefill("ragged_paged_attention", 8, 5, *VERIFY_CASE)]
        + [check_paged_prefill("ragged_paged_attention", 2, 256,
                               [0, 1344 + 37], [256, 100], page=p)
           for p in MK_PAGES],
        # the int8-pool variants at the same shapes
        "paged_decode_attention_int8": [
            check_paged_decode(8, 32, 8, 128, 64, q8=True),
            check_paged_decode(8, 32, 32, 128, 64, q8=True),
            check_paged_decode(8, 32, 8, 128, 64, q8=True, w=128,
                               lens_l=LENS_8K)]
        + [check_paged_decode(8, 32, 8, 128, p, q8=True, w=576 // p)
           for p in MK_PAGES],
        "prefix_prefill_attention_int8": [
            check_paged_prefill("prefix_prefill_attention", 4, 128,
                                [0, 64, 256, 512], [128, 1, 77, 100], w=8,
                                q8=True)]
        + [check_paged_prefill("prefix_prefill_attention", 4, 128,
                               [0, 64, 256, 512], [128, 1, 77, 100],
                               page=p, q8=True) for p in MK_PAGES],
        "ragged_paged_attention_int8": [
            check_paged_prefill("ragged_paged_attention", 2, 256,
                                [0, 1344 + 37], [256, 100], q8=True),
            check_paged_prefill("ragged_paged_attention", 8, 64,
                                [0, 37, 64, 200, 511, 700, 1381, 256],
                                [1, 1, 1, 1, 1, 1, 1, 64], q8=True),
            check_paged_prefill("ragged_paged_attention", 1, 256, [1536],
                                [256], w=33, q8=True),
            check_paged_prefill("ragged_paged_attention", 8, 5, *VERIFY_CASE,
                                q8=True)]
        + [check_paged_prefill("ragged_paged_attention", 2, 256,
                               [0, 1344 + 37], [256, 100], page=p, q8=True)
           for p in MK_PAGES],
    }
    # the weight-only GEMV at the decode matmuls' shapes (M = 8 slots),
    # the edge M = 1, and a 64-row decode step (M = 64, the top of the
    # GEMV route); contiguous decode at Llama-3-8B's GQA shape and at
    # equal heads
    for quant, name in (("weight_only_int4", "int4_matmul"),
                        ("weight_only_int8", "int8_weight_matmul")):
        res[name] = [check_gemv(quant, 8, k, n) for k, n in GEMV_SHAPES] \
            + [check_gemv(quant, 1, 4096, 14336)] \
            + [check_gemv(quant, 64, k, n) for k, n in GEMV_SHAPES]
        for m in (8, 64):
            step = gemv_step_totals(res[name], m)
            log(f"[kernel] {name}: one Llama-3-8B decode step's matmuls "
                f"(M={m}, 225 calls): {step[0]:.3f} ms, bound "
                f"{step[1]:.3f} ms ({100 * step[1] / step[0]:.1f}% of "
                f"bound), bf16 torch.matmul {step[2]:.3f} ms")
    res["gqa_decode_attention"] = [
        check_contiguous_decode("gqa_decode_attention", 8, 32, 8, 128, 1024),
        check_contiguous_decode("gqa_decode_attention", 8, 32, 8, 128, 8192,
                                LENS_8K)]
    res["decode_attention"] = [
        check_contiguous_decode("decode_attention", 8, 32, 32, 128, 1024)]
    # the training kernels: the flash backward at phase 13's shape
    # (bench.py's Llama-1B step) and at Llama-3-8B's heads (phase 14);
    # SwiGLU at phase 14's MLP (M = 4 x 2048 tokens); the dkv row's time
    # is its wrapper's, delta pre-pass included
    (res["flash_attention_bwd_dq"], res["flash_attention_bwd_dkv"],
     res["flash_attention_bwd_delta"]) = (
        list(rows) for rows in zip(check_flash_bwd(4, 2048, 16, 4, 128),
                                   check_flash_bwd(1, 2048, 32, 8, 128)))
    res["swiglu_fwd"], res["swiglu_bwd"] = check_swiglu(8192, 4096, 14336)
    _release()
    from paddle_tpu_torch.models import LlamaConfig

    res.update(megakernel_cases(LlamaConfig.llama3_8b()))
    for name, cases in res.items():
        for c in cases:
            log(f"[kernel] {name} {c['case']}: {c['ms']:.4f} ms, bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']}), "
                f"{100 * c['bound_ms'] / c['ms']:.1f}% of bound; plain "
                f"{c['plain_ms']:.4f} ms; library "
                + ("none" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f} ms")
                + ("" if "call_ms" not in c
                   else f"; call {c['call_ms']:.4f} ms")
                + f"; max_abs_err {c['max_abs_err']:.3e}")
    # the roofline's kernel_shares (analysis/device_specs.py, the h100-sxm
    # row) are these: bound / ms of each kernel's first case
    log("[kernel] shares of bound at the main path's shapes: " + json.dumps(
        {n: round(c[0]["bound_ms"] / c[0]["ms"], 4) for n, c in res.items()}))
    return res


# ---------------------------------------------------------------------------
# phase 2: the engine at full width
# ---------------------------------------------------------------------------

def build_model():
    """Llama-3-8B at full width, random bf16 weights from SEED, made on
    the card (shared by phases 2-4)."""
    from paddle_tpu_torch.models import LlamaConfig, init_serving_params

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_serving_params(cfg, seed=SEED, device="cuda",
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    log(f"[engine] Llama-3-8B {n_params / 1e9:.2f}B params bf16 on card in "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, params


def serve(eng, prompts, phase: str):
    """Submit every prompt at once and drain the engine, with every
    kernel launch counter reset just before and read just after. Gates:
    each request returns 32 in-vocabulary tokens."""
    from paddle_tpu_torch.kernels import _build

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    for r in reqs:
        if not r.done or len(r.tokens) != 32:
            raise AssertionError(f"{phase} request {r.req_id}: "
                                 f"{len(r.tokens)} tokens, expected 32")
        if not all(0 <= t < eng.cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"{phase} request {r.req_id}: token out "
                                 "of vocab")
    m = eng.metrics()
    n_tok = sum(len(r.tokens) for r in reqs)
    int8 = sum(n for k, n in launches.items() if k.endswith("_int8"))
    # a draft model decodes over its own bf16 pools
    drafts = getattr(eng._drafter, "kcs", None) is not None
    bf16 = sum(launches[k] for k in PAGED_ATTENTION
               if not (drafts and k == "paged_decode_attention"))
    if (eng.kv_dtype == "int8" and bf16) or (eng.kv_dtype != "int8"
                                             and int8):
        raise AssertionError(f"{phase}: {eng.kv_dtype} pools launched "
                             f"{bf16} bf16 and {int8} int8 paged-attention "
                             f"kernels: {launches}")
    log(f"[{phase}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f}s: "
        f"{n_tok / wall:.1f} tok/s; prefill calls {m['prefill_calls']} "
        f"({m['prefill_s']:.3f}s), prefill windows {m['prefill_chunks']}, "
        f"device steps {m['device_steps']} (decode {m['decode_s']:.3f}s); "
        f"prompt tokens {m['prompt_tokens']}, cache hits "
        f"{m['prefix_hit_tokens']} ({100 * m['prefix_hit_rate']:.1f}%), "
        f"inserts {m['prefix_inserts']}, evictions {m['prefix_evictions']}; "
        f"launches {json.dumps(launches)}")
    return reqs, wall, launches, m


def rank_margin(plain, r) -> float:
    """Teacher-forced bf16 plain forward over prompt + served tokens: the
    worst gap between a served token's logit and the row's argmax."""
    n = len(r.prompt)
    ids = torch.tensor([r.prompt + r.tokens[:-1]], device="cuda")
    with torch.no_grad():
        rows = plain(ids)[0, n - 1:].float()
    gen = torch.tensor(r.tokens, device="cuda")
    return float((rows.max(-1).values
                  - rows.gather(1, gen[:, None])[:, 0]).max())


def rank_margin_split(prefill_plain, decode_plain, r) -> float:
    """rank_margin for a generation whose prompt and decode steps read
    different weights (jit_generate with quant= and a dense prefill):
    the prompt's forward through `prefill_plain` with concat caches, then
    each served token but the last through `decode_plain` over those
    caches, teacher-forced; the worst gap between a served token's logit
    and its row's argmax."""
    n = len(r.prompt)
    L = prefill_plain.config.num_hidden_layers
    with torch.no_grad():
        logits, caches = prefill_plain(torch.tensor([r.prompt], device="cuda"),
                                       caches=[(None, None)] * L)
        rows = [logits[0, -1]]
        for i, t in enumerate(r.tokens[:-1]):
            logits, caches = decode_plain(
                torch.tensor([[t]], device="cuda"), caches=caches,
                position_offset=n + i)
            rows.append(logits[0, -1])
    rows = torch.stack(rows).float()
    gen = torch.tensor(r.tokens, device="cuda")
    return float((rows.max(-1).values
                  - rows.gather(1, gen[:, None])[:, 0]).max())


def rel_rms(a, b) -> float:
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def engine_traffic(cfg):
    """Phase 2's (and phase 12's) prompts: 16 of 16-500 tokens."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(1, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(16, 501, 16)]


# phase 2's engine (the cold split path), shared by the double-buffered
# phase 2b
ENGINE_KW = dict(max_prompt_len=512, prefix_cache=False)


def phase_engine(cfg, params):
    """Phase 2: the cold split path, its programs replayed as CUDA graphs
    and then run eagerly (serve_graph_and_eager), then the numerics of
    the served tokens."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.llama import (_make_head_logits,
                                               _make_prefill)

    prompts = engine_traffic(cfg)
    g = serve_graph_and_eager(
        "engine", cfg, params, prompts,
        lambda eng: profile_decode(eng, prompts[:8]), **ENGINE_KW)[True]
    reqs, wall, launches, m = g.reqs, g.wall, g.launches, g.m
    n_tok = sum(len(r.tokens) for r in reqs)
    chunk_ms = g.chunk_ms
    log(f"[engine] {m['device_steps']} decode chunks of 8 steps x 8 slots, "
        f"{chunk_ms:.2f} ms per chunk")

    # numerics: teacher-forced plain forward over prompt + generated
    # tokens (plain rms_norm / attention on the card, same weights), and
    # the same plain forward in f32 as the control both bf16 paths are
    # measured against
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    params32 = {k: v.float() for k, v in params.items()}
    plain32 = LlamaForCausalLM(cfg, use_kernels=False).load_params(params32)
    head = _make_head_logits(cfg)
    worst = {"kernel_vs_f32": 0.0, "plain_vs_f32": 0.0, "margin": 0.0}
    for r in sorted(reqs, key=lambda r: len(r.prompt))[::15]:  # 2 extremes
        n = len(r.prompt)
        ids = torch.tensor([r.prompt + r.tokens[:-1]], device="cuda")
        with torch.no_grad():
            ref = plain(ids)[0].float()                    # [n+31, V]
            ref32 = plain32(ids[:, :n])[0]
            sb = -(-n // 128) * 128
            pad = torch.zeros(1, sb, dtype=torch.long, device="cuda")
            pad[0, :n] = ids[0, :n]
            h, _ = _make_prefill(cfg, 1, sb)(params, pad)
            got = head(h[:, :n], params)[0].float()        # kernel prefill
        if not (torch.isfinite(ref).all() and torch.isfinite(got).all()):
            raise AssertionError(f"request {r.req_id}: non-finite logits")
        e_kernel, e_plain = rel_rms(got, ref32), rel_rms(ref[:n], ref32)
        gen = torch.tensor(r.tokens, device="cuda")
        rows = ref[n - 1:]
        margin = float((rows.max(-1).values
                        - rows.gather(1, gen[:, None])[:, 0]).max())
        worst["kernel_vs_f32"] = max(worst["kernel_vs_f32"], e_kernel)
        worst["plain_vs_f32"] = max(worst["plain_vs_f32"], e_plain)
        worst["margin"] = max(worst["margin"], margin)
        log(f"[numerics] request {r.req_id} (prompt {n}): prefill logits "
            f"rel. RMS error vs the f32 plain forward: kernel path "
            f"{e_kernel:.3e}, bf16 plain path {e_plain:.3e} (kernel vs "
            f"bf16 plain: max |diff| {float((got - ref[:n]).abs().max()):.3f}"
            f" of max |logit| {float(ref[:n].abs().max()):.3f}); generated "
            f"tokens' worst gap to the bf16 plain argmax {margin:.3f} "
            f"(logit std {float(rows.std()):.3f})")
    del params32, plain32
    # bf16 through 32 layers with random weights: both bf16 paths drift
    # from f32 by rounding at different places (the flash kernel keeps
    # f32 scores, the plain path rounds them to bf16). The kernel path
    # must be no less accurate than the plain bf16 path (within 25%),
    # and greedy choices meet near-ties: a served token must rank within
    # 0.5 logit (~0.4 std) of the plain argmax.
    if worst["kernel_vs_f32"] > 1.25 * worst["plain_vs_f32"] + 1e-3 \
            or worst["margin"] > 0.5:
        raise AssertionError(f"end-to-end numerics out of tolerance: "
                             f"{worst}")
    return {"launches": launches, "tok_s": n_tok / wall,
            "chunk_ms": chunk_ms, "worst": worst, "m": m,
            "tokens": [r.tokens for r in reqs]}


def phase_double_buffer(cfg, params, sync):
    """Phase 2b: phase 2's engine and traffic with double_buffer=True
    (chunk N+1 dispatched before chunk N is read back). Gates: phase 2's
    tokens exactly, compile_stats() unchanged by traffic. Logs sync_wait_s,
    blocked_syncs and tokens/s beside phase 2's synchronous run."""
    eng = build_engine(cfg, params, engine_traffic(cfg), double_buffer=True,
                       **ENGINE_KW)
    stats = eng.compile_stats()
    reqs, wall, launches, m = serve(eng, engine_traffic(cfg), "engine-db")
    if [r.tokens for r in reqs] != sync["tokens"]:
        raise AssertionError("engine-db: double-buffered tokens differ from "
                             "phase 2's synchronous tokens")
    if eng.compile_stats() != stats:
        raise AssertionError(f"engine-db: compile_stats {stats} -> "
                             f"{eng.compile_stats()}")
    n_tok = sum(len(r.tokens) for r in reqs)
    s = sync["m"]
    log(f"[engine-db] double-buffered vs synchronous (phase 2): "
        f"{n_tok / wall:.1f} vs {sync['tok_s']:.1f} tok/s; sync wait "
        f"{m['sync_wait_s']:.3f} "
        f"vs {s['sync_wait_s']:.3f} s, blocked syncs {m['blocked_syncs']} "
        f"vs {s['blocked_syncs']}, decode chunks {m['device_steps']} vs "
        f"{s['device_steps']}; tokens identical")
    del eng
    _release()
    return {"launches": launches, "tok_s": n_tok / wall, "m": m}


def profile_step(eng, title: str):
    """Trace one `eng.step()` under torch.profiler: device time by kernel
    and the device's busy share of the host wall time. Returns (wall ms,
    busy ms)."""
    return profile_call(eng.step, title)


def profile_call(fn, title: str):
    """Trace one `fn()` under torch.profiler (see profile_step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: a CPU op (aten::mm) also reports the
    # time of the kernels it launched, which would count them twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    log(f"[profile] {title}: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[profile]   {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    return wall_ms, busy


def event_ms(fn) -> float:
    """`fn()`'s time on the card's clock, without the profiler: CUDA
    events on the current stream just before and just after it (from its
    first enqueue to the end of its last kernel, host gaps between
    kernels included)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def graph_tag(eng) -> str:
    """How `eng`'s decode chunk runs: a replayed CUDA graph or eagerly."""
    return "graph" if eng._programs["decode"].graph is not None else "eager"


def profile_decode(eng, prompts):
    """After the counted run: 8 requests of 17 new tokens each, two decode
    chunks. The first is timed with CUDA events (`event_ms`: the chunk
    ms), the second traced (busy share). The traced chunk's launches do
    not join the phase's; they are counted apart (reset just before the
    chunk, read just after) and returned with the chunk's (wall ms, busy
    ms) and the first chunk's ms."""
    from paddle_tpu_torch.kernels import _build

    for p in prompts:
        eng.add_request(p, max_new=17)
    eng._admit()
    ms = event_ms(eng.step)
    _build.reset_launch_counts()
    prof = profile_step(eng, f"one decode chunk (8 steps x 8 slots, "
                             f"{eng.kv_dtype} pools, megakernel "
                             f"{eng.megakernel_rung}, {graph_tag(eng)})")
    chunk = _build.launch_counts()
    eng.run()
    return chunk, prof, ms


def profile_decode_lane(eng, prompts):
    """The unified step's decode lane alone: `prompts` prefill (a window
    a step) beside the live slots' decode, then two steps with no window
    left (decode chunks of the slots still live): the first timed with
    CUDA events, the second traced. The traced chunk's launches are
    counted apart and returned with its (wall ms, busy ms) and the first
    chunk's ms."""
    from paddle_tpu_torch.kernels import _build

    for p in prompts:
        eng.add_request(p)
    while eng.waiting or eng._prefilling is not None:
        eng.step()
    ms = event_ms(eng.step)
    _build.reset_launch_counts()
    prof = profile_step(eng, f"one decode chunk ({eng.n_active} live slots "
                             f"x 8 steps, no window, {eng.kv_dtype} pools, "
                             f"megakernel {eng.megakernel_rung}, "
                             f"{graph_tag(eng)})")
    chunk = _build.launch_counts()
    eng.run()
    return chunk, prof, ms


def warm_args(eng, traffic, shared: int = 0, grow: int = 0):
    """warm(buckets=, prefix_widths=) for `traffic` on `eng`'s geometry:
    every prompt's cold bucket and, with the prefix cache and a
    `shared`-token common head, every suffix bucket past it at the ladder
    rung of the shared pages; with `grow`, also the buckets of each prompt
    grown by up to `grow` tokens (a recovered request re-prefills its
    prompt and the tokens it was delivered)."""
    pb, bs = eng.prompt_bucket, eng.block_size
    lens = {len(p) + g for p in traffic for g in range(grow + 1)}
    buckets = {-(-n // pb) * pb for n in lens}
    widths = []
    if eng.prefix_cache and shared:
        buckets |= {-(-(n - shared) // pb) * pb for n in lens if n > shared}
        widths = [eng._prefix_width_for(shared // bs)]
    return sorted(buckets), widths


def warm_for(eng, traffic, shared: int = 0, tag: str = ""):
    """eng.warm(buckets=, prefix_widths=) for `traffic` (the JAX engine's
    rule: the buckets must cover the SUFFIX buckets cache hits prefill
    at): every prompt's cold bucket and, with the prefix cache and a
    `shared`-token common head, every suffix bucket past it at the ladder
    rung of the shared pages. On the unified path warm() ignores the
    buckets. Logs the prefill programs captured and the growth of the
    card's reserved memory across them."""
    buckets, widths = warm_args(eng, traffic, shared)
    # engines dropped earlier sit in reference cycles: free their graphs
    # first, so the growth is this engine's
    gc.collect()
    _release()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eng.warm(buckets=buckets, prefix_widths=widths)
    n = sum(1 for k in eng.compile_stats() if k.startswith("prefill:"))
    if n and tag:
        log(f"[{tag}] warm(buckets={buckets}, prefix_widths="
            f"{widths}): {n} prefill programs "
            f"({'graphs' if eng.graphed else 'eager'}) and the engine's "
            f"other programs in {time.perf_counter() - t0:.2f}s, reserved "
            f"memory +{(torch.cuda.memory_reserved() - reserved) / 2**20:.0f}"
            " MiB")
    return n


def programs(stats: dict) -> dict:
    """compile_stats() without the prefill programs' entries."""
    return {k: n for k, n in stats.items() if not k.startswith("prefill:")}


# the serving phases' shared engine settings
SERVE_KW = dict(slots=8, prompt_bucket=128, max_new_tokens=32, block_size=64,
                steps_per_sync=8, dtype=torch.bfloat16, device="cuda")


def build_engine(cfg, params, traffic, graphed: bool = True, shared: int = 0,
                 tag: str = "", **kw):
    """An engine at the serving phases' shared settings (8 slots,
    128-token prompt buckets, 32 new tokens, 64-token pages, 8-step
    chunks, bf16, on the card) overridden by `kw`, warmed for `traffic`
    (warm_for). With `graphed=False` every program, prefill programs
    included, runs its eager body on the card instead of replaying a
    CUDA graph: the yardstick the graphs are held to, and nothing the
    engine ever does on its own."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(cfg, params, **{**SERVE_KW, **kw})
    if not graphed:
        eng.graphed = False
    warm_for(eng, traffic, shared, tag)
    if graph_tag(eng) != ("graph" if graphed else "eager"):
        raise AssertionError(f"the decode chunk runs {graph_tag(eng)}")
    return eng


def serve_graph_and_eager(phase, cfg, params, traffic, profile,
                          shared: int = 0, **kw):
    """Serve `traffic` through `build_engine(cfg, params, traffic,
    shared=shared, **kw)` twice: replaying its CUDA graphs (the prefill
    programs' too), then eagerly. Gates: identical token streams and
    launch counts (each replay adds its capture's launches), and
    compile_stats() unchanged by the traffic. `profile(eng)` after each
    run returns (launches, (wall ms, busy ms), chunk ms). Logs both
    runs' tokens/s, prefill_s, chunk ms and busy share. Returns {True:
    graphed run, False: eager run}, each a namespace of reqs, wall,
    launches, m, chunk_ms (decode_s a chunk), chunk (the traced chunk's
    launches), prof, ev_ms."""
    runs = {}
    for graphed in (True, False):
        eng = build_engine(cfg, params, traffic, graphed, shared,
                           f"{phase}/{'graph' if graphed else 'eager'}",
                           **kw)
        stats = eng.compile_stats()
        reqs, wall, launches, m = serve(eng, traffic, f"{phase}/"
                                        f"{graph_tag(eng)}")
        if eng.compile_stats() != stats:
            raise AssertionError(f"{phase}: traffic grew compile_stats "
                                 f"{stats} -> {eng.compile_stats()}")
        chunk, prof, ev = profile(eng)
        runs[graphed] = SimpleNamespace(
            reqs=reqs, wall=wall, launches=launches, m=m,
            chunk_ms=1e3 * m["decode_s"] / max(m["device_steps"], 1),
            chunk=chunk, prof=prof, ev_ms=ev)
        del eng
        _release()
    g, e = runs[True], runs[False]
    eager_tokens = [r.tokens for r in e.reqs]
    if [r.tokens for r in g.reqs] != eager_tokens:
        raise AssertionError(f"{phase}: the graph-replayed engine's tokens "
                             f"differ from the eager engine's (match "
                             f"{_token_match(g.reqs, eager_tokens):.4f})")
    if g.launches != e.launches or g.chunk != e.chunk:
        raise AssertionError(f"{phase}: graph launches {g.launches} / "
                             f"chunk {g.chunk}, eager {e.launches} / "
                             f"{e.chunk}")
    n_tok = sum(len(r.tokens) for r in g.reqs)
    for tag, r in (("graph", g), ("eager", e)):
        wall_ms, busy = r.prof
        log(f"[{phase}] {tag}: {n_tok / r.wall:.1f} tok/s, prefill_s "
            f"{r.m['prefill_s']:.3f} s ({r.m['prefill_calls']} calls), "
            f"decode chunk "
            f"{r.ev_ms:.2f} ms (CUDA events; {r.chunk_ms:.2f} ms dispatch "
            f"to readback over the run), traced chunk busy {busy:.2f} of "
            f"{wall_ms:.2f} ms ({100 * busy / wall_ms:.1f}%), sync wait "
            f"{r.m['sync_wait_s']:.3f} s ({r.m['blocked_syncs']} blocked)")
    prefill = f"{e.m['prefill_s'] / g.m['prefill_s']:.2f}x" \
        if g.m["prefill_calls"] else "none (unified)"
    log(f"[{phase}] graph vs eager: tokens identical, launches equal; "
        f"chunk {e.ev_ms / g.ev_ms:.2f}x faster replayed, prefill "
        f"{prefill}")
    return runs


def profile_mixed(eng, short, long):
    """After the counted run: 4 short prompts prefill (one window each),
    then a long prompt's window rides beside their decode chunk; trace
    that mixed step. Its launches are not counted."""
    for p in short:
        eng.add_request(p)
    eng.add_request(long)
    while eng._prefilling is None or eng._prefilling["req"].prompt != long:
        if not eng.has_work:
            raise AssertionError("profile: the long prompt never prefilled")
        eng.step()
    profile_step(eng, f"one mixed step ({eng.n_active} live slots x 8 "
                      f"decode steps + one {eng.token_budget}-token window "
                      f"at cached {eng._prefilling['done']})")
    eng.run()


def _gate_ranks(phase: str, plain, reqs, limit: float = 0.5,
                margin_fn=rank_margin) -> float:
    """Every served token of `reqs` ranks within `limit` logit of the bf16
    plain forward's argmax (phase 2's rule: random bf16 weights make
    near-ties, so token identity is not the test): `margin_fn(plain, r)`
    per request. Returns the worst."""
    worst = 0.0
    for r in reqs:
        margin = margin_fn(plain, r)
        log(f"[{phase}] request {r.req_id} (prompt {len(r.prompt)}, cached "
            f"{r.cached_tokens}): served tokens' worst gap to the bf16 "
            f"plain argmax {margin:.3f}")
        worst = max(worst, margin)
    if worst > limit:
        raise AssertionError(f"{phase}: a served token ranks {worst:.3f} "
                             f"below the plain argmax (limit {limit})")
    return worst


def _gate_multiple(phase: str, launches, name: str, per: int) -> int:
    n = launches[name]
    if n <= 0 or n % per:
        raise AssertionError(f"{phase}: {n} {name} launches, expected a "
                             f"positive multiple of {per}")
    return n


# the system prompt prefix_traffic's prompts share (8 pages)
SHARED = 512


def prefix_traffic(cfg):
    """Phase 3's (and phase 5's) prompts: one shared 512-token system
    prompt (8 pages) plus 24 suffixes of 16-200 tokens."""
    rng = np.random.default_rng(SEED + 3)
    system = rng.integers(1, cfg.vocab_size, SHARED).tolist()
    return [system + rng.integers(1, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(16, 201, 24)]


def unified_traffic(cfg):
    """Phase 4's (and phase 6's) prompts: a long prompt first and 4 that
    share its first 512 tokens right after it, then 3 more long prompts
    (1200-2000 tokens) and 8 short cold ones (16-200)."""
    rng = np.random.default_rng(SEED + 4)

    def toks(n):
        return rng.integers(1, cfg.vocab_size, int(n)).tolist()

    longs = [toks(n) for n in rng.integers(1200, 2001, 4)]
    sharers = [longs[0][:512] + toks(n) for n in rng.integers(100, 701, 4)]
    shorts = [toks(n) for n in rng.integers(16, 201, 8)]
    return [longs[0]] + sharers + longs[1:] + shorts


def prefix_path_logits(eng, r, phase: str):
    """Logits of request `r`'s suffix rows through the prefix path: the
    suffix prefill over the cached prefix pages `eng` kept (its own pool
    dtype), at r's true suffix length. Returns [suffix, vocab] f32."""
    from paddle_tpu_torch.models.llama import (_make_head_logits,
                                               _make_prefill_with_prefix)

    bs, nc = eng.block_size, r.cached_tokens
    pages = eng.mgr.acquire_prefix(r.prompt, nc // bs, hashes=r.block_hashes)
    if len(pages) * bs != nc:
        raise AssertionError(f"{phase}: the cached pages were evicted")
    s = len(r.prompt) - nc
    sb = -(-s // eng.prompt_bucket) * eng.prompt_bucket
    ids = torch.zeros(1, sb, dtype=torch.long, device="cuda")
    ids[0, :s] = torch.tensor(r.prompt[nc:], device="cuda")
    with torch.no_grad():
        h, _ = _make_prefill_with_prefix(eng.cfg, 1, sb, len(pages), bs)(
            eng.p, eng.kcs, eng.vcs, ids,
            torch.tensor([pages], dtype=torch.int32, device="cuda"),
            torch.tensor([nc], dtype=torch.int32, device="cuda"),
            torch.tensor([s], dtype=torch.int32, device="cuda"))
        got = _make_head_logits(eng.cfg)(h[:, :s], eng.p)[0].float()
    eng.mgr.free(pages)
    return got


def phase_prefix_cache(cfg, params):
    """Phase 3: the split path with the prefix cache (the JAX engine's
    default configuration). 24 requests, each one shared 512-token system
    prompt (8 pages) plus its own suffix of 16-200 tokens, all submitted at
    once: the first batch prefills cold and inserts the shared pages, later
    batches prefill only their suffixes through prefix_prefill_attention.
    Every prefill is a program warmed for the traffic's buckets; the
    traffic is served replayed and eagerly (serve_graph_and_eager:
    identical tokens and launches, compile_stats() steady)."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    traffic = prefix_traffic(cfg)
    oracle = {}

    def profile(eng):
        if eng.graphed:
            # the prefix path's logits over the cached pages the replayed
            # engine kept: every suffix row of its first hit
            r = min((r for r in eng.finished if r.cached_tokens),
                    key=lambda r: r.req_id)
            oracle["r"], oracle["got"] = r, prefix_path_logits(eng, r,
                                                               "prefix")
        # phase 5 profiles the same chunk over int8 pools
        return profile_decode(eng, traffic[:8])

    g = serve_graph_and_eager("prefix", cfg, params, traffic, profile,
                              shared=SHARED, max_prompt_len=1024,
                              prefix_cache=True)[True]
    reqs, launches, m = g.reqs, g.launches, g.m
    if m["prefix_hit_tokens"] <= 0:
        raise AssertionError("prefix: no prompt token was served from the "
                             "prefix cache")
    _gate_multiple("prefix", launches, "prefix_prefill_attention",
                   cfg.num_hidden_layers)
    pool = {"kv_pool_bytes": m["kv_pool_bytes"],
            "n_cacheable_pages": m["n_cacheable_pages"]}
    hits = [r for r in reqs if r.cached_tokens]
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    _gate_ranks("prefix", plain, [hits[0], hits[-1]])

    # logits of the prefix path (suffix prefill over the cached pages the
    # engine kept) against an f32 plain forward, beside the bf16 plain
    # forward's error: every suffix position, the last of which picked
    # the first token
    r, got = oracle["r"], oracle["got"]
    nc = r.cached_tokens
    full = torch.tensor([r.prompt], device="cuda")
    with torch.no_grad():
        ref = plain(full)[0, nc:].float()
    params32 = {k: v.float() for k, v in params.items()}
    with torch.no_grad():
        ref32 = LlamaForCausalLM(cfg, use_kernels=False).load_params(
            params32)(full)[0, nc:]
    del params32
    oracle = {"req_id": r.req_id, "prompt": r.prompt, "ref": ref,
              "ref32": ref32}
    e_prefix, e_plain = rel_rms(got, ref32), rel_rms(ref, ref32)
    e_first = rel_rms(got[-1], ref32[-1])
    e_first_plain = rel_rms(ref[-1], ref32[-1])
    log(f"[prefix] request {r.req_id} (prompt {len(r.prompt)}, {nc} cached):"
        f" logits rel. RMS error vs the f32 plain forward, prefix path / "
        f"bf16 plain path: first-token row {e_first:.3e} / "
        f"{e_first_plain:.3e}, every suffix row {e_prefix:.3e} / "
        f"{e_plain:.3e}")
    # phase 2's rule: the kernel path no less accurate than the bf16
    # plain path (within 25%), on the first-token row and on all rows
    if not torch.isfinite(got).all() \
            or e_first > 1.25 * e_first_plain + 1e-3 \
            or e_prefix > 1.25 * e_plain + 1e-3:
        raise AssertionError(f"prefix: prefix-path logits error {e_first} "
                             f"(first token) / {e_prefix} vs bf16 plain "
                             f"{e_first_plain} / {e_plain}")
    return {"launches": launches, "tokens": [r.tokens for r in reqs],
            "oracle": oracle, "e_prefix": (e_first, e_prefix), **pool}


def phase_unified(cfg, params):
    """Phase 4: the unified step. 16 requests submitted at once: a long
    prompt first and 4 that share its first 512 tokens right after it (a
    prefix becomes visible only when its request's last window commits,
    and admission is FIFO), then 3 more long prompts (1200-2000 tokens,
    5-8 windows of 256) and 8 short cold ones (16-200)."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        cfg, params, slots=8, prompt_bucket=128, max_prompt_len=2048,
        max_new_tokens=32, block_size=64, steps_per_sync=8,
        prefix_cache=True, unified_step=True, token_budget=256,
        dtype=torch.bfloat16, device="cuda")
    eng.warm()
    reqs, wall, launches, m = serve(eng, unified_traffic(cfg), "unified")
    rng = np.random.default_rng(SEED + 5)

    def toks(n):
        return rng.integers(1, cfg.vocab_size, int(n)).tolist()

    n = launches["ragged_paged_attention"]
    if m["prefill_chunks"] <= 16:
        raise AssertionError(f"unified: {m['prefill_chunks']} prefill "
                             "windows, expected more than 16")
    if m["prefix_hit_tokens"] <= 0:
        raise AssertionError("unified: no prompt token was served from the "
                             "prefix cache")
    if n != cfg.num_hidden_layers * m["prefill_chunks"]:
        raise AssertionError(f"unified: {n} ragged_paged_attention launches "
                             f"for {m['prefill_chunks']} windows")
    # fresh prompts: the served ones would now hit the prefix cache
    profile_mixed(eng, [toks(n) for n in (100, 150, 40, 200)], toks(1500))
    del eng
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    hit = next(r for r in reqs if r.cached_tokens)
    _gate_ranks("unified", plain, [reqs[0], hit])
    return {"launches": launches, "tokens": [r.tokens for r in reqs]}


def phase_int8_split(cfg, params, bf16):
    """Phase 5: int8 KV pools on the split path with the prefix cache,
    over phase 3's traffic, the pool sized by a byte budget equal to
    phase 3's bf16 pool bytes (so it holds about twice the pages). Gates:
    every request returns 32 tokens, int8 decode and cache-hit prefill
    launches are positive multiples of the layer count and no bf16
    paged-attention kernel runs (serve), served tokens rank within
    INT8_RANK_MARGIN of the bf16 plain argmax. Prints, without gating,
    the token-match rate against phase 3's bf16 tokens."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        cfg, params, slots=8, prompt_bucket=128, max_prompt_len=1024,
        max_new_tokens=32, block_size=64, steps_per_sync=8,
        prefix_cache=True, kv_cache_dtype="int8",
        kv_pool_bytes=bf16["kv_pool_bytes"], dtype=torch.bfloat16,
        device="cuda")
    warm_for(eng, prefix_traffic(cfg), SHARED, "int8-split")
    reqs, wall, launches, m = serve(eng, prefix_traffic(cfg), "int8-split")
    if m["prefix_hit_tokens"] <= 0:
        raise AssertionError("int8-split: no prompt token was served from "
                             "the prefix cache")
    L = cfg.num_hidden_layers
    _gate_multiple("int8-split", launches, "paged_decode_attention_int8", L)
    _gate_multiple("int8-split", launches, "prefix_prefill_attention_int8",
                   L)
    log(f"[int8-split] pools at kv_pool_bytes={bf16['kv_pool_bytes']} "
        f"(phase 3's bf16 bytes): int8 {m['kv_pool_bytes']} bytes, "
        f"{m['n_cacheable_pages']} cacheable pages against bf16's "
        f"{bf16['n_cacheable_pages']} "
        f"({m['n_cacheable_pages'] / bf16['n_cacheable_pages']:.3f}x)")
    same = total = first = 0
    for r, theirs in zip(reqs, bf16["tokens"]):
        same += sum(a == b for a, b in zip(r.tokens, theirs))
        total += len(theirs)
        first += r.tokens[0] == theirs[0]
    log(f"[int8-split] token match vs phase 3 (bf16 pools, same traffic): "
        f"{same}/{total} = {same / total:.4f}; first tokens {first}/"
        f"{len(reqs)}")
    # accuracy where no token choice intervenes: the int8 prefix path's
    # logits for phase 3's checked request against phase 3's f32 and
    # bf16 plain forwards (printed, not gated)
    o = bf16["oracle"]
    r = reqs[o["req_id"]]
    if r.prompt != o["prompt"] or not r.cached_tokens:
        raise AssertionError("int8-split: phase 3's checked request was "
                             "not a cache hit here")
    got = prefix_path_logits(eng, r, "int8-split")
    ref32 = o["ref32"]
    e_first, e_all = rel_rms(got[-1], ref32[-1]), rel_rms(got, ref32)
    log(f"[int8-split] request {r.req_id} ({r.cached_tokens} cached): "
        f"logits rel. RMS error vs the f32 plain forward, int8 prefix path "
        f"/ bf16 prefix path (phase 3) / bf16 plain path: first-token row "
        f"{e_first:.3e} / {bf16['e_prefix'][0]:.3e} / "
        f"{rel_rms(o['ref'][-1], ref32[-1]):.3e}, every suffix row "
        f"{e_all:.3e} / {bf16['e_prefix'][1]:.3e} / "
        f"{rel_rms(o['ref'], ref32):.3e}; int8 vs bf16 plain max |diff| "
        f"{float((got - o['ref']).abs().max()):.3f}")
    profile_decode(eng, prefix_traffic(cfg)[:8])
    del eng
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    hits = [r for r in reqs if r.cached_tokens]
    worst = _gate_ranks("int8-split", plain, [hits[0], hits[-1]],
                        INT8_RANK_MARGIN)
    return {"launches": launches, "worst_margin": worst,
            "match_rate": same / total}


def phase_int8_unified(cfg, params):
    """Phase 6: int8 KV pools on the unified step, over phase 4's traffic:
    windows through the int8 ragged kernel (one launch per layer per
    window) beside the int8 decode lane; phase 5's gates."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        cfg, params, slots=8, prompt_bucket=128, max_prompt_len=2048,
        max_new_tokens=32, block_size=64, steps_per_sync=8,
        prefix_cache=True, unified_step=True, token_budget=256,
        kv_cache_dtype="int8", dtype=torch.bfloat16, device="cuda")
    eng.warm()
    reqs, wall, launches, m = serve(eng, unified_traffic(cfg),
                                    "int8-unified")
    L = cfg.num_hidden_layers
    if m["prefill_chunks"] <= 16 or m["prefix_hit_tokens"] <= 0:
        raise AssertionError(f"int8-unified: {m['prefill_chunks']} windows, "
                             f"{m['prefix_hit_tokens']} cache-hit tokens")
    _gate_multiple("int8-unified", launches, "paged_decode_attention_int8", L)
    n = _gate_multiple("int8-unified", launches,
                       "ragged_paged_attention_int8", L)
    if n != L * m["prefill_chunks"]:
        raise AssertionError(f"int8-unified: {n} int8 ragged launches for "
                             f"{m['prefill_chunks']} windows")
    del eng
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    hit = next(r for r in reqs if r.cached_tokens)
    worst = _gate_ranks("int8-unified", plain, [reqs[0], hit],
                        INT8_RANK_MARGIN)
    return {"launches": launches, "worst_margin": worst}


# ---------------------------------------------------------------------------
# phases 7-9: weight-only quantized serving
# ---------------------------------------------------------------------------

def dense_oracle(params, quant):
    """The plain forward's weights: every weight-only pair dequantized to
    bf16 (weight_dequantize: q * scale in f32, rounded once), the rest as
    is. The served matmul sums x * q in f32 and scales the sum; the oracle
    rounds q * scale to bf16 first, a bf16 rounding of each weight, the
    same function to bf16 accuracy."""
    from paddle_tpu_torch.nn.quant import weight_dequantize

    return {k: weight_dequantize(*v, algo=quant, out_dtype=torch.bfloat16)
            if isinstance(v, tuple) else v for k, v in params.items()}


def plain_over(cfg, params, quant):
    from paddle_tpu_torch.models import LlamaForCausalLM

    return LlamaForCausalLM(cfg, use_kernels=False).load_params(
        dense_oracle(params, quant))


def _release():
    """Return the memory of tensors the caller just dropped to the card
    (each phase frees its dequantized oracle weights before the next)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _quant_launch_gates(phase, launches, name):
    """A weight-only phase's matmuls: decode through the GEMV kernel
    `name`, prefills (M > 64 rows) through its large-M route, and nothing
    through the other format's."""
    other = "int8_weight_matmul" if name == "int4_matmul" else "int4_matmul"
    if launches[name] <= 0 or launches[name + "_large_m"] <= 0 \
            or launches[other] or launches[other + "_large_m"]:
        raise AssertionError(f"{phase}: weight-only matmul launches "
                             f"{launches}")


def phase_int4_split(cfg):
    """Phase 7: weight-only int4 params made on the card by
    init_quant_serving_params (no bf16 projection exists), served on the
    split path with the prefix cache over phase 3's traffic (bf16 pools).
    Gates: every request returns 32 in-vocabulary tokens; the decode
    matmuls launch the int4 GEMV and the prefills its large-M route; one
    decode chunk profiled alone launches the GEMV exactly 225 times per
    step (7 x 32 layers + lm_head) and the large-M route never; served
    tokens rank within 0.5 logit of the plain forward over the same
    weights dequantized to bf16. The prefills are programs warmed for the
    traffic's buckets, and the traffic is served replayed and eagerly
    (serve_graph_and_eager)."""
    from paddle_tpu_torch.models import init_quant_serving_params

    quant = "weight_only_int4"
    t0 = time.perf_counter()
    params = init_quant_serving_params(cfg, quant, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    dense = [k for k, v in params.items() if not isinstance(v, tuple)
             and (k.endswith("_proj.weight") or k == "lm_head.weight")]
    if dense:
        raise AssertionError(f"int4-split: dense projections {dense[:3]}")
    n_bytes = sum(t.numel() * t.element_size() for v in params.values()
                  for t in (v if isinstance(v, tuple) else (v,)))
    log(f"[int4-split] Llama-3-8B int4 weight-only params on card in "
        f"{time.perf_counter() - t0:.1f}s: {n_bytes / 1e9:.3f} GB "
        f"(projections and lm_head packed int4 + f32 scales, embedding and "
        f"norms bf16)")
    traffic = prefix_traffic(cfg)
    g = serve_graph_and_eager(
        "int4-split", cfg, params, traffic,
        lambda eng: profile_decode(eng, traffic[:8]), shared=SHARED,
        max_prompt_len=1024, prefix_cache=True)[True]
    reqs, launches, m, chunk, ev_ms = g.reqs, g.launches, g.m, g.chunk, \
        g.ev_ms
    if m["prefix_hit_tokens"] <= 0:
        raise AssertionError("int4-split: no prompt token was served from "
                             "the prefix cache")
    _quant_launch_gates("int4-split", launches, "int4_matmul")
    per_step = MATMULS_PER_LAYER * cfg.num_hidden_layers + 1
    steps = 8       # build_engine's steps_per_sync
    if chunk["int4_matmul"] != per_step * steps \
            or chunk["int4_matmul_large_m"]:
        raise AssertionError(f"int4-split: one decode chunk of {steps} "
                             f"steps launched {chunk['int4_matmul']} int4 "
                             f"GEMVs (expected {per_step * steps}) and "
                             f"{chunk['int4_matmul_large_m']} large-M "
                             "matmuls (expected 0)")
    log(f"[int4-split] one decode chunk: {chunk['int4_matmul']} int4 GEMV "
        f"launches ({per_step} per step), 0 large-M; {ev_ms:.2f} ms by CUDA "
        f"events (graph)")
    plain = plain_over(cfg, params, quant)
    hits = [r for r in reqs if r.cached_tokens]
    worst = _gate_ranks("int4-split", plain, [hits[0], hits[-1]])
    del plain
    _release()
    return {"launches": launches, "params": params, "worst_margin": worst,
            "chunk": chunk}


def int8w_unified_engine(cfg, params8):
    """Phase 8's engine (int8 KV pools, the unified step, 256-token
    windows) over the weight-only int8 params `params8`, warmed; phase 20
    serves the loaded checkpoint through the same one."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        cfg, params8, slots=8, prompt_bucket=128, max_prompt_len=2048,
        max_new_tokens=32, block_size=64, steps_per_sync=8,
        prefix_cache=True, unified_step=True, token_budget=256,
        kv_cache_dtype="int8", dtype=torch.bfloat16, device="cuda")
    eng.warm()
    return eng


def phase_int8w_unified(cfg, params):
    """Phase 8: weight-only int8 params from decode_params over the bf16
    params, int8 KV pools, the unified step over phase 4's traffic.
    Phase 6's gates (windows, cache hits, int8 decode and ragged launches
    per layer and window), the int8 GEMV on decode and its large-M route
    on the windows, and served tokens within INT8_RANK_MARGIN of the plain
    forward over the int8 weights dequantized to bf16 (the plain forward
    reads no quantized cache). Then one decode chunk of the decode lane
    alone is traced (its launches apart)."""
    from paddle_tpu_torch.models import decode_params

    quant, phase = "weight_only_int8", "int8w-int8kv-unified"
    params8 = decode_params(params, quant)
    eng = int8w_unified_engine(cfg, params8)
    reqs, wall, launches, m = serve(eng, unified_traffic(cfg), phase)
    L = cfg.num_hidden_layers
    if m["prefill_chunks"] <= 16 or m["prefix_hit_tokens"] <= 0:
        raise AssertionError(f"{phase}: {m['prefill_chunks']} windows, "
                             f"{m['prefix_hit_tokens']} cache-hit tokens")
    _gate_multiple(phase, launches, "paged_decode_attention_int8", L)
    n = _gate_multiple(phase, launches, "ragged_paged_attention_int8", L)
    if n != L * m["prefill_chunks"]:
        raise AssertionError(f"{phase}: {n} int8 ragged launches for "
                             f"{m['prefill_chunks']} windows")
    _quant_launch_gates(phase, launches, "int8_weight_matmul")
    chunk, _, ev_ms = profile_decode_lane(eng, unified_traffic(cfg)[-8:])
    log(f"[{phase}] one decode chunk: {chunk['int8_weight_matmul']} int8 "
        f"GEMV launches, {chunk['int8_weight_matmul_large_m']} large-M; "
        f"{ev_ms:.2f} ms by CUDA events ({graph_tag(eng)})")
    del eng
    plain = plain_over(cfg, params8, quant)
    hit = next(r for r in reqs if r.cached_tokens)
    worst = _gate_ranks(phase, plain, [reqs[0], hit], INT8_RANK_MARGIN)
    del plain, params8
    _release()
    return {"launches": launches, "worst_margin": worst,
            "tokens": [r.tokens for r in reqs]}


def quant_generate(cfg, params, quant, phase, attention):
    """build_quant_generate(b=8, sb=512, max_new=32), greedy, over 8
    prompts of 448 tokens (s0 = 448, so max_seq = 1024), with the launch
    counts reset just before and read just after. Gates: 8 x 32
    in-vocabulary tokens; `attention` launched once per layer and decode
    step (31 steps); the weight-only GEMV 31 times per step's matmuls
    plus once (the first token's lm_head, M = 8); the large-M route
    exactly once per prefill matmul (M = 4096); tokens rank within 0.5
    logit of the plain forward over the weights dequantized to bf16.
    Also times the prefill alone (max_new = 1) for a per-step figure."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import build_quant_generate

    b, sb, s0, max_new = 8, 512, 448, 32
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(1, cfg.vocab_size, s0).tolist()
               for _ in range(b)]
    ids = torch.zeros(b, sb, dtype=torch.long, device="cuda")
    ids[:, :s0] = torch.tensor(prompts, device="cuda")
    run = build_quant_generate(cfg, b=b, sb=sb, max_new=max_new)
    first = build_quant_generate(cfg, b=b, sb=sb, max_new=1)
    with torch.no_grad():
        first(params, ids, s0)                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first(params, ids, s0)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        toks = run(params, ids, s0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    gemv = "int4_matmul" if quant == "weight_only_int4" \
        else "int8_weight_matmul"
    L, steps = cfg.num_hidden_layers, max_new - 1
    per_step = MATMULS_PER_LAYER * L + 1
    want = {attention: L * steps, gemv: per_step * steps + 1,
            gemv + "_large_m": MATMULS_PER_LAYER * L}
    other = ({"decode_attention", "gqa_decode_attention"} - {attention}).pop()
    if any(launches[k] != v for k, v in want.items()) or launches[other] \
            or tuple(toks.shape) != (b, max_new) \
            or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{phase}: tokens {tuple(toks.shape)}, "
                             f"launches {launches}, expected {want}")
    step_ms = 1e3 * (wall - prefill_s) / steps
    log(f"[{phase}] {b} x {max_new} tokens in {wall:.3f}s "
        f"({b * max_new / wall:.1f} tok/s); prefill + first token "
        f"{prefill_s:.3f}s; decode {step_ms:.2f} ms per step of {b} rows; "
        f"launches {json.dumps(launches)}")
    profile_quant_step(cfg, params, b, s0)
    plain = plain_over(cfg, params, quant)
    reqs = [SimpleNamespace(req_id=i, prompt=prompts[i],
                            tokens=toks[i].tolist(), cached_tokens=0)
            for i in (0, b - 1)]
    worst = _gate_ranks(phase, plain, reqs)
    del plain
    _release()
    return {"launches": launches, "worst_margin": worst, "wall_s": wall,
            "step_ms": step_ms}


def profile_quant_step(cfg, params, b: int, pos: int, max_seq: int = 1024):
    """Trace one decode step of the quant-only program (the contiguous
    caches at position `pos`, contents irrelevant to the time), after the
    counted run; its launches are not counted."""
    from paddle_tpu_torch.models.llama import _make_decode_step

    shape = (b, cfg.num_key_value_heads, max_seq, cfg.head_dim)
    kcs, vcs = ([torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
                 for _ in range(cfg.num_hidden_layers)] for _ in range(2))
    step = _make_decode_step(cfg, b, max_seq)
    tok = torch.ones(b, 1, dtype=torch.long, device="cuda")
    with torch.no_grad():
        step(params, kcs, vcs, tok, pos)                  # warm-up
        profile_call(lambda: step(params, kcs, vcs, tok, pos),
                     f"one quant-generate decode step ({b} rows at "
                     f"position {pos})")
    del kcs, vcs
    _release()


def phase_quant_generate_7b():
    """Phase 9b: the quant-only program on Llama-2-7B widths cut to 2
    layers (equal heads: 32 q and 32 kv heads) with int8 weights, so the
    equal-heads contiguous decode (decode_attention) runs on a served
    path."""
    from paddle_tpu_torch.models import LlamaConfig, init_quant_serving_params

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2)
    quant = "weight_only_int8"
    params = init_quant_serving_params(cfg, quant, seed=SEED, device="cuda")
    out = quant_generate(cfg, params, quant, "quant-generate-7b",
                         "decode_attention")
    del params
    _release()
    return out


# ---------------------------------------------------------------------------
# phases 10-12: the decode megakernel ladder
# ---------------------------------------------------------------------------

def _gate_exact(phase: str, launches, name: str, want: int) -> None:
    if launches[name] != want:
        raise AssertionError(f"{phase}: {launches[name]} {name} launches, "
                             f"expected {want}: {launches}")


def _token_match(reqs, theirs) -> float:
    same = sum(a == b for r, t in zip(reqs, theirs)
               for a, b in zip(r.tokens, t))
    return same / sum(len(t) for t in theirs)


def _serve_rung(cfg, params, rung: str, phase: str, traffic, **kw):
    """The engine at megakernel rung `rung` over `traffic`, replayed and
    eager (serve_graph_and_eager): the graphed run (reqs, launches, m,
    chunk_ms, chunk, prof, ev_ms)."""
    g = serve_graph_and_eager(
        f"{phase}/{rung}", cfg, params, traffic,
        lambda eng: profile_decode(eng, traffic[:8]),
        decode_megakernel=rung, **kw)[True]
    if g.m["megakernel_rung"] != rung:
        raise AssertionError(f"{phase}: planned rung "
                             f"{g.m['megakernel_rung']}, asked for {rung}")
    return g


def phase_mega_scan(cfg, params):
    """Phase 10: the main path of the megakernel slice. Llama-3-8B over
    decode_params(params, "weight_only_int8") (phase 8's weights), bf16
    pools, the split path with the prefix cache, phase 3's traffic: first
    at decode_megakernel="off", then "scan", then "full", in this call.
    Gates for scan: the planned rung is scan; one decode_layers_megakernel
    launch per decode step (and exactly 8 in one profiled chunk); no
    paged_decode_attention launch; cache hits still prefill through
    prefix_prefill_attention over the layer-major pool's offset tables;
    served tokens rank within 0.5 logit of the plain forward over the
    dequantized weights. Full: 32 decode_layer_megakernel_full launches
    per decode step. Every rung also serves eagerly, to the same tokens
    and launches (serve_graph_and_eager). Logs each rung's decode-chunk
    wall, busy share and token match against off."""
    from paddle_tpu_torch.models import decode_params

    quant, phase = "weight_only_int8", "mega-scan"
    params8 = decode_params(params, quant)
    traffic = prefix_traffic(cfg)
    kw = dict(max_prompt_len=1024, prefix_cache=True, shared=SHARED)
    L, out = cfg.num_hidden_layers, {}
    for rung in ("off", "scan", "full"):
        out[rung] = _serve_rung(cfg, params8, rung, phase, traffic, **kw)
    g = out["scan"]
    reqs, launches, m, chunk = g.reqs, g.launches, g.m, g.chunk
    steps = m["device_steps"] * 8
    _gate_exact(phase, launches, "decode_layers_megakernel", steps)
    _gate_exact(phase, chunk, "decode_layers_megakernel", 8)
    if launches["paged_decode_attention"] or chunk["paged_decode_attention"]:
        raise AssertionError(f"{phase}: the scan rung launched the "
                             f"multi-kernel decode: {launches}")
    if m["prefix_hit_tokens"] <= 0:
        raise AssertionError(f"{phase}: no cache hit")
    _gate_multiple(phase, launches, "prefix_prefill_attention", L)
    f = out["full"]
    f_reqs, f_launches = f.reqs, f.launches
    _gate_exact(phase, f_launches, "decode_layer_megakernel_full",
                f.m["device_steps"] * 8 * L)
    _gate_exact(phase, f.chunk, "decode_layer_megakernel_full", 8 * L)
    off_tokens = [r.tokens for r in out["off"].reqs]
    for rung, o in out.items():
        wall_ms, busy = o.prof
        log(f"[{phase}] rung {rung}: decode chunks {o.m['device_steps']} at "
            f"{o.chunk_ms:.2f} ms each ({o.ev_ms:.2f} ms by CUDA events); "
            f"profiled chunk wall {wall_ms:.2f} ms, busy {busy:.2f} ms "
            f"({100 * busy / wall_ms:.1f}%); token match vs off "
            f"{_token_match(o.reqs, off_tokens):.4f}")
    plain = plain_over(cfg, params8, quant)
    hits = [r for r in reqs if r.cached_tokens]
    worst = _gate_ranks(phase, plain, [hits[0], hits[-1]])
    worst_full = _gate_ranks(phase + "/full", plain, [f_reqs[0]])
    del plain, params8
    _release()
    return {"launches": launches, "full_launches": f_launches,
            "worst_margin": max(worst, worst_full),
            "rungs": {rung: {"chunk_ms": o.chunk_ms, "profile": o.prof}
                      for rung, o in out.items()}}


def phase_mega_full(cfg, params, yardstick):
    """Phase 11: phase 8's configuration (int8 weights, int8 pools, the
    unified step, phase 4's traffic) at decode_megakernel="full". Gates:
    the int8 full kernel 32 times per decode step (exactly 256 in one
    profiled chunk), no multi-kernel int8 decode, windows through the int8
    ragged kernel; served tokens within INT8_RANK_MARGIN of the plain
    forward over the dequantized weights; the eager engine's tokens and
    launches. Phase 8 is the yardstick."""
    from paddle_tpu_torch.models import decode_params

    quant, phase = "weight_only_int8", "mega-full"
    params8 = decode_params(params, quant)
    L = cfg.num_hidden_layers
    g = _serve_rung(cfg, params8, "full", phase, unified_traffic(cfg),
                    max_prompt_len=2048, prefix_cache=True,
                    unified_step=True, token_budget=256,
                    kv_cache_dtype="int8")
    reqs, launches, chunk_ms, chunk = g.reqs, g.launches, g.chunk_ms, g.chunk
    wall_ms, busy = g.prof
    n = _gate_multiple(phase, launches, "decode_layer_megakernel_full_int8",
                       8 * L)
    _gate_exact(phase, chunk, "decode_layer_megakernel_full_int8", 8 * L)
    if launches["paged_decode_attention_int8"]:
        raise AssertionError(f"{phase}: multi-kernel decode launched")
    _gate_multiple(phase, launches, "ragged_paged_attention_int8", L)
    log(f"[{phase}] {n // (8 * L)} decode chunks through the full rung "
        f"at {chunk_ms:.2f} ms each; "
        f"profiled chunk wall {wall_ms:.2f} ms, busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%); token match vs phase 8 "
        f"{_token_match(reqs, yardstick['tokens']):.4f}")
    plain = plain_over(cfg, params8, quant)
    hit = next(r for r in reqs if r.cached_tokens)
    worst = _gate_ranks(phase, plain, [reqs[0], hit], INT8_RANK_MARGIN)
    del plain, params8
    _release()
    return {"launches": launches, "worst_margin": worst}


def phase_mega_attn(cfg, params, yardstick):
    """Phase 12: bf16 dense weights and bf16 pools on the cold split path
    (prefix_cache=False), phase 2's traffic, decode_megakernel="attn" (a
    rung the JAX package refuses at this width for its TPU VMEM budget).
    Gates: 32 decode_layer_megakernel launches per decode step (exactly
    256 in one profiled chunk), no paged_decode_attention; served tokens
    within 0.5 logit of the bf16 plain forward; the eager engine's tokens
    and launches. Phase 2 is the yardstick."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    phase, L = "mega-attn", cfg.num_hidden_layers
    g = _serve_rung(cfg, params, "attn", phase, engine_traffic(cfg),
                    **ENGINE_KW)
    reqs, launches, m, chunk_ms, chunk = (g.reqs, g.launches, g.m,
                                          g.chunk_ms, g.chunk)
    wall_ms, busy = g.prof
    _gate_exact(phase, launches, "decode_layer_megakernel",
                m["device_steps"] * 8 * L)
    _gate_exact(phase, chunk, "decode_layer_megakernel", 8 * L)
    if launches["paged_decode_attention"]:
        raise AssertionError(f"{phase}: multi-kernel decode launched")
    log(f"[{phase}] decode chunks at {chunk_ms:.2f} ms (phase 2: "
        f"{yardstick['chunk_ms']:.2f} ms); profiled chunk wall {wall_ms:.2f} "
        f"ms, busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%)")
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    worst = _gate_ranks(phase, plain, [reqs[0], reqs[-1]])
    del plain
    _release()
    return {"launches": launches, "worst_margin": worst}


# ---------------------------------------------------------------------------
# phases 15-18: speculative decoding and disaggregation
# ---------------------------------------------------------------------------

def spec_traffic(cfg):
    """The speculative phases' prompts (the JAX smoke's `_smoke_prompts`
    shape at Llama-3's vocabulary): 16 prompts, each a random head of 2-4
    tokens and one random 8-token phrase repeated to 256-448 tokens."""
    rng = np.random.default_rng(SEED + 15)
    phrase = rng.integers(1, cfg.vocab_size, 8).tolist()
    out = []
    for i in range(16):
        head = rng.integers(1, cfg.vocab_size, 2 + i % 3).tolist()
        n = int(rng.integers(256, 449))
        out.append(head + (phrase * (n // 8 + 1))[:n - len(head)])
    return out


def profile_spec(eng, prompts):
    """After the counted run: `prompts` (17 new tokens each) admitted and
    one speculative step taken; then the verify window of that step timed
    by CUDA events (its program replayed, or its body run eagerly, on the
    step's inputs: the same K/V rewritten in place) and the next step
    traced. The traced step's launches are counted apart and returned with
    its (wall ms, busy ms) and the window's ms."""
    from paddle_tpu_torch.kernels import _build

    for p in prompts:
        eng.add_request(p, max_new=17)
    eng.step()
    ms = event_ms(eng._programs["verify"])
    _build.reset_launch_counts()
    prof = profile_step(eng, f"one speculative step ({eng.n_active} live "
                             f"slots, spec_k {eng.spec_k}, {eng.kv_dtype} "
                             f"pools, {graph_tag(eng)})")
    step = _build.launch_counts()
    eng.run()
    return step, prof, ms


def _spec_log(phase, reqs, wall, m, off=None):
    """One line of a speculative run's numbers: tok/s, acceptance, tokens
    a verify step (decode tokens over verify dispatches; on the split
    path only, where every token after the first comes from a verify
    step: the unified step's mixed steps decode too), sync wait; with
    `off`, the spec-off yardstick's beside them. Returns (tok/s, tokens a
    verify step or None)."""
    n_tok = sum(len(r.tokens) for r in reqs)
    line = (f"[{phase}] {n_tok / wall:.1f} tok/s; {m['spec_steps']} verify "
            f"steps, acceptance {m['acceptance_rate']:.4f} "
            f"({m['spec_accepted']} of {m['spec_drafted']} drafts), ")
    per = None
    if not m["unified_step"]:
        dec = n_tok - len(reqs)          # every token after the first
        per = dec / max(m["spec_steps"], 1)
        # a slot's window commits its accepted drafts plus one token
        line += (f"{per:.3f} tokens a verify step "
                 f"({dec / max(dec - m['spec_accepted'], 1):.3f} a slot's "
                 f"window), ")
    line += (f"spec_k_effective {m['spec_k_effective']}; sync wait "
             f"{m['sync_wait_s']:.3f} s ({m['blocked_syncs']} blocked); "
             f"decode {m['decode_s']:.3f} s, prefill {m['prefill_s']:.3f} s")
    if off is not None:
        line += (f"; spec-off {off['tok_s']:.1f} tok/s, sync wait "
                 f"{off['m']['sync_wait_s']:.3f} s, decode "
                 f"{off['m']['decode_s']:.3f} s")
    log(line)
    return n_tok / wall, per


def _gate_spec_launches(phase, launches, m, name, L, windows=0):
    """The verify window runs the ragged kernel once a layer: exactly
    L x (verify steps + unified prefill windows) launches of `name`."""
    _gate_exact(phase, launches, name, L * (m["spec_steps"] + windows))


def phase_spec_ngram(cfg, params):
    """Phase 15: speculative decoding with the n-gram drafter. Dense bf16
    weights, bf16 pools, the split path with the prefix cache, spec_k 4,
    16 repetitive prompts (spec_traffic), 32 new tokens each. The same
    traffic first with speculation off (the yardstick), then speculating,
    replayed and again eagerly (serve_graph_and_eager: identical tokens and
    launches, compile_stats() unchanged by traffic). Gates: ragged
    launches exactly 32 a verify step, served tokens within 0.5 logit of
    the bf16 plain forward. Logs tok/s on and off, acceptance, tokens a
    verify, the verify window's ms beside the spec-off decode step's (a
    chunk's CUDA-event ms / 8), sync wait."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    phase, L = "spec-ngram", cfg.num_hidden_layers
    traffic = spec_traffic(cfg)
    kw = dict(max_prompt_len=512, prefix_cache=True)
    eng = build_engine(cfg, params, traffic, **kw)
    reqs, wall, _, m = serve(eng, traffic, f"{phase}/off")
    _, _, off_chunk_ms = profile_decode(eng, traffic[:8])
    off = {"tok_s": sum(len(r.tokens) for r in reqs) / wall, "m": m,
           "tokens": [r.tokens for r in reqs]}
    del eng
    _release()
    runs = serve_graph_and_eager(
        phase, cfg, params, traffic, lambda e: profile_spec(e, traffic[:8]),
        speculative="ngram", spec_k=4, **kw)
    g = runs[True]
    reqs, launches, m = g.reqs, g.launches, g.m
    if programs(m["compile_stats"]) != {"decode": 1, "verify": 1}:
        raise AssertionError(f"{phase}: compile_stats {m['compile_stats']}")
    # no acceptance floor: on random weights the served tokens rarely
    # recur in a prompt, so the n-gram drafter rarely proposes anything
    if m["spec_steps"] <= 0:
        raise AssertionError(f"{phase}: no verify step")
    _gate_spec_launches(phase, launches, m, "ragged_paged_attention", L)
    _gate_exact(phase, g.chunk, "ragged_paged_attention", L)
    tok_s, per = _spec_log(phase, reqs, g.wall, m, off)
    log(f"[{phase}] verify window {g.ev_ms:.3f} ms (CUDA events; eager "
        f"{runs[False].ev_ms:.3f} ms) vs the spec-off decode step "
        f"{off_chunk_ms / 8:.3f} ms (a chunk {off_chunk_ms:.2f} ms / 8); "
        f"token match vs spec-off {_token_match(reqs, off['tokens']):.4f}")
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    worst = _gate_ranks(phase, plain, [reqs[0], reqs[-1]])
    del plain
    _release()
    return {"launches": launches, "tok_s": tok_s, "off_tok_s": off["tok_s"],
            "acceptance": m["acceptance_rate"], "per_verify": per,
            "verify_ms": g.ev_ms, "step_ms": off_chunk_ms / 8,
            "worst_margin": worst}


def phase_spec_self(cfg, params):
    """Phase 16: the draft-model drafter on the target itself. bf16
    weights, int8 pools, the split path with the prefix cache, spec_k 4;
    DraftModelDrafter over the target's own config and params (bf16 draft
    pools), so a draft is the decode step's argmax and acceptance measures
    how often the verify window agrees with it. 8 of phase 15's prompts.
    Gates: served tokens within INT8_RANK_MARGIN of the bf16 plain forward,
    acceptance_rate >= 0.2 (a wrong window position or scatter gives
    about 0), compile_stats() {decode, verify, draft} unchanged by
    traffic, ragged int8 launches exactly 32 a verify step. Logs
    acceptance, tok/s and the draft program's ms (its last dispatch
    replayed, CUDA events)."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import DraftModelDrafter

    phase, L = "spec-self", cfg.num_hidden_layers
    eng = build_engine(cfg, params, spec_traffic(cfg)[:8],
                       max_prompt_len=512, prefix_cache=True,
                       kv_cache_dtype="int8", speculative="draft", spec_k=4,
                       drafter=DraftModelDrafter(cfg, params))
    stats = eng.compile_stats()
    if programs(stats) != {"decode": 1, "verify": 1, "draft": 1}:
        raise AssertionError(f"{phase}: compile_stats {stats}")
    reqs, wall, launches, m = serve(eng, spec_traffic(cfg)[:8], phase)
    if eng.compile_stats() != stats:
        raise AssertionError(f"{phase}: traffic grew compile_stats {stats} "
                             f"-> {eng.compile_stats()}")
    _gate_spec_launches(phase, launches, m, "ragged_paged_attention_int8", L)
    tok_s, per = _spec_log(phase, reqs, wall, m)
    if m["acceptance_rate"] < 0.2:
        raise AssertionError(f"{phase}: acceptance {m['acceptance_rate']} "
                             "below 0.2")
    draft_ms = event_ms(eng._drafter._prog)
    verify_ms = event_ms(eng._programs["verify"])
    log(f"[{phase}] draft program ({eng._drafter.m} decode steps x 8 rows) "
        f"{draft_ms:.3f} ms, verify window {verify_ms:.3f} ms (CUDA events, "
        f"last dispatches replayed; {graph_tag(eng)})")
    del eng
    _release()
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    worst = _gate_ranks(phase, plain, [reqs[0], reqs[-1]], INT8_RANK_MARGIN)
    del plain
    _release()
    return {"launches": launches, "tok_s": tok_s,
            "acceptance": m["acceptance_rate"], "per_verify": per,
            "draft_ms": draft_ms, "verify_ms": verify_ms,
            "worst_margin": worst}


def phase_spec_scan_unified(cfg, params):
    """Phase 17: speculation on the scan rung's unified step. int8 weights
    (decode_params), decode_megakernel="scan", unified_step over phase 4's
    traffic, double_buffer=True, spec_adaptive=True, spec_k 4; the drafter
    a DraftModelDrafter of Llama-3-8B's widths cut to 2 layers on its own
    random weights (seed 1). Replayed and eagerly (identical tokens and
    launches). Gates: served tokens within 0.5 logit of the plain forward
    over the dequantized weights; ragged launches exactly 32 x (prefill
    windows + verify steps); spec_k_effective reported in metrics()."""
    from paddle_tpu_torch.models import (LlamaConfig, decode_params,
                                         init_serving_params)
    from paddle_tpu_torch.serving import DraftModelDrafter

    quant, phase, L = "weight_only_int8", "spec-scan-unified", \
        cfg.num_hidden_layers
    params8 = decode_params(params, quant)
    dcfg = LlamaConfig.llama3_8b(num_hidden_layers=2)
    dparams = init_serving_params(dcfg, seed=SEED + 1, device="cuda",
                                  dtype=torch.bfloat16)
    traffic = unified_traffic(cfg)
    drafters = []

    def drafter():
        drafters.append(DraftModelDrafter(dcfg, dparams))
        return drafters[-1]

    runs = {}
    for graphed in (True, False):
        eng = build_engine(cfg, params8, traffic, graphed,
                           max_prompt_len=2048,
                           prefix_cache=True, unified_step=True,
                           token_budget=256, decode_megakernel="scan",
                           double_buffer=True, speculative="draft",
                           spec_k=4, spec_adaptive=True, drafter=drafter())
        if eng.megakernel_rung != "scan":
            raise AssertionError(f"{phase}: planned rung "
                                 f"{eng.megakernel_rung}")
        stats = eng.compile_stats()
        reqs, wall, launches, m = serve(eng, traffic, f"{phase}/"
                                        f"{graph_tag(eng)}")
        if eng.compile_stats() != stats:
            raise AssertionError(f"{phase}: traffic grew compile_stats "
                                 f"{stats} -> {eng.compile_stats()}")
        runs[graphed] = SimpleNamespace(reqs=reqs, wall=wall,
                                        launches=launches, m=m)
        del eng
        _release()
    g, e = runs[True], runs[False]
    if [r.tokens for r in g.reqs] != [r.tokens for r in e.reqs] \
            or g.launches != e.launches:
        raise AssertionError(f"{phase}: the graphed run's tokens or "
                             f"launches differ from the eager run's "
                             f"({g.launches} vs {e.launches})")
    m = g.m
    if "spec_k_effective" not in m or not 1 <= m["spec_k_effective"] <= 4:
        raise AssertionError(f"{phase}: spec_k_effective "
                             f"{m.get('spec_k_effective')}")
    if m["compile_stats"] != {"decode": 1, "unified": 1, "verify": 1,
                              "draft": 1}:
        raise AssertionError(f"{phase}: compile_stats {m['compile_stats']}")
    if m["spec_steps"] <= 0 or m["prefill_chunks"] <= 16:
        raise AssertionError(f"{phase}: {m['spec_steps']} verify steps, "
                             f"{m['prefill_chunks']} windows")
    _gate_spec_launches(phase, g.launches, m, "ragged_paged_attention", L,
                        m["prefill_chunks"])
    tok_s, per = _spec_log(phase, g.reqs, g.wall, m)
    log(f"[{phase}] graph vs eager: tokens identical, launches equal; eager "
        f"{sum(len(r.tokens) for r in e.reqs) / e.wall:.1f} tok/s; scan "
        f"megakernel launches {g.launches['decode_layers_megakernel']} "
        "(the mixed steps' decode lane)")
    plain = plain_over(cfg, params8, quant)
    hit = next(r for r in g.reqs if r.cached_tokens)
    worst = _gate_ranks(phase, plain, [g.reqs[0], hit])
    del plain, params8, dparams, drafters
    _release()
    return {"launches": g.launches, "tok_s": tok_s,
            "acceptance": m["acceptance_rate"], "per_verify": per,
            "spec_k_effective": m["spec_k_effective"], "worst_margin": worst}


def phase_disagg(cfg, params, prefix, unified):
    """Phase 18: disaggregated=True on phase 3's traffic (the split path
    with the prefix cache) and on phase 4's (the unified step). Gates:
    tokens identical to phases 3 and 4; prefill_handoffs equal to the
    requests, all of which take a decode slot."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    out = {}
    for name, traffic, yard, kw in (
            ("split", prefix_traffic(cfg), prefix,
             dict(max_prompt_len=1024)),
            ("unified", unified_traffic(cfg), unified,
             dict(max_prompt_len=2048, unified_step=True,
                  token_budget=256))):
        phase = f"disagg/{name}"
        eng = ContinuousBatchingEngine(
            cfg, params, slots=8, prompt_bucket=128, max_new_tokens=32,
            block_size=64, steps_per_sync=8, prefix_cache=True,
            disaggregated=True, dtype=torch.bfloat16, device="cuda", **kw)
        warm_for(eng, traffic, SHARED, phase)
        reqs, wall, launches, m = serve(eng, traffic, phase)
        if [r.tokens for r in reqs] != yard["tokens"]:
            raise AssertionError(
                f"{phase}: tokens differ from the non-disaggregated run's "
                f"(match {_token_match(reqs, yard['tokens']):.4f})")
        if m["prefill_handoffs"] != len(reqs) \
                or any(r.slot is None for r in reqs):
            raise AssertionError(f"{phase}: {m['prefill_handoffs']} handoffs "
                                 f"for {len(reqs)} requests")
        n_tok = sum(len(r.tokens) for r in reqs)
        log(f"[{phase}] tokens identical to the non-disaggregated run; "
            f"{m['prefill_handoffs']} handoffs; {n_tok / wall:.1f} tok/s")
        out[name] = launches
        del eng
        _release()
    return {"launches": out["split"]}


# ---------------------------------------------------------------------------
# phase 19: the generation entry points
# ---------------------------------------------------------------------------

class _flags:
    """Set serving flags of the port for one block."""

    def __init__(self, **flags):
        self.flags = flags

    def __enter__(self):
        from paddle_tpu_torch.framework import get_flags, set_flags

        self.old = {k: v for k, v in get_flags(list(self.flags)).items()}
        set_flags(self.flags)

    def __exit__(self, *exc):
        from paddle_tpu_torch.framework import set_flags

        set_flags(self.old)


def _timed(fn):
    """(fn()'s result, its wall seconds with the card synced before and
    after, its kernel launches)."""
    from paddle_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _build.launch_counts()


def phase_generate(cfg, params):
    """Phase 19: LlamaForCausalLM.jit_generate and generate, the
    generation entry points, on Llama-3-8B at full depth over phase 2's
    random bf16 weights: 8 rows, 32 new tokens, prompts of 100-500
    tokens (a 500-token rectangle for the contiguous layouts, ragged
    seq_lens of 100-500 for the paged ones). jit_generate in six modes:
    contiguous bf16; quant="weight_only_int8"; weight_only_int4 with
    prefill_with_quant (build_quant_generate); cache_layout="paged" over
    bf16 and (FLAGS_kv_cache_dtype=int8) int8 pools; paged with
    FLAGS_decode_megakernel=full over int8 weights. Each mode's program is
    a CUDA graph captured by its first call; a second call replays it and
    the same program's eager body runs a third. The six programs stay
    alive together, all captured through the model's one graph site, and
    the two int8-weight modes read one quantized set. Gates: the replay's
    tokens and launches equal the eager body's; a signature's program is
    captured once (the later calls capture nothing) and kept beside the
    earlier ones; every program of a quant mode holds the model's one set
    of that mode; exact launches per call (the
    flash forward once a layer for the prefill; per decode step 32 GQA
    decodes, 32 paged decodes or one full megakernel a layer, and the
    weight-only GEMV 225 times, or once for the lm_head beside the
    megakernel); every row's tokens in-vocabulary and within 0.5 logit
    (1.0 over int8 pools) of the bf16 plain forward over the weights the
    decode read. Then generate (eager, concat caches) for 8 new tokens:
    one flash forward a layer per forward, the rank gate. Logs ms per call
    and tok/s, replayed and eager."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    phase, L = "generate", cfg.num_hidden_layers
    b, max_new, width = 8, 32, 500
    steps, per_step = max_new - 1, MATMULS_PER_LAYER * L + 1
    rng = np.random.default_rng(SEED + 19)
    rect = torch.tensor(rng.integers(1, cfg.vocab_size, (b, width)),
                        device="cuda")
    seq_lens = rng.integers(100, width + 1, b)
    seq_lens[0] = width
    ragged = rect.clone()
    for i, n in enumerate(seq_lens):
        ragged[i, n:] = 0
    model = LlamaForCausalLM(cfg).load_params(params)
    paged = dict(cache_layout="paged", seq_lens=seq_lens.tolist())
    flash = {"flash_attention_fwd": L}
    modes = [
        ("contiguous", {}, {}, {**flash, "gqa_decode_attention": L * steps}),
        ("int8", dict(quant="weight_only_int8"), {},
         {**flash, "gqa_decode_attention": L * steps,
          "int8_weight_matmul": per_step * steps,
          "int8_weight_matmul_large_m": 0}),
        ("int4-quant-only", dict(quant="weight_only_int4",
                                 prefill_with_quant=True), {},
         {**flash, "gqa_decode_attention": L * steps,
          "int4_matmul": per_step * steps + 1,
          "int4_matmul_large_m": MATMULS_PER_LAYER * L}),
        ("paged", paged, {},
         {**flash, "paged_decode_attention": L * steps}),
        ("paged-int8-pools", paged, dict(kv_cache_dtype="int8"),
         {**flash, "paged_decode_attention_int8": L * steps,
          "paged_decode_attention": 0}),
        ("paged-full-int8-weights", {**paged, "quant": "weight_only_int8"},
         dict(decode_megakernel="full"),
         {**flash, "decode_layer_megakernel_full": L * steps,
          "paged_decode_attention": 0, "int8_weight_matmul": steps + 1,
          "int8_weight_matmul_large_m": MATMULS_PER_LAYER * L}),
    ]
    out, quant_sets = {}, {}
    for name, kw, flags, want in modes:
        tag = f"{phase}/{name}"
        ids = ragged if "seq_lens" in kw else rect
        with _flags(**flags):
            def call():
                return model.jit_generate(ids, max_new_tokens=max_new,
                                          bucket_size=128, **kw)

            gc.collect()
            _release()
            reserved = torch.cuda.memory_reserved()
            _, first_s, _ = _timed(call)
            entry = list(model._jit_gen_cache.values())[-1]
            grew = torch.cuda.memory_reserved() - reserved
            toks, g_s, g_n = _timed(call)
            model._gen_site.graphed = False
            e_toks, e_s, e_n = _timed(call)
            model._gen_site.graphed = True
        # every mode's program stays alive beside the earlier ones: one
        # capture each, all through the model's one graph site
        n_prog = len(model._jit_gen_cache)
        if entry.captures != 1 or n_prog != len(out) + 1 \
                or model._gen_site.captures != n_prog \
                or entry.prog.graph is None:
            raise AssertionError(f"{tag}: {entry.captures} captures, "
                                 f"{n_prog} programs, "
                                 f"{model._gen_site.captures} site captures")
        if not torch.equal(toks, e_toks) or g_n != e_n:
            raise AssertionError(f"{tag}: the replayed program's tokens or "
                                 f"launches {g_n} differ from its eager "
                                 f"body's {e_n}")
        bad = {k: (g_n[k], v) for k, v in want.items() if g_n[k] != v}
        new = toks[:, width:]
        if bad or tuple(toks.shape) != (b, width + max_new) \
                or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
            raise AssertionError(f"{tag}: tokens {tuple(toks.shape)}, "
                                 f"launches (got, want) {bad}")
        quant = kw.get("quant")
        quant_s = _timed(lambda: model._quant_set(params, quant))[1] \
            if quant else 0.0
        weights = entry._weights[-1]    # what the decode read
        if quant and weights is not quant_sets.setdefault(quant, weights):
            raise AssertionError(f"{tag}: the program holds a {quant} set "
                                 "of its own, not the model's shared one")
        dense = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
        plain = plain_over(cfg, weights, quant) if quant else dense
        margin_fn = rank_margin
        if quant and len(entry._weights) == 2:
            # the prompt prefilled over the dense weights, the steps over
            # the pairs: each part's own plain forward
            def margin_fn(plain, r):
                return rank_margin_split(dense, plain, r)
        reqs = [SimpleNamespace(
            req_id=i, prompt=ids[i, :seq_lens[i] if "seq_lens" in kw
                                else width].tolist(),
            tokens=new[i].tolist(), cached_tokens=0) for i in (0, b - 1)]
        limit = INT8_RANK_MARGIN if flags.get("kv_cache_dtype") == "int8" \
            else 0.5
        worst = _gate_ranks(tag, plain, reqs, limit, margin_fn)
        del plain, dense, weights
        n_tok = b * max_new
        log(f"[{tag}] {b} x {max_new} tokens: replayed {1e3 * g_s:.1f} ms "
            f"a call ({n_tok / g_s:.1f} tok/s; re-quantizing the weights, "
            f"which every call with quant= does, {1e3 * quant_s:.1f} ms "
            f"of it), eager body "
            f"{1e3 * e_s:.1f} ms ({n_tok / e_s:.1f} tok/s), first call "
            f"(capture) {1e3 * first_s:.1f} ms, reserved memory "
            f"+{grew / 2**20:.0f} MiB ({n_prog} programs kept, the site's "
            f"captures +{model._gen_site.reserved_bytes / 2**20:.0f} MiB in "
            f"all); tokens and launches identical; "
            f"worst gap {worst:.3f}; launches {json.dumps(g_n)}")
        out[name] = {"graph_ms": 1e3 * g_s, "eager_ms": 1e3 * e_s,
                     "quantize_ms": 1e3 * quant_s, "launches": g_n,
                     "tokens": toks, "reserved_mib": grew / 2**20}
    shared = {q: sum(t.numel() * t.element_size() for v in w.values()
                     if isinstance(v, tuple) for t in v) / 2**20
              for q, w in quant_sets.items()}
    log(f"[{phase}] {len(model._jit_gen_cache)} programs kept at once "
        f"through one graph site: its captures grew the reserved memory "
        f"{model._gen_site.reserved_bytes / 2**20:.0f} MiB; one quantized "
        f"set per quant mode, shared by its signatures ("
        + ", ".join(f"{q} {mib:.0f} MiB" for q, mib in shared.items())
        + f"); reserved now {torch.cuda.memory_reserved() / 2**20:.0f} MiB")
    model._jit_gen_cache.clear()
    quant_sets.clear()
    _release()

    # generate: eager, a forward per token over the concat caches
    n_gen = 8
    toks, s, n = _timed(lambda: model.generate(rect, max_new_tokens=n_gen))
    new = toks[:, width:]
    if tuple(toks.shape) != (b, width + n_gen) \
            or n["flash_attention_fwd"] != L * n_gen:
        raise AssertionError(f"{phase}/generate: tokens "
                             f"{tuple(toks.shape)}, launches {n}")
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    reqs = [SimpleNamespace(req_id=i, prompt=rect[i].tolist(),
                            tokens=new[i].tolist(), cached_tokens=0)
            for i in (0, b - 1)]
    worst = _gate_ranks(f"{phase}/generate", plain, reqs)
    same = float((new == out["contiguous"]["tokens"][:, width:width + n_gen])
                 .float().mean())
    log(f"[{phase}/generate] {b} x {n_gen} tokens eagerly in "
        f"{1e3 * s:.1f} ms ({b * n_gen / s:.1f} tok/s); "
        f"{n['flash_attention_fwd']} flash forwards (one a layer per "
        f"forward, Sq 1 over the concat cache after the prompt); worst gap "
        f"{worst:.3f}; token match with jit_generate's contiguous stream "
        f"{same:.4f}")
    del plain, model
    _release()
    return {"launches": out["contiguous"]["launches"], "modes": {
        k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
        for k, v in out.items()}}


# ---------------------------------------------------------------------------
# phase 20: a safetensors checkpoint streamed into the serving layout
# ---------------------------------------------------------------------------

CKPT_SHARDS = 4
# the safetensors dtype tags of the dtypes the writer stores
ST_TAGS = {torch.bfloat16: "BF16", torch.float16: "F16",
           torch.float32: "F32"}


def write_hf_checkpoint(params, d: str, shards: int = CKPT_SHARDS) -> int:
    """Write the decode-params dict `params` under `d` as an HF sharded
    safetensors checkpoint: `shards` files of about equal bytes plus
    model.safetensors.index.json, HF names (``model.`` for ``llama.``)
    and torch's [out, in] projections. The format's own writer (the
    card's machine needs no safetensors package): an 8-byte
    little-endian header length, the space-padded JSON header, then the
    tensors' bytes, one tensor on the host at a time. Returns the bytes
    of tensor data written."""
    layout = []
    for name, t in params.items():
        hf = "model." + name[len("llama."):] if name.startswith("llama.") \
            else name
        layout.append((hf, name, t.ndim == 2 and "embed_tokens" not in name,
                       t.numel() * t.element_size()))
    total = sum(n for *_, n in layout)
    groups, acc = [[] for _ in range(shards)], 0
    for item in layout:
        groups[min(shards - 1, acc * shards // total)].append(item)
        acc += item[3]
    weight_map = {}
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        header, off = {"__metadata__": {"format": "pt"}}, 0
        for hf, name, transpose, n in group:
            t = params[name]
            header[hf] = {"dtype": ST_TAGS[t.dtype],
                          "shape": list(t.shape[::-1] if transpose
                                        else t.shape),
                          "data_offsets": [off, off + n]}
            weight_map[hf] = fname
            off += n
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(d, fname), "wb") as f:
            f.write(struct.pack("<Q", len(raw)) + raw)
            for hf, name, transpose, n in group:
                t = params[name]
                host = (t.t() if transpose else t).contiguous().cpu()
                f.write(host.reshape(-1).view(torch.uint8).numpy().data)
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return total


def same_params(a: dict, b: dict) -> bool:
    """Whether two decode-params dicts hold the same names, dtypes,
    shapes and bytes (weight-only pairs element by element)."""
    if set(a) != set(b):
        return False
    for k in a:
        xs = a[k] if isinstance(a[k], tuple) else (a[k],)
        ys = b[k] if isinstance(b[k], tuple) else (b[k],)
        if len(xs) != len(ys):
            return False
        for x, y in zip(xs, ys):
            if x.dtype != y.dtype or x.shape != y.shape \
                    or not torch.equal(
                        x.contiguous().reshape(-1).view(torch.uint8),
                        y.contiguous().reshape(-1).view(torch.uint8)):
                return False
    return True


def nbytes(params: dict) -> int:
    return sum(t.numel() * t.element_size() for v in params.values()
               for t in (v if isinstance(v, tuple) else (v,)))


def phase_checkpoint(cfg, params, int8w):
    """Phase 20: Llama-3-8B at full width and depth through a checkpoint.
    build_model()'s bf16 params are written as an HF sharded checkpoint
    (4 shards + index, about 16.1 GB, in a temporary directory removed at
    the end), then streamed back by load_quant_serving_params:
    "weight_only_int8" must be byte-identical to decode_params(params,
    "weight_only_int8"), with the transient device peak over the load
    (max allocated minus what was allocated before minus the loaded set)
    at most 4x the largest weight's f32 bytes (the lm_head: never a second
    copy of the model); the loaded set, served through phase 8's engine
    and traffic, must give phase 8's tokens and launches. Then a 2-layer
    cfg reads the first layers of the same files: None bitwise equal to
    the params, "weight_only_int4" byte-identical to decode_params of
    them, and again under PADDLE_TPU_CHAOS=io_error:0.3:shard_read with a
    fixed seed, the retries counted by the reader's RetryStats. Logs the
    write's and the load's seconds and GB/s (the files are read back
    from the host's page cache)."""
    from paddle_tpu_torch.models import (decode_params,
                                         load_quant_serving_params)
    from paddle_tpu_torch.models.checkpoint import _SafetensorsSource
    from paddle_tpu_torch.resilience import RetryPolicy, chaos

    phase, quant = "checkpoint", "weight_only_int8"
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        written = write_hf_checkpoint(params, d)
        secs = time.perf_counter() - t0
        log(f"[{phase}] wrote {written / 1e9:.3f} GB of bf16 weights in "
            f"{secs:.2f} s ({written / 1e9 / secs:.2f} GB/s): "
            f"{sorted(os.listdir(d))}")
        gc.collect()
        _release()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loaded = load_quant_serving_params(cfg, d, quant, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        transient = torch.cuda.max_memory_allocated() - base - nbytes(loaded)
        f32_max = 4 * max(t.numel() for t in params.values())
        log(f"[{phase}] loaded {quant} from the files in {load_s:.2f} s "
            f"({written / 1e9 / load_s:.2f} GB/s read and uploaded at bf16, "
            f"quantized on the card; {nbytes(loaded) / 1e9:.3f} GB held); "
            f"transient device peak {transient / 1e9:.3f} GB = "
            f"{transient / f32_max:.2f}x the largest weight's f32 bytes "
            f"({f32_max / 1e9:.3f} GB)")
        if transient > 4 * f32_max:
            raise AssertionError(f"{phase}: the load's transient peak "
                                 f"{transient} B exceeds 4 x {f32_max} B")
        if not same_params(loaded, decode_params(params, quant)):
            raise AssertionError(f"{phase}: the loaded {quant} params differ "
                                 "from decode_params of the same weights")
        _release()
        eng = int8w_unified_engine(cfg, loaded)
        reqs, wall, launches, m = serve(eng, unified_traffic(cfg), phase)
        if [r.tokens for r in reqs] != int8w["tokens"] \
                or launches != int8w["launches"]:
            raise AssertionError(
                f"{phase}: the loaded set served other tokens (match "
                f"{_token_match(reqs, int8w['tokens']):.4f}) or launches "
                f"({launches} vs {int8w['launches']}) than phase 8's")
        log(f"[{phase}] the loaded set served phase 8's traffic: tokens and "
            "launches identical to phase 8's")
        del eng, loaded
        gc.collect()
        _release()

        cfg2 = dataclasses_replace(cfg, num_hidden_layers=2)
        first2 = {k: v for k, v in params.items()
                  if ".layers." not in k
                  or k.startswith(("llama.layers.0.", "llama.layers.1."))}
        dense = load_quant_serving_params(cfg2, d, None, device="cuda")
        if not same_params(dense, first2):
            raise AssertionError(f"{phase}: the 2-layer bf16 read differs "
                                 "from the params")
        int4 = load_quant_serving_params(cfg2, d, "weight_only_int4",
                                         device="cuda")
        if not same_params(int4, decode_params(first2, "weight_only_int4")):
            raise AssertionError(f"{phase}: the 2-layer int4 read differs "
                                 "from decode_params of the params")
        policy = RetryPolicy(max_attempts=20, base_delay=0.001, seed=SEED)
        old = {k: os.environ.get(k)
               for k in ("PADDLE_TPU_CHAOS", "PADDLE_TPU_CHAOS_SEED")}
        os.environ["PADDLE_TPU_CHAOS"] = "io_error:0.3:shard_read"
        os.environ["PADDLE_TPU_CHAOS_SEED"] = str(SEED)
        try:
            flaky = load_quant_serving_params(
                cfg2, _SafetensorsSource(d, retry=policy),
                "weight_only_int4", names="hf", device="cuda")
            fired = chaos.counters().get("io_error", 0)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            chaos.uninstall()
        stats = policy.stats.as_dict()
        log(f"[{phase}] 2-layer reads: bf16 bitwise the params, int4 "
            f"byte-identical to decode_params; under io_error:0.3:shard_read "
            f"(seed {SEED}) {fired} injected faults, RetryStats {stats}")
        if not same_params(flaky, int4) or stats["giveups"] \
                or stats["retries"] != fired or not fired:
            raise AssertionError(f"{phase}: the chaos read gave other params "
                                 f"or gave up: {stats}, {fired} faults")
        del dense, int4, flaky
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _release()
    return {"launches": launches, "load_s": load_s, "write_s": secs,
            "bytes": written, "transient": transient, "retries": stats}


# ---------------------------------------------------------------------------
# phase 21: observability and the watchdog
# ---------------------------------------------------------------------------

# phase 21b's deadline and injected hang, seconds
WATCHDOG_S, HANG_S = 2.0, 5.0


def watchdog_traffic(cfg):
    """Phase 21b's prompts: a 40-token cold prompt first (under one page:
    it never maps a cached block, so a requeued run prefills it exactly
    as its first admission did), then phase 3's first 7 prompts."""
    rng = np.random.default_rng(SEED + 21)
    return [rng.integers(1, cfg.vocab_size, 40).tolist()] \
        + prefix_traffic(cfg)[:7]


def empty_prefix_cache(eng):
    """Drop every cached prefix block of a drained engine: allocating all
    available pages evicts the cached ones (refcount 0), and freeing them
    returns them uncached, the free list in a fresh engine's order."""
    mgr = eng.mgr
    mgr.free(mgr.alloc_pages(mgr.n_available))
    if mgr.n_cached or mgr.n_free != mgr.max_pages - 1:
        raise AssertionError("the prefix cache did not empty")


def _ms(h, q):
    v = h.get(f"p{q}")
    return float("nan") if v is None else 1e3 * v


def phase_observe(cfg, params):
    """Phase 21: (a) phase 3's traffic (the split path, the prefix cache,
    bf16 pools; warmed engines) with a Tracer and a MetricsRegistry, and
    again with both off: identical tokens, launches and compile_stats();
    req.enqueue, req.admit and req.retire cover every request; the TTFT,
    queue-wait and TPOT histograms count every request; the Perfetto
    export parses back with X / i / C events. Logs TTFT and TPOT p50 / p99
    and tok/s traced and untraced, and shows the decode.dispatch range in
    a torch.profiler trace of one chunk. (b) the watchdog: `hang:decode`
    for HANG_S under a WATCHDOG_S deadline on warmed engines over
    watchdog_traffic (one warmed engine, its prefix cache emptied before
    each run), synchronous, double-buffered, and with
    requeue_hung: one victim (the lowest live slot) failed, or requeued
    and served in full, every other request's tokens those of an
    undisturbed run, chaos.hang / watchdog.timeout / the retirement once
    each in the event log; once the hang has elapsed the abandoned thread
    has launched nothing and the pools hold the same bytes."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.observability import (MetricsRegistry, Tracer,
                                                metrics as obs_metrics)
    from paddle_tpu_torch.resilience import chaos

    phase, traffic = "observe", prefix_traffic(cfg)
    kw = dict(shared=SHARED, max_prompt_len=1024, prefix_cache=True)
    runs = {}
    for traced in (False, True):
        tr, mt = (Tracer(), MetricsRegistry()) if traced else (False, False)
        tag = f"{phase}/{'traced' if traced else 'off'}"
        eng = build_engine(cfg, params, traffic, tag=tag, tracer=tr,
                           metrics=mt, **kw)
        stats = eng.compile_stats()
        reqs, wall, launches, m = serve(eng, traffic, tag)
        if eng.compile_stats() != stats:
            raise AssertionError(f"{tag}: traffic grew compile_stats")
        runs[traced] = SimpleNamespace(reqs=reqs, wall=wall,
                                       launches=launches, stats=stats,
                                       tr=tr, mt=mt, eng=eng)
    on, off = runs[True], runs[False]
    del off.eng
    if [r.tokens for r in on.reqs] != [r.tokens for r in off.reqs] \
            or on.launches != off.launches or on.stats != off.stats:
        raise AssertionError(f"{phase}: tracing changed tokens, launches "
                             f"({on.launches} vs {off.launches}) or "
                             f"captures ({on.stats} vs {off.stats})")
    n = len(traffic)
    evs = on.tr.events()
    ids = sorted(r.req_id for r in on.reqs)
    for stage in ("req.enqueue", "req.admit", "req.retire"):
        got = sorted(e["args"]["req_id"] for e in evs if e["name"] == stage)
        if got != ids:
            raise AssertionError(f"{phase}: {stage} covers {got}, not {ids}")
    snap = on.mt.snapshot()
    hist = snap["histograms"]
    counts = {k: hist[k]["count"] for k in ("ttft_s", "queue_wait_s",
                                            "tpot_s")}
    if set(counts.values()) != {n}:
        raise AssertionError(f"{phase}: histogram counts {counts} for {n} "
                             "requests")
    n_tok = sum(len(r.tokens) for r in on.reqs)
    on.tr.counter("output_tok_s", n_tok / on.wall)
    with tempfile.TemporaryDirectory() as d:
        with open(on.tr.export(os.path.join(d, "trace.json"))) as f:
            doc = json.load(f)
    phs = {e["ph"] for e in doc["traceEvents"]}
    if not {"X", "i", "C"} <= phs:
        raise AssertionError(f"{phase}: the Perfetto export holds {phs}")
    names = {}
    for e in evs:
        names[e["name"]] = names.get(e["name"], 0) + 1
    log(f"[{phase}] traced vs off: tokens, launches and compile_stats "
        f"identical; {on.tr.n_recorded} trace events {names}; counters "
        f"{snap['counters']}")
    def exact(h):
        return (f"min {1e3 * h['min']:.2f} / mean {1e3 * h['mean']:.2f} / "
                f"max {1e3 * h['max']:.2f} ms")

    log(f"[{phase}] TTFT p50 {_ms(hist['ttft_s'], 50):.1f} ms, p99 "
        f"{_ms(hist['ttft_s'], 99):.1f} ms ({exact(hist['ttft_s'])}); TPOT "
        f"p50 {_ms(hist['tpot_s'], 50):.2f} ms, p99 "
        f"{_ms(hist['tpot_s'], 99):.2f} ms ({exact(hist['tpot_s'])}); queue "
        f"wait p50 {_ms(hist['queue_wait_s'], 50):.1f} ms; decode chunk "
        f"p50 {_ms(hist['decode_chunk_s'], 50):.2f} ms (dispatch to "
        f"readback; percentiles interpolate inside the registry's x2 "
        f"buckets); {n} requests submitted at once; tok/s traced "
        f"{n_tok / on.wall:.1f}, off {n_tok / off.wall:.1f}")
    # one decode chunk under torch.profiler: the engine's dispatch range
    # sits beside the kernels it launched
    eng = on.eng
    for p in traffic[:8]:
        eng.add_request(p, max_new=17)
    eng._admit()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    ranges = {e.key: e.count for e in prof.key_averages()
              if e.key in ("decode.dispatch", "prefill.dispatch")}
    if ranges.get("decode.dispatch") != 1:
        raise AssertionError(f"{phase}: the profiled chunk shows ranges "
                             f"{ranges}, not one decode.dispatch")
    eng.run()
    log(f"[{phase}] torch.profiler of one chunk: ranges {ranges}")
    del eng, on.eng
    _release()

    # (b) the watchdog, on one warmed engine whose prefix cache is
    # emptied before each run (every run then batches and prefills as
    # the undisturbed one did)
    wtraffic = watchdog_traffic(cfg)
    # the chaos and watchdog seams report to the global registry; the
    # engine (metrics=None) takes it too
    reg = obs_metrics.enable()
    out = {}
    try:
        eng = build_engine(cfg, params, wtraffic, tag=f"{phase}/watchdog",
                           **kw)
        stats = eng.compile_stats()
        want = [r.tokens for r in serve(eng, wtraffic,
                                        f"{phase}/undisturbed")[0]]
        for db, requeue in ((False, False), (True, False), (False, True)):
            tag = f"{phase}/watchdog-{'db' if db else 'sync'}" \
                f"{'-requeue' if requeue else ''}"
            empty_prefix_cache(eng)
            hung = (eng.hung_retired, eng.hung_requeued)
            n_ev = len(reg.events())
            reqs = [eng.add_request(p) for p in wtraffic]
            _build.reset_launch_counts()
            chaos.install(f"hang:decode:{HANG_S}")
            t0 = time.perf_counter()
            eng.run(watchdog_timeout=WATCHDOG_S, double_buffer=db,
                    requeue_hung=requeue)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            events = [e["event"] for e in reg.events()[n_ev:]]
            failed = [r.req_id for r in reqs if r.failed]
            retired = eng.hung_retired - hung[0]
            requeued = eng.hung_requeued - hung[1]
            last = "watchdog.requeue_hung_slot" if requeue \
                else "watchdog.retire_hung_slot"
            if events != ["chaos.hang", "watchdog.timeout", last]:
                raise AssertionError(f"{tag}: event log {events}")
            if requeue:
                ok = requeued == 1 and retired == 0 \
                    and not failed and reqs[0].requeued \
                    and [r.tokens for r in reqs] == want
            else:
                ok = retired == 1 and requeued == 0 \
                    and failed == [reqs[0].req_id] \
                    and reqs[0].slot == 0 \
                    and [r.tokens for r in reqs[1:]] == want[1:]
            if not ok or eng.compile_stats() != stats:
                raise AssertionError(
                    f"{tag}: hung_retired +{retired}, requeued "
                    f"+{requeued}, failed {failed}, token match "
                    f"{_token_match(reqs, want):.4f}, captures "
                    f"{stats} -> {eng.compile_stats()}")
            # wait out the hang: the abandoned thread then unwinds and
            # must launch nothing and write no pool
            launches = _build.launch_counts()
            pools = [t.clone() for t in eng.kcs + eng.vcs]
            time.sleep(max(0.0, HANG_S + 0.5 - (time.perf_counter() - t0)))
            torch.cuda.synchronize()
            if _build.launch_counts() != launches or not all(
                    torch.equal(a, b) for a, b in zip(pools,
                                                      eng.kcs + eng.vcs)):
                raise AssertionError(f"{tag}: the abandoned step touched "
                                     "the card after the deadline")
            log(f"[{tag}] hang {HANG_S} s under a {WATCHDOG_S} s deadline: "
                f"run() returned in {wall:.2f} s, "
                f"{'requeued' if requeue else 'failed'} request "
                f"{reqs[0].req_id} (slot 0), the other {len(reqs) - 1} "
                f"{'and the victim ' if requeue else ''}token-identical to "
                f"the undisturbed run; events {events}; after the hang: "
                "no launch, pools unchanged")
            out[tag] = wall
            del pools
    finally:
        obs_metrics.disable()
        chaos.uninstall()
    del eng
    _release()
    return {"launches": on.launches, "ttft": hist["ttft_s"],
            "tpot": hist["tpot_s"], "watchdog": out}


# ---------------------------------------------------------------------------
# phase 22: the SLO router over a fault-tolerant decode fleet
# ---------------------------------------------------------------------------

PRIORITIES = ("high", "normal", "low")


def _gate_fleet_ranks(phase: str, plain, reqs, limit: float = 0.5) -> float:
    """Every finished stream of `reqs` (router requests) within `limit`
    logit of the teacher-forced bf16 plain forward's argmax (phase 2's
    rule), logged as one line. Returns the worst gap."""
    margins = [rank_margin(plain, r) for r in reqs]
    worst = max(margins)
    log(f"[{phase}] {len(reqs)} streams held to the bf16 plain forward: "
        f"worst gap to its argmax {worst:.3f} (limit {limit})")
    if worst > limit:
        raise AssertionError(f"{phase}: a served token ranks {worst:.3f} "
                             f"below the plain argmax (limit {limit})")
    return worst


def _fleet_submit(phase, router, traffic):
    """Submit `traffic` to `router` at once, priority classes in turn
    (32 new tokens each). Gate: nothing shed."""
    from paddle_tpu_torch.serving import Rejected

    reqs = [router.submit(p, 32, priority=PRIORITIES[i % 3])
            for i, p in enumerate(traffic)]
    shed = [r for r in reqs if isinstance(r, Rejected)]
    if shed:
        raise AssertionError(f"{phase}: the router shed {shed}")
    return reqs


def _wait_inflight(phase, reqs, wid, timeout: float = 120.0):
    """Block until worker `wid` holds a request with delivered tokens
    that is not done."""
    deadline = time.monotonic() + timeout
    while not any(r.worker_id == wid and r.tokens and not r.done
                  for r in reqs):
        if time.monotonic() > deadline:
            raise AssertionError(f"{phase}: no progress on {wid}")
        time.sleep(0.002)


def _fleet_finish(phase, router, reqs, timeout: float = 300.0):
    """Drive `router` until every request is terminal. Gate: every request
    finished with 32 tokens."""
    router.join(timeout=timeout)
    torch.cuda.synchronize()
    bad = [(r.req_id, r.state, len(r.tokens), r.worker_id, r.error)
           for r in reqs if r.state != "finished" or len(r.tokens) != 32]
    if bad:
        raise AssertionError(f"{phase}: requests not finished in full: {bad}")


def _fleet_serve(phase, router, traffic):
    """`traffic` through `router` to the end (the gates of _fleet_submit
    and _fleet_finish); returns the requests and the wall time."""
    t0 = time.perf_counter()
    reqs = _fleet_submit(phase, router, traffic)
    _fleet_finish(phase, router, reqs)
    return reqs, time.perf_counter() - t0


def _log_fleet(phase, router, reqs, wall, lone_tps, undisturbed):
    """The part's wall, tok/s beside the lone engine's, router TTFT p50 /
    p99 per class beside the exact max, and the share of streams
    identical to the lone engine's (logged, not gated)."""
    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = []
    for p in PRIORITIES:
        h = router.mt.histogram(f"router_ttft_s_{p}").summary()
        ttft.append(f"{p} p50 {_ms(h, 50):.1f} / p99 {_ms(h, 99):.1f} ms "
                    f"(exact max {1e3 * h['max']:.1f}, n {h['count']})")
    same = sum(r.tokens == t for r, t in zip(reqs, undisturbed))
    log(f"[{phase}] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"fleet {n_tok / wall:.1f} tok/s vs the lone engine's "
        f"{lone_tps:.1f}; router TTFT {'; '.join(ttft)}; streams identical "
        f"to the lone engine's {same}/{len(reqs)}")


def phase_fleet(cfg, params, prefix):
    """Phase 22: the SLO router over a fault-tolerant decode fleet, at
    Llama-3-8B full width, on phase 3's configuration (the split path, the
    prefix cache, bf16 pools sized by kv_pool_bytes= at phase 3's pool
    bytes) and traffic (24 requests sharing a 512-token system prompt,
    priority classes high / normal / low in turn). Every in-process
    worker's engine shares the one params dict and is warmed as it joins
    (`add_worker(warm=True)`), for the traffic's buckets and those of a
    recovered request (prompt + up to 31 delivered tokens) at the system
    prompt's prefix width. The workers keep their prefix caches from part
    to part, so a later part's hits can reach deeper, unwarmed prefix
    widths: those programs are captured at first use while the other
    worker serves, each worker's step holding the card's device gate.
    (1) two workers, undisturbed: all finished, no death, rank gates,
    compile_stats() steady, rms_norm, flash forward, paged decode and
    prefix prefill launched. (2) kill_worker on w1 once it holds
    in-flight work with delivered tokens: one death, requeued >= 1, no
    poison, w1 fenced, every request finished with a recovered one's
    delivered prefix intact, prefix prefill launched during the recovery,
    the merged trace naming only w0's lane. (3) once w0 holds in-flight
    work, it drains on a thread of its own while a third worker joins
    and warms: w0's slots finish there, its queue finishes on the
    newcomer (whose compile_stats() stays steady), the epoch rises by one
    per join and leave. (4) after the
    in-process engines are released, a FileStore serve_worker subprocess
    on the card (Llama-3-8B from the same seed) serves 8 requests with
    the rank gate and drains to exit code 0. Each part logs its wall,
    tok/s beside a lone engine's, and router TTFT per class."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.resilience.store import FileStore
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine, Fleet,
                                          Router)

    phase, traffic = "fleet", prefix_traffic(cfg)
    kw = dict(max_prompt_len=1024, prefix_cache=True,
              kv_pool_bytes=prefix["kv_pool_bytes"])
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)

    # the yardstick: one engine alone on the same traffic
    lone = build_engine(cfg, params, traffic, shared=SHARED,
                        tag=f"{phase}/lone", **kw)
    buckets, widths = warm_args(lone, traffic, SHARED, grow=31)
    lone_reqs, lone_wall, _, _ = serve(lone, traffic, f"{phase}/lone")
    undisturbed = [list(r.tokens) for r in lone_reqs]
    lone_tps = sum(len(t) for t in undisturbed) / lone_wall
    # part 4's yardstick: its 8 requests alone, from an empty cache
    empty_prefix_cache(lone)
    lone8, lone8_wall, _, _ = serve(lone, traffic[:8], f"{phase}/lone-8")
    lone8_tps = sum(len(r.tokens) for r in lone8) / lone8_wall
    undisturbed8 = [list(r.tokens) for r in lone8]
    del lone, lone_reqs, lone8
    gc.collect()
    _release()

    def factory(*, metrics, tracer):
        return ContinuousBatchingEngine(cfg, params, **{
            **SERVE_KW, **kw, "metrics": metrics, "tracer": tracer})

    warm_kw = {"buckets": buckets, "prefix_widths": widths}
    out = {}
    fleet = Fleet(factory, trace=True)
    try:
        t0 = time.perf_counter()
        for _ in range(2):
            fleet.add_worker(warm=True, warm_kwargs=warm_kw)
        workers = fleet.live()
        if any(w.engine.p is not params for w in workers.values()):
            raise AssertionError(f"{phase}: a worker copied the weights")
        stats = {wid: w.engine.compile_stats() for wid, w in workers.items()}
        log(f"[{phase}] two workers joined (epoch {fleet.epoch}), each "
            f"warmed for buckets {buckets} and prefix widths {widths} in "
            f"{time.perf_counter() - t0:.2f} s: "
            f"{len(stats['w0'])} programs each; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

        # (1) undisturbed
        tag = f"{phase}/undisturbed"
        router = Router(fleet)
        _build.reset_launch_counts()
        reqs, wall = _fleet_serve(tag, router, traffic)
        launches = _build.launch_counts()
        m = router.metrics()
        if m["worker_deaths"] or {wid: w.engine.compile_stats()
                                  for wid, w in workers.items()} != stats:
            raise AssertionError(f"{tag}: deaths {m['worker_deaths']}, "
                                 "or compile_stats grew")
        for name in ("rms_norm", "flash_attention_fwd",
                     "paged_decode_attention", "prefix_prefill_attention"):
            if launches[name] <= 0:
                raise AssertionError(f"{tag}: {name} was never launched")
        served = {wid: sum(r.worker_id == wid for r in reqs)
                  for wid in workers}
        _log_fleet(tag, router, reqs, wall, lone_tps, undisturbed)
        log(f"[{tag}] requests a worker {served}; launches "
            f"{json.dumps({k: n for k, n in launches.items() if n})}")
        _gate_fleet_ranks(tag, plain, reqs)
        out["undisturbed"] = {"wall": wall, "launches": launches}

        # (2) a chaos kill of w1 mid-request
        tag = f"{phase}/kill"
        router = Router(fleet)
        target = workers["w1"]
        t0 = time.perf_counter()
        try:
            reqs = _fleet_submit(tag, router, traffic)
            _wait_inflight(tag, reqs, "w1")
            chaos.install(f"kill_worker:1@{target.steps + 2}")
            target.join(60)
            if not target.killed:
                raise AssertionError(f"{tag}: the chaos kill did not fire")
            t_kill = time.perf_counter()
            with router._lock:
                kept = {r.req_id: list(r.tokens)
                        for r in router._dispatched.get("w1", {}).values()}
            _build.reset_launch_counts()
            _fleet_finish(tag, router, reqs)
        finally:
            chaos.uninstall()
        recovery = time.perf_counter() - t_kill
        wall = time.perf_counter() - t0
        launches = _build.launch_counts()
        m = router.metrics()
        recovered = [r for r in reqs if r.kills]
        broken = [r.req_id for r in recovered
                  if r.tokens[:len(kept[r.req_id])] != kept[r.req_id]]
        if (m["worker_deaths"], m["poison_failed"]) != (1, 0) \
                or m["requeued"] < 1 or "w1" not in fleet.fenced \
                or fleet.deaths[-1]["reason"] != "chaos_kill" \
                or broken or not any(kept.values()):
            raise AssertionError(
                f"{tag}: metrics {m}, deaths {fleet.deaths}, fenced "
                f"{fleet.fenced}, broken prefixes {broken}, delivered at "
                f"the kill {kept}")
        if launches["prefix_prefill_attention"] <= 0:
            raise AssertionError(f"{tag}: no prefix prefill during the "
                                 "recovery")
        grown = len(workers["w0"].engine.compile_stats()) - len(stats["w0"])
        with tempfile.TemporaryDirectory() as d:
            path = fleet.export_merged_trace(os.path.join(d, "fleet.json"))
            with open(path) as f:
                lanes = {e["args"]["name"] for e in json.load(f)["traceEvents"]
                         if e["name"] == "process_name"}
        if lanes != {"worker:w0"}:
            raise AssertionError(f"{tag}: the merged trace names {lanes}")
        _log_fleet(tag, router, reqs, wall, lone_tps, undisturbed)
        log(f"[{tag}] w1 killed at its loop step {target.steps}: "
            f"{len(recovered)} requests requeued ({m['requeued']:.0f}), "
            f"{sum(bool(t) for t in kept.values())} with delivered tokens "
            f"kept ({sum(len(t) for t in kept.values())} tokens); recovery "
            f"wall from the kill to the last request {recovery:.3f} s; "
            f"prefix prefill launches during it "
            f"{launches['prefix_prefill_attention']}; w0 captured {grown} "
            f"programs at first use (prefix hits kept from part 1); merged "
            f"trace lanes {sorted(lanes)}")
        _gate_fleet_ranks(tag, plain, reqs)
        out["kill"] = {"wall": wall, "recovery": recovery}
        # the killed worker unwound with no cleanup: drop its engine
        del target
        workers.pop("w1")
        gc.collect()
        _release()

        # (3) once w0 holds in-flight work, it drains on a thread of its
        # own (its slots finish there, its queue goes back to the router)
        # while a third worker joins and warms, holding the device gate
        tag = f"{phase}/drain"
        w0 = workers["w0"]
        router = Router(fleet)
        epoch0 = fleet.epoch
        t0 = time.perf_counter()
        reqs = _fleet_submit(tag, router, traffic)
        _wait_inflight(tag, reqs, "w0")
        with router._lock:
            assigned = len(router._dispatched.get("w0", {}))
        drain = threading.Thread(target=fleet.remove_worker, args=("w0",),
                                 kwargs={"drain": True, "timeout": 300})
        drain.start()
        steps0, t_join = w0.steps, time.perf_counter()
        w2 = fleet.add_worker(warm=True, warm_kwargs=warm_kw)
        log(f"[{tag}] {w2} joined at epoch {fleet.workers[w2].lease_epoch} "
            f"while w0 served its slots, warmed in "
            f"{time.perf_counter() - t_join:.2f} s (w0 took "
            f"{w0.steps - steps0} loop steps meanwhile)")
        stats2 = fleet.workers[w2].engine.compile_stats()
        drain.join(330)
        _fleet_finish(tag, router, reqs)
        wall = time.perf_counter() - t0
        m = router.metrics()
        bad = [(r.req_id, r.worker_id) for r in reqs
               if r.requeues and r.worker_id != w2]
        epochs = (epoch0, fleet.workers[w2].lease_epoch, fleet.epoch)
        if bad or drain.is_alive() or "w0" in fleet.workers \
                or "w0" not in fleet.fenced or fleet.epoch != epoch0 + 2 \
                or epochs[1] not in (epoch0 + 1, epoch0 + 2) \
                or (assigned > w0.slots and m["drain_requeued"] < 1) \
                or m["worker_deaths"] \
                or fleet.workers[w2].engine.compile_stats() != stats2:
            raise AssertionError(
                f"{tag}: requeued requests finished off {w2}: {bad}, epochs "
                f"(before, join, after) {epochs}, w0 held {assigned}, "
                f"metrics {m}, or the drain hung, or {w2}'s compile_stats "
                "grew")
        _log_fleet(tag, router, reqs, wall, lone_tps, undisturbed)
        log(f"[{tag}] w0 held {assigned} requests at the drain: "
            f"{sum(r.worker_id == 'w0' for r in reqs)} finished there, "
            f"{m['drain_requeued']:.0f} requeued to {w2}; epochs (before, "
            f"join, after) {epochs}")
        _gate_fleet_ranks(tag, plain, reqs)
        out["drain"] = {"wall": wall}
    finally:
        fleet.stop()
    # (4) a subprocess worker, after the in-process engines are released
    del fleet, workers, w0, router
    gc.collect()
    _release()
    tag = f"{phase}/subprocess"
    root = tempfile.mkdtemp(prefix="fleet-store-")
    sfleet = Fleet(lambda **_: None, store=FileStore(root), job_id=phase)
    try:
        router = Router(sfleet)
        args = ["--model", "llama3_8b", "--device", "cuda", "--seed",
                str(SEED), "--slots", str(SERVE_KW["slots"]),
                "--prompt-bucket", str(SERVE_KW["prompt_bucket"]),
                "--max-prompt-len", str(kw["max_prompt_len"]),
                "--max-new", str(SERVE_KW["max_new_tokens"]),
                "--block-size", str(SERVE_KW["block_size"]),
                "--steps-per-sync", str(SERVE_KW["steps_per_sync"]),
                "--kv-pool-bytes", str(kw["kv_pool_bytes"]),
                "--warm-buckets", *map(str, buckets),
                "--prefix-widths", *map(str, widths)]
        t0 = time.perf_counter()
        wid = sfleet.add_subprocess_worker(
            extra_args=args, ready_timeout_s=300,
            env={"PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
        ready = time.perf_counter() - t0
        proc = sfleet.workers[wid].proc
        reqs, wall = _fleet_serve(tag, router, traffic[:8])
        sfleet.remove_worker(wid, drain=True, timeout=120)
        if proc.returncode != 0 or wid in sfleet.workers:
            raise AssertionError(f"{tag}: the worker exited "
                                 f"{proc.returncode} after its drain")
        _log_fleet(tag, router, reqs, wall, lone8_tps, undisturbed8)
        log(f"[{tag}] serve_worker ready (Llama-3-8B from seed {SEED}, "
            f"warmed) {ready:.2f} s after launch; drained to exit code 0")
        _gate_fleet_ranks(tag, plain, reqs)
        out["subprocess"] = {"wall": wall, "ready": ready}
    finally:
        for w in sfleet.workers.values():
            if w.proc.poll() is None:
                w.proc.kill()
                w.proc.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phases 13-14: the training step
# ---------------------------------------------------------------------------

def bench_decay(name: str) -> bool:
    """bench.py's apply_decay_param_fun: every weight but the norms."""
    return "norm" not in name and not name.endswith(".b_0")


def build_train_step(model, strategy=None):
    """bench.py main()'s step: AdamW(1e-4, weight decay 0.01, bench's
    decay function) through make_train_step's optimizer= route."""
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import make_train_step

    crit = LlamaPretrainingCriterion(model.config)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                apply_decay_param_fun=bench_decay,
                parameters=model.parameters())
    return make_train_step(model, lambda lg, lb: crit(lg, lb), None,
                           optimizer=opt, strategy=strategy)


def bench_batch(cfg, batch: int, seq: int):
    """x and y as bench.py:1027-1029 draws them."""
    rng = np.random.default_rng(SEED)
    return tuple(torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (batch, seq)), device="cuda")
                 for _ in range(2))


def run_steps(phase: str, step, p, s, x, y, n: int, per_step: dict):
    """One warm-up step, then `n` timed steps on the same batch, with the
    launch counters reset just before the warm-up and read just after the
    last step. Gates: each kernel of `per_step` launched exactly that many
    times per step; every loss finite; the last below the first. Returns
    (params, state, launches, losses, ms per timed step)."""
    from paddle_tpu_torch.kernels import _build

    _build.reset_launch_counts()
    loss, p, s = step(p, s, x, y)
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loss, p, s = step(p, s, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / n
    launches = _build.launch_counts()
    losses = [float(v) for v in losses]
    log(f"[{phase}] losses {[round(v, 4) for v in losses]}; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    for name, want in per_step.items():
        _gate_exact(phase, launches, name, want * (n + 1))
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"{phase}: losses {losses}")
    return p, s, launches, losses, step_ms


def grads_kernel_vs_plain(phase: str, cfg, params, x, y):
    """One forward and backward of `cfg` over `params` (detached tensors)
    with the kernels, with use_kernels=False, and with
    use_kernels=False in f32: every gradient of the kernel path passes
    phase 2's rule against the f32 one (relative RMS at most 1.25x the
    bf16 plain path's plus 1e-3). Returns the worst ratio."""
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)

    def grads(use_kernels, dtype):
        model = LlamaForCausalLM(cfg, use_kernels=use_kernels).load_params(
            {k: v.to(dtype) for k, v in params.items()}, trainable=True)
        LlamaPretrainingCriterion()(model(x), y).backward()
        return {n: p.grad for n, p in model.named_parameters()}

    ref = grads(False, torch.float32)
    plain = grads(False, torch.bfloat16)
    got = grads(True, torch.bfloat16)
    worst, worst_name = 0.0, None
    for name in ref:
        e_k, e_p = rel_rms(got[name].float(), ref[name]), rel_rms(
            plain[name].float(), ref[name])
        if not torch.isfinite(got[name]).all() or e_k > 1.25 * e_p + 1e-3:
            raise AssertionError(f"{phase}: grad {name} rel. RMS vs f32 "
                                 f"{e_k:.3e}, bf16 plain {e_p:.3e}")
        if e_k / max(e_p, 1e-12) > worst:
            worst, worst_name = e_k / max(e_p, 1e-12), name
    log(f"[{phase}] kernel vs plain gradients ({len(ref)} tensors, batch "
        f"{x.shape[0]} x {x.shape[1]}): worst kernel/plain rel. RMS ratio "
        f"vs f32 {worst:.3f} ({worst_name})")
    del ref, plain, got
    _release()
    return worst


def phase_train():
    """Phase 13, the training slice's main path: bench.py main()'s step
    on the card. Llama-1B (16 layers, kv heads 4, bf16, no recompute),
    random weights from SEED drawn on the card, AdamW with bench's decay
    function through make_train_step(optimizer=), bench's batch 4 x 2048,
    one warm-up step and 10 timed steps. Gates: per step exactly 16
    flash_attention_fwd, 16 of each backward kernel (dq, dkv and dkv's
    delta pre-pass), 33 rms_norm and no
    SwiGLU launches (FFN 5504 is not 512-aligned, and fused_swiglu is
    off); losses finite and falling; a 2-layer copy at full width with the
    trained weights passes the kernel-vs-plain gradient rule. Logs
    tokens/s, ms per step, MFU against 989 TF/s (6 N per token, N counted
    as bench.py counts it) and one profiled step."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         init_train_params)

    phase, batch, seq, n = "train", 4, 2048, 10
    cfg = LlamaConfig.llama_1b(dtype="bfloat16", recompute=False,
                               num_key_value_heads=4,
                               max_position_embeddings=2048)
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg).load_params(
        init_train_params(cfg, seed=SEED, device="cuda"), trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    step, p, s = build_train_step(model)
    x, y = bench_batch(cfg, batch, seq)
    torch.cuda.reset_peak_memory_stats()
    p, s, launches, losses, step_ms = run_steps(
        phase, step, p, s, x, y, n,
        {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
         "flash_attention_bwd_dkv": L, "flash_attention_bwd_delta": L,
         "rms_norm": 2 * L + 1,
         "swiglu_fwd": 0, "swiglu_bwd": 0})
    tok_s = batch * seq / (step_ms / 1e3)
    mfu = tok_s * 6 * n_params / BF16_FLOPS_PER_S
    log(f"[{phase}] Llama-1B ({n_params} params, bf16, AdamW) batch "
        f"{batch} x {seq}: {step_ms:.2f} ms per step, {tok_s:.1f} tokens/s, "
        f"MFU {100 * mfu:.2f}% of 989 TF/s (6 N per token); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    wall_ms, busy = profile_call(lambda: step(p, s, x, y),
                                 f"{phase}: one Llama-1B train step")
    two = dataclasses_replace(cfg, num_hidden_layers=2)
    keep = {k: v.detach().clone() for k, v in p.items()
            if not k.startswith("llama.layers.") or int(k.split(".")[2]) < 2}
    del step, p, s, model
    _release()
    worst = grads_kernel_vs_plain(phase, two, keep, x, y)
    del keep
    _release()
    return {"launches": launches, "losses": losses, "step_ms": step_ms,
            "tok_s": tok_s, "mfu": mfu, "profile": (wall_ms, busy),
            "grad_ratio": worst}


def phase_train_swiglu():
    """Phase 14: the fused SwiGLU route of the trainer. Llama-3-8B's
    widths (K 4096, F 14336: 512-aligned) cut to 2 layers,
    fused_swiglu=True, bf16, batch 4 x 2048, bench's AdamW and
    strategy={"recompute": {"enable": True}}; three steps after a
    warm-up. Gates: per step exactly 2 swiglu_fwd and 1 swiglu_bwd per
    layer, 2 flash_attention_fwd per layer and 1 of each backward kernel
    (dq, dkv, delta; recompute runs every forward kernel twice), rms_norm
    4 per layer plus
    the final norm; losses finite and falling; the kernel-vs-plain
    gradient rule at batch 1 x 2048."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         init_train_params)

    phase, batch, seq = "train-swiglu", 4, 2048
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2, fused_swiglu=True,
                                dtype="bfloat16",
                                max_position_embeddings=2048)
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg).load_params(
        init_train_params(cfg, seed=SEED, device="cuda"), trainable=True)
    step, p, s = build_train_step(model, {"recompute": {"enable": True}})
    x, y = bench_batch(cfg, batch, seq)
    p, s, launches, losses, step_ms = run_steps(
        phase, step, p, s, x, y, 3,
        {"swiglu_fwd": 2 * L, "swiglu_bwd": L, "flash_attention_fwd": 2 * L,
         "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
         "flash_attention_bwd_delta": L, "rms_norm": 4 * L + 1})
    log(f"[{phase}] Llama-3-8B widths, {L} layers, fused SwiGLU, recompute: "
        f"{step_ms:.2f} ms per step, {batch * seq / (step_ms / 1e3):.1f} "
        f"tokens/s")
    wall_ms, busy = profile_call(lambda: step(p, s, x, y),
                                 f"{phase}: one step")
    keep = {k: v.detach().clone() for k, v in p.items()}
    del step, p, s, model
    _release()
    worst = grads_kernel_vs_plain(phase, dataclasses_replace(
        cfg, recompute=False), keep, x[:1], y[:1])
    del keep
    _release()
    return {"launches": launches, "losses": losses, "step_ms": step_ms,
            "profile": (wall_ms, busy), "grad_ratio": worst}


# ---------------------------------------------------------------------------
# phase 23: the hapi trainer over the resilience runtime
# ---------------------------------------------------------------------------

HAPI_PER_TRAIN_STEP = {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                       "flash_attention_bwd_dkv": 1,
                       "flash_attention_bwd_delta": 1, "rms_norm": 2}
HAPI_PER_EVAL_BATCH = {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 0,
                       "flash_attention_bwd_dkv": 0,
                       "flash_attention_bwd_delta": 0, "rms_norm": 2}


def hapi_config(layers: int = 16):
    """Phase 13's Llama-1B (kv heads 4, bf16, no recompute), `layers`
    deep."""
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig.llama_1b(dtype="bfloat16", recompute=False,
                                num_key_value_heads=4,
                                max_position_embeddings=2048,
                                num_hidden_layers=layers)


def hapi_model(cfg, seed: int):
    """hapi.Model over a Llama of random trainable weights drawn on the
    card from `seed`, prepared with bench's AdamW (1e-4, weight decay
    0.01, bench_decay over the structural names) and the criterion."""
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion,
                                         init_train_params)
    from paddle_tpu_torch.optimizer import AdamW

    net = LlamaForCausalLM(cfg).load_params(
        init_train_params(cfg, seed=seed, device="cuda"), trainable=True)
    model = hapi.Model(net)
    model.prepare(optimizer=AdamW(1e-4, weight_decay=0.01,
                                  apply_decay_param_fun=bench_decay,
                                  parameters=net.named_parameters()),
                  loss=LlamaPretrainingCriterion(cfg))
    return model


def hapi_loader(x, y, batch: int):
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    return DataLoader(TensorDataset([x, y]), batch_size=batch,
                      shuffle=False)


def hapi_tokens(cfg, rows: int, seq: int, seed: int):
    """`rows` x `seq` token ids and labels on the host, from `seed`."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (rows, seq)))
                 for _ in range(2))


def loss_tape():
    """A callback recording every train step's loss."""
    from paddle_tpu_torch.hapi import Callback

    class Tape(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []
            self.t_end = None

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"][0]))

        def on_train_end(self, logs=None):
            self.t_end = time.perf_counter()

    return Tape()


def _gate_launches(phase: str, launches, per: dict, n: int, L: int) -> None:
    for name, k in per.items():
        _gate_exact(phase, launches, name, k * L * n + (
            n if name == "rms_norm" and k else 0))


def same_state(a, b) -> bool:
    """Parameters and optimizer moments of two hapi Models byte-equal."""
    oa, ob = a._optimizer, b._optimizer
    if oa._global_step != ob._global_step:
        return False
    for (na, pa), (nb, pb) in zip(a.network.named_parameters(),
                                  b.network.named_parameters()):
        if na != nb or not torch.equal(pa, pb):
            return False
        sa, sb = oa._accumulators[id(pa)], ob._accumulators[id(pb)]
        if sorted(sa) != sorted(sb) or not all(
                torch.equal(sa[k], sb[k]) for k in sa):
            return False
    return True


def hapi_main_path(phase: str, step_ms_13: float):
    """Part 1: fit on Llama-1B at full width and depth (8 steps over
    bench_batch's batch, async generations at steps 4 and 8), evaluate
    on 2 batches, predict on 1 x 2048, then resume a fresh model and
    optimizer from the newest generation."""
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.observability import trace as obs_trace
    from paddle_tpu_torch.resilience import CheckpointManager

    cfg = hapi_config()
    L = cfg.num_hidden_layers
    model = hapi_model(cfg, SEED)
    x, y = (t.cpu() for t in bench_batch(cfg, 4, 2048))
    xs, ys = x.repeat(8, 1), y.repeat(8, 1)
    loader = hapi_loader(xs, ys, 4)
    root = tempfile.mkdtemp(prefix="hapi-")
    out = {}
    try:
        out["free_disk_gb"] = shutil.disk_usage(root).free / 1e9
        tape = loss_tape()
        tr = obs_trace.enable()
        _build.reset_launch_counts()
        try:
            model.fit(loader, epochs=1, checkpoint_dir=root,
                      checkpoint_freq=4, verbose=0, callbacks=[tape])
            # fit's finally waits for the last background write
            wait_ms = 1e3 * (time.perf_counter() - tape.t_end)
        finally:
            obs_trace.disable()
        launches = _build.launch_counts()
        _gate_launches(phase, launches, HAPI_PER_TRAIN_STEP, 8, L)
        losses = tape.losses
        if len(losses) != 8 or not all(math.isfinite(v) for v in losses) \
                or losses[-1] >= losses[0]:
            raise AssertionError(f"{phase}: fit losses {losses}")
        spans = {}
        for ev in tr.events():
            if ev.get("ph") == "X":
                spans.setdefault(ev["name"], []).append(ev)
        step_ms = [ev["dur"] / 1e3 for ev in spans["fit.step"]]
        saves = [ev["dur"] / 1e3 for ev in spans["fit.checkpoint_save"]]
        writes = [ev["dur"] / 1e3 for ev in spans["ckpt.write"]]
        nbytes = spans["ckpt.write"][-1]["args"]["nbytes"]
        # steps 2-4 run with no write in flight, 5-8 beside generation
        # 1's background write
        mean_ms = sum(step_ms[1:4]) / 3
        busy_ms = sum(step_ms[4:]) / len(step_ms[4:])
        log(f"[{phase}] fit: losses {[round(v, 4) for v in losses]}; "
            f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
        log(f"[{phase}] fit step {mean_ms:.2f} ms (mean of steps 2-4; step "
            f"1 {step_ms[0]:.2f} ms; steps 5-8 beside a background write "
            f"{busy_ms:.2f} ms; each {[round(v, 2) for v in step_ms]}) "
            f"vs phase 13's make_train_step {step_ms_13:.2f} ms: "
            f"{mean_ms / step_ms_13:.3f}x ({busy_ms / step_ms_13:.3f}x)")
        log(f"[{phase}] async saves: snapshot stall on the step "
            f"{[round(v, 1) for v in saves]} ms; background write "
            f"{[round(v, 1) for v in writes]} ms for {nbytes / 1e9:.3f} GB "
            f"each ({nbytes / 1e9 / (sum(writes) / len(writes) / 1e3):.3f} "
            f"GB/s); wait() remainder after the last step "
            f"{wait_ms:.1f} ms; free disk before "
            f"{out['free_disk_gb']:.1f} GB")
        mgr = CheckpointManager(root)
        gens = mgr.generations()
        if gens != [1, 2]:
            raise AssertionError(f"{phase}: generations {gens}")
        t0 = time.perf_counter()
        ok1 = mgr.verify_generation(1)
        verify_s = time.perf_counter() - t0
        if not ok1:
            raise AssertionError(f"{phase}: generation 1 fails to verify")
        # the resume: a fresh model and optimizer from another seed
        fresh = hapi_model(cfg, SEED + 1)
        t0 = time.perf_counter()
        fresh.fit(loader, epochs=1, checkpoint_dir=root, resume=True,
                  verbose=0)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        if fresh.restored_generation != 2:
            raise AssertionError(f"{phase}: resumed generation "
                                 f"{fresh.restored_generation}")
        if not same_state(model, fresh):
            raise AssertionError(f"{phase}: the resumed model and optimizer "
                                 "differ from the live ones")
        log(f"[{phase}] generations {gens} committed; generation 1 verified "
            f"in {verify_s:.2f} s ({nbytes / 1e9 / verify_s:.3f} GB/s, read "
            f"+ crc32, warm page cache possible); resume of generation 2 "
            f"into a fresh model on the card {resume_s:.2f} s "
            f"({nbytes / 1e9 / resume_s:.3f} GB/s); parameters and moments "
            "byte-identical")
        a = model.train_batch([x], [y])[0]
        b = fresh.train_batch([x], [y])[0]
        if not abs(a - b) <= 1e-3:
            raise AssertionError(f"{phase}: next step {a} vs resumed {b}")
        log(f"[{phase}] one more step: live {a!r}, resumed {b!r} "
            f"(bitwise {'equal' if a == b else 'different'})")
        del fresh
        _release()
        # evaluate on 2 batches, predict on 1 x 2048: forward kernels only
        _build.reset_launch_counts()
        ev_logs = model.evaluate(hapi_loader(xs[:8], ys[:8], 4), verbose=0)
        ev_launch = _build.launch_counts()
        _gate_launches(phase, ev_launch, HAPI_PER_EVAL_BATCH, 2, L)
        _build.reset_launch_counts()
        pred = model.predict(DataLoader(TensorDataset([xs[:1]]),
                                        batch_size=1))
        pr_launch = _build.launch_counts()
        _gate_launches(phase, pr_launch, HAPI_PER_EVAL_BATCH, 1, L)
        logits = pred[0][0]
        if logits.shape != (1, 2048, cfg.vocab_size) \
                or logits.dtype != np.float32 \
                or not np.isfinite(logits).all() \
                or not math.isfinite(ev_logs["loss"][0]):
            raise AssertionError(f"{phase}: evaluate {ev_logs}, predict "
                                 f"{logits.shape} {logits.dtype}")
        log(f"[{phase}] evaluate loss {ev_logs['loss'][0]:.4f}; predict "
            f"{logits.shape} {logits.dtype}; eval and predict launches "
            f"{json.dumps({k: v for k, v in ev_launch.items() if v})}, "
            f"{json.dumps({k: v for k, v in pr_launch.items() if v})}")
        out.update(launches=launches, losses=losses, step_ms=mean_ms,
                   step_ms_writing=busy_ms,
                   saves_ms=saves, writes_ms=writes, wait_ms=wait_ms,
                   gen_bytes=nbytes, verify_gbps=nbytes / 1e9 / verify_s,
                   resume_gbps=nbytes / 1e9 / resume_s, next_step=(a, b))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def hapi_preemption(phase: str):
    """Part 2: in-process preemption on 2 layers at full width. An
    uninterrupted oracle fit (8 batches of 2 x 2048, 2 epochs), then the
    same run under chaos preempt_at:5 with checkpoint_freq=2 (an
    emergency generation at step 5), then a fresh Model resuming it to
    step 16: the merged trajectory within 1e-3 of the oracle's."""
    from paddle_tpu_torch.resilience import CheckpointManager, chaos

    cfg = hapi_config(2)
    x, y = hapi_tokens(cfg, 16, 2048, SEED + 1)
    loader = hapi_loader(x, y, 2)
    oracle = loss_tape()
    hapi_model(cfg, SEED).fit(loader, epochs=2, verbose=0,
                              callbacks=[oracle])
    _release()
    root = tempfile.mkdtemp(prefix="hapi-preempt-")
    try:
        first = loss_tape()
        model = hapi_model(cfg, SEED)
        chaos.install("preempt_at:5")
        try:
            model.fit(loader, epochs=2, verbose=0, callbacks=[first],
                      checkpoint_dir=root, checkpoint_freq=2)
        finally:
            chaos.uninstall()
        # the emergency generation's position (the resume below
        # verifies its shards)
        mgr = CheckpointManager(root)
        with open(os.path.join(mgr._gen_path(mgr.latest_generation()),
                               "manifest.json")) as f:
            meta = json.load(f)["meta"]
        if not model.preempted or len(first.losses) != 5 \
                or meta["global_step"] != 5:
            raise AssertionError(f"{phase}: preempted {model.preempted} "
                                 f"after {len(first.losses)} steps, "
                                 f"emergency generation meta {meta}")
        del model
        _release()
        second = loss_tape()
        resumed = hapi_model(cfg, SEED + 7)
        t0 = time.perf_counter()
        resumed.fit(loader, epochs=2, verbose=0, callbacks=[second],
                    checkpoint_dir=root, resume=True)
        resume_fit_s = time.perf_counter() - t0
        merged = first.losses + second.losses
        diff = max(abs(a - b) for a, b in zip(merged, oracle.losses))
        if resumed.restored_generation is None or len(merged) != 16 \
                or diff > 1e-3:
            raise AssertionError(
                f"{phase}: restored {resumed.restored_generation}, merged "
                f"{merged} vs oracle {oracle.losses}")
        log(f"[{phase}] preempt_at:5 -> emergency generation at global "
            f"step 5; resumed generation {resumed.restored_generation} to "
            f"step 16 in {resume_fit_s:.2f} s; merged trajectory vs oracle "
            f"max |diff| {diff:.3e} (bitwise "
            f"{'equal' if merged == oracle.losses else 'different'})")
        del resumed
        _release()
        return {"diff": diff, "bitwise": merged == oracle.losses}
    finally:
        shutil.rmtree(root, ignore_errors=True)


GANG_STEPS, GANG_FREQ = 8, 2


def gang_setup(rank: int):
    """One gang rank's run: Llama-1B widths at 1 layer from its own
    seed, 8 batches of 1 x 2048 of its own."""
    cfg = hapi_config(1)
    x, y = hapi_tokens(cfg, GANG_STEPS, 2048, SEED + 10 + rank)
    return hapi_model(cfg, SEED + 10 + rank), hapi_loader(x, y, 1)


def gang_worker(ckpt_dir: str, out_dir: str, t_start: float) -> None:
    """The body of a gang rank's process (GangSupervisor starts it
    through the script hapi_gang writes): fit with the gang coordinator
    from the environment, each step's loss flushed to a trail as it
    lands (a SIGKILLed rank leaves its partial trajectory)."""
    from paddle_tpu_torch.hapi import Callback
    from paddle_tpu_torch.resilience import coordination

    coord = coordination.from_env()
    model, loader = gang_setup(coord.rank)
    trail = open(os.path.join(
        out_dir, f"rank{coord.rank}-a{coord.attempt}.jsonl"), "w")

    class Trail(Callback):
        def on_train_batch_end(self, step, logs=None):
            trail.write(json.dumps({"step": step + 1,
                                    "loss": float(logs["loss"][0]),
                                    "t": time.time() - t_start}) + "\n")
            trail.flush()

    model.fit(loader, epochs=1, verbose=0, callbacks=[Trail()],
              checkpoint_dir=ckpt_dir, resume=True,
              checkpoint_freq=GANG_FREQ, coordinator=coord)
    with open(os.path.join(out_dir, f"rank{coord.rank}-a{coord.attempt}"
                           "-done.json"), "w") as f:
        json.dump({"restored": model.restored_generation,
                   "preempted": bool(model.preempted)}, f)


GANG_SCRIPT = """import sys, time
t_start = time.time()
sys.path.insert(0, sys.argv[3])
import chip_smoke
chip_smoke.gang_worker(sys.argv[1], sys.argv[2], t_start)
"""


def hapi_gang(phase: str):
    """Part 3: GangSupervisor runs 2 subprocess ranks on the card over a
    FileStore; PADDLE_TPU_CHAOS=preempt_host:1@5 on attempt 0 only
    SIGKILLs rank 1 after its step 5. Gates: 2 attempts with (1, 0, -9)
    among the restarts, both ranks restoring one agreed generation, each
    rank's merged trajectory within 1e-3 of its in-process oracle, the
    agreed floor kept in the group directory, every exit code of the
    last attempt 0."""
    from paddle_tpu_torch.parallel.launch import GangSupervisor

    oracles = {}
    for rank in range(2):
        model, loader = gang_setup(rank)
        tape = loss_tape()
        model.fit(loader, epochs=1, verbose=0, callbacks=[tape])
        oracles[rank] = tape.losses
        del model
    _release()
    root = tempfile.mkdtemp(prefix="hapi-gang-")
    try:
        ck, out, store = (os.path.join(root, n)
                          for n in ("ck", "out", "store"))
        for p in (ck, out, store):
            os.makedirs(p)
        script = os.path.join(root, "worker.py")
        with open(script, "w") as f:
            f.write(GANG_SCRIPT)
        repo = os.path.dirname(os.path.abspath(__file__))

        def env(rank, attempt):
            # the preemption is a one-shot external event: armed on
            # attempt 0 only, or the relaunched rank would be re-killed
            return {"PYTHONPATH": repo, "PADDLE_TPU_BARRIER_TIMEOUT_S": "30",
                    "PADDLE_TPU_CHAOS": "preempt_host:1@5" if attempt == 0
                    else ""}

        sup = GangSupervisor([sys.executable, script, ck, out, repo], 2,
                             store_dir=store, max_restarts=2, env=env,
                             terminate_grace_s=3.0)
        res = sup.run(timeout=300)
        logs = {os.path.basename(p): open(p).read()[-2000:]
                for p in sorted(glob.glob(os.path.join(store, "logs",
                                                       "*")))}
        if not res.success or res.attempts != 2 \
                or (1, 0, -9) not in res.restarts \
                or res.exit_codes != [0, 0]:
            raise AssertionError(f"{phase}: gang {res.as_dict()}; logs "
                                 f"{json.dumps(logs)[-6000:]}")
        restored, worst, first_step = set(), 0.0, {}
        for rank in range(2):
            merged = {}
            for a in range(2):
                path = os.path.join(out, f"rank{rank}-a{a}.jsonl")
                recs = [json.loads(line) for line in open(path)]
                first_step[(rank, a)] = recs[0]["t"] if recs else None
                for rec in recs:
                    if rec["step"] in merged and abs(
                            merged[rec["step"]] - rec["loss"]) > 1e-3:
                        raise AssertionError(
                            f"{phase}: rank {rank} step {rec['step']} "
                            "differs between attempts")
                    merged[rec["step"]] = rec["loss"]
            if sorted(merged) != list(range(1, GANG_STEPS + 1)):
                raise AssertionError(f"{phase}: rank {rank} trail {merged}")
            got = [merged[s] for s in range(1, GANG_STEPS + 1)]
            worst = max(worst, max(abs(a - b)
                                   for a, b in zip(got, oracles[rank])))
            with open(os.path.join(out, f"rank{rank}-a1-done.json")) as f:
                restored.add(json.load(f)["restored"])
        group = sorted(os.listdir(os.path.join(ck, "group")))
        if len(restored) != 1 or None in restored or worst > 1e-3 \
                or f"gen-{min(restored):08d}.json" not in group:
            raise AssertionError(f"{phase}: restored {restored}, worst "
                                 f"{worst}, group {group}")
        log(f"[{phase}] gang of 2 on one card: attempts {res.attempts}, "
            f"restarts {res.restarts}, both ranks restored generation "
            f"{min(restored)}, group {group}; merged trajectories vs the "
            f"in-process oracles max |diff| {worst:.3e}; recovery_wall_s "
            f"{res.recovery_wall_s:.3f}, wall {res.wall_s:.1f} s; time to "
            f"first step (s since process start) "
            f"{ {f'r{r}a{a}': round(t, 2) for (r, a), t in first_step.items() if t is not None} }")
        return {"result": res.as_dict(), "worst": worst,
                "first_step_s": {f"r{r}a{a}": t for (r, a), t
                                 in first_step.items()}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 24: the shared-memory loader; phase 25: the static audits
# ---------------------------------------------------------------------------

LOADER_STEPS = 8


def ring_segments():
    """This process's DataLoader rings in /dev/shm (each
    MultiprocessIter's)."""
    return sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith(f"ptt_ring_{os.getpid()}_"))


def ring_rate(nbytes: int = 64 << 20, reps: int = 5):
    """One process through the ring: encode a batch of one `nbytes` uint8
    tensor, push, pop, decode. Returns (GB/s, ms a round trip); the bytes
    come back equal."""
    from paddle_tpu_torch.io._native import ShmRing
    from paddle_tpu_torch.io.multiprocess import decode_batch, encode_batch

    g = torch.Generator().manual_seed(SEED)
    x = torch.randint(0, 256, (nbytes,), generator=g, dtype=torch.uint8)
    ring = ShmRing.create(f"/ptt_rate_{os.getpid()}", nbytes + (1 << 20), 2)
    try:
        out = None
        t0 = time.perf_counter()
        for _ in range(reps):
            if ring.push(encode_batch(0, (x,))) != 0:
                raise AssertionError("loader: the ring refused a batch")
            out = decode_batch(ring.pop())[1][0]
        dt = (time.perf_counter() - t0) / reps
    finally:
        ring.close()
    if not torch.equal(out, x):
        raise AssertionError("loader: the ring changed the batch's bytes")
    return nbytes / dt / 1e9, 1e3 * dt


def phase_loader(step_ms_13: float):
    """Phase 24, "loader": phase 23's fit on Llama-1B (bf16, batch 4 x
    2048) for LOADER_STEPS steps over one seeded token dataset, fed by
    DataLoader(num_workers=4, use_shared_memory=False) (threads) and then
    by use_shared_memory=True (four spawned workers over the ring). Gates:
    the two runs' losses bitwise equal, exact launches per step, and no
    ring segment or worker left. Logs ms a step for both loaders, the parent's wait for a
    batch (fit.data_fetch) and the ring's host rate on a 64 MiB batch."""
    import multiprocessing as mp

    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.observability import trace as obs_trace

    phase = "loader"
    cfg = hapi_config()
    L = cfg.num_hidden_layers
    x, y = hapi_tokens(cfg, 4 * LOADER_STEPS, 2048, SEED + 24)
    segments = ring_segments()
    runs = {}
    for shm in (False, True):
        model = hapi_model(cfg, SEED)
        loader = DataLoader(TensorDataset([x, y]), batch_size=4,
                            num_workers=4, use_shared_memory=shm)
        tape = loss_tape()
        tr = obs_trace.enable()
        _build.reset_launch_counts()
        try:
            model.fit(loader, epochs=1, verbose=0, callbacks=[tape])
        finally:
            obs_trace.disable()
        launches = _build.launch_counts()
        _gate_launches(phase, launches, HAPI_PER_TRAIN_STEP, LOADER_STEPS, L)
        spans = {}
        for ev in tr.events():
            if ev.get("ph") == "X":
                spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
        step = spans["fit.step"]
        fetch = spans["fit.data_fetch"]
        # steps 2-4 overlap the other workers' start (each spawned worker
        # imports torch); steps 5-8 run beside idle workers
        runs[shm] = dict(losses=tape.losses, launches=launches,
                         early_ms=sum(step[1:4]) / 3,
                         step_ms=sum(step[4:]) / len(step[4:]),
                         fetch_ms=fetch)
        if shm:
            runs[shm]["model"] = model
        else:
            del model
            _release()
    t, p = runs[False], runs[True]
    if len(p["losses"]) != LOADER_STEPS or p["losses"] != t["losses"]:
        raise AssertionError(f"{phase}: losses over threads {t['losses']} "
                             f"and over the ring {p['losses']} differ")
    if ring_segments() != segments or mp.active_children():
        raise AssertionError(f"{phase}: left {ring_segments()} in /dev/shm "
                             f"and {mp.active_children()} alive")
    gbps, rt_ms = ring_rate()
    log(f"[{phase}] {LOADER_STEPS} fit steps each way, losses bitwise "
        f"equal {[round(v, 4) for v in p['losses']]}; ms a step, steps "
        f"5-{LOADER_STEPS}: threads {t['step_ms']:.2f}, ring "
        f"{p['step_ms']:.2f} ({p['step_ms'] / t['step_ms']:.3f}x; phase "
        f"13's make_train_step {step_ms_13:.2f}); steps 2-4 (the other "
        f"workers still starting): threads {t['early_ms']:.2f}, ring "
        f"{p['early_ms']:.2f} ({p['early_ms'] / t['early_ms']:.3f}x); "
        f"the parent's wait for a "
        f"batch: threads {[round(v, 2) for v in t['fetch_ms']]} ms, ring "
        f"{[round(v, 2) for v in p['fetch_ms']]} ms (the first includes "
        f"the workers' start); the ring's host rate on a 64 MiB batch "
        f"(encode, push, pop, decode in one process) {gbps:.2f} GB/s, "
        f"{rt_ms:.2f} ms; no segment or worker left")
    return {"launches": p["launches"], "model": p["model"], "x": x, "y": y,
            "step_ms": p["step_ms"], "thread_step_ms": t["step_ms"],
            "ring_gbps": gbps}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _gate_audit_reports(phase, mem_diags, kernels, launches, what):
    if any(d["rule"] == "TPU701" for d in mem_diags):
        raise AssertionError(f"{phase}: TPU701 on {what}: {mem_diags}")
    if kernels != launches:
        raise AssertionError(f"{phase}: {what}'s kernel nodes {kernels} vs "
                             f"its launches {launches}")


def phase_audit(cfg, params):
    """Phase 25, "audit" (engine part): phase 2's engine (Llama-3-8B,
    bf16, megakernel off) warmed for phase 2's traffic, then
    warm(audit_memory=True, audit_roofline=True). Gates: the audits
    allocate nothing on the card and launch nothing, TPU701 is silent,
    and each program's kernel nodes equal the launches of one eager run
    of its body. Logs each program's predicted_step_ms beside its
    measured replay (CUDA events) and its predicted peak beside the
    allocator's peak over that eager run, the audits' wall time, and the
    H100 row's launch cost: one launch replayed from a CUDA graph and one
    eager."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.rms_norm import rms_norm

    phase = "audit"
    traffic = engine_traffic(cfg)
    eng = build_engine(cfg, params, traffic, **ENGINE_KW)
    buckets, widths = warm_args(eng, traffic)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    eng.warm(buckets=buckets, prefix_widths=widths, audit_memory=True,
             audit_roofline=True)
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t0
    after = torch.cuda.memory_allocated()
    if after != before or any(_build.launch_counts().values()):
        raise AssertionError(f"{phase}: the audits allocated {after - before}"
                             f" bytes or launched {_build.launch_counts()}")
    m = eng.metrics()
    mem, roof = m["memory_audit"], m["roofline_audit"]
    if not mem["donation_clean"]:
        raise AssertionError(f"{phase}: donation misses {mem}")
    log(f"[{phase}] warm(audit_memory=True, audit_roofline=True) on a warm "
        f"engine: {audit_s:.2f} s for {mem['programs_audited']} programs "
        f"(one trace each), allocated bytes unchanged, no launch; engine "
        f"peak {mem['fleet_peak_hbm_bytes'] / 2**30:.3f} GiB against the "
        f"{mem['hbm_budget_bytes'] / 2**30:.1f} GiB budget")
    base_bytes = _tensor_bytes((eng.p, eng.kcs, eng.vcs))
    rows = {}
    for name, fn, ins in eng._program_inventory():
        prog = eng._programs.get(name) or next(
            pg for pg in eng._prefill_cache.values() if pg.name == name)
        replay_ms = min(event_ms(prog) for _ in range(3))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        _build.reset_launch_counts()
        with torch.no_grad():
            fn(eng.p, eng.kcs, eng.vcs, *ins)
        torch.cuda.synchronize()
        eager = {k: n for k, n in _build.launch_counts().items() if n}
        peak = base_bytes + _tensor_bytes(ins) \
            + torch.cuda.max_memory_allocated() - start
        r, mp_ = roof["programs"][name], mem["programs"][name]
        _gate_audit_reports(phase, mp_["diagnostics"], r["kernels"], eager,
                            name)
        rows[name] = dict(predicted_ms=r["predicted_step_ms"],
                          replay_ms=replay_ms,
                          predicted_peak=mp_["peak_hbm_bytes"],
                          measured_peak=peak, kernels=r["kernels"])
        log(f"[{phase}] {name}: predicted {r['predicted_step_ms']:.3f} ms "
            f"({r['bound']}-bound: compute {r['compute_ms']:.3f}, HBM "
            f"{r['bandwidth_ms']:.3f}, launches {r['kernel_launches']} x "
            f"the row's cost {r['launch_overhead_ms']:.3f}) vs replayed "
            f"{replay_ms:.3f} ms: {r['predicted_step_ms'] / replay_ms:.3f}"
            f"; peak predicted {mp_['peak_hbm_bytes'] / 2**30:.3f} GiB vs "
            f"allocator {peak / 2**30:.3f} GiB over one eager run: "
            f"{mp_['peak_hbm_bytes'] / peak:.3f}; kernel nodes = launches "
            f"{json.dumps(eager)}")
    # the row's launch cost: a small kernel launched 2000 times, eagerly
    # and replayed from one CUDA graph
    x = torch.ones(1, 128, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(128, device="cuda", dtype=torch.bfloat16)
    n = 2000

    def launches():
        for _ in range(n):
            rms_norm(x, w)

    eager_us = min(event_ms(launches) for _ in range(3)) * 1e3 / n
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        launches()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launches()
    replay_us = min(event_ms(graph.replay) for _ in range(3)) * 1e3 / n
    log(f"[{phase}] launch cost: {replay_us:.3f} us a launch replayed from "
        f"a CUDA graph (the h100-sxm row's launch_overhead_s), "
        f"{eager_us:.3f} us eager (rms_norm [1, 128] bf16, {n} launches)")
    del graph, eng
    _release()
    return {"audit_s": audit_s, "rows": rows, "replay_us": replay_us,
            "eager_us": eager_us}


def phase_audit_fit(out24):
    """Phase 25, "audit" (training part): fit's audit of phase 24's
    Llama-1B step, traced once on fakes on the card (the hook
    fit(audit_memory=True, audit_roofline=True) calls at its first
    batch), then one fit step with both audits on. Gates: the audit
    allocates and launches nothing, TPU701 is silent, the step's kernel
    nodes equal phase 24's launches a step, and the fit hook leaves both
    reports. Logs predicted vs measured step time and peak (the
    allocator's over one train step)."""
    from paddle_tpu_torch.kernels import _build

    phase = "audit"
    model = out24.pop("model")
    ins, labs = [out24["x"][:4]], [out24["y"][:4]]

    def steps_ms(n=3):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.train_batch(ins, labs)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    # the steps beside the audit: a trace leaves large graphs to collect
    pre = steps_ms()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    model._audit_step(ins, labs, True, True)
    audit_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != before \
            or any(_build.launch_counts().values()):
        raise AssertionError(f"{phase}: fit's audit allocated or launched")
    post = steps_ms()
    step_ms = sum(pre) / len(pre)
    mem, roof = model.memory_audit, model.roofline_audit
    if mem is None or roof is None:
        raise AssertionError(f"{phase}: fit's audit made no report")
    per_step = {k: n // LOADER_STEPS for k, n in out24["launches"].items()
                if n}
    _gate_audit_reports(phase, mem["diagnostics"], roof["kernels"], per_step,
                        "fit's step")
    opt = model._optimizer
    held = _tensor_bytes([list(model.network.parameters()),
                          list(opt._accumulators.values())])
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    model.train_batch(ins, labs)
    torch.cuda.synchronize()
    peak = held + torch.cuda.max_memory_allocated() - start
    model.memory_audit = model.roofline_audit = None
    model.fit([(ins[0], labs[0])], epochs=1, verbose=0, audit_memory=True,
              audit_roofline=True)
    if model.memory_audit is None or model.roofline_audit is None:
        raise AssertionError(f"{phase}: fit(audit_*=True) left no report")
    log(f"[{phase}] fit's step (Llama-1B, batch 4 x 2048): audit {audit_s:.2f}"
        f" s, nothing allocated or launched; predicted "
        f"{roof['predicted_step_ms']:.2f} ms ({roof['bound']}-bound: compute "
        f"{roof['compute_ms']:.2f}, HBM {roof['bandwidth_ms']:.2f}, "
        f"{roof['kernel_launches']} launches) vs measured "
        f"{step_ms:.2f} ms: {roof['predicted_step_ms'] / step_ms:.3f} (steps "
        f"just before the audit {[round(v, 2) for v in pre]} ms, just "
        f"after {[round(v, 2) for v in post]}); peak predicted "
        f"{mem['peak_hbm_bytes'] / 2**30:.3f} GiB vs allocator "
        f"{peak / 2**30:.3f} GiB over one step: "
        f"{mem['peak_hbm_bytes'] / peak:.3f}; kernel nodes = launches a step "
        f"{json.dumps(per_step)}")
    del model
    _release()
    return {"audit_s": audit_s, "predicted_ms": roof["predicted_step_ms"],
            "peak": mem["peak_hbm_bytes"]}


def phase_hapi(step_ms_13: float):
    """Phase 23, "hapi": the trainer API over the resilience runtime on
    the card (parts 1-3 above). Its launches gate exactly: per train step
    16 flash_attention_fwd, 16 of each flash backward kernel and 33
    rms_norm; per eval or predict batch 16 flash_attention_fwd, 33
    rms_norm and no backward launch."""
    phase, out = "hapi", {}
    for part, fn in (("main", lambda: hapi_main_path(phase, step_ms_13)),
                     ("preempt", lambda: hapi_preemption(phase)),
                     ("gang", lambda: hapi_gang(phase))):
        t0 = time.perf_counter()
        out[part] = fn()
        _release()
        log(f"[{phase}] part {part} done in {time.perf_counter() - t0:.1f}s")
    out["launches"] = out["main"]["launches"]
    return out


# ---------------------------------------------------------------------------
# phase 26: the static autotuner, the engine's config= and the build cache
# ---------------------------------------------------------------------------

# the decode launch counter of each served rung, per pool dtype: off counts
# one paged decode launch a layer a step, attn / full one megakernel a
# layer a step, scan one megakernel a step
RUNG_COUNTER = {"off": ("paged_decode_attention", True),
                "attn": ("decode_layer_megakernel", True),
                "full": ("decode_layer_megakernel_full", True),
                "scan": ("decode_layers_megakernel", False)}

# phase 1's kernel build: wall seconds and the build cache's traffic
BUILD = {}

def rung_launches(eng, launches, device_steps: int) -> tuple:
    """(counter, launches, expected) of `eng`'s served decode rung over
    `device_steps` decode chunks of 8 steps."""
    name, per_layer = RUNG_COUNTER[eng.megakernel_rung]
    if eng.kv_dtype == "int8":
        name += "_int8"
    want = device_steps * 8 * (eng.cfg.num_hidden_layers if per_layer else 1)
    return name, launches[name], want


def chunk_times(eng, traffic) -> list:
    """Replayed decode chunks of 8 full slots (CUDA events, `event_ms`:
    phase 2's chunk ms): two batches of 8 requests of 32 new tokens, four
    chunks each."""
    out = []
    for batch in (traffic[:8], traffic[8:16]):
        for p in batch:
            eng.add_request(p, max_new=32)
        eng._admit()
        while eng.n_active:
            out.append(event_ms(eng.step))
    return out


def kendall_tau(a, b) -> float:
    """Kendall's tau between two orderings of the same items' scores."""
    n, s = len(a), 0
    for i in range(n):
        for j in range(i + 1, n):
            s += np.sign(a[i] - a[j]) * np.sign(b[i] - b[j])
    return float(s / (n * (n - 1) / 2)) if n > 1 else 1.0


def phase_tune(cfg, params):
    """Phase 26, "tune": autotune Llama-3-8B (phase 2's bf16 params and
    geometry) on the card's row at phase 2's page (64 tokens, of the
    card rule's [64, 128] for its prompt bucket: the 16 candidates of both
    pages took 165 s, over the tune's 150 s budget), every megakernel
    rung and both pool dtypes (the split path, no speculation: 8
    candidates). Gates: the tuner allocates
    nothing on the card (memory_allocated equal, the peak up by under 256
    MiB) and launches nothing; the baseline is feasible and the winner
    predicts no slower. The winner's artifact, saved to a temporary
    directory, builds ContinuousBatchingEngine(config=<dir>): each knob
    as the artifact says, metrics()['tuned_config'] equal to it. The
    winner (on that engine), the baseline (phase 2's configuration), the
    runner-up and the worst feasible candidate, each warmed, serve phase
    2's traffic under the same gates: compile_stats() steady, exact
    launches of the rung each serves, and tokens within 0.5 logit (1.0
    over int8 pools) of the bf16 plain forward's argmax, at whatever
    page each was tuned to; then each replays decode chunks (the median
    of 8, CUDA events). Predicted / measured, tokens/s and Kendall's tau
    of the two orders are printed, not gated. Last, a fresh process
    (`python -m paddle_tpu_torch.serving.restart_probe`) warms the card
    tests' narrow engine over the build directory phase 1 filled: no
    cache miss, hits == requests > 0."""
    from paddle_tpu_torch.analysis import autotune, tuner
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.llama import serving_block_size_candidates
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    phase = "tune"
    kw = {**SERVE_KW, **ENGINE_KW}
    traffic = engine_traffic(cfg)
    space = {k: [v] for k, v in tuner.baseline_config(cfg, kw).items()}
    # the card's page rule gives [64, 128] for phase 2's 128-token bucket;
    # 16 candidates traced in 165 s, over the tune's 150 s budget, so the
    # space keeps phase 2's page (phase 1 holds the kernels at 32 and 128)
    pages = serving_block_size_candidates(cfg,
                                          prompt_bucket=kw["prompt_bucket"])
    space.update(
        block_size=[kw["block_size"]],
        decode_megakernel=["off", "attn", "full", "scan"],
        kv_cache_dtype=["bf16", "int8"], unified_step=[False],
        speculative=["off"])
    gc.collect()
    _release()
    _build.reset_launch_counts()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    peak0 = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    rep = autotune(cfg, params, engine_kwargs=kw, space=space)
    tune_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - peak0
    if torch.cuda.memory_allocated() != before or grown >= 256 << 20 \
            or any(_build.launch_counts().values()):
        raise AssertionError(
            f"{phase}: autotune allocated "
            f"{torch.cuda.memory_allocated() - before} bytes (peak +"
            f"{grown}) or launched {_build.launch_counts()}")
    base, best = rep.baseline, rep.best
    if not base.feasible or best.predicted_step_ms is None \
            or best.predicted_step_ms > base.predicted_step_ms:
        raise AssertionError(f"{phase}: baseline {base.to_dict()}, best "
                             f"{best.to_dict()}")
    log(f"[{phase}] autotune of {rep.n_candidates} candidates (pages "
        f"{space['block_size']} of the rule's {pages}) in {tune_s:.1f} s: "
        f"allocated bytes "
        f"unchanged, peak +{grown} B, no launch; {len(rep.ranking)} "
        f"feasible under {rep.hbm_budget_bytes / 2**30:.1f} GiB")
    for i, c in enumerate(rep.ranking + rep.pruned):
        k = c.config
        what = (f"predicted {c.predicted_step_ms:.3f} ms a chunk "
                f"({c.bound}-bound), peak {c.peak_hbm_bytes / 2**30:.3f} GiB"
                if c.feasible else f"pruned: {c.pruned_reason}")
        log(f"[{phase}] #{i + 1} page {k['block_size']} rung "
            f"{k['decode_megakernel']} pools {k['kv_cache_dtype']}: {what}, "
            f"static bound {c.static_bound_bytes / 2**30:.3f} GiB")

    # the winner through its artifact
    geometry = {k: v for k, v in kw.items() if k not in tuner.KNOBS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        tuned = rep.tuned_config()
        tuned.save(tmp)
        eng = ContinuousBatchingEngine(cfg, params, config=tmp, **geometry)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k = tuned.knobs
    got = dict(block_size=eng.block_size, decode_megakernel=eng.use_megakernel,
               kv_cache_dtype=eng.kv_dtype, unified_step=eng.unified,
               token_budget=eng.token_budget, speculative=eng.speculative)
    if any(got[n] != k[n] for n in got) \
            or eng.metrics()["tuned_config"] != tuned.to_dict():
        raise AssertionError(f"{phase}: the engine resolved {got} from "
                             f"the artifact's knobs {k}")
    warm_for(eng, traffic, tag=phase)
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)

    def measure(tags, c, e):
        """Serve phase 2's traffic through `e` (candidate `c`) under the
        artifact engine's gates (compile_stats steady, exact launches of
        its rung, ranks against the bf16 plain forward), then replay its
        decode chunks: (tags, c, chunk ms, tok/s)."""
        where = f"{phase}/{'='.join(tags)}"
        stats = e.compile_stats()
        reqs, wall, launches, m = serve(e, traffic, where)
        if e.compile_stats() != stats:
            raise AssertionError(f"{where}: traffic grew compile_stats "
                                 f"{stats} -> {e.compile_stats()}")
        name, n, want = rung_launches(e, launches, m["device_steps"])
        _gate_exact(where, launches, name, want)
        limit = INT8_RANK_MARGIN if e.kv_dtype == "int8" else 0.5
        worst = _gate_ranks(where, plain, [reqs[0], reqs[-1]], limit)
        times = chunk_times(e, traffic)
        tok_s = sum(len(r.tokens) for r in reqs) / wall
        ms = float(np.median(times))
        log(f"[{phase}] {'='.join(tags)} (page {c.config['block_size']}, "
            f"rung {c.config['decode_megakernel']} served "
            f"{e.megakernel_rung}, {c.config['kv_cache_dtype']} pools): "
            f"{n} {name} launches, worst gap {worst:.3f} (limit {limit}), "
            f"compile_stats steady; predicted {c.predicted_step_ms:.3f} ms "
            f"a chunk, measured {ms:.3f} (median of {len(times)}, CUDA "
            f"events; {min(times):.3f}-{max(times):.3f}): predicted / "
            f"measured {c.predicted_step_ms / ms:.3f}; {tok_s:.1f} tok/s")
        return tags, c, ms, tok_s

    # predicted against measured: baseline, winner, runner-up, worst; a
    # candidate in two roles is measured once under both names
    picks = {}
    for tag, c in (("baseline", base), ("winner", best),
                   ("runner-up", rep.ranking[min(1, len(rep.ranking) - 1)]),
                   ("worst", rep.ranking[-1])):
        picks.setdefault(tuner._config_key(c.config), ([], c))[0].append(tag)
    rows = []
    for key, (tags, c) in picks.items():
        if key == tuner._config_key(best.config):
            e, eng = eng, None          # the artifact's engine
        else:
            e = build_engine(cfg, params, traffic, **ENGINE_KW, **{
                n: v for n, v in c.config.items()
                if n != "quantized_collectives"})
        rows.append(measure(tags, c, e))
        del e
        gc.collect()
        _release()
    del plain
    gc.collect()
    _release()
    tau = kendall_tau([r[1].predicted_step_ms for r in rows],
                      [r[2] for r in rows])
    order = ["=".join(r[0]) for r in sorted(rows, key=lambda r: r[2])]
    ms_of = {t: r[2] for r in rows for t in r[0]}
    log(f"[{phase}] measured order {order} (fastest first); Kendall's tau "
        f"of predicted vs measured over {len(rows)}: {tau:.3f}; winner vs "
        f"baseline: {ms_of['baseline'] / ms_of['winner']:.3f}x chunk")

    # the build cache across processes
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.restart_probe"],
        capture_output=True, text=True,
        timeout=600, env=dict(os.environ,
                              PYTHONPATH=os.path.dirname(
                                  os.path.abspath(__file__))))
    if out.returncode:
        raise AssertionError(f"{phase}: the fresh process failed: "
                             f"{out.stderr[-3000:]}")
    wcs = json.loads(out.stdout.strip().splitlines()[-1])
    if wcs["cache_misses"] != 0 or wcs["compile_requests"] <= 0 \
            or wcs["cache_hits"] != wcs["compile_requests"]:
        raise AssertionError(f"{phase}: warm_compile_stats {wcs}")
    log(f"[{phase}] a fresh process warmed an engine over "
        f"{wcs['persistent_cache_dir']}: {wcs['compile_requests']} "
        f"libraries requested, {wcs['cache_hits']} found built, "
        f"{wcs['cache_misses']} built; its wall {wcs['wall_s']:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with the interpreter); phase 1 "
        f"built {BUILD['cache_misses']} of {BUILD['compile_requests']} "
        f"libraries in {BUILD['s']:.1f} s")
    return {"tune_s": tune_s, "rows": [("=".join(t), c.config,
                                        c.predicted_step_ms, ms, tok)
                                       for t, c, ms, tok in rows],
            "tau": tau, "warm_compile_stats": wcs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    import paddle_tpu_torch  # noqa: F401  (fails alone, without the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    kernels = phase_kernels()
    cfg, params = build_model()
    # each kernel's launches come from the phase that drives its path
    phases = {}
    for name, fn in (
            ("engine", lambda: phase_engine(cfg, params)),
            ("engine-db",
             lambda: phase_double_buffer(cfg, params, phases["engine"])),
            ("prefix", lambda: phase_prefix_cache(cfg, params)),
            ("unified", lambda: phase_unified(cfg, params)),
            ("int8-split",
             lambda: phase_int8_split(cfg, params, phases["prefix"])),
            ("int8-unified", lambda: phase_int8_unified(cfg, params)),
            ("int4-split", lambda: phase_int4_split(cfg)),
            ("int8w-int8kv-unified",
             lambda: phase_int8w_unified(cfg, params)),
            ("quant-generate", lambda: quant_generate(
                cfg, phases["int4-split"]["params"], "weight_only_int4",
                "quant-generate", "gqa_decode_attention")),
            ("quant-generate-7b", phase_quant_generate_7b),
            ("mega-scan", lambda: phase_mega_scan(cfg, params)),
            ("mega-full", lambda: phase_mega_full(
                cfg, params, phases["int8w-int8kv-unified"])),
            ("mega-attn", lambda: phase_mega_attn(cfg, params,
                                                  phases["engine"])),
            ("spec-ngram", lambda: phase_spec_ngram(cfg, params)),
            ("spec-self", lambda: phase_spec_self(cfg, params)),
            ("spec-scan-unified",
             lambda: phase_spec_scan_unified(cfg, params)),
            ("disagg", lambda: phase_disagg(cfg, params, phases["prefix"],
                                            phases["unified"])),
            ("generate", lambda: phase_generate(cfg, params)),
            ("checkpoint", lambda: phase_checkpoint(
                cfg, params, phases["int8w-int8kv-unified"])),
            ("observe", lambda: phase_observe(cfg, params)),
            ("fleet", lambda: phase_fleet(cfg, params, phases["prefix"])),
            ("audit", lambda: phase_audit(cfg, params)),
            ("tune", lambda: phase_tune(cfg, params))):
        t0 = time.perf_counter()
        phases[name] = fn()
        log(f"[phase] {name} done in {time.perf_counter() - t0:.1f}s")
    # training after serving: the serving weights go first (the engines
    # hold them in reference cycles, so collect before releasing)
    params = None
    phases["int4-split"].pop("params")
    gc.collect()
    _release()
    log(f"[phase] serving state freed: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    for name, fn in (("train", phase_train),
                     ("train-swiglu", phase_train_swiglu),
                     ("hapi", lambda: phase_hapi(phases["train"]["step_ms"])),
                     ("loader",
                      lambda: phase_loader(phases["train"]["step_ms"])),
                     ("audit-fit", lambda: phase_audit_fit(phases["loader"]))):
        t0 = time.perf_counter()
        phases[name] = fn()
        log(f"[phase] {name} done in {time.perf_counter() - t0:.1f}s")
    own_phase = {"rms_norm": "engine", "flash_attention_fwd": "engine",
                 "paged_decode_attention": "engine",
                 "prefix_prefill_attention": "prefix",
                 "ragged_paged_attention": "unified",
                 "paged_decode_attention_int8": "int8-split",
                 "prefix_prefill_attention_int8": "int8-split",
                 "ragged_paged_attention_int8": "int8-unified",
                 "int4_matmul": "int4-split",
                 "int8_weight_matmul": "int8w-int8kv-unified",
                 "gqa_decode_attention": "quant-generate",
                 "decode_attention": "quant-generate-7b",
                 "decode_layers_megakernel": "mega-scan",
                 "decode_layer_megakernel_full": "mega-scan-full",
                 "decode_layer_megakernel_full_int8": "mega-full",
                 "decode_layer_megakernel": "mega-attn",
                 "flash_attention_bwd_dq": "train",
                 "flash_attention_bwd_dkv": "train",
                 "flash_attention_bwd_delta": "train",
                 "swiglu_fwd": "train-swiglu", "swiglu_bwd": "train-swiglu"}
    phases["mega-scan-full"] = {
        "launches": phases["mega-scan"]["full_launches"]}

    sources = {
        "rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                     "paddle_tpu/kernels/rms_norm.py:22"),
        "flash_attention_fwd": (
            "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
            "paddle_tpu/kernels/flash_attention.py:123"),
        "paged_decode_attention": (
            "paddle_tpu_torch/csrc/paged_decode_attention.cu",
            "paddle_tpu/kernels/decode_attention.py:422"),
        "prefix_prefill_attention": (
            "paddle_tpu_torch/csrc/paged_prefill_attention.cu",
            "paddle_tpu/kernels/prefix_prefill.py:266"),
        "ragged_paged_attention": (
            "paddle_tpu_torch/csrc/paged_prefill_attention.cu",
            "paddle_tpu/kernels/ragged_attention.py:73"),
        "paged_decode_attention_int8": (
            "paddle_tpu_torch/csrc/paged_decode_attention.cu",
            "paddle_tpu/kernels/decode_attention.py:430"),
        "prefix_prefill_attention_int8": (
            "paddle_tpu_torch/csrc/paged_prefill_attention.cu",
            "paddle_tpu/kernels/prefix_prefill.py:248"),
        "ragged_paged_attention_int8": (
            "paddle_tpu_torch/csrc/paged_prefill_attention.cu",
            "paddle_tpu/kernels/ragged_attention.py:91"),
        "int4_matmul": ("paddle_tpu_torch/csrc/weight_only_gemv.cu",
                        "paddle_tpu/kernels/int4_matmul.py:76"),
        # the int8 product XLA fuses into the dot: no Pallas kernel
        "int8_weight_matmul": ("paddle_tpu_torch/csrc/weight_only_gemv.cu",
                               "paddle_tpu/models/llama.py:685"),
        "gqa_decode_attention": (
            "paddle_tpu_torch/csrc/decode_attention.cu",
            "paddle_tpu/kernels/decode_attention.py:512"),
        "decode_attention": ("paddle_tpu_torch/csrc/decode_attention.cu",
                             "paddle_tpu/kernels/decode_attention.py:156"),
        "decode_layers_megakernel": (
            "paddle_tpu_torch/csrc/decode_megakernel.cu",
            "paddle_tpu/kernels/decode_megakernel.py:868"),
        "decode_layer_megakernel_full": (
            "paddle_tpu_torch/csrc/decode_megakernel.cu",
            "paddle_tpu/kernels/decode_megakernel.py:1351"),
        "decode_layer_megakernel_full_int8": (
            "paddle_tpu_torch/csrc/decode_megakernel.cu",
            "paddle_tpu/kernels/decode_megakernel.py:1351"),
        "decode_layer_megakernel": (
            "paddle_tpu_torch/csrc/decode_megakernel.cu",
            "paddle_tpu/kernels/decode_megakernel.py:239"),
        "flash_attention_bwd_dq": (
            "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "paddle_tpu/kernels/flash_attention.py:265"),
        "flash_attention_bwd_dkv": (
            "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "paddle_tpu/kernels/flash_attention.py:311"),
        # part of the dkv redesign: the delta that _bwd_dkv_kernel
        # recomputes per tile, once per query row (no kernel of its own
        # in the JAX package)
        "flash_attention_bwd_delta": (
            "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "paddle_tpu/kernels/flash_attention.py:352"),
        "swiglu_fwd": ("paddle_tpu_torch/csrc/swiglu.cu",
                       "paddle_tpu/kernels/swiglu.py:92"),
        "swiglu_bwd": ("paddle_tpu_torch/csrc/swiglu.cu",
                       "paddle_tpu/kernels/swiglu.py:142"),
    }
    rows = []
    for name, cases in kernels.items():
        if name not in own_phase:
            continue    # a variant no phase serves: checked in phase 1 only
        n = phases[own_phase[name]]["launches"][name]
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 f"{own_phase[name]} phase's main path")
        main_case = cases[0]
        row = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": n,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]}
        if "call_ms" in main_case:      # the megakernels: a call's own time
            row["call_ms"] = main_case["call_ms"]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
