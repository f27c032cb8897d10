#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Build the hand-written kernels from paddle_tpu_torch/csrc (one nvcc
   per source, in parallel) and hold each kernel against its plain
   PyTorch version on the card at the serving path's shapes, timed with
   CUDA events beside its roofline bound and one PyTorch library call
   as a yardstick (the port never calls it).
2. Serve 16 requests through ContinuousBatchingEngine at Llama-3-8B full
   width (32 layers, random bf16 weights from a seed), with every kernel
   launch counter reset just before and read just after; then hold the
   served tokens against a teacher-forced plain forward.
3. Print the kernel table as one JSON line, the card's name and power
   limit, and the closing {"ok": true, ...} line.

Exits non-zero (and prints no result) without a CUDA device, or when
the paddle_tpu_torch package is not beside this script.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
SEED = 0


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


def check_paged_decode(b: int, hq: int, hkv: int, d: int, bs: int):
    """Permuted tables, ragged lens including 0, a page boundary
    (lens = k*bs - 1 and k*bs) and a row past its table (lens >= W*bs).
    Both versions score and accumulate in f32 from the same bf16 inputs
    and round once: one bf16 ulp apart at most (ulp_check)."""
    from paddle_tpu_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    g = torch.Generator(device="cuda").manual_seed(SEED + hq)
    w = 9                                  # 544 positions per row
    n_pages = b * w + 1
    pools = [torch.randn(n_pages, hkv, bs, d, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2)]
    q = torch.randn(b, hq, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(SEED)) + 1
    tables = perm[: b * w].reshape(b, w).to(torch.int32).cuda()
    lens_l = [0, bs - 1, bs, 3 * bs + 17, 500, w * bs - 1, w * bs + 5, 257]
    lens = torch.tensor((lens_l * b)[:b], dtype=torch.int32, device="cuda")
    args = (q, pools[0], pools[1], tables, lens)
    err = ulp_check(f"paged_decode_attention Hq{hq}/Hkv{hkv}",
                    paged_decode_attention(*args),
                    paged_decode_attention_reference(*args))
    ms = time_ms(lambda: paged_decode_attention(*args))
    plain_ms = time_ms(lambda: paged_decode_attention_reference(*args))
    # library yardstick: SDPA over the cache gathered beforehand
    tl = tables.long()
    kg, vg = (p[tl].permute(0, 2, 1, 3, 4).reshape(b, hkv, w * bs, d)
              for p in pools)
    mask = (torch.arange(w * bs, device="cuda")[None, :]
            <= lens.long()[:, None])[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kg, vg, attn_mask=mask, enable_gqa=True))
    # pages this run's lens name: min(W, len // bs + 1) per row
    pages = sum(min(w, int(n) // bs + 1) for n in lens.tolist())
    ctx = pages * bs
    n_bytes = 2 * ctx * hkv * d * 2 + 2 * b * hq * d * 2 + b * (w + 1) * 4
    b_ms, by = bound_ms(n_bytes, 4 * hq * d * ctx)
    return dict(case=f"B{b} Hq{hq} Hkv{hkv} D{d} block{bs} pages{pages}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=lib_ms)


def phase_kernels():
    """Returns {kernel name: [case results]}; the first case of each is
    at the shape the engine's main path gives it."""
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {sorted(_build.SIGNATURES)} in "
        f"{time.perf_counter() - t0:.1f}s")
    res = {
        "rms_norm": [check_rms_norm(8 * 512, 4096), check_rms_norm(8, 4096)],
        "flash_attention_fwd": [check_flash(4, 512, 512, 32, 8, 128),
                                check_flash(1, 300, 300, 32, 8, 128),
                                check_flash(2, 200, 333, 32, 8, 128)],
        "paged_decode_attention": [check_paged_decode(8, 32, 8, 128, 64),
                                   check_paged_decode(8, 32, 32, 128, 64)],
    }
    for name, cases in res.items():
        for c in cases:
            log(f"[kernel] {name} {c['case']}: {c['ms']:.4f} ms, bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']}), "
                f"{100 * c['bound_ms'] / c['ms']:.1f}% of bound; plain "
                f"{c['plain_ms']:.4f} ms; library {c['library_ms']:.4f} "
                f"ms; max_abs_err {c['max_abs_err']:.3e}")
    return res


# ---------------------------------------------------------------------------
# phase 2: the engine at full width
# ---------------------------------------------------------------------------

def phase_engine():
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         init_serving_params)
    from paddle_tpu_torch.models.llama import (_make_head_logits,
                                               _make_prefill)
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_serving_params(cfg, seed=SEED, device="cuda",
                                 dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    log(f"[engine] Llama-3-8B {n_params / 1e9:.2f}B params bf16 on card in "
        f"{time.perf_counter() - t0:.1f}s")
    eng = ContinuousBatchingEngine(
        cfg, params, slots=8, prompt_bucket=128, max_prompt_len=512,
        max_new_tokens=32, block_size=64, steps_per_sync=8,
        dtype=torch.bfloat16, device="cuda")
    eng.warm()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(16, 501, 16)]

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()

    for r in reqs:
        if not r.done or len(r.tokens) != 32:
            raise AssertionError(f"request {r.req_id}: {len(r.tokens)} "
                                 "tokens, expected 32")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.req_id}: token out of vocab")
    m = eng.metrics()
    n_tok = sum(len(r.tokens) for r in reqs)
    chunk_ms = 1e3 * m["decode_s"] / max(m["device_steps"], 1)
    log(f"[engine] 16 requests, {n_tok} tokens in {wall:.3f}s: "
        f"{n_tok / wall:.1f} tok/s; {m['prefill_calls']} prefill calls "
        f"{m['prefill_s']:.3f}s; {m['device_steps']} decode chunks of 8 "
        f"steps x 8 slots, {chunk_ms:.2f} ms per chunk; launches "
        f"{json.dumps(launches)}")

    # numerics: teacher-forced plain forward over prompt + generated
    # tokens (plain rms_norm / attention on the card, same weights), and
    # the same plain forward in f32 as the control both bf16 paths are
    # measured against
    plain = LlamaForCausalLM(cfg, use_kernels=False).load_params(params)
    params32 = {k: v.float() for k, v in params.items()}
    plain32 = LlamaForCausalLM(cfg, use_kernels=False).load_params(params32)
    head = _make_head_logits(cfg)

    def rel_rms(a, b):
        return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())

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
    profile_decode(eng, prompts[:8])
    return {"launches": launches, "tok_s": n_tok / wall,
            "chunk_ms": chunk_ms, "worst": worst}


def profile_decode(eng, prompts):
    """One short traced window (8 requests, 8 new tokens each) after the
    counted run: device time by kernel and the device's busy share of
    the host wall time. Its launches are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.add_request(p, max_new=9)
    eng._admit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    eng.run()
    # device-side events only: a CPU op (aten::mm) also reports the
    # time of the kernels it launched, which would count them twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    log(f"[profile] one decode chunk (8 steps x 8 slots): wall "
        f"{wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[profile]   {ms:8.3f} ms  x{count:<5d} {key[:90]}")


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
    engine = phase_engine()

    sources = {
        "rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                     "paddle_tpu/kernels/rms_norm.py:22"),
        "flash_attention_fwd": (
            "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
            "paddle_tpu/kernels/flash_attention.py:123"),
        "paged_decode_attention": (
            "paddle_tpu_torch/csrc/paged_decode_attention.cu",
            "paddle_tpu/kernels/decode_attention.py:422"),
    }
    rows = []
    for name, cases in kernels.items():
        n = engine["launches"][name]
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 "engine's main path")
        main_case = cases[0]
        rows.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": n,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]})
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
