#!/usr/bin/env python3
"""Same-card measurements of the port beside chip_smoke.py: one checkout's
kernels against another's on fixed inputs, end-to-end phases, and
variants of the decode and flash-backward kernels.

    python3 port_measure.py kernels TREE LABEL OUT.json
    python3 port_measure.py e2e TREE LABEL
    python3 port_measure.py variants

TREE is a directory holding `paddle_tpu_torch/` and `chip_smoke.py` (this
checkout is `.`; an earlier commit unpacks with `git archive COMMIT
paddle_tpu_torch chip_smoke.py | tar -x -C DIR`). Compare two trees by
running them in turns in one session on one card (A, B, B, A): calls on
different hosts differ by more than the kernels do.

- kernels: contiguous and paged decode attention at chip_smoke phase 1's
  cases and at Llama-3-8B's 8k context (B8 Hq32 Hkv8, lens 0..8191 on the
  split edges), bf16 and int8 pools, timed cold (operands past the L2) and
  warm; the flash backward dq / dkv at bench.py's shape and at Llama-3's
  heads. Appends {LABEL: [times]} to OUT.json.
- e2e: the decode wrappers' host time per call, then chip_smoke phases 2
  (the engine), 9 (build_quant_generate over int4 weights) and 13 (the
  Llama-1B train step), with their own logs.
- variants: this checkout's decode body rebuilt with four warps, and with
  its P V partial sums capped to fit three blocks per SM, against the
  built eight warps, each at 4, 8 and 16 blocks per SM by the split rule
  (chip_smoke's gates apply); the dkv kernel rebuilt with q tiles of 32
  rows against 64.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

# chip_smoke.LENS_8K (an earlier tree's chip_smoke may lack it)
LENS_8K = [0, 959, 960, 1919, 4095, 5761, 8190, 8191]


def _import_tree(tree: str):
    sys.path.insert(0, os.path.abspath(tree))
    sys.argv = sys.argv[:1]
    import chip_smoke
    from paddle_tpu_torch.kernels import _build
    if not _build.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {_build.__file__}, not {tree}'s")
    _build.build_all()
    return chip_smoke, _build


def kernels(tree: str, label: str, out_path: str) -> None:
    cs, _ = _import_tree(tree)
    time_ms, time_cold_ms = cs.time_ms, cs.time_cold_ms
    from paddle_tpu_torch.kernels.decode_attention import (
        decode_attention, gqa_decode_attention, paged_decode_attention)
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    from paddle_tpu_torch.models.llama import quantize_kv_pages

    res = {}

    def contig(name, fn, hq, hkv, ms, lens_l):
        g = torch.Generator(device="cuda").manual_seed(hq + hkv + ms)
        q = torch.randn(8, hq, 128, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        kc, vc = (torch.randn(8, hkv, ms, 128, generator=g, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        res[name] = time_cold_ms(fn, (q, kc, vc, lens))

    def paged(name, hq, hkv, w, lens_l, q8):
        b, bs = 8, 64
        g = torch.Generator(device="cuda").manual_seed(hq + w)
        n_pages = b * w + 1
        pools = [torch.randn(n_pages, hkv, bs, 128, generator=g,
                             device="cuda", dtype=torch.bfloat16)
                 for _ in range(2)]
        q = torch.randn(b, hq, 128, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        perm = torch.randperm(n_pages - 1,
                              generator=torch.Generator().manual_seed(0)) + 1
        tables = perm[: b * w].reshape(b, w).to(torch.int32).cuda()
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        if q8:
            (kc, ks), (vc, vs) = (quantize_kv_pages(p) for p in pools)
            ops = (q, kc, vc, tables, lens, ks, vs)

            def fn(q, kc, vc, t, n, ks, vs):
                return paged_decode_attention(q, kc, vc, t, n, k_scale=ks,
                                              v_scale=vs)
        else:
            ops = (q, pools[0], pools[1], tables, lens)
            fn = paged_decode_attention
        res[name + " warm"] = time_ms(lambda: fn(*ops))
        res[name + " cold"] = time_cold_ms(fn, ops)

    p1 = [0, 63, 64, 300, 447, 500, 1022, 1023]
    contig("contig GQA B8 Hq32 Hkv8 ms1024 (phase 1)", gqa_decode_attention,
           32, 8, 1024, p1)
    contig("contig eq B8 Hq32 Hkv32 ms1024", decode_attention, 32, 32, 1024,
           p1)
    contig("contig GQA B8 Hq32 Hkv8 ms8192 (8k)", gqa_decode_attention, 32,
           8, 8192, LENS_8K)
    pl = [0, 63, 64, 3 * 64 + 17, 500, 9 * 64 - 1, 9 * 64 + 5, 257]
    for q8 in (False, True):
        t = " int8" if q8 else " bf16"
        paged("paged GQA W9 (phase 1)" + t, 32, 8, 9, pl, q8)
        paged("paged eq W9" + t, 32, 32, 9, pl, q8)
        paged("paged GQA W128 (8k)" + t, 32, 8, 128, LENS_8K, q8)
    for b, s, hq, hkv in ((4, 2048, 16, 4), (1, 2048, 32, 8)):
        g = torch.Generator(device="cuda").manual_seed(hq)
        q, do = (torch.randn(b, s, hq, 128, generator=g, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, s, hkv, 128, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        args = (q, k, v, out, lse, do, True, 128 ** -0.5)
        case = f"B{b} S{s} Hq{hq} Hkv{hkv}"
        res["dq " + case] = time_ms(lambda: flash_attention_bwd_dq(*args),
                                    iters=10)
        res["dkv " + case] = time_ms(lambda: flash_attention_bwd_dkv(*args),
                                     iters=10)
    print(label, json.dumps(res, indent=1), flush=True)
    prev = json.load(open(out_path)) if os.path.exists(out_path) else {}
    prev.setdefault(label, []).append(res)
    with open(out_path, "w") as f:
        json.dump(prev, f, indent=1)


def e2e(tree: str, label: str) -> None:
    cs, _build = _import_tree(tree)
    from paddle_tpu_torch.kernels.decode_attention import (
        gqa_decode_attention, paged_decode_attention)
    from paddle_tpu_torch.models import init_quant_serving_params

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(8, 32, 128, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    kc, vc = (torch.randn(8, 8, 1024, 128, generator=g, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    lens = torch.tensor([0, 63, 64, 300, 447, 500, 1022, 1023],
                        dtype=torch.int32, device="cuda")
    pools = [torch.randn(73, 8, 64, 128, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2)]
    tables = torch.arange(1, 73, device="cuda",
                          dtype=torch.int32).reshape(8, 9)
    for name, fn in (
            ("gqa_decode_attention",
             lambda: gqa_decode_attention(q, kc, vc, lens)),
            ("paged_decode_attention",
             lambda: paged_decode_attention(q, pools[0], pools[1], tables,
                                            lens))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"[{label}] host {name}: {1e6 * (t1 - t0) / 500:.1f} us per "
              f"call enqueued, {1e6 * (t2 - t0) / 500:.1f} us per call with "
              f"the device", flush=True)
    del q, kc, vc, pools
    cfg, params = cs.build_model()
    cs.phase_engine(cfg, params)
    p4 = init_quant_serving_params(cfg, "weight_only_int4", seed=cs.SEED,
                                   device="cuda")
    cs.quant_generate(cfg, p4, "weight_only_int4", "quant-generate",
                      "gqa_decode_attention")
    del p4, params
    cs._release()
    cs.phase_train()
    print(f"[{label}] done", flush=True)


def _rebuilt(_build, tmp: str, tag: str, edits, names):
    """The libraries `names` built from a copy of csrc with `edits`
    ((file, old, new) string replacements), loaded like _build's."""
    d = os.path.join(tmp, tag)
    shutil.copytree(_build.CSRC, d)
    for fname, old, new in edits:
        path = os.path.join(d, fname)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"{tag}: {old!r} not in {fname}")
        open(path, "w").write(text.replace(old, new))
    libs = {}
    for name in names:
        so = os.path.join(d, name + ".so")
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                            "-v", f"-I{d}", "-o", so,
                            os.path.join(d, name + ".cu")],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"{tag}: nvcc failed\n{r.stderr[-3000:]}")
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                   r.stderr)})
        print(f"[variants] {tag} {name}: registers {regs}", flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build.SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def variants() -> None:
    cs, _build = _import_tree(".")
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_delta, flash_attention_bwd_dkv)

    tmp = tempfile.mkdtemp()
    dec = ("decode_attention", "paged_decode_attention")
    body = "decode_attention_body.cuh"
    built = {n: _build.library(n) for n in dec}
    four_warps = (body, "constexpr int DEC_THREADS = 256;",
                  "constexpr int DEC_THREADS = 128;")
    capped = (body, "  return G >= rows ? 1 : rows / G;",
              "  return max(1, min(G >= rows ? 1 : rows / G, "
              "1024 / (G * D)));")
    shapes = {"eight warps (built)": built,
              "four warps": _rebuilt(_build, tmp, "four", [four_warps], dec),
              "eight warps, P V sums capped to three blocks per SM":
                  _rebuilt(_build, tmp, "capped", [capped], dec)}
    for shape, libs in shapes.items():
        _build._LIBS.update(libs)
        for bpsm in (4, 8, 16):
            da._BLOCKS_PER_SM = bpsm
            rows = [
                cs.check_contiguous_decode("gqa_decode_attention", 8, 32, 8,
                                           128, 1024),
                cs.check_contiguous_decode("gqa_decode_attention", 8, 32, 8,
                                           128, 8192, LENS_8K),
                cs.check_contiguous_decode("decode_attention", 8, 32, 32,
                                           128, 1024),
                cs.check_paged_decode(8, 32, 8, 128, 64),
                cs.check_paged_decode(8, 32, 8, 128, 64, q8=True),
                cs.check_paged_decode(8, 32, 8, 128, 64, w=128,
                                      lens_l=LENS_8K, q8=True)]
            print(f"[variants] decode, {shape}, {bpsm} blocks/SM: "
                  + "; ".join(f"{r['case']} {r['ms']:.4f} ms" for r in rows),
                  flush=True)
    _build._LIBS.update(built)
    da._BLOCKS_PER_SM = 4

    dkv = {"q tiles of 64 rows (built)": _build.library("flash_attention_bwd"),
           "q tiles of 32 rows": _rebuilt(
               _build, tmp, "q32", [("flash_attention_bwd.cu",
                                     "constexpr int DKV_QROWS = 64;",
                                     "constexpr int DKV_QROWS = 32;")],
               ("flash_attention_bwd",))["flash_attention_bwd"]}
    g = torch.Generator(device="cuda").manual_seed(16)
    for b, s, hq, hkv in ((4, 2048, 16, 4), (1, 2048, 32, 8)):
        q, do = (torch.randn(b, s, hq, 128, generator=g, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, s, hkv, 128, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        delta = flash_attention_bwd_delta(out, do)
        want = flash_attention_bwd_dkv(q, k, v, out, lse, do, True,
                                       128 ** -0.5)
        for shape, lib in dkv.items():
            dk, dv = torch.empty_like(k), torch.empty_like(v)

            def run():
                code = lib.flash_attention_bwd_dkv_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), b, s, s, hq, hkv, 128, 128 ** -0.5, 1,
                    torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"dkv {shape}: CUDA error {code}")

            run()
            torch.cuda.synchronize()
            same = torch.equal(dk, want[0]) and torch.equal(dv, want[1])
            ms = cs.time_ms(run, iters=10)
            print(f"[variants] dkv kernel alone B{b} S{s} Hq{hq} Hkv{hkv}, "
                  f"{shape}: {ms:.4f} ms, bitwise equal to the built "
                  f"kernel: {same}", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("port_measure: needs a CUDA card")
    mode, args = sys.argv[1], sys.argv[2:]
    {"kernels": kernels, "e2e": e2e, "variants": variants}[mode](*args)
