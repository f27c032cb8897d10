#!/usr/bin/env python3
"""Same-card measurements of the port beside chip_smoke.py: one checkout's
kernels against another's on fixed inputs, end-to-end phases, and
variants of the decode, flash and paged prefill kernels.

    python3 port_measure.py kernels TREE LABEL OUT.json [mega]
    python3 port_measure.py e2e TREE LABEL [mega | quant | graph | dispatch]
    python3 port_measure.py stamps TREE LABEL
    python3 port_measure.py mega TREE LABEL OUT.json
    python3 port_measure.py kernels TREE LABEL OUT.json gemv
    python3 port_measure.py loader TREE LABEL
    python3 port_measure.py variants [decode] [dkv] [fwd] [prefill] [swiglu]
        [dq] [mega] [gemv]

TREE is a directory holding `paddle_tpu_torch/` and `chip_smoke.py` (this
checkout is `.`; an earlier commit unpacks with `git archive COMMIT
paddle_tpu_torch chip_smoke.py | tar -x -C DIR`). Compare two trees by
running them in turns in one session on one card (A, B, B, A): calls on
different hosts differ by more than the kernels do.

- kernels: contiguous and paged decode attention at chip_smoke phase 1's
  cases and at Llama-3-8B's 8k context (B8 Hq32 Hkv8, lens 0..8191 on the
  split edges), bf16 and int8 pools, timed cold (operands past the L2) and
  warm; paged prefill attention (ragged windows and prefix prefill, bf16
  and int8 pools) at phase 1's cases and at phase 4's window, cold and
  warm; the flash forward at phase 1's serving case and bench.py's
  training shape; the flash backward dq / dkv at bench.py's shape and at
  Llama-3's heads (dq as the kernel alone: a tree whose dq wrapper takes
  the pre-pass's `delta` gets it handed in); the SwiGLU kernels forward
  and backward at phase 14's M 8192, K 4096, F 14336; the decode
  megakernel's four main rows (full over int8 weights with bf16 and with
  int8 pools, attn over bf16 weights, scan at L 2) at phase 1's cases,
  through the tree's own chip_smoke.mk_operands / mk_call (the card's
  time a call, queued behind a spin, and back to back with the
  wrapper); the weight-only GEMV at a decode step's shapes and M 1, 8,
  16, 32 and 64, cold. `mega` times only the megakernel and GEMV rows,
  `gemv` the GEMV, megakernel and SwiGLU rows (the three kernels of the
  shared weight ring, csrc/weight_ring.cuh). Appends {LABEL: [times]} to
  OUT.json.
- e2e: the decode wrappers' and the megakernel wrappers' host time per
  call, then chip_smoke phases 2 (the engine), 3 (the prefix cache), 4
  (the unified step), 9 (build_quant_generate over int4 weights), 13 (the
  Llama-1B train step) and 14 (the fused SwiGLU route on Llama-3-8B
  widths), and the megakernel phases 10, 11 and 12 (with phase 8, phase
  11's yardstick), with their own logs; `mega` runs phases 2, 8 and
  10-12 only, `quant` phases 7 and 8 (the weight-only GEMV's engines),
  `graph` phases 2, 7, 8 and 10-12 and, where the tree has it, the
  double-buffered phase 2b (the engine's CUDA graphs: a tree whose
  engine replays them logs its graphed and eager runs), `dispatch` the
  wrappers' host time a call (rms_norm, the flash forward, paged and
  contiguous decode), phase 2 (its eager `prefill_s` beside the replayed
  one) and phase 13 (the eager train step): the cost of the kernels'
  dispatch route (ctypes calls from Python, or torch.library operators).
- stamps: the per-phase split of TREE's decode megakernel at the four
  rows: a copy of its csrc in which block 0 stamps %globaltimer at the
  launch's start and after every grid barrier, and every block stamps
  its arrival (the latest wins), rebuilt apart (`_rebuilt`, the
  production build is untouched). Phase time = last arrival minus the
  previous barrier's release, barrier time = release minus last arrival.
- mega: stamps, `kernels ... mega` and `e2e ... mega` of one tree in one
  process (one build): the megakernel A/B.
- loader: chip_smoke phase 24's fit (Llama-1B, batch 4 x 2048) for 12
  steps, fed by 4 worker threads and by 4 worker processes over the
  shared-memory ring, twice each in turns; for every step its wall time,
  the trainer process's CPU time and the CPU time its worker processes
  spent during it (from /proc), so a slow step shows whose cores it
  waited for.
- variants (all eight groups unless some are named): this checkout's
  decode body rebuilt with four warps, and with
  its P V partial sums capped to fit three blocks per SM, against the
  built eight warps, each at 4, 8 and 16 blocks per SM by the split rule
  (chip_smoke's gates apply); the dkv kernel rebuilt with q tiles of 32
  rows against 64; the flash forward rebuilt with 128-row q tiles (eight
  warps) against 64; paged prefill with its cached phase unsplit against
  the split plan; the SwiGLU kernel rebuilt with a ring of 3 stages
  against 4, each on the persistent grid and on one CTA a tile; the dq
  kernel rebuilt with 128-row q tiles (eight warps) against 64; the
  decode megakernel by its stamps (as `stamps`): its attention phase
  spread over every block (as built) and, rebuilt, over half of them
  (pieces about twice as long, half as many splits a row), its weight
  ring rebuilt with 3 stages against 4, and its phases' parts alone (no
  product step, no weight copies, no attention arithmetic, no K / V
  copies: bounds, their outputs unchecked); the weight-only GEMV rebuilt
  with a ring of 2 or 3 stages against 4, its plan forced to clusters of
  1 / 2 / 3 / 4 / 8 K ranks and to 64 / 128 channels a block, without the
  programmatic dependent launch, padded to one block an SM, and its parts
  alone, at the step shapes at M 8 and 64.
"""
from __future__ import annotations

import ctypes
import functools
import importlib.util
import inspect
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


# phase 1's paged prefill cases (name, B, TN, cached, new, table width)
# and phase 4's window (the engine's 33-page tables)
PREFILL_CASES = [
    ("ragged B2 tn256 (phase 1)", "ragged_paged_attention", 2, 256,
     [0, 1344 + 37], [256, 100], 22),
    ("ragged B8 tn64 decode-like (phase 1)", "ragged_paged_attention", 8, 64,
     [0, 37, 64, 200, 511, 700, 1381, 256], [1, 1, 1, 1, 1, 1, 1, 64], 22),
    ("prefix B4 tn128 (phase 1)", "prefix_prefill_attention", 4, 128,
     [0, 64, 256, 512], [128, 1, 77, 100], 8),
    ("ragged B1 tn256 cached 1536 (phase 4 window)",
     "ragged_paged_attention", 1, 256, [1536], [256], 33),
]
# the flash forward (B, Sq, Sk, Hq, Hkv): phase 1's cases, the serving
# case first and bench.py's training shape last
FLASH_CASES = [(4, 512, 512, 32, 8), (1, 300, 300, 32, 8),
               (2, 200, 333, 32, 8), (4, 2048, 2048, 16, 4)]
# SwiGLU (M, K, F): phase 14's MLP, Llama-3-8B at batch 4 x 2048
SWIGLU_SHAPE = (8192, 4096, 14336)


def prefill_operands(b, tn, cached, new, w, q8, seed=0):
    """chip_smoke.check_paged_prefill's operands (Hq32 Hkv8 D128, pages of
    64, permuted tables): (q, k_new, v_new, pools, tables, cached, new)
    plus the int8 scales when q8."""
    from paddle_tpu_torch.models.llama import quantize_kv_pages

    g = torch.Generator(device="cuda").manual_seed(seed + tn + b)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    n_pages = b * w + 1
    kc, vc = rnd(n_pages, 8, 64, 128), rnd(n_pages, 8, 64, 128)
    q, kn, vn = rnd(b, tn, 32, 128), rnd(b, tn, 8, 128), rnd(b, tn, 8, 128)
    perm = torch.randperm(n_pages - 1,
                          generator=torch.Generator().manual_seed(0)) + 1
    tables = torch.zeros(b, w, dtype=torch.int32)
    for row, c in enumerate(cached):
        n = -(-c // 64)
        tables[row, :n] = perm[row * w: row * w + n].to(torch.int32)
    ops = [q, kn, vn, kc, vc, tables.cuda(),
           torch.tensor(cached, dtype=torch.int32, device="cuda"),
           torch.tensor(new, dtype=torch.int32, device="cuda")]
    if q8:
        (ops[3], ks), (ops[4], vs) = (quantize_kv_pages(p)
                                      for p in (kc, vc))
        ops += [ks, vs]
    return tuple(ops)


def prefill_call(name):
    """fn(q, kn, vn, kc, vc, tables, cached, new[, ks, vs]) of the named
    wrapper."""
    from paddle_tpu_torch.kernels.prefix_prefill import (
        prefix_prefill_attention)
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_paged_attention)

    fn = {"ragged_paged_attention": ragged_paged_attention,
          "prefix_prefill_attention": prefix_prefill_attention}[name]

    def call(*ops):
        if len(ops) == 10:
            return fn(*ops[:8], k_scale=ops[8], v_scale=ops[9])
        return fn(*ops)
    return call


def kernels(tree: str, label: str, out_path: str, which: str = "all") -> None:
    if which not in ("all", "mega", "gemv"):
        raise SystemExit(f"kernels: unknown selection {which!r}")
    cs, _ = _import_tree(tree)
    if which == "mega":
        _record(label, out_path, {**mk_rows(cs), **gemv_rows(cs)})
        return
    if which == "gemv":
        _record(label, out_path,
                {**gemv_rows(cs), **mk_rows(cs), **swiglu_rows(cs)})
        return
    time_ms, time_cold_ms = cs.time_ms, cs.time_cold_ms
    from paddle_tpu_torch.kernels.decode_attention import (
        decode_attention, gqa_decode_attention, paged_decode_attention)
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_delta, flash_attention_bwd_dkv,
        flash_attention_bwd_dq)
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
    for case, name, b, tn, cached, new, w in PREFILL_CASES:
        for q8 in (False, True):
            ops = prefill_operands(b, tn, cached, new, w, q8)
            fn = prefill_call(name)
            t = case + (" int8" if q8 else " bf16")
            res["prefill " + t + " warm"] = time_ms(lambda: fn(*ops))
            res["prefill " + t + " cold"] = time_cold_ms(fn, ops)
    for b, sq, sk, hq, hkv in FLASH_CASES:
        g = torch.Generator(device="cuda").manual_seed(hq)
        q = torch.randn(b, sq, hq, 128, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, sk, hkv, 128, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        res[f"flash fwd B{b} Sq{sq} Sk{sk} Hq{hq} Hkv{hkv}"] = time_ms(
            lambda: flash_attention(q, k, v, causal=True), iters=10)
    for b, s, hq, hkv in ((4, 2048, 16, 4), (1, 2048, 32, 8)):
        g = torch.Generator(device="cuda").manual_seed(hq)
        q, do = (torch.randn(b, s, hq, 128, generator=g, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, s, hkv, 128, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        args = (q, k, v, out, lse, do, True, 128 ** -0.5)
        case = f"B{b} S{s} Hq{hq} Hkv{hkv}"
        kw = {}
        if "delta" in inspect.signature(flash_attention_bwd_dq).parameters:
            kw["delta"] = flash_attention_bwd_delta(out, do)
        res["dq " + case] = time_ms(
            lambda: flash_attention_bwd_dq(*args, **kw), iters=10)
        res["dkv " + case] = time_ms(lambda: flash_attention_bwd_dkv(*args),
                                     iters=10)
    res.update(swiglu_rows(cs))
    res.update(mk_rows(cs))
    res.update(gemv_rows(cs))
    _record(label, out_path, res)


def _record(label, out_path, res):
    print(label, json.dumps(res, indent=1), flush=True)
    prev = json.load(open(out_path)) if os.path.exists(out_path) else {}
    prev.setdefault(label, []).append(res)
    with open(out_path, "w") as f:
        json.dump(prev, f, indent=1)


def swiglu_rows(cs):
    """The SwiGLU kernels forward and backward at phase 14's MLP."""
    from paddle_tpu_torch.kernels.swiglu import swiglu_bwd, swiglu_fwd

    m, k, f = SWIGLU_SHAPE
    g = torch.Generator(device="cuda").manual_seed(f)
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    wg, wu = ((torch.randn(k, f, generator=g, device="cuda") * k ** -0.5)
              .to(torch.bfloat16) for _ in range(2))
    dout = torch.randn(m, f, generator=g, device="cuda").to(torch.bfloat16)
    return {f"swiglu fwd M{m} K{k} F{f}": cs.time_ms(
                lambda: swiglu_fwd(x, wg, wu), iters=10),
            f"swiglu bwd M{m} K{k} F{f}": cs.time_ms(
                lambda: swiglu_bwd(x, wg, wu, dout), iters=10)}


# rows of x the GEMV rows take: the main path's 8 slots, the edge 1, and
# servers of 16 to 64 slots (64 is the top of the GEMV route)
GEMV_MS = (1, 8, 16, 32, 64)


def _gemv_operands(quant, k, n):
    from paddle_tpu_torch.nn.quant import weight_quantize

    g = torch.Generator(device="cuda").manual_seed(k + n)
    return weight_quantize(
        torch.randn(k, n, generator=g, device="cuda") * 0.02, algo=quant)


def gemv_rows(cs, ms=GEMV_MS, shapes=None):
    """The weight-only GEMV (int8, int4) at a Llama-3-8B decode step's
    shapes and the rows `ms`, the tree's own wrapper, cold (its int8
    widening is shared with the megakernel). Each row's kernel only: no
    plain version, no yardstick."""
    from paddle_tpu_torch.kernels.int4_matmul import (int4_matmul,
                                                      int8_weight_matmul)

    res = {}
    for quant in ("weight_only_int8", "weight_only_int4"):
        fn = (int4_matmul if quant == "weight_only_int4"
              else int8_weight_matmul)
        for k, n in shapes or cs.GEMV_SHAPES:
            wq, sc = _gemv_operands(quant, k, n)
            for m in ms:
                x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16)
                res[f"gemv {quant[12:]} M{m} K{k} N{n} cold"] = \
                    cs.time_cold_ms(fn, (x, wq, sc))
            del wq, sc
    return res


# the decode megakernel's main rows (chip_smoke.megakernel_cases): (label,
# rung, int8 weights, int8 pools); the operands of one (weights, pools)
# pair serve every rung over them
MK_ROWS = (("megakernel full, int8 weights, bf16 pools", "full", True, False),
           ("megakernel scan L2, int8 weights, bf16 pools", "scan", True,
            False),
           ("megakernel full, int8 weights, int8 pools", "full", True, True),
           ("megakernel attn, bf16 weights and pools", "attn", False, False))


def _mk_own(cs, ops, rung):
    """`ops` cut to the rung's layers, with pools of its own (the rung
    commits in place)."""
    h, lens, tables, weights, pools, kw = cs.mk_layers(
        ops, 2 if rung == "scan" else 1)
    return (h, lens, tables, weights, [p.clone() for p in pools],
            {k: v.clone() for k, v in kw.items()})


def _mk_operand_sets(cs):
    """Yields (label, rung, own operands) for MK_ROWS, one operand set of
    Llama-3-8B's two layers alive at a time."""
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.llama3_8b()
    for quant, q8 in ((True, False), (True, True), (False, False)):
        ops = cs.mk_operands(cfg, 2, quant, q8)
        for label, rung, qw, qk in MK_ROWS:
            if (qw, qk) == (quant, q8):
                yield label, rung, _mk_own(cs, ops, rung)
        del ops
        cs._release()


def mk_rows(cs):
    """The megakernel rows: the card's time a call, 10 calls queued
    behind a spin (this checkout's chip_smoke.queued_ms, whatever the
    tree: each call streams its layers' weights past the L2), and CUDA
    events around 10 calls back to back (the wrapper's host time
    included)."""
    queued_ms = _own_smoke().queued_ms
    res = {}
    for label, rung, own in _mk_operand_sets(cs):
        def fn():
            return cs.mk_call(rung, False, own, clone=False)
        res[label] = queued_ms(fn)
        res[label + ", back to back"] = cs.time_ms(fn, iters=10)
    return res


@functools.lru_cache(maxsize=1)
def _own_smoke():
    """This checkout's chip_smoke.py as a module of its own name (its
    timing helpers time an earlier tree's calls as this tree's)."""
    spec = importlib.util.spec_from_file_location(
        "own_chip_smoke", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(label, name, fn, n=200):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[{label}] host {name}: {1e6 * (t1 - t0) / n:.1f} us per call "
          f"enqueued, {1e6 * (t2 - t0) / n:.1f} us per call with the "
          f"device", flush=True)


def mega(tree: str, label: str, out_path: str) -> None:
    """One tree's megakernel A/B in one process (one build): the stamps,
    the megakernel and GEMV rows, and e2e's megakernel phases."""
    cs, _build = _import_tree(tree)
    mk_stamps(cs, _build, tempfile.mkdtemp(), label, "stamps")
    _record(label, out_path, {**mk_rows(cs), **gemv_rows(cs)})
    _e2e(cs, label, "mega")


def e2e(tree: str, label: str, which: str = "all") -> None:
    if which not in ("all", "mega", "quant", "graph", "dispatch"):
        raise SystemExit(f"e2e: unknown selection {which!r}")
    cs, _build = _import_tree(tree)
    if which == "dispatch":
        _e2e_dispatch(cs, label)
        return
    if which == "quant":
        _e2e_quant(cs, label)
        return
    if which == "graph":
        _e2e_graph(cs, label)
        return
    _e2e(cs, label, which)


def _e2e_graph(cs, label):
    """chip_smoke phases 2, 2b (where the tree has it), 7, 8 and 10-12:
    every serving phase whose decode chunk the engine's CUDA graphs
    change, with their own logs (tokens/s, decode-chunk ms, busy share)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = cs.build_model()
    engine = cs.phase_engine(cfg, params)
    if hasattr(cs, "phase_double_buffer"):
        cs.phase_double_buffer(cfg, params, engine)
    cs.phase_int4_split(cfg).pop("params")
    cs._release()
    int8w = cs.phase_int8w_unified(cfg, params)
    cs.phase_mega_scan(cfg, params)
    cs.phase_mega_full(cfg, params, int8w)
    cs.phase_mega_attn(cfg, params, engine)
    print(f"[{label}] done", flush=True)


def _e2e_dispatch(cs, label):
    """The dispatch route's cost: the wrappers' host time a call at small
    shapes (where the host sets the pace), then chip_smoke phase 2 (the
    engine served replayed and eagerly: eager `prefill_s` pays every
    wrapper call) and phase 13 (the eager Llama-1B train step)."""
    from paddle_tpu_torch.kernels.decode_attention import (
        gqa_decode_attention, paged_decode_attention)
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.kernels.rms_norm import rms_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    x, w = rnd(8, 4096), rnd(4096)
    q, k, v = rnd(1, 128, 32, 128), rnd(1, 128, 8, 128), rnd(1, 128, 8, 128)
    qd, kc, vc = rnd(8, 32, 128), rnd(8, 8, 256, 128), rnd(8, 8, 256, 128)
    pools = [rnd(73, 8, 64, 128) for _ in range(2)]
    tables = torch.arange(1, 73, device="cuda",
                          dtype=torch.int32).reshape(8, 9)
    lens = torch.full((8,), 200, dtype=torch.int32, device="cuda")
    host_us(label, "rms_norm", lambda: rms_norm(x, w), n=1000)
    host_us(label, "flash_attention",
            lambda: flash_attention(q, k, v, causal=True), n=500)
    host_us(label, "paged_decode_attention",
            lambda: paged_decode_attention(qd, *pools, tables, lens), n=500)
    host_us(label, "gqa_decode_attention",
            lambda: gqa_decode_attention(qd, kc, vc, lens), n=500)
    del x, w, q, k, v, qd, kc, vc, pools
    cfg, params = cs.build_model()
    cs.phase_engine(cfg, params)
    del params
    cs._release()
    cs.phase_train()
    print(f"[{label}] done", flush=True)


def _children_cpu_s() -> float:
    """CPU seconds (user + system) of this process's live children."""
    import multiprocessing as mp

    tick = os.sysconf("SC_CLK_TCK")
    total = 0.0
    for p in mp.active_children():
        try:
            with open(f"/proc/{p.pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            total += (int(fields[11]) + int(fields[12])) / tick
        except OSError:
            pass
    return total


def loader(tree: str, label: str) -> None:
    """Phase 24's two loaders in turns (threads, ring, threads, ring),
    each step's wall time beside the CPU time of the trainer and of the
    workers during it."""
    from paddle_tpu_torch.hapi import Callback
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    cs, _build = _import_tree(tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.hapi_config()
    x, y = cs.hapi_tokens(cfg, 48, 2048, cs.SEED + 24)

    class Probe(Callback):
        def __init__(self):
            super().__init__()
            self.rows = []

        def on_train_batch_begin(self, step, logs=None):
            torch.cuda.synchronize()
            self.t = (time.perf_counter(), time.process_time(),
                      _children_cpu_s())

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            t0, c0, w0 = self.t
            self.rows.append((1e3 * (time.perf_counter() - t0),
                              1e3 * (time.process_time() - c0),
                              1e3 * (_children_cpu_s() - w0)))

    for shm in (False, True, False, True):
        model = cs.hapi_model(cfg, cs.SEED)
        probe = Probe()
        model.fit(DataLoader(TensorDataset([x, y]), batch_size=4,
                             num_workers=4, use_shared_memory=shm),
                  epochs=1, verbose=0, callbacks=[probe])
        tag = "ring" if shm else "threads"
        print(f"[{label}] {tag}: step ms / trainer CPU ms / workers' CPU ms "
              + "; ".join(f"{w:.1f}/{c:.1f}/{k:.1f}"
                          for w, c, k in probe.rows), flush=True)
        del model
        cs._release()
    print(f"[{label}] done", flush=True)


def _e2e_quant(cs, label):
    """chip_smoke phases 7 (int4 weights, split path, prefix cache) and 8
    (int8 weights and pools, unified step), with their profiled decode
    chunks (a tree whose phase 8 traces none prints none)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = cs.build_model()
    cs.phase_int4_split(cfg).pop("params")
    cs._release()
    cs.phase_int8w_unified(cfg, params)
    print(f"[{label}] done", flush=True)


def _e2e(cs, label, which):
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
    host_us(label, "gqa_decode_attention",
            lambda: gqa_decode_attention(q, kc, vc, lens), n=500)
    host_us(label, "paged_decode_attention",
            lambda: paged_decode_attention(q, pools[0], pools[1], tables,
                                           lens), n=500)
    del q, kc, vc, pools
    # the megakernel wrappers: host time per call beside the device's
    for name, rung, own in _mk_operand_sets(cs):
        host_us(label, name, lambda: cs.mk_call(rung, False, own,
                                                clone=False), n=50)
    cfg, params = cs.build_model()
    engine = cs.phase_engine(cfg, params)
    if which == "all":
        cs.phase_prefix_cache(cfg, params)
        cs.phase_unified(cfg, params)
        p4 = init_quant_serving_params(cfg, "weight_only_int4",
                                       seed=cs.SEED, device="cuda")
        cs.quant_generate(cfg, p4, "weight_only_int4", "quant-generate",
                          "gqa_decode_attention")
        del p4
        cs._release()
    int8w = cs.phase_int8w_unified(cfg, params)
    cs.phase_mega_scan(cfg, params)
    cs.phase_mega_full(cfg, params, int8w)
    cs.phase_mega_attn(cfg, params, engine)
    del params
    cs._release()
    if which == "all":
        cs.phase_train()
        cs._release()
        cs.phase_train_swiglu()
    print(f"[{label}] done", flush=True)


# the per-phase stamps: defines MK_STAMPS and the three stamp hooks the
# megakernel source calls (csrc/decode_megakernel.cu keeps them empty
# unless MK_STAMPS is defined), and a reader that copies the stamps out
# and clears them
STAMP_CODE = r"""#define MK_STAMPS 1
__device__ unsigned long long mk_stamps[1 + 2 * 1024];
__device__ unsigned mk_nbar;
__device__ __forceinline__ unsigned long long mk_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MK_STAMP_START() (mk_stamps[0] = mk_now())
#define MK_STAMP_ARRIVE(i) \
  atomicMax(&mk_stamps[1 + 2 * ((i) & 1023)], mk_now())
#define MK_STAMP_LEAVE(i)                                  \
  do {                                                     \
    if (blockIdx.x == 0) {                                 \
      mk_stamps[2 + 2 * ((i) & 1023)] = mk_now();          \
      atomicMax(&mk_nbar, static_cast<unsigned>(i) + 1u); \
    }                                                      \
  } while (0)
// phase 2's spans, summed over blocks in ns: piece start-up, tiles,
// piece end, merge, finish (join, ctx, commit)
__device__ unsigned long long mk_spans[8];
#define MK_SPAN_BEGIN(v) const unsigned long long v = mk_now()
#define MK_SPAN_END(kind, v) \
  if (threadIdx.x == 0) atomicAdd(&mk_spans[kind], mk_now() - (v))
extern "C" int decode_megakernel_stamps(unsigned long long* host, int n,
                                        unsigned* nbar) {
  static const unsigned long long zero[1 + 2 * 1024] = {};
  const unsigned z = 0;
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(host, mk_stamps, n * sizeof(unsigned long long));
  cudaMemcpyFromSymbol(nbar, mk_nbar, sizeof(unsigned));
  cudaMemcpyToSymbol(mk_stamps, zero, sizeof(zero));
  cudaMemcpyToSymbol(mk_nbar, &z, sizeof(unsigned));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int decode_megakernel_spans(unsigned long long* host) {
  static const unsigned long long zero[8] = {};
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(host, mk_spans, sizeof(zero));
  cudaMemcpyToSymbol(mk_spans, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
"""

# a kernel without the stamp hooks (the first, scalar design): its grid
# barrier and entry
_UNHOOKED_EDITS = (
    ("    const unsigned g = *gen;\n",
     "    const unsigned g = *gen;\n    MK_STAMP_ARRIVE(g);\n"),
    ("      while (*gen == g) __nanosleep(64);\n    }\n    __threadfence();\n",
     "      while (*gen == g) __nanosleep(64);\n    }\n    __threadfence();\n"
     "    MK_STAMP_LEAVE(g);\n"),
    ("  const int tid = threadIdx.x;\n  T* out = static_cast<T*>(a.out);\n",
     "  const int tid = threadIdx.x;\n  T* out = static_cast<T*>(a.out);\n"
     "  if (blockIdx.x == 0 && tid == 0) MK_STAMP_START();\n"))


def _stamp_edits(csrc: str):
    """(file, old, new) edits that build `csrc`'s megakernel with stamps."""
    fname = "decode_megakernel.cu"
    text = open(os.path.join(csrc, fname)).read()
    first = text.splitlines(keepends=True)[0]
    edits = [(fname, first, STAMP_CODE + first)]
    if "MK_STAMP_ARRIVE" not in text:
        edits += [(fname, old, new) for old, new in _UNHOOKED_EDITS]
    return edits


def _phase_split(label, stamps, nbar, L, mlp):
    """Sum the stamps' segments by phase over the layers; prints and
    returns {phase: ms} with 'barriers' and 'total'."""
    names = ["1 qkv", "2 attention", "3 o"] + (["4 gate/up", "5 down"]
                                              if mlp else [])
    per = len(names) * L
    arrivals = nbar + (1 if nbar < 1024 and stamps[1 + 2 * nbar] else 0)
    seq = (["copy-in"] if arrivals == per + 1 else []) + names * L
    if arrivals != len(seq):
        raise RuntimeError(f"{label}: {arrivals} barrier stamps, expected "
                           f"{per} or {per + 1}")
    out = {n: 0.0 for n in (["copy-in"] if seq[0] == "copy-in" else [])
           + names + ["barriers"]}
    prev = stamps[0]
    for i, name in enumerate(seq):
        arrive = stamps[1 + 2 * i]
        out[name] += (arrive - prev) / 1e6
        if i < nbar:
            out["barriers"] += (stamps[2 + 2 * i] - arrive) / 1e6
            prev = stamps[2 + 2 * i]
        else:
            prev = arrive
    out["total"] = (prev - stamps[0]) / 1e6
    return out


def mk_stamps_lib(cs, _build, tmp, label, edits):
    """mk_stamps of this tree's kernel with `edits` applied first."""
    d = os.path.join(tempfile.mkdtemp(dir=tmp), "csrc")
    shutil.copytree(_build.CSRC, d)
    for fname, old, new in edits:
        path = os.path.join(d, fname)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"{label}: {old!r} not in {fname}")
        open(path, "w").write(text.replace(old, new))
    mk_stamps(cs, _build, tmp, label,
              os.path.basename(os.path.dirname(d)) + "-stamped", csrc=d)


def mk_stamps(cs, _build, tmp, label, tag, csrc=None, reps=5):
    """The per-phase split (median of `reps` launches) of every MK_ROWS
    row, through a stamped rebuild of `csrc` (default: the tree's)."""
    import statistics

    csrc = csrc or str(_build.CSRC)
    built = _build._LIBS.get("decode_megakernel") or _build.library(
        "decode_megakernel")
    lib = _rebuilt(_build, tmp, tag, _stamp_edits(csrc),
                   ("decode_megakernel",), csrc=csrc)["decode_megakernel"]
    lib.decode_megakernel_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_void_p]
    lib.decode_megakernel_stamps.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 2049)()
    nbar = ctypes.c_uint()
    _build._LIBS["decode_megakernel"] = lib
    try:
        for name, rung, own in _mk_operand_sets(cs):
            L, mlp = (2 if rung == "scan" else 1), rung != "attn"
            runs = []
            for i in range(reps + 1):
                cs.mk_call(rung, False, own, clone=False)
                code = lib.decode_megakernel_stamps(buf, 2049,
                                                    ctypes.byref(nbar))
                if code:
                    raise RuntimeError(f"stamps: CUDA error {code}")
                if i:       # the first launch warms up
                    runs.append(_phase_split(name, list(buf), nbar.value, L,
                                             mlp))
            split = {k: statistics.median(r[k] for r in runs)
                     for k in runs[0]}
            print(f"[stamps] {label} {name}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in split.items()), flush=True)
            if hasattr(lib, "decode_megakernel_spans"):
                spans = (ctypes.c_ulonglong * 8)()
                lib.decode_megakernel_spans(spans)
                per = 1.0 / (reps + 1) / L / n_blocks()
                print(f"[stamps] {label} {name}: phase 2 a block and layer "
                      f"(us): " + ", ".join(
                          f"{k} {spans[i] * per / 1e3:.2f}" for i, k in
                          enumerate(("start-up", "tiles", "piece end",
                                     "merge", "finish"))), flush=True)
    finally:
        _build._LIBS["decode_megakernel"] = built


def n_blocks() -> int:
    """The megakernel's grid at the rows' shared memory: one block an SM."""
    return torch.cuda.get_device_properties(0).multi_processor_count


def stamps(tree: str, label: str) -> None:
    cs, _build = _import_tree(tree)
    mk_stamps(cs, _build, tempfile.mkdtemp(), label, "stamps")


def _rebuilt(_build, tmp: str, tag: str, edits, names, csrc=None):
    """The libraries `names` built from a copy of csrc (default: _build's)
    with `edits` ((file, old, new) string replacements), loaded like
    _build's."""
    return _rebuilt_many(_build, tmp, {tag: edits}, names, csrc)[tag]


def _rebuilt_many(_build, tmp: str, variants, names, csrc=None):
    """{tag: _rebuilt(..., tag, edits, names)} for {tag: edits}, every
    nvcc started at once."""
    procs = {}
    for tag, edits in variants.items():
        d = os.path.join(tmp, tag)
        shutil.copytree(csrc or _build.CSRC, d)
        for fname, old, new in edits:
            path = os.path.join(d, fname)
            text = open(path).read()
            if old not in text:
                raise RuntimeError(f"{tag}: {old!r} not in {fname}")
            open(path, "w").write(text.replace(old, new))
        for name in names:
            so = os.path.join(d, name + ".so")
            procs[tag, name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 f"-I{d}", "-o", so, os.path.join(d, name + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {tag: {} for tag in variants}
    for (tag, name), (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag}: nvcc failed\n{err[-3000:]}")
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                   err)})
        print(f"[variants] {tag} {name}: registers {regs}", flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build.SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        built[tag][name] = lib
    return built


def variants(*groups: str) -> None:
    names = ("decode", "dkv", "fwd", "prefill", "swiglu", "dq", "mega",
             "gemv")
    groups = set(groups or names)
    cs, _build = _import_tree(".")
    tmp = tempfile.mkdtemp()
    g = torch.Generator(device="cuda").manual_seed(16)
    for name in names:
        if name in groups:
            globals()["_variants_" + name](cs, _build, tmp, g)


def _variants_decode(cs, _build, tmp, g) -> None:
    from paddle_tpu_torch.kernels import decode_attention as da

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


def _variants_dkv(cs, _build, tmp, g) -> None:
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_delta, flash_attention_bwd_dkv)

    dkv = {"q tiles of 64 rows (built)": _build.library("flash_attention_bwd"),
           "q tiles of 32 rows": _rebuilt(
               _build, tmp, "q32", [("flash_attention_bwd.cu",
                                     "constexpr int DKV_QROWS = 64;",
                                     "constexpr int DKV_QROWS = 32;")],
               ("flash_attention_bwd",))["flash_attention_bwd"]}
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


def _variants_fwd(cs, _build, tmp, g) -> None:
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    fwd = {"64-row q tiles, four warps (built)":
               _build.library("flash_attention_fwd"),
           "128-row q tiles, eight warps": _rebuilt(
               _build, tmp, "fwd8", [("flash_attention_fwd.cu",
                                      "constexpr int FWD_WARPS = 4;",
                                      "constexpr int FWD_WARPS = 8;")],
               ("flash_attention_fwd",))["flash_attention_fwd"]}
    for b, sq, sk, hq, hkv in FLASH_CASES:
        q = torch.randn(b, sq, hq, 128, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, sk, hkv, 128, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        want = flash_attention(q, k, v, causal=True, return_lse=True)
        for shape, lib in fwd.items():
            o = torch.empty_like(q)
            lse = torch.empty(b * hq, sq, device="cuda", dtype=torch.float32)

            def run():
                code = lib.flash_attention_fwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), b, sq, sk, hq, hkv, 128, 128 ** -0.5, 1,
                    torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"flash fwd {shape}: CUDA error "
                                       f"{code}")

            run()
            torch.cuda.synchronize()
            same = torch.equal(o, want[0]) and torch.equal(lse, want[1])
            ms = cs.time_ms(run, iters=10)
            print(f"[variants] flash fwd B{b} Sq{sq} Sk{sk} Hq{hq} Hkv{hkv}, "
                  f"{shape}: "
                  f"{ms:.4f} ms, bitwise equal to the built kernel: {same}",
                  flush=True)


def _variants_prefill(cs, _build, tmp, g) -> None:
    from paddle_tpu_torch.kernels import prefix_prefill as pp
    planned = pp.prefill_split_plan

    def unsplit(span, *_):
        return -(-span // pp.PREFILL_TILE), 1

    for case, name, b, tn, cached, new, w in PREFILL_CASES:
        for q8 in (False, True):
            ops = prefill_operands(b, tn, cached, new, w, q8)
            fn = prefill_call(name)
            t = f"{case}{' int8' if q8 else ' bf16'}"
            for shape, plan in (("split plan (built)", planned),
                                ("cached phase unsplit", unsplit)):
                pp.prefill_split_plan = plan
                tps, splits = plan(w * 64, tn, 4, b, 8)
                ms = cs.time_cold_ms(fn, ops)
                print(f"[variants] prefill {t}, {shape} ({splits} splits of "
                      f"{tps} tiles): {ms:.4f} ms cold, "
                      f"{cs.time_ms(lambda: fn(*ops)):.4f} ms warm (events "
                      f"around back-to-back calls), "
                      f"{device_ms(lambda: fn(*ops), 'paged_prefill'):.4f} "
                      f"ms warm (profiler, kernel alone)", flush=True)
            pp.prefill_split_plan = planned


def _variants_swiglu(cs, _build, tmp, g) -> None:
    from paddle_tpu_torch.kernels.swiglu import (SWIGLU_TILE, swiglu_bwd,
                                                 swiglu_fwd, swiglu_grid)

    libs = {"4 stages (built)": _build.library("swiglu"),
            "3 stages": _rebuilt(
                _build, tmp, "swiglu3", [("swiglu.cu",
                                          "constexpr int STAGES = 4;",
                                          "constexpr int STAGES = 3;")],
                ("swiglu",))["swiglu"]}
    m, k, f = SWIGLU_SHAPE
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    wg, wu = ((torch.randn(k, f, generator=g, device="cuda") * k ** -0.5)
              .to(torch.bfloat16) for _ in range(2))
    dout = torch.randn(m, f, generator=g, device="cuda").to(torch.bfloat16)
    want = (swiglu_fwd(x, wg, wu),) + swiglu_bwd(x, wg, wu, dout)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for shape, lib in libs.items():
        for persistent, grid in (
                (True, swiglu_grid(m, k, f, n_sms)),
                (False, (m // SWIGLU_TILE) * (f // SWIGLU_TILE))):
            outs = [torch.empty_like(want[0]) for _ in range(3)]

            def fwd():
                code = lib.swiglu_fwd_launch(
                    x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                    outs[0].data_ptr(), m, k, f, grid, stream)
                if code:
                    raise RuntimeError(f"swiglu fwd {shape}: error {code}")

            def bwd():
                code = lib.swiglu_bwd_launch(
                    x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                    dout.data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
                    m, k, f, grid, stream)
                if code:
                    raise RuntimeError(f"swiglu bwd {shape}: error {code}")

            fwd()
            bwd()
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(outs, want))
            print(f"[variants] swiglu M{m} K{k} F{f}, {shape}, grid {grid} "
                  f"({'persistent' if persistent else 'a CTA a tile'}): "
                  f"fwd {cs.time_ms(fwd, iters=10):.4f} ms, bwd "
                  f"{cs.time_ms(bwd, iters=10):.4f} ms, bitwise equal to "
                  f"the built kernel: {same}", flush=True)


def _variants_dq(cs, _build, tmp, g) -> None:
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_delta, flash_attention_bwd_dq)

    dq = {"64-row q tiles, four warps (built)":
              _build.library("flash_attention_bwd"),
          "128-row q tiles, eight warps": _rebuilt(
              _build, tmp, "dq8", [("flash_attention_bwd.cu",
                                    "constexpr int DQ_WARPS = 4;",
                                    "constexpr int DQ_WARPS = 8;")],
              ("flash_attention_bwd",))["flash_attention_bwd"]}
    for b, s, hq, hkv in ((4, 2048, 16, 4), (1, 2048, 32, 8)):
        q, do = (torch.randn(b, s, hq, 128, generator=g, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, s, hkv, 128, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        delta = flash_attention_bwd_delta(out, do)
        want = flash_attention_bwd_dq(q, k, v, out, lse, do, True,
                                      128 ** -0.5, delta=delta)
        for shape, lib in dq.items():
            got = torch.empty_like(q)

            def run():
                code = lib.flash_attention_bwd_dq_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    delta.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    got.data_ptr(), b, s, s, hq, hkv, 128, 128 ** -0.5, 1,
                    torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"dq {shape}: CUDA error {code}")

            run()
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            ms = cs.time_ms(run, iters=10)
            print(f"[variants] dq kernel alone B{b} S{s} Hq{hq} Hkv{hkv}, "
                  f"{shape}: {ms:.4f} ms, bitwise equal to the built kernel: "
                  f"{same}", flush=True)


def _variants_mega(cs, _build, tmp, g) -> None:
    """By the stamps alone (the split by phase, taken inside the
    kernel)."""
    from paddle_tpu_torch.kernels import decode_megakernel as mk

    mk_stamps(cs, _build, tmp, "phase 2 over every block", "every-block")
    src = "decode_megakernel.cu"
    variants = {
        "phase 2 over half the blocks": [(
            src, "      const int64_t nblk = min(static_cast<int64_t>("
                 "gridDim.x), T_);",
            "      const int64_t nblk = min(static_cast<int64_t>("
            "(gridDim.x + 1) / 2), T_);")],
        "ring of 3 stages": [(src, "constexpr int STAGES = 4;",
                              "constexpr int STAGES = 3;")],
        # bounds on the parts, not products: outputs wrong, unchecked
        "no product step (streaming only)": [(
            src, "  if constexpr (!std::is_same<T, float>::value && QW) {",
            "  if constexpr (!std::is_same<T, float>::value && QW) {\n"
            "    return;")],
        "no weight copies (products only)": [
            (src, "    if (lane == 0) mb_expect_tx(full, row * n);",
             "    if (lane == 0) mb_expect_tx(full, 0);"),
            (src, "        bulk_g2s(slot + lane * PITCH,",
             "        if (false) bulk_g2s(slot + lane * PITCH,")],
        "no attention arithmetic (K / V streaming only)": [(
            src, "    // scores, masked strictly below len\n",
            "    if (j1 > 0) continue;\n")],
        "no K / V copies (attention arithmetic only)": [(
            src, "    start_tile_copy(k, k + stage_elems, kc, vc, "
                 "locate(j, &sidx), st, D);", "")]}
    for shape, edits in variants.items():
        mk._GEOMETRY.clear()
        mk_stamps_lib(cs, _build, tmp, shape, edits)
    mk._GEOMETRY.clear()


def _variants_gemv(cs, _build, tmp, g) -> None:
    """The weight-only GEMV rebuilt with a ring of 2 and 3 stages (4
    built), with its plan forced to clusters of 1, 2, 3, 4 and 8 K ranks,
    without the programmatic dependent launch, with its plan's groups in
    two waves of the card (two blocks an SM) or of 4 and 8 A tiles (64 and
    128 channels a block; the plan still picks the cluster size), with
    its shared memory padded past half an SM's (one block an SM), and its
    parts alone (no product step, no weight copies: bounds, their outputs
    unchecked), each at the five step shapes at M 8 and M 64, int4 and
    int8, cold; every other result within one bf16 step of the plain
    version. A variant the card refuses prints its error."""
    from paddle_tpu_torch.kernels import int4_matmul as im

    src = "weight_only_gemv.cu"
    loop = "  for (int c = 1; c <= MAX_CLUSTER; ++c) {"
    groups = "  return std::min(tiles, w * sms / c);"
    smem = ("  p.smem = smem_bytes(int4, (p.tiles + p.groups - 1) / "
            "p.groups, p.ntl);")
    sub_loop = ("      const int nv = min(per, (K - k0 + KSUB - 1) / KSUB - "
                "sb0);")
    no_subs = "      const int nv = 0;"
    edits = {
        "ring of 2 stages": [(src, "constexpr int STAGES = 4;",
                              "constexpr int STAGES = 2;")],
        "ring of 3 stages": [(src, "constexpr int STAGES = 4;",
                              "constexpr int STAGES = 3;")],
        **{f"cluster of {c}": [(src, loop, f"  for (int c = {c}; c <= {c}; "
                                           "++c) {")]
           for c in (1, 2, 3, 4, 8)},
        "no programmatic launch": [(src, "constexpr bool PDL = true;",
                                    "constexpr bool PDL = false;")],
        "groups in two waves": [(src, "  int w = 1;\n  while (w * sms / c",
                                 "  int w = 2;\n  while (w * sms / c")],
        "64 channels a block": [(src, groups, "  return (tiles + 3) / 4;")],
        "128 channels a block": [(src, groups, "  return (tiles + 7) / 8;")],
        "one block an SM": [(src, smem, smem.replace(
            "p.smem = smem_bytes(", "p.smem = std::max(116 * 1024, "
            "smem_bytes(").replace("p.ntl);", "p.ntl));"))],
        # bounds on the parts, not products: outputs wrong, unchecked
        "no product step (streaming only)": [(src, sub_loop, no_subs)],
        "no weight copies (products only)": [
            (src, "mb_expect_tx(full + slot, ct * WBOX + nsub * xsub);",
             "mb_expect_tx(full + slot, nsub * xsub);"),
            (src, "      if (w)\n", "      if (false)\n")]}
    unchecked = {tag for tag in edits if "only" in tag}
    libs = {"built (ring of 4, planned)":
                {"weight_only_gemv": _build.library("weight_only_gemv")},
            **_rebuilt_many(_build, tmp, edits, ("weight_only_gemv",))}
    built = libs["built (ring of 4, planned)"]
    ops = {(q, k, n): _gemv_operands(q, k, n)
           for q in ("weight_only_int4", "weight_only_int8")
           for k, n in cs.GEMV_SHAPES}
    xs = {(m, k): torch.randn(m, k, generator=g, device="cuda",
                              dtype=torch.bfloat16)
          for m in (8, 64) for k in (4096, 14336)}
    for tag, lib in libs.items():
        _build._LIBS.update(lib)
        for (quant, k, n), (wq, sc) in ops.items():
            int4 = quant == "weight_only_int4"
            fn, ref = ((im.int4_matmul, im.int4_matmul_reference) if int4
                       else (im.int8_weight_matmul,
                             im.int8_weight_matmul_reference))
            row = []
            for m in (8, 64):
                x = xs[m, k]
                try:
                    got = fn(x, wq, sc)
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    row.append(f"M{m} refused ({e})")
                    continue
                if tag not in unchecked:
                    cs.ulp_check(f"{tag} {quant} M{m} K{k} N{n}", got,
                                 ref(x, wq, sc))
                p = im.card_plan(x, wq, int4)
                row.append(f"M{m} {cs.time_cold_ms(fn, (x, wq, sc)):.4f} ms "
                           f"(groups {p.groups}, cluster {p.cluster})")
            print(f"[variants] gemv {tag}, {quant[12:]} K{k} N{n}: "
                  + "; ".join(row), flush=True)
    _build._LIBS.update(built)


def device_ms(fn, kernel: str, n: int = 20) -> float:
    """Mean device time of the kernels whose name holds `kernel`, per
    call of fn, from torch.profiler over n calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if kernel in e.key)
    return us / n / 1e3


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("port_measure: needs a CUDA card")
    mode, args = sys.argv[1], sys.argv[2:]
    {"kernels": kernels, "e2e": e2e, "stamps": stamps, "mega": mega,
     "loader": loader,
     "variants": variants}[mode](*args)
