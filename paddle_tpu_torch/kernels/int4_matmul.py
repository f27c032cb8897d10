"""Weight-only dequant matmul for decode (counterpart of
paddle_tpu/kernels/int4_matmul.py ``int4_matmul``, and of the int8 branch
of the serving matmul ``_mm``, paddle_tpu/models/llama.py:685).

Layouts are ``weight_quantize``'s: x [M, K]; int4 weights packed
[N, K // 2] int8 (low nibble = even k, high nibble = odd k) or int8
weights [N, K]; per-channel scales [N] float32. Both compute
``(x @ W^T)`` with W's exact integer values, summed in f32, times the f32
scale, rounded once to x's dtype.

Routing is by M alone, as in the JAX package (``MAX_DECODE_M``):

- CUDA x with M <= 64 launches ``csrc/weight_only_gemv.cu`` (counters
  ``int4_matmul`` / ``int8_weight_matmul``; bf16 or f16 x, K a multiple
  of 32); a dtype or shape the kernel does not take raises. The kernel's
  host code plans the launch (channel groups, the K split into the ranks
  of a thread-block cluster); ``gemv_plan`` is that plan's twin and
  ``weight_only_split_reference`` the plain twin of the kernel's order of
  sums, both for the tests (the card's launches never call them);
- CUDA x with M > 64 (prefill, windows) runs the dequantize-then-matmul
  form, the JAX package's own XLA route for large M (counters
  ``int4_matmul_large_m`` / ``int8_weight_matmul_large_m``);
- CPU x runs ``int4_matmul_reference`` / ``int8_weight_matmul_reference``.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple

import torch

from . import _build

# beyond this M the JAX package routes to its XLA form (int4_matmul.py:36)
MAX_DECODE_M = 64
# the kernel's rows of weights and x are whole 16-byte units (the copy
# engine's stride unit): 32 k of int4
K_MULTIPLE = 32

# the kernel's geometry (csrc/weight_only_gemv.cu): A tiles of 16
# channels, at most 8 a block (one consumer warp each), clusters of at most
# 2 K ranks, a ring of STAGES stages of 128 bytes of every weight row (256
# k of int4, 128 of int8) and the same k of x in 64-k sub-blocks
ATILE = 16
MAX_CT = 8
MAX_CLUSTER = 2
# shared memory a block may take with two blocks an SM
TWO_A_SM = 113 * 1024
CONSUMER_WARPS = 8
STAGES = 4
ROW_BYTES = 128
SUB_K = 64

LARGE_M_SUFFIX = "_large_m"


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """[N, K // 2] packed bytes -> [N, K] int32 values in [-8, 7]
    (the kernel's ``((v & 15) ^ 8) - 8``)."""
    w32 = w_packed.to(torch.int32)
    lo = ((w32 & 15) ^ 8) - 8
    hi = (((w32 >> 4) & 15) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(w_packed.shape[0], -1)


class GemvPlan(NamedTuple):
    """A launch plan of the weight-only GEMV: the grid is (cluster,
    groups); group j owns A tiles [j * tiles // groups, (j + 1) * tiles //
    groups), rank r of its cluster owns stages [r * stages_per_rank, (r +
    1) * stages_per_rank) of K."""
    m: int
    n: int
    k: int
    int4: bool
    groups: int
    cluster: int
    stages_per_rank: int
    stages: int
    tiles: int
    row_tiles: int
    smem: int

    @property
    def stage_k(self) -> int:
        return ROW_BYTES * (2 if self.int4 else 1)


class GemvBlock(NamedTuple):
    """One block of a plan: its K rank and channel group, channels [c0, c1)
    and k [k0, k1) it sums (empty when k0 == k1), and its k groups (the
    64-k sub-blocks of a stage cut into k_groups contiguous runs)."""
    rank: int
    group: int
    c0: int
    c1: int
    k0: int
    k1: int
    k_groups: int


def _smem_bytes(int4: bool, ct: int, row_tiles: int) -> int:
    sub_blocks = ROW_BYTES * (2 if int4 else 1) // SUB_K
    return 1024 + STAGES * (ct * ATILE * ROW_BYTES
                            + sub_blocks * row_tiles * 1024) + 16 * STAGES


def _plan_groups(tiles: int, c: int, sms: int) -> int:
    gmin = -(-tiles // MAX_CT)
    w = 1
    while w * sms // c < gmin:
        w += 1
    return min(tiles, w * sms // c)


def gemv_plan(m: int, n: int, k: int, int4: bool, sms: int) -> GemvPlan:
    """The twin of the kernel's ``make_plan`` (the same arithmetic, in the
    same order): for each cluster size c in 1, 2 (no more than the
    stages), channel groups in the first multiple of sms // c that keeps a
    group within 8 A tiles. A cluster of 2 when its blocks, at most two an
    SM, fit two to an SM's shared memory; otherwise the cheaper of the
    two, the cost of a candidate being the bytes its slowest block streams
    (weights, half its x, a fixed cost for the ring's first fill and the
    epilogue) times the waves, over the share of SMs the grid keeps
    busy."""
    stage_k = ROW_BYTES * (2 if int4 else 1)
    sub_blocks = stage_k // SUB_K
    stages = -(-k // stage_k)
    tiles = -(-n // ATILE)
    row_tiles = -(-m // 8)
    sms = max(1, sms)
    best = None
    for c in range(1, MAX_CLUSTER + 1):
        if c > 1 and c > stages:
            break
        g = _plan_groups(tiles, c, sms)
        ct, spr = -(-tiles // g), -(-stages // c)
        blocks = g * c
        waves = -(-blocks // sms)
        per_block = spr * (ct * ATILE * ROW_BYTES
                           + sub_blocks * m * 64.0) + 16384.0
        cost = waves * per_block * sms / min(blocks, sms)
        if c == 2 and blocks <= 2 * sms \
                and _smem_bytes(int4, ct, row_tiles) <= TWO_A_SM:
            cost = 0.0
        if best is None or cost < best[0]:
            best = (cost, g, c, spr)
    _, g, c, spr = best
    return GemvPlan(m, n, k, bool(int4), g, c, spr, stages, tiles,
                    row_tiles, _smem_bytes(int4, -(-tiles // g), row_tiles))


def gemv_blocks(plan: GemvPlan) -> Iterator[GemvBlock]:
    """The plan's blocks, group-major."""
    sub_blocks = plan.stage_k // SUB_K
    for j in range(plan.groups):
        a0 = j * plan.tiles // plan.groups
        a1 = (j + 1) * plan.tiles // plan.groups
        kg = min(CONSUMER_WARPS // (a1 - a0), sub_blocks)
        for r in range(plan.cluster):
            s0 = r * plan.stages_per_rank
            s1 = min(plan.stages, s0 + plan.stages_per_rank)
            k0 = min(plan.k, s0 * plan.stage_k)
            k1 = max(k0, min(plan.k, s1 * plan.stage_k))
            yield GemvBlock(r, j, a0 * ATILE, min(plan.n, a1 * ATILE), k0,
                            k1, kg)


def weight_only_split_reference(x: torch.Tensor, wq: torch.Tensor,
                                scale: torch.Tensor,
                                plan: GemvPlan) -> torch.Tensor:
    """The plain twin of the kernel's order of sums under ``plan`` (int4
    packed [N, K // 2] or int8 [N, K] weights, as ``plan.int4`` says): for
    each channel group and K rank, one f32 partial a k group (run g of
    the 64-k sub-blocks of each of the rank's stages), the k groups summed
    in order, the ranks' sums in rank order, then the f32 scale and one
    rounding. The sums inside a partial run in another order than the
    tensor cores'."""
    w = (unpack_int4(wq) if plan.int4 else wq).to(torch.float32)
    xf = x.to(torch.float32)
    kk = torch.arange(plan.k, device=x.device)
    rank_of = kk // plan.stage_k // plan.stages_per_rank
    sub_of = kk % plan.stage_k // SUB_K
    per_stage = plan.stage_k // SUB_K
    out = torch.zeros(plan.m, plan.n, dtype=torch.float32, device=x.device)
    # groups of one k-group count share the partials' k sets
    by_kg = {}
    for b in gemv_blocks(plan):
        if b.rank == 0:
            by_kg.setdefault(b.k_groups, []).append(
                torch.arange(b.c0, b.c1, device=x.device))
    for kgn, chans in by_kg.items():
        ch = torch.cat(chans)
        wc = w[ch]
        total = None
        for r in range(plan.cluster):
            part = None
            for kg in range(kgn):
                sel = (rank_of == r) & (sub_of // (per_stage // kgn) == kg)
                p = xf[:, sel] @ wc[:, sel].t()
                part = p if part is None else part + p
            total = part if total is None else total + part
        out[:, ch] = total
    return (out * scale.to(torch.float32)).to(x.dtype)


def card_plan(x: torch.Tensor, wq: torch.Tensor, int4: bool) -> GemvPlan:
    """The plan the kernel makes for these operands on their card (its own
    host code's, read back), for checks beside a launch."""
    m, k = x.shape
    out = (ctypes.c_int * 7)()
    lib = _build.library("weight_only_gemv")
    lib.weight_only_gemv_plan(m, wq.shape[0], k, int(int4), 0,
                              ctypes.addressof(out))
    return GemvPlan(m, wq.shape[0], k, bool(int4), *out)


def _reference(x, w_int, scale):
    out = x.to(torch.float32) @ w_int.to(torch.float32).t()
    return (out * scale.to(torch.float32)).to(x.dtype)


def int4_matmul_reference(x: torch.Tensor, w_packed: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack, f32 matmul, scale, one rounding."""
    return _reference(x, unpack_int4(w_packed), scale)


def int8_weight_matmul_reference(x: torch.Tensor, wq: torch.Tensor,
                                 scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 product ``_mm`` computes."""
    return _reference(x, wq, scale)


def _mm_f32(x, w):
    """x @ w.T with an f32 result (w widened to x's dtype, exactly)."""
    w = w.to(x.dtype).t()
    return x @ w if x.dtype == torch.float32 \
        else torch.mm(x, w, out_dtype=torch.float32)


def _large_m(x, wq, scale, int4: bool):
    """The large-M route, the JAX package's XLA forms: int8 weights widen
    to x's dtype (exact) into one matmul with an f32 result; packed int4
    splits into its sign-extended low and high nibbles by int8 shifts and
    meets x's even and odd columns in two such matmuls (int4_matmul.py
    ``_xla_fallback``). Then the f32 scale and one rounding."""
    if int4:
        lo = (wq.view(torch.uint8) << 4).view(torch.int8) >> 4   # even k
        out = _mm_f32(x[:, 0::2], lo)
        del lo
        out += _mm_f32(x[:, 1::2], wq >> 4)                       # odd k
    else:
        out = _mm_f32(x, wq)
    return (out * scale).to(x.dtype)


def _weight_only(what: str, x, wq, scale, int4: bool):
    if x.ndim != 2 or wq.ndim != 2:
        raise ValueError(f"{what}: x [M, K] and w [N, K'] expected, got "
                         f"{list(x.shape)} / {list(wq.shape)}")
    m, k = x.shape
    n, kw = wq.shape
    if kw * (2 if int4 else 1) != k:
        raise ValueError(f"{what}: w {list(wq.shape)} does not match K={k}")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.shape != (n,):
        raise ValueError(f"{what}: w must be int8 and scale float32 [{n}], "
                         f"got {wq.dtype} / {scale.dtype} "
                         f"{list(scale.shape)}")
    if x.device.type == "cuda" and m > MAX_DECODE_M:
        _build.require_cuda(what, x, wq, scale)
        out = _large_m(x, wq, scale, int4)
        _build.LAUNCHES[what + LARGE_M_SUFFIX] += 1
        return out
    return _weight_only_op(what, x, wq, scale, bool(int4))


def _weight_only_cuda(what: str, x, wq, scale, int4: bool):
    m, k = x.shape
    n = wq.shape[0]
    dev = _build.require_cuda(what, x, wq, scale)
    _build.require_contiguous(what, x=x, w=wq, scale=scale)
    if x.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: the tensor-core GEMV takes bfloat16 or "
                         f"float16 x, got {x.dtype}")
    if k % K_MULTIPLE:
        raise ValueError(f"{what}: K={k} is not a multiple of "
                         f"{K_MULTIPLE} (the kernel's copies take rows of "
                         f"whole 16-byte units)")
    for name, t in (("x", x), ("w", wq)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if k == 0:      # an empty sum: no launch
        return torch.zeros((m, n), dtype=x.dtype, device=dev)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    lib = _build.library("weight_only_gemv")
    err = lib.weight_only_gemv_launch(x.data_ptr(), wq.data_ptr(),
                                      scale.data_ptr(), out.data_ptr(), m, n,
                                      k, int(int4),
                                      _build.dtype_code(x.dtype),
                                      _build.stream_ptr(dev))
    _build.check(lib, err, what)
    _build.LAUNCHES[what] += 1
    return out


# one operator for the two JAX functions the GEMV serves (`what` names the
# launch counter: int4_matmul or int8_weight_matmul); the large-M route
# (M > MAX_DECODE_M, plain PyTorch on the card) is no kernel and no
# operator
_weight_only_op = _build.kernel_op(
    "weight_only_gemv",
    "(str what, Tensor x, Tensor wq, Tensor scale, bool int4) -> Tensor",
    cuda=_weight_only_cuda,
    cpu=lambda what, x, wq, scale, int4: _reference(
        x, unpack_int4(wq) if int4 else wq, scale),
    fake=lambda what, x, wq, scale, int4: x.new_empty((x.shape[0],
                                                       wq.shape[0])))


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ unpack(w_packed [N, K // 2])^T * scale [N] -> [M, N] in
    x's dtype."""
    return _weight_only("int4_matmul", x, w_packed, scale, True)


def int8_weight_matmul(x: torch.Tensor, wq: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ wq [N, K]^T * scale [N] -> [M, N] in x's dtype."""
    return _weight_only("int8_weight_matmul", x, wq, scale, False)
