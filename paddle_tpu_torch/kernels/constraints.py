"""The card's limits and cost models of the hand-written kernels
(counterpart of paddle_tpu/kernels/constraints.py).

One `KernelConstraint` per kernel operator ``paddle_tpu::<op>``
(`_build.kernel_op`), read by ``paddle_tpu_torch.analysis``:

- ``checker(args)`` lists the shapes and dtypes the CUDA kernel refuses
  (the checks its wrapper makes before a launch, as pure shape math):
  lint rule TPU102 reports them before the program reaches the card;
- ``roofline(args)`` is one launch's least work, ``{"flops", "hbm_bytes"}``:
  each input read once, each output written once, and the products the
  kernel does, the counts ``chip_smoke.py``'s bound column divides (and
  ``PERF.md``'s kernel table). A trace has shapes, not data, so the
  paged kernels count every page their tables name, and causal attention
  the causal pairs of its shapes.

``args`` maps the operator's schema argument names to a `TensorMeta`
(shape, dtype) for each tensor, a list of them for a tensor list, or the
Python value of any other argument.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch


class TensorMeta(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * itemsize(self.dtype)


def itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return torch.empty((), dtype=getattr(torch, str(dtype))).element_size()


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class KernelConstraint:
    """One kernel operator's card contract: `ops` are the operator names
    (``paddle_tpu::<op>``) it covers, `limits` the named card limits,
    `checker(args)` the violations (("error" | "warning", message)), and
    `roofline(args)` one launch's {"flops", "hbm_bytes"}."""

    name: str
    ops: Tuple[str, ...]
    limits: Dict[str, object]
    note: str = ""
    checker: Optional[Callable[[dict], Sequence[tuple]]] = None
    roofline: Optional[Callable[[dict], Optional[dict]]] = None

    def check(self, args: dict) -> list:
        return [] if self.checker is None else list(self.checker(args))


KERNEL_CONSTRAINTS: Dict[str, KernelConstraint] = {}
_BY_OP: Dict[str, KernelConstraint] = {}


def register_constraint(c: KernelConstraint) -> KernelConstraint:
    KERNEL_CONSTRAINTS[c.name] = c
    for op in c.ops:
        _BY_OP[op] = c
    return c


def constraint_for_op(op_name: str) -> Optional[KernelConstraint]:
    """The constraint of a kernel operator's name (``rms_norm`` or
    ``paddle_tpu::rms_norm``), None for any other operator."""
    return _BY_OP.get(op_name.split("::")[-1].split(".")[0])


def missing_scale_finding(args: dict):
    """An int8 pool without its f32 scales (the TPU103 finding), or
    None."""
    pool = args.get("key_cache", args.get("k_cache"))
    if pool is None or pool.dtype != torch.int8:
        return None
    if args.get("k_scale") is None or args.get("v_scale") is None:
        return ("warning", "int8 KV pools consumed without their "
                "per-(page, kv head) f32 scales: a quantized pool without "
                "scales decodes garbage")
    return None


def _err(msg):
    return ("error", msg)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

ATTENTION_HEAD_DIMS = (64, 128)     # flash_attention.KERNEL_HEAD_DIMS
SWIGLU_BLOCK = 512                  # swiglu._BLOCK
GEMV_K_MULTIPLE = 32                # int4_matmul.K_MULTIPLE
GEMV_MAX_M = 64                     # int4_matmul.MAX_DECODE_M
GRID_Y = 65535


def _rms_check(a):
    x, w = a["x"], a["w"]
    out = []
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        out.append(_err(f"the CUDA kernel takes float32/bfloat16/float16, "
                        f"got {dtype_name(x.dtype)}"))
    if w.shape != (x.shape[-1],) or w.dtype != x.dtype:
        out.append(_err(f"w must be [{x.shape[-1]}] {dtype_name(x.dtype)}"))
    return out


def _rms_roofline(a):
    x, w = a["x"], a["w"]
    return {"flops": 4 * x.numel, "hbm_bytes": 2 * x.nbytes + w.nbytes}


register_constraint(KernelConstraint(
    name="rms_norm", ops=("rms_norm",), limits={},
    note="one row a block; statistics in f32, one rounding",
    checker=_rms_check, roofline=_rms_roofline))


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes: row i sees keys
    [0, i + sk - sq] when causal (the diagonal aligned to the end)."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


def _flash_check(a):
    q, k = a["q"], a["k"]
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = []
    if any(a[n].dtype != torch.bfloat16 for n in ("q", "k", "v")):
        out.append(_err("the CUDA kernel takes bfloat16 q/k/v, got "
                        + "/".join(dtype_name(a[n].dtype)
                                   for n in ("q", "k", "v"))))
    if dh not in ATTENTION_HEAD_DIMS:
        out.append(_err(f"head_dim {dh} not in {ATTENTION_HEAD_DIMS}"))
    if hq % hkv:
        out.append(_err(f"Hq {hq} not a multiple of Hkv {hkv}"))
    if a["causal"] and sq > sk:
        out.append(_err(f"causal with Sq {sq} > Sk {sk}"))
    if b * hq > GRID_Y:
        out.append(_err(f"batch*heads {b * hq} exceeds the grid"))
    return out


def _flash_fwd_roofline(a):
    q, k = a["q"], a["k"]
    b, sq, hq, d = q.shape
    pairs = causal_pairs(sq, k.shape[1], a["causal"])
    return {"flops": 4 * b * hq * d * pairs,
            "hbm_bytes": 2 * q.nbytes + a["k"].nbytes + a["v"].nbytes
            + 4 * b * hq * sq}


def _dq_roofline(a):
    # as chip_smoke's dq bound: q, dO, k, v, lse and delta read once, dq
    # written once; one product's flops
    q, k = a["q"], a["k"]
    b, sq, hq, d = q.shape
    pairs = causal_pairs(sq, k.shape[1], a["causal"])
    return {"flops": 2 * b * hq * d * pairs,
            "hbm_bytes": 3 * q.nbytes + a["k"].nbytes + a["v"].nbytes
            + 2 * 4 * b * hq * sq}


def _dkv_roofline(a):
    # as chip_smoke's dkv bound: q, k, v, O-shaped dO and dq-shaped
    # reads, lse, and dk / dv written; four products
    q, k = a["q"], a["k"]
    b, sq, hq, d = q.shape
    pairs = causal_pairs(sq, k.shape[1], a["causal"])
    return {"flops": 8 * b * hq * d * pairs,
            "hbm_bytes": 3 * q.nbytes + 2 * (a["k"].nbytes + a["v"].nbytes)
            + 4 * b * hq * sq}


def _delta_roofline(a):
    out = a["out"]
    b, sq, hq, d = out.shape
    return {"flops": 2 * out.numel,
            "hbm_bytes": 2 * out.nbytes + 4 * b * hq * sq}


def _delta_check(a):
    out, do = a["out"], a["do"]
    if out.dtype != torch.bfloat16 or do.dtype != torch.bfloat16 \
            or out.shape[-1] % 2:
        return [_err("out / dO must be bfloat16 with an even head_dim")]
    return []


register_constraint(KernelConstraint(
    name="flash_attention_fwd", ops=("flash_attention_fwd",),
    limits={"head_dims": ATTENTION_HEAD_DIMS, "dtype": "bfloat16"},
    note="mma.sync tiles of 64 query rows (csrc/attention_tile.cuh); the "
         "score matrix never leaves registers",
    checker=_flash_check, roofline=_flash_fwd_roofline))
register_constraint(KernelConstraint(
    name="flash_attention_bwd_dq", ops=("flash_attention_bwd_dq",),
    limits={"head_dims": ATTENTION_HEAD_DIMS, "dtype": "bfloat16"},
    checker=_flash_check, roofline=_dq_roofline))
register_constraint(KernelConstraint(
    name="flash_attention_bwd_dkv", ops=("flash_attention_bwd_dkv",),
    limits={"head_dims": ATTENTION_HEAD_DIMS, "dtype": "bfloat16"},
    checker=_flash_check, roofline=_dkv_roofline))
register_constraint(KernelConstraint(
    name="flash_attention_bwd_delta", ops=("flash_attention_bwd_delta",),
    limits={"dtype": "bfloat16"}, checker=_delta_check,
    roofline=_delta_roofline))


def _swiglu_check(a):
    x = a["x2d"]
    m, k = x.shape
    f = a["wg"].shape[1]
    out = []
    if any(t.dtype != torch.bfloat16 for t in a.values()
           if isinstance(t, TensorMeta)):
        out.append(_err("the CUDA kernel takes bfloat16 operands"))
    if m % SWIGLU_BLOCK or k % SWIGLU_BLOCK or f % SWIGLU_BLOCK:
        out.append(_err(f"M, K and F must be multiples of {SWIGLU_BLOCK}, "
                        f"got M {m}, K {k}, F {f}"))
    return out


def _swiglu_roofline(a, outputs):
    x, wg = a["x2d"], a["wg"]
    m, k = x.shape
    f = wg.shape[1]
    it = itemsize(x.dtype)
    return {"flops": 4 * m * k * f,
            "hbm_bytes": it * (m * k + 2 * k * f + outputs * m * f)}


register_constraint(KernelConstraint(
    name="swiglu_fwd", ops=("swiglu_fwd",),
    limits={"multiple": SWIGLU_BLOCK, "dtype": "bfloat16"},
    note="warp-specialized wgmma, TMA ring, one CTA an SM",
    checker=_swiglu_check, roofline=lambda a: _swiglu_roofline(a, 1)))
register_constraint(KernelConstraint(
    name="swiglu_bwd", ops=("swiglu_bwd",),
    limits={"multiple": SWIGLU_BLOCK, "dtype": "bfloat16"},
    checker=_swiglu_check, roofline=lambda a: _swiglu_roofline(a, 3)))


def _rows_check(d, item, what="head_dim"):
    if d % 8 or d > 256 or (d * item) % 16:
        return [_err(f"{what} {d} must be a multiple of 8 up to 256 with "
                     "rows of whole 16-byte units")]
    return []


def _kv_dtype_check(a, q, pool):
    out = []
    finding = missing_scale_finding(a)
    if finding is not None:
        out.append(_err(finding[1]))
    elif pool.dtype != torch.int8 and pool.dtype != q.dtype:
        out.append(_err(f"q and pools must share a dtype, got "
                        f"{dtype_name(q.dtype)}/{dtype_name(pool.dtype)}"))
    return out


def _paged_decode_check(a):
    q, kc = a["q"], a["key_cache"]
    b, hq, d = q.shape
    hkv = kc.shape[1]
    out = _kv_dtype_check(a, q, kc)
    if hq % hkv:
        out.append(_err(f"Hq {hq} not a multiple of Hkv {hkv}"))
    return out + _rows_check(d, itemsize(kc.dtype))


def _pool_bytes(a, pool, tokens_per_row, pages_per_row, rows):
    """K and V bytes of `tokens_per_row` tokens of `rows` rows (int8:
    plus the two f32 scales of each named page and kv head)."""
    hkv, d = pool.shape[1], pool.shape[3]
    n = 2 * rows * tokens_per_row * hkv * d * itemsize(pool.dtype)
    if pool.dtype == torch.int8:
        n += 2 * rows * pages_per_row * hkv * 4
    return n


def _paged_decode_roofline(a):
    q, kc, t = a["q"], a["key_cache"], a["block_tables"]
    b, hq, d = q.shape
    w, bs = t.shape[1], kc.shape[2]
    return {"flops": 4 * b * hq * d * w * bs,
            "hbm_bytes": _pool_bytes(a, kc, w * bs, w, b) + 2 * q.nbytes
            + t.nbytes + a["lens"].nbytes}


register_constraint(KernelConstraint(
    name="paged_decode_attention", ops=("paged_decode_attention",),
    limits={"head_dim": "multiple of 8 up to 256"},
    note="one query token a row over paged bf16 / int8 pools, split "
         "across blocks and merged in the launch",
    checker=_paged_decode_check, roofline=_paged_decode_roofline))


def _contig_check(a):
    q, kc = a["q"], a["k_cache"]
    out = []
    if q.dtype != kc.dtype:
        out.append(_err("q and caches must share a dtype"))
    if q.shape[1] % kc.shape[1]:
        out.append(_err(f"Hq {q.shape[1]} not a multiple of Hkv "
                        f"{kc.shape[1]}"))
    return out + _rows_check(q.shape[2], itemsize(kc.dtype))


def _contig_roofline(a):
    q, kc = a["q"], a["k_cache"]
    b, hq, d = q.shape
    return {"flops": 4 * b * hq * d * kc.shape[2],
            "hbm_bytes": 2 * kc.nbytes + 2 * q.nbytes + a["lens"].nbytes}


register_constraint(KernelConstraint(
    name="contiguous_decode_attention", ops=("contiguous_decode_attention",),
    limits={"head_dim": "multiple of 8 up to 256"},
    checker=_contig_check, roofline=_contig_roofline))


def _prefill_check(a):
    q, kc = a["q"], a["key_cache"]
    b, tn, nh, dh = q.shape
    nkv = kc.shape[1]
    out = _kv_dtype_check(a, q, kc)
    if dh not in ATTENTION_HEAD_DIMS:
        out.append(_err(f"head_dim {dh} not in {ATTENTION_HEAD_DIMS}"))
    if nh % nkv:
        out.append(_err(f"Hq {nh} not a multiple of Hkv {nkv}"))
    if b * nkv > GRID_Y:
        out.append(_err(f"batch*kv heads {b * nkv} exceed the grid"))
    return out


def _prefill_roofline(a):
    # every page the tables name is cached context, every window row new
    q, kc, t = a["q"], a["key_cache"], a["block_tables"]
    b, tn, nh, dh = q.shape
    w, page = t.shape[1], kc.shape[2]
    cached = w * page
    pairs = b * (tn * cached + tn * (tn + 1) // 2)
    return {"flops": 4 * nh * dh * pairs,
            "hbm_bytes": 2 * q.nbytes + a["k_new"].nbytes
            + a["v_new"].nbytes + _pool_bytes(a, kc, cached, w, b)
            + t.nbytes + 2 * 4 * b}


register_constraint(KernelConstraint(
    name="paged_prefill_attention", ops=("paged_prefill_attention",),
    limits={"head_dims": ATTENTION_HEAD_DIMS, "page": "the pool's page"},
    note="prefix prefill and ragged windows over paged pools; cached "
         "phase split across blocks on bf16 / f16 operands",
    checker=_prefill_check, roofline=_prefill_roofline))


def _gemv_check(a):
    x, wq = a["x"], a["wq"]
    m, k = x.shape
    out = []
    if x.dtype not in (torch.bfloat16, torch.float16):
        out.append(_err(f"the tensor-core GEMV takes bfloat16 or float16 "
                        f"x, got {dtype_name(x.dtype)}"))
    if k % GEMV_K_MULTIPLE:
        out.append(_err(f"K={k} is not a multiple of {GEMV_K_MULTIPLE}"))
    if m > GEMV_MAX_M:
        out.append(_err(f"M={m} is over the GEMV's {GEMV_MAX_M} rows"))
    return out


def _gemv_roofline(a):
    x, wq = a["x"], a["wq"]
    m, k = x.shape
    n = wq.shape[0]
    return {"flops": 2 * m * n * k,
            "hbm_bytes": wq.nbytes + a["scale"].nbytes + x.nbytes
            + m * n * itemsize(x.dtype)}


register_constraint(KernelConstraint(
    name="weight_only_gemv", ops=("weight_only_gemv",),
    limits={"k_multiple": GEMV_K_MULTIPLE, "max_m": GEMV_MAX_M},
    note="int4 / int8 weights through a TMA ring, K split over 2-block "
         "clusters",
    checker=_gemv_check, roofline=_gemv_roofline))


def _mk_dims(a):
    h, kc, ws = a["h"], a["k_cache"], a["weights"]
    b, _, H = h.shape
    dh, bs, nkv = kc.shape[3], kc.shape[2], kc.shape[1]
    quant_w = any(s is not None for s in a["weight_scales"])
    wq = ws[1]
    nh = (wq.shape[1] if quant_w else wq.shape[2]) // dh
    F = 0
    if a["mlp"]:
        F = ws[6].shape[1] if quant_w else ws[6].shape[2]
    return b, H, F, nh, nkv, dh, bs, quant_w


def _mk_check(a):
    from .decode_megakernel import _card_reason

    b, H, F, nh, nkv, dh, bs, quant_w = _mk_dims(a)
    reason = _card_reason(b, H, F or None, nh, nkv, dh, bs, quant_w,
                          a["k_cache"].dtype == torch.int8, a["h"].dtype)
    return [] if reason is None else [_err(reason)]


def _mk_roofline(a):
    from .decode_megakernel import megakernel_roofline

    b, H, F, nh, nkv, dh, bs, _ = _mk_dims(a)
    kc, t = a["k_cache"], a["tables"]
    weights = sum(w.nbytes for w in a["weights"] + a["weight_scales"]
                  if w is not None)
    return megakernel_roofline(
        b=b, H=H, F=F, nh=nh, nkv=nkv, dh=dh, bs=bs,
        n_layers=a["n_layers"], weight_bytes=weights,
        positions=b * t.shape[1] * bs, kv_itemsize=itemsize(kc.dtype),
        row_itemsize=itemsize(a["h"].dtype), mlp=a["mlp"])


register_constraint(KernelConstraint(
    name="decode_megakernel",
    ops=("decode_megakernel", "decode_megakernel_partial"),
    limits={"max_rows": 16, "head_dim": "multiple of 16 up to 256",
            "smem_bytes": 232448},
    note="one cooperative launch a layer (attn, full) or for every layer "
         "(scan)", checker=_mk_check, roofline=_mk_roofline))
