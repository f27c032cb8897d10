"""Single-token decode attention (counterpart of
paddle_tpu/kernels/decode_attention.py): ``paged_decode_attention`` over
paged pools, and ``decode_attention`` / ``gqa_decode_attention`` over
contiguous per-layer caches.

Contiguous caches: q [B, Hq, D]; k/v caches [B, Hkv, max_seq, D] in q's
dtype; lens [B] int32 = tokens cached before the current one, whose K/V
is already written at position lens[b] -- positions <= lens[b] are
attended. ``decode_attention`` takes equal heads (Hq == Hkv),
``gqa_decode_attention`` any Hq that is a multiple of Hkv; CUDA tensors
launch ``csrc/decode_attention.cu`` (one kernel for both, each wrapper
with its own launch counter), CPU tensors run
``decode_attention_reference``.

Paged pools (``paged_decode_attention``): q [B, Hq, D]; key/value pools
[max_pages, Hkv, block_size, D]; block tables [B, W] int32 page ids
covering positions [0, W*block_size); lens [B] int32 = tokens cached
before the current one, whose K/V is already written at position
lens[b] -- so positions <= lens[b] are attended (an inclusive mask).

int8 pools (``kv_cache_dtype="int8"``) pass their per-(page, kv head)
f32 absmax scales ``k_scale`` / ``v_scale`` [max_pages, Hkv]: a stored
value x of page p, kv head h stands for x * scale[p, h].

CUDA tensors launch ``csrc/paged_decode_attention.cu`` (one kernel for
every group size Hq/Hkv >= 1, i.e. both the JAX package's GQA grid and
its equal-heads grid, with an int8-pool variant that applies the scales
inside its f32 accumulation); CPU tensors run
``paged_decode_attention_reference``.

Both CUDA kernels split each row's positions across blocks
(flash-decoding, ``decode_split_plan``) and merge the splits' f32
partials in split order inside the same launch; ``split_decode_reference``
is the plain twin of that split-and-merge arithmetic (tests and the card
check hold the kernels against it; the wrappers never call it).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30
# cached positions per tile of the contiguous kernel, and the most rows a
# tile of the paged kernel takes (larger pages are walked in pieces)
CONTIG_TILE = 64
MAX_TILE_ROWS = 64
# the split rule aims at this many blocks per SM of the H100's 132
_SMS, _BLOCKS_PER_SM = 132, 4
# keys per tile, and rows per tile, of the paged prefill kernel
PREFILL_TILE = 64


# the split plans size their grid by the MODEL's kv heads: a serving_mp
# rank that holds 1/k of them plans under `model_kv_heads(k)`, so each of
# its rows splits (and merges) exactly as on one device
_PLAN_HEADS = [1]


@contextlib.contextmanager
def model_kv_heads(shards: int):
    """Within this block the split plans count `shards` x the kv heads
    they are given (a rank's share of a model sharded `shards` ways)."""
    prev, _PLAN_HEADS[0] = _PLAN_HEADS[0], int(shards)
    try:
        yield
    finally:
        _PLAN_HEADS[0] = prev


def decode_split_plan(n_tiles: int, b: int, hkv: int):
    """(tiles per split, splits) for rows of `n_tiles` tiles: enough
    splits that the grid (splits, Hkv, B) holds about four blocks per SM,
    at most one split per tile, every split `tps` tiles but the last.
    Hkv is the model's (`model_kv_heads`)."""
    hkv = hkv * _PLAN_HEADS[0]
    want = -(-_SMS * _BLOCKS_PER_SM // max(1, b * hkv))
    splits = max(1, min(n_tiles, want))
    tps = -(-n_tiles // splits)
    return tps, -(-n_tiles // tps)


def prefill_split_plan(span: int, tn: int, group: int, b: int, hkv: int):
    """(tiles per split, splits) of the paged prefill kernel's cached
    phase (csrc/paged_prefill_attention.cu), from the shapes alone:
    `span` = W * page positions the tables can name, in tiles of
    PREFILL_TILE keys, over ceil(tn * group / PREFILL_TILE) row tiles per
    (batch row, kv head). The decode rule on those rows: about four blocks
    per SM in the grid (row tiles, splits, B * Hkv), at most one split per
    tile."""
    return decode_split_plan(-(-span // PREFILL_TILE),
                             b * -(-tn * group // PREFILL_TILE), hkv)


def decode_tile_rows(block_size: int) -> int:
    """Rows per tile of the paged kernel: the page, or the largest divisor
    of it up to MAX_TILE_ROWS."""
    return next(r for r in range(min(block_size, MAX_TILE_ROWS), 0, -1)
                if block_size % r == 0)


def split_decode_reference(q, k_cache, v_cache, lens,
                           scale: Optional[float] = None, *,
                           block_tables=None, k_scale=None, v_scale=None,
                           tiles_per_split: Optional[int] = None):
    """The plain twin of the CUDA kernels' split-and-merge decode, in f32:
    each row's positions in tiles (CONTIG_TILE rows of a contiguous
    cache [B, Hkv, max_seq, D], or ``decode_tile_rows`` rows of a page of
    the pools [P, Hkv, bs, D] that `block_tables` names, ids clamped),
    `tiles_per_split` tiles a split (default ``decode_split_plan``'s).
    Per split: m = max score, l = sum p, acc = sum over tiles of the
    tile's p V (times its v scale on int8 pools; the k scale multiplies
    the score after the softmax scale); then out = sum_s w_s acc_s /
    sum_s w_s l_s with w_s = exp(m_s - max m). Splits past lens[b] weigh
    0. Returns [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    f32 = torch.float32
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ks = vs = None
    if block_tables is None:
        hkv, t_max = k_cache.shape[1], k_cache.shape[2]
        st = CONTIG_TILE
        k, v = k_cache.to(f32), v_cache.to(f32)
    else:
        n_pages, hkv, bs, _ = k_cache.shape
        w = block_tables.shape[1]
        st, t_max = decode_tile_rows(bs), w * bs
        tbl = block_tables.to(torch.int64).clamp(0, n_pages - 1)
        k, v = (pool[tbl].to(f32).permute(0, 2, 1, 3, 4)
                .reshape(b, hkv, t_max, d) for pool in (k_cache, v_cache))
        if k_scale is not None:     # per position: its page's scale
            ks, vs = (sc.to(f32)[tbl].permute(0, 2, 1)
                      .repeat_interleave(bs, dim=2)
                      for sc in (k_scale, v_scale))
    g = hq // hkv
    n_tiles = -(-t_max // st)
    tps = tiles_per_split or decode_split_plan(n_tiles, b, hkv)[0]
    n_split = -(-n_tiles // tps)
    pad = n_split * tps * st - t_max
    if pad:
        k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
        if ks is not None:
            ks, vs = (torch.nn.functional.pad(x, (0, pad)) for x in (ks, vs))
    qg = q.reshape(b, hkv, g, d).to(f32)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) * scale
    if ks is not None:
        s = s * ks[:, :, None, :]
    pos = torch.arange(s.shape[-1], device=q.device)
    valid = (pos[None, :] <= lens.to(torch.int64)[:, None]) \
        & (pos[None, :] < t_max)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    s = s.reshape(b, hkv, g, n_split, tps * st)
    m = torch.amax(s, dim=-1)                           # [B, Hkv, G, S]
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    pv = torch.einsum("bhgjt,bhjtd->bhgjd",
                      p.reshape(b, hkv, g, n_split * tps, st),
                      v.reshape(b, hkv, n_split * tps, st, d))
    if vs is not None:
        pv = pv * vs[:, :, ::st][:, :, None, :, None]
    acc = pv.reshape(b, hkv, g, n_split, tps, d).sum(4)
    # splits that start past lens[b] hold no attended position: weight 0
    live_tiles = torch.clamp(lens.to(torch.int64) // st + 1, max=n_tiles)
    live = torch.arange(n_split, device=q.device)[None, :] * tps \
        < live_tiles[:, None]                            # [B, S]
    m = torch.where(live[:, None, None, :], m, torch.full_like(m, _NEG_INF))
    wgt = torch.exp(m - torch.amax(m, dim=-1, keepdim=True))
    wgt = torch.where(live[:, None, None, :], wgt, torch.zeros_like(wgt))
    out = (wgt[..., None] * acc).sum(3) / (wgt * l).sum(3)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


# per device: the split launches' scratch (the decode kernels' and paged
# prefill's), reused launch after launch. Launches on one stream run in
# order; launches of these kernels on two streams of one device must not
# overlap (the port launches on the current stream only; a CUDA graph
# captures on a stream of its own, and its replays are not run beside
# eager launches)
_SCRATCH = {}


def split_scratch(dev, rows: int, splits: int, g: int, d: int):
    """Pointers (partials, counters) for a launch of `splits` splits over
    `rows` rows (decode: B*Hkv; paged prefill: B*Hkv*row tiles, G = 64
    rows a tile), or (None, None) for one split: f32 partials of
    G*D + 2G words a split (acc, m, l, padded to 16-byte units), and
    `rows` int counters that are zero between launches (each launch's last
    split resets its row's). The tensors stay in _SCRATCH. The counters
    are zeroed when they are made, so they must not first be made (or
    grown) inside a CUDA graph capture, which would only record the
    zeroing."""
    if splits == 1:
        return None, None
    floats = rows * splits * (g * d + -(-2 * g // 4) * 4)
    part, cnt = _SCRATCH.get(dev, (None, None))
    if cnt is None or cnt.numel() < rows:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "split attention kernels: launch once at this shape "
                "before capturing a CUDA graph (their split counters are "
                "made then)")
        cnt = torch.zeros(max(rows, 4096), dtype=torch.int32, device=dev)
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=dev)
    _SCRATCH[dev] = (part, cnt)
    return part.data_ptr(), cnt.data_ptr()


def split_scratch_tensors(dev) -> tuple:
    """The split launches' scratch on `dev` as it stands (empty before the
    first split launch). A CUDA graph that captured split launches names
    these buffers, so its owner holds them: a later launch that grows the
    scratch then cannot free memory the graph's replays still write."""
    return tuple(t for t in _SCRATCH.get(dev, ()) if t is not None)


def _require_rows(what, b, d, elem_size, *caches):
    """The kernels' rules: batch within the grid, D a multiple of 8 up to
    256, whole 16-byte rows, 16-byte aligned caches."""
    if b > 65535:
        raise ValueError(f"{what}: batch {b} exceeds the grid")
    if d % 8 or d > 256 or (d * elem_size) % 16:
        raise ValueError(f"{what}: head_dim {d} must be a multiple of 8 up "
                         f"to 256 with rows of whole 16-byte units")
    if any(c.data_ptr() % 16 for c in caches):
        raise ValueError(f"{what}: caches must be 16-byte aligned")


def paged_decode_attention_reference(q, key_cache, value_cache,
                                     block_tables, lens,
                                     scale: Optional[float] = None, *,
                                     k_scale=None, v_scale=None):
    """Plain PyTorch paged decode: gather the table's pages, mask
    positions > lens, softmax in f32. Page ids are clamped into the
    pool, as the CUDA kernel clamps them. int8 pages are dequantized in
    f32 against `k_scale` / `v_scale` [max_pages, Hkv] (never through a
    narrower type)."""
    b, hq, d = q.shape
    n_pages, hkv, bs, _ = key_cache.shape
    w = block_tables.shape[1]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tbl = block_tables.to(torch.int64).clamp(0, n_pages - 1)

    def gather(pool, sc):  # [B, W, Hkv, bs, D] -> [B, Hkv, W*bs, D] f32
        pages = pool[tbl].to(torch.float32)
        if sc is not None:
            pages = pages * sc.to(torch.float32)[tbl][..., None, None]
        return pages.permute(0, 2, 1, 3, 4).reshape(b, hkv, w * bs, d)

    k, v = gather(key_cache, k_scale), gather(value_cache, v_scale)
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) * scale
    pos = torch.arange(w * bs, device=q.device)
    valid = pos[None, :] <= lens.to(torch.int64)[:, None]       # [B, T]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v) / p.sum(-1, keepdim=True)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, key_cache: torch.Tensor,
                           value_cache: torch.Tensor,
                           block_tables: torch.Tensor, lens: torch.Tensor,
                           scale: Optional[float] = None, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One decode step over a paged cache. Returns [B, Hq, D]."""
    quant = _build.int8_pools(key_cache, k_scale, v_scale)
    b, hq, d = q.shape
    n_pages, hkv, bs, _ = key_cache.shape
    if hq % hkv:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _paged_decode_op(q, key_cache, value_cache, block_tables, lens,
                            float(scale), k_scale, v_scale)


def _paged_decode_cuda(q, key_cache, value_cache, block_tables, lens, scale,
                       k_scale, v_scale):
    quant = k_scale is not None
    b, hq, d = q.shape
    n_pages, hkv, bs, _ = key_cache.shape
    what = "paged_decode_attention"
    scales = (k_scale, v_scale) if quant else ()
    dev = _build.require_cuda(what, q, key_cache, value_cache,
                              block_tables, lens, *scales)
    _build.require_contiguous(what, q=q, key_cache=key_cache,
                              value_cache=value_cache,
                              block_tables=block_tables, lens=lens)
    if quant:
        _build.require_q8_operands(what, key_cache, value_cache, k_scale,
                                   v_scale)
    elif not (q.dtype == key_cache.dtype == value_cache.dtype):
        raise ValueError(f"{what}: q and pools must share a dtype, got "
                         f"{q.dtype}/{key_cache.dtype}/{value_cache.dtype}")
    if value_cache.shape != key_cache.shape or key_cache.shape[3] != d:
        raise ValueError(f"{what}: pools must be [P, {hkv}, bs, {d}], got "
                         f"{list(key_cache.shape)} / "
                         f"{list(value_cache.shape)}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"{what}: block_tables and lens must be int32")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or lens.shape != (b,):
        raise ValueError(f"{what}: block_tables [{b}, W] and lens [{b}] "
                         f"expected, got {list(block_tables.shape)} / "
                         f"{list(lens.shape)}")
    if hkv > 65535:
        raise ValueError(f"{what}: {hkv} kv heads exceed the grid")
    _require_rows(what, b, d, key_cache.element_size(), key_cache,
                  value_cache)
    w = block_tables.shape[1]
    st = decode_tile_rows(bs)
    tps, splits = decode_split_plan(w * (bs // st), b, hkv)
    stream = _build.stream_ptr(dev)
    out = torch.empty_like(q)
    lib = _build.library(what)
    ptrs = (out.data_ptr(),
            *split_scratch(dev, b * hkv, splits, hq // hkv, d))
    dims = (b, hq, hkv, d, bs, w, n_pages, st, tps, splits, float(scale),
            _build.dtype_code(q.dtype), stream)
    if quant:
        code = lib.paged_decode_attention_q8_launch(
            q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
            lens.data_ptr(), *ptrs, *dims)
        what += _build.INT8_SUFFIX
    else:
        code = lib.paged_decode_attention_launch(
            q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), *ptrs, *dims)
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return out


_paged_decode_op = _build.kernel_op(
    "paged_decode_attention",
    "(Tensor q, Tensor key_cache, Tensor value_cache, Tensor block_tables, "
    "Tensor lens, float scale, Tensor? k_scale, Tensor? v_scale) -> Tensor",
    cuda=_paged_decode_cuda,
    cpu=lambda q, kc, vc, t, lens, scale, ks, vs:
        paged_decode_attention_reference(q, kc, vc, t, lens, scale,
                                         k_scale=ks, v_scale=vs),
    fake=lambda q, *a: torch.empty_like(q))


def decode_attention_reference(q, k_cache, v_cache, lens,
                               scale: Optional[float] = None):
    """Plain PyTorch decode over contiguous caches [B, Hkv, max_seq, D]:
    mask positions > lens, softmax in f32, any group size."""
    b, hq, d = q.shape
    hkv, max_seq = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    s = torch.einsum("bhgd,bhtd->bhgt", qg,
                     k_cache.to(torch.float32)) * scale
    pos = torch.arange(max_seq, device=q.device)
    valid = pos[None, :] <= lens.to(torch.int64)[:, None]       # [B, T]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, _NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    out = torch.einsum("bhgt,bhtd->bhgd", p, v_cache.to(torch.float32)) \
        / p.sum(-1, keepdim=True)
    return out.reshape(b, hq, d).to(q.dtype)


def _contiguous_decode(what: str, q, k_cache, v_cache, lens, scale):
    b, hq, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: caches must be [{b}, Hkv, max_seq, {d}], "
                         f"got {list(k_cache.shape)} / "
                         f"{list(v_cache.shape)}")
    hkv, max_seq = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _contiguous_decode_op(what, q, k_cache, v_cache, lens,
                                 float(scale))


def _contiguous_decode_cuda(what, q, k_cache, v_cache, lens, scale):
    b, hq, d = q.shape
    hkv, max_seq = k_cache.shape[1], k_cache.shape[2]
    dev = _build.require_cuda(what, q, k_cache, v_cache, lens)
    _build.require_contiguous(what, q=q, k_cache=k_cache, v_cache=v_cache,
                              lens=lens)
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"{what}: q and caches must share a dtype, got "
                         f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if lens.dtype != torch.int32 or lens.shape != (b,):
        raise ValueError(f"{what}: lens must be int32 [{b}], got "
                         f"{lens.dtype} {list(lens.shape)}")
    if hkv > 65535:
        raise ValueError(f"{what}: {hkv} kv heads exceed the grid")
    _require_rows(what, b, d, k_cache.element_size(), k_cache, v_cache)
    tps, splits = decode_split_plan(-(-max_seq // CONTIG_TILE), b, hkv)
    stream = _build.stream_ptr(dev)
    out = torch.empty_like(q)
    lib = _build.library("decode_attention")
    code = lib.contiguous_decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), *split_scratch(dev, b * hkv, splits, hq // hkv, d),
        b, hq, hkv, d, max_seq, CONTIG_TILE, tps, splits, float(scale),
        _build.dtype_code(q.dtype), stream)
    _build.check(lib, code, what)
    _build.LAUNCHES[what] += 1
    return out


# one operator for the two JAX functions the kernel serves (`what` names
# the launch counter: decode_attention or gqa_decode_attention)
_contiguous_decode_op = _build.kernel_op(
    "contiguous_decode_attention",
    "(str what, Tensor q, Tensor k_cache, Tensor v_cache, Tensor lens, "
    "float scale) -> Tensor",
    cuda=_contiguous_decode_cuda,
    cpu=lambda what, q, kc, vc, lens, scale: decode_attention_reference(
        q, kc, vc, lens, scale),
    fake=lambda what, q, *a: torch.empty_like(q))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lens: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One decode step over contiguous caches with equal heads: q
    [B, H, D], caches [B, H, max_seq, D]. Returns [B, H, D]."""
    if k_cache.ndim == 4 and k_cache.shape[1] != q.shape[1]:
        raise ValueError(f"decode_attention: equal heads expected, got Hq "
                         f"{q.shape[1]} and Hkv {k_cache.shape[1]} (use "
                         "gqa_decode_attention)")
    return _contiguous_decode("decode_attention", q, k_cache, v_cache, lens,
                              scale)


def gqa_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lens: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """One grouped-query decode step over contiguous caches: q
    [B, Hq, D], caches [B, Hkv, max_seq, D], Hq % Hkv == 0. Returns
    [B, Hq, D]."""
    return _contiguous_decode("gqa_decode_attention", q, k_cache, v_cache,
                              lens, scale)
