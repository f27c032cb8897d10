// The decode megakernel: the serving decode step of one layer (rungs attn
// and full) or of every layer (rung scan) in one persistent launch.
//
// Replaces the Pallas kernels paddle_tpu/kernels/decode_megakernel.py
// `_decode_megakernel_kernel` (launched by `decode_layer_megakernel`, the
// attn rung: no MLP) and `_decode_megakernel_scan_kernel` (launched by
// `decode_layers_megakernel`, and at one layer by
// `decode_layer_megakernel_full`, where it is traced as
// `_decode_megakernel_full_kernel`). One kernel serves the three: `mlp`
// adds the MLP half, `L` walks the layers.
//
// Per layer, five phases with a grid-wide barrier between two phases:
//   1. rms_norm + q/k/v projections + rotary;
//   2. attention over the pages + the current token, then the commit of
//      the token into its page (bf16 slot write, or the int8 monotone-
//      scale read-modify-write of the whole page), after the page was read;
//   3. o projection + residual;
//   4. (mlp) post-attention rms_norm + gate and up, silu(g) * u;
//   5. (mlp) down + residual.
// The tensor-parallel seam of the attn rung (one layer, no MLP; JAX
// `_decode_megakernel_kernel`'s residual / quantize_out): out_mode 1 makes
// phase 3 store the f32 o-proj partial over this rank's heads into `pout`
// [b, H] instead of adding it to the residual; out_mode 2 then, after one
// more grid barrier, quantizes that partial per 128-lane block of a row
// into `qout` [b, H] int8 and `qsc` [b, H / 128] f32 with
// parallel/collectives.py `quantize_blocks`' ops in their order (scale =
// absmax / 127, divide by the scale or by 1 where it is 0, round half to
// even, no clip; a NaN in the block makes the scale NaN), one warp a block.
// The residual stream lives in `out` [b, H] for the whole launch (seeded
// from h), never in a per-layer copy. Data written inside the launch is
// read with ld.global.cg (L2), never through a possibly stale L1.
// Numerics: every sum is f32 in a fixed order (a launch repeats its
// outputs bitwise); a weight-only scale multiplies the whole sum; the
// residual adds in f32 and rounds once; gate and up round to the compute
// type before silu(g) * u; rotary rounds its products as the plain version.
//
// Bound on the H100: bytes. A decode step at b = 8 reads every weight once
// (Llama-3-8B int8: 218 MB a layer, 2.1 ms a step at 3.35 TB/s) plus the
// named KV pages; the flops are 2 b per weight value.
//
// Design. A first version (one block per 32-slot item, 4-byte weight
// loads, inputs re-staged per item, scalar attention one page at a time)
// reached 6-9% of that bound. This one runs one block per SM slot of the
// occupancy query, all resident (cooperative launch), each block eight
// consumer warps and one producer warp:
// - GEMV phases (1, 3, 4, 5): a tile of 16 (int8 weights) or 64 (dense)
//   output channels meets the <= 16 input rows on the tensor cores:
//   mma.sync m16n8k16 with A = 16 channels x 16 k of W (int8 widened to
//   bf16 exactly; dense [K, N] tiles through ldmatrix.trans) and B = 8
//   input rows (rows 9-16: a second n8 tile), f32 accumulators. f32
//   activations take an FMA product step over the same pipeline.
// - Weights stream through a ring of STAGES 16 KB shared-memory stages
//   filled by the producer warp with bulk copies (cp.async.bulk, a full /
//   empty mbarrier pair a stage). The producer walks the block's whole
//   weight stream -- its items of phase 1, 3, 4, 5, then the next
//   layer's -- and never waits on a grid barrier (weights are not written
//   in the launch), so while the consumers finish a phase, wait at a
//   barrier or attend (phase 2), the next phase's first stages land. The
//   consumer warps meet a stage's mbarrier, not each other.
// - A block stages its phase input once per phase (the residual rows,
//   normalized on the way in with one rms per row, or ctx); phase 5's
//   input y [b, F] is read from L2 beside the ring. A phase's tiles are
//   split along K (the launch's plan: the fewest splits whose items fall
//   within 10% evenly on the grid); the splits' f32 partials meet in a
//   scratch that the tile's last arriver sums in split order.
// - Tile maps keep each epilogue's pairs in one tile: a phase-1 tile holds
//   channels {c..} and {c + D/2..} of one head (rotate-half pairs), a
//   phase-4 tile 8 (32) gate and 8 (32) up channels of the same index.
// - Phase 2 (flash-decoding): all (row, kv head) tiles of positions
//   strictly below lens in one list, cut into equal contiguous shares, one
//   a block; the share's run inside a (row, head) is a piece. A block walks
//   its pieces with the decode body's helpers (decode_attention_body.cuh:
//   8-element lane slices, four query heads a read of K) over a four-stage
//   cp.async ring of K / V tiles. A piece leaves an f32 partial (m, l,
//   acc); the row's last piece to finish (an int counter per (row, kv
//   head), reset by that block) merges them in piece order, joins the
//   current token's k / v from the projection (unquantized), writes ctx
//   and commits: every read of the commit page is done by then. A row in
//   one piece finishes in place. The walk is the megakernel's own (strict
//   mask, the current token, the commit, pages of layer l, shares across
//   rows) over the body's helpers, leaving the standalone decode kernel
//   untouched.
// - The grid barrier is a generation counter: one red.release arrival a
//   block (block 0 adds 2^31 - (grid - 1), so the top bit flips when all
//   have arrived), an ld.acquire spin, no reset.
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "decode_attention_body.cuh"
#include "fragments.cuh"
#include "weight_ring.cuh"

#ifndef MK_STAMPS  // port_measure.py's per-phase build defines these
#define MK_STAMP_START()
#define MK_STAMP_ARRIVE(i)
#define MK_STAMP_LEAVE(i)
#define MK_SPAN_BEGIN(v)
#define MK_SPAN_END(kind, v)
#endif

namespace {

constexpr int NT = 256;               // consumer threads (8 warps)
constexpr int NWARP = NT / 32;
constexpr int NTHREADS = NT + 32;     // and the producer warp
constexpr int MAXB = 16;              // rows per launch
constexpr int STAGES = 4;             // weight ring depth
constexpr int MISC_BYTES = 512;       // flag, plans, row tiles, ring
constexpr int MBAR_OFFSET = 320;      // the ring's full / empty mbarriers
constexpr float NEG = -1e30f;

enum { WQ = 0, WK, WV, WO, WG, WU, WD };

// A GEMV tile of each weight kind: TN output channels, TK k values a ring
// stage, the stage as ROWS staged rows of ROW bytes (padded by 16 bytes
// against bank conflicts), KG warps sharing the channels along k, and the
// row padding of the staged input (elements).
template <typename T, bool QW>
struct Geo;
// int8 [N, K]: a row per channel, 1024 k; warp w takes k [128 w, +128)
template <typename T>
struct Geo<T, true> {
  static constexpr int TN = 16, TK = 1024, ROWS = 16, ROW = 1024, KG = 8;
  static constexpr int XPAD = std::is_same<T, float>::value ? 4 : 16;
};
// dense bf16 [K, N]: a row per k, 64 channels; warps 4 channel groups x 2
template <>
struct Geo<__nv_bfloat16, false> {
  static constexpr int TN = 64, TK = 128, ROWS = 128, ROW = 128, KG = 2;
  static constexpr int XPAD = 8;
};
template <>
struct Geo<float, false> {
  static constexpr int TN = 64, TK = 64, ROWS = 64, ROW = 256, KG = 2;
  static constexpr int XPAD = 4;
};

template <typename T, bool QW>
struct Ring {
  static constexpr int PITCH = Geo<T, QW>::ROW + 16;
  static constexpr int STAGE = Geo<T, QW>::ROWS * PITCH;
  static_assert(Geo<T, QW>::ROWS * Geo<T, QW>::ROW == 16384,
                "a stage holds 16 KB of weights");
  static_assert(MBAR_OFFSET + 16 * STAGES <= MISC_BYTES,
                "the ring's mbarriers fit the misc area");
};

// the consumer warps' block barrier (the producer warp never joins one)
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

struct Args {
  const void* h;
  void* out;
  const int* lens;
  const int* tables;
  const float* cos_t;
  const float* sin_t;
  const void* w_in;
  const void* w_post;
  const void* w[7];       // q k v o gate up down, stacked [L, ...]
  const float* s[7];      // their f32 scales [L, N] (int8 weights)
  void* kc;
  void* vc;
  float* ksc;
  float* vsc;
  void* q_ws;
  void* k_ws;
  void* v_ws;
  void* ctx_ws;
  void* y_ws;
  float* part;            // split partials (GEMV k splits, attention)
  int* cnt;               // their arrival counters, zero on entry
  unsigned* bar;          // the grid barrier's counter, zero on entry
  float* pout;            // out_mode 1, 2: the f32 o-proj partial [B, H]
  int8_t* qout;           // out_mode 2: its int8 blocks [B, H]
  float* qsc;             // out_mode 2: their scales [B, H / 128]
  int out_mode;           // 0 residual, 1 f32 partial, 2 int8 partial
  int L, B, H, F, NH, NKV, D, BS, W, P;   // P: pool pages per layer
  int mlp;
  int ks[4];              // K splits of phases 1, 3, 4, 5 (plan())
  int st;                 // attention: rows of a K / V tile
  float scale, eps;
};

// one GEMV phase of the plan: tiles, ring stages along K, K splits,
// stages a split, items (tiles x splits; item i = split i / tiles of tile
// i % tiles)
struct PhasePlan {
  int tiles, nst, ks, spk, items;
};

template <typename T, bool QW>
__host__ __device__ inline PhasePlan phase_plan(const Args& a, int pi) {
  using G = Geo<T, QW>;
  const int half = G::TN / 2;
  int tiles, K;
  switch (pi) {
    case 0:   // q / k / v heads, each in tiles of rotate-half pairs
      tiles = (a.NH + 2 * a.NKV) * ((a.D / 2 + half - 1) / half);
      K = a.H;
      break;
    case 1:
      tiles = (a.H + G::TN - 1) / G::TN;
      K = a.NH * a.D;
      break;
    case 2:   // half gate, half up channels
      tiles = a.mlp ? (a.F + half - 1) / half : 0;
      K = a.H;
      break;
    default:
      tiles = a.mlp ? (a.H + G::TN - 1) / G::TN : 0;
      K = a.F;
      break;
  }
  PhasePlan p;
  p.tiles = tiles;
  p.nst = (K + G::TK - 1) / G::TK;
  p.ks = a.ks[pi] < 1 ? 1 : a.ks[pi];
  p.spk = (p.nst + p.ks - 1) / p.ks;
  p.items = tiles * p.ks;
  return p;
}

// a tile's two halves of TN / 2 channels: matrix (this layer's), first
// column, valid columns
struct Seg {
  const void* w;
  int col, n;
};

struct TileMap {
  Seg seg[2];
  int mat, K, N;   // matrix of the halves (phase 4: WG, then WU), K, N
};

template <typename T, bool QW>
__device__ __forceinline__ const void* layer_w(const void* w, int l,
                                               int64_t per_layer) {
  return QW ? static_cast<const void*>(static_cast<const int8_t*>(w) +
                                       l * per_layer)
            : static_cast<const void*>(static_cast<const T*>(w) +
                                       l * per_layer);
}

template <typename T, bool QW>
__device__ TileMap tile_map(const Args& a, int l, int pi, int tile) {
  constexpr int half = Geo<T, QW>::TN / 2;
  TileMap t;
  if (pi == 0) {
    const int tph = (a.D / 2 + half - 1) / half;
    const int head = tile / tph, c0 = (tile - head * tph) * half;
    int hh;
    if (head < a.NH) { t.mat = WQ; hh = head; }
    else if (head < a.NH + a.NKV) { t.mat = WK; hh = head - a.NH; }
    else { t.mat = WV; hh = head - a.NH - a.NKV; }
    t.K = a.H;
    t.N = (t.mat == WQ ? a.NH : a.NKV) * a.D;
    const void* w = layer_w<T, QW>(a.w[t.mat], l,
                                   static_cast<int64_t>(t.N) * t.K);
    const int n = min(half, a.D / 2 - c0);
    t.seg[0] = {w, hh * a.D + c0, n};
    t.seg[1] = {w, hh * a.D + a.D / 2 + c0, n};
  } else if (pi == 2) {
    t.mat = WG;
    t.K = a.H;
    t.N = a.F;
    const int64_t per = static_cast<int64_t>(a.H) * a.F;
    const int col = tile * half, n = max(0, min(half, a.F - col));
    t.seg[0] = {layer_w<T, QW>(a.w[WG], l, per), col, n};
    t.seg[1] = {layer_w<T, QW>(a.w[WU], l, per), col, n};
  } else {
    t.mat = pi == 1 ? WO : WD;
    t.K = pi == 1 ? a.NH * a.D : a.F;
    t.N = a.H;
    const void* w = layer_w<T, QW>(a.w[t.mat], l,
                                   static_cast<int64_t>(t.N) * t.K);
    for (int h = 0; h < 2; ++h) {
      const int col = tile * 2 * half + h * half;
      t.seg[h] = {w, col, max(0, min(half, a.H - col))};
    }
  }
  return t;
}

// the block's weight stream: (layer, GEMV phase, item, stage) in the
// order the block consumes them; l == L once it is exhausted
struct Cursor {
  int l, pi, it, s, s1;
};

__device__ __forceinline__ void next_stage(Cursor& c, const PhasePlan* pp,
                                           int L, int nph) {
  if (++c.s < c.s1) return;
  for (;;) {
    c.it += gridDim.x;
    while (c.it >= pp[c.pi].items) {
      if (++c.pi == nph) {
        c.pi = 0;
        if (++c.l >= L) return;
      }
      c.it = blockIdx.x;
    }
    const PhasePlan& q = pp[c.pi];
    c.s = (c.it / q.tiles) * q.spk;
    c.s1 = min(c.s + q.spk, q.nst);
    if (c.s < c.s1) return;
  }
}

// the producer warp's copies of one stage into a ring slot, completing on
// `full`. int8: a bulk copy a valid channel's row of the stage's k (lanes
// 0-15, one expect_tx arrival); bytes past K or of invalid channels keep
// older weights, finite int8 that meet only zero inputs or channels no
// epilogue stores. Dense: rows of 64 or 128 bytes are too short for the
// copy engine, so 16-byte cp.async copies (32 a lane, zero-filled past K
// and past a half's valid channels), each lane's arrival once its copies
// land.
template <typename T, bool QW>
__device__ void issue_stage(const TileMap& t, int s, unsigned char* slot,
                            uint64_t* full) {
  using G = Geo<T, QW>;
  constexpr int PITCH = Ring<T, QW>::PITCH;
  const int lane = threadIdx.x & 31;
  const int k0 = s * G::TK;
  if constexpr (QW) {
    const uint32_t row = min(G::TK, t.K - k0);
    const int n = t.seg[0].n + t.seg[1].n;
    if (lane == 0) mb_expect_tx(full, row * n);
    __syncwarp();
    if (lane < G::TN) {
      const Seg& sg = t.seg[lane / (G::TN / 2)];
      const int jj = lane % (G::TN / 2);
      if (jj < sg.n)
        bulk_g2s(slot + lane * PITCH,
                 static_cast<const int8_t*>(sg.w) +
                     static_cast<int64_t>(sg.col + jj) * t.K + k0,
                 row, full);
    }
  } else {
    constexpr int E = 16 / sizeof(T);              // elements a copy
    constexpr int CPR = G::ROW / 16, HALF = CPR / 2;
#pragma unroll 4
    for (int i = lane; i < G::ROWS * CPR; i += 32) {
      const int kk = i / CPR, rest = i - kk * CPR;
      const int hf = rest / HALF, cc = rest - hf * HALF;
      const Seg& sg = t.seg[hf];
      const bool ok = k0 + kk < t.K && cc * E < sg.n;
      const T* src = static_cast<const T*>(sg.w) +
                     (ok ? static_cast<int64_t>(k0 + kk) * t.N + sg.col +
                               cc * E
                         : 0);
      cp_async16(slot + kk * PITCH + hf * (G::TN / 2) * sizeof(T) + 16 * cc,
                 src, ok);
    }
    mb_arrive_cp_async(full);
  }
}

// the producer warp: the block's whole weight stream, layer after layer,
// into the ring as fast as slots free up; it never waits on a grid
// barrier (weights are not written in the launch)
template <typename T, bool QW>
__device__ void produce(const Args& a, const PhasePlan* pp, int nph,
                        unsigned char* ring, uint64_t* full,
                        uint64_t* empty) {
  Cursor c = {0, 0,
              static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x), 0,
              0};
  next_stage(c, pp, a.L, nph);
  int map_l = -1, map_pi = -1, map_it = -1;
  TileMap map;
  for (int n = 0; c.l < a.L; ++n) {
    const int slot = n % STAGES;
    if (n >= STAGES) mb_wait(empty + slot, ((n / STAGES) & 1) ^ 1);
    if (c.it != map_it || c.pi != map_pi || c.l != map_l) {
      map = tile_map<T, QW>(a, c.l, c.pi, c.it % pp[c.pi].tiles);
      map_l = c.l;
      map_pi = c.pi;
      map_it = c.it;
    }
    issue_stage<T, QW>(map, c.s, ring + slot * Ring<T, QW>::STAGE,
                       full + slot);
    next_stage(c, pp, a.L, nph);
  }
}

// input words for the products: from the staged rows in shared memory, or
// (phase 5) from device memory through L2, zero past K
template <bool XG>
__device__ __forceinline__ uint32_t x_u32(const void* p, bool ok) {
  if constexpr (XG)
    return ok ? __ldcg(static_cast<const unsigned*>(p)) : 0u;
  else
    return *static_cast<const uint32_t*>(p);
}
template <bool XG>
__device__ __forceinline__ uint2 x_u64(const void* p, bool ok) {
  if constexpr (XG)
    return ok ? __ldcg(static_cast<const uint2*>(p)) : make_uint2(0u, 0u);
  else
    return *static_cast<const uint2*>(p);
}
template <bool XG>
__device__ __forceinline__ float x_f32(const float* p, bool ok) {
  if constexpr (XG)
    return ok ? __ldcg(p) : 0.f;
  else
    return *p;
}

// one ring stage into the warp's C fragments: c[nt] = (channels g, g + 8)
// x (rows 2t, 2t + 1) of row tile nt (rows 8 nt ..). x: row 0 of the
// input, `xp` elements a row; k0: the stage's first k.
template <typename T, bool QW, bool XG>
__device__ __forceinline__ void stage_product(const unsigned char* slot,
                                              const T* x, int xp, int K,
                                              int B, int k0,
                                              float (&c)[2][4]) {
  using G = Geo<T, QW>;
  constexpr int PITCH = Ring<T, QW>::PITCH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool two = B > 8;
  if constexpr (!std::is_same<T, float>::value && QW) {
    // warp w: k [128 w, +128); step s: k 16 s + 4 t .. + 3 of channels g,
    // g + 8 (one word each) into A slots (2t, 2t+1) and (2t+8, 2t+9), the
    // same four k of rows g, g + 8 as one 8-byte word of B
    const unsigned char* wa = slot + g * PITCH + warp * 128 + 4 * t;
    const int kb = k0 + warp * 128 + 4 * t;
    const T* x0 = x + static_cast<int64_t>(min(g, B - 1)) * xp + kb;
    const T* x1 = x + static_cast<int64_t>(min(g + 8, B - 1)) * xp + kb;
    uint2 xb[2][8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const bool ok = kb + 16 * s < K;
      xb[0][s] = x_u64<XG>(x0 + 16 * s, ok);
      xb[1][s] = two ? x_u64<XG>(x1 + 16 * s, ok) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      uint32_t af[4];
      int8_word_pairs<T>(*reinterpret_cast<const uint32_t*>(wa + 16 * s),
                         &af[0], &af[2]);
      int8_word_pairs<T>(
          *reinterpret_cast<const uint32_t*>(wa + 8 * PITCH + 16 * s), &af[1],
          &af[3]);
      mma16816<T>(c[0], af, xb[0][s].x, xb[0][s].y);
      if (two) mma16816<T>(c[1], af, xb[1][s].x, xb[1][s].y);
    }
  } else if constexpr (!std::is_same<T, float>::value) {
    // warp (kg, cg): k [64 kg, +64), channels 16 cg ..; A from the [k][n]
    // tile by ldmatrix.trans, B = rows g, g + 8 at k 2t.. and 2t + 8..
    const int cg = warp & 3, kg = warp >> 2;
    const int mi = lane >> 3, r = lane & 7;
    const unsigned char* ab = slot + (kg * 64 + r + (mi >> 1) * 8) * PITCH +
                              (cg * 16 + (mi & 1) * 8) * 2;
    const int kb = k0 + kg * 64 + 2 * t;
    const T* x0 = x + static_cast<int64_t>(min(g, B - 1)) * xp + kb;
    const T* x1 = x + static_cast<int64_t>(min(g + 8, B - 1)) * xp + kb;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t af[4];
      ldsm_x4_trans(af, ab + 16 * s * PITCH);
      const int k = kb + 16 * s;
      mma16816<T>(c[0], af, x_u32<XG>(x0 + 16 * s, k < K),
                  x_u32<XG>(x0 + 16 * s + 8, k + 8 < K));
      if (two)
        mma16816<T>(c[1], af, x_u32<XG>(x1 + 16 * s, k < K),
                    x_u32<XG>(x1 + 16 * s + 8, k + 8 < K));
    }
  } else {
    // f32 activations: the same partition, an FMA product step; thread
    // (g, t) owns its C fragment's channels and rows and sums its k in
    // order
    const int cb = QW ? 0 : (warp & 3) * 16;
    const int kw = QW ? warp * 128 : (warp >> 2) * 32;
    const int nk = QW ? 128 : 32;
    const float* xr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      xr[e] = x + static_cast<int64_t>(min(2 * t + (e & 1) + 8 * (e >> 1),
                                           B - 1)) * xp;
    for (int kk = 0; kk < nk; ++kk) {
      const int k = kw + kk;
      float w0, w1;
      if constexpr (QW) {
        w0 = static_cast<float>(
            reinterpret_cast<const int8_t*>(slot)[g * PITCH + k]);
        w1 = static_cast<float>(
            reinterpret_cast<const int8_t*>(slot)[(g + 8) * PITCH + k]);
      } else {
        const float* wr = reinterpret_cast<const float*>(slot + k * PITCH);
        w0 = wr[cb + g];
        w1 = wr[cb + g + 8];
      }
      const bool ok = k0 + k < K;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt && !two) break;
        const float xa = x_f32<XG>(xr[2 * nt] + k0 + k, ok);
        const float xb = x_f32<XG>(xr[2 * nt + 1] + k0 + k, ok);
        c[nt][0] += w0 * xa;
        c[nt][1] += w0 * xb;
        c[nt][2] += w1 * xa;
        c[nt][3] += w1 * xb;
      }
    }
  }
}

// one item's stages [s0, s1) through the ring, then the warps' fragments
// summed over k groups in order into red[m * TN + j]; with K splits the
// tile's last arriver sums the splits' partials in split order. Returns
// whether this block finishes the tile (its epilogue reads red).
template <typename T, bool QW, bool XG>
__device__ bool gemv_item(const Args& a, int& consumed, unsigned char* ring,
                          uint64_t* full, uint64_t* empty, float* red,
                          int* flag, const T* x, int xp, int K, int tile,
                          int ksi, int s0, int s1, int ks) {
  using G = Geo<T, QW>;
  const int B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int s = s0; s < s1; ++s, ++consumed) {
    const int slot = consumed % STAGES;
    mb_wait(full + slot, (consumed / STAGES) & 1);   // the stage landed
    stage_product<T, QW, XG>(ring + slot * Ring<T, QW>::STAGE, x, xp, K, B,
                             s * G::TK, c);
    __syncwarp();
    if (lane == 0) mb_arrive(empty + slot);          // this warp is done
  }
  const int g = lane >> 2, t = lane & 3;
  const int kg = QW ? warp : warp >> 2, cb = QW ? 0 : (warp & 3) * 16;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 2 * t + (e & 1) + 8 * nt;
      if (row < B)
        red[(kg * B + row) * G::TN + cb + g + (e >> 1) * 8] = c[nt][e];
    }
  csync();
  const int n = B * G::TN;
  for (int i = threadIdx.x; i < n; i += NT) {
    float v = red[i];
#pragma unroll
    for (int q = 1; q < G::KG; ++q) v += red[q * n + i];
    red[i] = v;
  }
  if (ks == 1) {
    csync();
    return true;
  }
  float* mine = a.part + (static_cast<int64_t>(tile) * ks + ksi) * n;
  for (int i = threadIdx.x; i < n; i += NT) mine[i] = red[i];
  __threadfence();
  csync();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(a.cnt + tile, 1);
    *flag = done == ks - 1;
    if (*flag) a.cnt[tile] = 0;     // ready for the next phase
  }
  csync();
  if (!*flag) return false;
  __threadfence();
  const float* all = a.part + static_cast<int64_t>(tile) * ks * n;
  for (int i = threadIdx.x; i < n; i += NT) {
    float v = 0.f;
    for (int q = 0; q < ks; ++q) v += __ldcg(all + static_cast<int64_t>(q) * n + i);
    red[i] = v;
  }
  csync();
  return true;
}

// rows [B, K] of src into xs (pitch xp, zeros to Kp) through cp.async (one
// round trip to L2 for the whole input); with `norm`, each row then scaled
// by 1 / rms(row) (over K, f32) and norm[k], rounded to T, a warp a row
template <typename T>
__device__ void stage_input(const T* src, const T* norm, int B, int K,
                            int Kp, int xp, float eps, T* xs) {
  constexpr int E = 16 / sizeof(T);
  const int per = Kp / E;
  for (int i = threadIdx.x; i < B * per; i += NT) {
    const int m = i / per, k = (i - m * per) * E;
    cp_async16(xs + static_cast<int64_t>(m) * xp + k,
               src + static_cast<int64_t>(m) * K + (k < K ? k : 0), k < K);
  }
  cp_async_commit();
  cp_async_wait<0>();
  csync();
  if (norm == nullptr) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < B; m += NWARP) {
    T* row = xs + static_cast<int64_t>(m) * xp;
    float ss = 0.f;
    for (int k = lane * E; k < K; k += 32 * E) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + k);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < E; ++j) ss += to_f32(e[j]) * to_f32(e[j]);
    }
    ss = warp_sum(ss);
    const float inv = 1.f / sqrtf(ss / static_cast<float>(K) + eps);
    for (int k = lane * E; k < K; k += 32 * E) {
      uint4 v = *reinterpret_cast<const uint4*>(row + k);
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(norm + k));
      T* e = reinterpret_cast<T*>(&v);
      const T* n = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < E; ++j)
        e[j] = from_f32<T>(to_f32(e[j]) * inv * to_f32(n[j]));
      *reinterpret_cast<uint4*>(row + k) = v;
    }
  }
  csync();
}

__device__ __forceinline__ float rn_mul(float a, float b) {
  return __fmul_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T ldcg_t(const T* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ __nv_bfloat16 ldcg_t(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// the grid barrier (every block is resident: cooperative launch)
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned& nb) {
  csync();
  if (threadIdx.x == 0) {
    MK_STAMP_ARRIVE(nb);
    const unsigned inc =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old, cur;
    __threadfence();
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(bar), "r"(inc)
                 : "memory");
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(cur)
                   : "l"(bar)
                   : "memory");
    } while (((old ^ cur) & 0x80000000u) == 0);
    __threadfence();
    MK_STAMP_LEAVE(nb);
  }
  ++nb;
  csync();
}

// phase 2's K / V ring: four stages of a K and a V tile (two on f32
// pools, whose tiles are twice the bytes)
template <typename KT>
struct AttStages {
  static constexpr int N = std::is_same<KT, float>::value ? 2 : 4;
};

// phase 2's shared memory: f32 q [G, D], acc [KS, G, D] (KS: the decode
// body's key splits of P V), scores [G, st], m / l / corr [G], the merge
// flag; the ring's stages; the current token's k / v (f32 [D]), its
// weight per head, a block reduction
struct AttnLayout {
  size_t q, acc, s, m, l, c, flag, kv, stage, kcur, vcur, p, red, bytes;
  __host__ __device__ AttnLayout(int G, int D, int st, int kt_size,
                                 int stages) {
    const size_t gd = static_cast<size_t>(G) * D;
    q = 0;
    acc = q + gd * 4;
    s = acc + dec_key_splits(G, D) * gd * 4;
    m = s + static_cast<size_t>(G) * st * 4;
    l = m + G * 4;
    c = l + G * 4;
    flag = c + G * 4;
    kv = (flag + 4 + 15) / 16 * 16;
    stage = static_cast<size_t>(st) * D * kt_size;   // one K or V tile
    kcur = kv + 2 * stages * stage;
    vcur = kcur + static_cast<size_t>(D) * 4;
    p = vcur + static_cast<size_t>(D) * 4;
    red = p + static_cast<size_t>(G) * 4;
    bytes = (red + NWARP * 4 + 15) / 16 * 16;
  }
};

template <typename KT>
__host__ __device__ inline AttnLayout attn_layout(int G, int D, int st) {
  return AttnLayout(G, D, st, sizeof(KT), AttStages<KT>::N);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  csync();
  if (lane == 0) red[warp] = v;
  csync();
  float r = red[0];
  for (int i = 1; i < NWARP; ++i) r = fmaxf(r, red[i]);
  csync();
  return r;
}

// the row's attention state (m_s, l_s, acc [G, D]) joined by the current
// token, written to ctx, then the token committed into its page
template <typename T, typename KT>
__device__ void finish_row(const Args& a, int l, int m, int h,
                           unsigned char* area, const AttnLayout& A) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  const int D = a.D, G = a.NH / a.NKV, BS = a.BS, NKV = a.NKV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* q_s = reinterpret_cast<const float*>(area + A.q);
  const float* acc = reinterpret_cast<const float*>(area + A.acc);
  float* m_s = reinterpret_cast<float*>(area + A.m);
  float* l_s = reinterpret_cast<float*>(area + A.l);
  float* c_s = reinterpret_cast<float*>(area + A.c);
  float* kcur = reinterpret_cast<float*>(area + A.kcur);
  float* vcur = reinterpret_cast<float*>(area + A.vcur);
  float* p_s = reinterpret_cast<float*>(area + A.p);
  float* red = reinterpret_cast<float*>(area + A.red);
  const int64_t row = static_cast<int64_t>(m) * NKV + h;
  const T* kw = static_cast<const T*>(a.k_ws) + row * D;
  const T* vw = static_cast<const T*>(a.v_ws) + row * D;
  for (int d = threadIdx.x; d < D; d += NT) {
    kcur[d] = to_f32(ldcg_t(kw + d));
    vcur[d] = to_f32(ldcg_t(vw + d));
  }
  csync();
  for (int g = warp; g < G; g += NWARP) {
    float d = 0.f;
    for (int c = lane; c < D; c += 32) d += q_s[g * D + c] * kcur[c];
    d = warp_sum(d);
    if (lane == 0) {
      const float s = d * a.scale;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, s);
      const float corr = expf(m_old - m_new);
      const float p = expf(s - m_new);
      l_s[g] = l_s[g] * corr + p;
      c_s[g] = corr;
      p_s[g] = p;
      m_s[g] = m_new;
    }
  }
  csync();
  T* cw = static_cast<T*>(a.ctx_ws) +
          (static_cast<int64_t>(m) * a.NH + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, c = i - g * D;
    const float v = acc[i] * c_s[g] + p_s[g] * vcur[c];
    const float lg = l_s[g];
    cw[i] = from_f32<T>(v / (lg > 0.f ? lg : 1.f));
  }

  // commit the token into its page (every read of the page is done)
  KT* kc = static_cast<KT*>(a.kc);
  KT* vc = static_cast<KT*>(a.vc);
  const int len = a.lens[m];
  const int colc = min(len / BS, a.W - 1);
  const int64_t page =
      min(max(a.tables[static_cast<int64_t>(m) * a.W + colc], 0), a.P - 1) +
      static_cast<int64_t>(l) * a.P;
  const int64_t sidx = page * NKV + h;
  const int64_t tile = static_cast<int64_t>(BS) * D;
  const int slot = len % BS;
  if constexpr (!Q8) {
    for (int d = threadIdx.x; d < D; d += NT) {
      kc[sidx * tile + slot * D + d] = from_f32<T>(kcur[d]);
      vc[sidx * tile + slot * D + d] = from_f32<T>(vcur[d]);
    }
  } else {
    for (int which = 0; which < 2; ++which) {
      const float* tok = which ? vcur : kcur;
      int8_t* pool = (which ? vc : kc) + sidx * tile;
      float* sc = which ? a.vsc : a.ksc;
      float am = 0.f;
      for (int d = threadIdx.x; d < D; d += NT) am = fmaxf(am, fabsf(tok[d]));
      am = block_max(am, red) / 127.f;
      const float old = slot == 0 ? 0.f : __ldcg(sc + sidx);
      const float nw = fmaxf(old, am);
      const float safe = nw > 0.f ? nw : 1.f;
      const float ratio = old / safe;
      // 16 bytes a thread at a time (a page's rows are whole 16-byte
      // units: D % 16 == 0)
      for (int i16 = threadIdx.x; i16 < tile / 16; i16 += NT) {
        uint4 u = __ldcg(reinterpret_cast<const uint4*>(pool) + i16);
        int8_t* e = reinterpret_cast<int8_t*>(&u);
        const int r = 16 * i16 / D, c0 = 16 * i16 - r * D;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float q = r == slot ? rintf(tok[c0 + j] / safe)
                              : rintf(static_cast<float>(e[j]) * ratio);
          q = fminf(fmaxf(q, -127.f), 127.f);
          e[j] = static_cast<int8_t>(q);
        }
        reinterpret_cast<uint4*>(pool)[i16] = u;
      }
      csync();
      if (threadIdx.x == 0) sc[sidx] = nw;
    }
  }
  csync();
}

// one piece of phase 2 at layer l: tiles [j0, j1) of (row m, kv head h),
// piece `piece` of the `n_pieces` the row's tiles are cut into; its
// partial goes to slot slot0 + piece, and the last piece to finish
// merges slots slot0 .. slot0 + n_pieces - 1 in order
template <typename T, typename KT>
__device__ void attend_piece(const Args& a, int l, int m, int h, int j0,
                             int j1, int piece, int n_pieces, int slot0,
                             unsigned char* area) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  constexpr int S = AttStages<KT>::N;
  const int G = a.NH / a.NKV, D = a.D, st = a.st, NKV = a.NKV;
  const int per = a.BS / st;
  const int len = a.lens[m];

  const AttnLayout A = attn_layout<KT>(G, D, st);
  float* q_s = reinterpret_cast<float*>(area + A.q);
  float* acc_s = reinterpret_cast<float*>(area + A.acc);
  float* s_s = reinterpret_cast<float*>(area + A.s);
  float* m_s = reinterpret_cast<float*>(area + A.m);
  float* l_s = reinterpret_cast<float*>(area + A.l);
  float* c_s = reinterpret_cast<float*>(area + A.c);
  int* flag = reinterpret_cast<int*>(area + A.flag);
  KT* kv_s = reinterpret_cast<KT*>(area + A.kv);
  const size_t stage_elems = A.stage / sizeof(KT);
  const KT* kc = static_cast<const KT*>(a.kc);
  const KT* vc = static_cast<const KT*>(a.vc);
  const int* trow = a.tables + static_cast<int64_t>(m) * a.W;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nsl = D / 8;
  const int lpr = dec_lanes_per_row(D);
  const int c = lane & (lpr - 1);
  const bool has = c < nsl;
  const int kpw = 32 / lpr;
  const int KS = dec_key_splits(G, D);

  // tile j: its page of layer l and the rows (j % per) * st onward
  auto locate = [&](int j, int64_t* sidx) {
    const int page = min(max(trow[j / per], 0), a.P - 1);
    *sidx = (static_cast<int64_t>(page) + static_cast<int64_t>(l) * a.P) *
                NKV + h;
    return (*sidx * a.BS + static_cast<int64_t>(j % per) * st) * D;
  };
  auto copy = [&](int j, int slot) {
    int64_t sidx;
    KT* k = kv_s + 2 * slot * stage_elems;
    start_tile_copy(k, k + stage_elems, kc, vc, locate(j, &sidx), st, D);
  };

  csync();   // the area's previous user is done
  MK_SPAN_BEGIN(t_start);
  for (int i = 0; i < S - 1; ++i) {
    if (j0 + i < j1) copy(j0 + i, i);
    cp_async_commit();
  }
  const T* qb = static_cast<const T*>(a.q_ws) +
                (static_cast<int64_t>(m) * a.NH + h * G) * D;
  for (int i = tid; i < G * D; i += NT) q_s[i] = to_f32(ldcg_t(qb + i));
  for (int i = tid; i < KS * G * D; i += NT) acc_s[i] = 0.f;
  for (int g = tid; g < G; g += NT) {
    m_s[g] = NEG;
    l_s[g] = 0.f;
  }
  csync();

  MK_SPAN_END(0, t_start);
  MK_SPAN_BEGIN(t_tiles);
  for (int j = j0; j < j1; ++j) {
    const int i = j - j0;
    const KT* k_t = kv_s + 2 * (i % S) * stage_elems;
    const KT* v_t = k_t + stage_elems;
    if (j + S - 1 < j1) copy(j + S - 1, (i + S - 1) % S);
    cp_async_commit();
    cp_async_wait<S - 1>();
    int64_t sidx;
    locate(j, &sidx);
    float k_scale = 1.f, v_scale = 1.f;
    if constexpr (Q8) {
      k_scale = __ldcg(a.ksc + sidx);
      v_scale = __ldcg(a.vsc + sidx);
    }
    csync();
    // scores, masked strictly below len
    for (int g0 = 0; g0 < G; g0 += DEC_HEADS) {
      float qr[DEC_HEADS][8];
#pragma unroll
      for (int i = 0; i < DEC_HEADS; ++i) {
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[i][e] = 0.f;
        if (has && g0 + i < G) {
          const float* qg = q_s + (g0 + i) * D;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float4 v4 = *reinterpret_cast<const float4*>(
                qg + half_off<KT>(c, hf, D));
            qr[i][4 * hf] = v4.x;
            qr[i][4 * hf + 1] = v4.y;
            qr[i][4 * hf + 2] = v4.z;
            qr[i][4 * hf + 3] = v4.w;
          }
        }
      }
      for (int base = warp * kpw; base < st; base += NWARP * kpw) {
        const int t = base + lane / lpr;
        const bool live = t < st;
        float kx[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) kx[e] = 0.f;
        if (live && has)
          load_slice(k_t + static_cast<int64_t>(t) * D, c, D, kx);
        float d[DEC_HEADS];
#pragma unroll
        for (int i = 0; i < DEC_HEADS; ++i) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s += qr[i][e] * kx[e];
          for (int o = lpr >> 1; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          d[i] = s;
        }
        if (c == 0 && live) {
          const bool valid = j * st + t < len;
#pragma unroll
          for (int i = 0; i < DEC_HEADS; ++i) {
            if (g0 + i >= G) break;
            float s = d[i] * a.scale;
            if constexpr (Q8) s = s * k_scale;
            s_s[(g0 + i) * st + t] = valid ? s : NEG;
          }
        }
      }
    }
    csync();

    for (int g = warp; g < G; g += NWARP) {
      float* sg = s_s + g * st;
      float mx = NEG;
      for (int t = lane; t < st; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < st; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
      }
    }
    csync();

    if (has) {
      for (int u = tid / lpr; u < G * KS; u += NT / lpr) {
        const int g = u / KS, ks = u - g * KS;
        const float* pg = s_s + g * st;
        float pv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) pv[e] = 0.f;
        for (int t = ks; t < st; t += KS) {
          const float p = pg[t];
          float vx[8];
          load_slice(v_t + static_cast<int64_t>(t) * D, c, D, vx);
#pragma unroll
          for (int e = 0; e < 8; ++e) pv[e] += p * vx[e];
        }
        const float corr = c_s[g];
        float* ap = acc_s + (static_cast<size_t>(ks) * G + g) * D;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float4* a4 =
              reinterpret_cast<float4*>(ap + half_off<KT>(c, hf, D));
          float4 v4 = *a4;
          v4.x = v4.x * corr + pv[4 * hf] * v_scale;
          v4.y = v4.y * corr + pv[4 * hf + 1] * v_scale;
          v4.z = v4.z * corr + pv[4 * hf + 2] * v_scale;
          v4.w = v4.w * corr + pv[4 * hf + 3] * v_scale;
          *a4 = v4;
        }
      }
    }
    csync();
  }

  MK_SPAN_END(1, t_tiles);
  MK_SPAN_BEGIN(t_end);
  for (int i = tid; i < G * D; i += NT) {
    float v = acc_s[i];
    for (int ks = 1; ks < KS; ++ks)
      v += acc_s[static_cast<size_t>(ks) * G * D + i];
    acc_s[i] = v;
  }
  csync();
  if (n_pieces == 1) {
    MK_SPAN_END(2, t_end);
    MK_SPAN_BEGIN(t_finish);
    finish_row<T, KT>(a, l, m, h, area, A);
    MK_SPAN_END(4, t_finish);
    return;
  }

  // this piece's partial (acc [G, D], m [G], l [G]); the row's last
  // piece merges them all in piece order
  const int GD = G * D;
  const int64_t row = static_cast<int64_t>(m) * NKV + h;
  const int64_t pstride = dec_partial_floats(G, D);
  float* mine = a.part + (slot0 + piece) * pstride;
  for (int i4 = tid; i4 < GD / 4; i4 += NT)
    reinterpret_cast<float4*>(mine)[i4] =
        reinterpret_cast<const float4*>(acc_s)[i4];
  for (int g = tid; g < G; g += NT) {
    mine[GD + g] = m_s[g];
    mine[GD + G + g] = l_s[g];
  }
  __threadfence();
  csync();
  if (tid == 0) {
    const int done = atomicAdd(a.cnt + row, 1);
    *flag = done == n_pieces - 1;
    if (*flag) a.cnt[row] = 0;      // ready for the next layer
  }
  csync();
  MK_SPAN_END(2, t_end);
  if (!*flag) return;
  MK_SPAN_BEGIN(t_merge);
  __threadfence();
  const float* rp = a.part + slot0 * pstride;
  for (int g = warp; g < G; g += NWARP) {
    float mx = NEG;
    for (int s = lane; s < n_pieces; s += 32)
      mx = fmaxf(mx, __ldcg(rp + s * pstride + GD + g));
    mx = warp_max(mx);
    float ls = 0.f;
    for (int s = lane; s < n_pieces; s += 32) {
      const float* ps = rp + s * pstride + GD;
      ls += expf(__ldcg(ps + g) - mx) * __ldcg(ps + G + g);
    }
    ls = warp_sum(ls);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = ls;
    }
  }
  csync();
  for (int i4 = tid; i4 < GD / 4; i4 += NT) {
    const int g = 4 * i4 / D;
    const float mx = m_s[g];
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_pieces; ++s) {
      const float* ps = rp + s * pstride;
      const float w = expf(__ldcg(ps + GD + g) - mx);
      const float4 a4 = __ldcg(reinterpret_cast<const float4*>(ps) + i4);
      o.x += w * a4.x;
      o.y += w * a4.y;
      o.z += w * a4.z;
      o.w += w * a4.w;
    }
    reinterpret_cast<float4*>(acc_s)[i4] = o;
  }
  csync();
  MK_SPAN_END(3, t_merge);
  MK_SPAN_BEGIN(t_finish);
  finish_row<T, KT>(a, l, m, h, area, A);
  MK_SPAN_END(4, t_finish);
}

// shared memory: misc | ring | red | union(staged input, phase 2's area)
template <typename T, bool QW, bool QKV>
struct Layout {
  size_t ring, red, area, bytes;
  int kp, xp;     // staged input: columns (zero-padded), pitch
  __host__ __device__ Layout(const Args& a) {
    using G = Geo<T, QW>;
    using KT = typename std::conditional<QKV, int8_t, T>::type;
    const int kmax = a.H > a.NH * a.D ? a.H : a.NH * a.D;
    kp = (kmax + G::TK - 1) / G::TK * G::TK;
    xp = kp + G::XPAD;
    ring = MISC_BYTES;
    red = ring + static_cast<size_t>(STAGES) * Ring<T, QW>::STAGE;
    area = red + static_cast<size_t>(G::KG) * a.B * G::TN * 4;
    const size_t x = static_cast<size_t>(a.B) * xp * sizeof(T);
    const size_t att = attn_layout<KT>(a.NH / a.NKV, a.D, a.st).bytes;
    bytes = area + (x > att ? x : att);
  }
};

template <typename T, bool QW, bool QKV>
__global__ void __launch_bounds__(NTHREADS, 1) mega_kernel(Args a) {
  using G = Geo<T, QW>;
  using KT = typename std::conditional<QKV, int8_t, T>::type;
  constexpr int TN = G::TN, HALF = TN / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T, QW, QKV> LY(a);
  int* flag = reinterpret_cast<int*>(smem);
  PhasePlan* pp = reinterpret_cast<PhasePlan*>(smem + 16);   // [4]
  int* rt = reinterpret_cast<int*>(smem + 128);   // [MAXB] tiles a row
  int* rp = rt + MAXB;                            // [MAXB + 1] prefix
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + MBAR_OFFSET);
  uint64_t* empty = full + STAGES;
  unsigned char* ring = smem + LY.ring;
  float* red = reinterpret_cast<float*>(smem + LY.red);
  unsigned char* area = smem + LY.area;
  T* xs = reinterpret_cast<T*>(area);
  const int B = a.B, H = a.H, F = a.F, D = a.D, NH = a.NH, NKV = a.NKV;
  const int tid = threadIdx.x, nph = a.mlp ? 4 : 2;
  const int64_t HQ = static_cast<int64_t>(NH) * D;
  T* out = static_cast<T*>(a.out);

  if (tid < 4) pp[tid] = phase_plan<T, QW>(a, tid);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's expect_tx arrival (int8), or its 32 lanes' (dense)
      mb_init(full + s, QW ? 1 : 32);
      mb_init(empty + s, NWARP);     // one arrival a consumer warp
    }
    mb_init_fence();
  }
  if (blockIdx.x == 0 && tid == 0) MK_STAMP_START();
  __syncthreads();
  if (tid >= NT) {                   // the producer warp
    produce<T, QW>(a, pp, nph, ring, full, empty);
    return;
  }
  int consumed = 0;                  // ring stages this block consumed

  // the residual stream starts as h (phase 1 of layer 0 reads h itself;
  // phase 3 reads out two barriers later)
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * NT + tid;
       i < static_cast<int64_t>(B) * H;
       i += static_cast<int64_t>(gridDim.x) * NT)
    out[i] = static_cast<const T*>(a.h)[i];
  unsigned nb = 0;

  for (int l = 0; l < a.L; ++l) {
    // ---- 1: rms_norm + q/k/v + rotary
    {
      const PhasePlan P = pp[0];
      if (static_cast<int>(blockIdx.x) < P.items)
        stage_input<T>(l == 0 ? static_cast<const T*>(a.h) : out,
                       static_cast<const T*>(a.w_in) +
                           static_cast<int64_t>(l) * H,
                       B, H, LY.kp, LY.xp, a.eps, xs);
      const int tph = (D / 2 + HALF - 1) / HALF;
      for (int it = blockIdx.x; it < P.items; it += gridDim.x) {
        const int tile = it % P.tiles, ksi = it / P.tiles;
        const int s0 = ksi * P.spk, s1 = min(s0 + P.spk, P.nst);
        if (!gemv_item<T, QW, false>(a, consumed, ring, full, empty, red, flag, xs,
                                     LY.xp, H, tile, ksi, s0, s1, P.ks))
          continue;
        const int head = tile / tph, c0 = (tile - head * tph) * HALF;
        int mat, hh;
        if (head < NH) { mat = WQ; hh = head; }
        else if (head < NH + NKV) { mat = WK; hh = head - NH; }
        else { mat = WV; hh = head - NH - NKV; }
        const int64_t N = mat == WQ ? HQ : static_cast<int64_t>(NKV) * D;
        const float* sc = QW ? a.s[mat] + l * N : nullptr;
        T* dst = static_cast<T*>(mat == WQ ? a.q_ws : mat == WK ? a.k_ws
                                                                : a.v_ws);
        const int dh2 = D / 2;
        for (int i = tid; i < B * HALF; i += NT) {
          const int m = i / HALF, cc = i - m * HALF;
          const int d = c0 + cc;
          if (d >= dh2) continue;
          const int na = hh * D + d, nbb = na + dh2;
          float va = red[m * TN + cc], vb = red[m * TN + HALF + cc];
          if (QW) { va = va * sc[na]; vb = vb * sc[nbb]; }
          T ta = from_f32<T>(va), tb = from_f32<T>(vb);
          if (mat != WV) {
            const T cs = from_f32<T>(a.cos_t[m * dh2 + d]);
            const T sn = from_f32<T>(a.sin_t[m * dh2 + d]);
            const float fa = to_f32(ta), fb = to_f32(tb);
            const float fc = to_f32(cs), fs = to_f32(sn);
            const T a1 = from_f32<T>(rn_mul(fa, fc)),
                    a2 = from_f32<T>(rn_mul(fb, fs));
            const T b1 = from_f32<T>(rn_mul(fb, fc)),
                    b2 = from_f32<T>(rn_mul(fa, fs));
            ta = from_f32<T>(__fsub_rn(to_f32(a1), to_f32(a2)));
            tb = from_f32<T>(__fadd_rn(to_f32(b1), to_f32(b2)));
          }
          dst[m * N + na] = ta;
          dst[m * N + nbb] = tb;
        }
        csync();   // red is the next item's
      }
    }
    grid_barrier(a.bar, nb);

    // ---- 2: attention over the pages + the current token, then commit.
    // Every (row, kv head)'s tiles in one list (row-major, a row's heads
    // one after another); the first min(blocks, tiles) blocks take equal
    // contiguous shares, a piece per (row, head) a share meets.
    // Rows with no position finish in the block of their index.
    {
      if (tid < B)
        rt[tid] = min(a.W * (a.BS / a.st), (a.lens[tid] + a.st - 1) / a.st);
      csync();
      if (tid == 0) {
        int sum = 0;
        for (int m = 0; m < B; ++m) {
          rp[m] = sum;
          sum += rt[m] * NKV;
        }
        rp[B] = sum;
      }
      csync();
      // at most one block a tile: every share then holds a tile, and the
      // blocks between a row's first and last share each hold a piece
      const int64_t T_ = rp[B];
      const int64_t nblk = min(static_cast<int64_t>(gridDim.x), T_);
      const int64_t b = blockIdx.x;
      int64_t t = b < nblk ? b * T_ / nblk : T_;
      const int64_t t1 = b < nblk ? (b + 1) * T_ / nblk : T_;
      while (t < t1) {
        int m = 0;
        while (rp[m + 1] <= t) ++m;
        const int hh = static_cast<int>((t - rp[m]) / rt[m]);
        const int64_t s0 = rp[m] + static_cast<int64_t>(hh) * rt[m];
        const int64_t e0 = s0 + rt[m], e = min(t1, e0);
        // the blocks whose shares meet [s0, e0): ceil((t + 1) n / T) - 1
        const int fb = static_cast<int>(((s0 + 1) * nblk + T_ - 1) / T_ - 1);
        const int lb = static_cast<int>((e0 * nblk + T_ - 1) / T_ - 1);
        attend_piece<T, KT>(a, l, m, hh, static_cast<int>(t - s0),
                            static_cast<int>(e - s0),
                            static_cast<int>(b) - fb, lb - fb + 1,
                            fb + m * NKV + hh, area);
        t = e;
      }
      for (int q = blockIdx.x; q < B * NKV; q += gridDim.x)
        if (rt[q / NKV] == 0)
          attend_piece<T, KT>(a, l, q / NKV, q % NKV, 0, 0, 0, 1, 0, area);
    }
    grid_barrier(a.bar, nb);

    // ---- 3: o projection + residual
    {
      const PhasePlan P = pp[1];
      if (static_cast<int>(blockIdx.x) < P.items)
        stage_input<T>(static_cast<const T*>(a.ctx_ws), nullptr, B,
                       static_cast<int>(HQ), LY.kp, LY.xp, a.eps, xs);
      const float* sc = QW ? a.s[WO] + static_cast<int64_t>(l) * H : nullptr;
      for (int it = blockIdx.x; it < P.items; it += gridDim.x) {
        const int tile = it % P.tiles, ksi = it / P.tiles;
        const int s0 = ksi * P.spk, s1 = min(s0 + P.spk, P.nst);
        if (!gemv_item<T, QW, false>(a, consumed, ring, full, empty, red, flag, xs,
                                     LY.xp, static_cast<int>(HQ), tile, ksi,
                                     s0, s1, P.ks))
          continue;
        for (int i = tid; i < B * TN; i += NT) {
          const int m = i / TN, n = tile * TN + (i - m * TN);
          if (n >= H) continue;
          float p = red[i];
          if (QW) p = p * sc[n];
          if (a.out_mode) {          // the partial: the caller sums ranks
            a.pout[static_cast<int64_t>(m) * H + n] = p;
            continue;
          }
          T* o = out + static_cast<int64_t>(m) * H + n;
          *o = from_f32<T>(__fadd_rn(to_f32(ldcg_t(o)), p));
        }
        csync();
      }
    }
    if (!a.mlp) {
      if (l + 1 < a.L) grid_barrier(a.bar, nb);
      continue;
    }
    grid_barrier(a.bar, nb);

    // ---- 4: post-attention rms_norm + gate / up + silu(g) * u
    {
      const PhasePlan P = pp[2];
      if (static_cast<int>(blockIdx.x) < P.items)
        stage_input<T>(out,
                       static_cast<const T*>(a.w_post) +
                           static_cast<int64_t>(l) * H,
                       B, H, LY.kp, LY.xp, a.eps, xs);
      const float* sg = QW ? a.s[WG] + static_cast<int64_t>(l) * F : nullptr;
      const float* su = QW ? a.s[WU] + static_cast<int64_t>(l) * F : nullptr;
      T* y = static_cast<T*>(a.y_ws);
      for (int it = blockIdx.x; it < P.items; it += gridDim.x) {
        const int tile = it % P.tiles, ksi = it / P.tiles;
        const int s0 = ksi * P.spk, s1 = min(s0 + P.spk, P.nst);
        if (!gemv_item<T, QW, false>(a, consumed, ring, full, empty, red, flag, xs,
                                     LY.xp, H, tile, ksi, s0, s1, P.ks))
          continue;
        for (int i = tid; i < B * HALF; i += NT) {
          const int m = i / HALF, cc = i - m * HALF, n = tile * HALF + cc;
          if (n >= F) continue;
          float g = red[m * TN + cc], u = red[m * TN + HALF + cc];
          if (QW) { g = g * sg[n]; u = u * su[n]; }
          const float gt = to_f32(from_f32<T>(g)), ut = to_f32(from_f32<T>(u));
          const float sl = to_f32(from_f32<T>(gt / (1.f + expf(-gt))));
          y[static_cast<int64_t>(m) * F + n] = from_f32<T>(rn_mul(sl, ut));
        }
        csync();
      }
    }
    grid_barrier(a.bar, nb);

    // ---- 5: down + residual (y read from L2 beside the ring)
    {
      const PhasePlan P = pp[3];
      const float* sc = QW ? a.s[WD] + static_cast<int64_t>(l) * H : nullptr;
      for (int it = blockIdx.x; it < P.items; it += gridDim.x) {
        const int tile = it % P.tiles, ksi = it / P.tiles;
        const int s0 = ksi * P.spk, s1 = min(s0 + P.spk, P.nst);
        if (!gemv_item<T, QW, true>(a, consumed, ring, full, empty, red, flag,
                                    static_cast<const T*>(a.y_ws), F, F,
                                    tile, ksi, s0, s1, P.ks))
          continue;
        for (int i = tid; i < B * TN; i += NT) {
          const int m = i / TN, n = tile * TN + (i - m * TN);
          if (n >= H) continue;
          float p = red[i];
          if (QW) p = p * sc[n];
          T* o = out + static_cast<int64_t>(m) * H + n;
          *o = from_f32<T>(__fadd_rn(to_f32(ldcg_t(o)), p));
        }
        csync();
      }
    }
    if (l + 1 < a.L) grid_barrier(a.bar, nb);
  }
  if (a.out_mode == 2) {
    // ---- 6 (quantize_out): the partial's 128-lane blocks to int8, one
    // warp a (row, block); the partial was written by other blocks, so
    // it is read through L2
    grid_barrier(a.bar, nb);
    const int warp = tid >> 5, lane = tid & 31, nbk = H / 128;
    for (int it = blockIdx.x * NWARP + warp; it < B * nbk;
         it += gridDim.x * NWARP) {
      const int64_t off = static_cast<int64_t>(it) * 128;  // row-major
      float v[4], amax = 0.f;
      bool nan = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = __ldcg(a.pout + off + lane + 32 * e);
        nan |= v[e] != v[e];
        amax = fmaxf(amax, fabsf(v[e]));
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float sc = __any_sync(0xffffffffu, nan) ? __int_as_float(0x7fc00000)
                                                     : __fdiv_rn(amax, 127.f);
      const float safe = sc > 0.f ? sc : 1.f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a.qout[off + lane + 32 * e] =
            static_cast<int8_t>(__float2int_rn(__fdiv_rn(v[e], safe)));
      if (lane == 0) a.qsc[it] = sc;
    }
  }
  csync();
  if (tid == 0) MK_STAMP_ARRIVE(nb);
}

// the launch's shape checks (the wrapper refuses these first, with the
// card's words)
inline bool shapes_ok(const Args& a, int elem) {
  const int unit = 16 / elem;   // weight / input elements a 16-byte copy
  return a.B >= 1 && a.B <= MAXB && a.NKV >= 1 && a.NH % a.NKV == 0 &&
         a.D % 16 == 0 && a.D <= 256 && a.H % unit == 0 &&
         (a.NH * a.D) % unit == 0 && (!a.mlp || a.F % unit == 0) &&
         a.st > 0 && a.BS % a.st == 0 && a.L >= 1 &&
         (a.out_mode == 0 || (a.L == 1 && !a.mlp)) &&
         (a.out_mode != 2 || a.H % 128 == 0);
}

// resident blocks of the launch (occupancy x SMs) and its shared memory;
// the last answer is kept per instantiation (the engine launches one
// shape again and again)
template <typename T, bool QW, bool QKV>
int resident(const Args& a, int* blocks, int* smem_out) {
  static int kept_dev = -1, kept_smem = -1, kept_blocks = 0;
  const int smem = static_cast<int>(Layout<T, QW, QKV>(a).bytes);
  *smem_out = smem;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev == kept_dev && smem == kept_smem) {
    *blocks = kept_blocks;
    return 0;
  }
  auto kern = mega_kernel<T, QW, QKV>;
  if ((e = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, NTHREADS, smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  kept_dev = dev;
  kept_smem = smem;
  kept_blocks = *blocks = per_sm * sms;
  return 0;
}

// a GEMV phase's K split over `nst` ring stages: the fewest splits whose
// items (tiles x splits) fall within 10% of an even share of the grid's
// blocks, leaving no split empty; the most even one if none does
inline int k_split(int tiles, int nst, int grid) {
  if (tiles == 0) return 1;
  int best = 1;
  double best_ratio = 0.0;
  for (int ks = 1; ks <= nst; ++ks) {
    const int spk = (nst + ks - 1) / ks;
    if ((nst + spk - 1) / spk != ks) continue;   // an empty split
    const int64_t items = static_cast<int64_t>(tiles) * ks;
    const double ratio =
        static_cast<double>((items + grid - 1) / grid * grid) / items;
    if (ratio <= 1.1) return ks;
    if (best_ratio == 0.0 || ratio < best_ratio) {
      best = ks;
      best_ratio = ratio;
    }
  }
  return best;
}

// the launch's work split over `grid` resident blocks: each GEMV phase's
// K splits (into a->ks), and the scratch they and phase 2 need: the K
// splits' partials and tile counters, the attention pieces' partials (at
// most a slot per block and per (row, kv head)) and row counters
template <typename T, bool QW>
void plan(Args* a, int grid, int64_t* part, int64_t* cnt) {
  using G = Geo<T, QW>;
  *part = 0;
  *cnt = static_cast<int64_t>(a->B) * a->NKV;
  for (int pi = 0; pi < 4; ++pi) {
    a->ks[pi] = 1;
    const PhasePlan one = phase_plan<T, QW>(*a, pi);
    a->ks[pi] = k_split(one.tiles, one.nst, grid);
    const PhasePlan p = phase_plan<T, QW>(*a, pi);
    if (p.ks > 1) {
      *part = std::max(*part, static_cast<int64_t>(p.items) * a->B * G::TN);
      *cnt = std::max(*cnt, static_cast<int64_t>(p.tiles));
    }
  }
  *part = std::max(*part, (static_cast<int64_t>(grid) + a->B * a->NKV) *
                              dec_partial_floats(a->NH / a->NKV, a->D));
}

// out: resident blocks (the grid), shared memory bytes, and the partial
// floats and counters the plan over that grid needs
template <typename T, bool QW, bool QKV>
int geometry(Args* a, int64_t* out) {
  const int elem = QW ? 1 : static_cast<int>(sizeof(T));
  if (!shapes_ok(*a, elem)) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, smem = 0;
  const int e = resident<T, QW, QKV>(*a, &blocks, &smem);
  if (e) return e;
  out[0] = blocks;
  out[1] = smem;
  plan<T, QW>(a, blocks, out + 2, out + 3);
  return 0;
}

// one persistent block per resident slot; `part_cap` / `cnt_cap` are the
// scratch the caller allocated (from decode_megakernel_resident)
template <typename T, bool QW, bool QKV>
int launch(const Args& a, int64_t part_cap, int64_t cnt_cap,
           cudaStream_t stream) {
  Args g = a;
  int64_t geo[4];
  const int e = geometry<T, QW, QKV>(&g, geo);
  if (e) return e;
  if (geo[2] > part_cap || geo[3] > cnt_cap)
    return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&g};
  cudaError_t r = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mega_kernel<T, QW, QKV>),
      dim3(static_cast<unsigned>(geo[0])), dim3(NTHREADS), params,
      static_cast<size_t>(geo[1]), stream);
  if (r != cudaSuccess) return static_cast<int>(r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_t(const Args& a, int quant_w, int quant_kv, int64_t part_cap,
               int64_t cnt_cap, cudaStream_t s) {
  if (quant_w)
    return quant_kv ? launch<T, true, true>(a, part_cap, cnt_cap, s)
                    : launch<T, true, false>(a, part_cap, cnt_cap, s);
  return quant_kv ? launch<T, false, true>(a, part_cap, cnt_cap, s)
                  : launch<T, false, false>(a, part_cap, cnt_cap, s);
}

template <typename T>
int geometry_t(Args* a, int quant_w, int quant_kv, int64_t* out) {
  if (quant_w)
    return quant_kv ? geometry<T, true, true>(a, out)
                    : geometry<T, true, false>(a, out);
  return quant_kv ? geometry<T, false, true>(a, out)
                  : geometry<T, false, false>(a, out);
}

// ints: L, B, H, F, NH, NKV, D, BS, W, P, mlp, quant_w, quant_kv, dtype,
// st (rows of an attention tile), then for a launch the partial floats
// and counters allocated
Args dims(const int* ints) {
  Args a = {};
  a.L = ints[0]; a.B = ints[1]; a.H = ints[2]; a.F = ints[3];
  a.NH = ints[4]; a.NKV = ints[5]; a.D = ints[6]; a.BS = ints[7];
  a.W = ints[8]; a.P = ints[9]; a.mlp = ints[10];
  a.st = ints[14];
  return a;
}

}  // namespace

// ptrs: h, out, lens, tables, cos, sin, w_in, w_post, wq, wk, wv, wo, wg,
//   wu, wd, sq, sk, sv, so, sg, su, sd, k_cache, v_cache, k_scale,
//   v_scale, q_ws, k_ws, v_ws, ctx_ws, y_ws, partials (f32), counters
//   (int32, zeroed: the barrier's two words, then the split counters),
//   pout, qout, qsc (null unless out_mode asks for them)
// ints: see dims(), then the partial floats and counters allocated and
//   out_mode; the grid and the K splits are planned here
extern "C" int decode_megakernel_launch(const void* const* ptrs,
                                        const int* ints, float scale,
                                        float eps, void* stream) {
  Args a = dims(ints);
  a.h = ptrs[0];
  a.out = const_cast<void*>(ptrs[1]);
  a.lens = static_cast<const int*>(ptrs[2]);
  a.tables = static_cast<const int*>(ptrs[3]);
  a.cos_t = static_cast<const float*>(ptrs[4]);
  a.sin_t = static_cast<const float*>(ptrs[5]);
  a.w_in = ptrs[6];
  a.w_post = ptrs[7];
  for (int i = 0; i < 7; ++i) {
    a.w[i] = ptrs[8 + i];
    a.s[i] = static_cast<const float*>(ptrs[15 + i]);
  }
  a.kc = const_cast<void*>(ptrs[22]);
  a.vc = const_cast<void*>(ptrs[23]);
  a.ksc = static_cast<float*>(const_cast<void*>(ptrs[24]));
  a.vsc = static_cast<float*>(const_cast<void*>(ptrs[25]));
  a.q_ws = const_cast<void*>(ptrs[26]);
  a.k_ws = const_cast<void*>(ptrs[27]);
  a.v_ws = const_cast<void*>(ptrs[28]);
  a.ctx_ws = const_cast<void*>(ptrs[29]);
  a.y_ws = const_cast<void*>(ptrs[30]);
  a.part = static_cast<float*>(const_cast<void*>(ptrs[31]));
  int* counters = static_cast<int*>(const_cast<void*>(ptrs[32]));
  a.bar = reinterpret_cast<unsigned*>(counters);
  a.cnt = counters + 2;
  a.pout = static_cast<float*>(const_cast<void*>(ptrs[33]));
  a.qout = static_cast<int8_t*>(const_cast<void*>(ptrs[34]));
  a.qsc = static_cast<float*>(const_cast<void*>(ptrs[35]));
  a.out_mode = ints[17];
  a.scale = scale;
  a.eps = eps;
  const int64_t part_cap = ints[15], cnt_cap = ints[16];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ints[13]) {
    case PTT_F32:
      return dispatch_t<float>(a, ints[11], ints[12], part_cap, cnt_cap, s);
    case PTT_BF16:
      return dispatch_t<__nv_bfloat16>(a, ints[11], ints[12], part_cap,
                                       cnt_cap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[4] of a launch with these ints: its grid (resident blocks,
// occupancy x SMs), its dynamic shared memory in bytes, and the partial
// floats and counters its plan needs (the wrapper sizes its scratch from
// the last two; the card tests hold the second against smem_bytes)
extern "C" int decode_megakernel_resident(const int* ints, int64_t* out) {
  Args a = dims(ints);
  switch (ints[13]) {
    case PTT_F32:
      return geometry_t<float>(&a, ints[11], ints[12], out);
    case PTT_BF16:
      return geometry_t<__nv_bfloat16>(&a, ints[11], ints[12], out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
