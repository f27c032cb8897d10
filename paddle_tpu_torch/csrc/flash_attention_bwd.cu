// Flash-attention backward (FA2): dq, and dk / dv summed over each kv head's
// group of query heads, in the [B, S, H, D] layout, from the forward's
// output O and row log-sum-exp lse [B*Hq, Sq] (f32).
//
// Replaces the Pallas kernels paddle_tpu/kernels/flash_attention.py
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (both launched by `_bwd_pallas`).
// Per (query row i, key j), as the TPU kernels compute it:
//   s = scale * q_i . k_j (f32; masked to -1e30 above the causal diagonal,
//       which sits at q_offset = Sk - Sq), p = exp(s - lse_i),
//   dp = dO_i . v_j, delta_i = rowsum(dO_i * O_i) (O the forward's rounded
//   output), dS = p * (dp - delta_i) * scale, all in f32;
//   dq_i += bf16(dS) k_j, dv_j += bf16(p) dO_i, dk_j += bf16(dS) q_i,
//   summed in f32 and rounded once at the end.
// The TPU pair writes per-q-head dk / dv in bf16 and the caller sums each
// GQA group in bf16 (flash_attention.py:436-440); here the dkv block walks
// every q head of its group itself and keeps the sum in f32, so there are
// no float atomics and the result is deterministic.
//
// Bound on the H100: operations. The five products (recomputed S, dP, dV,
// dQ, dK) are 10*B*Hq*Sq*Sk*D flops (about half when causal) against
// O(S*D) bytes per row; both kernels recompute S and dP, which is their
// own choice and not work the function needs. The delta pre-pass is bound
// by bytes (O and dO read once).
//
// - dq kernel (the first design, kept): blocks of four warps, each warp
//   owning 16 rows of a 64-row q tile end to end; products on the tensor
//   cores with bf16 WMMA tiles and f32 accumulators; score strips through
//   f32 shared memory for the elementwise phase (two columns per lane);
//   one block per (64 query rows, batch * q head); Q and dO stay in shared
//   memory, K / V tiles of 64 keys stream through it, dq's accumulators
//   stay in registers. About 111 KB of shared memory at D = 128 (two
//   blocks per SM), opted in past the 48 KB default.
// - delta pre-pass: delta = rowsum(dO * O) in f32 once per query row, one
//   warp per row, into [B * Hq, Sq] beside lse (the JAX kernels recompute
//   it for every (key tile, q tile) pair).
// - dkv kernel (redesigned): one block of four warps per (64 keys,
//   batch * kv head), each warp owning 16 keys; K and V stay in shared
//   memory. For every q head of the group and every q tile of 64 rows
//   that sees these keys, Q, dO, lse and delta of the tile arrive by
//   cp.async into one of two stage buffers while the previous tile
//   computes (one block barrier per tile). Products are raw m16n8k16
//   mma.sync with fragments of known layout, fed by ldmatrix (.trans for
//   the [q, D] operands of the second products): S^T = K_w Q^T and
//   dP^T = V_w dO^T accumulate in registers over 32 query rows at a time;
//   the mask, p = exp(s * scale - lse) and dS = p (dP - delta) scale run on
//   the accumulators, which are packed to bf16 straight into the A
//   fragments of dV += P^T dO and dK += dS^T Q (no score goes through
//   shared memory). The dk / dv sums stay in registers for the block's
//   whole walk and are rounded once. Key tiles that see the most q rows
//   (causal: the first) are dispatched first: grid (B * Hkv, Sk / 64).
//   103 KB of shared memory (K, V and two stages) and 242 registers at
//   D = 128 (170 at D = 64), no spills: two blocks, eight warps, per SM.
//   q tiles of 64 rows measured faster than tiles of 32 (PERF.md).
// A refused launch returns its error. wgmma + TMA is later work.
#include <mma.h>

#include "common.cuh"
#include "fragments.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BT = 64;          // rows of a q or k tile (16 per warp)
constexpr int NTHREADS = 128;
constexpr float NEG = -1e30f;   // the JAX kernels' finite mask value

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D>
struct Tiles {
  static constexpr int LDH = D + 8;   // bf16 q/k/v/dO rows (padding: banks)
  static constexpr int LDS = BT + 4;  // f32 score rows
  static constexpr int LDP = BT + 8;  // bf16 p / dS rows
  static constexpr int LDO = D + 4;   // f32 rows of the finished sums
  static constexpr size_t H = align128(BT * LDH * sizeof(bf16));
  static constexpr size_t S = align128(BT * LDS * sizeof(float));
  static constexpr size_t P = align128(BT * LDP * sizeof(bf16));
  static constexpr size_t V64 = align128(BT * sizeof(float));
};

// rows [row0, row0 + 64) of a [B, S, H, D] tensor at (b, h) -> smem, zero
// past `S` (16-byte vector copies; D % 8 == 0)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int h, int row0, int S, int H) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < BT * VPR; idx += NTHREADS) {
    const int r = idx / VPR, c = idx - r * VPR;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<int64_t>(b) * S + s) * H + h) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Tiles<D>::LDH + c * 8) = val;
  }
}

// lse and delta = rowsum(dO * O) of query rows [q0, q0 + 64) of head (b, h)
// into smem (0 past Sq); dO from its smem tile, O from global memory.
// Each warp fills its own 16 rows.
template <int D>
__device__ __forceinline__ void row_stats(float* lse_s, float* delta_s,
                                          const bf16* dOs, const bf16* o,
                                          const float* lse, int b, int h,
                                          int q0, int Sq, int Hq, int row0) {
  const int lane = threadIdx.x & 31;
  const int bh = b * Hq + h;
  for (int r = 0; r < 16; ++r) {
    const int i = row0 + r, s = q0 + i;
    float acc = 0.f;
    if (s < Sq) {
      const bf16* orow = o + ((static_cast<int64_t>(b) * Sq + s) * Hq + h) * D;
      for (int c = lane; c < D; c += 32)
        acc += __bfloat162float(dOs[i * Tiles<D>::LDH + c]) *
               __bfloat162float(orow[c]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_s[i] = acc;
      lse_s[i] = s < Sq ? lse[static_cast<int64_t>(bh) * Sq + s] : 0.f;
    }
  }
}

// out strip [16, 64] (f32, ldm LDS) = A[16 rows of `a`] B^T over D, where
// B's rows are the 64 rows of `b` (both bf16 tiles with ldm LDH)
template <int D>
__device__ __forceinline__ void strip_abt(float* out, const bf16* a,
                                          const bf16* b) {
  using T = Tiles<D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BT / 16];
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, T::LDH);
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + (j * 16) * T::LDH + kk, T::LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BT / 16; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], T::LDS,
                            wmma::mem_row_major);
}

// acc[dj] (the warp's [16, D] sum) += P[16, 64] (bf16, ldm LDP) @ B[64, D]
// (bf16 tile, ldm LDH)
template <int D>
__device__ __forceinline__ void accumulate_pb(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
    const bf16* p, const bf16* b) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < BT; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, p + kk, T::LDP);
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * T::LDH + dj * 16, T::LDH);
      wmma::mma_sync(acc[dj], fa, fb, acc[dj]);
    }
  }
}

// the warp's [16, D] f32 sums -> rows [row0 + 16w ...) of a [B, S, H, D]
// bf16 tensor at (b, h), through `stage` (f32, ldm LDO), skipping rows
// past S
template <int D>
__device__ __forceinline__ void store_rows(
    const wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
    float* stage, bf16* dst, int b, int h, int tile0, int S, int H) {
  using T = Tiles<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = stage + warp * 16 * T::LDO;
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj)
    wmma::store_matrix_sync(mine + dj * 16, acc[dj], T::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int s = tile0 + warp * 16 + r;
    if (s >= S) continue;
    bf16* row = dst + ((static_cast<int64_t>(b) * S + s) * H + h) * D;
    for (int c = lane; c < D; c += 32)
      row[c] = __float2bfloat16(mine[r * T::LDO + c]);
  }
}

// ---------------------------------------------------------------------------
// dq: grid (ceil(Sq / 64), B * Hq)
// ---------------------------------------------------------------------------

template <int D>
struct DqLayout {
  using T = Tiles<D>;
  static constexpr size_t q = 0;
  static constexpr size_t dO = q + T::H;
  static constexpr size_t k = dO + T::H;
  static constexpr size_t v = k + T::H;
  static constexpr size_t s = v + T::H;
  static constexpr size_t dp = s + T::S;
  static constexpr size_t ds = dp + T::S;
  static constexpr size_t lse = ds + T::P;
  static constexpr size_t delta = lse + T::V64;
  static constexpr size_t bytes = delta + T::V64;
  // the finished dq rows are staged over the k..ds regions
  static_assert(BT * T::LDO * sizeof(float) <= lse - k, "dq stage");
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dO,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        int Sq, int Sk, int Hq, int Hkv, float scale,
                        int causal) {
  using T = Tiles<D>;
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dO);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* dPs = reinterpret_cast<float*>(smem + L::dp);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const int q0 = blockIdx.x * BT;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int q_offset = Sk - Sq;

  load_tile<D>(Qs, q, b, h, q0, Sq, Hq);
  load_tile<D>(dOs, dO, b, h, q0, Sq, Hq);
  __syncthreads();
  row_stats<D>(lse_s, delta_s, dOs, o, lse, b, h, q0, Sq, Hq, row0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) wmma::fill_fragment(acc[dj], 0.f);

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(q0 + BT, Sq) - 1 + q_offset + 1);
  const int n_tiles = (kv_end + BT - 1) / BT;

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // every warp is done with the last K/V tile
    load_tile<D>(Ks, k, b, hk, kt * BT, Sk, Hkv);
    load_tile<D>(Vs, v, b, hk, kt * BT, Sk, Hkv);
    __syncthreads();

    strip_abt<D>(Ss + row0 * T::LDS, Qs + row0 * T::LDH, Ks);
    strip_abt<D>(dPs + row0 * T::LDS, dOs + row0 * T::LDH, Vs);
    __syncwarp();

    // dS = p (dp - delta) scale over this warp's rows, two keys per lane
    for (int r = 0; r < 16; ++r) {
      const int i = row0 + r;
      const int qpos = q0 + i + q_offset;
      const float li = lse_s[i], di = delta_s[i];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const int key = kt * BT + c;
        float s = Ss[i * T::LDS + c] * scale;
        if (key >= Sk || (causal && key > qpos)) s = NEG;
        const float p = expf(s - li);
        const float ds = p * (dPs[i * T::LDS + c] - di) * scale;
        dSs[i * T::LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    accumulate_pb<D>(acc, dSs + row0 * T::LDP, Ks);
  }
  __syncthreads();  // the K/V..dS regions become the dq stage
  store_rows<D>(acc, reinterpret_cast<float*>(smem + L::k), dq, b, h, q0, Sq,
                Hq);
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in f32, once per query row: [B * Hq, Sq], beside
// lse. One warp per row of the [B, Sq, Hq, D] tensors.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_delta_kernel(const bf16* __restrict__ o,
                           const bf16* __restrict__ dO,
                           float* __restrict__ delta, int64_t rows, int Sq,
                           int Hq, int D) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * NTHREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const __nv_bfloat162* orow =
      reinterpret_cast<const __nv_bfloat162*>(o + r * D);
  const __nv_bfloat162* drow =
      reinterpret_cast<const __nv_bfloat162*>(dO + r * D);
  float acc = 0.f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 a = __bfloat1622float2(orow[c]);
    const float2 d = __bfloat1622float2(drow[c]);
    acc += d.x * a.x + d.y * a.y;
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = static_cast<int>(r % Hq);
    const int64_t bs = r / Hq;
    const int s = static_cast<int>(bs % Sq);
    const int64_t b = bs / Sq;
    delta[(b * Hq + h) * Sq + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// dkv: grid (B * Hkv, ceil(Sk / 64)), the key tiles that see the most query
// rows (causal: the first) dispatched first; each block walks the Hq / Hkv
// query heads of its kv head and, for each, the q tiles that see its keys.
// Raw m16n8k16 mma.sync with fragments of known layout (fragments.cuh):
// every score stays in registers.
// ---------------------------------------------------------------------------

// keys of a dkv block (16 per warp) and query rows of a stage; each stage
// holds Q, dO, lse and delta of one q tile, in two buffers
constexpr int DKV_QROWS = 64;
constexpr int DKV_SUB = 32;     // query rows per register pass

template <int D>
struct DkvLayout {
  static constexpr int LDH = D + 8;   // bf16 rows (padding: ldmatrix banks)
  static constexpr size_t KV = size_t(BT) * LDH * sizeof(bf16);
  static constexpr size_t QT = size_t(DKV_QROWS) * LDH * sizeof(bf16);
  static constexpr size_t k = 0;
  static constexpr size_t v = KV;
  static constexpr size_t stage0 = 2 * KV;
  static constexpr size_t q = 0, dO = QT, lse = 2 * QT,
                          delta = 2 * QT + DKV_QROWS * sizeof(float);
  static constexpr size_t STAGE = 2 * QT + 2 * DKV_QROWS * sizeof(float);
  static constexpr size_t bytes = stage0 + 2 * STAGE;
};

// one [rows, D] tile of a [B, S, H, D] tensor at (b, h) into smem rows of
// ldm LDH, rows past S zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void start_rows_copy(bf16* dst, const bf16* src,
                                                int b, int h, int row0,
                                                int S, int H) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NTHREADS) {
    const int r = idx / VPR, c = idx - r * VPR;
    const int s = row0 + r;
    const bool ok = s < S;
    const bf16* g =
        ok ? src + ((static_cast<int64_t>(b) * S + s) * H + h) * D + c * 8
           : src;
    cp_async16(dst + r * DkvLayout<D>::LDH + c * 8, g, ok);
  }
}

// stage: Q, dO, lse and delta of query rows [q0, q0 + 64) of head (b, h)
template <int D>
__device__ __forceinline__ void start_stage_copy(unsigned char* st,
                                                 const bf16* q, const bf16* dO,
                                                 const float* lse,
                                                 const float* delta, int b,
                                                 int h, int q0, int Sq,
                                                 int Hq) {
  using L = DkvLayout<D>;
  start_rows_copy<D, DKV_QROWS>(reinterpret_cast<bf16*>(st + L::q), q, b, h,
                                q0, Sq, Hq);
  start_rows_copy<D, DKV_QROWS>(reinterpret_cast<bf16*>(st + L::dO), dO, b,
                                h, q0, Sq, Hq);
  const int t = threadIdx.x;
  if (t < 2 * DKV_QROWS) {
    const int i = t % DKV_QROWS;
    const bool ok = q0 + i < Sq;
    const float* src = (t < DKV_QROWS ? lse : delta) +
                       (static_cast<int64_t>(b) * Hq + h) * Sq +
                       (ok ? q0 + i : 0);
    float* dst = reinterpret_cast<float*>(
                     st + (t < DKV_QROWS ? L::lse : L::delta)) + i;
    cp_async4(dst, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Sk, int Hq, int Hkv, float scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int LDH = L::LDH;
  constexpr int NT = D / 8;                 // n-tiles of a [16, D] sum
  constexpr int ST = DKV_SUB / 8;           // n-tiles of a [16, 32] strip
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int b = bkv / Hkv, hk = bkv - b * Hkv;
  const int rep = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_offset = Sk - Sq;

  // causal: the first q tile with a row that sees key k0 (row i sees key j
  // when j <= i + q_offset); earlier tiles see none of these keys
  int qt0 = 0;
  if (causal && k0 - q_offset > 0) qt0 = (k0 - q_offset) / DKV_QROWS;
  const int n_qt = (Sq + DKV_QROWS - 1) / DKV_QROWS;
  const int per_head = max(n_qt - qt0, 0);
  const int n_it = rep * per_head;

  start_rows_copy<D, BT>(Ks, k, b, hk, k0, Sk, Hkv);
  start_rows_copy<D, BT>(Vs, v, b, hk, k0, Sk, Hkv);
  if (n_it > 0)
    start_stage_copy<D>(smem + L::stage0, q, dO, lse, delta, b, hk * rep,
                        qt0 * DKV_QROWS, Sq, Hq);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // this thread's two key rows of the warp's 16 and its ldmatrix offsets
  const int key_r0 = k0 + warp * 16 + (lane >> 2);
  const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int bn_row = (lane & 7) + ((lane >> 4) << 3);
  const int bn_col = ((lane >> 3) & 1) * 8;
  const int bt_row = lane & 15, bt_col = (lane >> 4) * 8;

  for (int it = 0; it < n_it; ++it) {
    const int g = it / per_head;
    const int q0 = (qt0 + it - g * per_head) * DKV_QROWS;
    cp_async_wait<0>();
    // stage `it` is visible to every thread, and every warp is done with
    // stage it - 1, whose buffer the next copy refills
    __syncthreads();
    if (it + 1 < n_it) {
      const int g1 = (it + 1) / per_head;
      start_stage_copy<D>(smem + L::stage0 + ((it + 1) & 1) * L::STAGE, q,
                          dO, lse, delta, b, hk * rep + g1,
                          (qt0 + it + 1 - g1 * per_head) * DKV_QROWS, Sq,
                          Hq);
    }
    cp_async_commit();
    const unsigned char* st = smem + L::stage0 + (it & 1) * L::STAGE;
    const bf16* Qs = reinterpret_cast<const bf16*>(st + L::q);
    const bf16* dOs = reinterpret_cast<const bf16*>(st + L::dO);
    const float* lse_s = reinterpret_cast<const float*>(st + L::lse);
    const float* delta_s = reinterpret_cast<const float*>(st + L::delta);

#pragma unroll 1
    for (int qs = 0; qs < DKV_QROWS; qs += DKV_SUB) {
      // S^T = K_w Q^T and dP^T = V_w dO^T over this pass's 32 query rows
      float sacc[ST][4], pacc[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, Ks + a_row * LDH + kk + a_col);
        ldsm_x4(av, Vs + a_row * LDH + kk + a_col);
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          uint32_t bq[4], bd[4];
          const int row = qs + np * 16 + bn_row;
          ldsm_x4(bq, Qs + row * LDH + kk + bn_col);
          ldsm_x4(bd, dOs + row * LDH + kk + bn_col);
          mma16816(sacc[2 * np], ak, bq[0], bq[1]);
          mma16816(sacc[2 * np + 1], ak, bq[2], bq[3]);
          mma16816(pacc[2 * np], av, bd[0], bd[1]);
          mma16816(pacc[2 * np + 1], av, bd[2], bd[3]);
        }
      }
      // p and dS on the accumulators: element e of n-tile j is key row
      // key_r0 (+8 for e >= 2), query column qs + 8j + 2(lane % 4) (+1
      // for odd e); packed to bf16 as A fragments of the next products
      uint32_t ap[ST / 2][4], ads[ST / 2][4];
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_r0 + (e >> 1) * 8;
          const int col = qs + 8 * j + 2 * (lane & 3) + (e & 1);
          const int qi = q0 + col;
          float sv = sacc[j][e] * scale;
          if (key >= Sk || (causal && key > qi + q_offset)) sv = NEG;
          const float p = qi < Sq ? expf(sv - lse_s[col]) : 0.f;
          pv[e] = p;
          dsv[e] = p * (pacc[j][e] - delta_s[col]) * scale;
        }
        ap[j >> 1][(j & 1) * 2] = pack2(pv[0], pv[1]);
        ap[j >> 1][(j & 1) * 2 + 1] = pack2(pv[2], pv[3]);
        ads[j >> 1][(j & 1) * 2] = pack2(dsv[0], dsv[1]);
        ads[j >> 1][(j & 1) * 2 + 1] = pack2(dsv[2], dsv[3]);
      }
      // dV += P^T dO and dK += dS^T Q over the pass's rows
#pragma unroll
      for (int t = 0; t < ST / 2; ++t) {
        const int row = qs + t * 16 + bt_row;
#pragma unroll
        for (int dn = 0; dn < NT / 2; ++dn) {
          uint32_t bd[4], bq[4];
          ldsm_x4_trans(bd, dOs + row * LDH + dn * 16 + bt_col);
          ldsm_x4_trans(bq, Qs + row * LDH + dn * 16 + bt_col);
          mma16816(dv_acc[2 * dn], ap[t], bd[0], bd[1]);
          mma16816(dv_acc[2 * dn + 1], ap[t], bd[2], bd[3]);
          mma16816(dk_acc[2 * dn], ads[t], bq[0], bq[1]);
          mma16816(dk_acc[2 * dn + 1], ads[t], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the f32 sums, rounded once, straight from the accumulators
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_r0 + half * 8;
    if (key >= Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Sk + key) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dk + off + col) =
          pack2(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + col) =
          pack2(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
    }
  }
}

template <typename K>
int opt_in(K kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dO, const float* lse, void* dq, int B, int Sq,
              int Sk, int Hq, int Hkv, float scale, int causal,
              cudaStream_t stream) {
  constexpr size_t bytes = DqLayout<D>::bytes;
  static bool attr_set = false;
  if (int e = opt_in(flash_bwd_dq_kernel<D>, bytes, &attr_set)) return e;
  dim3 grid((Sq + BT - 1) / BT, B * Hq);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dO), lse, static_cast<bf16*>(dq), Sq, Sk, Hq,
      Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int Sq, int Sk, int Hq, int Hkv, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t bytes = DkvLayout<D>::bytes;
  static bool attr_set = false;
  if (int e = opt_in(flash_bwd_dkv_kernel<D>, bytes, &attr_set)) return e;
  dim3 grid(B * Hkv, (Sk + BT - 1) / BT);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, int B, int Sq, int Sk, int Hq,
    int Hkv, int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, o, dO, l, dq, B, Sq, Sk, Hq, Hkv, scale,
                           causal, s);
    case 128:
      return launch_dq<128>(q, k, v, o, dO, l, dq, B, Sq, Sk, Hq, Hkv, scale,
                            causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// delta [B * Hq, Sq] f32 = rowsum(dO * O) of the forward's rounded output
extern "C" int flash_attention_bwd_delta_launch(const void* o,
                                                const void* dO, void* delta,
                                                int B, int Sq, int Hq, int D,
                                                void* stream) {
  const int64_t rows = static_cast<int64_t>(B) * Sq * Hq;
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  if (D % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + NTHREADS / 32 - 1) / (NTHREADS / 32);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta_kernel<<<static_cast<unsigned>(blocks), NTHREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO),
      static_cast<float*>(delta), rows, Sq, Hq, D);
  return static_cast<int>(cudaGetLastError());
}

// delta from flash_attention_bwd_delta_launch
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (B == 0 || Sk == 0) return static_cast<int>(cudaGetLastError());
  if ((Sk + BT - 1) / BT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dO, l, dl, dk, dv, B, Sq, Sk, Hq, Hkv,
                            scale, causal, s);
    case 128:
      return launch_dkv<128>(q, k, v, dO, l, dl, dk, dv, B, Sq, Sk, Hq, Hkv,
                             scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
