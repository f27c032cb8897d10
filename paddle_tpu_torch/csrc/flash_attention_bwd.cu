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
// own choice and not work the function needs.
//
// Design (simple first, the forward kernel's shape): blocks of four warps,
// each warp owning 16 rows of a 64-row tile end to end. Products run on the
// tensor cores with bf16 WMMA tiles (mma.sync) and f32 accumulators; score
// strips go through f32 shared memory for the elementwise phase (two
// columns per lane). Warps touch only their own rows of the score strips,
// so only the tile loads need block barriers.
// - dq kernel: one block per (64 query rows, batch * q head). Q and dO stay
//   in shared memory, K / V tiles of 64 keys stream through it; dq's
//   accumulators stay in registers.
// - dkv kernel: one block per (64 keys, batch * kv head). K and V stay in
//   shared memory; for every q head of the group, the Q / dO tiles that
//   see these keys stream through it; dk and dv accumulate in registers.
// Both need about 111 KB of shared memory at D = 128 (two blocks per SM),
// past the 48 KB default, so each launch opts in first; a refused launch
// returns its error. wgmma + TMA pipelining is later work.
#include <mma.h>

#include "common.cuh"

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
// dkv: grid (ceil(Sk / 64), B * Hkv); each block walks the Hq / Hkv query
// heads of its kv head and, for each, the q tiles that see its keys
// ---------------------------------------------------------------------------

template <int D>
struct DkvLayout {
  using T = Tiles<D>;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + T::H;
  static constexpr size_t q = v + T::H;
  static constexpr size_t dO = q + T::H;
  static constexpr size_t s = dO + T::H;    // S^T, then p^T in place
  static constexpr size_t dp = s + T::S;    // dP^T
  static constexpr size_t p = dp + T::S;    // bf16 p^T, then bf16 dS^T
  static constexpr size_t lse = p + T::P;
  static constexpr size_t delta = lse + T::V64;
  static constexpr size_t bytes = delta + T::V64;
  // the finished dk and dv rows are staged from offset 0
  static_assert(BT * T::LDO * sizeof(float) <= bytes, "dkv stage");
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dO,
                         const float* __restrict__ lse,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Sk, int Hq, int Hkv, float scale, int causal) {
  using T = Tiles<D>;
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::dO);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* dPs = reinterpret_cast<float*>(smem + L::dp);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const int k0 = blockIdx.x * BT;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv - b * Hkv;
  const int rep = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;    // this warp's keys in the tile
  const int q_offset = Sk - Sq;

  load_tile<D>(Ks, k, b, hk, k0, Sk, Hkv);
  load_tile<D>(Vs, v, b, hk, k0, Sk, Hkv);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[D / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dv_acc[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) {
    wmma::fill_fragment(dk_acc[dj], 0.f);
    wmma::fill_fragment(dv_acc[dj], 0.f);
  }

  // causal: the first q tile with a row that sees key k0 (row i sees key j
  // when j <= i + q_offset); earlier tiles see none of these keys
  int qt0 = 0;
  if (causal && k0 - q_offset > 0) qt0 = (k0 - q_offset) / BT;
  const int n_qt = (Sq + BT - 1) / BT;

  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // every warp is done with the last Q/dO tile
      load_tile<D>(Qs, q, b, h, q0, Sq, Hq);
      load_tile<D>(dOs, dO, b, h, q0, Sq, Hq);
      __syncthreads();
      row_stats<D>(lse_s, delta_s, dOs, o, lse, b, h, q0, Sq, Hq, row0);
      __syncthreads();  // every warp reads all 64 rows' statistics

      strip_abt<D>(Ss + row0 * T::LDS, Ks + row0 * T::LDH, Qs);   // S^T
      strip_abt<D>(dPs + row0 * T::LDS, Vs + row0 * T::LDH, dOs);  // dP^T
      __syncwarp();

      // p^T over this warp's keys, two query columns per lane: bf16 into
      // Ps for dV, f32 back into Ss for dS
      for (int r = 0; r < 16; ++r) {
        const int key = k0 + row0 + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const int qi = q0 + c;
          float s = Ss[(row0 + r) * T::LDS + c] * scale;
          if (key >= Sk || (causal && key > qi + q_offset)) s = NEG;
          const float p = qi < Sq ? expf(s - lse_s[c]) : 0.f;
          Ss[(row0 + r) * T::LDS + c] = p;
          Ps[(row0 + r) * T::LDP + c] = __float2bfloat16(p);
        }
      }
      __syncwarp();
      accumulate_pb<D>(dv_acc, Ps + row0 * T::LDP, dOs);   // dV += P^T dO
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const int e = (row0 + r) * T::LDS + c;
          const float ds = Ss[e] * (dPs[e] - delta_s[c]) * scale;
          Ps[(row0 + r) * T::LDP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();
      accumulate_pb<D>(dk_acc, Ps + row0 * T::LDP, Qs);    // dK += dS^T Q
    }
  }
  __syncthreads();  // every region becomes the stage
  float* stage = reinterpret_cast<float*>(smem);
  store_rows<D>(dk_acc, stage, dk, b, hk, k0, Sk, Hkv);
  __syncwarp();     // each warp restages only its own rows
  store_rows<D>(dv_acc, stage, dv, b, hk, k0, Sk, Hkv);
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
int launch_dkv(const void* q, const void* k, const void* v, const void* o,
               const void* dO, const float* lse, void* dk, void* dv, int B,
               int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t bytes = DkvLayout<D>::bytes;
  static bool attr_set = false;
  if (int e = opt_in(flash_bwd_dkv_kernel<D>, bytes, &attr_set)) return e;
  dim3 grid((Sk + BT - 1) / BT, B * Hkv);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dO), lse, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv, scale, causal);
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

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dk, void* dv, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (B == 0 || Sk == 0) return static_cast<int>(cudaGetLastError());
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, o, dO, l, dk, dv, B, Sq, Sk, Hq, Hkv,
                            scale, causal, s);
    case 128:
      return launch_dkv<128>(q, k, v, o, dO, l, dk, dv, B, Sq, Sk, Hq, Hkv,
                             scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
