// Flash-attention forward: O = softmax(scale * Q K^T [causal mask]) V and the
// row log-sum-exp, in the [B, S, H, D] layout, with grouped-query heads.
//
// Replaces the Pallas kernel paddle_tpu/kernels/flash_attention.py
// `_fwd_kernel` (launched by `_fwd_pallas`). On the TPU the JAX package
// sends GQA to jax's bundled splash kernel; this kernel maps each query
// head to its KV head itself (h // (Hq / Hkv)), so nothing is repeated.
//
// Bound on the H100: operations. 4*B*Hq*Sq*Sk*D flops (about half of that
// when causal) against q/k/v/o bytes gives an intensity of O(S) flop/byte,
// far above the ~295 flop/byte ridge of the bf16 tensor cores.
//
// Design (simple first, not yet the fast Hopper shape): one block of four
// warps per (64-row query tile, batch*head). The Q tile stays in shared
// memory; K/V tiles of 64 keys stream through shared memory. Each warp owns
// 16 query rows end to end: it computes its 16x64 score strip with bf16
// WMMA (mma.sync) tensor-core tiles into f32 shared memory, runs the online
// softmax in f32 over its rows (two columns per lane, warp-shuffle max and
// sum), casts P to bf16 like the JAX kernel (p.astype(v.dtype)), rescales
// its rows of the f32 output accumulator and adds P V with WMMA again.
// Because a warp only touches its own rows, the phases need __syncwarp and
// only the K/V loads need block barriers. Causal blocks stop at the
// diagonal (q_offset = Sk - Sq aligns it to the end of the keys, as
// flash_attention.py:126 does); the ragged Sq / Sk edges are masked here,
// so any length works. wgmma + TMA pipelining is later work.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // keys per streamed tile
constexpr int NTHREADS = 128;
constexpr float NEG = -1e30f;  // the JAX kernels' finite mask value

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;   // bf16 Q/K/V rows (padding: banks)
  static constexpr int LDS = BK + 4;  // f32 score rows
  static constexpr int LDP = BK + 8;  // bf16 probability rows
  static constexpr int LDO = D + 4;   // f32 output-accumulator rows
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(BQ * LDH * sizeof(bf16));
  static constexpr size_t v = k + align128(BK * LDH * sizeof(bf16));
  static constexpr size_t s = v + align128(BK * LDH * sizeof(bf16));
  static constexpr size_t p = s + align128(BQ * LDS * sizeof(float));
  static constexpr size_t o = p + align128(BQ * LDP * sizeof(bf16));
  static constexpr size_t bytes = o + align128(BQ * LDO * sizeof(float));
};

// rows [row0, row0 + 64) of a [B, S, H, D] tensor at (b, h) -> smem, zero
// past `S` (16-byte vector copies; D % 8 == 0)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int h, int row0, int S, int H) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < BQ * VPR; idx += NTHREADS) {
    const int r = idx / VPR, c = idx - r * VPR;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<int64_t>(b) * S + s) * H + h) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDH + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                     float scale, int causal) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;  // this warp's first row in the tile
  const int q_offset = Sk - Sq;

  load_tile<D>(Qs, q, b, h, q0, Sq, Hq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) Os[i] = 0.f;

  float m_r[16], l_r[16], c_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = NEG;
    l_r[r] = 0.f;
  }
  int kv_end = Sk;
  if (causal) {
    const int last = min(q0 + BQ, Sq) - 1 + q_offset;
    kv_end = min(Sk, last + 1);
  }
  const int n_tiles = (kv_end + BK - 1) / BK;
  __syncthreads();

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt) __syncthreads();  // every warp is done with the last K/V tile
    load_tile<D>(Ks, k, b, hk, kt * BK, Sk, Hkv);
    load_tile<D>(Vs, v, b, hk, kt * BK, Sk, Hkv);
    __syncthreads();

    // S strip [16, BK] = Q[rows] K^T on the tensor cores
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + row0 * L::LDH + kk, L::LDH);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + (j * 16) * L::LDH + kk, L::LDH);
        wmma::mma_sync(sacc[j], a, kb, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wmma::store_matrix_sync(Ss + row0 * L::LDS + j * 16, sacc[j], L::LDS,
                              wmma::mem_row_major);
    __syncwarp();

    // online softmax over this warp's 16 rows, two key columns per lane
    const int k0 = kt * BK + lane, k1 = k0 + 32;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = row0 + r;
      const int qpos = q0 + i + q_offset;
      float s0 = Ss[i * L::LDS + lane] * scale;
      float s1 = Ss[i * L::LDS + lane + 32] * scale;
      if (k0 >= Sk || (causal && k0 > qpos)) s0 = NEG;
      if (k1 >= Sk || (causal && k1 > qpos)) s1 = NEG;
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(s0, s1)));
      const float corr = expf(m_r[r] - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      l_r[r] = l_r[r] * corr + warp_sum(p0 + p1);
      m_r[r] = m_new;
      c_r[r] = corr;
      Ps[i * L::LDP + lane] = __float2bfloat16(p0);
      Ps[i * L::LDP + lane + 32] = __float2bfloat16(p1);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
      for (int c = lane; c < D; c += 32) Os[(row0 + r) * L::LDO + c] *= c_r[r];
    __syncwarp();

    // O[rows] += P V on the tensor cores
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      float* optr = Os + row0 * L::LDO + dj * 16;
      wmma::load_matrix_sync(oacc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Ps + row0 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(vb, Vs + kk * L::LDH + dj * 16, L::LDH);
        wmma::mma_sync(oacc, pa, vb, oacc);
      }
      wmma::store_matrix_sync(optr, oacc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = q0 + row0 + r;
    if (s >= Sq) continue;
    bf16* orow = o + ((static_cast<int64_t>(b) * Sq + s) * Hq + h) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(Os[(row0 + r) * L::LDO + c] / l_r[r]);
    if (lane == 0)
      lse[static_cast<int64_t>(bh) * Sq + s] = m_r[r] + logf(l_r[r]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t bytes = Layout<D>::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Sk, Hq,
      Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int Sq, int Sk, int Hq,
                                          int Hkv, int D, float scale,
                                          int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, l, B, Sq, Sk, Hq, Hkv, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
