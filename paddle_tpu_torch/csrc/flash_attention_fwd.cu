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
// Design (FA2 on mma.sync; the tile body is csrc/attention_tile.cuh, shared
// with paged prefill attention): one block of FWD_WARPS warps per (q tile of
// 16 rows a warp, batch * q head). Each warp owns its 16 rows end to end:
// their Q fragments, the running max and sums and the [16, D] f32 output
// accumulator stay in registers for the block's whole walk; scores stay in
// C fragments and reach O += P V as A fragments, so nothing but the K / V
// tiles goes through shared memory. K / V tiles of 64 keys arrive by
// cp.async into a ring of two stages, the next tile's copy in flight while
// the current one computes, one block barrier a tile. Numerics are the JAX
// kernel's: f32 scores, the finite -1e30 mask, P rounded to bf16 before
// P V (p.astype(v.dtype)), f32 sums, lse = m + log(l) in f32 [B*Hq, Sq]
// (what the backward reads). Causal (q_offset = Sk - Sq aligns the diagonal
// to the end of the keys, as flash_attention.py:126 does): a block walks
// the key tiles up to its diagonal, a warp skips the tiles past its own
// rows' reach, and only tiles that cross the diagonal or Sk are masked; q
// tiles are dispatched longest first (grid (B * Hq, q tiles), the last q
// tile first), so the short ones fill the tail. Ragged Sq / Sk edges are
// zero-filled and masked, so any length works. FWD_WARPS = 4 (64-row q
// tiles, 85 KB of shared memory at D = 128, two blocks per SM) measured
// against 8 (128-row tiles): PERF.md. wgmma + TMA is later work.
#include "attention_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int FWD_WARPS = 4;

template <int D, int NW>
struct FwdLayout {
  static constexpr int LDH = D + 8;
  static constexpr int BQ = 16 * NW;
  static constexpr size_t TILE = size_t(ATT_BK) * LDH * sizeof(bf16);
  static constexpr size_t stage0 = size_t(BQ) * LDH * sizeof(bf16);  // Q first
  static constexpr size_t bytes = stage0 + 4 * TILE;  // two stages of K, V
};

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32, 8 / NW)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                     float scale, int causal) {
  using L = FwdLayout<D, NW>;
  constexpr int NT = NW * 32, LDH = L::LDH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  auto stage = [&](int i) {
    return reinterpret_cast<bf16*>(smem + L::stage0 + (i & 1) * 2 * L::TILE);
  };

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BQ;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_offset = Sk - Sq;
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(q0 + L::BQ, Sq) + q_offset);
  const int n_tiles = (kv_end + ATT_BK - 1) / ATT_BK;
  // the warp's first row, and the last key any of its rows sees
  const int w0 = q0 + warp * 16;
  const int reach =
      causal ? min(Sk, min(w0 + 16, Sq) + q_offset) - 1 : Sk - 1;
  const int row = w0 + g;  // this lane's rows: row, row + 8

  copy_rows<D, L::BQ, NT>(Qs, q, b, h, q0, Sq, Hq);
  if (n_tiles > 0) {
    copy_rows<D, ATT_BK, NT>(stage(0), k, b, hk, 0, Sk, Hkv);
    copy_rows<D, ATT_BK, NT>(stage(0) + ATT_BK * LDH, v, b, hk, 0, Sk, Hkv);
  }
  cp_async_commit();

  AttRows<D> st;
  st.init();
  uint32_t qf[D / 16][4];
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    // tile kt (and Q) visible to every thread; every warp is done with
    // tile kt - 1, whose stage the next copy refills
    __syncthreads();
    if (kt + 1 < n_tiles) {
      copy_rows<D, ATT_BK, NT>(stage(kt + 1), k, b, hk, (kt + 1) * ATT_BK, Sk,
                               Hkv);
      copy_rows<D, ATT_BK, NT>(stage(kt + 1) + ATT_BK * LDH, v, b, hk,
                               (kt + 1) * ATT_BK, Sk, Hkv);
    }
    cp_async_commit();
    if (kt == 0) att_load_q<bf16, D>(qf, Qs + warp * 16 * LDH);
    const int k0 = kt * ATT_BK;
    if (w0 >= Sq || k0 > reach) continue;  // no row of the warp sees it
    const bf16* Ks = stage(kt);
    float s[8][4];
    att_scores<bf16, D>(s, qf, Ks);
    const bool edge = k0 + ATT_BK > Sk ||
                      (causal && k0 + ATT_BK - 1 > w0 + q_offset);
    att_softmax_pv<bf16, D, false>(
        s, Ks + ATT_BK * LDH,
        [&](int hh, int c, float x) {
          x *= scale;
          if (edge) {
            const int key = k0 + c;
            if (key >= Sk || (causal && key > row + 8 * hh + q_offset))
              x = ATT_NEG;
          }
          return x;
        },
        [](int) { return 1.f; }, st);
  }
  cp_async_wait<0>();
  st.finish();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = row + 8 * hh;
    if (s >= Sq) continue;
    bf16* orow = o + ((static_cast<int64_t>(b) * Sq + s) * Hq + h) * D;
    const float l = st.l[hh];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack2(st.o[j][2 * hh] / l, st.o[j][2 * hh + 1] / l);
    if (t == 0)
      lse[static_cast<int64_t>(bh) * Sq + s] = st.m[hh] + logf(l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           cudaStream_t stream) {
  using L = FwdLayout<D, FWD_WARPS>;
  constexpr size_t bytes = L::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, FWD_WARPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int n_qt = (Sq + L::BQ - 1) / L::BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * Hq, n_qt);
  flash_fwd_kernel<D, FWD_WARPS><<<grid, FWD_WARPS * 32, bytes, stream>>>(
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
