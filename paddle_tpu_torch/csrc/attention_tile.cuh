// The register-resident tile body of the port's many-query attention
// kernels: the flash forward (csrc/flash_attention_fwd.cu) and paged
// prefill attention (csrc/paged_prefill_attention.cu); the flash
// backward's dq kernel (csrc/flash_attention_bwd.cu) takes its row copies
// and Q fragments.
//
// A warp owns 16 query rows end to end. Their Q fragments stay in
// registers; K and V tiles of 64 keys come from shared memory (16-bit
// elements, rows of D + 8 elements: the padding puts the eight rows an
// ldmatrix reads in distinct banks). S = Q K^T runs on m16n8k16 mma.sync
// into C fragments (B fragments of K by ldmatrix), the online softmax
// runs on those accumulators (row max over the quad's four lanes by
// shuffles; each lane keeps its own partial row sum, added across the
// quad once at the end), and the probabilities are packed to 16-bit pairs
// straight into the A fragments of O += P V (B fragments of V by
// ldmatrix.trans). No score, probability or output row goes through
// shared memory, and O stays in registers for the block's whole walk.
// Fragment layouts: fragments.cuh.
#pragma once

#include "common.cuh"
#include "fragments.cuh"

constexpr int ATT_BK = 64;          // keys per tile
constexpr float ATT_NEG = -1e30f;   // the JAX kernels' finite mask value

// online-softmax state of a warp's 16 rows; this lane holds rows g and
// g + 8 (lane = 4 g + t), columns 8 j + 2 t, 8 j + 2 t + 1 of O
template <int D>
struct AttRows {
  float m[2];         // running max of the f32 logits
  float l[2];         // this lane's part of the row sums of p
  float o[D / 8][4];  // O: C fragments of [16, D]

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = ATT_NEG;
      l[h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }

  // the quad's row sums, once after the last tile
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
};

// rows [row0, row0 + ROWS) of a [B, S, H, D] tensor at (b, h) -> smem
// rows of pitch D + 8 by cp.async from the block's NT threads, zero-filled
// past S
template <int D, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int b,
                                          int h, int row0, int S, int H) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR, c = idx - r * VPR;
    const int s = row0 + r;
    const bool ok = s < S;
    const __nv_bfloat16* g =
        ok ? src + ((static_cast<int64_t>(b) * S + s) * H + h) * D + c * 8
           : src;
    cp_async16(dst + r * (D + 8) + c * 8, g, ok);
  }
}

// A fragments of the warp's 16 rows of a Q tile in shared memory (`rows`:
// its first row, pitch D + 8)
template <typename T, int D>
__device__ __forceinline__ void att_load_q(uint32_t (&qf)[D / 16][4],
                                           const T* rows) {
  const int lane = threadIdx.x & 31;
  const T* p = rows + (lane & 15) * (D + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], p + kk * 16);
}

// s = Q K^T over the tile's 64 keys: n-tile j holds keys 8 j .. 8 j + 7
template <typename T, int D>
__device__ __forceinline__ void att_scores(float (&s)[8][4],
                                           const uint32_t (&qf)[D / 16][4],
                                           const T* Ks) {
  constexpr int LDH = D + 8;
  const int lane = threadIdx.x & 31;
  const T* p = Ks + ((lane & 7) + ((lane >> 4) << 3)) * LDH +
               ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, p + np * 16 * LDH + kk * 16);
      mma16816<T>(s[2 * np], qf[kk], b[0], b[1]);
      mma16816<T>(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
}

// One 64-key tile of the online softmax (the JAX kernels' recurrence:
// m' = max(m, max s), corr = exp(m - m'), l' = l corr + sum p, O' = O corr
// + P V) on the raw dots `s`. score(h, c, x) turns the dot x of row g + 8 h
// and key column c into the f32 logit (softmax scale, an int8 key's scale,
// the mask: ATT_NEG); vmul(c) is the factor key column c's p takes into
// P V (an int8 value's scale), 1 otherwise; the row sums take p itself.
// PSPLIT = false rounds P to T once, as the JAX flash kernel's
// p.astype(v.dtype) does; PSPLIT = true runs two products over the same V
// fragments, hi = T(p) and lo = T(p - hi), which carry p to about 16 bits
// (bf16) or 22 bits (f16), near the f32 P V of the JAX paged kernels.
template <typename T, int D, bool PSPLIT, typename Score, typename VMul>
__device__ __forceinline__ void att_softmax_pv(float (&s)[8][4],
                                               const T* Vs, Score score,
                                               VMul vmul, AttRows<D>& st) {
  constexpr int LDH = D + 8;
  const int lane = threadIdx.x & 31, t = lane & 3;
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = score(e >> 1, 8 * j + 2 * t + (e & 1), s[j][e]);
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = __expf(st.m[h] - mx[h]);
    st.m[h] = mx[h];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += p;
      s[j][e] = p * vmul(8 * j + 2 * t + (e & 1));
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * corr[h] + sum[h];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.o[j][0] *= corr[0];
    st.o[j][1] *= corr[0];
    st.o[j][2] *= corr[1];
    st.o[j][3] *= corr[1];
  }

  const T* p = Vs + (lane & 15) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < ATT_BK / 16; ++kk) {
    // n-tiles 2 kk and 2 kk + 1 of P are the A fragment of keys 16 kk ..
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* c = s[2 * kk + half];
      hi[2 * half] = pack2<T>(c[0], c[1]);
      hi[2 * half + 1] = pack2<T>(c[2], c[3]);
      if constexpr (PSPLIT) {
        const float2 a = unpack2<T>(hi[2 * half]);
        const float2 b = unpack2<T>(hi[2 * half + 1]);
        lo[2 * half] = pack2<T>(c[0] - a.x, c[1] - a.y);
        lo[2 * half + 1] = pack2<T>(c[2] - b.x, c[3] - b.y);
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldsm_x4_trans(b, p + kk * 16 * LDH + dn * 16);
      mma16816<T>(st.o[2 * dn], hi, b[0], b[1]);
      mma16816<T>(st.o[2 * dn + 1], hi, b[2], b[3]);
      if constexpr (PSPLIT) {
        mma16816<T>(st.o[2 * dn], lo, b[0], b[1]);
        mma16816<T>(st.o[2 * dn + 1], lo, b[2], b[3]);
      }
    }
  }
}
