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
// Per layer, five phases, each a grid-stride loop over work items with a
// grid-wide barrier after it:
//   1. rms_norm + q/k/v projections + rotary. Item: one head's columns
//      {c, c + D/2} for a run of c (the rotate-half pairs stay in one item),
//      for all b rows. Each block recomputes the rows' rms (b x H from L2).
//   2. attention + commit. Item: one (row, kv head) and its whole query
//      group. Pages named by the table stream through shared memory with an
//      f32 online softmax over positions strictly below lens; the current
//      token's k / v join from the projection, unquantized; then the token
//      is committed into its page (bf16 slot write, or the int8 monotone-
//      scale read-modify-write of the whole page), after the page was read.
//   3. o projection + residual. Item: 32 output columns of H; the sum over
//      Hq*D is f32, a weight-only scale multiplies the whole sum, the
//      residual adds in f32 and rounds once.
//   4. (mlp) post-attention rms_norm + gate and up. Item: 16 columns of F
//      of both; gate and up round to the compute type, then silu(g) * u.
//   5. (mlp) down + residual, as phase 3 over F.
// The residual stream lives in `out` [b, H] for the whole launch (seeded
// from h), never in a per-layer copy. Data written inside the launch is
// read with ld.global.cg (L2), never through a possibly stale L1.
//
// GEMV (phases 1, 3, 4, 5): the input rows are staged into shared memory
// 1024 columns at a time (phases 1 and 4 normalize them on the way); a
// block computes 32 output slots for all b rows. Dense weights [K, N]:
// lane j of every warp owns slot j and the warps split k, so a warp reads
// 32 neighbouring columns of one k row (coalesced); warp partials add in
// a fixed order. int8 weights [N, K]: warp w owns slots w, w + 8, w + 16,
// w + 24 and its lanes read 4 bytes of each slot's row at a time; lane
// partials add by shuffles. No float atomics: every sum has a fixed order,
// so a launch repeats its tokens exactly.
//
// Bound on the H100: bytes. A decode step at b = 8 reads every weight once
// (Llama-3-8B int8: 218 MB a layer, 6.98 GB a step, 2.1 ms at 3.35 TB/s)
// plus the named KV pages; the flops are 2 b per weight value. This first
// version is simple: one block per item, no TMA, no tensor cores, no split
// of long rows across blocks; its grid barrier is a counter in device
// memory (the cooperative launch guarantees that every block is resident).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;               // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXB = 16;              // rows per launch
constexpr int KC = 1024;              // staged input columns per GEMV step
constexpr float NEG = -1e30f;

enum { WQ = 0, WK, WV, WO, WG, WU, WD };

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
  unsigned* bar;
  int L, B, H, F, NH, NKV, D, BS, W, P;   // P: pool pages per layer
  int mlp;
  float scale, eps;
};

template <typename T>
__device__ __forceinline__ T ldcg(const T* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ __nv_bfloat16 ldcg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// read-only weights (never written by the launch) through the
// non-coherent cache
template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ __nv_bfloat16 ldg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}

// grid-wide barrier (every block is resident: cooperative launch)
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < NWARP; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

// shared state of one block's GEMV (static: set per item)
struct Slots {
  const void* ptr[32];    // slot j's column base (dense) or row (int8)
  int ld[32];             // dense: the row stride N
  float inv[MAXB];        // rms inverse per row (phases 1 and 4)
};

// 1 / rms of each row of the residual [B, H] (one warp per row)
template <typename T>
__device__ void row_inv(const T* src, int B, int H, float eps, Slots& sl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < B; m += NWARP) {
    float ss = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float v = to_f32(ldcg(src + static_cast<int64_t>(m) * H + k));
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) sl.inv[m] = 1.f / sqrtf(ss / static_cast<float>(H) + eps);
  }
  __syncthreads();
}

// out_s[m][j] = sum_k x[m][k] * W(k, slot j) in f32, for m < B, j < 32.
// x[m][k] = src[m * K + k], or with RMS the normalized value
// T(src * inv[m] * norm[k]). QW: int8 rows (the caller scales the sum).
template <typename T, bool QW, bool RMS>
__device__ void gemv(const T* src, const T* norm, int B, int K,
                     const Slots& sl, T* xs, float* red, float* out_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[QW ? 4 : 1][MAXB];
#pragma unroll
  for (int i = 0; i < (QW ? 4 : 1); ++i)
#pragma unroll
    for (int m = 0; m < MAXB; ++m) acc[i][m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();   // the previous chunk is consumed
    for (int i = threadIdx.x; i < B * kc; i += NT) {
      const int m = i / kc, k = i - m * kc;
      const T v = ldcg(src + static_cast<int64_t>(m) * K + k0 + k);
      if constexpr (RMS)
        xs[m * KC + k] = from_f32<T>(to_f32(v) * sl.inv[m] *
                                     to_f32(norm[k0 + k]));
      else
        xs[m * KC + k] = v;
    }
    __syncthreads();
    if constexpr (QW) {
      // warp w: slots w + 8 i; lane: 4 k at a time, 128 k per step
      const int8_t* rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rows[i] = static_cast<const int8_t*>(sl.ptr[warp + 8 * i]);
      for (int k = 4 * lane; k < kc; k += 128) {
        float wv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          char4 c = make_char4(0, 0, 0, 0);
          if (rows[i])
            c = __ldg(reinterpret_cast<const char4*>(rows[i] + k0 + k));
          wv[i][0] = c.x; wv[i][1] = c.y; wv[i][2] = c.z; wv[i][3] = c.w;
        }
#pragma unroll
        for (int m = 0; m < MAXB; ++m) {
          if (m < B) {
            const T* xm = xs + m * KC + k;
            const float x0 = to_f32(xm[0]), x1 = to_f32(xm[1]),
                        x2 = to_f32(xm[2]), x3 = to_f32(xm[3]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[i][m] += x0 * wv[i][0] + x1 * wv[i][1] + x2 * wv[i][2] +
                           x3 * wv[i][3];
          }
        }
      }
    } else {
      // lane j: slot j; warp w: k = w, w + 8, ...
      const T* col = static_cast<const T*>(sl.ptr[lane]);
      const int64_t ld = sl.ld[lane];
#pragma unroll 4
      for (int k = warp; k < kc; k += NWARP) {
        const float wv = col ? to_f32(ldg(col + (k0 + k) * ld)) : 0.f;
#pragma unroll
        for (int m = 0; m < MAXB; ++m)
          if (m < B) acc[0][m] += to_f32(xs[m * KC + k]) * wv;
      }
    }
  }

  if constexpr (QW) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < MAXB; ++m) {
        if (m < B) {
          const float v = warp_sum(acc[i][m]);
          if (lane == 0) out_s[m * 32 + warp + 8 * i] = v;
        }
      }
    __syncthreads();
  } else {
#pragma unroll
    for (int m = 0; m < MAXB; ++m)
      if (m < B) red[(warp * B + m) * 32 + lane] = acc[0][m];
    __syncthreads();
    for (int i = threadIdx.x; i < B * 32; i += NT) {
      const int m = i / 32, j = i - m * 32;
      float v = 0.f;
      for (int w = 0; w < NWARP; ++w) v += red[(w * B + m) * 32 + j];
      out_s[i] = v;
    }
    __syncthreads();
  }
}

// slot j's column n of a per-layer matrix: dense [K, N] (column base,
// stride N) or int8 [N, K] (row base)
template <typename T, bool QW>
__device__ __forceinline__ void set_slot(Slots& sl, int j, const void* w,
                                         int n, int N, int K, bool valid) {
  if (!valid) {
    sl.ptr[j] = nullptr;
    sl.ld[j] = 0;
  } else if (QW) {
    sl.ptr[j] = static_cast<const int8_t*>(w) + static_cast<int64_t>(n) * K;
    sl.ld[j] = 0;
  } else {
    sl.ptr[j] = static_cast<const T*>(w) + n;
    sl.ld[j] = N;
  }
}

template <typename T, bool QW>
__device__ __forceinline__ const void* layer_w(const void* w, int l,
                                               int64_t per_layer) {
  return QW ? static_cast<const void*>(static_cast<const int8_t*>(w) +
                                       l * per_layer)
            : static_cast<const void*>(static_cast<const T*>(w) +
                                       l * per_layer);
}

__device__ __forceinline__ float rn_mul(float a, float b) {
  return __fmul_rn(a, b);
}

// one (row m, kv head h) of phase 2
template <typename T, bool QKV>
__device__ void attend_commit(const Args& a, int l, int m, int h,
                              unsigned char* smem) {
  using KT = typename std::conditional<QKV, int8_t, T>::type;
  const int D = a.D, BS = a.BS, G = a.NH / a.NKV, NKV = a.NKV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* q_s = reinterpret_cast<float*>(smem);   // [G, D]
  float* acc = q_s + G * D;                       // [G, D]
  float* s_s = acc + G * D;                       // [G, BS]
  float* m_s = s_s + G * BS;                      // [G]
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  float* p_s = c_s + G;
  float* kcur = p_s + G;                          // [D]
  float* vcur = kcur + D;                         // [D]
  float* red = vcur + D;                          // [64]
  const size_t f32_bytes =
      (static_cast<size_t>(2 * G * D + G * BS + 4 * G + 2 * D + 64) * 4 +
       15) / 16 * 16;
  KT* k_t = reinterpret_cast<KT*>(smem + f32_bytes);   // [BS, D]
  KT* v_t = k_t + BS * D;

  const T* qw = static_cast<const T*>(a.q_ws);
  const T* kw = static_cast<const T*>(a.k_ws);
  const T* vw = static_cast<const T*>(a.v_ws);
  const int len = a.lens[m];
  for (int i = threadIdx.x; i < G * D; i += NT) {
    q_s[i] = to_f32(ldcg(qw + (static_cast<int64_t>(m) * a.NH + h * G) * D +
                         i));
    acc[i] = 0.f;
  }
  for (int d = threadIdx.x; d < D; d += NT) {
    kcur[d] = to_f32(ldcg(kw + (static_cast<int64_t>(m) * NKV + h) * D + d));
    vcur[d] = to_f32(ldcg(vw + (static_cast<int64_t>(m) * NKV + h) * D + d));
  }
  for (int g = threadIdx.x; g < G; g += NT) {
    m_s[g] = NEG;
    l_s[g] = 0.f;
  }
  KT* kc = static_cast<KT*>(a.kc);
  KT* vc = static_cast<KT*>(a.vc);
  const int* trow = a.tables + static_cast<int64_t>(m) * a.W;
  const int64_t tile = static_cast<int64_t>(BS) * D;
  const bool vec = (tile * sizeof(KT)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(kc) |
                     reinterpret_cast<uintptr_t>(vc)) & 15) == 0;
  const int n_pages = min(a.W, (len + BS - 1) / BS);

  for (int col = 0; col < n_pages; ++col) {
    const int64_t page = min(max(trow[col], 0), a.P - 1) +
                         static_cast<int64_t>(l) * a.P;
    const int64_t sidx = page * NKV + h;
    float ks = 1.f, vs = 1.f;
    if constexpr (QKV) {
      ks = ldcg(a.ksc + sidx);
      vs = ldcg(a.vsc + sidx);
    }
    __syncthreads();   // the previous tile is consumed
    if (vec) {
      const int nv = static_cast<int>(tile * sizeof(KT) / 16);
      const uint4* ks4 = reinterpret_cast<const uint4*>(kc + sidx * tile);
      const uint4* vs4 = reinterpret_cast<const uint4*>(vc + sidx * tile);
      for (int i = threadIdx.x; i < nv; i += NT) {
        reinterpret_cast<uint4*>(k_t)[i] = __ldcg(ks4 + i);
        reinterpret_cast<uint4*>(v_t)[i] = __ldcg(vs4 + i);
      }
    } else {
      for (int i = threadIdx.x; i < tile; i += NT) {
        k_t[i] = ldcg(kc + sidx * tile + i);
        v_t[i] = ldcg(vc + sidx * tile + i);
      }
    }
    __syncthreads();
    // scores: one warp per (query head g, key t), masked strictly below len
    for (int idx = warp; idx < G * BS; idx += NWARP) {
      const int g = idx / BS, t = idx - g * BS;
      float d = 0.f;
      for (int c = lane; c < D; c += 32)
        d += q_s[g * D + c] * to_f32(k_t[t * D + c]);
      d = warp_sum(d);
      float s = d * a.scale;
      if constexpr (QKV) s = s * ks;
      if (lane == 0) s_s[idx] = (col * BS + t < len) ? s : NEG;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NWARP) {
      float* sg = s_s + g * BS;
      float mx = NEG;
      for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
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
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += NT) {
      const int g = i / D, c = i - g * D;
      const float* pg = s_s + g * BS;
      float pv = 0.f;
      for (int t = 0; t < BS; ++t) {
        float v = to_f32(v_t[t * D + c]);
        if constexpr (QKV) v = v * vs;
        pv += pg[t] * v;
      }
      acc[i] = acc[i] * c_s[g] + pv;
    }
  }
  __syncthreads();
  // the current token joins from the projection
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
  __syncthreads();
  T* cw = static_cast<T*>(a.ctx_ws);
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D, c = i - g * D;
    const float v = acc[i] * c_s[g] + p_s[g] * vcur[c];
    const float lg = l_s[g];
    cw[(static_cast<int64_t>(m) * a.NH + h * G) * D + i] =
        from_f32<T>(v / (lg > 0.f ? lg : 1.f));
  }

  // commit the token into its page (after the page was read above)
  const int colc = min(len / BS, a.W - 1);
  const int64_t page = min(max(trow[colc], 0), a.P - 1) +
                       static_cast<int64_t>(l) * a.P;
  const int64_t sidx = page * NKV + h;
  const int slot = len % BS;
  if constexpr (!QKV) {
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
      const float old = slot == 0 ? 0.f : ldcg(sc + sidx);
      const float nw = fmaxf(old, am);
      const float safe = nw > 0.f ? nw : 1.f;
      const float ratio = old / safe;
      for (int i = threadIdx.x; i < tile; i += NT) {
        const int r = i / D;
        float q = r == slot ? rintf(tok[i - r * D] / safe)
                            : rintf(static_cast<float>(ldcg(pool + i)) * ratio);
        q = fminf(fmaxf(q, -127.f), 127.f);
        pool[i] = static_cast<int8_t>(q);
      }
      __syncthreads();
      if (threadIdx.x == 0) sc[sidx] = nw;
    }
  }
  __syncthreads();
}

template <typename T, bool QW, bool QKV>
__global__ void __launch_bounds__(NT) mega_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Slots sl;
  const int B = a.B, H = a.H, F = a.F, D = a.D, NH = a.NH, NKV = a.NKV;
  const int tid = threadIdx.x;
  T* out = static_cast<T*>(a.out);
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + sizeof(T) * B * KC);
  float* out_s = red + NWARP * B * 32;
  const int dh2 = D / 2;
  int pc = 16;                       // rotate-half pairs per item
  while (dh2 % pc) --pc;
  const int chunks = dh2 / pc;
  const int64_t HQ = static_cast<int64_t>(NH) * D, HK =
      static_cast<int64_t>(NKV) * D;

  for (int64_t i = static_cast<int64_t>(blockIdx.x) * NT + tid;
       i < static_cast<int64_t>(B) * H; i += static_cast<int64_t>(gridDim.x) * NT)
    out[i] = static_cast<const T*>(a.h)[i];
  grid_sync(a.bar);

  for (int l = 0; l < a.L; ++l) {
    // ---- 1: rms_norm + q/k/v + rotary
    const T* w_in = static_cast<const T*>(a.w_in) + static_cast<int64_t>(l) * H;
    const int items1 = (NH + 2 * NKV) * chunks;
    if (blockIdx.x < items1) row_inv(out, B, H, a.eps, sl);
    for (int it = blockIdx.x; it < items1; it += gridDim.x) {
      const int head = it / chunks, ch = it - head * chunks;
      int mat, hh;
      if (head < NH) { mat = WQ; hh = head; }
      else if (head < NH + NKV) { mat = WK; hh = head - NH; }
      else { mat = WV; hh = head - NH - NKV; }
      const int64_t N = mat == WQ ? HQ : HK;
      const void* wl = layer_w<T, QW>(a.w[mat], l, N * H);
      if (tid < 32) {
        const int half = tid / pc, c = tid - half * pc;
        const int n = hh * D + ch * pc + c + half * dh2;
        set_slot<T, QW>(sl, tid, wl, n, static_cast<int>(N), H, tid < 2 * pc);
      }
      __syncthreads();
      gemv<T, QW, true>(out, w_in, B, H, sl, xs, red, out_s);
      const float* sc = QW ? a.s[mat] + l * N : nullptr;
      T* dst = static_cast<T*>(mat == WQ ? a.q_ws : mat == WK ? a.k_ws
                                                               : a.v_ws);
      for (int i = tid; i < B * pc; i += NT) {
        const int m = i / pc, c = i - m * pc;
        const int d = ch * pc + c;
        const int na = hh * D + d, nb = na + dh2;
        float va = out_s[m * 32 + c], vb = out_s[m * 32 + pc + c];
        if (QW) { va = va * sc[na]; vb = vb * sc[nb]; }
        T ta = from_f32<T>(va), tb = from_f32<T>(vb);
        if (mat != WV) {
          const T cs = from_f32<T>(a.cos_t[m * dh2 + d]);
          const T sn = from_f32<T>(a.sin_t[m * dh2 + d]);
          const float fa = to_f32(ta), fb = to_f32(tb);
          const float fc = to_f32(cs), fs = to_f32(sn);
          const T a1 = from_f32<T>(rn_mul(fa, fc)), a2 = from_f32<T>(rn_mul(fb, fs));
          const T b1 = from_f32<T>(rn_mul(fb, fc)), b2 = from_f32<T>(rn_mul(fa, fs));
          ta = from_f32<T>(__fsub_rn(to_f32(a1), to_f32(a2)));
          tb = from_f32<T>(__fadd_rn(to_f32(b1), to_f32(b2)));
        }
        const int64_t row = static_cast<int64_t>(m) * (mat == WQ ? HQ : HK);
        dst[row + na] = ta;
        dst[row + nb] = tb;
      }
    }
    grid_sync(a.bar);

    // ---- 2: attention over the pages + the current token, then commit
    for (int it = blockIdx.x; it < B * NKV; it += gridDim.x)
      attend_commit<T, QKV>(a, l, it / NKV, it % NKV, smem);
    grid_sync(a.bar);

    // ---- 3: o projection + residual
    {
      const void* wl = layer_w<T, QW>(a.w[WO], l, HQ * H);
      const float* sc = QW ? a.s[WO] + static_cast<int64_t>(l) * H : nullptr;
      for (int it = blockIdx.x; it < (H + 31) / 32; it += gridDim.x) {
        if (tid < 32) {
          const int n = it * 32 + tid;
          set_slot<T, QW>(sl, tid, wl, n, H, static_cast<int>(HQ), n < H);
        }
        __syncthreads();
        gemv<T, QW, false>(static_cast<const T*>(a.ctx_ws), nullptr, B,
                           static_cast<int>(HQ), sl, xs, red, out_s);
        for (int i = tid; i < B * 32; i += NT) {
          const int m = i / 32, n = it * 32 + (i - m * 32);
          if (n >= H) continue;
          float p = out_s[i];
          if (QW) p = p * sc[n];
          T* o = out + static_cast<int64_t>(m) * H + n;
          *o = from_f32<T>(__fadd_rn(to_f32(ldcg(o)), p));
        }
      }
    }
    grid_sync(a.bar);
    if (!a.mlp) continue;

    // ---- 4: post-attention rms_norm + gate / up + silu(g) * u
    {
      const T* w_post =
          static_cast<const T*>(a.w_post) + static_cast<int64_t>(l) * H;
      const int64_t per = static_cast<int64_t>(H) * F;
      const void* wg = layer_w<T, QW>(a.w[WG], l, per);
      const void* wu = layer_w<T, QW>(a.w[WU], l, per);
      const float* sg = QW ? a.s[WG] + static_cast<int64_t>(l) * F : nullptr;
      const float* su = QW ? a.s[WU] + static_cast<int64_t>(l) * F : nullptr;
      const int items4 = (F + 15) / 16;
      if (blockIdx.x < items4) row_inv(out, B, H, a.eps, sl);
      T* y = static_cast<T*>(a.y_ws);
      for (int it = blockIdx.x; it < items4; it += gridDim.x) {
        if (tid < 32) {
          const int n = it * 16 + (tid & 15);
          set_slot<T, QW>(sl, tid, tid < 16 ? wg : wu, n, F, H, n < F);
        }
        __syncthreads();
        gemv<T, QW, true>(out, w_post, B, H, sl, xs, red, out_s);
        for (int i = tid; i < B * 16; i += NT) {
          const int m = i / 16, c = i - m * 16, n = it * 16 + c;
          if (n >= F) continue;
          float g = out_s[m * 32 + c], u = out_s[m * 32 + 16 + c];
          if (QW) { g = g * sg[n]; u = u * su[n]; }
          const float gt = to_f32(from_f32<T>(g)), ut = to_f32(from_f32<T>(u));
          const float sl_ = to_f32(from_f32<T>(gt / (1.f + expf(-gt))));
          y[static_cast<int64_t>(m) * F + n] = from_f32<T>(rn_mul(sl_, ut));
        }
      }
    }
    grid_sync(a.bar);

    // ---- 5: down + residual
    {
      const void* wl = layer_w<T, QW>(a.w[WD], l, static_cast<int64_t>(H) * F);
      const float* sc = QW ? a.s[WD] + static_cast<int64_t>(l) * H : nullptr;
      for (int it = blockIdx.x; it < (H + 31) / 32; it += gridDim.x) {
        if (tid < 32) {
          const int n = it * 32 + tid;
          set_slot<T, QW>(sl, tid, wl, n, H, F, n < H);
        }
        __syncthreads();
        gemv<T, QW, false>(static_cast<const T*>(a.y_ws), nullptr, B, F, sl,
                           xs, red, out_s);
        for (int i = tid; i < B * 32; i += NT) {
          const int m = i / 32, n = it * 32 + (i - m * 32);
          if (n >= H) continue;
          float p = out_s[i];
          if (QW) p = p * sc[n];
          T* o = out + static_cast<int64_t>(m) * H + n;
          *o = from_f32<T>(__fadd_rn(to_f32(ldcg(o)), p));
        }
      }
    }
    grid_sync(a.bar);
  }
}

template <typename T, bool QKV>
size_t smem_bytes(const Args& a) {
  using KT = typename std::conditional<QKV, int8_t, T>::type;
  const int G = a.NH / a.NKV;
  const size_t gemv = static_cast<size_t>(a.B) * KC * sizeof(T) +
                      static_cast<size_t>(NWARP) * a.B * 32 * 4 +
                      static_cast<size_t>(a.B) * 32 * 4 + 64;
  const size_t attn =
      (static_cast<size_t>(2 * G * a.D + G * a.BS + 4 * G + 2 * a.D + 64) * 4 +
       15) / 16 * 16 +
      2 * static_cast<size_t>(a.BS) * a.D * sizeof(KT);
  return gemv > attn ? gemv : attn;
}

template <typename T, bool QW, bool QKV>
int launch(const Args& a, cudaStream_t stream) {
  if (a.B < 1 || a.B > MAXB || a.NKV < 1 || a.NH % a.NKV || a.D % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T, QKV>(a);
  auto kern = mega_kernel<T, QW, QKV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                         smem)) != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // no more blocks than the widest phase has items
  int dh2 = a.D / 2, pc = 16;
  while (dh2 % pc) --pc;
  int widest = max((a.NH + 2 * a.NKV) * (dh2 / pc), a.B * a.NKV);
  widest = max(widest, (a.H + 31) / 32);
  if (a.mlp) widest = max(widest, (a.F + 15) / 16);
  const int grid = max(1, min(per_sm * sms, widest));
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(grid), dim3(NT), params, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_t(const Args& a, int quant_w, int quant_kv, cudaStream_t s) {
  if (quant_w)
    return quant_kv ? launch<T, true, true>(a, s) : launch<T, true, false>(a, s);
  return quant_kv ? launch<T, false, true>(a, s) : launch<T, false, false>(a, s);
}

}  // namespace

// ptrs: h, out, lens, tables, cos, sin, w_in, w_post, wq, wk, wv, wo, wg,
//   wu, wd, sq, sk, sv, so, sg, su, sd, k_cache, v_cache, k_scale,
//   v_scale, q_ws, k_ws, v_ws, ctx_ws, y_ws, barrier (2 x u32, zeroed)
// ints: L, B, H, F, NH, NKV, D, BS, W, P, mlp, quant_w, quant_kv, dtype
extern "C" int decode_megakernel_launch(const void* const* ptrs,
                                        const int* ints, float scale,
                                        float eps, void* stream) {
  Args a;
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
  a.bar = static_cast<unsigned*>(const_cast<void*>(ptrs[31]));
  a.L = ints[0]; a.B = ints[1]; a.H = ints[2]; a.F = ints[3];
  a.NH = ints[4]; a.NKV = ints[5]; a.D = ints[6]; a.BS = ints[7];
  a.W = ints[8]; a.P = ints[9]; a.mlp = ints[10];
  a.scale = scale;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ints[13]) {
    case PTT_F32:
      return dispatch_t<float>(a, ints[11], ints[12], s);
    case PTT_BF16:
      return dispatch_t<__nv_bfloat16>(a, ints[11], ints[12], s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
