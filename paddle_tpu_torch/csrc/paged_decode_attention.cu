// Paged single-query decode attention with grouped-query heads, over bf16
// (f32, f16) pools or int8 pools with per-(page, kv head) f32 scales.
//
// Replaces the Pallas kernels paddle_tpu/kernels/decode_attention.py
// `_paged_gqa_kernel` (launched by `_paged_decode_gqa`) and
// `_paged_decode_kernel` (equal heads, launched by `paged_decode_attention`),
// and their int8 twins `_paged_gqa_q8_kernel` and `_paged_decode_q8_kernel`:
// one kernel covers every group size Hq / Hkv >= 1, and a template
// parameter picks the pool element type.
//
// Inputs: q [B, Hq, D]; pools [max_pages, Hkv, block_size, D]; block
// tables [B, W] int32 page ids; lens [B] int32 = tokens cached before the
// current one. The current token was already written at position lens[b],
// so positions <= lens[b] are valid (decode_attention.py:283-288); pages
// past that are never read. int8 pools come with k/v scales
// [max_pages, Hkv] f32: a stored value x of page p, kv head h stands for
// x * scale[p, h].
//
// Bound on the H100: bytes. Every named K/V page is read once
// (2*B*ctx*Hkv*D*itemsize, plus 8 bytes of scales per page and kv head on
// int8 pools) for ~4 flops per element, so the kernel can at best stream
// the cache at memory rate; int8 pools halve the bytes.
//
// Design (simple first): one block of four warps per (sequence, KV head),
// the TPU kernel's (B, Hkv) grid with its page loop moved inside the
// block. The block reads its own block-table row, copies one page of K and
// V for its KV head (each a contiguous block_size*D run of the pool, in the
// pool's own type: 16 int8 or 8 bf16 elements per 16-byte load) into
// shared memory, scores the whole query group against it (one warp per
// (query head, key) dot product, warp-shuffle sum), runs the online
// softmax in f32 per query head, and accumulates P V in an f32
// shared-memory accumulator. On int8 pools the page's two scales are
// applied where the JAX q8 body applies them (decode_attention.py:
// 386-412): the k scale multiplies the f32 score after the dot and the
// softmax scale, the v scale multiplies the page's f32 P V before it joins
// the running accumulator (scales differ from page to page). No value is
// dequantized into a narrower type. Out-of-range page ids are clamped into
// the pool so a bad table cannot read outside it. Splitting the page loop
// across blocks (more blocks than B*Hkv when the batch is small) and
// double-buffering the page copies are later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr float NEG = -1e30f;

template <typename T>
__device__ __forceinline__ void copy_page(T* dst, const T* src, int n,
                                          bool vec) {
  if (vec) {
    const int nv = n * static_cast<int>(sizeof(T)) / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < nv; i += NTHREADS) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += NTHREADS) dst[i] = src[i];
  }
}

__host__ __device__ constexpr size_t f32_region(int G, int D, int bs) {
  return ((static_cast<size_t>(2 * G * D + G * bs + 3 * G) * 4) + 15) / 16 *
         16;
}

// T: q / out type; KT: pool element type (T, or int8_t with scales)
template <typename T, typename KT>
__global__ void __launch_bounds__(NTHREADS)
    paged_decode_kernel(const T* __restrict__ q, const KT* __restrict__ kc,
                        const KT* __restrict__ vc,
                        const float* __restrict__ ksc,
                        const float* __restrict__ vsc,
                        const int* __restrict__ tables,
                        const int* __restrict__ lens, T* __restrict__ out,
                        int Hq, int Hkv, int D, int bs, int W, int P,
                        float scale, int vec) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = Hq / Hkv;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [G, D]
  float* acc = q_s + G * D;                     // [G, D]
  float* s_s = acc + G * D;                     // [G, bs] scores, then p
  float* m_s = s_s + G * bs;                    // [G]
  float* l_s = m_s + G;                         // [G]
  float* c_s = l_s + G;                         // [G]
  KT* k_s = reinterpret_cast<KT*>(smem + f32_region(G, D, bs));  // [bs, D]
  KT* v_s = k_s + bs * D;                                        // [bs, D]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NW = NTHREADS / 32;
  const int len = lens[b];
  const int n_pages = min(W, len / bs + 1);
  const T* qb = q + (static_cast<int64_t>(b) * Hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += NTHREADS) {
    q_s[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += NTHREADS) {
    m_s[g] = NEG;
    l_s[g] = 0.f;
  }

  for (int j = 0; j < n_pages; ++j) {
    const int page = min(max(tables[static_cast<int64_t>(b) * W + j], 0), P - 1);
    const int64_t off = (static_cast<int64_t>(page) * Hkv + h) * bs * D;
    float k_scale = 1.f, v_scale = 1.f;
    if constexpr (Q8) {
      k_scale = ksc[static_cast<int64_t>(page) * Hkv + h];
      v_scale = vsc[static_cast<int64_t>(page) * Hkv + h];
    }
    __syncthreads();  // previous page fully consumed (and q_s/acc ready)
    copy_page(k_s, kc + off, bs * D, vec);
    copy_page(v_s, vc + off, bs * D, vec);
    __syncthreads();

    // scores: one warp per (query head g, key t)
    for (int idx = warp; idx < G * bs; idx += NW) {
      const int g = idx / bs, t = idx - g * bs;
      const float* qg = q_s + g * D;
      const KT* kt = k_s + t * D;
      float d = 0.f;
      for (int c = lane; c < D; c += 32) d += qg[c] * to_f32(kt[c]);
      d = warp_sum(d);
      float s = d * scale;
      if constexpr (Q8) s = s * k_scale;
      if (lane == 0) s_s[idx] = (j * bs + t <= len) ? s : NEG;
    }
    __syncthreads();

    // online softmax per query head
    for (int g = warp; g < G; g += NW) {
      float* sg = s_s + g * bs;
      float mx = NEG;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
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

    // acc = acc * corr + P V (int8: + (P V) * v_scale, the page's f32 sum)
    for (int i = threadIdx.x; i < G * D; i += NTHREADS) {
      const int g = i / D, c = i - g * D;
      const float* pg = s_s + g * bs;
      if constexpr (Q8) {
        float pv = 0.f;
        for (int t = 0; t < bs; ++t) pv += pg[t] * to_f32(v_s[t * D + c]);
        acc[i] = acc[i] * c_s[g] + pv * v_scale;
      } else {
        float a = acc[i] * c_s[g];
        for (int t = 0; t < bs; ++t) a += pg[t] * to_f32(v_s[t * D + c]);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<int64_t>(b) * Hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += NTHREADS)
    ob[i] = from_f32<T>(acc[i] / l_s[i / D]);
}

template <typename T, typename KT>
int launch(const void* q, const void* kc, const void* vc, const float* ksc,
           const float* vsc, const int* tables, const int* lens, void* out,
           int B, int Hq, int Hkv, int D, int bs, int W, int P, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t bytes =
      f32_region(G, D, bs) + 2 * static_cast<size_t>(bs) * D * sizeof(KT);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec =
      ((reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) &
       15) == 0 &&
      (static_cast<size_t>(bs) * D * sizeof(KT)) % 16 == 0;
  dim3 grid(B, Hkv);
  paged_decode_kernel<T, KT><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), ksc, vsc, tables, lens,
      static_cast<T*>(out), Hq, Hkv, D, bs, W, P, scale, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// KT = void: the pool has q's type; KT = int8_t: an int8 pool with scales
template <typename KT>
int dispatch(int dtype, const void* q, const void* kc, const void* vc,
             const float* ksc, const float* vsc, const int* t, const int* l,
             void* out, int B, int Hq, int Hkv, int D, int bs, int W, int P,
             float scale, cudaStream_t s) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  using KF = typename std::conditional<Q8, int8_t, float>::type;
  using KB = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  using KH = typename std::conditional<Q8, int8_t, __half>::type;
  if (B == 0) return static_cast<int>(cudaGetLastError());
  switch (dtype) {
    case PTT_F32:
      return launch<float, KF>(q, kc, vc, ksc, vsc, t, l, out, B, Hq, Hkv, D,
                               bs, W, P, scale, s);
    case PTT_BF16:
      return launch<__nv_bfloat16, KB>(q, kc, vc, ksc, vsc, t, l, out, B, Hq,
                                       Hkv, D, bs, W, P, scale, s);
    case PTT_F16:
      return launch<__half, KH>(q, kc, vc, ksc, vsc, t, l, out, B, Hq, Hkv, D,
                                bs, W, P, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* tables,
    const void* lens, void* out, int B, int Hq, int Hkv, int D, int bs, int W,
    int P, float scale, int dtype, void* stream) {
  return dispatch<void>(dtype, q, kc, vc, nullptr, nullptr,
                        static_cast<const int*>(tables),
                        static_cast<const int*>(lens), out, B, Hq, Hkv, D, bs,
                        W, P, scale, static_cast<cudaStream_t>(stream));
}

// int8 pools with f32 scales [P, Hkv]; `dtype` is q's (and out's) type
extern "C" int paged_decode_attention_q8_launch(
    const void* q, const void* kc, const void* vc, const void* k_scale,
    const void* v_scale, const void* tables, const void* lens, void* out,
    int B, int Hq, int Hkv, int D, int bs, int W, int P, float scale,
    int dtype, void* stream) {
  return dispatch<int8_t>(dtype, q, kc, vc,
                          static_cast<const float*>(k_scale),
                          static_cast<const float*>(v_scale),
                          static_cast<const int*>(tables),
                          static_cast<const int*>(lens), out, B, Hq, Hkv, D,
                          bs, W, P, scale, static_cast<cudaStream_t>(stream));
}
