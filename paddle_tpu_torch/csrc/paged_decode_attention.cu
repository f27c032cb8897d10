// Paged single-query decode attention with grouped-query heads.
//
// Replaces the Pallas kernels paddle_tpu/kernels/decode_attention.py
// `_paged_gqa_kernel` (launched by `_paged_decode_gqa`) and
// `_paged_decode_kernel` (equal heads, launched by `paged_decode_attention`):
// one kernel covers every group size Hq / Hkv >= 1.
//
// Inputs: q [B, Hq, D]; pools [max_pages, Hkv, block_size, D]; block
// tables [B, W] int32 page ids; lens [B] int32 = tokens cached before the
// current one. The current token was already written at position lens[b],
// so positions <= lens[b] are valid (decode_attention.py:283-288); pages
// past that are never read.
//
// Bound on the H100: bytes. Every named K/V page is read once
// (2*B*ctx*Hkv*D*itemsize) for ~4 flops per element, so the kernel can at
// best stream the cache at memory rate.
//
// Design (simple first): one block of four warps per (sequence, KV head),
// the TPU kernel's (B, Hkv) grid with its page loop moved inside the
// block. The block reads its own block-table row, copies one page of K and
// V for its KV head (each a contiguous block_size*D run of the pool) into
// shared memory with 16-byte loads, scores the whole query group against
// it (one warp per (query head, key) dot product, warp-shuffle sum), runs
// the online softmax in f32 per query head, and accumulates P V in an f32
// shared-memory accumulator. Out-of-range page ids are clamped into the
// pool so a bad table cannot read outside it. Splitting the page loop
// across blocks (more blocks than B*Hkv when the batch is small) and
// double-buffering the page copies are later work.
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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ tables,
                        const int* __restrict__ lens, T* __restrict__ out,
                        int Hq, int Hkv, int D, int bs, int W, int P,
                        float scale, int vec) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = Hq / Hkv;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [G, D]
  float* acc = q_s + G * D;                     // [G, D]
  float* s_s = acc + G * D;                     // [G, bs] scores, then p
  float* m_s = s_s + G * bs;                    // [G]
  float* l_s = m_s + G;                         // [G]
  float* c_s = l_s + G;                         // [G]
  const size_t f32_bytes =
      ((static_cast<size_t>(2 * G * D + G * bs + 3 * G) * 4) + 15) / 16 * 16;
  T* k_s = reinterpret_cast<T*>(smem + f32_bytes);  // [bs, D]
  T* v_s = k_s + bs * D;                            // [bs, D]

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
    __syncthreads();  // previous page fully consumed (and q_s/acc ready)
    copy_page(k_s, kc + off, bs * D, vec);
    copy_page(v_s, vc + off, bs * D, vec);
    __syncthreads();

    // scores: one warp per (query head g, key t)
    for (int idx = warp; idx < G * bs; idx += NW) {
      const int g = idx / bs, t = idx - g * bs;
      const float* qg = q_s + g * D;
      const T* kt = k_s + t * D;
      float d = 0.f;
      for (int c = lane; c < D; c += 32) d += qg[c] * to_f32(kt[c]);
      d = warp_sum(d);
      if (lane == 0) s_s[idx] = (j * bs + t <= len) ? d * scale : NEG;
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

    // acc = acc * corr + P V
    for (int i = threadIdx.x; i < G * D; i += NTHREADS) {
      const int g = i / D, c = i - g * D;
      const float* pg = s_s + g * bs;
      float a = acc[i] * c_s[g];
      for (int t = 0; t < bs; ++t) a += pg[t] * to_f32(v_s[t * D + c]);
      acc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<int64_t>(b) * Hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += NTHREADS)
    ob[i] = from_f32<T>(acc[i] / l_s[i / D]);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* tables,
           const int* lens, void* out, int B, int Hq, int Hkv, int D, int bs,
           int W, int P, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t f32_bytes =
      ((static_cast<size_t>(2 * G * D + G * bs + 3 * G) * 4) + 15) / 16 * 16;
  const size_t bytes = f32_bytes + 2 * static_cast<size_t>(bs) * D * sizeof(T);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec =
      ((reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) &
       15) == 0 &&
      (static_cast<size_t>(bs) * D * sizeof(T)) % 16 == 0;
  dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), tables, lens, static_cast<T*>(out), Hq, Hkv,
      D, bs, W, P, scale, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* tables,
    const void* lens, void* out, int B, int Hq, int Hkv, int D, int bs, int W,
    int P, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  switch (dtype) {
    case PTT_F32:
      return launch<float>(q, kc, vc, t, l, out, B, Hq, Hkv, D, bs, W, P,
                           scale, s);
    case PTT_BF16:
      return launch<__nv_bfloat16>(q, kc, vc, t, l, out, B, Hq, Hkv, D, bs, W,
                                   P, scale, s);
    case PTT_F16:
      return launch<__half>(q, kc, vc, t, l, out, B, Hq, Hkv, D, bs, W, P,
                            scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
