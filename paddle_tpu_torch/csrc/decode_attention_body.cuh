// The single-query decode attention body shared by the paged kernel
// (paged_decode_attention.cu) and the contiguous-cache kernel
// (decode_attention.cu). Both walk one (sequence b, kv head h) through
// tiles of `bs` cached positions; they differ only in where tile j lives,
// which a tile policy answers:
//
// - PagedTiles: tile j is pool page tables[b, j] (clamped into the pool),
//   a [bs, D] run at ((page * Hkv + h) * bs) * D; int8 pools read their
//   scale at page * Hkv + h;
// - ContigTiles: tile j is cache rows [j * bs, min((j + 1) * bs, max_seq))
//   of the [B, Hkv, max_seq, D] cache, at ((b * Hkv + h) * max_seq +
//   j * bs) * D; the last tile is ragged when bs does not divide max_seq.
//
// Positions <= lens[b] are attended (an inclusive mask: the current token
// was written at lens[b]); tiles past lens[b] are never read.
//
// Per block (four warps): copy one tile of K and V for the kv head (in the
// cache's own type; 16-byte loads where aligned) into shared memory, score
// the whole query group against it (one warp per (query head, key) dot
// product, warp-shuffle sum), run the online softmax in f32 per query head,
// and accumulate P V in an f32 shared-memory accumulator. On int8 pools the
// tile's k scale multiplies the f32 score after the dot and the softmax
// scale, and its v scale multiplies the tile's f32 P V before it joins the
// running accumulator (paddle_tpu/kernels/decode_attention.py:386-412). No
// value is rounded to a narrower type before the output.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int DEC_THREADS = 128;
constexpr float DEC_NEG = -1e30f;

template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int n,
                                          bool vec) {
  if (vec) {
    const int nv = n * static_cast<int>(sizeof(T)) / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < nv; i += DEC_THREADS) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += DEC_THREADS) dst[i] = src[i];
  }
}

__host__ __device__ constexpr size_t dec_f32_region(int G, int D, int bs) {
  return ((static_cast<size_t>(2 * G * D + G * bs + 3 * G) * 4) + 15) / 16 *
         16;
}

struct PagedTiles {
  const int* tables;  // [B, W] page ids
  int W, P, bs;
  __device__ int n_tiles(int len) const { return min(W, len / bs + 1); }
  __device__ int rows(int) const { return bs; }
  // element offset of tile j; *sidx = its scale index
  __device__ int64_t locate(int b, int h, int j, int Hkv, int D,
                            int64_t* sidx) const {
    const int page =
        min(max(tables[static_cast<int64_t>(b) * W + j], 0), P - 1);
    *sidx = static_cast<int64_t>(page) * Hkv + h;
    return *sidx * bs * D;
  }
};

struct ContigTiles {
  int max_seq, bs;
  __device__ int n_tiles(int len) const {
    return min((max_seq + bs - 1) / bs, len / bs + 1);
  }
  __device__ int rows(int j) const { return min(bs, max_seq - j * bs); }
  __device__ int64_t locate(int b, int h, int j, int Hkv, int D,
                            int64_t* sidx) const {
    *sidx = 0;
    return ((static_cast<int64_t>(b) * Hkv + h) * max_seq +
            static_cast<int64_t>(j) * bs) * D;
  }
};

// T: q / out type; KT: cache element type (T, or int8_t with scales)
template <typename T, typename KT, typename Tiles>
__global__ void __launch_bounds__(DEC_THREADS)
    decode_kernel(const T* __restrict__ q, const KT* __restrict__ kc,
                  const KT* __restrict__ vc, const float* __restrict__ ksc,
                  const float* __restrict__ vsc,
                  const int* __restrict__ lens, T* __restrict__ out, int Hq,
                  int Hkv, int D, float scale, Tiles tiles, int vec) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = Hq / Hkv;
  const int bs = tiles.bs;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [G, D]
  float* acc = q_s + G * D;                     // [G, D]
  float* s_s = acc + G * D;                     // [G, bs] scores, then p
  float* m_s = s_s + G * bs;                    // [G]
  float* l_s = m_s + G;                         // [G]
  float* c_s = l_s + G;                         // [G]
  KT* k_s = reinterpret_cast<KT*>(smem + dec_f32_region(G, D, bs));
  KT* v_s = k_s + bs * D;                       // [bs, D] each

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NW = DEC_THREADS / 32;
  const int len = lens[b];
  const int n_tiles = tiles.n_tiles(len);
  const T* qb = q + (static_cast<int64_t>(b) * Hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += DEC_THREADS) {
    q_s[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += DEC_THREADS) {
    m_s[g] = DEC_NEG;
    l_s[g] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    int64_t sidx;
    const int64_t off = tiles.locate(b, h, j, Hkv, D, &sidx);
    const int rows = tiles.rows(j);
    float k_scale = 1.f, v_scale = 1.f;
    if constexpr (Q8) {
      k_scale = ksc[sidx];
      v_scale = vsc[sidx];
    }
    __syncthreads();  // previous tile fully consumed (and q_s/acc ready)
    copy_tile(k_s, kc + off, rows * D, vec);
    copy_tile(v_s, vc + off, rows * D, vec);
    __syncthreads();

    // scores: one warp per (query head g, key t); rows past a ragged last
    // tile hold stale shared memory and are masked without being read
    for (int idx = warp; idx < G * bs; idx += NW) {
      const int g = idx / bs, t = idx - g * bs;
      if (t >= rows) {
        if (lane == 0) s_s[idx] = DEC_NEG;
        continue;
      }
      const float* qg = q_s + g * D;
      const KT* kt = k_s + t * D;
      float d = 0.f;
      for (int c = lane; c < D; c += 32) d += qg[c] * to_f32(kt[c]);
      d = warp_sum(d);
      float s = d * scale;
      if constexpr (Q8) s = s * k_scale;
      if (lane == 0) s_s[idx] = (j * bs + t <= len) ? s : DEC_NEG;
    }
    __syncthreads();

    // online softmax per query head
    for (int g = warp; g < G; g += NW) {
      float* sg = s_s + g * bs;
      float mx = DEC_NEG;
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

    // acc = acc * corr + P V (int8: + (P V) * v_scale, the tile's f32 sum)
    for (int i = threadIdx.x; i < G * D; i += DEC_THREADS) {
      const int g = i / D, c = i - g * D;
      const float* pg = s_s + g * bs;
      if constexpr (Q8) {
        float pv = 0.f;
        for (int t = 0; t < rows; ++t) pv += pg[t] * to_f32(v_s[t * D + c]);
        acc[i] = acc[i] * c_s[g] + pv * v_scale;
      } else {
        float a = acc[i] * c_s[g];
        for (int t = 0; t < rows; ++t) a += pg[t] * to_f32(v_s[t * D + c]);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<int64_t>(b) * Hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += DEC_THREADS)
    ob[i] = from_f32<T>(acc[i] / l_s[i / D]);
}

// one block per (sequence, kv head); `vec`: every tile starts 16-byte
// aligned and spans whole 16-byte units
template <typename T, typename KT, typename Tiles>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const float* ksc, const float* vsc, const int* lens,
                  void* out, int B, int Hq, int Hkv, int D, float scale,
                  Tiles tiles, bool vec, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t bytes = dec_f32_region(G, D, tiles.bs) +
                       2 * static_cast<size_t>(tiles.bs) * D * sizeof(KT);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, KT, Tiles>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(B, Hkv);
  decode_kernel<T, KT, Tiles><<<grid, DEC_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), ksc, vsc, lens, static_cast<T*>(out), Hq,
      Hkv, D, scale, tiles, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

}  // namespace
