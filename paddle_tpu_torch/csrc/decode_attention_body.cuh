// The single-query decode attention body shared by the paged kernel
// (paged_decode_attention.cu) and the contiguous-cache kernel
// (decode_attention.cu). Both walk one (sequence b, kv head h) through
// tiles of `st` cached positions; they differ only in where tile j lives,
// which a tile policy answers:
//
// - PagedTiles: page j / (bs / st) of the row's table (clamped into the
//   pool), rows (j % (bs / st)) * st onward of its [bs, D] run at
//   ((page * Hkv + h) * bs) * D; int8 pools read their scale at
//   page * Hkv + h;
// - ContigTiles: cache rows [j * st, min((j + 1) * st, max_seq)) of the
//   [B, Hkv, max_seq, D] cache; the last tile is ragged when st does not
//   divide max_seq.
//
// Positions <= lens[b] are attended (an inclusive mask: the current token
// was written at lens[b]); tiles past lens[b] are never read.
//
// Bound on the H100: bytes. Every attended K/V position is read once for
// about 4 G flops per element (G = Hq / Hkv), far below the card's
// operations-per-byte line.
//
// Design (flash-decoding):
// - The position loop is split across blocks: grid (splits, Hkv, B), each
//   block walks `tps` consecutive tiles of its row. The wrapper picks tps
//   from the row's tile count and B * Hkv (decode_split_plan in
//   kernels/decode_attention.py: about four blocks per SM of 132 SMs).
//   A split that starts past lens[b] returns at once: it reads nothing and
//   writes nothing, and the row's live splits, ceil(n_tiles(lens[b]) /
//   tps), are the only ones that count.
// - A row with one live split writes its output directly. Otherwise each
//   live split writes an f32 partial (m[G], l[G], acc[G, D]) to a scratch
//   that the wrapper allocates, and the last of them to finish (an int
//   counter per (b, h), reset to 0 by that block) merges the partials in
//   split order: deterministic, one launch, no float atomics.
// - Inside a block (eight warps): K/V tiles flow through a two-stage
//   cp.async (16-byte) ring, so the next tile loads while this one is
//   scored. Lanes hold 8-element slices of a key row (D / 8 lanes a row,
//   several rows a warp) and score up to four query heads per read of K
//   (the group's q in registers, four heads at a time), with a shuffle sum
//   over the row's lanes. The online softmax runs per query head in f32;
//   P V accumulates per (head, 8 columns), with the tile's keys split
//   between threads when the group is small, each partial sum in its own
//   f32 shared-memory row, added in a fixed order at the end. Measured
//   on the main path's cases (PERF.md): eight warps beat four, about four
//   blocks per SM beat 8 and 16, and splitting P V over all the thread
//   rows (75 KB of shared memory at G 4, D 128, bf16: two blocks per SM)
//   beat capping its partial sums to fit three blocks per SM.
// - On int8 pools the tile's k scale multiplies the f32 score after the
//   dot and the softmax scale, and its v scale multiplies the tile's f32
//   P V before it joins the running sum
//   (paddle_tpu/kernels/decode_attention.py:386-412). No value is rounded
//   to a narrower type before the output.
// - Operands: D a multiple of 8 up to 256, rows of a whole number of
//   16-byte units (int8 pools: D a multiple of 16), 16-byte aligned
//   caches; the launch returns cudaErrorInvalidValue otherwise.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "fragments.cuh"

namespace {

constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_HEADS = 4;    // query heads scored per read of K
constexpr float DEC_NEG = -1e30f;

// The 8 elements lane slice c holds of a D-element row: elements
// [8c, 8c + 8), except for f32 rows, whose slice is the two 16-byte
// chunks [4c, 4c + 4) and [D/2 + 4c, D/2 + 4c + 4), so that neighbouring
// lanes read neighbouring 16 bytes. `half_off` gives the offset of each
// four-element half; shared f32 rows of q and acc use the same halves.
template <typename KT>
__device__ __forceinline__ int half_off(int c, int half, int D) {
  if constexpr (std::is_same<KT, float>::value)
    return half ? D / 2 + 4 * c : 4 * c;
  return 8 * c + 4 * half;
}

__device__ __forceinline__ void load_slice(const float* row, int c, int D,
                                           float* x) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * c);
  const float4 b = *reinterpret_cast<const float4*>(row + D / 2 + 4 * c);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load_slice(const __nv_bfloat16* row, int c,
                                           int, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * c);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_slice(const __half* row, int c, int,
                                           float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * c);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_slice(const int8_t* row, int c, int,
                                           float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(row + 8 * c);
  const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(e[i]);
}

// lanes per key row: the power of two >= D / 8 (D <= 256)
__host__ __device__ inline int dec_lanes_per_row(int D) {
  int lpr = 1;
  while (lpr < D / 8) lpr <<= 1;
  return lpr;
}

// P V partial sums per head: tile keys split this many ways between
// thread rows when the group leaves thread rows over
__host__ __device__ inline int dec_key_splits(int G, int D) {
  const int rows = DEC_THREADS / dec_lanes_per_row(D);
  return G >= rows ? 1 : rows / G;
}

// floats of one split's partial: acc [G, D], m [G], l [G], padded to
// whole 16-byte units
__host__ __device__ inline int64_t dec_partial_floats(int G, int D) {
  return static_cast<int64_t>(G) * D + (2 * G + 3) / 4 * 4;
}

// shared memory: f32 q [G, D], acc [KS, G, D], scores [G, st], m / l /
// corr [G], the merge flag; then two stages of K and V tiles [st, D]
struct DecLayout {
  size_t q, acc, s, m, l, c, flag, kv, stage, bytes;
  __host__ __device__ DecLayout(int G, int D, int st, int kt_size) {
    const size_t gd = static_cast<size_t>(G) * D;
    q = 0;
    acc = q + gd * 4;
    s = acc + dec_key_splits(G, D) * gd * 4;
    m = s + static_cast<size_t>(G) * st * 4;
    l = m + G * 4;
    c = l + G * 4;
    flag = c + G * 4;
    kv = (flag + 4 + 15) / 16 * 16;
    stage = static_cast<size_t>(st) * D * kt_size;  // one K or V tile
    bytes = kv + 4 * stage;
  }
};

struct PagedTiles {
  const int* tables;  // [B, W] page ids
  int W, P, bs, st;
  __device__ int n_tiles(int len) const {
    return min(W * (bs / st), len / st + 1);
  }
  __device__ int rows(int) const { return st; }
  // element offset of tile j; *sidx = its scale index
  __device__ int64_t locate(int b, int h, int j, int Hkv, int D,
                            int64_t* sidx) const {
    const int per = bs / st;
    const int page = min(
        max(tables[static_cast<int64_t>(b) * W + j / per], 0), P - 1);
    *sidx = static_cast<int64_t>(page) * Hkv + h;
    return (*sidx * bs + static_cast<int64_t>(j % per) * st) * D;
  }
};

struct ContigTiles {
  int max_seq, st;
  __device__ int n_tiles(int len) const {
    return min((max_seq + st - 1) / st, len / st + 1);
  }
  __device__ int rows(int j) const { return min(st, max_seq - j * st); }
  __device__ int64_t locate(int b, int h, int j, int Hkv, int D,
                            int64_t* sidx) const {
    *sidx = 0;
    return ((static_cast<int64_t>(b) * Hkv + h) * max_seq +
            static_cast<int64_t>(j) * st) * D;
  }
};

// tile j's K and V rows into a stage (16-byte cp.async units)
template <typename KT>
__device__ __forceinline__ void start_tile_copy(KT* ks, KT* vs,
                                                const KT* kc, const KT* vc,
                                                int64_t off, int rows,
                                                int D) {
  const int n16 = rows * D * static_cast<int>(sizeof(KT)) / 16;
  const char* kg = reinterpret_cast<const char*>(kc + off);
  const char* vg = reinterpret_cast<const char*>(vc + off);
  char* kd = reinterpret_cast<char*>(ks);
  char* vd = reinterpret_cast<char*>(vs);
  for (int i = threadIdx.x; i < n16; i += DEC_THREADS) {
    cp_async16(kd + 16 * i, kg + 16 * i);
    cp_async16(vd + 16 * i, vg + 16 * i);
  }
}

// T: q / out type; KT: cache element type (T, or int8_t with scales).
// part: [B * Hkv * splits, dec_partial_floats(G, D)] f32 partials;
// counters: [B * Hkv] ints, 0 on entry and on exit.
template <typename T, typename KT, typename Tiles>
__global__ void __launch_bounds__(DEC_THREADS)
    decode_kernel(const T* __restrict__ q, const KT* __restrict__ kc,
                  const KT* __restrict__ vc, const float* __restrict__ ksc,
                  const float* __restrict__ vsc,
                  const int* __restrict__ lens, T* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ counters,
                  int Hq, int Hkv, int D, float scale, Tiles tiles,
                  int tps) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int G = Hq / Hkv;
  const int st = tiles.st;
  const int len = lens[b];
  const int n_tiles = tiles.n_tiles(len);
  const int j0 = split * tps;
  if (j0 >= n_tiles) return;   // past lens[b]: no work, no partial
  const int j1 = min(j0 + tps, n_tiles);
  const int n_live = (n_tiles + tps - 1) / tps;

  const DecLayout L(G, D, st, sizeof(KT));
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* c_s = reinterpret_cast<float*>(smem + L.c);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  KT* kv_s = reinterpret_cast<KT*>(smem + L.kv);
  const size_t stage_elems = L.stage / sizeof(KT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nsl = D / 8;                    // slices of a row
  const int lpr = dec_lanes_per_row(D);
  const int c = lane & (lpr - 1);           // this lane's slice
  const bool has = c < nsl;
  const int kpw = 32 / lpr;                 // key rows per warp pass
  const int KS = dec_key_splits(G, D);

  // the first tile's copy starts before anything else
  {
    int64_t sidx;
    const int64_t off = tiles.locate(b, h, j0, Hkv, D, &sidx);
    start_tile_copy(kv_s, kv_s + stage_elems, kc, vc, off, tiles.rows(j0), D);
    cp_async_commit();
  }
  const T* qb = q + (static_cast<int64_t>(b) * Hq + h * G) * D;
  for (int i = tid; i < G * D; i += DEC_THREADS) q_s[i] = to_f32(qb[i]);
  for (int i = tid; i < KS * G * D; i += DEC_THREADS) acc_s[i] = 0.f;
  for (int g = tid; g < G; g += DEC_THREADS) {
    m_s[g] = DEC_NEG;
    l_s[g] = 0.f;
  }

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    const KT* k_t = kv_s + 2 * buf * stage_elems;
    const KT* v_t = k_t + stage_elems;
    if (j + 1 < j1) {   // the next tile loads while this one is scored
      int64_t sidx;
      const int64_t off = tiles.locate(b, h, j + 1, Hkv, D, &sidx);
      KT* nk = kv_s + 2 * (buf ^ 1) * stage_elems;
      start_tile_copy(nk, nk + stage_elems, kc, vc, off, tiles.rows(j + 1), D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    int64_t sidx;
    tiles.locate(b, h, j, Hkv, D, &sidx);
    const int rows = tiles.rows(j);
    float k_scale = 1.f, v_scale = 1.f;
    if constexpr (Q8) {
      k_scale = ksc[sidx];
      v_scale = vsc[sidx];
    }
    __syncthreads();    // tile j (and q_s / acc_s) visible to every thread

    // scores: a key row per lpr lanes, up to four heads per read of K;
    // rows past a ragged last tile hold stale shared memory and are masked
    // without being read
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
      for (int base = warp * kpw; base < st; base += DEC_WARPS * kpw) {
        const int t = base + lane / lpr;
        const bool live = t < rows;
        float kx[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) kx[e] = 0.f;
        if (live && has) load_slice(k_t + static_cast<int64_t>(t) * D, c, D,
                                    kx);
        float d[DEC_HEADS];
#pragma unroll
        for (int i = 0; i < DEC_HEADS; ++i) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) a += qr[i][e] * kx[e];
          for (int o = lpr >> 1; o > 0; o >>= 1)
            a += __shfl_xor_sync(0xffffffffu, a, o);
          d[i] = a;
        }
        if (c == 0 && t < st) {
          const bool valid = live && j * st + t <= len;
#pragma unroll
          for (int i = 0; i < DEC_HEADS; ++i) {
            if (g0 + i >= G) break;
            float s = d[i] * scale;
            if constexpr (Q8) s = s * k_scale;
            s_s[(g0 + i) * st + t] = valid ? s : DEC_NEG;
          }
        }
      }
    }
    __syncthreads();

    // online softmax per query head
    for (int g = warp; g < G; g += DEC_WARPS) {
      float* sg = s_s + g * st;
      float mx = DEC_NEG;
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
    __syncthreads();

    // acc[ks, g] = acc * corr + (sum over this thread row's keys of p v)
    // (* v_scale on int8 pools)
    if (has) {
      for (int u = tid / lpr; u < G * KS; u += DEC_THREADS / lpr) {
        const int g = u / KS, ks = u - g * KS;
        const float* pg = s_s + g * st;
        float pv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) pv[e] = 0.f;
        for (int t = ks; t < rows; t += KS) {
          const float p = pg[t];
          float vx[8];
          load_slice(v_t + static_cast<int64_t>(t) * D, c, D, vx);
#pragma unroll
          for (int e = 0; e < 8; ++e) pv[e] += p * vx[e];
        }
        const float corr = c_s[g];
        float* a = acc_s + (static_cast<size_t>(ks) * G + g) * D;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float4* a4 = reinterpret_cast<float4*>(a + half_off<KT>(c, hf, D));
          float4 v4 = *a4;
          v4.x = v4.x * corr + pv[4 * hf] * v_scale;
          v4.y = v4.y * corr + pv[4 * hf + 1] * v_scale;
          v4.z = v4.z * corr + pv[4 * hf + 2] * v_scale;
          v4.w = v4.w * corr + pv[4 * hf + 3] * v_scale;
          *a4 = v4;
        }
      }
    }
    __syncthreads();    // this stage is consumed before it is refilled
  }

  // the thread rows' partial sums, added in a fixed order
  for (int i = tid; i < G * D; i += DEC_THREADS) {
    float a = acc_s[i];
    for (int ks = 1; ks < KS; ++ks)
      a += acc_s[static_cast<size_t>(ks) * G * D + i];
    acc_s[i] = a;
  }
  __syncthreads();
  const int64_t row = static_cast<int64_t>(b) * Hkv + h;
  T* ob = out + (static_cast<int64_t>(b) * Hq + h * G) * D;
  if (n_live == 1) {
    for (int i = tid; i < G * D; i += DEC_THREADS)
      ob[i] = from_f32<T>(acc_s[i] / l_s[i / D]);
    return;
  }

  // write this split's partial (acc [G, D], then m [G] and l [G]); the
  // last live split merges them all
  const int GD = G * D;
  const int64_t pstride = dec_partial_floats(G, D);
  float* mine = part + (row * splits + split) * pstride;
  for (int i4 = tid; i4 < GD / 4; i4 += DEC_THREADS)
    reinterpret_cast<float4*>(mine)[i4] =
        reinterpret_cast<const float4*>(acc_s)[i4];
  for (int g = tid; g < G; g += DEC_THREADS) {
    mine[GD + g] = m_s[g];
    mine[GD + G + g] = l_s[g];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(counters + row, 1);
    *flag = done == n_live - 1;
    if (*flag) counters[row] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // per head, one warp reads the splits' m and l in parallel: M = max m,
  // L = sum exp(m - M) l (a fixed shuffle tree: deterministic)
  const float* rp = part + row * splits * pstride;
  for (int g = warp; g < G; g += DEC_WARPS) {
    float mx = DEC_NEG;
    for (int sp = lane; sp < n_live; sp += 32)
      mx = fmaxf(mx, __ldcg(rp + sp * pstride + GD + g));
    mx = warp_max(mx);
    float ls = 0.f;
    for (int sp = lane; sp < n_live; sp += 32) {
      const float* ps = rp + sp * pstride + GD;
      ls += expf(__ldcg(ps + g) - mx) * __ldcg(ps + G + g);
    }
    ls = warp_sum(ls);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = ls;
    }
  }
  __syncthreads();
  // out = sum over splits, in split order, of exp(m - M) acc, over L; four
  // columns of one head per thread, the splits' loads independent
  for (int i4 = tid; i4 < GD / 4; i4 += DEC_THREADS) {
    const int g = 4 * i4 / D;
    const float mx = m_s[g];
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < n_live; ++sp) {
      const float* ps = rp + sp * pstride;
      const float w = expf(__ldcg(ps + GD + g) - mx);
      const float4 a4 = __ldcg(reinterpret_cast<const float4*>(ps) + i4);
      o.x += w * a4.x;
      o.y += w * a4.y;
      o.z += w * a4.z;
      o.w += w * a4.w;
    }
    const float ls = l_s[g];
    T* o4 = ob + 4 * i4;
    o4[0] = from_f32<T>(o.x / ls);
    o4[1] = from_f32<T>(o.y / ls);
    o4[2] = from_f32<T>(o.z / ls);
    o4[3] = from_f32<T>(o.w / ls);
  }
}

inline bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// grid (splits, Hkv, B); `tps` tiles per split. part / counters may be
// null when splits == 1.
template <typename T, typename KT, typename Tiles>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const float* ksc, const float* vsc, const int* lens,
                  void* out, float* part, int* counters, int B, int Hq,
                  int Hkv, int D, float scale, Tiles tiles, int tps,
                  int splits, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (D % 8 || D > 256 || (D * sizeof(KT)) % 16 || !aligned16(kc, vc) ||
      tiles.st <= 0 || tps <= 0 || splits <= 0 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = DecLayout(G, D, tiles.st, sizeof(KT)).bytes;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, KT, Tiles>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(splits, Hkv, B);
  decode_kernel<T, KT, Tiles><<<grid, DEC_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), ksc, vsc, lens, static_cast<T*>(out), part,
      counters, Hq, Hkv, D, scale, tiles, tps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
