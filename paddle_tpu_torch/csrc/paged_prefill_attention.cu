// Paged prefill attention: new-token queries over a row's cached paged
// tokens plus its own new-token window, causally, with grouped-query heads.
//
// Replaces two Pallas kernels that share one body:
// paddle_tpu/kernels/prefix_prefill.py `_prefix_prefill_kernel` (launched by
// `prefix_prefill_attention`; whole-page prefix lengths) and
// paddle_tpu/kernels/ragged_attention.py `_ragged_attention_kernel`
// (launched by `ragged_paged_attention`; token-granular cached lengths).
// The JAX wrappers differ only in how their index maps round the page count
// (down for whole-page prefixes, up for a partial last page); here a block
// walks its own table row and masks `kpos < cached_len`, which covers both.
//
// Inputs: q [B, TN, Hq, D]; window k/v [B, TN, Hkv, D]; pools
// [P, Hkv, page, D]; tables [B, W] int32 page ids; cached_lens and
// new_lens [B] int32. Window token i of row b sits at position
// cached_lens[b] + i; it sees every cached token and window tokens
// j <= i with j < new_lens[b]. Query rows i >= new_lens[b] are pad rows
// and come out as exact zeros (never NaN: a NaN there would poison the
// pages later layers read).
//
// Bound on the H100: bytes, at the serving shapes. Each block reads its
// row's cached pages once per 64-row query tile, and the rows of a tile
// are (query position, head in group) pairs of one KV head, so a page is
// read once for the whole query group; the work per byte is about
// 4 * (query positions per tile) flops, far below the bf16 ridge for
// decode-like rows and a few hundred at most for prefill tiles. The byte
// model is that of prefix_prefill.py:104-140: the pool pages the table
// names, plus q, out and the window K/V. What the design does about it:
// pages past cached_len and window keys past the tile's causal reach are
// never read, and the query group shares each K/V tile.
//
// Design (simple first): one block of four warps per (64-row query tile,
// batch row * KV head). Q, K and V tiles live in shared memory in the input
// type; each warp owns 16 query rows end to end. Scores and P V are
// computed in f32 on the CUDA cores (no tensor cores), so the numerics are
// those of the JAX body, which keeps P and V in f32
// (prefix_prefill.py:306-309): online softmax in f32 with the finite -1e30
// mask, one rounding at the output. A loop over 64-key tiles replaces the
// JAX grid's sequential kv axis: keys [0, cached_len) come from the pool
// through the table (page ids clamped into the pool, as
// paged_decode_attention.cu does), keys past them from the window. Tensor
// cores (wgmma) and double-buffered page copies are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS = BQ / NWARPS;
constexpr float NEG = -1e30f;  // the JAX kernels' finite mask value

constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T, int D>
struct Smem {
  // row pitch in elements: one 4-byte word of padding spreads the rows of a
  // column over the banks (scores read K column-wise, one key per lane)
  static constexpr int LD = D + 4 / static_cast<int>(sizeof(T));
  static constexpr size_t tile = align16(static_cast<size_t>(BQ) * LD *
                                         sizeof(T));
  static constexpr size_t q = 0;
  static constexpr size_t k = tile;
  static constexpr size_t v = 2 * tile;
  static constexpr size_t p = 3 * tile;  // f32 [NWARPS][ROWS][BK]
  static constexpr size_t bytes = p + sizeof(float) * NWARPS * ROWS * BK;
};

// 64 rows of D elements -> shared memory (pitch LD), with 16-byte global
// loads; `row_ptr(r)` is the source row or nullptr for a zero row
template <typename T, int D, typename RowPtr>
__device__ __forceinline__ void load_rows(T* dst, RowPtr row_ptr) {
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));  // elements/vector
  constexpr int VPR = D / EPV;                            // vectors/row
  constexpr int LD = Smem<T, D>::LD;
  for (int idx = threadIdx.x; idx < BQ * VPR; idx += NTHREADS) {
    const int r = idx / VPR, c = idx - r * VPR;
    const T* src = row_ptr(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + c * EPV);
    const T* e = reinterpret_cast<const T*>(&val);
    T* d = dst + r * LD + c * EPV;
#pragma unroll
    for (int i = 0; i < EPV; ++i) d[i] = e[i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) paged_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ kn,
    const T* __restrict__ vn, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ tables,
    const int* __restrict__ clens, const int* __restrict__ nlens,
    T* __restrict__ out, int TN, int Hq, int Hkv, int page, int W, int P,
    float scale) {
  using S = Smem<T, D>;
  constexpr int LD = S::LD;
  constexpr int DC = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + S::q);
  T* Ks = reinterpret_cast<T*>(smem + S::k);
  T* Vs = reinterpret_cast<T*>(smem + S::v);
  float* Ps = reinterpret_cast<float*>(smem + S::p);

  const int G = Hq / Hkv;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y - b * Hkv;
  const int flat0 = blockIdx.x * BQ;  // tile row r: flat index flat0 + r
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * ROWS;
  const int new_len = min(max(nlens[b], 0), TN);
  // tokens past the table's reach do not exist (the plain version gathers
  // exactly W * page positions)
  const int clen = min(max(clens[b], 0), W * page);
  const int q_first = flat0 / G;
  const int q_hi = min(min((flat0 + BQ - 1) / G, TN - 1), new_len - 1);

  // out row of tile row r (flat = qpos * G + g), or nullptr past TN
  auto out_row = [&](int r) -> T* {
    const int flat = flat0 + r;
    const int qpos = flat / G;
    if (qpos >= TN) return nullptr;
    return out + ((static_cast<int64_t>(b) * TN + qpos) * Hq + hk * G +
                  (flat - qpos * G)) * D;
  };

  if (q_first >= new_len) {  // every row of the tile is a pad row
    for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
      T* o = out_row(idx / D);
      if (o != nullptr) o[idx % D] = from_f32<T>(0.f);
    }
    return;
  }

  load_rows<T, D>(Qs, [&](int r) -> const T* {
    const int flat = flat0 + r;
    const int qpos = flat / G;
    if (qpos >= TN) return nullptr;
    return q + ((static_cast<int64_t>(b) * TN + qpos) * Hq + hk * G +
                (flat - qpos * G)) * D;
  });

  // key kp < clen: cached token kp (pool page tables[b, kp / page]);
  // clen <= kp < n_keys: window token kp - clen. Keys past the tile's
  // causal reach (window index > q_hi) are never read.
  const int n_keys = clen + q_hi + 1;
  const int* trow = tables + static_cast<int64_t>(b) * W;
  auto key_row = [&](const T* pool, const T* win, int kp) -> const T* {
    if (kp >= n_keys) return nullptr;
    if (kp < clen) {
      const int col = kp / page;
      const int pg = min(max(trow[col], 0), P - 1);
      return pool + ((static_cast<int64_t>(pg) * Hkv + hk) * page +
                     (kp - col * page)) * D;
    }
    return win + ((static_cast<int64_t>(b) * TN + (kp - clen)) * Hkv + hk) *
                     D;
  };

  float m_r[ROWS], l_r[ROWS], o_r[ROWS][DC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m_r[r] = NEG;
    l_r[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) o_r[r][j] = 0.f;
  }
  float* Pw = Ps + warp * ROWS * BK;
  const int n_tiles = (n_keys + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, D>(Ks, [&](int r) { return key_row(kc, kn, k0 + r); });
    load_rows<T, D>(Vs, [&](int r) { return key_row(vc, vn, k0 + r); });
    __syncthreads();

    // scores of this warp's 16 rows against keys k0 + lane, k0 + lane + 32
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    const T* ka = Ks + lane * LD;
    const T* kb = Ks + (lane + 32) * LD;
    const T* qw = Qs + row0 * LD;
    for (int d = 0; d < D; ++d) {
      const float x0 = to_f32(ka[d]), x1 = to_f32(kb[d]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = to_f32(qw[r * LD + d]);
        s[r][0] = fmaf(qv, x0, s[r][0]);
        s[r][1] = fmaf(qv, x1, s[r][1]);
      }
    }

    // mask and online softmax, row by row (the JAX `accum` recurrence)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = (flat0 + row0 + r) / G;
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = k0 + lane + 32 * c;
        const int w = kp - clen;
        const bool ok = kp < clen ||
                        (kp < n_keys && w <= qpos && w < new_len);
        v[c] = ok ? s[r][c] * scale : NEG;
      }
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(v[0], v[1])));
      const float corr = expf(m_r[r] - m_new);
      const float p0 = expf(v[0] - m_new), p1 = expf(v[1] - m_new);
      l_r[r] = l_r[r] * corr + warp_sum(p0 + p1);
      m_r[r] = m_new;
      Pw[r * BK + lane] = p0;
      Pw[r * BK + lane + 32] = p1;
#pragma unroll
      for (int j = 0; j < DC; ++j) o_r[r][j] *= corr;
    }
    __syncwarp();

    // O[rows] += P V, P and V in f32
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = to_f32(Vs[kk * LD + lane + 32 * j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = Pw[r * BK + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) o_r[r][j] = fmaf(p, vv[j], o_r[r][j]);
      }
    }
    __syncwarp();  // Pw is rewritten by the next tile's softmax
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    T* o = out_row(row0 + r);
    if (o == nullptr) continue;
    const bool live = (flat0 + row0 + r) / G < new_len;
    const float inv = live ? 1.f / (l_r[r] > 0.f ? l_r[r] : 1.f) : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      o[lane + 32 * j] = from_f32<T>(live ? o_r[r][j] * inv : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kn, const void* vn, const void* kc,
           const void* vc, const int* tables, const int* clens,
           const int* nlens, void* out, int B, int TN, int Hq, int Hkv,
           int page, int W, int P, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Smem<T, D>::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int64_t rows = static_cast<int64_t>(TN) * (Hq / Hkv);
  dim3 grid(static_cast<unsigned>((rows + BQ - 1) / BQ), B * Hkv);
  paged_prefill_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const T*>(kc),
      static_cast<const T*>(vc), tables, clens, nlens, static_cast<T*>(out),
      TN, Hq, Hkv, page, W, P, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* kn, const void* vn,
               const void* kc, const void* vc, const int* t, const int* cl,
               const int* nl, void* out, int B, int TN, int Hq, int Hkv,
               int page, int W, int P, float scale, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, kn, vn, kc, vc, t, cl, nl, out, B, TN, Hq, Hkv,
                           page, W, P, scale, s);
    case 128:
      return launch<T, 128>(q, kn, vn, kc, vc, t, cl, nl, out, B, TN, Hq, Hkv,
                            page, W, P, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* kc,
    const void* vc, const void* tables, const void* cached_lens,
    const void* new_lens, void* out, int B, int TN, int Hq, int Hkv, int D,
    int page, int W, int P, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(cached_lens);
  const int* nl = static_cast<const int*>(new_lens);
  if (B == 0 || TN == 0) return static_cast<int>(cudaGetLastError());
  switch (dtype) {
    case PTT_F32:
      return dispatch_d<float>(D, q, k_new, v_new, kc, vc, t, cl, nl, out, B,
                               TN, Hq, Hkv, page, W, P, scale, s);
    case PTT_BF16:
      return dispatch_d<__nv_bfloat16>(D, q, k_new, v_new, kc, vc, t, cl, nl,
                                       out, B, TN, Hq, Hkv, page, W, P, scale,
                                       s);
    case PTT_F16:
      return dispatch_d<__half>(D, q, k_new, v_new, kc, vc, t, cl, nl, out, B,
                                TN, Hq, Hkv, page, W, P, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
