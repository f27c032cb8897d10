// Paged prefill attention: new-token queries over a row's cached paged
// tokens plus its own new-token window, causally, with grouped-query heads,
// over bf16 (f32, f16) pools or int8 pools with per-(page, kv head) f32
// scales.
//
// Replaces four Pallas kernels that share one body:
// paddle_tpu/kernels/prefix_prefill.py `_prefix_prefill_kernel` (launched by
// `prefix_prefill_attention`; whole-page prefix lengths) and
// paddle_tpu/kernels/ragged_attention.py `_ragged_attention_kernel`
// (launched by `ragged_paged_attention`; token-granular cached lengths),
// and their int8-pool twins `_prefix_prefill_q8_kernel` and
// `_ragged_attention_q8_kernel`. The JAX wrappers differ only in how their
// index maps round the page count (down for whole-page prefixes, up for a
// partial last page); here a block walks its own table row and masks
// `kpos < cached_len`, which covers both.
//
// Inputs: q [B, TN, Hq, D]; window k/v [B, TN, Hkv, D]; pools
// [P, Hkv, page, D]; tables [B, W] int32 page ids; cached_lens and
// new_lens [B] int32. Window token i of row b sits at position
// cached_lens[b] + i; it sees every cached token and window tokens
// j <= i with j < new_lens[b]. Query rows i >= new_lens[b] are pad rows
// and come out as exact zeros (never NaN: a NaN there would poison the
// pages later layers read). int8 pools come with k/v scales [P, Hkv] f32:
// a stored value x of page p, kv head h stands for x * scale[p, h]; the
// window K/V are never quantized.
//
// Bound on the H100: bytes, at the serving shapes. Each block reads its
// row's cached pages once per 64-row query tile, and the rows of a tile
// are (query position, head in group) pairs of one KV head, so a page is
// read once for the whole query group; the work per byte is about
// 4 * (query positions per tile) flops, far below the bf16 ridge for
// decode-like rows and a few hundred at most for prefill tiles. The byte
// model is that of prefix_prefill.py:104-140: the pool pages the table
// names (1 byte per element plus 8 bytes of scales per page and kv head on
// int8 pools), plus q, out and the window K/V. What the design does about
// it: pages past cached_len and window keys past the tile's causal reach
// are never read, and the query group shares each K/V tile.
//
// Design (simple first): one block of four warps per (64-row query tile,
// batch row * KV head); each warp owns 16 query rows end to end. Two
// phases of 64-key tiles replace the JAX grid's sequential kv axis, as the
// JAX body has a prefix phase and a suffix phase: cached keys [0,
// cached_len) from the pool through the table (page ids clamped into the
// pool, as paged_decode_attention.cu does), then window keys up to the
// tile's causal reach. Every tile thus holds one element type and lives in
// shared memory in that type: Q and window tiles in the input type, pool
// tiles in the pool's (int8 bytes on int8 pools, with a per-key f32 scale
// vector beside them: a 64-key tile crosses pages when page != 64, so the
// scale is looked up per key row, from its own page). Scores and P V are
// computed in f32 on the CUDA cores (no tensor cores), so the numerics are
// those of the JAX body, which keeps P and V in f32
// (prefix_prefill.py:306-331): an int8 key's scale multiplies its f32
// score after the dot and the softmax scale, an int8 value is widened to
// f32 and multiplied by its scale inside the P V loop, and no value is
// dequantized into a narrower type; online softmax in f32 with the finite
// -1e30 mask, one rounding at the output. Tensor cores (wgmma) and
// double-buffered page copies are later work.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS = BQ / NWARPS;
constexpr float NEG = -1e30f;  // the JAX kernels' finite mask value

constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// row pitch in elements of type E: one 4-byte word of padding spreads the
// rows of a column over the banks (scores read K column-wise, one key per
// lane)
template <typename E, int D>
__host__ __device__ constexpr int pitch() {
  return D + 4 / static_cast<int>(sizeof(E));
}

template <typename T, int D>
struct Smem {
  // every tile is sized for the input type T, the widest it holds (an
  // int8 pool tile uses the first part of its slot)
  static constexpr size_t tile = align16(static_cast<size_t>(BQ) *
                                         pitch<T, D>() * sizeof(T));
  static constexpr size_t q = 0;
  static constexpr size_t k = tile;
  static constexpr size_t v = 2 * tile;
  static constexpr size_t p = 3 * tile;  // f32 [NWARPS][ROWS][BK]
  static constexpr size_t sc = p + sizeof(float) * NWARPS * ROWS * BK;
  static constexpr size_t bytes = sc + 2 * sizeof(float) * BK;  // k/v scales
};

// 64 rows of D elements -> shared memory (pitch<E, D>), with 16-byte global
// loads; `row_ptr(r)` is the source row or nullptr for a zero row
template <typename E, int D, typename RowPtr>
__device__ __forceinline__ void load_rows(E* dst, RowPtr row_ptr) {
  constexpr int EPV = 16 / static_cast<int>(sizeof(E));  // elements/vector
  constexpr int VPR = D / EPV;                            // vectors/row
  constexpr int LD = pitch<E, D>();
  for (int idx = threadIdx.x; idx < BQ * VPR; idx += NTHREADS) {
    const int r = idx / VPR, c = idx - r * VPR;
    const E* src = row_ptr(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + c * EPV);
    const E* e = reinterpret_cast<const E*>(&val);
    E* d = dst + r * LD + c * EPV;
#pragma unroll
    for (int i = 0; i < EPV; ++i) d[i] = e[i];
  }
}

// One 64-key tile of the online softmax for this warp's ROWS query rows
// (the JAX `accum` recurrence). Ks / Vs: the tile in element type E;
// ksc / vsc: per-key f32 scales (SCALED: int8 pool tiles); ok(r, c):
// whether row r of the warp sees key c of the tile.
template <typename T, typename E, int D, bool SCALED, typename Ok>
__device__ __forceinline__ void tile_step(
    const T* qw, const E* Ks, const E* Vs, const float* ksc,
    const float* vsc, float* Pw, float scale, Ok ok, float (&m_r)[ROWS],
    float (&l_r)[ROWS], float (&o_r)[ROWS][D / 32]) {
  constexpr int LQ = pitch<T, D>();
  constexpr int LK = pitch<E, D>();
  constexpr int DC = D / 32;  // output columns per lane
  const int lane = threadIdx.x & 31;

  // scores of this warp's 16 rows against keys lane, lane + 32
  float s[ROWS][2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
  const E* ka = Ks + lane * LK;
  const E* kb = Ks + (lane + 32) * LK;
  for (int d = 0; d < D; ++d) {
    const float x0 = to_f32(ka[d]), x1 = to_f32(kb[d]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float qv = to_f32(qw[r * LQ + d]);
      s[r][0] = fmaf(qv, x0, s[r][0]);
      s[r][1] = fmaf(qv, x1, s[r][1]);
    }
  }
  float kscale[2] = {1.f, 1.f};
  if constexpr (SCALED) {
    kscale[0] = ksc[lane];
    kscale[1] = ksc[lane + 32];
  }

  // mask and online softmax, row by row
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float v[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x = s[r][c] * scale;
      if constexpr (SCALED) x = x * kscale[c];
      v[c] = ok(r, lane + 32 * c) ? x : NEG;
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

  // O[rows] += P V, P and V in f32 (an int8 value times its key's scale)
  for (int kk = 0; kk < BK; ++kk) {
    float vv[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      vv[j] = to_f32(Vs[kk * LK + lane + 32 * j]);
      if constexpr (SCALED) vv[j] = vv[j] * vsc[kk];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float p = Pw[r * BK + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) o_r[r][j] = fmaf(p, vv[j], o_r[r][j]);
    }
  }
  __syncwarp();  // Pw is rewritten by the next tile's softmax
}

// T: q / window / out type; PT: pool element type (T, or int8_t with
// scales)
template <typename T, typename PT, int D>
__global__ void __launch_bounds__(NTHREADS) paged_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ kn,
    const T* __restrict__ vn, const PT* __restrict__ kc,
    const PT* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ clens, const int* __restrict__ nlens,
    T* __restrict__ out, int TN, int Hq, int Hkv, int page, int W, int P,
    float scale) {
  using S = Smem<T, D>;
  constexpr bool Q8 = std::is_same<PT, int8_t>::value;
  constexpr int LQ = pitch<T, D>();
  constexpr int DC = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + S::q);
  float* Ps = reinterpret_cast<float*>(smem + S::p);
  float* Ksc = reinterpret_cast<float*>(smem + S::sc);  // [BK]
  float* Vsc = Ksc + BK;                                // [BK]

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

  float m_r[ROWS], l_r[ROWS], o_r[ROWS][DC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m_r[r] = NEG;
    l_r[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) o_r[r][j] = 0.f;
  }
  float* Pw = Ps + warp * ROWS * BK;
  const T* qw = Qs + row0 * LQ;

  // ---- cached phase: keys [0, clen) from the pool, page tables[b, kp /
  // page]; a tile's keys past clen are zero rows and masked
  const int* trow = tables + static_cast<int64_t>(b) * W;
  auto pool_page = [&](int kp) {
    return min(max(trow[kp / page], 0), P - 1);
  };
  auto pool_row = [&](const PT* pool, int kp) -> const PT* {
    if (kp >= clen) return nullptr;
    return pool + ((static_cast<int64_t>(pool_page(kp)) * Hkv + hk) * page +
                   kp % page) * D;
  };
  PT* Kp = reinterpret_cast<PT*>(smem + S::k);
  PT* Vp = reinterpret_cast<PT*>(smem + S::v);
  for (int k0 = 0; k0 < clen; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<PT, D>(Kp, [&](int r) { return pool_row(kc, k0 + r); });
    load_rows<PT, D>(Vp, [&](int r) { return pool_row(vc, k0 + r); });
    if constexpr (Q8) {
      for (int r = threadIdx.x; r < BK; r += NTHREADS) {
        const int kp = k0 + r;
        const int64_t at =
            kp < clen ? static_cast<int64_t>(pool_page(kp)) * Hkv + hk : -1;
        Ksc[r] = at >= 0 ? ksc[at] : 0.f;
        Vsc[r] = at >= 0 ? vsc[at] : 0.f;
      }
    }
    __syncthreads();
    tile_step<T, PT, D, Q8>(qw, Kp, Vp, Ksc, Vsc, Pw, scale,
                            [&](int, int c) { return k0 + c < clen; }, m_r,
                            l_r, o_r);
  }

  // ---- window phase: window keys [0, q_hi] (the tile's causal reach),
  // key j visible to query position qpos iff j <= qpos and j < new_len
  const int n_win = q_hi + 1;
  T* Kw = reinterpret_cast<T*>(smem + S::k);
  T* Vw = reinterpret_cast<T*>(smem + S::v);
  auto win_row = [&](const T* win, int j) -> const T* {
    if (j >= n_win) return nullptr;
    return win + ((static_cast<int64_t>(b) * TN + j) * Hkv + hk) * D;
  };
  for (int w0 = 0; w0 < n_win; w0 += BK) {
    __syncthreads();
    load_rows<T, D>(Kw, [&](int r) { return win_row(kn, w0 + r); });
    load_rows<T, D>(Vw, [&](int r) { return win_row(vn, w0 + r); });
    __syncthreads();
    tile_step<T, T, D, false>(
        qw, Kw, Vw, nullptr, nullptr, Pw, scale,
        [&](int r, int c) {
          const int j = w0 + c;
          const int qpos = (flat0 + row0 + r) / G;
          return j < n_win && j <= qpos && j < new_len;
        },
        m_r, l_r, o_r);
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

template <typename T, typename PT, int D>
int launch(const void* q, const void* kn, const void* vn, const void* kc,
           const void* vc, const float* ksc, const float* vsc,
           const int* tables, const int* clens, const int* nlens, void* out,
           int B, int TN, int Hq, int Hkv, int page, int W, int P,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = Smem<T, D>::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, PT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int64_t rows = static_cast<int64_t>(TN) * (Hq / Hkv);
  dim3 grid(static_cast<unsigned>((rows + BQ - 1) / BQ), B * Hkv);
  paged_prefill_kernel<T, PT, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const PT*>(kc),
      static_cast<const PT*>(vc), ksc, vsc, tables, clens, nlens,
      static_cast<T*>(out), TN, Hq, Hkv, page, W, P, scale);
  return static_cast<int>(cudaGetLastError());
}

struct Args {
  const void *q, *kn, *vn, *kc, *vc;
  const float *ksc, *vsc;
  const int *t, *cl, *nl;
  void* out;
  int B, TN, Hq, Hkv, page, W, P;
  float scale;
  cudaStream_t s;
};

template <typename T, typename PT>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 64:
      return launch<T, PT, 64>(a.q, a.kn, a.vn, a.kc, a.vc, a.ksc, a.vsc,
                               a.t, a.cl, a.nl, a.out, a.B, a.TN, a.Hq,
                               a.Hkv, a.page, a.W, a.P, a.scale, a.s);
    case 128:
      return launch<T, PT, 128>(a.q, a.kn, a.vn, a.kc, a.vc, a.ksc, a.vsc,
                                a.t, a.cl, a.nl, a.out, a.B, a.TN, a.Hq,
                                a.Hkv, a.page, a.W, a.P, a.scale, a.s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Q8 = false: the pools have q's type; Q8 = true: int8 pools with scales
template <bool Q8>
int dispatch(int dtype, int D, const Args& a) {
  using PF = typename std::conditional<Q8, int8_t, float>::type;
  using PB = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  using PH = typename std::conditional<Q8, int8_t, __half>::type;
  if (a.B == 0 || a.TN == 0) return static_cast<int>(cudaGetLastError());
  switch (dtype) {
    case PTT_F32:
      return dispatch_d<float, PF>(D, a);
    case PTT_BF16:
      return dispatch_d<__nv_bfloat16, PB>(D, a);
    case PTT_F16:
      return dispatch_d<__half, PH>(D, a);
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
  const Args a{q, k_new, v_new, kc, vc, nullptr, nullptr,
               static_cast<const int*>(tables),
               static_cast<const int*>(cached_lens),
               static_cast<const int*>(new_lens), out, B, TN, Hq, Hkv, page,
               W, P, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, D, a);
}

// int8 pools with f32 scales [P, Hkv]; `dtype` is the type of q, the
// window k/v and out
extern "C" int paged_prefill_attention_q8_launch(
    const void* q, const void* k_new, const void* v_new, const void* kc,
    const void* vc, const void* k_scale, const void* v_scale,
    const void* tables, const void* cached_lens, const void* new_lens,
    void* out, int B, int TN, int Hq, int Hkv, int D, int page, int W, int P,
    float scale, int dtype, void* stream) {
  const Args a{q, k_new, v_new, kc, vc, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tables),
               static_cast<const int*>(cached_lens),
               static_cast<const int*>(new_lens), out, B, TN, Hq, Hkv, page,
               W, P, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, D, a);
}
