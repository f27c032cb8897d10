// Paged prefill attention: new-token queries over a row's cached paged
// tokens plus its own new-token window, causally, with grouped-query heads,
// over bf16 (f16, f32) pools or int8 pools with per-(page, kv head) f32
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
// window K/V are never quantized. Pages of any size; D 64 or 128.
//
// Bound on the H100: bytes, at the serving shapes. The rows of a 64-row
// tile are (query position, head in group) pairs of one KV head, so a K/V
// tile is read once for the whole query group; the work per byte is about
// 4 * (query positions per tile) flops, below the bf16 ridge. The byte
// model is that of prefix_prefill.py:104-140: the pool pages the table
// names (1 byte per element plus 8 bytes of scales per page and kv head on
// int8 pools), plus q, out and the window K/V. What the design does about
// it: pages past cached_len and window keys past the tile's causal reach
// are never read, and the query group shares each K/V tile.
//
// Design, bf16 and f16 operands (the serving path): the register-resident
// tile body of csrc/attention_tile.cuh (shared with the flash forward) in
// blocks of four warps, one per (64-row tile, split, batch row * KV head);
// each warp owns 16 rows end to end. Two phases of 64-key tiles replace the
// JAX grid's sequential kv axis: cached keys [0, cached_len) from the pool
// through the table (page ids clamped into the pool, as
// paged_decode_attention.cu does; a 64-key tile may cross pages, so the
// page, and on int8 pools the scales, are looked up per key row), then
// window keys up to the tile's causal reach. Tiles arrive in a ring of two
// stages, one block barrier a tile: bf16 / f16 rows by cp.async; int8 rows
// into registers before the current tile's products and, after them,
// widened exactly to the input type (|x| <= 127) into the free stage, with
// their scales. Numerics, against the JAX body, which keeps P and V in f32
// (prefix_prefill.py:306-331): Q K^T on mma.sync (16-bit products are exact
// in f32; only the order of summation changes), an int8 key's scale
// multiplies its f32 logit after the softmax scale, an int8 value's scale
// multiplies p in f32, and P V runs as two products, hi = T(p) and
// lo = T(p - hi), so P keeps about 16 bits (bf16) and V is the pool's own
// values; online softmax in f32 with the finite -1e30 mask, one rounding at
// the output. A warp whose 16 rows are all pad rows skips the products (a
// decode-like row, new_len 1 with a group of 4, costs one warp), and a
// warp skips window tiles past its last live row. When the grid is small
// (prefill_split_plan in kernels/decode_attention.py, from the shapes on
// the host), the cached phase is split across blocks: split s walks cached
// tiles [s tps, (s + 1) tps), split 0 also the window; splits past
// cached_len exit before reading. Each live split of a row tile writes f32
// partials (acc, m, l) to scratch, and the last to finish (an int counter
// per row tile, reset by that block) merges them in split order: one
// launch, deterministic, no float atomics (the scheme of
// decode_attention_body.cuh).
//
// f32 operands (on no main path; the card tests hold them at 1e-5) keep
// the first design, by dtype: one block of four warps per (64-row tile,
// batch row * KV head), scores and P V in f32 on the CUDA cores, K/V tiles
// loaded synchronously into shared memory, no split.
#include <type_traits>

#include "attention_tile.cuh"

namespace {

constexpr int BQ = 64;        // rows of a tile (16 per warp)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

// ===========================================================================
// bf16 / f16: tensor cores, cp.async ring, split cached phase
// ===========================================================================

// partial of one split of a row tile: acc [BQ, D], m [BQ], l [BQ] (f32)
template <int D>
__host__ __device__ constexpr int64_t partial_floats() {
  return int64_t(BQ) * D + 2 * BQ;
}

template <typename T, int D>
struct MmaLayout {
  static constexpr int LDH = D + 8;
  static constexpr size_t TILE = size_t(ATT_BK) * LDH * sizeof(T);
  static constexpr size_t stage0 = TILE;  // Q first; stage i: K, then V
  static constexpr size_t sc = stage0 + 4 * TILE;  // f32 [2][k, v][64]
  static constexpr size_t flag = sc + 2 * 2 * ATT_BK * sizeof(float);
  static constexpr size_t bytes = flag + 16;
};

// 16 int8 values -> 16 T values (exact), 32 bytes at dst
template <typename T>
__device__ __forceinline__ void widen16(T* dst, const uint4& v) {
  const int8_t* x = reinterpret_cast<const int8_t*>(&v);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack2<T>(static_cast<float>(x[2 * i]),
                    static_cast<float>(x[2 * i + 1]));
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// T: q / window / out type (bf16 or f16); PT: pool element type (T, or
// int8_t with scales). part / counters: the split scratch (unused when
// gridDim.y == 1); counters are 0 on entry and on exit.
template <typename T, typename PT, int D>
__global__ void __launch_bounds__(NTHREADS, 2) paged_prefill_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ kn,
    const T* __restrict__ vn, const PT* __restrict__ kc,
    const PT* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ clens, const int* __restrict__ nlens,
    T* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
    int TN, int Hq, int Hkv, int page, int W, int P, float scale, int tps) {
  using L = MmaLayout<T, D>;
  constexpr bool Q8 = std::is_same<PT, int8_t>::value;
  constexpr int LDH = L::LDH;
  constexpr int EPV = 16 / sizeof(T);      // T elements per 16 bytes
  constexpr int NCH = ATT_BK * D / 16 / NTHREADS;  // int8 16-byte units
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  int* flag = reinterpret_cast<int*>(smem + L::flag);
  auto kstage = [&](int i) {
    return reinterpret_cast<T*>(smem + L::stage0 + (i & 1) * 2 * L::TILE);
  };
  auto sstage = [&](int i) {
    return reinterpret_cast<float*>(smem + L::sc) + (i & 1) * 2 * ATT_BK;
  };

  const int G = Hq / Hkv;
  const int qt = blockIdx.x, split = blockIdx.y, bkv = blockIdx.z;
  const int splits = gridDim.y;
  const int b = bkv / Hkv, hk = bkv - b * Hkv;
  const int flat0 = qt * BQ;  // tile row r: flat index flat0 + r
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int new_len = min(max(nlens[b], 0), TN);
  // tokens past the table's reach do not exist (the plain version gathers
  // exactly W * page positions)
  const int clen = min(max(clens[b], 0), W * page);

  // element offset of tile row r's out / q row, or -1 past TN
  auto row_off = [&](int r) -> int64_t {
    const int flat = flat0 + r;
    const int qpos = flat / G;
    if (qpos >= TN) return -1;
    return ((static_cast<int64_t>(b) * TN + qpos) * Hq + hk * G +
            (flat - qpos * G)) * D;
  };

  if (flat0 / G >= new_len) {  // every row of the tile is a pad row
    if (split == 0)
      for (int idx = tid; idx < BQ * (D / EPV); idx += NTHREADS) {
        const int64_t off = row_off(idx / (D / EPV));
        if (off >= 0)
          reinterpret_cast<uint4*>(out + off)[idx % (D / EPV)] =
              make_uint4(0u, 0u, 0u, 0u);
      }
    return;
  }
  const int n_c = (clen + ATT_BK - 1) / ATT_BK;  // the row's cached tiles
  const int c_lo = split * tps;
  if (split > 0 && c_lo >= n_c) return;  // past cached_len: no partial
  const int n_cs = max(min(c_lo + tps, n_c) - c_lo, 0);
  const int n_live = max(1, (n_c + tps - 1) / tps);
  // window keys [0, n_win): the tile's causal reach
  const int n_win = min(min((flat0 + BQ - 1) / G, TN - 1), new_len - 1) + 1;
  const int n_it = n_cs + (split == 0 ? (n_win + ATT_BK - 1) / ATT_BK : 0);

  // the warp's rows: live if its first row is; its last live position
  const int wflat = flat0 + warp * 16;
  const bool w_live = wflat / G < new_len;
  const int w_qhi = min(min((wflat + 15) / G, TN - 1), new_len - 1);
  int qpos[2];  // this lane's rows: tile rows warp * 16 + g (+ 8)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = (wflat + g + 8 * hh) / G;

  const int* trow = tables + static_cast<int64_t>(b) * W;
  auto page_of = [&](int kp) { return min(max(trow[kp / page], 0), P - 1); };
  auto pool_off = [&](int kp) -> int64_t {
    return ((static_cast<int64_t>(page_of(kp)) * Hkv + hk) * page +
            kp % page) * D;
  };

  // Q rows of live positions (zeros for pad rows and rows past TN)
  for (int idx = tid; idx < BQ * (D / EPV); idx += NTHREADS) {
    const int r = idx / (D / EPV), c = idx - r * (D / EPV);
    const int flat = flat0 + r, qp = flat / G;
    const bool ok = qp < new_len;
    const T* src = ok ? q + ((static_cast<int64_t>(b) * TN + qp) * Hq +
                             hk * G + (flat - qp * G)) * D + c * EPV
                      : q;
    cp_async16(Qs + r * LDH + c * EPV, src, ok);
  }

  // int8 tiles in flight in registers (Q8), with this thread's scale
  uint4 kr[NCH > 0 ? NCH : 1], vr[NCH > 0 ? NCH : 1];
  float scr = 0.f;

  // start tile `it` into stage it & 1 (int8 cached tiles: into registers)
  auto start_tile = [&](int it) {
    T* Kd = kstage(it);
    T* Vd = Kd + ATT_BK * LDH;
    if (it < n_cs) {
      const int k0 = (c_lo + it) * ATT_BK;
      if constexpr (Q8) {
        constexpr int VPR = D / 16;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int idx = tid + i * NTHREADS;
          const int r = idx / VPR, c = idx - r * VPR;
          const int kp = k0 + r;
          kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
          if (kp < clen) {
            const int64_t off = pool_off(kp) + c * 16;
            kr[i] = __ldg(reinterpret_cast<const uint4*>(kc + off));
            vr[i] = __ldg(reinterpret_cast<const uint4*>(vc + off));
          }
        }
        // threads 0..63: the k scale of key tid; 64..127: the v scale
        const int kp = k0 + (tid & (ATT_BK - 1));
        scr = 0.f;
        if (kp < clen) {
          const int64_t at = static_cast<int64_t>(page_of(kp)) * Hkv + hk;
          scr = tid < ATT_BK ? ksc[at] : vsc[at];
        }
      } else {
        for (int idx = tid; idx < ATT_BK * (D / EPV); idx += NTHREADS) {
          const int r = idx / (D / EPV), c = idx - r * (D / EPV);
          const int kp = k0 + r;
          const bool ok = kp < clen;
          const int64_t off = ok ? pool_off(kp) + c * EPV : 0;
          cp_async16(Kd + r * LDH + c * EPV, kc + off, ok);
          cp_async16(Vd + r * LDH + c * EPV, vc + off, ok);
        }
      }
    } else {
      const int w0 = (it - n_cs) * ATT_BK;
      for (int idx = tid; idx < ATT_BK * (D / EPV); idx += NTHREADS) {
        const int r = idx / (D / EPV), c = idx - r * (D / EPV);
        const int j = w0 + r;
        const bool ok = j < n_win;
        const int64_t off =
            ok ? ((static_cast<int64_t>(b) * TN + j) * Hkv + hk) * D +
                     c * EPV
               : 0;
        cp_async16(Kd + r * LDH + c * EPV, kn + off, ok);
        cp_async16(Vd + r * LDH + c * EPV, vn + off, ok);
      }
    }
  };
  // int8 tile `it` from registers into its stage, widened to T
  auto land = [&](int it) {
    if constexpr (Q8) {
      constexpr int VPR = D / 16;
      T* Kd = kstage(it);
      T* Vd = Kd + ATT_BK * LDH;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int idx = tid + i * NTHREADS;
        const int r = idx / VPR, c = idx - r * VPR;
        widen16(Kd + r * LDH + c * 16, kr[i]);
        widen16(Vd + r * LDH + c * 16, vr[i]);
      }
      sstage(it)[tid] = scr;  // k scales [0, 64), v scales [64, 128)
    }
  };

  start_tile(0);
  if (Q8 && n_cs > 0) land(0);
  cp_async_commit();

  AttRows<D> st;
  st.init();
  uint32_t qf[D / 16][4];
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    // tile it (and Q) visible to every thread; every warp is done with
    // tile it - 1, whose stage the next tile refills
    __syncthreads();
    const bool next = it + 1 < n_it;
    if (next) start_tile(it + 1);
    cp_async_commit();
    if (it == 0) att_load_q<T, D>(qf, Qs + warp * 16 * LDH);
    const T* Ks = kstage(it);
    const T* Vs = Ks + ATT_BK * LDH;
    if (w_live && it < n_cs) {
      const int k0 = (c_lo + it) * ATT_BK;
      const bool edge = k0 + ATT_BK > clen;
      const float* S = sstage(it);
      float s[8][4];
      att_scores<T, D>(s, qf, Ks);
      att_softmax_pv<T, D, true>(
          s, Vs,
          [&](int, int c, float x) {
            x *= scale;
            if constexpr (Q8) x *= S[c];
            if (edge && k0 + c >= clen) x = ATT_NEG;
            return x;
          },
          [&](int c) {
            if constexpr (Q8) return S[ATT_BK + c];
            return 1.f;
          },
          st);
    } else if (w_live && (it - n_cs) * ATT_BK <= w_qhi) {
      const int w0 = (it - n_cs) * ATT_BK;
      float s[8][4];
      att_scores<T, D>(s, qf, Ks);
      att_softmax_pv<T, D, true>(
          s, Vs,
          [&](int hh, int c, float x) {
            const int j = w0 + c;
            return j <= qpos[hh] && j < new_len ? x * scale : ATT_NEG;
          },
          [](int) { return 1.f; }, st);
    }
    if (Q8 && next && it + 1 < n_cs) land(it + 1);
  }
  cp_async_wait<0>();
  st.finish();

  // this lane's rows: tile rows warp * 16 + g + 8 hh
  if (n_live == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t off = row_off(warp * 16 + g + 8 * hh);
      if (off < 0) continue;
      const bool live = qpos[hh] < new_len;
      const float inv = live ? 1.f / st.l[hh] : 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + off + 8 * j + 2 * t) = pack2<T>(
            live ? st.o[j][2 * hh] * inv : 0.f,
            live ? st.o[j][2 * hh + 1] * inv : 0.f);
    }
    return;
  }

  // this split's partial; the row tile's last live split merges them all
  constexpr int64_t PS = partial_floats<D>();
  const int64_t row_id = static_cast<int64_t>(bkv) * gridDim.x + qt;
  float* mine = part + (row_id * splits + split) * PS;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(mine + r * D + 8 * j + 2 * t) =
          make_float2(st.o[j][2 * hh], st.o[j][2 * hh + 1]);
    if (t == 0) {
      mine[BQ * D + r] = st.m[hh];
      mine[BQ * D + BQ + r] = st.l[hh];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(counters + row_id, 1);
    *flag = done == n_live - 1;
    if (*flag) counters[row_id] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // out = sum over splits, in split order, of exp(m - M) acc, over
  // L = sum exp(m - M) l, M = max m; each lane merges its own elements
  const float* rp = part + row_id * splits * PS;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    const int64_t off = row_off(r);
    if (off < 0) continue;
    const bool live = qpos[hh] < new_len;
    float mx = ATT_NEG;
    for (int sp = 0; sp < n_live; ++sp)
      mx = fmaxf(mx, __ldcg(rp + sp * PS + BQ * D + r));
    float ls = 0.f;
    float acc[D / 8][2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float* ps = rp + sp * PS;
      const float w = __expf(__ldcg(ps + BQ * D + r) - mx);
      ls += w * __ldcg(ps + BQ * D + BQ + r);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 a =
            __ldcg(reinterpret_cast<const float2*>(ps + r * D + 8 * j + 2 * t));
        acc[j][0] += w * a.x;
        acc[j][1] += w * a.y;
      }
    }
    const float inv = live ? 1.f / ls : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + off + 8 * j + 2 * t) =
          pack2<T>(live ? acc[j][0] * inv : 0.f, live ? acc[j][1] * inv : 0.f);
  }
}

// ===========================================================================
// f32: the first design (CUDA cores)
// ===========================================================================

constexpr int BK = 64;         // keys per tile
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

template <int D>
struct Smem {
  // every tile is sized for f32, the widest it holds (an int8 pool tile
  // uses the first part of its slot)
  static constexpr size_t tile = align16(static_cast<size_t>(BQ) *
                                         pitch<float, D>() * sizeof(float));
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
template <typename E, int D, bool SCALED, typename Ok>
__device__ __forceinline__ void tile_step(
    const float* qw, const E* Ks, const E* Vs, const float* ksc,
    const float* vsc, float* Pw, float scale, Ok ok, float (&m_r)[ROWS],
    float (&l_r)[ROWS], float (&o_r)[ROWS][D / 32]) {
  constexpr int LQ = pitch<float, D>();
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
      const float qv = qw[r * LQ + d];
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

// PT: pool element type (float, or int8_t with scales)
template <typename PT, int D>
__global__ void __launch_bounds__(NTHREADS) paged_prefill_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ kn,
    const float* __restrict__ vn, const PT* __restrict__ kc,
    const PT* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ clens, const int* __restrict__ nlens,
    float* __restrict__ out, int TN, int Hq, int Hkv, int page, int W, int P,
    float scale) {
  using T = float;
  using S = Smem<D>;
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
      if (o != nullptr) o[idx % D] = 0.f;
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
    tile_step<PT, D, Q8>(qw, Kp, Vp, Ksc, Vsc, Pw, scale,
                         [&](int, int c) { return k0 + c < clen; }, m_r, l_r,
                         o_r);
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
    tile_step<T, D, false>(
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
      o[lane + 32 * j] = live ? o_r[r][j] * inv : 0.f;
  }
}

// ===========================================================================
// launch
// ===========================================================================

struct Args {
  const void *q, *kn, *vn, *kc, *vc;
  const float *ksc, *vsc;
  const int *t, *cl, *nl;
  void* out;
  float* part;
  int* cnt;
  int B, TN, Hq, Hkv, page, W, P, tps, splits;
  float scale;
  cudaStream_t s;
};

template <typename K>
int opt_in(K kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

template <typename T, typename PT, int D>
int launch_mma(const Args& a) {
  constexpr size_t bytes = MmaLayout<T, D>::bytes;
  static bool attr_set = false;
  if (int e = opt_in(paged_prefill_mma_kernel<T, PT, D>, bytes, &attr_set))
    return e;
  const int64_t rows = static_cast<int64_t>(a.TN) * (a.Hq / a.Hkv);
  if (a.tps < 1 || a.splits < 1 || a.splits > 65535 ||
      (a.splits > 1 && (a.part == nullptr || a.cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>((rows + BQ - 1) / BQ), a.splits,
            a.B * a.Hkv);
  paged_prefill_mma_kernel<T, PT, D><<<grid, NTHREADS, bytes, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kn),
      static_cast<const T*>(a.vn), static_cast<const PT*>(a.kc),
      static_cast<const PT*>(a.vc), a.ksc, a.vsc, a.t, a.cl, a.nl,
      static_cast<T*>(a.out), a.part, a.cnt, a.TN, a.Hq, a.Hkv, a.page, a.W,
      a.P, a.scale, a.tps);
  return static_cast<int>(cudaGetLastError());
}

template <typename PT, int D>
int launch_f32(const Args& a) {
  constexpr size_t bytes = Smem<D>::bytes;
  static bool attr_set = false;
  if (int e = opt_in(paged_prefill_f32_kernel<PT, D>, bytes, &attr_set))
    return e;
  if (a.splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(a.TN) * (a.Hq / a.Hkv);
  dim3 grid(static_cast<unsigned>((rows + BQ - 1) / BQ), a.B * a.Hkv);
  paged_prefill_f32_kernel<PT, D><<<grid, NTHREADS, bytes, a.s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kn),
      static_cast<const float*>(a.vn), static_cast<const PT*>(a.kc),
      static_cast<const PT*>(a.vc), a.ksc, a.vsc, a.t, a.cl, a.nl,
      static_cast<float*>(a.out), a.TN, a.Hq, a.Hkv, a.page, a.W, a.P,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// Q8 = false: the pools have q's type; Q8 = true: int8 pools with scales
template <bool Q8, int D>
int dispatch_t(int dtype, const Args& a) {
  using PF = typename std::conditional<Q8, int8_t, float>::type;
  using PB = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  using PH = typename std::conditional<Q8, int8_t, __half>::type;
  switch (dtype) {
    case PTT_F32:
      return launch_f32<PF, D>(a);
    case PTT_BF16:
      return launch_mma<__nv_bfloat16, PB, D>(a);
    case PTT_F16:
      return launch_mma<__half, PH, D>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool Q8>
int dispatch(int dtype, int D, const Args& a) {
  if (a.B == 0 || a.TN == 0) return static_cast<int>(cudaGetLastError());
  switch (D) {
    case 64:
      return dispatch_t<Q8, 64>(dtype, a);
    case 128:
      return dispatch_t<Q8, 128>(dtype, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// part / counters: the split scratch (f32 [B * Hkv * row tiles * splits,
// 64 D + 128] and int [B * Hkv * row tiles], zero between launches); null
// when splits == 1. f32 operands take splits == 1 only.
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* kc,
    const void* vc, const void* tables, const void* cached_lens,
    const void* new_lens, void* out, void* part, void* counters, int B,
    int TN, int Hq, int Hkv, int D, int page, int W, int P, int tps,
    int splits, float scale, int dtype, void* stream) {
  const Args a{q, k_new, v_new, kc, vc, nullptr, nullptr,
               static_cast<const int*>(tables),
               static_cast<const int*>(cached_lens),
               static_cast<const int*>(new_lens), out,
               static_cast<float*>(part), static_cast<int*>(counters), B, TN,
               Hq, Hkv, page, W, P, tps, splits, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, D, a);
}

// int8 pools with f32 scales [P, Hkv]; `dtype` is the type of q, the
// window k/v and out
extern "C" int paged_prefill_attention_q8_launch(
    const void* q, const void* k_new, const void* v_new, const void* kc,
    const void* vc, const void* k_scale, const void* v_scale,
    const void* tables, const void* cached_lens, const void* new_lens,
    void* out, void* part, void* counters, int B, int TN, int Hq, int Hkv,
    int D, int page, int W, int P, int tps, int splits, float scale,
    int dtype, void* stream) {
  const Args a{q, k_new, v_new, kc, vc, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tables),
               static_cast<const int*>(cached_lens),
               static_cast<const int*>(new_lens), out,
               static_cast<float*>(part), static_cast<int*>(counters), B, TN,
               Hq, Hkv, page, W, P, tps, splits, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, D, a);
}
