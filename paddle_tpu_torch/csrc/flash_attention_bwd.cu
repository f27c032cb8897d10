// Flash-attention backward (FA2): dq, and dk / dv summed over each kv head's
// group of query heads, in the [B, S, H, D] layout, from the forward's
// output O and row log-sum-exp lse [B*Hq, Sq] (f32).
//
// Replaces the Pallas kernels paddle_tpu/kernels/flash_attention.py
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (both launched by `_bwd_pallas`).
// Per (query row i, key j), as the TPU kernels compute it:
//   s = scale * q_i . k_j (f32; masked to -1e30 above the causal diagonal,
//       which sits at q_offset = Sk - Sq), p = exp(s - lse_i),
//   dp = dO_i . v_j, delta_i = rowsum(dO_i * O_i) (O the forward's rounded
//   output), dS = p * (dp - delta_i) * scale, all in f32;
//   dq_i += bf16(dS) k_j, dv_j += bf16(p) dO_i, dk_j += bf16(dS) q_i,
//   summed in f32 and rounded once at the end.
// The TPU pair writes per-q-head dk / dv in bf16 and the caller sums each
// GQA group in bf16 (flash_attention.py:436-440); here the dkv block walks
// every q head of its group itself and keeps the sum in f32, so there are
// no float atomics and the result is deterministic.
//
// Bound on the H100: operations. The five products (recomputed S, dP, dV,
// dQ, dK) are 10*B*Hq*Sq*Sk*D flops (about half when causal) against
// O(S*D) bytes per row; both kernels recompute S and dP, which is their
// own choice and not work the function needs. The delta pre-pass is bound
// by bytes (O and dO read once).
//
// - dq kernel (redesigned on the register-resident tile body of the
//   forward, csrc/attention_tile.cuh, and of dkv): blocks of DQ_WARPS
//   warps, each warp owning 16 rows of the q tile end to end. Q and dO go
//   to A fragments in registers once (their shared memory then becomes a
//   K / V stage); K / V tiles of 64 keys arrive by cp.async into a ring of
//   two stages, one block barrier a tile. Each tile runs as two strips of
//   32 keys: S = Q K^T and dP = dO V^T on raw m16n8k16 mma.sync into C
//   fragments, the mask, p = exp(s * scale - lse) and dS = p (dP - delta)
//   scale on those accumulators, dS packed to bf16 straight into the A
//   fragments of dq += dS K (K's B fragments by ldmatrix.trans); dq stays
//   in registers for the whole walk and is rounded once. delta comes from
//   the pre-pass below (the wrapper launches it once for dq and dkv).
//   Causal: a warp skips the strips past its rows' reach and masks only
//   strips that cross the diagonal or Sk; q tiles that see the most keys
//   (the last) are dispatched first: grid (B * Hq, q tiles). 68 KB of
//   shared memory at D = 128 with four warps. 64-row q tiles (four warps)
//   against 128 (eight): PERF.md.
// - delta pre-pass: delta = rowsum(dO * O) in f32 once per query row, one
//   warp per row, into [B * Hq, Sq] beside lse (the JAX kernels recompute
//   it for every (key tile, q tile) pair); dq and dkv both read it.
// - dkv kernel (redesigned): one block of four warps per (64 keys,
//   batch * kv head), each warp owning 16 keys; K and V stay in shared
//   memory. For every q head of the group and every q tile of 64 rows
//   that sees these keys, Q, dO, lse and delta of the tile arrive by
//   cp.async into one of two stage buffers while the previous tile
//   computes (one block barrier per tile). Products are raw m16n8k16
//   mma.sync with fragments of known layout, fed by ldmatrix (.trans for
//   the [q, D] operands of the second products): S^T = K_w Q^T and
//   dP^T = V_w dO^T accumulate in registers over 32 query rows at a time;
//   the mask, p = exp(s * scale - lse) and dS = p (dP - delta) scale run on
//   the accumulators, which are packed to bf16 straight into the A
//   fragments of dV += P^T dO and dK += dS^T Q (no score goes through
//   shared memory). The dk / dv sums stay in registers for the block's
//   whole walk and are rounded once. Key tiles that see the most q rows
//   (causal: the first) are dispatched first: grid (B * Hkv, Sk / 64).
//   103 KB of shared memory (K, V and two stages) and 242 registers at
//   D = 128 (170 at D = 64), no spills: two blocks, eight warps, per SM.
//   q tiles of 64 rows measured faster than tiles of 32 (PERF.md).
// A refused launch returns its error. wgmma + TMA is later work.
#include "attention_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BT = 64;          // rows of a k tile (dkv: 16 per warp)
constexpr int NTHREADS = 128;

// ---------------------------------------------------------------------------
// dq: grid (B * Hq, q tiles of 16 * DQ_WARPS rows), the q tiles that see
// the most keys (causal: the last) dispatched first. A warp owns 16 query
// rows end to end: Q and dO as A fragments, lse and delta of its rows and
// the [16, D] dq sum in registers. K / V tiles of 64 keys arrive by
// cp.async into a ring of two stages (one block barrier a tile); each tile
// runs as two strips of 32 keys: S = Q K^T and dP = dO V^T on m16n8k16
// mma.sync (B fragments of K and V by ldmatrix), the mask, p and dS on the
// C fragments, dS packed to bf16 straight into the A fragments of
// dq += dS K (K's B fragments by ldmatrix.trans). No score goes through
// shared memory.
// ---------------------------------------------------------------------------

constexpr int DQ_WARPS = 4;
constexpr int DQ_STRIP = 32;    // keys a register pass

template <int D, int NW>
struct DqLayout {
  static constexpr int LDH = D + 8;   // bf16 rows (padding: ldmatrix banks)
  static constexpr int BQ = 16 * NW;
  static constexpr size_t QT = size_t(BQ) * LDH * sizeof(bf16);
  static constexpr size_t KV = size_t(BT) * LDH * sizeof(bf16);
  // Q and dO land in the first region and go to registers before its
  // bytes become K / V stage 1; stage 0 follows
  static constexpr size_t region0 = 2 * QT > 2 * KV ? 2 * QT : 2 * KV;
  static constexpr size_t bytes = region0 + 2 * KV;
};

// over the strip's 32 keys (4 n-tiles of 8): s = Q K^T and dp = dO V^T,
// the warp's 16 rows (A fragments qf, df) against 32 rows of K and of V
// (pitch D + 8); the two products interleave, eight independent
// accumulators a k16 step
template <int D>
__device__ __forceinline__ void strip_scores(float (&s)[4][4],
                                             float (&dp)[4][4],
                                             const uint32_t (&qf)[D / 16][4],
                                             const uint32_t (&df)[D / 16][4],
                                             const bf16* Ks, const bf16* Vs) {
  constexpr int LDH = D + 8;
  const int lane = threadIdx.x & 31;
  const int off = ((lane & 7) + ((lane >> 4) << 3)) * LDH +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bk[4], bv[4];
      ldsm_x4(bk, Ks + off + np * 16 * LDH + kk * 16);
      ldsm_x4(bv, Vs + off + np * 16 * LDH + kk * 16);
      mma16816(s[2 * np], qf[kk], bk[0], bk[1]);
      mma16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      mma16816(dp[2 * np], df[kk], bv[0], bv[1]);
      mma16816(dp[2 * np + 1], df[kk], bv[2], bv[3]);
    }
}

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32, 8 / NW)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ delta,
                        const bf16* __restrict__ dO,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        int Sq, int Sk, int Hq, int Hkv, float scale,
                        int causal) {
  using L = DqLayout<D, NW>;
  constexpr int NT = NW * 32, LDH = L::LDH;
  extern __shared__ __align__(128) unsigned char smem[];
  auto stage = [&](int i) {
    return reinterpret_cast<bf16*>(smem + ((i & 1) ? 0 : L::region0));
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
  const int n_tiles = (kv_end + BT - 1) / BT;
  // the warp's first row, and the last key any of its rows sees
  const int w0 = q0 + warp * 16;
  const int reach =
      causal ? min(Sk, min(w0 + 16, Sq) + q_offset) - 1 : Sk - 1;
  const int row = w0 + g;  // this lane's rows: row, row + 8

  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::QT);
  copy_rows<D, L::BQ, NT>(Qs, q, b, h, q0, Sq, Hq);
  copy_rows<D, L::BQ, NT>(dOs, dO, b, h, q0, Sq, Hq);
  if (n_tiles > 0) {
    copy_rows<D, BT, NT>(stage(0), k, b, hk, 0, Sk, Hkv);
    copy_rows<D, BT, NT>(stage(0) + BT * LDH, v, b, hk, 0, Sk, Hkv);
  }
  cp_async_commit();

  // lse and delta of this lane's rows (0 past Sq: Q and dO are zero
  // there, so dS is too)
  float li[2], di[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = row + 8 * hh;
    const int64_t at = static_cast<int64_t>(bh) * Sq + s;
    li[hh] = s < Sq ? lse[at] : 0.f;
    di[hh] = s < Sq ? delta[at] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[D / 16][4], df[D / 16][4];

  cp_async_wait<0>();
  __syncthreads();
  att_load_q<bf16, D>(qf, Qs + warp * 16 * LDH);
  att_load_q<bf16, D>(df, dOs + warp * 16 * LDH);
  for (int kt = 0; kt < n_tiles; ++kt) {
    // tile kt visible to every thread; every warp is done with tile
    // kt - 1 (at kt = 0: with Q and dO), whose bytes the next copy refills
    if (kt > 0) cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < n_tiles) {
      copy_rows<D, BT, NT>(stage(kt + 1), k, b, hk, (kt + 1) * BT, Sk, Hkv);
      copy_rows<D, BT, NT>(stage(kt + 1) + BT * LDH, v, b, hk,
                           (kt + 1) * BT, Sk, Hkv);
    }
    cp_async_commit();
    const bf16* Ks = stage(kt);
    const bf16* Vs = Ks + BT * LDH;
#pragma unroll 1
    for (int ks = 0; ks < BT; ks += DQ_STRIP) {
      const int k0 = kt * BT + ks;
      if (w0 >= Sq || k0 > reach) break;  // no row of the warp sees it
      float s[4][4], dp[4][4];
      strip_scores<D>(s, dp, qf, df, Ks + ks * LDH, Vs + ks * LDH);
      const bool edge = k0 + DQ_STRIP > Sk ||
                        (causal && k0 + DQ_STRIP - 1 > w0 + q_offset);
      // dS = p (dP - delta) scale on the C fragments: element e of n-tile
      // j is row `row` (+8 for e >= 2), key k0 + 8 j + 2 t (+1 for odd e)
      uint32_t af[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= Sk ||
                (causal && key > row + 8 * (e >> 1) + q_offset))
              x = ATT_NEG;
          }
          const float p = expf(x - li[e >> 1]);
          ds[e] = p * (dp[j][e] - di[e >> 1]) * scale;
        }
        af[j >> 1][(j & 1) * 2] = pack2(ds[0], ds[1]);
        af[j >> 1][(j & 1) * 2 + 1] = pack2(ds[2], ds[3]);
      }
      // dq += dS K over the strip's keys
      const bf16* kp = Ks + (ks + (lane & 15)) * LDH + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < DQ_STRIP / 16; ++kk)
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bk[4];
          ldsm_x4_trans(bk, kp + kk * 16 * LDH + dn * 16);
          mma16816(acc[2 * dn], af[kk], bk[0], bk[1]);
          mma16816(acc[2 * dn + 1], af[kk], bk[2], bk[3]);
        }
    }
  }
  cp_async_wait<0>();

  // the f32 sums, rounded once, straight from the accumulators
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int s = row + 8 * hh;
    if (s >= Sq) continue;
    bf16* out = dq + ((static_cast<int64_t>(b) * Sq + s) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
          pack2(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in f32, once per query row: [B * Hq, Sq], beside
// lse. One warp per row of the [B, Sq, Hq, D] tensors.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_delta_kernel(const bf16* __restrict__ o,
                           const bf16* __restrict__ dO,
                           float* __restrict__ delta, int64_t rows, int Sq,
                           int Hq, int D) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * NTHREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const __nv_bfloat162* orow =
      reinterpret_cast<const __nv_bfloat162*>(o + r * D);
  const __nv_bfloat162* drow =
      reinterpret_cast<const __nv_bfloat162*>(dO + r * D);
  float acc = 0.f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 a = __bfloat1622float2(orow[c]);
    const float2 d = __bfloat1622float2(drow[c]);
    acc += d.x * a.x + d.y * a.y;
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = static_cast<int>(r % Hq);
    const int64_t bs = r / Hq;
    const int s = static_cast<int>(bs % Sq);
    const int64_t b = bs / Sq;
    delta[(b * Hq + h) * Sq + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// dkv: grid (B * Hkv, ceil(Sk / 64)), the key tiles that see the most query
// rows (causal: the first) dispatched first; each block walks the Hq / Hkv
// query heads of its kv head and, for each, the q tiles that see its keys.
// Raw m16n8k16 mma.sync with fragments of known layout (fragments.cuh):
// every score stays in registers.
// ---------------------------------------------------------------------------

// keys of a dkv block (16 per warp) and query rows of a stage; each stage
// holds Q, dO, lse and delta of one q tile, in two buffers
constexpr int DKV_QROWS = 64;
constexpr int DKV_SUB = 32;     // query rows per register pass

template <int D>
struct DkvLayout {
  static constexpr int LDH = D + 8;   // bf16 rows (padding: ldmatrix banks)
  static constexpr size_t KV = size_t(BT) * LDH * sizeof(bf16);
  static constexpr size_t QT = size_t(DKV_QROWS) * LDH * sizeof(bf16);
  static constexpr size_t k = 0;
  static constexpr size_t v = KV;
  static constexpr size_t stage0 = 2 * KV;
  static constexpr size_t q = 0, dO = QT, lse = 2 * QT,
                          delta = 2 * QT + DKV_QROWS * sizeof(float);
  static constexpr size_t STAGE = 2 * QT + 2 * DKV_QROWS * sizeof(float);
  static constexpr size_t bytes = stage0 + 2 * STAGE;
};

// stage: Q, dO, lse and delta of query rows [q0, q0 + 64) of head (b, h)
template <int D>
__device__ __forceinline__ void start_stage_copy(unsigned char* st,
                                                 const bf16* q, const bf16* dO,
                                                 const float* lse,
                                                 const float* delta, int b,
                                                 int h, int q0, int Sq,
                                                 int Hq) {
  using L = DkvLayout<D>;
  copy_rows<D, DKV_QROWS, NTHREADS>(reinterpret_cast<bf16*>(st + L::q), q,
                                    b, h, q0, Sq, Hq);
  copy_rows<D, DKV_QROWS, NTHREADS>(reinterpret_cast<bf16*>(st + L::dO), dO,
                                    b, h, q0, Sq, Hq);
  const int t = threadIdx.x;
  if (t < 2 * DKV_QROWS) {
    const int i = t % DKV_QROWS;
    const bool ok = q0 + i < Sq;
    const float* src = (t < DKV_QROWS ? lse : delta) +
                       (static_cast<int64_t>(b) * Hq + h) * Sq +
                       (ok ? q0 + i : 0);
    float* dst = reinterpret_cast<float*>(
                     st + (t < DKV_QROWS ? L::lse : L::delta)) + i;
    cp_async4(dst, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Sk, int Hq, int Hkv, float scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int LDH = L::LDH;
  constexpr int NT = D / 8;                 // n-tiles of a [16, D] sum
  constexpr int ST = DKV_SUB / 8;           // n-tiles of a [16, 32] strip
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BT;
  const int b = bkv / Hkv, hk = bkv - b * Hkv;
  const int rep = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_offset = Sk - Sq;

  // causal: the first q tile with a row that sees key k0 (row i sees key j
  // when j <= i + q_offset); earlier tiles see none of these keys
  int qt0 = 0;
  if (causal && k0 - q_offset > 0) qt0 = (k0 - q_offset) / DKV_QROWS;
  const int n_qt = (Sq + DKV_QROWS - 1) / DKV_QROWS;
  const int per_head = max(n_qt - qt0, 0);
  const int n_it = rep * per_head;

  copy_rows<D, BT, NTHREADS>(Ks, k, b, hk, k0, Sk, Hkv);
  copy_rows<D, BT, NTHREADS>(Vs, v, b, hk, k0, Sk, Hkv);
  if (n_it > 0)
    start_stage_copy<D>(smem + L::stage0, q, dO, lse, delta, b, hk * rep,
                        qt0 * DKV_QROWS, Sq, Hq);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // this thread's two key rows of the warp's 16 and its ldmatrix offsets
  const int key_r0 = k0 + warp * 16 + (lane >> 2);
  const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int bn_row = (lane & 7) + ((lane >> 4) << 3);
  const int bn_col = ((lane >> 3) & 1) * 8;
  const int bt_row = lane & 15, bt_col = (lane >> 4) * 8;

  for (int it = 0; it < n_it; ++it) {
    const int g = it / per_head;
    const int q0 = (qt0 + it - g * per_head) * DKV_QROWS;
    cp_async_wait<0>();
    // stage `it` is visible to every thread, and every warp is done with
    // stage it - 1, whose buffer the next copy refills
    __syncthreads();
    if (it + 1 < n_it) {
      const int g1 = (it + 1) / per_head;
      start_stage_copy<D>(smem + L::stage0 + ((it + 1) & 1) * L::STAGE, q,
                          dO, lse, delta, b, hk * rep + g1,
                          (qt0 + it + 1 - g1 * per_head) * DKV_QROWS, Sq,
                          Hq);
    }
    cp_async_commit();
    const unsigned char* st = smem + L::stage0 + (it & 1) * L::STAGE;
    const bf16* Qs = reinterpret_cast<const bf16*>(st + L::q);
    const bf16* dOs = reinterpret_cast<const bf16*>(st + L::dO);
    const float* lse_s = reinterpret_cast<const float*>(st + L::lse);
    const float* delta_s = reinterpret_cast<const float*>(st + L::delta);

#pragma unroll 1
    for (int qs = 0; qs < DKV_QROWS; qs += DKV_SUB) {
      // S^T = K_w Q^T and dP^T = V_w dO^T over this pass's 32 query rows
      float sacc[ST][4], pacc[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, Ks + a_row * LDH + kk + a_col);
        ldsm_x4(av, Vs + a_row * LDH + kk + a_col);
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          uint32_t bq[4], bd[4];
          const int row = qs + np * 16 + bn_row;
          ldsm_x4(bq, Qs + row * LDH + kk + bn_col);
          ldsm_x4(bd, dOs + row * LDH + kk + bn_col);
          mma16816(sacc[2 * np], ak, bq[0], bq[1]);
          mma16816(sacc[2 * np + 1], ak, bq[2], bq[3]);
          mma16816(pacc[2 * np], av, bd[0], bd[1]);
          mma16816(pacc[2 * np + 1], av, bd[2], bd[3]);
        }
      }
      // p and dS on the accumulators: element e of n-tile j is key row
      // key_r0 (+8 for e >= 2), query column qs + 8j + 2(lane % 4) (+1
      // for odd e); packed to bf16 as A fragments of the next products
      uint32_t ap[ST / 2][4], ads[ST / 2][4];
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_r0 + (e >> 1) * 8;
          const int col = qs + 8 * j + 2 * (lane & 3) + (e & 1);
          const int qi = q0 + col;
          float sv = sacc[j][e] * scale;
          if (key >= Sk || (causal && key > qi + q_offset)) sv = ATT_NEG;
          const float p = qi < Sq ? expf(sv - lse_s[col]) : 0.f;
          pv[e] = p;
          dsv[e] = p * (pacc[j][e] - delta_s[col]) * scale;
        }
        ap[j >> 1][(j & 1) * 2] = pack2(pv[0], pv[1]);
        ap[j >> 1][(j & 1) * 2 + 1] = pack2(pv[2], pv[3]);
        ads[j >> 1][(j & 1) * 2] = pack2(dsv[0], dsv[1]);
        ads[j >> 1][(j & 1) * 2 + 1] = pack2(dsv[2], dsv[3]);
      }
      // dV += P^T dO and dK += dS^T Q over the pass's rows
#pragma unroll
      for (int t = 0; t < ST / 2; ++t) {
        const int row = qs + t * 16 + bt_row;
#pragma unroll
        for (int dn = 0; dn < NT / 2; ++dn) {
          uint32_t bd[4], bq[4];
          ldsm_x4_trans(bd, dOs + row * LDH + dn * 16 + bt_col);
          ldsm_x4_trans(bq, Qs + row * LDH + dn * 16 + bt_col);
          mma16816(dv_acc[2 * dn], ap[t], bd[0], bd[1]);
          mma16816(dv_acc[2 * dn + 1], ap[t], bd[2], bd[3]);
          mma16816(dk_acc[2 * dn], ads[t], bq[0], bq[1]);
          mma16816(dk_acc[2 * dn + 1], ads[t], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the f32 sums, rounded once, straight from the accumulators
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_r0 + half * 8;
    if (key >= Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Sk + key) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dk + off + col) =
          pack2(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + col) =
          pack2(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
    }
  }
}

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

template <int D>
int launch_dq(const void* q, const void* k, const void* v,
              const float* delta, const void* dO, const float* lse, void* dq,
              int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
              cudaStream_t stream) {
  using L = DqLayout<D, DQ_WARPS>;
  constexpr size_t bytes = L::bytes;
  static bool attr_set = false;
  if (int e = opt_in(flash_bwd_dq_kernel<D, DQ_WARPS>, bytes, &attr_set))
    return e;
  const int n_qt = (Sq + L::BQ - 1) / L::BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * Hq, n_qt);
  flash_bwd_dq_kernel<D, DQ_WARPS><<<grid, DQ_WARPS * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), delta, static_cast<const bf16*>(dO), lse,
      static_cast<bf16*>(dq), Sq, Sk, Hq, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int Sq, int Sk, int Hq, int Hkv, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t bytes = DkvLayout<D>::bytes;
  static bool attr_set = false;
  if (int e = opt_in(flash_bwd_dkv_kernel<D>, bytes, &attr_set)) return e;
  dim3 grid(B * Hkv, (Sk + BT - 1) / BT);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// delta from flash_attention_bwd_delta_launch
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* delta,
    const void* dO, const void* lse, void* dq, int B, int Sq, int Sk, int Hq,
    int Hkv, int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dl, dO, l, dq, B, Sq, Sk, Hq, Hkv, scale,
                           causal, s);
    case 128:
      return launch_dq<128>(q, k, v, dl, dO, l, dq, B, Sq, Sk, Hq, Hkv,
                            scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// delta [B * Hq, Sq] f32 = rowsum(dO * O) of the forward's rounded output
extern "C" int flash_attention_bwd_delta_launch(const void* o,
                                                const void* dO, void* delta,
                                                int B, int Sq, int Hq, int D,
                                                void* stream) {
  const int64_t rows = static_cast<int64_t>(B) * Sq * Hq;
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  if (D % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + NTHREADS / 32 - 1) / (NTHREADS / 32);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta_kernel<<<static_cast<unsigned>(blocks), NTHREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO),
      static_cast<float*>(delta), rows, Sq, Hq, D);
  return static_cast<int>(cudaGetLastError());
}

// delta from flash_attention_bwd_delta_launch
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (B == 0 || Sk == 0) return static_cast<int>(cudaGetLastError());
  if ((Sk + BT - 1) / BT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dO, l, dl, dk, dv, B, Sq, Sk, Hq, Hkv,
                            scale, causal, s);
    case 128:
      return launch_dkv<128>(q, k, v, dO, l, dl, dk, dv, B, Sq, Sk, Hq, Hkv,
                             scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
