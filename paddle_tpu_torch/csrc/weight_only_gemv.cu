// Weight-only dequant GEMV for decode-shaped matmuls: out [M, N] =
// (x [M, K] @ W^T) * scale [N], M <= 64, W stored per output channel as
// int8 [N, K] or packed int4 [N, K / 2] (low nibble = even k, high nibble =
// odd k).
//
// Replaces the Pallas kernel paddle_tpu/kernels/int4_matmul.py `_kernel`
// (launched by `int4_matmul`, M <= 64). The int8 instantiation serves the
// int8 branch of the serving matmul `_mm` (paddle_tpu/models/llama.py:685),
// which the JAX package leaves to XLA's fused convert + dot and which has no
// Pallas kernel.
//
// Arithmetic (both formats): each weight value is an exact small integer
// (int4: ((v & 15) ^ 8) - 8), exact in bf16 and f16; it meets x (bf16 or
// f16) in the tensor cores' products, the products are summed in f32, the
// f32 per-channel scale multiplies the finished sum, and the result is
// rounded once to x's type. The sums run in a fixed order (below), so a
// launch repeats its results bitwise; kernels/int4_matmul.py
// `weight_only_split_reference` is the plain twin of that order.
//
// Bound on the H100: bytes. The kernel does 2*M flops per weight value and
// must stream every weight byte once: 0.5 byte a value for int4, 1 for
// int8, so a Llama-3-8B decode step needs about 3.75 GB of int4 weights
// (1.1 ms at 3.35 TB/s) against 15 GB of bf16.
//
// Design. The first tensor-core version (a block of 16 channels and 8 rows,
// plain loads) streamed the weights once for every 8 rows, read more x
// than weights from L2 and left small N short of the card's SMs. This one:
// - one pass over the weights for all rows: a block owns a group of A
//   tiles (16 channels each, at most 8) and every row of x; each widened
//   weight fragment feeds ceil(M / 8) mma.sync m16n8k16 products (A = 16
//   channels x 16 k, B = 8 rows), so widening is paid once a weight value;
// - a producer warp streams the block's K range through a ring of STAGES
//   shared-memory stages with TMA (cp.async.bulk.tensor) under the
//   128-byte swizzle, a full / empty mbarrier pair a stage: a stage holds
//   128 bytes of every channel row of the group (256 k of int4, 128 of
//   int8) and the same k of all rows of x, staged once for every warp of
//   the block (ragged N, M and K arrive as zeros from the copy engine); a
//   stage's boxes go out from as many lanes at once, and the ring's first
//   fill starts before the block barrier;
// - programmatic dependent launch: a launch may begin while the kernel
//   before it on the stream ends; its first stages' weights stream
//   meanwhile, its x (that kernel's output) only after griddepcontrol.wait,
//   and it lets the next launch begin once its stages are consumed;
// - eight consumer warps: warp w takes A tile w % ct and the (w / ct)-th
//   of kg contiguous runs of each stage's 64-k sub-blocks (kg = min(8 /
//   ct, sub-blocks a stage) k groups), two sub-blocks at a time at M <=
//   16; within a sub-block thread (g, t) owns k 16 t .. 16 t + 15, four
//   k16 steps of four k each. The reduction may permute k, so each thread
//   reads its k as they lie in memory, and the A rows hold the tile's
//   channels in an order (rho) that puts a warp's weight loads on
//   distinct banks under the swizzle (x's loads already are). Eight
//   accumulator chains a warp keep the products from waiting on each
//   other;
// - nibbles widen with the magic-number trick, two a byte permute, a lop3
//   and a subtraction: (n ^ 8) | 0x4300 is the bf16 of 128 + (n ^ 8), less
//   136 gives the signed value exactly (f16: 0x6400 and 1032); int8 bytes
//   go through the f32 form (fragments.cuh int8_word_pairs);
// - K splits inside the launch: a group's K range is cut into `cluster`
//   ranks, one block each, launched as one thread-block cluster; each
//   block sums its k groups in order in shared memory, then rank r sums
//   its share of the outputs over the ranks' partials in rank order
//   through distributed shared memory, scales and stores. No scratch, no
//   atomics, no second launch;
// - the plan (`make_plan`, host code: channel groups, cluster size,
//   stages a rank): groups come in multiples of the card's SM count over
//   the cluster size, so the blocks cover the SMs in whole waves; a
//   cluster of 2 where its blocks fit two to an SM, else a cost in
//   streamed bytes picks 1 or 2.
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "fragments.cuh"
#include "weight_ring.cuh"

namespace {

constexpr int NCW = 8;                  // consumer warps
constexpr int NTHREADS = (NCW + 1) * 32;
constexpr int STAGES = 4;               // ring depth
constexpr int ATILE = 16;               // channels of an A tile (a warp)
constexpr int MAX_CT = 8;               // A tiles a block
constexpr int MAX_CLUSTER = 2;          // K ranks a group
// shared memory a block may take with two blocks an SM (of 228 KB, 1 KB
// reserved a block)
constexpr int TWO_A_SM = 113 * 1024;
// programmatic dependent launch: a grid may start while the one before it
// on the stream finishes; its first stages' weights stream meanwhile, and
// x (the previous grids' output) only after griddepcontrol.wait
constexpr bool PDL = true;
constexpr int ROW = 128;                // bytes of a weight row a stage
constexpr int WBOX = ATILE * ROW;       // an A tile's stage: 2 KB
constexpr int KSUB = 64;                // k of an x sub-block (128 bytes)
constexpr int XTILE = 8 * 128;          // 8 rows of an x sub-block: 1 KB

template <bool INT4>
struct Fmt {
  static constexpr int SB = INT4 ? 4 : 2;       // x sub-blocks a stage
  static constexpr int SK = SB * KSUB;          // k a stage
};

// the launch's plan, computed on the host (make_plan) and passed by value
struct Plan {
  int groups;    // channel groups (grid.y)
  int cluster;   // K ranks of a group, one cluster (grid.x)
  int spr;       // ring stages a rank (the last ranks may have fewer)
  int nst;       // ring stages over K
  int tiles;     // A tiles over N
  int ntl;       // n8 tiles of rows, ceil(M / 8)
  int smem;      // dynamic shared memory a block
};

template <typename T>
struct Magic;
template <>
struct Magic<__nv_bfloat16> {
  static constexpr uint32_t BASE = 0x43004300u;  // bf16 128.0, 128.0
  static constexpr uint32_t BIAS = 0x43084308u;  // bf16 136.0, 136.0
};
template <>
struct Magic<__half> {
  static constexpr uint32_t BASE = 0x64006400u;  // f16 1024.0, 1024.0
  static constexpr uint32_t BIAS = 0x64086408u;  // f16 1032.0, 1032.0
};

__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b,
                                         __nv_bfloat16*) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b, __half*) {
  __half2 r = __hsub2(*reinterpret_cast<__half2*>(&a),
                      *reinterpret_cast<__half2*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// one int4 word (k 0..7: k 2i in the low nibble of byte i) -> the packed
// pairs (k 0, 1), (2, 3), (4, 5), (6, 7) in T, exactly: a byte permute
// puts byte i and byte i of the word shifted by a nibble at bytes 0 and 2,
// one lop3 keeps their low nibbles, flips their top bits (offset binary:
// n ^ 8) and ors in the magic exponent (lut 0x6A: b ? a ^ c : c), and one
// subtraction of the bias leaves (n ^ 8) - 8
template <typename T>
__device__ __forceinline__ void int4_word_pairs(uint32_t w, uint32_t* p) {
  const uint32_t w4 = w >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v;
    asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"
        : "=r"(v)
        : "r"(__byte_perm(w, w4, 0x0400u + 0x0101u * i)), "r"(0x000F000Fu),
          "r"(Magic<T>::BASE | 0x00080008u));
    p[i] = sub2(v, Magic<T>::BIAS, static_cast<T*>(nullptr));
  }
}

__device__ __forceinline__ uint2 lds64(const void* p) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(smem_u32(p)));
  return v;
}
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

// the float at `p`'s offset in the shared memory of cluster block `rank`
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

// every thread of every block of the cluster; shared-memory writes before
// it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// the A row of lane group g (and g + 8) holds channel rho(g) (rho(g) + 8)
// of the warp's tile: int4's 8-byte loads (16 lanes a bank pass) then meet
// four rows with distinct swizzle phases, int8's 16-byte loads (8 lanes a
// pass) two rows four phases apart, so every pass covers all 32 banks
template <bool INT4>
__device__ __forceinline__ int rho(int g) {
  return INT4 ? 2 * (g & 3) + (g >> 2) : (g >> 1) + 4 * (g & 1);
}

__host__ __device__ inline int group_first_tile(const Plan& p, int grp) {
  return static_cast<int>(static_cast<int64_t>(grp) * p.tiles / p.groups);
}

// NT: n8 tiles the accumulators hold (>= p.ntl)
template <typename T, bool INT4, int NT>
__global__ void __launch_bounds__(NTHREADS, NT <= 2 ? 2 : 1)
    gemv_kernel(const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tx,
                const float* __restrict__ scale, T* __restrict__ out, int M,
                int N, int K, Plan p) {
  using F = Fmt<INT4>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int rank = blockIdx.x, grp = blockIdx.y;
  const int a0 = group_first_tile(p, grp);
  const int ct = group_first_tile(p, grp + 1) - a0;   // A tiles, 1..8
  const int kgn = min(NCW / ct, F::SB);                // k groups
  const int active = ct * kgn;                         // warps with work
  const int xsub = p.ntl * XTILE;                      // an x sub-block
  const int stage = ct * WBOX + F::SB * xsub;          // 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * stage);
  uint64_t* empty = full + STAGES;
  const int s0 = rank * p.spr;
  const int ns = max(0, min(p.nst, s0 + p.spr) - s0);  // this rank's stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // the producer warp's stage n: lane 0 sets the byte count (if `expect`),
  // then lane a < ct copies A tile a's weights and lane ct + s x's
  // sub-block s, as many boxes at once
  auto issue = [&](int n, bool expect, bool w, bool x) {
    const int slot = n % STAGES;
    unsigned char* st = smem + slot * stage;
    const int k0 = (s0 + n) * F::SK;
    const int nsub = min(F::SB, (K - k0 + KSUB - 1) / KSUB);
    if (expect && lane == 0)
      mb_expect_tx(full + slot, ct * WBOX + nsub * xsub);
    __syncwarp();
    if (lane < ct) {
      if (w)
        tma_load(st + lane * WBOX, &tw, full + slot, INT4 ? k0 / 2 : k0,
                 (a0 + lane) * ATILE);
    } else if (lane - ct < nsub && x) {
      const int s = lane - ct;
      tma_load(st + ct * WBOX + s * xsub, &tx, full + slot, k0 + s * KSUB,
               0);
    }
  };
  if (warp == NCW) {
    // the ring's first fill, before the block barrier: the maps'
    // descriptors, the mbarriers, the first stages' weights, then (once
    // the grids before this one finished) their x
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tw))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tx))
                   : "memory");
      for (int s = 0; s < STAGES; ++s) {
        mb_init(full + s, 1);
        mb_init(empty + s, active);   // one arrival a working consumer warp
      }
      mb_init_fence();
    }
    for (int n = 0; n < min(ns, STAGES); ++n) issue(n, true, true, false);
    if (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int n = 0; n < min(ns, STAGES); ++n) issue(n, false, false, true);
  }
  __syncthreads();

  // ACC accumulator sets an n8 tile, so that a warp's products issue as
  // NT * ACC = 8 independent chains (a product waits for the previous
  // one of its chain); summed in order at the end
  constexpr int ACC = 8 / NT;
  float c[NT][ACC][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < ACC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][j][e] = 0.f;

  if (warp == NCW) {
    // ---- producer: the rest of the rank's stages, each into the slot
    // its consumers released ----
    for (int n = STAGES; n < ns; ++n) {
      mb_wait(empty + n % STAGES, ((n / STAGES) & 1) ^ 1);
      issue(n, true, true, true);
    }
  } else if (warp < active) {
    // ---- consumers: A tile `a`, k group `kg`: sub-blocks [sb0, sb0 +
    // per) of each stage, two at a time where the registers allow ----
    const int a = warp % ct, kg = warp / ct, r = rho<INT4>(g);
    const int per = F::SB / kgn, sb0 = kg * per;
    const int wrow = (a * ATILE + r) * ROW;   // its swizzle phase is r
    // x rows 8 nt + g (swizzle phase g): this thread's two 16-byte chunks
    const int xo0 = g * 128 + (((2 * t) ^ g) << 4);
    const int xo1 = g * 128 + (((2 * t + 1) ^ g) << 4);
    // U sub-blocks from s: loads, widening, then the products
    auto sub_blocks = [&](const unsigned char* st, int s, auto u) {
      constexpr int U = decltype(u)::value;
      uint32_t af[U][4][4];
      uint4 xv[U][NT][2];
#pragma unroll
      for (int v = 0; v < U; ++v) {
        // this thread's 16 k of sub-block sv: weights of rows r, r + 8,
        // then the same k of x
        const int sv = s + v;
        const unsigned char* wr = st + wrow;
        uint32_t wa[4], wb[4];
        if constexpr (INT4) {
          const int off = (((2 * sv + (t >> 1)) ^ r) << 4) + 8 * (t & 1);
          const uint2 va = lds64(wr + off);
          const uint2 vb = lds64(wr + 8 * ROW + off);
          wa[0] = va.x, wa[1] = va.y, wb[0] = vb.x, wb[1] = vb.y;
        } else {
          const int off = ((4 * sv + t) ^ r) << 4;
          const uint4 va = lds128(wr + off);
          const uint4 vb = lds128(wr + 8 * ROW + off);
          wa[0] = va.x, wa[1] = va.y, wa[2] = va.z, wa[3] = va.w;
          wb[0] = vb.x, wb[1] = vb.y, wb[2] = vb.z, wb[3] = vb.w;
        }
        const unsigned char* xs = st + ct * WBOX + sv * xsub;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt < NT / 2 + 1 || nt < p.ntl) {   // p.ntl > NT / 2
            xv[v][nt][0] = lds128(xs + nt * 1024 + xo0);
            xv[v][nt][1] = lds128(xs + nt * 1024 + xo1);
          }
        // A fragments of the four k16 steps: step q takes k 4q .. 4q + 3
        // (slots 2t, 2t + 1 <- 4q, 4q + 1; 2t + 8, 2t + 9 <- 4q + 2, 4q + 3)
        if constexpr (INT4) {
          uint32_t pa[8], pb[8];
          int4_word_pairs<T>(wa[0], pa);
          int4_word_pairs<T>(wa[1], pa + 4);
          int4_word_pairs<T>(wb[0], pb);
          int4_word_pairs<T>(wb[1], pb + 4);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            af[v][q][0] = pa[2 * q], af[v][q][1] = pb[2 * q];
            af[v][q][2] = pa[2 * q + 1], af[v][q][3] = pb[2 * q + 1];
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            int8_word_pairs<T>(wa[q], &af[v][q][0], &af[v][q][2]);
            int8_word_pairs<T>(wb[q], &af[v][q][1], &af[v][q][3]);
          }
        }
      }
      // x words of step q: (k 4q, 4q + 1) and (4q + 2, 4q + 3)
#pragma unroll
      for (int v = 0; v < U; ++v)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            if (nt < NT / 2 + 1 || nt < p.ntl) {
              const uint4& xq = xv[v][nt][q >> 1];
              mma16816<T>(c[nt][(4 * v + q) % ACC], af[v][q],
                          q & 1 ? xq.z : xq.x, q & 1 ? xq.w : xq.y);
            }
    };
    for (int n = 0; n < ns; ++n) {
      const int slot = n % STAGES;
      mb_wait(full + slot, (n / STAGES) & 1);   // the stage landed
      const unsigned char* st = smem + slot * stage;
      // this warp's sub-blocks that hold k < K
      const int k0 = (s0 + n) * F::SK;
      const int nv = min(per, (K - k0 + KSUB - 1) / KSUB - sb0);
      int j = 0;
      if constexpr (NT <= 2)
        for (; j + 2 <= nv; j += 2)
          sub_blocks(st, sb0 + j, std::integral_constant<int, 2>());
      for (; j < nv; ++j)
        sub_blocks(st, sb0 + j, std::integral_constant<int, 1>());
      __syncwarp();
      if (lane == 0) mb_arrive(empty + slot);   // this warp is done
    }
  }

  // ---- epilogue: k groups in order, then ranks in order ----
  __syncthreads();   // every stage consumed: the ring's bytes are free
  // the next grid may start its prologue (it waits for this one to end
  // before it reads x or writes anything)
  if (PDL) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tn = ct * ATILE, rows = 8 * p.ntl, part = rows * tn;
  float* red = reinterpret_cast<float*>(smem);   // [kgn][rows][tn]
  if (warp < active) {
    const int a = warp % ct, kg = warp / ct, r = rho<INT4>(g);
    // c[nt]: channels r, r + 8 of tile a x rows 8 nt + 2t, + 1
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt < NT / 2 + 1 || nt < p.ntl)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = c[nt][0][e];
#pragma unroll
          for (int j = 1; j < ACC; ++j) v += c[nt][j][e];
          red[(kg * rows + nt * 8 + 2 * t + (e & 1)) * tn + a * ATILE + r +
              8 * (e >> 1)] = v;
        }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < part; i += NTHREADS) {
    float v = red[i];
    for (int q = 1; q < kgn; ++q) v += red[q * part + i];
    red[i] = v;
  }
  if (p.cluster > 1)
    cluster_sync();
  else
    __syncthreads();
  const int per = (part + p.cluster - 1) / p.cluster;
  const int i1 = min(part, (rank + 1) * per);
  for (int i = rank * per + threadIdx.x; i < i1; i += NTHREADS) {
    float v = rank == 0 ? red[i] : ld_cluster(red + i, 0);
    for (int q = 1; q < p.cluster; ++q)
      v += q == rank ? red[i] : ld_cluster(red + i, q);
    const int m = i / tn, n = a0 * ATILE + (i - m * tn);
    if (m < M && n < N)
      out[static_cast<int64_t>(m) * N + n] = from_f32<T>(v * scale[n]);
  }
  if (p.cluster > 1) cluster_sync();   // no block leaves while read
}

// ---- host side ---------------------------------------------------------

int smem_bytes(bool int4, int ct, int ntl) {
  const int sb = int4 ? Fmt<true>::SB : Fmt<false>::SB;
  return 1024 + STAGES * (ct * WBOX + sb * ntl * XTILE) +
         2 * STAGES * static_cast<int>(sizeof(uint64_t));
}

// channel groups for a cluster size: the first multiple of the card's
// wave (sms / c groups) that keeps a group within MAX_CT A tiles, and no
// more groups than A tiles
int plan_groups(int tiles, int c, int sms) {
  const int gmin = (tiles + MAX_CT - 1) / MAX_CT;
  int w = 1;
  while (w * sms / c < gmin) ++w;
  return std::min(tiles, w * sms / c);
}

// the plan of one shape on a card of `sms` SMs (kernels/int4_matmul.py
// `gemv_plan` is its twin). A cluster of 2 when its blocks, at most two an
// SM, all fit two to an SM's shared memory (the consumers' latency is
// hidden by a second block's warps; on an H100 SXM at 700 W, int8 gate /
// up at M 8 ran 0.0254 ms so against 0.0333 in one block an SM).
// Otherwise the cheaper of 1 and 2:
// the cost of a candidate is the bytes its slowest block streams (its
// weights, half its x, which it reads from L2, and a fixed cost for the
// ring's first fill and the epilogue) times the waves, over the share of
// SMs the grid keeps busy. Clusters of 3, 4 and 8 measured slower at
// nearly every step shape (PERF.md §6, the GEMV variants).
Plan make_plan(int M, int N, int K, bool int4, int sms) {
  const int sk = int4 ? Fmt<true>::SK : Fmt<false>::SK;
  const int sb = int4 ? Fmt<true>::SB : Fmt<false>::SB;
  Plan p = {};
  p.nst = (K + sk - 1) / sk;
  p.tiles = (N + ATILE - 1) / ATILE;
  p.ntl = (M + 7) / 8;
  sms = std::max(1, sms);
  double best = -1.0;
  for (int c = 1; c <= MAX_CLUSTER; ++c) {
    if (c > 1 && c > p.nst) break;
    const int g = plan_groups(p.tiles, c, sms);
    const int ct = (p.tiles + g - 1) / g, spr = (p.nst + c - 1) / c;
    const int blocks = g * c, waves = (blocks + sms - 1) / sms;
    const double per_block =
        spr * (ct * WBOX + sb * M * 64.0) + 16384.0;
    double cost = waves * per_block * sms / std::min(blocks, sms);
    if (c == 2 && blocks <= 2 * sms &&
        smem_bytes(int4, ct, p.ntl) <= TWO_A_SM)
      cost = 0.0;
    if (best < 0.0 || cost < best) {
      best = cost;
      p.groups = g;
      p.cluster = c;
      p.spr = spr;
    }
  }
  p.smem = smem_bytes(int4, (p.tiles + p.groups - 1) / p.groups, p.ntl);
  return p;
}

int device_sms() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0)
    cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev];
}

// a row-major [outer, inner] matrix of `elem`-byte elements (rows of
// `row_bytes`) in boxes of [box_outer, box_inner] under the 128-byte
// swizzle, zeros past its edges
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
            uint64_t inner, uint64_t outer, uint64_t row_bytes,
            uint32_t box_inner, uint32_t box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool INT4, int NT>
int launch_nt(const CUtensorMap& tw, const CUtensorMap& tx,
              const float* scale, void* out, int M, int N, int K,
              const Plan& p, cudaStream_t stream) {
  auto kern = gemv_kernel<T, INT4, NT>;
  static int smem_opt_in = 0;   // the kernel's shared memory attribute
  if (p.smem > smem_opt_in) {
    const int bytes = std::max(p.smem, smem_bytes(INT4, MAX_CT, NT));
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_opt_in = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.groups, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[2];
  int na = 0;
  if (PDL) {
    at[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    at[na++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (p.cluster > 1) {
    at[na].id = cudaLaunchAttributeClusterDimension;
    at[na].val.clusterDim.x = p.cluster;
    at[na].val.clusterDim.y = 1;
    at[na++].val.clusterDim.z = 1;
  }
  cfg.attrs = at;
  cfg.numAttrs = na;
  T* o = static_cast<T*>(out);
  Plan pp = p;
  void* args[] = {const_cast<CUtensorMap*>(&tw),
                  const_cast<CUtensorMap*>(&tx),
                  &scale, &o, &M, &N, &K, &pp};
  cudaError_t e =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kern), args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool INT4>
int launch(const void* x, const void* w, const float* scale, void* out,
           int M, int N, int K, cudaStream_t stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (M > 64 || K % 32 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(M, N, K, INT4, device_sms());
  if (p.groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t kb = INT4 ? K / 2 : K;   // bytes of a weight row
  CUtensorMap tw, tx;
  if (!encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, kb, N, kb, ROW, ATILE) ||
      !encode(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT16, x, K, M, 2 * uint64_t(K),
              KSUB, 8 * p.ntl))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.ntl <= 1)
    return launch_nt<T, INT4, 1>(tw, tx, scale, out, M, N, K, p, stream);
  if (p.ntl <= 2)
    return launch_nt<T, INT4, 2>(tw, tx, scale, out, M, N, K, p, stream);
  if (p.ntl <= 4)
    return launch_nt<T, INT4, 4>(tw, tx, scale, out, M, N, K, p, stream);
  return launch_nt<T, INT4, 8>(tw, tx, scale, out, M, N, K, p, stream);
}

template <bool INT4>
int dispatch(int dtype, const void* x, const void* w, const float* scale,
             void* out, int M, int N, int K, cudaStream_t s) {
  switch (dtype) {
    case PTT_BF16:
      return launch<__nv_bfloat16, INT4>(x, w, scale, out, M, N, K, s);
    case PTT_F16:
      return launch<__half, INT4>(x, w, scale, out, M, N, K, s);
    default:   // the tensor cores take bf16 / f16 x
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [M, K] (bf16 / f16, `dtype`), w int8 [N, K] or packed int4 [N, K / 2]
// (`int4`), scale f32 [N], out [M, N] (x's type); all contiguous, x and w
// 16-byte aligned, 0 < K a multiple of 32, M <= 64
extern "C" int weight_only_gemv_launch(const void* x, const void* w,
                                       const void* scale, void* out, int M,
                                       int N, int K, int int4, int dtype,
                                       void* stream) {
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int4 ? dispatch<true>(dtype, x, w, sc, out, M, N, K, s)
              : dispatch<false>(dtype, x, w, sc, out, M, N, K, s);
}

// the plan the launch would use on a card of `sms` SMs (0: the current
// device's): out int32 [7] = groups, cluster, stages a rank, stages, A
// tiles, n8 row tiles, shared memory bytes
extern "C" int weight_only_gemv_plan(int M, int N, int K, int int4, int sms,
                                     int* out) {
  const Plan p = make_plan(M, N, K, int4 != 0, sms > 0 ? sms : device_sms());
  const int v[7] = {p.groups, p.cluster, p.spr, p.nst, p.tiles, p.ntl,
                    p.smem};
  std::copy(v, v + 7, out);
  return 0;
}
