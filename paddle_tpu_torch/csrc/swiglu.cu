// Fused SwiGLU, forward and backward: g = x @ Wg, u = x @ Wu (x [M, K],
// Wg / Wu [K, F], bf16; f32 sums over K), then one elementwise epilogue in
// f32 and one rounding at the write:
//   forward   out  = silu(g) * u                       [M, F]
//   backward  dh_g = dout * u * silu'(g), dh_u = dout * silu(g)
// with silu(g) = g * sigmoid(g), silu'(g) = sig * (1 + g * (1 - sig)).
//
// Replaces the Pallas kernels paddle_tpu/kernels/swiglu.py
// `_swiglu_fwd_kernel` (launched by `_fwd_pallas`) and `_swiglu_bwd_kernel`
// (launched by `_bwd_pallas`). The backward recomputes g and u per tile, as
// the TPU kernel does: not saving the two [M, F] products is the point of
// the fused MLP (paddle_tpu/models/llama.py:75-80). dx, dWg and dWu are
// plain matrix products outside the kernel, as XLA's dots are in JAX.
//
// Bound on the H100: operations. 4*M*K*F flops against (M*K + 2*K*F +
// M*F) * 2 bytes (forward; the backward reads dout and writes two [M, F])
// is hundreds of flops per byte at the MLP's shapes.
//
// Design: one warp-specialized kernel on Hopper's warpgroup MMA for both
// directions. A CTA owns 128 x 128 outputs, so 128 x 128 of g and of u.
// Two consumer warpgroups own 64 rows each; for every k16 step each issues
// wgmma.mma_async m64n128k16 twice, once over Wg's tile and once over
// Wu's, both operands from shared memory, f32 accumulators in registers
// (2 x 64 a thread): x's tile feeds both products, the fusion the TPU
// kernel makes. A producer warpgroup (one thread issues, the rest idle)
// keeps TMA loads (cp.async.bulk.tensor) of x [128 x 64] and Wg, Wu
// [64 x 128] in flight into a ring of STAGES stages of 48 KB under the
// 128-byte swizzle, with a full / empty mbarrier pair a stage: no
// block-wide barrier in the K loop. setmaxnreg moves registers from the
// producer (40) to the consumers (232). A consumer keeps one stage's
// products in flight (wgmma.wait_group 1) and hands the stage before back
// to the producer. W is [K, F] with F contiguous, so B is MN-major (the
// transpose bit): a 64-wide TMA box per half of the 128 columns, the
// descriptor's leading byte offset the distance between the halves and
// its stride byte offset the distance between groups of 8 k rows
// (swiglu_wgmma_probe_launch runs one tile through the same code for the
// card tests). The epilogue runs on the accumulators: the m64nN layout
// puts g and u of one output in the same thread at the same index, so
// silu(g) * u needs no exchange; each thread reads dout and writes the
// outputs as bf16 pairs. The grid is persistent (the wrapper passes one
// CTA per SM, kernels/swiglu.py `swiglu_grid`): each CTA walks
// output tiles grouped GROUP_M m-tiles at a time over the n-tiles (the
// tiles in flight share x and W panels in the 50 MB L2), and the producer
// runs ahead into the next tile while the consumers finish one, so an
// epilogue overlaps the next tile's loads. A grid of one CTA a tile is the
// same kernel without that overlap. The tensor maps are encoded on the host
// at each launch (x's pointer changes every call) through the driver entry
// point cuTensorMapEncodeTiled, fetched at run time (no -lcuda), and passed
// as __grid_constant__ parameters. Shapes must be multiples of the tiles
// (M, F of 128, K of 64); the wrapper routes only 512-aligned shapes here.
#include <cuda.h>

#include "common.cuh"
#include "fragments.cuh"
#include "weight_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                   // warpgroups of 64 rows
constexpr int NTHREADS = (CONSUMERS + 1) * 128;
constexpr int GROUP_M = 8;
constexpr int X_BYTES = BM * BK * 2;           // 16 KB, 128 rows of 128 B
constexpr int W_HALF = BK * 64 * 2;            // 8 KB: 64 k rows x 64 cols
constexpr int STAGE_BYTES = X_BYTES + 4 * W_HALF;
// B (W, MN-major, 128-byte swizzle): the two 64-column halves of a tile
// lie W_HALF apart (leading byte offset); 8 k rows of 128 bytes are one
// swizzle atom (stride byte offset)
constexpr int B_LBO = W_HALF, B_SBO = 1024;
// A (x, K-major, 128-byte swizzle): 8 rows of 128 bytes a core group
constexpr int A_SBO = 1024;
constexpr size_t SMEM_BYTES =
    size_t(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t) + 1024;
static_assert(SMEM_BYTES <= 227 * 1024,
              "the ring must fit the shared memory a block may opt into");

// ---- wgmma ---------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] (K-major) B[16 x 128] (MN-major), bf16 -> f32
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// one BK-deep slice of a stage: 64 rows of x (from `xs`, rows of 128 B)
// against a 128-column W tile (`ws`: two 64-column halves W_HALF apart)
__device__ __forceinline__ void slice_products(float (&d)[64],
                                               const unsigned char* xs,
                                               const unsigned char* ws) {
#pragma unroll
  for (int k = 0; k < BK / 16; ++k)
    wgmma_m64n128k16(d, desc_sw128(xs + 32 * k, 16, A_SBO),
                     desc_sw128(ws + 16 * 128 * k, B_LBO, B_SBO));
}

__device__ __forceinline__ float sigmoid_f32(float g) {
  return 1.f / (1.f + expf(-g));
}

// the (m0, n0) origin of output tile `t`: GROUP_M m-tiles side by side
// over the n-tiles
__device__ __forceinline__ void tile_origin(int t, int n_m, int n_n,
                                            int* m0, int* n0) {
  const int per_group = GROUP_M * n_n;
  const int first_m = (t / per_group) * GROUP_M;
  const int group_m = min(n_m - first_m, GROUP_M);
  *m0 = (first_m + (t % per_group) % group_m) * BM;
  *n0 = ((t % per_group) / group_m) * BN;
}

// BACKWARD = false: out = silu(g) * u; true: dh_g, dh_u from dout
template <bool BACKWARD>
__global__ void __launch_bounds__(NTHREADS, 1)
    swiglu_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tg,
                  const __grid_constant__ CUtensorMap tu,
                  const bf16* __restrict__ dout, bf16* __restrict__ out0,
                  bf16* __restrict__ out1, int M, int K, int F) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int n_m = M / BM, n_n = F / BN, tiles = n_m * n_n, KT = K / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mb_init(&full[s], 1);
      mb_init(&empty[s], CONSUMERS * 4);   // one arrival a consumer warp
    }
    mb_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, n_m, n_n, &m0, &n0);
        for (int kt = 0; kt < KT; ++kt) {
          mb_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * STAGE_BYTES;
          mb_expect_tx(&full[stage], STAGE_BYTES);
          const int k0 = kt * BK;
          tma_load(st, &tx, &full[stage], k0, m0);
          tma_load(st + X_BYTES, &tg, &full[stage], n0, k0);
          tma_load(st + X_BYTES + W_HALF, &tg, &full[stage], n0 + 64, k0);
          tma_load(st + X_BYTES + 2 * W_HALF, &tu, &full[stage], n0, k0);
          tma_load(st + X_BYTES + 3 * W_HALF, &tu, &full[stage], n0 + 64,
                   k0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_origin(t, n_m, n_n, &m0, &n0);
      float accg[64], accu[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) accg[i] = accu[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < KT; ++kt) {
        mb_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * STAGE_BYTES;
        const unsigned char* xs = st + wg * 64 * 128;
        acc_fence(accg);
        acc_fence(accu);
        wgmma_fence();
        slice_products(accg, xs, st + X_BYTES);
        slice_products(accu, xs, st + X_BYTES + 2 * W_HALF);
        wgmma_commit();
        acc_fence(accg);
        acc_fence(accu);
        // the previous stage's products are done: hand its buffers back
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mb_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      acc_fence(accg);
      acc_fence(accu);
      if (prev >= 0 && lane == 0) mb_arrive(&empty[prev]);

      // epilogue in f32 on the accumulators: element 4 j + e of this
      // thread is row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane %
      // 4) + e % 2 of the warpgroup's 64 x 128 block
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wg * 64 + w * 16 + (lane >> 2) + half * 8;
          const int col = n0 + 8 * j + 2 * (lane & 3);
          const int64_t at = static_cast<int64_t>(row) * F + col;
          float2 d2 = make_float2(0.f, 0.f);
          if (BACKWARD)
            d2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(dout + at));
          float r0[2], r1[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float g = accg[4 * j + 2 * half + e];
            const float u = accu[4 * j + 2 * half + e];
            const float sig = sigmoid_f32(g);
            const float silu = g * sig;
            if (BACKWARD) {
              const float d = e ? d2.y : d2.x;
              const float dsilu = sig * (1.f + g * (1.f - sig));
              r0[e] = d * u * dsilu;
              r1[e] = d * silu;
            } else {
              r0[e] = silu * u;
              r1[e] = 0.f;
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(out0 + at) =
              __floats2bfloat162_rn(r0[0], r0[1]);
          if (BACKWARD)
            *reinterpret_cast<__nv_bfloat162*>(out1 + at) =
                __floats2bfloat162_rn(r1[0], r1[1]);
        }
    }
  }
}

// C [64, 128] f32 = A [64, 64] (row-major) B [64, 128] (row-major) on one
// warpgroup through the kernel's TMA boxes, descriptors and products (the
// card tests' probe of the MN-major descriptor)
__global__ void __launch_bounds__(128)
    wgmma_probe_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, float* c) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 64 * 128 + 2 * W_HALF);
  if (threadIdx.x == 0) {
    mb_init(bar, 1);
    mb_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mb_expect_tx(bar, 64 * 128 + 2 * W_HALF);
    tma_load(smem, &ta, bar, 0, 0);
    tma_load(smem + 64 * 128, &tb, bar, 0, 0);
    tma_load(smem + 64 * 128 + W_HALF, &tb, bar, 64, 0);
  }
  mb_wait(bar, 0);
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  acc_fence(d);
  wgmma_fence();
  slice_products(d, smem, smem + 64 * 128);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence(d);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = w * 16 + (lane >> 2) + 8 * ((i & 3) >> 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    c[row * 128 + col] = d[i];
  }
}

// ---- host side ---------------------------------------------------------

// a row-major bf16 [rows, cols] matrix in boxes of [box_rows, 64] (64
// bf16 = 128 bytes, the 128-byte swizzle's row)
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool BACKWARD>
int launch(const void* x, const void* wg, const void* wu, const void* dout,
           void* out0, void* out1, int M, int K, int F, int grid,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        swiglu_kernel<BACKWARD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (M % BM || F % BN || K % BK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || F == 0) return static_cast<int>(cudaGetLastError());
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tg, tu;
  if (!encode(&tx, x, M, K, BM) || !encode(&tg, wg, K, F, BK) ||
      !encode(&tu, wu, K, F, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  swiglu_kernel<BACKWARD><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      tx, tg, tu, static_cast<const bf16*>(dout), static_cast<bf16*>(out0),
      static_cast<bf16*>(out1), M, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int swiglu_fwd_launch(const void* x, const void* wg,
                                 const void* wu, void* out, int M, int K,
                                 int F, int grid, void* stream) {
  return launch<false>(x, wg, wu, nullptr, out, nullptr, M, K, F, grid,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int swiglu_bwd_launch(const void* x, const void* wg,
                                 const void* wu, const void* dout, void* dh_g,
                                 void* dh_u, int M, int K, int F, int grid,
                                 void* stream) {
  return launch<true>(x, wg, wu, dout, dh_g, dh_u, M, K, F, grid,
                      static_cast<cudaStream_t>(stream));
}

// c [64, 128] f32 = a [64, 64] @ b [64, 128] (bf16, row-major) through one
// warpgroup's products
extern "C" int swiglu_wgmma_probe_launch(const void* a, const void* b,
                                         void* c, void* stream) {
  constexpr int bytes = 64 * 128 + 2 * W_HALF + 64 + 1024;
  CUtensorMap ta, tb;
  if (!encode(&ta, a, 64, 64, 64) || !encode(&tb, b, 64, 128, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  wgmma_probe_kernel<<<1, 128, bytes, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}
