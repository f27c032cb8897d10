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
// Design (simple first: mma.sync, not yet wgmma + TMA). One block of eight
// warps owns a 128 x 128 tile of the output and both of its f32
// accumulators (g and u), so x's tile is read once for the two products
// (the fusion the TPU kernel makes). K streams in 32-wide slices through a
// three-stage cp.async ring in shared memory (81 KB, opted in past the 48 KB
// default); warps take 64 x 32 sub-tiles and feed m16n8k16 bf16 mma.sync
// from ldmatrix (x row-major; W's [k][n] rows transposed by ldmatrix.trans).
// The epilogue runs on the accumulators in registers: each thread owns
// pairs of adjacent columns, so dout is read and the outputs written as
// bf16 pairs. Blocks are grouped 8 m-tiles at a time over the n-tiles, so
// the blocks in flight share x and W panels in the 50 MB L2. Shapes must be
// multiples of the tiles (M, F of 128, K of 32); the wrapper routes only
// 512-aligned shapes here.
#include "common.cuh"
#include "fragments.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int STAGES = 3;
constexpr int NTHREADS = 256;         // 8 warps: 2 (m) x 4 (n)
constexpr int WM = 64, WN = 32;       // a warp's sub-tile
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int GROUP_M = 8;
constexpr int LDA = BK + 8;           // bf16 x rows in smem (banks)
constexpr int LDB = BN + 8;           // bf16 W rows in smem
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = BK * LDB;
constexpr int STAGE_ELEMS = A_ELEMS + 2 * B_ELEMS;
constexpr size_t SMEM_BYTES = size_t(STAGES) * STAGE_ELEMS * sizeof(bf16);

// one K slice [k0, k0 + BK) of x's m-tile and of Wg's / Wu's n-tile into
// a stage (16-byte cp.async; two chunks per thread per operand)
__device__ __forceinline__ void load_stage(bf16* st, const bf16* x,
                                           const bf16* wg, const bf16* wu,
                                           int m0, int n0, int k0, int K,
                                           int F) {
  bf16* As = st;
  bf16* Bg = st + A_ELEMS;
  bf16* Bu = Bg + B_ELEMS;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;   // 0 .. 511
    const int ar = idx >> 2, ac = (idx & 3) * 8;  // x: 128 rows x 4 chunks
    cp_async16(As + ar * LDA + ac,
               x + static_cast<int64_t>(m0 + ar) * K + k0 + ac);
    const int br = idx >> 4, bc = (idx & 15) * 8;  // W: 32 rows x 16 chunks
    const int64_t off = static_cast<int64_t>(k0 + br) * F + n0 + bc;
    cp_async16(Bg + br * LDB + bc, wg + off);
    cp_async16(Bu + br * LDB + bc, wu + off);
  }
}

__device__ __forceinline__ float sigmoid_f32(float g) {
  return 1.f / (1.f + expf(-g));
}

// BACKWARD = false: out = silu(g) * u; true: dh_g, dh_u from dout
template <bool BACKWARD>
__global__ void __launch_bounds__(NTHREADS, 1)
    swiglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                  const bf16* __restrict__ wu, const bf16* __restrict__ dout,
                  bf16* __restrict__ out0, bf16* __restrict__ out1, int M,
                  int K, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  // grouped rasterization: GROUP_M m-tiles side by side over the n-tiles
  const int n_m = M / BM, n_n = F / BN;
  const int bid = blockIdx.x;
  const int per_group = GROUP_M * n_n;
  const int first_m = (bid / per_group) * GROUP_M;
  const int group_m = min(n_m - first_m, GROUP_M);
  const int m0 = (first_m + (bid % per_group) % group_m) * BM;
  const int n0 = ((bid % per_group) / group_m) * BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * WM;   // 0 or 64
  const int wn = (warp & 3) * WN;    // 0, 32, 64, 96

  float accg[MI][NI][4], accu[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[i][j][e] = accu[i][j][e] = 0.f;

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage(smem + s * STAGE_ELEMS, x, wg, wu, m0, n0, s * BK, K, F);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt landed; every warp is done with kt - 1
    const int next = kt + STAGES - 1;
    if (next < KT)
      load_stage(smem + (next % STAGES) * STAGE_ELEMS, x, wg, wu, m0, n0,
                 next * BK, K, F);
    cp_async_commit();

    const bf16* As = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* Bg = As + A_ELEMS;
    const bf16* Bu = Bg + B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MI][4], bg[NI][2], bu[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(a[i], As + (wm + i * 16 + (lane & 15)) * LDA + kk +
                              (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        const int off = (kk + (lane & 15)) * LDB + wn + j * 8 +
                        (lane >> 4) * 8;
        uint32_t r[4];
        ldsm_x4_trans(r, Bg + off);
        bg[j][0] = r[0]; bg[j][1] = r[1]; bg[j + 1][0] = r[2];
        bg[j + 1][1] = r[3];
        ldsm_x4_trans(r, Bu + off);
        bu[j][0] = r[0]; bu[j][1] = r[1]; bu[j + 1][0] = r[2];
        bu[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          mma16816(accg[i][j], a[i], bg[j][0], bg[j][1]);
          mma16816(accu[i][j], a[i], bu[j][0], bu[j][1]);
        }
    }
  }
  cp_async_wait<0>();

  // epilogue in f32 on the accumulators: thread (g, t) of a warp owns
  // rows g and g + 8 of each 16 x 8 tile, columns 2t and 2t + 1
  const int gr = lane >> 2, tc = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + i * 16 + gr + half * 8;
        const int col = n0 + wn + j * 8 + tc;
        const int64_t at = static_cast<int64_t>(row) * F + col;
        float2 res0, res1;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g = accg[i][j][2 * half + e];
          const float u = accu[i][j][2 * half + e];
          const float sig = sigmoid_f32(g);
          const float silu = g * sig;
          float r0, r1 = 0.f;
          if (BACKWARD) {
            const float d = __bfloat162float(dout[at + e]);
            const float dsilu = sig * (1.f + g * (1.f - sig));
            r0 = d * u * dsilu;
            r1 = d * silu;
          } else {
            r0 = silu * u;
          }
          (e ? res0.y : res0.x) = r0;
          (e ? res1.y : res1.x) = r1;
        }
        *reinterpret_cast<__nv_bfloat162*>(out0 + at) =
            __floats2bfloat162_rn(res0.x, res0.y);
        if (BACKWARD)
          *reinterpret_cast<__nv_bfloat162*>(out1 + at) =
              __floats2bfloat162_rn(res1.x, res1.y);
      }
}

template <bool BACKWARD>
int launch(const void* x, const void* wg, const void* wu, const void* dout,
           void* out0, void* out1, int M, int K, int F, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        swiglu_kernel<BACKWARD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  if (M % BM || F % BN || K % BK) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (M / BM) * (F / BN);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  swiglu_kernel<BACKWARD><<<blocks, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(dout),
      static_cast<bf16*>(out0), static_cast<bf16*>(out1), M, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int swiglu_fwd_launch(const void* x, const void* wg,
                                 const void* wu, void* out, int M, int K,
                                 int F, void* stream) {
  return launch<false>(x, wg, wu, nullptr, out, nullptr, M, K, F,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int swiglu_bwd_launch(const void* x, const void* wg,
                                 const void* wu, const void* dout, void* dh_g,
                                 void* dh_u, int M, int K, int F,
                                 void* stream) {
  return launch<true>(x, wg, wu, dout, dh_g, dh_u, M, K, F,
                      static_cast<cudaStream_t>(stream));
}
