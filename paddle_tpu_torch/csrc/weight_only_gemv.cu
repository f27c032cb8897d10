// Weight-only dequant GEMV for decode-shaped matmuls: out [M, N] =
// (x [M, K] @ W^T) * scale [N], W stored per output channel as int8 [N, K]
// or packed int4 [N, K / 2] (low nibble = even k, high nibble = odd k).
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
// rounded once to x's type.
//
// Bound on the H100: bytes. At decode M (8 rows) the kernel does 2*M flops
// per weight value and must stream every weight byte once: 0.5 byte per
// value for int4, 1 for int8, so a Llama-3-8B decode step needs about 3.75
// GB of int4 weights (1.1 ms at 3.35 TB/s) against 15 GB of bf16.
//
// Design. A first version on the CUDA cores spent about 13 instructions per
// weight value (the unpack and one FMA per x row) and ran at 7-13% of the
// byte bound on the large shapes (chip_smoke.py, NVIDIA H100 80GB HBM3 at
// 700 W); this one keeps the CUDA cores to the unpack and gives the
// products to mma.sync m16n8k16 (A = a 16-channel x 16-k tile of W, B = the
// 8 x rows, f32 accumulators):
// - a block of 8 warps owns 16 output channels and 8 rows of x (grid.y walks
//   M in groups of 8; the main path runs M = 8, one group). The warps split
//   K in 128-value blocks and add their partial tiles through shared
//   memory at the end, so even N = 1024 gives 64 blocks;
// - the TPU kernel keeps all of x in VMEM; on the card x does not fit in
//   shared memory whole (M = 8, K = 14336 bf16 is 229 KB), and it needs no
//   staging: each thread reads the 32 x values of its k range straight
//   from global memory (L1 / L2 resident, shared by every block);
// - no shuffle of the fixed [N, K/2] layout is needed: the reduction is
//   free to permute k, so within a 128-value block thread (g, t) of a warp
//   (g = lane / 4, t = lane % 4) takes k in [32t, 32t + 32) of channels g
//   and g + 8, one 16-byte load per channel (int4; two for int8), and at
//   step s (0..7) feeds k = 32t + 4s + {0, 1} into its A / B slots 2t, 2t+1
//   and 32t + 4s + {2, 3} into slots 2t+8, 2t+9. Its B values are then four
//   consecutive x values (one 8-byte word), read as they lie in memory;
// - nibbles widen with the magic-number trick: (n ^ 8) | 0x4300 is the
//   bf16 of 128 + (n ^ 8), less 136 gives the signed value exactly (f16:
//   0x6400 and 1032); int8 bytes go through the f32 form of the same trick
//   (2^23 + (b ^ 128)) and one packing conversion;
// - ragged N and M are masked (zeros in, no store); K must be a multiple of
//   32 (whole 16-byte loads of each thread), which the Python wrapper checks.
// A deeper load pipeline (cp.async / TMA double buffering) is later work.
#include "common.cuh"
#include "fragments.cuh"

namespace {

constexpr int NW = 8;            // warps per block, splitting K
constexpr int NTHREADS = NW * 32;
constexpr int TILE_N = 16;       // output channels per block
constexpr int TILE_M = 8;        // x rows per block
constexpr int KB = 128;          // k values per warp iteration

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

// two nibbles (already in offset binary, at bits [0, 4) and [16, 20) of
// `v`) -> a packed pair of exact small integers in T
template <typename T>
__device__ __forceinline__ uint32_t widen_nibbles(uint32_t v) {
  return sub2(v | Magic<T>::BASE, Magic<T>::BIAS, static_cast<T*>(nullptr));
}

// int4: the A pairs of step s from one channel's 16-byte load `w`:
// lo = (k 4s, 4s+1), hi = (k 4s+2, 4s+3), both as packed T pairs
template <typename T>
__device__ __forceinline__ void int4_pairs(const uint4& w, int s,
                                           uint32_t* lo, uint32_t* hi) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  const uint32_t v = words[s >> 1] ^ 0x88888888u;   // offset binary
  const uint32_t h = (s & 1) ? (v >> 16) : v;        // nibbles n0..n3
  *lo = widen_nibbles<T>((h & 0xFu) | ((h << 12) & 0xF0000u));
  *hi = widen_nibbles<T>(((h >> 8) & 0xFu) | ((h << 4) & 0xF0000u));
}

// int8: the A pairs of step s from one channel's two 16-byte loads
template <typename T>
__device__ __forceinline__ void int8_pairs(const uint4& w0, const uint4& w1,
                                           int s, uint32_t* lo,
                                           uint32_t* hi) {
  const uint32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  int8_word_pairs<T>(words[s], lo, hi);
}

template <typename T, bool INT4>
__global__ void __launch_bounds__(NTHREADS)
    gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, T* __restrict__ out, int M,
                int N, int K) {
  __shared__ float red[NW][4][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TILE_N, m0 = blockIdx.y * TILE_M;
  const int64_t kw = INT4 ? K / 2 : K;   // bytes per weight row
  const bool ok_a = n0 + g < N, ok_b = n0 + g + 8 < N, ok_x = m0 + g < M;
  const int8_t* wa = w + (n0 + g) * kw;
  const int8_t* wb = wa + 8 * kw;
  const T* xr = x + static_cast<int64_t>(m0 + g) * K;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = warp * KB; k0 < K; k0 += NW * KB) {
    const int k = k0 + 32 * t;           // this thread's 32 values
    const bool ok_k = k < K;             // K % 32 == 0: all in or out
    uint4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = ok_k && ok_x ? __ldg(reinterpret_cast<const uint4*>(xr + k) + i)
                           : zero;
    const int kbyte = INT4 ? k / 2 : k;
    uint4 a0 = zero, a1 = zero, b0 = zero, b1 = zero;
    if (ok_k && ok_a) {
      a0 = __ldg(reinterpret_cast<const uint4*>(wa + kbyte));
      if (!INT4) a1 = __ldg(reinterpret_cast<const uint4*>(wa + kbyte) + 1);
    }
    if (ok_k && ok_b) {
      b0 = __ldg(reinterpret_cast<const uint4*>(wb + kbyte));
      if (!INT4) b1 = __ldg(reinterpret_cast<const uint4*>(wb + kbyte) + 1);
    }
    const uint32_t xw[16] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w,
                             xv[1].x, xv[1].y, xv[1].z, xv[1].w,
                             xv[2].x, xv[2].y, xv[2].z, xv[2].w,
                             xv[3].x, xv[3].y, xv[3].z, xv[3].w};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      uint32_t a[4];   // {ch g k-lo, ch g+8 k-lo, ch g k-hi, ch g+8 k-hi}
      if constexpr (INT4) {
        int4_pairs<T>(a0, s, &a[0], &a[2]);
        int4_pairs<T>(b0, s, &a[1], &a[3]);
      } else {
        int8_pairs<T>(a0, a1, s, &a[0], &a[2]);
        int8_pairs<T>(b0, b1, s, &a[1], &a[3]);
      }
      mma16816<T>(c, a, xw[2 * s], xw[2 * s + 1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) red[warp][i][lane] = c[i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < NW; ++j) v += red[j][i][lane];
      // c0, c1: channel g, rows 2t, 2t+1; c2, c3: channel g + 8
      const int n = n0 + g + (i >> 1) * 8, m = m0 + 2 * t + (i & 1);
      if (n < N && m < M)
        out[static_cast<int64_t>(m) * N + n] = from_f32<T>(v * scale[n]);
    }
  }
}

template <typename T, bool INT4>
int launch(const void* x, const void* w, const float* scale, void* out,
           int M, int N, int K, cudaStream_t stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((N + TILE_N - 1) / TILE_N, (M + TILE_M - 1) / TILE_M);
  gemv_kernel<T, INT4><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<T*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
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
// 16-byte aligned, K a multiple of 32
extern "C" int weight_only_gemv_launch(const void* x, const void* w,
                                       const void* scale, void* out, int M,
                                       int N, int K, int int4, int dtype,
                                       void* stream) {
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int4 ? dispatch<true>(dtype, x, w, sc, out, M, N, K, s)
              : dispatch<false>(dtype, x, w, sc, out, M, N, K, s);
}
