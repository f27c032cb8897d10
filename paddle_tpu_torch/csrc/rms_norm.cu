// RMSNorm forward: y = (x * rsqrt(mean(x^2) + eps) * w) over the last axis.
//
// Replaces the Pallas kernel paddle_tpu/kernels/rms_norm.py `_rms_kernel`
// (launched by `_rms_pallas`).
//
// Bound on the H100: bytes. Each row is read once and written once
// (2*N*D*itemsize + D*itemsize for w) and the arithmetic is a few flops per
// element, far below the ~295 flop/byte the card needs to be compute-bound.
//
// Design: one block per row, 16-byte vector loads (8 bf16 lanes) so a warp
// moves 512 contiguous bytes per instruction. The sum of squares is kept in
// f32, reduced by warp shuffles and one shared-memory step across warps.
// The second pass re-reads the row (it is still in L1/L2: one row is
// 8 KB at hidden 4096) and writes (x32 * inv * w32) cast once to the
// input type -- the JAX kernel's rounding order (rms_norm.py:26), not the
// Hugging Face order that casts before multiplying by w.
#include "common.cuh"

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ w, T* __restrict__ out,
                                int dim, float eps) {
  using V = Vec<T, VEC>;
  const int64_t row = blockIdx.x;
  const V* xr = reinterpret_cast<const V*>(x + row * dim);
  const V* wr = reinterpret_cast<const V*>(w);
  V* orow = reinterpret_cast<V*>(out + row * dim);
  const int nvec = dim / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    V a = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = to_f32(a.v[j]);
      ss += f * f;
    }
  }
  __shared__ float partial[32];
  __shared__ float inv_s;
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float t = lane < nwarps ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) inv_s = rsqrtf(t / static_cast<float>(dim) + eps);
  }
  __syncthreads();
  const float inv = inv_s;

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    V a = xr[i];
    V g = wr[i];
    V o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_f32<T>(to_f32(a.v[j]) * inv * to_f32(g.v[j]));
    orow[i] = o;
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int64_t rows, int dim,
            float eps, bool vec, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = vec ? dim / VEC : dim;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  if (vec) {
    rms_norm_kernel<T, VEC><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), dim, eps);
  } else {
    rms_norm_kernel<T, 1><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), dim, eps);
  }
}

}  // namespace

extern "C" int rms_norm_launch(const void* x, const void* w, void* out,
                               int64_t rows, int dim, float eps, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (rows > 0) {
    switch (dtype) {
      case PTT_F32:
        launch<float>(x, w, out, rows, dim, eps, aligned && dim % 4 == 0, s);
        break;
      case PTT_BF16:
        launch<__nv_bfloat16>(x, w, out, rows, dim, eps,
                              aligned && dim % 8 == 0, s);
        break;
      case PTT_F16:
        launch<__half>(x, w, out, rows, dim, eps, aligned && dim % 8 == 0, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
