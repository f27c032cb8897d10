// Raw building blocks of the port's tensor-core kernels: asynchronous
// global -> shared copies (cp.async), fragment loads from shared memory
// (ldmatrix) and the m16n8k16 warp-level product (mma.sync) with f32
// accumulation, in bf16 or f16. One copy for every kernel that uses them.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 g + t): A [16 x 16] row
// major, a[0] = (row g, k 2t..2t+1), a[1] = (row g + 8, same k), a[2] =
// (row g, k 2t+8..2t+9), a[3] = (row g + 8, k 2t+8..); B [16 x 8] column
// major, b0 = (k 2t..2t+1, column g), b1 = (k 2t+8..2t+9, column g); C
// [16 x 8] f32, c[0..1] = (row g, columns 2t, 2t+1), c[2..3] = (row g + 8,
// same columns). Two neighbouring C tiles of one row block, packed to
// 16-bit pairs, are therefore one A fragment of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, zero-filled when !valid (no byte is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8 f32] += a[16x16 T] b[16x8 T], T bf16 (the default) or f16
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same<T, __nv_bfloat16>::value,
                  "mma16816 takes bf16 or f16");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// (lo, hi) rounded to a packed pair of T (lo in the low half)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// four int8 weights (one 32-bit word, k ascending from the low byte) ->
// two packed pairs of T holding them exactly: lo = (byte 0, byte 1), hi =
// (byte 2, byte 3). Each byte goes through the f32 form of the
// magic-number trick (2^23 + (b ^ 128), less 2^23 + 128), exact since
// |b| <= 128. An integer of at most 8 significant bits has zero low 16
// bits in f32, so bf16 pairs are the f32 words' high halves (one byte
// permute, no conversion); f16 pairs take one packing conversion.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void int8_word_pairs(uint32_t w, uint32_t* lo,
                                                uint32_t* hi) {
  const uint32_t v = w ^ 0x80808080u;                // offset binary
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u + i)) -
           8388736.f;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
    *hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
  } else {
    *lo = pack2<T>(f[0], f[1]);
    *hi = pack2<T>(f[2], f[3]);
  }
}

// a packed pair of T -> its two values in f32
template <typename T = __nv_bfloat16>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
