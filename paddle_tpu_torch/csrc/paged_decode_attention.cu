// Paged single-query decode attention with grouped-query heads, over bf16
// (f32, f16) pools or int8 pools with per-(page, kv head) f32 scales.
//
// Replaces the Pallas kernels paddle_tpu/kernels/decode_attention.py
// `_paged_gqa_kernel` (launched by `_paged_decode_gqa`) and
// `_paged_decode_kernel` (equal heads, launched by `paged_decode_attention`),
// and their int8 twins `_paged_gqa_q8_kernel` and `_paged_decode_q8_kernel`:
// one kernel covers every group size Hq / Hkv >= 1, and a template
// parameter picks the pool element type.
//
// Inputs: q [B, Hq, D]; pools [max_pages, Hkv, block_size, D]; block
// tables [B, W] int32 page ids; lens [B] int32 = tokens cached before the
// current one. The current token was already written at position lens[b],
// so positions <= lens[b] are valid (decode_attention.py:283-288); pages
// past that are never read. int8 pools come with k/v scales
// [max_pages, Hkv] f32: a stored value x of page p, kv head h stands for
// x * scale[p, h].
//
// Bound on the H100: bytes. Every named K/V page is read once
// (2*B*ctx*Hkv*D*itemsize, plus 8 bytes of scales per page and kv head on
// int8 pools) for ~4 flops per element, so the kernel can at best stream
// the cache at memory rate; int8 pools halve the bytes.
//
// Design: the body shared with the contiguous-cache kernel
// (decode_attention_body.cuh): the page loop split across blocks, grid
// (splits, Hkv, B), each block walking a run of tiles of up to 64 rows
// (a page, or a piece of a larger page), the group's query heads scored
// together per read of K, K/V copied through a two-stage cp.async ring in
// the pool's own type (16 int8 or 8 bf16 elements per 16-byte copy), the
// online softmax in f32 per query head, and the splits' partials merged in
// split order by the row's last block. On int8 pools the page's two scales
// are applied where the JAX q8 body applies them
// (decode_attention.py:386-412). Out-of-range page ids are clamped into
// the pool so a bad table cannot read outside it.
#include "decode_attention_body.cuh"

namespace {

template <typename T, typename KT>
int launch(const void* q, const void* kc, const void* vc, const float* ksc,
           const float* vsc, const int* tables, const int* lens, void* out,
           float* part, int* counters, int B, int Hq, int Hkv, int D, int bs,
           int W, int P, int st, int tps, int splits, float scale,
           cudaStream_t stream) {
  if (st <= 0 || bs % st) return static_cast<int>(cudaErrorInvalidValue);
  return launch_decode<T, KT>(q, kc, vc, ksc, vsc, lens, out, part, counters,
                              B, Hq, Hkv, D, scale,
                              PagedTiles{tables, W, P, bs, st}, tps, splits,
                              stream);
}

// KT = void: the pool has q's type; KT = int8_t: an int8 pool with scales
template <typename KT>
int dispatch(int dtype, const void* q, const void* kc, const void* vc,
             const float* ksc, const float* vsc, const int* t, const int* l,
             void* out, float* pt, int* ct, int B, int Hq, int Hkv, int D,
             int bs, int W, int P, int st, int tps, int splits, float scale,
             cudaStream_t s) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  using KF = typename std::conditional<Q8, int8_t, float>::type;
  using KB = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  using KH = typename std::conditional<Q8, int8_t, __half>::type;
  switch (dtype) {
    case PTT_F32:
      return launch<float, KF>(q, kc, vc, ksc, vsc, t, l, out, pt, ct, B, Hq,
                               Hkv, D, bs, W, P, st, tps, splits, scale, s);
    case PTT_BF16:
      return launch<__nv_bfloat16, KB>(q, kc, vc, ksc, vsc, t, l, out, pt,
                                       ct, B, Hq, Hkv, D, bs, W, P, st, tps,
                                       splits, scale, s);
    case PTT_F16:
      return launch<__half, KH>(q, kc, vc, ksc, vsc, t, l, out, pt, ct, B,
                                Hq, Hkv, D, bs, W, P, st, tps, splits, scale,
                                s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// part: f32 scratch [B * Hkv * splits, G*D + 2G rounded up to 4] and
// counters: int [B * Hkv], zero on entry (and left zero), both unused when
// splits == 1;
// st: rows per tile (divides block_size); tps: tiles per split
extern "C" int paged_decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* tables,
    const void* lens, void* out, void* part, void* counters, int B, int Hq,
    int Hkv, int D, int bs, int W, int P, int st, int tps, int splits,
    float scale, int dtype, void* stream) {
  return dispatch<void>(dtype, q, kc, vc, nullptr, nullptr,
                        static_cast<const int*>(tables),
                        static_cast<const int*>(lens), out,
                        static_cast<float*>(part),
                        static_cast<int*>(counters), B, Hq, Hkv, D, bs, W, P,
                        st, tps, splits, scale,
                        static_cast<cudaStream_t>(stream));
}

// int8 pools with f32 scales [P, Hkv]; `dtype` is q's (and out's) type
extern "C" int paged_decode_attention_q8_launch(
    const void* q, const void* kc, const void* vc, const void* k_scale,
    const void* v_scale, const void* tables, const void* lens, void* out,
    void* part, void* counters, int B, int Hq, int Hkv, int D, int bs, int W,
    int P, int st, int tps, int splits, float scale, int dtype,
    void* stream) {
  return dispatch<int8_t>(dtype, q, kc, vc,
                          static_cast<const float*>(k_scale),
                          static_cast<const float*>(v_scale),
                          static_cast<const int*>(tables),
                          static_cast<const int*>(lens), out,
                          static_cast<float*>(part),
                          static_cast<int*>(counters), B, Hq, Hkv, D, bs, W,
                          P, st, tps, splits, scale,
                          static_cast<cudaStream_t>(stream));
}
