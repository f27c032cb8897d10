// Single-query decode attention over contiguous per-layer caches, for
// every group size Hq / Hkv >= 1.
//
// Replaces the Pallas kernels paddle_tpu/kernels/decode_attention.py
// `_decode_kernel` (equal heads, launched by `decode_attention`) and
// `_gqa_contig_kernel` (grouped heads, launched by `gqa_decode_attention`
// through `_gqa_grid_body`): one kernel, blocks per (split of a row's
// positions, kv head, sequence) scoring the whole query group against each
// tile of their kv head.
//
// Inputs: q [B, Hq, D]; caches [B, Hkv, max_seq, D] in q's type (strides
// [Hkv*max_seq*D, max_seq*D, D], not a pool's); lens [B] int32 = tokens
// cached before the current one, whose K/V is already written at position
// lens[b], so positions <= lens[b] are attended. Output [B, Hq, D] in q's
// type; scores, softmax and accumulation in f32.
//
// Bound on the H100: bytes. Each row reads (lens[b] + 1) cached positions
// of K and V once for ~4 G flops per element.
//
// Design: the paged kernel's body (decode_attention_body.cuh: the position
// loop split across blocks, a cp.async ring, a deterministic merge) with a
// tile policy that addresses `st`-position tiles (64) of the contiguous
// cache. The TPU kernel takes the largest divisor of max_seq as its block;
// here max_seq need not be a multiple of the tile (544 positions, or 96),
// so the last tile is ragged: it copies only the rows that exist and masks
// the rest without reading them. Tiles past lens[b] are never read,
// lens = 0 reads one tile, lens = max_seq - 1 reads all of them.
#include "decode_attention_body.cuh"

namespace {

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* lens,
           void* out, float* part, int* counters, int B, int Hq, int Hkv,
           int D, int max_seq, int st, int tps, int splits, float scale,
           cudaStream_t stream) {
  return launch_decode<T, T>(q, kc, vc, nullptr, nullptr, lens, out, part,
                             counters, B, Hq, Hkv, D, scale,
                             ContigTiles{max_seq, st}, tps, splits, stream);
}

}  // namespace

// part: f32 scratch [B * Hkv * splits, G*D + 2G rounded up to 4] and
// counters: int [B * Hkv], zero on entry (and left zero), both unused when
// splits == 1
extern "C" int contiguous_decode_attention_launch(
    const void* q, const void* kc, const void* vc, const void* lens,
    void* out, void* part, void* counters, int B, int Hq, int Hkv, int D,
    int max_seq, int st, int tps, int splits, float scale, int dtype,
    void* stream) {
  const int* l = static_cast<const int*>(lens);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case PTT_F32:
      return launch<float>(q, kc, vc, l, out, pt, ct, B, Hq, Hkv, D, max_seq,
                           st, tps, splits, scale, s);
    case PTT_BF16:
      return launch<__nv_bfloat16>(q, kc, vc, l, out, pt, ct, B, Hq, Hkv, D,
                                   max_seq, st, tps, splits, scale, s);
    case PTT_F16:
      return launch<__half>(q, kc, vc, l, out, pt, ct, B, Hq, Hkv, D,
                            max_seq, st, tps, splits, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
