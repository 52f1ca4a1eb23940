// B2 — paged GQA decode attention on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/paged.py
// (`_paged_decode_kernel`, launched by `paged_decode_attention`): the
// function of B1 over a shared block pool (NB, bs, Hkv, hd) read through a
// per-slot block table (B, n_log). Logical key j of slot b lives in pool
// block table[b, j / bs] at offset j % bs; an entry of -1 masks the whole
// block, keys at j >= length are masked, and int8 K/V carry a per-(entry,
// kv-head) f32 scale.
//
// What bounds it on this card: the bytes of the mapped K/V blocks (plus
// the scales for int8). The design is B1's (decode_attn_common.cuh): fixed
// splits of the logical keys across blocks, each a multiple of bs, merged in
// split order; a 16-byte cp.async ring of K/V tiles; mma.sync for bf16
// queries, f32 CUDA cores for f32 queries; dead tiles never read. Paged
// specifics: each block reads its split's table entries once (the TPU
// kernel scalar-prefetched the table for its BlockSpec index maps), so a
// key costs one shared-memory lookup, and no dense copy of a slot's cache
// is ever gathered. int8 rows are copied as int8 (half the bytes of bf16)
// and converted to bf16 in shared memory; the K scale multiplies the score
// after the dot product and the V scale folds into P before P·V.

#include "decode_attn_common.cuh"

namespace repro_torch {

template <typename TKV>
struct PagedSrc {
  static constexpr bool kScaled = std::is_same<TKV, int8_t>::value;
  const TKV* k;            // (NB, bs, Hkv, hd)
  const TKV* v;
  const int* pos_map;      // (NB, bs)
  const float* k_scale;    // (NB, bs, Hkv) or null
  const float* v_scale;
  const int* table;        // (B, n_log)
  int bs;
  int n_log;

  // the table entries of the split's logical blocks, read once; s0 is a
  // multiple of bs (the split is)
  __device__ __forceinline__ void prologue(int b, int s0, int s_end,
                                           int* tbl_s, int tid,
                                           int nthr) const {
    const int blk0 = s0 / bs;
    const int nblk = s_end > s0 ? (s_end - s0 + bs - 1) / bs : 0;
    for (int i = tid; i < nblk; i += nthr)
      tbl_s[i] = blk0 + i < n_log ? table[(long long)b * n_log + blk0 + i]
                                  : -1;
  }

  // the key's row (index of pos_map and the scales; K/V at row·Hkv + h),
  // -1 for an unmapped block
  __device__ __forceinline__ long long row(int, int j, int s0,
                                           const int* tbl_s) const {
    const int rel = j - s0;
    const int phys = tbl_s[rel / bs];
    return phys < 0 ? -1 : (long long)phys * bs + (rel % bs);
  }
};

template <typename TQ, typename TKV>
int paged_launch(const void* q, const void* k, const void* v,
                 const void* k_scale, const void* v_scale,
                 const void* pos_map, const void* table, const void* q_pos,
                 void* out, void* part, int B, int T, int Hkv, int G, int hd,
                 int bs, int n_log, int length, int window, int split,
                 int n_split, cudaStream_t stream) {
  if (bs <= 0 || split % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PagedSrc<TKV> src{static_cast<const TKV*>(k),
                    static_cast<const TKV*>(v),
                    static_cast<const int*>(pos_map),
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale),
                    static_cast<const int*>(table),
                    bs,
                    n_log};
  const int span = n_log * bs;
  const int n_keys = length < span ? length : span;
  return launch_attend_hd<TQ, TKV>(
      hd, static_cast<const TQ*>(q), static_cast<const int*>(q_pos),
      TreeWindow{nullptr, nullptr, 0}, static_cast<TQ*>(out),
      static_cast<float*>(part), B, T, Hkv, G, n_keys > 0 ? n_keys : 0,
      split, n_split, window, src, stream);
}

}  // namespace repro_torch

// q_dtype: 0 = float32, 1 = bfloat16 (q and out). kv_int8: 0 = the pool
// holds q's dtype, 1 = int8 with f32 scales. split: logical keys per split,
// a multiple of bs; n_split = ceil(min(length, n_log·bs) / split) (1 when
// that is 0); part: f32 scratch of n_split·B·T·Hkv·G·(hd + 2), null when
// n_split == 1. Returns cudaGetLastError() after the last launch.
extern "C" int paged_decode_attn_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* pos_map,
    const void* block_table, const void* q_pos, void* out, void* part, int B,
    int T, int Hkv, int G, int hd, int bs, int n_log, int length, int window,
    int split, int n_split, int q_dtype, int kv_int8, void* stream) {
  using repro_torch::paged_launch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_int8 == 0)
    return paged_launch<float, float>(q, k_pool, v_pool, nullptr, nullptr,
                                      pos_map, block_table, q_pos, out, part,
                                      B, T, Hkv, G, hd, bs, n_log, length,
                                      window, split, n_split, st);
  if (q_dtype == 1 && kv_int8 == 0)
    return paged_launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, pos_map, block_table, q_pos,
        out, part, B, T, Hkv, G, hd, bs, n_log, length, window, split,
        n_split, st);
  if (q_dtype == 0 && kv_int8 == 1)
    return paged_launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                       pos_map, block_table, q_pos, out,
                                       part, B, T, Hkv, G, hd, bs, n_log,
                                       length, window, split, n_split, st);
  if (q_dtype == 1 && kv_int8 == 1)
    return paged_launch<__nv_bfloat16, int8_t>(
        q, k_pool, v_pool, k_scale, v_scale, pos_map, block_table, q_pos,
        out, part, B, T, Hkv, G, hd, bs, n_log, length, window, split,
        n_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
