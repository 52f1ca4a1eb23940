// B2 — paged GQA decode attention on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/paged.py
// (`_paged_decode_kernel`, launched by `paged_decode_attention`): the
// arithmetic of B1 over a shared block pool (NB, bs, Hkv, hd) read through
// a per-slot block table (B, n_log). Logical key j of slot b lives in pool
// block table[b, j / bs] at offset j % bs; an entry of -1 masks the whole
// block, keys at j >= length are masked, and int8 K/V are dequantized with
// their per-(entry, kv-head) f32 scale before the dot product, in f32.
//
// What bounds it: the bytes of the mapped K/V blocks (plus scales for
// int8). What the design does about it: as in B1, one block serves all G
// query heads of a kv group, and no dense copy of the slot's cache is ever
// gathered; each block reads its own table entries (the TPU kernel
// scalar-prefetched the table to drive its BlockSpec index maps).
//
// Right and simple first: the grid is B·Hkv blocks per row tile at decode,
// so splitting the logical length across blocks, vector loads, TMA and
// wgmma are later work.

#include "decode_attn_common.cuh"

namespace repro_torch {

template <typename TKV>
struct PagedSrc {
  const TKV* k;            // (NB, bs, Hkv, hd)
  const TKV* v;
  const float* k_scale;    // (NB, bs, Hkv) or null
  const float* v_scale;
  const int* pos_map;      // (NB, bs)
  const int* table;        // (B, n_log)
  int bs;
  int n_log;
  int length;
  int Hkv;
  int hd;

  __device__ __forceinline__ long long locate(int b, int h, int j, int n_keys,
                                              int& pos, float& ks,
                                              float& vs) const {
    ks = 1.f;
    vs = 1.f;
    if (j >= length || j >= n_keys) return -1;
    const int blk = j / bs;
    if (blk >= n_log) return -1;
    const int phys = table[(long long)b * n_log + blk];
    if (phys < 0) return -1;
    const long long idx = (long long)phys * bs + (j - blk * bs);
    pos = pos_map[idx];
    if (k_scale != nullptr) {
      ks = k_scale[idx * Hkv + h];
      vs = v_scale[idx * Hkv + h];
    }
    return (idx * Hkv + h) * hd;
  }
};

template <typename TQ, typename TKV>
int paged_launch(const void* q, const void* k, const void* v,
                 const void* k_scale, const void* v_scale,
                 const void* pos_map, const void* table, const void* q_pos,
                 void* out, int B, int T, int Hkv, int G, int hd, int bs,
                 int n_log, int length, int window, cudaStream_t stream) {
  PagedSrc<TKV> src{static_cast<const TKV*>(k),
                    static_cast<const TKV*>(v),
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale),
                    static_cast<const int*>(pos_map),
                    static_cast<const int*>(table),
                    bs,
                    n_log,
                    length,
                    Hkv,
                    hd};
  const int span = n_log * bs;
  const int n_keys = length < span ? length : span;
  return launch_attend_hd<TQ>(hd, static_cast<const TQ*>(q),
                              static_cast<const int*>(q_pos),
                              TreeWindow{nullptr, nullptr, 0},
                              static_cast<TQ*>(out), B, T, Hkv, G, n_keys,
                              window, src, stream);
}

}  // namespace repro_torch

// q_dtype: 0 = float32, 1 = bfloat16 (q and out). kv_int8: 0 = the pool
// holds q's dtype, 1 = int8 with f32 scales. Returns cudaGetLastError().
extern "C" int paged_decode_attn_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* pos_map,
    const void* block_table, const void* q_pos, void* out, int B, int T,
    int Hkv, int G, int hd, int bs, int n_log, int length, int window,
    int q_dtype, int kv_int8, void* stream) {
  using repro_torch::paged_launch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_int8 == 0)
    return paged_launch<float, float>(q, k_pool, v_pool, nullptr, nullptr,
                                      pos_map, block_table, q_pos, out, B,
                                      T, Hkv, G, hd, bs, n_log, length,
                                      window, st);
  if (q_dtype == 1 && kv_int8 == 0)
    return paged_launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, pos_map, block_table, q_pos,
        out, B, T, Hkv, G, hd, bs, n_log, length, window, st);
  if (q_dtype == 0 && kv_int8 == 1)
    return paged_launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                       pos_map, block_table, q_pos, out, B,
                                       T, Hkv, G, hd, bs, n_log, length,
                                       window, st);
  if (q_dtype == 1 && kv_int8 == 1)
    return paged_launch<__nv_bfloat16, int8_t>(
        q, k_pool, v_pool, k_scale, v_scale, pos_map, block_table, q_pos,
        out, B, T, Hkv, G, hd, bs, n_log, length, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
