// B1 — dense GQA decode attention on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/decode_attn.py
// (`_decode_attn_kernel`, launched by `decode_attn_call`): attention of a
// T-token window (T = 1 per draft step, gamma_max + 1 per verify, the
// padded prompt at admission) over a dense (B, S, Hkv, hd) cache masked by
// pos_map. Same function: f32 scores scaled by 1/sqrt(hd), mask
// 0 <= pos_map <= q_pos (+ sliding window), online softmax with f32 m/l/acc,
// one cast to q's dtype at the end, zeros for a row with no valid slot.
// Tree speculation adds the ancestor bitmap of the reference's
// `_attend_cached(win_mask=...)` (repro/models/attention.py): inside the
// region [pos, pos + Wn) of each row the bitmap replaces the position rule
// (the draft's depth windows and the target's tree verify pass it).
//
// What bounds it on this card: the K/V bytes (at most 64 flops per byte for
// T·G ≤ 64 rows, far under the ridge). The Pallas grid walked S in order on
// one core with m/l/acc in VMEM; here S is split across blocks in splits of
// a fixed number of keys per cache layout (head dim, dtype, kv heads), merged
// by a fixed-order combine pass; K/V tiles stream through a 16-byte cp.async
// ring; bf16 windows run QKᵀ and P·V on the tensor cores (mma.sync,
// FlashAttention-2 style), f32 windows stay in f32 on the CUDA cores; tiles
// with no valid key for the block's rows are never read
// (decode_attn_common.cuh has the design and its reasons).

#include "decode_attn_common.cuh"

namespace repro_torch {

template <typename TKV>
struct DenseSrc {
  static constexpr bool kScaled = false;
  const TKV* k;  // (B, S, Hkv, hd)
  const TKV* v;
  const int* pos_map;  // (B, S)
  int S;

  __device__ __forceinline__ void prologue(int, int, int, int*, int,
                                           int) const {}

  // the key's row (index of pos_map; K/V at row·Hkv + h), -1 if none
  __device__ __forceinline__ long long row(int b, int j, int,
                                           const int*) const {
    return j < S ? (long long)b * S + j : -1;
  }
};

template <typename T>
int dense_launch(const void* q, const void* k, const void* v,
                 const void* pos_map, const void* q_pos, TreeWindow tw,
                 void* out, void* part, int B, int T_, int Hkv, int G,
                 int hd, int S, int window, int split, int n_split,
                 cudaStream_t stream) {
  DenseSrc<T> src{static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const int*>(pos_map), S};
  return launch_attend_hd<T, T>(hd, static_cast<const T*>(q),
                                static_cast<const int*>(q_pos), tw,
                                static_cast<T*>(out),
                                static_cast<float*>(part), B, T_, Hkv, G, S,
                                split, n_split, window, src, stream);
}

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). win_mask
// (T, Wn) bool and win_base (B,) int32 are null for a plain window. split:
// keys per split; n_split = ceil(S / split) (1 when S = 0); part: f32
// scratch of n_split·B·T·Hkv·G·(hd + 2), null when n_split == 1. Returns
// cudaGetLastError() after the last launch (the attention kernel, then the
// combine kernel when n_split > 1).
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* pos_map, const void* q_pos,
                                  const void* win_mask, const void* win_base,
                                  void* out, void* part, int B, int T,
                                  int Hkv, int G, int hd, int S, int window,
                                  int Wn, int split, int n_split, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const repro_torch::TreeWindow tw{
      static_cast<const unsigned char*>(win_mask),
      static_cast<const int*>(win_base), Wn};
  if (dtype == 0)
    return repro_torch::dense_launch<float>(q, k, v, pos_map, q_pos, tw, out,
                                            part, B, T, Hkv, G, hd, S, window,
                                            split, n_split, st);
  if (dtype == 1)
    return repro_torch::dense_launch<__nv_bfloat16>(
        q, k, v, pos_map, q_pos, tw, out, part, B, T, Hkv, G, hd, S, window,
        split, n_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
