// B1 — dense GQA decode attention on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/decode_attn.py
// (`_decode_attn_kernel`, launched by `decode_attn_call`): attention of a
// T-token window (T = 1 per draft step, gamma_max + 1 per verify, the
// padded prompt at admission) over a dense (B, S, Hkv, hd) cache masked by
// pos_map. Same arithmetic: f32 scores scaled by 1/sqrt(hd), mask
// 0 <= pos_map <= q_pos (+ sliding window), online softmax with f32 m/l/acc,
// P·V in f32, one cast to q's dtype at the end, zeros for a row with no
// valid slot. Tree speculation adds the ancestor bitmap of the reference's
// `_attend_cached(win_mask=...)` (repro/models/attention.py): inside the
// region [pos, pos + Wn) of each row the bitmap replaces the position rule
// (the draft's depth windows and the target's tree verify pass it).
//
// What bounds it: the bytes of K and V read (the arithmetic intensity is
// about T·G flops per byte, far below the card's ridge). What the design
// does about it: all G query heads of a kv group share one block, so each
// K/V tile is read from device memory once per group per row tile, not once
// per query head. The Pallas grid walked S in order with m/l/acc in VMEM;
// here the block walks S itself with that state in registers.
//
// Right and simple first. At decode the grid is only B·Hkv blocks (32 for
// the qwen3-14b target, 8 for the qwen2.5-3b draft at batch 4) on 132 SMs,
// so the card is mostly idle: splitting S across blocks with a combine
// pass (flash-decoding), 16-byte vector loads, TMA and wgmma are later
// work.

#include "decode_attn_common.cuh"

namespace repro_torch {

template <typename TKV>
struct DenseSrc {
  const TKV* k;  // (B, S, Hkv, hd)
  const TKV* v;
  const int* pos_map;  // (B, S)
  int S;
  int Hkv;
  int hd;

  __device__ __forceinline__ long long locate(int b, int h, int j, int n_keys,
                                              int& pos, float& ks,
                                              float& vs) const {
    ks = 1.f;
    vs = 1.f;
    if (j >= S || j >= n_keys) return -1;
    const long long idx = (long long)b * S + j;
    pos = pos_map[idx];
    return (idx * Hkv + h) * hd;
  }
};

template <typename T>
int dense_launch(const void* q, const void* k, const void* v,
                 const void* pos_map, const void* q_pos, TreeWindow tw,
                 void* out, int B, int T_, int Hkv, int G, int hd, int S,
                 int window, cudaStream_t stream) {
  DenseSrc<T> src{static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const int*>(pos_map), S, Hkv, hd};
  return launch_attend_hd<T>(hd, static_cast<const T*>(q),
                             static_cast<const int*>(q_pos), tw,
                             static_cast<T*>(out), B, T_, Hkv, G, S, window,
                             src, stream);
}

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). win_mask
// (T, Wn) bool and win_base (B,) int32 are null for a plain window.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* pos_map, const void* q_pos,
                                  const void* win_mask, const void* win_base,
                                  void* out, int B, int T, int Hkv, int G,
                                  int hd, int S, int window, int Wn,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const repro_torch::TreeWindow tw{
      static_cast<const unsigned char*>(win_mask),
      static_cast<const int*>(win_base), Wn};
  if (dtype == 0)
    return repro_torch::dense_launch<float>(q, k, v, pos_map, q_pos, tw, out,
                                            B, T, Hkv, G, hd, S, window, st);
  if (dtype == 1)
    return repro_torch::dense_launch<__nv_bfloat16>(
        q, k, v, pos_map, q_pos, tw, out, B, T, Hkv, G, hd, S, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
