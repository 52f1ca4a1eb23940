// Shared body of the two decode-attention kernels (decode_attn.cu,
// paged_decode_attn.cu): GQA flash-decode of a T-token query window over a
// KV cache, masked by per-entry absolute positions.
//
// One block owns (batch b, kv-head h, a tile of kRows query rows). Query
// rows are the flattened (t, g) pairs of the window: all G query heads of
// the kv group sit in the same row space, so every K/V tile a block reads
// serves all of them (the GQA saving). The block walks the keys itself in
// tiles of 32 (one key per lane), keeping the online-softmax state m, l and
// the f32 accumulator in registers: warp w owns kRowsPerWarp rows, lane l
// owns key l of the tile for the scores and head-dim columns l, l+32, ...
// for the accumulator. Rows are tiled, so shared memory does not grow with
// T·G (a 48-token prefill of a 5-head group is 240 rows = 15 blocks).
//
// Where a key lives (dense row or paged block), its position and its
// dequantization scale come from a `Src` policy (DenseSrc / PagedSrc), so
// the two kernels share every line of the attention arithmetic.
//
// Tree windows (dense only): with a (T, Wn) ancestor bitmap `win_mask` and
// per-row region bases `win_base` (B,), key j with 0 <= j - win_base[b] <
// Wn is valid for query t iff win_mask[t, j - win_base[b]] — the bitmap
// REPLACES the position rule there (sibling branches share positions, so
// pos_map cannot separate them); keys outside the region keep the rule.
// A null `win_mask` leaves the kernel exactly as without the option.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // keys per tile (one per lane)
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;             // the Pallas kernels' NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// xor butterflies leave the identical value in every lane (each step adds
// the same two operands in both partner lanes)
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, out: (B, T, Hkv, G, HD); q_pos: (B, T). Keys j in [0, n_keys) are
// located through `src`; a key it cannot place (past the cache, unmapped
// block, past `length`) carries position -1 and is masked like an empty
// slot. Valid iff 0 <= pos <= q_pos (and pos > q_pos - window when
// window > 0), or by the tree bitmap inside its region (see above). A row
// with no valid key writes zeros.
template <int HD, typename TQ, typename Src>
__global__ void __launch_bounds__(kThreads)
    attend_kernel(const TQ* __restrict__ q, const int* __restrict__ q_pos,
                  const unsigned char* __restrict__ win_mask,
                  const int* __restrict__ win_base, int Wn,
                  TQ* __restrict__ out, int T, int Hkv, int G, int n_keys,
                  int window, float scale, Src src) {
  constexpr int kDpl = HD / 32;  // head-dim columns per lane
  constexpr int kLoadIters = kTile * HD / kThreads;  // K/V elements/thread
  static_assert(kTile * HD % kThreads == 0, "tile must split evenly");
  __shared__ float q_s[kRows][HD];
  __shared__ float k_s[kTile][HD + 1];  // +1: lane-strided rows, no conflicts
  __shared__ float v_s[kTile][HD];
  __shared__ long long ent_s[kTile];
  __shared__ int kpos_s[kTile];
  __shared__ float ksc_s[kTile];
  __shared__ float vsc_s[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = T * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int rr = i / HD;
    const int d = i - rr * HD;
    const int row = row0 + rr;
    float x = 0.f;
    if (row < n_rows) {
      const int t = row / G;
      const int g = row - t * G;
      x = to_f(q[((((long long)b * T + t) * Hkv + h) * G + g) * HD + d]);
    }
    q_s[rr][d] = x;
  }

  int qp[kRowsPerWarp];
  int tq[kRowsPerWarp];  // the row's query token t
  bool live[kRowsPerWarp];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp * kRowsPerWarp + i;
    live[i] = row < n_rows;
    tq[i] = live[i] ? row / G : 0;
    qp[i] = live[i] ? q_pos[(long long)b * T + tq[i]] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDpl; ++c) acc[i][c] = 0.f;
  }
  const int base = win_mask != nullptr ? win_base[b] : 0;

  for (int s0 = 0; s0 < n_keys; s0 += kTile) {
    __syncthreads();  // q_s written / previous tile consumed
    if (tid < kTile) {
      int pos = -1;
      float ks = 1.f, vs = 1.f;
      const long long e = src.locate(b, h, s0 + tid, n_keys, pos, ks, vs);
      ent_s[tid] = e;
      kpos_s[tid] = e >= 0 ? pos : -1;
      ksc_s[tid] = ks;
      vsc_s[tid] = vs;
    }
    __syncthreads();
    // all of this thread's K/V loads are issued before the first is used:
    // a fixed trip count, unrolled, so the global-memory latencies overlap
    float kx[kLoadIters], vx[kLoadIters];
#pragma unroll
    for (int it = 0; it < kLoadIters; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / HD;
      const int d = i - j * HD;
      const long long e = ent_s[j];
      kx[it] = e >= 0 ? to_f(src.k[e + d]) * ksc_s[j] : 0.f;
      vx[it] = e >= 0 ? to_f(src.v[e + d]) * vsc_s[j] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kLoadIters; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / HD;
      const int d = i - j * HD;
      k_s[j][d] = kx[it];
      v_s[j][d] = vx[it];
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    const int kp = kpos_s[lane];
    const int rel = s0 + lane - base;  // offset into the tree region
    const bool in_win = win_mask != nullptr && s0 + lane < n_keys &&
                        rel >= 0 && rel < Wn;
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        sc[i] = fmaf(q_s[warp * kRowsPerWarp + i][d], kd, sc[i]);
    }

    // online softmax per row (every lane ends with the same m, l, alpha)
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool valid;
      if (in_win) {
        valid = live[i] && win_mask[(long long)tq[i] * Wn + rel] != 0;
      } else {
        valid = live[i] && kp >= 0 && kp <= qp[i];
        if (window > 0) valid = valid && kp > qp[i] - window;
      }
      const float s = valid ? sc[i] * scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - m_new);
      const float e = valid ? expf(s - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(e);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDpl; ++c) acc[i][c] *= alpha;
      p[i] = e;
    }

    // acc += P · V, P broadcast from the lane that owns each key
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vv[kDpl];
#pragma unroll
      for (int c = 0; c < kDpl; ++c) vv[c] = v_s[j][lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < kDpl; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!live[i]) continue;
    const int row = row0 + warp * kRowsPerWarp + i;
    const int t = row / G;
    const int g = row - t * G;
    TQ* o = out + ((((long long)b * T + t) * Hkv + h) * G + g) * HD;
    const float inv = l[i] > 0.f ? 1.f / fmaxf(l[i], 1e-20f) : 0.f;
#pragma unroll
    for (int c = 0; c < kDpl; ++c)
      o[lane + 32 * c] = from_f<TQ>(l[i] > 0.f ? acc[i][c] * inv : 0.f);
  }
}

// The optional tree window (win_mask, win_base, Wn; nullptr = none).
struct TreeWindow {
  const unsigned char* mask;  // (T, Wn) bool
  const int* base;            // (B,) region start per row
  int Wn;
};

template <int HD, typename TQ, typename Src>
int launch_attend(const TQ* q, const int* q_pos, TreeWindow tw, TQ* out,
                  int B, int T, int Hkv, int G, int n_keys, int window,
                  const Src& src, cudaStream_t stream) {
  const dim3 grid((T * G + kRows - 1) / kRows, Hkv, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  attend_kernel<HD, TQ, Src><<<grid, kThreads, 0, stream>>>(
      q, q_pos, tw.mask, tw.base, tw.Wn, out, T, Hkv, G, n_keys, window,
      scale, src);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename Src>
int launch_attend_hd(int hd, const TQ* q, const int* q_pos, TreeWindow tw,
                     TQ* out, int B, int T, int Hkv, int G, int n_keys,
                     int window, const Src& src, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || G <= 0) return 0;  // nothing to do
  switch (hd) {
    case 64:
      return launch_attend<64>(q, q_pos, tw, out, B, T, Hkv, G, n_keys,
                               window, src, stream);
    case 128:
      return launch_attend<128>(q, q_pos, tw, out, B, T, Hkv, G, n_keys,
                                window, src, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch
