// B4a / B4b — greedy tree verify on Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/verify/tree.py, glued as
// in repro/kernels/verify/ops.py::tree_verify_fused:
//
// - tree_argmax (`tree_argmax_kernel`): the target's argmax at every tree
//   entry, (B, T, V) f32 logits -> (B, T) int32, ties to the LOWEST id (the
//   contract of torch.argmax / jnp.argmax; a NaN counts as the largest
//   value, as there). The Pallas kernel streamed 512-wide vocab tiles
//   through VMEM in order, carrying (max, argmax) across the sequential
//   grid; here one block owns one (b, t) row and its threads stride the
//   row with 16-byte loads, each keeping its own (value, index) best, then
//   warps and shared memory reduce the PAIRS (larger value wins, lower
//   index on equal values). A reduction over values alone would be wrong:
//   bf16 logits widened to f32 tie exactly. No vocab padding: the kernel
//   takes any V (151936 is not a multiple of 512).
//   Bound: the bytes of the logits, read once (B·T·V·4). Design: enough
//   loads in flight per block (512 threads × 4 float4) for one block per
//   SM to stream its row; B·T = 100 rows at the slice's verify shape.
//
// - tree_accept (`tree_accept_kernel`): the longest-accepted-root-path
//   rule. One block per batch row, one thread per entry (T = 1 +
//   d_max·b_max <= 1024): match[e] = valid[e] ∧ tok[e] == tgt[parent[e]]
//   (the anchor always matches), accept[e] = AND of match over the entry's
//   ancestors-or-self (a row of the (T, T) bitmap), winner = the accepted
//   entry of largest tpos·T + (T − e) (unique: deepest, then lowest index),
//   n_acc = tpos[winner], bonus = tgt[winner]. O(T²) on a few dozen
//   entries: bound by launch latency, far above its byte bound.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kArgmaxThreads = 512;
constexpr int kVecPerIter = 4;  // float4 loads in flight per thread
constexpr int kMaxEntries = 1024;

// the total order of torch.argmax: NaN above every number, then value,
// then the lower index first
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    take(ov, oi, bv, bi);
  }
}

__global__ void __launch_bounds__(kArgmaxThreads)
    tree_argmax_kernel(const float* __restrict__ logits,
                       int* __restrict__ out, int V) {
  const float* p = logits + (long long)blockIdx.x * V;
  const int tid = threadIdx.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  // scalar head up to a 16-byte boundary, float4 body, scalar tail
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const int head = min(V, ((16 - mis) & 15) >> 2);
  for (int j = tid; j < head; j += kArgmaxThreads) take(p[j], j, bv, bi);
  const float4* p4 = reinterpret_cast<const float4*>(p + head);
  const int n4 = (V - head) >> 2;
  for (int k0 = tid; k0 < n4; k0 += kArgmaxThreads * kVecPerIter) {
    float4 x[kVecPerIter];
#pragma unroll
    for (int u = 0; u < kVecPerIter; ++u) {
      const int k = k0 + u * kArgmaxThreads;
      x[u] = k < n4 ? __ldg(p4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kVecPerIter; ++u) {
      const int k = k0 + u * kArgmaxThreads;
      if (k < n4) {
        const int j = head + 4 * k;
        take(x[u].x, j, bv, bi);
        take(x[u].y, j + 1, bv, bi);
        take(x[u].z, j + 2, bv, bi);
        take(x[u].w, j + 3, bv, bi);
      }
    }
  }
  for (int j = head + 4 * n4 + tid; j < V; j += kArgmaxThreads)
    take(p[j], j, bv, bi);

  __shared__ float s_v[kArgmaxThreads / 32];
  __shared__ int s_i[kArgmaxThreads / 32];
  const int warp = tid >> 5;
  const int lane = tid & 31;
  warp_best(bv, bi);
  if (lane == 0) {
    s_v[warp] = bv;
    s_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kArgmaxThreads / 32;
    bv = lane < kWarps ? s_v[lane] : -INFINITY;
    bi = lane < kWarps ? s_i[lane] : INT_MAX;
    warp_best(bv, bi);
    if (lane == 0) out[blockIdx.x] = bi == INT_MAX ? 0 : bi;
  }
}

__global__ void tree_accept_kernel(const int* __restrict__ tok,
                                   const int* __restrict__ tgt,
                                   const int* __restrict__ parent,
                                   const int* __restrict__ tpos,
                                   const unsigned char* __restrict__ valid,
                                   const unsigned char* __restrict__ mask,
                                   int* __restrict__ n_acc,
                                   int* __restrict__ winner,
                                   int* __restrict__ bonus, int T) {
  __shared__ int s_tgt[kMaxEntries];
  __shared__ unsigned char s_match[kMaxEntries];
  __shared__ int s_best;
  const int b = blockIdx.x;
  const int e = threadIdx.x;
  const int* tok_b = tok + (long long)b * T;
  if (e == 0) s_best = -1;
  if (e < T) s_tgt[e] = tgt[(long long)b * T + e];
  __syncthreads();
  if (e < T)
    s_match[e] = e == 0 || (valid[e] != 0 && tok_b[e] == s_tgt[parent[e]]);
  __syncthreads();
  int score = -1;
  if (e < T) {
    const unsigned char* anc = mask + (long long)e * T;
    bool acc = true;
    for (int a = 0; a < T; ++a) acc = acc && !(anc[a] != 0 && !s_match[a]);
    if (acc) score = tpos[e] * T + (T - e);
  }
  atomicMax(&s_best, score);
  __syncthreads();
  if (e < T && score == s_best) {  // the anchor is always accepted: one hit
    winner[b] = e;
    n_acc[b] = tpos[e];
    bonus[b] = s_tgt[e];
  }
}

}  // namespace
}  // namespace repro_torch

// logits (rows, V) float32 contiguous -> out (rows,) int32. Returns
// cudaGetLastError() after the launch.
extern "C" int tree_argmax_launch(const void* logits, void* out, int rows,
                                  int V, void* stream) {
  if (rows <= 0) return 0;
  if (V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  repro_torch::tree_argmax_kernel<<<rows, repro_torch::kArgmaxThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int*>(out), V);
  return static_cast<int>(cudaGetLastError());
}

// tok/tgt (B, T) int32; parent/tpos (T,) int32; valid (T,) bool; mask
// (T, T) bool; n_acc/winner/bonus (B,) int32. T <= 1024.
extern "C" int tree_accept_launch(const void* tok, const void* tgt,
                                  const void* parent, const void* tpos,
                                  const void* valid, const void* mask,
                                  void* n_acc, void* winner, void* bonus,
                                  int B, int T, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || T > repro_torch::kMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (T + 31) / 32 * 32;
  repro_torch::tree_accept_kernel<<<B, threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<const int*>(tgt),
      static_cast<const int*>(parent), static_cast<const int*>(tpos),
      static_cast<const unsigned char*>(valid),
      static_cast<const unsigned char*>(mask), static_cast<int*>(n_acc),
      static_cast<int*>(winner), static_cast<int*>(bonus), T);
  return static_cast<int>(cudaGetLastError());
}
