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
//   rule as bitmask arithmetic. Entry e matches when valid[e] ∧ tok[e] ==
//   tgt[parent[e]] (the anchor always matches); a warp's 32 match bits are
//   one word by __ballot_sync (bit e % 32 of word e / 32). The ancestor-
//   or-self bitmap arrives packed the same way, once per tree shape
//   (TreeSpec.win_words, (T, ⌈T/32⌉) words), so entry e is accepted when
//   no word of its row has a bit outside the match words. The winner is
//   the accepted entry of largest score tpos·T + (T − e) (unique: deepest,
//   then lowest index), one __reduce_max_sync per warp and one across
//   warps; n_acc and the winner are decoded from that score (tpos ≥ 0),
//   and the thread holding the winner writes them with bonus = tgt[winner],
//   read beside tgt[parent]. T = 1 + d_max·b_max <= 1024. Bound: launch
//   latency and two dependent L2 reads (the entry's inputs, then tgt at
//   its parent and its own), far above its byte bound.
//
// - tree_verify (`tree_verify_kernel`): both in ONE launch, the served
//   path. Every block runs B4a's row argmax; thread 0 then stores its
//   entry and counts it in counters[b] by one acquire-release atomic add
//   (one ordered operation in place of fence, atomic, fence); the block
//   that brings the count to T resets it to 0 (so no memset runs per call
//   and CUDA-graph replays stay right) and runs B4b's rule on row b as its
//   epilogue, reading the row's other entries through L2 (ld.global.cg).
//   The accept inputs (tokens, parents, positions, validity, the first
//   ancestor word) are loaded by every block before its argmax, so the
//   last block's tail starts at the tgt reads. Bound: B4a's bytes; past B4a the tail is the ordered atomic
//   and one L2 read. The counters belong to the caller (one workspace per
//   decode session): launches that may overlap must not share them.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kArgmaxThreads = 512;
constexpr int kVecPerIter = 4;  // float4 loads in flight per thread
constexpr int kMaxEntries = 1024;
constexpr int kMaxWords = kMaxEntries / 32;
constexpr unsigned kFull = 0xffffffffu;

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
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    take(ov, oi, bv, bi);
  }
}

// B4a's body: the argmax of one V-long row, by a block of kArgmaxThreads;
// the result is valid in thread 0
__device__ __forceinline__ int block_argmax(const float* __restrict__ p,
                                            int V) {
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
  }
  return bi == INT_MAX ? 0 : bi;
}

// B4b's operands: tok/tgt (B, T); parent/tpos (T,) int32; valid (T,)
// bool; words (T, ⌈T/32⌉) packed ancestor-or-self rows; n_acc/winner/bonus
// (B,) int32. tgt is read through L2 only: in tree_verify other blocks of
// the same launch wrote it.
struct TreeArgs {
  const int* tok;
  const int* tgt;
  const int* parent;
  const int* tpos;
  const unsigned char* valid;
  const unsigned* words;
  int* n_acc;
  int* winner;
  int* bonus;
  int T;
};

// what entry e of row b reads besides tgt (neutral past T)
struct Entry {
  int tok, parent, tpos;
  unsigned row0;  // the first word of e's ancestor row
  bool valid;
};

__device__ __forceinline__ Entry load_entry(const TreeArgs& a, int b, int e) {
  Entry in{0, 0, 0, 0u, false};
  if (e < a.T) {
    const int W = (a.T + 31) >> 5;
    in.tok = __ldg(a.tok + (long long)b * a.T + e);
    in.parent = __ldg(a.parent + e);
    in.tpos = __ldg(a.tpos + e);
    in.row0 = __ldg(a.words + (long long)e * W);
    in.valid = __ldg(a.valid + e) != 0;
  }
  return in;
}

// B4b on batch row b, run by every thread of the block (any multiple of
// 32 threads); `first` is what load_entry gives this thread's first entry,
// threadIdx.x. Chunk c (entries 32c .. 32c + 31) belongs to warp c % warps.
// The thread holding the winning entry writes the verdict, with the tgt it
// read beside its parent's: no read waits for the winner.
__device__ void accept_row(const TreeArgs& a, int b, const Entry& first) {
  __shared__ unsigned s_match[kMaxWords];
  __shared__ int s_best[kMaxWords];
  const int T = a.T;
  const int W = (T + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int* tgt = a.tgt + (long long)b * T;
  // match words
  int first_tgt = 0;
  for (int c = warp; c < W; c += warps) {
    const int e = (c << 5) + lane;
    const Entry in = c == warp ? first : load_entry(a, b, e);
    if (c == warp && e < T) first_tgt = __ldcg(tgt + e);
    const bool m = e == 0 || (in.valid && in.tok == __ldcg(tgt + in.parent));
    const unsigned bits = __ballot_sync(kFull, m);
    if (lane == 0) s_match[c] = bits;
  }
  // one word: its warp reads its own lane 0's store
  if (W > 1)
    __syncthreads();
  else
    __syncwarp();
  // accepted entries: this thread's best score and its entry's tgt
  int mine = -1, mine_tgt = 0;
  for (int c = warp; c < W; c += warps) {
    const int e = (c << 5) + lane;
    const Entry in = c == warp ? first : load_entry(a, b, e);
    if (e < T) {
      const unsigned* row = a.words + (long long)e * W;
      unsigned viol = in.row0 & ~s_match[0];
      for (int w = 1; w < W; ++w) viol |= __ldg(row + w) & ~s_match[w];
      const int score = in.tpos * T + (T - e);
      if (viol == 0u && score > mine) {
        mine = score;
        mine_tgt = c == warp ? first_tgt : __ldcg(tgt + e);
      }
    }
  }
  int best = __reduce_max_sync(kFull, mine);
  const int live = min(W, warps);  // warps that scored entries
  if (live > 1) {
    if (lane == 0) s_best[warp] = best;
    __syncthreads();
    best = __reduce_max_sync(kFull, lane < live ? s_best[lane] : -1);
  }
  // scores are unique and the anchor is always accepted (best >= T >= 1):
  // one thread writes
  if (mine >= 0 && mine == best) {
    const int s = best - 1;
    a.n_acc[b] = s / T;
    a.winner[b] = T - 1 - s % T;
    a.bonus[b] = mine_tgt;
  }
}

__global__ void __launch_bounds__(kArgmaxThreads)
    tree_argmax_kernel(const float* __restrict__ logits,
                       int* __restrict__ out, int V) {
  const int best = block_argmax(logits + (long long)blockIdx.x * V, V);
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

// one block of 32·⌈T/32⌉ threads per batch row
__global__ void tree_accept_kernel(TreeArgs a) {
  accept_row(a, blockIdx.x, load_entry(a, blockIdx.x, threadIdx.x));
}

// one block per (b, t) row of the logits; tgt is written here
__global__ void __launch_bounds__(kArgmaxThreads)
    tree_verify_kernel(const float* __restrict__ logits, int* tgt,
                       int* counters, TreeArgs a, int V) {
  const int row = blockIdx.x;
  const int b = row / a.T;
  const Entry first = load_entry(a, b, threadIdx.x);
  const int best = block_argmax(logits + (long long)row * V, V);
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    tgt[row] = best;
    // release: this entry is visible before it is counted; acquire: the
    // last block sees every entry counted before its own
    int seen;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(seen)
                 : "l"(counters + b)
                 : "memory");
    s_last = seen == a.T - 1;
    if (s_last) counters[b] = 0;  // every entry of row b is in: reusable
  }
  __syncthreads();
  if (s_last) accept_row(a, b, first);
}

__global__ void empty_kernel() {}

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

// tok/tgt (B, T) int32; parent/tpos (T,) int32; valid (T,) bool; words
// (T, ⌈T/32⌉) int32 packed ancestor rows; n_acc/winner/bonus (B,) int32.
// T <= 1024.
extern "C" int tree_accept_launch(const void* tok, const void* tgt,
                                  const void* parent, const void* tpos,
                                  const void* valid, const void* words,
                                  void* n_acc, void* winner, void* bonus,
                                  int B, int T, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || T > repro_torch::kMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  const repro_torch::TreeArgs a{
      static_cast<const int*>(tok),   static_cast<const int*>(tgt),
      static_cast<const int*>(parent), static_cast<const int*>(tpos),
      static_cast<const unsigned char*>(valid),
      static_cast<const unsigned*>(words), static_cast<int*>(n_acc),
      static_cast<int*>(winner),      static_cast<int*>(bonus), T};
  repro_torch::tree_accept_kernel<<<B, (T + 31) / 32 * 32, 0,
                                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// B4a and B4b in one launch: logits (B, T, V) float32; tgt (B, T) int32
// out; counters (>= B,) int32, zero on entry and on return; the rest as in
// tree_accept_launch. T <= 1024.
extern "C" int tree_verify_launch(const void* logits, const void* tok,
                                  void* tgt, const void* parent,
                                  const void* tpos, const void* valid,
                                  const void* words, void* counters,
                                  void* n_acc, void* winner, void* bonus,
                                  int B, int T, int V, void* stream) {
  if (B <= 0) return 0;
  if (T <= 0 || T > repro_torch::kMaxEntries || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const repro_torch::TreeArgs a{
      static_cast<const int*>(tok),   static_cast<const int*>(tgt),
      static_cast<const int*>(parent), static_cast<const int*>(tpos),
      static_cast<const unsigned char*>(valid),
      static_cast<const unsigned*>(words), static_cast<int*>(n_acc),
      static_cast<int*>(winner),      static_cast<int*>(bonus), T};
  repro_torch::tree_verify_kernel<<<B * T, repro_torch::kArgmaxThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int*>(tgt),
      static_cast<int*>(counters), a, V);
  return static_cast<int>(cudaGetLastError());
}

// an empty kernel: the launch floor a short kernel is timed against
extern "C" int empty_kernel_launch(void* stream) {
  repro_torch::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
