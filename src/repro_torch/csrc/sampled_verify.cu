// B3a / B3b — sampled speculative verify on Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/verify/verify.py, glued as
// in repro/kernels/verify/ops.py::verify_window_fused (the port's glue is
// repro_torch/kernels/verify/ops.py):
//
// - gather_reduce (`gather_reduce_kernel`, pass A): for every window
//   position (b, i) of the (B, Γ) draft window, p_i(t_i), q_i(t_i) and the
//   residual mass Σ_v max(p_i − q_i, 0), float32 out whatever the input
//   type (f32 or bf16, accumulated in f32). The Pallas kernel avoided
//   gathers with a one-hot compare-and-sum over each 512-wide vocab tile;
//   a sum of one value and zeros is that value, so one direct load per
//   position gives the same bits (0 for a token outside [0, V)). The mass
//   streams the two (B·Γ, V) row sets once: bound by their bytes. Blocks
//   run in no order on 132 SMs and nothing carries between them, so the
//   TPU's sequential vocab grid becomes a 2-D grid of (row, 8192-entry
//   chunk) blocks writing partial sums, then a second kernel that adds a
//   row's partials in index order (one warp per row) and does the two
//   gathers. No float atomics: the mass feeds the resample threshold, so
//   its summation order is fixed run to run. 16-byte loads where both rows
//   of a chunk are 16-byte aligned (any V that is a multiple of 8 on a
//   fresh tensor), scalar loads otherwise.
//
// - cdf_sample (`cdf_sample_kernel`, pass B): one selected row per
//   sequence; the first v whose running sum of dist crosses thresh
//   (strictly), dist = p[b, jrow] if use_p else max(p[b, jrow] − q[b, qrow],
//   0); V − 1 when nothing crosses. The TPU scalar-prefetched jrow/qrow/
//   use_p into its index maps; here the block loads them itself. The
//   sequential cumsum becomes two passes over the row. Each of the block's
//   16 warps owns a contiguous segment; phase 1 sums it (each lane reads 8
//   contiguous entries of a 256-entry sub-tile: coalesced, 16-byte loads
//   where the rows are aligned), one block-wide exclusive scan of the 16
//   segment totals gives each segment its offset, and phase 2 walks every
//   segment again from its offset, one sub-tile at a time (lane sums, a
//   warp exclusive scan, each lane its 8 entries), to its first crossing;
//   the earliest warp's crossing wins. The kernel's CDF is thus a
//   different float32 rounding from a plain cumsum, so at a threshold
//   within a few ulps of a CDF step the crossing can move by one token
//   (chip_smoke.py flags those cases with a float64 CDF). Bound by the
//   bytes of one p row (and one q row unless use_p) up to the crossing;
//   one block per sequence leaves most SMs idle at B = 4.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kReduceThreads = 256;
constexpr int kVecIters = 4;      // 16-byte loads in flight per thread
constexpr int kChunk = 8192;      // vocab entries per pass-A block
constexpr int kFinalWarps = 8;    // rows per pass-A combine block
constexpr int kSampleWarps = 16;  // pass B: one block of 512 per row
constexpr int kLaneElems = 8;     // pass B: contiguous entries per lane
constexpr int kSubTile = 32 * kLaneElems;

// element loads widened to f32; bf16 travels as its 16 raw bits (bf16 → f32
// is a 16-bit shift, exact for every value)
__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const uint16_t* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
}

template <typename T>
struct VecN;
template <>
struct VecN<float> {
  static constexpr int n = 4;
};
template <>
struct VecN<uint16_t> {
  static constexpr int n = 8;
};

// one 16-byte load → VecN<T>::n floats (p must be 16-byte aligned)
__device__ __forceinline__ void ldv(const float* p, float* o) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void ldv(const uint16_t* p, float* o) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = __uint_as_float(w[k] << 16);
    o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// lane 0 ends with the warp's sum, added in a fixed tree order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------- pass A

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    gather_reduce_partial_kernel(const T* __restrict__ p,
                                 const T* __restrict__ q,
                                 float* __restrict__ partial, int gamma,
                                 int V, int splits) {
  constexpr int N = VecN<T>::n;
  const int row = blockIdx.x;  // b·Γ + i
  const int split = blockIdx.y;
  const int b = row / gamma;
  const int i = row - b * gamma;
  const T* pr = p + ((long long)b * (gamma + 1) + i) * V;
  const T* qr = q + (long long)row * V;
  const int c0 = split * kChunk;
  const int c1 = min(V, c0 + kChunk);
  const int tid = threadIdx.x;
  float acc = 0.f;
  int tail = c0;
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(pr + c0) |
                         reinterpret_cast<uintptr_t>(qr + c0)) & 15;
  if (mis == 0) {
    const int nv = (c1 - c0) / N;
    for (int k0 = tid; k0 < nv; k0 += kReduceThreads * kVecIters) {
      float a[kVecIters][N], c[kVecIters][N];
#pragma unroll
      for (int u = 0; u < kVecIters; ++u) {
        const int k = k0 + u * kReduceThreads;
        if (k < nv) {
          ldv(pr + c0 + k * N, a[u]);
          ldv(qr + c0 + k * N, c[u]);
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e) a[u][e] = c[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kVecIters; ++u) {
#pragma unroll
        for (int e = 0; e < N; ++e) acc += fmaxf(a[u][e] - c[u][e], 0.f);
      }
    }
    tail = c0 + nv * N;
  }
  for (int j = tail + tid; j < c1; j += kReduceThreads)
    acc += fmaxf(ldf(pr + j) - ldf(qr + j), 0.f);

  __shared__ float s_sum[kReduceThreads / 32];
  acc = warp_sum(acc);
  if ((tid & 31) == 0) s_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid < 32) {
    float v = tid < kReduceThreads / 32 ? s_sum[tid] : 0.f;
    v = warp_sum(v);
    if (tid == 0) partial[(long long)row * splits + split] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinalWarps * 32)
    gather_reduce_final_kernel(const int* __restrict__ tokens,
                               const T* __restrict__ p,
                               const T* __restrict__ q,
                               const float* __restrict__ partial,
                               float* __restrict__ p_at,
                               float* __restrict__ q_at,
                               float* __restrict__ mass, int rows, int gamma,
                               int V, int splits) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFinalWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const float* part = partial + (long long)row * splits;
  float v = 0.f;
  for (int s = lane; s < splits; s += 32) v += part[s];
  v = warp_sum(v);
  if (lane == 0) {
    const int b = row / gamma;
    const int i = row - b * gamma;
    const int t = tokens[row];
    float pa = 0.f, qa = 0.f;
    if (t >= 0 && t < V) {
      pa = ldf(p + ((long long)b * (gamma + 1) + i) * V + t);
      qa = ldf(q + (long long)row * V + t);
    }
    p_at[row] = pa;
    q_at[row] = qa;
    mass[row] = v;
  }
}

// ---------------------------------------------------------------- pass B

// 8 consecutive entries of dist from j on (zero at or past `end`): two
// float4 / one uint4 load per row where the rows are 16-byte aligned
template <typename T>
__device__ __forceinline__ void load_dist(const T* prow, const T* qrow,
                                          bool up, bool vec, int j, int end,
                                          float* d) {
  if (vec && j + kLaneElems <= end) {
    float a[kLaneElems], c[kLaneElems];
#pragma unroll
    for (int h = 0; h < kLaneElems; h += VecN<T>::n) ldv(prow + j + h, a + h);
    if (up) {
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e) d[e] = a[e];
    } else {
#pragma unroll
      for (int h = 0; h < kLaneElems; h += VecN<T>::n)
        ldv(qrow + j + h, c + h);
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e) d[e] = fmaxf(a[e] - c[e], 0.f);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      const int k = j + e;
      float x = 0.f;
      if (k < end) {
        x = ldf(prow + k);
        if (!up) x = fmaxf(x - ldf(qrow + k), 0.f);
      }
      d[e] = x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSampleWarps * 32)
    cdf_sample_kernel(const int* __restrict__ jrow,
                      const int* __restrict__ qrow,
                      const int* __restrict__ use_p,
                      const T* __restrict__ p, const T* __restrict__ q,
                      const float* __restrict__ thresh,
                      int* __restrict__ token, int gamma, int V) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the glue keeps the rows in range; clamp so a bad index cannot fault
  const int jr = min(max(jrow[b], 0), gamma);
  const int qr = min(max(qrow[b], 0), gamma - 1);
  const bool up = use_p[b] > 0;
  const float th = thresh[b];
  const T* prow = p + ((long long)b * (gamma + 1) + jr) * V;
  const T* qrw = q + ((long long)b * gamma + qr) * V;
  const bool vec = ((reinterpret_cast<uintptr_t>(prow) |
                     (up ? 0 : reinterpret_cast<uintptr_t>(qrw))) & 15) == 0;
  // warp w owns the contiguous segment [w0, w1), whole sub-tiles of 256
  const int seg = ((V + kSampleWarps - 1) / kSampleWarps + kSubTile - 1) /
                  kSubTile * kSubTile;
  const int w0 = min(V, warp * seg);
  const int w1 = min(V, w0 + seg);
  float d[kLaneElems];

  // phase 1: the segment's total
  float part = 0.f;
#pragma unroll 4
  for (int base = w0; base < w1; base += kSubTile) {
    load_dist(prow, qrw, up, vec, base + lane * kLaneElems, w1, d);
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) part += d[e];
  }
  __shared__ float s_seg[kSampleWarps];
  __shared__ int s_hit[kSampleWarps];
  part = warp_sum(part);
  if (lane == 0) s_seg[warp] = part;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the segment totals in order
    float x = lane < kSampleWarps ? s_seg[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    float ex = __shfl_up_sync(0xffffffffu, x, 1);
    if (lane == 0) ex = 0.f;
    if (lane < kSampleWarps) s_seg[lane] = ex;
  }
  __syncthreads();

  // phase 2: rescan the segment from its offset, one sub-tile at a time
  // (lane sums → warp exclusive scan → each lane walks its 8 entries), to
  // the first crossing; the block takes the earliest warp's
  float carry = s_seg[warp];
  int hit = INT_MAX;
  for (int base = w0; base < w1; base += kSubTile) {
    const int j = base + lane * kLaneElems;
    load_dist(prow, qrw, up, vec, j, w1, d);
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) sum += d[e];
    float incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    float ex = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) ex = 0.f;
    float run = carry + ex;
    int mine = INT_MAX;
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      run += d[e];
      if (mine == INT_MAX && j + e < w1 && run > th) mine = j + e;
    }
    if (__ballot_sync(0xffffffffu, mine != INT_MAX)) {
      hit = warp_min(mine);
      break;  // uniform across the warp
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) s_hit[warp] = hit;
  __syncthreads();
  if (warp == 0) {
    int m = lane < kSampleWarps ? s_hit[lane] : INT_MAX;
    m = warp_min(m);
    if (lane == 0) token[b] = m == INT_MAX ? V - 1 : m;
  }
}

template <typename T>
int launch_gather_reduce(const void* tokens, const void* p, const void* q,
                         void* partial, void* p_at, void* q_at, void* mass,
                         int B, int gamma, int V, int splits,
                         cudaStream_t stream) {
  const int rows = B * gamma;
  gather_reduce_partial_kernel<T><<<dim3(rows, splits), kReduceThreads, 0,
                                    stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(q),
      static_cast<float*>(partial), gamma, V, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_reduce_final_kernel<T>
      <<<(rows + kFinalWarps - 1) / kFinalWarps, kFinalWarps * 32, 0,
         stream>>>(static_cast<const int*>(tokens), static_cast<const T*>(p),
                   static_cast<const T*>(q),
                   static_cast<const float*>(partial),
                   static_cast<float*>(p_at), static_cast<float*>(q_at),
                   static_cast<float*>(mass), rows, gamma, V, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cdf_sample(const void* jrow, const void* qrow, const void* use_p,
                      const void* p, const void* q, const void* thresh,
                      void* token, int B, int gamma, int V,
                      cudaStream_t stream) {
  cdf_sample_kernel<T><<<B, kSampleWarps * 32, 0, stream>>>(
      static_cast<const int*>(jrow), static_cast<const int*>(qrow),
      static_cast<const int*>(use_p), static_cast<const T*>(p),
      static_cast<const T*>(q), static_cast<const float*>(thresh),
      static_cast<int*>(token), gamma, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Vocab entries per pass-A block: the wrapper sizes the partial-sum scratch
// (B·Γ, ceil(V / chunk)) float32 from it.
extern "C" int gather_reduce_chunk() { return repro_torch::kChunk; }

// tokens (B, Γ) int32; p (B, Γ+1, V) and q (B, Γ, V) of one type (dtype 0 =
// float32, 1 = bfloat16), contiguous; partial (B·Γ, splits) float32 scratch
// with splits = ceil(V / chunk); p_at/q_at/mass (B, Γ) float32 out. Returns
// cudaGetLastError() after the launches.
extern "C" int gather_reduce_launch(const void* tokens, const void* p,
                                    const void* q, void* partial, void* p_at,
                                    void* q_at, void* mass, int B, int gamma,
                                    int V, int splits, int dtype,
                                    void* stream) {
  if (B <= 0) return 0;
  if (gamma <= 0 || V <= 0 ||
      splits != (V + repro_torch::kChunk - 1) / repro_torch::kChunk ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch_gather_reduce<float>(
        tokens, p, q, partial, p_at, q_at, mass, B, gamma, V, splits, s);
  if (dtype == 1)
    return repro_torch::launch_gather_reduce<uint16_t>(
        tokens, p, q, partial, p_at, q_at, mass, B, gamma, V, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// jrow/qrow/use_p (B,) int32; p (B, Γ+1, V), q (B, Γ, V) of one type as
// above; thresh (B,) float32; token (B,) int32 out.
extern "C" int cdf_sample_launch(const void* jrow, const void* qrow,
                                 const void* use_p, const void* p,
                                 const void* q, const void* thresh,
                                 void* token, int B, int gamma, int V,
                                 int dtype, void* stream) {
  if (B <= 0) return 0;
  if (gamma <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch_cdf_sample<float>(
        jrow, qrow, use_p, p, q, thresh, token, B, gamma, V, s);
  if (dtype == 1)
    return repro_torch::launch_cdf_sample<uint16_t>(
        jrow, qrow, use_p, p, q, thresh, token, B, gamma, V, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
