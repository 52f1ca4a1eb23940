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
//   use_p into its index maps and walked the vocab tiles in order with a
//   running sum; here each block loads them itself. Bound by the bytes of
//   one p row (and one q row unless use_p) up to the crossing: 0.6–1.2 MB
//   per sequence at V 151936 f32, ~0.2–0.4 µs per row at 3.35 TB/s, so a
//   row must be spread over many SMs (one block per sequence left 128 of
//   132 idle at B = 4). The row is cut into fixed splits of 4096 entries,
//   a function of the vocab index alone:
//     1. cdf_total_kernel, grid (B, splits): each split's total (16
//        contiguous entries per thread, 16-byte loads where the rows are
//        aligned, then a fixed tree order), 152 blocks at B 4, V 151936;
//     2. cdf_search_kernel, grid (B): one warp scans the totals in a fixed
//        order (a shuffle scan, 32 at a time, carried in index order) to
//        the first split whose running total crosses thresh, its offset
//        the sum of the splits before it; the block rescans that split
//        from its offset (lane sums, a fixed block scan, each thread its
//        16 entries) and the earliest crossing wins through an integer min.
//        If the split's own float sums never cross (they round otherwise
//        than its total), the token is the split's last entry with
//        dist > 0: the CDF step the totals put the threshold at, never a
//        zero-probability token.
//   Every sum — the totals, the offsets, the running sum — is float64, and
//   v crosses when the running sum rounded to float32 exceeds thresh, as
//   the plain version and PyTorch's CPU cumsum of float32 (float64
//   accumulation, float32 out) do: the kernel's CDF is the exact one to
//   float32 rounding. A float32 accumulation in another order than the
//   plain version's disagreed with it at thresholds on a CDF step in
//   several rows of the planted last-step case (PERF.md). No float
//   atomics: every sum has a fixed order, so the token is a function of
//   the row's inputs alone (the same in a B 1 and a B 4 call, run after
//   run). Where the threshold itself comes from another sum order (the
//   glue's mass from B3a against a plain mass), the crossing can still
//   move by one token at a CDF step (chip_smoke.py flags those cases with
//   a float64 CDF).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kReduceThreads = 256;
constexpr int kVecIters = 4;      // 16-byte loads in flight per thread
constexpr int kChunk = 8192;      // vocab entries per pass-A block
constexpr int kFinalWarps = 8;    // rows per pass-A combine block
constexpr int kLaneElems = 8;     // pass B: entries per load_dist
constexpr int kSplit = 4096;      // pass B: vocab entries per split
constexpr int kSplitThreads = 256;
constexpr int kThreadElems = kSplit / kSplitThreads;  // 16, contiguous

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
template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
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

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// the selected row of sequence b: p row jrow (clamped to [0, Γ]) and, unless
// use_p, q row qrow (clamped to [0, Γ)); the glue keeps them in range, the
// clamp keeps a bad index from faulting
template <typename T>
struct SampleRow {
  const T* p;
  const T* q;
  bool up;
  bool vec;
  __device__ SampleRow(const int* jrow, const int* qrow, const int* use_p,
                       const T* pb, const T* qb, int b, int gamma, int V) {
    const int jr = min(max(jrow[b], 0), gamma);
    const int qr = min(max(qrow[b], 0), gamma - 1);
    up = use_p[b] > 0;
    p = pb + ((long long)b * (gamma + 1) + jr) * V;
    q = qb + ((long long)b * gamma + qr) * V;
    vec = ((reinterpret_cast<uintptr_t>(p) |
            (up ? 0 : reinterpret_cast<uintptr_t>(q))) & 15) == 0;
  }
  // this thread's 16 entries of dist from j on (zero at or past end)
  __device__ __forceinline__ void load(int j, int end, float* d) const {
    load_dist(p, q, up, vec, j, end, d);
    load_dist(p, q, up, vec, j + kLaneElems, end, d + kLaneElems);
  }
};

// inclusive scan over the lanes in a fixed order
__device__ __forceinline__ double warp_incl_scan(double v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// the float64 running sum crosses thresh when it rounds above it in float32
__device__ __forceinline__ bool crosses(double run, float th) {
  return __double2float_rn(run) > th;
}

// pass B1: totals[b][split] = Σ dist over the split's 4096 entries
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
    cdf_total_kernel(const int* __restrict__ jrow,
                     const int* __restrict__ qrow,
                     const int* __restrict__ use_p, const T* __restrict__ p,
                     const T* __restrict__ q, double* __restrict__ totals,
                     int gamma, int V, int splits) {
  const int b = blockIdx.x, split = blockIdx.y;
  const SampleRow<T> row(jrow, qrow, use_p, p, q, b, gamma, V);
  const int end = min(V, (split + 1) * kSplit);
  float d[kThreadElems];
  row.load(split * kSplit + threadIdx.x * kThreadElems, end, d);
  double s = 0.0;
#pragma unroll
  for (int e = 0; e < kThreadElems; ++e) s += d[e];
  __shared__ double s_sum[kSplitThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  if (lane == 0) s_sum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    double v = lane < kSplitThreads / 32 ? s_sum[lane] : 0.0;
    v = warp_sum(v);
    if (lane == 0) totals[(long long)b * splits + split] = v;
  }
}

// pass B2: the split that holds the crossing, then the crossing in it
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
    cdf_search_kernel(const int* __restrict__ jrow,
                      const int* __restrict__ qrow,
                      const int* __restrict__ use_p, const T* __restrict__ p,
                      const T* __restrict__ q,
                      const float* __restrict__ thresh,
                      const double* __restrict__ totals,
                      int* __restrict__ token, int gamma, int V,
                      int splits) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float th = thresh[b];
  __shared__ int s_k;
  __shared__ double s_off;
  __shared__ double s_scan[kSplitThreads / 32];
  __shared__ int s_hit[kSplitThreads / 32];
  __shared__ int s_last[kSplitThreads / 32];
  if (warp == 0) {
    const double* tot = totals + (long long)b * splits;
    double carry = 0.0, off = 0.0;
    int k = -1;
    for (int base = 0; base < splits; base += 32) {
      const int i = base + lane;
      const double incl =
          carry + warp_incl_scan(i < splits ? tot[i] : 0.0, lane);
      double ex = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) ex = carry;
      const unsigned hit =
          __ballot_sync(0xffffffffu, i < splits && crosses(incl, th));
      if (hit) {
        const int l = __ffs(hit) - 1;
        k = base + l;
        off = __shfl_sync(0xffffffffu, ex, l);
        break;  // uniform across the warp
      }
      carry = __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      s_k = k;
      s_off = off;
    }
  }
  __syncthreads();
  const int k = s_k;
  if (k < 0) {  // nothing crosses
    if (tid == 0) token[b] = V - 1;
    return;
  }
  const SampleRow<T> row(jrow, qrow, use_p, p, q, b, gamma, V);
  const int end = min(V, (k + 1) * kSplit);
  const int j = k * kSplit + tid * kThreadElems;
  float d[kThreadElems];
  row.load(j, end, d);
  double sum = 0.0;
  int last = -1;
#pragma unroll
  for (int e = 0; e < kThreadElems; ++e) {
    sum += d[e];
    if (d[e] > 0.f) last = j + e;
  }
  // exclusive prefix of the thread sums: warp scan, then the warp totals
  // scanned in order by warp 0
  const double incl = warp_incl_scan(sum, lane);
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const double v = lane < kSplitThreads / 32 ? s_scan[lane] : 0.0;
    const double wi = warp_incl_scan(v, lane);
    double we = __shfl_up_sync(0xffffffffu, wi, 1);
    if (lane == 0) we = 0.0;
    if (lane < kSplitThreads / 32) s_scan[lane] = we;
  }
  __syncthreads();
  double run = s_off + (s_scan[warp] + (incl - sum));
  int mine = INT_MAX;
#pragma unroll
  for (int e = 0; e < kThreadElems; ++e) {
    run += d[e];
    if (mine == INT_MAX && j + e < end && crosses(run, th)) mine = j + e;
  }
  mine = warp_min(mine);
  last = warp_max(last);
  if (lane == 0) {
    s_hit[warp] = mine;
    s_last[warp] = last;
  }
  __syncthreads();
  if (warp == 0) {
    int m = lane < kSplitThreads / 32 ? s_hit[lane] : INT_MAX;
    int l = lane < kSplitThreads / 32 ? s_last[lane] : -1;
    m = warp_min(m);
    l = warp_max(l);
    if (lane == 0) token[b] = m != INT_MAX ? m : (l >= 0 ? l : V - 1);
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
                      void* totals, void* token, int B, int gamma, int V,
                      int splits, cudaStream_t stream) {
  const int* jr = static_cast<const int*>(jrow);
  const int* qr = static_cast<const int*>(qrow);
  const int* up = static_cast<const int*>(use_p);
  cdf_total_kernel<T><<<dim3(B, splits), kSplitThreads, 0, stream>>>(
      jr, qr, up, static_cast<const T*>(p), static_cast<const T*>(q),
      static_cast<double*>(totals), gamma, V, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cdf_search_kernel<T><<<B, kSplitThreads, 0, stream>>>(
      jr, qr, up, static_cast<const T*>(p), static_cast<const T*>(q),
      static_cast<const float*>(thresh), static_cast<const double*>(totals),
      static_cast<int*>(token), gamma, V, splits);
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

// Vocab entries per pass-B split: the wrapper sizes the split-total
// scratch (B, ceil(V / split)) float64 from it.
extern "C" int cdf_sample_split() { return repro_torch::kSplit; }

// jrow/qrow/use_p (B,) int32; p (B, Γ+1, V), q (B, Γ, V) of one type as
// above; thresh (B,) float32; totals (B, splits) float64 scratch with
// splits = ceil(V / split); token (B,) int32 out.
extern "C" int cdf_sample_launch(const void* jrow, const void* qrow,
                                 const void* use_p, const void* p,
                                 const void* q, const void* thresh,
                                 void* totals, void* token, int B, int gamma,
                                 int V, int splits, int dtype,
                                 void* stream) {
  if (B <= 0) return 0;
  if (gamma <= 0 || V <= 0 ||
      splits != (V + repro_torch::kSplit - 1) / repro_torch::kSplit ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch_cdf_sample<float>(
        jrow, qrow, use_p, p, q, thresh, totals, token, B, gamma, V, splits,
        s);
  if (dtype == 1)
    return repro_torch::launch_cdf_sample<uint16_t>(
        jrow, qrow, use_p, p, q, thresh, totals, token, B, gamma, V, splits,
        s);
  return static_cast<int>(cudaErrorInvalidValue);
}
