// B5 — the Mamba2 SSD chunked scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd/ssd.py::_ssd_kernel (its
// call ssd_call, glued by repro/kernels/ssd/ops.py::ssd_chunked_kernel).
// Per (batch row b, head), scalar A per head, B/C shared across heads:
//
//   h_t = exp(A·dt_t)·h_{t-1} + dt_t · x_t ⊗ B_t        (h: hd × N, f32)
//   y_t = C_t · h_t
//
// computed as the SSD duality over tiles of L tokens (Lc = cumsum(A·dt)
// inside the tile):
//
//   y      = exp(Lc)·(C hᵀ) + ((C Bᵀ) ∘ causal ∘ exp(Lc_t − Lc_s) ∘ dt_s) x
//   h_out  = exp(Lc_L)·h + Σ_s exp(Lc_L − Lc_s)·dt_s · x_s ⊗ B_s
//
// The Pallas kernel walked the chunks as the sequential last grid axis and
// carried h in VMEM scratch. Here one block owns one (b, head) and walks
// its tiles in order with h resident in shared memory (transposed, N rows
// of hd + 1 floats: 16 KiB at zamba2's hd 64 / N 64, 32 KiB at
// mamba2-130m's hd 64 / N 128); nothing is carried between blocks. The
// kernel picks its own tile, L = 32 tokens (one warp wide), whatever chunk
// the caller names: chunking changes only the float order. A ragged last
// tile is handled in place (no padded copies); rows past S are never read.
// Shared memory per block: h, the B/C tiles (rows padded to N + 1 floats
// so lanes that walk rows hit distinct banks), x, the (L × L) scores and
// three L vectors — 46 KB at hd 64 / N 64, 117 KB at hd 128 / N 128, under
// the 227 KB a block may use.
//
// All arithmetic is f32 whatever the x/B/C type (f32 or bf16). The
// cumsum is sequential (one lane), so rows with dt = 0 add exactly zero:
// they are exact identities on h (the wrapper's and the model's padding
// relies on it).
//
// Bound on this card: bytes at the serving shapes (h read and written once,
// 4·hd·N bytes each per (b, head), dominates a γ+1 verify window); the
// O(S·hd·N) products on f32 CUDA cores at long prefill. This first design
// uses no tensor cores: wgmma, TMA and a parallel pass over chunks are
// later work (ROADMAP).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // tokens per tile: one lane per token column

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int HD, int N>
constexpr int smem_floats() {
  return N * (HD + 1) + 2 * kTile * (N + 1) + kTile * HD + kTile * kTile +
         3 * kTile;
}

// x (B, S, nh, HD), Bm/Cm (B, S, N) in T; dt (B, S, nh), A (nh,),
// h_in (B, nh, HD, N) f32 -> y (B, S, nh, HD), h_out (B, nh, HD, N) f32.
// Grid: B·nh blocks of kThreads.
template <typename T, int HD, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const float* __restrict__ h_in, float* __restrict__ y,
                    float* __restrict__ h_out, int S, int nh) {
  constexpr int G = kThreads / HD;  // thread groups along rows / state cols
  constexpr int R = kTile / G;      // y rows per thread
  constexpr int NS = N / G;         // state columns per thread
  constexpr int HP = HD + 1;        // padded row of the transposed state
  constexpr int NP = N + 1;         // padded row of the B/C tiles

  extern __shared__ float smem[];
  float* hT = smem;                // N × HP: hT[n][d] = h[d][n]
  float* Bs = hT + N * HP;         // kTile × NP
  float* Cs = Bs + kTile * NP;     // kTile × NP
  float* xs = Cs + kTile * NP;     // kTile × HD
  float* sc = xs + kTile * HD;     // kTile × kTile scores
  float* Lc = sc + kTile * kTile;  // cumsum of A·dt in the tile
  float* dts = Lc + kTile;         // dt
  float* wo = dts + kTile;         // exp(Lc_last − Lc_s)·dt_s

  const int b = blockIdx.x / nh;
  const int head = blockIdx.x % nh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = tid % HD;
  const int g = tid / HD;
  const float a = A[head];
  const size_t hbase = (static_cast<size_t>(b) * nh + head) * HD * N;

  for (int i = tid; i < HD * N; i += kThreads)
    hT[(i % N) * HP + i / N] = h_in[hbase + i];

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int Lv = min(kTile, S - t0);
    const size_t row0 = static_cast<size_t>(b) * S + t0;
    if (warp == 0) {
      const float dv = lane < Lv ? dt[(row0 + lane) * nh + head] : 0.f;
      dts[lane] = dv;
      Lc[lane] = a * dv;
      __syncwarp();
      if (lane == 0) {
        float c = 0.f;
        for (int t = 0; t < Lv; ++t) {
          c += Lc[t];
          Lc[t] = c;
        }
      }
      __syncwarp();
      wo[lane] = lane < Lv ? expf(Lc[Lv - 1] - Lc[lane]) * dv : 0.f;
    }
    for (int i = tid; i < Lv * HD; i += kThreads)
      xs[i] = to_f32(x[((row0 + i / HD) * nh + head) * HD + i % HD]);
    for (int i = tid; i < Lv * N; i += kThreads) {
      const int t = i / N, n = i % N;
      Bs[t * NP + n] = to_f32(Bm[row0 * N + i]);
      Cs[t * NP + n] = to_f32(Cm[row0 * N + i]);
    }
    __syncthreads();

    // scores[t][s] = (C_t · B_s)·exp(Lc_t − Lc_s)·dt_s for s ≤ t; lane = s
    for (int t = warp; t < Lv; t += kThreads / 32) {
      float v = 0.f;
      if (lane <= t) {
        float dot = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) dot += Cs[t * NP + n] * Bs[lane * NP + n];
        v = dot * expf(Lc[t] - Lc[lane]) * dts[lane];
      }
      sc[t * kTile + lane] = v;
    }
    __syncthreads();

    // y[t][d] = exp(Lc_t)·(C_t · h[d]) + Σ_{s ≤ t} scores[t][s]·x[s][d]
    // for the rows t = g + r·G of this thread
    {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float hv = hT[n * HP + d];
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (g + r * G < Lv) acc[r] += Cs[(g + r * G) * NP + n] * hv;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = g + r * G;
        if (t < Lv) acc[r] *= expf(Lc[t]);
      }
      for (int s = 0; s < Lv; ++s) {
        const float xv = xs[s * HD + d];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int t = g + r * G;
          if (t < Lv && s <= t) acc[r] += sc[t * kTile + s] * xv;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = g + r * G;
        if (t < Lv) y[((row0 + t) * nh + head) * HD + d] = acc[r];
      }
    }
    __syncthreads();  // every y read h before the update below

    // h[d][n] = exp(Lc_last)·h[d][n] + Σ_s wo_s·x[s][d]·B[s][n] for the
    // state columns n = g + j·G of this thread (each element one owner)
    {
      const float decay = expf(Lc[Lv - 1]);
      float acc[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) acc[j] = decay * hT[(g + j * G) * HP + d];
      for (int s = 0; s < Lv; ++s) {
        const float xw = wo[s] * xs[s * HD + d];
#pragma unroll
        for (int j = 0; j < NS; ++j) acc[j] += xw * Bs[s * NP + g + j * G];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) hT[(g + j * G) * HP + d] = acc[j];
    }
    __syncthreads();  // the next tile overwrites x, B, C, Lc
  }

  for (int i = tid; i < HD * N; i += kThreads)
    h_out[hbase + i] = hT[(i % N) * HP + i / N];
}

template <typename T, int HD, int N>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt,
           const void* A, const void* h_in, void* y, void* h_out, int B,
           int S, int nh, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, HD, N>;
  constexpr int bytes = smem_floats<HD, N>() * static_cast<int>(sizeof(float));
  // set once per instantiation, on the first (eager) call: never inside a
  // CUDA-graph capture
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kernel<<<B * nh, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(h_in),
      static_cast<float*>(y), static_cast<float*>(h_out), S, nh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_n(int N, const void* x, const void* Bm, const void* Cm,
             const void* dt, const void* A, const void* h_in, void* y,
             void* h_out, int B, int S, int nh, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, HD, 16>(x, Bm, Cm, dt, A, h_in, y, h_out, B, S, nh,
                               stream);
    case 32:
      return launch<T, HD, 32>(x, Bm, Cm, dt, A, h_in, y, h_out, B, S, nh,
                               stream);
    case 64:
      return launch<T, HD, 64>(x, Bm, Cm, dt, A, h_in, y, h_out, B, S, nh,
                               stream);
    case 128:
      return launch<T, HD, 128>(x, Bm, Cm, dt, A, h_in, y, h_out, B, S, nh,
                                stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_hd(int hd, int N, const void* x, const void* Bm, const void* Cm,
              const void* dt, const void* A, const void* h_in, void* y,
              void* h_out, int B, int S, int nh, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_n<T, 16>(N, x, Bm, Cm, dt, A, h_in, y, h_out, B, S, nh,
                             stream);
    case 32:
      return launch_n<T, 32>(N, x, Bm, Cm, dt, A, h_in, y, h_out, B, S, nh,
                             stream);
    case 64:
      return launch_n<T, 64>(N, x, Bm, Cm, dt, A, h_in, y, h_out, B, S, nh,
                             stream);
    case 128:
      return launch_n<T, 128>(N, x, Bm, Cm, dt, A, h_in, y, h_out, B, S, nh,
                              stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// x (B, S, nh, hd) and Bm/Cm (B, S, N) in dtype (0 = f32, 1 = bf16);
// dt (B, S, nh), A (nh,), h_in (B, nh, hd, N) f32; y (B, S, nh, hd) and
// h_out (B, nh, hd, N) f32. hd, N ∈ {16, 32, 64, 128}; all contiguous.
extern "C" int ssd_scan_launch(const void* x, const void* Bm, const void* Cm,
                               const void* dt, const void* A,
                               const void* h_in, void* y, void* h_out, int B,
                               int S, int nh, int hd, int N, int dtype,
                               void* stream) {
  if (B <= 0 || nh <= 0) return 0;
  if (S < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch_hd<float>(hd, N, x, Bm, Cm, dt, A, h_in, y,
                                         h_out, B, S, nh, st);
  if (dtype == 1)
    return repro_torch::launch_hd<__nv_bfloat16>(hd, N, x, Bm, Cm, dt, A,
                                                 h_in, y, h_out, B, S, nh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
