// The gradient of B5 (the Mamba2 SSD scan) on Hopper (sm_90a): ssd_scan_bwd.
//
// Replaces no TPU kernel: the Pallas kernel repro/kernels/ssd/ssd.py::
// _ssd_kernel has no backward, and the reference trains through
// jax.value_and_grad of its jnp ssd_chunked (repro/models/ssm.py:127). The
// port runs B5 in every Mamba2 block of training on the card, so the
// gradient of that same function is this kernel
// (kernels/ssd/ops.py::SSDScanFn.backward).
//
// Per (batch row b, head), scalar A, B/C shared across heads:
//
//   h_t = a_t·h_{t-1} + dt_t · x_t ⊗ B_t,   a_t = exp(A·dt_t)   (h: hd × N)
//   y_t = C_t · h_t
//
// Given dy and dh_out, the gradient of h_t, g_t (hd × N), runs backwards:
//
//   g_t = dy_t ⊗ C_t + a_{t+1}·g_{t+1},   g_{S-1} includes dh_out
//
// and every input gradient is a contraction of g_t, h_t, h_{t-1} with the
// step's inputs:
//
//   dx_t[d]  = dt_t · Σ_n g_t[d,n] B_t[n]
//   dB_t[n]  = dt_t · Σ_{head,d} g_t[d,n] x_t[d]
//   dC_t[n]  = Σ_{head,d} dy_t[d] h_t[d,n]
//   dla_t    = a_t · <g_t, h_{t-1}>                (∂L/∂(A·dt_t))
//   ddt_t    = Σ_d x_t[d] Σ_n g_t[d,n] B_t[n] + A·dla_t
//   dA       = Σ_{b,t} dt_t · dla_t
//   dh_in    = a_0 · g_0
//
// Design (a simple kernel that is right first):
//
// - The recurrence is elementwise in (d, n), so the state splits freely. A
//   block of 256 threads takes one (b, head) and a tile of NC = min(N, 32)
//   state columns over all hd rows; a warp spans 32 / NC rows × NC columns
//   and each thread holds E = hd·NC / 256 elements of h and g in registers.
//   Grid (N / NC, nh, B).
// - Going backwards needs h_t and h_{t-1} at every t. The block first runs
//   the recurrence forward over the whole sequence, writing its tile of h at
//   the start of every group of K = min(16, 64 / E) steps to a scratch
//   buffer (ceil(S/K)·hd·N floats per (b, head): the wrapper allocates it).
//   Then, group by group from the last, it reloads the group's checkpoint,
//   re-runs the group's K steps keeping each h_t in registers (K·E ≤ 64
//   floats), and walks them backwards carrying g. Each group's x, dy, B, C
//   and dt are staged in shared memory first.
// - Reductions: over a row's columns (dx, and ddt's first term) by warp
//   shuffles; over rows (dB, dC) by shuffles inside the warp, then a
//   per-warp partial in shared memory summed in warp order once per group.
//   Columns of other tiles and other heads are summed by a second kernel
//   (sum_axis_kernel) over partial buffers in a fixed order, so the result
//   does not depend on scheduling: no atomics. dla is formed from h_{t-1}
//   directly (no difference of two large terms).
// - Types: x, B, C in f32 or bf16 (widened on load), dt, A, h_in, dy, dh_out
//   f32; all arithmetic f32; dx, dB, dC come back in x's type, ddt, dA and
//   dh_in in f32. hd, N ∈ {16, 32, 64, 128}, as B5 takes.
//
// Bound on this card: bytes. Inputs and outputs are read and written once
// in the bound (chip_smoke.py ssd_bwd_bound); this kernel moves more: the
// checkpoints (written once, read once: 8·hd·N/K bytes per (b, head, step))
// and the partial buffers, and it re-reads x/dy once per column tile. Its
// chain of dependent steps per block (a sequential scan over S, twice) and
// the per-group barriers are what a redesign (the chunked SSD backward on
// tensor cores, as B5's forward) would remove.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct BwdArgs {
  const void* x;        // (B, S, nh, hd) T
  const void* Bm;       // (B, S, N) T
  const void* Cm;       // (B, S, N) T
  const float* dt;      // (B, S, nh)
  const float* A;       // (nh,)
  const float* h_in;    // (B, nh, hd, N)
  const float* dy;      // (B, S, nh, hd)
  const float* dh_out;  // (B, nh, hd, N)
  float* dh_in;         // (B, nh, hd, N)
  float* ckpt;          // (B, nh, nct, n_groups, E·256)
  float* dxp;           // (B, S, nh, nct, hd)
  float* dBp;           // (B, S, nh, N)
  float* dCp;           // (B, S, nh, N)
  float* ddtp;          // (B, S, nh, nct)
  float* dAp;           // (B, nct, nh)
  int B, S, nh, N, nct;
};

// E state rows per thread, NC columns per block: a warp covers RW = 32/NC
// rows, the block ROWS = 8·RW rows per pass, hd = E·ROWS; thread element i
// is row warp·RW + lane/NC + i·ROWS, column lane % NC of the tile. K steps
// per group (between two checkpoints).
template <int E, int NC>
struct Tile {
  static constexpr int RW = 32 / NC;
  static constexpr int ROWS = kWarps * RW;
  static constexpr int HD = E * ROWS;
  static constexpr int K = (64 / E) < 16 ? (64 / E) : 16;
};

// a group's inputs, and the per-step partial sums of its reverse walk
template <int E, int NC>
struct Smem {
  using P = Tile<E, NC>;
  float x[P::K][P::HD];
  float dy[P::K][P::HD];
  float gB[P::K][P::HD];  // Σ_n g·B per row over this tile's columns
  float B[P::K][NC];
  float C[P::K][NC];
  float dt[P::K];
  float a[P::K];
  float dB[P::K][kWarps][NC];
  float dC[P::K][kWarps][NC];
  float gh[P::K][kWarps];  // per-warp <g_t, h_{t-1}>
  float dA[P::K];
};

// stage steps [t0, t0 + K) of (b, head) and column tile ct; steps past S
// get zeros (never stepped: every loop checks t < S). dy and C only for
// the backward walk.
template <typename T, int E, int NC>
__device__ __forceinline__ void stage(Smem<E, NC>& sm, const BwdArgs& p,
                                      int b, int head, int ct, float A,
                                      int t0, bool backward) {
  using P = Tile<E, NC>;
  const int tid = threadIdx.x, S = p.S, nh = p.nh, N = p.N;
  const T* x = static_cast<const T*>(p.x);
  const T* Bm = static_cast<const T*>(p.Bm);
  const T* Cm = static_cast<const T*>(p.Cm);
  for (int idx = tid; idx < P::K * P::HD; idx += kThreads) {
    const int k = idx / P::HD, d = idx % P::HD, t = t0 + k;
    float xv = 0.f, dyv = 0.f;
    if (t < S) {
      const size_t o =
          ((static_cast<size_t>(b) * S + t) * nh + head) * P::HD + d;
      xv = to_f32(x[o]);
      if (backward) dyv = p.dy[o];
    }
    sm.x[k][d] = xv;
    sm.dy[k][d] = dyv;
  }
  for (int idx = tid; idx < P::K * NC; idx += kThreads) {
    const int k = idx / NC, c = idx % NC, t = t0 + k;
    float bv = 0.f, cv = 0.f;
    if (t < S) {
      const size_t o = (static_cast<size_t>(b) * S + t) * N + ct * NC + c;
      bv = to_f32(Bm[o]);
      if (backward) cv = to_f32(Cm[o]);
    }
    sm.B[k][c] = bv;
    sm.C[k][c] = cv;
  }
  if (tid < P::K) {
    const int t = t0 + tid;
    const float d =
        t < S ? p.dt[(static_cast<size_t>(b) * S + t) * nh + head] : 0.f;
    sm.dt[tid] = d;
    sm.a[tid] = expf(A * d);
  }
}

template <typename T, int E, int NC>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel(const BwdArgs p) {
  using P = Tile<E, NC>;
  constexpr int ROWS = P::ROWS, HD = P::HD, K = P::K;
  __shared__ Smem<E, NC> sm;

  const int ct = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col = lane % NC, rsub = lane / NC;
  const int S = p.S, nh = p.nh, N = p.N;
  const int n = ct * NC + col;
  const int row0 = warp * P::RW + rsub;
  const float A = p.A[head];
  const size_t bh = static_cast<size_t>(b) * nh + head;
  const int n_groups = (S + K - 1) / K;
  float* ck = p.ckpt +
              (bh * p.nct + ct) * static_cast<size_t>(n_groups) * E * kThreads;

  float h[E], g[E];
#pragma unroll
  for (int i = 0; i < E; ++i)
    h[i] = p.h_in[(bh * HD + row0 + i * ROWS) * N + n];

  // ---- forward: a checkpoint at the start of every group of K steps
  for (int j = 0; j < n_groups; ++j) {
#pragma unroll
    for (int i = 0; i < E; ++i)
      ck[(static_cast<size_t>(j) * E + i) * kThreads + tid] = h[i];
    __syncthreads();
    stage<T, E, NC>(sm, p, b, head, ct, A, j * K, false);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j * K + k < S) {
        const float ub = sm.dt[k] * sm.B[k][col];
#pragma unroll
        for (int i = 0; i < E; ++i)
          h[i] = fmaf(sm.a[k], h[i], ub * sm.x[k][row0 + i * ROWS]);
      }
    }
  }

  // ---- backward, group by group from the last
#pragma unroll
  for (int i = 0; i < E; ++i)
    g[i] = p.dh_out[(bh * HD + row0 + i * ROWS) * N + n];
  float a_next = 1.f;   // a_{t+1}; 1 past the last step (g starts at dh_out)
  float dA_acc = 0.f;   // thread 0: Σ_t dt_t·dla_t in reverse time order
  for (int j = n_groups - 1; j >= 0; --j) {
    const int t0 = j * K;
    __syncthreads();
    stage<T, E, NC>(sm, p, b, head, ct, A, t0, true);
    __syncthreads();
    float h0[E], hist[K][E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      h0[i] = ck[(static_cast<size_t>(j) * E + i) * kThreads + tid];
      h[i] = h0[i];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (t0 + k < S) {
        const float ub = sm.dt[k] * sm.B[k][col];
#pragma unroll
        for (int i = 0; i < E; ++i)
          h[i] = fmaf(sm.a[k], h[i], ub * sm.x[k][row0 + i * ROWS]);
      }
#pragma unroll
      for (int i = 0; i < E; ++i) hist[k][i] = h[i];
    }
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      if (t0 + k < S) {  // the same for every thread of the block
        const float cv = sm.C[k][col], bv = sm.B[k][col];
        float pdB = 0.f, pdC = 0.f, pP = 0.f, gB[E];
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int d = row0 + i * ROWS;
          const float dyv = sm.dy[k][d];
          g[i] = fmaf(a_next, g[i], dyv * cv);
          const float hprev = k > 0 ? hist[k > 0 ? k - 1 : 0][i] : h0[i];
          pdC = fmaf(dyv, hist[k][i], pdC);
          pdB = fmaf(g[i], sm.x[k][d], pdB);
          pP = fmaf(g[i], hprev, pP);
          gB[i] = g[i] * bv;
        }
#pragma unroll
        for (int i = 0; i < E; ++i) {
#pragma unroll
          for (int off = NC / 2; off > 0; off >>= 1)
            gB[i] += __shfl_xor_sync(0xffffffffu, gB[i], off);
        }
        if (col == 0) {
#pragma unroll
          for (int i = 0; i < E; ++i) sm.gB[k][row0 + i * ROWS] = gB[i];
        }
#pragma unroll
        for (int off = NC; off < 32; off <<= 1) {
          pdB += __shfl_xor_sync(0xffffffffu, pdB, off);
          pdC += __shfl_xor_sync(0xffffffffu, pdC, off);
        }
        if (rsub == 0) {
          sm.dB[k][warp][col] = pdB;
          sm.dC[k][warp][col] = pdC;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          pP += __shfl_xor_sync(0xffffffffu, pP, off);
        if (lane == 0) sm.gh[k][warp] = pP;
        a_next = sm.a[k];
      }
    }
    __syncthreads();
    // this group's partial gradients: dB, dC over this tile's columns
    // (complete over rows), dx over this tile's columns, ddt, dA
    for (int idx = tid; idx < K * NC; idx += kThreads) {
      const int k = idx / NC, c = idx % NC, t = t0 + k;
      if (t >= S) continue;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += sm.dB[k][w][c];
        sc += sm.dC[k][w][c];
      }
      const size_t o = ((static_cast<size_t>(b) * S + t) * nh + head) * N +
                       ct * NC + c;
      p.dBp[o] = sm.dt[k] * sb;
      p.dCp[o] = sc;
    }
    for (int idx = tid; idx < K * HD; idx += kThreads) {
      const int k = idx / HD, d = idx % HD, t = t0 + k;
      if (t >= S) continue;
      p.dxp[(((static_cast<size_t>(b) * S + t) * nh + head) * p.nct + ct) *
                HD + d] = sm.dt[k] * sm.gB[k][d];
    }
    if (tid < K) {
      const int k = tid, t = t0 + k;
      float v = 0.f;
      if (t < S) {
        float xg = 0.f, gh = 0.f;   // x·(g·B) and <g_t, h_{t-1}>
        for (int d = 0; d < HD; ++d) xg = fmaf(sm.x[k][d], sm.gB[k][d], xg);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) gh += sm.gh[k][w];
        const float dla = sm.a[k] * gh;
        p.ddtp[((static_cast<size_t>(b) * S + t) * nh + head) * p.nct + ct] =
            fmaf(A, dla, xg);
        v = sm.dt[k] * dla;
      }
      sm.dA[k] = v;
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = K - 1; k >= 0; --k) dA_acc += sm.dA[k];
    }
  }
  // a_next is a_0 here (1 when S == 0: dh_in = dh_out)
#pragma unroll
  for (int i = 0; i < E; ++i)
    p.dh_in[(bh * HD + row0 + i * ROWS) * N + n] = a_next * g[i];
  if (tid == 0)
    p.dAp[(static_cast<size_t>(b) * p.nct + ct) * nh + head] = dA_acc;
}

// out[o, i] = Σ_j in[o, j, i] (j in order), written in TO
template <typename TO>
__global__ void __launch_bounds__(256)
    sum_axis_kernel(const float* __restrict__ in, TO* __restrict__ out,
                    long long outer, int J, int inner) {
  const long long total = outer * inner;
  for (long long idx = blockIdx.x * 256LL + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * 256) {
    const long long o = idx / inner;
    const int i = static_cast<int>(idx % inner);
    const float* src = in + o * J * inner + i;
    float s = 0.f;
    for (int j = 0; j < J; ++j) s += src[static_cast<long long>(j) * inner];
    out[idx] = from_f32<TO>(s);
  }
}

template <typename TO>
int sum_axis(const float* in, void* out, long long outer, int J, int inner,
             cudaStream_t st) {
  const long long total = outer * inner;
  if (total <= 0) return 0;
  long long blocks = (total + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  sum_axis_kernel<TO><<<static_cast<int>(blocks), 256, 0, st>>>(
      in, static_cast<TO*>(out), outer, J, inner);
  return static_cast<int>(cudaGetLastError());
}

constexpr int cols_of(int N) { return N < 32 ? N : 32; }
constexpr int rows_per_thread(int hd, int N) {
  return hd / (kWarps * (32 / cols_of(N)));
}

template <typename T, int NC>
int launch_e(int E, const BwdArgs& a, cudaStream_t st) {
  const dim3 grid(a.nct, a.nh, a.B);
  switch (E) {
    case 1:
      if (NC == 16) {
        ssd_bwd_kernel<T, 1, 16><<<grid, kThreads, 0, st>>>(a);
        return static_cast<int>(cudaGetLastError());
      }
      break;
    case 2:
      ssd_bwd_kernel<T, 2, NC><<<grid, kThreads, 0, st>>>(a);
      return static_cast<int>(cudaGetLastError());
    case 4:
      ssd_bwd_kernel<T, 4, NC><<<grid, kThreads, 0, st>>>(a);
      return static_cast<int>(cudaGetLastError());
    case 8:
      ssd_bwd_kernel<T, 8, NC><<<grid, kThreads, 0, st>>>(a);
      return static_cast<int>(cudaGetLastError());
    case 16:
      if (NC == 32) {
        ssd_bwd_kernel<T, 16, 32><<<grid, kThreads, 0, st>>>(a);
        return static_cast<int>(cudaGetLastError());
      }
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_all(int hd, const BwdArgs& a, void* dx, void* dB, void* dC,
               float* ddt, float* dA, cudaStream_t st) {
  const int E = rows_per_thread(hd, a.N);
  int err = a.N == 16 ? launch_e<T, 16>(E, a, st) : launch_e<T, 32>(E, a, st);
  if (err) return err;
  const long long BS = static_cast<long long>(a.B) * a.S;
  if ((err = sum_axis<T>(a.dxp, dx, BS * a.nh, a.nct, hd, st))) return err;
  if ((err = sum_axis<T>(a.dBp, dB, BS, a.nh, a.N, st))) return err;
  if ((err = sum_axis<T>(a.dCp, dC, BS, a.nh, a.N, st))) return err;
  if ((err = sum_axis<float>(a.ddtp, ddt, BS * a.nh, a.nct, 1, st)))
    return err;
  return sum_axis<float>(a.dAp, dA, 1, a.B * a.nct, a.nh, st);
}

bool supported(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }

}  // namespace
}  // namespace repro_torch

// Steps between two checkpoints of the state (K above) for hd × N, or 0 if
// the kernel does not take the shape: the wrapper sizes the checkpoint
// scratch (B, nh, ceil(S / K), hd, N) float32 from it.
extern "C" int ssd_scan_bwd_interval(int hd, int N) {
  using namespace repro_torch;
  if (!supported(hd) || !supported(N)) return 0;
  const int E = rows_per_thread(hd, N);
  const int k = 64 / E;
  return k < 16 ? k : 16;
}

// State columns per block: the partial buffers carry N / cols tiles.
extern "C" int ssd_scan_bwd_cols(int N) { return repro_torch::cols_of(N); }

// Inputs as B5 takes them plus dy (B, S, nh, hd) and dh_out (B, nh, hd, N)
// float32; outputs dx (x's shape and type), dB, dC ((B, S, N), x's type),
// ddt (B, S, nh), dA (nh,), dh_in (B, nh, hd, N) float32; scratch: ckpt
// (B, nh, ceil(S/K), hd, N), dxp (B, S, nh, nct, hd), dBp and dCp
// (B, S, nh, N), ddtp (B, S, nh, nct), dAp (B, nct, nh), all float32,
// nct = N / cols. Everything contiguous. dtype 0 = f32, 1 = bf16.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* Bm, const void* Cm, const void* dt,
    const void* A, const void* h_in, const void* dy, const void* dh_out,
    void* dx, void* dB, void* dC, void* ddt, void* dA, void* dh_in,
    void* ckpt, void* dxp, void* dBp, void* dCp, void* ddtp, void* dAp,
    int B, int S, int nh, int hd, int N, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || nh <= 0) return 0;
  if (S < 0 || !supported(hd) || !supported(N))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.x = x;
  a.Bm = Bm;
  a.Cm = Cm;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.h_in = static_cast<const float*>(h_in);
  a.dy = static_cast<const float*>(dy);
  a.dh_out = static_cast<const float*>(dh_out);
  a.dh_in = static_cast<float*>(dh_in);
  a.ckpt = static_cast<float*>(ckpt);
  a.dxp = static_cast<float*>(dxp);
  a.dBp = static_cast<float*>(dBp);
  a.dCp = static_cast<float*>(dCp);
  a.ddtp = static_cast<float*>(ddtp);
  a.dAp = static_cast<float*>(dAp);
  a.B = B;
  a.S = S;
  a.nh = nh;
  a.N = N;
  a.nct = N / cols_of(N);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(hd, a, dx, dB, dC, static_cast<float*>(ddt),
                             static_cast<float*>(dA), st);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(hd, a, dx, dB, dC,
                                     static_cast<float*>(ddt),
                                     static_cast<float*>(dA), st);
  return static_cast<int>(cudaErrorInvalidValue);
}
