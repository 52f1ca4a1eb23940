// The gradient of B5 (the Mamba2 SSD scan) on Hopper (sm_90a): ssd_scan_bwd,
// the kernels, shared by ssd_scan_bwd.cu (bf16 instantiations and the C
// entries) and ssd_scan_bwd_f32.cu (f32 instantiations), two sources so they
// build in two parallel nvcc processes.
//
// Replaces no TPU kernel: the Pallas kernel repro/kernels/ssd/ssd.py::
// _ssd_kernel has no backward, and the reference trains through
// jax.value_and_grad of its jnp ssd_chunked (repro/models/ssm.py:127). The
// port runs B5 in every Mamba2 block of training on the card, so the
// gradient of that same function is a kernel too
// (kernels/ssd/ops.py::SSDScanFn.backward).
//
// Per (batch row b, head), scalar A, B/C shared across heads, the forward
// is B5's chunked scan (ssd_scan.cuh): in a chunk of L = 64 tokens with
// a_r = A·dt_r and Lc_t = Σ_{r≤t} a_r,
//
//   y_t   = exp(Lc_t)·(C_t h_cᵀ) + Σ_{s≤t} (C_t·B_s)·exp(Σ_{(s,t]} a)·dt_s·x_s
//   h_end = exp(Lc_end)·h_c + Σ_s exp(Σ_{(s,end]} a)·dt_s · x_s ⊗ B_s
//
// and the gradient runs the same chunks in reverse (the SSD backward as the
// Mamba2 authors' chunked kernels run it):
//
//   0. h_c, each chunk's starting state: B5's own phases 1–2, rerun by
//      ssd_scan_states_launch (ssd_scan.cu) into scratch;
//   1. mode kDstates, per (b, chunk, group of heads): D_c = (exp(Lc)∘dy)ᵀ·C,
//      the gradient on h_c of the chunk's own y_state term;
//   2. ssd_bwd_pass_kernel, per (b, head, 1024 state elements): the chunks
//      from the last, G ← dh_out, G_{c−1} = exp(Lc_end^c)·G_c + D_c, writing
//      G_c (the gradient at chunk c's end state) over D_c and the last G to
//      dh_in; sequential over chunks only;
//   3. mode kGrad, per (b, chunk, group of heads), from G_c and h_c: with
//      U_s = dx_s / dt_s,
//        U_s   = exp(Σ_{(s,end]} a)·(G_c B_s) + Σ_{t≥s} (C_t·B_s)·exp(Σ_{(s,t]} a)·dy_t
//        dB_s += dt_s·exp(Σ_{(s,end]} a)·(x_sᵀ G_c) + Σ_{t≥s} P_ts·C_t
//        dC_t += exp(Lc_t)·(dy_t h_c) + Σ_{s≤t} P_ts·B_s
//      with P_ts = (dy_t·x_s)·exp(Σ_{(s,t]} a)·dt_s, ddt_s = x_s·U_s + A·da_s,
//      dA = Σ dt·da; da_r is the sum over the pairs (s, t) with s < r ≤ t
//      of the forward's weighted terms — intra (s, t): P_ts·(C_t·B_s);
//      y_state (−1, t): dy_t·y_state_t; contribution (s, end): x_s·(dt_s·
//      exp(Σ_{(s,end]} a)·G_c B_s); decay (−1, end): exp(Lc_end)·<G_c, h_c>
//      — taken over that rectangle (column suffix sums over t, then row
//      sums over s < r, as chunk_scan_bwd_ddAcs_stable), never as the
//      difference of two cumsums, which at |Σ a| in the tens would spend
//      the f32 tolerance on cancellation.
//
// A call of one chunk (S ≤ 64: every verify window and the serving path's
// prefills) takes phases 1 and 3 in one launch, mode kGradFused: G =
// dh_out, h_c = h_in, and the block also forms D and dh_in =
// exp(Lc_end)·dh_out + D; no state recompute, no pass.
//
// Every exponential is of a sum of a over a range (≤ 0, as A < 0 and
// dt ≥ 0), never exp(−Lc_s) alone, so the gradient stays finite where the
// reference's overflows (Σ A·dt in a chunk above ~88).
//
// Every product — C·Bᵀ once per block for its group of heads, then per
// head dy·h_c, S̃ᵀ·dy (S̃ = C·Bᵀ ∘ exp(Σ a)), dy·xᵀ, Pᵀ·C, P·B, B·G_cᵀ,
// x·G_c, and D_c — runs on the tensor cores as mma.sync m16n8k8 TF32 with
// f32 accumulation, every operand that is not exact in TF32 (dy, G_c, h_c,
// the score and weight tiles, f32 inputs) split hi + lo as B5 does
// (ssd_mma.cuh); bf16 x, B, C are exact. A weight of an output's rows
// (exp(Lc_t), exp(Σ_{(s,end]} a)·dt_s) multiplies the product's rows after
// it, so those operands stay exact (two mma a step, not three). Warps own
// one 16-row tile and every cnt-th 8-column tile of a product, so an A
// fragment is loaded and split once per k-step for all its columns.
//
// Staging: B, C and each head's x, dy and the chunk's state tiles by
// 16-byte cp.async; where two buffers fit (B5's double buffer) the next
// head's x/dy/h_c and G_c load while one head computes, else each waits for
// the previous head's. One block of 16 warps per SM, at most 128 registers a
// thread.
//
// Sum order is fixed, with no float atomics: dB and dC sum over a block's
// heads in head order in registers, then across head groups (partials
// (B, S, groups, N)) in group order, and dA's per-(b, chunk, head)
// partials in a fixed order, by ssd_bwd_finish_kernel; so a result's bits
// do not depend on scheduling.
//
// Bound on this card: bytes at the serving shapes; at the training shapes
// the chunk states cost 4·hd·N bytes per (b, chunk, head) several times
// (written and rewritten by phase 0, D written by 1, read and rewritten by
// 2, G and h read by 3) beside the inputs' bytes, and the split products
// double or triple the tensor work.
//
// Invariants: Lc is a sequential cumsum in token order (one thread per
// head), as B5's; rows with dt = 0 give dx = 0·U = 0, add nothing to dB
// (their weights carry the factor dt_s) and nothing to dA.

#pragma once

#include "ssd_mma.cuh"

namespace repro_torch {

// one call's tensors (as the C entry ssd_scan_bwd_launch takes them)
struct BwdCall {
  const void *x, *Bm, *Cm, *dt, *A, *h_in, *dy, *dh_out;
  void *dx, *dB, *dC, *ddt, *dA, *dh_in;
  void *states, *gst, *decay, *dBp, *dCp, *dAp;
  int B, S, nh, hg;
};

namespace {

constexpr int kBwdWarps = 16;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdMaxHG = 8;          // heads per block
constexpr int kBwdPart = 320;         // rank × row partials (≤ 6 × 48)
constexpr int kBwdSmemBytes = 232448;  // a block's dynamic shared memory
constexpr int kBwdPassThreads = 256;
constexpr int kBwdPassAhead = 8;       // chunks in flight per pass thread
enum BwdMode { kDstates = 0, kGrad = 1, kGradFused = 2 };

struct BwdArgs {
  const void* x;     // (B, S, nh, HD) T
  const void* Bm;    // (B, S, N) T
  const void* Cm;    // (B, S, N) T
  const float* dt;   // (B, S, nh)
  const float* A;    // (nh,)
  const float* dy;   // (B, S, nh, HD)
  const float* hs;   // kGrad: h_c (B, nch, nh, HD, N); fused: h_in (B, nh, HD, N)
  const float* gs;   // kGrad: G_c (B, nch, nh, HD, N); fused: dh_out
  void* dx;          // (B, S, nh, HD) T
  float* ddt;        // (B, S, nh)
  float* dBp;        // (B, S, groups, N)
  float* dCp;        // (B, S, groups, N)
  float* dAp;        // (B, nch, nh)
  float* dst;        // kDstates: D_c (B, nch, nh, HD, N); fused: dh_in
  int S, nh, nch, hg, mode, nbuf;
};

// shared memory of one block, byte offsets: B, C rows (T), C·Bᵀ (hg > 1)
// and the per-head score tile X (f32), nbuf x (T) and dy (f32) tiles, the
// state tiles h (and G where two buffers fit, else G shares h's), the
// per-head dt / Lc / exp vectors, then the work vectors
template <typename T, int HD, int N>
struct BwdLayout {
  static constexpr int BSP = N + (sizeof(T) == 4 ? 4 : 8);   // B, C rows
  static constexpr int XSP = HD + (sizeof(T) == 4 ? 4 : 8);  // x rows
  static constexpr int DYP = HD + 4;                         // dy rows
  static constexpr int HP = N + 4;                           // state rows
  static constexpr int XP = kSsdChunk + 4;                   // L × L rows
  // every row a whole number of 16-byte cp.async copies, so every offset
  // below stays 16-byte aligned
  static_assert(BSP * sizeof(T) % 16 == 0 && XSP * sizeof(T) % 16 == 0 &&
                    DYP * 4 % 16 == 0 && HP * 4 % 16 == 0 && XP * 4 % 16 == 0,
                "row strides of 16-byte multiples");
  int Bs, Cs, CB, X, xs, dys, Hs, Gs, vec, work, total;
  __host__ __device__ BwdLayout(int Lp, int hg, int nbuf, int mode) {
    const bool grad = mode != kDstates;
    const int sT = static_cast<int>(sizeof(T));
    int o = 0;
    Bs = o;
    o += grad ? Lp * BSP * sT : 0;
    Cs = o;
    o += Lp * BSP * sT;
    CB = o;
    o += grad && hg > 1 ? Lp * XP * 4 : 0;
    X = o;
    o += grad ? Lp * XP * 4 : 0;
    xs = o;
    o += grad ? nbuf * Lp * XSP * sT : 0;
    dys = o;
    o += nbuf * Lp * DYP * 4;
    Hs = o;
    o += grad ? HD * HP * 4 : 0;
    Gs = grad && nbuf == 2 ? o : Hs;
    o += grad && nbuf == 2 ? HD * HP * 4 : 0;
    vec = o;
    o += 4 * hg * kSsdChunk * 4;
    work = o;
    o += (5 * kSsdChunk + 3 * kBwdPart + 32 + kBwdThreads) * 4;
    total = o;
  }
};

// rows [0, Lv) of a (rows, W) tile of E (row stride gs elements) → smem
// rows of stride sp in E by 16-byte cp.async; rows [Lv, Lp) zero-filled
template <typename E, int W>
__device__ __forceinline__ void rows_async(const E* g, long long gs, int Lv,
                                           int Lp, E* s, int sp, int tid) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(E));
  constexpr int PER_ROW = W / EPC;
  for (int i = tid; i < Lp * PER_ROW; i += kBwdThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * EPC;
    const bool in = r < Lv;
    cp_async16(s + r * sp + c, in ? g + r * gs + c : g, in ? 16 : 0);
  }
}

// a warp's share of an (MT × 16) × (NT × 8) product: row tile mi, column
// tiles nj0 + u·step for u < nu; rank = its index among the warps of row
// tile mi (the partial sums over a row are kept per rank)
struct Tiles {
  int mi, nj0, step, nu;
};
__device__ __forceinline__ Tiles tiles_of(int warp, int MT, int NT) {
  Tiles w;
  w.mi = warp % MT;
  w.nj0 = warp / MT;
  w.step = (kBwdWarps - w.mi + MT - 1) / MT;
  w.nu = w.nj0 < NT ? (NT - w.nj0 + w.step - 1) / w.step : 0;
  return w;
}
// the ranks holding partials of row tile mi
__device__ __forceinline__ int ranks_of(int mi, int MT, int NT) {
  return min((kBwdWarps - mi + MT - 1) / MT, NT);
}

// acc[u] += A(rows 16·mi.., k) · B(k, columns 8·(nj0 + u·step)..) over
// k ∈ [k0, k1) (multiples of 8) for u < nu; a_at(r, k) and b_at(k, n) give
// the operands' f32 values, SA / SB split them. Each split term runs across
// the tiles before the next, so an accumulator's dependent mma are NU
// issues apart.
template <bool SA, bool SB, int NU, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NU][4], const Tiles& w,
                                         int nu, int k0, int k1, FA a_at,
                                         FB b_at, int g, int q) {
  const int m0 = w.mi * 16;
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4];
    put<SA>(a_at(m0 + g, k + q), ah[0], al[0]);
    put<SA>(a_at(m0 + g + 8, k + q), ah[1], al[1]);
    put<SA>(a_at(m0 + g, k + q + 4), ah[2], al[2]);
    put<SA>(a_at(m0 + g + 8, k + q + 4), ah[3], al[3]);
    uint32_t bh[NU][2], bl[NU][2];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      if (u < nu) {
        const int n = (w.nj0 + u * w.step) * 8 + g;
        put<SB>(b_at(k + q, n), bh[u][0], bl[u][0]);
        put<SB>(b_at(k + q + 4, n), bh[u][1], bl[u][1]);
      }
    }
    if (SA) {
#pragma unroll
      for (int u = 0; u < NU; ++u)
        if (u < nu) mma_tf32(acc[u], al, bh[u]);
    }
    if (SB) {
#pragma unroll
      for (int u = 0; u < NU; ++u)
        if (u < nu) mma_tf32(acc[u], ah, bl[u]);
    }
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (u < nu) mma_tf32(acc[u], ah, bh[u]);
  }
}

template <int NU>
__device__ __forceinline__ void zero(float (&acc)[NU][4]) {
#pragma unroll
  for (int u = 0; u < NU; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
}

// the rows of a warp's tiles times a per-row weight w[row] (a weight of
// the output's rows stays out of the operand, which then stays exact)
template <int NU>
__device__ __forceinline__ void scale_rows(float (&acc)[NU][4],
                                           const Tiles& w, const float* wr,
                                           int g) {
  const float w0 = wr[w.mi * 16 + g], w1 = wr[w.mi * 16 + g + 8];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    acc[u][0] *= w0;
    acc[u][1] *= w0;
    acc[u][2] *= w1;
    acc[u][3] *= w1;
  }
}

// Σ over this warp's columns of f(row, col)·acc for its two rows g and g+8
// of the row tile, summed over the 4 lanes of a row, → part[rank·Lp + row]
template <int NU, typename F>
__device__ __forceinline__ void row_partials(const float (&acc)[NU][4],
                                             const Tiles& w, int Lp, F f,
                                             float* part, int g, int q) {
  if (w.nu == 0) return;
  const int r0 = w.mi * 16 + g;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    if (u < w.nu) {
      const int n = (w.nj0 + u * w.step) * 8 + 2 * q;
      s0 = fmaf(f(r0, n), acc[u][0], s0);
      s0 = fmaf(f(r0, n + 1), acc[u][1], s0);
      s1 = fmaf(f(r0 + 8, n), acc[u][2], s1);
      s1 = fmaf(f(r0 + 8, n + 1), acc[u][3], s1);
    }
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  if (q == 0) {
    part[w.nj0 * Lp + r0] = s0;
    part[w.nj0 * Lp + r0 + 8] = s1;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// D = (el∘dy)ᵀ·C over the chunk's rows (HD × N), handed to out(d, n, v)
template <typename T, int HD, int N, typename F>
__device__ __forceinline__ void dstate_product(const float* dyj,
                                               const float* elj, const T* Cs,
                                               int Lp, int warp, int g, int q,
                                               F out) {
  using Lay = BwdLayout<T, HD, N>;
  constexpr bool XS = !Elem<T>::exact;
  constexpr int MT = HD / 16, NT = N / 8;
  constexpr int NU = (NT * MT + kBwdWarps - 1) / kBwdWarps;
  const Tiles w = tiles_of(warp, MT, NT);
  float acc[NU][4];
  zero(acc);
  warp_mma<true, XS>(
      acc, w, w.nu, 0, Lp,
      [&](int d, int t) { return elj[t] * dyj[t * Lay::DYP + d]; },
      [&](int t, int n) { return to_f32(Cs[t * Lay::BSP + n]); }, g, q);
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    if (u < w.nu) {
      const int d = w.mi * 16 + g, n = (w.nj0 + u * w.step) * 8 + 2 * q;
      out(d, n, acc[u][0], acc[u][1]);
      out(d + 8, n, acc[u][2], acc[u][3]);
    }
  }
}

// Phases 1 and 3 (the modes above). Grid (B·nch, nh / hg): block (b, chunk
// c, heads h0..h0+hg); hg heads one after another over one C·Bᵀ.
template <typename T, int HD, int N>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_bwd_chunk_kernel(const BwdArgs p) {
  using Lay = BwdLayout<T, HD, N>;
  constexpr bool XS = !Elem<T>::exact;
  constexpr int BSP = Lay::BSP, XSP = Lay::XSP, DYP = Lay::DYP,
                HP = Lay::HP, XP = Lay::XP, L = kSsdChunk;
  constexpr int NUN = (N / 8 + 3) / 4;   // column tiles a warp holds: N
  constexpr int NUD = (HD / 8 + 3) / 4;  // HD
  constexpr int NUL = 2;                 // L

  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const int S = p.S, nh = p.nh, nch = p.nch, hg = p.hg, mode = p.mode,
            nbuf = p.nbuf;
  const bool grad = mode != kDstates, fused = mode == kGradFused;
  const int b = blockIdx.x / nch, c = blockIdx.x % nch;
  const int h0 = blockIdx.y * hg;
  const int t0 = c * L;
  const int Lv = min(L, S - t0);
  const int Lp = (Lv + 15) & ~15;
  const int MT = Lp / 16;
  const BwdLayout<T, HD, N> lay(Lp, hg, nbuf, mode);
  T* Bs = reinterpret_cast<T*>(sm + lay.Bs);
  T* Cs = reinterpret_cast<T*>(sm + lay.Cs);
  float* X = reinterpret_cast<float*>(sm + lay.X);
  float* CB = hg > 1 ? reinterpret_cast<float*>(sm + lay.CB) : X;
  T* xs = reinterpret_cast<T*>(sm + lay.xs);
  float* dys = reinterpret_cast<float*>(sm + lay.dys);
  float* Hs = reinterpret_cast<float*>(sm + lay.Hs);
  float* Gs = reinterpret_cast<float*>(sm + lay.Gs);
  float* dts = reinterpret_cast<float*>(sm + lay.vec);
  float* Lcs = dts + hg * L;
  float* ees = Lcs + hg * L;   // exp(Σ_{(s,end]} a)
  float* els = ees + hg * L;   // exp(Lc_t)
  float* da_in = reinterpret_cast<float*>(sm + lay.work);
  float* xU = da_in + L;       // x_r·U_r
  float* ctb = xU + L;         // contribution pairs (r, end)
  float* yst = ctb + L;        // y_state pairs (−1, r)
  float* dtda = yst + L;
  float* part_x = dtda + L;
  float* part_c = part_x + kBwdPart;
  float* part_y = part_c + kBwdPart;
  float* wsum = part_y + kBwdPart;   // 16 warp sums, then the decay term
  float* segs = wsum + 32;           // the column suffix sums' segments

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const long long row0 = static_cast<long long>(b) * S + t0;
  const T* x = static_cast<const T*>(p.x);
  const long long hdn = static_cast<long long>(HD) * N;
  auto state = [&](const float* base, int head) {
    return fused ? base + (static_cast<long long>(b) * nh + head) * hdn
                 : base + ((static_cast<long long>(b) * nch + c) * nh + head) *
                              hdn;
  };
  // one commit group per head for x, dy and (grad) h_c; one for G_c
  auto issue_x = [&](int j) {
    const int head = h0 + j, buf = j % nbuf;
    rows_async<float, HD>(p.dy + (row0 * nh + head) * HD,
                          static_cast<long long>(nh) * HD, Lv, Lp,
                          dys + buf * Lp * DYP, DYP, tid);
    if (grad) {
      rows_async<T, HD>(x + (row0 * nh + head) * HD,
                        static_cast<long long>(nh) * HD, Lv, Lp,
                        xs + buf * Lp * XSP, XSP, tid);
      rows_async<float, N>(state(p.hs, head), N, HD, HD, Hs, HP, tid);
    }
    cp_async_commit();
  };
  auto issue_g = [&](int j) {
    rows_async<float, N>(state(p.gs, h0 + j), N, HD, HD, Gs, HP, tid);
    cp_async_commit();
  };

  if (grad)
    rows_async<T, N>(static_cast<const T*>(p.Bm) + row0 * N, N, Lv, Lp, Bs,
                     BSP, tid);
  rows_async<T, N>(static_cast<const T*>(p.Cm) + row0 * N, N, Lv, Lp, Cs,
                   BSP, tid);
  issue_x(0);   // B and C ride in head 0's group
  if (grad && nbuf == 2)
    issue_g(0);
  else if (!grad && nbuf == 2 && hg > 1)
    issue_x(1);
  for (int i = tid; i < hg * L; i += kBwdThreads) {
    const int j = i / L, s = i % L;
    dts[i] = s < Lv ? p.dt[(row0 + s) * nh + h0 + j] : 0.f;
  }
  __syncthreads();
  if (tid < hg) {   // Lc: a sequential cumsum in token order per head
    const float a = p.A[h0 + tid];
    float run = 0.f;
    for (int s = 0; s < L; ++s) {
      if (s < Lv) run += a * dts[tid * L + s];
      Lcs[tid * L + s] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < hg * L; i += kBwdThreads) {
    const int s = i % L;
    ees[i] = s < Lv ? expf(Lcs[i - s + Lv - 1] - Lcs[i]) : 0.f;
    els[i] = s < Lv ? expf(Lcs[i]) : 0.f;
  }

  if (!grad) {
    // phase 1: D_c per head
    for (int j = 0; j < hg; ++j) {
      cp_async_wait(nbuf == 2 && j + 1 < hg ? 1 : 0);
      __syncthreads();
      float* o = p.dst + ((static_cast<long long>(b) * nch + c) * nh + h0 +
                          j) * hdn;
      dstate_product<T, HD, N>(
          dys + (j % nbuf) * Lp * DYP, els + j * L, Cs, Lp, warp, g, q,
          [&](int d, int n, float v0, float v1) {
            store2(o + d * N + n, v0, v1);
          });
      __syncthreads();
      if (j + nbuf < hg) issue_x(j + nbuf);
    }
    return;
  }

  const Tiles wN = tiles_of(warp, MT, N / 8);
  const Tiles wD = tiles_of(warp, MT, HD / 8);
  const Tiles wL = tiles_of(warp, MT, Lp / 8);
  // dxy tiles on or below the diagonal (the column tiles increase with u)
  int nuL = 0;
  for (int u = 0; u < wL.nu; ++u)
    if ((wL.nj0 + u * wL.step) * 8 <= wL.mi * 16 + 15) nuL = u + 1;

  // C·Bᵀ once for the group: (t, s) tiles on or below the diagonal
  cp_async_wait(nbuf == 2 ? 1 : 0);
  __syncthreads();
  {
    float acc[NUL][4];
    zero(acc);
    warp_mma<XS, XS>(
        acc, wL, nuL, 0, N,
        [&](int t, int n) { return to_f32(Cs[t * BSP + n]); },
        [&](int n, int s) { return to_f32(Bs[s * BSP + n]); }, g, q);
#pragma unroll
    for (int u = 0; u < NUL; ++u) {
      if (u < nuL) {
        float* o = CB + (wL.mi * 16 + g) * XP + (wL.nj0 + u * wL.step) * 8 +
                   2 * q;
        o[0] = acc[u][0];
        o[1] = acc[u][1];
        o[8 * XP] = acc[u][2];
        o[8 * XP + 1] = acc[u][3];
      }
    }
  }

  float dBa[NUN][4], dCa[NUN][4];
  zero(dBa);
  zero(dCa);
  for (int j = 0; j < hg; ++j) {
    const int head = h0 + j;
    const float* dtj = dts + j * L;
    const float* Lcj = Lcs + j * L;
    const float* eej = ees + j * L;
    const float* elj = els + j * L;
    const float* dyj = dys + (j % nbuf) * Lp * DYP;
    const T* xj = xs + (j % nbuf) * Lp * XSP;

    // A: the h_c terms — dC += el∘(dy·h_c), its y_state pairs, and the
    // decay pair's <h_c, G_c> (G_c read from device memory)
    if (j > 0) cp_async_wait(nbuf == 2 ? 1 : 0);
    __syncthreads();
    {
      float ys[NUN][4];
      zero(ys);
      warp_mma<true, true>(
          ys, wN, wN.nu, 0, HD,
          [&](int t, int d) { return dyj[t * DYP + d]; },
          [&](int d, int n) { return Hs[d * HP + n]; }, g, q);
      scale_rows(ys, wN, elj, g);
      row_partials(ys, wN, Lp,
                   [&](int t, int n) { return to_f32(Cs[t * BSP + n]); },
                   part_y, g, q);
#pragma unroll
      for (int u = 0; u < NUN; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dCa[u][e] += ys[u][e];
    }
    {
      const float* Gg = state(p.gs, head);
      float s = 0.f;
      for (int i = tid; i < HD * N / 4; i += kBwdThreads) {
        const int d = (i * 4) / N, n = (i * 4) % N;
        const float4 gv = __ldg(reinterpret_cast<const float4*>(Gg) + i);
        const float* hv = Hs + d * HP + n;
        s = fmaf(gv.x, hv[0], s);
        s = fmaf(gv.y, hv[1], s);
        s = fmaf(gv.z, hv[2], s);
        s = fmaf(gv.w, hv[3], s);
      }
      s = warp_sum(s);
      if (lane == 0) wsum[warp] = s;
    }
    // S̃ = C·Bᵀ ∘ exp(Σ_{(s,t]} a) on s ≤ t < Lv, else 0
    for (int i = tid; i < Lp * Lp; i += kBwdThreads) {
      const int t = i / Lp, s = i % Lp;
      X[t * XP + s] =
          s <= t && t < Lv ? CB[t * XP + s] * expf(Lcj[t] - Lcj[s]) : 0.f;
    }
    __syncthreads();
    if (nbuf == 2) {
      if (j + 1 < hg) issue_x(j + 1);
    } else {
      issue_g(j);
    }

    // B: U = S̃ᵀ·dy (the state term joins at E), dxy = dy·xᵀ
    float U[NUD][4], P[NUL][4];
    zero(U);
    zero(P);
    warp_mma<true, true>(
        U, wD, wD.nu, wD.mi * 16, Lp,
        [&](int s, int t) { return X[t * XP + s]; },
        [&](int t, int d) { return dyj[t * DYP + d]; }, g, q);
    warp_mma<true, XS>(
        P, wL, nuL, 0, HD,
        [&](int t, int d) { return dyj[t * DYP + d]; },
        [&](int d, int s) { return to_f32(xj[s * XSP + d]); }, g, q);
    __syncthreads();

    // C: the intra pairs. v = dxy·S̃·dt_s over X in place, P = dxy·
    // exp(Σ_{(s,t]} a)·dt_s kept in registers; the column suffix sums of v
    // over t, then per row r the sum over s < r: da's intra part
#pragma unroll
    for (int u = 0; u < NUL; ++u) {
      if (u < nuL) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = wL.mi * 16 + g + (e >> 1) * 8;
          const int s = (wL.nj0 + u * wL.step) * 8 + 2 * q + (e & 1);
          const bool ok = s <= t && t < Lv;
          float* xv = X + t * XP + s;
          const float v = P[u][e] * dtj[s];
          *xv = ok ? v * *xv : 0.f;
          P[u][e] = ok ? v * expf(Lcj[t] - Lcj[s]) : 0.f;
        }
      }
    }
    __syncthreads();
    {
      // column s's suffix sums over t > s in 8 segments of 8 rows, a
      // thread each: the segment's own sum, then its rows from the bottom
      // starting at the sum of the segments below (a fixed order)
      static_assert(kBwdThreads == 8 * L, "8 row segments per column");
      const int s = tid % L, t0s = (tid / L) * 8;
      const int t1 = min(t0s + 8, Lv);
      float part = 0.f;
      for (int t = t1 - 1; t >= t0s && t > s; --t) part += X[t * XP + s];
      segs[tid] = part;
      __syncthreads();
      float run = 0.f;
      for (int k = 7; k > tid / L; --k) run += segs[k * L + s];
      for (int t = t1 - 1; t >= t0s && t > s; --t) {
        run += X[t * XP + s];
        X[t * XP + s] = run;
      }
    }
    __syncthreads();
    for (int r = warp; r < Lv; r += kBwdWarps) {
      float v = 0.f;
      if (lane < r) v = X[r * XP + lane];
      if (lane + 32 < r) v += X[r * XP + lane + 32];
      v = warp_sum(v);
      if (lane == 0) da_in[r] = v;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < NUL; ++u) {
      if (u < nuL) {
        float* o = X + (wL.mi * 16 + g) * XP + (wL.nj0 + u * wL.step) * 8 +
                   2 * q;
        o[0] = P[u][0];
        o[1] = P[u][1];
        o[8 * XP] = P[u][2];
        o[8 * XP + 1] = P[u][3];
      }
    }
    __syncthreads();

    // D: dB += Pᵀ·C (t ≥ s), dC += P·B (s ≤ t)
    warp_mma<true, XS>(
        dBa, wN, wN.nu, wN.mi * 16, Lp,
        [&](int s, int t) { return X[t * XP + s]; },
        [&](int t, int n) { return to_f32(Cs[t * BSP + n]); }, g, q);
    warp_mma<true, XS>(
        dCa, wN, wN.nu, 0, min(Lp, wN.mi * 16 + 16),
        [&](int t, int s) { return X[t * XP + s]; },
        [&](int s, int n) { return to_f32(Bs[s * BSP + n]); }, g, q);

    // E: the G_c terms — U += ee∘(B·G_cᵀ) (its contribution pairs first),
    // dB += (dt∘ee)∘(x·G_c); dx = dt·U, and x·U for ddt
    cp_async_wait(nbuf == 2 && j + 1 < hg ? 1 : 0);
    __syncthreads();
    {
      float us[NUD][4];
      zero(us);
      warp_mma<XS, true>(
          us, wD, wD.nu, 0, N,
          [&](int s, int n) { return to_f32(Bs[s * BSP + n]); },
          [&](int n, int d) { return Gs[d * HP + n]; }, g, q);
      scale_rows(us, wD, eej, g);
      row_partials(us, wD, Lp,
                   [&](int s, int d) { return to_f32(xj[s * XSP + d]); },
                   part_c, g, q);
#pragma unroll
      for (int u = 0; u < NUD; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) U[u][e] += us[u][e];
    }
    {
      float xg[NUN][4];
      zero(xg);
      warp_mma<XS, true>(
          xg, wN, wN.nu, 0, HD,
          [&](int s, int d) { return to_f32(xj[s * XSP + d]); },
          [&](int d, int n) { return Gs[d * HP + n]; }, g, q);
      const int s0 = wN.mi * 16 + g;
      const float w0 = dtj[s0] * eej[s0], w1 = dtj[s0 + 8] * eej[s0 + 8];
#pragma unroll
      for (int u = 0; u < NUN; ++u) {
        dBa[u][0] = fmaf(w0, xg[u][0], dBa[u][0]);
        dBa[u][1] = fmaf(w0, xg[u][1], dBa[u][1]);
        dBa[u][2] = fmaf(w1, xg[u][2], dBa[u][2]);
        dBa[u][3] = fmaf(w1, xg[u][3], dBa[u][3]);
      }
    }
    row_partials(U, wD, Lp,
                 [&](int s, int d) { return to_f32(xj[s * XSP + d]); },
                 part_x, g, q);
    {
      T* dx = static_cast<T*>(p.dx);
#pragma unroll
      for (int u = 0; u < NUD; ++u) {
        if (u < wD.nu) {
          const int s = wD.mi * 16 + g, d = (wD.nj0 + u * wD.step) * 8 + 2 * q;
          if (s < Lv)
            store2(dx + ((row0 + s) * nh + head) * HD + d, dtj[s] * U[u][0],
                   dtj[s] * U[u][1]);
          if (s + 8 < Lv)
            store2(dx + ((row0 + s + 8) * nh + head) * HD + d,
                   dtj[s + 8] * U[u][2], dtj[s + 8] * U[u][3]);
        }
      }
    }
    if (fused) {   // one head (hg 1): D and dh_in from dy and dh_out
      const float dec = expf(Lcj[Lv - 1]);
      float* o = p.dst + (static_cast<long long>(b) * nh + head) * hdn;
      dstate_product<T, HD, N>(
          dyj, elj, Cs, Lp, warp, g, q, [&](int d, int n, float v0, float v1) {
            const float* gv = Gs + d * HP + n;
            store2(o + d * N + n, fmaf(dec, gv[0], v0), fmaf(dec, gv[1], v1));
          });
    }
    __syncthreads();
    if (nbuf == 2) {
      if (j + 1 < hg) issue_g(j + 1);
    } else if (j + 1 < hg) {
      issue_x(j + 1);
    }

    // F: da_r = intra + Σ_{s<r} contribution_s + Σ_{t≥r} y_state_t + decay;
    // ddt = x·U + A·da; dA's partial Σ dt·da
    if (tid < Lv) {
      const int r = tid, mi = r / 16;
      float sx = 0.f, sc = 0.f, sy = 0.f;
      for (int k = 0; k < ranks_of(mi, MT, HD / 8); ++k) {
        sx += part_x[k * Lp + r];
        sc += part_c[k * Lp + r];
      }
      for (int k = 0; k < ranks_of(mi, MT, N / 8); ++k)
        sy += part_y[k * Lp + r];
      xU[r] = sx;
      ctb[r] = dtj[r] * sc;
      yst[r] = sy;
    }
    if (warp == kBwdWarps - 1) {
      float s = lane < kBwdWarps ? wsum[lane] : 0.f;
      s = warp_sum(s);
      if (lane == 0) wsum[kBwdWarps] = expf(Lcj[Lv - 1]) * s;
    }
    __syncthreads();
    const float A = p.A[head];
    for (int r = warp; r < Lv; r += kBwdWarps) {
      float v = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = lane + 32 * h;
        if (s < Lv) v += s < r ? ctb[s] : yst[s];
      }
      v = warp_sum(v);
      if (lane == 0) {
        const float da = da_in[r] + v + wsum[kBwdWarps];
        p.ddt[(row0 + r) * nh + head] = fmaf(A, da, xU[r]);
        dtda[r] = dtj[r] * da;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float v = (lane < Lv ? dtda[lane] : 0.f) +
                (lane + 32 < Lv ? dtda[lane + 32] : 0.f);
      v = warp_sum(v);
      if (lane == 0)
        p.dAp[(static_cast<long long>(b) * nch + c) * nh + head] = v;
    }
  }

  // the group's dB, dC partials: (B, S, groups, N), group blockIdx.y
  const int groups = gridDim.y;
#pragma unroll
  for (int u = 0; u < NUN; ++u) {
    if (u < wN.nu) {
      const int s = wN.mi * 16 + g, n = (wN.nj0 + u * wN.step) * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (s + 8 * h < Lv) {
          const long long o =
              ((row0 + s + 8 * h) * groups + blockIdx.y) * N + n;
          store2(p.dBp + o, dBa[u][2 * h], dBa[u][2 * h + 1]);
          store2(p.dCp + o, dCa[u][2 * h], dCa[u][2 * h + 1]);
        }
      }
    }
  }
}

// Phase 2: per (b, head) and 4 state elements per thread, the chunks from
// the last: G ← dh_out; gs[c] (D_c) ← G_c = G, G ← fmaf(decay_c, G, D_c);
// dh_in ← the last G. The next kBwdPassAhead chunks' loads are issued
// before this batch's stores. Grid (B·nh, ceil(hdn / 1024)).
__global__ void __launch_bounds__(kBwdPassThreads)
    ssd_bwd_pass_kernel(float* __restrict__ gs,
                        const float* __restrict__ decay,
                        const float* __restrict__ dh_out,
                        float* __restrict__ dh_in, int nch, int nh, int hdn) {
  const int b = blockIdx.x / nh, head = blockIdx.x % nh;
  const int e = (blockIdx.y * kBwdPassThreads + threadIdx.x) * 4;
  if (e >= hdn) return;
  const long long hoff = (static_cast<long long>(b) * nh + head) * hdn + e;
  const long long base0 = static_cast<long long>(b) * nch * nh + head;
  auto load = [&](int c0, float4* v, float* dc) {   // chunks c0, c0 − 1, ...
#pragma unroll
    for (int u = 0; u < kBwdPassAhead; ++u) {
      if (c0 - u >= 0) {
        const long long base = base0 + static_cast<long long>(c0 - u) * nh;
        v[u] = *reinterpret_cast<const float4*>(gs + base * hdn + e);
        dc[u] = decay[base];
      }
    }
  };
  float4 G = *reinterpret_cast<const float4*>(dh_out + hoff);
  float4 cur[kBwdPassAhead];
  float cdc[kBwdPassAhead];
  load(nch - 1, cur, cdc);
  for (int c0 = nch - 1; c0 >= 0; c0 -= kBwdPassAhead) {
    float4 nxt[kBwdPassAhead];
    float ndc[kBwdPassAhead];
    if (c0 - kBwdPassAhead >= 0) load(c0 - kBwdPassAhead, nxt, ndc);
#pragma unroll
    for (int u = 0; u < kBwdPassAhead; ++u) {
      if (c0 - u >= 0) {
        const long long base = base0 + static_cast<long long>(c0 - u) * nh;
        *reinterpret_cast<float4*>(gs + base * hdn + e) = G;
        G.x = fmaf(cdc[u], G.x, cur[u].x);
        G.y = fmaf(cdc[u], G.y, cur[u].y);
        G.z = fmaf(cdc[u], G.z, cur[u].z);
        G.w = fmaf(cdc[u], G.w, cur[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdPassAhead; ++u) {
      cur[u] = nxt[u];
      cdc[u] = ndc[u];
    }
  }
  *reinterpret_cast<float4*>(dh_in + hoff) = G;
}

template <typename TO>
__device__ __forceinline__ TO from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The sums over the partials, in one launch: dB[e] = Σ_j dBp[e / N, j,
// e % N] and dC alike (j in group order, a thread per element, written in
// T), for e < BSN; then a warp per head, dA[h] = Σ_j dAp[j, h] over the
// J2 (b, chunk) partials, lane l taking j ≡ l (mod 32) in order and the
// warp's shuffle tree the rest. Fixed order either way. nDB = BSN rounded
// up to a whole number of warps.
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_bwd_finish_kernel(const float* __restrict__ dBp,
                          const float* __restrict__ dCp,
                          const float* __restrict__ dAp, T* __restrict__ dB,
                          T* __restrict__ dC, float* __restrict__ dA,
                          long long BSN, long long nDB, int groups, int N,
                          int J2, int nh) {
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  if (idx < nDB) {
    if (idx < BSN) {
      const long long o = idx / N;
      const int n = static_cast<int>(idx % N);
      const long long base = o * groups * N + n;
      float sb = 0.f, sc = 0.f;
      for (int j = 0; j < groups; ++j) {
        sb += dBp[base + static_cast<long long>(j) * N];
        sc += dCp[base + static_cast<long long>(j) * N];
      }
      dB[idx] = from_f32<T>(sb);
      dC[idx] = from_f32<T>(sc);
    }
    return;
  }
  const long long w = (idx - nDB) / 32;
  if (w >= nh) return;   // whole warps: nDB is a multiple of 32
  const int lane = static_cast<int>((idx - nDB) % 32);
  float s = 0.f;
  for (int j = lane; j < J2; j += 32)
    s += dAp[static_cast<long long>(j) * nh + w];
  s = warp_sum(s);
  if (lane == 0) dA[w] = s;
}

template <typename T>
int finish(const BwdCall& k, int N, int J2, cudaStream_t st) {
  const long long BSN = static_cast<long long>(k.B) * k.S * N;
  const long long nDB = (BSN + 31) / 32 * 32;
  const long long total = nDB + 32LL * k.nh;
  ssd_bwd_finish_kernel<T><<<static_cast<int>((total + 255) / 256), 256, 0,
                             st>>>(
      static_cast<const float*>(k.dBp), static_cast<const float*>(k.dCp),
      static_cast<const float*>(k.dAp), static_cast<T*>(k.dB),
      static_cast<T*>(k.dC), static_cast<float*>(k.dA), BSN, nDB,
      k.nh / k.hg, N, J2, k.nh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int N>
int bwd_smem(int Lp, int hg, int nbuf, int mode) {
  return BwdLayout<T, HD, N>(Lp, hg, nbuf, mode).total;
}

// the largest group of heads (hg, hg/2, ..., 1) whose block fits at one
// buffer: f32 at hd = N = 128 takes one head a block
template <typename T, int HD, int N>
int bwd_heads(int hg) {
  while (hg > 1 && bwd_smem<T, HD, N>(kSsdChunk, hg, 1, kGrad) >
                       kBwdSmemBytes)
    hg /= 2;
  return bwd_smem<T, HD, N>(kSsdChunk, hg, 1, kGrad) <= kBwdSmemBytes ? hg
                                                                      : 0;
}

template <typename T, int HD, int N>
int launch_bwd_chunks(dim3 grid, int Lp, BwdArgs a, cudaStream_t st) {
  // the attribute is set once per instantiation, on the first (eager)
  // call: never inside a CUDA-graph capture
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_chunk_kernel<T, HD, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  a.nbuf = bwd_smem<T, HD, N>(Lp, a.hg, 2, a.mode) <= kBwdSmemBytes ? 2 : 1;
  const int bytes = bwd_smem<T, HD, N>(Lp, a.hg, a.nbuf, a.mode);
  if (bytes > kBwdSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_chunk_kernel<T, HD, N><<<grid, kBwdThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int N>
int launch_bwd(const BwdCall& k, cudaStream_t st) {
  if (bwd_heads<T, HD, N>(k.hg) != k.hg)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = (k.S + kSsdChunk - 1) / kSsdChunk;
  const int hdn = HD * N;
  const dim3 pass_grid(k.B * k.nh, (hdn + 4 * kBwdPassThreads - 1) /
                                       (4 * kBwdPassThreads));
  if (nch == 0) {   // dh_in = dh_out, dA = 0
    ssd_bwd_pass_kernel<<<pass_grid, kBwdPassThreads, 0, st>>>(
        nullptr, nullptr, static_cast<const float*>(k.dh_out),
        static_cast<float*>(k.dh_in), 0, k.nh, hdn);
    const int e = static_cast<int>(cudaGetLastError());
    return e ? e : finish<T>(k, N, 0, st);
  }
  BwdArgs a;
  a.x = k.x;
  a.Bm = k.Bm;
  a.Cm = k.Cm;
  a.dt = static_cast<const float*>(k.dt);
  a.A = static_cast<const float*>(k.A);
  a.dy = static_cast<const float*>(k.dy);
  a.dx = k.dx;
  a.ddt = static_cast<float*>(k.ddt);
  a.dBp = static_cast<float*>(k.dBp);
  a.dCp = static_cast<float*>(k.dCp);
  a.dAp = static_cast<float*>(k.dAp);
  a.S = k.S;
  a.nh = k.nh;
  a.nch = nch;
  a.hg = k.hg;
  const dim3 grid(k.B * nch, k.nh / k.hg);
  int e;
  if (nch == 1) {
    a.hs = static_cast<const float*>(k.h_in);
    a.gs = static_cast<const float*>(k.dh_out);
    a.dst = static_cast<float*>(k.dh_in);
    a.mode = kGradFused;
    if ((e = launch_bwd_chunks<T, HD, N>(grid, (k.S + 15) & ~15, a, st)))
      return e;
  } else {
    float* gst = static_cast<float*>(k.gst);
    a.hs = static_cast<const float*>(k.states);
    a.gs = gst;
    a.dst = gst;
    a.mode = kDstates;
    if ((e = launch_bwd_chunks<T, HD, N>(grid, kSsdChunk, a, st))) return e;
    ssd_bwd_pass_kernel<<<pass_grid, kBwdPassThreads, 0, st>>>(
        gst, static_cast<const float*>(k.decay),
        static_cast<const float*>(k.dh_out), static_cast<float*>(k.dh_in),
        nch, k.nh, hdn);
    if ((e = static_cast<int>(cudaGetLastError()))) return e;
    a.mode = kGrad;
    if ((e = launch_bwd_chunks<T, HD, N>(grid, kSsdChunk, a, st))) return e;
  }
  return finish<T>(k, N, k.B * nch, st);
}

template <typename T, int HD>
int launch_bwd_n(int N, const BwdCall& k, cudaStream_t st) {
  switch (N) {
    case 16: return launch_bwd<T, HD, 16>(k, st);
    case 32: return launch_bwd<T, HD, 32>(k, st);
    case 64: return launch_bwd<T, HD, 64>(k, st);
    case 128: return launch_bwd<T, HD, 128>(k, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_bwd_hd(int hd, int N, const BwdCall& k, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_bwd_n<T, 16>(N, k, st);
    case 32: return launch_bwd_n<T, 32>(N, k, st);
    case 64: return launch_bwd_n<T, 64>(N, k, st);
    case 128: return launch_bwd_n<T, 128>(N, k, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int HD>
int bwd_heads_n(int N, int hg) {
  switch (N) {
    case 16: return bwd_heads<T, HD, 16>(hg);
    case 32: return bwd_heads<T, HD, 32>(hg);
    case 64: return bwd_heads<T, HD, 64>(hg);
    case 128: return bwd_heads<T, HD, 128>(hg);
  }
  return 0;
}

template <typename T>
int bwd_heads_hd(int hd, int N, int hg) {
  switch (hd) {
    case 16: return bwd_heads_n<T, 16>(N, hg);
    case 32: return bwd_heads_n<T, 32>(N, hg);
    case 64: return bwd_heads_n<T, 64>(N, hg);
    case 128: return bwd_heads_n<T, 128>(N, hg);
  }
  return 0;
}

}  // namespace

// the f32 instantiations, in ssd_scan_bwd_f32.cu
int ssd_scan_bwd_f32(int hd, int N, const BwdCall& k, cudaStream_t st);
int ssd_scan_bwd_heads_f32(int hd, int N, int hg);

}  // namespace repro_torch
