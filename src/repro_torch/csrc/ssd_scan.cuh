// B5 — the Mamba2 SSD chunked scan on Hopper (sm_90a): the kernels, shared
// by ssd_scan.cu (bf16 instantiations and the C entries) and
// ssd_scan_f32.cu (f32 instantiations), two sources so the 64 chunk
// kernels build in two parallel nvcc processes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd/ssd.py::_ssd_kernel (its
// call ssd_call, glued by repro/kernels/ssd/ops.py::ssd_chunked_kernel).
// Per (batch row b, head), scalar A per head, B/C shared across heads:
//
//   h_t = exp(A·dt_t)·h_{t-1} + dt_t · x_t ⊗ B_t        (h: hd × N, f32)
//   y_t = C_t · h_t
//
// computed as the SSD duality over chunks of L = 64 tokens (Lc = cumsum(A·dt)
// inside the chunk):
//
//   y      = exp(Lc)·(C h_startᵀ) + ((C Bᵀ) ∘ causal ∘ exp(Lc_t − Lc_s) ∘ dt_s) x
//   h_end  = exp(Lc_L)·h_start + Σ_s exp(Lc_L − Lc_s)·dt_s · x_s ⊗ B_s
//
// The Pallas kernel walked the chunks as the sequential last grid axis and
// carried h in VMEM. Blocks on this card run in no order and carry nothing,
// so the chunks run in parallel in three phases (the SSD algorithm as GPUs
// run it):
//
//   1. ssd_chunk_kernel, mode kState — per (b, chunk, group of heads): the
//      chunk's own state contribution Σ_s exp(Lc_L − Lc_s)·dt_s·x_s ⊗ B_s and
//      its decay exp(Lc_L), into scratch the wrapper allocates;
//   2. ssd_pass_kernel — per (b, head, 1024 state elements): the chunks in
//      index order, h ← decay·h + contribution, writing each chunk's starting
//      state over its contribution and the last h to h_out; sequential over
//      chunks only, parallel over every state element;
//   3. ssd_chunk_kernel, mode kOut — per (b, chunk, group of heads): y from
//      the chunk's starting state.
//
// A call of one chunk (S ≤ 64: every verify window and the serving path's
// prefills) is one launch, mode kFused: y from h_in and h_out = exp(Lc_L)·
// h_in + contribution, no scratch. The chunk is 64 tokens whatever chunk
// the caller names (chunking changes only the float order); boundaries sit
// at multiples of 64 of the token index alone.
//
// C·Bᵀ depends on (b, chunk) alone: a block computes it once for its group
// of heads and runs the heads one after another, the next head's x and
// state loading while one computes. The wrapper picks the group
// (heads_per_block): 8 heads at long S, where sharing C·Bᵀ pays; one head
// per block in a one-chunk call, where a block's chain of dependent steps,
// not C·Bᵀ, sets the time and more blocks put more loads in flight.
//
// Every product — C·Bᵀ, C·h_startᵀ, scores·x and the contribution
// (x∘w)ᵀ·B — runs on the tensor cores as mma.sync m16n8k8 TF32 with f32
// accumulation. Rounding an f32 operand (the scores, h, x∘w, or f32
// inputs) once to TF32 keeps 11 significant bits, ~5e-4 relative: that
// would break the plain version's tolerance (chip_smoke.py SSD_TOL, atol
// 5e-4, rtol 1e-3). So every operand that is not exact in TF32 is split,
// v = hi + lo with hi = tf32(v) and lo = tf32(v − hi) (22 bits, residual
// ≤ 2⁻²³·|v|), and a·b = a_hi·b_hi + a_hi·b_lo + a_lo·b_hi (the dropped
// lo·lo term is ≤ 2⁻²²·|ab|): f32 accuracy to a few ulps, within SSD_TOL
// at every shape of chip_smoke.py's SSD_CASES (its line reports the
// largest share of the tolerance used). A bf16 x, B or
// C is exact in TF32 and is not split, so a product with one split operand
// takes 2 mma and C·Bᵀ on bf16 1; f32 inputs take 3. (A hi/lo split in
// bf16 keeps 16 bits, ~1.5e-5 relative: too close to the f32 exactness of
// a served model's greedy tokens, so TF32.) The scores are split once when
// they are formed, the states once per warp column.
//
// B and C are widened to f32 in shared memory, rows padded so the fragment
// loads hit 32 distinct banks (a row stride ≡ 4 mod 8 floats where lanes
// walk rows, ≡ 8 mod 32 where they walk columns); x is staged in its own
// type by 16-byte cp.async (rows past the chunk zero-filled by the copy)
// and the states by cp.async, issued before the B/C/dt loads of the block
// and, with two buffers, a head ahead. The tiles follow the chunk's real
// length (rows rounded up to 16), so a verify window of 9 tokens holds
// 16-row tiles. Blocks have 8 warps where two fit an SM's shared memory
// (the phases of the two interleave), else 16; at most 128 registers.
//
// Bound on this card: bytes at the serving shapes (h read and written once,
// 4·hd·N bytes each per (b, head), is 8.4 of the 9.3 MB at zamba2's verify
// window); at long S the chunk states cost 4 passes of 4·hd·N bytes per
// (b, chunk, head) through device memory (written by phase 1, read and
// rewritten by phase 2, read by phase 3) beside the x/B/C/y bytes, and the
// split products double or triple the tensor work. What holds it back
// (PERF.md, from ablations): the chains of dependent shared-memory loads,
// splits and mma inside a block, at 8–16 warps per SM.
//
// Invariants: Lc is a sequential cumsum in token order (one thread per
// head), so a row with dt = 0 adds exactly 0 and leaves every earlier
// prefix's bits unchanged; its weight exp(·)·0 is 0, so it adds zero
// products to every sum; a chunk of only such rows has decay exp(0) = 1 and
// contribution 0, and phase 2 passes h as fmaf(1, h, 0) = h. So rows with
// dt = 0 are exact identities on h (the wrapper's and the model's padding
// relies on it), and a row's h_out does not depend on the group of heads or
// the batch it was computed with.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kL = 64;        // tokens per chunk
constexpr int kMaxHG = 8;     // heads per block
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;  // chunk states in flight per pass thread
enum Mode { kState = 0, kOut = 1, kFused = 2 };

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr bool exact = false;  // not exact in TF32: split
  static constexpr int vec = 4;         // elements per 16-byte load
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool exact = true;
  static constexpr int vec = 8;
};

// one 16-byte load widened to f32 (bf16 → f32 is a 16-bit shift, exact)
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = __uint_as_float(w[k] << 16);
    o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16-byte async copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` (0 or 1) of the latest groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// an operand value as TF32 registers: split into hi + lo, or as it is
template <bool SPLIT>
__device__ __forceinline__ void put(float v, uint32_t& hi, uint32_t& lo) {
  if (SPLIT) {
    hi = tf32_rna(v);
    lo = tf32_rna(v - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b with the split operands' lo terms (small terms first)
template <bool SA, bool SB>
__device__ __forceinline__ void mma3(float d[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  if (SA) mma_tf32(d, al, bh);
  if (SB) mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Fragments of m16n8k8 (g = lane / 4, q = lane % 4):
//   A 16×8 row-major: a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4)
//   B 8×8:            b0 (k q, n g), b1 (k q+4, n g)
//   D 16×8:           d0 (g, 2q), d1 (g, 2q+1), d2 (g+8, 2q), d3 (g+8, 2q+1)
// A from rows of a row-major tile (element (r, k) at s[r·sp + k])
template <bool SPLIT>
__device__ __forceinline__ void frag_a(const float* s, int sp, int g, int q,
                                       uint32_t h[4], uint32_t l[4]) {
  put<SPLIT>(s[g * sp + q], h[0], l[0]);
  put<SPLIT>(s[(g + 8) * sp + q], h[1], l[1]);
  put<SPLIT>(s[g * sp + q + 4], h[2], l[2]);
  put<SPLIT>(s[(g + 8) * sp + q + 4], h[3], l[3]);
}
// B with k along a tile's rows (element (k, n) at s[k·sp + n]), f32 or the
// staged input type
template <bool SPLIT, typename E>
__device__ __forceinline__ void frag_b_krows(const E* s, int sp, int g,
                                             int q, uint32_t h[2],
                                             uint32_t l[2]) {
  put<SPLIT>(to_f32(s[q * sp + g]), h[0], l[0]);
  put<SPLIT>(to_f32(s[(q + 4) * sp + g]), h[1], l[1]);
}
// B with n along a tile's rows (element (k, n) at s[n·sp + k])
template <bool SPLIT>
__device__ __forceinline__ void frag_b_nrows(const float* s, int sp, int g,
                                             int q, uint32_t h[2],
                                             uint32_t l[2]) {
  put<SPLIT>(s[g * sp + q], h[0], l[0]);
  put<SPLIT>(s[g * sp + q + 4], h[1], l[1]);
}

// rows [0, Lv) of a (rows, W) tile of T with row stride gs → f32 smem rows
// of stride sp; rows [Lv, Lp) zero
template <typename T, int W, int NT>
__device__ __forceinline__ void tile_to_smem(const T* g, long long gs, int Lv,
                                             int Lp, float* s, int sp,
                                             int tid) {
  constexpr int V = Elem<T>::vec;
  constexpr int PER_ROW = W / V;
  for (int i = tid; i < Lp * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    float v[V];
    if (r < Lv) {
      load16(g + r * gs + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
    }
    float* d = s + r * sp + c;
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  }
}

// the (HD, N) f32 state at g → smem rows of stride N + 4, by cp.async
template <int HD, int N, int NT>
__device__ __forceinline__ void state_to_smem_async(const float* g, float* s,
                                                    int tid) {
  constexpr int PER_ROW = N / 4;
  for (int i = tid; i < HD * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    cp_async16(s + r * (N + 4) + c, g + r * N + c);
  }
}

// elements of a staged x row: the fragment loads walk rows 4 apart by lane,
// so the row stride is ≡ 8 or 24 words mod 32 (conflict-free)
template <typename T, int HD>
__host__ __device__ constexpr int x_stride() {
  return sizeof(T) == 4 ? HD + 8 : (HD == 16 ? 48 : HD + 16);
}

// rows [0, Lv) of one head's x (row stride gs elements) → smem rows of
// x_stride in T, by cp.async; rows [Lv, Lp) zero-filled
template <typename T, int HD, int NT>
__device__ __forceinline__ void x_to_smem_async(const T* g, long long gs,
                                                int Lv, int Lp, T* s,
                                                int tid) {
  constexpr int XRP = x_stride<T, HD>();
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));
  constexpr int PER_ROW = HD / EPC;
  for (int i = tid; i < Lp * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * EPC;
    const bool in = r < Lv;
    cp_async16(s + r * XRP + c, in ? g + r * gs + c : g, in ? 16 : 0);
  }
}

// shared memory of one block, in floats: B, nbuf staged x tiles, the
// per-head dt / Lc / w vectors (every mode), then C, C·Bᵀ, the scores as
// TF32 hi and lo, and nbuf states (y modes)
template <typename T, int HD, int N>
__host__ __device__ constexpr int smem_floats(int Lp, int mode, int nbuf) {
  return Lp * (N + 8) +
         nbuf * Lp * x_stride<T, HD>() * static_cast<int>(sizeof(T)) / 4 +
         3 * kMaxHG * kL +
         (mode == kState ? 0
                         : Lp * (N + 4) + 3 * Lp * (Lp + 4) +
                               nbuf * HD * (N + 4));
}

// x (B, S, nh, HD), Bm/Cm (B, S, N) in T; dt (B, S, nh), A (nh,) f32.
//   kState: h_dst ← chunk contributions (B, nch, nh, HD, N), decay (B, nch,
//           nh); h_src, y unused
//   kOut:   y ← from h_src = chunk starting states (B, nch, nh, HD, N)
//   kFused: nch = 1; y and h_dst = h_out (B, nh, HD, N) from h_src = h_in
// The block's hg heads run one after another; nbuf 2: head j+1's x (and
// state) load while head j computes, 1: each head's load waits for the
// previous head. Grid (B·nch, nh / hg), kWarps warps of at most 128
// registers: 16 fill an SM's registers, 8 let two blocks share an SM where
// shared memory allows (their phases interleave).
template <typename T, int HD, int N, int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 16 / kWarps)
    ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const float* __restrict__ h_src, float* __restrict__ y,
                     float* __restrict__ h_dst, float* __restrict__ decay,
                     int S, int nh, int nch, int hg, int mode, int nbuf) {
  constexpr bool XS = !Elem<T>::exact;  // x/B/C operands split
  constexpr int BP = N + 8;   // B: k-rows operand of the contribution
  constexpr int CP = N + 4;   // C: A operand (C·Bᵀ, C·hᵀ)
  constexpr int XRP = x_stride<T, HD>();  // staged x rows, in T
  constexpr int HP = N + 4;   // state rows d: n-rows operand (C·hᵀ)
  constexpr int kThreads = 32 * kWarps;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int b = blockIdx.x / nch, c = blockIdx.x % nch;
  const int h0 = blockIdx.y * hg;
  const int t0 = c * kL;
  const int Lv = min(kL, S - t0);
  const int Lp = (Lv + 15) & ~15;
  const int SP = Lp + 4;      // C·Bᵀ and scores rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool want_y = mode != kState, want_c = mode != kOut;

  const int x_stage = Lp * XRP;                        // in T
  float* Bs = smem;
  T* Xr = reinterpret_cast<T*>(Bs + Lp * BP);
  float* dts =
      Bs + Lp * BP + nbuf * x_stage * static_cast<int>(sizeof(T)) / 4;
  float* Lcs = dts + kMaxHG * kL;  // kMaxHG × kL each
  float* ws = Lcs + kMaxHG * kL;   // exp(Lc_L − Lc_s)·dt_s
  float* Cs = ws + kMaxHG * kL;
  float* CB = Cs + Lp * CP;
  float* Sh = CB + Lp * SP;  // scores, TF32 hi
  float* Sl = Sh + Lp * SP;  // scores, TF32 lo
  float* Hs = Sl + Lp * SP;  // nbuf × HD × HP

  const long long row0 = static_cast<long long>(b) * S + t0;
  // one commit group per head: its x rows and (y modes) its state
  auto issue = [&](int j) {
    const int head = h0 + j, buf = j % nbuf;
    x_to_smem_async<T, HD, kThreads>(x + (row0 * nh + head) * HD,
                                     static_cast<long long>(nh) * HD, Lv, Lp,
                                     Xr + buf * x_stage, tid);
    if (want_y)
      state_to_smem_async<HD, N, kThreads>(
          mode == kFused
              ? h_src + (static_cast<long long>(b) * nh + head) * HD * N
              : h_src + ((static_cast<long long>(b) * nch + c) * nh + head) *
                            HD * N,
          Hs + buf * HD * HP, tid);
    cp_async_commit();
  };
  issue(0);
  if (nbuf == 2 && hg > 1) issue(1);

  tile_to_smem<T, N, kThreads>(Bm + row0 * N, N, Lv, Lp, Bs, BP, tid);
  if (want_y)
    tile_to_smem<T, N, kThreads>(Cm + row0 * N, N, Lv, Lp, Cs, CP, tid);
  for (int i = tid; i < hg * kL; i += kThreads) {
    const int s = i / hg, j = i % hg;
    dts[j * kL + s] = s < Lv ? dt[(row0 + s) * nh + h0 + j] : 0.f;
  }
  __syncthreads();

  // Lc: a sequential cumsum in token order per head
  if (tid < hg) {
    const float a = A[h0 + tid];
    float* lc = Lcs + tid * kL;
    const float* d = dts + tid * kL;
    float run = 0.f;
    for (int s = 0; s < Lv; ++s) {
      run += a * d[s];
      lc[s] = run;
    }
    for (int s = Lv; s < kL; ++s) lc[s] = run;
  }
  __syncthreads();
  for (int i = tid; i < hg * kL; i += kThreads) {
    const int s = i % kL;
    ws[i] = s < Lv ? expf(Lcs[i - s + Lv - 1] - Lcs[i]) * dts[i] : 0.f;
  }

  // C·Bᵀ once for the group: (t, s) tiles on or below the diagonal
  if (want_y) {
    const int MT = Lp / 16, NT = Lp / 8;
    for (int tile = warp; tile < MT * NT; tile += kWarps) {
      const int mi = tile / NT, nj = tile % NT;
      if (nj * 8 > mi * 16 + 15) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k0 = 0; k0 < N; k0 += 8) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        frag_a<XS>(Cs + mi * 16 * CP + k0, CP, g, q, ah, al);
        frag_b_nrows<XS>(Bs + nj * 8 * BP + k0, BP, g, q, bh, bl);
        mma3<XS, XS>(acc, ah, al, bh, bl);
      }
      float* o = CB + mi * 16 * SP + nj * 8 + 2 * q;
      o[g * SP] = acc[0];
      o[g * SP + 1] = acc[1];
      o[(g + 8) * SP] = acc[2];
      o[(g + 8) * SP + 1] = acc[3];
    }
  }
  __syncthreads();

  for (int j = 0; j < hg; ++j) {
    const int head = h0 + j;
    const float* Lc = Lcs + j * kL;
    const float* w = ws + j * kL;
    const float* dtj = dts + j * kL;
    const T* Xj = Xr + (j % nbuf) * x_stage;
    const float* Hj = Hs + (j % nbuf) * HD * HP;
    if (nbuf == 1 && j > 0) issue(j);
    if (want_y) {
      // scores[t][s] = (C_t·B_s)·exp(Lc_t − Lc_s)·dt_s for s ≤ t < Lv,
      // split once here for every warp's fragments, while the head's loads
      // are in flight; a warp per row, a lane per column
      for (int t = warp; t < Lp; t += kWarps) {
        for (int s = lane; s < Lp; s += 32) {
          const float v = (s <= t && t < Lv)
                              ? CB[t * SP + s] * expf(Lc[t] - Lc[s]) * dtj[s]
                              : 0.f;
          uint32_t hi, lo;
          put<true>(v, hi, lo);
          Sh[t * SP + s] = __uint_as_float(hi);
          Sl[t * SP + s] = __uint_as_float(lo);
        }
      }
    }
    cp_async_wait(nbuf == 2 && j + 1 < hg ? 1 : 0);
    __syncthreads();
    const float dec = expf(Lc[Lv - 1]);

    if (want_c) {
      // contribution[d][n] = Σ_s (x[s][d]·w[s])·B[s][n]: warp → one 16-row
      // tile of d and every (kWarps / MT)-th 8-column tile of n
      constexpr int MT = HD / 16, NT = N / 8;
      constexpr int WPM = kWarps / MT;
      constexpr int NPW = (NT + WPM - 1) / WPM;
      const int mi = warp % MT;
      float acc[NPW][4];
#pragma unroll
      for (int u = 0; u < NPW; ++u)
        acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
      const int nk = (Lv + 7) / 8;
      for (int k0 = 0; k0 < nk * 8; k0 += 8) {
        uint32_t ah[4], al[4];
        const T* xa = Xj + k0 * XRP + mi * 16;
        const float w0 = w[k0 + q], w4 = w[k0 + q + 4];
        put<true>(to_f32(xa[q * XRP + g]) * w0, ah[0], al[0]);
        put<true>(to_f32(xa[q * XRP + g + 8]) * w0, ah[1], al[1]);
        put<true>(to_f32(xa[(q + 4) * XRP + g]) * w4, ah[2], al[2]);
        put<true>(to_f32(xa[(q + 4) * XRP + g + 8]) * w4, ah[3], al[3]);
        // every tile's fragments, then each split term across the tiles:
        // the dependent mma of one tile are NPW issues apart
        uint32_t bh[NPW][2], bl[NPW][2];
#pragma unroll
        for (int u = 0; u < NPW; ++u) {
          const int nj = warp / MT + u * WPM;
          if (nj < NT)
            frag_b_krows<XS>(Bs + k0 * BP + nj * 8, BP, g, q, bh[u], bl[u]);
        }
#pragma unroll
        for (int u = 0; u < NPW; ++u)
          if (warp / MT + u * WPM < NT) mma_tf32(acc[u], al, bh[u]);
        if (XS) {
#pragma unroll
          for (int u = 0; u < NPW; ++u)
            if (warp / MT + u * WPM < NT) mma_tf32(acc[u], ah, bl[u]);
        }
#pragma unroll
        for (int u = 0; u < NPW; ++u)
          if (warp / MT + u * WPM < NT) mma_tf32(acc[u], ah, bh[u]);
      }
      // kState: the contribution; kFused: h_out = exp(Lc_L)·h_in + it (one
      // fmaf, as phase 2)
      float* o = h_dst +
                 (mode == kState
                      ? ((static_cast<long long>(b) * nch + c) * nh + head)
                      : (static_cast<long long>(b) * nh + head)) * HD * N;
#pragma unroll
      for (int u = 0; u < NPW; ++u) {
        const int nj = warp / MT + u * WPM;
        if (nj < NT) {
          const int d = mi * 16 + g, n = nj * 8 + 2 * q;
          float2 lo = make_float2(acc[u][0], acc[u][1]);
          float2 hi = make_float2(acc[u][2], acc[u][3]);
          if (mode == kFused) {
            const float* hv = Hj + d * HP + n;
            lo = make_float2(fmaf(dec, hv[0], lo.x), fmaf(dec, hv[1], lo.y));
            hi = make_float2(fmaf(dec, hv[8 * HP], hi.x),
                             fmaf(dec, hv[8 * HP + 1], hi.y));
          }
          *reinterpret_cast<float2*>(o + d * N + n) = lo;
          *reinterpret_cast<float2*>(o + (d + 8) * N + n) = hi;
        }
      }
      if (mode == kState && warp == 0 && lane == 0)
        decay[(static_cast<long long>(b) * nch + c) * nh + head] = dec;
    }

    if (want_y) {
      // y: warps form a (row group × 8-column tile) grid; warp w owns the
      // column tiles w % NTW + u·NTW and the row tiles w / NTW + k·MG, so
      // each state fragment is split once per row group
      constexpr int NTY = HD / 8;
      constexpr int NTW = NTY < kWarps ? NTY : kWarps;
      constexpr int NU = NTY / NTW;
      constexpr int MG = kWarps / NTW;
      constexpr int MW = (4 + MG - 1) / MG;   // row tiles per warp, at most
      const int MTy = Lp / 16;
      const int wn = warp % NTW, wm = warp / NTW;
      if (wm < MTy) {
        float acc[MW][NU][4];
#pragma unroll
        for (int m = 0; m < MW; ++m)
#pragma unroll
          for (int u = 0; u < NU; ++u)
            acc[m][u][0] = acc[m][u][1] = acc[m][u][2] = acc[m][u][3] = 0.f;
        // C·h_startᵀ over the state dimension
        for (int k0 = 0; k0 < N; k0 += 8) {
          uint32_t bh[NU][2], bl[NU][2];
#pragma unroll
          for (int u = 0; u < NU; ++u)
            frag_b_nrows<true>(Hj + (wn + u * NTW) * 8 * HP + k0, HP, g, q,
                               bh[u], bl[u]);
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            const int mt = wm + m * MG;
            if (mt < MTy) {
              uint32_t ah[4], al[4];
              frag_a<XS>(Cs + mt * 16 * CP + k0, CP, g, q, ah, al);
#pragma unroll
              for (int u = 0; u < NU; ++u) mma_tf32(acc[m][u], ah, bl[u]);
              if (XS) {
#pragma unroll
                for (int u = 0; u < NU; ++u) mma_tf32(acc[m][u], al, bh[u]);
              }
#pragma unroll
              for (int u = 0; u < NU; ++u) mma_tf32(acc[m][u], ah, bh[u]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < MW; ++m) {
          const int mt = wm + m * MG;
          if (mt < MTy) {
            const float e0 = expf(Lc[mt * 16 + g]);
            const float e1 = expf(Lc[mt * 16 + g + 8]);
#pragma unroll
            for (int u = 0; u < NU; ++u) {
              acc[m][u][0] *= e0;
              acc[m][u][1] *= e0;
              acc[m][u][2] *= e1;
              acc[m][u][3] *= e1;
            }
          }
        }
        // + scores·x, row tile mt over s < min(Lv, 16·mt + 16) (causal)
        const int kend = (Lv + 7) & ~7;
        for (int k0 = 0; k0 < kend; k0 += 8) {
          uint32_t bh[NU][2], bl[NU][2];
#pragma unroll
          for (int u = 0; u < NU; ++u)
            frag_b_krows<XS>(Xj + k0 * XRP + (wn + u * NTW) * 8, XRP, g, q,
                             bh[u], bl[u]);
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            const int mt = wm + m * MG;
            if (mt < MTy && k0 < mt * 16 + 16) {
              uint32_t ah[4], al[4], unused[4];
              frag_a<false>(Sh + mt * 16 * SP + k0, SP, g, q, ah, unused);
              frag_a<false>(Sl + mt * 16 * SP + k0, SP, g, q, al, unused);
#pragma unroll
              for (int u = 0; u < NU; ++u) mma_tf32(acc[m][u], al, bh[u]);
              if (XS) {
#pragma unroll
                for (int u = 0; u < NU; ++u) mma_tf32(acc[m][u], ah, bl[u]);
              }
#pragma unroll
              for (int u = 0; u < NU; ++u) mma_tf32(acc[m][u], ah, bh[u]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < MW; ++m) {
          const int mt = wm + m * MG;
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            const int d = (wn + u * NTW) * 8 + 2 * q;
            const int t = mt * 16 + g;
            if (mt < MTy) {
              if (t < Lv)
                *reinterpret_cast<float2*>(
                    y + ((row0 + t) * nh + head) * HD + d) =
                    make_float2(acc[m][u][0], acc[m][u][1]);
              if (t + 8 < Lv)
                *reinterpret_cast<float2*>(
                    y + ((row0 + t + 8) * nh + head) * HD + d) =
                    make_float2(acc[m][u][2], acc[m][u][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the buffers of head j and the scores are free
    if (nbuf == 2 && j + 2 < hg) issue(j + 2);
  }
}

// Phase 2: per (b, head) and 4 state elements per thread, the chunks in
// index order: states[c] (the contribution) ← h at the start of chunk c,
// h ← fmaf(decay_c, h, contribution_c); h_out ← the last h. The next
// kPassAhead chunks' loads are issued before this batch's stores. nch = 0
// copies h_in to h_out. Grid (B·nh, ceil(hdn / 1024)).
__global__ void __launch_bounds__(kPassThreads)
    ssd_pass_kernel(float* __restrict__ states,
                    const float* __restrict__ decay,
                    const float* __restrict__ h_in,
                    float* __restrict__ h_out, int nch, int nh, int hdn) {
  const int b = blockIdx.x / nh, head = blockIdx.x % nh;
  const int e = (blockIdx.y * kPassThreads + threadIdx.x) * 4;
  if (e >= hdn) return;
  const long long hoff = (static_cast<long long>(b) * nh + head) * hdn + e;
  const long long base0 = static_cast<long long>(b) * nch * nh + head;
  auto load = [&](int c0, float4* v, float* dc) {
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      if (c0 + u < nch) {
        const long long base = base0 + static_cast<long long>(c0 + u) * nh;
        v[u] = *reinterpret_cast<const float4*>(states + base * hdn + e);
        dc[u] = decay[base];
      }
    }
  };
  float4 h = *reinterpret_cast<const float4*>(h_in + hoff);
  float4 cur[kPassAhead];
  float cdc[kPassAhead];
  load(0, cur, cdc);
  for (int c0 = 0; c0 < nch; c0 += kPassAhead) {
    float4 nxt[kPassAhead];
    float ndc[kPassAhead];
    if (c0 + kPassAhead < nch) load(c0 + kPassAhead, nxt, ndc);
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      if (c0 + u < nch) {
        const long long base = base0 + static_cast<long long>(c0 + u) * nh;
        *reinterpret_cast<float4*>(states + base * hdn + e) = h;
        h.x = fmaf(cdc[u], h.x, cur[u].x);
        h.y = fmaf(cdc[u], h.y, cur[u].y);
        h.z = fmaf(cdc[u], h.z, cur[u].z);
        h.w = fmaf(cdc[u], h.w, cur[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      cur[u] = nxt[u];
      cdc[u] = ndc[u];
    }
  }
  *reinterpret_cast<float4*>(h_out + hoff) = h;
}

constexpr int kMaxSmemBytes = 232448;  // a block's dynamic shared memory

template <typename T, int HD, int N>
int smem_bytes(int Lp, int mode, int nbuf) {
  return smem_floats<T, HD, N>(Lp, mode, nbuf) *
         static_cast<int>(sizeof(float));
}

// two x / state buffers where they fit, else one
template <typename T, int HD, int N>
int buffers(int Lp, int mode) {
  return smem_bytes<T, HD, N>(Lp, mode, 2) <= kMaxSmemBytes ? 2 : 1;
}

// one launch of the chunk kernel: 8 warps where two blocks fit an SM's
// shared memory, else 16
template <typename T, int HD, int N>
int launch_chunks(dim3 grid, int Lp, int mode, const T* x, const T* Bm,
                  const T* Cm, const float* dt, const float* A,
                  const float* h_src, float* y, float* h_dst, float* decay,
                  int S, int nh, int nch, int hg, cudaStream_t stream) {
  // the attribute is set once per instantiation, on the first (eager)
  // call: never inside a CUDA-graph capture
  static bool attr_set = false;
  if (!attr_set) {
    const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t e = cudaFuncSetAttribute(ssd_chunk_kernel<T, HD, N, 8>, a,
                                         kMaxSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_kernel<T, HD, N, 16>, a,
                               kMaxSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int nb = buffers<T, HD, N>(Lp, mode);
  const int bytes = smem_bytes<T, HD, N>(Lp, mode, nb);
  // (hd 128 holds twice the accumulators: 16 warps keep them in registers)
  if (HD <= 64 && 2 * bytes <= kMaxSmemBytes)
    ssd_chunk_kernel<T, HD, N, 8><<<grid, 256, bytes, stream>>>(
        x, Bm, Cm, dt, A, h_src, y, h_dst, decay, S, nh, nch, hg, mode, nb);
  else
    ssd_chunk_kernel<T, HD, N, 16><<<grid, 512, bytes, stream>>>(
        x, Bm, Cm, dt, A, h_src, y, h_dst, decay, S, nh, nch, hg, mode, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int N>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt,
           const void* A, const void* h_in, void* y, void* h_out,
           void* states, void* decay, int B, int S, int nh, int hg,
           cudaStream_t stream) {
  static_assert(smem_floats<T, HD, N>(kL, kOut, 1) * 4 <= kMaxSmemBytes,
                "B5 tile exceeds shared memory");
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const int nch = (S + kL - 1) / kL;
  if (nch == 1)
    return launch_chunks<T, HD, N>(
        dim3(B, nh / hg), (S + 15) & ~15, kFused, xt, bt, ct, dtf, af,
        static_cast<const float*>(h_in), static_cast<float*>(y),
        static_cast<float*>(h_out), nullptr, S, nh, 1, hg, stream);
  float* st = static_cast<float*>(states);
  float* dc = static_cast<float*>(decay);
  if (nch > 1) {
    const int e = launch_chunks<T, HD, N>(
        dim3(B * nch, nh / hg), kL, kState, xt, bt, ct, dtf, af, nullptr,
        nullptr, st, dc, S, nh, nch, hg, stream);
    if (e != 0) return e;
  }
  ssd_pass_kernel<<<dim3(B * nh, (HD * N + 4 * kPassThreads - 1) /
                                     (4 * kPassThreads)),
                    kPassThreads, 0, stream>>>(
      st, dc, static_cast<const float*>(h_in), static_cast<float*>(h_out),
      nch, nh, HD * N);
  const cudaError_t e = cudaGetLastError();
  if (nch == 0 || e != cudaSuccess) return static_cast<int>(e);
  return launch_chunks<T, HD, N>(dim3(B * nch, nh / hg), kL, kOut, xt, bt, ct,
                                 dtf, af, st, static_cast<float*>(y), nullptr,
                                 nullptr, S, nh, nch, hg, stream);
}

template <typename T, int HD>
int launch_n(int N, const void* x, const void* Bm, const void* Cm,
             const void* dt, const void* A, const void* h_in, void* y,
             void* h_out, void* states, void* decay, int B, int S, int nh,
             int hg, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, HD, 16>(x, Bm, Cm, dt, A, h_in, y, h_out, states,
                               decay, B, S, nh, hg, stream);
    case 32:
      return launch<T, HD, 32>(x, Bm, Cm, dt, A, h_in, y, h_out, states,
                               decay, B, S, nh, hg, stream);
    case 64:
      return launch<T, HD, 64>(x, Bm, Cm, dt, A, h_in, y, h_out, states,
                               decay, B, S, nh, hg, stream);
    case 128:
      return launch<T, HD, 128>(x, Bm, Cm, dt, A, h_in, y, h_out, states,
                                decay, B, S, nh, hg, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_hd(int hd, int N, const void* x, const void* Bm, const void* Cm,
              const void* dt, const void* A, const void* h_in, void* y,
              void* h_out, void* states, void* decay, int B, int S, int nh,
              int hg, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_n<T, 16>(N, x, Bm, Cm, dt, A, h_in, y, h_out, states,
                             decay, B, S, nh, hg, stream);
    case 32:
      return launch_n<T, 32>(N, x, Bm, Cm, dt, A, h_in, y, h_out, states,
                             decay, B, S, nh, hg, stream);
    case 64:
      return launch_n<T, 64>(N, x, Bm, Cm, dt, A, h_in, y, h_out, states,
                             decay, B, S, nh, hg, stream);
    case 128:
      return launch_n<T, 128>(N, x, Bm, Cm, dt, A, h_in, y, h_out, states,
                              decay, B, S, nh, hg, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// the f32 instantiations, in ssd_scan_f32.cu
int ssd_scan_f32(int hd, int N, const void* x, const void* Bm, const void* Cm,
                 const void* dt, const void* A, const void* h_in, void* y,
                 void* h_out, void* states, void* decay, int B, int S, int nh,
                 int hg, cudaStream_t stream);

}  // namespace repro_torch
