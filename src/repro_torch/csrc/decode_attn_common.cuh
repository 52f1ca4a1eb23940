// Shared body of the two decode-attention kernels (decode_attn.cu,
// paged_decode_attn.cu): GQA flash-decoding of a T-token query window over
// a KV cache, masked by per-entry absolute positions, written for Hopper.
//
// What bounds it: the K/V bytes. A window of T·G ≤ 64 query rows does at
// most 64 flops per K/V byte, far below the card's ridge (≈ 295), so the
// design aims at keeping enough K/V bytes in flight on every SM:
//
// - Split S across blocks (flash-decoding). A split is a fixed number of
//   keys chosen by the wrapper per cache layout (hd, dtype, kv heads; a
//   multiple of the pool's block size for the paged kernel), so split
//   boundaries depend on the key index alone. Grid: (split × row block, kv-head, batch row).
//   With one split the block normalises and writes the output itself; with
//   more, each block writes f32 partials (m, l, acc) to a scratch buffer
//   the wrapper allocates, and `combine_kernel` merges them in split order
//   (no atomics: the result is deterministic).
// - Rows: all G query heads × T tokens of a kv group share the block's K/V
//   tiles (the GQA saving); a block holds up to 64 rows (four 16-row
//   tiles), so K/V is read once per 64 rows, and the row blocks of one
//   split are adjacent in the grid (the later ones find K/V in L2).
// - Loads: 16-byte `cp.async.cg` copies of K/V tiles into a shared-memory
//   ring (bf16 queries: 64-key stages, 2 deep, 4 for a one-tile block;
//   f32: 32-key stages, 3 deep), so later stages are in flight while one
//   is computed. Rows are
//   padded by 16 bytes so `ldmatrix` and 16-byte reads are free of bank
//   conflicts. The first stages are issued as soon as the keys' rows are
//   known, before their positions are read, so the prologue overlaps them.
// - bf16 queries: QKᵀ and P·V on the tensor cores (`mma.sync` m16n8k16
//   bf16 → f32), FlashAttention-2 style: two warps per 16-row tile, each a
//   fixed half (32 keys) of every stage over the whole head dim. Scores stay
//   in registers and become P's A fragments; the online softmax runs inside
//   the warp (quad shuffles), so a stage needs no exchange between warps;
//   the two key groups merge once per split in a fixed order. A block runs
//   at least four warps (a draft step has 8 rows: 2 compute, 2 only load),
//   and two blocks share an SM. Scale, mask and softmax stay in f32
//   (scores in log2 units, one exp2 each); P is rounded to bf16 for P·V,
//   as the reference model's `_attend_cached` rounds its softmax weights.
// - f32 queries stay in full f32 on the CUDA cores (no TF32): one warp per
//   16-row tile, one lane per key for the scores, one lane per head-dim
//   column for P·V, the same split, ring and loads.
// - int8 K/V (paged only): the int8 rows are copied as they are; bf16
//   queries convert them to bf16 in shared memory (±127 is exact) before
//   the mma. The K scale multiplies the score after the dot product and the
//   V scale folds into P before P·V: the dequantization reordered.
// - Dead tiles are skipped exactly. The block reads every key's position
//   (and, paged, each logical block's table entry once) and sets one bit
//   per tile with a key that some row may see (a warp ballot); a tile after
//   the early ones none of whose keys can be valid for any of its rows
//   (position −1, beyond the rows' largest q_pos, or before every row's
//   window) is never loaded. Such keys add exactly zero (alpha = 1, p = 0)
//   wherever they are computed, so skipping changes no bit.
//
// A row's arithmetic depends only on its own q, q_pos and the keys, in an
// order fixed by the key index: the output of a row is bit-identical
// whatever the batch, window or number of query heads it is computed with.
//
// Where a key lives (dense row or paged block), its position and its
// dequantization scale come from a `Src` policy (DenseSrc / PagedSrc).
//
// Tree windows (dense only): with a (T, Wn) ancestor bitmap `win_mask` and
// per-row region bases `win_base` (B,), key j with 0 <= j - win_base[b] <
// Wn is valid for query t iff win_mask[t, j - win_base[b]] — the bitmap
// REPLACES the position rule there (sibling branches share positions, so
// pos_map cannot separate them); keys outside the region keep the rule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {

constexpr int kMaxWarps = 4;      // 16-row tiles per block
constexpr int kMaxSplit = 1024;   // keys per split the metadata can hold
constexpr int kCombineWarps = 4;  // rows per combine block
constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

// ------------------------------------------------------------ primitives

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// 2^x by the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a · b for one m16n8k16 tile: bf16 inputs, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// 16 bytes of a shared-memory row as floats (4 f32 or 16 int8)
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load16(const int8_t* p, float (&x)[16]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = static_cast<float>(static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3))));
}

__device__ __forceinline__ float elem_f(float x) { return x; }
__device__ __forceinline__ float elem_f(int8_t x) {
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

// ------------------------------------------- configuration and layout

constexpr float kLog2e = 1.4426950408889634f;

// bf16 queries (mma path): two warps per 16-row tile (at least four warps
// a block, the rest only load), 64-key stages in a 2- or 4-deep ring; key
// group g (warp parity) takes keys [32g, 32g + 32) of every stage for its
// tile's rows over the whole head dim. f32 queries (CUDA-core path): one warp per
// 16-row tile, 32-key stages, 3 deep.
template <int HD, typename TQ, typename TKV>
struct Cfg {
  static constexpr bool kMma = std::is_same<TQ, __nv_bfloat16>::value;
  static constexpr bool kCvt = kMma && std::is_same<TKV, int8_t>::value;
  static constexpr int kGroups = kMma ? 2 : 1;         // key groups
  static constexpr int kWarps = kMaxWarps * kGroups;   // most per block
  static constexpr int KT = kMma ? 64 : 32;
  // ring depth: a one-tile bf16 block (a draft step, the hybrid's
  // attention) streams alone on its SM at long S, so it keeps three stages
  // in flight; blocks of more rows share an SM by twos, two stages each
  template <int RT>
  __host__ __device__ static constexpr int stages() {
    return kMma ? (RT == 1 ? 4 : 2) : 3;
  }
  static constexpr int kKeysPerWarp = KT / kGroups;    // mma: 32
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(TKV)) + 16;
  static constexpr int kBfRowBytes = HD * 2 + 16;
  static constexpr int kStageBytes = 2 * KT * kRowBytes;
};

// Byte offsets of one block's dynamic shared memory: the K/V stage ring
// (after the last stage, the mma path merges its key groups there), the
// bf16 copy of an int8 stage (bf16 queries over int8 pools), the queries
// (bf16 for the mma path; f32, and P, for the CUDA-core path), then the
// split's key metadata and the live-tile mask.
template <int HD, typename TQ, typename TKV>
struct Layout {
  using C = Cfg<HD, TQ, TKV>;
  int cvt, qs, ps, ent, kpos, ksc, vsc, tbl, live, bytes;

  __host__ __device__ Layout(int nw, int split_t, int n_stages) {
    cvt = n_stages * C::kStageBytes;
    qs = cvt + (C::kCvt ? 2 * C::KT * C::kBfRowBytes : 0);
    ps = qs + (C::kMma ? 64 * C::kBfRowBytes : nw * 16 * HD * 4);
    ent = ps + (C::kMma ? 0 : nw * 16 * C::KT * 4);
    kpos = ent + split_t * 8;
    ksc = kpos + split_t * 4;
    vsc = ksc + split_t * 4;
    tbl = vsc + split_t * 4;
    live = tbl + (split_t + 1) * 4;
    bytes = live + 16;
  }
};

// ------------------------------------------------------------ the kernel

// q, out: (B, T, Hkv, G, HD); q_pos: (B, T). Keys j in [0, n_keys) are
// located through `src`; a key it cannot place (past the cache, unmapped
// block, past `length`) carries position -1 and is masked like an empty
// slot. Valid iff 0 <= pos <= q_pos (and pos > q_pos - window when
// window > 0), or by the tree bitmap inside its region (see above). A row
// with no valid key writes zeros. Scores are kept in log2 units (scale2 =
// log2(e)/sqrt(HD)), so every exponential is one exp2. part: f32 scratch
// of n_split·R·(HD + 2) (R = B·T·Hkv·G rows: acc, then m, then l), unused
// with one split. Grid: (n_rb row blocks × n_split splits, Hkv, B), the
// row blocks of one split adjacent (they read the same K/V, so the later
// ones find it in L2). RT: 16-row tiles per block (mma path: 2·RT warps).
template <int HD, typename TQ, typename TKV, typename Src, int RT>
__global__ void __launch_bounds__(
    Cfg<HD, TQ, TKV>::kMma ? 64 * (RT > 2 ? RT : 2) : 32 * kMaxWarps,
    Cfg<HD, TQ, TKV>::kMma && RT < 4 ? 2 : 1)
    attend_kernel(const TQ* __restrict__ q, const int* __restrict__ q_pos,
                  const unsigned char* __restrict__ win_mask,
                  const int* __restrict__ win_base, int Wn,
                  TQ* __restrict__ out, float* __restrict__ part, int T,
                  int Hkv, int G, int n_keys, int split, int n_split,
                  int n_rb, int window, float scale2, Src src) {
  using C = Cfg<HD, TQ, TKV>;
  constexpr int KT = C::KT;
  constexpr int kSt = C::template stages<RT>();
  // rows held per thread: the mma path holds rows r8 and r8 + 8 of its
  // warp's tile (the accumulator fragment layout), the CUDA-core path all
  // 16 rows of its warp's tile in every lane
  constexpr int kHeld = C::kMma ? 2 : 16;
  constexpr int kAccA = C::kMma ? HD / 8 : HD / 32;
  constexpr int kAccB = C::kMma ? 4 : 16;
  constexpr int kDead = 0x7fffffff;  // lower bound of a row past the window
  extern __shared__ __align__(16) unsigned char smem[];

  const int rb = blockIdx.x % n_rb;
  const int sp = blockIdx.x / n_rb;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int tid = threadIdx.x;
  const int nthr =
      C::kMma ? 64 * (RT > 2 ? RT : 2) : static_cast<int>(blockDim.x);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  const int r8 = lane >> 2;
  const int n_rows = T * G;
  const int tiles = (n_rows + 15) / 16;
  const int rpb = 16 * (tiles < kMaxWarps ? tiles : kMaxWarps);  // rows/block
  const int row_blk = rb * rpb;
  const int rows_here = min(rpb, n_rows - row_blk);
  // first row of the warp's tile (mma: two warps, key groups, per tile)
  const int row_w = row_blk + (warp / C::kGroups) * 16;
  const int s0 = sp * split;
  const int s_end = min(s0 + split, n_keys);
  const int n_tiles = s_end > s0 ? (s_end - s0 + KT - 1) / KT : 0;
  const int split_t = (split + KT - 1) / KT * KT;
  const Layout<HD, TQ, TKV> lay(nthr >> 5, split_t, kSt);
  long long* ent_s = reinterpret_cast<long long*>(smem + lay.ent);
  int* kpos_s = reinterpret_cast<int*>(smem + lay.kpos);
  float* ksc_s = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc_s = reinterpret_cast<float*>(smem + lay.vsc);
  int* tbl_s = reinterpret_cast<int*>(smem + lay.tbl);
  unsigned* live_s = reinterpret_cast<unsigned*>(smem + lay.live);

  // query offsets of a row (element index of q[b, t, h, g, 0]); the flat
  // row index of out / the partials times HD
  auto q_off = [&](int row) -> long long {
    const int t = row / G;
    const int g = row - t * G;
    return ((((long long)b * T + t) * Hkv + h) * G + g) * HD;
  };
  auto held_row = [&](int i) -> int {
    return C::kMma ? row_w + r8 + 8 * i : row_w + i;
  };

  // ---- early loads, all independent: the mma path's queries into shared
  // memory (their own cp.async group), the held rows' q_pos, the q_pos
  // range of the block's rows
  if (tid == 0) *live_s = 0u;
  if constexpr (C::kMma) {
    constexpr int kCpr = HD / 8;
    for (int c = tid; c < rpb * kCpr; c += nthr) {
      const int r = c / kCpr;
      const int pc = c - r * kCpr;
      const bool ok = r < rows_here;
      const TQ* g = ok ? q + q_off(row_blk + r) + pc * 8 : q;
      cp_async16(smem + lay.qs + r * C::kBfRowBytes + pc * 16, g,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }
  // a held row's keys: lo <= pos <= hi (lo = kDead: the row is past the
  // window's rows); tr: its token, for the tree bitmap
  int lo[kHeld], hi[kHeld], tr[kHeld];
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int row = held_row(i);
    const bool live = row < n_rows;
    tr[i] = live ? row / G : 0;
    hi[i] = live ? q_pos[(long long)b * T + tr[i]] : 0;
    lo[i] = !live ? kDead : window > 0 ? max(0, hi[i] - window + 1) : 0;
  }
  int qp_min = 0x7fffffff, qp_max = -0x7fffffff - 1;
  {
    const int t_lo = row_blk / G;
    const int t_hi = (row_blk + rows_here - 1) / G;
    for (int t = t_lo + lane; t <= t_hi; t += 32) {
      const int p = q_pos[(long long)b * T + t];
      qp_min = min(qp_min, p);
      qp_max = max(qp_max, p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qp_min = min(qp_min, __shfl_xor_sync(0xffffffffu, qp_min, o));
      qp_max = max(qp_max, __shfl_xor_sync(0xffffffffu, qp_max, o));
    }
  }
  const int base = win_mask != nullptr ? win_base[b] : 0;

  // ---- the K/V ring: tile ti into stage `stage`
  auto issue = [&](int ti, int stage) {
    constexpr int kCpr = HD * static_cast<int>(sizeof(TKV)) / 16;
    constexpr int kElems = 16 / static_cast<int>(sizeof(TKV));
    unsigned char* st = smem + stage * C::kStageBytes;
#pragma unroll 4
    for (int c = tid; c < 2 * KT * kCpr; c += nthr) {
      const int which = c / (KT * kCpr);
      const int rem = c - which * KT * kCpr;
      const int r = rem / kCpr;
      const int pc = rem - r * kCpr;
      const long long e = ent_s[ti * KT + r];
      const TKV* g = which ? src.v : src.k;
      const void* gp = e >= 0 ? static_cast<const void*>(g + e + pc * kElems)
                              : static_cast<const void*>(g);
      cp_async16(st + (which * KT + r) * C::kRowBytes + pc * 16, gp,
                 e >= 0 ? 16 : 0);
    }
  };
  // ---- key metadata of the split. First each key's row and K/V entry
  // (no device-memory read for a dense cache; the paged table entries, one
  // per logical block, come first); then the first kSt − 1 tiles are
  // issued at once, so their loads overlap the rest of this prologue; then
  // each key's position and scales, and a bit per tile with a key that
  // some row of the block may see. Later tiles without one are never
  // loaded (the early ones add exactly zero if dead).
  src.prologue(b, s0, s_end, tbl_s, tid, nthr);
  __syncthreads();
  for (int i = tid; i < n_tiles * KT; i += nthr) {
    const int j = s0 + i;
    const long long r = j < s_end ? src.row(b, j, s0, tbl_s) : -1;
    ent_s[i] = r >= 0 ? (r * Hkv + h) * HD : -1;
  }
  __syncthreads();
  const unsigned all_tiles = n_tiles >= 32 ? ~0u : (1u << n_tiles) - 1u;
  const unsigned early =
      all_tiles & ((1u << (kSt - 1)) - 1u);  // tiles 0 .. kSt - 2
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    if (early & (1u << i)) issue(i, i);
    cp_async_commit();
  }
  for (int i0 = 0; i0 < n_tiles * KT; i0 += nthr) {
    const int i = i0 + tid;
    bool live = false;
    if (i < n_tiles * KT) {
      const int j = s0 + i;
      const long long r = ent_s[i] >= 0 ? src.row(b, j, s0, tbl_s) : -1;
      const int pos = r >= 0 ? src.pos_map[r] : -1;
      kpos_s[i] = pos;
      if constexpr (Src::kScaled) {
        ksc_s[i] = r >= 0 ? src.k_scale[r * Hkv + h] : 1.f;
        vsc_s[i] = r >= 0 ? src.v_scale[r * Hkv + h] : 1.f;
      }
      const int rel = j - base;
      live = (win_mask != nullptr && j < s_end && rel >= 0 && rel < Wn) ||
             (pos >= 0 && pos <= qp_max &&
              (window <= 0 || pos > qp_min - window));
    }
    // a warp's 32 keys lie in one tile (KT is 32 or 64)
    if (__ballot_sync(0xffffffffu, live) != 0u && lane == 0)
      atomicOr(live_s, 1u << ((i0 + warp * 32) / KT));
  }
  __syncthreads();
  const unsigned live_mask = *live_s | early;
  unsigned pend = live_mask & ~early;  // tiles not yet issued, key order
  auto next_tile = [&]() -> int {
    const int t = __ffs(pend) - 1;
    pend &= pend - 1;
    return t;
  };

  float m[kHeld], l[kHeld];
  float acc[kAccA][kAccB];
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < kAccA; ++a)
#pragma unroll
    for (int u = 0; u < kAccB; ++u) acc[a][u] = 0.f;

  // tree bitmap of a key in the region (offset rel) for a row of token t
  // (lo_i = kDead: the row is past the window's rows)
  auto tree_ok = [&](int lo_i, int t, int rel) -> bool {
    return lo_i != kDead && win_mask[(long long)t * Wn + rel] != 0;
  };

  if constexpr (C::kMma) {
    // Warp w: row tile w / 2, key group g = w % 2, keys [32g, 32g + 32) of
    // every stage for its 16 rows over the whole head dim; scores stay in
    // registers and become P's A fragments (FlashAttention-2 style), so a
    // stage needs no exchange between warps. The two key groups of a tile
    // merge once, after the split's last stage, in a fixed order.
    constexpr int kKW = C::kKeysPerWarp;  // 32
    const int kg = warp % C::kGroups;
    const bool computes = warp < 2 * RT;  // else the warp only loads
    const unsigned char* qs =
        smem + lay.qs + (warp / C::kGroups) * 16 * C::kBfRowBytes;
    unsigned todo = live_mask;
    for (int it = 0; todo != 0u; ++it) {
      const int ti = __ffs(todo) - 1;
      todo &= todo - 1;
      cp_async_wait<kSt - 2>();
      __syncthreads();  // stage `it` (and q) landed; stage it-1 consumed
      if (pend) issue(next_tile(), (it + kSt - 1) % kSt);
      cp_async_commit();
      const unsigned char* st = smem + (it % kSt) * C::kStageBytes;
      const unsigned char* kb = st;
      const unsigned char* vb = st + KT * C::kRowBytes;
      int rowb = C::kRowBytes;
      if constexpr (C::kCvt) {
        // int8 rows → bf16 rows (exact), 8 values per thread and step
        unsigned char* cv = smem + lay.cvt;
        constexpr int kCpr = HD / 8;
#pragma unroll 4
        for (int c = tid; c < 2 * KT * kCpr; c += nthr) {
          const int r = c / kCpr;  // 0..2KT: K rows then V rows
          const int pc = c - r * kCpr;
          const int2 raw = *reinterpret_cast<const int2*>(
              st + r * C::kRowBytes + pc * 8);
          const int w[2] = {raw.x, raw.y};
          uint32_t o[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int wd = w[u >> 1] >> (16 * (u & 1));
            o[u] = pack_bf16(static_cast<float>(static_cast<int8_t>(wd)),
                             static_cast<float>(static_cast<int8_t>(wd >> 8)));
          }
          *reinterpret_cast<uint4*>(cv + r * C::kBfRowBytes + pc * 16) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
        __syncthreads();
        kb = cv;
        vb = cv + KT * C::kBfRowBytes;
        rowb = C::kBfRowBytes;
      }
      if (!computes) continue;
      const int k0 = kg * kKW;  // the group's first key of the stage

      // S = Q Kᵀ over the group's 32 keys: four 8-key column tiles, two
      // k-steps per ldmatrix.x4
      float sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[nt][u] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; kk += 2) {
        uint32_t qa[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          ldmatrix_x4(qa[u], qs + (lane & 15) * C::kBfRowBytes +
                                 ((kk + u) * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kb + (k0 + nt * 8 + (lane & 7)) * rowb +
                              (kk * 16 + (lane >> 3) * 8) * 2);
          mma_bf16(sc[nt], qa[0], kf[0], kf[1]);
          mma_bf16(sc[nt], qa[1], kf[2], kf[3]);
        }
      }
      // mask and scale (log2 units), online softmax over the group's keys
      // for rows r8 (i = 0) and r8 + 8 (i = 1); P (× the V scale) in bf16
      // A fragments
      uint32_t pa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kt = ti * KT + k0 + nt * 8 + 2 * q4 + e;
            const int kp = kpos_s[kt];
            const int rel = s0 + kt - base;
            const bool in_tree = win_mask != nullptr && s0 + kt < s_end &&
                                 rel >= 0 && rel < Wn;
            const bool v = in_tree ? tree_ok(lo[i], tr[i], rel)
                                   : kp >= lo[i] && kp <= hi[i];
            const float ks = Src::kScaled ? ksc_s[kt] * scale2 : scale2;
            const float s = v ? sc[nt][2 * i + e] * ks : kNegInf;
            sc[nt][2 * i + e] = s;
            mx = fmaxf(mx, s);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = fast_exp2(m[i] - m_new);
        m[i] = m_new;
        float rs = 0.f;
        float pv[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = sc[nt][2 * i + e];
            const float p = s > kNegInf ? fast_exp2(s - m_new) : 0.f;
            rs += p;
            pv[nt][e] =
                Src::kScaled ? p * vsc_s[ti * KT + k0 + nt * 8 + 2 * q4 + e]
                             : p;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[i] = l[i] * alpha + rs;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          acc[c][2 * i] *= alpha;
          acc[c][2 * i + 1] *= alpha;
        }
        // row i's A-fragment registers: keys 16k2 + 2q4 (+8) of k-step k2
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          pa[k2][i] = pack_bf16(pv[2 * k2][0], pv[2 * k2][1]);
          pa[k2][2 + i] = pack_bf16(pv[2 * k2 + 1][0], pv[2 * k2 + 1][1]);
        }
      }
      // acc += P · V over the group's keys, the whole head dim
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const unsigned char* va =
            vb + (k0 + k2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * rowb +
            (lane >> 4) * 16;
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, va + dp * 32);
          mma_bf16(acc[2 * dp], pa[k2], vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pa[k2], vf[2], vf[3]);
        }
      }
    }
    cp_async_wait<0>();
    // merge the key groups: group 1 hands (m, l, acc) of its rows over
    // through shared memory (the ring, now free); group 0 combines them
    __syncthreads();
    float* xch = reinterpret_cast<float*>(smem) +
                 (warp / C::kGroups) * (32 * (HD / 8) * 4 + 32 * 4);
    if (kg == 1 && computes) {
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<float4*>(xch + (c * 32 + lane) * 4) =
            make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
      *reinterpret_cast<float4*>(xch + 32 * (HD / 8) * 4 + lane * 4) =
          make_float4(m[0], m[1], l[0], l[1]);
    }
    __syncthreads();
    if (kg == 1 || !computes) return;
    const float4 o_ml = *reinterpret_cast<const float4*>(
        xch + 32 * (HD / 8) * 4 + lane * 4);
    const float m1[2] = {o_ml.x, o_ml.y}, l1[2] = {o_ml.z, o_ml.w};
    float a0[2], a1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mm = fmaxf(m[i], m1[i]);
      a0[i] = fast_exp2(m[i] - mm);
      a1[i] = fast_exp2(m1[i] - mm);
      m[i] = mm;
      l[i] = l[i] * a0[i] + l1[i] * a1[i];
    }
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const float4 o = *reinterpret_cast<const float4*>(
          xch + (c * 32 + lane) * 4);
      acc[c][0] = acc[c][0] * a0[0] + o.x * a1[0];
      acc[c][1] = acc[c][1] * a0[0] + o.y * a1[0];
      acc[c][2] = acc[c][2] * a0[1] + o.z * a1[1];
      acc[c][3] = acc[c][3] * a0[1] + o.w * a1[1];
    }
  } else {
    // f32 queries on the CUDA cores: warp w owns rows [16w, 16w + 16) of
    // the block; lane = key for the scores, lane = head-dim column for P·V
    constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
    const bool warp_live = row_w < n_rows;
    float* qs = reinterpret_cast<float*>(smem + lay.qs) + warp * 16 * HD;
    for (int i = 0; i < 16; ++i) {
      const int row = row_w + i;
      for (int d = lane; d < HD; d += 32)
        qs[i * HD + d] =
            row < n_rows ? static_cast<float>(q[q_off(row) + d]) : 0.f;
    }
    __syncwarp();
    float* ps = reinterpret_cast<float*>(smem + lay.ps) + warp * 16 * KT;

    unsigned todo = live_mask;
    for (int it = 0; todo != 0u; ++it) {
      const int ti = __ffs(todo) - 1;
      todo &= todo - 1;
      cp_async_wait<kSt - 2>();
      __syncthreads();  // stage `it` landed; every warp is done with it - 1
      if (pend) issue(next_tile(), (it + kSt - 1) % kSt);
      cp_async_commit();
      if (!warp_live) continue;
      const unsigned char* st = smem + (it % kSt) * C::kStageBytes;
      const TKV* krow = reinterpret_cast<const TKV*>(st + lane * C::kRowBytes);
      float sc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < HD; d0 += kVec) {
        float kx[kVec];
        load16(krow + d0, kx);
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int u = 0; u < kVec; u += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + i * HD + d0 + u);
            sc[i] = fmaf(qv.x, kx[u], sc[i]);
            sc[i] = fmaf(qv.y, kx[u + 1], sc[i]);
            sc[i] = fmaf(qv.z, kx[u + 2], sc[i]);
            sc[i] = fmaf(qv.w, kx[u + 3], sc[i]);
          }
      }
      const int kt = ti * KT + lane;
      const int kp = kpos_s[kt];
      const int rel = s0 + kt - base;
      const bool in_tree =
          win_mask != nullptr && s0 + kt < s_end && rel >= 0 && rel < Wn;
      const float ks = Src::kScaled ? ksc_s[kt] * scale2 : scale2;
      const float vs = Src::kScaled ? vsc_s[kt] : 1.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool v = in_tree ? tree_ok(lo[i], tr[i], rel)
                             : kp >= lo[i] && kp <= hi[i];
        const float s = v ? sc[i] * ks : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(s));
        const float alpha = fast_exp2(m[i] - m_new);
        const float e = v ? fast_exp2(s - m_new) : 0.f;
        l[i] = l[i] * alpha + warp_sum(e);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < HD / 32; ++c) acc[c][i] *= alpha;
        ps[i * KT + lane] = e * vs;
      }
      __syncwarp();
      const TKV* vt = reinterpret_cast<const TKV*>(st + KT * C::kRowBytes);
      constexpr int kVRow = C::kRowBytes / static_cast<int>(sizeof(TKV));
#pragma unroll 4
      for (int j = 0; j < KT; ++j) {
        float vv[HD / 32];
#pragma unroll
        for (int c = 0; c < HD / 32; ++c)
          vv[c] = elem_f(vt[j * kVRow + lane + 32 * c]);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float pj = ps[i * KT + j];
#pragma unroll
          for (int c = 0; c < HD / 32; ++c)
            acc[c][i] = fmaf(pj, vv[c], acc[c][i]);
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: the output (one split) or this split's partials (m in
  // log2 units)
  const long long R = (long long)B * n_rows * Hkv;
  float* pacc = part + (long long)sp * R * HD;
  float* pm = part + (long long)n_split * R * HD + (long long)sp * R;
  float* pl = pm + (long long)n_split * R;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    if (lo[i] == kDead) continue;
    const long long o = q_off(held_row(i));
    const float inv = l[i] > 0.f ? 1.f / fmaxf(l[i], 1e-20f) : 0.f;
    if constexpr (C::kMma) {
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const int d = c * 8 + 2 * q4;
        const float a0 = acc[c][2 * i], a1 = acc[c][2 * i + 1];
        if (n_split == 1)
          *reinterpret_cast<uint32_t*>(out + o + d) =
              pack_bf16(a0 * inv, a1 * inv);
        else
          *reinterpret_cast<float2*>(pacc + o + d) = make_float2(a0, a1);
      }
      if (n_split > 1 && q4 == 0) {
        pm[o / HD] = m[i];
        pl[o / HD] = l[i];
      }
    } else {
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) {
        if (n_split == 1)
          out[o + lane + 32 * c] = from_f<TQ>(acc[c][i] * inv);
        else
          pacc[o + lane + 32 * c] = acc[c][i];
      }
      if (n_split > 1 && lane == 0) {
        pm[o / HD] = m[i];
        pl[o / HD] = l[i];
      }
    }
  }
}

// Merge the splits' partials of R rows in split order: out = Σ w_s acc_s /
// Σ w_s l_s with w_s = exp2(m_s − max m). One warp per row, lane = HD/32
// contiguous head-dim columns. The splits go in chunks of 16: a chunk's
// partials are all loaded before any is used (the first chunk's before
// the maximum over the splits is known), lanes 0..15 take the chunk's
// weights and broadcast them, and every sum runs in split order (the
// chunk's Σ w·l by a fixed butterfly), so the order depends on n_split
// alone. A row with no valid key anywhere (every l_s = 0) writes zeros.
template <int HD, typename TQ>
__global__ void __launch_bounds__(kCombineWarps * 32)
    combine_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                   long long R, int n_split) {
  constexpr int kC = HD / 32;
  constexpr int kChunk = 16;
  const long long row =
      (long long)blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float* pm = part + (long long)n_split * R * HD;
  const float* pl = pm + (long long)n_split * R;
  float x[kChunk][kC];
  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float* src = part + ((c0 + u) * R + row) * HD + lane * kC;
#pragma unroll
      for (int c = 0; c < kC; c += 2) {
        float2 v = make_float2(0.f, 0.f);
        if (c0 + u < n_split) v = *reinterpret_cast<const float2*>(src + c);
        x[u][c] = v.x;
        x[u][c + 1] = v.y;
      }
    }
  };
  load_chunk(0);
  float mx = kNegInf;
  for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, pm[s * R + row]);
  mx = warp_max(mx);
  float den = 0.f;
  float a[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) a[c] = 0.f;
  for (int c0 = 0;;) {
    const int s = c0 + (lane & (kChunk - 1));
    const bool ok = s < n_split;
    const float w_l = ok ? fast_exp2(pm[s * R + row] - mx) : 0.f;
    float lw = ok ? w_l * pl[s * R + row] : 0.f;
#pragma unroll
    for (int o = kChunk / 2; o > 0; o >>= 1)
      lw += __shfl_xor_sync(0xffffffffu, lw, o);
    den += lw;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float w = __shfl_sync(0xffffffffu, w_l, u);
#pragma unroll
      for (int c = 0; c < kC; ++c) a[c] += w * x[u][c];
    }
    c0 += kChunk;
    if (c0 >= n_split) break;
    load_chunk(c0);
  }
  const float inv = den > 0.f ? 1.f / fmaxf(den, 1e-20f) : 0.f;
  TQ* o = out + row * HD + lane * kC;
#pragma unroll
  for (int c = 0; c < kC; ++c) o[c] = from_f<TQ>(a[c] * inv);
}

// The optional tree window (win_mask, win_base, Wn; nullptr = none).
struct TreeWindow {
  const unsigned char* mask;  // (T, Wn) bool
  const int* base;            // (B,) region start per row
  int Wn;
};

// One launch of the attention kernel with RT row tiles per block (the mma
// path; the CUDA-core path takes RT = 1 and sizes its block by `nw`).
template <int HD, typename TQ, typename TKV, typename Src, int RT>
int launch_rt(const TQ* q, const int* q_pos, TreeWindow tw, TQ* out,
              float* part, int B, int T, int Hkv, int G, int n_keys,
              int split, int n_split, int n_rb, int nw, int window,
              const Src& src, cudaStream_t stream) {
  using C = Cfg<HD, TQ, TKV>;
  const int split_t = (split + C::KT - 1) / C::KT * C::KT;
  constexpr int kSt = C::template stages<RT>();
  const Layout<HD, TQ, TKV> lay(nw, split_t, kSt);
  auto kernel = attend_kernel<HD, TQ, TKV, Src, RT>;
  // set once per instantiation, on the first (eager) call, to the most any
  // call can ask for: never inside a CUDA-graph capture
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<HD, TQ, TKV>(C::kWarps, kMaxSplit, kSt).bytes);
    // all of L1 as shared memory, so two 105 KB blocks share an SM
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const float scale2 = kLog2e / sqrtf(static_cast<float>(HD));
  const dim3 grid(n_rb * n_split, Hkv, B);
  kernel<<<grid, C::kMma ? 64 * (RT > 2 ? RT : 2) : nw * 32, lay.bytes,
                                 stream>>>(
      q, q_pos, tw.mask, tw.base, tw.Wn, out, part, T, Hkv, G, n_keys,
      split, n_split, n_rb, window, scale2, src);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename TQ, typename TKV, typename Src>
int launch_attend(const TQ* q, const int* q_pos, TreeWindow tw, TQ* out,
                  float* part, int B, int T, int Hkv, int G, int n_keys,
                  int split, int n_split, int window, const Src& src,
                  cudaStream_t stream) {
  using C = Cfg<HD, TQ, TKV>;
  const int want = n_keys > 0 ? (n_keys + split - 1) / split : 1;
  if (split <= 0 || split > kMaxSplit || n_split != want ||
      (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (T * G + 15) / 16;
  const int nw = tiles < kMaxWarps ? tiles : kMaxWarps;
  const int n_rb = (tiles + nw - 1) / nw;
  int err;
#define REPRO_LAUNCH_RT(rt)                                               \
  launch_rt<HD, TQ, TKV, Src, rt>(q, q_pos, tw, out, part, B, T, Hkv, G,  \
                                  n_keys, split, n_split, n_rb, nw, window, \
                                  src, stream)
  if (!C::kMma || nw == 1)
    err = REPRO_LAUNCH_RT(1);
  else if (nw == 2)
    err = REPRO_LAUNCH_RT(2);
  else if (nw == 3)
    err = REPRO_LAUNCH_RT(3);
  else
    err = REPRO_LAUNCH_RT(4);
#undef REPRO_LAUNCH_RT
  if (err != 0 || n_split == 1) return err;
  const long long R = (long long)B * T * Hkv * G;
  combine_kernel<HD, TQ>
      <<<static_cast<unsigned>((R + kCombineWarps - 1) / kCombineWarps),
         kCombineWarps * 32, 0, stream>>>(part, out, R, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, typename Src>
int launch_attend_hd(int hd, const TQ* q, const int* q_pos, TreeWindow tw,
                     TQ* out, float* part, int B, int T, int Hkv, int G,
                     int n_keys, int split, int n_split, int window,
                     const Src& src, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || G <= 0) return 0;  // nothing to do
  switch (hd) {
    case 64:
      return launch_attend<64, TQ, TKV>(q, q_pos, tw, out, part, B, T, Hkv,
                                        G, n_keys, split, n_split, window,
                                        src, stream);
    case 128:
      return launch_attend<128, TQ, TKV>(q, q_pos, tw, out, part, B, T, Hkv,
                                         G, n_keys, split, n_split, window,
                                         src, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch
