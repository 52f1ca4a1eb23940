// Helpers shared by B5 (ssd_scan.cuh) and its gradient (ssd_scan_bwd.cuh):
// the element types' traits, 16-byte loads and cp.async copies, and the
// tensor-core product mma.sync m16n8k8 TF32 with f32 accumulation, with the
// hi/lo split of an operand that is not exact in TF32 (v = tf32(v) +
// tf32(v − tf32(v)): 22 significant bits, so a product of two split
// operands, hi·hi + hi·lo + lo·hi, is f32-accurate to a few ulps).
// Header only, in an anonymous namespace: each source that includes it
// compiles its own copy, and no template of either kernel is instantiated
// twice.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kSsdChunk = 64;  // tokens per chunk, forward and backward

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

// BEGIN PTX: the five functions written in inline PTX, between this line
// and END PTX (tools/ssd_bwd_emulate.py swaps them for host versions)
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

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// END PTX

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

}  // namespace
}  // namespace repro_torch
