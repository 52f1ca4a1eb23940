// CPU emulation of the CUDA subset the SSD backward kernel uses, for g++:
// one OS thread per CUDA thread, blocks one after another, a barrier per
// block for __syncthreads and one per warp for shuffles and mma.sync (its
// fragments exchanged through memory and multiplied in double). For
// checking a kernel's index math and numerics on a machine without nvcc
// (tools/ssd_bwd_emulate.py); it says nothing of speed.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __restrict__ __restrict

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 v) { return __uint_as_float(uint32_t(v.x) << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u = __float_as_uint(f);
  u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }

namespace emu {
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<float> xch;        // 32 per warp
  std::vector<uint32_t> fa, fb;  // mma fragments: 32·4, 32·2 per warp
  std::vector<float> fd;
};
extern Block* cur;
extern thread_local unsigned tid;
}
extern thread_local uint3 threadIdx;
extern uint3 blockIdx;
extern dim3 gridDim, blockDim;

inline void __syncthreads() { emu::cur->bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const unsigned w = emu::tid / 32, l = emu::tid % 32;
  auto& b = *emu::cur->wbar[w];
  emu::cur->xch[w * 32 + l] = v;
  b.arrive_and_wait();
  const float r = emu::cur->xch[w * 32 + (l ^ off)];
  b.arrive_and_wait();
  return r;
}
// m16n8k8 TF32: the operands' low 13 bits are ignored, as on the card
inline float tf32v(uint32_t u) { return __uint_as_float(u & 0xffffe000u); }
inline void emu_mma(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  const unsigned w = emu::tid / 32, l = emu::tid % 32;
  auto& bar = *emu::cur->wbar[w];
  uint32_t* fa = &emu::cur->fa[w * 128];
  uint32_t* fb = &emu::cur->fb[w * 64];
  for (int i = 0; i < 4; ++i) fa[l * 4 + i] = a[i];
  for (int i = 0; i < 2; ++i) fb[l * 2 + i] = b[i];
  bar.arrive_and_wait();
  auto A = [&](int r, int k) {
    const int g = r % 8, q = k % 4;
    return tf32v(fa[(g * 4 + q) * 4 + (r >= 8) + 2 * (k >= 4)]);
  };
  auto B = [&](int k, int n) { return tf32v(fb[(n * 4 + k % 4) * 2 + (k >= 4)]); };
  const int g = l / 4, q = l % 4;
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >= 2), n = 2 * q + (i & 1);
    double s = 0;
    for (int k = 0; k < 8; ++k) s += double(A(r, k)) * B(k, n);
    d[i] = float(d[i] + s);
  }
  bar.arrive_and_wait();
}

namespace emu {
template <typename K, typename... Args>
void launch(K kernel, dim3 grid, dim3 block, int, cudaStream_t, Args... args) {
  const unsigned nt = block.x;
  gridDim = grid;
  blockDim = block;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        Block bl;
        bl.bar = std::make_unique<std::barrier<>>(nt);
        for (unsigned w = 0; w < (nt + 31) / 32; ++w)
          bl.wbar.push_back(std::make_unique<std::barrier<>>(32));
        bl.xch.resize(nt + 32);
        bl.fa.resize(4 * (nt + 32));
        bl.fb.resize(2 * (nt + 32));
        cur = &bl;
        blockIdx = {x, y, z};
        std::vector<std::thread> th;
        for (unsigned t = 0; t < nt; ++t)
          th.emplace_back([&, t] {
            tid = t;
            threadIdx = {t, 0, 0};
            kernel(args...);
          });
        for (auto& t : th) t.join();
      }
}
}
