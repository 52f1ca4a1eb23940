// The load side of the decode-attention kernels alone: blocks stream K and
// V rows (256 bytes each, `stride` bytes apart, `heads` interleaved heads)
// into a ring of 64-row shared-memory stages and compute nothing. ring_cp
// copies with 16-byte cp.async (as the kernels do), ring_bulk with one
// cp.async.bulk per row completing on an mbarrier (the TMA engine). Built
// and driven by tools/decode_attn_probe.py, never by the port.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void cp16(void* s, const void* g) {
  unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g));
}
__device__ __forceinline__ void bulk(void* s, const void* g, int bytes, uint64_t* bar) {
  unsigned a = (unsigned)__cvta_generic_to_shared(s);
  unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(a), "l"(g), "r"(bytes), "r"(b) : "memory");
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int n) {
  unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(b), "r"(n));
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int phase) {
  unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("{\n.reg .pred p;\nW: mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n@!p bra W;\n}\n" ::"r"(b), "r"(phase) : "memory");
}

// grid (n_blocks); block b reads keys [b*keys, (b+1)*keys) of K and V
// rows: row r at base + r*stride, 256 B. STAGES x 64 rows x 2 in flight.
template <int STAGES>
__global__ void __launch_bounds__(256) ring_cp(const char* k, const char* v, long long stride, int keys, int heads, float* out) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x;
  const long long r0 = (long long)(blockIdx.x / heads) * keys;
  const long long hoff = (long long)(blockIdx.x % heads) * 256;
  const int n_st = keys / 64;
  float acc = 0.f;
  auto issue = [&](int s, int slot) {
    for (int c = tid; c < 2 * 64 * 16; c += 256) {
      int w = c / 1024, r = (c / 16) % 64, pc = c % 16;
      const char* g = (w ? v : k) + hoff + (r0 + s * 64 + r) * stride + pc * 16;
      cp16(sm + slot * 34816 + (w * 64 + r) * 272 + pc * 16, g);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) { if (s < n_st) issue(s, s); asm volatile("cp.async.commit_group;\n"); }
  for (int s = 0; s < n_st; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    if (s + STAGES - 1 < n_st) issue(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    asm volatile("cp.async.commit_group;\n");
    acc += *(const float*)(sm + (s % STAGES) * 34816 + (tid % 128) * 272);
  }
  if (acc == 12345.f) out[0] = acc;
}

template <int STAGES>
__global__ void __launch_bounds__(256) ring_bulk(const char* k, const char* v, long long stride, int keys, int heads, float* out) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ uint64_t bars[STAGES];
  const int tid = threadIdx.x;
  const long long r0 = (long long)(blockIdx.x / heads) * keys;
  const long long hoff = (long long)(blockIdx.x % heads) * 256;
  const int n_st = keys / 64;
  if (tid == 0) for (int s = 0; s < STAGES; ++s) bar_init(&bars[s], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  float acc = 0.f;
  auto issue = [&](int s, int slot) {   // warp 0: 128 rows, 4 per lane
    if (tid >= 32) return;
    if (tid == 0) bar_expect(&bars[slot], 2 * 64 * 256);
    __syncwarp();
    for (int r = tid; r < 128; r += 32) {
      int w = r / 64, rr = r % 64;
      const char* g = (w ? v : k) + hoff + (r0 + s * 64 + rr) * stride;
      bulk(sm + slot * 34816 + r * 272, g, 256, &bars[slot]);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) if (s < n_st) issue(s, s);
  for (int s = 0; s < n_st; ++s) {
    bar_wait(&bars[s % STAGES], (s / STAGES) & 1);
    __syncthreads();
    if (s + STAGES - 1 < n_st) issue(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    acc += *(const float*)(sm + (s % STAGES) * 34816 + (tid % 128) * 272);
  }
  if (acc == 12345.f) out[0] = acc;
}

extern "C" int membench(int mode, int stages, const void* k, const void* v, long long stride,
                        int keys, int heads, int blocks, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int smem = stages * 34816;
  void* fn = nullptr;
  if (mode == 0) fn = stages == 2 ? (void*)ring_cp<2> : stages == 3 ? (void*)ring_cp<3> : (void*)ring_cp<4>;
  else fn = stages == 2 ? (void*)ring_bulk<2> : stages == 3 ? (void*)ring_bulk<3> : (void*)ring_bulk<4>;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  void* args[] = {(void*)&k, (void*)&v, (void*)&stride, (void*)&keys, (void*)&heads, (void*)&out};
  cudaLaunchKernel(fn, dim3(blocks), dim3(256), args, smem, st);
  return (int)cudaGetLastError();
}
