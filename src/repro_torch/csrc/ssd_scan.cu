// B5 — the Mamba2 SSD chunked scan on Hopper (sm_90a): the C entries and the
// bf16 instantiations. The design note and the kernels are in
// ssd_scan.cuh; the f32 instantiations build apart, in ssd_scan_f32.cu.

#include "ssd_scan.cuh"

// Tokens per chunk: the wrapper sizes the scratch (B, nch, nh, hd, N) and
// (B, nch, nh) float32 from it, nch = ceil(S / chunk), when nch > 1.
extern "C" int ssd_scan_chunk() { return repro_torch::kL; }

// x (B, S, nh, hd) and Bm/Cm (B, S, N) in dtype (0 = f32, 1 = bf16);
// dt (B, S, nh), A (nh,), h_in (B, nh, hd, N) f32; y (B, S, nh, hd) and
// h_out (B, nh, hd, N) f32; states/decay the scratch above (unused for one
// chunk). hd, N ∈ {16, 32, 64, 128}; hg heads per block, 1..8, divides nh;
// all contiguous and 16-byte aligned.
extern "C" int ssd_scan_launch(const void* x, const void* Bm, const void* Cm,
                               const void* dt, const void* A,
                               const void* h_in, void* y, void* h_out,
                               void* states, void* decay, int B, int S,
                               int nh, int hd, int N, int hg, int dtype,
                               void* stream) {
  if (B <= 0 || nh <= 0) return 0;
  if (S < 0 || hg < 1 || hg > repro_torch::kMaxHG || nh % hg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::ssd_scan_f32(hd, N, x, Bm, Cm, dt, A, h_in, y,
                                     h_out, states, decay, B, S, nh, hg, st);
  if (dtype == 1)
    return repro_torch::launch_hd<__nv_bfloat16>(hd, N, x, Bm, Cm, dt, A,
                                                 h_in, y, h_out, states,
                                                 decay, B, S, nh, hg, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
