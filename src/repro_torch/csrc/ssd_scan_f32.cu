// B5 — the f32 instantiations of the SSD chunked scan (ssd_scan.cuh), in a
// source of their own so they build beside the bf16 ones (ssd_scan.cu).

#include "ssd_scan.cuh"

namespace repro_torch {

int ssd_scan_f32(int hd, int N, const void* x, const void* Bm, const void* Cm,
                 const void* dt, const void* A, const void* h_in, void* y,
                 void* h_out, void* states, void* decay, int B, int S, int nh,
                 int hg, cudaStream_t stream) {
  return launch_hd<float>(hd, N, x, Bm, Cm, dt, A, h_in, y, h_out, states,
                          decay, B, S, nh, hg, stream);
}

}  // namespace repro_torch
