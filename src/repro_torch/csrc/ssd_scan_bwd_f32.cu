// ssd_scan_bwd — the f32 instantiations of B5's gradient (ssd_scan_bwd.cuh),
// in a source of their own so they build beside the bf16 ones
// (ssd_scan_bwd.cu).

#include "ssd_scan_bwd.cuh"

namespace repro_torch {

int ssd_scan_bwd_f32(int hd, int N, const BwdCall& k, cudaStream_t st) {
  return launch_bwd_hd<float>(hd, N, k, st);
}

int ssd_scan_bwd_heads_f32(int hd, int N, int hg) {
  return bwd_heads_hd<float>(hd, N, hg);
}

}  // namespace repro_torch
