// ssd_scan_bwd — B5's gradient on Hopper (sm_90a): the C entries and the
// bf16 instantiations. The design note and the kernels are in
// ssd_scan_bwd.cuh; the f32 instantiations build apart, in
// ssd_scan_bwd_f32.cu. The chunks' starting states come from
// ssd_scan_states_launch (ssd_scan.cu), which the wrapper calls first.

#include "ssd_scan_bwd.cuh"

namespace {
bool supported(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }
}  // namespace

// Heads per block the backward takes for hd × N in dtype (0 = f32, 1 =
// bf16) given the wanted hg (a power of two dividing nh): hg, or a half of
// it where its block would not fit shared memory; 0 if the shape is not
// taken. The wrapper sizes the dB/dC partials (B, S, nh / hg, N) from it.
extern "C" int ssd_scan_bwd_heads(int hd, int N, int dtype, int hg) {
  if (!supported(hd) || !supported(N) || hg < 1 ||
      hg > repro_torch::kBwdMaxHG)
    return 0;
  if (dtype == 0) return repro_torch::ssd_scan_bwd_heads_f32(hd, N, hg);
  if (dtype == 1)
    return repro_torch::bwd_heads_hd<__nv_bfloat16>(hd, N, hg);
  return 0;
}

// Inputs as B5 takes them plus dy (B, S, nh, hd) and dh_out (B, nh, hd, N)
// float32; outputs dx (x's shape and type), dB, dC ((B, S, N), x's type),
// ddt (B, S, nh), dA (nh,), dh_in (B, nh, hd, N) float32. Scratch, float32:
// for S > 64, states (B, nch, nh, hd, N) holding the chunks' starting
// states (ssd_scan_states_launch), decay (B, nch, nh) from the same call,
// gst (B, nch, nh, hd, N); always dBp, dCp (B, S, nh / hg, N) and dAp
// (B, max(nch, 1), nh); nch = ceil(S / 64). hg from ssd_scan_bwd_heads.
// Everything contiguous and 16-byte aligned.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* Bm, const void* Cm, const void* dt,
    const void* A, const void* h_in, const void* dy, const void* dh_out,
    void* dx, void* dB, void* dC, void* ddt, void* dA, void* dh_in,
    void* states, void* decay, void* gst, void* dBp, void* dCp, void* dAp,
    int B, int S, int nh, int hd, int N, int hg, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || nh <= 0) return 0;
  if (S < 0 || !supported(hd) || !supported(N) || hg < 1 || nh % hg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S > kSsdChunk && (!states || !decay || !gst))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdCall k{x,  Bm, Cm, dt,  A,   h_in,  dy,    dh_out, dx,  dB,
            dC, ddt, dA, dh_in, states, gst, decay, dBp, dCp, dAp,
            B,  S,  nh, hg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ssd_scan_bwd_f32(hd, N, k, st);
  if (dtype == 1) return launch_bwd_hd<__nv_bfloat16>(hd, N, k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
