#!/usr/bin/env python3
"""``ssd_scan_bwd``'s CUDA source run on the CPU, against the plain backward.

    python3 tools/ssd_bwd_emulate.py [--quick]      # from the repository root

Needs g++ (C++20) and the CPU build of PyTorch; no card and no nvcc. The
kernel header ``src/repro_torch/csrc/ssd_scan_bwd.cuh`` and its two sources
are copied into ``build/ssd_bwd_emulate/``, their ``<<<…>>>`` launches
rewritten as calls of ``emu::launch``, beside ``ssd_mma.cuh`` with its
inline-PTX functions swapped for host versions, and compiled with g++ against
``tools/cuda_emu`` (one OS thread per CUDA thread, warp barriers for the
shuffles and ``mma.sync``, TF32 rounding as the card does it) into a
library the C entry ``ssd_scan_bwd_launch`` is called from through ctypes,
on CPU tensors. The chunk states the wrapper gets from B5 on the card
(``ssd_scan_states_launch``) come from PyTorch here. Each case prints the
largest share of chip_smoke.py's SSD_BWD_TOL used per gradient against
autograd of the plain chunked scan (``ssd_chunked_plain_bwd``), or the
einsum form (``ssd_chunked_bwd_plain``) at S = 0, and exits 1 if a share
passes 1. It checks index math and numerics, never speed: a block of 512
threads runs as 512 OS threads, so keep the shapes small."""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.ssd.ref import (ssd_chunked_bwd_plain,  # noqa: E402
                                         ssd_chunked_plain_bwd)

CSRC = ROOT / "src" / "repro_torch" / "csrc"
SHIM = ROOT / "tools" / "cuda_emu"
OUT = ROOT / "build" / "ssd_bwd_emulate"
TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}   # chip_smoke SSD_BWD_TOL
# (B, S, nh, hd, N, dtype, wanted heads per block, seed, dt scale): one
# chunk and several, both buffer layouts, the clamp to one head (f32 at
# hd = N = 128), S 0 and 1, Σ A·dt in a chunk far above 88
CASES = [(1, 9, 2, 16, 16, torch.float32, 2, 0, 1.0),
         (1, 9, 2, 16, 16, torch.bfloat16, 2, 0, 1.0),
         (2, 130, 4, 16, 32, torch.float32, 2, 0, 1.0),
         (2, 130, 4, 16, 32, torch.bfloat16, 2, 0, 1.0),
         (1, 200, 2, 32, 16, torch.float32, 2, 0, 1.0),
         (1, 1, 2, 16, 16, torch.float32, 1, 0, 1.0),
         (1, 0, 2, 16, 16, torch.float32, 1, 0, 1.0),
         (1, 77, 4, 64, 64, torch.float32, 4, 5, 8.0),
         (1, 63, 2, 32, 64, torch.bfloat16, 1, 6, 8.0),
         (2, 48, 3, 16, 128, torch.float32, 1, 7, 1.0),
         (1, 40, 8, 64, 128, torch.bfloat16, 8, 1, 1.0),
         (1, 130, 8, 64, 128, torch.bfloat16, 8, 2, 1.0),
         (1, 100, 8, 128, 128, torch.bfloat16, 8, 3, 1.0),
         (1, 100, 2, 128, 128, torch.float32, 2, 4, 1.0)]
QUICK = 6    # --quick: the first cases only


def emulated_mma_header() -> str:
    """csrc/ssd_mma.cuh with its CUDA includes replaced by the emulation's
    and its inline-PTX region (BEGIN PTX … END PTX) by the host versions in
    ``tools/cuda_emu/emu_ptx.inc``: every other helper is the card's own."""
    src = (CSRC / "ssd_mma.cuh").read_text()
    inc = "#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n"
    ptx = re.compile(r"^// BEGIN PTX\b.*?^// END PTX\n", re.S | re.M)
    if inc not in src or len(ptx.findall(src)) != 1:
        raise SystemExit("csrc/ssd_mma.cuh: its CUDA includes or its one "
                         "BEGIN PTX … END PTX region are not where the "
                         "emulation expects them")
    src = src.replace(inc, '#include "emu_cuda.h"\n')
    return ptx.sub(lambda _: (SHIM / "emu_ptx.inc").read_text(), src)


def build() -> ctypes.CDLL:
    """The kernel's sources with their launches rewritten, linked with the
    emulation into OUT/libemu.so."""
    OUT.mkdir(parents=True, exist_ok=True)
    for name in ("ssd_scan_bwd.cuh", "ssd_scan_bwd.cu", "ssd_scan_bwd_f32.cu"):
        src = (CSRC / name).read_text()
        src = re.sub(r"([\w:]+(?:<[^<>;()]*>)?)<<<([^;]*?)>>>\(",
                     r"::emu::launch(\1, \2, ", src)
        dst = name[:-3] + ".cpp" if name.endswith(".cu") else name
        (OUT / dst).write_text(src)
    (OUT / "ssd_mma.cuh").write_text(emulated_mma_header())
    cmd = ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w",
           "-I", str(SHIM), str(SHIM / "emu_runtime.cpp"),
           str(OUT / "ssd_scan_bwd.cpp"), str(OUT / "ssd_scan_bwd_f32.cpp"),
           "-o", str(OUT / "libemu.so")]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(OUT / "libemu.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd_launch.argtypes = [P] * 20 + [I] * 7 + [P]
    lib.ssd_scan_bwd_heads.argtypes = [I] * 4
    return lib


def chunk_states(x, Bm, dt, A, h_in):
    """B5's phases 1–2 in PyTorch: each 64-token chunk's starting state
    and decay, (B, nch, nh, hd, N) and (B, nch, nh)."""
    st, dc, h = [], [], h_in.clone()
    for c0 in range(0, x.shape[1], 64):
        sl = slice(c0, min(x.shape[1], c0 + 64))
        Lc = torch.cumsum(A * dt[:, sl], 1)
        w = torch.exp(Lc[:, -1:] - Lc) * dt[:, sl]
        st.append(h)
        dc.append(torch.exp(Lc[:, -1]))
        h = dc[-1][..., None, None] * h + torch.einsum(
            "blhd,blh,bln->bhdn", x[:, sl].float(), w, Bm[:, sl].float())
    return torch.stack(st, 1).contiguous(), torch.stack(dc, 1).contiguous()


def run_case(lib, B, S, nh, hd, N, dtype, hg_want, seed, dt_scale) -> float:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, nh, hd, generator=g).to(dtype)
    Bm = (0.5 * torch.randn(B, S, N, generator=g)).to(dtype)
    Cm = (0.5 * torch.randn(B, S, N, generator=g)).to(dtype)
    dt = dt_scale * F.softplus(torch.randn(B, S, nh, generator=g))
    A = -torch.exp(torch.randn(nh, generator=g))
    h_in = torch.randn(B, nh, hd, N, generator=g)
    dy = torch.randn(B, S, nh, hd, generator=g)
    dh = torch.randn(B, nh, hd, N, generator=g)
    code = 0 if dtype == torch.float32 else 1
    hg = lib.ssd_scan_bwd_heads(hd, N, code, hg_want)
    nch = -(-S // 64)

    def new(*shape, dt_=torch.float32):   # NaN-filled: unwritten shows
        return torch.full(shape, float("nan"), dtype=dt_)
    dx, dB, dC = new(B, S, nh, hd, dt_=dtype), new(B, S, N, dt_=dtype), \
        new(B, S, N, dt_=dtype)
    ddt, dA, dh_in = new(B, S, nh), new(nh), new(B, nh, hd, N)
    st = dc = gst = None
    if nch > 1:
        st, dc = chunk_states(x, Bm, dt, A, h_in)
        gst = new(B, nch, nh, hd, N)
    dBp, dCp = new(B, S, nh // hg, N), new(B, S, nh // hg, N)
    dAp = new(B, max(nch, 1), nh)
    err = lib.ssd_scan_bwd_launch(
        *(None if t is None else t.data_ptr()
          for t in (x, Bm, Cm, dt, A, h_in, dy, dh, dx, dB, dC, ddt, dA,
                    dh_in, st, dc, gst, dBp, dCp, dAp)),
        B, S, nh, hd, N, hg, code, None)
    if err:
        raise RuntimeError(f"ssd_scan_bwd_launch returned {err}")
    plain = ssd_chunked_plain_bwd if S else ssd_chunked_bwd_plain
    want = plain(x, Bm, Cm, dt, A, h_in, dy, dh, 64)
    shares = {}
    for name, a, w in zip(("dx", "dB", "dC", "ddt", "dA", "dh_in"),
                          (dx, dB, dC, ddt, dA, dh_in), want):
        a, w = a.float(), w.float()
        if not a.numel():
            continue
        if not torch.isfinite(a).all():
            shares[name] = float("inf")
            continue
        lim = TOL[dtype] * (w.abs().max() + w.abs())
        d = (a - w).abs()
        over_zero = torch.where(d > 0, float("inf"), 0.0)
        shares[name] = float(torch.where(lim > 0, d / lim.clamp_min(1e-30),
                                         over_zero).max())
    worst = max(shares.values(), default=0.0)
    print(f"B {B} S {S} nh {nh} hd {hd} N {N} {str(dtype)[6:]} hg {hg} "
          f"dt×{dt_scale}: share {worst:.3g} "
          + " ".join(f"{k} {v:.2g}" for k, v in shares.items()), flush=True)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help=f"the first {QUICK} cases only")
    args = ap.parse_args(argv)
    lib = build()
    worst = max(run_case(lib, *c)
                for c in (CASES[:QUICK] if args.quick else CASES))
    print(f"largest share of the tolerance used: {worst:.3g}")
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
