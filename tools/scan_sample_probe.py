#!/usr/bin/env python3
"""B5 (the SSD scan) and B3b (the inverse-CDF sample) alone, on one card.

    python3 tools/scan_sample_probe.py [--root DIR] [--check] [--sweep]

Run from the repository root. ``--root`` names another checkout of the
port (for example an unpacked parent commit) whose kernels are built and
timed instead, with this checkout's timing helpers and inputs
(``chip_smoke.py``): comparing two commits means one process each, in turns
(one kernel library per process). Prints one JSON line each:

- the build: seconds, and each entry's registers and spills;
- with ``--check``: ``chip_smoke.py``'s B5 and B3 checks (kernel == plain
  at every shape of ``SSD_CASES`` and of the sampled check, the zero-dt
  identity, B3b's B 1 == B 4 and run == run);
- B5 at ``SSD_TIMED`` (bf16) and B3b at (B 4, Γ 8, V 151936, f32, L2-cold):
  device ms by CUDA-graph replay beside the bound;
- with ``--sweep``: B5 at each timed shape under every heads-per-block
  value the shape admits (the result does not depend on it);
- with ``--breakdown``: each CUDA kernel of one B5 call at each timed shape
  and of one B3b call, device µs from ``torch.profiler``, in launch order;
- the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def launches_us(torch, fn, reps: int = 5) -> list:
    """(kernel name, mean device µs) of each launch of one ``fn()`` call, in
    launch order, from ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                 key=lambda e: e.time_range.start)
    n = len(evs) // reps
    return [[evs[i].name.split("(")[0][-48:],
             sum(evs[i + k * n].time_range.elapsed_us()
                 for k in range(reps)) / reps] for i in range(n)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.kernels.ssd import ssd_chunked_kernel
    from repro_torch.kernels.verify import cdf_sample, gather_reduce
    from repro_torch.kernels.verify.ops import select_rows

    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    kernels.library()
    ptxas = kernels.BUILD_LOG.get("ptxas") or {}
    cs.emit({"root": str(root), "build_s": time.perf_counter() - t0,
             "ptxas": {n: cs.ptxas_entries(ptxas.get(n, ""))
                       for n in ("ssd_scan.cu", "ssd_scan_f32.cu",
                                 "sampled_verify.cu")}})
    failed = []
    if args.check:
        for check in (cs.check_ssd_kernels, cs.check_sampled_kernels,
                      cs.check_cdf_sample_determinism):
            try:
                check(torch, gen, dev)
            except SystemExit as e:     # report, time the kernels anyway
                failed.append(str(e))
                cs.emit({"failed": str(e)})

    for label, B, S, nh, hd, N, chunk in cs.SSD_TIMED:
        x = cs.ssd_inputs(torch, gen, dev, B, S, nh, hd, N, torch.bfloat16)
        bound, by = cs.ssd_bound(B, S, nh, hd, N, chunk, 2)
        row = {"kernel": "ssd_scan", "shape": label, "bound_ms": bound,
               "bound_by": by,
               "ms": cs.graph_ms(torch, lambda: ssd_chunked_kernel(
                   *x, chunk), iters=20 if S > 9 else 50)}
        if args.sweep:     # the wrapper's choice pinned, one value each
            import repro_torch.kernels.ssd.ssd as ssd_mod
            pick, row["ms_by_heads_per_block"] = ssd_mod.heads_per_block, {}
            for hg in (h for h in (1, 2, 4, 8) if nh % h == 0):
                ssd_mod.heads_per_block = lambda *_, hg=hg: hg
                row["ms_by_heads_per_block"][hg] = cs.graph_ms(
                    torch, lambda: ssd_chunked_kernel(*x, chunk),
                    iters=20 if S > 9 else 50)
            ssd_mod.heads_per_block = pick
        if args.breakdown:
            row["kernels_us"] = launches_us(torch, lambda: ssd_chunked_kernel(
                *x, chunk))
        cs.emit(row)

    B, G, V = 4, cs.GAMMA_MAX, 151936
    copies = []
    for _ in range(3):
        toks, p, q = cs.sampled_window(torch, gen, B, G, V, torch.float32,
                                       dev)
        u = torch.rand((B, G), generator=gen, device=dev)
        r = torch.rand((B,), generator=gen, device=dev)
        copies.append((p, q, select_rows(*gather_reduce(toks, p, q), u, r)))
    call = cs.cycle([lambda c=c: cdf_sample(c[2].jrow, c[2].qrow,
                                            c[2].use_p, c[0], c[1],
                                            c[2].thresh) for c in copies])
    row = {"kernel": "cdf_sample", "shape": {"B": B, "gamma": G, "V": V},
           "ms": cs.graph_ms(torch, call, iters=48)}
    if args.breakdown:
        row["kernels_us"] = launches_us(torch, call)
    cs.emit(row)
    print(cs.smi_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
