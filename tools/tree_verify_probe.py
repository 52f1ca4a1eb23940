#!/usr/bin/env python3
"""B4 (greedy tree verify) alone, on one card.

    python3 tools/tree_verify_probe.py [--root DIR] [--check] [--rounds N]

Run from the repository root. ``--root`` names another checkout of the
port (for example an unpacked parent commit) whose kernels are built and
timed instead, with this checkout's timing helpers (``chip_smoke.py``):
comparing two commits means one process each, in turns (one kernel library
per process). At the tree verify shape of ``chip_smoke.py`` (B 4, T 25,
V 151936 f32; entries follow the target's argmax at their parent with
p 0.7) it prints one JSON line of device µs by CUDA-graph replay, ``N``
rounds of turns over: B4a alone, B4b alone, B4a then B4b (two launches),
the one-launch call and an empty kernel (the last two where the checkout
has them), and whether the one-launch verdict equals the plain one with
its counters back at zero (the exit code is 1 if not). With ``--check``, ``chip_smoke.py``'s tree kernel
check runs first (this checkout's API). Then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.core.tree import TreeSpec
    from repro_torch.kernels import verify as kv

    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lib = kernels.library()
    if args.check:
        tol = {torch.float32: dict(atol=1e-4, rtol=1e-4),
               torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
        cs.check_tree_kernels(torch, gen, dev,
                              {"target": (8, 5), "draft": (2, 8)}, tol)

    spec = TreeSpec(cs.GAMMA_MAX, cs.B_MAX, dev)
    B, T, V = 4, spec.n_entries, 151936
    logits = torch.randn((B, T, V), generator=gen, device=dev)
    tgt = kv.tree_argmax_plain(logits)
    keep = torch.rand((B, T), generator=gen, device=dev) < 0.7
    toks = torch.where(keep, tgt[:, spec.parent_entry.long()],
                       torch.randint(0, V, (B, T), generator=gen, device=dev,
                                     dtype=torch.int32)).contiguous()
    tables = (spec.parent_entry, spec.tree_pos,
              spec.node_valid(cs.GAMMA_MAX, cs.B_MAX), spec.win_mask)
    words = (spec.win_words,) if hasattr(spec, "win_words") else ()
    fns = {"B4a": lambda: kv.tree_argmax(logits),
           "B4b": lambda: kv.tree_accept(toks, tgt, *tables, *words),
           "B4a_then_B4b": lambda: kv.tree_accept(
               toks, kv.tree_argmax(logits), *tables, *words)}
    # the one-launch call takes the caller's counters; a checkout whose
    # tree_verify_fused takes none launches B4a then B4b
    one_launch = "counters" in inspect.signature(
        kv.tree_verify_fused).parameters
    counters = torch.zeros(B, dtype=torch.int32, device=dev)
    if one_launch:
        fns["one_launch"] = lambda: kv.tree_verify_fused(
            toks, logits, *tables, *words, counters)
    if hasattr(lib, "empty_kernel_launch"):
        fns["empty"] = lambda: lib.empty_kernel_launch(
            torch.cuda.current_stream(dev).cuda_stream)
    us = {k: [] for k in fns}
    for _ in range(args.rounds):
        for k, fn in fns.items():
            us[k].append(cs.graph_ms(torch, fn) * 1e3)
    equal = None
    if "one_launch" in fns:
        want = kv.tree_accept_plain(toks, tgt, *tables)
        got = kv.tree_verify_fused(toks, logits, *tables, *words, counters)
        equal = all(torch.equal(a, w) for a, w in zip(got, want)) \
            and int(counters.abs().sum()) == 0
    print(json.dumps({"root": str(root), "shape": {"B": B, "T": T, "V": V},
                      "us": us,
                      "min_us": {k: min(v) for k, v in us.items()},
                      "one_launch_equals_plain": equal}), flush=True)
    print(cs.smi_line(), flush=True)
    return 1 if equal is False else 0


if __name__ == "__main__":
    sys.exit(main())
