"""Knee sweep of a rate cell, once, when the cell is defined:

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 2,3,4,5

One process builds and warms the cell's deployment once, then serves the
cell's traffic at each rate in turn (the ramp, then the window) and prints
one JSON line per rate: the queue of requests due and not yet admitted at
the window's start and at its end, the TTFT and TPOT p90, tokens/s and the
round time. The knee is the highest rate whose queue at the window's end
is no longer than at its start; the cell runs at 0.8 x the knee, written
into its traffic file as a number."""

from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    _, cell, cfg, mix = run.cell_files(args.workload, manifest)
    if mix["arrivals"]["kind"] != "poisson":
        raise SystemExit("a knee sweep needs a rate cell")
    import torch

    import traffic
    import weights as W
    from serve import serve_window
    from window import (percentile, queue_length, tpot_samples_ms,
                        ttft_samples_ms, window_tokens)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    seeds = W.side_seeds(args.seed)
    params = {side: W.draw(cfg["port"][side], seeds[side], "cuda")
              for side in ("target", "draft")}
    dep, kw = run.build(cfg, cell, mix, params, "cuda")
    run.warm_up(dep, kw, mix, cell, args.seed)
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        m = {**mix, "arrivals": {"kind": "poisson", "rate_per_s": rate}}
        reqs = traffic.generate(m, args.seed, cell["ramp_s"] + args.seconds,
                                dep.vocab)
        rec = serve_window(dep, kw, reqs, cell["ramp_s"], args.seconds)
        win, rs = rec.window(), list(rec.requests.values())
        chunks = [c for c in rec.chunks if win.w0 <= c.t0 and c.t1 <= win.w1]
        rounds = sum(c.rounds for c in chunks)
        row = {"rate_per_s": rate,
               "queue_at_start": queue_length(rs, win.w0),
               "queue_at_end": queue_length(rs, win.w1),
               "ttft_p90_ms": percentile(ttft_samples_ms(rs, win), 90),
               "ttft_samples": len(ttft_samples_ms(rs, win)),
               "tpot_p90_ms": percentile(tpot_samples_ms(rs, win), 90),
               "tokens_per_s": window_tokens(rec.chunks, rec.admits, win)
               / win.seconds,
               "round_ms": 1e3 * sum(c.t1 - c.t0 for c in chunks)
               / max(1, rounds),
               "fused_share": sum(g == 0 for c in chunks for g in c.gammas)
               / max(1, rounds)}
        if row["queue_at_end"] <= row["queue_at_start"]:
            knee = rate
        print(json.dumps(row), flush=True)
    print(json.dumps({"knee_per_s": knee,
                      "cell_rate_per_s": None if knee is None
                      else round(0.8 * knee, 3)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
