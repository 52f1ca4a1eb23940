"""Serving launcher of the PyTorch port: edge-draft + cloud-target
speculative decoding with the paper's window policies on the continuous
slot-based scheduler, one draft–target pair colocated on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --target qwen3-14b --draft qwen2.5-3b --policy awc \
        --requests 8 --max-new 32 [--arrival-rate 8] [--temperature 0.0] \
        [--paged-kv] [--full-size] [--device cuda|cpu] [--json]

The flags are the reference launcher's one-pair surface that the port
runs (``repro/launch/serve.py``), plus ``--device`` (the card by default),
``--paged-kv``/``--kv-pool-blocks`` (the serving config's paged pool) and
``--full-size``. Reduced same-family configs by default, as the reference
launcher; ``--full-size`` serves the published widths and depths in their
published dtype (the reference's ``build_deployment(reduced=False)``).
Weights are random, drawn on the device from ``--seed``. ``--arrival-rate``
draws Poisson arrivals (requests/s); TTFT and e2e include queue wait.
``--temperature`` > 0 samples (the sampled verify runs kernels B3 every
round); the sessions seed their generators as the reference's do (0).
Topologies, links and the wave server come with ROADMAP items A13 and A9.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, replace

import numpy as np

from ..configs import ARCHS, get_config
from ..core.engine import SpecDecodeEngine
from ..core.window import make_window_policy
from ..serving import ServeRequest, ServerConfig, SpecDecodeServer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default="qwen3-14b", choices=sorted(ARCHS))
    ap.add_argument("--draft", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--policy", default="static",
                    choices=["static", "dynamic", "awc"])
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals per second (0 = all at t=0)")
    ap.add_argument("--rtt-ms", type=float, default=10.0,
                    help="virtual RTT charged by the colocated path")
    ap.add_argument("--gamma-max", type=int, default=12,
                    help="window width of the step; any policy γ ≤ this "
                         "runs the same step")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode rounds between host stat syncs")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--paged-kv", action="store_true",
                    help="paged block-pool KV cache")
    ap.add_argument("--kv-pool-blocks", type=int, default=None,
                    help="pool blocks per paged side (default: dense "
                         "parity)")
    ap.add_argument("--full-size", action="store_true",
                    help="published configs instead of the reduced ones")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


@dataclass
class ServeRun:
    summary: dict
    results: list          # list[ServeResult], in retirement order
    server: SpecDecodeServer
    requests: list         # list[ServeRequest], in submission order


def run(argv=None) -> ServeRun:
    """Build the pair, serve the generated request stream, summarize."""
    args = parse_args(argv)
    raw = {}
    for role, name in (("draft", args.draft), ("target", args.target)):
        cfg = get_config(name)
        raw[role] = cfg if args.full_size else cfg.reduced()
    # one tokenizer: the vocabularies unify to the smaller one
    vocab = min(c.vocab for c in raw.values())
    cfgs = {r: (c if c.vocab == vocab else replace(c, vocab=vocab))
            for r, c in raw.items()}
    engine = SpecDecodeEngine(cfgs["draft"], cfgs["target"], seed=args.seed,
                              temperature=args.temperature,
                              rtt_ms=args.rtt_ms, gamma_max=args.gamma_max,
                              sync_every=args.sync_every, device=args.device)
    policy = make_window_policy(args.policy, gamma=args.gamma)
    server = SpecDecodeServer(engine, policy, ServerConfig(
        max_batch=args.max_batch, sync_every=args.sync_every,
        paged_kv=args.paged_kv, kv_pool_blocks=args.kv_pool_blocks))

    rng = np.random.default_rng(args.seed)
    arrival = 0.0
    requests = []
    for i in range(args.requests):
        plen = int(rng.integers(8, 48))
        if args.arrival_rate > 0:
            arrival += float(rng.exponential(1.0 / args.arrival_rate))
        requests.append(ServeRequest(
            i, rng.integers(0, vocab, plen).astype(np.int32), args.max_new,
            arrival_s=arrival))
        server.submit(requests[-1])
    t0 = time.perf_counter()
    results = server.run()
    wall = time.perf_counter() - t0

    tokens = int(sum(len(r.tokens) for r in results))
    pairs = server.pair_summaries()
    summary = {
        "server": "continuous",
        "device": str(engine.device),
        "target": cfgs["target"].name,
        "draft": cfgs["draft"].name,
        "policy": args.policy,
        "temperature": args.temperature,
        "paged_kv": bool(args.paged_kv),
        "requests": len(results),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall if wall > 0 else 0.0,
        "iterations": sum(d["iterations"] for d in pairs.values()),
        "mean_acceptance": float(np.mean([r.acceptance_rate
                                          for r in results])),
        "mean_ttft_ms": float(np.mean([r.ttft_ms for r in results])),
        "mean_queue_ms": float(np.mean([r.queue_ms for r in results])),
        "mean_tpot_ms": float(np.mean([r.tpot_ms for r in results])),
        "mean_e2e_ms": float(np.mean([r.e2e_ms for r in results])),
        "step_programs": engine.step_programs(),
        "pairs": pairs,
    }
    return ServeRun(summary=summary, results=results, server=server,
                    requests=requests)


def main(argv=None) -> int:
    args = parse_args(argv)
    s = run(argv).summary
    if args.json:
        print(json.dumps(s, indent=1))
    else:
        print(f"served {s['requests']} requests on {s['device']}  "
              f"tokens={s['tokens']}  tok/s={s['tokens_per_s']:.1f}  "
              f"acceptance={s['mean_acceptance']:.3f}  "
              f"ttft={s['mean_ttft_ms']:.1f}ms  "
              f"tpot={s['mean_tpot_ms']:.1f}ms  "
              f"e2e={s['mean_e2e_ms']:.0f}ms  "
              f"programs={s['step_programs']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
