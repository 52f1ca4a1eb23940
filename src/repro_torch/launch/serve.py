"""Serving launcher of the PyTorch port: edge-draft + cloud-target
speculative decoding with the paper's window policies on the continuous
slot-based scheduler, one draft–target pair colocated on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --target qwen3-14b --draft qwen2.5-3b --policy awc \
        --requests 8 --max-new 32 [--arrival-rate 8] [--temperature 0.0] \
        [--paged-kv] [--full-size] [--device cuda|cpu] [--no-capture]
        [--link-rtt-ms 15 [--link-jitter-ms 1] [--link-bw-gbps 1]]
        [--mode-policy auto|distributed|fused] [--json]

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --target zamba2-1.2b --draft mamba2-130m --full-size

The flags are the reference launcher's one-pair surface that the port
runs (``repro/launch/serve.py``), plus ``--device`` (the card by default),
``--paged-kv``/``--kv-pool-blocks`` (the serving config's paged pool) and
``--full-size``. On the card every session step is captured once as a
CUDA graph and replayed (``captured_graphs`` 2 for a continuous server:
one round step, one insert; ``graph_replays`` = rounds + admissions − the
two warm-ups); ``--no-capture`` runs them eagerly for comparison.
``--target``/``--draft`` take any name of the config zoo
whose family the port runs: dense (qwen, llama2, deepseek, command-r), ssm
(mamba2-130m) and hybrid (zamba2-1.2b); a pair with an ssm or hybrid side
runs the engine's split step (verify from the window-start state, then
re-advance it over the accepted tokens). ``--paged-kv`` pages only the
attention-family sides (a hybrid's shared attention stays dense) and
refuses a pair with none. Reduced same-family configs by default, as the
reference launcher; ``--full-size`` serves the published widths and
depths in their published dtype (the reference's
``build_deployment(reduced=False)``).
Weights are random, drawn on the device from ``--seed``. ``--arrival-rate``
draws Poisson arrivals (requests/s); TTFT and e2e include queue wait.
``--temperature`` > 0 samples (the sampled verify runs kernels B3 every
round); the sessions seed their generators as the reference's do (0).

``--link-rtt-ms`` splits the pair at the wire: the rounds run as
half-duplex draft→verify→verdict exchanges between the engine's split
workers over a transport — 0 is the zero-delay in-process transport, more
is an emulated edge–cloud link of that RTT, ``--link-jitter-ms`` jitter and
``--link-bw-gbps`` bandwidth (wall-clock sleeps of the sampled delays; the
summary's ``link_recent_rtt_ms`` is the measured RTT). On the card every
worker program is captured once and replayed (``captured_graphs``: insert,
propose, verify; + advance for an ssm draft; + ingest once a fused round
ran). ``--mode-policy`` honors the window policy's fused/distributed
decision (auto) or forces one mode; the pipelined mode comes with the next
slice of ROADMAP A9. Topologies and the wave server come with A13.
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
from ..distributed import make_transport
from ..serving import ServeRequest, ServerConfig, SpecDecodeServer
from ..sim.network import LinkSpec


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
                    help="virtual RTT charged by the colocated path "
                         "(ignored when --link-rtt-ms selects a transport)")
    ap.add_argument("--link-rtt-ms", type=float, default=None,
                    help="run distributed over a transport: 0 = in-process "
                         "(zero delay), >0 = emulated edge-cloud link with "
                         "this RTT (measured wall-clock delays)")
    ap.add_argument("--link-jitter-ms", type=float, default=1.0,
                    help="emulated link jitter (with --link-rtt-ms > 0)")
    ap.add_argument("--link-bw-gbps", type=float, default=1.0,
                    help="emulated link bandwidth (with --link-rtt-ms > 0)")
    ap.add_argument("--mode-policy", default="auto",
                    choices=["auto", "distributed", "fused", "pipeline"],
                    help="honor the window policy's fused/distributed "
                         "decision (auto) or force one mode; 'pipeline' is "
                         "refused (the next slice of ROADMAP A9)")
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
    ap.add_argument("--no-capture", action="store_true",
                    help="run every step eagerly on the card instead of "
                         "replaying captured CUDA graphs")
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
    if args.mode_policy == "pipeline":
        raise SystemExit("--mode-policy pipeline: the pipelined mode is the "
                         "next slice of ROADMAP A9")
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
    transport = make_transport(
        None if args.link_rtt_ms is None else LinkSpec(
            rtt_ms=args.link_rtt_ms, jitter_ms=args.link_jitter_ms,
            bandwidth_gbps=args.link_bw_gbps), seed=args.seed)
    server = SpecDecodeServer(engine, policy, ServerConfig(
        max_batch=args.max_batch, sync_every=args.sync_every,
        paged_kv=args.paged_kv, kv_pool_blocks=args.kv_pool_blocks,
        capture=False if args.no_capture else None, transport=transport,
        mode_policy=args.mode_policy))

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
        "captured_graphs": engine.graphs.captured,
        "graph_replays": engine.graphs.replays,
        "graph_warm_ups": engine.graphs.warm_ups,
        "pairs": pairs,
    }
    if transport is not None:
        # the reference launcher's flat link keys
        summary.update(
            transport=transport.describe(), mode_policy=args.mode_policy,
            link_bytes_sent=transport.bytes_sent,
            link_messages=transport.messages_sent,
            link_recent_rtt_ms=round(transport.recent_rtt_ms, 3))
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
              f"programs={s['step_programs']}  "
              f"graphs={s['captured_graphs']}"
              + (f"  link={s['transport']} rtt="
                 f"{s['link_recent_rtt_ms']:.2f}ms "
                 f"messages={s['link_messages']}" if "transport" in s
                 else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
