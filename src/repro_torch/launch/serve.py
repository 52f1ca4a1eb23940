"""Serving launcher of the PyTorch port: edge-draft + cloud-target
speculative decoding with the paper's window policies, on the continuous
slot-based scheduler (default) or the wave-batched baseline.

TOPOLOGY-FIRST, as the reference launcher (``repro/launch/serve.py``): the
real input is a :class:`repro_torch.topology.ClusterSpec` — nodes,
draft→target pairs with per-pair links/window/mode policies, serving knobs,
workload:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --topology examples/cluster_2pair.json [--requests 8] [--json]

The one-pair flags compile to an equivalent spec through
:func:`repro_torch.topology.one_pair_spec` and the same
:func:`~repro_torch.topology.build_deployment`:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --target qwen3-14b --draft qwen2.5-3b --policy awc \
        --requests 8 --max-new 32 [--server continuous|wave] \
        [--arrival-rate 8] [--temperature 0.0] [--paged-kv] [--full-size] \
        [--device cuda|cpu] [--no-capture] \
        [--link-rtt-ms 15 [--link-jitter-ms 1] [--link-bw-gbps 1]] \
        [--mode-policy auto|distributed|fused|pipeline] [--json]

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --target zamba2-1.2b --draft mamba2-130m --full-size

Beside the reference's flags the port has ``--device`` (the card by
default), ``--paged-kv``/``--kv-pool-blocks`` (the serving config's paged
pool), ``--no-capture`` and ``--full-size`` (the published widths and
depths in their published dtype: ``build_deployment(reduced=False)``;
reduced same-family configs otherwise). Weights are random, drawn on the
device per node from the spec's seed (``--seed``;
:func:`repro_torch.topology.node_seed`: a one-pair spec's draft from
``seed``, its target from ``seed + 1``). ``--target``/``--draft`` take any
config of the zoo: dense (qwen, llama2, deepseek, command-r), moe
(arctic-480b, llama4-maverick), ssm (mamba2-130m) and hybrid
(zamba2-1.2b); a pair with an ssm or hybrid side runs the engine's split
step. The servers admit per slot, so an encdec (whisper-tiny) or vlm
(internvl2-76b) side is refused at the first admission, as in the
reference (their waves go through ``SpecDecodeEngine.generate(frontend=)``).
``--paged-kv`` pages only the attention-family sides that page (dense,
moe) and refuses a pair with none.
``--arrival-rate`` draws Poisson arrivals (requests/s); TTFT and e2e
include queue wait. ``--temperature`` > 0 samples (kernels B3 every
round).

On the card every session step is captured once as a CUDA graph and
replayed (``captured_graphs`` 2 for a colocated continuous server: one
round step, one insert; ``graph_replays`` = rounds + admissions − the two
warm-ups); ``--no-capture`` runs them eagerly for comparison.

``--link-rtt-ms`` splits the pair at the wire: the rounds run as
draft→verify→verdict exchanges between the engine's split workers over a
transport — 0 is the zero-delay in-process transport, more is an emulated
edge–cloud link of that RTT, ``--link-jitter-ms`` jitter and
``--link-bw-gbps`` bandwidth (wall-clock sleeps of the sampled delays; the
summary's ``link_recent_rtt_ms`` is the measured RTT). ``--mode-policy``
honors the window policy's fused/distributed decision (auto), forces one
mode, or (``pipeline``, which needs a link) honors it and overlaps window
k+1's draft with window k's verdict; the pair's ``pipeline_hits``/
``pipeline_misses`` show in ``pairs``. Captured worker steps: insert,
propose, verify (+ advance for an ssm draft, + ingest once a fused round
ran); pipelined: insert, propose, speculative propose, verify (+
checkpoint and rollback for an ssm draft).

A topology whose workload declares a fleet ``trace`` (request classes with
per-class lengths and TTFT/TPOT SLOs, a load shape;
``examples/fleet_cluster.json``) serves that trace's stream —
:func:`repro_torch.fleet.workload.generate_requests` through
:func:`~repro_torch.fleet.workload.fleet_serve_requests`, the stream
:func:`repro_torch.topology.build_simulation` replays — and the summary's
``slo`` block grades it (:func:`~repro_torch.fleet.workload.slo_report`).
``serving.router: "smart"`` routes by link, acceptance and occupancy.

A topology with ``process: true`` pairs spawns two worker hosts per pair
(:mod:`repro_torch.distributed.host`, on ``--device``); the summary's
``pairs`` then carry each host pair's row. ``--server wave`` serves the
single colocated pair wave by wave (the measured baseline).
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np

from ..configs import ARCHS
from ..serving import ServeRequest
from ..topology import ClusterSpec, build_deployment, one_pair_spec


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--topology", default=None, metavar="cluster.json",
                    help="declarative ClusterSpec (nodes + draft→target "
                         "pairs with per-pair links/policies); replaces "
                         "the one-pair flags below")
    ap.add_argument("--target", default="qwen3-14b", choices=sorted(ARCHS))
    ap.add_argument("--draft", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--policy", default="static",
                    choices=["static", "dynamic", "awc"])
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--requests", type=int, default=None,
                    help="request count (default: topology workload, or 8)")
    ap.add_argument("--max-new", type=int, default=None,
                    help="tokens per request (default: topology workload, "
                         "or 32)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--server", default="continuous",
                    choices=["continuous", "wave"],
                    help="continuous slot scheduler vs wave-batched baseline")
    ap.add_argument("--arrival-rate", type=float, default=None,
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
                         "decision (auto) or force one mode; 'pipeline' "
                         "honors the decision AND overlaps window k+1's "
                         "draft with window k's verdict (needs "
                         "--link-rtt-ms)")
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


def spec_from_args(args) -> ClusterSpec:
    """``--topology`` loads the file (workload flags passed explicitly
    override its workload section); otherwise the one-pair flags map to
    :func:`one_pair_spec`."""
    if args.topology:
        spec = ClusterSpec.load(args.topology)
    else:
        spec = one_pair_spec(
            target=args.target, draft=args.draft, policy=args.policy,
            gamma=args.gamma, gamma_max=args.gamma_max,
            max_batch=args.max_batch, sync_every=args.sync_every,
            temperature=args.temperature, rtt_ms=args.rtt_ms,
            link_rtt_ms=args.link_rtt_ms,
            link_jitter_ms=args.link_jitter_ms,
            link_bw_gbps=args.link_bw_gbps, mode_policy=args.mode_policy,
            server=args.server, seed=args.seed)
    if args.requests is not None:
        spec.workload.num_requests = args.requests
    if args.max_new is not None:
        spec.workload.max_new = args.max_new
    if args.arrival_rate is not None:
        spec.workload.rate_per_s = args.arrival_rate
    return spec.validate()


def spec_requests(spec: ClusterSpec, vocab: int) -> list:
    """The request stream of a spec's workload: its fleet trace's stream
    (class, SLOs and arrival per request; the stream
    :func:`~repro_torch.topology.build_simulation` replays), else the flat
    surface's seeded prompts and Poisson arrivals."""
    wl = spec.workload
    if wl.trace is not None:
        from ..fleet.workload import fleet_serve_requests, generate_requests
        return fleet_serve_requests(generate_requests(wl.trace), vocab,
                                    seed=spec.seed)
    rng = np.random.default_rng(spec.seed)
    arrival = 0.0
    requests = []
    for i in range(wl.num_requests):
        plen = int(rng.integers(wl.prompt_lo, wl.prompt_hi))
        if wl.rate_per_s > 0:
            arrival += float(rng.exponential(1.0 / wl.rate_per_s))
        requests.append(ServeRequest(
            i, rng.integers(0, vocab, plen).astype(np.int32), wl.max_new,
            arrival_s=arrival))
    return requests


@dataclass
class ServeRun:
    summary: dict
    results: list          # list[ServeResult], in retirement order
    server: object         # SpecDecodeServer | WaveSpecDecodeServer
    requests: list         # list[ServeRequest], in submission order
    deployment: object     # repro_torch.topology.Deployment


def run(argv=None, *, node_params=None) -> ServeRun:
    """Build the deployment, serve the generated request stream,
    summarize; the worker hosts of process-backed pairs are stopped before
    this returns. ``node_params`` (node id → port params) replaces the
    weights drawn from the seed, as in
    :func:`~repro_torch.topology.build_deployment`."""
    args = parse_args(argv)
    if args.link_rtt_ms is not None and args.server == "wave":
        raise SystemExit("--link-rtt-ms needs the continuous server "
                         "(the wave baseline is colocated-only)")
    if args.mode_policy == "pipeline" and args.link_rtt_ms is None \
            and not args.topology:
        raise SystemExit("--mode-policy pipeline overlaps rounds across a "
                         "transport; pass --link-rtt-ms (0 = in-process)")
    spec = spec_from_args(args)
    deployment = build_deployment(spec, reduced=not args.full_size,
                                  device=args.device,
                                  node_params=node_params)
    try:
        server = deployment.build_server(
            paged_kv=args.paged_kv, kv_pool_blocks=args.kv_pool_blocks,
            capture=False if args.no_capture else None)
        requests = spec_requests(spec, deployment.vocab)
        for r in requests:
            server.submit(r)
        t0 = time.perf_counter()
        results = server.run()
        wall = time.perf_counter() - t0
    finally:
        # the hosts' last wave stats stay cached on their handles, so the
        # summaries below still read
        deployment.shutdown()

    engines = list({id(p.engine): p.engine for p in deployment.pairs
                    if p.engine is not None}.values())
    pairs = (server.pair_summaries() if hasattr(server, "pair_summaries")
             else {})
    tokens = int(sum(len(r.tokens) for r in results))
    cfgs = deployment.node_configs
    p0 = spec.pairs[0]
    summary = {
        "server": spec.serving.server,
        "topology": args.topology or "one-pair(flags)",
        "pairs_deployed": len(deployment.pairs),
        "device": str(engines[0].device) if engines else args.device,
        "target": cfgs[p0.target].name,
        "draft": cfgs[p0.draft].name,
        "temperature": spec.serving.temperature,
        "paged_kv": bool(args.paged_kv),
        "requests": len(results),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall if wall > 0 else 0.0,
        "iterations": sum(d.get("iterations", 0) for d in pairs.values()),
        "mean_acceptance": float(np.mean([r.acceptance_rate
                                          for r in results])),
        "mean_ttft_ms": float(np.mean([r.ttft_ms for r in results])),
        "mean_queue_ms": float(np.mean([r.queue_ms for r in results])),
        "mean_tpot_ms": float(np.mean([r.tpot_ms for r in results])),
        "mean_e2e_ms": float(np.mean([r.e2e_ms for r in results])),
        "step_programs": sum(e.step_programs() for e in engines),
        "captured_graphs": sum(e.graphs.captured for e in engines),
        "graph_replays": sum(e.graphs.replays for e in engines),
        "graph_warm_ups": sum(e.graphs.warm_ups for e in engines),
        "pairs": pairs,
    }
    if not args.topology:
        summary["policy"] = args.policy
    if spec.workload.trace is not None:
        from ..fleet.workload import serve_results_rows, slo_report
        summary["slo"] = slo_report(serve_results_rows(results))
    tr = deployment.pairs[0].transport
    if len(deployment.pairs) == 1 and tr is not None:
        # the one-pair launcher's flat link keys
        summary.update(
            transport=tr.describe(), mode_policy=p0.mode_policy,
            link_bytes_sent=tr.bytes_sent, link_messages=tr.messages_sent,
            link_recent_rtt_ms=round(tr.recent_rtt_ms, 3))
    return ServeRun(summary=summary, results=results, server=server,
                    requests=requests, deployment=deployment)


def main(argv=None) -> int:
    args = parse_args(argv)
    s = run(argv).summary
    if args.json:
        print(json.dumps(s, indent=1))
    else:
        per_pair = ""
        if s["pairs_deployed"] > 1:
            per_pair = "  " + "  ".join(
                f"[{pid}: n={d['requests']} acc="
                f"{d.get('acceptance_rate', 0.0):.2f}"
                + (f" γ={d['mean_gamma']:.2f}" if "mean_gamma" in d
                   else " process") + "]"
                for pid, d in s["pairs"].items())
        print(f"served {s['requests']} requests on {s['device']}  "
              f"server={s['server']}  pairs={s['pairs_deployed']}  "
              f"tokens={s['tokens']}  tok/s={s['tokens_per_s']:.1f}  "
              f"acceptance={s['mean_acceptance']:.3f}  "
              f"ttft={s['mean_ttft_ms']:.1f}ms  "
              f"tpot={s['mean_tpot_ms']:.1f}ms  "
              f"e2e={s['mean_e2e_ms']:.0f}ms  "
              f"programs={s['step_programs']}  "
              f"graphs={s['captured_graphs']}"
              + (f"  slo={s['slo']['attainment']:.2f}"
                 if s.get("slo", {}).get("graded") else "")
              + (f"  link={s['transport']} rtt="
                 f"{s['link_recent_rtt_ms']:.2f}ms "
                 f"messages={s['link_messages']}" if "transport" in s
                 else "") + per_pair)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
