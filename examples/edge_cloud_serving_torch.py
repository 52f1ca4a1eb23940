"""End-to-end serving example of the PyTorch port, topology-first: ONE
declarative ClusterSpec — 2 edge drafts behind heterogeneous links (fast
LAN, slow WAN) sharing 1 cloud target — builds BOTH the real multi-pair
deployment (``build_deployment`` → SpecDecodeServer with per-pair
transports and per-pair AWC stabilizers) and the matching DSD-Sim run
(``build_simulation``), then holds the fused sampled verify (kernels
B3a/B3b on the card, their plain versions on the CPU) to the
accept–resample rule's reference on the same inputs. The port's form of
``examples/edge_cloud_serving.py``.

On the card unless ``--device cpu``; the flags shrink the run:

    PYTHONPATH=src python examples/edge_cloud_serving_torch.py \\
        [--device cpu] [--requests 8] [--max-new 16]
    PYTHONPATH=src python examples/edge_cloud_serving_torch.py \\
        --topology examples/cluster_2pair.json
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import LAUNCHES, resolve_device
from repro_torch.kernels.verify import verify_reference, verify_window_fused
from repro_torch.serving import ServeRequest
from repro_torch.sim.network import LinkSpec
from repro_torch.topology import (ClusterSpec, NodeSpec, PairSpec,
                                  ServingSpec, WindowSpec, WorkloadSpec,
                                  build_deployment, build_simulation)


def default_spec() -> ClusterSpec:
    """2 edge drafts → 1 cloud target over heterogeneous links, AWC window
    control per pair (the reference example's spec)."""
    return ClusterSpec(
        nodes=[
            NodeSpec("edge-lan", "draft", "qwen2.5-3b", device="edge-nic"),
            NodeSpec("edge-wan", "draft", "qwen2.5-3b", device="edge-lte"),
            NodeSpec("cloud", "target", "deepseek-7b", device="cloud-pool"),
        ],
        pairs=[
            PairSpec("lan", "edge-lan", "cloud",
                     link=LinkSpec(rtt_ms=2.0, jitter_ms=0.3,
                                   name="campus-lan"),
                     window=WindowSpec("awc")),
            PairSpec("wan", "edge-wan", "cloud",
                     link=LinkSpec(rtt_ms=40.0, jitter_ms=3.0,
                                   bandwidth_gbps=0.1, name="metro-wan"),
                     window=WindowSpec("awc")),
        ],
        serving=ServingSpec(max_batch=2, gamma_max=8, sync_every=4),
        workload=WorkloadSpec(num_requests=8, max_new=16))


def check_fused_verify(device) -> bool:
    """The sampled verify through the kernel pair (B3a → select rows → B3b)
    against the plain rule with the same explicit uniforms."""
    V = get_config("deepseek-7b").reduced().vocab
    B, G = 4, 4
    gen = torch.Generator().manual_seed(2)
    p = torch.softmax(torch.randn((B, G + 1, V), generator=gen), -1)
    q = torch.softmax(torch.randn((B, G, V), generator=gen), -1)
    toks = torch.multinomial(q.reshape(-1, V), 1, generator=gen
                             ).reshape(B, G).to(torch.int32)
    u = torch.rand((B, G), generator=gen)
    r = torch.rand((B,), generator=gen)
    ref = verify_reference(toks, q, p, u, r)
    dev = [t.to(device) for t in (toks, q, p, u, r)]
    before = LAUNCHES["gather_reduce"]
    out = verify_window_fused(*dev)
    launched = LAUNCHES["gather_reduce"] - before
    same = bool(torch.equal(ref.n_accepted, out.n_accepted.cpu())
                and torch.equal(ref.next_token, out.next_token.cpu()))
    print(f"fused verify ({'kernel' if launched else 'plain'} on {device}) "
          f"== reference rule: {same}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--topology", default=None,
                    help="ClusterSpec JSON (default: the built-in 2-pair "
                         "edge-cloud example)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--max-new", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = (ClusterSpec.load(args.topology) if args.topology
            else default_spec())
    if args.requests is not None:
        spec.workload.num_requests = args.requests
    if args.max_new is not None:
        spec.workload.max_new = args.max_new
    spec.validate()

    # -- real path: one spec -> engines, transports, policies, server -----
    deployment = build_deployment(spec, device=dev)
    server = deployment.build_server()
    wl = spec.workload
    rng = np.random.default_rng(spec.seed)
    for i in range(wl.num_requests):
        plen = int(rng.integers(wl.prompt_lo, wl.prompt_hi))
        server.submit(ServeRequest(
            i, rng.integers(0, deployment.vocab, plen).astype(np.int32),
            wl.max_new))
    results = server.run()
    assert len(results) == wl.num_requests
    ttft = np.mean([r.ttft_ms for r in results])
    tpot = np.mean([r.tpot_ms for r in results])
    print(f"served={len(results)} pairs={len(deployment.pairs)} "
          f"ttft={ttft:.1f}ms tpot={tpot:.1f}ms")
    for pid, d in server.pair_summaries().items():
        print(f"  pair={pid:4s} requests={d['requests']} "
              f"mean_gamma={d['mean_gamma']:.2f} "
              f"fused_fraction={d['fused_fraction']:.2f} "
              f"measured_rtt={d.get('recent_rtt_ms', 0.0):.1f}ms")

    # -- sim path: the IDENTICAL spec drives DSD-Sim ----------------------
    analyzer = build_simulation(spec).run()
    per_pair: dict[int, list[int]] = {}
    for m in analyzer.requests.values():
        per_pair.setdefault(m.drafter_id, []).extend(m.gamma_sequence)
    for i, p in enumerate(spec.pairs):
        g = per_pair.get(i, [])
        mean_g = float(np.mean(g)) if g else 0.0
        print(f"  sim pair={p.id:4s} mean_gamma={mean_g:.2f}")

    return 0 if check_fused_verify(dev) else 1


if __name__ == "__main__":
    raise SystemExit(main())
