"""Quickstart of the PyTorch port: distributed speculative decoding in a
page. The port's form of ``examples/quickstart.py``.

Builds a reduced draft/target pair, serves a batch of prompts through the
port's engine under three window policies (static γ / dynamic / AWC),
then runs the same policy comparison at cluster scale in DSD-Sim. On the
card unless ``--device cpu``; the flags shrink the run:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] \\
        [--requests 4] [--max-new 32] [--sim-requests 80]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.awc.model import default_predictor
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.window import (AWCWindowPolicy, DynamicWindowPolicy,
                                     StaticWindowPolicy)
from repro_torch.sim import simulate_from_yaml


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=4,
                    help="sequences in the engine's batch")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--sim-requests", type=int, default=80)
    args = ap.parse_args(argv)

    # --- real-model engine (reduced configs; full configs go through the
    # dry-run, repro_torch.launch.dryrun) -------------------------------
    target_cfg = get_config("qwen3-14b").reduced()
    draft_cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                                    vocab=target_cfg.vocab)
    engine = SpecDecodeEngine(draft_cfg, target_cfg, temperature=1.0,
                              rtt_ms=10.0, seed=0, device=args.device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, target_cfg.vocab,
                           (args.requests, 16)).astype(np.int32)

    print(f"=== real-model engine on {engine.device} (temp 1.0; "
          f"{args.requests} sequences, {args.max_new} new tokens) ===")
    # gamma_max=12 builds ONE masked-window step (one captured graph on
    # the card) that all three policies reuse: varying γ captures nothing
    for policy in (StaticWindowPolicy(4), DynamicWindowPolicy(),
                   AWCWindowPolicy(default_predictor())):
        tokens, stats = engine.generate(prompts, args.max_new, policy,
                                        seed=1, gamma_max=12)
        assert tokens.shape == (args.requests, args.max_new)
        print(f"  {policy.name():10s} acceptance={stats.acceptance_rate:.3f} "
              f"tokens/iter={stats.tokens_per_iteration:.2f} "
              f"iters={stats.iterations} "
              f"step_programs={engine.step_programs()} "
              f"graphs={engine.graphs.captured}")

    # --- cluster-scale simulation (DSD-Sim) -----------------------------
    print("=== DSD-Sim: 2 cloud targets, 64 edge drafters, GSM8K ===")
    for window in ("static, gamma: 4", "dynamic", "awc"):
        summary = simulate_from_yaml(f"""
cluster:
  targets: {{count: 2, hw: A100, model: llama2-70b, tp: 4}}
  drafters: {{count: 64, hw: A40, model: llama2-7b}}
  link: {{rtt_ms: 10, jitter_ms: 1}}
policies:
  routing: jsq
  batching: {{kind: lab, max_batch: 16}}
  window: {{kind: {window.split(',')[0]}, gamma: 4}}
workload: {{dataset: gsm8k, rate_per_s: 40, num_requests: {args.sim_requests}, seed: 0}}
""").summary()
        print(f"  {window.split(',')[0]:10s} "
              f"thpt={summary['throughput_rps']:.2f} r/s  "
              f"tpot={summary['tpot_ms']['mean']:.1f} ms  "
              f"gamma={summary['mean_gamma']:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
