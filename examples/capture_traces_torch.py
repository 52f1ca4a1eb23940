"""Close the paper's trace loop with the PyTorch port: capture
ground-truth acceptance sequences from real draft/target models, write
them in the Table-1 trace schema, and replay them through DSD-Sim. The
port's form of ``examples/capture_traces.py``.

On the card unless ``--device cpu``; the flags shrink the run:

    PYTHONPATH=src python examples/capture_traces_torch.py [--device cpu] \\
        [--requests 8] [--max-new 24] [--out captured_traces.jsonl]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.window import StaticWindowPolicy
from repro_torch.sim import (ClusterSpec, DSDSimulation, LinkSpec,
                             PolicyStack, TraceRecord, load_trace,
                             save_trace)
from repro_torch.sim.policies import (BatchingConfig, JSQRouting,
                                      LengthAwareBatching)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--out", default=None,
                    help="trace file (default: in a temporary directory)")
    args = ap.parse_args(argv)

    target_cfg = get_config("deepseek-7b").reduced()
    # the draft shares the target family (distilled-style pairing); heads
    # of 64, a head size the port's decode-attention kernels take
    draft_cfg = dataclasses.replace(target_cfg, n_layers=2, d_model=128,
                                    n_heads=2, n_kv_heads=2, head_dim=64,
                                    d_ff=256, name="deepseek-draft")
    engine = SpecDecodeEngine(draft_cfg, target_cfg, temperature=1.0,
                              seed=0, device=args.device)

    rng = np.random.default_rng(0)
    n_req, plen = args.requests, 12
    prompts = rng.integers(0, target_cfg.vocab, (n_req, plen)
                           ).astype(np.int32)
    print(f"capturing acceptance traces from real models on "
          f"{engine.device}...")
    seqs = engine.capture_traces(prompts, max_new_tokens=args.max_new,
                                 gamma=6)

    records = []
    t = 0.0
    for i, bits in enumerate(seqs):
        t += float(rng.exponential(50.0))
        records.append(TraceRecord(
            request_id=i, prompt_length=plen, output_length=args.max_new,
            acceptance_seq=bits, arrival_time_ms=t,
            drafter_id=i % 8, dataset="captured"))
        print(f"  req {i}: alpha={np.mean(bits):.3f} bits={len(bits)}")
    with tempfile.TemporaryDirectory() as tmp:
        path = args.out or os.path.join(tmp, "captured_traces.jsonl")
        save_trace(records, path)
        print(f"saved {len(records)} records (Table-1 schema)")
        replay = load_trace(path)
        assert [r.acceptance_seq for r in replay] == \
            [r.acceptance_seq for r in records]

    cluster = ClusterSpec(num_targets=2, num_drafters=8,
                          link=LinkSpec(rtt_ms=10.0))
    sim = DSDSimulation(cluster, PolicyStack(
        routing=JSQRouting(), batching=LengthAwareBatching(),
        batching_cfg=BatchingConfig(max_batch=8),
        window=StaticWindowPolicy(4)), replay)
    s = sim.run().summary()
    print(f"replayed through DSD-Sim: thpt={s['throughput_rps']:.2f} r/s "
          f"tpot={s['tpot_ms']['mean']:.1f} ms "
          f"acceptance={s['acceptance_rate']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
