"""Training launcher of the PyTorch port (the reference's
``repro/launch/train.py``).

Two modes:

- default (host): trains ``--arch`` on the synthetic LM pipeline with AdamW and a cosine
schedule: by default its REDUCED variant (``cfg.reduced()``, optionally
resized by ``--d-model``/``--layers``), with ``--full`` the published
config in its published dtype, on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 100 --batch 8 --seq 256 [--full] [--device cuda|cpu] \\
        [--micro-steps 2] [--ckpt out.npz]

- ``--production-lower``: the full-size train step at ``train_4k`` against
  the single-pod production mesh, traced on the meta device
  (:func:`repro_torch.launch.dryrun.run_one`): prints its dry-run row, the
  per-device memory and FLOPs, and exits 1 if the row failed. Nothing is
  allocated and no card is needed:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --production-lower

Beside the reference's flags the port has ``--device`` and lets
``--layers`` cut the depth of a ``--full`` config too (published widths,
fewer layers). Weights are random from seed 0 (a ``torch.Generator``: not
the reference's draws). On the card every Mamba2 block's scan runs in
kernel B5 and its gradient in ``ssd_scan_bwd``. The reference documents
``--production-lower`` and its parser lacks the flag; the port's runs the
dry-run's ``train_4k`` row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..kernels import resolve_device
from ..models.model import build_model
from ..training import (AdamWConfig, DataConfig, SyntheticLM, checkpoint,
                        cosine_schedule, init_train_state, make_train_step)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: reduced smoke variant)")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override d_model of the reduced config (e.g. a "
                         "~100M-param draft model)")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the depth (reduced or --full)")
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--production-lower", action="store_true",
                    help="trace the full-size train_4k step on the meta "
                         "device against the production mesh and print "
                         "its dry-run row")
    return ap.parse_args(argv)


def config_of(args: argparse.Namespace):
    """The model config the flags name (the reference's rules, plus
    ``--layers`` under ``--full``)."""
    cfg = get_config(args.arch)
    over = {}
    if not args.full:
        cfg = cfg.reduced()
        if args.d_model:
            heads = max(1, args.d_model // 64)
            over = dict(d_model=args.d_model, n_heads=min(heads, 16),
                        n_kv_heads=min(heads, 16),
                        head_dim=args.d_model // min(heads, 16),
                        d_ff=args.d_model * 4)
    if args.layers:
        over["n_layers"] = args.layers
    return dataclasses.replace(cfg, **over) if over else cfg


def run(args: argparse.Namespace, after_steps=None) -> dict:
    """Train as the flags say; print the reference's step lines and return
    a summary: losses per step, s/step (the steps after the first),
    tokens/s, peak device memory (the card only) and the device.
    ``after_steps``, if given, is called once the timed steps are done with
    a function that runs one more step on the next batch (a profiler's
    window); that step is in no number of the summary."""
    dev = resolve_device(args.device)
    cfg = config_of(args)
    model = build_model(cfg, dev)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"layers={cfg.n_layers} d={cfg.d_model}", flush=True)
    opt = AdamWConfig(lr=args.lr,
                      schedule=cosine_schedule(args.lr, warmup=20,
                                               total=args.steps))
    state = init_train_state(model, 0, opt)
    step = make_train_step(model, opt, micro_steps=args.micro_steps)
    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, batch=args.batch, seed=0,
        frontend_tokens=(cfg.n_frontend_tokens
                         if cfg.arch_type in ("vlm", "encdec") else 0),
        frontend_dim=cfg.d_model))
    it = data.batches()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, walls = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in next(it).items()}
        state, m = step(state, batch)
        losses.append(m["loss"])
        if cuda:
            torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        if (i + 1) % args.log_every == 0 or i == 0:
            print(f"step {m['step']:5d}  loss {float(m['loss']):.4f}  "
                  f"ce {float(m['ce']):.4f}  aux {float(m['aux']):.4f}  "
                  f"({walls[-1] / (i + 1):.2f}s/step)", flush=True)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    if after_steps is not None:
        def one_step() -> None:
            nonlocal state
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in next(it).items()}
            state, _ = step(state, batch)
            if cuda:
                torch.cuda.synchronize(dev)
        after_steps(one_step)
    if args.ckpt:
        checkpoint.save(state.params, args.ckpt)
        print("saved", args.ckpt, flush=True)
    losses = [float(l) for l in losses]
    steady = ((walls[-1] - walls[0]) / (len(walls) - 1) if len(walls) > 1
              else walls[-1] if walls else float("nan"))
    return {"arch": cfg.name, "params": cfg.param_count(),
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "remat": cfg.remat, "batch": args.batch,
            "seq": args.seq, "steps": args.steps,
            "micro_steps": args.micro_steps, "losses": losses,
            "first_step_s": walls[0] if walls else None,
            "s_per_step": steady,
            "tokens_per_s": args.batch * args.seq / steady,
            "peak_mem_gb": peak,
            "device": str(dev)}


def production_lower(args: argparse.Namespace) -> int:
    from .dryrun import format_row, run_one
    row = run_one(args.arch, "train_4k", "single")
    print(format_row(row), flush=True)
    print(json.dumps(row), flush=True)
    return 0 if row["ok"] else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.production_lower:
        return production_lower(args)
    s = run(args)
    print(f"loss {s['losses'][0]:.4f} -> {s['losses'][-1]:.4f}  "
          f"{s['s_per_step']:.3f} s/step  {s['tokens_per_s']:.0f} tokens/s"
          + (f"  peak {s['peak_mem_gb']:.2f} GiB" if s["peak_mem_gb"]
             else ""), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
