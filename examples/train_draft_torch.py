"""Train a draft model, then measure how training raises speculative
acceptance against a fixed target — the draft-quality knob the paper's α
(acceptance rate) abstracts. The PyTorch port's form of
``examples/train_draft.py``.

Trains a dense target and a small llama-family draft on the synthetic LM
(``repro_torch.training``), then serves one batch of prompts through the
port's ``SpecDecodeEngine`` at temperature 1 with the untrained draft and
with the trained one, and checks that acceptance rose. Runs on the card
unless ``--device cpu``:

    PYTHONPATH=src python examples/train_draft_torch.py [--steps 200] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.window import StaticWindowPolicy
from repro_torch.kernels import resolve_device
from repro_torch.models.model import build_model
from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM,
                                  cosine_schedule, init_train_state,
                                  make_train_step)
from repro_torch.training.optimizer import tree_map


def train_lm(cfg, steps, data_cfg, lr=3e-3, seed=0, device=None):
    """``steps`` AdamW steps of ``cfg`` from ``init_params(seed)`` on the
    synthetic LM. Returns (the trained parameters, detached; the first and
    the last loss)."""
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    opt = AdamWConfig(lr=lr, schedule=cosine_schedule(lr, 20, steps))
    state = init_train_state(model, seed, opt)
    step = make_train_step(model, opt)
    it = SyntheticLM(data_cfg).batches()
    first = last = None
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        state, m = step(state, batch)
        if i == 0:
            first = m["loss"]
        last = m["loss"]
    return (tree_map(lambda p: p.detach(), state.params), float(first),
            float(last))


def configs(d_model: int, layers: int, vocab: int = 512):
    """(target, draft): the reference example's pair, except that the
    draft's heads are 64 wide (d_model // 64 query heads, half as many KV
    heads) where the reference's has 4 heads of d_model // 4: the port's
    decode-attention kernels take head dims 64 and 128."""
    target = ModelConfig(
        name="target", arch_type="dense", n_layers=6, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab=vocab, dtype="float32",
        remat=False)
    heads = max(1, d_model // 64)
    draft = ModelConfig(
        name="draft", arch_type="dense", n_layers=layers, d_model=d_model,
        n_heads=heads, n_kv_heads=max(1, heads // 2),
        head_dim=d_model // heads, d_ff=d_model * 4, vocab=vocab,
        dtype="float32", remat=False)
    return target, draft


def run(steps: int = 200, d_model: int = 128, layers: int = 4,
        device=None) -> dict:
    vocab = 512
    data = DataConfig(vocab=vocab, seq_len=96, batch=8, seed=0)
    target_cfg, draft_cfg = configs(d_model, layers, vocab)
    print(f"target params: {target_cfg.param_count()/1e6:.1f}M, "
          f"draft params: {draft_cfg.param_count()/1e6:.1f}M", flush=True)
    print("training target on synthetic LM...", flush=True)
    tparams, f0, f1 = train_lm(target_cfg, steps, data, seed=1,
                               device=device)
    print(f"  target loss {f0:.3f} -> {f1:.3f}", flush=True)
    print("training draft on the same distribution...", flush=True)
    dparams, g0, g1 = train_lm(draft_cfg, steps, data, seed=2,
                               device=device)
    print(f"  draft  loss {g0:.3f} -> {g1:.3f}", flush=True)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab, (4, 16)).astype(np.int32)
    untrained = SpecDecodeEngine(draft_cfg, target_cfg,
                                 target_params=tparams, temperature=1.0,
                                 seed=3, device=device)
    _, s0 = untrained.generate(prompts, 32, StaticWindowPolicy(4), seed=4)
    trained = SpecDecodeEngine(draft_cfg, target_cfg, draft_params=dparams,
                               target_params=tparams, temperature=1.0,
                               seed=3, device=device)
    _, s1 = trained.generate(prompts, 32, StaticWindowPolicy(4), seed=4)
    print(f"acceptance untrained draft: {s0.acceptance_rate:.3f} "
          f"({s0.tokens_per_iteration:.2f} tok/iter)")
    print(f"acceptance trained draft:   {s1.acceptance_rate:.3f} "
          f"({s1.tokens_per_iteration:.2f} tok/iter)", flush=True)
    assert s1.acceptance_rate > s0.acceptance_rate, \
        "training the draft on the target's distribution must raise alpha"
    return {"target_loss": [f0, f1], "draft_loss": [g0, g1],
            "acceptance_untrained": s0.acceptance_rate,
            "acceptance_trained": s1.acceptance_rate,
            "tokens_per_iteration": [s0.tokens_per_iteration,
                                     s1.tokens_per_iteration]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.steps, args.d_model, args.layers, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
