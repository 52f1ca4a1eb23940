"""WC-DNN supervised training (paper §4.3): L1 regression, AdamW, 100
epochs — the port of the reference ``core/awc/train.py``.

The split and the batch order come from numpy with the reference's seeds,
so from the same initial parameters (``init_params``) the two packages
run the same steps on the same rows. On the card unless ``device="cpu"``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...kernels import resolve_device
from ...training.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                   tree_leaves, tree_map)
from . import model as wcdnn


@dataclass
class TrainConfig:
    hidden: int = 64
    n_blocks: int = 2
    epochs: int = 100
    batch_size: int = 256
    lr: float = 3e-3
    weight_decay: float = 1e-4
    val_frac: float = 0.15
    seed: int = 0


def l1_loss(params, x, y):
    return torch.mean(torch.abs(wcdnn.forward(params, x) - y))


def _train_step(params, opt_state, x, y, lr: float, wd: float):
    """One AdamW step on the L1 loss; the normalization statistics get a
    zero gradient (weight decay still applies to them, as in the
    reference)."""
    loss = l1_loss(params, x, y)
    grads = list(torch.autograd.grad(loss, tree_leaves(params)))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    grads = grads._replace(feat_mean=torch.zeros_like(grads.feat_mean),
                           feat_std=torch.zeros_like(grads.feat_std))
    params, opt_state = adamw_update(grads, opt_state, params,
                                     AdamWConfig(lr=lr, weight_decay=wd))
    return params, opt_state, loss.detach()


def _tensors(params, device) -> wcdnn.WCDNNParams:
    """float32 leaf tensors on ``device`` that require grad."""
    return tree_map(lambda v: torch.as_tensor(
        v if isinstance(v, torch.Tensor) else np.array(v, np.float32),
        dtype=torch.float32).to(device).clone().requires_grad_(True),
        params)


def train(X: np.ndarray, y: np.ndarray, cfg: Optional[TrainConfig] = None,
          init_params: Optional[wcdnn.WCDNNParams] = None, device=None
          ) -> tuple[wcdnn.WCDNNParams, dict]:
    """Fit WC-DNN to (X (N, FEATURE_DIM), y (N,)): a seeded validation
    split, normalization from the training rows, ``cfg.epochs`` epochs of
    shuffled minibatches. ``init_params`` (numpy or tensors) replaces the
    fresh :func:`~.model.init`. Returns (parameters as float32 tensors on
    the device, info: train_l1, val_mae, row counts, the loss history)."""
    cfg = cfg or TrainConfig()
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    n = len(X)
    perm = rng.permutation(n)
    n_val = max(1, int(n * cfg.val_frac))
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    f32 = dict(dtype=torch.float32, device=dev)
    Xtr, ytr = torch.as_tensor(X[tr_idx], **f32), torch.as_tensor(
        y[tr_idx], **f32)
    Xva, yva = torch.as_tensor(X[val_idx], **f32), torch.as_tensor(
        y[val_idx], **f32)

    params = (init_params if init_params is not None else
              wcdnn.init(cfg.seed, hidden=cfg.hidden,
                         n_blocks=cfg.n_blocks, device=dev))
    params = _tensors(params, dev)
    with torch.no_grad():
        params = _tensors(wcdnn.set_normalization(params, Xtr), dev)
    opt_state = adamw_init(params, AdamWConfig(lr=cfg.lr,
                                               weight_decay=cfg.weight_decay))
    n_tr = len(tr_idx)
    bs = min(cfg.batch_size, n_tr)
    history = []
    for _ in range(cfg.epochs):
        order = torch.as_tensor(rng.permutation(n_tr), device=dev)
        losses = []
        for i in range(0, n_tr, bs):
            idx = order[i:i + bs]
            params, opt_state, loss = _train_step(
                params, opt_state, Xtr[idx], ytr[idx], cfg.lr,
                cfg.weight_decay)
            losses.append(float(loss))
        history.append(sum(losses) / len(losses))
    with torch.no_grad():
        val_mae = float(l1_loss(params, Xva, yva))
    params = tree_map(lambda v: v.detach(), params)
    info = {"train_l1": history[-1] if history else float("nan"),
            "val_mae": val_mae, "n_train": int(n_tr), "n_val": int(n_val),
            "history": history}
    return params, info


def train_default_and_save(scenarios=None, path: Optional[str] = None,
                           small: bool = False, device=None
                           ) -> tuple[wcdnn.WCDNNParams, dict]:
    """End-to-end: sweep → dataset → train → save. Without ``path`` it
    writes :data:`~.model.DEFAULT_CKPT`, which :func:`~.model.
    default_predictor` then serves in place of the bootstrap controller."""
    from .dataset import default_grid, generate_dataset
    scenarios = scenarios or default_grid(small=small)
    X, y, _ = generate_dataset(scenarios)
    params, info = train(X, y, TrainConfig(epochs=40 if small else 100),
                         device=device)
    path = path or wcdnn.DEFAULT_CKPT
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wcdnn.save(params, path)
    return params, info
