"""AdamW with decoupled weight decay, global-norm gradient clipping and a
cosine learning-rate schedule, the port of the reference
``repro/training/optimizer.py``.

Parameters, gradients and moments are trees of tensors: nested dicts
(walked in sorted key order, as ``jax.tree`` walks them) and tuples or
NamedTuples. The arithmetic is the reference's: moments are kept in
``state_dtype`` or else the parameter's dtype and updated in float32, the
bias corrections and the schedule are float32, and the clipped gradient
stays float32 inside the update. Unlike the reference, which returns new
arrays, :func:`adamw_update` writes parameters and moments in place under
``torch.no_grad()`` (and returns them for the reference's calling
convention); the step counter is a device scalar, so an update never reads
the device from the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch


def tree_leaves(tree: Any) -> list:
    """The tensors of a tree of dicts (sorted keys), tuples and lists."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure, in the
    order of :func:`tree_leaves` (dicts come back with sorted keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32, on the parameters' device
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # dtype of the moment accumulators (None: each parameter's own); bf16
    # halves the optimizer's memory
    state_dtype: Optional[torch.dtype] = None
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio``·base_lr at ``total``; float32 throughout."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(1, warmup), max=1.0)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * warm * cos
    return fn


def adamw_init(params: Any, cfg: AdamWConfig) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros_like(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype or p.dtype,
                           device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros_like, params),
                      nu=tree_map(zeros_like, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 cfg: AdamWConfig) -> tuple[Any, AdamWState]:
    """One AdamW step: writes ``params``, ``state.mu`` and ``state.nu`` in
    place and returns them with the advanced step counter."""
    step = state.step + 1
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr
    scale = None
    if cfg.grad_clip and cfg.grad_clip > 0:
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g32 = g.to(torch.float32)
        if scale is not None:
            g32 = g32 * scale
        m32 = m.to(torch.float32) * cfg.b1 + (1 - cfg.b1) * g32
        v32 = v.to(torch.float32) * cfg.b2 + (1 - cfg.b2) * g32 * g32
        p32 = p.to(torch.float32)
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
