"""Training step: cross-entropy LM loss + AdamW update, the port of the
reference ``repro/training/train_step.py``.

``make_train_step`` builds ``train_step(state, batch) -> (state,
metrics)`` closed over the model (the reference's also takes a PRNG key,
which it does not use). Gradients come from
``torch.autograd.grad`` over the parameter leaves (they carry
``requires_grad``; :func:`init_train_state` sets it), and the update runs in
place (:func:`~.optimizer.adamw_update`). On the card every Mamba2 block's
scan and its gradient run in the hand-written kernels (B5 forward,
``ssd_scan_bwd`` backward); ``cfg.remat`` re-runs each layer's forward in
the backward pass (``models/model.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..models.model import Model
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        tree_leaves, tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: int


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions, in float32. labels == -100 are
    ignored, and so are positions where ``mask`` is not positive."""
    valid = labels != -100
    if mask is not None:
        valid = valid & (mask > 0)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def make_loss_fn(model: Model, aux_weight: float = 0.01):
    """``loss_fn(params, batch) -> (loss, (ce, aux))``: ce + aux_weight·aux,
    aux the MoE load-balance loss (0 for the other families)."""
    def loss_fn(params, batch):
        logits, aux = model.forward_train(params, batch)
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        return ce + aux_weight * aux, (ce, aux)
    return loss_fn


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    aux_weight: float = 0.01, micro_steps: int = 1):
    """``micro_steps`` > 1 accumulates gradients over that many equal
    micro-batches of the batch, in order, in the parameter dtype (as the
    reference's scan does), bounding live activation memory; the loss
    terms and gradients are their means."""
    loss_fn = make_loss_fn(model, aux_weight)

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        loss, (ce, aux) = loss_fn(params, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        return (loss.detach(), ce.detach(), aux.detach(),
                tree_map(lambda _: next(grads), params))

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        if micro_steps == 1:
            loss, ce, aux, grads = grad_fn(state.params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // micro_steps
            grads = tree_map(torch.zeros_like, state.params)
            loss = ce = aux = 0.0
            for i in range(micro_steps):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, c, a, g = grad_fn(state.params, mb)
                with torch.no_grad():       # in place: two copies at most
                    for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                        acc.add_(gi)
                del g
                loss, ce, aux = loss + l, ce + c, aux + a
            inv = 1.0 / micro_steps
            grads = tree_map(lambda g: g * inv, grads)
            loss, ce, aux = loss * inv, ce * inv, aux * inv
        params, opt = adamw_update(grads, state.opt, state.params, opt_cfg)
        metrics = {"loss": loss, "ce": ce, "aux": aux,
                   "step": state.step + 1}
        return TrainState(params=params, opt=opt, step=state.step + 1), \
            metrics

    return train_step


def trainable(params: Any) -> Any:
    """``params`` with every leaf a leaf tensor that requires grad."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def init_train_state(model: Model, seed: int, opt_cfg: AdamWConfig,
                     params: Any = None) -> TrainState:
    """Fresh parameters from ``model.init_params(seed)`` (or the given
    ``params``, e.g. bridged reference weights), made trainable, and a
    zeroed optimizer state."""
    params = trainable(model.init_params(seed) if params is None
                       else params)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg),
                      step=0)
