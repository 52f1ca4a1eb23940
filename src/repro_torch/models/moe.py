"""Mixture-of-Experts FFN — GShard-style capacity dispatch (the reference
``repro/models/moe.py``).

Tokens are grouped per batch row and each expert takes at most ``c =
ceil(S/E · cf · k)`` of a row's tokens. Dispatch and combine are one-hot
(B, S, E, c) tensors and the expert products batched einsums over the
expert axis, in plain PyTorch: the reference computes them in plain jnp
outside any Pallas kernel. Top-1 (llama4-maverick) and top-2 (arctic)
routing, arctic's parallel dense-residual MLP, and the aux loss. Tokens
over an expert's capacity contribute zero from the MoE branch.

Numerics follow the reference: the router weights and logits are float32
and so is the softmax; the renormalized top-k gates weight the combine in
float32, cast to the model dtype for the last product.

Ranking: ``lax.top_k`` puts the lowest expert index first among equal
gates; ``torch.topk`` promises no order for ties. The port ranks by k
argmax passes (``torch.argmax`` returns the first maximum), masking each
winner before the next pass, so ties resolve as the reference resolves
them.

Every step is a device op with no host read, so the block runs inside a
captured CUDA graph like the rest of a decode step.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from .layers import dense_init, swiglu


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                    n_layers: int) -> dict:
    """Layer-stacked (L, ...) MoE weights, reference layout: router (L, D,
    E) float32, w_gate/w_up (L, E, D, F), w_down (L, E, F, D), and for a
    dense residual res_gate/res_up (L, D, F), res_down (L, F, D)."""
    d, f, e, L = cfg.d_model, cfg.d_ff, cfg.n_experts, n_layers
    p = {
        "router": dense_init(gen, (L, d, e), torch.float32, device, fan_in=d),
        "w_gate": dense_init(gen, (L, e, d, f), dtype, device, fan_in=d),
        "w_up": dense_init(gen, (L, e, d, f), dtype, device, fan_in=d),
        "w_down": dense_init(gen, (L, e, f, d), dtype, device, fan_in=f),
    }
    if cfg.moe_dense_residual:
        p["res_gate"] = dense_init(gen, (L, d, f), dtype, device, fan_in=d)
        p["res_up"] = dense_init(gen, (L, d, f), dtype, device, fan_in=d)
        p["res_down"] = dense_init(gen, (L, f, d), dtype, device, fan_in=f)
    return p


def capacity(seq: int, n_experts: int, k: int, cf: float) -> int:
    return max(1, int(math.ceil(seq / n_experts * cf * k)))


def top_k_lowest_first(gates: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries on the last axis, in
    descending order, the lowest index first among equal values (the order
    ``lax.top_k`` gives): k argmax passes, each winner masked out."""
    rest = gates.clone()
    vals, idx = [], []
    for _ in range(k):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        vals.append(torch.gather(gates, -1, i))
        idx.append(i)
        rest.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def dispatch_plan(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """The routing of one (B, S, D) group batch: float32 gates (B, S, E),
    the top-k expert ids (B, S, k), the (B, S, E, c) dispatch one-hots in
    the model dtype and the float32 combine weights. Ranks fill capacity in
    sequence: rank r's position in an expert counts the row's earlier
    tokens of that rank (a cumsum) plus every token the earlier ranks sent
    there."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    c = capacity(S, E, k, cfg.capacity_factor)
    logits = x.float() @ router                               # (B, S, E)
    gates = torch.softmax(logits, dim=-1)
    top_gate, top_idx = top_k_lowest_first(gates, k)
    top_gate = top_gate / top_gate.sum(-1, keepdim=True).clamp_min(1e-9)
    experts = torch.arange(E, device=x.device)
    slots = torch.arange(c, device=x.device)
    counts = torch.zeros((B, E), dtype=torch.int32, device=x.device)
    dispatch = torch.zeros((B, S, E, c), dtype=x.dtype, device=x.device)
    combine = torch.zeros((B, S, E, c), dtype=torch.float32, device=x.device)
    for r in range(k):
        onehot = (top_idx[..., r, None] == experts).to(torch.int32)
        pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot \
            + counts[:, None, :]
        keep = (pos < c) & (onehot > 0)
        slot = (pos.clamp(0, c - 1)[..., None] == slots).to(x.dtype)
        disp_r = keep[..., None].to(x.dtype) * slot
        dispatch = dispatch + disp_r
        combine = combine + disp_r.float() * top_gate[..., r, None, None]
        counts = counts + onehot.sum(dim=1, dtype=torch.int32)
    return gates, top_idx, dispatch, combine


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux loss). One layer's weights ``p``.

    GShard grouping: a sequence longer than ``cfg.moe_group`` and a
    multiple of it is split into groups of that many tokens, each with its
    own capacity (the reference's rule; otherwise the dispatch tensor grows
    with S²)."""
    B0, S0, D = x.shape
    g = cfg.moe_group or 4096
    grouped = S0 > g and S0 % g == 0
    if grouped:
        x = x.reshape(B0 * (S0 // g), g, D)
    E = cfg.n_experts
    gates, top_idx, dispatch, combine = dispatch_plan(x, p["router"], cfg)
    xe = torch.einsum("bsec,bsd->ebcd", dispatch, x)
    gt = torch.einsum("ebcd,edf->ebcf", xe, p["w_gate"])
    up = torch.einsum("ebcd,edf->ebcf", xe, p["w_up"])
    h = torch.nn.functional.silu(gt.float()).to(x.dtype) * up
    yo = torch.einsum("ebcf,efd->ebcd", h, p["w_down"])
    y = torch.einsum("ebcd,bsec->bsd", yo, combine.to(x.dtype))
    if cfg.moe_dense_residual:
        y = y + swiglu(x, p["res_gate"], p["res_up"], p["res_down"])
    me = gates.mean(dim=(0, 1))
    fe = (top_idx[..., 0, None] == torch.arange(E, device=x.device)
          ).float().mean(dim=(0, 1))
    aux = E * (me * fe).sum()
    if grouped:
        y = y.reshape(B0, S0, D)
    return y, aux


def dropped_assignments(x: torch.Tensor, router: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """Expert assignments of ``x`` (B, S, D) that capacity dropped: B·S·k
    minus the dispatched ones (a device scalar; no grouping)."""
    _, top_idx, dispatch, _ = dispatch_plan(x, router, cfg)
    return top_idx.numel() - dispatch.float().sum()
