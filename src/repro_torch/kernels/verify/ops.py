"""Glue of the verify kernels, the port of the reference glue
``repro/kernels/verify/ops.py``:

- :func:`verify_window_fused` — sampled verify: B3a (gather + residual
  mass), the O(BΓ) acceptance rule in torch on the device, then B3b
  (inverse-CDF sample);
- :func:`tree_verify_fused` — greedy tree verify: B4a (per-entry target
  argmax) then B4b (accept rule).

The CUDA kernels take any V, so no vocab padding is needed."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ref import VerifyOut
from .tree import tree_accept, tree_argmax
from .verify import cdf_sample, gather_reduce

# a residual mass at or below this is empty and the row samples p itself
# (the reference glue's ``eps``, repro/kernels/verify/ops.py:21)
_EMPTY_RESIDUAL_EPS = 1e-12


class Selection(NamedTuple):
    """The O(BΓ) acceptance glue between the two passes."""
    accept: torch.Tensor    # (B, Γ) bool
    n_acc: torch.Tensor     # (B,) int32
    jrow: torch.Tensor      # (B,) int32 p row to sample
    qrow: torch.Tensor      # (B,) int32 q row of the residual
    use_p: torch.Tensor     # (B,) int32: sample p_jrow itself
    thresh: torch.Tensor    # (B,) float32 r · total


def select_rows(p_at: torch.Tensor, q_at: torch.Tensor, mass: torch.Tensor,
                u: torch.Tensor, r: torch.Tensor,
                active_gamma: Optional[torch.Tensor] = None) -> Selection:
    """From pass A's (p_at, q_at, mass) and the uniforms: which positions
    are accepted and which row pass B samples, at which threshold. With
    ``active_gamma=None`` this is the reference glue line for line; a 0-d
    or (B,) int ``active_gamma`` applies the engine rule's masking
    (``repro/core/specdec.py::verify_window``): positions ≥ ag are
    rejected, the window counts as all accepted at n_acc == ag and then
    samples p row ag, and the residual's q row is min(n_acc, ag − 1)
    clamped to ≥ 0 (ag = 0, a fused round, samples p row 0)."""
    B, gamma = p_at.shape
    dev = p_at.device
    accept = u < torch.clamp(p_at / q_at.clamp_min(1e-20), max=1.0)
    if active_gamma is None:
        ag = torch.full((B,), gamma, dtype=torch.int32, device=dev)
    else:
        ag = active_gamma.to(torch.int32).reshape(-1).expand(B)
        accept = accept & (torch.arange(gamma, device=dev)[None, :]
                           < ag[:, None])
    n_acc = torch.cumprod(accept.to(torch.int32), dim=-1).sum(
        dim=-1, dtype=torch.int32)
    all_acc = n_acc == ag
    jrow = torch.where(all_acc, ag, n_acc)
    qrow = torch.minimum(n_acc, ag - 1).clamp_min(0)
    mass_j = torch.gather(mass, 1, qrow[:, None].long())[:, 0]
    use_p = all_acc | (mass_j <= _EMPTY_RESIDUAL_EPS)
    # p rows sum to ~1: the reference glue takes total = 1 on that branch
    total = torch.where(use_p, torch.ones_like(mass_j), mass_j)
    return Selection(accept=accept, n_acc=n_acc, jrow=jrow.contiguous(),
                     qrow=qrow.contiguous(), use_p=use_p.to(torch.int32),
                     thresh=(r.float() * total).contiguous())


def verify_window_fused(draft_tokens: torch.Tensor,   # (B, Γ) int32
                        q_probs: torch.Tensor,        # (B, Γ, V)
                        p_probs: torch.Tensor,        # (B, Γ+1, V)
                        u: torch.Tensor,              # (B, Γ) uniforms
                        r: torch.Tensor,              # (B,) uniform
                        active_gamma: Optional[torch.Tensor] = None
                        ) -> VerifyOut:
    """The accept–resample rule with explicit uniforms through the kernel
    pair: pass A (B3a), :func:`select_rows` in torch on the device, pass B
    (B3b). ``active_gamma`` as in :func:`select_rows`.

    As in the reference glue, the all-accepted / empty-residual branch
    samples p with total 1 (not Σp): when r·1 lies above a row's float sum
    the token is V − 1, where the oracle's Σp-normalised rule would not be
    (probability ≈ |1 − Σp| per round)."""
    tokens = draft_tokens.to(torch.int32).contiguous()
    p_at, q_at, mass = gather_reduce(tokens, p_probs, q_probs)
    sel = select_rows(p_at, q_at, mass, u, r, active_gamma)
    token = cdf_sample(sel.jrow, sel.qrow, sel.use_p, p_probs, q_probs,
                       sel.thresh)
    return VerifyOut(n_accepted=sel.n_acc, next_token=token,
                     accept_mask=sel.accept)


def tree_verify_fused(tree_tokens: torch.Tensor,   # (B, T) int32
                      p_logits: torch.Tensor,      # (B, T, V) float32
                      parent_entry: torch.Tensor,  # (T,) int32
                      tree_pos: torch.Tensor,      # (T,) int32
                      node_valid: torch.Tensor,    # (T,) bool
                      win_mask: torch.Tensor):     # (T, T) bool
    """(n_accepted, winner, bonus), each (B,) int32 — the verdict of
    :func:`repro_torch.core.tree.verify_tree_greedy`."""
    tgt = tree_argmax(p_logits)
    return tree_accept(tree_tokens, tgt, parent_entry, tree_pos, node_valid,
                       win_mask)
