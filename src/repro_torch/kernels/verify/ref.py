"""Plain PyTorch versions of the verify kernels.

- Tree verify: the per-entry target argmax (B4a, ``torch.argmax``: ties to
  the lowest id) and the longest-accepted-root-path rule (B4b).
- Sampled verify: the oracle :func:`verify_reference` (the accept–resample
  rule with explicit uniforms) and the plain versions of the kernel pair,
  :func:`gather_reduce_plain` (B3a) and :func:`cdf_sample_plain` (B3b).

The CPU tests and the engine on CPU tensors run them; on the card
``chip_smoke.py`` holds the kernels to them (B4 exactly; B3 exactly up to
float32 cumsum rounding at a CDF step)."""

from __future__ import annotations

from typing import NamedTuple

import torch


def tree_argmax_plain(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, V) → (B, T) int32 argmax over the vocab."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def accept_rule(tree_tokens: torch.Tensor,   # (B, T) int32
                tgt: torch.Tensor,           # (B, T) int32 target argmax
                parent_entry: torch.Tensor,  # (T,) int32
                tree_pos: torch.Tensor,      # (T,) int32
                node_valid: torch.Tensor,    # (T,) bool
                win_mask: torch.Tensor):     # (T, T) bool ancestor-or-self
    """→ (accept (B, T) bool, n_acc, winner, bonus (B,) int32).

    An entry matches when it is valid and its token is the target's
    argmax at its parent (the anchor always matches); it is accepted when
    every ancestor-or-self matches. The winner is the deepest accepted
    entry, ties to the lowest index (the best-ranked branch); the bonus is
    the target's argmax at the winner."""
    B, T = tree_tokens.shape
    entry = torch.arange(T, device=tree_tokens.device)
    parent_tgt = torch.gather(tgt, 1,
                              parent_entry.long()[None, :].expand(B, T))
    match = (node_valid[None, :] & (tree_tokens == parent_tgt)) \
        | (entry == 0)[None, :]
    accept = (match[:, None, :] | ~win_mask[None, :, :]).all(dim=-1)
    score = torch.where(accept, tree_pos.long()[None, :] * T + (T - entry),
                        torch.full_like(entry, -1)[None, :])
    winner = torch.argmax(score, dim=-1)
    n_acc = tree_pos[winner].to(torch.int32)
    bonus = torch.gather(tgt, 1, winner[:, None])[:, 0].to(torch.int32)
    return accept, n_acc, winner.to(torch.int32), bonus


def tree_accept_plain(tree_tokens, tgt, parent_entry, tree_pos, node_valid,
                      win_mask):
    """The plain version of B4b: (n_acc, winner, bonus)."""
    return accept_rule(tree_tokens, tgt, parent_entry, tree_pos, node_valid,
                       win_mask)[1:]


# --------------------------------------------------------------------------
# Sampled verify (B3): the oracle and the plain versions of the kernel pair
# --------------------------------------------------------------------------

class VerifyOut(NamedTuple):
    n_accepted: torch.Tensor   # (B,) int32
    next_token: torch.Tensor   # (B,) int32
    accept_mask: torch.Tensor  # (B, γ) bool


def verify_reference(draft_tokens: torch.Tensor,   # (B, γ) int32
                     q_probs: torch.Tensor,        # (B, γ, V)
                     p_probs: torch.Tensor,        # (B, γ+1, V)
                     u: torch.Tensor,              # (B, γ) uniforms
                     r: torch.Tensor,              # (B,) resample uniform
                     eps: float = 1e-12) -> VerifyOut:
    """The Leviathan/Chen accept–resample rule with explicit uniforms (the
    port of ``repro/kernels/verify/ref.py::verify_reference``): token i is
    accepted iff u_i < min(1, p_i(t_i)/q_i(t_i)); the next token is the
    inverse CDF at r·total of the residual max(p_j − q_j, 0) at the first
    rejection, or of p_{γ+1} when all γ accept (or the residual is empty).
    Unlike the kernels' glue, ``total`` is the chosen row's own sum."""
    B, gamma = draft_tokens.shape
    V = p_probs.shape[-1]
    tok = draft_tokens.long()[..., None]
    p_at = torch.gather(p_probs[:, :gamma, :], -1, tok)[..., 0]
    q_at = torch.gather(q_probs, -1, tok)[..., 0]
    accept = u < torch.clamp(p_at / q_at.clamp_min(1e-20), max=1.0)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=-1).sum(dim=-1)
    all_acc = n_acc == gamma
    jrow = torch.where(all_acc, gamma, n_acc)
    qrow = jrow.clamp(max=gamma - 1)
    rows = torch.arange(B, device=draft_tokens.device)
    p_j, q_j = p_probs[rows, jrow], q_probs[rows, qrow]
    residual = (p_j - q_j).clamp_min(0.0)
    use_p = all_acc | (residual.sum(-1) <= eps)
    dist = torch.where(use_p[:, None], p_j, residual)
    total = dist.sum(-1)
    hit = torch.cumsum(dist, dim=-1) > (r * total)[:, None]
    token = torch.where(hit.any(-1), torch.argmax(hit.to(torch.int8), -1),
                        V - 1)
    return VerifyOut(n_accepted=n_acc.to(torch.int32),
                     next_token=token.to(torch.int32), accept_mask=accept)


def gather_reduce_plain(tokens: torch.Tensor,   # (B, Γ) int32
                        p: torch.Tensor,        # (B, Γ+1, V) f32 or bf16
                        q: torch.Tensor):       # (B, Γ, V)
    """The plain version of B3a → (p_at, q_at, mass), each (B, Γ) float32:
    p and q of window position i at its draft token (0 for a token outside
    [0, V), as the Pallas kernel's one-hot compare gives) and the residual
    mass Σ_v max(p_i − q_i, 0), accumulated in float32."""
    gamma, V = tokens.shape[1], p.shape[-1]
    pf, qf = p[:, :gamma, :].float(), q.float()
    ok = (tokens >= 0) & (tokens < V)
    idx = torch.where(ok, tokens, 0).long()[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    p_at = torch.where(ok, torch.gather(pf, -1, idx)[..., 0], zero)
    q_at = torch.where(ok, torch.gather(qf, -1, idx)[..., 0], zero)
    mass = (pf - qf).clamp_min(0.0).sum(-1)
    return p_at, q_at, mass


def cdf_sample_plain(jrow: torch.Tensor,    # (B,) int32 p row
                     qrow: torch.Tensor,    # (B,) int32 q row
                     use_p: torch.Tensor,   # (B,) int32, > 0: sample p_j
                     p: torch.Tensor,       # (B, Γ+1, V)
                     q: torch.Tensor,       # (B, Γ, V)
                     thresh: torch.Tensor   # (B,) float32
                     ) -> torch.Tensor:
    """The plain version of B3b → (B,) int32: the first v whose running
    float32 sum of dist crosses ``thresh`` (strictly), where dist = p_jrow
    if use_p else max(p_jrow − q_qrow, 0); V − 1 when nothing crosses."""
    B, V = jrow.shape[0], p.shape[-1]
    rows = torch.arange(B, device=p.device)
    p_j = p[rows, jrow.long()].float()
    q_j = q[rows, qrow.long()].float()
    dist = torch.where(use_p[:, None] > 0, p_j, (p_j - q_j).clamp_min(0.0))
    hit = torch.cumsum(dist, dim=-1) > thresh.reshape(B, 1)
    token = torch.where(hit.any(-1), torch.argmax(hit.to(torch.int8), -1),
                        V - 1)
    return token.to(torch.int32)
