"""Plain PyTorch versions of the tree-verify kernels: the per-entry target
argmax (B4a, ``torch.argmax``: ties to the lowest id) and the longest-
accepted-root-path rule (B4b). The CPU tests and
:func:`repro_torch.core.tree.verify_tree_greedy` run them; on the card
``chip_smoke.py`` holds the kernels to them exactly."""

from __future__ import annotations

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
