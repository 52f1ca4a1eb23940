"""Fused greedy tree verify, the port of the reference glue
``repro/kernels/verify/ops.py::tree_verify_fused``: B4a (per-entry target
argmax) then B4b (accept rule). The CUDA kernel takes any V, so no vocab
padding is needed."""

from __future__ import annotations

import torch

from .tree import tree_accept, tree_argmax


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
