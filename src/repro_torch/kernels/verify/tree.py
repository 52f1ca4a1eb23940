"""Wrappers of the hand-written CUDA tree-verify kernels
(``csrc/tree_verify.cu``), the port of the Pallas pair
``repro/kernels/verify/tree.py``:

- :func:`tree_argmax` (B4a) — per-entry target argmax over the vocab;
- :func:`tree_accept` (B4b) — n_acc, winner and bonus of the longest
  accepted root path.

CPU tensors run the plain versions (:mod:`.ref`); CUDA tensors launch the
kernel or raise."""

from __future__ import annotations

import torch

from .. import check_launch, count_launch, library, stream_ptr
from .ref import tree_accept_plain, tree_argmax_plain

MAX_ENTRIES = 1024          # one thread per tree entry in one block


def _same_device(ref: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tree_argmax(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, V) float32 logits → (B, T) int32 argmax, ties to the lowest
    id (``torch.argmax``'s order)."""
    if logits.device.type == "cpu":
        return tree_argmax_plain(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"tree_argmax runs on cuda or cpu, not "
                         f"{logits.device}")
    if logits.dim() != 3 or logits.dtype != torch.float32:
        raise ValueError("logits must be float32 (B, T, V)")
    _same_device(logits, logits=logits)
    B, T, V = logits.shape
    out = torch.empty((B, T), dtype=torch.int32, device=logits.device)
    err = library().tree_argmax_launch(logits.data_ptr(), out.data_ptr(),
                                       B * T, V, stream_ptr(logits))
    check_launch("tree_argmax", err)
    count_launch("tree_argmax")
    return out


def tree_accept(tree_tokens: torch.Tensor,   # (B, T) int32
                tgt: torch.Tensor,           # (B, T) int32
                parent_entry: torch.Tensor,  # (T,) int32
                tree_pos: torch.Tensor,      # (T,) int32
                node_valid: torch.Tensor,    # (T,) bool
                win_mask: torch.Tensor):     # (T, T) bool
    """Longest accepted root path per batch row → (n_acc, winner, bonus),
    each (B,) int32."""
    if tree_tokens.device.type == "cpu":
        return tree_accept_plain(tree_tokens, tgt, parent_entry, tree_pos,
                                 node_valid, win_mask)
    if tree_tokens.device.type != "cuda":
        raise ValueError(f"tree_accept runs on cuda or cpu, not "
                         f"{tree_tokens.device}")
    B, T = tree_tokens.shape
    if T > MAX_ENTRIES:
        raise ValueError(f"tree_accept takes at most {MAX_ENTRIES} entries, "
                         f"got {T}")
    _same_device(tree_tokens, tree_tokens=tree_tokens, tgt=tgt,
                 parent_entry=parent_entry, tree_pos=tree_pos,
                 node_valid=node_valid, win_mask=win_mask)
    for name, t, dt, shape in (
            ("tree_tokens", tree_tokens, torch.int32, (B, T)),
            ("tgt", tgt, torch.int32, (B, T)),
            ("parent_entry", parent_entry, torch.int32, (T,)),
            ("tree_pos", tree_pos, torch.int32, (T,)),
            ("node_valid", node_valid, torch.bool, (T,)),
            ("win_mask", win_mask, torch.bool, (T, T))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dt} {shape}")
    out = torch.empty((3, B), dtype=torch.int32, device=tree_tokens.device)
    err = library().tree_accept_launch(
        tree_tokens.data_ptr(), tgt.data_ptr(), parent_entry.data_ptr(),
        tree_pos.data_ptr(), node_valid.data_ptr(), win_mask.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B, T,
        stream_ptr(tree_tokens))
    check_launch("tree_accept", err)
    count_launch("tree_accept")
    return out[0], out[1], out[2]
