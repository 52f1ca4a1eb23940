"""Wrappers of the hand-written CUDA tree-verify kernels
(``csrc/tree_verify.cu``), the port of the Pallas pair
``repro/kernels/verify/tree.py``:

- :func:`tree_argmax` (B4a) — per-entry target argmax over the vocab;
- :func:`tree_accept` (B4b) — n_acc, winner and bonus of the longest
  accepted root path, as bitmask arithmetic over packed ancestor rows;
- :func:`tree_verify_fused` — both in one launch (B4b as the epilogue of
  the last block of each batch row), the served path.

The ancestor-or-self bitmap stays a (T, T) bool ``win_mask`` at these
functions, as in the reference, and the plain versions read it. The
kernels read it packed into (T, ⌈T/32⌉) int32 words, built once per tree
shape as ``TreeSpec.win_words``; a CUDA call without them raises.

CPU tensors run the plain versions (:mod:`.ref`); CUDA tensors launch the
kernel or raise."""

from __future__ import annotations

from typing import Optional

import torch

from .. import check_launch, count_launch, library, stream_ptr
from .ref import tree_accept_plain, tree_argmax_plain

MAX_ENTRIES = 1024          # csrc kMaxEntries: 32 ancestor words a row


def _same_device(ref: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")


def _check_entries(name: str, T: int) -> None:
    if T > MAX_ENTRIES:
        raise ValueError(f"{name} takes at most {MAX_ENTRIES} entries, "
                         f"got {T}")


def _check_tables(name, B, T, tree_tokens, parent_entry, tree_pos,
                  node_valid, win_mask, win_words, **more) -> None:
    """Device, type and shape of the accept rule's operands on the card."""
    if win_words is None:
        raise ValueError(f"{name} on the card reads the packed ancestor "
                         "words: pass win_words (TreeSpec.win_words)")
    _same_device(tree_tokens, tree_tokens=tree_tokens,
                 parent_entry=parent_entry, tree_pos=tree_pos,
                 node_valid=node_valid, win_mask=win_mask,
                 win_words=win_words, **more)
    for arg, t, dt, shape in (
            ("tree_tokens", tree_tokens, torch.int32, (B, T)),
            ("parent_entry", parent_entry, torch.int32, (T,)),
            ("tree_pos", tree_pos, torch.int32, (T,)),
            ("node_valid", node_valid, torch.bool, (T,)),
            ("win_mask", win_mask, torch.bool, (T, T)),
            ("win_words", win_words, torch.int32, (T, -(-T // 32)))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{arg} must be {dt} {shape}")


def tree_argmax(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, V) float32 logits → (B, T) int32 argmax, ties to the lowest
    id (``torch.argmax``'s order)."""
    _check_device("tree_argmax", logits)
    if logits.device.type == "cpu":
        return tree_argmax_plain(logits)
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
                win_mask: torch.Tensor,      # (T, T) bool
                win_words: Optional[torch.Tensor] = None):  # (T, ⌈T/32⌉)
    """Longest accepted root path per batch row → (n_acc, winner, bonus),
    each (B,) int32. ``win_words`` is ``win_mask`` packed
    (``TreeSpec.win_words``), which the kernel reads; CPU tensors need
    only ``win_mask``."""
    _check_device("tree_accept", tree_tokens)
    B, T = tree_tokens.shape
    _check_entries("tree_accept", T)
    if tree_tokens.device.type == "cpu":
        return tree_accept_plain(tree_tokens, tgt, parent_entry, tree_pos,
                                 node_valid, win_mask)
    _check_tables("tree_accept", B, T, tree_tokens, parent_entry, tree_pos,
                  node_valid, win_mask, win_words, tgt=tgt)
    if tgt.dtype != torch.int32 or tuple(tgt.shape) != (B, T):
        raise ValueError(f"tgt must be {torch.int32} {(B, T)}")
    out = torch.empty((3, B), dtype=torch.int32, device=tree_tokens.device)
    err = library().tree_accept_launch(
        tree_tokens.data_ptr(), tgt.data_ptr(), parent_entry.data_ptr(),
        tree_pos.data_ptr(), node_valid.data_ptr(), win_words.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B, T,
        stream_ptr(tree_tokens))
    check_launch("tree_accept", err)
    count_launch("tree_accept")
    return out[0], out[1], out[2]


def tree_verify_fused(tree_tokens: torch.Tensor,   # (B, T) int
                      p_logits: torch.Tensor,      # (B, T, V) float32
                      parent_entry: torch.Tensor,  # (T,) int32
                      tree_pos: torch.Tensor,      # (T,) int32
                      node_valid: torch.Tensor,    # (T,) bool
                      win_mask: torch.Tensor,      # (T, T) bool
                      win_words: Optional[torch.Tensor] = None,
                      counters: Optional[torch.Tensor] = None):
    """(n_accepted, winner, bonus), each (B,) int32 — the verdict of
    :func:`repro_torch.core.tree.verify_tree_greedy` — in one launch where
    the reference glue makes two: the target's argmax at every entry, then
    the accept rule on each batch row, run by the block that finishes the
    row's last entry.

    On the card it also takes ``win_words`` (``TreeSpec.win_words``) and
    ``counters``, a zeroed int32 workspace of at least B entries that the
    caller owns (a decode session holds one). The kernel counts each row's
    finished entries there and leaves it at zero, so no memset runs per
    call; two launches that may overlap must not share it. Allocate it
    before a CUDA-graph capture of this call: the graph keeps its address.
    CPU tensors need neither."""
    _check_device("tree_verify", tree_tokens)
    B, T = tree_tokens.shape
    _check_entries("tree_verify", T)
    tree_tokens = tree_tokens.to(torch.int32).contiguous()
    if tree_tokens.device.type == "cpu":
        return tree_accept_plain(tree_tokens, tree_argmax_plain(p_logits),
                                 parent_entry, tree_pos, node_valid,
                                 win_mask)
    if counters is None:
        raise ValueError("tree_verify on the card counts finished entries "
                         "in a zeroed int32 workspace: pass counters")
    _check_tables("tree_verify", B, T, tree_tokens, parent_entry, tree_pos,
                  node_valid, win_mask, win_words, p_logits=p_logits,
                  counters=counters)
    if p_logits.dtype != torch.float32 or p_logits.dim() != 3 \
            or tuple(p_logits.shape[:2]) != (B, T):
        raise ValueError(f"p_logits must be float32 ({B}, {T}, V)")
    if counters.dtype != torch.int32 or counters.numel() < B:
        raise ValueError(f"counters must be int32 with at least {B} "
                         "entries")
    dev = tree_tokens.device
    tgt = torch.empty((B, T), dtype=torch.int32, device=dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    err = library().tree_verify_launch(
        p_logits.data_ptr(), tree_tokens.data_ptr(), tgt.data_ptr(),
        parent_entry.data_ptr(), tree_pos.data_ptr(), node_valid.data_ptr(),
        win_words.data_ptr(), counters.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), B, T, p_logits.shape[2],
        stream_ptr(tree_tokens))
    check_launch("tree_verify", err)
    count_launch("tree_verify")
    return out[0], out[1], out[2]
