"""Tree-structured speculation (the port of ``repro/core/tree.py``): grid-
shaped multi-branch drafts verified in one ancestor-masked target pass.

The grid family and its rules are the reference's:

- ``T = 1 + d_max·b_max`` window entries; entry 0 is the anchor (the last
  committed token), entry ``1 + d·b_max + k`` is depth ``d`` of branch
  ``k`` (depth-major); ``parent(d, k) = (d−1, k)``, the anchor for d = 0.
  Branch ``k`` is a greedy chain rooted at the draft's k-th-best anchor
  token.
- A round's active shape (γ ≤ d_max depths, b ≤ b_max branches) enters only
  through :meth:`TreeSpec.node_valid`, computed on the device from the
  session's γ/b device scalars, so {γ, b} vary per round on one step.
- Accept rule (greedy, longest accepted root path): an entry is accepted
  iff every edge on its root path predicted the target's argmax; the
  winner is the deepest accepted entry (ties → lowest index), the bonus
  the target's argmax at the winner. ``b_max = 1`` is the linear chain.
- KV discipline: entry ``e`` writes slot ``pos + e`` at logical position
  ``pos + tree_pos[e]``; the ancestor bitmap masks cross-branch attention
  inside the window region, and after the verdict
  :func:`repro_torch.models.kvcache.tree_commit_cache` relocates the
  winning path onto the linear slots and scrubs the rest.

The verdict runs through kernels B4a/B4b in one launch
(:func:`repro_torch.kernels.verify.tree_verify_fused`), which reads the
ancestor bitmap packed into 32-bit words (:attr:`TreeSpec.win_words`);
:func:`verify_tree_greedy` is their plain version in full (the tests use
it). Nothing here reads a device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.verify.ref import accept_rule, tree_argmax_plain


class TreeSpec:
    """Static (d_max, b_max) grid-family descriptor: the reference's numpy
    tables and their mirrors on ``device`` (int32 tables, bool masks).
    The per-depth draft-window tables and ``win_words``, the ancestor
    bitmap packed for kernel B4b ((T, ⌈T/32⌉) int32: bit a % 32 of word
    a // 32 of row e is ``mask_np[e, a]``), are built here too, so a round
    allocates, packs and copies nothing from the host."""

    def __init__(self, d_max: int, b_max: int, device="cpu"):
        if d_max < 1 or b_max < 1:
            raise ValueError(f"TreeSpec needs d_max, b_max >= 1, got "
                             f"({d_max}, {b_max})")
        self.d_max = int(d_max)
        self.b_max = int(b_max)
        T = 1 + self.d_max * self.b_max
        self.n_entries = T

        depth = np.full((T,), -1, np.int32)    # anchor = -1
        branch = np.zeros((T,), np.int32)
        parent = np.zeros((T,), np.int32)      # anchor's parent = itself
        tpos = np.zeros((T,), np.int32)        # window-relative position
        for d in range(self.d_max):
            for k in range(self.b_max):
                e = 1 + d * self.b_max + k
                depth[e], branch[e], tpos[e] = d, k, 1 + d
                parent[e] = 0 if d == 0 else 1 + (d - 1) * self.b_max + k
        mask = np.zeros((T, T), bool)          # ancestor-or-self bitmap
        for e in range(T):
            a = e
            while True:
                mask[e, a] = True
                if a == 0:
                    break
                a = int(parent[a])

        W = -(-T // 32)
        packed = np.packbits(mask, axis=1, bitorder="little")
        packed = np.pad(packed, ((0, 0), (0, 4 * W - packed.shape[1])))
        words = packed.view("<i4").astype(np.int32)            # (T, W)

        self.depth_np, self.branch_np = depth, branch
        self.parent_np, self.tree_pos_np, self.mask_np = parent, tpos, mask
        self.win_words_np = words
        dev = torch.device(device)
        as_dev = lambda a: torch.as_tensor(a, device=dev)
        self.parent_entry = as_dev(parent)
        self.tree_pos = as_dev(tpos)
        self.win_mask = as_dev(mask)
        self.win_words = as_dev(words)
        self.depth = as_dev(depth)
        self.branch = as_dev(branch)
        self.slot_off = torch.arange(T, dtype=torch.int32, device=dev)
        # draft depth windows d = 0 .. d_max−2: (slot_off, pos_off, mask rows)
        self.depth_windows = []
        for d in range(self.d_max - 1):
            lo, hi = self.row_slice(d)
            self.depth_windows.append((
                self.slot_off[lo:hi],
                torch.full((self.b_max,), 1 + d, dtype=torch.int32,
                           device=dev),
                self.win_mask[lo:hi].contiguous()))

    def node_valid(self, gamma, branches) -> torch.Tensor:
        """(T,) bool — which grid entries the round's (γ, b) activates
        (device scalars or ints); the anchor is always valid."""
        return (self.depth < gamma) & (self.branch < branches)

    def row_slice(self, d: int) -> tuple[int, int]:
        """Entry range [lo, hi) of depth ``d``'s b_max-wide frontier."""
        lo = 1 + d * self.b_max
        return lo, lo + self.b_max


def tree_expected_accepted(alpha: float, gamma: float, branches: float,
                           decay: float = 0.4) -> float:
    """E[accepted draft tokens] of a (γ, b) grid tree at acceptance α: the
    primary chain E_chain(α, γ) = α(1 − α^γ)/(1 − α), plus, when the
    primary root is rejected (1 − α), a rescue by one of the b − 1 other
    roots at the decayed rate r = decay·α, worth its root plus a (γ − 1)
    chain. b = 1 reduces to E_chain. Host float math (the AWC joint
    {γ, b} decision)."""
    a = min(max(float(alpha), 0.0), 1.0 - 1e-9)
    g = max(float(gamma), 0.0)
    b = max(float(branches), 1.0)

    def chain(depth: float) -> float:
        return a * (1.0 - a ** depth) / (1.0 - a) if depth > 0 else 0.0

    r = min(max(decay * a, 0.0), 1.0)
    rescue_p = (1.0 - a) * (1.0 - (1.0 - r) ** (b - 1.0))
    return chain(g) + rescue_p * (1.0 + chain(g - 1.0))


class TreeVerifyResult(NamedTuple):
    """Per-slot verdict of one tree verify pass (pre-lifecycle)."""
    n_accepted: torch.Tensor   # (B,) int32 — depth of the winning entry
    next_token: torch.Tensor   # (B,) int32 — target prediction at the winner
    winner: torch.Tensor       # (B,) int32 — winning entry index
    path: torch.Tensor         # (B, d_max) int32 — root-path entries (0 pad)
    accept: torch.Tensor       # (B, T) bool — accepted-entry bitmap


def verify_tree_greedy(tree_tokens: torch.Tensor,    # (B, T) int32
                       p_logits: torch.Tensor,       # (B, T, V)
                       parent_entry: torch.Tensor,   # (T,) int32
                       tree_pos: torch.Tensor,       # (T,) int32
                       node_valid: torch.Tensor,     # (T,) bool
                       win_mask: torch.Tensor,       # (T, T) bool
                       d_max: int) -> TreeVerifyResult:
    """The longest-accepted-root-path rule over one target pass's logits:
    the plain version of kernels B4a + B4b, plus the winning path."""
    tgt = tree_argmax_plain(p_logits)
    accept, n_acc, winner, bonus = accept_rule(
        tree_tokens, tgt, parent_entry, tree_pos, node_valid, win_mask)
    path = tree_path_from_winner(winner, parent_entry, tree_pos, d_max)
    return TreeVerifyResult(n_accepted=n_acc, next_token=bonus,
                            winner=winner, path=path, accept=accept)


def tree_path_from_winner(winner: torch.Tensor, parent_entry: torch.Tensor,
                          tree_pos: torch.Tensor, d_max: int) -> torch.Tensor:
    """(B, d_max) root-path entries of ``winner``: a d_max-step parent walk
    placing each visited entry at its depth (the anchor contributes
    nothing; depths beyond the winner stay 0)."""
    B = winner.shape[0]
    path = torch.zeros((B, d_max), dtype=torch.int32, device=winner.device)
    darange = torch.arange(d_max, device=winner.device)[None, :]
    cur = winner.long()
    for _ in range(d_max):
        dcur = tree_pos[cur].long()                                 # (B,)
        hit = (darange == (dcur - 1)[:, None]) & (cur != 0)[:, None]
        path = torch.where(hit, cur[:, None].to(torch.int32), path)
        cur = parent_entry[cur].long()
    return path


def tree_committed(tree_tokens: torch.Tensor, res: TreeVerifyResult,
                   d_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(new_tokens (B, d_max+1), num_new (B,)): the winning path's draft
    tokens at 0..n_acc−1, the bonus token at n_acc, −1 after."""
    path_tokens = torch.gather(tree_tokens, 1, res.path.long())
    committed = torch.cat([path_tokens, torch.zeros_like(path_tokens[:, :1])],
                          dim=1)
    arange = torch.arange(d_max + 1, device=tree_tokens.device)[None, :]
    committed = torch.where(arange == res.n_accepted[:, None],
                            res.next_token[:, None], committed)
    num_new = res.n_accepted + 1
    new_tokens = torch.where(arange < num_new[:, None], committed,
                             torch.full_like(committed, -1))
    return new_tokens, num_new


def _top_lowest_id(logits: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) ids of the k largest logits, equal values ordered lowest id
    first (the order of the reference's ``jax.lax.top_k``; ``torch.topk``
    promises none on ties, and bf16 logits tie). k argmax passes, each
    masking its pick."""
    work = logits.float().clone()
    picks = []
    for _ in range(k):
        idx = torch.argmax(work, dim=-1, keepdim=True)
        picks.append(idx)
        work.scatter_(1, idx, float("-inf"))
    return torch.cat(picks, dim=1).to(torch.int32)


def tree_propose(model, params, cache, last_token: torch.Tensor,
                 pos: torch.Tensor, spec: TreeSpec):
    """Draft a full (d_max, b_max) grid in lockstep depth rounds: one anchor
    decode gives the top-b_max roots, then each depth is ONE b_max-wide
    masked window pass writing slots ``pos + entry`` at positions
    ``pos + 1 + d``. The final depth's KV is not written (the tail hole the
    linear propose leaves too). Returns ``(tree_tokens (B, T) int32,
    cache)``; the round's (γ, b) only masks acceptance."""
    logits, cache = model.decode_step(params, last_token, cache, pos)
    frontier = _top_lowest_id(logits, spec.b_max)              # (B, b_max)
    rows = [frontier]
    for slot_off, pos_off, mask in spec.depth_windows:
        lg, cache = model.verify_step(params, frontier, cache, pos,
                                      slot_off=slot_off, pos_off=pos_off,
                                      win_mask=mask)
        frontier = torch.argmax(lg, dim=-1).to(torch.int32)
        rows.append(frontier)
    tree_tokens = torch.cat([last_token[:, None].to(torch.int32)] + rows,
                            dim=1)
    return tree_tokens, cache
