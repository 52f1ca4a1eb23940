"""Plain PyTorch versions of the verify kernels.

- Tree verify: the per-entry target argmax (B4a, ``torch.argmax``: ties to
  the lowest id) and the longest-accepted-root-path rule (B4b), also as
  the packed-word arithmetic the kernel follows (:func:`accept_rule_words`
  over :func:`pack_mask_words`).
- Sampled verify: the oracle :func:`verify_reference` (the accept–resample
  rule with explicit uniforms) and the plain versions of the kernel pair,
  :func:`gather_reduce_plain` (B3a) and :func:`cdf_sample_plain` (B3b).

The CPU tests and the engine on CPU tensors run them; on the card
``chip_smoke.py`` holds the kernels to them (B4 exactly; B3 exactly up to
rounding at a CDF step)."""

from __future__ import annotations

from typing import NamedTuple

import torch


def tree_argmax_plain(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, V) → (B, T) int32 argmax over the vocab."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _match(tree_tokens, tgt, parent_entry, node_valid) -> torch.Tensor:
    """(B, T) bool: the entry is valid and its token is the target's argmax
    at its parent; the anchor always matches."""
    B, T = tree_tokens.shape
    parent_tgt = torch.gather(tgt, 1,
                              parent_entry.long()[None, :].expand(B, T))
    anchor = torch.arange(T, device=tree_tokens.device) == 0
    return (node_valid[None, :] & (tree_tokens == parent_tgt)) \
        | anchor[None, :]


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
    T = tree_tokens.shape[1]
    entry = torch.arange(T, device=tree_tokens.device)
    match = _match(tree_tokens, tgt, parent_entry, node_valid)
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


def _to_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool → (..., ⌈n/32⌉) int64 words in [0, 2³²): bit i % 32
    of word i // 32 is bits[..., i]."""
    n = bits.shape[-1]
    W = -(-n // 32)
    lanes = torch.arange(32, device=bits.device)
    padded = torch.nn.functional.pad(bits.long(), (0, 32 * W - n))
    return (padded.reshape(*bits.shape[:-1], W, 32) << lanes).sum(-1)


def pack_mask_words(win_mask: torch.Tensor) -> torch.Tensor:
    """(T, T) bool ancestor-or-self bitmap → (T, ⌈T/32⌉) int32, the layout
    B4b reads: bit a % 32 of word a // 32 of row e is ``win_mask[e, a]``
    (``TreeSpec.win_words`` builds the same with numpy)."""
    words = _to_words(win_mask)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def accept_rule_words(tree_tokens: torch.Tensor,   # (B, T) int32
                      tgt: torch.Tensor,           # (B, T) int32
                      parent_entry: torch.Tensor,  # (T,) int32
                      tree_pos: torch.Tensor,      # (T,) int32, >= 0
                      node_valid: torch.Tensor,    # (T,) bool
                      win_words: torch.Tensor):    # (T, ⌈T/32⌉) int32
    """:func:`accept_rule` as kernel B4b computes it → (accept, n_acc,
    winner, bonus): the match bits packed into 32-bit words as the warps'
    ballots give them; entry e accepted when no word of its packed
    ancestor row has a bit outside the match words; the best score
    s = tpos·T + (T − e) over accepted entries, decoded as n_acc =
    (s − 1) // T and winner = T − 1 − (s − 1) % T; bonus = tgt[winner]."""
    T = tree_tokens.shape[1]
    entry = torch.arange(T, device=tree_tokens.device)
    match = _match(tree_tokens, tgt, parent_entry, node_valid)
    match_words = _to_words(match)                              # (B, W)
    rows = win_words.long() & 0xFFFFFFFF                        # (T, W)
    viol = rows[None, :, :] & ~match_words[:, None, :]          # (B, T, W)
    accept = (viol == 0).all(dim=-1)
    score = torch.where(accept, tree_pos.long()[None, :] * T + (T - entry),
                        torch.full_like(entry, -1)[None, :])
    s = score.max(dim=-1).values - 1
    winner = T - 1 - s % T
    bonus = torch.gather(tgt, 1, winner[:, None])[:, 0]
    return (accept, (s // T).to(torch.int32), winner.to(torch.int32),
            bonus.to(torch.int32))


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


def _selected_dist(jrow, qrow, use_p, p, q):
    """(B, V) float32: p_jrow if use_p else max(p_jrow − q_qrow, 0)."""
    rows = torch.arange(jrow.shape[0], device=p.device)
    p_j = p[rows, jrow.long()].float()
    q_j = q[rows, qrow.long()].float()
    return torch.where(use_p[:, None] > 0, p_j, (p_j - q_j).clamp_min(0.0))


def cdf_sample_plain(jrow: torch.Tensor,    # (B,) int32 p row
                     qrow: torch.Tensor,    # (B,) int32 q row
                     use_p: torch.Tensor,   # (B,) int32, > 0: sample p_j
                     p: torch.Tensor,       # (B, Γ+1, V)
                     q: torch.Tensor,       # (B, Γ, V)
                     thresh: torch.Tensor   # (B,) float32
                     ) -> torch.Tensor:
    """The plain version of B3b → (B,) int32: the first v whose running
    sum of dist, rounded to float32, crosses ``thresh`` (strictly), where
    dist = p_jrow if use_p else max(p_jrow − q_qrow, 0); V − 1 when
    nothing crosses. The running sum accumulates in float64: PyTorch's CPU
    cumsum of float32 does so (the result is bit for bit the same), while
    its CUDA cumsum scans in float32, so without it the plain token would
    depend on the device."""
    B, V = jrow.shape[0], p.shape[-1]
    dist = _selected_dist(jrow, qrow, use_p, p, q)
    hit = torch.cumsum(dist, dim=-1, dtype=torch.float64).float() \
        > thresh.reshape(B, 1)
    token = torch.where(hit.any(-1), torch.argmax(hit.to(torch.int8), -1),
                        V - 1)
    return token.to(torch.int32)


CDF_SPLIT = 4096    # B3b's vocab split (``csrc/sampled_verify.cu`` kSplit)


def cdf_sample_split_plain(jrow, qrow, use_p, p, q, thresh,
                           split: int = CDF_SPLIT) -> torch.Tensor:
    """B3b's decomposition → (B,) int32, the same token as
    :func:`cdf_sample_plain` up to rounding at a CDF step: the selected row
    cut into fixed ``split``-entry vocab splits; each split's total; the
    first split whose running total (in index order) crosses ``thresh``,
    its offset the total of the splits before it; in that split the first v
    whose running sum from the offset crosses, or, if the split's own sums
    never do, its last entry with dist > 0; V − 1 when no split crosses.
    Sums are float64 and a running sum crosses when it rounds above
    ``thresh`` in float32, as the kernel and a CPU cumsum do."""
    B, V = jrow.shape[0], p.shape[-1]
    dist = _selected_dist(jrow, qrow, use_p, p, q).double()
    n = -(-V // split)
    parts = torch.nn.functional.pad(dist, (0, n * split - V)).reshape(
        B, n, split)
    incl = torch.cumsum(parts.sum(-1), dim=-1)               # (B, n)
    th = thresh.reshape(B).float()
    token = torch.full((B,), V - 1, dtype=torch.int64, device=p.device)
    for b in range(B):
        cross = torch.nonzero(incl[b].float() > th[b]).flatten()
        if cross.numel() == 0:
            continue
        k = int(cross[0])
        off = incl[b, k - 1] if k > 0 else incl.new_zeros(())
        d = parts[b, k]
        hit = torch.nonzero((off + torch.cumsum(d, 0)).float()
                            > th[b]).flatten()
        pos = torch.nonzero(d > 0).flatten()
        if hit.numel() or pos.numel():
            token[b] = k * split + int(hit[0] if hit.numel() else pos[-1])
    return token.to(torch.int32)
