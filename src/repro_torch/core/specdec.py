"""Speculative decoding algorithm (paper §2.1) at temperature 0, in
PyTorch, model-agnostic and batched with no data-dependent host control
flow (the step never reads a device value on the host).

- the draft proposes γ tokens (argmax at temperature 0),
- the target evaluates the γ+1 window in one pass,
- token i is accepted while it equals the target's argmax; the target's
  argmax at the first mismatch (or the extra position) is committed next.

Per-token acceptance probability α gives (paper Eqs. (1)–(2)):

    E[τ] = (1 − α^{γ+1}) / (1 − α)
    S    = (1 − α^{γ+1}) / ((1 − α)(cγ + 1))

The sampled accept/resample rule (temperature > 0) and its kernel pair
come with ROADMAP item A8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch


# --------------------------------------------------------------------------
# Analytic formulas (Eqs. 1 and 2)
# --------------------------------------------------------------------------

def expected_accepted(alpha, gamma) -> torch.Tensor:
    """E[tokens per iteration] = (1 - alpha^(gamma+1)) / (1 - alpha)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    g = torch.as_tensor(gamma, dtype=torch.float32)
    near_one = (1.0 - alpha).abs() < 1e-6
    safe = torch.where(near_one, torch.full_like(alpha, 0.5), alpha)
    val = (1.0 - safe ** (g + 1.0)) / (1.0 - safe)
    return torch.where(near_one, g + 1.0, val)


def expected_speedup(alpha, gamma, cost_ratio) -> torch.Tensor:
    """S = (1 - alpha^(gamma+1)) / ((1 - alpha) (c*gamma + 1))."""
    return expected_accepted(alpha, gamma) / (
        torch.as_tensor(cost_ratio, dtype=torch.float32)
        * torch.as_tensor(gamma, dtype=torch.float32) + 1.0)


def optimal_gamma(alpha: float, cost_ratio: float, gmax: int = 12) -> int:
    """argmax_γ of Eq. (2) over the integer range [1, gmax]."""
    gammas = torch.arange(1, gmax + 1, dtype=torch.float32)
    s = expected_speedup(alpha, gammas, cost_ratio)
    return int(torch.argmax(s)) + 1


# --------------------------------------------------------------------------
# Verification (greedy)
# --------------------------------------------------------------------------

class VerifyResult(NamedTuple):
    n_accepted: torch.Tensor   # (B,) int32 — accepted draft tokens in [0, γ]
    next_token: torch.Tensor   # (B,) int32 — corrected or bonus token
    accept_mask: torch.Tensor  # (B, γ) bool — per-position acceptance
    num_new: torch.Tensor      # (B,) int32 — n_accepted + 1 tokens produced


def verify_window_greedy(draft_tokens: torch.Tensor,
                         p_logits: torch.Tensor,
                         active_gamma: torch.Tensor) -> VerifyResult:
    """Accept while the draft token equals the target argmax; the
    correction/bonus token is the target argmax at the first mismatch (or
    the extra position). ``active_gamma`` (a 0-d or (B,) int32 device
    tensor) masks the window to its first positions; because attention
    decoding is causal, the committed tokens at any γ are identical to a
    dedicated per-γ window."""
    B, gamma = draft_tokens.shape
    tgt = torch.argmax(p_logits, dim=-1).to(torch.int32)         # (B, Γ+1)
    ar = torch.arange(gamma, device=draft_tokens.device)
    accept = (tgt[:, :gamma] == draft_tokens) \
        & (ar[None, :] < active_gamma.reshape(-1, 1))
    n_acc = torch.cumprod(accept.to(torch.int32), dim=-1).sum(dim=-1)
    next_token = torch.gather(tgt, 1, n_acc[:, None].long())[:, 0]
    n_acc = n_acc.to(torch.int32)
    return VerifyResult(n_accepted=n_acc, next_token=next_token,
                        accept_mask=accept, num_new=n_acc + 1)


# --------------------------------------------------------------------------
# Per-slot stopping (continuous batching)
# --------------------------------------------------------------------------

class SlotStop(NamedTuple):
    num_new: torch.Tensor      # (B,) int32 — tokens to commit after masking
    n_accepted: torch.Tensor   # (B,) int32 — masked acceptance count
    done: torch.Tensor         # (B,) bool  — updated finished flags


def slot_stop_mask(num_new: torch.Tensor, n_accepted: torch.Tensor,
                   new_tokens: torch.Tensor, cursor: torch.Tensor,
                   max_new: torch.Tensor, done: torch.Tensor,
                   eos_id: torch.Tensor) -> SlotStop:
    """Per-slot active masking + EOS/length stopping for a batch whose rows
    belong to independent requests at different lifecycle stages.

    - rows with ``done`` commit nothing (``num_new → 0``),
    - active rows are clamped to their remaining budget ``max_new − cursor``
      and marked done when they exhaust it,
    - a committed ``eos_id`` token (int32 device tensor; −1 disables)
      truncates the window after the EOS position and marks the row done.
    """
    B, W = new_tokens.shape
    active = ~done
    zero = torch.zeros_like(num_new)
    num_eff = torch.where(active,
                          torch.minimum(num_new,
                                        (max_new - cursor).clamp_min(0)),
                          zero)
    ar = torch.arange(W, device=new_tokens.device)[None, :]
    is_eos = (new_tokens == eos_id) & (ar < num_eff[:, None]) & (eos_id >= 0)
    has_eos = is_eos.any(dim=-1)
    eos_pos = torch.argmax(is_eos.to(torch.int32), dim=-1).to(torch.int32)
    num_eff = torch.where(has_eos, torch.minimum(num_eff, eos_pos + 1),
                          num_eff)
    new_done = done | (cursor + num_eff >= max_new) | has_eos
    # acceptance stats reflect COMMITTED tokens only
    n_eff = torch.where(active, torch.minimum(n_accepted, num_eff), zero)
    return SlotStop(num_new=num_eff.to(torch.int32),
                    n_accepted=n_eff.to(torch.int32), done=new_done)


# --------------------------------------------------------------------------
# Draft proposal loop
# --------------------------------------------------------------------------

class DraftProposal(NamedTuple):
    tokens: torch.Tensor    # (B, γ) int32
    cache: object           # draft model cache after the window


def draft_propose(decode_fn: Callable, params, cache,
                  last_token: torch.Tensor, start_pos: torch.Tensor,
                  gamma: int) -> DraftProposal:
    """Autoregressively propose γ tokens with the draft model at temperature
    0. The reference draws Gumbel-max samples from one-hot probabilities,
    which is the argmax; the port takes the argmax directly.
    ``decode_fn(params, token, cache, pos) -> (logits, cache)``."""
    tok, pos, toks = last_token, start_pos, []
    for _ in range(gamma):
        logits, cache = decode_fn(params, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
        pos = pos + 1
    return DraftProposal(tokens=torch.stack(toks, dim=1), cache=cache)


# --------------------------------------------------------------------------
# One full speculation iteration (draft γ → verify → commit)
# --------------------------------------------------------------------------

@dataclass
class SpecDecodeState:
    draft_cache: object
    target_cache: object
    last_token: torch.Tensor   # (B,) int32 most recent committed token
    pos: torch.Tensor          # (B,) int32 absolute position OF last_token


class SpecDecodeOut(NamedTuple):
    state: SpecDecodeState
    new_tokens: torch.Tensor   # (B, γ+1) committed tokens, padded with -1
    num_new: torch.Tensor      # (B,)
    n_accepted: torch.Tensor   # (B,)


def spec_decode_step(draft_decode_fn: Callable, target_verify_fn: Callable,
                     draft_params, target_params, state: SpecDecodeState,
                     gamma: int, active_gamma: torch.Tensor) -> SpecDecodeOut:
    """One speculation iteration at temperature 0.

    ``target_verify_fn(params, tokens, cache, pos) -> (logits, cache)``
    runs the target over the γ+1 window ``[last_token, draft_tokens]``.
    Callers commit only ``num_new`` tokens; stale cache entries beyond the
    committed position stay pos_map-masked until overwritten. ``gamma`` is
    the fixed window width (γ_max); ``active_gamma`` masks acceptance so
    one width serves every γ ∈ [0, γ_max]."""
    prop = draft_propose(draft_decode_fn, draft_params, state.draft_cache,
                         state.last_token, state.pos, gamma)
    window = torch.cat([state.last_token[:, None], prop.tokens], dim=1)
    p_logits, target_cache = target_verify_fn(
        target_params, window, state.target_cache, state.pos)
    res = verify_window_greedy(prop.tokens, p_logits, active_gamma)

    # committed tokens: accepted prefix then the corrected/bonus token
    ar = torch.arange(gamma + 1, device=window.device)[None, :]
    acc_part = torch.cat([prop.tokens, torch.zeros_like(prop.tokens[:, :1])],
                         dim=1)
    corrected = torch.where(ar == res.n_accepted[:, None],
                            res.next_token[:, None], acc_part)
    new_tokens = torch.where(ar < res.num_new[:, None], corrected,
                             torch.full_like(corrected, -1))
    new_state = SpecDecodeState(draft_cache=prop.cache,
                                target_cache=target_cache,
                                last_token=res.next_token,
                                pos=state.pos + res.num_new)
    return SpecDecodeOut(state=new_state, new_tokens=new_tokens,
                         num_new=res.num_new, n_accepted=res.n_accepted)
