"""WC-DNN deployment paths (paper §4.1, §4.3): the numpy predictor over a
saved checkpoint and the analytic bootstrap controller.

A copy of the numpy-only parts of the reference ``core/awc/model.py``
(``numpy_predictor``, ``load``, ``bootstrap_gamma``,
``default_predictor``). Training the network (``init``/``forward``/``save``
and ``awc/train.py``) comes with ROADMAP item A15; ``load`` returns the
parameters as numpy arrays.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np

# fused-mode tokens stream edge-ward one control round trip per this many
# committed tokens: mirrors repro_torch.sim.network.DEFAULT_FUSED_CHUNK, not
# imported because core.window → core.awc → this module loads while
# repro_torch.sim.scheduler (which imports core.window) may be mid-import
# (as in the reference); tests/test_torch_sim.py holds the two equal
DEFAULT_FUSED_CHUNK = 8

# [q_depth, alpha_recent, rtt_ms, tpot_ms, gamma_prev, pipe_hit_recent,
#  branches_prev]
FEATURE_DIM = 7


class WCDNNParams(NamedTuple):
    feat_mean: np.ndarray   # (FEATURE_DIM,)
    feat_std: np.ndarray    # (FEATURE_DIM,)
    w_in: np.ndarray        # (FEATURE_DIM, H)
    b_in: np.ndarray        # (H,)
    blocks: tuple           # ((w1,b1,w2,b2), ...) residual blocks
    w_out: np.ndarray       # (H, 1)
    b_out: np.ndarray       # (1,)


def numpy_predictor(params: WCDNNParams) -> Callable[[list[float]], float]:
    """Sub-microsecond per-call inference for the serving loop."""
    mean = np.asarray(params.feat_mean)
    std = np.asarray(params.feat_std)
    w_in, b_in = np.asarray(params.w_in), np.asarray(params.b_in)
    blocks = [(np.asarray(w1), np.asarray(b1), np.asarray(w2), np.asarray(b2))
              for (w1, b1, w2, b2) in params.blocks]
    w_out, b_out = np.asarray(params.w_out), np.asarray(params.b_out)

    def silu(v):
        # numerically stable x·sigmoid(x)
        pos = v >= 0
        ev = np.exp(np.where(pos, -v, v))
        sig = np.where(pos, 1.0 / (1.0 + ev), ev / (1.0 + ev))
        return v * sig

    def predict(feats: list[float]) -> float:
        h = (np.asarray(feats, np.float32) - mean) / std
        h = silu(h @ w_in + b_in)
        for (w1, b1, w2, b2) in blocks:
            h = h + silu(silu(h @ w1 + b1) @ w2 + b2)
        return float((h @ w_out + b_out)[0])

    return predict


def load(path: str) -> WCDNNParams:
    z = np.load(path)
    got = int(z["w_in"].shape[0])
    if got != FEATURE_DIM:
        raise ValueError(
            f"{path} was trained on {got}-dim features but this build "
            f"expects FEATURE_DIM={FEATURE_DIM} (the pipeline-hit-rate "
            f"and tree-branch signals were appended); re-train or delete "
            f"the stale checkpoint")
    n = int(z["n_blocks"])
    blocks = tuple(
        (z[f"blk{i}_w1"], z[f"blk{i}_b1"], z[f"blk{i}_w2"], z[f"blk{i}_b2"])
        for i in range(n))
    return WCDNNParams(
        feat_mean=z["feat_mean"], feat_std=z["feat_std"],
        w_in=z["w_in"], b_in=z["b_in"], blocks=blocks,
        w_out=z["w_out"], b_out=z["b_out"])


# --------------------------------------------------------------------------
# Analytic bootstrap controller (pre-training fallback + label prior)
# --------------------------------------------------------------------------

def bootstrap_gamma(feats: list[float], cost_ratio: float = 0.12,
                    gmax: int = 12,
                    fused_chunk: int = DEFAULT_FUSED_CHUNK,
                    mode_aware: bool = True) -> float:
    """γ* maximizing tokens/second from Eq. (1) with network-, queue- and
    pipeline-aware iteration cost:

        rate(γ) = E[τ](α, γ) / (γ·c + 1 + ((1−h)·RTT + queue·TPOT) / t_verify)

    where t_verify ≈ TPOT and h is the recent pipeline hit rate (the 6th
    feature; 0 when feats has only the classic 5). When ``mode_aware``,
    the best distributed rate is compared against the fused (cloud-only)
    alternative,

        rate_fused = 1 / (1 + (RTT + queue·TPOT) / (chunk · t_verify)),

    and 1.0 is returned when fused wins (the stabilizer's hysteresis maps
    γ ≤ 1 to fused mode)."""
    q_depth, alpha, rtt_ms, tpot_ms = feats[0], feats[1], feats[2], feats[3]
    pipe_hit = min(1.0, max(0.0, float(feats[5]))) if len(feats) > 5 else 0.0
    alpha = min(0.98, max(0.02, alpha))
    t_verify = max(1.0, tpot_ms)
    queue_ms = max(0.0, q_depth) * tpot_ms
    stall_ms = rtt_ms + queue_ms
    # overlapped-RTT term: a hit round's RTT hides behind the next draft
    overhead = ((1.0 - pipe_hit) * rtt_ms + queue_ms) / t_verify
    best_g, best_rate = 1, -1.0
    for g in range(1, gmax + 1):
        e_tau = (1.0 - alpha ** (g + 1)) / (1.0 - alpha)
        rate = e_tau / (g * cost_ratio + 1.0 + overhead)
        if rate > best_rate:
            best_g, best_rate = g, rate
    if mode_aware:
        fused_rate = 1.0 / (1.0 + stall_ms / (fused_chunk * t_verify))
        if fused_rate > best_rate:
            return 1.0
    return float(best_g)


DEFAULT_CKPT = os.path.join(os.path.dirname(__file__), "data",
                            "wcdnn_default.npz")


def default_predictor() -> Callable[[list[float]], float]:
    """Trained checkpoint if present, analytic bootstrap otherwise."""
    if os.path.exists(DEFAULT_CKPT):
        return numpy_predictor(load(DEFAULT_CKPT))
    return bootstrap_gamma
