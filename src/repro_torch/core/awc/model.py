"""WC-DNN — the AWC window-control network (paper §4.1, §4.3, Fig. 3), the
port of the reference ``core/awc/model.py``.

A residual MLP: the 7-dim feature vector → input projection → residual
blocks with SiLU → a scalar head predicting the speculation window γ as a
continuous value. Features are z-normalized with statistics stored inside
the parameters, so a deployed predictor is self-contained.

- :func:`init` / :func:`set_normalization` / :func:`forward` — the network
  in PyTorch for training (``awc/train.py``), parameters float32 tensors
  (``init`` draws from a seeded ``torch.Generator``, not the reference's
  ``jax.random`` numbers);
- :func:`save` / :func:`load` — the reference's ``.npz`` layout, so each
  package reads the other's checkpoint (``load`` returns numpy arrays);
- :func:`numpy_predictor` — sub-microsecond per-call inference for the
  serving loop and the simulator, from numpy or tensor parameters;
- :func:`bootstrap_gamma` — the analytic controller used before any
  training data exists, and :func:`default_predictor`.
"""

from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

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


def init(seed: int = 0, hidden: int = 64, n_blocks: int = 2,
         device="cpu") -> WCDNNParams:
    """He-normal weights (std sqrt(2 / fan_in)) from a ``torch.Generator``
    seeded with ``seed``, zero biases, the head scaled by 0.1 and its bias
    at the paper's default γ = 4; identity normalization. Float32 tensors
    on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)

    def dense(fan_in, fan_out):
        w = torch.empty((fan_in, fan_out), **f32)
        return w.normal_(0.0, 1.0, generator=gen) * math.sqrt(2.0 / fan_in)

    w_in, w_out = dense(FEATURE_DIM, hidden), dense(hidden, 1) * 0.1
    blocks = tuple((dense(hidden, hidden), torch.zeros(hidden, **f32),
                    dense(hidden, hidden), torch.zeros(hidden, **f32))
                   for _ in range(n_blocks))
    return WCDNNParams(
        feat_mean=torch.zeros(FEATURE_DIM, **f32),
        feat_std=torch.ones(FEATURE_DIM, **f32),
        w_in=w_in, b_in=torch.zeros(hidden, **f32), blocks=blocks,
        w_out=w_out, b_out=torch.full((1,), 4.0, **f32))


def set_normalization(params: WCDNNParams,
                      x: torch.Tensor) -> WCDNNParams:
    """The feature statistics of ``x`` (N, FEATURE_DIM): mean and the
    population std, floored at 1e-3."""
    return params._replace(
        feat_mean=x.mean(dim=0),
        feat_std=torch.clamp(x.std(dim=0, correction=0), min=1e-3))


def forward(params: WCDNNParams, x: torch.Tensor) -> torch.Tensor:
    """x: (..., FEATURE_DIM) → (...,) continuous γ prediction."""
    h = (x - params.feat_mean) / params.feat_std
    h = F.silu(h @ params.w_in + params.b_in)
    for (w1, b1, w2, b2) in params.blocks:
        r = F.silu(h @ w1 + b1)
        h = h + F.silu(r @ w2 + b2)
    return (h @ params.w_out + params.b_out)[..., 0]


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").numpy()
    return np.asarray(v)


def numpy_predictor(params: WCDNNParams) -> Callable[[list[float]], float]:
    """Sub-microsecond per-call inference for the serving loop (numpy or
    tensor parameters; tensors are copied to the host once)."""
    mean = _numpy(params.feat_mean)
    std = _numpy(params.feat_std)
    w_in, b_in = _numpy(params.w_in), _numpy(params.b_in)
    blocks = [tuple(map(_numpy, blk)) for blk in params.blocks]
    w_out, b_out = _numpy(params.w_out), _numpy(params.b_out)

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


def save(params: WCDNNParams, path: str) -> None:
    """The reference's ``.npz`` layout (``blk{i}_w1`` … and ``n_blocks``),
    so ``repro.core.awc.model.load`` reads it."""
    flat = {
        "feat_mean": params.feat_mean, "feat_std": params.feat_std,
        "w_in": params.w_in, "b_in": params.b_in,
        "w_out": params.w_out, "b_out": params.b_out,
        "n_blocks": np.asarray(len(params.blocks)),
    }
    for i, (w1, b1, w2, b2) in enumerate(params.blocks):
        flat[f"blk{i}_w1"], flat[f"blk{i}_b1"] = w1, b1
        flat[f"blk{i}_w2"], flat[f"blk{i}_b2"] = w2, b2
    np.savez(path, **{k: _numpy(v) for k, v in flat.items()})


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
