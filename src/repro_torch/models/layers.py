"""Shared neural-net layers: RMSNorm, rotary embeddings, SwiGLU, init."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               dtype: torch.dtype, device: torch.device,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan_in) drawn directly in ``dtype`` on ``device`` (the
    reference draws f32 and casts; at full width the f32 copy of both
    models would not fit the card, so the port never makes one)."""
    fan_in = fan_in or shape[0]
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings (applied per absolute position; GQA-friendly)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (float(theta) ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., T, 1, half) for :func:`apply_rope`."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               angles: Optional[tuple] = None) -> torch.Tensor:
    """x: (..., T, H, head_dim); positions: broadcastable to (..., T).
    Half-split rotation in f32. ``angles`` reuses precomputed tables."""
    half = x.shape[-1] // 2
    cos, sin = angles if angles is not None else rope_angles(
        positions, x.shape[-1], theta)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down
