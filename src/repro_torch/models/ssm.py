"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060], the port
of the reference ``repro/models/ssm.py``.

Scalar-A-per-head SSD recurrence::

    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t ⊗ x_t        (state: hd × N)
    y_t = C_t · h_t + D ⊙ x_t

- :func:`ssm_block_train` — prefill and the verify window (T > 1): the
  chunked scan through :func:`~repro_torch.kernels.ssd.ssd_chunked_kernel`,
  whose device rule runs kernel B5 on the card and its plain version on
  the CPU (the reference's ``use_kernel`` flag is gone: the device picks);
- :func:`ssm_block_decode` — the single-token step, :func:`ssd_decode_step`.

Both return a FRESH state (new conv-tail and SSD-state tensors) and never
write the state they were given: speculative decoding verifies and drafts
from the window-start state and re-advances it over the accepted tokens
(the engine's split step), so that state must survive the round.
Parameters are layer-stacked in the model (``layers.ssm.in_proj`` is
(L, D, E)); the functions here take one layer's slice."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd import ssd_chunked_kernel
from .layers import dense_init, rms_norm


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_state


def init_ssm_params(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                    n_layers: int) -> dict:
    """Layer-stacked (L, ...) Mamba2 weights, reference layout and init:
    in_proj emits [z (d_inner), xBC (d_inner + 2N), dt (nh)]; A_log, D and
    dt_bias are f32, the rest is in the model dtype."""
    d, din, nh, st = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads,
                      cfg.ssm_state)
    L, K, cd = n_layers, cfg.ssm_conv, conv_dim(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    per_layer = lambda v: v.expand(L, nh).contiguous()
    return {
        "in_proj": dense_init(gen, (L, d, 2 * din + 2 * st + nh), dtype,
                              device, fan_in=d),
        "conv_w": dense_init(gen, (L, K, cd), dtype, device, fan_in=K),
        "conv_b": torch.zeros((L, cd), dtype=dtype, device=device),
        "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, nh, **f32))),
        "D": torch.ones((L, nh), **f32),
        "dt_bias": per_layer(torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, nh, **f32)))),
        "norm": torch.zeros((L, din), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (L, din, d), dtype, device, fan_in=din),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    din, st, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    return (zxbcdt[..., :din], zxbcdt[..., din:din + din + 2 * st],
            zxbcdt[..., -nh:])


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor):
    """Depthwise causal conv over time. xBC (B, S, C), w (K, C), ``tail``
    (B, K−1, C) the carried-in inputs. Returns (silu(conv) in xBC's type,
    the last K−1 inputs)."""
    K, S = w.shape[0], xBC.shape[1]
    ext = torch.cat([tail, xBC], dim=1)                 # (B, S+K−1, C)
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(K):
        out = out + ext[:, i:i + S].float() * w[i].float()
    out = F.silu(out + b.float()).to(xBC.dtype)
    return out, (ext[:, S:] if K > 1 else tail)


class SSDState(NamedTuple):
    h: torch.Tensor           # (B, nh, hd, N) float32
    conv_tail: torch.Tensor   # (B, K−1, conv_dim)


def ssd_decode_step(x, Bm, Cm, dt, A, h_in):
    """Single-token recurrence. x (B, nh, hd); Bm, Cm (B, N); dt (B, nh)."""
    a = torch.exp(A[None, :] * dt)                             # (B, nh)
    upd = torch.einsum("bh,bn,bhd->bhdn", dt, Bm.float(), x.float())
    h = a[..., None, None] * h_in + upd
    y = torch.einsum("bn,bhdn->bhd", Cm.float(), h)
    return y, h


def _gated_out(y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor, p: dict,
               cfg: ModelConfig, dtype) -> torch.Tensor:
    """D skip, SiLU(z) gate, RMSNorm, out projection. y/xs (B, S, nh, hd)."""
    B, S = y.shape[:2]
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, cfg.ssm_d_inner).to(dtype)
    y = rms_norm(y * F.silu(z.float()).to(dtype), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def ssm_block_train(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    state: Optional[SSDState] = None,
                    seq_lens: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, SSDState]:
    """x (B, S, D) → (y (B, S, D), the state after the sequence).

    ``seq_lens`` (B,) — right-padded batches: positions ≥ len are identity
    steps of the recurrence (dt masked to 0 after softplus: decay 1,
    contribution 0) and the conv tail is gathered at each sequence's true
    end, so the returned state is exactly the state after the valid
    prefix."""
    B, S, _ = x.shape
    nh, hd, st, din = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                       cfg.ssm_d_inner)
    z, xBC_raw, dt = _split_proj(x @ p["in_proj"], cfg)
    K1 = cfg.ssm_conv - 1
    tail = (state.conv_tail if state is not None else
            torch.zeros((B, K1, xBC_raw.shape[-1]), dtype=x.dtype,
                        device=x.device))
    xBC, new_tail = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"], tail)
    if seq_lens is not None:
        # per-sequence tail: the raw inputs at positions len−K+1 .. len−1
        ext = torch.cat([tail, xBC_raw], dim=1)         # (B, K−1+S, C)
        idx = seq_lens.long()[:, None] + torch.arange(K1, device=x.device)
        new_tail = torch.gather(
            ext, 1, idx[..., None].expand(B, K1, ext.shape[-1]))
    xs = xBC[..., :din].reshape(B, S, nh, hd)
    Bm = xBC[..., din:din + st].contiguous()
    Cm = xBC[..., din + st:].contiguous()
    dt = F.softplus(dt.float() + p["dt_bias"])
    if seq_lens is not None:
        valid = torch.arange(S, device=x.device)[None, :] < seq_lens[:, None]
        dt = torch.where(valid[..., None], dt, torch.zeros_like(dt))
    A = -torch.exp(p["A_log"])
    h_in = (state.h if state is not None else
            torch.zeros((B, nh, hd, st), dtype=torch.float32,
                        device=x.device))
    chunk = min(cfg.ssm_chunk, S) or S
    y, h = ssd_chunked_kernel(xs.contiguous(), Bm, Cm, dt.contiguous(),
                              A.contiguous(), h_in.contiguous(), chunk)
    return (_gated_out(y, xs, z, p, cfg, x.dtype),
            SSDState(h=h, conv_tail=new_tail))


def ssm_block_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     state: SSDState) -> tuple[torch.Tensor, SSDState]:
    """Single-token step. x (B, 1, D)."""
    B = x.shape[0]
    nh, hd, st, din = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                       cfg.ssm_d_inner)
    z, xBC, dt = _split_proj(x @ p["in_proj"], cfg)
    # conv via explicit tail concat (width K): newest input last
    ext = torch.cat([state.conv_tail, xBC], dim=1)            # (B, K, C)
    K = p["conv_w"].shape[0]
    out = torch.einsum("bkc,kc->bc", ext[:, -K:].float(),
                       p["conv_w"].float())
    xBC1 = F.silu(out + p["conv_b"].float()).to(x.dtype)
    new_tail = ext[:, 1:] if K > 1 else state.conv_tail
    xs = xBC1[..., :din].reshape(B, nh, hd)
    dts = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h = ssd_decode_step(xs, xBC1[..., din:din + st], xBC1[..., din + st:],
                           dts, A, state.h)
    return (_gated_out(y[:, None], xs[:, None], z, p, cfg, x.dtype),
            SSDState(h=h, conv_tail=new_tail))
