"""Plain PyTorch versions of the SSD scan (kernel B5), the port of the
reference oracles ``repro/kernels/ssd/ref.py`` and of the chunked jnp path
``repro/models/ssm.py`` (``ssd_chunk`` / ``ssd_chunked``).

- :func:`ssd_recurrent_reference` — the literal token-by-token recurrence,
  the ground truth;
- :func:`ssd_chunked_plain` — the chunked SSD algorithm as einsums, what
  the CPU path runs and what ``chip_smoke.py`` holds the kernel to.

Shapes: x (B, S, nh, hd); Bm, Cm (B, S, N) shared across heads; dt
(B, S, nh) f32, already softplus'ed; A (nh,) f32, negative; h_in
(B, nh, hd, N) f32. Arithmetic is f32 whatever the x/B/C type."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_recurrent_reference(x, Bm, Cm, dt, A, h_in):
    """h_t = exp(A·dt_t)·h_{t−1} + dt_t·x_t ⊗ B_t, y_t = C_t·h_t, one token
    at a time. Returns (y (B, S, nh, hd) f32, h_out (B, nh, hd, N) f32)."""
    h = h_in.float()
    ys = []
    for t in range(x.shape[1]):
        xt, bt, ct, dtt = (x[:, t].float(), Bm[:, t].float(),
                           Cm[:, t].float(), dt[:, t].float())
        a = torch.exp(A[None, :] * dtt)                       # (B, nh)
        upd = torch.einsum("bh,bn,bhd->bhdn", dtt, bt, xt)
        h = a[..., None, None] * h + upd
        ys.append(torch.einsum("bn,bhdn->bhd", ct, h))
    y = (torch.stack(ys, dim=1) if ys
         else x.new_zeros(x.shape, dtype=torch.float32))
    return y, h


def ssd_chunk_plain(x, Bm, Cm, dt, A, h_in):
    """One chunk of L tokens (the reference's ``ssd_chunk``): the carried-in
    state's contribution, the masked (L, L) quadratic form inside the
    chunk, and the state carried out."""
    L = x.shape[1]
    x32, B32, C32 = x.float(), Bm.float(), Cm.float()
    Lc = torch.cumsum(A[None, None, :] * dt, dim=1)          # (B, L, nh)
    y_state = torch.einsum("bln,bhdn->blhd", C32, h_in) \
        * torch.exp(Lc)[..., None]
    seg = Lc[:, :, None, :] - Lc[:, None, :, :]               # (B, t, s, nh)
    causal = torch.ones((L, L), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    w = torch.where(causal, torch.exp(seg), torch.zeros_like(seg))
    cb = torch.einsum("btn,bsn->bts", C32, B32)
    scores = cb[..., None] * w * dt[:, None, :, :]
    y_intra = torch.einsum("btsh,bshd->bthd", scores, x32)
    decay_out = torch.exp(Lc[:, -1:, :] - Lc)                 # (B, L, nh)
    contrib = torch.einsum("blh,bln,blhd->bhdn", decay_out * dt, B32, x32)
    h_out = torch.exp(Lc[:, -1, :])[..., None, None] * h_in + contrib
    return y_state + y_intra, h_out


def ssd_chunked_plain(x, Bm, Cm, dt, A, h_in, chunk: int):
    """The chunked scan over ``chunk``-token chunks in order. S is padded
    to a chunk multiple with zero dt (identity steps: decay exp(0) = 1,
    contribution 0), as the reference glue pads; the padded y rows are cut.
    Returns (y (B, S, nh, hd) f32, h_out f32)."""
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    h = h_in.float()
    ys = []
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        y, h = ssd_chunk_plain(x[:, sl], Bm[:, sl], Cm[:, sl],
                               dt[:, sl].float(), A.float(), h)
        ys.append(y)
    y = (torch.cat(ys, dim=1)[:, :S] if ys
         else x.new_zeros(x.shape, dtype=torch.float32))
    return y, h
