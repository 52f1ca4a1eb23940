"""Plain PyTorch versions of the SSD scan (kernel B5), the port of the
reference oracles ``repro/kernels/ssd/ref.py`` and of the chunked jnp path
``repro/models/ssm.py`` (``ssd_chunk`` / ``ssd_chunked``).

- :func:`ssd_recurrent_reference` — the literal token-by-token recurrence,
  the ground truth;
- :func:`ssd_chunked_plain` — the chunked SSD algorithm as einsums, what
  the CPU path runs and what ``chip_smoke.py`` holds the kernel to;
- :func:`ssd_state_passing_plain` — the kernel's three-phase decomposition
  (chunk states, a pass over the chunks, outputs) in its chunk of 64
  tokens; the CPU tests hold it to the reference, and no path runs it.

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


KERNEL_CHUNK = 64   # the CUDA kernel's chunk (``csrc/ssd_scan.cuh`` kL)


def ssd_state_passing_plain(x, Bm, Cm, dt, A, h_in,
                            chunk: int = KERNEL_CHUNK):
    """The scan as B5 computes it, in three phases over ``chunk``-token
    chunks whose boundaries depend on the token index alone:

    1. per (b, chunk, head) the chunk's own contribution
       Σ_s exp(Lc_L − Lc_s)·dt_s·x_s ⊗ B_s and its decay exp(Lc_L), Lc the
       cumsum of A·dt inside the chunk (the last chunk is cut at S, its
       Lc_L the last real row's);
    2. the chunks in index order, h ← decay·h + contribution: each chunk's
       starting state, and h_out;
    3. per chunk y = exp(Lc)·(C·h_startᵀ) + ((C·Bᵀ) ∘ causal ∘
       exp(Lc_t − Lc_s) ∘ dt_s)·x, C·Bᵀ once per (b, chunk) for every head.

    Returns (y (B, S, nh, hd) f32, h_out (B, nh, hd, N) f32)."""
    B, S, nh, hd = x.shape
    h = h_in.float()
    A = A.float()
    contrib, decay, parts = [], [], []
    for c0 in range(0, S, chunk):                         # phase 1
        sl = slice(c0, min(S, c0 + chunk))
        x32, B32 = x[:, sl].float(), Bm[:, sl].float()
        Lc = torch.cumsum(A[None, None, :] * dt[:, sl].float(), dim=1)
        w = torch.exp(Lc[:, -1:, :] - Lc) * dt[:, sl].float()
        contrib.append(torch.einsum("blhd,blh,bln->bhdn", x32, w, B32))
        decay.append(torch.exp(Lc[:, -1, :]))
        parts.append((sl, Lc))
    starts = []
    for cb, dc in zip(contrib, decay):                    # phase 2
        starts.append(h)
        h = dc[..., None, None] * h + cb
    ys = []
    for (sl, Lc), h0 in zip(parts, starts):               # phase 3
        C32, B32 = Cm[:, sl].float(), Bm[:, sl].float()
        L = Lc.shape[1]
        cb = torch.einsum("btn,bsn->bts", C32, B32)
        seg = Lc[:, :, None, :] - Lc[:, None, :, :]       # (B, t, s, nh)
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        scores = torch.where(causal, cb[..., None] * torch.exp(seg)
                             * dt[:, sl].float()[:, None, :, :],
                             torch.zeros_like(seg))
        y_state = torch.einsum("btn,bhdn->bthd", C32, h0) \
            * torch.exp(Lc)[..., None]
        ys.append(y_state + torch.einsum("btsh,bshd->bthd", scores,
                                         x[:, sl].float()))
    y = (torch.cat(ys, dim=1) if ys
         else x.new_zeros(x.shape, dtype=torch.float32))
    return y, h
