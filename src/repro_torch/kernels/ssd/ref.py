"""Plain PyTorch versions of the SSD scan (kernel B5), the port of the
reference oracles ``repro/kernels/ssd/ref.py`` and of the chunked jnp path
``repro/models/ssm.py`` (``ssd_chunk`` / ``ssd_chunked``).

- :func:`ssd_recurrent_reference` — the literal token-by-token recurrence,
  the ground truth;
- :func:`ssd_chunked_plain` — the chunked SSD algorithm as einsums over
  every chunk at once, what the CPU path and the meta device's dry-run
  run and what ``chip_smoke.py`` holds the kernel to;
- :func:`ssd_state_passing_plain` — the kernel's three-phase decomposition
  (chunk states, a pass over the chunks, outputs) in its chunk of 64
  tokens; the CPU tests hold it to the reference, and no path runs it;
- :func:`ssd_chunked_plain_bwd` — the scan's gradient as autograd of
  :func:`ssd_chunked_plain`: what ``chip_smoke.py`` holds ``ssd_scan_bwd``
  to (the CPU path of training differentiates the plain scan the same way);
- :func:`ssd_chunked_bwd_plain` — the gradient as ``ssd_scan_bwd``
  computes it (B5's chunks in reverse: chunk states, dstates, a reverse
  pass over the chunks, then per chunk the input gradients and da as a
  sum over a rectangle); the CPU tests hold it to the reference, and no
  path runs it;
- :func:`ssd_reverse_recurrence_bwd` — the gradient by the token-by-token
  reverse recurrence of ∂L/∂h, the ground truth; no path runs it.

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


def ssd_chunked_plain(x, Bm, Cm, dt, A, h_in, chunk: int):
    """The chunked scan over ``chunk``-token chunks (the reference's
    ``ssd_chunked``), every chunk at once: in each chunk the masked (L, L)
    quadratic form and the chunk's own contribution to the state, then the
    states entering the chunks as one strictly-lower (nc, nc) decay product
    over the chunks' total decays, Σ_{j<c} exp(Σ_{j<k<c} D_k)·contrib_j +
    exp(Σ_{k<c} D_k)·h_in. A few dozen ops whatever S, which the meta
    device's dry-run needs as much as the CPU. S is padded to a chunk
    multiple with zero dt (identity steps: decay exp(0) = 1, contribution
    0), as the reference glue pads; the padded y rows are cut. Returns
    (y (B, S, nh, hd) f32, h_out f32)."""
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    f = torch.float32
    if S == 0:
        return x.new_zeros(x.shape, dtype=f), h_in.to(f)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc, L = (S + pad) // chunk, chunk
    xc = x.to(f).reshape(Bsz, nc, L, nh, hd)
    Bc = Bm.to(f).reshape(Bsz, nc, L, N)
    Cc = Cm.to(f).reshape(Bsz, nc, L, N)
    dtc = dt.to(f).reshape(Bsz, nc, L, nh)
    Lc = torch.cumsum(A.to(f) * dtc, dim=2)                  # (B, nc, L, nh)
    # masked before the exp, not after: the same values (exp(−inf) = 0),
    # but the gradient of exp at the masked entries, where the segment sum
    # is > 0 and can overflow, is 0·0 instead of 0·inf = NaN (the
    # reference's where(mask, exp(seg), 0) has that NaN in its gradient)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    seg = Lc[:, :, :, None] - Lc[:, :, None]            # (B, nc, t, s, nh)
    w = torch.exp(torch.where(tri[:, :, None], seg,
                              torch.full_like(seg, float("-inf"))))
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    scores = cb[..., None] * w * dtc[:, :, None]
    y_intra = torch.einsum("bctsh,bcshd->bcthd", scores, xc)
    wout = torch.exp(Lc[:, :, -1:] - Lc) * dtc
    contrib = torch.einsum("bclh,bcln,bclhd->bchdn", wout, Bc, xc)
    D = Lc[:, :, -1]                                         # (B, nc, nh)
    cum = torch.cumsum(D, dim=1)
    excl = F.pad(cum, (0, 0, 1, 0))[:, :nc]                   # Σ_{k<c} D_k
    # run[i, j] = Σ_{j<k≤i} D_k, a cumsum over i of D_i masked to i > j:
    # a sum over its own range, not a difference of two long prefix sums
    # (in f32 that difference loses the decay's low bits a few thousand
    # tokens in); the state entering chunk c carries chunk j's
    # contribution by run[c − 1, j], j < c
    strict = torch.ones((nc, nc), dtype=torch.bool,
                        device=x.device).tril(-1)
    run = torch.cumsum(torch.where(strict[:, :, None], D[:, :, None],
                                   torch.zeros_like(D[:, :, None])), dim=1)
    segc = F.pad(run, (0, 0, 0, 0, 1, 0))[:, :nc]            # (B, c, j, nh)
    wc = torch.exp(torch.where(strict[:, :, None], segc,
                               torch.full_like(segc, float("-inf"))))
    h_in = h_in.to(f)
    starts = torch.einsum("bcjh,bjhdn->bchdn", wc, contrib) \
        + torch.exp(excl)[..., None, None] * h_in[:, None]
    y_state = torch.einsum("bctn,bchdn->bcthd", Cc, starts) \
        * torch.exp(Lc)[..., None]
    y = (y_intra + y_state).reshape(Bsz, nc * L, nh, hd)[:, :S]
    h_out = torch.exp(cum[:, -1])[..., None, None] * h_in + torch.einsum(
        "bjh,bjhdn->bhdn", torch.exp(run[:, -1]), contrib)
    return y, h_out


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


def ssd_chunked_plain_bwd(x, Bm, Cm, dt, A, h_in, dy, dh_out,
                          chunk: int = KERNEL_CHUNK):
    """Gradients of :func:`ssd_chunked_plain`'s (y, h_out) with respect to
    (x, Bm, Cm, dt, A, h_in), given dy and dh_out, by autograd; each comes
    back in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (x, Bm, Cm, dt, A, h_in)]
        y, h = ssd_chunked_plain(*ins, chunk)
        return torch.autograd.grad((y, h), ins, (dy, dh_out))


def ssd_chunked_bwd_plain(x, Bm, Cm, dt, A, h_in, dy, dh_out,
                          chunk: int = KERNEL_CHUNK):
    """The scan's gradient as ``ssd_scan_bwd`` computes it: B5's chunks run
    in reverse, as einsums over ``chunk``-token chunks whose boundaries
    depend on the token index alone (the last cut at S). Inside a chunk
    a_r = A·dt_r, Lc its inclusive cumsum, and every weight is the exp of a
    sum of a over a range, exp(Σ_{(s,t]} a) ≤ 1:

    0. the chunks' starting states h_c (B5's phases 1–2);
    1. D_c = (exp(Lc) ∘ dy)ᵀ · C, the gradient on h_c of the chunk's own
       y_state term;
    2. the reverse pass: G (the gradient at the chunk's end state) starts at
       dh_out, G_{c−1} = exp(Lc_end)·G_c + D_c, dh_in = the last G;
    3. per chunk, from G_c and h_c: dx, dB, dC (summed over heads), and da_r
       = ∂L/∂a_r as a sum over the rectangle s < r ≤ t of the pairs (s, t)
       whose weight holds a_r — intra (s, t), y_state (−1, t), contribution
       (s, end), decay (−1, end) — with no difference of two cumsums; ddt =
       x·(dx/dt) + A·da, dA = Σ dt·da.

    Returns (dx, dBm, dCm in x's dtype; ddt, dA, dh_in float32). No path
    runs it: the CPU tests hold it to the reference's ``jax.vjp``."""
    Bsz, S, nh, hd = x.shape
    f = torch.float32
    x32, B32, C32 = x.to(f), Bm.to(f), Cm.to(f)
    dt32, A32, dy32 = dt.to(f), A.to(f), dy.to(f)
    spans = [(c0, min(S, c0 + chunk)) for c0 in range(0, S, chunk)]
    Lcs, starts, h = [], [], h_in.to(f)
    for c0, c1 in spans:                                     # phase 0
        Lc = torch.cumsum(A32 * dt32[:, c0:c1], dim=1)       # (B, L, nh)
        w = torch.exp(Lc[:, -1:] - Lc) * dt32[:, c0:c1]
        starts.append(h)
        h = torch.exp(Lc[:, -1])[..., None, None] * h + torch.einsum(
            "blhd,blh,bln->bhdn", x32[:, c0:c1], w, B32[:, c0:c1])
        Lcs.append(Lc)
    D = [torch.einsum("bth,bthd,btn->bhdn", torch.exp(Lc),     # phase 1
                      dy32[:, c0:c1], C32[:, c0:c1])
         for (c0, c1), Lc in zip(spans, Lcs)]
    Gs, G = [None] * len(spans), dh_out.to(f)
    for c in reversed(range(len(spans))):                    # phase 2
        Gs[c] = G
        G = torch.exp(Lcs[c][:, -1])[..., None, None] * G + D[c]
    dx, dB, dC = torch.zeros_like(x32), torch.zeros_like(B32), \
        torch.zeros_like(C32)
    ddt, dA = torch.zeros_like(dt32), torch.zeros_like(A32)
    for (c0, c1), Lc, Gc, hc in zip(spans, Lcs, Gs, starts):  # phase 3
        L = c1 - c0
        xc, Bc, Cc = x32[:, c0:c1], B32[:, c0:c1], C32[:, c0:c1]
        dtc, dyc = dt32[:, c0:c1], dy32[:, c0:c1]
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        E = torch.exp(torch.where(causal, Lc[:, :, None] - Lc[:, None],
                                  torch.full((), float("-inf"))))
        CB = torch.einsum("btn,bsn->bts", Cc, Bc)[..., None]  # (B, t, s, 1)
        ee = torch.exp(Lc[:, -1:] - Lc)                        # (B, s, nh)
        el = torch.exp(Lc)                                     # (B, t, nh)
        GB = ee[..., None] * torch.einsum("bhdn,bsn->bshd", Gc, Bc)
        U = GB + torch.einsum("btsh,bthd->bshd", CB * E, dyc)  # dx / dt
        P = torch.einsum("bthd,bshd->btsh", dyc, xc) * E * dtc[:, None]
        Ys = el[..., None] * torch.einsum("bthd,bhdn->bthn", dyc, hc)
        dx[:, c0:c1] = dtc[..., None] * U
        dB[:, c0:c1] = torch.einsum("bsh,bshd,bhdn->bsn", dtc * ee, xc,
                                    Gc) + torch.einsum("btsh,btn->bsn", P,
                                                       Cc)
        dC[:, c0:c1] = Ys.sum(2) + torch.einsum("btsh,bsn->btn", P, Bc)
        # da_r: the intra pairs s < r ≤ t as a column suffix over t, then a
        # row sum over s < r; y_state pairs t ≥ r; contributions s < r;
        # the decay pair, every r
        v = P * CB
        suffix = torch.flip(torch.cumsum(torch.flip(v, [1]), 1), [1])
        strict = torch.ones((L, L), dtype=torch.bool,
                            device=x.device).tril(-1)[None, :, :, None]
        da = (suffix * strict).sum(2)
        ystate = torch.einsum("bthn,btn->bth", Ys, Cc)
        da = da + torch.flip(torch.cumsum(torch.flip(ystate, [1]), 1), [1])
        contrib = dtc * torch.einsum("bshd,bshd->bsh", xc, GB)
        da = da + F.pad(torch.cumsum(contrib, 1), (0, 0, 1, 0))[:, :L]
        da = da + (torch.exp(Lc[:, -1]) * torch.einsum(
            "bhdn,bhdn->bh", Gc, hc))[:, None]
        ddt[:, c0:c1] = torch.einsum("bshd,bshd->bsh", xc, U) + A32 * da
        dA = dA + (dtc * da).sum((0, 1))
    return (dx.to(x.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype), ddt, dA, G)


def ssd_reverse_recurrence_bwd(x, Bm, Cm, dt, A, h_in, dy, dh_out,
                               interval: int = 8):
    """The scan's gradient by the token-by-token reverse recurrence, in
    float32 (the ground truth of the chunked forms; no path runs it):

    - forward over the sequence from h_in, keeping the state at the start
      of every group of ``interval`` steps;
    - the groups from the last: re-run the group from its checkpoint
      keeping every h_t, then walk it backwards carrying g = ∂L/∂h_t,
      g_t = dy_t ⊗ C_t + a_{t+1}·g_{t+1} (g starts at dh_out), with
      dx_t = dt_t·(g_t·B_t), dB_t = dt_t·Σ_{head,d} g_t x_t, dC_t =
      Σ_{head,d} dy_t h_t, dla_t = a_t·<g_t, h_{t−1}>, ddt_t = x_t·(g_t·B_t)
      + A·dla_t, dA = Σ dt_t·dla_t, and dh_in = a_0·g_0.

    Returns (dx, dBm, dCm in x's dtype; ddt, dA, dh_in float32)."""
    Bsz, S, nh, hd = x.shape
    x32, B32, C32 = x.float(), Bm.float(), Cm.float()
    dt32, A32, dy32 = dt.float(), A.float(), dy.float()
    a = torch.exp(A32[None, None, :] * dt32)                   # (B, S, nh)

    def step(h, t):
        return (a[:, t, :, None, None] * h + dt32[:, t, :, None, None]
                * x32[:, t, :, :, None] * B32[:, t, None, None, :])

    ckpts, h = [], h_in.float()
    for t0 in range(0, S, interval):
        ckpts.append(h)
        for t in range(t0, min(S, t0 + interval)):
            h = step(h, t)
    dx = torch.zeros_like(x32)
    dB, dC = torch.zeros_like(B32), torch.zeros_like(C32)
    ddt, dA = torch.zeros_like(dt32), torch.zeros_like(A32)
    g = dh_out.float()
    a_next = torch.ones_like(a[:, 0])
    for j in reversed(range(len(ckpts))):
        t0 = j * interval
        hist = [ckpts[j]]
        for t in range(t0, min(S, t0 + interval)):
            hist.append(step(hist[-1], t))
        for t in reversed(range(t0, min(S, t0 + interval))):
            h_t, h_prev = hist[t - t0 + 1], hist[t - t0]
            g = a_next[..., None, None] * g \
                + dy32[:, t, :, :, None] * C32[:, t, None, None, :]
            gB = (g * B32[:, t, None, None, :]).sum(-1)          # (B, nh, hd)
            dx[:, t] = dt32[:, t, :, None] * gB
            dB[:, t] = (dt32[:, t, :, None, None] * g
                        * x32[:, t, :, :, None]).sum((1, 2))
            dC[:, t] = (dy32[:, t, :, :, None] * h_t).sum((1, 2))
            dla = a[:, t] * (g * h_prev).sum((-1, -2))           # (B, nh)
            xg = (x32[:, t] * gB).sum(-1)
            ddt[:, t] = xg + A32 * dla
            dA = dA + (dt32[:, t] * dla).sum(0)
            a_next = a[:, t]
    return (dx.to(x.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype), ddt, dA,
            a_next[..., None, None] * g)
