"""Plain float32 PyTorch pieces of the reference models: norms, rotary
embeddings, causal attention, the SwiGLU MLP and the lm head. Nothing here
imports the program. Matrices are cast to float32 one at a time as they
are used, so the reference holds the served weights plus one float32
matrix.

``q8`` turns a reference into the control: every matrix product and the
attention's q, k and v take their inputs rounded to float8 e4m3 (per row
for activations, per output column for weights, each scaled to the
format's range), accumulating in float32, the precision step below the
served bfloat16."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ROWS = 4096          # rows of a matrix product at once


def fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


def mm(x: torch.Tensor, w: torch.Tensor, q8: bool = False) -> torch.Tensor:
    """x (N, i) float32 @ w (i, o) → (N, o) float32, in row blocks."""
    w = w.float()
    if q8:
        w = fp8(w, dim=0)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(0, x.shape[0], ROWS):
        xi = x[i:i + ROWS]
        out[i:i + ROWS] = (fp8(xi) if q8 else xi) @ w
    return out


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis, scaled by (1 + w)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding: x (T, H, hd), pos (T,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                          device=x.device) / half))
    ang = (pos.double()[:, None] * freqs[None, :]).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x: torch.Tensor, p: dict, s: dict, lens: list,
              q8: bool = False) -> torch.Tensor:
    """Causal grouped-query self-attention over packed sequences: x (N, d)
    is the sequences of ``lens`` end to end, each at positions 0..T-1.
    Returns the output projection (N, d)."""
    d, H, Hkv, hd = s["d"], s["H"], s["Hkv"], s["hd"]
    N = x.shape[0]
    q = mm(x, p["wq"].reshape(d, H * hd), q8).view(N, H, hd)
    k = mm(x, p["wk"].reshape(d, Hkv * hd), q8).view(N, Hkv, hd)
    v = mm(x, p["wv"].reshape(d, Hkv * hd), q8).view(N, Hkv, hd)
    if "bq" in p:
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), v + p["bv"].float()
    if s["qk_norm"]:
        q = rms(q, p["q_norm"], s["eps"])
        k = rms(k, p["k_norm"], s["eps"])
    ctx = torch.empty((N, H, hd), dtype=torch.float32, device=x.device)
    off = 0
    for T in lens:
        pos = torch.arange(T, device=x.device)
        qs = rope(q[off:off + T], pos, s["theta"])
        ks = rope(k[off:off + T], pos, s["theta"])
        vs = v[off:off + T]
        if q8:
            qs, ks, vs = fp8(qs), fp8(ks), fp8(vs)
        ks = ks.repeat_interleave(H // Hkv, dim=1)
        vs = vs.repeat_interleave(H // Hkv, dim=1)
        sc = torch.einsum("thd,shd->hts", qs, ks) / math.sqrt(hd)
        mask = torch.ones((T, T), dtype=torch.bool,
                          device=x.device).tril_()
        sc.masked_fill_(~mask, float("-inf"))
        ctx[off:off + T] = torch.einsum("hts,shd->thd",
                                        torch.softmax(sc, dim=-1), vs)
        del sc
        off += T
    return mm(ctx.view(N, H * hd), p["wo"].reshape(H * hd, d), q8)


def mlp(x: torch.Tensor, p: dict, q8: bool = False) -> torch.Tensor:
    out = torch.empty((x.shape[0], p["w_down"].shape[-1]),
                      dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], ROWS):
        xi = x[i:i + ROWS]
        h = F.silu(mm(xi, p["w_gate"], q8)) * mm(xi, p["w_up"], q8)
        out[i:i + ROWS] = mm(h, p["w_down"], q8)
    return out


def layer(tree: dict, l: int) -> dict:
    return {k: (layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


def head(params: dict, s: dict, h: torch.Tensor,
         q8: bool = False) -> torch.Tensor:
    """Final norm and lm head: hidden rows (R, d) → float32 logits (R, V)."""
    w = params["embed"].T if s["tied"] else params["lm_head"]
    return mm(rms(h, params["final_norm"], s["eps"]), w, q8)


def embed(params: dict, seqs: list) -> torch.Tensor:
    """The packed sequences' embeddings (N, d) float32."""
    ids = torch.cat([torch.as_tensor(t, dtype=torch.long) for t in seqs])
    return params["embed"][ids.to(params["embed"].device)].float()
