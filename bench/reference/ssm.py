"""Plain float32 reference of a Mamba2 stack (SSD, arXiv:2405.21060). Per
layer: x = RMSNorm(h); in_proj → z, xBC, dt; causal depthwise conv over
xBC (zero history) and SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
per head

    y_t = sum_{s<=t} exp(sum_{s<k<=t} A dt_k) (C_t . B_s) dt_s x_s + D x_t,

written as the whole (T, T) quadratic form (the decay sums in float64);
then RMSNorm(y * SiLU(z)) → out_proj, added to h."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.common import embed, fp8, layer, mm, rms


def mamba(h: torch.Tensor, lp: dict, s: dict, lens: list,
          q8: bool = False) -> torch.Tensor:
    """One residual Mamba2 layer over packed sequences h (N, d)."""
    p = lp["ssm"]
    din, N, nh, P, K = s["din"], s["N"], s["nh"], s["P"], s["K"]
    x = rms(h, lp["ln1"], s["eps"])
    zxbcdt = mm(x, p["in_proj"], q8)
    z, xbc, dt = (zxbcdt[:, :din], zxbcdt[:, din:2 * din + 2 * N],
                  zxbcdt[:, 2 * din + 2 * N:])
    w, b = p["conv_w"].float(), p["conv_b"].float()
    A = -torch.exp(p["A_log"].float())
    y = torch.empty((h.shape[0], din), dtype=torch.float32, device=h.device)
    off = 0
    for T in lens:
        seg = xbc[off:off + T]
        ext = torch.cat([seg.new_zeros((K - 1, seg.shape[1])), seg])
        conv = sum(ext[i:i + T] * w[i] for i in range(K)) + b
        conv = F.silu(conv)
        xs = conv[:, :din].view(T, nh, P)
        Bm, Cm = conv[:, din:din + N], conv[:, din + N:]
        if q8:
            xs, Bm, Cm = fp8(xs), fp8(Bm), fp8(Cm)
        dts = F.softplus(dt[off:off + T] + p["dt_bias"].float())   # (T, nh)
        cum = torch.cumsum((dts * A).double(), dim=0)               # (T, nh)
        seg_sum = cum.T[:, :, None] - cum.T[:, None, :]             # (nh,t,s)
        causal = torch.ones((T, T), dtype=torch.bool,
                            device=h.device).tril_()
        decay = torch.exp(seg_sum.masked_fill(~causal, float("-inf"))
                          ).float()
        del seg_sum
        m = decay * (Cm @ Bm.T)[None]                               # (nh,t,s)
        del decay
        u = dts.T[:, :, None] * xs.permute(1, 0, 2)                 # (nh,s,P)
        ys = torch.bmm(m, u).permute(1, 0, 2)                       # (t,nh,P)
        del m
        ys = ys + p["D"].float()[None, :, None] * xs
        y[off:off + T] = ys.reshape(T, din)
        off += T
    y = rms(y * F.silu(z), p["norm"], s["eps"])
    return h + mm(y, p["out_proj"], q8)


def hidden(params: dict, s: dict, seqs: list, q8: bool = False
           ) -> torch.Tensor:
    lens = [len(t) for t in seqs]
    h = embed(params, seqs)
    for l in range(s["L"]):
        h = mamba(h, layer(params["layers"], l), s, lens, q8)
    return h
