"""Plain float32 reference of the dense GQA transformer (qwen3: q/k
RMSNorm; qwen2.5: q/k/v bias): embedding, per layer RMSNorm → attention →
residual → RMSNorm → SwiGLU → residual, final RMSNorm, lm head."""

from __future__ import annotations

import torch

from reference.common import attention, embed, layer, mlp, rms


def hidden(params: dict, s: dict, seqs: list, q8: bool = False
           ) -> torch.Tensor:
    """Last hidden states (N, d) float32 of the packed sequences, before
    the final norm."""
    lens = [len(t) for t in seqs]
    h = embed(params, seqs)
    for l in range(s["L"]):
        lp = layer(params["layers"], l)
        h = h + attention(rms(h, lp["ln1"], s["eps"]), lp["attn"], s, lens,
                          q8)
        h = h + mlp(rms(h, lp["ln2"], s["eps"]), lp["mlp"], q8)
    return h
