"""The four production input shapes and their stand-ins, the port of the
reference ``repro/launch/shapes.py``:

    train_4k     seq_len=4096    global_batch=256   (training: train_step)
    prefill_32k  seq_len=32768   global_batch=32    (inference prefill)
    decode_32k   seq_len=32768   global_batch=128   (decode_step: 1 new
                                                     token, a 32k cache)
    long_500k    seq_len=524288  global_batch=1     (decode_step: SSM
                                                     state, or a ring-buffer
                                                     sliding window for
                                                     attention archs)

The reference's stand-in is ``jax.ShapeDtypeStruct``; the port's is a
tensor on the meta device: a shape and a dtype, no storage. Nothing here
allocates device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..models.model import Model


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"
    sliding: bool = False        # decode via ring-buffer sliding window


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode", sliding=True),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def cache_specs(model: Model, batch: int, slots: int, ring: bool,
                enc_frames: int = 0) -> Any:
    """The cache ``model.init_cache`` would build, on the meta device (no
    allocation, whatever ``model``'s device)."""
    return Model(model.cfg, "meta").init_cache(batch, slots, ring=ring,
                                               enc_frames=enc_frames)


def input_specs(cfg: ModelConfig, shape: InputShape, model: Model
                ) -> dict[str, Any]:
    """Meta stand-ins for every input of the step ``shape.kind`` selects
    (tokens/labels for train; tokens for prefill; token/cache/pos for
    decode), plus what the dry-run needs besides (``kind``, ``slots``,
    ``window``, ``ring``)."""
    B, S = shape.global_batch, shape.seq_len
    out: dict[str, Any] = {"kind": shape.kind}
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "train":
        text = S
        if cfg.arch_type == "vlm":
            # patches + text together fill the backbone's positions
            text = S - cfg.n_frontend_tokens
            out["frontend"] = _meta((B, cfg.n_frontend_tokens, cfg.d_model),
                                    f32)
        if cfg.arch_type == "encdec":
            out["frontend"] = _meta((B, cfg.n_frontend_tokens, cfg.d_model),
                                    f32)
        out["tokens"] = _meta((B, text), i32)
        out["labels"] = _meta((B, text), i32)
        return out

    if shape.kind == "prefill":
        out["tokens"] = _meta((B, S), i32)
        if cfg.arch_type == "encdec":
            out["frontend"] = _meta((B, cfg.n_frontend_tokens, cfg.d_model),
                                    f32)
        out["slots"] = S + 128
        return out

    # decode: ONE new token against a seq_len cache
    ring, window, slots = False, 0, S
    if shape.sliding and cfg.arch_type not in ("ssm",):
        # sub-quadratic serving for attention archs: a ring-buffer sliding
        # window (SSM/hybrid Mamba state is O(1) natively)
        ring = True
        window = cfg.serve_sliding_window
        slots = cfg.serve_sliding_window
    enc_frames = cfg.n_frontend_tokens if cfg.arch_type == "encdec" else 0
    out["token"] = _meta((B,), i32)
    out["pos"] = _meta((B,), i32)
    out["cache"] = cache_specs(model, B, slots, ring, enc_frames)
    out["window"] = window
    out["ring"] = ring
    return out
