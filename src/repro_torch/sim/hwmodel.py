"""Hardware performance-modeling engine for DSD-Sim.

The paper plugs VIDUR's empirically-profiled per-op latency predictors into
the scheduler behind a single API: ``predict(op, shape, hardware)``. VIDUR's
GPU profiling tables are not part of this repository, so we implement an
*analytical roofline predictor* over a published-spec device catalog and
expose the identical API. A calibration hook (``fit_calibration``) scales the
analytic model against wall-clock measurements, mirroring the paper's Fig. 4
methodology of validating the modeling engine against real hardware. The
catalog holds data-sheet entries the simulator computes with, not
measurements; it is the reference's, unchanged, so that a simulation of one
spec and seed gives the reference's summary.

Latency model (per batched op):

    t = max(flops / (peak_flops * eff_f), bytes / (hbm_bw * eff_b))
        + tp_comm + overhead

where ``bytes`` counts the weight working set (read once per batch), KV-cache
traffic, and activation traffic; ``tp_comm`` models per-layer tensor-parallel
all-reduces over the intra-server link.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional


# --------------------------------------------------------------------------
# Device catalog (published peak specs; dense fp16/bf16 tensor FLOP/s)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops: float          # dense bf16/fp16 FLOP/s per chip
    hbm_bw: float              # bytes/s
    mem_bytes: float
    link_bw: float             # intra-server interconnect, bytes/s per direction
    flops_eff: float = 0.45    # achievable fraction of peak in serving kernels
    bw_eff: float = 0.65
    overhead_s: float = 2.0e-4  # per-dispatch launch/framework overhead


DEVICES: dict[str, DeviceSpec] = {
    # Edge GPUs serve one small model with resident weights; decode kernels
    # stream weights at ~85-90% of HBM bw (calibration note: this constant
    # positions the paper's Fig.6 distributed/fused crossover; see
    # benchmarks/fig6_rtt_crossover.py).
    "A40":   DeviceSpec("A40",   149.7e12, 696e9,  48e9,  32e9, bw_eff=0.88),
    "V100":  DeviceSpec("V100",  125.0e12, 900e9,  32e9,  150e9, bw_eff=0.88),
    "A6000": DeviceSpec("A6000", 154.8e12, 768e9,  48e9,  32e9),
    "A100":  DeviceSpec("A100",  312.0e12, 2039e9, 80e9,  300e9),
    "H100":  DeviceSpec("H100",  989.0e12, 3350e9, 80e9,  450e9),
    # TPU v5e (published spec).
    "TPUv5e": DeviceSpec("TPUv5e", 197.0e12, 819e9, 16e9, 50e9),
    # A CPU host; eff factors are fit by fit_calibration().
    "CPU":   DeviceSpec("CPU", 2.0e11, 2.0e10, 64e9, 1e10,
                        flops_eff=0.5, bw_eff=0.5, overhead_s=5e-4),
}


# --------------------------------------------------------------------------
# Model catalog — enough architecture detail for flop/byte accounting
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelDesc:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_experts: int = 0          # 0 = dense
    experts_per_tok: int = 0
    dtype_bytes: int = 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def params(self) -> int:
        """Total parameter count (attn + ffn + embeddings)."""
        attn = self.n_layers * (
            self.d_model * self.n_heads * self.head_dim        # Q
            + 2 * self.d_model * self.n_kv_heads * self.head_dim  # K,V
            + self.n_heads * self.head_dim * self.d_model      # O
        )
        ffn_mult = max(1, self.n_experts)
        ffn = self.n_layers * ffn_mult * 3 * self.d_model * self.d_ff  # SwiGLU
        emb = 2 * self.vocab * self.d_model
        return attn + ffn + emb

    @property
    def active_params(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.n_experts == 0:
            return self.params
        attn = self.n_layers * (
            self.d_model * self.n_heads * self.head_dim
            + 2 * self.d_model * self.n_kv_heads * self.head_dim
            + self.n_heads * self.head_dim * self.d_model
        )
        ffn = self.n_layers * self.experts_per_tok * 3 * self.d_model * self.d_ff
        emb = 2 * self.vocab * self.d_model
        return attn + ffn + emb

    def kv_bytes_per_token(self) -> int:
        return self.n_layers * 2 * self.n_kv_heads * self.head_dim * self.dtype_bytes


MODELS: dict[str, ModelDesc] = {
    # Paper's edge draft models
    "llama2-7b":   ModelDesc("llama2-7b",   32, 4096, 32, 32, 11008, 32000),
    "qwen-7b":     ModelDesc("qwen-7b",     32, 4096, 32, 32, 11008, 151936),
    "llama3.1-8b": ModelDesc("llama3.1-8b", 32, 4096, 32, 8, 14336, 128256),
    # Paper's cloud target models
    "llama2-70b":  ModelDesc("llama2-70b",  80, 8192, 64, 8, 28672, 32000),
    "llama3-70b":  ModelDesc("llama3-70b",  80, 8192, 64, 8, 28672, 128256),
    "qwen-72b":    ModelDesc("qwen-72b",    80, 8192, 64, 8, 24576, 152064),
}


def register_model(desc: ModelDesc) -> None:
    MODELS[desc.name] = desc


# --------------------------------------------------------------------------
# The predictor
# --------------------------------------------------------------------------

@dataclass
class OpShape:
    """Shape description for one batched op invocation.

    ``context_lens`` — per-sequence KV context length at execution time.
    ``new_tokens``   — tokens computed per sequence this invocation
                       (prompt length for prefill; γ+1 for verify; 1 for decode).
    """
    context_lens: list[int]
    new_tokens: list[int]

    @property
    def batch(self) -> int:
        return len(self.context_lens)

    @property
    def total_new(self) -> int:
        return sum(self.new_tokens)

    @property
    def padded_new(self) -> int:
        """Tokens actually computed under right-padding to the batch max."""
        return self.batch * max(self.new_tokens) if self.new_tokens else 0

    @property
    def padded_context(self) -> int:
        return self.batch * max(self.context_lens) if self.context_lens else 0


class HardwareModel:
    """``predict(op, shape, hardware)`` — the unified VIDUR-style API."""

    def __init__(self, calibration: Optional[dict[str, float]] = None):
        # multiplicative fudge factors fit against real measurements
        self.calibration = dict(calibration or {})

    # -- core roofline -----------------------------------------------------

    def _roofline_s(self, dev: DeviceSpec, flops: float, bytes_: float,
                    tp: int, act_bytes_comm: float) -> float:
        t_compute = flops / (dev.peak_flops * dev.flops_eff * tp)
        t_memory = bytes_ / (dev.hbm_bw * dev.bw_eff * tp)
        # ring all-reduce cost over tp chips: 2(tp-1)/tp of the payload per chip
        t_comm = 0.0
        if tp > 1:
            t_comm = 2.0 * (tp - 1) / tp * act_bytes_comm / dev.link_bw
        return max(t_compute, t_memory) + t_comm + dev.overhead_s

    def predict(self, op: str, shape: OpShape, hardware: str,
                model: str, tp: int = 1) -> float:
        """Latency in **seconds** for one batched invocation of ``op``.

        op ∈ {"prefill", "decode", "verify"}; "verify" is a decode-phase
        forward over γ+1 tokens per sequence (the SD verification step) and
        shares the decode cost model with multi-token new_tokens.
        """
        dev = DEVICES[hardware]
        m = MODELS[model]
        pad_new = max(1, shape.padded_new)
        weight_bytes = m.active_params * m.dtype_bytes
        if m.n_experts > 0:
            # Each token routes to experts_per_tok experts but a *batch* touches
            # min(E, batch·k) expert weight sets; approximate with saturation.
            touched = min(m.n_experts, max(1, shape.total_new) * m.experts_per_tok)
            ffn_w = m.n_layers * touched * 3 * m.d_model * m.d_ff * m.dtype_bytes
            dense_w = (m.active_params
                       - m.n_layers * m.experts_per_tok * 3 * m.d_model * m.d_ff)
            weight_bytes = dense_w * m.dtype_bytes + ffn_w

        # Linear-layer flops: 2 * active_params per computed token.
        flops = 2.0 * m.active_params * pad_new
        # Attention score/value flops: 4 * d_model * context per new token
        # (2 for QK^T, 2 for PV; GQA does not reduce this — all Q heads attend).
        attn_ctx = 0.0
        for ctx, new in zip(shape.context_lens, shape.new_tokens):
            if op == "prefill":
                attn_ctx += new * (new + 1) / 2.0   # causal triangle
            else:
                attn_ctx += new * ctx + new * (new + 1) / 2.0
        flops += 4.0 * m.n_layers * m.d_model * attn_ctx

        # Byte traffic: weights (once per batch) + KV cache read + KV write
        kv_read = sum(c for c in shape.context_lens) * m.kv_bytes_per_token()
        kv_write = shape.total_new * m.kv_bytes_per_token()
        act_bytes = pad_new * m.d_model * m.dtype_bytes * m.n_layers * 2
        bytes_ = weight_bytes + (0 if op == "prefill" else kv_read) + kv_write

        comm_payload = pad_new * m.d_model * m.dtype_bytes * m.n_layers
        t = self._roofline_s(dev, flops, bytes_, tp, comm_payload)
        key = f"{hardware}:{op}"
        cal = self.calibration.get(key, self.calibration.get(hardware))
        if cal is not None:
            if isinstance(cal, (tuple, list)):
                a, b = cal
                t = max(1e-9, a + b * t)
            else:
                t = t * cal
        return t

    # convenience wrappers used by the scheduler --------------------------

    def prefill_ms(self, hardware: str, model: str, prompt_lens: list[int],
                   tp: int = 1) -> float:
        shp = OpShape(context_lens=[0] * len(prompt_lens), new_tokens=list(prompt_lens))
        return self.predict("prefill", shp, hardware, model, tp) * 1e3

    def decode_ms(self, hardware: str, model: str, context_lens: list[int],
                  tokens_per_seq: Optional[list[int]] = None, tp: int = 1) -> float:
        toks = tokens_per_seq or [1] * len(context_lens)
        shp = OpShape(context_lens=list(context_lens), new_tokens=list(toks))
        return self.predict("verify" if max(toks) > 1 else "decode",
                            shp, hardware, model, tp) * 1e3

    # -- calibration -------------------------------------------------------

    def fit_calibration(self, samples: list[tuple[str, str, OpShape, str, float]]
                        ) -> dict[str, object]:
        """Fit per-(hardware, op) affine corrections t ≈ a + b·t_raw from
        measured samples (a captures fixed dispatch overhead, b kernel
        efficiency). Falls back to a geometric-mean ratio with <2 samples.

        ``samples``: (op, hardware, shape, model, measured_seconds).
        """
        by_key: dict[str, list[tuple[float, float]]] = {}
        saved = dict(self.calibration)
        self.calibration = {}
        try:
            for op, hw, shape, model, measured in samples:
                raw = self.predict(op, shape, hw, model)
                if raw > 0 and measured > 0:
                    by_key.setdefault(f"{hw}:{op}", []).append((raw, measured))
        finally:
            self.calibration = saved
        for key, pts in by_key.items():
            if len(pts) >= 2:
                xs = [p for p, _ in pts]
                ys = [m for _, m in pts]
                n = len(pts)
                mx, my = sum(xs) / n, sum(ys) / n
                sxx = sum((x - mx) ** 2 for x in xs)
                b = (sum((x - mx) * (y - my) for x, y in pts) / sxx
                     if sxx > 1e-18 else 1.0)
                if b <= 0:       # degenerate fit: fall back to ratio
                    b = my / mx if mx > 0 else 1.0
                    a = 0.0
                else:
                    a = my - b * mx
                self.calibration[key] = (max(0.0, a), b)
            else:
                raw, meas = pts[0]
                self.calibration[key] = meas / raw
        return dict(self.calibration)

    def mean_abs_pct_error(self, samples: list[tuple[str, str, OpShape, str, float]]
                           ) -> float:
        errs = []
        for op, hw, shape, model, measured in samples:
            pred = self.predict(op, shape, hw, model)
            errs.append(abs(pred - measured) / measured)
        return 100.0 * sum(errs) / max(1, len(errs))
