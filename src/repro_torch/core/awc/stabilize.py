"""Stabilized execution of WC-DNN window predictions (paper §4.4).

Three techniques, applied in order per draft–target pair:

1. **Clamping** of raw predictions to a configured range (default [1, 12]).
2. **Exponential smoothing** — EMA with smoothing factor α=0.4 across
   iterations, damping high-frequency oscillation in the predicted γ.
3. **Hysteresis for mode switching** — a sticky fused/distributed policy:
   while distributed, the smoothed prediction must sit at γ≤1 for k
   consecutive steps (default k=2) before the switch to fused mode is
   permitted; symmetric logic applies for leaving fused mode.

The smoothed value is finally quantized to the nearest integer in range.
State is per draft–target pair (paper: "smoothing state is maintained per
draft-target pair so each connection follows its own trajectory").
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StabilizerConfig:
    clamp_lo: float = 1.0
    clamp_hi: float = 12.0
    ema_alpha: float = 0.4          # weight of the *new* prediction
    hysteresis_k: int = 2
    fused_threshold: float = 1.0    # gamma <= 1  =>  fused mode


class WindowStabilizer:
    """Per-pair stabilization state machine."""

    def __init__(self, cfg: StabilizerConfig | None = None):
        self.cfg = cfg or StabilizerConfig()
        self._ema: float | None = None
        self._below_count = 0
        self._above_count = 0
        self.mode = "distributed"

    def reset(self) -> None:
        self._ema = None
        self._below_count = 0
        self._above_count = 0
        self.mode = "distributed"

    def step(self, raw_prediction: float) -> tuple[int, str]:
        """Apply clamp → EMA → hysteresis → quantize. Returns (γ, mode)."""
        c = self.cfg
        # 1. clamp
        x = min(c.clamp_hi, max(c.clamp_lo, float(raw_prediction)))
        # 2. EMA
        if self._ema is None:
            self._ema = x
        else:
            self._ema = c.ema_alpha * x + (1.0 - c.ema_alpha) * self._ema
        # 3. hysteresis on mode switching
        near_one = self._ema <= c.fused_threshold + 0.25  # "remains near γ=1"
        if self.mode == "distributed":
            self._below_count = self._below_count + 1 if near_one else 0
            if self._below_count >= c.hysteresis_k:
                self.mode = "fused"
                self._above_count = 0
        else:  # fused
            self._above_count = 0 if near_one else self._above_count + 1
            if self._above_count >= c.hysteresis_k:
                self.mode = "distributed"
                self._below_count = 0
        # 4. quantize
        gamma = int(round(self._ema))
        gamma = int(min(c.clamp_hi, max(c.clamp_lo, gamma)))
        if self.mode == "fused":
            gamma = 1
        return gamma, self.mode
