"""Speculation-window policies (paper §3.4 "Window Size Policy", §4).

Every policy consumes a read-only :class:`FeatureSnapshot` of recent system
metrics and returns a :class:`WindowDecision` — the speculation window size γ
and the execution mode (``distributed`` draft→verify vs ``fused``
cloud-only). Policies keep any adaptation state *per draft–target pair*.

- :class:`StaticWindowPolicy`   — fixed γ (paper baseline, γ=4).
- :class:`DynamicWindowPolicy`  — threshold heuristic: γ+1 when the recent
  acceptance rate exceeds 0.75, γ−1 when it falls below 0.25 (paper §5.2).
- :class:`AWCWindowPolicy`      — the paper's learned controller: WC-DNN
  prediction + clamp/EMA/hysteresis stabilization (§4.4). γ≤1 ⇒ fused mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol

from .awc.stabilize import StabilizerConfig, WindowStabilizer
from .tree import tree_expected_accepted


@dataclass(frozen=True)
class FeatureSnapshot:
    """The AWC feature vector (paper §4.1, plus the pipeline-hit signal).

    ``pipe_hit_recent`` is the recent fraction of cross-round speculative
    windows that survived their verdict (pipelined execution overlaps
    window k+1's draft with window k's verification; a hit means the
    overlapped RTT was genuinely hidden). 0.0 whenever pipelining is off —
    the controller's overlapped-RTT discount must stay inert there.

    ``branches_prev`` is the branch width of the previous round's
    speculation tree (1.0 outside tree sessions — the feature is inert on
    linear deployments, like ``pipe_hit_recent`` outside pipelining)."""
    q_depth: float        # recent target-queue depth utilization in [0, ~]
    alpha_recent: float   # recent token acceptance rate in [0,1]
    rtt_recent_ms: float  # recent link round-trip time
    tpot_recent_ms: float # recent time-per-output-token of the target
    gamma_prev: float     # previous window size
    pipe_hit_recent: float = 0.0  # recent pipeline hit rate in [0,1]
    branches_prev: float = 1.0    # previous tree branch width (1 = linear)

    def as_list(self) -> list[float]:
        return [self.q_depth, self.alpha_recent, self.rtt_recent_ms,
                self.tpot_recent_ms, self.gamma_prev, self.pipe_hit_recent,
                self.branches_prev]


@dataclass(frozen=True)
class WindowDecision:
    gamma: int
    mode: str  # "distributed" | "fused"
    branches: int = 1  # speculation-tree branch width (1 = linear chain)


class WindowPolicy(Protocol):
    def decide(self, pair_key: str, feats: FeatureSnapshot) -> WindowDecision: ...
    def name(self) -> str: ...


class StaticWindowPolicy:
    def __init__(self, gamma: int = 4, branches: int = 1):
        self.gamma = int(gamma)
        self.branches = max(1, int(branches))

    def decide(self, pair_key: str, feats: FeatureSnapshot) -> WindowDecision:
        return WindowDecision(self.gamma, "distributed", self.branches)

    def gamma_bound(self) -> int:
        """Largest γ this policy can ever emit — the engine compiles its
        single masked-window step at this width."""
        return self.gamma

    def name(self) -> str:
        if self.branches > 1:
            return f"static-{self.gamma}x{self.branches}"
        return f"static-{self.gamma}"


class DynamicWindowPolicy:
    """Threshold heuristic from the paper's 'Dynamic/Simple' baseline."""

    def __init__(self, hi: float = 0.75, lo: float = 0.25,
                 gamma0: int = 4, gmin: int = 1, gmax: int = 12):
        self.hi, self.lo = hi, lo
        self.gamma0, self.gmin, self.gmax = gamma0, gmin, gmax
        self._state: dict[str, int] = {}

    def decide(self, pair_key: str, feats: FeatureSnapshot) -> WindowDecision:
        g = self._state.get(pair_key, self.gamma0)
        if feats.alpha_recent > self.hi:
            g = min(self.gmax, g + 1)
        elif feats.alpha_recent < self.lo:
            g = max(self.gmin, g - 1)
        self._state[pair_key] = g
        return WindowDecision(g, "distributed")

    def gamma_bound(self) -> int:
        return self.gmax

    def name(self) -> str:
        return "dynamic"


class AWCWindowPolicy:
    """Adaptive Window Control: WC-DNN prediction + per-pair stabilization.

    ``predictor`` maps a 5-float feature list → raw continuous γ. In the
    simulator this is the trained WC-DNN exported to numpy
    (:func:`repro_torch.core.awc.model.numpy_predictor`); in unit tests it can be
    any callable.
    """

    def __init__(self, predictor: Callable[[list[float]], float],
                 stab_cfg: StabilizerConfig | None = None,
                 max_branches: int = 1, bandwidth_gbps: float = 1.0):
        self.predictor = predictor
        self.stab_cfg = stab_cfg or StabilizerConfig()
        self._stab: dict[str, WindowStabilizer] = {}
        self.max_branches = max(1, int(max_branches))
        self.bandwidth_gbps = float(bandwidth_gbps)

    def _pick_branches(self, gamma: int, feats: FeatureSnapshot) -> int:
        """Joint {γ, b} decision: widen the tree while the marginal
        expected-accepted gain of one more branch
        (:func:`repro_torch.core.tree.tree_expected_accepted`) beats its
        cost — the extra wire bytes of a wider grid (12 B/node at the
        link's bandwidth) in token-equivalents of the recent TPOT, with a
        small floor so near-zero gains buy no extra draft work."""
        if self.max_branches <= 1 or gamma < 1:
            return 1
        tpot = max(0.1, feats.tpot_recent_ms)
        # one extra branch adds γ grid nodes → 12·γ bytes on the uplink
        ser_ms = 12 * gamma * 8 / (self.bandwidth_gbps * 1e9) * 1e3
        floor = max(0.02, ser_ms / tpot)
        b = 1
        prev = tree_expected_accepted(feats.alpha_recent, gamma, 1)
        while b < self.max_branches:
            nxt = tree_expected_accepted(feats.alpha_recent, gamma, b + 1)
            if nxt - prev <= floor:
                break
            prev = nxt
            b += 1
        return b

    def decide(self, pair_key: str, feats: FeatureSnapshot) -> WindowDecision:
        stab = self._stab.get(pair_key)
        if stab is None:
            stab = self._stab[pair_key] = WindowStabilizer(self.stab_cfg)
        raw = float(self.predictor(feats.as_list()))
        gamma, mode = stab.step(raw)
        branches = (self._pick_branches(gamma, feats)
                    if mode == "distributed" else 1)
        return WindowDecision(gamma, mode, branches)

    def gamma_bound(self) -> int:
        return int(self.stab_cfg.clamp_hi)

    def name(self) -> str:
        return "awc"


def make_window_policy(kind: str, *, gamma: int = 4, hi: float = 0.75,
                       lo: float = 0.25, gmax: int = 12, predictor=None,
                       stab_cfg: StabilizerConfig | None = None,
                       branches: int = 1, max_branches: int = 1,
                       bandwidth_gbps: float = 1.0):
    """One window-policy factory for every config surface (the topology
    spec layer, ``launch.serve`` flags, DSD-Sim's YAML reader): a policy
    *kind* plus its knobs → a fresh policy instance. Fresh matters — each
    call returns its own adaptation state, so two deployment surfaces can
    never accidentally share a stabilizer. ``branches``/``max_branches``
    opt a policy into tree speculation (static width vs AWC's joint
    {γ, b} choice); both default to 1 — the linear chain."""
    if kind == "static":
        return StaticWindowPolicy(int(gamma), branches=int(branches))
    if kind == "dynamic":
        return DynamicWindowPolicy(hi=float(hi), lo=float(lo),
                                   gamma0=int(gamma), gmax=int(gmax))
    if kind == "awc":
        if predictor is None:
            from .awc.model import default_predictor
            predictor = default_predictor()
        return AWCWindowPolicy(predictor, stab_cfg=stab_cfg,
                               max_branches=int(max_branches),
                               bandwidth_gbps=float(bandwidth_gbps))
    raise ValueError(f"unknown window policy kind {kind!r}; "
                     "expected static | dynamic | awc")


class OracleStaticPolicy:
    """Upper-bound helper used for AWC dataset labeling sweeps: behaves like
    StaticWindowPolicy but records nothing; separate class only so sweep code
    can distinguish label-generation runs."""

    def __init__(self, gamma: int, fused: bool = False):
        self.gamma = int(gamma)
        self.fused = fused

    def decide(self, pair_key: str, feats: FeatureSnapshot) -> WindowDecision:
        if self.fused:
            return WindowDecision(1, "fused")
        return WindowDecision(self.gamma, "distributed")

    def gamma_bound(self) -> int:
        return 1 if self.fused else self.gamma

    def name(self) -> str:
        return f"oracle-{'fused' if self.fused else self.gamma}"
