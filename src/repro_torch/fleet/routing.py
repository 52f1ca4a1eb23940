"""α/link/queue-aware pair routing — ONE scoring rule for sim and real.

"Efficient LLM Inference over Heterogeneous Edge Networks with
Speculative Decoding" (PAPERS.md) shows draft placement and link
bandwidth must be optimized JOINTLY; the scoring function here is that
joint decision reduced to serving time: :func:`pair_cost` estimates a
pair's expected time per committed token from its link RTT, its recent
acceptance rate, and its queue occupancy — the standard speculative
decoding rate model (each round pays one RTT plus one verify pass and
commits ``E[tokens] = (1 − α^(γ+1))/(1 − α)`` tokens).

Long-context requests are routed AWAY from WAN pairs: their many decode
rounds amplify the per-round RTT term, so the cost doubles the link term
for prompts past ``long_prompt_tokens`` ("Speculation at a Distance":
where edge-cloud SD pays off depends on workload shape).

Two thin adapters consume the same rule:

- :class:`SmartPairRouter` — the real server's
  :class:`~repro_torch.serving.PairRouter`: reads each pair's MEASURED
  transport RTT and its live session's acceptance counters;
- :class:`SmartSimPairRouter` — DSD-Sim's arrival-time pair router
  (:class:`repro_torch.sim.policies.SimPairView` snapshot of per-pair queue
  depths / link RTTs / rolling acceptance).

Because both paths rank pairs with the identical function, the
routing-policy ORDERING (smart vs least-loaded) is comparable sim↔real —
the property ``benchmarks/bench_fleet.py`` gates.
"""

from __future__ import annotations

from typing import Sequence


def pair_cost(rtt_ms: float, alpha: float, queue_frac: float,
              long_context: bool = False, gamma_hint: int = 4,
              step_ms: float = 10.0) -> float:
    """Expected serving time per committed token on one pair (lower is
    better). ``queue_frac`` (0 = idle, 1 = full) scales the whole cost:
    a busy pair delivers its per-token time later."""
    a = min(0.98, max(0.02, float(alpha)))
    e_tokens = (1.0 - a ** (gamma_hint + 1)) / (1.0 - a)
    link = float(max(0.0, rtt_ms))
    if long_context:
        link *= 2.0              # long outputs pay the RTT round after round
    per_token = (step_ms + link) / e_tokens
    return per_token * (1.0 + max(0.0, float(queue_frac)))


class SmartPairRouter:
    """α/link/queue-aware router for the real multi-pair server.

    Scores every pair with a free slot by :func:`pair_cost` using its
    transport's measured ``recent_rtt_ms`` (which falls back to the
    declared link's expected RTT before any round trip completes), the
    live session's acceptance counters, and slot occupancy; ties break to
    the lowest pair index (deterministic, matching
    :class:`~repro_torch.serving.LeastLoadedPairRouter`)."""

    def __init__(self, long_prompt_tokens: int = 128, gamma_hint: int = 4,
                 step_ms: float = 10.0, default_alpha: float = 0.7):
        self.long_prompt_tokens = int(long_prompt_tokens)
        self.gamma_hint = int(gamma_hint)
        self.step_ms = float(step_ms)
        self.default_alpha = float(default_alpha)

    def _pair_inputs(self, pair, free: int) -> tuple[float, float, float]:
        tr = getattr(pair, "transport", None)
        rtt = float(tr.recent_rtt_ms) if tr is not None else 0.0
        sess = getattr(pair, "session", None)
        alpha = self.default_alpha
        queue_frac = 0.0
        if sess is not None:
            if sess.proposed > 0:
                alpha = sess.accepted / sess.proposed
            cap = max(1, sess.capacity)
            queue_frac = (cap - free) / cap
        return rtt, alpha, queue_frac

    def route(self, req, pairs: Sequence, free_slots: Sequence[int]) -> int:
        long_ctx = len(req.prompt) >= self.long_prompt_tokens
        best, best_cost = None, None
        for i, pair in enumerate(pairs):
            if free_slots[i] <= 0:
                continue
            rtt, alpha, qf = self._pair_inputs(pair, free_slots[i])
            cost = pair_cost(rtt, alpha, qf, long_context=long_ctx,
                             gamma_hint=self.gamma_hint,
                             step_ms=self.step_ms)
            if best_cost is None or cost < best_cost:
                best, best_cost = i, cost
        if best is None:   # contract: only called when capacity exists
            return int(max(range(len(free_slots)),
                           key=lambda i: free_slots[i]))
        return best


# --------------------------------------------------------------------------
# sim-side pair routers (arrival-time lane assignment in DSD-Sim)
# --------------------------------------------------------------------------

class LeastLoadedSimPairRouter:
    """Sim analogue of :class:`~repro_torch.serving.LeastLoadedPairRouter`:
    the pair with the shallowest drafter queue, ties to the lowest
    index."""

    def route_pair(self, record, view) -> int:
        best, best_d = 0, None
        for i, d in enumerate(view.queue_depths):
            if best_d is None or d < best_d:
                best, best_d = i, d
        return best

    def name(self) -> str:
        return "least-loaded"


class SmartSimPairRouter:
    """Sim analogue of :class:`SmartPairRouter`: the identical
    :func:`pair_cost` over the sim's per-pair view."""

    def __init__(self, long_prompt_tokens: int = 128, gamma_hint: int = 4,
                 step_ms: float = 10.0):
        self.long_prompt_tokens = int(long_prompt_tokens)
        self.gamma_hint = int(gamma_hint)
        self.step_ms = float(step_ms)

    def route_pair(self, record, view) -> int:
        long_ctx = record.prompt_length >= self.long_prompt_tokens
        best, best_cost = 0, None
        cap = max(1, view.max_batch)
        for i in range(len(view.queue_depths)):
            cost = pair_cost(view.rtt_ms[i], view.alpha[i],
                             view.queue_depths[i] / cap,
                             long_context=long_ctx,
                             gamma_hint=self.gamma_hint,
                             step_ms=self.step_ms)
            if best_cost is None or cost < best_cost:
                best, best_cost = i, cost
        return best

    def name(self) -> str:
        return "smart"


SIM_PAIR_ROUTERS = {
    "least-loaded": LeastLoadedSimPairRouter,
    "smart": SmartSimPairRouter,
}
