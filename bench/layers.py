"""The per-layer readings that ``metrics/<name>.py`` report. Each takes the
finished run (:class:`run.Run`) and returns a number, or None when the run
has nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

import counts
from window import in_window, percentile, queue_samples_ms

ATTN_KERNELS = ("attend_kernel", "combine_kernel")


def _win_chunks(run):
    return [c for c in run.rec.chunks if in_window(c.t0, c.t1, run.win)]


def queue_ms_p50(run):
    """Median wait from due time to the start of admission over every
    request due in the window (still waiting at its end: the wait so
    far)."""
    return percentile(queue_samples_ms(run.rec.requests.values(), run.win),
                      50)


def round_ms(run):
    """Wall time of the window's chunks over their rounds (each chunk ends
    in the session's sync)."""
    cs = _win_chunks(run)
    rounds = sum(c.rounds for c in cs)
    return 1e3 * sum(c.t1 - c.t0 for c in cs) / rounds if rounds else None


def insert_share(run):
    """Summed prefill-insert spans in the window over the window, %."""
    spans = sum(a.t1 - a.t0 for a in run.rec.admits
                if in_window(a.t0, a.t1, run.win))
    return 100.0 * spans / run.win.seconds


def tokens_per_slot_round(run):
    """Tokens committed over active slot-rounds in the window."""
    work = [w for c in _win_chunks(run) for w in c.work]
    return sum(w[2] for w in work) / len(work) if work else None


def step_mfu(run):
    """Model FLOPs of the window's useful work over the window at the bf16
    peak, %: the target's gamma_r + 1 and the draft's gamma_r tokens per
    active slot-round, and each admission's prompt at its own length."""
    t, d = run.sizes["target"], run.sizes["draft"]
    flops = sum(counts.round_flops(t, d, g, [n])
                for c in _win_chunks(run) for n, g, _ in c.work)
    flops += sum(counts.prefill_flops(t, a.prompt_len)
                 + counts.prefill_flops(d, a.prompt_len)
                 for a in run.rec.admits if in_window(a.t0, a.t1, run.win))
    return 100.0 * flops / (run.win.seconds * counts.PEAK_FLOPS)


def _roofline(run, names, slot_cost, prefill_cost):
    tr = run.trace
    if not tr:
        return None
    dev = sum(s for k, s in tr["kernels"].items() if k in names)
    if dev <= 0:
        return None
    t, d = run.sizes["target"], run.sizes["draft"]
    nbytes = flops = 0.0
    for c in run.rec.chunks:
        if c.traced:
            for n, g, new in c.work:
                b, f = slot_cost(t, d, n, g, new)
                nbytes, flops = nbytes + b, flops + f
    for a in run.rec.admits:
        if a.traced:
            b, f = prefill_cost(t, d, a.prompt_len)
            nbytes, flops = nbytes + b, flops + f
    return 100.0 * counts.bound_seconds(nbytes, flops) / dev


def attn_roofline(run):
    """B1/B2 (``attend_kernel`` and ``combine_kernel``) in the traced
    chunks: the least time their needed bytes and FLOPs take at the peaks,
    over their device time, %."""
    return _roofline(run, ATTN_KERNELS, counts.attn_slot_round_cost,
                     counts.attn_prefill_cost)


def ssd_roofline(run):
    """B5 (every forward ``ssd_`` kernel) in the traced chunks, as above."""
    tr = run.trace
    if not tr:
        return None
    names = {k for k in tr["kernels"]
             if k.startswith("ssd_") and "bwd" not in k}
    return _roofline(run, names,
                     lambda t, d, n, g, new: counts.ssd_slot_round_cost(t, g),
                     counts.ssd_prefill_cost)


def idle_share(run):
    """Share of the traced window in which no device operation ran, %."""
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
