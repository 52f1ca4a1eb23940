"""Reduction of a ``torch.profiler`` trace of part of the window to the
device numbers: busy seconds, kernel seconds by name, the device
operations that took most time, and the longest idle gaps named by what
the host was doing.

The harness labels its own host spans with ``record_function`` (admit,
chunk, retire); an idle gap is named after the innermost host span or
runtime call that covers its middle, and gaps under ``SHORT_GAP_S`` are
pooled as launch spacing."""

from __future__ import annotations

import re
from collections import defaultdict

SHORT_GAP_S = 20e-6


def short_name(name: str) -> str:
    """A kernel's function name without namespaces, return type, template
    arguments or parameters: ``void ns::(anonymous
    namespace)::attend_kernel<...>(...)`` → ``attend_kernel``,
    ``std::enable_if<...>::type internal::gemvx::kernel<...>(...)`` →
    ``gemvx.kernel``; ``Memcpy DtoH (Device -> Pinned)`` →
    ``Memcpy_DtoH``."""
    n = name.replace("(anonymous namespace)", "anon")
    while True:
        m = re.sub(r"<[^<>]*>", "", n)
        if m == n:
            break
        n = m
    n = n.split("(")[0].strip()
    if "::" in n:
        parts = n.split()[-1].split("::")
        n = ".".join(parts[-2:]) if parts[-1] == "kernel" else parts[-1]
    elif n.startswith("void "):
        n = n[5:]
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", n) or "kernel"


def merge(intervals: list) -> list:
    """Union of [start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_and_gaps(device: list, lo: float, hi: float) -> tuple:
    """(busy seconds, idle gaps [(start, end)]) of device intervals within
    [lo, hi]."""
    clipped = [(max(s, lo), min(e, hi)) for s, e in device
               if e > lo and s < hi]
    spans = merge(clipped)
    busy = sum(e - s for s, e in spans)
    gaps, t = [], lo
    for s, e in spans:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return busy, gaps


def name_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by the innermost host span covering each gap's middle
    (``host``: (start, end, name)); short gaps pooled."""
    out: dict = defaultdict(float)
    host = sorted(host, key=lambda h: h[0])
    for s, e in gaps:
        if e - s < SHORT_GAP_S:
            out["shorter_gaps_launch_spacing"] += e - s
            continue
        mid, best = (s + e) / 2, None
        for hs, he, name in host:
            if hs > mid:
                break
            if he >= mid and (best is None or he - hs < best[1] - best[0]):
                best = (hs, he, name)
        out[best[2] if best else "host_idle"] += e - s
    return dict(out)


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _ev_times(ev) -> tuple:
    """(start s, end s) of a kineto event, whichever accessors it has."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns() * 1e-9
        return s, s + ev.duration_ns() * 1e-9
    s = ev.start_us() * 1e-6
    return s, s + ev.duration_us() * 1e-6


def reduce(prof) -> dict:
    """The profiler's events → {busy_s, kernels: {short name: seconds},
    device_ops, idle_gaps, window: (lo, hi)} on the trace's own clock.
    The window is the span of the harness's labelled host spans."""
    from torch.autograd import DeviceType
    device, host, kernels = [], [], defaultdict(float)
    for ev in prof.profiler.kineto_results.events():
        s, e = _ev_times(ev)
        if ev.name().startswith("bench."):
            # the harness's own labels: host spans, also mirrored on the
            # device timeline as annotations, which are no device work
            if ev.device_type() != DeviceType.CUDA:
                host.append((s, e, ev.name()))
            continue
        if ev.device_type() == DeviceType.CUDA:
            device.append((s, e))
            kernels[short_name(ev.name())] += e - s
        else:
            host.append((s, e, short_name(ev.name())))
    labelled = [(s, e) for s, e, n in host if n.startswith("bench.")]
    if not labelled or not device:
        return {}
    lo = min(s for s, _ in labelled)
    hi = max(e for _, e in labelled)
    busy, gaps = busy_and_gaps(device, lo, hi)
    return {"busy_s": busy, "window_s": hi - lo, "kernels": dict(kernels),
            "device_ops": top(kernels), "idle_gaps": top(name_gaps(gaps,
                                                                   host))}
