"""Configuration parser for DSD-Sim (paper §3.1).

The paper's simulator ingests a YAML system specification (device types,
network links, runtime policies) and runs an ``auto_topology`` pass that
expands it into explicit draft/target pools with fully-connected links.
The module carries its own YAML-subset reader (no PyYAML dependency)
(nested block mappings, block lists, inline scalars/lists, comments) which is
sufficient for the config schema below:

    cluster:
      targets: {count: 20, hw: A100, model: llama2-70b, tp: 4}
      drafters: {count: 600, hw: A40, model: llama2-7b}
      link: {rtt_ms: 10, jitter_ms: 1}
    policies:
      routing: jsq
      batching: {kind: lab, max_batch: 16, batch_window_ms: 2}
      window: {kind: awc, gamma: 4}
    workload:
      dataset: gsm8k
      rate_per_s: 40
      num_requests: 400
      seed: 0
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional

from .network import DEFAULT_FUSED_CHUNK, LinkSpec
from .policies import (BATCHING, ROUTING, BatchingConfig)
from .scheduler import ClusterSpec, PolicyStack, DSDSimulation
from .trace import PROFILES, WorkloadGenerator
from .hwmodel import HardwareModel
from ..core.window import make_window_policy


# --------------------------------------------------------------------------
# Mini-YAML
# --------------------------------------------------------------------------

_SCALAR_RE = re.compile(r"^[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+)$")


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith(("'", '"')) and tok.endswith(tok[0]) and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("null", "none", "~", ""):
        return None
    if _SCALAR_RE.match(tok):
        try:
            return int(tok)
        except ValueError:
            return float(tok)
    return tok


def _split_inline(body: str) -> list[str]:
    """Split a {...} or [...] body on top-level commas."""
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p for p in (p.strip() for p in parts) if p]


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith("{") and tok.endswith("}"):
        out: dict[str, Any] = {}
        for item in _split_inline(tok[1:-1]):
            k, _, v = item.partition(":")
            out[k.strip()] = _parse_value(v)
        return out
    if tok.startswith("[") and tok.endswith("]"):
        return [_parse_value(i) for i in _split_inline(tok[1:-1])]
    return _parse_scalar(tok)


def _strip_comment(line: str) -> str:
    out, in_q = [], None
    for ch in line:
        if in_q:
            out.append(ch)
            if ch == in_q:
                in_q = None
        elif ch in "'\"":
            in_q = ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out).rstrip()


def loads(text: str) -> Any:
    """Parse the YAML subset into dicts/lists/scalars."""
    lines: list[tuple[int, str]] = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        lines.append((indent, line.strip()))

    def parse_block(idx: int, indent: int) -> tuple[Any, int]:
        result: Any = None
        while idx < len(lines):
            ind, content = lines[idx]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"bad indent at line: {content!r}")
            if content.startswith("- "):
                if result is None:
                    result = []
                item_txt = content[2:].strip()
                if item_txt.endswith(":") or ":" in item_txt and not item_txt.startswith(("{", "[")):
                    # list of mappings: re-parse as a one-line mapping + block
                    k, _, v = item_txt.partition(":")
                    if v.strip():
                        d = {k.strip(): _parse_value(v)}
                        result.append(d)
                        idx += 1
                    else:
                        sub, idx2 = parse_block(idx + 1, indent + 2)
                        d = {k.strip(): sub}
                        result.append(d)
                        idx = idx2
                else:
                    result.append(_parse_value(item_txt))
                    idx += 1
                continue
            key, _, val = content.partition(":")
            key = key.strip()
            if result is None:
                result = {}
            if val.strip():
                result[key] = _parse_value(val)
                idx += 1
            else:
                sub, idx2 = parse_block(idx + 1, ind + 2)
                result[key] = sub if sub is not None else {}
                idx = idx2
        return result, idx

    parsed, _ = parse_block(0, 0)
    return parsed


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


# --------------------------------------------------------------------------
# auto_topology: high-level spec -> runnable simulation
# --------------------------------------------------------------------------

@dataclass
class SimSpec:
    cluster: ClusterSpec
    policies: PolicyStack
    workload_dataset: str = "gsm8k"
    workload_rate: float = 40.0
    num_requests: int = 200
    seed: int = 0
    fused_chunk: int = DEFAULT_FUSED_CHUNK


def _build_window_policy(w: dict[str, Any], awc_predictor=None):
    """YAML window mapping → policy instance, via the shared factory
    (:func:`repro_torch.core.window.make_window_policy`) so the YAML reader,
    the topology spec layer and the launcher flags construct policies
    through one code path."""
    w = w or {}
    return make_window_policy(str(w.get("kind", "static")),
                              gamma=int(w.get("gamma", 4)),
                              hi=float(w.get("hi", 0.75)),
                              lo=float(w.get("lo", 0.25)),
                              gmax=int(w.get("gmax", 12)),
                              predictor=awc_predictor)


def auto_topology(doc: dict[str, Any], awc_predictor=None) -> SimSpec:
    """Expand a high-level YAML document into an explicit SimSpec.

    Mirrors the paper's auto_topology pass: a pool count + device class
    becomes explicit device pools with per-target links.
    """
    c = doc.get("cluster", {})
    targets = c.get("targets", {})
    drafters = c.get("drafters", {})
    link = c.get("link", {})
    cluster = ClusterSpec(
        num_targets=int(targets.get("count", 4)),
        target_hw=str(targets.get("hw", "A100")),
        target_model=str(targets.get("model", "llama2-70b")),
        target_tp=int(targets.get("tp", 4)),
        num_drafters=int(drafters.get("count", 64)),
        draft_hw=str(drafters.get("hw", "A40")),
        draft_model=str(drafters.get("model", "llama2-7b")),
        link=LinkSpec(rtt_ms=float(link.get("rtt_ms", 10.0)),
                      jitter_ms=float(link.get("jitter_ms", 1.0)),
                      bandwidth_gbps=float(link.get("bandwidth_gbps", 1.0))),
    )
    p = doc.get("policies", {})
    routing = ROUTING[str(p.get("routing", "random"))]
    routing = routing() if routing is not ROUTING["random"] else routing(
        seed=int(doc.get("workload", {}).get("seed", 0)))
    b = p.get("batching", {}) or {}
    batching_cfg = BatchingConfig(
        max_batch=int(b.get("max_batch", 16)),
        batch_window_ms=float(b.get("batch_window_ms", 2.0)),
        continuous=bool(b.get("continuous", True)),
        chunked_prefill=bool(b.get("chunked_prefill", False)),
        prefill_chunk=int(b.get("prefill_chunk", 512)))
    batching = BATCHING[str(b.get("kind", "fifo"))]()
    window = _build_window_policy(p.get("window", {}), awc_predictor)
    policies = PolicyStack(routing=routing, batching=batching,
                           batching_cfg=batching_cfg, window=window)
    w = doc.get("workload", {})
    return SimSpec(
        cluster=cluster, policies=policies,
        workload_dataset=str(w.get("dataset", "gsm8k")),
        workload_rate=float(w.get("rate_per_s", 40.0)),
        num_requests=int(w.get("num_requests", 200)),
        seed=int(w.get("seed", 0)),
        fused_chunk=int(doc.get("fused_chunk", DEFAULT_FUSED_CHUNK)))


def build_simulation(spec: SimSpec,
                     hwmodel: Optional[HardwareModel] = None) -> DSDSimulation:
    gen = WorkloadGenerator(spec.workload_dataset, spec.workload_rate,
                            spec.cluster.num_drafters, seed=spec.seed)
    records = gen.generate(spec.num_requests)
    return DSDSimulation(spec.cluster, spec.policies, records,
                         hwmodel=hwmodel, seed=spec.seed,
                         fused_chunk=spec.fused_chunk)


def simulate_from_yaml(text: str, awc_predictor=None,
                       hwmodel: Optional[HardwareModel] = None):
    """One-call entry: YAML text → Analyzer summary dict."""
    spec = auto_topology(loads(text), awc_predictor)
    sim = build_simulation(spec, hwmodel)
    analyzer = sim.run()
    return analyzer
