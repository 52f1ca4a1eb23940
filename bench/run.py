"""Benchmark of the PyTorch/CUDA port of DSD (``repro_torch``) on one
H100: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run is one process: it draws both models' weights on the card from the
seed, builds the deployment, warms up the cell's one pool geometry (one
round graph, one insert graph), serves the cell's traffic through
``SpecDecodeServer.run`` for the ramp and then the measured window, stops
at the window's end without draining, judges a sample of the finished
requests against the plain reference (``check.py``), and prints one JSON
line last. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics (a profiled stretch right after the ramp, then
the window) and the breakdown.

Everything is found by name: the cell's entry in ``BENCHMARK.json`` and
``bench/cells/<cell>.json`` (serving settings, limits), the configuration's
file, ``bench/traffic/<mix>.json``, ``bench/reference/<family>.py`` and
``bench/metrics/<metric>.py``."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_REQUESTS, WARM_TOKENS = 3, 40


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def cell_files(name: str, manifest: dict) -> tuple:
    """(workload entry, cell settings, configuration, traffic mix)."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(BENCH / "cells" / f"{name}.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cfg = load_json(ROOT / conf["file"])
    mix = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    if cell["config"] != entry["config"] or cell["traffic"] != entry["traffic"]:
        raise SystemExit(f"{name}: cell file and BENCHMARK.json disagree")
    return entry, cell, cfg, mix


def cell_metrics(name: str, manifest: dict, trace: bool) -> list:
    """The metric entries this cell reports."""
    ends = [m for m in manifest["end_to_end"]
            if name in m.get("workloads", [name])]
    if not trace:
        return ends
    moved = {m["name"] for m in ends}
    return [m for m in manifest["per_layer"]
            if name in m["workloads"] or ("workloads" not in m
                                          and m["moves"] in moved)]


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        f"metric_{metric}", BENCH / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """A finished measured run, as the metric readers see it."""
    rec: object               # serve.Recorder
    win: object               # window.Window
    sizes: dict               # side → weights.sizes
    trace: dict               # devtrace.reduce, or {}


def build(cfg: dict, cell: dict, mix: dict, params: dict, device: str):
    """The deployment of the cell's pair and its server settings."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.topology import build_deployment, one_pair_spec
    mc = {side: ModelConfig(**cfg["port"][side]) for side in params}
    spec = one_pair_spec(
        target=mc["target"].name, draft=mc["draft"].name,
        policy=cell["policy"], gamma=cell.get("gamma", 4),
        gamma_max=cell["gamma_max"],
        max_batch=cell["slots"], sync_every=cell["sync_every"],
        temperature=float(mix["temperature"]), rtt_ms=cell["rtt_ms"])
    spec.serving.max_prompt_len = cell["max_prompt_len"]
    spec.serving.max_new_cap = cell["max_new_cap"]
    dep = build_deployment(
        spec, model_configs={m.name: m for m in mc.values()},
        node_params={"edge0": params["draft"], "cloud0": params["target"]},
        reduced=False, device=device)
    kw = {}
    if cell["paged"]:
        block = cell["kv_block_size"]
        slot_len = (cell["max_prompt_len"] + cell["max_new_cap"]
                    + 2 * cell["gamma_max"] + 18)
        kw = dict(paged_kv=True, kv_block_size=block,
                  kv_pool_blocks=cell["pool_slots"] * math.ceil(slot_len
                                                                / block))
    return dep, kw


def warm_up(dep, kw: dict, mix: dict, cell: dict, seed: int) -> None:
    """Capture the cell's round and insert graphs: a few short requests
    through a server of the deployment, untimed."""
    import traffic
    from serve import serve_requests
    warm = traffic.generate({**mix, "arrivals": {"kind": "backlog",
                                                  "requests": WARM_REQUESTS}},
                            seed, 0, dep.vocab)
    for r in warm:
        r.max_new = min(WARM_TOKENS, cell["max_new_cap"])
    serve_requests(dep, kw, warm)


def measure(name: str, cell: dict, cfg: dict, mix: dict, seed: int,
            seconds: float, trace: bool, device: str = "cuda",
            control: bool = False, metrics: list = (),
            t_start: float = T_START) -> dict:
    """One run: set-up, ramp, window, check. Returns the result line's
    fields and the numbers compared."""
    import torch

    import check
    import devtrace
    import traffic
    import weights as W
    from serve import serve_window
    from window import (in_window, percentile, tpot_samples_ms,
                        ttft_samples_ms, window_tokens)

    seeds = W.side_seeds(seed)
    params = {side: W.draw(cfg["port"][side], seeds[side], device)
              for side in ("target", "draft")}
    dep, kw = build(cfg, cell, mix, params, device)
    vocab = dep.vocab
    warm_up(dep, kw, mix, cell, seed)
    if device == "cuda":
        torch.cuda.synchronize()
    reqs = traffic.generate(mix, seed, cell["ramp_s"] + seconds, vocab)
    rec = serve_window(dep, kw, reqs, cell["ramp_s"], seconds,
                       cell["trace_chunks"] if trace else 0)
    win = rec.window()
    setup_s = win.w0 - t_start
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    tr = devtrace.reduce(rec.prof) if rec.prof is not None else {}
    sizes = {side: W.sizes(cfg["port"][side]) for side in params}
    run = Run(rec, win, sizes, tr)

    reqs_all = list(rec.requests.values())
    ttft = ttft_samples_ms(reqs_all, win)
    tpot = tpot_samples_ms(reqs_all, win)
    tokens = window_tokens(rec.chunks, rec.admits, win)
    values = {"ttft_p90_ms": percentile(ttft, 90),
              "tpot_p90_ms": percentile(tpot, 90),
              "tokens_per_s": tokens / win.seconds, "setup_s": setup_s}
    samples = {"ttft_p90_ms": len(ttft), "tpot_p90_ms": len(tpot),
               "tokens_per_s": tokens, "setup_s": 1}
    out_metrics = {}
    for m in metrics:
        v = values.get(m["name"]) if not trace else reader(m["name"])(run)
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if mix["arrivals"]["kind"] == "poisson":
        attempted = len(ttft)
    else:
        attempted = sum(1 for a in rec.admits
                        if in_window(a.t0, a.t1, win))
    info = {"samples": samples, "window_s": win.seconds,
            "chunks": sum(1 for c in rec.chunks
                          if in_window(c.t0, c.t1, win)),
            "finished": sum(1 for r in reqs_all if r.tokens is not None)}

    # -- the program is done: free it, then judge its outputs -------------
    prompts = {r.request_id: r.prompt for r in reqs}
    finished = [r for r in reqs_all if r.tokens is not None]
    struct = check.structure(reqs_all, vocab)
    picked = check.sample(finished, cell["sample"], seed)
    prof = rec.prof
    del dep, params, rec, run, prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = check.judge(cfg, lambda side: W.draw(cfg["port"][side],
                                                seeds[side], device),
                       picked, prompts, float(mix["temperature"]), seed,
                       device, control) if picked else {}
    info["check_s"] = time.perf_counter() - t_check
    failed = struct["overdue"] + struct["out_of_vocab"] \
        + struct["wrong_length"] + struct["rows_disagree"]
    checks = {k: {"value": struct[k], "limit": 0}
              for k in ("overdue", "out_of_vocab", "wrong_length",
                        "rows_disagree")}
    checks["finished"] = {"value": struct["finished"], "limit": 1,
                          "at_least": True}
    for k, lim in cell["limits"].items():
        checks[k] = {"value": nums.get(k), "limit": lim}
    correct = all(
        c["value"] is not None and (c["value"] >= c["limit"]
                                    if c.get("at_least")
                                    else c["value"] <= c["limit"])
        for c in checks.values())
    return {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": out_metrics,
            "memory_peak_bytes": int(peak), "trace": tr, "checks": checks,
            "numbers": nums, "info": info}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    entry, cell, cfg, mix = cell_files(args.workload, manifest)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}; peaks 989 TFLOP/s bf16, 3.35 TB/s",
          file=sys.stderr)
    res = measure(args.workload, cell, cfg, mix, args.seed, args.seconds,
                  bool(args.trace), "cuda", bool(args.control),
                  cell_metrics(args.workload, manifest, bool(args.trace)))
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    info = res["info"]
    print("samples: " + json.dumps(info["samples"]) + f"; window "
          f"{info['window_s']:.3f} s, {info['chunks']} chunks, "
          f"{info['finished']} finished, check {info['check_s']:.1f} s",
          file=sys.stderr)
    print("numbers: " + json.dumps(res["numbers"]), file=sys.stderr)
    for k, c in res["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {k} {c['value']} {rel} {c['limit']}", file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        tr = res["trace"]
        if tr:
            device["busy_s"] = tr["busy_s"]
            device["window_s"] = tr["window_s"]
            line["breakdown"] = {"device_ops": tr["device_ops"],
                                 "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in res["checks"].items()}
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
