#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device   — the card (capability 9.0) and its name/power limit;
2. build    — the hand-written CUDA kernels (``src/repro_torch/csrc``) built
              with nvcc for sm_90a;
3. kernels  — B1 (dense), B2 (paged, fp and int8, under f32 and bf16
              queries) against their single-pass and split-and-combine
              plain versions at the draft-decode, verify and prefill windows
              (S below one split, S no multiple of the split, a whole split
              masked), bit-identity of a row across B 1 T 1 and B 4 T 9
              calls, B1 with the tree ancestor mask (also across a split
              boundary), B4a (tree argmax), B4b (tree accept) alone and
              both in one launch (``tree_verify_fused``; T 2 to 65, B 1
              to 64, and 250 launches replayed from a CUDA graph leaving
              each captured verdict right and the counters at zero), B3a
              (sampled gather/residual mass), B3b (inverse-CDF sample), B1
              at the hybrid's shared-attention shape and B5 (the SSD
              chunked scan, f32 and bf16, eight shapes up to S 4096, zero-dt
              rows exact identities) against their plain PyTorch versions
              at the slices' shapes (B4 exactly; B3 exactly up to
              rounding at a CDF step, those cases counted; B5
              within atol 5e-4 / rtol 1e-3), B3b's token of a row the same
              in a B 1 and a B 4 call and over two runs, the sampled
              verify's first committed token against p_0 (chi-square),
              then timed against the plain version, a library yardstick the
              port never calls (``scaled_dot_product_attention``,
              ``torch.argmax``; none for B3 and B5), the bound and, for
              B4, an empty kernel (the launch floor) — B1/B2
              at the verify, draft-decode and hybrid shapes at S 114 and
              4096, B2 also over an int8 pool, B5 at the zamba2 verify and
              prefill shapes and at S 4096;
4. exact    — float32, full widths at 2 layers each: the server's greedy
              tokens on dense KV == on paged KV (pool at 60 % of dense
              parity) == a target-only greedy decode, and a self-speculation
              pair commits the same tokens at acceptance 1.0; then, on a
              qwen3-14b pair whose draft is a noised copy of the target, a
              tree session (γ_max 8, b_max 3, static γ 4 × b 3) == a linear
              session == the target-only greedy decode, with acceptance
              strictly between 0 and 1, and a max_branches=1 tree session ==
              the linear one bit for bit (tokens and acceptance bits); at
              temperature 1.0, self-speculation accepts ≥ 0.99, the noised
              draft strictly between 0 and 1, and a seed fixes the tokens;
5. capture  — float32, published widths at the exact phases' depths:
              every step of an engine-owned slot pool captured once as a
              CUDA graph and replayed, against the same runs eager
              (``capture=False``) on one engine, seed and stream: qwen
              servers dense and paged with γ changing every round, tree
              sessions (static γ 4 × b 3, AWC with max_branches=3, γ × b
              changing every round) on a noised-draft pair, the zamba2 ←
              mamba2 split server — captured tokens == eager == the
              target-only greedy decode; at temperature 1.0 captured ==
              eager on one seed (qwen and zamba2 pairs); each step warms up
              and captures once per pool whatever γ, b and 8 admissions
              into 4 slots did, every other call a replay (checked against
              each pooled step's calls); a second ``generate``, a second
              server and a second tree wave of one geometry build no pool,
              capture no graph and warm no step up, with the first run's
              tokens (== target greedy); at T 1.0 two ``generate(seed=5)``
              give equal tokens; two live sessions hold two pools; TTFT of
              a cold and a warm bf16 server at QWEN_CUT side by side; then
              the bf16 qwen dense static γ 4 serve at PROFILE_CUT depth
              (5 / 4 layers, 8 requests × 16 tokens) eager and captured
              back to back (walls,
              TPOT, device busy share, equal launch counts);
6. distributed — the draft/target split, half-duplex rounds over a
              transport, every worker program captured once per session:
              float32 at the exact phases' depths, qwen3-14b ← qwen2.5-3b
              servers over the in-process transport, a 20 ms emulated link
              (virtual clock) and a TCP loopback socket, under mode
              distributed (static γ 4), fused and auto (γ and fused
              changing every round), dense and paged (pool at 60 % of
              parity) — tokens == the colocated server's == target greedy,
              messages = 2·distributed rounds + 2·control round trips,
              graphs per step as called; a noised-draft tree session
              (γ_max 8, b_max 3, static 4 × 3) over the in-process
              transport == colocated == target greedy, acceptance in
              (0, 1); zamba2 ← mamba2 == colocated == target greedy; at
              T 1.0 on one seed in-process == colocated; then bf16
              through ``repro_torch.launch.serve``: qwen static γ 4 at the
              published depth colocated, over ``--link-rtt-ms 0`` and over
              a 15 ms link (jitter 1 ms, 1 Gbps), AWC over the 15 ms link
              and T 1.0 over link 0 at QWEN_CUT, zamba2 ← mamba2 at the
              published depth over the 15 ms link — complete outputs,
              exact launch counts, messages, the measured RTT within ±1 ms
              of the link model's, the measured wait ≥ 0.95 × the sampled
              delays, graphs per step; a profiled short serve colocated
              and over link 0 (busy share);
7. serve    — the qwen3-14b target ← qwen2.5-3b draft pair in bf16
              through ``repro_torch.launch.serve``: dense and paged static
              γ=4 at the published depth, dense AWC at QWEN_CUT depth
              (every width as published), each checked for complete
              in-range outputs, kernel launch counts equal to rounds·(γ_max·L_draft +
              L_target) + admissions·(L_draft + L_target), and the step-key
              count; then the same pair through tree ``DecodeSession``s
              (γ_max 8, b_max 3; static γ 4 × b 3 and AWC with
              max_branches=3), checked for complete outputs, B1 launches =
              rounds·(γ_max·L_draft + L_target) + waves·(L_draft +
              L_target), one B4 launch (``tree_verify``) per round and
              none of B4a or B4b alone, and one step key (the tree
              runs at QWEN_CUT depth); the dense (published depth) and
              paged (QWEN_CUT) static runs again at ``--temperature 1.0``
              with the same launch counts, their greedy twins' step keys
              and B3a = B3b = rounds (every greedy and tree run: B3 = 0);
              every run replays its rounds and admissions from captured
              graphs (2 per server, 1 per wave session: checked);
8. exact_ssm — float32, published widths: zamba2-1.2b (8 layers: one
              shared-attention segment and a 2-layer tail) ← mamba2-130m
              (2 layers), vocab 32000, through the server: greedy tokens ==
              a target-only greedy decode; zamba2 and mamba2-130m
              self-speculation at acceptance 1.0 with their models' greedy
              tokens; at temperature 1.0 zamba2 self-speculation accepts
              ≥ 0.99 and a seed fixes the pair's tokens;
9. serve_ssm — the full zamba2-1.2b ← mamba2-130m pair in bf16 through
              ``repro_torch.launch.serve`` (static γ 4, greedy and
              ``--temperature 1.0``): complete outputs, 2 step keys and 2
              captured graphs, B5 = rounds·38 + admissions·(38 + 24), B1 =
              rounds·6·(γ_max + 2) + admissions·6, B3 = rounds sampled and
              0 greedy; a profile;
10. pipeline — the pipelined mode: float32, a qwen3-14b target at
              QWEN_CUT depth whose draft is its noised copy (the first
              noise of a ladder whose pipelined run has hits AND misses,
              printed), 2-slot servers over the in-process transport, a
              15 ms emulated link on the virtual clock and a TCP loopback
              socket, dense and paged: pipelined == half-duplex == target
              greedy, graphs per step as called (insert, propose,
              speculative propose, verify); zamba2 ← mamba2 (every verdict
              a miss: the recurrent checkpoint and rollback, 6 graphs);
              T 1.0 pipelined captured == eager on one seed; then bf16
              through ``repro_torch.launch.serve`` over a 15 ms link, each
              pipelined run beside its half-duplex twin: qwen3-14b ←
              qwen2.5-3b at the published depth (α 0: every speculative
              window wasted) and qwen2.5-3b ← its noised copy at a low and
              a high hit rate, with exact B1 launches (every window
              proposed, discarded ones included) and graphs;
11. topology — ``examples/cluster_2pair.json`` through ``launch.serve
              --topology`` in bf16 at the published depth, 8 requests ×
              32 tokens (both pairs, exact launches and graphs per pair)
              and in f32 at QWEN_CUT (== target greedy); the wave server
              (bf16, QWEN_CUT; both waves in one session, exact graphs)
              twice, beside its continuous twin under the same policy,
              in the order wave, continuous, continuous, wave; a
              process-backed pair at the published depth (two worker hosts
              on the card, each holding its own model); the
              ``cluster_2pair_procs.json`` shape (four hosts) in f32 at
              QWEN_CUT == the in-process deployment of the same spec; every
              host's second wave under the capture guard, graphs and B1
              launches per host exact;
12. families — the moe, encdec and vlm families at the published widths:
              float32 arctic-480b (experts 128 → 8, 2 layers) ← llama2-7b
              (2 layers) captured == eager, dense == paged, colocated ==
              in-process transport at capacity factor 1.25, server and
              tree wave == target greedy at cf 8 (nothing dropped), T 1.0
              seeded; bf16 arctic-480b (experts 128 → 8, layers 35 → 6)
              ← llama2-7b as published, static γ 4 served dense and paged
              on the 8 × 32 stream with exact launches, the dropped expert
              assignments per round and the MoE blocks' share of the
              verify step (profiled eager run, and timed); whisper-tiny ←
              its noised copy at the published size, ``generate(frontend=)``
              over 1500 frames == target greedy in float32, a second call
              capturing nothing, bf16 timed; internvl2-76b text-only at the
              published widths, float32 depth 2 ← 1 == target greedy, a
              live frontend refused, bf16 depth 4 ← 1 timed;
13. fleet   — ``examples/fleet_cluster.json`` (qwen3-14b shared ← two
              qwen2.5-3b drafts over 2 ms and 40 ms, the smart router, its
              8-request three-class burst trace with SLOs) through
              ``launch.serve --topology --full-size`` in bf16 at the
              published depth: every request served with its output
              length, exact B1 launches, each step captured once per pair,
              the SLO report; the same spec in f32 at QWEN_CUT under the
              smart and least-loaded routers == target greedy; SLO shedding
              (16 requests, a chat TTFT SLO of 1 ms): shed rows empty,
              served rows == target greedy, the report counting the shed;
              an ``ElasticPairPool`` of ``cluster_2pair_procs.json``'s
              process pair (f32, QWEN_CUT) scaling from one pair to two
              under a 12-request burst == target greedy, every host shut
              down; DSD-Sim on the spec under both routers beside the real
              per-pair counts (printed, not gated);
14. train   — training: ``ssd_scan_bwd`` (B5's gradient, a hand-written
              backward kernel) against the plain backward (autograd of
              the chunked plain scan) at zamba2-1.2b's and mamba2-130m's
              SSM widths, S 64 / 512 / 2048 / 1001, f32 and bf16, nonzero
              h_in and dh_out, then timed beside B5's forward, the plain
              backward and the bound; float32 parity (2 layers a side,
              ssm and hybrid): the first gradient and 3 AdamW steps on the
              card (B5 both ways) == the same on the CPU, every Mamba2 leaf
              of every layer with a nonzero gradient; mamba2-130m (B 8 × S
              1024, 30 steps) and zamba2-1.2b (B 4 × S 1024, 10 steps) at
              the published widths and depth and qwen2.5-3b at QWEN_CUT
              depth (6 steps) in bf16 through ``repro_torch.launch.train
              --full --device cuda``: loss falls, ``ssd_scan`` =
              steps·L·2 (remat re-runs each layer's forward) and
              ``ssd_scan_bwd`` = steps·L exactly, s/step, tokens/s, peak
              memory; ``examples/train_draft_torch.py`` at its default
              sizes (the trained draft's acceptance above the untrained
              one's); WC-DNN on DSD-Sim labels (``default_grid(small=
              True)``) trained on the card into a temporary path,
              ``numpy_predictor`` == ``forward`` within 1e-5;
15. dryrun  — ``repro_torch.launch.dryrun`` on the meta device over every
              assigned arch × the 4 shapes × the single- and multi-pod
              meshes through its CLI (four children side by side, no
              card visible to them), one line a row, every row ok; B1
              held to its plain and split plain at the qwen2.5-3b steps'
              shapes below (not counted); then three steps that
              fit one H100 run for real at the ``host`` mesh, each beside
              its meta estimate (``torch.cuda.max_memory_allocated`` from
              an empty allocator, within ±15 % of the estimate) and its
              meta FLOPs beside the analytic model FLOPs: mamba2-130m's
              train step at B 8 × S 1024 (B5 and ``ssd_scan_bwd``),
              qwen2.5-3b's chunked prefill of 8192 tokens (B1, 1024-token
              windows) and its ``decode_step`` at decode_32k's 32768 slots
              with the batch cut to 16 (B1), with exact launch counts;
16. examples — ``examples/quickstart_torch.py``,
              ``edge_cloud_serving_torch.py`` and ``capture_traces_torch.py``
              as child processes on the card, side by side, at shrunk
              flags: each exits 0, the edge example's fused verify ran its
              kernels and equals the reference rule.
The decode rounds of every chunk run under
``torch.cuda.set_sync_debug_mode("error")`` (all but the one call per
session step that captures it: capture synchronizes the device); a
transport round runs each device segment between its host crossings
under it.

Then each phase's seconds, the ``{"kernels": [...]}`` line, the card's
name and power limit, and the last line ``{"ok": true, "device": {...}}``.
Without CUDA, or without the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernels", "exact", "capture", "distributed",
          "serve", "exact_ssm", "serve_ssm", "pipeline", "topology",
          "families", "fleet", "train", "dryrun", "examples")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor rate
GAMMA_MAX = 8
HYBRID_LAYERS = 8              # zamba2 depth in exact_ssm: 1 segment + 2
# depth of the earlier slices' secondary qwen runs (dense AWC, paged
# T = 1, the tree waves), a quarter of the published 40 / 36 layers, so the
# whole script stays near 600 s with the SSM slice added; dense static
# (greedy and T = 1) and paged static greedy keep the published depth
QWEN_CUT = {"qwen3-14b": 10, "qwen2.5-3b": 9}
# depth of the profiled eager-against-captured serve (capture phase), half
# of QWEN_CUT since the training phase joined the script (the profiler's
# cost grows with the kernels it traces; the whole script stays well under
# its 1200 s limit)
PROFILE_CUT = {"qwen3-14b": 5, "qwen2.5-3b": 4}
SSM_DRAFT_LAYERS = 2           # mamba2-130m depth in exact_ssm
B_MAX = 3                      # tree branch bound of the tree runs
TREE_NOISE = 0.05              # draft = target + N(0, (0.05·std)²) per tensor
SAMPLED_T = 1.0                # temperature of the sampled runs
TAIL_CASE = "u = r = 1 - 2^-24"   # planted: thresholds at the last CDF step
FLAG_SHARE = 0.02              # B3b rows allowed at a CDF step, of all rows
FLAG_SHARE_INNER = 0.01        # … and of the rows outside TAIL_CASE
# the kernels each serving phase must launch: the qwen pair's runs (linear,
# paged, sampled, tree) and the zamba2 ← mamba2-130m runs (B5 in every
# prefill and verify, B1 in the shared attention, B3 at T > 0)
# (the tree runs launch B4a and B4b as one kernel, ``tree_verify``)
SERVE_KERNELS = ("decode_attn", "paged_decode_attn", "tree_verify",
                 "gather_reduce", "cdf_sample")
SERVE_SSM_KERNELS = ("ssd_scan", "decode_attn", "gather_reduce", "cdf_sample")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# --------------------------------------------------------------- helpers

def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 50, replays: int = 5,
             after=None) -> float:
    """Device time per call: ``iters`` calls captured into one CUDA graph,
    replayed and timed with events (``iters · (1 + replays)`` launches in
    all). Unlike :func:`cuda_ms`, the wrapper's host work (argument checks,
    allocation, the ctypes call) is not in the number — for a kernel
    shorter than its Python wrapper an eager loop times the host.
    ``after``, if given, runs once the last replay has finished, while the
    graph and the tensors its calls wrote still live."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    if after is not None:
        after()
    return start.elapsed_time(end) / (iters * replays)


def ragged_pos_map(torch, gen, B, S, T, dev):
    """Positions 0..p-1 with −1 holes and stale entries past q_pos, row 0
    empty; q_pos = p .. p+T-1 per row."""
    p = torch.randint(S // 2, S - 4, (B,), generator=gen, device=dev)
    ar = torch.arange(S, device=dev)
    pm = torch.where(ar[None, :] < p[:, None], ar[None, :],
                     torch.full_like(ar[None, :], -1))
    pm[:, 3] = -1                                   # holes
    pm[:, -2:] = (p + T + 3)[:, None]               # stale speculation
    pm[0] = -1                                      # a row with no slot
    q_pos = p[:, None] + torch.arange(T, device=dev)[None, :]
    return pm.to(torch.int32).contiguous(), q_pos.to(torch.int32).contiguous()


def paged_inputs(torch, gen, B, T, Hkv, G, hd, S, bs, dtype, quant, dev,
                 dead=None):
    n_log = math.ceil(S / bs)
    NB = B * n_log + 3
    q = torch.randn((B, T, Hkv, G, hd), generator=gen, device=dev).to(dtype)
    if quant:
        k = torch.randint(-127, 128, (NB, bs, Hkv, hd), generator=gen,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (NB, bs, Hkv, hd), generator=gen,
                          device=dev, dtype=torch.int8)
        ks = torch.rand((NB, bs, Hkv), generator=gen, device=dev) * 0.02
        vs = torch.rand((NB, bs, Hkv), generator=gen, device=dev) * 0.02
    else:
        k = torch.randn((NB, bs, Hkv, hd), generator=gen,
                        device=dev).to(dtype)
        v = torch.randn((NB, bs, Hkv, hd), generator=gen,
                        device=dev).to(dtype)
        ks = vs = None
    perm = torch.randperm(NB, generator=gen, device=dev)
    table = perm[:B * n_log].reshape(B, n_log).to(torch.int32)
    table[0, 1] = -1                                # unmapped block
    table[-1, -1] = -1                              # unreserved tail
    if dead is not None:                            # unmapped key range
        table[:, dead[0] // bs:dead[1] // bs] = -1
    pm = torch.randint(-1, S, (NB, bs), generator=gen, device=dev,
                       dtype=torch.int32)
    p = torch.randint(S // 2, S - T, (B,), generator=gen, device=dev)
    q_pos = (p[:, None] + torch.arange(T, device=dev)[None, :]).to(
        torch.int32)
    return (q.contiguous(), k, v, ks, vs, pm, table.contiguous(),
            q_pos.contiguous())


# ---------------------------------------------------------------- phases

def phase_device(torch):
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"needs a Hopper card (capability 9.0), found {cap}")
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "capability": list(cap), "count": torch.cuda.device_count(),
            "nvidia_smi": smi_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build(kernels):
    t0 = time.perf_counter()
    # builds and loads the library, launches nothing: not a kernel wrapper
    lib = kernels.library()  # noqa: DSD004
    info = {"phase": "build", "seconds": time.perf_counter() - t0,
            "library": str(kernels.BUILD_LOG.get("path")),
            "cached": kernels.BUILD_LOG.get("cached")}
    ptxas = kernels.BUILD_LOG.get("ptxas") or {}
    for name, log in ptxas.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        info[f"ptxas_{name}"] = lines[:12]
    emit(info)
    # per entry: registers, spills, static shared memory (the tiles, ring
    # and metadata are dynamic shared memory)
    for label, names in (("decode_attention", ("decode_attn.cu",
                                               "paged_decode_attn.cu")),
                         ("ssd_scan", ("ssd_scan.cu", "ssd_scan_f32.cu")),
                         ("ssd_scan_bwd", ("ssd_scan_bwd.cu",
                                           "ssd_scan_bwd_f32.cu")),
                         ("sampled_verify", ("sampled_verify.cu",))):
        entries = []
        for name in names:
            entries += ptxas_entries(ptxas.get(name, ""))
        if entries:
            emit({"phase": "build", f"ptxas_{label}": entries,
                  "spill_bytes": sum(e["spill_stores"] + e["spill_loads"]
                                     for e in entries)})


def ptxas_entries(log: str) -> list:
    """(kernel, registers, spill bytes, static smem) per entry function of
    an ``nvcc -Xptxas -v`` log, names demangled when c++filt is there."""
    import re
    import shutil
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"kernel": m.group(1), "registers": None,
                   "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0,
                   "smem_bytes": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            (cur["stack_bytes"], cur["spill_stores"],
             cur["spill_loads"]) = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(e["kernel"]
                                                       for e in out),
                               capture_output=True, text=True).stdout
        for e, n in zip(out, names.splitlines()):
            e["kernel"] = re.sub(r"\(.*\)$", "", n.replace(
                "repro_torch::", "").replace("(anonymous namespace)::", ""))
    return out
    assert lib is not None


def phase_kernels(torch):
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    geoms = {"target": (8, 5), "draft": (2, 8)}     # (Hkv, G), hd 128
    tol = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
    err = check_attention_kernels(torch, gen, dev, geoms, tol)
    bit_identity(torch, gen, dev)

    # ---- timing: every main-path shape of B1/B2 at S 114 and 4096
    times = {"attn": {}}
    for label, (B, T, Hkv, G, hd), paged in (
            ("verify", (4, 9) + geoms["target"] + (128,), True),
            ("draft", (4, 1) + geoms["draft"] + (128,), True),
            ("hybrid", (4, 9, 32, 1, 64), False)):
        for S in (114, 4096):
            t = attention_times(torch, gen, dev, B, T, Hkv, G, hd, S, paged)
            times["attn"][f"{label}_s{S}"] = t
            emit({"phase": "kernel_times", "shape_label": f"{label}_s{S}",
                  "card": smi_line(), **t})
    times["slice"], times["long"] = (times["attn"]["verify_s114"],
                                     times["attn"]["verify_s4096"])
    err.update(check_tree_kernels(torch, gen, dev, geoms, tol))
    times["tree"] = time_tree_kernels(torch, gen, dev, geoms)
    emit({"phase": "tree_kernel_times", "card": smi_line(),
          **times["tree"]})
    err.update(check_sampled_kernels(torch, gen, dev))
    check_cdf_sample_determinism(torch, gen, dev)
    check_sampled_distribution(torch, dev)
    times["sampled"] = time_sampled_kernels(torch, gen, dev)
    emit({"phase": "sampled_kernel_times", "card": smi_line(),
          **times["sampled"]})
    err["decode_attn_hybrid"] = hybrid_attention(torch, gen, dev, tol)
    times["hybrid_attn"] = dict(times["attn"]["hybrid_s114"]["decode_attn"],
                                shape=times["attn"]["hybrid_s114"]["shape"])
    err["ssd_scan"] = check_ssd_kernels(torch, gen, dev)
    times["ssd"] = time_ssd_kernels(torch, gen, dev)
    emit({"phase": "ssd_kernel_times", "card": smi_line(), **times["ssd"]})
    return err, times


# B1/B2 checks: S 114 lies inside one split (no combine pass); S 1300 is no
# multiple of any split (128 to 512 keys) and its keys [0, 512) are masked
# (B1: pos −1; B2: unmapped blocks), so at least one whole split is dead
ATTN_CASES = ((114, None), (1300, (0, 512)))


def check_attention_kernels(torch, gen, dev, geoms, tol) -> dict:
    """B1 and B2 (bf16 or f32 pool, and int8 under f32 and bf16 queries)
    against the single-pass plain version and the split-and-combine plain
    version of the kernels' own split plan, at the draft decode, verify
    and prefill windows of both geometries."""
    from repro_torch.kernels.decode_attn import (
        decode_attn_call, decode_attention_grouped, decode_attention_split,
        paged_decode_attention, paged_decode_attention_plain,
        paged_decode_attention_split, split_plan)
    hd, bs = 128, 16
    err = {"decode_attn": 0.0, "paged_decode_attn": 0.0}
    cases = []

    def check(name, label, dtype, out, refs):
        torch.cuda.synchronize()
        for ref in refs:
            try:
                torch.testing.assert_close(out.float(), ref.float(),
                                           **tol[dtype])
            except AssertionError as e:
                fail(f"{name} {label} vs plain: {e}")
        err[name] = max(err[name], float(
            (out.float() - refs[0].float()).abs().max()))

    for S, dead in ATTN_CASES:
        for gname, (Hkv, G) in geoms.items():
            for T in (1, 9, 48):
                B = 2 if T == 48 else 4
                for dtype in (torch.bfloat16, torch.float32):
                    label = f"{gname} S{S} T{T} {str(dtype)[6:]}"
                    q = torch.randn((B, T, Hkv, G, hd), generator=gen,
                                    device=dev).to(dtype)
                    k = torch.randn((B, S, Hkv, hd), generator=gen,
                                    device=dev).to(dtype)
                    v = torch.randn((B, S, Hkv, hd), generator=gen,
                                    device=dev).to(dtype)
                    pm, qp = ragged_pos_map(torch, gen, B, S, T, dev)
                    if dead is not None:
                        pm[:, dead[0]:dead[1]] = -1
                    split, _ = split_plan(S, hd, dtype, Hkv)
                    out = decode_attn_call(q, k, v, pm, qp)
                    check("decode_attn", label, dtype, out, [
                        decode_attention_grouped(q, k, v, pm, qp),
                        decode_attention_split(q, k, v, pm, qp, split)])
                    if not (out[0] == 0).all():
                        fail(f"B1 {label}: the empty row is not zero")
                    for quant in (False, True):
                        args = paged_inputs(torch, gen, B, T, Hkv, G, hd, S,
                                            bs, dtype, quant, dev, dead)
                        out = paged_decode_attention(*args, S)
                        check("paged_decode_attn",
                              label + (" int8" if quant else ""), dtype,
                              out, [paged_decode_attention_plain(*args, S),
                                    paged_decode_attention_split(*args, S)])
                    cases.append(label)
    emit({"phase": "kernels", "check": "B1/B2 == plain and split plain",
          "cases": len(cases), "S": [c[0] for c in ATTN_CASES],
          "masked_keys": ATTN_CASES[1][1], "paged_int8": ["float32",
                                                          "bfloat16"],
          "tolerance": {"float32": 1e-4, "bfloat16": 2e-2},
          "allow_tf32": False, "max_abs_err": err})
    return err


def bit_identity(torch, gen, dev) -> None:
    """A query row's output is bit-identical whether computed in a B 1,
    T 1 call or inside a B 4, T 9 call over the same cache row and q_pos
    (B1, B2 with a bf16 and an int8 pool), at one split and at three."""
    from repro_torch.kernels.decode_attn import (decode_attn_call,
                                                 paged_decode_attention)
    (Hkv, G), hd, B, T = (8, 5), 128, 4, 9
    rows = 0
    for S in (114, 700):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, T, Hkv, G, hd), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn((B, S, Hkv, hd), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((B, S, Hkv, hd), generator=gen,
                            device=dev).to(dtype)
            pm, qp = ragged_pos_map(torch, gen, B, S, T, dev)
            full = decode_attn_call(q, k, v, pm, qp)
            pools = [paged_inputs(torch, gen, B, T, Hkv, G, hd, S, 16, dtype,
                                  quant, dev) for quant in (False, True)]
            pfull = [paged_decode_attention(*a, S) for a in pools]
            for b in range(B):
                for t in (0, 4, 8):
                    one = decode_attn_call(
                        q[b:b + 1, t:t + 1].contiguous(), k[b:b + 1],
                        v[b:b + 1], pm[b:b + 1],
                        qp[b:b + 1, t:t + 1].contiguous())
                    if not torch.equal(one[0, 0], full[b, t]):
                        fail(f"B1 S{S} {dtype}: row ({b}, {t}) differs "
                             "between a B 1 T 1 call and a B 4 T 9 call")
                    for a, pf in zip(pools, pfull):
                        pq, kp, vp, ks, vs, ppm, table, pqp = a
                        one = paged_decode_attention(
                            pq[b:b + 1, t:t + 1].contiguous(), kp, vp, ks,
                            vs, ppm, table[b:b + 1].contiguous(),
                            pqp[b:b + 1, t:t + 1].contiguous(), S)
                        if not torch.equal(one[0, 0], pf[b, t]):
                            fail(f"B2 S{S} {dtype} int8={ks is not None}: "
                                 f"row ({b}, {t}) differs between a B 1 "
                                 "T 1 call and a B 4 T 9 call")
                    rows += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "check": "B1/B2 bit-identical across B and T",
          "rows": rows, "S": [114, 700], "paged_pools": ["fp", "int8"],
          "identical": True})


def attention_times(torch, gen, dev, B, T, Hkv, G, hd, S, paged) -> dict:
    """B1 and (``paged``) B2 over a bf16 pool and over an int8 pool, bf16
    queries, at one shape: device time by CUDA-graph replay (``ms``), the
    eager wrapper (``eager_ms``), the plain version (graph), SDPA on the
    same bf16 cache (``library_ms``; null for int8, which no single call
    computes, its ``sdpa_bf16_ms`` beside it) and the bound (each input
    read once, the output written once, over the HBM rate; against the
    flops over the bf16 tensor rate). All keys valid: q_pos = S − T + t."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import (
        decode_attn_call, decode_attention_grouped, paged_decode_attention,
        paged_decode_attention_plain)
    dtype, H = torch.bfloat16, Hkv * G
    q = torch.randn((B, T, Hkv, G, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
    pm = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S) \
        .contiguous()
    qp = (S - T + torch.arange(T, device=dev, dtype=torch.int32)) \
        .expand(B, T).contiguous()
    qs = q.reshape(B, T, H, hd).transpose(1, 2)
    ksd, vsd = k.transpose(1, 2), v.transpose(1, 2)
    mask = ((pm[:, None, None, :] >= 0)
            & (pm[:, None, None, :] <= qp[:, None, :, None]))
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, ksd, vsd, attn_mask=mask, enable_gqa=G > 1)
    torch.testing.assert_close(
        sdpa().transpose(1, 2).float().reshape(B, T, Hkv, G, hd),
        decode_attention_grouped(q, k, v, pm, qp).float(),
        atol=2e-2, rtol=2e-2)
    flops = 2 * 2 * B * T * H * S * hd
    io = 2 * q.numel() * 2 + qp.numel() * 4
    it_plain = 20 if S <= 1024 else 10

    def row(call, plain, by, lib):
        t_b, t_o = by / HBM_BYTES_PER_S, flops / BF16_FLOPS
        return {"ms": graph_ms(torch, call), "eager_ms": cuda_ms(torch, call),
                "plain_ms": graph_ms(torch, plain, iters=it_plain),
                "library_ms": lib, "bound_ms": max(t_b, t_o) * 1e3,
                "bound_by": "bytes" if t_b >= t_o else "operations"}

    lib_ms = graph_ms(torch, sdpa)
    kv = 2 * B * S * Hkv * hd * 2
    out = {"shape": {"B": B, "T": T, "Hkv": Hkv, "G": G, "hd": hd, "S": S,
                     "dtype": "bfloat16"},
           "decode_attn": row(lambda: decode_attn_call(q, k, v, pm, qp),
                              lambda: decode_attention_grouped(q, k, v, pm,
                                                               qp),
                              kv + io + pm.numel() * 4, lib_ms)}
    if not paged:
        return out
    # paged twin of the same cache: bs 16, identity-ordered blocks
    bs = 16
    n_log = math.ceil(S / bs)
    pad = n_log * bs - S
    kp = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(B * n_log, bs, Hkv, hd) \
        .contiguous()
    vp = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(B * n_log, bs, Hkv, hd) \
        .contiguous()
    pmp = F.pad(pm, (0, pad), value=-1).reshape(B * n_log, bs).contiguous()
    table = torch.arange(B * n_log, device=dev,
                         dtype=torch.int32).reshape(B, n_log)
    meta = pmp.numel() * 4 + table.numel() * 4
    pargs = (q, kp, vp, None, None, pmp, table, qp, S)
    out["paged_decode_attn"] = row(
        lambda: paged_decode_attention(*pargs),
        lambda: paged_decode_attention_plain(*pargs), kv + io + meta, lib_ms)
    # int8 pool: per-(entry, head) absmax scales
    ks = (kp.float().abs().amax(-1) / 127).clamp(min=1e-8)
    vs = (vp.float().abs().amax(-1) / 127).clamp(min=1e-8)
    kq = (kp.float() / ks[..., None]).round().clamp(-127, 127) \
        .to(torch.int8).contiguous()
    vq = (vp.float() / vs[..., None]).round().clamp(-127, 127) \
        .to(torch.int8).contiguous()
    qargs = (q, kq, vq, ks.contiguous(), vs.contiguous(), pmp, table, qp, S)
    got = paged_decode_attention(*qargs)
    torch.testing.assert_close(
        got.float(), paged_decode_attention_plain(*qargs).float(),
        atol=2e-2, rtol=2e-2)
    out["paged_decode_attn_int8"] = dict(row(
        lambda: paged_decode_attention(*qargs),
        lambda: paged_decode_attention_plain(*qargs),
        kv // 2 + 2 * ks.numel() * 4 + io + meta, None),
        sdpa_bf16_ms=lib_ms)
    return out


# ------------------------------------------------- SSM / hybrid slice (B5)

def hybrid_attention(torch, gen, dev, tol) -> float:
    """B1 at the hybrid's shared-attention geometry (zamba2-1.2b: Hkv 32,
    G 1, hd 64) against its plain version at T 1, 9 and 48 in f32 and
    bf16, at S 114 (one split) and S 1100 (three bf16 splits, five f32);
    its times come from :func:`attention_times`."""
    from repro_torch.kernels.decode_attn import (decode_attn_call,
                                                 decode_attention_grouped)
    Hkv, G, hd = 32, 1, 64
    err = 0.0
    for S in (114, 1100):
        for T in (1, 9, 48):
            B = 2 if T == 48 else 4
            for dtype in (torch.bfloat16, torch.float32):
                q = torch.randn((B, T, Hkv, G, hd), generator=gen,
                                device=dev).to(dtype)
                k = torch.randn((B, S, Hkv, hd), generator=gen,
                                device=dev).to(dtype)
                v = torch.randn((B, S, Hkv, hd), generator=gen,
                                device=dev).to(dtype)
                pm, qp = ragged_pos_map(torch, gen, B, S, T, dev)
                out = decode_attn_call(q, k, v, pm, qp)
                ref = decode_attention_grouped(q, k, v, pm, qp)
                torch.cuda.synchronize()
                torch.testing.assert_close(out.float(), ref.float(),
                                           **tol[dtype])
                err = max(err, float((out.float() - ref.float())
                                     .abs().max()))
    emit({"phase": "kernels", "check": "B1 at the hybrid shape == plain",
          "Hkv": Hkv, "G": G, "hd": hd, "T": [1, 9, 48], "S": [114, 1100],
          "max_abs_err": err,
          "tolerance": {"float32": 1e-4, "bfloat16": 2e-2}})
    return err


# (label, B, S, nh, hd, N, chunk, rows with dt = 0 past these lengths)
SSD_CASES = (("zamba2 verify", 4, 9, 64, 64, 64, 9, None),
             ("zamba2 prefill", 1, 48, 64, 64, 64, 48, (37,)),
             ("zamba2 prefill ragged", 4, 48, 64, 64, 64, 48,
              (48, 37, 20, 5)),
             ("mamba2-130m prefill", 1, 48, 24, 64, 128, 48, None),
             ("multi-chunk", 2, 4096, 24, 64, 128, 128, None),
             ("ragged", 2, 1000, 24, 64, 128, 128, (1000, 613)),
             ("reduced verify", 4, 9, 32, 16, 16, 9, None),
             ("reduced prefill", 4, 48, 32, 16, 16, 16, (48, 30, 17, 5)))
SSD_TOL = dict(atol=5e-4, rtol=1e-3)    # the reference's kernel tolerance


def ssd_inputs(torch, gen, dev, B, S, nh, hd, N, dtype, lens=None):
    """x ~ N(0, 1), B/C ~ N(0, 1/4) in ``dtype``; dt = softplus(N(0, 1)),
    zero past ``lens`` (identity steps); A = −exp(N(0, 1)); h_in ~ N(0, 1)
    (nonzero carried-in state), all as the reference's kernel test."""
    import torch.nn.functional as F
    x = torch.randn((B, S, nh, hd), generator=gen, device=dev).to(dtype)
    Bm = (0.5 * torch.randn((B, S, N), generator=gen, device=dev)).to(dtype)
    Cm = (0.5 * torch.randn((B, S, N), generator=gen, device=dev)).to(dtype)
    dt = F.softplus(torch.randn((B, S, nh), generator=gen, device=dev))
    if lens is not None:
        ln = torch.tensor(lens, device=dev)
        dt = torch.where(torch.arange(S, device=dev)[None, :, None]
                         < ln[:, None, None], dt, torch.zeros_like(dt))
    A = -torch.exp(torch.randn((nh,), generator=gen, device=dev))
    h0 = torch.randn((B, nh, hd, N), generator=gen, device=dev)
    return x, Bm, Cm, dt.contiguous(), A, h0


def check_ssd_kernels(torch, gen, dev) -> float:
    """B5 (through the wrapper the model calls) against its plain chunked
    version on the same card tensors, f32 and bf16 x/B/C, TF32 off, at the
    slice's shapes (SSD_CASES): y and h_out within SSD_TOL. Rows with
    dt = 0 past a length must be exact identities: the ragged cases'
    h_out rows equal the kernel run on the row's prefix alone, bit for
    bit. Returns the largest |kernel − plain| over y and h_out."""
    from repro_torch.kernels.ssd import (ssd_call, ssd_chunked_kernel,
                                         ssd_chunked_plain)
    err, used, cases = 0.0, 0.0, []
    for label, B, S, nh, hd, N, chunk, lens in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(torch, gen, dev, B, S, nh, hd, N, dtype, lens)
            y, h = ssd_chunked_kernel(*args, chunk)
            yp, hp = ssd_chunked_plain(*args, chunk)
            torch.cuda.synchronize()
            for name, a_, b_ in (("y", y, yp), ("h_out", h, hp)):
                if not torch.isfinite(a_).all():
                    fail(f"B5 {label} {dtype}: {name} not finite")
                try:
                    torch.testing.assert_close(a_, b_, **SSD_TOL)
                except AssertionError as e:
                    fail(f"B5 {label} {dtype}: {name} vs plain: {e}")
                err = max(err, float((a_ - b_).abs().max()))
                used = max(used, float(((a_ - b_).abs() / (
                    SSD_TOL["atol"] + SSD_TOL["rtol"] * b_.abs())).max()))
            if lens is not None:
                x, Bm, Cm, dt, A, h0 = args
                for r, n in enumerate(lens):
                    _, hr = ssd_call(x[r:r + 1, :n].contiguous(),
                                     Bm[r:r + 1, :n].contiguous(),
                                     Cm[r:r + 1, :n].contiguous(),
                                     dt[r:r + 1, :n].contiguous(), A,
                                     h0[r:r + 1].contiguous())
                    if not torch.equal(hr[0], h[r]):
                        fail(f"B5 {label}: zero-dt rows past {n} are not "
                             "an exact identity")
            cases.append(f"{label} {str(dtype)[6:]}")
    emit({"phase": "kernels", "check": "ssd scan == plain",
          "cases": cases, "max_abs_err": err, "tolerance": SSD_TOL,
          "tolerance_share_used": used,
          "zero_dt_identity": "exact", "allow_tf32": False})
    return err


def ssd_bound(B, S, nh, hd, N, chunk, esize):
    """The least time of the scan: bytes (x/B/C once in their type, dt, A,
    h_in once, y and h_out once in f32) over the HBM rate, against the
    chunked algorithm's multiply-adds over the bf16 tensor rate (per chunk
    of L: C·Bᵀ 2L²N, and per head the carried-state term and the state
    update 2·2L·hd·N and the causal quadratic form 2·L(L+1)/2·hd)."""
    by = (esize * (B * S * nh * hd + 2 * B * S * N) + 4 * B * S * nh
          + 4 * nh + 4 * 2 * B * nh * hd * N + 4 * B * S * nh * hd)
    flops = 0
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        flops += B * (2 * L * L * N + nh * (4 * L * hd * N
                                            + L * (L + 1) * hd))
    t_b, t_o = by / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# (label, B, S, nh, hd, N, chunk) of the timed B5 shapes
SSD_TIMED = (("zamba2_verify", 4, 9, 64, 64, 64, 9),
             ("zamba2_prefill", 4, 48, 64, 64, 64, 48),
             ("s4096", 2, 4096, 24, 64, 128, 128))


def time_ssd_kernels(torch, gen, dev) -> dict:
    """B5 at the zamba2 verify and prefill shapes and at S 4096 (bf16
    x/B/C): device time by CUDA-graph replay (``ms``), the eager wrapper
    (``eager_ms``), the plain version (graph) and the bound; no PyTorch
    call computes the scan (``library_ms`` null)."""
    from repro_torch.kernels.ssd import ssd_chunked_kernel, ssd_chunked_plain
    out = {}
    for label, B, S, nh, hd, N, chunk in SSD_TIMED:
        args = ssd_inputs(torch, gen, dev, B, S, nh, hd, N, torch.bfloat16)
        call = lambda: ssd_chunked_kernel(*args, chunk)
        bound, by = ssd_bound(B, S, nh, hd, N, chunk, 2)
        out[label] = {
            "shape": {"B": B, "S": S, "nh": nh, "hd": hd, "N": N,
                      "chunk": chunk, "dtype": "bfloat16"},
            "ms": graph_ms(torch, call, iters=20 if S > 9 else 50),
            "eager_ms": cuda_ms(torch, call, iters=20 if S > 9 else 50),
            "plain_ms": graph_ms(torch, lambda: ssd_chunked_plain(
                *args, chunk), iters=5 if S > 9 else 20),
            "library_ms": None, "bound_ms": bound, "bound_by": by}
    return out


def tree_pos_map(torch, gen, B, S, T, dev, p=None):
    """Committed positions 0..p−1 with a hole, junk inside the tree region
    [p, p + T) (the bitmap replaces it) and stale entries past it; unless
    the region starts ``p`` are given, they are drawn and the last row's
    region runs past the cache edge. Returns (pos_map, p)."""
    if p is None:
        p = torch.randint(S // 3, S - T, (B,), generator=gen, device=dev)
        p[-1] = S - T // 2
    ar = torch.arange(S, device=dev)
    pm = torch.where(ar[None, :] < p[:, None], ar[None, :],
                     torch.randint(-1, S, (B, S), generator=gen, device=dev))
    pm[:, 2] = -1
    return pm.to(torch.int32).contiguous(), p.to(torch.int32).contiguous()


def tree_validity(torch, pm, q_pos, mask, base):
    """(B, 1, T, S) bool: the position rule, replaced by the ancestor
    bitmap inside each row's tree region (the SDPA yardstick's mask)."""
    S, Wn = pm.shape[1], mask.shape[1]
    valid = (pm[:, None, :] >= 0) & (pm[:, None, :] <= q_pos[:, :, None])
    rel = torch.arange(S, device=pm.device)[None, :] - base[:, None].long()
    inr = (rel >= 0) & (rel < Wn)
    ov = mask[:, rel.clamp(0, Wn - 1)].transpose(0, 1)        # (B, T, S)
    return torch.where(inr[:, None, :], ov, valid)[:, None]


def check_tree_kernels(torch, gen, dev, geoms, tol) -> dict:
    """B1 with the tree mask (target verify window and a draft depth
    window), B4a, B4b alone and both in one launch (``tree_verify_fused``),
    each against its plain version."""
    from repro_torch.core.tree import TreeSpec
    from repro_torch.kernels.decode_attn import (decode_attn_call,
                                                 decode_attention_grouped)
    from repro_torch.kernels.verify import (tree_accept, tree_accept_plain,
                                            tree_argmax, tree_argmax_plain,
                                            tree_verify_fused)
    hd, S = 128, 131
    spec = TreeSpec(GAMMA_MAX, B_MAX, dev)
    T_all = spec.n_entries
    b1_err, b1_cases = 0.0, 0
    for rows, (Hkv, G) in (("verify", geoms["target"]),
                           ("depth", geoms["draft"])):
        if rows == "verify":
            mask, off = spec.win_mask, spec.tree_pos
        else:
            _, off, mask = spec.depth_windows[3]
        T = mask.shape[0]
        for dtype in (torch.bfloat16, torch.float32):
            B = 4
            q = torch.randn((B, T, Hkv, G, hd), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn((B, S, Hkv, hd), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((B, S, Hkv, hd), generator=gen,
                            device=dev).to(dtype)
            pm, base = tree_pos_map(torch, gen, B, S, T_all, dev)
            qp = (base[:, None] + off[None, :]).to(torch.int32).contiguous()
            out = decode_attn_call(q, k, v, pm, qp, win_mask=mask,
                                   win_base=base)
            ref = decode_attention_grouped(q, k, v, pm, qp, 0, mask, base)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(),
                                       **tol[dtype])
            b1_err = max(b1_err, float((out.float() - ref.float())
                                       .abs().max()))
            b1_cases += 1
    # the target's verify region across the first split boundary: every
    # row's region holds keys on both sides
    from repro_torch.kernels.decode_attn import split_plan
    Hkv, G = geoms["target"]
    mask, off = spec.win_mask, spec.tree_pos
    T = mask.shape[0]
    for dtype in (torch.bfloat16, torch.float32):
        edge, _ = split_plan(1, hd, dtype, Hkv)
        B, S_x = 4, edge + 44
        q = torch.randn((B, T, Hkv, G, hd), generator=gen,
                        device=dev).to(dtype)
        k = torch.randn((B, S_x, Hkv, hd), generator=gen,
                        device=dev).to(dtype)
        v = torch.randn((B, S_x, Hkv, hd), generator=gen,
                        device=dev).to(dtype)
        base = torch.tensor([edge - 6, edge - 1, edge - 20, edge - T + 1],
                            dtype=torch.int32, device=dev)
        pm, base = tree_pos_map(torch, gen, B, S_x, T, dev, base)
        qp = (base[:, None] + off[None, :]).to(torch.int32).contiguous()
        out = decode_attn_call(q, k, v, pm, qp, win_mask=mask,
                               win_base=base)
        ref = decode_attention_grouped(q, k, v, pm, qp, 0, mask, base)
        torch.cuda.synchronize()
        try:
            torch.testing.assert_close(out.float(), ref.float(),
                                       **tol[dtype])
        except AssertionError as e:
            fail(f"B1 tree region across split edge {edge}: {e}")
        b1_err = max(b1_err, float((out.float() - ref.float())
                                   .abs().max()))
        b1_cases += 1

    # B4a: (B 4, T 25, V 151936) f32, exact against torch.argmax
    B, T, V = 4, T_all, 151936
    argmax_cases = []
    x = torch.randn((B, T, V), generator=gen, device=dev).mul_(3.0)
    argmax_cases.append(("bf16-rounded", x.to(torch.bfloat16).float()))
    y = torch.randn((B, T, V), generator=gen, device=dev)
    # equal maxima in different threads' strides, in one thread's stride
    # (4·512·4 apart), in the vector head/tail, and three-way
    pairs = [(7, 90001), (2048, 8192 * 4 + 2048), (0, V - 1), (V - 2, V - 1),
             (513, 1025), (33, 151000)]
    for i in range(B * T):
        a, b_ = pairs[i % len(pairs)]
        y.view(-1, V)[i, [a, b_]] = 9.0
        if i % 5 == 0:
            y.view(-1, V)[i, 60000] = 9.0
    y[0, 0] = float("-inf")                       # all −inf row → 0
    argmax_cases.append(("planted ties + -inf row", y))
    buf = torch.randn(B * T * 1001 + 1, generator=gen, device=dev)
    odd = buf[1:].view(B, T, 1001)                # V odd, 4-byte misaligned
    odd[:, :, [3, 998]] = 7.0
    argmax_cases.append(("V 1001 misaligned", odd))
    for name, lg in argmax_cases:
        got, want = tree_argmax(lg), tree_argmax_plain(lg)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"B4a {name}: {bad} entries differ from torch.argmax")
    if int(tree_argmax(y)[0, 0]) != 0:
        fail("B4a: an all -inf row is not 0")

    # B4 in one launch at the served shape, on the argmax cases' logits:
    # entries follow the plain argmax at their parent with p 0.7; one
    # counter workspace for every launch below (B up to 64), checked back
    # at zero at the end
    counters = torch.zeros(64, dtype=torch.int32, device=dev)
    for name, lg in argmax_cases:
        tgt_p = tree_argmax_plain(lg)
        keep = torch.rand((B, T), generator=gen, device=dev) < 0.7
        toks = torch.where(keep, tgt_p[:, spec.parent_entry.long()],
                           torch.randint(0, lg.shape[2], (B, T),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)).contiguous()
        for g, b in ((GAMMA_MAX, B_MAX), (4, 2), (0, 1)):
            nv = spec.node_valid(g, b)
            got = tree_verify_fused(toks, lg, spec.parent_entry,
                                    spec.tree_pos, nv, spec.win_mask,
                                    spec.win_words, counters)
            want = tree_accept_plain(toks, tgt_p, spec.parent_entry,
                                     spec.tree_pos, nv, spec.win_mask)
            torch.cuda.synchronize()
            if not all(torch.equal(a_, w_) for a_, w_ in zip(got, want)):
                fail(f"tree_verify_fused {name} γ={g} b={b}: {got} != "
                     f"plain {want}")

    # B4b alone and B4a + B4b in one launch: planted matching paths on
    # several branches (every fourth row's to the last depth, so entries
    # of the last ancestor word win), every (γ, b), T 2 to 65 (one to
    # three ancestor words a row), B 1, 8 and 64
    accept_cases, last_word_wins, V_s = 0, 0, 4099
    trees = ((8, 3), (6, 4), (4, 1), (8, 4), (16, 4), (1, 1))
    for d_max, b_max in trees:
        sp = TreeSpec(d_max, b_max, dev)
        Tn, parent = sp.n_entries, sp.parent_np
        for Bn in (1, 8, 64):
            g2 = torch.Generator()
            g2.manual_seed(d_max * 1000 + b_max * 100 + Bn)
            toks = torch.randint(0, V_s, (Bn, Tn), generator=g2,
                                 dtype=torch.int32)
            tgt = torch.randint(0, V_s, (Bn, Tn), generator=g2,
                                dtype=torch.int32)
            for r in range(Bn):
                root = r % (b_max + 1)             # b_max: no root matches
                full = r % 4 == 3                  # root's branch matches
                for e in range(1, Tn):             # to the last depth
                    d, k_ = int(sp.depth_np[e]), int(sp.branch_np[e])
                    if (d == 0 and k_ == root) or (d > 0 and (
                            (r + e) % 3 != 0 or (full and k_ == root))):
                        tgt[r, parent[e]] = toks[r, e]
            toks, tgt = toks.to(dev), tgt.to(dev)
            lg = torch.randn((Bn, Tn, V_s), generator=gen, device=dev)
            lg.scatter_(2, tgt.long()[..., None], 8.0)
            tgt_p = tree_argmax_plain(lg)
            for g in range(d_max + 1):
                for b in range(1, b_max + 1):
                    nv = sp.node_valid(g, b)
                    want = tree_accept_plain(toks, tgt_p, sp.parent_entry,
                                             sp.tree_pos, nv, sp.win_mask)
                    alone = tree_accept(toks, tgt_p, sp.parent_entry,
                                        sp.tree_pos, nv, sp.win_mask,
                                        sp.win_words)
                    fused = tree_verify_fused(toks, lg, sp.parent_entry,
                                              sp.tree_pos, nv, sp.win_mask,
                                              sp.win_words, counters)
                    torch.cuda.synchronize()
                    for kname, got in (("B4b", alone),
                                       ("tree_verify_fused", fused)):
                        if not all(torch.equal(a_, w_)
                                   for a_, w_ in zip(got, want)):
                            fail(f"{kname} ({d_max},{b_max}) B={Bn} γ={g} "
                                 f"b={b}: {got} != plain {want}")
                    accept_cases += 1
                    last_word_wins += int((want[1] >= 32 * (
                        (Tn - 1) // 32)).sum()) if Tn > 32 else 0
    if not last_word_wins:
        fail("B4b sweep: no winner in the last ancestor word")
    if int(counters.abs().sum()) != 0:
        fail(f"tree_verify_fused counters after the sweep: {counters}")
    emit({"phase": "kernels", "check": "tree kernels == plain",
          "decode_attn_tree_cases": b1_cases,
          "decode_attn_tree_max_abs_err": b1_err,
          "tree_argmax_cases": [n for n, _ in argmax_cases],
          "tree_argmax_equal": True, "tree_accept_cases": accept_cases,
          "tree_accept_trees": [[d, b, 1 + d * b] for d, b in trees],
          "tree_accept_batches": [1, 8, 64],
          "tree_accept_last_word_winners": last_word_wins,
          "tree_accept_equal": True, "tree_verify_equal": True,
          "tolerance": {"decode_attn": {"float32": 1e-4, "bfloat16": 2e-2},
                        "tree_argmax": "exact", "tree_accept": "exact",
                        "tree_verify": "exact"}})
    return {"decode_attn_tree": b1_err, "tree_argmax": 0, "tree_accept": 0}


def time_tree_kernels(torch, gen, dev, geoms) -> dict:
    """The tree slice's kernels at its main-path shapes: B1 with the mask at
    the target's tree-verify window; B4a alone, B4b alone and both in one
    launch (the served call) at one verdict, beside an empty kernel (the
    launch floor under graph replay). ``ms``, ``plain_ms`` and
    ``library_ms`` are device times from CUDA-graph replay; ``eager_ms`` is
    the wrapper called in an eager loop."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.core.tree import TreeSpec
    from repro_torch.kernels.decode_attn import (decode_attn_call,
                                                 decode_attention_grouped)
    from repro_torch.kernels.verify import (tree_accept, tree_accept_plain,
                                            tree_argmax, tree_argmax_plain,
                                            tree_verify_fused)
    spec = TreeSpec(GAMMA_MAX, B_MAX, dev)
    B, T, hd, S = 4, spec.n_entries, 128, 131
    Hkv, G = geoms["target"]
    H = Hkv * G
    dt = torch.bfloat16
    q = torch.randn((B, T, Hkv, G, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dt)
    pm, base = tree_pos_map(torch, gen, B, S, T, dev)
    base.clamp_(max=S - T)                     # every region inside S
    qp = (base[:, None] + spec.tree_pos[None, :]).to(torch.int32)
    mask = spec.win_mask
    valid = tree_validity(torch, pm, qp, mask, base)
    qs = q.reshape(B, T, H, hd).transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, k.transpose(1, 2), v.transpose(1, 2), attn_mask=valid,
        enable_gqa=True)
    torch.testing.assert_close(
        sdpa().transpose(1, 2).float().reshape(B, T, Hkv, G, hd),
        decode_attention_grouped(q, k, v, pm, qp, 0, mask, base).float(),
        atol=2e-2, rtol=2e-2)
    kv_bytes = 2 * B * S * Hkv * hd * 2
    io_bytes = 2 * q.numel() * 2 + qp.numel() * 4 + pm.numel() * 4 \
        + mask.numel() + B * 4
    flops = 2 * 2 * B * T * H * S * hd
    b1_call = lambda: decode_attn_call(q, k, v, pm, qp, win_mask=mask,
                                       win_base=base)
    b1 = {"shape": {"B": B, "T": T, "Hkv": Hkv, "G": G, "hd": hd, "S": S,
                    "dtype": "bfloat16", "win_mask": [T, T]},
          "ms": graph_ms(torch, b1_call),
          "eager_ms": cuda_ms(torch, b1_call),
          "plain_ms": graph_ms(torch, lambda: decode_attention_grouped(
              q, k, v, pm, qp, 0, mask, base), iters=20),
          "library_ms": graph_ms(torch, sdpa),
          "bound_ms": max((kv_bytes + io_bytes) / HBM_BYTES_PER_S,
                          flops / BF16_FLOPS) * 1e3,
          "bound_by": "bytes" if (kv_bytes + io_bytes) / HBM_BYTES_PER_S
          >= flops / BF16_FLOPS else "operations"}

    V = 151936
    logits = torch.randn((B, T, V), generator=gen, device=dev)
    a_bytes = logits.numel() * 4 + B * T * 4
    argmax = {"shape": {"B": B, "T": T, "V": V, "dtype": "float32"},
              "ms": graph_ms(torch, lambda: tree_argmax(logits)),
              "eager_ms": cuda_ms(torch, lambda: tree_argmax(logits)),
              "plain_ms": graph_ms(torch, lambda: tree_argmax_plain(logits)),
              "library_ms": graph_ms(torch,
                                     lambda: torch.argmax(logits, -1)),
              "bound_ms": a_bytes / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes"}
    # entries follow the target's argmax at their parent with p 0.7, so
    # the verdicts reach past the anchor
    tgt = tree_argmax_plain(logits)
    keep = torch.rand((B, T), generator=gen, device=dev) < 0.7
    toks = torch.where(keep, tgt[:, spec.parent_entry.long()],
                       torch.randint(0, V, (B, T), generator=gen, device=dev,
                                     dtype=torch.int32)).contiguous()
    nv = spec.node_valid(GAMMA_MAX, B_MAX)
    words = spec.win_words
    tables = (spec.parent_entry, spec.tree_pos, nv, mask, words)
    args = (toks, tgt) + tables
    plain_args = (toks, tgt, spec.parent_entry, spec.tree_pos, nv, mask)
    # bytes each call must move: tokens, tables and packed words in, the
    # three (B,) verdicts out (B4b); the logits in, tgt and the verdicts
    # out (both in one launch)
    c_bytes = 2 * B * T * 4 + 2 * T * 4 + T + words.numel() * 4 + 3 * B * 4
    f_bytes = a_bytes + B * T * 4 + 2 * T * 4 + T + words.numel() * 4 \
        + 3 * B * 4
    accept = {"shape": {"B": B, "T": T, "words": list(words.shape)},
              "ms": graph_ms(torch, lambda: tree_accept(*args)),
              "eager_ms": cuda_ms(torch, lambda: tree_accept(*args)),
              "plain_ms": graph_ms(torch,
                                   lambda: tree_accept_plain(*plain_args)),
              "library_ms": None,
              "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes"}
    # the served call: 50 launches captured into one CUDA graph and
    # replayed five times (250 launches); then every captured launch's
    # verdict, as the last replay wrote it, against the plain pair, and
    # every counter back at 0
    want = tree_accept_plain(*plain_args)
    counters = torch.zeros(B, dtype=torch.int32, device=dev)
    outs = []
    fused_call = lambda: outs.append(
        tree_verify_fused(toks, logits, *tables, counters))

    def replayed():
        captured = outs[-50:]
        for out in captured:
            if not all(torch.equal(a_, w_) for a_, w_ in zip(out, want)):
                fail(f"tree_verify_fused after 250 graph replays: {out} "
                     f"!= {want}")
        if int(counters.abs().sum()) != 0:
            fail(f"tree_verify_fused counters after 250 graph replays: "
                 f"{counters}")

    fused = {"shape": {"B": B, "T": T, "V": V, "dtype": "float32"},
             "ms": graph_ms(torch, fused_call, iters=50, replays=4,
                            after=replayed)}
    fused.update({
        "eager_ms": cuda_ms(torch, fused_call),
        "plain_ms": graph_ms(torch, lambda: tree_accept_plain(
            toks, tree_argmax_plain(logits), *plain_args[2:])),
        "library_ms": None,
        "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes"})
    fused["replayed_launches_checked"] = 250
    fused["verdict"] = [x.tolist() for x in want]
    # times the empty kernel, the launch floor: a probe, not a wrapper
    lib = kernels.library()  # noqa: DSD004
    empty = lambda: lib.empty_kernel_launch(
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch("empty_kernel", empty())
    return {"decode_attn_tree_verify": b1, "tree_argmax": argmax,
            "tree_accept": accept, "tree_verify": fused,
            "launch_floor_ms": graph_ms(torch, empty)}


# ------------------------------------------------------ sampled verify (B3)

def sampled_window(torch, gen, B, G, V, dtype, dev, misalign=False):
    """p (B, G+1, V), q (B, G, V): softmaxes of 2·N(0, 1) logits, q == p on
    rows 0 and 1 (the accept path), draft tokens drawn from q, all cast to
    ``dtype``; ``misalign`` shifts both into buffers one element off a
    16-byte boundary."""
    from repro_torch.core.specdec import sample_from_probs
    p = torch.softmax(2 * torch.randn((B, G + 1, V), generator=gen,
                                      device=dev), -1)
    q = torch.softmax(2 * torch.randn((B, G, V), generator=gen, device=dev),
                      -1)
    q[:2] = p[:2, :G]
    toks = sample_from_probs(q, gen)
    p, q = p.to(dtype), q.to(dtype)
    if misalign:
        def shift(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            y = buf[1:].view(x.shape)
            y.copy_(x)
            return y
        p, q = shift(p), shift(q)
    return toks, p, q


def plant_case(torch, case, toks, p, q, u, r):
    """Edge cases on rows 2 and 3 (rows 0 and 1 keep q == p)."""
    one_less = 1.0 - 2.0 ** -24
    rows = [2, 3]
    if case == "zero-mass residual":
        # halve p at the draft token and nowhere else raise it: the
        # position-0 residual is empty, so the row samples p (use_p)
        for b in rows:
            q[b, 0] = p[b, 0]
            p[b, 0, toks[b, 0]] *= 0.5
        u[rows, 0] = 0.9
    elif case == "all-zero p row":
        p[rows, 0] = 0.0
    elif case == "u = r = 0":
        u.zero_()
        r.zero_()
    elif case == TAIL_CASE:
        u.fill_(one_less)
        r.fill_(one_less)


def bracket_ok(np, dist64, thresh, a, b, tol=1e-5) -> bool:
    """Both tokens are a crossing of ``thresh`` on the float64 CDF within
    ``tol`` (cdf[t−1] ≤ thresh < cdf[t], each side loosened by tol): the
    threshold lies at a CDF step, where float32 cumsum orders disagree."""
    cdf = np.cumsum(dist64)
    for t in (a, b):
        lo = cdf[t - 1] if t > 0 else 0.0
        if not (lo - tol <= thresh <= cdf[t] + tol):
            return False
    return True


def cdf_tokens_f32_running_sum(torch, np, sel, p, q) -> list:
    """B3b's tokens by the reference Pallas kernel's rule, for comparison
    only: dist in float32, its running sum in float32 added in token order
    (numpy's cumsum adds in order), the first v whose sum exceeds thresh,
    V − 1 when none does."""
    rows = torch.arange(p.shape[0], device=p.device)
    p_j = p[rows, sel.jrow.long()].float()
    q_j = q[rows, sel.qrow.long()].float()
    dist = torch.where(sel.use_p[:, None] > 0, p_j,
                       (p_j - q_j).clamp_min(0.0)).cpu().numpy()
    out = []
    for b, th in enumerate(sel.thresh.float().cpu().numpy()):
        hit = np.nonzero(np.cumsum(dist[b], dtype=np.float32) > th)[0]
        out.append(int(hit[0]) if hit.size else p.shape[-1] - 1)
    return out


def check_sampled_kernels(torch, gen, dev) -> dict:
    """B3a and B3b against their plain versions on the same card tensors,
    and the glue on the card (kernels) against the glue on CPU copies
    (plain versions), at (B 4, Γ 8) and V 151936, 50304, 32000 (the
    zamba2 ← mamba2-130m pair's) and a misaligned 1001, in float32 and
    bfloat16, over planted cases and every active γ.
    p_at/q_at, accept counts and masks exact; the mass within 1e-6 +
    1e-5·mass (float32 sums in another order); tokens exact except where
    the threshold lies at a CDF step (a float64 CDF brackets it for both
    tokens within 1e-5). Such rows are counted, and the run fails if they
    exceed FLAG_SHARE of a check's rows, or FLAG_SHARE_INNER of its rows
    outside the planted tail case (r = 1 − 2⁻²⁴ puts every threshold
    within 2⁻²⁴ of the row's last CDF step). The B3b line also reports,
    without a limit, how many rows' kernel and plain tokens differ from the
    reference kernel's float32 running-sum rule (the plain version and the
    kernel sum in float64). Returns the mass error and, for B3b, the
    largest |kernel token − plain token| with the counts."""
    import numpy as np
    from repro_torch.kernels.verify import (cdf_sample, cdf_sample_plain,
                                            gather_reduce,
                                            gather_reduce_plain,
                                            verify_window_fused)
    from repro_torch.kernels.verify.ops import select_rows
    B, G = 4, GAMMA_MAX
    cases = ["random", "zero-mass residual", "all-zero p row", "u = r = 0",
             TAIL_CASE]
    mass_err, flagged = 0.0, []
    rows = {"B3b": {"all": 0, "inner": 0}, "glue": {"all": 0, "inner": 0}}
    vs_f32 = {"rows": 0, "kernel_differs": 0, "kernel_differs_outside_tail": 0,
              "plain_differs": 0, "plain_differs_outside_tail": 0}
    for V, misalign in ((151936, False), (50304, False), (32000, False),
                        (1001, True)):
        for dtype in (torch.float32, torch.bfloat16):
            for case in cases + [f"ag={a}" for a in range(G + 1)]:
                toks, p, q = sampled_window(torch, gen, B, G, V, dtype, dev,
                                            misalign)
                u = torch.rand((B, G), generator=gen, device=dev)
                r = torch.rand((B,), generator=gen, device=dev)
                plant_case(torch, case, toks, p, q, u, r)
                ag = (torch.full((B,), int(case[3:]), dtype=torch.int32,
                                 device=dev) if case.startswith("ag=")
                      else None)
                label = f"V{V} {str(dtype)[6:]} {case}"
                # B3a
                got = gather_reduce(toks, p, q)
                want = gather_reduce_plain(toks, p, q)
                torch.cuda.synchronize()
                for a_, w_, name in zip(got[:2], want[:2], ("p_at", "q_at")):
                    if not torch.equal(a_, w_):
                        fail(f"B3a {label}: {name} differs from plain")
                d = (got[2] - want[2]).abs()
                if (d > 1e-6 + 1e-5 * want[2].abs()).any():
                    fail(f"B3a {label}: mass off by {float(d.max())}")
                mass_err = max(mass_err, float(d.max()))
                # B3b on identical inputs
                sel = select_rows(*want, u, r, ag)
                args = (sel.jrow, sel.qrow, sel.use_p, p, q, sel.thresh)
                tk, tp = cdf_sample(*args), cdf_sample_plain(*args)
                f32 = cdf_tokens_f32_running_sum(torch, np, sel, p, q)
                vs_f32["rows"] += B
                for who, got_t in (("kernel", tk), ("plain", tp)):
                    n_diff = sum(int(a_) != f_ for a_, f_ in
                                 zip(got_t.tolist(), f32))
                    vs_f32[f"{who}_differs"] += n_diff
                    if case != TAIL_CASE:
                        vs_f32[f"{who}_differs_outside_tail"] += n_diff
                # the glue: card (kernels) vs CPU copies (plain versions)
                cpu = lambda x: None if x is None else x.cpu()
                gk = verify_window_fused(toks, q, p, u, r, ag)
                gp = verify_window_fused(*map(cpu, (toks, q, p, u, r, ag)))
                for tag in rows:
                    rows[tag]["all"] += B
                    rows[tag]["inner"] += B * (case != TAIL_CASE)
                if not (torch.equal(gk.n_accepted.cpu(), gp.n_accepted)
                        and torch.equal(gk.accept_mask.cpu(),
                                        gp.accept_mask)):
                    fail(f"glue {label}: accept counts/masks differ")
                sel_c = select_rows(*gather_reduce_plain(*map(
                    cpu, (toks, p, q))), *map(cpu, (u, r, ag)))
                for tag, a_t, b_t, s_ in (
                        ("B3b", tk.cpu(), tp.cpu(), sel),
                        ("glue", gk.next_token.cpu(), gp.next_token, sel_c)):
                    for b in torch.nonzero(a_t != b_t).flatten().tolist():
                        jr, qr = int(s_.jrow[b]), int(s_.qrow[b])
                        p_j = p[b, jr].double().cpu().numpy()
                        dist = p_j if int(s_.use_p[b]) else np.maximum(
                            p_j - q[b, qr].double().cpu().numpy(), 0.0)
                        th = float(s_.thresh[b])
                        a_i, b_i = int(a_t[b]), int(b_t[b])
                        if not bracket_ok(np, dist, th, a_i, b_i):
                            fail(f"{tag} {label} row {b}: token {a_i} vs "
                                 f"plain {b_i}, threshold {th} not at a "
                                 "CDF step")
                        # the CDF step the two tokens disagree about
                        step = float(np.cumsum(dist)[min(a_i, b_i)])
                        flagged.append({"check": tag, "case": label,
                                        "tail": case == TAIL_CASE,
                                        "row": b, "kernel": a_i,
                                        "plain": b_i, "thresh": th,
                                        "cdf_gap": abs(th - step)})
                if case == "all-zero p row":
                    if not (gk.next_token[2:] == V - 1).all():
                        fail(f"glue {label}: an all-zero row is not V - 1")
    counts = {}
    for tag, n in rows.items():
        mine = [f for f in flagged if f["check"] == tag]
        inner = [f for f in mine if not f["tail"]]
        counts[tag] = {"rows": n["all"], "flagged": len(mine),
                       "rows_outside_tail": n["inner"],
                       "flagged_outside_tail": len(inner)}
    token_err = max((abs(f["kernel"] - f["plain"]) for f in flagged),
                    default=0)
    cdf_gap = max((f["cdf_gap"] for f in flagged), default=0.0)
    emit({"phase": "kernels", "check": "sampled kernels == plain",
          "rows_flagged": counts, "cases": cases + ["ag=0..8"],
          "B3b_vs_float32_running_sum": vs_f32,
          "vocab": [151936, 50304, 32000, 1001],
          "dtypes": ["float32", "bfloat16"],
          "gather_reduce_mass_max_abs_err": mass_err,
          "cdf_sample_token_max_abs_err": token_err,
          "flagged_max_cdf_gap": cdf_gap, "flagged": flagged[:20],
          "tolerance": {"p_at/q_at/accept": "exact",
                        "mass": "1e-6 + 1e-5*mass",
                        "token": "exact unless both bracket the threshold "
                                 "on a float64 CDF within 1e-5",
                        "flagged_share": [FLAG_SHARE, FLAG_SHARE_INNER]}})
    for tag, n in rows.items():
        c = counts[tag]
        if (c["flagged"] > FLAG_SHARE * n["all"]
                or c["flagged_outside_tail"] > FLAG_SHARE_INNER * n["inner"]):
            fail(f"{tag}: {c['flagged']} of {n['all']} rows flagged at a CDF "
                 f"step ({c['flagged_outside_tail']} of {n['inner']} outside "
                 f"the tail case), over the {FLAG_SHARE:.0%} / "
                 f"{FLAG_SHARE_INNER:.0%} limits")
    return {"gather_reduce": mass_err, "cdf_sample": token_err,
            "cdf_sample_flagged": dict(counts, max_cdf_gap=cdf_gap)}


def check_cdf_sample_determinism(torch, gen, dev) -> None:
    """B3b's token of a row depends on that row alone: each row of a B 4
    call (V 151936 and a misaligned 1001, float32 and bfloat16, p rows and
    residual rows) equals the token of a B 1 call on that row's window,
    and a second B 4 call gives the same tokens."""
    from repro_torch.kernels.verify import cdf_sample
    B, G = 4, GAMMA_MAX
    checked = 0
    for V, misalign in ((151936, False), (1001, True)):
        for dtype in (torch.float32, torch.bfloat16):
            _, p, q = sampled_window(torch, gen, B, G, V, dtype, dev,
                                     misalign)
            jrow = torch.tensor([0, 3, G, 5], dtype=torch.int32, device=dev)
            qrow = jrow.clamp(max=G - 1)
            use_p = torch.tensor([1, 0, 1, 0], dtype=torch.int32,
                                 device=dev)
            thresh = torch.rand((B,), generator=gen, device=dev) * 0.5
            args = (jrow, qrow, use_p, p, q, thresh)
            first, again = cdf_sample(*args), cdf_sample(*args)
            if not torch.equal(first, again):
                fail(f"B3b V{V} {dtype}: two runs differ: "
                     f"{first.tolist()} vs {again.tolist()}")
            for b in range(B):
                one = cdf_sample(*(a[b:b + 1].contiguous() for a in args))
                if int(one[0]) != int(first[b]):
                    fail(f"B3b V{V} {dtype} row {b}: {int(one[0])} in a B 1 "
                         f"call, {int(first[b])} in a B 4 call")
                checked += 1
    emit({"phase": "kernels", "check": "cdf_sample B 1 == B 4, run == run",
          "rows": checked, "vocab": [151936, 1001],
          "dtypes": ["float32", "bfloat16"]})


def check_sampled_distribution(torch, dev) -> None:
    """The card path of the sampled verify, 2^16 rows of one fixed (p, q)
    window at V 16, Γ 4: the first committed token (draft token 0 if
    accepted, else the resample) must follow p_0 (chi-square p > 1e-4 at a
    fixed seed)."""
    from scipy import stats
    from repro_torch.core.specdec import sample_from_probs
    from repro_torch.kernels.verify import verify_window_fused
    N, G, V = 1 << 16, 4, 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    p1 = torch.softmax(torch.randn((G + 1, V), generator=gen, device=dev),
                       -1)
    q1 = torch.softmax(torch.randn((G, V), generator=gen, device=dev), -1)
    p = p1.expand(N, G + 1, V).contiguous()
    q = q1.expand(N, G, V).contiguous()
    toks = sample_from_probs(q, gen)
    u = torch.rand((N, G), generator=gen, device=dev)
    r = torch.rand((N,), generator=gen, device=dev)
    out = verify_window_fused(toks, q, p, u, r)
    first = torch.where(out.n_accepted > 0, toks[:, 0], out.next_token)
    counts = torch.bincount(first.long(), minlength=V).cpu().numpy()
    expect = p1[0].double().cpu().numpy() * N
    pval = float(stats.chisquare(counts, expect * counts.sum()
                                 / expect.sum()).pvalue)
    info = {"phase": "kernels", "check": "sampled first-token marginal",
            "rows": N, "V": V, "gamma": G, "chi2_pvalue": pval,
            "acceptance_pos0": float((out.n_accepted > 0).float().mean())}
    emit(info)
    if not pval > 1e-4:
        fail(f"first committed token is not distributed as p_0 "
             f"(chi-square p = {pval})")


def cycle(fns):
    """One callable that calls ``fns`` in turn: timing it over copies of the
    inputs larger together than the 50 MB L2 finds each launch's inputs
    evicted (cold), as a fresh round's probabilities may be."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()
    return call


def time_sampled_kernels(torch, gen, dev) -> dict:
    """B3a and B3b at the main path's shape (B 4, Γ 8, V 151936, float32
    probabilities, one round's typical selection): device time by CUDA-
    graph replay over three copies of the inputs (123 MB, so L2-cold:
    ``ms``) and over one copy (L2-warm: ``warm_ms``), beside the eager
    wrapper (``eager_ms``), the plain version (graph, cold) and the bound;
    no single PyTorch call computes either function (``library_ms``
    null)."""
    from repro_torch.kernels.verify import (cdf_sample, cdf_sample_plain,
                                            gather_reduce,
                                            gather_reduce_plain,
                                            verify_window_fused)
    from repro_torch.kernels.verify.ops import select_rows
    B, G, V = 4, GAMMA_MAX, 151936
    copies = []
    for _ in range(3):
        toks, p, q = sampled_window(torch, gen, B, G, V, torch.float32, dev)
        u = torch.rand((B, G), generator=gen, device=dev)
        r = torch.rand((B,), generator=gen, device=dev)
        sel = select_rows(*gather_reduce(toks, p, q), u, r)
        copies.append((toks, p, q, u, r, sel))
    toks, p, q, u, r, sel = copies[0]
    pass_a = lambda f: cycle([lambda c=c: f(*c[:3]) for c in copies])
    pass_b = lambda f: cycle([lambda c=c: f(c[5].jrow, c[5].qrow,
                                            c[5].use_p, c[1], c[2],
                                            c[5].thresh) for c in copies])
    # pass A reads the Γ window rows of p and of q once and writes 3 (B, Γ)
    a_bytes = 2 * B * G * V * 4 + toks.numel() * 4 + 3 * B * G * 4
    reduce_ = {"shape": {"B": B, "gamma": G, "V": V, "dtype": "float32"},
               "ms": graph_ms(torch, pass_a(gather_reduce), iters=48),
               "warm_ms": graph_ms(torch, lambda: gather_reduce(toks, p, q)),
               "eager_ms": cuda_ms(torch, pass_a(gather_reduce), iters=48),
               "plain_ms": graph_ms(torch, pass_a(gather_reduce_plain),
                                    iters=48),
               "library_ms": None,
               "bound_ms": a_bytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
    args = (sel.jrow, sel.qrow, sel.use_p, p, q, sel.thresh)
    tok = cdf_sample(*args)
    # pass B must read the selected row (and the q row unless use_p) up
    # to the crossing, + the four (B,) inputs and the token — averaged
    # over the three copies the timing cycles through
    need = sum(int(((cdf_sample(c[5].jrow, c[5].qrow, c[5].use_p, c[1],
                                c[2], c[5].thresh).long() + 1) * 4
                    * (2 - c[5].use_p.long())).sum()) for c in copies)
    b_bytes = need / len(copies) + 5 * B * 4
    sample = {"shape": {"B": B, "gamma": G, "V": V, "dtype": "float32"},
              "n_accepted": sel.n_acc.tolist(),
              "use_p": sel.use_p.tolist(), "token": tok.tolist(),
              "ms": graph_ms(torch, pass_b(cdf_sample), iters=48),
              "warm_ms": graph_ms(torch, lambda: cdf_sample(*args)),
              "eager_ms": cuda_ms(torch, pass_b(cdf_sample), iters=48),
              "plain_ms": graph_ms(torch, pass_b(cdf_sample_plain),
                                   iters=48),
              "library_ms": None,
              "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes"}
    glue_fn = lambda: cycle([lambda c=c: verify_window_fused(
        c[0], c[2], c[1], c[3], c[4]) for c in copies])
    glue = {"ms": graph_ms(torch, glue_fn(), iters=48),
            "eager_ms": cuda_ms(torch, glue_fn(), iters=48)}
    return {"gather_reduce": reduce_, "cdf_sample": sample,
            "verify_window_fused": glue}


def _greedy(torch, model, params, prompt, n, slots, dev):
    """Target-only greedy decode of one prompt (T = 1 steps)."""
    toks = torch.as_tensor(prompt[None, :].astype("int64"), device=dev)
    logits, cache = model.prefill(params, toks, slots)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = [tok]
    pos = torch.full((1,), prompt.size, dtype=torch.int32, device=dev)
    gaps = []
    for _ in range(n - 1):
        logits, cache = model.decode_step(params, tok, cache, pos)
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return (torch.cat(out).cpu().numpy(),
            torch.cat(gaps).cpu().numpy() if gaps else None)


def _workload(np, vocab, n=8, seed=0, max_new=32):
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(8, 48))
        reqs.append(ServeRequest(
            i, rng.integers(0, vocab, plen).astype(np.int32), max_new))
    return reqs


def _serve(engine, policy, reqs, batch: int = 4, **cfg_kw):
    from repro_torch.serving import ServerConfig, SpecDecodeServer
    srv = SpecDecodeServer(engine, policy, ServerConfig(
        max_batch=batch, sync_every=8, **cfg_kw))
    for r in reqs:
        srv.submit(dataclasses.replace(r))
    res = {r.request_id: r for r in srv.run()}
    return srv, res


def graph_counts(eng) -> dict:
    g = eng.graphs
    return {"captured": g.captured, "replays": g.replays,
            "warm_ups": g.warm_ups}


def graphs_since(eng, before: dict) -> dict:
    now = graph_counts(eng)
    return {k: now[k] - before[k] for k in now}


def want_graphs(steps: int, calls: int) -> dict:
    """Graphs of ``steps`` captured steps called ``calls`` times in all:
    each warms up once, captures once, and serves every later call by a
    replay."""
    return {"captured": steps, "replays": calls - steps, "warm_ups": steps}


def step_calls(eng) -> dict:
    """Calls so far of every captured step in the engine's slot pools, by
    (pool, step name): the pools outlive sessions, and so do their steps'
    graphs."""
    out = {}
    for pools in eng.pools.values():
        for pool in pools:
            steps = dict(pool.steps)
            if pool.wire is not None:
                steps.update(pool.wire["steps"])
            out.update({(id(pool), k): st.calls for k, st in steps.items()})
    return out


def pool_graphs(eng, before: dict, calls: dict) -> tuple:
    """The graphs a run on ``eng`` should have made, given the calls of
    its steps (``calls``, by step name, summed over the pools it used) and
    each pooled step's calls before it (``before``, :func:`step_calls`): a
    step's first call ever warms up, its second captures and replays, every
    later call replays, in whichever session of its pool it falls. Fails
    unless the steps were called as ``calls`` says. Returns the expected
    graphs and the number of steps that had run before the run."""
    after = step_calls(eng)
    made, warm = {}, 0
    want = {"captured": 0, "replays": 0, "warm_ups": 0}
    for key, total in after.items():
        p = before.get(key, 0)
        n = total - p
        if not n:
            continue
        made[key[1]] = made.get(key[1], 0) + n
        warm += p > 0
        want["warm_ups"] += p == 0
        want["captured"] += p <= 1 < p + n
        want["replays"] += max(0, p + n - 1) - max(0, p - 1)
    called = {k: n for k, n in calls.items() if n}
    if made != called:
        fail(f"step calls {made}, expected {called}")
    return want, warm


def summary_graphs(s: dict) -> dict:
    return {"captured": s["captured_graphs"], "replays": s["graph_replays"],
            "warm_ups": s["graph_warm_ups"]}


class WinnerLog:
    """Records each tree round's winning entries (and which rows were
    already done) by wrapping the engine's verdict call; the wrapped call
    is the real one, so launch counts are unchanged. It runs once per
    round only in eager sessions (``capture=False``). Information only."""

    def __init__(self):
        import repro_torch.core.engine as engine_mod
        self.mod, self.real = engine_mod, engine_mod.tree_verify_fused
        self.sess, self.rounds = None, []

    def __enter__(self):
        def recording(*args):
            out = self.real(*args)
            self.rounds.append((out[1].clone(), self.sess._done.clone()))
            return out
        self.mod.tree_verify_fused = recording
        return self

    def __exit__(self, *exc):
        self.mod.tree_verify_fused = self.real

    def side_wins(self, branch_np) -> int:
        """(round, active row) pairs whose winner lies on a branch > 0."""
        return sum(int(((branch_np[w.cpu().numpy()] > 0)
                        & ~d.cpu().numpy()).sum()) for w, d in self.rounds)


def run_sessions(np, eng, reqs, policy, max_branches: int, batch: int = 4,
                 log=None, seed: int = 0, capture=None,
                 transport=None, mode_policy: str = "auto") -> dict:
    """Decode ``reqs`` wave by wave (``batch`` at a time) through
    ``DecodeSession`` as ``benchmarks/bench_tree.py`` run_cell drives it:
    ``admit_batch`` the wave, ``run_chunk`` until every row stops,
    ``snapshot``, ``close``. ``capture`` goes to each session (None:
    rounds replayed from the graph of the session's pool, captured by the
    pool's first session), and so does ``transport`` (the split rounds
    over it; None: colocated). Returns per-request tokens and the summed
    statistics."""
    from repro_torch.core.session import DecodeSession
    out = {"tokens": {}, "bits": {}, "rounds": 0, "fused": 0, "waves": 0,
           "hits": 0, "misses": 0,
           "accepted": 0, "proposed": 0, "wall_s": 0.0,
           "decode_wall_s": 0.0, "tpot_ms": []}
    for w0 in range(0, len(reqs), batch):
        wave = reqs[w0:w0 + batch]
        lens = np.array([r.prompt.size for r in wave], np.int32)
        prompts = np.zeros((len(wave), int(lens.max())), np.int32)
        for i, r in enumerate(wave):
            prompts[i, :r.prompt.size] = r.prompt
        max_new = wave[0].max_new_tokens
        sess = DecodeSession(eng, capacity=len(wave), max_new_cap=max_new,
                             gamma_max=GAMMA_MAX, sync_every=8,
                             max_branches=max_branches, seed=seed + w0,
                             capture=capture, transport=transport,
                             mode_policy=mode_policy)
        if log is not None:
            log.sess = sess
        t0 = time.perf_counter()
        sess.admit_batch(prompts, max_new, prompt_lens=lens,
                         request_ids=[r.request_id for r in wave])
        while sess.unfinished:
            sess.run_chunk(policy)
        toks, st = sess.snapshot()
        sess.close()
        out["wall_s"] += time.perf_counter() - t0
        for i, r in enumerate(wave):
            out["tokens"][r.request_id] = toks[i]
            out["bits"][r.request_id] = st.acceptance_seqs[i]
        out["rounds"] += sess.iterations
        out["fused"] += sess.fused_iterations
        out["hits"] += sess.pipeline_hits
        out["misses"] += sess.pipeline_misses
        out["accepted"] += st.accepted
        out["proposed"] += st.proposed
        out["decode_wall_s"] += sess.decode_wall_s
        out["tpot_ms"].append(sess.decode_wall_s * 1e3 / max(1, max_new - 1))
        out["waves"] += 1
    out["tokens_total"] = sum(t.size for t in out["tokens"].values())
    out["acceptance"] = out["accepted"] / max(1, out["proposed"])
    return out


class RecordingPolicy:
    """Forwards to a window policy and keeps the γ and branch width each
    round actually runs (the session clamps b to b_max; a fused round runs
    γ 0, b 1)."""

    def __init__(self, inner, b_max: int):
        self.inner, self.b_max, self.widths, self.gammas = inner, b_max, [], []

    def decide(self, pair_key, feats):
        dec = self.inner.decide(pair_key, feats)
        fused = dec.mode == "fused"
        self.widths.append(1 if fused
                           else min(self.b_max, max(1, int(dec.branches))))
        self.gammas.append(0 if fused
                           else min(GAMMA_MAX, max(1, int(dec.gamma))))
        return dec

    def gamma_bound(self):
        return self.inner.gamma_bound()


def noised_copy(torch, params, scale: float, seed: int):
    """Draft = target + N(0, (scale·std)²) per tensor, drawn on the card
    (benchmarks/bench_tree.py's noised draft): same architecture, an
    acceptance rate strictly between 0 and 1."""
    gen = torch.Generator(device=params["embed"].device)
    gen.manual_seed(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        noise = torch.randn(tree.shape, generator=gen, device=tree.device,
                            dtype=torch.float32)
        return (tree.float() + scale * tree.float().std() * noise).to(
            tree.dtype)
    return walk(params)


def tree_exact(torch, np, t_cfg, target, target_params, dev) -> None:
    """Float32, qwen3-14b widths at 2 layers, draft = noised target copy:
    tree (static γ 4 × b 3) == linear (γ 4) == target-only greedy, and
    max_branches=1 == linear bit for bit."""
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.tree import TreeSpec
    from repro_torch.core.window import StaticWindowPolicy
    t0 = time.perf_counter()
    eng = SpecDecodeEngine(t_cfg, t_cfg, target_params=target_params,
                           draft_params=noised_copy(torch, target_params,
                                                    TREE_NOISE, 7),
                           gamma_max=GAMMA_MAX, device=dev)
    reqs = _workload(np, t_cfg.vocab)
    lin = run_sessions(np, eng, reqs, StaticWindowPolicy(4), 0)
    with WinnerLog() as log:            # reads each round: eager rounds
        tree = run_sessions(np, eng, reqs,
                            StaticWindowPolicy(4, branches=B_MAX), B_MAX,
                            log=log, capture=False)
    one = run_sessions(np, eng, reqs, StaticWindowPolicy(4), 1)
    side = log.side_wins(TreeSpec(GAMMA_MAX, B_MAX).branch_np)
    mismatches = []
    for r in reqs:
        ref, _ = _greedy(torch, target, target_params, r.prompt,
                         r.max_new_tokens, r.prompt.size + 64, dev)
        for name, run in (("linear", lin), ("tree", tree),
                          ("tree_b1", one)):
            if not np.array_equal(run["tokens"][r.request_id], ref):
                mismatches.append({"run": name, "request": r.request_id})
        if one["bits"][r.request_id] != lin["bits"][r.request_id]:
            mismatches.append({"run": "tree_b1 bits",
                               "request": r.request_id})
    info = {"phase": "exact", "check": "tree", "dtype": "float32",
            "target": t_cfg.name, "draft": f"{t_cfg.name} + noise "
            f"{TREE_NOISE}", "layers": t_cfg.n_layers,
            "requests": len(reqs), "gamma": 4, "branches": B_MAX,
            "acceptance": {"linear": lin["acceptance"],
                           "tree": tree["acceptance"],
                           "tree_b1": one["acceptance"]},
            "rounds": {"linear": lin["rounds"], "tree": tree["rounds"],
                       "tree_b1": one["rounds"]},
            "tree_rounds_won_on_branch_gt0": side,
            "mismatches": mismatches,
            "seconds": time.perf_counter() - t0}
    emit(info)
    if mismatches:
        fail(f"tree exactness: {mismatches}")
    if not 0.0 < lin["acceptance"] < 1.0:
        fail(f"noised draft acceptance {lin['acceptance']} is not strictly "
             "between 0 and 1")
    if (one["accepted"], one["rounds"]) != (lin["accepted"], lin["rounds"]):
        fail("max_branches=1 tree differs from linear in accept counts")
    del eng
    torch.cuda.empty_cache()


def sampled_exact(torch, np, t_cfg, target_params, dev) -> None:
    """Float32, qwen3-14b widths at 2 layers, temperature 1.0: a
    self-speculation pair (draft = target weights) accepts ≥ 0.99 through
    the server; a draft = target + 0.05·std noise accepts strictly between
    0 and 1 in waves; two wave runs with the same seeds commit identical
    tokens and acceptance bits."""
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy
    t0 = time.perf_counter()
    reqs = _workload(np, t_cfg.vocab)
    self_eng = SpecDecodeEngine(t_cfg, t_cfg, draft_params=target_params,
                                target_params=target_params,
                                temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                                device=dev)
    _, selfspec = _serve(self_eng, StaticWindowPolicy(4), reqs)
    del self_eng
    self_acc = float(np.mean([selfspec[r.request_id].acceptance_rate
                              for r in reqs]))
    eng = SpecDecodeEngine(t_cfg, t_cfg, target_params=target_params,
                           draft_params=noised_copy(torch, target_params,
                                                    TREE_NOISE, 7),
                           temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                           device=dev)
    runs = [run_sessions(np, eng, reqs, StaticWindowPolicy(4), 0, seed=3)
            for _ in range(2)]
    same = all(np.array_equal(runs[0]["tokens"][i], runs[1]["tokens"][i])
               and runs[0]["bits"][i] == runs[1]["bits"][i]
               for i in runs[0]["tokens"])
    V = t_cfg.vocab
    full = all(t.size == 32 and (t >= 0).all() and (t < V).all()
               for run in runs for t in run["tokens"].values())
    info = {"phase": "exact", "check": "sampled", "dtype": "float32",
            "temperature": SAMPLED_T, "target": t_cfg.name,
            "layers": t_cfg.n_layers, "requests": len(reqs),
            "self_spec_acceptance": self_acc,
            "noised_draft": f"{t_cfg.name} + noise {TREE_NOISE}",
            "noised_acceptance": runs[0]["acceptance"],
            "noised_rounds": runs[0]["rounds"],
            "same_seed_identical": same, "all_full_in_range": full,
            "seconds": time.perf_counter() - t0}
    emit(info)
    if self_acc < 0.99:
        fail(f"sampled self-speculation acceptance {self_acc} < 0.99")
    if not 0.0 < runs[0]["acceptance"] < 1.0:
        fail(f"sampled noised-draft acceptance {runs[0]['acceptance']} is "
             "not strictly between 0 and 1")
    if not same:
        fail("two sampled runs with the same seed differ")
    if not full:
        fail("sampled runs: incomplete or out-of-range outputs")
    del eng
    torch.cuda.empty_cache()


def phase_exact(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=2,
                                dtype="float32")
    d_cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2,
                                dtype="float32")
    t0 = time.perf_counter()
    eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    reqs = _workload(np, t_cfg.vocab)
    pol = lambda: StaticWindowPolicy(4)
    srv_d, dense = _serve(eng, pol(), reqs)
    sess = srv_d._sessions[0]
    parity = sess.capacity * sess._n_logical()
    srv_p, paged = _serve(eng, pol(), reqs, paged_kv=True,
                          kv_pool_blocks=int(0.6 * parity))
    self_eng = SpecDecodeEngine(t_cfg, t_cfg,
                                draft_params=eng.target_params,
                                target_params=eng.target_params,
                                gamma_max=GAMMA_MAX, device=dev)
    _, selfspec = _serve(self_eng, pol(), reqs)
    mismatches = []
    for r in reqs:
        ref, gaps = _greedy(torch, eng.target, eng.target_params, r.prompt,
                            r.max_new_tokens, sess.slots_len, dev)
        for name, res in (("dense", dense), ("paged", paged),
                          ("self_spec", selfspec)):
            got = res[r.request_id].tokens
            if not np.array_equal(got, ref):
                i = int(np.argmax(got != ref)) if got.size == ref.size else 0
                gap = float(gaps[i - 1]) if i >= 1 else None
                mismatches.append({"run": name, "request": r.request_id,
                                   "first_diff": i, "top2_gap": gap})
    acc = [selfspec[r.request_id].acceptance_rate for r in reqs]
    info = {"phase": "exact", "dtype": "float32",
            "target": t_cfg.name, "draft": d_cfg.name, "layers": 2,
            "requests": len(reqs), "paged_pool_blocks": int(0.6 * parity),
            "dense_parity_blocks": parity,
            "self_spec_acceptance": float(np.mean(acc)),
            "mismatches": mismatches, "seconds": time.perf_counter() - t0}
    emit(info)
    if mismatches:
        fail(f"greedy tokens differ: {mismatches}")
    if min(acc) != 1.0:
        fail(f"self-speculation acceptance {acc} != 1.0")
    del self_eng, srv_d, srv_p
    tree_exact(torch, np, t_cfg, eng.target, eng.target_params, dev)
    sampled_exact(torch, np, t_cfg, eng.target_params, dev)
    del eng
    torch.cuda.empty_cache()


class CyclePolicy:
    """γ 1..4 and b 1..b_max change every round and every fifth round is
    fused (γ 0): what the captured steps must serve without a new graph."""

    def __init__(self, b_max: int = 1):
        self.i, self.b_max = 0, b_max

    def decide(self, pair_key, feats):
        from repro_torch.core.window import WindowDecision
        self.i += 1
        if self.i % 5 == 0:
            return WindowDecision(1, "fused")
        return WindowDecision(1 + self.i % 4, "distributed",
                              branches=1 + self.i % self.b_max)

    def gamma_bound(self):
        return GAMMA_MAX


def capture_pair(np, name, eng, drive, admissions, steps, ref=None) -> None:
    """Drive one configuration captured and eager (``capture=False``) on the
    same engine, seed and stream; fail unless the tokens are equal (and
    equal ``ref``, the target-only greedy decode, where given), each of the
    ``steps`` steps (round; insert when 2) warmed up and captured once per
    slot pool it ran on for the first time whatever γ, b and the
    admissions did, every other round and admission was a replay, and the
    eager run captured nothing. ``drive(capture)`` returns (tokens by
    request, rounds, sessions, recording policy)."""
    runs = {}
    for mode, capture in (("captured", None), ("eager", False)):
        g0, c0 = graph_counts(eng), step_calls(eng)
        t0 = time.perf_counter()
        tokens, rounds, sessions, pol = drive(capture)
        runs[mode] = {"tokens": tokens, "rounds": rounds,
                      "sessions": sessions,
                      "graphs": graphs_since(eng, g0),
                      "distinct_gamma": len(set(pol.gammas)),
                      "distinct_branches": len(set(pol.widths)),
                      "seconds": time.perf_counter() - t0}
        if capture is None:
            calls = {"round": rounds}
            if steps == 2:
                calls["insert"] = admissions
            want, reused = pool_graphs(eng, c0, calls)
    cap, eag = runs["captured"], runs["eager"]
    same = sorted(cap["tokens"]) == sorted(eag["tokens"]) and all(
        np.array_equal(cap["tokens"][i], eag["tokens"][i])
        for i in eag["tokens"])
    greedy = None if ref is None else all(
        np.array_equal(cap["tokens"][i], ref[i]) for i in ref)
    info = {"phase": "capture", "run": name, "requests": len(cap["tokens"]),
            "admissions": admissions, "rounds": cap["rounds"],
            "eager_rounds": eag["rounds"],
            "distinct_gamma": cap["distinct_gamma"],
            "distinct_branches": cap["distinct_branches"],
            "graphs": cap["graphs"], "expected_graphs": want,
            "steps_reused_from_earlier_sessions": reused,
            "eager_graphs": eag["graphs"],
            "captured_equals_eager": same,
            "captured_equals_target_greedy": greedy,
            "seconds": {m: r["seconds"] for m, r in runs.items()}}
    emit(info)
    if not same:
        fail(f"capture {name}: captured tokens differ from eager")
    if greedy is False:
        fail(f"capture {name}: tokens differ from the target's greedy decode")
    if cap["graphs"] != want or eag["graphs"] != want_graphs(0, 0):
        fail(f"capture {name}: graphs {cap['graphs']} (eager "
             f"{eag['graphs']}), expected {want}")


def wave_prompts(np, reqs):
    """One right-padded wave of ``reqs``: (prompts, lengths)."""
    lens = np.array([r.prompt.size for r in reqs], np.int32)
    prompts = np.zeros((len(reqs), int(lens.max())), np.int32)
    for i, r in enumerate(reqs):
        prompts[i, :r.prompt.size] = r.prompt
    return prompts, lens


def pool_count(eng) -> int:
    return sum(len(pools) for pools in eng.pools.values())


def check_reuse(np, name, eng, run, ref=None) -> None:
    """``run()`` (tokens by request) twice on one engine: the second call's
    sessions lease the slot pools the first call's gave back, so it builds
    no pool and no step, captures no graph, warms no step up and serves
    every step call by a replay; its tokens equal the first call's (and
    ``ref``, the target-only greedy decode, where given)."""
    first = run()
    g0, keys0, pools0 = graph_counts(eng), eng.step_programs(), \
        pool_count(eng)
    t0 = time.perf_counter()
    second = run()
    graphs = graphs_since(eng, g0)
    same = sorted(first) == sorted(second) and all(
        np.array_equal(first[i], second[i]) for i in first)
    greedy = None if ref is None else all(
        np.array_equal(second[i], ref[i]) for i in second)
    info = {"phase": "capture", "check": "a second session of one geometry "
            "reuses the engine's pool", "run": name,
            "second_graphs": graphs,
            "second_pools_built": pool_count(eng) - pools0,
            "second_step_keys_built": eng.step_programs() - keys0,
            "tokens_equal_first": same,
            "equals_target_greedy": greedy,
            "second_seconds": time.perf_counter() - t0}
    emit(info)
    if (graphs["captured"] or graphs["warm_ups"] or not graphs["replays"]
            or info["second_pools_built"] or info["second_step_keys_built"]
            or not same or greedy is False):
        fail(f"pool reuse {name}: {info}")


def check_live_sessions(eng, reqs) -> None:
    """Two live sessions of one geometry hold two pools: different
    buffers; closed, both pools are free for the next sessions."""
    from repro_torch.core.session import DecodeSession
    kw = dict(capacity=2, max_new_cap=8, max_prompt_len=48,
              gamma_max=GAMMA_MAX)
    a, b = DecodeSession(eng, **kw), DecodeSession(eng, **kw)
    a.admit(reqs[0].prompt, 8)
    b.admit(reqs[1].prompt, 8)
    two = (a._pool is not b._pool and a._pool.key == b._pool.key
           and a._state.target_cache.k_buf.data_ptr()
           != b._state.target_cache.k_buf.data_ptr())
    key = a._pool.key
    a.close()
    b.close()
    free = not any(p.leased for p in eng.pools[key])
    emit({"phase": "capture", "check": "two live sessions of one geometry",
          "pools": len(eng.pools[key]), "distinct_buffers": two,
          "both_free_after_close": free})
    if not (two and free):
        fail("two live sessions shared a pool, or a closed pool stayed "
             "leased")


def cold_warm_ttft(torch, np, dev) -> None:
    """The qwen3-14b ← qwen2.5-3b pair in bf16 at QWEN_CUT depth, static γ
    4, the smoke's 8 × 32 stream through the in-process server twice on
    one engine: the cold run warms up and captures its steps, the warm run
    leases the same pool and only replays. TTFT side by side."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy
    d_cfg, t_cfg = (dataclasses.replace(get_config(n), n_layers=QWEN_CUT[n])
                    for n in ("qwen2.5-3b", "qwen3-14b"))
    eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    reqs = _workload(np, t_cfg.vocab)
    rows = {}
    for run in ("cold", "warm"):
        g0 = graph_counts(eng)
        t0 = time.perf_counter()
        srv, res = _serve(eng, StaticWindowPolicy(4), reqs)
        wall = time.perf_counter() - t0
        toks = sum(len(r.tokens) for r in res.values())
        rows[run] = {
            "mean_ttft_ms": float(np.mean([r.ttft_ms for r in res.values()])),
            "max_ttft_ms": float(np.max([r.ttft_ms for r in res.values()])),
            "mean_tpot_ms": float(np.mean([r.tpot_ms for r in res.values()])),
            "tokens_per_s": toks / wall, "wall_s": wall,
            "rounds": srv._sessions[0].iterations,
            "graphs": graphs_since(eng, g0),
            "tokens": {i: r.tokens for i, r in res.items()}}
    same = all(np.array_equal(rows["cold"]["tokens"][i],
                              rows["warm"]["tokens"][i]) for i in range(8))
    for r in rows.values():
        del r["tokens"]
    emit({"phase": "capture", "check": "cold vs warm server",
          "run": "qwen dense static gamma 4, bf16, QWEN_CUT",
          "layers": [QWEN_CUT["qwen2.5-3b"], QWEN_CUT["qwen3-14b"]],
          "card": smi_line(), **rows, "tokens_equal": same})
    if rows["warm"]["graphs"]["captured"] or not same:
        fail(f"cold vs warm server: {rows}")
    del eng, srv
    torch.cuda.empty_cache()


def phase_capture(torch, kernels):
    """Float32 at the published widths and the exact phases' depths: every
    session step captured once and replayed against the same step run
    eagerly (``capture=False``), on one engine, seed and stream (8 requests
    × 32 tokens, batch 4: 8 admissions, twice the capacity). Servers on
    the qwen pair, dense and paged, with γ changing every round (fused
    rounds included): 2 graphs each (round step, insert). Tree sessions
    on a noised-draft pair, static γ 4 × b 3, AWC with max_branches=3 and
    γ × b changing every round: one graph per wave session. The split step
    on zamba2 ← mamba2 (exact_ssm depths). Greedy tokens equal eager and
    the target-only greedy decode; at temperature 1.0 captured equals
    eager on one seed (qwen and zamba2 pairs). Then the qwen dense static
    γ 4 bf16 serve at QWEN_CUT depth eager and captured back to back:
    walls, TPOT and device busy share."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy, make_window_policy
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=2,
                                dtype="float32")
    d_cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2,
                                dtype="float32")
    reqs = _workload(np, t_cfg.vocab)
    n = len(reqs)
    # the servers' slot length (pad quantum 16), which the greedy
    # reference decodes at, and dense parity of the paged pool
    P = 16 * math.ceil(max(r.prompt.size for r in reqs) / 16)
    slots = P + 32 + 2 * GAMMA_MAX + 18
    parity = 4 * math.ceil(slots / 16)

    def server(eng, policy, reqs, **kw):
        def drive(capture):
            pol = RecordingPolicy(policy(), 1)
            srv, res = _serve(eng, pol, reqs, capture=capture, **kw)
            return ({i: r.tokens for i, r in res.items()},
                    srv._sessions[0].iterations, 1, pol)
        return drive

    def waves(eng, policy, b_max):
        def drive(capture):
            pol = RecordingPolicy(policy(), b_max)
            res = run_sessions(np, eng, reqs, pol, b_max, capture=capture)
            return res["tokens"], res["rounds"], res["waves"], pol
        return drive

    def greedy(eng, reqs, slots):
        return {r.request_id: _greedy(
            torch, eng.target, eng.target_params, r.prompt, r.max_new_tokens,
            r.prompt.size + 64 if slots is None else slots, dev)[0]
            for r in reqs}

    t0 = time.perf_counter()
    eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    ref = greedy(eng, reqs, slots)
    emit({"phase": "capture", "setup_seconds": time.perf_counter() - t0})
    capture_pair(np, "qwen linear dense", eng,
                 server(eng, CyclePolicy, reqs), n, 2, ref)
    capture_pair(np, "qwen linear paged", eng,
                 server(eng, CyclePolicy, reqs, paged_kv=True,
                        kv_pool_blocks=int(0.6 * parity)), n, 2, ref)
    # pools: a second generate / server of one geometry captures nothing
    wave, lens = wave_prompts(np, reqs[:4])
    check_reuse(np, "qwen generate", eng, lambda: dict(enumerate(
        eng.generate(wave, 32, StaticWindowPolicy(4),
                     prompt_lens=lens)[0])), ref)
    check_reuse(np, "qwen server", eng, lambda: {
        i: r.tokens for i, r in _serve(eng, StaticWindowPolicy(4),
                                       reqs)[1].items()}, ref)
    check_live_sessions(eng, reqs)
    t1 = SpecDecodeEngine(d_cfg, t_cfg, draft_params=eng.draft_params,
                          target_params=eng.target_params,
                          temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                          device=dev)
    capture_pair(np, "qwen linear dense T=1", t1,
                 server(t1, lambda: StaticWindowPolicy(4), reqs), n, 2)
    # the re-seeded pool generator: generate(seed=s) twice, equal tokens
    check_reuse(np, "qwen generate T=1 seed 5", t1, lambda: dict(enumerate(
        t1.generate(wave, 32, StaticWindowPolicy(4), prompt_lens=lens,
                    seed=5)[0])))
    del t1
    tree = SpecDecodeEngine(t_cfg, t_cfg, target_params=eng.target_params,
                            draft_params=noised_copy(torch, eng.target_params,
                                                     TREE_NOISE, 7),
                            gamma_max=GAMMA_MAX, device=dev)
    ref = greedy(eng, reqs, None)            # as tree_exact decodes it
    for name, policy in (
            ("static 4x3", lambda: StaticWindowPolicy(4, branches=B_MAX)),
            ("awc", lambda: make_window_policy("awc", max_branches=B_MAX)),
            ("cycle", lambda: CyclePolicy(B_MAX))):
        capture_pair(np, f"qwen tree {name}", tree,
                     waves(tree, policy, B_MAX), 0, 1, ref)
    check_reuse(np, "qwen tree wave", tree, lambda: run_sessions(
        np, tree, reqs[:4], StaticWindowPolicy(4, branches=B_MAX),
        B_MAX)["tokens"], ref)
    del tree, eng
    torch.cuda.empty_cache()

    st_cfg, sd_cfg = ssm_pair_cfgs(full=False)
    sreqs = _workload(np, st_cfg.vocab)
    ssm = SpecDecodeEngine(sd_cfg, st_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    P = 16 * math.ceil(max(r.prompt.size for r in sreqs) / 16)
    ref = greedy(ssm, sreqs, P + 32 + 2 * GAMMA_MAX + 18)
    capture_pair(np, "zamba2 <- mamba2 split", ssm,
                 server(ssm, CyclePolicy, sreqs), n, 2, ref)
    t1 = SpecDecodeEngine(sd_cfg, st_cfg, draft_params=ssm.draft_params,
                          target_params=ssm.target_params,
                          temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                          device=dev)
    capture_pair(np, "zamba2 <- mamba2 split T=1", t1,
                 server(t1, lambda: StaticWindowPolicy(4), sreqs), n, 2)
    del ssm, t1
    torch.cuda.empty_cache()
    cold_warm_ttft(torch, np, dev)
    eager_against_captured(torch, kernels)


def eager_against_captured(torch, kernels) -> None:
    """The qwen3-14b ← qwen2.5-3b dense static γ 4 serve (bf16, PROFILE_CUT
    depth, the smoke's 8 requests at 16 new tokens each, half its 32, so
    that the two profiled runs stay short) through the launcher, eager
    (``--no-capture``) then captured, back to back; then each again under
    torch.profiler for its device time. Busy share = profiled device ms ÷
    the unprofiled wall (same rounds, same kernels). Launch counts must
    agree between the two."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    argv = ["--target", "qwen3-14b", "--draft", "qwen2.5-3b", "--full-size",
            "--max-batch", "4", "--requests", "8", "--max-new", "16",
            "--gamma-max", str(GAMMA_MAX), "--seed", "0", "--json",
            "--policy", "static", "--gamma", "4"]
    modes = (("eager", ["--no-capture"]), ("captured", []))
    res = {}
    for mode, extra in modes:
        kernels.reset_launches()
        t0 = time.perf_counter()
        with depth_cut(PROFILE_CUT):
            out = serve.run(argv + extra)
        s = out.summary
        res[mode] = {k: s[k] for k in (
            "wall_s", "tokens_per_s", "mean_ttft_ms", "mean_tpot_ms",
            "iterations", "requests")}
        res[mode].update(graphs=summary_graphs(s),
                         seconds=time.perf_counter() - t0,
                         launches=dict(kernels.LAUNCHES),
                         tokens={r.request_id: r.tokens for r in out.results})
        del out
        torch.cuda.empty_cache()
    for mode, extra in modes:
        t0 = time.perf_counter()
        with depth_cut(PROFILE_CUT), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            out = serve.run(argv + extra)
            torch.cuda.synchronize()
        line = profile_summary(prof, f"dense_static {mode}",
                               out.summary["iterations"],
                               out.summary["requests"],
                               out.summary["wall_s"])
        r = res[mode]
        r["profiled_seconds"] = time.perf_counter() - t0
        r["device_ms_profiled"] = line["device_ms"]
        r["device_busy_share"] = line["device_ms"] / 1e3 / r["wall_s"]
        r["device_busy_share_profiled"] = line["device_busy_share_profiled"]
        r["top_kernels"] = line["top_kernels"][:5]
        del out, prof
        torch.cuda.empty_cache()
    eag, cap = res["eager"], res["captured"]
    same = all(np.array_equal(eag["tokens"][i], cap["tokens"][i])
               for i in eag["tokens"])
    launches_equal = eag["launches"] == cap["launches"]
    for r in res.values():
        del r["tokens"]
    emit({"phase": "capture", "check": "eager vs captured",
          "run": "qwen dense static gamma 4, bf16, PROFILE_CUT",
          "layers": [PROFILE_CUT["qwen2.5-3b"], PROFILE_CUT["qwen3-14b"]],
          "card": smi_line(), "eager": eag, "captured": cap,
          "wall_speedup": eag["wall_s"] / cap["wall_s"],
          "tpot_speedup": eag["mean_tpot_ms"] / cap["mean_tpot_ms"],
          "tokens_equal": same, "launches_equal": launches_equal})
    if not launches_equal or eag["iterations"] != cap["iterations"]:
        fail("eager vs captured: launches or rounds differ "
             f"({eag['launches']} vs {cap['launches']})")
    if cap["graphs"] != want_graphs(2, cap["iterations"] + cap["requests"]):
        fail(f"eager vs captured: graphs {cap['graphs']}")


# ------------------------------------------------ distributed split (A9)

# the kernels the distributed phase must launch: B1 in every draft step and
# verify, B2 in the paged transport servers, B4 in the tree session, B3 in
# the sampled rounds, B5 in the zamba2 verify and prefill
DIST_KERNELS = ("decode_attn", "paged_decode_attn", "tree_verify",
                "gather_reduce", "cdf_sample", "ssd_scan")
LINK15 = ["--link-rtt-ms", "15", "--link-jitter-ms", "1",
          "--link-bw-gbps", "1"]


def want_step_graphs(calls: dict) -> dict:
    """Graphs of one session's captured steps called ``calls[name]`` times
    each: a step's first call warms up, its second captures and replays,
    every later call replays (a step called once never captures)."""
    return {"captured": sum(1 for n in calls.values() if n >= 2),
            "replays": sum(max(0, n - 1) for n in calls.values()),
            "warm_ups": sum(1 for n in calls.values() if n >= 1)}


def split_calls(rounds: int, fused: int, admissions: int,
                recurrent_draft: bool) -> dict:
    """Calls of each captured step of a transport server session: one
    insert per admission, a propose per distributed round, a verify per
    round (γ 0 in a fused round), an ingest per fused round, and for a
    recurrent draft an advance per distributed round."""
    calls = {"insert": admissions, "propose": rounds - fused,
             "verify": rounds, "ingest": fused}
    if recurrent_draft:
        calls["advance"] = rounds - fused
    return calls


def _add(totals: dict, launches: dict) -> None:
    for k, n in launches.items():
        totals[k] = totals.get(k, 0) + n


def distributed_exact(torch, kernels) -> dict:
    """Float32 at the published widths and the exact phases' depths: the
    half-duplex transport rounds commit the colocated session's tokens and
    the target-only greedy decode. qwen3-14b ← qwen2.5-3b (8 requests × 32
    tokens through 4-slot servers) over the in-process transport, a 20 ms
    emulated link on the virtual clock and a TCP loopback socket, each
    under mode ``distributed`` (static γ 4), ``fused`` and ``auto`` with
    γ and fused changing every round, dense and paged (pool at 60 % of
    parity): tokens == the colocated server's == target greedy, messages
    == 2·distributed rounds + 2·control round trips, graphs per step as
    called. A tree session (noised draft, γ_max 8, b_max 3, static 4 × 3)
    over the in-process transport == the colocated tree session == target
    greedy, acceptance strictly between 0 and 1. zamba2 ← mamba2 (the
    recurrent draft re-advanced by the received verdict) == colocated ==
    target greedy. At T = 1.0 on one seed, mode distributed: in-process
    wave sessions == colocated ones. Returns the launch counts."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy
    from repro_torch.distributed import (EmulatedLinkTransport,
                                         InProcessTransport, SocketTransport)
    from repro_torch.sim.network import LinkSpec
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    t_cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=2,
                                dtype="float32")
    d_cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2,
                                dtype="float32")
    totals = {k: 0 for k in kernels.LAUNCHES}
    eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    reqs = _workload(np, t_cfg.vocab)
    P = 16 * math.ceil(max(r.prompt.size for r in reqs) / 16)
    slots = P + 32 + 2 * GAMMA_MAX + 18
    parity = 4 * math.ceil(slots / 16)
    ref = {r.request_id: _greedy(torch, eng.target, eng.target_params,
                                 r.prompt, r.max_new_tokens, slots, dev)[0]
           for r in reqs}
    layouts = {"dense": {},
               "paged": dict(paged_kv=True, kv_pool_blocks=int(0.6 * parity))}
    colo = {}
    for lay, kw in layouts.items():
        _, res = _serve(eng, StaticWindowPolicy(4), reqs, **kw)
        colo[lay] = {i: r.tokens for i, r in res.items()}
    transports = {
        "in-process": InProcessTransport,
        "emulated 20/1/1 virtual": lambda: EmulatedLinkTransport(
            LinkSpec(20.0, 1.0, 1.0), seed=0, sleep=False),
        "socket loopback": lambda: SocketTransport.loopback(timeout_s=60.0)}
    modes = {"distributed": lambda: StaticWindowPolicy(4),
             "fused": lambda: StaticWindowPolicy(4),
             "auto": CyclePolicy}
    rows, bad = [], []
    for lay, kw in layouts.items():
        for tname, make_tr in transports.items():
            for mode, make_pol in modes.items():
                tr = make_tr()
                g0, c0 = graph_counts(eng), step_calls(eng)
                kernels.reset_launches()
                try:
                    srv, res = _serve(eng, make_pol(), reqs, transport=tr,
                                      mode_policy=mode, **kw)
                finally:
                    if isinstance(tr, SocketTransport):
                        tr.close()
                _add(totals, kernels.LAUNCHES)
                sess = srv._sessions[0]
                rounds, fused = sess.iterations, sess.fused_iterations
                got = {i: r.tokens for i, r in res.items()}
                same = sorted(got) == sorted(ref) and all(
                    np.array_equal(got[i], ref[i])
                    and np.array_equal(got[i], colo[lay][i]) for i in ref)
                graphs = graphs_since(eng, g0)
                want, _ = pool_graphs(eng, c0, split_calls(
                    rounds, fused, len(reqs), False))
                msgs = 2 * (rounds - fused) + 2 * sess.control_roundtrips
                row = {"layout": lay, "transport": tname, "mode": mode,
                       "rounds": rounds, "fused": fused,
                       "messages": tr.messages_sent,
                       "control_roundtrips": sess.control_roundtrips,
                       "graphs": graphs, "equal": same}
                rows.append(row)
                if not same:
                    bad.append(row)
                if graphs != want or tr.messages_sent != msgs:
                    fail(f"distributed {lay}/{tname}/{mode}: graphs {graphs} "
                         f"(expected {want}), messages {tr.messages_sent} "
                         f"(expected {msgs})")
    emit({"phase": "distributed", "check": "transports == colocated == "
          "target greedy", "dtype": "float32", "target": t_cfg.name,
          "draft": d_cfg.name, "layers": 2, "requests": len(reqs),
          "runs": rows, "mismatches": bad,
          "seconds": time.perf_counter() - t0})
    if bad:
        fail(f"distributed tokens differ: {bad}")

    # tree: noised draft, grid over the in-process transport
    t1 = time.perf_counter()
    tree = SpecDecodeEngine(t_cfg, t_cfg, target_params=eng.target_params,
                            draft_params=noised_copy(torch, eng.target_params,
                                                     TREE_NOISE, 7),
                            gamma_max=GAMMA_MAX, device=dev)
    tref = {r.request_id: _greedy(torch, eng.target, eng.target_params,
                                  r.prompt, r.max_new_tokens,
                                  r.prompt.size + 64, dev)[0] for r in reqs}
    pol = lambda: StaticWindowPolicy(4, branches=B_MAX)
    col = run_sessions(np, tree, reqs, pol(), B_MAX)
    tr = InProcessTransport()
    g0, c0 = graph_counts(tree), step_calls(tree)
    kernels.reset_launches()
    dist = run_sessions(np, tree, reqs, pol(), B_MAX, transport=tr)
    _add(totals, kernels.LAUNCHES)
    graphs = graphs_since(tree, g0)
    n = dist["rounds"]
    want, _ = pool_graphs(tree, c0, {"propose_tree": n, "verify_tree": n,
                                     "ingest_tree": n})
    same = all(np.array_equal(dist["tokens"][i], tref[i])
               and np.array_equal(col["tokens"][i], tref[i]) for i in tref)
    emit({"phase": "distributed", "check": "tree over in-process == "
          "colocated tree == target greedy", "dtype": "float32",
          "gamma": 4, "branches": B_MAX,
          "acceptance": {"transport": dist["acceptance"],
                         "colocated": col["acceptance"]},
          "rounds": {"transport": dist["rounds"],
                     "colocated": col["rounds"]},
          "messages": tr.messages_sent, "graphs": graphs,
          "expected_graphs": want, "equal": same,
          "seconds": time.perf_counter() - t1})
    if not same:
        fail("distributed tree tokens differ")
    if not 0.0 < dist["acceptance"] < 1.0:
        fail(f"distributed tree acceptance {dist['acceptance']} is not "
             "strictly between 0 and 1")
    if graphs != want or tr.messages_sent != 2 * dist["rounds"]:
        fail(f"distributed tree: graphs {graphs} (expected {want}), "
             f"messages {tr.messages_sent}")
    del tree

    # T = 1.0, one seed, mode distributed: wave sessions (one generator each)
    t1 = time.perf_counter()
    samp = SpecDecodeEngine(d_cfg, t_cfg, draft_params=eng.draft_params,
                            target_params=eng.target_params,
                            temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                            device=dev)
    kernels.reset_launches()
    runs = {"colocated": run_sessions(np, samp, reqs, StaticWindowPolicy(4),
                                      0, seed=3),
            "transport": run_sessions(np, samp, reqs, StaticWindowPolicy(4),
                                      0, seed=3,
                                      transport=InProcessTransport())}
    _add(totals, kernels.LAUNCHES)

    def equal(a, b):
        return all(np.array_equal(a["tokens"][i], b["tokens"][i])
                   and a["bits"][i] == b["bits"][i] for i in a["tokens"])
    same = equal(runs["colocated"], runs["transport"])
    info = {"phase": "distributed", "check": "T=1 in-process == colocated "
            "on one seed", "temperature": SAMPLED_T,
            "captured_transport_equals_captured_colocated": same,
            "acceptance": runs["transport"]["acceptance"]}
    if not same:
        # the draws' order is the colocated step's; what may differ on the
        # card is how two graphs' registered Philox offsets advance. Then
        # the check is: eager transport == eager colocated (the order) and
        # captured transport == eager transport (the capture)
        for name in ("colocated", "transport"):
            runs[f"{name}_eager"] = run_sessions(
                np, samp, reqs, StaticWindowPolicy(4), 0, seed=3,
                capture=False, transport=(InProcessTransport()
                                          if name == "transport" else None))
        info.update(
            eager_transport_equals_eager_colocated=equal(
                runs["colocated_eager"], runs["transport_eager"]),
            captured_transport_equals_eager_transport=equal(
                runs["transport"], runs["transport_eager"]))
    info["seconds"] = time.perf_counter() - t1
    emit(info)
    if not same and not (info["eager_transport_equals_eager_colocated"]
                         and info["captured_transport_equals_eager_"
                                  "transport"]):
        fail(f"T=1 distributed: {info}")
    del samp, eng
    torch.cuda.empty_cache()

    # zamba2 <- mamba2: the recurrent draft re-advanced by the verdict
    t1 = time.perf_counter()
    st_cfg, sd_cfg = ssm_pair_cfgs(full=False)
    ssm = SpecDecodeEngine(sd_cfg, st_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    sreqs = _workload(np, st_cfg.vocab)
    P = 16 * math.ceil(max(r.prompt.size for r in sreqs) / 16)
    sref = {r.request_id: _greedy(torch, ssm.target, ssm.target_params,
                                  r.prompt, r.max_new_tokens,
                                  P + 32 + 2 * GAMMA_MAX + 18, dev)[0]
            for r in sreqs}
    _, col = _serve(ssm, StaticWindowPolicy(4), sreqs)
    tr = InProcessTransport()
    g0, c0 = graph_counts(ssm), step_calls(ssm)
    kernels.reset_launches()
    srv, dist = _serve(ssm, StaticWindowPolicy(4), sreqs, transport=tr,
                       mode_policy="distributed")
    _add(totals, kernels.LAUNCHES)
    sess = srv._sessions[0]
    graphs = graphs_since(ssm, g0)
    want, _ = pool_graphs(ssm, c0, split_calls(sess.iterations, 0,
                                               len(sreqs), True))
    same = all(np.array_equal(dist[i].tokens, sref[i])
               and np.array_equal(col[i].tokens, sref[i]) for i in sref)
    emit({"phase": "distributed", "check": "zamba2 <- mamba2 over "
          "in-process == colocated == target greedy", "dtype": "float32",
          "target": f"{st_cfg.name} ({st_cfg.n_layers} layers)",
          "draft": f"{sd_cfg.name} ({sd_cfg.n_layers} layers)",
          "rounds": sess.iterations, "messages": tr.messages_sent,
          "graphs": graphs, "expected_graphs": want, "equal": same,
          "seconds": time.perf_counter() - t1})
    if not same:
        fail("distributed zamba2 <- mamba2 tokens differ")
    if graphs != want or tr.messages_sent != 2 * sess.iterations:
        fail(f"distributed zamba2: graphs {graphs} (expected {want})")
    del ssm, srv
    torch.cuda.empty_cache()
    return totals


def distributed_serve(torch, kernels) -> dict:
    """bf16 through ``repro_torch.launch.serve`` (8 requests × 32 tokens,
    batch 4, γ_max 8): qwen3-14b ← qwen2.5-3b at the published depth,
    static γ 4, colocated (the yardstick, in this call), over the
    in-process transport (``--link-rtt-ms 0``) and over a 15 ms emulated
    link (jitter 1 ms, 1 Gbps); at QWEN_CUT, AWC over the 15 ms link and
    T = 1.0 over ``--link-rtt-ms 0``; zamba2 ← mamba2 at the published
    depth over the 15 ms link. Each: complete in-range outputs, exact
    launch counts (B1 = distributed rounds·(γ_max·L_d + L_t) + fused
    rounds·(L_d + L_t) + admissions·(L_d + L_t); zamba2 B5 = rounds·L_t +
    admissions·(L_t + L_d), B1 = rounds·n_seg·(γ_max + 2) +
    admissions·n_seg; B3a = B3b = verify calls at T > 0), messages =
    2·distributed rounds + 2·control round trips, the measured RTT within
    ±1 ms of the link model's, the measured wait ≥ 0.95 × the sampled
    delays, graphs per step as called. Then a short profiled serve
    colocated and over the in-process transport (busy share). Returns the
    launch counts."""
    from repro_torch.launch import serve
    from repro_torch.sim.network import (LinkSpec, expected_rtt_ms,
                                         verdict_payload_bytes,
                                         window_payload_bytes)
    qwen = ["--target", "qwen3-14b", "--draft", "qwen2.5-3b", "--full-size",
            "--max-batch", "4", "--requests", "8", "--max-new", "32",
            "--gamma-max", str(GAMMA_MAX), "--seed", "0", "--json"]
    zamba = list(qwen)
    zamba[1], zamba[3] = "zamba2-1.2b", "mamba2-130m"
    static = ["--policy", "static", "--gamma", "4"]
    link0 = ["--link-rtt-ms", "0"]
    t1 = ["--temperature", str(SAMPLED_T)]
    runs = [("qwen colocated static", qwen + static, False),
            ("qwen link0 static", qwen + static + link0, False),
            ("qwen link15 static", qwen + static + LINK15, False),
            ("qwen link15 awc", qwen + ["--policy", "awc"] + LINK15, True),
            ("qwen link0 static T=1", qwen + static + link0 + t1, True),
            ("zamba2 link15 static", zamba + static + LINK15, False)]
    spec15 = LinkSpec(15.0, 1.0, 1.0)
    totals = {k: 0 for k in kernels.LAUNCHES}
    card = smi_line()
    for name, argv, cut in runs:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with depth_cut(QWEN_CUT if cut else {}):
            out = serve.run(argv)
        launches = dict(kernels.LAUNCHES)
        s = out.summary
        eng, sess = out.server.engine, out.server._sessions[0]
        tr = out.server.pairs[0].transport
        L_d, L_t = eng.draft_cfg.n_layers, eng.target_cfg.n_layers
        R, F, A = sess.iterations, sess.fused_iterations, s["requests"]
        D = R - F
        sampled = "--temperature" in argv
        want = {k: 0 for k in kernels.LAUNCHES}
        b3 = R if sampled else 0
        if eng.target_cfg.arch_type == "hybrid":
            n_seg = L_t // eng.target_cfg.attn_every
            want.update(ssd_scan=R * L_t + A * (L_t + L_d),
                        decode_attn=R * n_seg * (GAMMA_MAX + 2) + A * n_seg)
        elif tr is None:
            want.update(decode_attn=R * (GAMMA_MAX * L_d + L_t)
                        + A * (L_d + L_t))
        else:
            want.update(decode_attn=D * (GAMMA_MAX * L_d + L_t)
                        + (F + A) * (L_d + L_t))
        want.update(gather_reduce=b3, cdf_sample=b3)
        V = eng.target_cfg.vocab
        full = all(len(r.tokens) == 32 and (r.tokens >= 0).all()
                   and (r.tokens < V).all() for r in out.results)
        graphs = summary_graphs(s)
        if tr is None:
            graphs_want = want_graphs(2, R + A)
        else:
            graphs_want = want_step_graphs(split_calls(
                R, F, A, not eng._draft_attention))
        info = {"phase": "distributed", "run": name, "card": card,
                "layers": [L_d, L_t], "requests": A,
                "tokens": s["tokens"], "wall_s": s["wall_s"],
                "tokens_per_s": s["tokens_per_s"],
                "mean_tpot_ms": s["mean_tpot_ms"],
                "mean_ttft_ms": s["mean_ttft_ms"],
                "mean_acceptance": s["mean_acceptance"],
                "rounds": R, "fused_rounds": F,
                "fused_fraction": s["pairs"]["pair0"]["fused_fraction"],
                "decode_ms_per_round": sess.decode_wall_s * 1e3 / max(1, R),
                "link_ms": sess.link_ms, "graphs": graphs,
                "expected_graphs": graphs_want, "launches": launches,
                "expected_launches": want, "all_full_in_range": full,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 2**30,
                "seconds": time.perf_counter() - t0}
        problems = []
        if tr is not None:
            msgs = 2 * D + 2 * sess.control_roundtrips
            delays = tr.delay_log["window"] + tr.delay_log["verdict"]
            sampled_ms = sum(delays)
            spec = getattr(tr, "spec", None)
            rtt_want = 0.0 if spec is None else expected_rtt_ms(
                spec, 4 * window_payload_bytes(4),
                4 * verdict_payload_bytes(4))
            info.update(transport=s["transport"],
                        link_messages=s["link_messages"],
                        expected_messages=msgs,
                        control_roundtrips=sess.control_roundtrips,
                        link_bytes_sent=s["link_bytes_sent"],
                        link_recent_rtt_ms=s["link_recent_rtt_ms"],
                        expected_rtt_ms=rtt_want,
                        sampled_delay_ms=sampled_ms,
                        link_wait_over_sampled=(sess.link_ms / sampled_ms
                                                if sampled_ms else None))
            if s["link_messages"] != msgs:
                problems.append("messages")
            if abs(tr.recent_rtt_ms - rtt_want) > 1.0:
                problems.append("rtt")
            if len(delays) != tr.messages_sent or (
                    sess.link_ms < 0.95 * sampled_ms):
                problems.append("link wait")
            if spec is not None and spec.rtt_ms != spec15.rtt_ms:
                problems.append("link spec")
        emit(info)
        if A != 8 or not full:
            problems.append("incomplete or out-of-range outputs")
        if launches != want:
            problems.append(f"launches {launches}, expected {want}")
        if graphs != graphs_want:
            problems.append(f"graphs {graphs}, expected {graphs_want}")
        if problems:
            fail(f"distributed {name}: {problems}")
        if tr is not None:
            _add(totals, launches)
        del out, eng, sess, tr
        torch.cuda.empty_cache()
    # where a round's time goes, colocated against in-process: 4 requests
    # × 8 tokens at QWEN_CUT, profiled
    from torch.profiler import ProfilerActivity, profile
    short = list(qwen)
    short[short.index("--requests") + 1] = "4"
    short[short.index("--max-new") + 1] = "8"
    for name, extra in (("colocated", []), ("link0", link0)):
        with depth_cut(QWEN_CUT), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            out = serve.run(short + static + extra)
            torch.cuda.synchronize()
        s = out.summary
        line = profile_summary(prof, f"distributed qwen {name} static 4x8, "
                               "QWEN_CUT", s["iterations"], s["requests"],
                               s["wall_s"])
        line["top_kernels"] = line["top_kernels"][:6]
        emit(line)
        del out, prof
        torch.cuda.empty_cache()
    return totals


def phase_distributed(torch, kernels) -> dict:
    totals = distributed_exact(torch, kernels)
    _add(totals, distributed_serve(torch, kernels))
    return totals


def _agreement(torch, out, dev) -> dict:
    """Share of served tokens equal to a target-only greedy decode, and for
    each request that diverges, where and by what top-2 logit gap of the
    target-only decode at that step (a gap within bf16 rounding of the
    logits is a near-tie, not a port fault)."""
    eng = out.server.engine
    slots = out.server._sessions[0].slots_len
    byid = {r.request_id: r for r in out.results}
    same, first = 0, []
    for rq in out.requests:
        ref, gaps = _greedy(torch, eng.target, eng.target_params, rq.prompt,
                            rq.max_new_tokens, slots, dev)
        got = byid[rq.request_id].tokens
        same += int((ref == got).sum())
        if (ref != got).any():
            i = int((ref != got).argmax())
            first.append({"request": rq.request_id, "first_diff": i,
                          "top2_gap": float(gaps[i - 1]) if i else None})
    return {"share": same / sum(rq.max_new_tokens for rq in out.requests),
            "divergences": first}


def phase_serve(torch, kernels):
    import numpy as np
    from repro_torch.core.session import no_host_sync
    from repro_torch.launch import serve
    dev = torch.device("cuda", 0)
    # the guard the session wraps each chunk's rounds in is live
    raised = False
    try:
        with no_host_sync(dev):
            torch.ones(1, device=dev).item()
    except RuntimeError:
        raised = True
    if not raised:
        fail("set_sync_debug_mode('error') did not raise on a host sync")
    base = ["--target", "qwen3-14b", "--draft", "qwen2.5-3b", "--full-size",
            "--max-batch", "4", "--requests", "8", "--max-new", "32",
            "--gamma-max", str(GAMMA_MAX), "--seed", "0", "--json"]
    t1 = ["--temperature", str(SAMPLED_T)]
    # (name, launcher flags, depth cut to QWEN_CUT)
    runs = [("dense_static", ["--policy", "static", "--gamma", "4"], False),
            ("dense_awc", ["--policy", "awc"], True),
            ("paged_static", ["--policy", "static", "--gamma", "4",
                              "--paged-kv"], False),
            ("dense_static_t1", ["--policy", "static", "--gamma", "4"] + t1,
             False),
            ("paged_static_t1", ["--policy", "static", "--gamma", "4",
                                 "--paged-kv"] + t1, True)]
    greedy_tokens = {}
    # the launcher's request stream (seed 0): its padded prompt bound P
    # fixes the slot length P + max_new + 2γ_max + 18 and so dense parity
    P = 16 * math.ceil(max(len(r.prompt) for r in _workload(np, 151936))
                       / 16)
    parity = 4 * math.ceil((P + 32 + 2 * GAMMA_MAX + 18) / 16)
    totals = {k: 0 for k in kernels.LAUNCHES}
    for name, extra, cut in runs:
        argv = base + extra
        if "--paged-kv" in extra:
            argv += ["--kv-pool-blocks", str(int(0.6 * parity))]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with depth_cut(QWEN_CUT if cut else {}):
            out = serve.run(argv)
        launches = dict(kernels.LAUNCHES)
        s = out.summary
        eng = out.server.engine
        L_d, L_t = eng.draft_cfg.n_layers, eng.target_cfg.n_layers
        expect = s["iterations"] * (GAMMA_MAX * L_d + L_t) \
            + s["requests"] * (L_d + L_t)
        # rounds run the paged kernel on a paged session; admission always
        # prefills into a dense batch-1 row first (as the reference does)
        per_round = s["iterations"] * (GAMMA_MAX * L_d + L_t)
        per_admit = s["requests"] * (L_d + L_t)
        if "--paged-kv" in extra:
            want = {"decode_attn": per_admit, "paged_decode_attn": per_round}
        else:
            want = {"decode_attn": expect, "paged_decode_attn": 0}
        sampled = "--temperature" in extra
        b3 = s["iterations"] if sampled else 0
        want.update(tree_argmax=0, tree_accept=0, tree_verify=0,
                    gather_reduce=b3, cdf_sample=b3, ssd_scan=0,
                    ssd_scan_bwd=0)
        V = eng.target_cfg.vocab
        full = all(len(r.tokens) == 32 and (r.tokens >= 0).all()
                   and (r.tokens < V).all() for r in out.results)
        keys = eng.step_programs()
        want_keys = 3 if "--paged-kv" in extra else 2
        # one round step and one insert, captured once each: every other
        # round and admission is a replay
        graphs = summary_graphs(s)
        graphs_want = want_graphs(2, s["iterations"] + s["requests"])
        # information only: bf16 agreement with a target-only greedy decode;
        # a sampled run's share of tokens equal to its greedy twin's
        agree = _agreement(torch, out, dev) if name == "dense_static" \
            else None
        twin = name.replace("_t1", "")
        byid = {r.request_id: r.tokens for r in out.results}
        if sampled:
            agree = {"share_equal_to_greedy_twin": float(np.mean(
                [(byid[i] == greedy_tokens[twin][i]).mean()
                 for i in byid]))}
        else:
            greedy_tokens[name] = byid
        info = {"phase": "serve", "run": name, "layers": [L_d, L_t],
                "requests": s["requests"],
                "tokens": s["tokens"], "wall_s": s["wall_s"],
                "tokens_per_s": s["tokens_per_s"],
                "mean_ttft_ms": s["mean_ttft_ms"],
                "mean_tpot_ms": s["mean_tpot_ms"],
                "mean_acceptance": s["mean_acceptance"],
                "temperature": s["temperature"],
                "fused_fraction": s["pairs"]["pair0"]["fused_fraction"],
                "rounds": s["iterations"], "step_keys": keys,
                "graphs": graphs, "expected_graphs": graphs_want,
                "launches": launches, "expected_launches": want,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 2**30,
                "all_full_in_range": full, "pairs": s["pairs"],
                "bf16_agreement": agree,
                "sync_debug_mode_in_rounds": "error"}
        emit(info)
        if s["requests"] != 8 or not full:
            fail(f"{name}: incomplete or out-of-range outputs")
        if launches != want:
            fail(f"{name}: kernel launches {launches}, expected {want}")
        if keys != want_keys:
            fail(f"{name}: {keys} step keys, expected {want_keys}")
        if graphs != graphs_want:
            fail(f"{name}: graphs {graphs}, expected {graphs_want}")
        for k in totals:
            totals[k] += launches[k]
        del out, eng
        torch.cuda.empty_cache()
    for k, n in serve_tree(torch, np, kernels, dev).items():
        totals[k] += n
    profile_round(torch, serve, base, t1, "dense_static_t1 4x8")
    return totals


class depth_cut:
    """Within the block a deployment (the launcher's, or one built with
    ``repro_torch.topology.build_deployment``) builds the named configs at
    the given depths (``{name: n_layers}``) and every other setting as
    published."""

    def __init__(self, layers: dict):
        import repro_torch.topology as topo
        self.mod, self.layers = topo, layers
        self.real = topo.get_config

    def __enter__(self):
        real, layers = self.real, self.layers
        self.mod.get_config = lambda name: (
            dataclasses.replace(real(name), n_layers=layers[name])
            if name in layers else real(name))
        return self

    def __exit__(self, *exc):
        self.mod.get_config = self.real


def serve_tree(torch, np, kernels, dev) -> dict:
    """The qwen3-14b ← qwen2.5-3b pair in bf16 at the published widths and
    QWEN_CUT depth through tree sessions (γ_max 8, b_max 3), 8 requests ×
    32 tokens in waves of 4:
    static γ 4 × b 3, then AWC choosing {γ, b} (max_branches=3). Returns
    the launch counts of both runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy, make_window_policy
    d_cfg, t_cfg = (dataclasses.replace(get_config(n), n_layers=QWEN_CUT[n])
                    for n in ("qwen2.5-3b", "qwen3-14b"))
    vocab = t_cfg.vocab                       # the pair shares it
    eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, rtt_ms=10.0,
                           gamma_max=GAMMA_MAX, sync_every=8, device=dev)
    L_d, L_t = d_cfg.n_layers, t_cfg.n_layers
    reqs = _workload(np, vocab)
    totals = {k: 0 for k in kernels.LAUNCHES}
    # a linear wave run before the tree runs is the same-harness yardstick
    # of their wall per round (it also pays the engine's warm-up; its
    # launches are not the tree path's)
    runs = [("linear_static_waves", StaticWindowPolicy(4), 0, 1),
            ("tree_static", StaticWindowPolicy(4, branches=B_MAX), B_MAX, 2),
            ("tree_awc", make_window_policy("awc", max_branches=B_MAX),
             B_MAX, 2)]
    for name, inner, b_max, want_keys in runs:
        policy = RecordingPolicy(inner, max(1, b_max))
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        g0, c0 = graph_counts(eng), step_calls(eng)
        res = run_sessions(np, eng, reqs, policy, b_max)
        launches = dict(kernels.LAUNCHES)
        rounds, waves = res["rounds"], res["waves"]
        # each wave's session replays its pool's round step (the wave
        # prefill stays eager), captured by the pool's first session
        graphs = graphs_since(eng, g0)
        graphs_want, _ = pool_graphs(eng, c0, {"round": rounds})
        tree_n = rounds if b_max else 0
        want = {"decode_attn": rounds * (GAMMA_MAX * L_d + L_t)
                + waves * (L_d + L_t), "paged_decode_attn": 0,
                "tree_argmax": 0, "tree_accept": 0, "tree_verify": tree_n,
                "gather_reduce": 0, "cdf_sample": 0, "ssd_scan": 0,
                "ssd_scan_bwd": 0}
        full = all(t.size == 32 and (t >= 0).all() and (t < vocab).all()
                   for t in res["tokens"].values())
        keys = eng.step_programs()
        info = {"phase": "serve", "run": name, "requests": len(reqs),
                "tokens": res["tokens_total"], "wall_s": res["wall_s"],
                "tokens_per_s": res["tokens_total"] / res["wall_s"],
                "mean_tpot_ms": float(np.mean(res["tpot_ms"])),
                "rounds": rounds, "waves": waves,
                "decode_ms_per_round": res["decode_wall_s"] * 1e3
                / max(1, rounds),
                "fused_fraction": res["fused"] / max(1, rounds),
                "mean_branch_width": float(np.mean(policy.widths)),
                "acceptance": res["acceptance"], "step_keys": keys,
                "graphs": graphs, "expected_graphs": graphs_want,
                "launches": launches, "expected_launches": want,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 2**30,
                "all_full_in_range": full,
                "sync_debug_mode_in_rounds": "error"}
        emit(info)
        if len(res["tokens"]) != len(reqs) or not full:
            fail(f"{name}: incomplete or out-of-range outputs")
        if launches != want:
            fail(f"{name}: kernel launches {launches}, expected {want}")
        if keys != want_keys:
            fail(f"{name}: {keys} step keys, expected {want_keys} (the "
                 "linear step, then the tree step)")
        if graphs != graphs_want:
            fail(f"{name}: graphs {graphs}, expected {graphs_want}")
        if b_max:
            for k in totals:
                totals[k] += launches[k]
    profile_tree(torch, np, eng, vocab)
    del eng
    torch.cuda.empty_cache()
    return totals


def profile_tree(torch, np, eng, vocab) -> None:
    """Device kernel time of tree rounds (torch.profiler) over one wave of
    4 requests × 8 tokens at static γ 4 × b 3, beside its wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.window import StaticWindowPolicy
    reqs = _workload(np, vocab, n=4, max_new=8)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = run_sessions(np, eng, reqs, StaticWindowPolicy(4,
                                                             branches=B_MAX),
                           B_MAX)
        torch.cuda.synchronize()
    emit(profile_summary(prof, "tree_static 4x8", res["rounds"],
                         len(reqs), res["wall_s"]))


def profile_round(torch, serve, base, extra, run) -> None:
    """Where a round's time goes: device kernel time from torch.profiler
    over a short dense serve (4 requests × 8 tokens; ``extra`` launcher
    flags: the sampled round runs every kernel the greedy one does, plus
    B3), beside its wall time. The profiler's own host overhead
    inflates that wall; the unprofiled runs above give the honest wall per
    round."""
    from torch.profiler import ProfilerActivity, profile
    argv = [a for a in base]
    argv[argv.index("--requests") + 1] = "4"
    argv[argv.index("--max-new") + 1] = "8"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = serve.run(argv + ["--policy", "static", "--gamma", "4"]
                        + extra)
        torch.cuda.synchronize()
    s = out.summary
    emit(profile_summary(prof, run, s["iterations"], s["requests"],
                         s["wall_s"]))
    del out
    torch.cuda.empty_cache()


def profile_summary(prof, run: str, rounds: int, requests: int,
                    wall_s: float) -> dict:
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    # B1/B2: the attention kernel and its combine pass
    attn = [r for r in rows if "attend_kernel" in r[2]
            or "combine_kernel" in r[2]]
    attn_ms = sum(r[0] for r in attn)
    return {"phase": "profile", "run": run, "rounds": rounds,
            "requests": requests, "wall_s_profiled": wall_s,
            "device_ms": device_ms,
            "decode_attention_device_ms": attn_ms,
            "decode_attention_calls": sum(r[1] for r in attn),
            "decode_attention_device_ms_per_round":
                attn_ms / max(rounds, 1),
            "device_busy_share_profiled": device_ms / 1e3 / wall_s,
            "top_kernels": [{"ms": r[0], "calls": r[1], "name": r[2][:90]}
                            for r in rows[:12]]}


# ------------------------------------------- SSM / hybrid exact and serve

def ssm_pair_cfgs(full: bool):
    """zamba2-1.2b target and mamba2-130m draft at the published widths,
    the vocabularies unified to the smaller (32000) as the launcher does;
    ``full=False``: float32 at HYBRID_LAYERS / SSM_DRAFT_LAYERS layers."""
    from repro_torch.configs import get_config
    t_cfg, d_cfg = get_config("zamba2-1.2b"), get_config("mamba2-130m")
    d_cfg = dataclasses.replace(d_cfg, vocab=t_cfg.vocab)
    if full:
        return t_cfg, d_cfg
    return (dataclasses.replace(t_cfg, n_layers=HYBRID_LAYERS,
                                dtype="float32"),
            dataclasses.replace(d_cfg, n_layers=SSM_DRAFT_LAYERS,
                                dtype="float32"))


def phase_exact_ssm(torch):
    """Float32 at the published widths: zamba2-1.2b at HYBRID_LAYERS layers
    (attn_every 6: one shared-attention segment and a 2-layer tail) ←
    mamba2-130m at SSM_DRAFT_LAYERS, vocab 32000. The server's greedy
    tokens == the target-only greedy decode; zamba2 and mamba2-130m
    self-speculation pairs commit their model's greedy tokens at
    acceptance 1.0; at temperature 1.0 zamba2 self-speculation accepts
    ≥ 0.99 and two wave runs of the pair with one seed commit identical
    tokens and acceptance bits."""
    import numpy as np
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    t_cfg, d_cfg = ssm_pair_cfgs(full=False)
    eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    reqs = _workload(np, t_cfg.vocab)
    pol = lambda: StaticWindowPolicy(4)
    srv, pair = _serve(eng, pol(), reqs)
    slots = srv._sessions[0].slots_len
    runs = {"pair": pair}
    for name, cfg, params in (("self_zamba2", t_cfg, eng.target_params),
                              ("self_mamba2", d_cfg, eng.draft_params)):
        self_eng = SpecDecodeEngine(cfg, cfg, draft_params=params,
                                    target_params=params,
                                    gamma_max=GAMMA_MAX, device=dev)
        _, runs[name] = _serve(self_eng, pol(), reqs)
        del self_eng
    mismatches = []
    for r in reqs:
        refs = {m: _greedy(torch, model, params, r.prompt,
                           r.max_new_tokens, slots, dev)[0]
                for m, model, params in (
                    ("zamba2", eng.target, eng.target_params),
                    ("mamba2", eng.draft, eng.draft_params))}
        for name, want in (("pair", "zamba2"), ("self_zamba2", "zamba2"),
                           ("self_mamba2", "mamba2")):
            got = runs[name][r.request_id].tokens
            if not np.array_equal(got, refs[want]):
                mismatches.append({"run": name, "request": r.request_id})
    acc = {n: [runs[n][r.request_id].acceptance_rate for r in reqs]
           for n in runs}
    # temperature 1.0
    t1_self = SpecDecodeEngine(t_cfg, t_cfg, draft_params=eng.target_params,
                               target_params=eng.target_params,
                               temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                               device=dev)
    _, t1_res = _serve(t1_self, pol(), reqs)
    del t1_self
    t1_acc = float(np.mean([t1_res[r.request_id].acceptance_rate
                            for r in reqs]))
    t1_eng = SpecDecodeEngine(d_cfg, t_cfg, draft_params=eng.draft_params,
                              target_params=eng.target_params,
                              temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                              device=dev)
    seeded = [run_sessions(np, t1_eng, reqs, pol(), 0, seed=3)
              for _ in range(2)]
    same = all(np.array_equal(seeded[0]["tokens"][i], seeded[1]["tokens"][i])
               and seeded[0]["bits"][i] == seeded[1]["bits"][i]
               for i in seeded[0]["tokens"])
    V = t_cfg.vocab
    full = all(t.size == 32 and (t >= 0).all() and (t < V).all()
               for run in seeded for t in run["tokens"].values())
    info = {"phase": "exact_ssm", "dtype": "float32",
            "target": f"{t_cfg.name} ({t_cfg.n_layers} layers)",
            "draft": f"{d_cfg.name} ({d_cfg.n_layers} layers)",
            "vocab": V, "requests": len(reqs), "gamma": 4,
            "acceptance": {n: float(np.mean(a)) for n, a in acc.items()},
            "mismatches": mismatches,
            "t1_self_spec_acceptance": t1_acc,
            "t1_pair_acceptance": seeded[0]["acceptance"],
            "t1_same_seed_identical": same, "t1_all_full_in_range": full,
            "step_keys": sorted(map(str, eng.step_keys)),
            "seconds": time.perf_counter() - t0}
    emit(info)
    if mismatches:
        fail(f"SSM/hybrid greedy tokens differ: {mismatches}")
    for name in ("self_zamba2", "self_mamba2"):
        if min(acc[name]) != 1.0:
            fail(f"{name} self-speculation acceptance {acc[name]} != 1.0")
    if t1_acc < 0.99:
        fail(f"T=1 zamba2 self-speculation acceptance {t1_acc} < 0.99")
    if not same or not full:
        fail("T=1 zamba2 <- mamba2 runs: a seed does not fix the tokens, "
             "or outputs are incomplete")
    del eng, t1_eng, srv
    torch.cuda.empty_cache()


def phase_serve_ssm(torch, kernels) -> dict:
    """The full zamba2-1.2b ← mamba2-130m pair in bf16 through
    ``repro_torch.launch.serve`` (the smoke's stream: 8 requests × 32
    tokens, batch 4, γ_max 8, static γ 4), greedy and at temperature 1.0.
    Each: complete in-range outputs, 2 step keys (split step, insert), and
    exact launch counts — B5 = rounds·L_t + admissions·(L_t + L_d) (the
    verify window and both prefills run the chunked scan; decode steps run
    the recurrence), B1 = rounds·n_seg·(γ_max + 2) + admissions·n_seg (the
    shared block in the verify and in each of the γ_max + 1 advance steps,
    and in the prefill), B3a = B3b = rounds sampled and 0 greedy, the rest
    0; one round step and one insert captured, every other round and
    admission replayed. Then one profile of a short greedy serve."""
    import numpy as np
    from repro_torch.launch import serve
    dev = torch.device("cuda", 0)
    base = ["--target", "zamba2-1.2b", "--draft", "mamba2-130m",
            "--full-size", "--max-batch", "4", "--requests", "8",
            "--max-new", "32", "--gamma-max", str(GAMMA_MAX), "--seed", "0",
            "--policy", "static", "--gamma", "4", "--json"]
    t_cfg, d_cfg = ssm_pair_cfgs(full=True)
    L_t, L_d = t_cfg.n_layers, d_cfg.n_layers
    n_seg = L_t // t_cfg.attn_every
    totals = {k: 0 for k in kernels.LAUNCHES}
    for name, extra in (("hybrid_static", []),
                        ("hybrid_static_t1",
                         ["--temperature", str(SAMPLED_T)])):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        out = serve.run(base + extra)
        launches = dict(kernels.LAUNCHES)
        s = out.summary
        rounds, adm = s["iterations"], s["requests"]
        b3 = rounds if extra else 0
        want = {k: 0 for k in kernels.LAUNCHES}
        want.update(ssd_scan=rounds * L_t + adm * (L_t + L_d),
                    decode_attn=rounds * n_seg * (GAMMA_MAX + 2)
                    + adm * n_seg, gather_reduce=b3, cdf_sample=b3)
        eng = out.server.engine
        V = eng.target_cfg.vocab
        full = all(len(r.tokens) == 32 and (r.tokens >= 0).all()
                   and (r.tokens < V).all() for r in out.results)
        keys = eng.step_programs()
        decode_s = sum(sess.decode_wall_s for sess in out.server._sessions)
        graphs, graphs_want = summary_graphs(s), want_graphs(2, rounds + adm)
        info = {"phase": "serve_ssm", "run": name,
                "target": eng.target_cfg.name, "draft": eng.draft_cfg.name,
                "requests": adm, "tokens": s["tokens"], "wall_s": s["wall_s"],
                "tokens_per_s": s["tokens_per_s"],
                "mean_ttft_ms": s["mean_ttft_ms"],
                "mean_tpot_ms": s["mean_tpot_ms"],
                "mean_acceptance": s["mean_acceptance"],
                "temperature": s["temperature"], "rounds": rounds,
                "decode_wall_s": decode_s,
                "step_keys": keys, "graphs": graphs,
                "expected_graphs": graphs_want, "launches": launches,
                "expected_launches": want,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 2**30,
                "all_full_in_range": full,
                "sync_debug_mode_in_rounds": "error"}
        emit(info)
        if adm != 8 or not full:
            fail(f"{name}: incomplete or out-of-range outputs")
        if launches != want:
            fail(f"{name}: kernel launches {launches}, expected {want}")
        if keys != 2:
            fail(f"{name}: {keys} step keys, expected 2 (split, insert)")
        if graphs != graphs_want:
            fail(f"{name}: graphs {graphs}, expected {graphs_want}")
        for k in totals:
            totals[k] += launches[k]
        del out, eng
        torch.cuda.empty_cache()
    from torch.profiler import ProfilerActivity, profile
    argv = list(base)
    argv[argv.index("--requests") + 1] = "4"
    argv[argv.index("--max-new") + 1] = "8"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = serve.run(argv)
        torch.cuda.synchronize()
    s = out.summary
    emit(profile_summary(prof, "hybrid_static 4x8", s["iterations"],
                         s["requests"], s["wall_s"]))
    del out
    torch.cuda.empty_cache()
    return totals


# ------------------------------------- pipelined mode and topology layer

# draft noise ladder of the f32 pipelined checks: the first noise whose
# pipelined run has both hits and misses is used (and printed); the served
# noised pair runs at a high and a low hit rate
PIPE_NOISES = (0.002, 0.005, 0.01, 0.02, 0.04)
PIPE_SERVE_NOISES = (0.01, 0.001)
PIPE_BATCH = 2                 # slots of the f32 pipelined servers
PIPE_KERNELS = ("decode_attn", "paged_decode_attn", "ssd_scan",
                "gather_reduce", "cdf_sample")
TOPO_KERNELS = ("decode_attn",)


def pipe_calls(sess, admissions: int, recurrent: bool) -> dict:
    """Calls of each captured step of a pipelined server session: an
    insert per admission; a propose per distributed round not verifying a
    kept speculative window; a speculative propose per speculative window
    posted; a verify per round; an ingest per fused round; for a recurrent
    draft a checkpoint per distributed round and a rollback per miss."""
    R, F = sess.iterations, sess.fused_iterations
    S = sess.speculative_windows
    kept = S - sess.transport.discarded_messages
    calls = {"insert": admissions, "propose": R - F - kept,
             "propose_spec": S, "verify": R, "ingest": F}
    if recurrent:
        calls.update(checkpoint=R - F, rollback=sess.pipeline_misses)
    return calls


def pipe_launches(sess, admissions: int, L_d: int, L_t: int,
                  half_duplex: bool) -> dict:
    """B1 launches of a greedy attention pair's transport server: every
    window proposed (γ_max draft steps) and every verify (one pass), the
    prefills of the admissions; a fused round verifies and ingests."""
    R, F = sess.iterations, sess.fused_iterations
    windows = R - F if half_duplex else (R - F
                                         + sess.transport.discarded_messages)
    return {"decode_attn": windows * GAMMA_MAX * L_d + (R - F) * L_t
            + (F + admissions) * (L_d + L_t)}


def pipeline_exact(torch, kernels) -> dict:
    """Float32, published widths: a qwen3-14b target at QWEN_CUT depth
    whose draft is its noised copy (the first noise of PIPE_NOISES whose
    pipelined run has hits AND misses), 4 requests × 32 tokens through
    2-slot servers, static γ 4: pipelined over the in-process transport, a
    15 ms emulated link on the virtual clock and a TCP loopback socket,
    dense and paged — tokens == the half-duplex server's == target greedy,
    hits > 0 and misses > 0, graphs per step as called; one more
    in-process run with γ and fused rounds changing every round
    (CyclePolicy) == target greedy on the same graphs. zamba2 ← mamba2
    (exact_ssm depths; random pair, every verdict a miss: the recurrent
    checkpoint and rollback) == half-duplex == target greedy. T = 1.0 on
    one seed: pipelined captured == eager. Returns the launch counts."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy
    from repro_torch.distributed import (EmulatedLinkTransport,
                                         InProcessTransport, SocketTransport)
    from repro_torch.models.model import build_model
    from repro_torch.sim.network import LinkSpec
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    t_cfg = dataclasses.replace(get_config("qwen3-14b"),
                                n_layers=QWEN_CUT["qwen3-14b"],
                                dtype="float32")
    model = build_model(t_cfg, dev)
    target = model.init_params(1)
    reqs = _workload(np, t_cfg.vocab, n=4)
    P = 16 * math.ceil(max(r.prompt.size for r in reqs) / 16)
    slots = P + 32 + 2 * GAMMA_MAX + 18
    ref = {r.request_id: _greedy(torch, model, target, r.prompt,
                                 r.max_new_tokens, slots, dev)[0]
           for r in reqs}
    totals = {k: 0 for k in kernels.LAUNCHES}
    static = lambda: StaticWindowPolicy(4)
    ladder, eng = [], None
    for noise in PIPE_NOISES:
        eng = SpecDecodeEngine(t_cfg, t_cfg, target_params=target,
                               draft_params=noised_copy(torch, target, noise,
                                                        7),
                               gamma_max=GAMMA_MAX, device=dev)
        srv, _ = _serve(eng, static(), reqs, batch=PIPE_BATCH,
                        transport=InProcessTransport(),
                        mode_policy="pipeline")
        s = srv._sessions[0]
        ladder.append({"noise": noise, "hits": s.pipeline_hits,
                       "misses": s.pipeline_misses,
                       "acceptance": s.accepted / max(1, s.proposed)})
        if s.pipeline_hits and s.pipeline_misses:
            break
        del eng, srv, s
        eng = None
        torch.cuda.empty_cache()
    emit({"phase": "pipeline", "check": "noise ladder", "ladder": ladder,
          "chosen_noise": ladder[-1]["noise"] if eng is not None else None})
    if eng is None:
        fail(f"pipeline: no noise in {PIPE_NOISES} gave hits and misses")
    transports = {
        "in-process": InProcessTransport,
        "emulated 15/1/1 virtual": lambda: EmulatedLinkTransport(
            LinkSpec(15.0, 1.0, 1.0), seed=0, sleep=False),
        "socket loopback": lambda: SocketTransport.loopback(timeout_s=60.0)}
    rows, bad = [], []
    for lay, kw in (("dense", {}), ("paged", dict(paged_kv=True))):
        _, half = _serve(eng, static(), reqs, batch=PIPE_BATCH,
                         transport=InProcessTransport(),
                         mode_policy="distributed", **kw)
        for tname, make_tr in transports.items():
            tr = make_tr()
            g0, c0 = graph_counts(eng), step_calls(eng)
            kernels.reset_launches()
            try:
                srv, res = _serve(eng, static(), reqs, batch=PIPE_BATCH,
                                  transport=tr, mode_policy="pipeline", **kw)
            finally:
                if isinstance(tr, SocketTransport):
                    tr.close()
            _add(totals, kernels.LAUNCHES)
            sess = srv._sessions[0]
            same = all(np.array_equal(res[i].tokens, ref[i])
                       and np.array_equal(half[i].tokens, ref[i])
                       for i in ref)
            graphs = graphs_since(eng, g0)
            want, _ = pool_graphs(eng, c0, pipe_calls(sess, len(reqs),
                                                      False))
            row = {"layout": lay, "transport": tname,
                   "rounds": sess.iterations, "hits": sess.pipeline_hits,
                   "misses": sess.pipeline_misses,
                   "speculative_windows": sess.speculative_windows,
                   "discarded": tr.discarded_messages,
                   "link_ms": sess.link_ms, "graphs": graphs,
                   "expected_graphs": want, "equal": same}
            rows.append(row)
            if not (same and sess.pipeline_hits and sess.pipeline_misses
                    and graphs == want):
                bad.append(row)
    # γ changing every round and a fused round every fifth (CyclePolicy):
    # the same 4 graphs + ingest serve every γ, hit, miss and admission
    g0, c0 = graph_counts(eng), step_calls(eng)
    kernels.reset_launches()
    srv, res = _serve(eng, CyclePolicy(), reqs, batch=PIPE_BATCH,
                      transport=InProcessTransport(), mode_policy="pipeline")
    _add(totals, kernels.LAUNCHES)
    sess = srv._sessions[0]
    graphs = graphs_since(eng, g0)
    want, _ = pool_graphs(eng, c0, pipe_calls(sess, len(reqs), False))
    row = {"layout": "dense", "transport": "in-process", "policy": "cycle",
           "rounds": sess.iterations, "fused": sess.fused_iterations,
           "hits": sess.pipeline_hits, "misses": sess.pipeline_misses,
           "speculative_windows": sess.speculative_windows,
           "graphs": graphs, "expected_graphs": want,
           "equal": all(np.array_equal(res[i].tokens, ref[i]) for i in ref)}
    rows.append(row)
    if not (row["equal"] and sess.fused_iterations and graphs == want):
        bad.append(row)
    emit({"phase": "pipeline", "check": "pipelined == half-duplex == "
          "target greedy", "dtype": "float32", "target": t_cfg.name,
          "layers": t_cfg.n_layers, "noise": ladder[-1]["noise"],
          "requests": len(reqs), "batch": PIPE_BATCH, "runs": rows,
          "failures": bad, "seconds": time.perf_counter() - t0})
    if bad:
        fail(f"pipeline exactness: {bad}")

    # T = 1.0, one seed: pipelined captured == eager (the speculative
    # propose draws from the session generator between verifies)
    t1 = time.perf_counter()
    samp = SpecDecodeEngine(t_cfg, t_cfg, target_params=target,
                            draft_params=eng.draft_params,
                            temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                            device=dev)
    kernels.reset_launches()
    runs = {c: run_sessions(np, samp, reqs, static(), 0, batch=PIPE_BATCH,
                            seed=3, capture=c, transport=InProcessTransport(),
                            mode_policy="pipeline")
            for c in (None, False)}
    _add(totals, kernels.LAUNCHES)
    same = all(np.array_equal(runs[None]["tokens"][i],
                              runs[False]["tokens"][i])
               and runs[None]["bits"][i] == runs[False]["bits"][i]
               for i in runs[None]["tokens"])
    emit({"phase": "pipeline", "check": "T=1 pipelined captured == eager "
          "on one seed", "temperature": SAMPLED_T, "equal": same,
          "acceptance": runs[None]["acceptance"],
          "hits": runs[None]["hits"], "misses": runs[None]["misses"],
          "seconds": time.perf_counter() - t1})
    if not same:
        fail("pipeline T=1: captured != eager on one seed")
    del samp, eng, target
    torch.cuda.empty_cache()

    # zamba2 <- mamba2: every verdict misses, the checkpoint rolls back
    t1 = time.perf_counter()
    st_cfg, sd_cfg = ssm_pair_cfgs(full=False)
    ssm = SpecDecodeEngine(sd_cfg, st_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    sreqs = _workload(np, st_cfg.vocab, n=4)
    _, half = _serve(ssm, static(), sreqs, batch=PIPE_BATCH,
                     transport=InProcessTransport(),
                     mode_policy="distributed")
    g0, c0 = graph_counts(ssm), step_calls(ssm)
    kernels.reset_launches()
    srv, pipe = _serve(ssm, static(), sreqs, batch=PIPE_BATCH,
                       transport=InProcessTransport(), mode_policy="pipeline")
    _add(totals, kernels.LAUNCHES)
    sess = srv._sessions[0]
    sref = {r.request_id: _greedy(torch, ssm.target, ssm.target_params,
                                  r.prompt, r.max_new_tokens,
                                  sess.slots_len, dev)[0] for r in sreqs}
    same = all(np.array_equal(pipe[i].tokens, sref[i])
               and np.array_equal(half[i].tokens, sref[i]) for i in sref)
    graphs = graphs_since(ssm, g0)
    want, _ = pool_graphs(ssm, c0, pipe_calls(sess, len(sreqs), True))
    emit({"phase": "pipeline", "check": "zamba2 <- mamba2 pipelined == "
          "half-duplex == target greedy", "dtype": "float32",
          "rounds": sess.iterations, "hits": sess.pipeline_hits,
          "misses": sess.pipeline_misses, "graphs": graphs,
          "expected_graphs": want, "equal": same,
          "seconds": time.perf_counter() - t1})
    if not same or graphs != want or not sess.pipeline_misses:
        fail("pipeline zamba2 <- mamba2: tokens, graphs or no miss")
    del ssm, srv, sess
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------ the moe, encdec and vlm families

FAMILY_KERNELS = ("decode_attn", "paged_decode_attn", "tree_verify",
                  "gather_reduce", "cdf_sample")
# arctic-480b cut to one card: experts 128 → 8, layers 35 → 6 (12, about
# 26 GB in bf16, until the training phase joined the script), every width
# as published; the f32 checks at 2 layers each side
ARCTIC_CUT = dict(n_experts=8, n_layers=6)
FAMILY_EXACT_LAYERS = 2
WHISPER_NOISE = 0.01
INTERNVL_LAYERS = (4, 1)           # bf16 timing: target, draft
INTERNVL_EXACT_LAYERS = (2, 1)     # f32 exactness


def _fam_greedy(torch, model, params, prompt, n, slots, dev, frontend=None):
    """Target-only greedy decode of one prompt (T = 1 steps); ``frontend``
    (1, F, D) for an encdec model."""
    toks = torch.as_tensor(prompt[None, :].astype("int64"), device=dev)
    logits, cache = model.prefill(params, toks, slots, frontend=frontend)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = [tok]
    pos = torch.full((1,), prompt.size, dtype=torch.int32, device=dev)
    for _ in range(n - 1):
        logits, cache = model.decode_step(params, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return torch.cat(out).cpu().numpy()


def _served(kernels, totals, eng, policy, reqs, **kw):
    """One in-process server run whose launches count for the phase:
    (server, results, launches, wall s)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    srv, res = _serve(eng, policy, reqs, **kw)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    _add(totals, launches)
    return srv, res, launches, wall


def moe_exact(torch, np, kernels, totals, dev) -> None:
    """Float32 at the published widths, 2 layers each side: arctic-480b
    (8 experts, cf 1.25) ← llama2-7b. Captured == eager (γ changing every
    round), dense == paged (pool at 60 % of parity), colocated ==
    in-process transport; at cf 8 (no assignment dropped) the served and
    tree-wave tokens == the target's greedy decode; at T 1.0 a seed fixes
    the tokens of ``generate``."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy
    from repro_torch.distributed import InProcessTransport
    t0 = time.perf_counter()
    t_cfg = dataclasses.replace(get_config("arctic-480b"), n_experts=8,
                                n_layers=FAMILY_EXACT_LAYERS, dtype="float32")
    d_cfg = dataclasses.replace(get_config("llama2-7b"),
                                n_layers=FAMILY_EXACT_LAYERS, dtype="float32")
    eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    reqs = _workload(np, t_cfg.vocab)
    n = len(reqs)
    P = 16 * math.ceil(max(r.prompt.size for r in reqs) / 16)
    slots = P + 32 + 2 * GAMMA_MAX + 18
    parity = 4 * math.ceil(slots / 16)

    def server(policy, **kw):
        def drive(capture):
            pol = RecordingPolicy(policy(), 1)
            srv, res = _serve(eng, pol, reqs, capture=capture, **kw)
            return ({i: r.tokens for i, r in res.items()},
                    srv._sessions[0].iterations, 1, pol)
        return drive

    capture_pair(np, "arctic moe cf 1.25", eng, server(CyclePolicy), n, 2)
    runs = {}
    for name, kw in (("dense", {}),
                     ("paged", dict(paged_kv=True,
                                    kv_pool_blocks=int(0.6 * parity))),
                     ("in-process", dict(transport=InProcessTransport(),
                                         mode_policy="distributed"))):
        _, res, launches, _ = _served(kernels, totals, eng,
                                      StaticWindowPolicy(4), reqs, **kw)
        runs[name] = {i: r.tokens for i, r in res.items()}
    same = {k: all(np.array_equal(runs[k][i], runs["dense"][i])
                   for i in runs["dense"]) for k in ("paged", "in-process")}
    # cf 8: capacity 2·S per expert and group, so nothing drops
    e8 = SpecDecodeEngine(d_cfg, dataclasses.replace(t_cfg,
                                                     capacity_factor=8.0),
                          draft_params=eng.draft_params,
                          target_params=eng.target_params,
                          gamma_max=GAMMA_MAX, device=dev)
    ref = {r.request_id: _fam_greedy(torch, e8.target, e8.target_params,
                                     r.prompt, r.max_new_tokens, slots, dev)
           for r in reqs}
    _, res8, _, _ = _served(kernels, totals, e8, StaticWindowPolicy(4), reqs)
    kernels.reset_launches()
    tree = run_sessions(np, e8, reqs, StaticWindowPolicy(4, branches=B_MAX),
                        B_MAX)
    _add(totals, {k: v for k, v in kernels.LAUNCHES.items() if v})
    greedy = all(np.array_equal(res8[i].tokens, ref[i]) for i in ref)
    tree_greedy = all(np.array_equal(tree["tokens"][i], ref[i])
                      for i in ref)
    del e8
    t1 = SpecDecodeEngine(d_cfg, t_cfg, draft_params=eng.draft_params,
                          target_params=eng.target_params,
                          temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                          device=dev)
    wave, lens = wave_prompts(np, reqs[:4])
    kernels.reset_launches()
    sampled = [t1.generate(wave, 32, StaticWindowPolicy(4), prompt_lens=lens,
                           seed=5)[0] for _ in range(2)]
    _add(totals, {k: v for k, v in kernels.LAUNCHES.items() if v})
    seeded = np.array_equal(sampled[0], sampled[1])
    info = {"phase": "families", "check": "moe exact", "dtype": "float32",
            "target": f"{t_cfg.name} (experts 128 -> 8, {t_cfg.n_layers} "
            f"layers, widths as published)",
            "draft": f"{d_cfg.name} ({d_cfg.n_layers} layers)",
            "requests": n, "paged_equals_dense": same["paged"],
            "in_process_equals_colocated": same["in-process"],
            "cf8_server_equals_target_greedy": greedy,
            "cf8_tree_equals_target_greedy": tree_greedy,
            "tree_rounds": tree["rounds"],
            "t1_same_seed_equal": seeded,
            "t1_full_in_range": bool(((sampled[0] >= 0)
                                      & (sampled[0] < t_cfg.vocab)).all()),
            "seconds": time.perf_counter() - t0}
    emit(info)
    if not (all(same.values()) and greedy and tree_greedy and seeded
            and info["t1_full_in_range"]):
        fail(f"moe exactness: {info}")
    del eng, t1
    torch.cuda.empty_cache()


class MoeRecorder:
    """Wraps ``repro_torch.models.moe.moe_block`` (the model calls it
    through the module) for an eager run: each call of the verify window's
    shape (``rows`` × γ_max + 1) adds its dropped expert assignments to a
    device counter and runs inside ``record_function("moe_block")``; the
    target's verify steps of that shape run inside
    ``record_function("verify_step")``. Device ops only: the rounds' no-sync
    guard holds. Information only."""

    def __init__(self, torch, eng, rows: int):
        import repro_torch.models.moe as moe
        self.torch, self.moe, self.real = torch, moe, moe.moe_block
        self.eng, self.shape = eng, (rows, GAMMA_MAX + 1)
        self.dropped = torch.zeros((), device=eng.device)

    def __enter__(self):
        torch, real, shape = self.torch, self.real, self.shape
        moe = self.moe
        rf = torch.profiler.record_function

        def block(x, p, cfg):
            if tuple(x.shape[:2]) != shape:
                return real(x, p, cfg)
            self.dropped += moe.dropped_assignments(x, p["router"], cfg)
            with rf("moe_block"):
                return real(x, p, cfg)

        verify = self.eng.target.verify_step

        def verify_step(params, tokens, *a, **kw):
            if tuple(tokens.shape) != shape:
                return verify(params, tokens, *a, **kw)
            with rf("verify_step"):
                return verify(params, tokens, *a, **kw)

        moe.moe_block = block
        self.eng.target.verify_step = verify_step
        return self

    def __exit__(self, *exc):
        self.moe.moe_block = self.real
        del self.eng.target.verify_step


def _scope_device_ms(prof, name: str) -> float:
    for ev in prof.key_averages():
        if ev.key == name:
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            return t / 1e3
    return 0.0


def moe_serve(torch, np, kernels, totals, dev) -> None:
    """bf16, arctic-480b at the published widths (experts 128 → 8, layers
    35 → 6) ← llama2-7b as published: static γ 4 on the smoke's 8 × 32
    stream through the in-process server, dense then paged (captured);
    exact launch counts; then an eager dense run counting the dropped
    expert assignments per round, and the MoE blocks' share of the verify
    step's device time: three eager verify steps at the verify shape
    profiled (torch.profiler: a whole eager served run takes minutes to
    trace), and the same share timed with CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.session import DecodeSession
    from repro_torch.core.window import StaticWindowPolicy
    import repro_torch.models.moe as moe
    t0 = time.perf_counter()
    t_cfg = dataclasses.replace(get_config("arctic-480b"), **ARCTIC_CUT)
    d_cfg = get_config("llama2-7b")
    eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, gamma_max=GAMMA_MAX,
                           device=dev)
    setup = time.perf_counter() - t0
    reqs = _workload(np, t_cfg.vocab)
    L_d, L_t, V = d_cfg.n_layers, t_cfg.n_layers, t_cfg.vocab
    rows = {}
    for name, kw in (("dense", {}), ("paged", dict(paged_kv=True))):
        torch.cuda.reset_peak_memory_stats()
        srv, res, launches, wall = _served(kernels, totals, eng,
                                           StaticWindowPolicy(4), reqs, **kw)
        R, A = srv._sessions[0].iterations, len(reqs)
        per_round, per_admit = R * (GAMMA_MAX * L_d + L_t), A * (L_d + L_t)
        want = ({"decode_attn": per_admit, "paged_decode_attn": per_round}
                if kw else {"decode_attn": per_round + per_admit})
        toks = sum(len(r.tokens) for r in res.values())
        full = all(len(r.tokens) == 32 and (r.tokens >= 0).all()
                   and (r.tokens < V).all() for r in res.values())
        rows[name] = {
            "tokens_per_s": toks / wall, "wall_s": wall, "rounds": R,
            "mean_tpot_ms": float(np.mean([r.tpot_ms for r in res.values()])),
            "mean_ttft_ms": float(np.mean([r.ttft_ms for r in res.values()])),
            "acceptance": float(np.mean([r.acceptance_rate
                                         for r in res.values()])),
            "launches": launches, "expected_launches": want,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2**30,
            "all_full_in_range": full}
        if launches != want or not full:
            fail(f"moe serve {name}: {rows[name]}")
    # eager: the dropped assignments of every verify window
    rec = MoeRecorder(torch, eng, 4)
    with rec:
        srv, res = _serve(eng, StaticWindowPolicy(4), reqs, capture=False)
    R = srv._sessions[0].iterations
    # the MoE share of a verify step: profiled and timed at its shape
    with DecodeSession(eng, capacity=4, max_new_cap=8, max_prompt_len=48,
                       gamma_max=GAMMA_MAX, capture=False) as sess:
        sess.admit(reqs[0].prompt, 8)
        st = sess._state
        win = torch.zeros((4, GAMMA_MAX + 1), dtype=torch.int32, device=dev)

        def verify():
            return eng.target.verify_step(eng.target_params, win,
                                          st.target_cache, st.pos)
        verify()
        torch.cuda.synchronize()
        with MoeRecorder(torch, eng, 4), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng.target.verify_step(eng.target_params, win,
                                       st.target_cache, st.pos)
            torch.cuda.synchronize()
        verify_step_ms = cuda_ms(torch, verify)
    moe_ms = _scope_device_ms(prof, "moe_block")
    verify_ms = _scope_device_ms(prof, "verify_step")
    x = torch.randn(4, GAMMA_MAX + 1, t_cfg.d_model, device=dev,
                    dtype=eng.target.dtype)
    lp = {k: v[0] for k, v in eng.target_params["layers"]["moe"].items()}
    block_ms = cuda_ms(torch, lambda: moe.moe_block(x, lp, t_cfg))
    emit({"phase": "families", "check": "moe serve", "dtype": "bfloat16",
          "target": f"{t_cfg.name} (experts 128 -> {t_cfg.n_experts}, "
          f"layers 35 -> {t_cfg.n_layers}, widths as published)",
          "draft": f"{d_cfg.name} (as published)",
          "card": smi_line(), "setup_seconds": setup, **rows,
          "eager_rounds": R,
          "dropped_assignments_per_round": float(rec.dropped) / max(1, R),
          "assignments_per_round": 4 * (GAMMA_MAX + 1)
          * t_cfg.experts_per_tok * L_t,
          "moe_share_of_verify_profiled": moe_ms / verify_ms
          if verify_ms else None,
          "moe_block_ms": block_ms, "verify_step_ms": verify_step_ms,
          "moe_share_of_verify_timed": L_t * block_ms / verify_step_ms,
          "seconds": time.perf_counter() - t0})
    del eng, srv, res, prof, st
    torch.cuda.empty_cache()


def whisper_run(torch, np, kernels, totals, dev) -> None:
    """whisper-tiny ← its noised copy (σ 0.01) at the published size (4 + 4
    layers, d 384, 6 heads of 64, vocab 51865, 1500 frames from the seed):
    float32 ``generate(frontend=)`` == the target's greedy decode with the
    same frontend, a second call on the engine captures nothing; then
    bf16 timed."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy
    t0 = time.perf_counter()
    base = get_config("whisper-tiny")
    reqs = _workload(np, base.vocab, n=4)
    wave, lens = wave_prompts(np, reqs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    frames = torch.randn(len(reqs), base.n_frontend_tokens, base.d_model,
                         generator=gen, device=dev)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        target = SpecDecodeEngine(cfg, cfg, seed=1, device=dev)
        eng = SpecDecodeEngine(cfg, cfg, target_params=target.target_params,
                               draft_params=noised_copy(
                                   torch, target.target_params,
                                   WHISPER_NOISE, 7),
                               gamma_max=GAMMA_MAX, device=dev)
        del target
        fe = frames.to(eng.target.dtype)
        row = {}
        for run in ("cold", "warm"):
            g0 = graph_counts(eng)
            kernels.reset_launches()
            t1 = time.perf_counter()
            toks, st = eng.generate(wave, 32, StaticWindowPolicy(4),
                                    prompt_lens=lens, frontend=fe)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            row[run] = {"wall_s": wall, "tokens_per_s": toks.size / wall,
                        "rounds": st.iterations,
                        "acceptance": st.acceptance_rate,
                        "graphs": graphs_since(eng, g0)}
            _add(totals, {k: v for k, v in kernels.LAUNCHES.items() if v})
        if dtype == "float32":
            slots = int(lens.max()) + 32 + 2 * GAMMA_MAX + 18
            ref = [_fam_greedy(torch, eng.target, eng.target_params,
                               r.prompt, 32, slots, dev, fe[i:i + 1])
                   for i, r in enumerate(reqs)]
            row["equals_target_greedy"] = all(
                np.array_equal(toks[i], ref[i]) for i in range(len(reqs)))
        out[dtype] = row
        del eng
        torch.cuda.empty_cache()
    f32 = out["float32"]
    emit({"phase": "families", "check": "whisper generate(frontend=)",
          "target": "whisper-tiny (published size)",
          "draft": f"whisper-tiny + noise {WHISPER_NOISE}",
          "frames": base.n_frontend_tokens, "requests": len(reqs),
          "card": smi_line(), **out, "seconds": time.perf_counter() - t0})
    if not f32["equals_target_greedy"] or f32["warm"]["graphs"]["captured"]:
        fail(f"whisper: {out}")


def internvl_run(torch, np, kernels, totals, dev) -> None:
    """internvl2-76b text-only at the published widths: float32 at depth 2
    ← a draft of the same widths at depth 1, ``generate`` == the target's
    greedy decode; a live frontend raises NotImplementedError (the
    reference's rule); then bf16 at depth 4 ← 1 timed."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy
    t0 = time.perf_counter()
    base = get_config("internvl2-76b")
    reqs = _workload(np, base.vocab, n=4)
    wave, lens = wave_prompts(np, reqs)
    out = {}
    for dtype, (L_t, L_d) in (("float32", INTERNVL_EXACT_LAYERS),
                              ("bfloat16", INTERNVL_LAYERS)):
        t_cfg = dataclasses.replace(base, n_layers=L_t, dtype=dtype)
        d_cfg = dataclasses.replace(base, n_layers=L_d, dtype=dtype)
        eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, gamma_max=GAMMA_MAX,
                               device=dev)
        kernels.reset_launches()
        t1 = time.perf_counter()
        toks, st = eng.generate(wave, 32, StaticWindowPolicy(4),
                                prompt_lens=lens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        _add(totals, {k: v for k, v in kernels.LAUNCHES.items() if v})
        row = {"layers": [L_t, L_d], "wall_s": wall,
               "tokens_per_s": toks.size / wall, "rounds": st.iterations}
        if dtype == "float32":
            slots = int(lens.max()) + 32 + 2 * GAMMA_MAX + 18
            row["equals_target_greedy"] = all(
                np.array_equal(toks[i], _fam_greedy(
                    torch, eng.target, eng.target_params, r.prompt, 32,
                    slots, dev)) for i, r in enumerate(reqs))
            try:
                eng.target.prefill(
                    eng.target_params,
                    torch.as_tensor(wave[:1], device=dev), 64,
                    frontend=torch.zeros((1, 4, base.d_model), device=dev))
                row["frontend_refused"] = False
            except NotImplementedError:
                row["frontend_refused"] = True
        out[dtype] = row
        del eng
        torch.cuda.empty_cache()
    emit({"phase": "families", "check": "internvl2 text-only",
          "target": "internvl2-76b (widths as published, depth cut)",
          "requests": len(reqs), "card": smi_line(), **out,
          "seconds": time.perf_counter() - t0})
    f32 = out["float32"]
    if not (f32["equals_target_greedy"] and f32["frontend_refused"]):
        fail(f"internvl2: {out}")


def phase_families(torch, kernels) -> dict:
    import numpy as np
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    totals = {k: 0 for k in kernels.LAUNCHES}
    moe_exact(torch, np, kernels, totals, dev)
    moe_serve(torch, np, kernels, totals, dev)
    whisper_run(torch, np, kernels, totals, dev)
    internvl_run(torch, np, kernels, totals, dev)
    return totals


def _served_row(torch, kernels, name, out, card, half_duplex) -> dict:
    """Checks and the line of one served pipelined or half-duplex run."""
    s = out.summary
    eng, sess = out.server.engine, out.server._sessions[0]
    L_d, L_t = eng.draft_cfg.n_layers, eng.target_cfg.n_layers
    A, V = s["requests"], eng.target_cfg.vocab
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    want = pipe_launches(sess, A, L_d, L_t, half_duplex)
    calls = (split_calls(sess.iterations, sess.fused_iterations, A, False)
             if half_duplex else pipe_calls(sess, A, False))
    graphs, graphs_want = summary_graphs(s), want_step_graphs(calls)
    full = all(len(r.tokens) == 32 and (r.tokens >= 0).all()
               and (r.tokens < V).all() for r in out.results)
    row = s["pairs"]["pair0"]
    info = {"phase": "pipeline", "run": name, "card": card,
            "layers": [L_d, L_t], "requests": A, "tokens": s["tokens"],
            "wall_s": s["wall_s"], "tokens_per_s": s["tokens_per_s"],
            "mean_tpot_ms": s["mean_tpot_ms"],
            "mean_ttft_ms": s["mean_ttft_ms"],
            "mean_acceptance": s["mean_acceptance"],
            "rounds": sess.iterations, "hits": sess.pipeline_hits,
            "misses": sess.pipeline_misses,
            "speculative_windows": sess.speculative_windows,
            "discarded_windows": row["discarded_windows"],
            "link_ms": sess.link_ms,
            "link_ms_per_round": sess.link_ms / max(1, sess.iterations),
            "decode_ms_per_round": sess.decode_wall_s * 1e3
            / max(1, sess.iterations),
            "link_recent_rtt_ms": s["link_recent_rtt_ms"],
            "graphs": graphs, "expected_graphs": graphs_want,
            "launches": launches, "expected_launches": want,
            "all_full_in_range": full}
    emit(info)
    problems = []
    if A != 8 or not full:
        problems.append("incomplete or out-of-range outputs")
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    if graphs != graphs_want:
        problems.append(f"graphs {graphs}, expected {graphs_want}")
    if problems:
        fail(f"pipeline {name}: {problems}")
    return info


def pipeline_serve(torch, kernels) -> dict:
    """bf16 through ``repro_torch.launch.serve`` over a 15 ms link (jitter
    1 ms, 1 Gbps), 8 requests × 32 tokens, batch 4, γ_max 8, static γ 4,
    each pipelined run beside its half-duplex twin: qwen3-14b ← qwen2.5-3b
    at the published depth, random weights (α = 0: every verdict misses,
    pricing the wasted speculative propose); qwen2.5-3b ← a noised copy of
    itself at the published depth (``node_params``) at each noise of
    PIPE_SERVE_NOISES (a low and a high hit rate; the high one must hit).
    Complete outputs, exact B1 launches (every window proposed, discarded
    ones included), graphs per step as called. Returns the launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    base = ["--full-size", "--max-batch", "4", "--requests", "8",
            "--max-new", "32", "--gamma-max", str(GAMMA_MAX), "--seed", "0",
            "--policy", "static", "--gamma", "4", "--json"] + LINK15
    card = smi_line()
    totals = {k: 0 for k in kernels.LAUNCHES}
    rows = {}

    def run(name, argv, mode, node_params=None):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = serve.run(argv + ["--mode-policy", mode],
                        node_params=node_params)
        _add(totals, kernels.LAUNCHES)
        info = _served_row(torch, kernels, name, out, card,
                           mode == "distributed")
        info["seconds"] = time.perf_counter() - t0
        rows[name] = info
        del out
        torch.cuda.empty_cache()
        return info

    qwen = ["--target", "qwen3-14b", "--draft", "qwen2.5-3b"] + base
    run("qwen3-14b <- qwen2.5-3b pipelined", qwen, "pipeline")
    run("qwen3-14b <- qwen2.5-3b half-duplex", qwen, "distributed")
    cfg = get_config("qwen2.5-3b")
    dev = torch.device("cuda", 0)
    target = build_model(cfg, dev).init_params(1)
    self3b = ["--target", "qwen2.5-3b", "--draft", "qwen2.5-3b"] + base
    for noise in PIPE_SERVE_NOISES:
        params = {"cloud0": target,
                  "edge0": noised_copy(torch, target, noise, 7)}
        info = run(f"qwen2.5-3b <- noised ({noise}) pipelined", self3b,
                   "pipeline", params)
        run(f"qwen2.5-3b <- noised ({noise}) half-duplex", self3b,
            "distributed", params)
        del params
    if not info["hits"]:
        fail(f"pipeline: the qwen2.5-3b pair at noise {noise} never hit")
    del target
    torch.cuda.empty_cache()
    emit({"phase": "pipeline", "check": "served, pipelined vs half-duplex",
          "card": card, "tokens_per_s": {k: v["tokens_per_s"]
                                         for k, v in rows.items()},
          "mean_tpot_ms": {k: v["mean_tpot_ms"] for k, v in rows.items()}})
    return totals


def phase_pipeline(torch, kernels) -> dict:
    totals = pipeline_exact(torch, kernels)
    _add(totals, pipeline_serve(torch, kernels))
    return totals


def _spec_requests(spec, vocab: int) -> list:
    """The request stream ``launch.serve`` makes from a spec's workload."""
    from repro_torch.launch.serve import spec_requests
    return spec_requests(spec, vocab)


def _cut_f32(names) -> dict:
    from repro_torch.configs import get_config
    return {n: dataclasses.replace(get_config(n), n_layers=QWEN_CUT[n],
                                   dtype="float32") for n in names}


def phase_topology(torch, kernels) -> dict:
    """``examples/cluster_2pair.json`` (one shared qwen3-14b node, two
    qwen2.5-3b drafts over 2 ms and 40 ms links, AWC) served through
    ``launch.serve --topology`` in bf16 at the published widths and depth
    (8 requests × 32 tokens): both pairs serve, complete outputs, exact B1
    launches and graphs per pair; the same spec in f32 at QWEN_CUT: each
    pair's tokens == target greedy. Two wave-server runs (bf16, QWEN_CUT)
    beside two of its continuous twin. One process-backed pair
    at the published depth (two worker hosts on the card, 20 ms link, 8
    requests in two waves). The ``cluster_2pair_procs.json`` shape (four
    hosts) in f32 at QWEN_CUT: tokens == the in-process deployment of the
    same spec (each pair serving the same round-robin share), run after
    that deployment is freed. Every host: its second wave under the
    capture guard (a re-capture stops it), graphs as called. Each part runs
    in a function of its own, so its models are freed when it returns.
    Returns the launch counts (the hosts' included)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi_line()
    totals = {k: 0 for k in kernels.LAUNCHES}
    for part in (topology_cluster, topology_cluster_f32, topology_wave,
                 topology_process_pair, topology_procs_f32):
        _add(totals, part(torch, kernels, card))
        torch.cuda.empty_cache()
    return totals


def topology_cluster(torch, kernels, card) -> dict:
    """cluster_2pair in bf16, published widths and depth, through the
    launcher, on the smoke's serve stream (8 requests × 32 tokens in place
    of the file's 4 × 12, so that each pair runs enough rounds for AWC's
    fused share to read)."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    kernels.reset_launches()
    out = serve.run(["--topology", str(ROOT / "examples"
                                       / "cluster_2pair.json"),
                     "--full-size", "--requests", "8", "--max-new", "32",
                     "--json"])
    launches = dict(kernels.LAUNCHES)
    s, spec = out.summary, out.deployment.spec
    want_l, pairs, problems = 0, {}, []
    for pair, sess in zip(out.server.pairs, out.server._sessions):
        eng, row = pair.engine, s["pairs"][pair.pair_id]
        L_d, L_t = eng.draft_cfg.n_layers, eng.target_cfg.n_layers
        R, F, A = sess.iterations, sess.fused_iterations, row["requests"]
        want_l += ((R - F) * (spec.serving.gamma_max * L_d + L_t)
                   + (F + A) * (L_d + L_t))
        want_g = want_step_graphs(split_calls(R, F, A, False))
        got_g = graph_counts(eng)
        pairs[pair.pair_id] = {k: row[k] for k in (
            "requests", "iterations", "mean_gamma", "fused_fraction",
            "link_ms", "recent_rtt_ms")}
        pairs[pair.pair_id].update(graphs=got_g, expected_graphs=want_g)
        if got_g != want_g or not A:
            problems.append(pair.pair_id)
    V = out.deployment.vocab
    full = all(len(r.tokens) == spec.workload.max_new
               and (r.tokens >= 0).all() and (r.tokens < V).all()
               for r in out.results)
    emit({"phase": "topology", "run": "cluster_2pair bf16 full depth",
          "card": card, "pairs": pairs, "tokens_per_s": s["tokens_per_s"],
          "mean_tpot_ms": s["mean_tpot_ms"],
          "mean_ttft_ms": s["mean_ttft_ms"], "launches": launches,
          "expected_launches": {"decode_attn": want_l},
          "all_full_in_range": full, "seconds": time.perf_counter() - t0})
    if problems or not full or {k: n for k, n in launches.items()
                                if n} != {"decode_attn": want_l}:
        fail(f"topology cluster_2pair: pairs {problems}, full {full}, "
             f"launches {launches} (expected B1 {want_l})")
    return launches


def topology_cluster_f32(torch, kernels, card) -> dict:
    """cluster_2pair in f32 at QWEN_CUT: each pair == target greedy."""
    import numpy as np
    from repro_torch.topology import ClusterSpec, build_deployment
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    spec = ClusterSpec.load(str(ROOT / "examples" / "cluster_2pair.json"))
    dep = build_deployment(spec, model_configs=_cut_f32(
        ("qwen3-14b", "qwen2.5-3b")), reduced=False, device=dev,
        sleep_links=False)
    reqs = _spec_requests(spec, dep.vocab)
    srv = dep.build_server()
    for r in reqs:
        srv.submit(dataclasses.replace(r))
    kernels.reset_launches()
    res = {r.request_id: r for r in srv.run()}
    launches = dict(kernels.LAUNCHES)
    eng = dep.pairs[0].engine
    slots = srv._sessions[0].slots_len
    same = all(np.array_equal(res[r.request_id].tokens, _greedy(
        torch, eng.target, eng.target_params, r.prompt, r.max_new_tokens,
        slots, dev)[0]) for r in reqs)
    served = {p: sum(1 for r in res.values() if r.pair_id == p)
              for p in ("lan", "wan")}
    emit({"phase": "topology", "check": "cluster_2pair f32 QWEN_CUT == "
          "target greedy", "served": served, "equal": same,
          "seconds": time.perf_counter() - t0})
    if not same or not all(served.values()):
        fail(f"topology cluster_2pair f32: equal {same}, served {served}")
    return launches


def topology_wave(torch, kernels, card) -> dict:
    """The wave server in bf16 at QWEN_CUT (static γ 4, 8 requests × 32 in
    two waves of 4) and its continuous twin with the same flags, run in the
    order wave, continuous, continuous, wave so that neither gains from
    going second: each wave run's two waves share one session, so its
    insert and round steps each warm up and capture once (exact graph
    counts); the two servers differ only in the scheduler."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    argv = ["--full-size", "--requests", "8", "--max-new", "32",
            "--gamma-max", str(GAMMA_MAX), "--policy", "static", "--gamma",
            "4", "--json"]
    kernels.reset_launches()
    rows = {"wave": [], "continuous": []}
    problems = []
    for name in ("wave", "continuous", "continuous", "wave"):
        with depth_cut(QWEN_CUT):
            out = serve.run(argv + ["--server", name])
        s = out.summary
        row = {k: s[k] for k in ("tokens_per_s", "mean_tpot_ms",
                                 "mean_ttft_ms")}
        if name == "wave":
            want = want_step_graphs({"insert": s["requests"],
                                     "round": out.server.session.iterations})
            row.update(rounds=out.server.session.iterations,
                       graphs=summary_graphs(s))
            if summary_graphs(s) != want:
                problems.append(f"graphs {summary_graphs(s)} (expected "
                                f"{want})")
        else:
            row.update(rounds=out.server._sessions[0].iterations)
        if s["requests"] != 8 or any(len(r.tokens) != 32
                                     for r in out.results):
            problems.append(f"{name}: {s['requests']} requests, not all "
                            "complete")
        rows[name].append(row)
        del out
    launches = dict(kernels.LAUNCHES)
    emit({"phase": "topology", "run": "wave server bf16 QWEN_CUT beside "
          "its continuous twin (wave, cont., cont., wave)", "card": card,
          "runs": rows, "problems": problems,
          "seconds": time.perf_counter() - t0})
    if problems:
        fail(f"topology wave server: {problems}")
    return launches


def topology_process_pair(torch, kernels, card) -> dict:
    """A process-backed qwen3-14b ← qwen2.5-3b pair at the published depth
    in bf16: two worker hosts on the card, each holding its own model, a
    20 ms link, 8 requests × 32 tokens in two waves of 4."""
    import numpy as np
    from repro_torch.topology import build_deployment, one_pair_spec
    t0 = time.perf_counter()
    spec = one_pair_spec(link_rtt_ms=20.0, link_jitter_ms=0.0,
                         mode_policy="distributed", gamma_max=GAMMA_MAX,
                         max_batch=4, requests=8, max_new=32)
    spec.pairs[0].process = True
    spec.serving.max_new_cap = 32
    dep = build_deployment(spec, reduced=False,
                           device=torch.device("cuda", 0),
                           host_timeout_s=600.0)
    try:
        t_up = time.perf_counter() - t0
        srv = dep.build_server()
        for r in _spec_requests(spec, dep.vocab):
            srv.submit(r)
        t1 = time.perf_counter()
        res = srv.run()
        wall = time.perf_counter() - t1
        row = srv.pair_summaries()["pair0"]
    finally:
        dep.shutdown()
    cfgs = dep.node_configs
    problems = check_hosts(row, cfgs["edge0"].n_layers,
                           cfgs["cloud0"].n_layers, 8, GAMMA_MAX)
    tokens = sum(len(r.tokens) for r in res)
    emit({"phase": "topology", "run": "process-backed pair bf16 full depth",
          "card": card, "startup_s": t_up, "wall_s": wall,
          "tokens_per_s": tokens / wall,
          "mean_tpot_ms": float(np.mean([r.tpot_ms for r in res])),
          "mean_ttft_ms": float(np.mean([r.ttft_ms for r in res])),
          "host": row, "problems": problems,
          "seconds": time.perf_counter() - t0})
    if problems or tokens != 8 * 32:
        fail(f"topology process pair: {problems}, tokens {tokens}")
    totals: dict = {}
    for side in ("target_launches", "draft_launches"):
        _add(totals, row[side])
    return totals


def topology_procs_f32(torch, kernels, card) -> dict:
    """cluster_2pair_procs.json in f32 at QWEN_CUT (8 requests): the
    in-process deployment of the same spec, each pair serving its
    round-robin share, then — after it is freed — the four worker hosts;
    tokens equal per request."""
    import numpy as np
    from repro_torch.topology import ClusterSpec, build_deployment
    t0 = time.perf_counter()
    procs = ClusterSpec.load(str(ROOT / "examples"
                                 / "cluster_2pair_procs.json"))
    procs.workload.num_requests = 8
    cfgs = _cut_f32(("qwen3-14b", "qwen2.5-3b"))
    local, vocab = in_process_shares(torch, procs, cfgs)
    torch.cuda.empty_cache()
    reqs = _spec_requests(procs, vocab)
    dep = build_deployment(procs, model_configs=cfgs, reduced=False,
                           device=torch.device("cuda", 0),
                           host_timeout_s=600.0)
    try:
        srv = dep.build_server()
        for r in reqs:
            srv.submit(dataclasses.replace(r))
        hosted = {r.request_id: r.tokens for r in srv.run()}
        rows = srv.pair_summaries()
    finally:
        dep.shutdown()
    problems = {pid: check_hosts(r, cfgs["qwen2.5-3b"].n_layers,
                                 cfgs["qwen3-14b"].n_layers, 4,
                                 procs.serving.gamma_max)
                for pid, r in rows.items()}
    totals: dict = {}
    for r in rows.values():
        for side in ("target_launches", "draft_launches"):
            _add(totals, r[side])
    same = sorted(hosted) == sorted(local) and all(
        np.array_equal(hosted[i], local[i]) for i in local)
    emit({"phase": "topology", "check": "cluster_2pair_procs f32 QWEN_CUT "
          "four hosts == in-process deployment", "equal": same,
          "hosts": rows, "problems": problems,
          "seconds": time.perf_counter() - t0})
    if not same or any(problems.values()):
        fail(f"topology procs: equal {same}, {problems}")
    return totals


def in_process_shares(torch, spec, cfgs) -> tuple:
    """The in-process deployment of ``spec`` with every pair in process,
    pair i serving requests i, i + n, ... (the hosts' round-robin
    buckets); returns (tokens by request, vocab). Its models are freed on
    return."""
    import numpy as np
    from repro_torch.serving import SpecDecodeServer
    from repro_torch.topology import ClusterSpec, build_deployment
    inproc = ClusterSpec.from_json(spec.to_json())
    for p in inproc.pairs:
        p.process = False
    dep = build_deployment(inproc, model_configs=cfgs, reduced=False,
                           device=torch.device("cuda", 0), sleep_links=False)
    reqs = _spec_requests(spec, dep.vocab)
    local = {}
    for i, pair in enumerate(dep.pairs):
        srv = SpecDecodeServer(cfg=dep.server_config(), pairs=[pair])
        for r in reqs[i::len(dep.pairs)]:
            srv.submit(dataclasses.replace(r))
        local.update({r.request_id: r.tokens for r in srv.run()})
    return local, dep.vocab


def check_hosts(row: dict, L_d: int, L_t: int, admissions: int,
                gamma_max: int) -> list:
    """A process-backed pair's hosts after two waves: every wave ran, the
    second under the capture guard; graphs as called (target: insert,
    verify; draft: insert, propose, apply); exact B1 launches (each host
    prefills its model and the one-layer peer stub; the draft proposes
    γ_max steps a round, the target verifies once)."""
    problems = []
    if row["waves"] != 2:
        problems.append(f"waves {row['waves']}")
    if (row["target_graphs"], row["draft_graphs"]) != (2, 3):
        problems.append(f"graphs {row['target_graphs']} / "
                        f"{row['draft_graphs']}")
    R = row["iterations"]
    want = {"target": R * L_t + admissions * (L_t + 1),
            "draft": R * gamma_max * L_d + admissions * (L_d + 1)}
    for side in ("target", "draft"):
        got = row[f"{side}_launches"].get("decode_attn", 0)
        if got != want[side]:
            problems.append(f"{side} B1 {got}, expected {want[side]}")
    return problems


# ------------------------------------------------------------------ fleet

FLEET_KERNELS = ("decode_attn",)
FLEET_JSON = ROOT / "examples" / "fleet_cluster.json"
FLEET_SHED_REQUESTS = 16       # the shedding trace's length
FLEET_SHED_SLO_MS = 1.0        # the chat class's TTFT SLO there: no card
                               # prefills and crosses a link in 1 ms
ELASTIC_REQUESTS = 12          # burst at t = 0 into the elastic pool


def phase_fleet(torch, kernels) -> dict:
    """Fleet serving: ``examples/fleet_cluster.json`` (one shared
    qwen3-14b node ← two qwen2.5-3b drafts over 2 ms and 40 ms links, the
    smart router, an 8-request three-class burst trace with SLOs) through
    ``launch.serve --topology --full-size`` in bf16 at the published
    widths and depth: every request served with its class's output length,
    exact B1 launches and graphs per pair, the SLO report; the same spec in
    f32 at QWEN_CUT under the smart and the least-loaded router: tokens ==
    target greedy; SLO shedding on a 16-request trace whose chat TTFT SLO
    no card meets: shed rows empty, served rows == target greedy, shed +
    served == submitted, the report counting the shed; an elastic pool of
    ``cluster_2pair_procs.json``'s process pair (f32, QWEN_CUT) scaling
    from one pair to two under a burst: every request served == target
    greedy, every host shut down. Last, DSD-Sim on the bf16 spec under
    both routers beside the real per-pair counts (printed, not gated: the
    sim's times are for its own hardware catalog). Returns the launch
    counts (the elastic hosts' included)."""
    import gc
    import numpy as np
    from repro_torch.topology import ClusterSpec, build_deployment
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi_line()
    totals = {k: 0 for k in kernels.LAUNCHES}
    real = {}
    _add(totals, fleet_full(torch, kernels, card, real))
    torch.cuda.empty_cache()
    spec = ClusterSpec.load(str(FLEET_JSON))
    dep = build_deployment(spec, model_configs=_cut_f32(
        ("qwen3-14b", "qwen2.5-3b")), reduced=False,
        device=torch.device("cuda", 0), sleep_links=False)
    greedy = {}
    _add(totals, fleet_f32(torch, np, kernels, dep, greedy, real))
    _add(totals, fleet_shed(torch, np, kernels, dep, greedy))
    del dep, greedy
    gc.collect()
    torch.cuda.empty_cache()
    _add(totals, fleet_elastic(torch, np, card))
    torch.cuda.empty_cache()
    fleet_sim(real)
    return totals


def _fleet_greedy(torch, dep, greedy: dict, reqs) -> None:
    """Target-only greedy tokens of each request not yet in ``greedy``
    (keyed by prompt and length), on the deployment's target node."""
    eng = dep.pairs[0].engine
    dev = eng.target_params["embed"].device
    for r in reqs:
        key = (r.prompt.tobytes(), r.max_new_tokens)
        if key not in greedy:
            greedy[key] = _greedy(torch, eng.target, eng.target_params,
                                  r.prompt, r.max_new_tokens,
                                  len(r.prompt) + r.max_new_tokens + 8,
                                  dev)[0]


def _fleet_counts(results, pair_ids) -> dict:
    """Requests per pair, and the SLO-bearing ones per pair."""
    out = {"requests": {p: 0 for p in pair_ids},
           "slo_bearing": {p: 0 for p in pair_ids}}
    for r in results:
        if r.shed:
            continue
        out["requests"][r.pair_id] += 1
        if r.slo_ttft_ms > 0 or r.slo_tpot_ms > 0:
            out["slo_bearing"][r.pair_id] += 1
    return out


def fleet_full(torch, kernels, card, real: dict) -> dict:
    """fleet_cluster.json in bf16 at the published widths and depth through
    the launcher, its own trace (8 requests, smart router), on cold
    engines; then the same stream again through a second server on the
    deployment's warm engines. Each run: every request served with its
    output length, B1 launches = Σ pairs (R − F)·(γ_max·L_d + L_t) + (F +
    A)·(L_d + L_t); the cold run captures each step once per pair's pool,
    the warm run captures and warms up nothing (it replays every call)."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    kernels.reset_launches()
    out = serve.run(["--topology", str(FLEET_JSON), "--full-size",
                     "--json"])
    cold = _fleet_served(kernels, card, "cold", out.server, out.results,
                         out.requests, out.deployment, out.summary, {}, t0)
    real["smart bf16 full depth"] = _fleet_counts(
        out.results, [p.pair_id for p in out.server.pairs])
    t0 = time.perf_counter()
    dep, reqs = out.deployment, out.requests
    before = {p.pair_id: graph_counts(p.engine) for p in dep.pairs}
    srv = dep.build_server()
    for r in reqs:
        srv.submit(dataclasses.replace(r))
    kernels.reset_launches()
    t1 = time.perf_counter()
    res = srv.run()
    wall = time.perf_counter() - t1
    tokens = sum(len(r.tokens) for r in res)
    summary = {"requests": len(res), "tokens": tokens, "wall_s": wall,
               "tokens_per_s": tokens / wall,
               "mean_ttft_ms": sum(r.ttft_ms for r in res) / len(res),
               "mean_tpot_ms": sum(r.tpot_ms for r in res) / len(res),
               "pairs": srv.pair_summaries()}
    cold_tokens = {r.request_id: r.tokens.tolist() for r in out.results}
    warm = _fleet_served(kernels, card, "warm", srv, res, reqs, dep,
                         summary, before, t0, same_tokens_as_cold=all(
                             r.tokens.tolist() == cold_tokens[r.request_id]
                             for r in res))
    _add(cold, warm)
    return cold


def _fleet_served(kernels, card, name, srv, results, reqs, dep, s,
                  before: dict, t0, **extra) -> dict:
    """Checks and the line of one bf16 fleet run: complete outputs, exact
    B1 launches, graphs per pair (``before``: each engine's graph counts
    before a warm run, which must add replays only). Returns the
    launches."""
    launches = dict(kernels.LAUNCHES)
    spec = dep.spec
    want_l, pairs, problems = 0, {}, []
    for pair, sess in zip(srv.pairs, srv._sessions):
        eng, row = pair.engine, s["pairs"][pair.pair_id]
        L_d, L_t = eng.draft_cfg.n_layers, eng.target_cfg.n_layers
        R, F, A = sess.iterations, sess.fused_iterations, row["requests"]
        want_l += ((R - F) * (spec.serving.gamma_max * L_d + L_t)
                   + (F + A) * (L_d + L_t))
        calls = split_calls(R, F, A, False)
        if pair.pair_id in before:
            want_g = {"captured": 0, "warm_ups": 0,
                      "replays": sum(calls.values())}
            got_g = graphs_since(eng, before[pair.pair_id])
        else:
            want_g, got_g = want_step_graphs(calls), graph_counts(eng)
        pairs[pair.pair_id] = {k: row[k] for k in (
            "requests", "iterations", "fused_fraction", "recent_rtt_ms",
            "ttft_p95_ms", "shed")}
        pairs[pair.pair_id].update(graphs=got_g, expected_graphs=want_g)
        if got_g != want_g:
            problems.append(f"{pair.pair_id}: graphs {got_g}, expected "
                            f"{want_g}")
    by_id = {r.request_id: r for r in reqs}
    full = (len(results) == len(reqs) and all(
        len(r.tokens) == by_id[r.request_id].max_new_tokens
        and (r.tokens >= 0).all() and (r.tokens < dep.vocab).all()
        for r in results))
    emit({"phase": "fleet", "run": f"fleet_cluster bf16 full depth, {name}",
          "card": card, **{k: s[k] for k in (
              "requests", "tokens", "wall_s", "tokens_per_s", "mean_ttft_ms",
              "mean_tpot_ms")}, "pairs": pairs,
          "slo": slo_of(results), "launches": launches,
          "expected_launches": {"decode_attn": want_l},
          "all_full_in_range": full, **extra,
          "seconds": time.perf_counter() - t0})
    if problems or not full or {k: n for k, n in launches.items()
                                if n} != {"decode_attn": want_l}:
        fail(f"fleet {name}: {problems}, full {full}, launches {launches} "
             f"(expected B1 {want_l})")
    return launches


def slo_of(results) -> dict:
    from repro_torch.fleet import slo_report
    from repro_torch.fleet.workload import serve_results_rows
    return slo_report(serve_results_rows(results))


def fleet_f32(torch, np, kernels, dep, greedy: dict, real: dict) -> dict:
    """fleet_cluster.json in f32 at QWEN_CUT, its trace under the smart and
    the least-loaded router on one deployment: every request's tokens ==
    the target's greedy decode."""
    from repro_torch.serving import PAIR_ROUTERS, SpecDecodeServer
    t0 = time.perf_counter()
    reqs = _spec_requests(dep.spec, dep.vocab)
    _fleet_greedy(torch, dep, greedy, reqs)
    kernels.reset_launches()
    rows, problems = {}, []
    for router in ("smart", "least-loaded"):
        srv = SpecDecodeServer(cfg=dep.server_config(), pairs=dep.pairs,
                               router=PAIR_ROUTERS[router]())
        for r in reqs:
            srv.submit(dataclasses.replace(r))
        res = srv.run()
        same = len(res) == len(reqs) and all(np.array_equal(
            r.tokens, greedy[(q.prompt.tobytes(), q.max_new_tokens)])
            for q, r in zip(reqs, sorted(res, key=lambda x: x.request_id)))
        counts = _fleet_counts(res, [p.pair_id for p in dep.pairs])
        real[f"{router} f32 QWEN_CUT"] = counts
        rows[router] = dict(counts, equal=same)
        if not same:
            problems.append(router)
    emit({"phase": "fleet", "check": "fleet_cluster f32 QWEN_CUT == target "
          "greedy under both routers", "routers": rows,
          "seconds": time.perf_counter() - t0})
    if problems:
        fail(f"fleet f32: tokens differ from greedy under {problems}")
    return dict(kernels.LAUNCHES)


def fleet_shed(torch, np, kernels, dep, greedy: dict) -> dict:
    """SLO shedding at QWEN_CUT (f32): the spec's trace grown to 16
    requests with the chat class's TTFT SLO at 1 ms, smart router,
    ``slo_admission="shed"`` after 2 retirements per pair. Shed rows carry
    no tokens, served rows equal greedy, shed + served == submitted, and
    ``slo_report`` counts every shed row."""
    from repro_torch.fleet import SmartPairRouter
    from repro_torch.serving import SpecDecodeServer
    t0 = time.perf_counter()
    spec = dataclasses.replace(dep.spec)
    spec.workload = dataclasses.replace(spec.workload)
    trace = spec.workload.trace = dataclasses.replace(
        spec.workload.trace, num_requests=FLEET_SHED_REQUESTS,
        classes=[dataclasses.replace(c) for c in
                 spec.workload.trace.classes])
    for c in trace.classes:
        if c.name == "chat":
            c.slo_ttft_ms = FLEET_SHED_SLO_MS
    reqs = _spec_requests(spec.validate(), dep.vocab)
    _fleet_greedy(torch, dep, greedy, reqs)
    kernels.reset_launches()
    srv = SpecDecodeServer(cfg=dep.server_config(slo_admission="shed",
                                                 slo_min_samples=2),
                           pairs=dep.pairs, router=SmartPairRouter())
    for r in reqs:
        srv.submit(dataclasses.replace(r))
    res = srv.run()
    by_id = {r.request_id: r for r in reqs}
    shed = [r for r in res if r.shed]
    served = [r for r in res if not r.shed]
    rep = slo_of(res)
    reported = sum(pc["shed"] for pc in rep["per_class"].values())
    empty = all(len(r.tokens) == 0 for r in shed)
    same = all(np.array_equal(r.tokens, greedy[(
        by_id[r.request_id].prompt.tobytes(),
        by_id[r.request_id].max_new_tokens)]) for r in served)
    emit({"phase": "fleet", "check": "SLO shedding f32 QWEN_CUT",
          "submitted": len(reqs), "shed": len(shed), "served": len(served),
          "shed_by_class": {c: pc["shed"] for c, pc in
                            rep["per_class"].items()},
          "shed_by_pair": {p: row["shed"] for p, row in
                           srv.pair_summaries().items()},
          "attainment": rep["attainment"], "shed_rows_empty": empty,
          "served_equal_greedy": same,
          "seconds": time.perf_counter() - t0})
    if not (shed and empty and same and reported == len(shed)
            and len(shed) + len(served) == len(reqs)
            and sorted(r.request_id for r in res) == sorted(by_id)):
        fail(f"fleet shed: shed {len(shed)} (reported {reported}), served "
             f"{len(served)} of {len(reqs)}, empty {empty}, equal {same}")
    return dict(kernels.LAUNCHES)


def fleet_elastic(torch, np, card) -> dict:
    """An elastic pool of cluster_2pair_procs.json's first process pair in
    f32 at QWEN_CUT, one to two pairs, a 12-request burst at t = 0 (more
    than ``scale_up_depth`` × capacity per pair): at least one scale-up,
    every request served == target greedy, every host process gone after
    ``shutdown``. Returns the hosts' launch counts."""
    from repro_torch.fleet import ElasticPairPool
    from repro_torch.models.model import build_model
    from repro_torch.topology import ClusterSpec, node_configs, node_seed
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    spec = ClusterSpec.load(str(ROOT / "examples"
                                / "cluster_2pair_procs.json"))
    spec.workload.num_requests = ELASTIC_REQUESTS
    cfgs = _cut_f32(("qwen3-14b", "qwen2.5-3b"))
    template = spec.pairs[0]
    t_cfg = node_configs(spec, cfgs)[template.target]
    reqs = _spec_requests(spec, t_cfg.vocab)
    target = build_model(t_cfg, dev)
    params = target.init_params(node_seed(spec, template.target))
    greedy = {r.request_id: _greedy(torch, target, params, r.prompt,
                                    r.max_new_tokens, 96, dev)[0]
              for r in reqs}
    del target, params
    torch.cuda.empty_cache()
    startup = []

    def spawn(pair_spec):
        t = time.perf_counter()
        handle = pool._default_spawn(pair_spec)
        startup.append(time.perf_counter() - t)
        return handle

    pool = ElasticPairPool(spec, min_pairs=1, max_pairs=2,
                           model_configs=cfgs, spawn_fn=spawn,
                           device="cuda")
    try:
        t1 = time.perf_counter()
        res = pool.run(reqs)
        wall = time.perf_counter() - t1
        summ = pool.summary()
        rows = {pid: h.summary() for pid, h in pool.handles.items()}
    finally:
        pool.shutdown()
    alive = [pid for pid, h in pool.handles.items()
             if any(p.poll() is None for p in h.procs)]
    same = (sorted(r.request_id for r in res) == sorted(greedy)
            and all(np.array_equal(r.tokens, greedy[r.request_id])
                    for r in res))
    emit({"phase": "fleet", "run": "elastic pool f32 QWEN_CUT", "card": card,
          "events": summ["events"], "pairs_spawned": summ["pairs_spawned"],
          "startup_s": startup, "served": summ["served"],
          "max_concurrent_pairs": summ["max_concurrent_pairs"],
          "wall_s": wall, "equal_greedy": same, "hosts_alive": alive,
          "seconds": time.perf_counter() - t0})
    if summ["pairs_spawned"] < 2 or not same or alive:
        fail(f"fleet elastic: spawned {summ['pairs_spawned']}, equal "
             f"{same}, hosts alive {alive}")
    totals: dict = {}
    for row in rows.values():
        for side in ("target_launches", "draft_launches"):
            _add(totals, row[side])
    return totals


def fleet_sim(real: dict) -> None:
    """DSD-Sim on fleet_cluster.json under both pair routers: lane counts
    and SLO-bearing requests on the LAN lane, beside the real runs'
    per-pair counts (the order bench_fleet compares; printed only)."""
    from repro_torch.topology import ClusterSpec, build_simulation
    spec = ClusterSpec.load(str(FLEET_JSON))
    ids = [p.id for p in spec.pairs]
    sim = {}
    for router in ("smart", "least-loaded"):
        an = build_simulation(spec, pair_router=router).run()
        counts = {"requests": {p: 0 for p in ids},
                  "slo_bearing": {p: 0 for p in ids}}
        for m in an.requests.values():
            counts["requests"][ids[m.drafter_id]] += 1
            if m.slo_ttft_ms > 0 or m.slo_tpot_ms > 0:
                counts["slo_bearing"][ids[m.drafter_id]] += 1
        sim[router] = dict(counts, attainment=an.summary()["slo"][
            "attainment"])
    lan = ids[0]
    more = {"sim": sim["smart"]["slo_bearing"][lan]
            > sim["least-loaded"]["slo_bearing"][lan],
            "real f32": real["smart f32 QWEN_CUT"]["slo_bearing"][lan]
            > real["least-loaded f32 QWEN_CUT"]["slo_bearing"][lan]}
    emit({"phase": "fleet", "check": "sim beside real (printed, not gated)",
          "sim": sim, "real": real, "smart_more_slo_on_lan": more})


# ------------------------------------------------------------------- train

TRAIN_KERNELS = ("ssd_scan", "ssd_scan_bwd")
# (model whose SSM widths, B, S, nh, hd, N, dt scale) of the gradient
# checks: one chunk, many, and a length that is no multiple of 64; then
# Σ A·dt far above 88 inside a 64-token chunk (dt 8× softplus: the
# reference's own gradient overflows there, the kernel's every exp is of a
# range sum ≤ 0), an odd S of one chunk (one launch, rows cut at 37), and
# the shapes the training runs and SSD_BWD_TIMED give it, whose heads per
# block (8 at both training shapes, 2 at zamba2_verify's one chunk) no
# smaller case reaches; check_ssd_bwd fails if a timed shape's
# configuration is checked at none
SSD_BWD_CASES = tuple(
    (name, B, S, nh, hd, N, 1.0)
    for name, nh, hd, N in (("zamba2-1.2b", 64, 64, 64),
                            ("mamba2-130m", 24, 64, 128))
    for B, S in ((2, 64), (2, 512), (1, 2048), (2, 1001))) + (
    ("mamba2-130m", 2, 200, 24, 64, 128, 8.0),
    ("zamba2-1.2b", 3, 37, 64, 64, 64, 1.0),
    ("mamba2-130m", 8, 1024, 24, 64, 128, 1.0),
    ("zamba2-1.2b", 4, 1024, 64, 64, 64, 1.0),
    ("zamba2-1.2b", 4, 9, 64, 64, 64, 1.0))
SSD_BWD_OVERFLOW = 88.0   # |Σ A·dt| in a chunk past which exp(−Σ) overflows
# per gradient, |kernel − plain| ≤ share·(max|plain| + |plain|): float32,
# two f32 algorithms in another order (the kernel's split-TF32 products and
# rectangle sums, the plain chunked einsums and autograd); bfloat16 adds
# one rounding of dx/dB/dC to
# bf16 on each side (2⁻⁸ relative)
SSD_BWD_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
GRAD_NAMES = ("dx", "dBm", "dCm", "ddt", "dA", "dh_in")
# (label, B, S, nh, hd, N) of the timed ssd_scan_bwd calls (bf16): B5's
# three kernel-table shapes, then the two training shapes of this phase
SSD_BWD_TIMED = (("zamba2_verify", 4, 9, 64, 64, 64),
                 ("zamba2_prefill", 4, 48, 64, 64, 64),
                 ("s4096", 2, 4096, 24, 64, 128),
                 ("mamba2_train", 8, 1024, 24, 64, 128),
                 ("zamba2_train", 4, 1024, 64, 64, 64))
# the full training runs: (arch, batch, seq, steps, layers or None, peak
# lr; the launcher's cosine schedule warms up over 20 steps); the runs of
# TRAIN_PROFILED profile one more step after the timed ones
TRAIN_PROFILED = ("mamba2-130m", "zamba2-1.2b")
TRAIN_RUNS = (("mamba2-130m", 8, 1024, 30, None, 1e-3),
              ("zamba2-1.2b", 4, 1024, 10, None, 3e-4),
              ("qwen2.5-3b", 4, 1024, 6, QWEN_CUT["qwen2.5-3b"], 3e-4))
# parity: 2 layers a side in float32 (zamba2: one segment of 2 Mamba2
# layers and the shared block), B 1 × S 128 (two B5 chunks), 3 steps
PARITY_CFGS = (("mamba2-130m", dict(n_layers=2)),
               ("zamba2-1.2b", dict(n_layers=2, attn_every=2)))
PARITY_SHAPE = (1, 128)
PARITY_LR = 1e-4
# card against CPU, float32: gradients per leaf |Δ| ≤ 1e-3·(max|g| + |g|)
# (sum orders, B5's split-TF32 products against the CPU's f32 einsums);
# losses rtol 1e-4; the 3 steps' parameter update p − p0 within 1e-2 of
# its norm (‖Δcard − Δcpu‖ ≤ 1e-2·‖Δcpu‖ over all leaves): AdamW moves an
# element by ±lr whatever its gradient's size, so an element whose
# gradient sits at rounding level may move the other way on the other
# device; its share of the update's norm is what stays small
PARITY_GRAD_TOL = 1e-3
PARITY_LOSS_RTOL = 1e-4
PARITY_UPDATE_RTOL = 1e-2
WCDNN_PREDICT_TOL = 1e-5
# the dryrun phase's real steps on the card (arch, InputShape fields): they
# fit one H100 at the host mesh; the meta estimate of each within
# DRYRUN_TOL of the measured peak
DRYRUN_CARD = (("mamba2-130m", ("train_b8_s1024", 1024, 8, "train")),
               ("qwen2.5-3b", ("prefill_8k", 8192, 1, "prefill")),
               ("qwen2.5-3b", ("decode_32k_b16", 32768, 16, "decode")))
DRYRUN_TOL = 0.15
# the meta rows run as four ``python -m repro_torch.launch.dryrun``
# children side by side, the archs grouped so that the groups take about
# as long (zamba2's hybrid and whisper's encoder are traced at three
# depths each)
DRYRUN_GROUPS = (("zamba2-1.2b",),
                 ("whisper-tiny", "mamba2-130m", "qwen2.5-3b"),
                 ("arctic-480b", "deepseek-7b", "internvl2-76b"),
                 ("llama4-maverick-400b-a17b", "qwen3-14b",
                  "command-r-plus-104b"))
DRYRUN_KERNELS = ("decode_attn", "ssd_scan", "ssd_scan_bwd")
# the examples phase: (script, its shrinking flags, text its output holds)
EXAMPLES = (("quickstart_torch.py", ["--requests", "4", "--max-new", "16",
                                     "--sim-requests", "40"], "awc"),
            ("edge_cloud_serving_torch.py", ["--requests", "4",
                                             "--max-new", "8"],
             "(kernel on cuda:0) == reference rule: True"),
            ("capture_traces_torch.py", ["--requests", "4", "--max-new",
                                         "16"], "replayed through DSD-Sim"))


def ssd_bwd_bound(B, S, nh, hd, N, esize):
    """The least time of the scan's gradient: bytes (x/B/C and dx/dB/dC
    once in their type, dy, dt, ddt, A, dA and h_in/dh_out/dh_in once in
    f32) over the HBM rate, against twice the chunked forward's
    multiply-adds (:func:`ssd_bound`, chunk 64) over the bf16 tensor
    rate."""
    by = (esize * 2 * (B * S * nh * hd + 2 * B * S * N)
          + 4 * B * S * nh * hd + 4 * 2 * B * S * nh + 4 * 2 * nh
          + 4 * 3 * B * nh * hd * N)
    flops = 0
    for c0 in range(0, S, 64):
        L = min(64, S - c0)
        flops += 2 * B * (2 * L * L * N + nh * (4 * L * hd * N
                                                + L * (L + 1) * hd))
    t_b, t_o = by / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def ssd_bwd_inputs(torch, gen, dev, B, S, nh, hd, N, dtype, dt_scale=1.0):
    """:func:`ssd_inputs` (nonzero h_in), dt scaled by ``dt_scale``, and
    dy, dh_out ~ N(0, 1) f32."""
    x, Bm, Cm, dt, A, h0 = ssd_inputs(torch, gen, dev, B, S, nh, hd, N,
                                      dtype)
    dy = torch.randn((B, S, nh, hd), generator=gen, device=dev)
    dh = torch.randn((B, nh, hd, N), generator=gen, device=dev)
    return x, Bm, Cm, (dt_scale * dt).contiguous(), A, h0, dy, dh


def chunk_decay_max(torch, dt, A) -> float:
    """The largest |Σ A·dt| over one 64-token chunk of any (b, head)."""
    B, S, nh = dt.shape
    pad = (-S) % 64
    a = torch.nn.functional.pad(dt * A, (0, 0, 0, pad))
    return float(a.reshape(B, -1, 64, nh).sum(2).abs().max())


def ssd_bwd_config(torch, B, S, nh, hd, N, dtype) -> tuple:
    """What an ``ssd_scan_bwd`` call's code depends on: (hd, N, dtype, heads
    per block after the kernel's shared-memory clamp, one chunk or more)."""
    from repro_torch.kernels import dtype_code, library
    from repro_torch.kernels.ssd.ssd import bwd_heads_per_block
    # reads the kernel's configuration entries, launches nothing
    lib = library()  # noqa: DSD004
    nch = -(-S // lib.ssd_scan_chunk())
    hg = lib.ssd_scan_bwd_heads(hd, N, dtype_code(dtype),
                                bwd_heads_per_block(B, nch, nh))
    return hd, N, str(dtype)[6:], hg, nch <= 1


def check_ssd_bwd(torch, gen, dev) -> tuple:
    """``ssd_scan_bwd`` (its wrapper) against the plain backward (autograd
    of the chunked plain scan) on the same card tensors, TF32 off, at
    SSD_BWD_CASES in f32 and bf16: every gradient finite, of the input's
    shape and type, within SSD_BWD_TOL, and bit-identical in a second call
    on the same inputs (fixed sum order, no float atomics); the overflow
    case's inputs really pass SSD_BWD_OVERFLOW, and every configuration
    (:func:`ssd_bwd_config`) of SSD_BWD_TIMED is among the checked ones.
    Returns the largest share
    of the tolerance used and the largest |kernel − plain| of any gradient;
    prints each case's largest error per gradient."""
    from repro_torch.kernels.ssd import ssd_bwd_call, ssd_chunked_plain_bwd
    worst, top, rows, checked = 0.0, 0.0, [], set()
    for name, B, S, nh, hd, N, scale in SSD_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            conf = ssd_bwd_config(torch, B, S, nh, hd, N, dtype)
            checked.add(conf)
            ins = ssd_bwd_inputs(torch, gen, dev, B, S, nh, hd, N, dtype,
                                 scale)
            decay = chunk_decay_max(torch, ins[3], ins[4])
            if scale != 1.0 and not decay > SSD_BWD_OVERFLOW:
                fail(f"ssd_scan_bwd {name} S {S}: the overflow case's "
                     f"largest |Σ A·dt| in a chunk is {decay:.1f}")
            got = ssd_bwd_call(*ins)
            again = ssd_bwd_call(*ins)
            want = ssd_chunked_plain_bwd(*ins, 64)
            torch.cuda.synchronize()
            for gname, a_, b_ in zip(GRAD_NAMES, got, again):
                if not torch.equal(a_, b_):
                    fail(f"ssd_scan_bwd {name} S {S} {dtype}: {gname} "
                         "differs between two calls on the same inputs")
            share = SSD_BWD_TOL[str(dtype)[6:]]
            errs = {}
            for gname, a_, b_, x_ in zip(GRAD_NAMES, got, want, ins):
                if a_.shape != x_.shape or a_.dtype != x_.dtype:
                    fail(f"ssd_scan_bwd {name} S {S} {dtype}: {gname} is "
                         f"{a_.dtype} {tuple(a_.shape)}")
                a_, b_ = a_.float(), b_.float()
                if not torch.isfinite(a_).all():
                    fail(f"ssd_scan_bwd {name} S {S} {dtype}: {gname} "
                         "not finite")
                if not torch.isfinite(b_).all():
                    fail(f"ssd_scan_bwd {name} S {S} {dtype}: the plain "
                         f"backward's {gname} is not finite")
                d = (a_ - b_).abs()
                lim = share * (float(b_.abs().max()) + b_.abs())
                used = float((d / lim).max())
                if not used <= 1.0:
                    fail(f"ssd_scan_bwd {name} S {S} {dtype}: {gname} "
                         f"max |err| {float(d.max()):.3e} over "
                         f"{share}·(max|plain| + |plain|)")
                worst = max(worst, used)
                errs[gname] = float(d.max())
                top = max(top, errs[gname])
            rows.append({"ssm": name, "B": B, "S": S, "nh": nh, "hd": hd,
                         "N": N, "dt_scale": scale, "heads_per_block":
                         conf[3], "max_chunk_decay": decay,
                         "dtype": str(dtype)[6:], "max_abs_err": errs})
            del ins, got, again, want
    for label, B, S, nh, hd, N in SSD_BWD_TIMED:
        conf = ssd_bwd_config(torch, B, S, nh, hd, N, torch.bfloat16)
        if conf not in checked:
            fail(f"ssd_scan_bwd: {label}'s configuration {conf} (hd, N, "
                 "dtype, heads per block, one chunk) is timed but checked "
                 "at no case of SSD_BWD_CASES")
    emit({"phase": "train", "check": "ssd_scan_bwd == plain backward",
          "cases": rows, "tolerance": {k: f"{v}·(max|plain| + |plain|)"
                                       for k, v in SSD_BWD_TOL.items()},
          "tolerance_share_used": worst, "h_in": "nonzero",
          "dh_out": "nonzero", "allow_tf32": False,
          "two_calls_bit_identical": True})
    return worst, top


def time_ssd_bwd(torch, gen, dev) -> dict:
    """``ssd_scan_bwd`` at SSD_BWD_TIMED (bf16): device time by CUDA-graph
    replay (a few calls per graph at the training shapes, whose scratch is
    ~0.2 GB a call), beside B5's forward on the same inputs, the state
    recompute alone (B5's phases 1–2, the backward's phase 0; none for one
    chunk) and its share of the call, the plain backward (eager: autograd)
    and the bound; no PyTorch call computes it (``library_ms`` null); at
    the training shapes the device ms of each kernel of a call
    (:func:`ssd_bwd_breakdown`)."""
    from repro_torch.kernels.ssd import (ssd_bwd_call, ssd_bwd_states,
                                         ssd_call, ssd_chunked_plain_bwd)
    out = {}
    for label, B, S, nh, hd, N in SSD_BWD_TIMED:
        ins = ssd_bwd_inputs(torch, gen, dev, B, S, nh, hd, N,
                             torch.bfloat16)
        small = S <= 64
        bound, by = ssd_bwd_bound(B, S, nh, hd, N, 2)
        ms = graph_ms(torch, lambda: ssd_bwd_call(*ins),
                      iters=20 if small else 2, replays=5 if small else 3)
        states_ms = 0.0 if small else graph_ms(
            torch, lambda: ssd_bwd_states(*ins[:6]), iters=2, replays=3)
        out[label] = {
            "shape": {"B": B, "S": S, "nh": nh, "hd": hd, "N": N,
                      "dtype": "bfloat16"},
            "ms": ms, "state_recompute_ms": states_ms,
            "state_recompute_share": states_ms / ms,
            "forward_ms": graph_ms(torch, lambda: ssd_call(*ins[:6]),
                                   iters=20 if small else 2,
                                   replays=5 if small else 3),
            "plain_ms": cuda_ms(torch, lambda: ssd_chunked_plain_bwd(
                *ins, 64), iters=5 if small else 2, warmup=1),
            "library_ms": None, "bound_ms": bound, "bound_by": by}
        del ins
        torch.cuda.empty_cache()
    train = [(label, shape) for label, *shape in SSD_BWD_TIMED
             if label.endswith("_train")]
    for (label, _), parts in zip(train, ssd_bwd_breakdown(
            [shape for _, shape in train])):
        out[label]["breakdown"] = parts
    return out


# the kernels of one multi-chunk ssd_scan_bwd call, in launch order
SSD_BWD_PARTS = ("recompute: chunk states", "recompute: pass", "dstates",
                 "reverse pass", "gradients", "sums of dB, dC, dA")


def ssd_bwd_breakdown(shapes, calls: int = 3) -> list:
    """:func:`ssd_bwd_profile` of each of ``shapes`` (B, S, nh, hd, N), in
    one fresh process: in this one, after the phases that profile
    CUDA-graph replays, the profiler came back without some or all of the
    calls' kernel events (3 of 18 missing after phase ``capture``, all 18
    after every phase). The child loads the library this process built."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; print(json.dumps([chip_smoke.ssd_bwd_profile("
            "tuple(s), int(sys.argv[3])) for s in json.loads(sys.argv[2])]))")
    try:
        out = subprocess.run([sys.executable, "-c", code, str(ROOT),
                              json.dumps([list(s) for s in shapes]),
                              str(calls)],
                             capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail(f"ssd_scan_bwd breakdown at {shapes}: no answer in 300 s")
    if out.returncode:
        fail(f"ssd_scan_bwd breakdown at {shapes}: exit {out.returncode}: "
             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def ssd_bwd_profile(shape, calls: int) -> dict:
    """Device ms per kernel of ``calls`` ``ssd_scan_bwd`` calls of more
    than one chunk on :func:`ssd_bwd_inputs` (bf16, seed 0) of ``shape``
    (torch.profiler, CPU and CUDA activity, kernels taken in launch order
    as SSD_BWD_PARTS), and each part's share of their sum; where the
    kernel events do not come in that order, the device ms per kernel name
    instead (dstates and gradients share one)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd import ssd_bwd_call
    dev = torch.device("cuda")
    ins = ssd_bwd_inputs(torch, torch.Generator(device=dev).manual_seed(0),
                         dev, *shape, torch.bfloat16)
    cuda = torch.autograd.DeviceType.CUDA
    ssd_bwd_call(*ins)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ssd_bwd_call(*ins)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == cuda]
    if len(ev) != calls * len(SSD_BWD_PARTS):
        by_name = {}
        for e in prof.key_averages():
            if e.device_type == cuda:
                t = getattr(e, "self_device_time_total", None)
                if t is None:
                    t = getattr(e, "self_cuda_time_total", 0.0)
                by_name[e.key[:70]] = t / 1e3 / calls
        return {"kernel_events": len(ev), "ms_by_kernel_name": by_name}
    ms = {p: 0.0 for p in SSD_BWD_PARTS}
    for i, e in enumerate(ev):
        ms[SSD_BWD_PARTS[i % len(SSD_BWD_PARTS)]] += \
            e.time_range.elapsed_us() / 1e3 / calls
    total = sum(ms.values())
    return {"ms": ms, "share": {p: v / total for p, v in ms.items()},
            "total_ms": total}


def train_parity(torch, kernels, card) -> None:
    """Float32, 2 layers a side: from the same weights, the gradient of the
    first batch's loss and 3 AdamW steps of the port's train step on the
    card (B5 forward, ``ssd_scan_bwd`` backward) against the same on the
    CPU (the plain scan and autograd), for the ssm and the hybrid family.
    Every Mamba2 leaf of every layer has a nonzero gradient on the card
    and equals the CPU's within PARITY_GRAD_TOL; losses and parameters
    after 3 steps within PARITY_LOSS_RTOL / PARITY_UPDATE_RTOL (the card's
    ``ssd_scan_bwd`` launches per gradient: one per Mamba2 layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM,
                                      init_train_state, make_loss_fn,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_step import trainable
    cpu = torch.device("cpu")
    for name, over in PARITY_CFGS:
        cfg = dataclasses.replace(get_config(name), dtype="float32", **over)
        dev = torch.device("cuda", 0)
        models = {"cuda": build_model(cfg, dev), "cpu": build_model(cfg, cpu)}
        p0 = models["cuda"].init_params(0)
        params = {"cuda": p0, "cpu": tree_map(lambda t: t.cpu(), p0)}
        B, S = PARITY_SHAPE
        it = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, batch=B,
                                    seed=0)).batches()
        batches = [next(it) for _ in range(3)]
        grads = {}
        for side, model in models.items():
            d = dev if side == "cuda" else cpu
            p = trainable(params[side])
            batch = {k: torch.from_numpy(v).to(d)
                     for k, v in batches[0].items()}
            loss, _ = make_loss_fn(model)(p, batch)
            kernels.reset_launches()
            g = torch.autograd.grad(loss, tree_leaves(p))
            it_g = iter(g)
            grads[side] = tree_map(lambda _: next(it_g), p)
            if side == "cuda":
                n_bwd = kernels.LAUNCHES["ssd_scan_bwd"]
                if n_bwd != cfg.n_layers:
                    fail(f"parity {name}: ssd_scan_bwd launched {n_bwd} "
                         f"times for {cfg.n_layers} Mamba2 layers")
        zero, worst = [], 0.0
        for key, gc_ in grads["cuda"]["layers"]["ssm"].items():
            gp = grads["cpu"]["layers"]["ssm"][key]
            for l in range(cfg.n_layers):
                if not bool((gc_[l] != 0).any()):
                    zero.append(f"layers.ssm.{key}[{l}]")
        if zero:
            fail(f"parity {name}: zero gradient on the card for {zero}")
        for (kc, a_), b_ in zip(_paths(grads["cuda"]),
                                tree_leaves(grads["cpu"])):
            d = (a_.cpu().float() - b_.float()).abs()
            lim = PARITY_GRAD_TOL * (float(b_.abs().max()) + b_.abs())
            used = float((d / lim.clamp_min(1e-30)).max())
            if not used <= 1.0:
                fail(f"parity {name}: gradient {kc} card vs CPU max |err| "
                     f"{float(d.max()):.3e}")
            worst = max(worst, used)
        opt = AdamWConfig(lr=PARITY_LR)
        losses, finals = {}, {}
        for side, model in models.items():
            d = dev if side == "cuda" else cpu
            st = init_train_state(model, 0, opt, params=tree_map(
                lambda t: t.clone(), params[side]))
            step = make_train_step(model, opt)
            ls = []
            for b in batches:
                st, m = step(st, {k: torch.from_numpy(v).to(d)
                                  for k, v in b.items()})
                ls.append(float(m["loss"]))
            losses[side], finals[side] = ls, st.params
        for a_, b_ in zip(losses["cuda"], losses["cpu"]):
            if abs(a_ - b_) > PARITY_LOSS_RTOL * abs(b_):
                fail(f"parity {name}: losses {losses['cuda']} card vs "
                     f"{losses['cpu']} CPU")
        num = den = pmax = 0.0
        for a_, b_, c_ in zip(tree_leaves(finals["cuda"]),
                              tree_leaves(finals["cpu"]),
                              tree_leaves(params["cpu"])):
            d = a_.detach().cpu().double() - b_.detach().double()
            num += float(d.square().sum())
            den += float((b_.detach().double() - c_.double()).square().sum())
            pmax = max(pmax, float(d.abs().max()))
        rel = math.sqrt(num / den)
        if not rel <= PARITY_UPDATE_RTOL:
            fail(f"parity {name}: the 3 steps' update differs by {rel:.3e} "
                 f"of its norm (card vs CPU)")
        emit({"phase": "train", "check": f"parity {name} f32, card == CPU",
              "card": card, "layers": cfg.n_layers, "batch": B, "seq": S,
              "mamba2_leaves_nonzero": sorted(grads["cuda"]["layers"]["ssm"]),
              "grad_tolerance": f"{PARITY_GRAD_TOL}·(max|g| + |g|)",
              "grad_tolerance_share_used": worst,
              "losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
              "loss_rtol": PARITY_LOSS_RTOL,
              "update_rel_diff": rel, "update_rtol": PARITY_UPDATE_RTOL,
              "param_max_abs_diff": pmax, "lr": PARITY_LR})
        del models, params, grads, finals
        torch.cuda.empty_cache()


def _paths(tree, prefix=""):
    """(dotted path, leaf) in tree_leaves order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def train_runs(torch, kernels, card) -> dict:
    """The published configs through ``repro_torch.launch.train --full
    --device cuda`` in bf16 (TRAIN_RUNS): loss falls, ``ssd_scan`` =
    steps·L·(2 under remat: the checkpointed layer's forward re-runs in
    the backward pass) and ``ssd_scan_bwd`` = steps·L for the L Mamba2
    layers, no other kernel; s/step (steps after the first), tokens/s and
    peak memory printed. The TRAIN_PROFILED runs then profile one more step
    (torch.profiler, CPU and CUDA activity): :func:`train_step_profile`.
    That step is in no count or time above."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    totals = {k: 0 for k in kernels.LAUNCHES}

    def profiled(arch, out):
        def after(one_step):
            out["launches"] = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                one_step()
            out["wall_s"] = time.perf_counter() - t0
            out["prof"] = prof
        return after if arch in TRAIN_PROFILED else None
    for arch, B, S, steps, layers, lr in TRAIN_RUNS:
        argv = ["--arch", arch, "--full", "--device", "cuda", "--batch",
                str(B), "--seq", str(S), "--steps", str(steps), "--lr",
                str(lr), "--log-every", str(steps)]
        t0 = time.perf_counter()
        if layers:
            argv += ["--layers", str(layers)]
        kernels.reset_launches()
        prof = {}
        s = launcher.run(launcher.parse_args(argv),
                         after_steps=profiled(arch, prof))
        launches = prof.get("launches", dict(kernels.LAUNCHES))
        cfg = get_config(arch)
        L = layers or cfg.n_layers
        mamba = L if cfg.arch_type in ("ssm", "hybrid") else 0
        want = {k: 0 for k in kernels.LAUNCHES}
        want["ssd_scan"] = steps * mamba * (2 if s["remat"] else 1)
        want["ssd_scan_bwd"] = steps * mamba
        if launches != want:
            fail(f"train {arch}: launches {launches}, want {want}")
        first, last = s["losses"][0], s["losses"][-1]
        if not all(math.isfinite(l) for l in s["losses"]) or last >= first:
            fail(f"train {arch}: loss {s['losses']} does not fall")
        _add(totals, launches)
        emit({"phase": "train", "run": f"{arch} bf16 --full", "card": card,
              "layers": L, "d_model": s["d_model"], "params": s["params"],
              "batch": B, "seq": S, "steps": steps, "lr": lr,
              "seconds": time.perf_counter() - t0,
              "remat": s["remat"], "first_loss": first, "last_loss": last,
              "losses": s["losses"], "first_step_s": s["first_step_s"],
              "s_per_step": s["s_per_step"],
              "tokens_per_s": s["tokens_per_s"],
              "peak_mem_gb": s["peak_mem_gb"],
              "launches": {k: v for k, v in launches.items() if v},
              "launch_formula": "ssd_scan = steps·L·(2 if remat), "
                                "ssd_scan_bwd = steps·L"})
        if "prof" in prof:
            emit({"phase": "train", "check": "profiled step",
                  "run": f"{arch} bf16 --full", "card": card,
                  **train_step_profile(torch, prof.pop("prof"),
                                       prof["wall_s"])})
        del s
        torch.cuda.empty_cache()
    return totals


def train_step_profile(torch, prof, wall_s: float, top: int = 15) -> dict:
    """One profiled training step: device ms of its kernels (CUDA events),
    the top kernels, and the top ops (aten ops and autograd nodes, CPU
    events) by the device time of the kernels each launched itself, each
    with its share of the step's device time; the busy share is device ms
    over the profiled wall (the profiler's host overhead included)."""
    cuda = torch.autograd.DeviceType.CUDA
    kern, ops = [], []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            (kern if ev.device_type == cuda else ops).append(
                (t / 1e3, ev.count, ev.key))
    device_ms = sum(r[0] for r in kern)

    def rows(xs):
        return [{"ms": ms, "calls": n, "share": ms / device_ms,
                 "name": name[:90]}
                for ms, n, name in sorted(xs, reverse=True)[:top]]
    return {"step_wall_s_profiled": wall_s, "device_ms": device_ms,
            "device_busy_share_profiled": device_ms / 1e3 / wall_s,
            "top_ops": rows(ops), "top_kernels": rows(kern)}


def train_draft_example(card) -> None:
    """``examples/train_draft_torch.py`` at its default sizes on the card:
    the trained draft's acceptance above the untrained one's (the example
    asserts it)."""
    import importlib.util
    path = ROOT / "examples" / "train_draft_torch.py"
    spec = importlib.util.spec_from_file_location("train_draft_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    out = mod.run(device="cuda")
    emit({"phase": "train", "run": "examples/train_draft_torch.py",
          "card": card, "seconds": time.perf_counter() - t0, **out,
          "acceptance_rise": out["acceptance_trained"]
          - out["acceptance_untrained"]})


def train_wcdnn(torch, card) -> None:
    """WC-DNN: ``core/awc/dataset.generate_dataset`` on
    ``default_grid(small=True)`` (host: DSD-Sim sweeps), then ``train`` on
    the card, saved to a temporary path; ``numpy_predictor`` of the trained
    parameters == ``forward`` on the card within WCDNN_PREDICT_TOL."""
    import tempfile
    import numpy as np
    from repro_torch.core.awc import dataset, model as wcdnn
    from repro_torch.core.awc.train import TrainConfig, train
    t0 = time.perf_counter()
    X, y, _ = dataset.generate_dataset(dataset.default_grid(small=True))
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, info = train(X, y, TrainConfig(epochs=40), device="cuda")
    t_train = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "wcdnn.npz")
        wcdnn.save(params, path)
        loaded = wcdnn.load(path)
    predict = wcdnn.numpy_predictor(loaded)
    with torch.no_grad():
        card_out = wcdnn.forward(params, torch.as_tensor(
            X, device="cuda")).cpu().numpy()
    host_out = np.asarray([predict(list(r)) for r in X])
    err = float(np.abs(card_out - host_out).max())
    if not err <= WCDNN_PREDICT_TOL:
        fail(f"wcdnn: numpy predictor vs card forward max |err| {err:.3e}")
    if not math.isfinite(info["val_mae"]):
        fail(f"wcdnn: val_mae {info['val_mae']}")
    if Path(wcdnn.DEFAULT_CKPT).exists():
        fail(f"wcdnn: {wcdnn.DEFAULT_CKPT} exists: the default checkpoint "
             "must not be written")
    emit({"phase": "train", "run": "wcdnn", "card": card,
          "rows": int(len(X)), "dataset_s": t_data, "train_s": t_train,
          "epochs": 40, "train_l1": info["train_l1"],
          "val_mae": info["val_mae"], "numpy_vs_card_max_abs_err": err,
          "tolerance": WCDNN_PREDICT_TOL, "saved_to": "a temporary path"})


def phase_train(torch, kernels) -> tuple:
    """Training (the slice of PR 23): B5's gradient kernel against the plain
    backward and timed, the f32 card == CPU parity of 3 train steps, the
    published mamba2-130m, zamba2-1.2b (and qwen2.5-3b at QWEN_CUT depth)
    trained through ``launch.train``, the torch ``train_draft`` example and
    WC-DNN. Returns (the launch counts of the ``launch.train`` runs, the
    main path; errors; times)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    card = smi_line()
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    share, top = check_ssd_bwd(torch, gen, dev)
    err = {"ssd_scan_bwd": top, "ssd_scan_bwd_share": share}
    lap("grad_check")
    times = time_ssd_bwd(torch, gen, dev)
    emit({"phase": "train_kernel_times", "card": card, **times})
    lap("grad_times")
    train_parity(torch, kernels, card)
    lap("parity")
    totals = train_runs(torch, kernels, card)
    lap("runs")
    train_draft_example(card)
    lap("draft")
    train_wcdnn(torch, card)
    lap("wcdnn")
    emit({"phase": "train", "seconds": seconds})
    return totals, err, times


def meta_rows() -> tuple:
    """``python -m repro_torch.launch.dryrun`` over DRYRUN_GROUPS, one child
    a group, side by side: (the rows, their seconds)."""
    import os
    import tempfile
    t0 = time.perf_counter()
    # the meta rows need no card, so none is visible to them (a child's
    # first train row, 9–12 s on the H100 host either way, is mostly its
    # first import of torch._dynamo, under the live-bytes mode)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rows{i}.jsonl"
                for i in range(len(DRYRUN_GROUPS))]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             ",".join(g), "--shape", "all", "--mesh", "single,multi",
             "--out", str(out)], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for g, out in zip(DRYRUN_GROUPS, outs)]
        try:
            for g, p, out in zip(DRYRUN_GROUPS, procs, outs):
                text, _ = p.communicate(timeout=600)
                print(text, end="", flush=True)
                if p.returncode != 0:
                    fail(f"dryrun CLI over {g} exited {p.returncode}")
                rows += [json.loads(l) for l in out.read_text().splitlines()]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return rows, time.perf_counter() - t0


def dryrun_attention(torch, card) -> dict:
    """B1 at the shapes the dryrun phase's qwen2.5-3b steps give it (Hkv 2,
    G 8, hd 128, bf16 — the cache's dtype): a prefill window of 1024
    queries over the 8320-slot cache, first (7 of 8 windows' keys not
    written yet, pos −1) and last, and the decode step over 16 × 32768
    slots with every slot written and with only its own (as the step
    after a fresh cache has it). Each against the single-pass plain
    version and the split plain of the kernel's own plan, within the
    phase_kernels bf16 tolerance. Not counted as main-path launches (the
    counts are reset after)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import (
        decode_attn_call, decode_attention_grouped, decode_attention_split,
        split_plan)
    from repro_torch.launch.dryrun import PREFILL_CHUNK
    cfg = get_config("qwen2.5-3b")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // Hkv
    dtype = torch.bfloat16
    tol = dict(atol=2e-2, rtol=2e-2)
    prefill = DRYRUN_CARD[1][1][1]
    decode = DRYRUN_CARD[2][1]
    chunk = PREFILL_CHUNK
    cases = []
    for w in (0, prefill // chunk - 1):     # (B, T, S, written, q_pos 0)
        cases.append((f"prefill window {w}", 1, chunk, prefill + 128,
                      (w + 1) * chunk, w * chunk))
    for written in (decode[1], 1):
        cases.append((f"decode {written} written", decode[2], 1, decode[1],
                      written, decode[1] - 1))
    err, rows = 0.0, []
    for label, B, T, S, written, q0 in cases:
        q = torch.randn((B, T, Hkv, G, hd), generator=gen,
                        device=dev).to(dtype)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).to(dtype)
        ar = torch.arange(S, device=dev, dtype=torch.int32)
        lo = S - written if written < S and T == 1 else 0
        pm = torch.where((ar >= lo) & (ar < lo + written), ar,
                         torch.full_like(ar, -1)).expand(B, S).contiguous()
        qp = (q0 + torch.arange(T, device=dev, dtype=torch.int32)
              ).expand(B, T).contiguous()
        split, n_split = split_plan(S, hd, dtype, Hkv)
        out = decode_attn_call(q, k, v, pm, qp)
        refs = (decode_attention_grouped(q, k, v, pm, qp),
                decode_attention_split(q, k, v, pm, qp, split))
        torch.cuda.synchronize()
        for ref in refs:
            try:
                torch.testing.assert_close(out.float(), ref.float(), **tol)
            except AssertionError as e:
                fail(f"dryrun B1 {label} (B {B}, T {T}, S {S}) vs plain: {e}")
        e = float((out.float() - refs[0].float()).abs().max())
        err = max(err, e)
        rows.append({"case": label, "B": B, "T": T, "S": S,
                     "splits": n_split, "max_abs_err": e})
        del q, k, v, out, refs
    torch.cuda.empty_cache()
    emit({"phase": "dryrun", "card": card,
          "check": "B1 at the real steps' shapes == plain and split plain",
          "Hkv": Hkv, "G": G, "hd": hd, "dtype": "bfloat16",
          "tolerance": tol, "cases": rows})
    return err


def phase_dryrun(torch, kernels) -> dict:
    """The meta dry-run over ASSIGNED × SHAPES × (single, multi) through its
    CLI, then the DRYRUN_CARD steps for real (module docstring, phase 15).
    Returns the real steps' launch counts (the main path)."""
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES, InputShape
    card = smi_line()
    if sorted(a for g in DRYRUN_GROUPS for a in g) != sorted(ASSIGNED):
        fail(f"DRYRUN_GROUPS must hold every assigned arch once: {ASSIGNED}")
    rows, meta_s = meta_rows()
    if len(rows) != len(ASSIGNED) * len(SHAPES) * 2 or not all(
            r["ok"] and r["collectives"] is None for r in rows):
        fail(f"dryrun: {len(rows)} rows, not all ok")
    emit({"phase": "dryrun", "meta_rows": len(rows),
          "rows_ok": sum(r["ok"] for r in rows),
          "rows_fit_80gib": sum(r["fits"] for r in rows),
          "not_fit": [[r["arch"], r["shape"], r["mesh"],
                       r["memory"]["peak_estimate_bytes"] / 2**30]
                      for r in rows if not r["fits"]],
          "collectives": "null in every row: " + dryrun.COLLECTIVES_NOTE,
          "meta_seconds": meta_s})
    dryrun_attention(torch, card)
    t0 = time.perf_counter()
    kernels.reset_launches()
    checks = []
    for arch, fields in DRYRUN_CARD:
        shape = InputShape(*fields)
        row = dryrun.run_one(arch, shape, "host", device="cuda")
        if not row["ok"]:
            fail(f"dryrun on the card, {arch} {shape.name}: {row['error']}")
        m = row["memory"]
        check = {"arch": arch, "shape": shape.name,
                 "estimate_bytes": m["peak_estimate_bytes"],
                 "measured_peak_bytes": row["measured_peak_bytes"],
                 "ratio": row["estimate_ratio"],
                 "estimate_parts": {k: m[k] for k in (
                     "argument_bytes", "output_bytes", "gradient_bytes",
                     "activation_bytes")},
                 "meta_flops": row["meta_flops"],
                 "model_flops": row["model_flops"],
                 "meta_over_model_flops": row["meta_flops"]
                 / row["model_flops"],
                 "trace_s": row["trace_s"], "run_s": row["run_s"],
                 "finite": row["finite"]}
        emit({"phase": "dryrun", "card": card, **check})
        if not row["finite"]:
            fail(f"dryrun on the card, {arch} {shape.name}: output not "
                 "finite")
        if not abs(row["estimate_ratio"] - 1.0) <= DRYRUN_TOL:
            fail(f"dryrun on the card, {arch} {shape.name}: estimate "
                 f"{m['peak_estimate_bytes']} B against a measured peak of "
                 f"{row['measured_peak_bytes']} B (ratio "
                 f"{row['estimate_ratio']:.3f}, limit ±{DRYRUN_TOL})")
        checks.append(check)
    launches = dict(kernels.LAUNCHES)
    # mamba2-130m: 24 layers, B5 twice a layer under remat and its
    # gradient once; qwen2.5-3b: 36 layers, 8 prefill windows and 1 decode
    mamba, qwen = get_config("mamba2-130m"), get_config("qwen2.5-3b")
    want = {"ssd_scan": 2 * mamba.n_layers, "ssd_scan_bwd": mamba.n_layers,
            "decode_attn": (8 + 1) * qwen.n_layers}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"dryrun card steps launched {got}, expected {want}")
    emit({"phase": "dryrun", "card": card, "launches": got,
          "card_seconds": time.perf_counter() - t0})
    return launches


def phase_examples() -> dict:
    """The three torch examples as child processes on the card, side by
    side (module docstring, phase 16)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = []
    for script, flags, _ in EXAMPLES:
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / script), *flags],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    runs = []
    try:
        for (script, flags, expect), p in zip(EXAMPLES, procs):
            out, _ = p.communicate(timeout=300)
            runs.append({"script": script, "flags": flags,
                         "rc": p.returncode,
                         "seconds_since_start": time.perf_counter() - t0,
                         "tail": out.strip().splitlines()[-4:]})
            if p.returncode != 0 or expect not in out:
                print(out, flush=True)
                fail(f"examples: {script} exited {p.returncode} (or "
                     f"printed no {expect!r})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    emit({"phase": "examples", "runs": runs,
          "seconds": time.perf_counter() - t0})
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = [p for p in ap.parse_args(argv).phases.split(",") if p]
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    seconds = {}
    t0 = time.perf_counter()
    info = phase_device(torch)
    from repro_torch import kernels
    if "build" in phases or "kernels" in phases:
        phase_build(kernels)
    seconds["device+build"] = time.perf_counter() - t0
    err, times = {}, {}
    t0 = time.perf_counter()
    if "kernels" in phases:
        err, times = phase_kernels(torch)
        seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if "exact" in phases:
        phase_exact(torch)
        seconds["exact"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if "capture" in phases:
        phase_capture(torch, kernels)
        seconds["capture"] = time.perf_counter() - t0
    totals, idle = {}, []
    t0 = time.perf_counter()
    if "distributed" in phases:
        dist_totals = phase_distributed(torch, kernels)
        idle += [k for k in DIST_KERNELS if not dist_totals[k]]
        _add(totals, dist_totals)
        seconds["distributed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if "serve" in phases:
        serve_totals = phase_serve(torch, kernels)
        idle += [k for k in SERVE_KERNELS if not serve_totals[k]]
        _add(totals, serve_totals)
        seconds["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if "exact_ssm" in phases:
        phase_exact_ssm(torch)
        seconds["exact_ssm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if "serve_ssm" in phases:
        ssm_totals = phase_serve_ssm(torch, kernels)
        idle += [k for k in SERVE_SSM_KERNELS if not ssm_totals[k]]
        for k, n in ssm_totals.items():
            totals[k] = totals.get(k, 0) + n
        seconds["serve_ssm"] = time.perf_counter() - t0
    for name, phase, main_path in (
            ("pipeline", phase_pipeline, PIPE_KERNELS),
            ("topology", phase_topology, TOPO_KERNELS),
            ("families", phase_families, FAMILY_KERNELS),
            ("fleet", phase_fleet, FLEET_KERNELS)):
        t0 = time.perf_counter()
        if name in phases:
            phase_totals = phase(torch, kernels)
            idle += [k for k in main_path if not phase_totals.get(k)]
            _add(totals, phase_totals)
            seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_t = {}
    if "train" in phases:
        train_totals, train_err, train_t = phase_train(torch, kernels)
        idle += [k for k in TRAIN_KERNELS if not train_totals.get(k)]
        _add(totals, train_totals)
        err.update(train_err)
        seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if "dryrun" in phases:
        dry_totals = phase_dryrun(torch, kernels)
        idle += [k for k in DRYRUN_KERNELS if not dry_totals.get(k)]
        _add(totals, dry_totals)
        seconds["dryrun"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if "examples" in phases:
        phase_examples()
        seconds["examples"] = time.perf_counter() - t0
    emit({"phase_seconds": seconds})
    csrc = "src/repro_torch/csrc/"
    replaces = {
        "decode_attn": (csrc + "decode_attn.cu",
                        "src/repro/kernels/decode_attn/decode_attn.py:38",
                        "_decode_attn_kernel"),
        "paged_decode_attn": (csrc + "paged_decode_attn.cu",
                              "src/repro/kernels/decode_attn/paged.py:39",
                              "_paged_decode_kernel"),
        "tree_argmax": (csrc + "tree_verify.cu",
                        "src/repro/kernels/verify/tree.py:34",
                        "tree_argmax_kernel"),
        "tree_accept": (csrc + "tree_verify.cu",
                        "src/repro/kernels/verify/tree.py:60",
                        "tree_accept_kernel"),
        "gather_reduce": (csrc + "sampled_verify.cu",
                          "src/repro/kernels/verify/verify.py:34",
                          "gather_reduce_kernel"),
        "cdf_sample": (csrc + "sampled_verify.cu",
                       "src/repro/kernels/verify/verify.py:70",
                       "cdf_sample_kernel"),
        "ssd_scan": (csrc + "ssd_scan.cu",
                     "src/repro/kernels/ssd/ssd.py:30", "_ssd_kernel"),
        # the reference has no backward kernel: it differentiates its jnp
        # scan (src/repro/models/ssm.py:127) inside jax.value_and_grad
        "ssd_scan_bwd": (csrc + "ssd_scan_bwd.cu",
                         "src/repro/kernels/ssd/ssd.py:30",
                         "none (gradient of _ssd_kernel's function)"),
    }
    slice_t, tree_t = times.get("slice", {}), times.get("tree", {})
    tree_t = dict(tree_t, **times.get("sampled", {}))
    ssd_t = times.get("ssd", {})
    if ssd_t:
        tree_t["ssd_scan"] = ssd_t["zamba2_verify"]
    rows = []
    for name, (src, tpu, tpu_fn) in replaces.items():
        t = (dict(slice_t[name], shape=slice_t["shape"]) if name in slice_t
             else tree_t.get(name, {}))
        if name == "ssd_scan_bwd":
            t = train_t.get("mamba2_train", {})
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": tpu, "tpu_kernel": tpu_fn,
               "launches": totals.get(name),
               "max_abs_err": err.get(name), "ms": t.get("ms"),
               "plain_ms": t.get("plain_ms"),
               "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
               "library_ms": t.get("library_ms"), "shape": t.get("shape")}
        if name in times.get("long", {}):
            row["long_context"] = times["long"][name]
        if name in ("decode_attn", "paged_decode_attn") and "attn" in times:
            row["shapes"] = {
                lbl: {kn: dict(t[kn], shape=t["shape"]) for kn in t
                      if kn.startswith(name)}
                for lbl, t in times["attn"].items() if name in t}
        if name == "ssd_scan" and ssd_t:
            row["long_context"] = ssd_t["s4096"]
            row["prefill"] = ssd_t["zamba2_prefill"]
        if name == "ssd_scan_bwd" and train_t:
            row["shapes"] = train_t
            row["tolerance_share_used"] = err.get("ssd_scan_bwd_share")
        if name in ("tree_argmax", "tree_accept"):
            # the served path runs B4a and B4b as one kernel, counted as
            # tree_verify; this row's own wrapper launches 0 times there
            row["launches"] = totals.get("tree_verify")
            row["counted_as"] = "tree_verify"
            row["standalone_launches"] = totals.get(name)
            if "tree_verify" in tree_t:
                row["fused_ms"] = tree_t["tree_verify"]["ms"]
                row["launch_floor_ms"] = tree_t["launch_floor_ms"]
            if name == "tree_accept" and "tree_verify" in tree_t:
                row["fused"] = dict(tree_t["tree_verify"],
                                    kernel="tree_verify_kernel")
        if name == "cdf_sample" and "cdf_sample_flagged" in err:
            # max_abs_err is in tokens; rows off by it lie at a CDF step
            row["flagged_at_cdf_step"] = err["cdf_sample_flagged"]
        if name == "decode_attn" and tree_t:
            row["max_abs_err"] = max(err["decode_attn"],
                                     err["decode_attn_tree"])
            row["tree_verify"] = tree_t["decode_attn_tree_verify"]
        if name == "decode_attn" and "hybrid_attn" in times:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     err["decode_attn_hybrid"])
            row["hybrid_verify"] = times["hybrid_attn"]
        rows.append(row)
    if idle:
        fail(f"kernels never launched on the main paths: {sorted(set(idle))}")
    emit({"kernels": rows})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
