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
              every session step captured once as a CUDA graph and
              replayed, against the same runs eager (``capture=False``) on
              one engine, seed and stream: qwen servers dense and paged
              with γ changing every round, tree sessions (static γ 4 × b
              3, AWC with max_branches=3, γ × b changing every round) on
              a noised-draft pair, the zamba2 ← mamba2 split server —
              captured tokens == eager == the target-only greedy decode;
              at temperature 1.0 captured == eager on one seed (qwen and
              zamba2 pairs); 2 graphs per server and 1 per wave session
              whatever γ, b and 8 admissions into 4 slots did, replays =
              rounds + admissions − warm-ups; then the bf16 qwen dense
              static γ 4 serve at QWEN_CUT depth eager and captured back to
              back (walls, TPOT, device busy share, equal launch counts);
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
              0 greedy; a profile.
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
          "serve", "exact_ssm", "serve_ssm")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor rate
GAMMA_MAX = 8
HYBRID_LAYERS = 8              # zamba2 depth in exact_ssm: 1 segment + 2
# depth of the earlier slices' secondary qwen runs (dense AWC, paged
# T = 1, the tree waves), a quarter of the published 40 / 36 layers, so the
# whole script stays near 600 s with the SSM slice added; dense static
# (greedy and T = 1) and paged static greedy keep the published depth
QWEN_CUT = {"qwen3-14b": 10, "qwen2.5-3b": 9}
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
    lib = kernels.library()
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
    lib = kernels.library()
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


def _serve(engine, policy, reqs, **cfg_kw):
    from repro_torch.serving import ServerConfig, SpecDecodeServer
    srv = SpecDecodeServer(engine, policy, ServerConfig(
        max_batch=4, sync_every=8, **cfg_kw))
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
                 transport=None) -> dict:
    """Decode ``reqs`` wave by wave (``batch`` at a time) through
    ``DecodeSession`` as ``benchmarks/bench_tree.py`` run_cell drives it:
    ``admit_batch`` the wave, ``run_chunk`` until every row stops,
    ``snapshot``. ``capture`` goes to each session (None: rounds replayed
    from the session's captured graph), and so does ``transport`` (the
    split rounds over it; None: colocated). Returns per-request tokens and
    the summed statistics."""
    from repro_torch.core.session import DecodeSession
    out = {"tokens": {}, "bits": {}, "rounds": 0, "fused": 0, "waves": 0,
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
                             capture=capture, transport=transport)
        if log is not None:
            log.sess = sess
        t0 = time.perf_counter()
        sess.admit_batch(prompts, max_new, prompt_lens=lens,
                         request_ids=[r.request_id for r in wave])
        while sess.unfinished:
            sess.run_chunk(policy)
        toks, st = sess.snapshot()
        out["wall_s"] += time.perf_counter() - t0
        for i, r in enumerate(wave):
            out["tokens"][r.request_id] = toks[i]
            out["bits"][r.request_id] = st.acceptance_seqs[i]
        out["rounds"] += sess.iterations
        out["fused"] += sess.fused_iterations
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
    equal ``ref``, the target-only greedy decode, where given), the
    captured run's graphs are ``steps`` per session whatever γ, b and the
    admissions did, every other round and admission was a replay, and the
    eager run captured nothing. ``drive(capture)`` returns (tokens by
    request, rounds, sessions, recording policy)."""
    runs = {}
    for mode, capture in (("captured", None), ("eager", False)):
        g0 = graph_counts(eng)
        t0 = time.perf_counter()
        tokens, rounds, sessions, pol = drive(capture)
        runs[mode] = {"tokens": tokens, "rounds": rounds,
                      "sessions": sessions,
                      "graphs": graphs_since(eng, g0),
                      "distinct_gamma": len(set(pol.gammas)),
                      "distinct_branches": len(set(pol.widths)),
                      "seconds": time.perf_counter() - t0}
    cap, eag = runs["captured"], runs["eager"]
    want = want_graphs(steps * cap["sessions"], cap["rounds"] + admissions)
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
    t1 = SpecDecodeEngine(d_cfg, t_cfg, draft_params=eng.draft_params,
                          target_params=eng.target_params,
                          temperature=SAMPLED_T, gamma_max=GAMMA_MAX,
                          device=dev)
    capture_pair(np, "qwen linear dense T=1", t1,
                 server(t1, lambda: StaticWindowPolicy(4), reqs), n, 2)
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
    eager_against_captured(torch, kernels)


def eager_against_captured(torch, kernels) -> None:
    """The qwen3-14b ← qwen2.5-3b dense static γ 4 serve (bf16, QWEN_CUT
    depth, the smoke's stream) through the launcher, eager
    (``--no-capture``) then captured, back to back; then each again under
    torch.profiler for its device time. Busy share = profiled device ms ÷
    the unprofiled wall (same rounds, same kernels). Launch counts must
    agree between the two."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    argv = ["--target", "qwen3-14b", "--draft", "qwen2.5-3b", "--full-size",
            "--max-batch", "4", "--requests", "8", "--max-new", "32",
            "--gamma-max", str(GAMMA_MAX), "--seed", "0", "--json",
            "--policy", "static", "--gamma", "4"]
    modes = (("eager", ["--no-capture"]), ("captured", []))
    res = {}
    for mode, extra in modes:
        kernels.reset_launches()
        t0 = time.perf_counter()
        with depth_cut(serve, QWEN_CUT):
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
        with depth_cut(serve, QWEN_CUT), profile(
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
          "run": "qwen dense static gamma 4, bf16, QWEN_CUT",
          "layers": [QWEN_CUT["qwen2.5-3b"], QWEN_CUT["qwen3-14b"]],
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
                g0 = graph_counts(eng)
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
                want = want_step_graphs(split_calls(rounds, fused, len(reqs),
                                                    False))
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
    g0 = graph_counts(tree)
    kernels.reset_launches()
    dist = run_sessions(np, tree, reqs, pol(), B_MAX, transport=tr)
    _add(totals, kernels.LAUNCHES)
    graphs = graphs_since(tree, g0)
    want = want_graphs(3 * dist["waves"], 3 * dist["rounds"])
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
    g0 = graph_counts(ssm)
    kernels.reset_launches()
    srv, dist = _serve(ssm, StaticWindowPolicy(4), sreqs, transport=tr,
                       mode_policy="distributed")
    _add(totals, kernels.LAUNCHES)
    sess = srv._sessions[0]
    graphs = graphs_since(ssm, g0)
    want = want_step_graphs(split_calls(sess.iterations, 0, len(sreqs),
                                        True))
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
        with depth_cut(serve, QWEN_CUT if cut else {}):
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
        with depth_cut(serve, QWEN_CUT), profile(
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
        with depth_cut(serve, QWEN_CUT if cut else {}):
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
                    gather_reduce=b3, cdf_sample=b3, ssd_scan=0)
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
    """Within the block the launcher builds the named configs at the given
    depths (``{name: n_layers}``) and every other setting as published."""

    def __init__(self, serve_mod, layers: dict):
        self.mod, self.layers = serve_mod, layers
        self.real = serve_mod.get_config

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
        g0 = graph_counts(eng)
        res = run_sessions(np, eng, reqs, policy, b_max)
        launches = dict(kernels.LAUNCHES)
        rounds, waves = res["rounds"], res["waves"]
        # each wave's session captures its round step (the wave prefill
        # stays eager)
        graphs, graphs_want = graphs_since(eng, g0), want_graphs(waves,
                                                                 rounds)
        tree_n = rounds if b_max else 0
        want = {"decode_attn": rounds * (GAMMA_MAX * L_d + L_t)
                + waves * (L_d + L_t), "paged_decode_attn": 0,
                "tree_argmax": 0, "tree_accept": 0, "tree_verify": tree_n,
                "gather_reduce": 0, "cdf_sample": 0, "ssd_scan": 0}
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
