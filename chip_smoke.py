#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device   — the card (capability 9.0) and its name/power limit;
2. build    — the hand-written CUDA kernels (``src/repro_torch/csrc``) built
              with nvcc for sm_90a;
3. kernels  — B1 (dense), B2 (paged, fp and int8), B1 with the tree
              ancestor mask, B4a (tree argmax) and B4b (tree accept) against
              their plain PyTorch versions at the slices' shapes (B4a/B4b
              exactly), then timed against the plain version, a library
              yardstick the port never calls (``scaled_dot_product_attention``,
              ``torch.argmax``) and the bound;
4. exact    — float32, full widths at 2 layers each: the server's greedy
              tokens on dense KV == on paged KV (pool at 60 % of dense
              parity) == a target-only greedy decode, and a self-speculation
              pair commits the same tokens at acceptance 1.0; then, on a
              qwen3-14b pair whose draft is a noised copy of the target, a
              tree session (γ_max 8, b_max 3, static γ 4 × b 3) == a linear
              session == the target-only greedy decode, with acceptance
              strictly between 0 and 1, and a max_branches=1 tree session ==
              the linear one bit for bit (tokens and acceptance bits);
5. serve    — the full qwen3-14b target ← qwen2.5-3b draft pair in bf16
              through ``repro_torch.launch.serve``: dense static γ=4, dense
              AWC, paged static γ=4, each checked for complete in-range
              outputs, kernel launch counts equal to rounds·(γ_max·L_draft +
              L_target) + admissions·(L_draft + L_target), and the step-key
              count; then the same pair through tree ``DecodeSession``s
              (γ_max 8, b_max 3; static γ 4 × b 3 and AWC with
              max_branches=3), checked for complete outputs, B1 launches =
              rounds·(γ_max·L_draft + L_target) + waves·(L_draft +
              L_target), B4a = B4b = rounds, and one step key. The decode
              rounds of every chunk run under
              ``torch.cuda.set_sync_debug_mode("error")``.

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
PHASES = ("device", "build", "kernels", "exact", "serve")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor rate
GAMMA_MAX = 8
B_MAX = 3                      # tree branch bound of the tree runs
TREE_NOISE = 0.05              # draft = target + N(0, (0.05·std)²) per tensor


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


def graph_ms(torch, fn, iters: int = 50, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured into one CUDA graph,
    replayed and timed with events. Unlike :func:`cuda_ms`, the wrapper's
    host work (argument checks, allocation, the ctypes call) is not in the
    number — for a kernel shorter than its Python wrapper an eager loop
    times the host."""
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


def paged_inputs(torch, gen, B, T, Hkv, G, hd, S, bs, dtype, quant, dev):
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
    assert lib is not None


def phase_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import (
        decode_attn_call, decode_attention_grouped, paged_decode_attention,
        paged_decode_attention_plain)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    geoms = {"target": (8, 5), "draft": (2, 8)}     # (Hkv, G), hd 128
    tol = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
    hd, S, bs = 128, 114, 16
    err = {"decode_attn": 0.0, "paged_decode_attn": 0.0}
    cases = 0
    for gname, (Hkv, G) in geoms.items():
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
                if not (out[0] == 0).all():
                    fail("B1: the empty row is not zero")
                err["decode_attn"] = max(err["decode_attn"], float(
                    (out.float() - ref.float()).abs().max()))
                for quant in (False, True):
                    args = paged_inputs(torch, gen, B, T, Hkv, G, hd, S, bs,
                                        dtype, quant, dev)
                    out = paged_decode_attention(*args, S)
                    ref = paged_decode_attention_plain(*args, S)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(out.float(), ref.float(),
                                               **tol[dtype])
                    err["paged_decode_attn"] = max(
                        err["paged_decode_attn"],
                        float((out.float() - ref.float()).abs().max()))
                cases += 1
    emit({"phase": "kernels", "check": "kernel == plain", "cases": cases,
          "tolerance": {"float32": 1e-4, "bfloat16": 2e-2},
          "allow_tf32": False, "max_abs_err": err})

    # ---- timing: the slice's verify shape and one long-context shape
    times = {}
    Hkv, G = geoms["target"]
    for label, S_t in (("slice", 114), ("long", 4096)):
        B, T, dtype = 4, 9, torch.bfloat16
        H = Hkv * G
        q = torch.randn((B, T, Hkv, G, hd), generator=gen,
                        device=dev).to(dtype)
        k = torch.randn((B, S_t, Hkv, hd), generator=gen,
                        device=dev).to(dtype)
        v = torch.randn((B, S_t, Hkv, hd), generator=gen,
                        device=dev).to(dtype)
        ar = torch.arange(S_t, device=dev, dtype=torch.int32)
        pm = ar.expand(B, S_t).contiguous()
        qp = (S_t - T + torch.arange(T, device=dev, dtype=torch.int32)
              ).expand(B, T).contiguous()
        # SDPA yardstick: same function, GQA-aware, boolean position mask
        qs = q.reshape(B, T, H, hd).transpose(1, 2)
        ksd, vsd = k.transpose(1, 2), v.transpose(1, 2)
        mask = ((pm[:, None, None, :] >= 0)
                & (pm[:, None, None, :] <= qp[:, None, :, None]))
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ksd, vsd, attn_mask=mask, enable_gqa=True)
        torch.testing.assert_close(
            sdpa().transpose(1, 2).float().reshape(B, T, Hkv, G, hd),
            decode_attention_grouped(q, k, v, pm, qp).float(),
            atol=2e-2, rtol=2e-2)
        # paged twin of the same cache: bs 16, identity-ordered blocks
        bs_t = 16
        n_log = math.ceil(S_t / bs_t)
        pad = n_log * bs_t - S_t
        kp = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(B * n_log, bs_t, Hkv,
                                                    hd).contiguous()
        vp = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(B * n_log, bs_t, Hkv,
                                                    hd).contiguous()
        pmp = F.pad(pm, (0, pad), value=-1).reshape(B * n_log,
                                                    bs_t).contiguous()
        table = torch.arange(B * n_log, device=dev,
                             dtype=torch.int32).reshape(B, n_log)
        pargs = (q, kp, vp, None, None, pmp, table, qp, S_t)
        kv_bytes = 2 * B * S_t * Hkv * hd * 2
        io_bytes = 2 * q.numel() * 2 + qp.numel() * 4
        flops = 2 * 2 * B * T * H * S_t * hd
        bound = {}
        bound["decode_attn"] = max(
            (kv_bytes + io_bytes + pm.numel() * 4) / HBM_BYTES_PER_S,
            flops / BF16_FLOPS) * 1e3
        bound["paged_decode_attn"] = max(
            (kv_bytes + io_bytes + pmp.numel() * 4 + table.numel() * 4)
            / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        lib_ms = cuda_ms(torch, sdpa)
        times[label] = {
            "shape": {"B": B, "T": T, "Hkv": Hkv, "G": G, "hd": hd,
                      "S": S_t, "dtype": "bfloat16"},
            "decode_attn": {
                "ms": cuda_ms(torch, lambda: decode_attn_call(q, k, v, pm,
                                                              qp)),
                "plain_ms": cuda_ms(torch, lambda: decode_attention_grouped(
                    q, k, v, pm, qp), iters=20),
                "library_ms": lib_ms, "bound_ms": bound["decode_attn"],
                "bound_by": "bytes"},
            "paged_decode_attn": {
                "ms": cuda_ms(torch, lambda: paged_decode_attention(*pargs)),
                "plain_ms": cuda_ms(torch, lambda:
                                    paged_decode_attention_plain(*pargs),
                                    iters=20),
                "library_ms": lib_ms,
                "bound_ms": bound["paged_decode_attn"], "bound_by": "bytes"},
        }
    emit({"phase": "kernel_times", "card": smi_line(), **times})
    err.update(check_tree_kernels(torch, gen, dev, geoms, tol))
    times["tree"] = time_tree_kernels(torch, gen, dev, geoms)
    emit({"phase": "tree_kernel_times", "card": smi_line(),
          **times["tree"]})
    return err, times


def tree_pos_map(torch, gen, B, S, T, dev):
    """Committed positions 0..p−1 with a hole, junk inside the tree region
    [p, p + T) (the bitmap replaces it) and stale entries past it; the last
    row's region runs past the cache edge. Returns (pos_map, p)."""
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
    window), B4a and B4b, each against its plain version."""
    from repro_torch.core.tree import TreeSpec
    from repro_torch.kernels.decode_attn import (decode_attn_call,
                                                 decode_attention_grouped)
    from repro_torch.kernels.verify import (tree_accept, tree_accept_plain,
                                            tree_argmax, tree_argmax_plain)
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

    # B4b: planted matching paths on several branches, γ and b swept
    accept_cases = 0
    for d_max, b_max in ((8, 3), (6, 4), (4, 1)):
        sp = TreeSpec(d_max, b_max, dev)
        Tn = sp.n_entries
        g2 = torch.Generator()
        g2.manual_seed(d_max * 10 + b_max)
        toks = torch.randint(0, 1000, (8, Tn), generator=g2,
                             dtype=torch.int32)
        tgt = torch.randint(0, 1000, (8, Tn), generator=g2,
                            dtype=torch.int32)
        parent = sp.parent_np
        for r in range(8):
            root = r % (b_max + 1)                 # b_max: no root matches
            for e in range(1, Tn):
                d, k_ = int(sp.depth_np[e]), int(sp.branch_np[e])
                if (d == 0 and k_ == root) or (d > 0 and
                                               (r + e) % 3 != 0):
                    tgt[r, parent[e]] = toks[r, e]
        toks, tgt = toks.to(dev), tgt.to(dev)
        for g in range(d_max + 1):
            for b in range(1, b_max + 1):
                nv = sp.node_valid(g, b)
                got = tree_accept(toks, tgt, sp.parent_entry, sp.tree_pos,
                                  nv, sp.win_mask)
                want = tree_accept_plain(toks, tgt, sp.parent_entry,
                                         sp.tree_pos, nv, sp.win_mask)
                torch.cuda.synchronize()
                for a_, w_ in zip(got, want):
                    if not torch.equal(a_, w_):
                        fail(f"B4b ({d_max},{b_max}) γ={g} b={b}: "
                             f"{got} != plain {want}")
                accept_cases += 1
    emit({"phase": "kernels", "check": "tree kernels == plain",
          "decode_attn_tree_cases": b1_cases,
          "decode_attn_tree_max_abs_err": b1_err,
          "tree_argmax_cases": [n for n, _ in argmax_cases],
          "tree_argmax_equal": True, "tree_accept_cases": accept_cases,
          "tree_accept_equal": True,
          "tolerance": {"decode_attn": {"float32": 1e-4, "bfloat16": 2e-2},
                        "tree_argmax": "exact", "tree_accept": "exact"}})
    return {"decode_attn_tree": b1_err, "tree_argmax": 0, "tree_accept": 0}


def time_tree_kernels(torch, gen, dev, geoms) -> dict:
    """The tree slice's kernels at its main-path shapes: B1 with the mask at
    the target's tree-verify window, B4a/B4b at one verdict. ``ms``,
    ``plain_ms`` and ``library_ms`` are device times from CUDA-graph
    replay; ``eager_ms`` is the wrapper called in an eager loop."""
    import torch.nn.functional as F
    from repro_torch.core.tree import TreeSpec
    from repro_torch.kernels.decode_attn import (decode_attn_call,
                                                 decode_attention_grouped)
    from repro_torch.kernels.verify import (tree_accept, tree_accept_plain,
                                            tree_argmax, tree_argmax_plain)
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
    toks = torch.randint(0, V, (B, T), generator=gen, device=dev,
                         dtype=torch.int32)
    tgt = tree_argmax(logits)
    nv = spec.node_valid(4, B_MAX)
    args = (toks, tgt, spec.parent_entry, spec.tree_pos, nv, mask)
    c_bytes = 2 * B * T * 4 + 2 * T * 4 + T + T * T + 3 * B * 4
    accept = {"shape": {"B": B, "T": T},
              "ms": graph_ms(torch, lambda: tree_accept(*args)),
              "eager_ms": cuda_ms(torch, lambda: tree_accept(*args)),
              "plain_ms": graph_ms(torch, lambda: tree_accept_plain(*args)),
              "library_ms": None,
              "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes"}
    return {"decode_attn_tree_verify": b1, "tree_argmax": argmax,
            "tree_accept": accept}


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


class WinnerLog:
    """Records each tree round's winning entries (and which rows were
    already done) by wrapping the engine's verdict call; the wrapped call
    is the real one, so launch counts are unchanged. Information only."""

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
                 log=None) -> dict:
    """Decode ``reqs`` wave by wave (``batch`` at a time) through
    ``DecodeSession`` as ``benchmarks/bench_tree.py`` run_cell drives it:
    ``admit_batch`` the wave, ``run_chunk`` until every row stops,
    ``snapshot``. Returns per-request tokens and the summed statistics."""
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
                             max_branches=max_branches)
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
    """Forwards to a window policy and keeps the branch width each round
    actually runs (the session clamps to b_max; a fused round runs b 1)."""

    def __init__(self, inner, b_max: int):
        self.inner, self.b_max, self.widths = inner, b_max, []

    def decide(self, pair_key, feats):
        dec = self.inner.decide(pair_key, feats)
        self.widths.append(1 if dec.mode == "fused"
                           else min(self.b_max, max(1, int(dec.branches))))
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
    with WinnerLog() as log:
        tree = run_sessions(np, eng, reqs,
                            StaticWindowPolicy(4, branches=B_MAX), B_MAX,
                            log=log)
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
    del eng
    torch.cuda.empty_cache()


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
    runs = [("dense_static", ["--policy", "static", "--gamma", "4"]),
            ("dense_awc", ["--policy", "awc"]),
            ("paged_static", ["--policy", "static", "--gamma", "4",
                              "--paged-kv"])]
    # the launcher's request stream (seed 0): its padded prompt bound P
    # fixes the slot length P + max_new + 2γ_max + 18 and so dense parity
    P = 16 * math.ceil(max(len(r.prompt) for r in _workload(np, 151936))
                       / 16)
    parity = 4 * math.ceil((P + 32 + 2 * GAMMA_MAX + 18) / 16)
    totals = {k: 0 for k in kernels.LAUNCHES}
    for name, extra in runs:
        argv = base + extra
        if "--paged-kv" in extra:
            argv += ["--kv-pool-blocks", str(int(0.6 * parity))]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
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
        want.update(tree_argmax=0, tree_accept=0)
        V = eng.target_cfg.vocab
        full = all(len(r.tokens) == 32 and (r.tokens >= 0).all()
                   and (r.tokens < V).all() for r in out.results)
        keys = eng.step_programs()
        want_keys = 3 if "--paged-kv" in extra else 2
        # information only: bf16 agreement with a target-only greedy decode
        agree = _agreement(torch, out, dev) if name == "dense_static" \
            else None
        info = {"phase": "serve", "run": name, "requests": s["requests"],
                "tokens": s["tokens"], "wall_s": s["wall_s"],
                "tokens_per_s": s["tokens_per_s"],
                "mean_ttft_ms": s["mean_ttft_ms"],
                "mean_tpot_ms": s["mean_tpot_ms"],
                "mean_acceptance": s["mean_acceptance"],
                "rounds": s["iterations"], "step_keys": keys,
                "launches": launches, "expected_launches": want,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 2**30,
                "all_full_in_range": full, "pairs": s["pairs"],
                "bf16_agreement_with_target_greedy": agree,
                "sync_debug_mode_in_rounds": "error"}
        emit(info)
        if s["requests"] != 8 or not full:
            fail(f"{name}: incomplete or out-of-range outputs")
        if launches != want:
            fail(f"{name}: kernel launches {launches}, expected {want}")
        if keys != want_keys:
            fail(f"{name}: {keys} step keys, expected {want_keys}")
        for k in totals:
            totals[k] += launches[k]
        del out, eng
        torch.cuda.empty_cache()
    for k, n in serve_tree(torch, np, kernels, dev).items():
        totals[k] += n
    profile_round(torch, serve, base)
    return totals


def serve_tree(torch, np, kernels, dev) -> dict:
    """The full-depth qwen3-14b ← qwen2.5-3b pair in bf16 through tree
    sessions (γ_max 8, b_max 3), 8 requests × 32 tokens in waves of 4:
    static γ 4 × b 3, then AWC choosing {γ, b} (max_branches=3). Returns
    the launch counts of both runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SpecDecodeEngine
    from repro_torch.core.window import StaticWindowPolicy, make_window_policy
    d_cfg, t_cfg = get_config("qwen2.5-3b"), get_config("qwen3-14b")
    vocab = t_cfg.vocab                       # the pair shares it
    eng = SpecDecodeEngine(d_cfg, t_cfg, seed=0, rtt_ms=10.0,
                           gamma_max=GAMMA_MAX, sync_every=8, device=dev)
    L_d, L_t = d_cfg.n_layers, t_cfg.n_layers
    reqs = _workload(np, vocab)
    totals = {k: 0 for k in kernels.LAUNCHES}
    # linear wave runs before and after the tree runs are the same-harness
    # yardstick of their wall per round (the first also pays the engine's
    # warm-up; their launches are not the tree path's)
    linear = lambda: StaticWindowPolicy(4)
    runs = [("linear_static_waves", linear(), 0, 1),
            ("tree_static", StaticWindowPolicy(4, branches=B_MAX), B_MAX, 2),
            ("tree_awc", make_window_policy("awc", max_branches=B_MAX),
             B_MAX, 2),
            ("linear_static_waves_after", linear(), 0, 2)]
    for name, inner, b_max, want_keys in runs:
        policy = RecordingPolicy(inner, max(1, b_max))
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        res = run_sessions(np, eng, reqs, policy, b_max)
        launches = dict(kernels.LAUNCHES)
        rounds, waves = res["rounds"], res["waves"]
        tree_n = rounds if b_max else 0
        want = {"decode_attn": rounds * (GAMMA_MAX * L_d + L_t)
                + waves * (L_d + L_t), "paged_decode_attn": 0,
                "tree_argmax": tree_n, "tree_accept": tree_n}
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


def profile_round(torch, serve, base) -> None:
    """Where a round's time goes: device kernel time from torch.profiler
    over a short dense serve (4 requests × 8 tokens), beside its wall time.
    The profiler's own host overhead inflates that wall; the unprofiled
    runs above give the honest wall per round."""
    from torch.profiler import ProfilerActivity, profile
    argv = [a for a in base]
    argv[argv.index("--requests") + 1] = "4"
    argv[argv.index("--max-new") + 1] = "8"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = serve.run(argv + ["--policy", "static", "--gamma", "4"])
        torch.cuda.synchronize()
    s = out.summary
    emit(profile_summary(prof, "dense_static 4x8", s["iterations"],
                         s["requests"], s["wall_s"]))
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
    return {"phase": "profile", "run": run, "rounds": rounds,
            "requests": requests, "wall_s_profiled": wall_s,
            "device_ms": device_ms,
            "device_busy_share_profiled": device_ms / 1e3 / wall_s,
            "top_kernels": [{"ms": r[0], "calls": r[1], "name": r[2][:90]}
                            for r in rows[:12]]}


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
    totals = {}
    t0 = time.perf_counter()
    if "serve" in phases:
        totals = phase_serve(torch, kernels)
        seconds["serve"] = time.perf_counter() - t0
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
    }
    slice_t, tree_t = times.get("slice", {}), times.get("tree", {})
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
        if name == "decode_attn" and tree_t:
            row["max_abs_err"] = max(err["decode_attn"],
                                     err["decode_attn_tree"])
            row["tree_verify"] = tree_t["decode_attn_tree_verify"]
        rows.append(row)
    emit({"kernels": rows})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
