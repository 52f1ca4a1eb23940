#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device   — the card (capability 9.0) and its name/power limit;
2. build    — the hand-written CUDA kernels (``src/repro_torch/csrc``) built
              with nvcc for sm_90a;
3. kernels  — B1 (dense) and B2 (paged, fp and int8) against their plain
              PyTorch versions at the slice's shapes, then timed against the
              plain version, ``scaled_dot_product_attention`` (a yardstick
              the port never calls) and the memory bound;
4. exact    — float32, full widths at 2 layers each: the server's greedy
              tokens on dense KV == on paged KV (pool at 60 % of dense
              parity) == a target-only greedy decode, and a self-speculation
              pair commits the same tokens at acceptance 1.0;
5. serve    — the full qwen3-14b target ← qwen2.5-3b draft pair in bf16
              through ``repro_torch.launch.serve``: dense static γ=4, dense
              AWC, paged static γ=4, each checked for complete in-range
              outputs, kernel launch counts equal to rounds·(γ_max·L_draft +
              L_target) + admissions·(L_draft + L_target), and the step-key
              count; the decode rounds of every chunk run under
              ``torch.cuda.set_sync_debug_mode("error")``.

Then the ``{"kernels": [...]}`` line, the card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``. Without CUDA, or without
the repository beside it, the script exits non-zero and prints no result.
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
    return err, times


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
    del eng, self_eng, srv_d, srv_p
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
    profile_round(torch, serve, base)
    return totals


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
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    s = out.summary
    emit({"phase": "profile", "run": "dense_static 4x8",
          "rounds": s["iterations"], "requests": s["requests"],
          "wall_s_profiled": s["wall_s"], "device_ms": device_ms,
          "device_busy_share_profiled": device_ms / 1e3 / s["wall_s"],
          "top_kernels": [{"ms": r[0], "calls": r[1], "name": r[2][:90]}
                          for r in rows[:12]]})
    del out
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = [p for p in ap.parse_args(argv).phases.split(",") if p]
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    info = phase_device(torch)
    from repro_torch import kernels
    if "build" in phases or "kernels" in phases:
        phase_build(kernels)
    err, times = {}, {}
    if "kernels" in phases:
        err, times = phase_kernels(torch)
    if "exact" in phases:
        phase_exact(torch)
    totals = {}
    if "serve" in phases:
        totals = phase_serve(torch, kernels)
    replaces = {
        "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                        "src/repro/kernels/decode_attn/decode_attn.py:38",
                        "_decode_attn_kernel"),
        "paged_decode_attn": ("src/repro_torch/csrc/paged_decode_attn.cu",
                              "src/repro/kernels/decode_attn/paged.py:39",
                              "_paged_decode_kernel"),
    }
    rows = []
    for name, (src, tpu, tpu_fn) in replaces.items():
        t = times.get("slice", {}).get(name, {})
        lt = times.get("long", {}).get(name, {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "tpu_kernel": tpu_fn,
                     "launches": totals.get(name),
                     "max_abs_err": err.get(name), "ms": t.get("ms"),
                     "plain_ms": t.get("plain_ms"),
                     "bound_ms": t.get("bound_ms"),
                     "bound_by": t.get("bound_by"),
                     "library_ms": t.get("library_ms"),
                     "shape": times.get("slice", {}).get("shape"),
                     "long_context": lt})
    emit({"kernels": rows})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
