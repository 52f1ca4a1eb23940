#!/usr/bin/env python3
"""Where the time of the bf16 decode-attention kernel (B1) goes, on one card.

    python3 tools/decode_attn_probe.py        # from the repository root

Prints, each as one line (times are device times by CUDA-graph replay, bf16,
hd 128, all keys valid):

- a split sweep at S 4096 for the verify (B 4, T 9, Hkv 8, G 5) and draft
  decode (B 4, T 1, Hkv 2, G 8) shapes: the kernel with its keys per split
  overridden, the rest of the plan as in the wrapper;
- one split of S keys (S 64 … 1024) at both shapes: the slope is the cost of
  one 64-key stage of one block, the intercept the launch and prologue;
- the kernel over S 1024 keys all beyond q_pos (only the early tiles are
  loaded), and the profiler's split of the S 4096 call into the attention
  kernel and the combine kernel;
- the load side alone (tools/kv_stream_bench.cu, built here with nvcc):
  the verify shape's K/V at S 4096 (67 MB, rows 2 KB apart) streamed through
  the same shared-memory ring with cp.async and with cp.async.bulk;
- the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.kernels.decode_attn.decode_attn as da  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn_call  # noqa: E402

SHAPES = {"verify": (4, 9, 8, 5), "draft": (4, 1, 2, 8)}   # B, T, Hkv, G


def inputs(gen, dev, B, T, Hkv, G, S, q_pos=None, hd=128):
    q = torch.randn((B, T, Hkv, G, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev).bfloat16()
    pm = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S) \
        .contiguous()
    qp = (S - T + torch.arange(T, device=dev, dtype=torch.int32)) \
        .expand(B, T).contiguous() if q_pos is None else q_pos
    return q, k, v, pm, qp


def with_split(split: int):
    """Pin the wrapper's keys per split (both kv-head widths)."""
    da.SPLIT_KEYS[(128, torch.bfloat16)] = split
    da.WIDE_KV = 10 ** 9


def us(fn) -> float:
    return cs.graph_ms(torch, fn) * 1e3


def stream_bench(dev) -> None:
    lib_path = ROOT / "build" / "kv_stream_bench.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib_path), str(ROOT / "tools" / "kv_stream_bench.cu")],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.membench.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p]
    B, S, Hkv = 4, 4096, 8
    k = torch.randn(B * S * Hkv * 128, device=dev).bfloat16()
    v = torch.randn_like(k)
    out = torch.zeros(1, device=dev)
    for keys in (256, 512):
        blocks = B * S * Hkv // keys
        for mode, name in ((0, "cp.async"), (1, "cp.async.bulk")):
            for stages in (2, 3):
                f = lambda: lib.membench(
                    mode, stages, k.data_ptr(), v.data_ptr(), Hkv * 256,
                    keys, Hkv, blocks, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                assert f() == 0
                t = us(f)
                print(f"stream {name:13s} keys/block {keys} stages {stages}: "
                      f"{t:.2f} us for {2 * k.numel() * 2 / 1e6:.1f} MB "
                      f"({2 * k.numel() * 2 / t / 1e6:.2f} TB/s)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("decode_attn_probe: needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels.library()
    for name, (B, T, Hkv, G) in SHAPES.items():
        a = inputs(gen, dev, B, T, Hkv, G, 4096)
        for split in (256, 512):
            with_split(split)
            print(f"{name} S 4096 split {split}: "
                  f"{us(lambda: decode_attn_call(*a)):.2f} us", flush=True)
        with_split(1024)
        for S in (64, 128, 256, 512, 1024):
            a1 = inputs(gen, dev, B, T, Hkv, G, S)
            print(f"{name} one split S {S}: "
                  f"{us(lambda: decode_attn_call(*a1)):.2f} us", flush=True)
        dead = inputs(gen, dev, B, T, Hkv, G, 1024,
                      q_pos=torch.full((B, T), -5, dtype=torch.int32,
                                       device=dev))
        print(f"{name} S 1024 all keys past q_pos: "
              f"{us(lambda: decode_attn_call(*dead)):.2f} us", flush=True)
        with_split(256 if Hkv < 8 else 512)
        from torch.profiler import ProfilerActivity, profile
        for _ in range(3):
            decode_attn_call(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                decode_attn_call(*a)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", 0) \
                or getattr(ev, "self_cuda_time_total", 0)
            if t > 0:
                print(f"{name} S 4096 profile {ev.key.split('<')[0][-20:]}: "
                      f"{t / ev.count:.2f} us per call", flush=True)
    stream_bench(dev)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
