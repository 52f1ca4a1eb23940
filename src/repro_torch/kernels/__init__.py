"""Hand-written Hopper kernels of the port, their build and their dispatch.

- decode_attn — GQA flash-decode over a dense KV cache (replaces the Pallas
  kernel ``repro/kernels/decode_attn/decode_attn.py``),
- decode_attn.paged — the same over a paged block pool (replaces
  ``repro/kernels/decode_attn/paged.py``),
- verify.tree — greedy tree verify: the per-entry target argmax and the
  longest-accepted-root-path rule (replace ``repro/kernels/verify/tree.py``),
- verify.verify — sampled verify: the gather/residual-mass pass and the
  inverse-CDF sample (replace ``repro/kernels/verify/verify.py``).

The CUDA sources live in ``repro_torch/csrc``. They are compiled at first
use with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, which is loaded with ``ctypes`` (one ``nvcc`` process per source,
all started together, then one link). The library is keyed by a hash of the
sources, so a changed source rebuilds and an unchanged one loads at once.

The device rule: a kernel wrapper given CPU tensors runs the kernel's plain
PyTorch version (that is what the CPU tests exercise); given CUDA tensors it
launches the kernel or raises. There is no fallback from the card to the
plain version. Every launch adds one to the wrapper's entry in
:data:`LAUNCHES`, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <repo>/build/repro_torch_kernels (src/repro_torch/kernels → parents[3])
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launch counts per kernel wrapper; read and reset by callers that need to
# show a path ran through the kernels (chip_smoke.py)
LAUNCHES: dict[str, int] = {"decode_attn": 0, "paged_decode_attn": 0,
                            "tree_argmax": 0, "tree_accept": 0,
                            "gather_reduce": 0, "cdf_sample": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_LOG: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def resolve_device(device=None) -> torch.device:
    """The port's entry-point device rule: ``None`` means the card, and a
    machine without one raises; the CPU runs only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "kernels are built from source at first use")
    return found


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link the
    shared library; returns its path. A no-op when the library for the
    current sources' hash already exists."""
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    lib_path = build_dir / f"librepro_torch_kernels_{tag}.so"
    if lib_path.exists():
        BUILD_LOG.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in srcs if s.suffix == ".cu"):
        obj = build_dir / f"{src.stem}_{tag}.o"
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = {}
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        logs[src.name] = out
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[f] for f in failed))
    tmp = build_dir / f".{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    BUILD_LOG.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                     cached=False, ptxas=logs)
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, pos_map, q_pos, win_mask, win_base, out, B, T, Hkv, G, hd,
    # S, window, Wn, dtype, stream
    "decode_attn_launch": [_P] * 8 + [_I] * 9 + [_P],
    # q, k_pool, v_pool, k_scale, v_scale, pos_map, block_table, q_pos,
    # out, B, T, Hkv, G, hd, bs, n_log, length, window, q_dtype, kv_int8,
    # stream
    "paged_decode_attn_launch": [_P] * 9 + [_I] * 11 + [_P],
    # logits, out, rows, V, stream
    "tree_argmax_launch": [_P] * 2 + [_I] * 2 + [_P],
    # tok, tgt, parent, tpos, valid, mask, n_acc, winner, bonus, B, T,
    # stream
    "tree_accept_launch": [_P] * 9 + [_I] * 2 + [_P],
    # tokens, p, q, partial, p_at, q_at, mass, B, gamma, V, splits, dtype,
    # stream
    "gather_reduce_launch": [_P] * 7 + [_I] * 5 + [_P],
    "gather_reduce_chunk": [],
    # jrow, qrow, use_p, p, q, thresh, token, B, gamma, V, dtype, stream
    "cdf_sample_launch": [_P] * 7 + [_I] * 4 + [_P],
}


def library() -> ctypes.CDLL:
    """Build (first call) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def dtype_code(dt: torch.dtype) -> int:
    """The C entries' element-type code: 0 = float32, 1 = bfloat16."""
    if dt == torch.float32:
        return 0
    if dt == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, not {dt}")


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
