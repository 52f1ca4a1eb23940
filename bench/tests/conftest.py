"""CPU tests of the benchmark harness (``bench/``). Run from the repo root:

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider bench/tests

Tests that need the card take the ``card`` fixture, which skips them when
no CUDA device is present; that is decided when the test runs, never at
import."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")
    # the tiny models run faster on one thread than on a shared machine's
    # many, and the runs' timing windows need the chunks to go round
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100)")
    return torch.device("cuda", 0)


TINY_DENSE = {
    "target": {"name": "bench-tiny-t", "arch_type": "dense", "n_layers": 2,
               "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
               "vocab": 256, "head_dim": 16, "qk_norm": True,
               "rope_theta": 1000000.0, "norm_eps": 1e-05,
               "dtype": "float32"},
    "draft": {"name": "bench-tiny-d", "arch_type": "dense", "n_layers": 2,
              "d_model": 32, "n_heads": 2, "n_kv_heads": 1, "d_ff": 64,
              "vocab": 256, "head_dim": 16, "qkv_bias": True,
              "rope_theta": 1000000.0, "norm_eps": 1e-05,
              "dtype": "float32"}}

TINY_SSM = {
    "target": {"name": "bench-tiny-m", "arch_type": "ssm", "n_layers": 3,
               "d_model": 64, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
               "vocab": 256, "ssm_state": 16, "ssm_expand": 2,
               "ssm_head_dim": 16, "ssm_conv": 4, "ssm_chunk": 16,
               "norm_eps": 1e-05, "dtype": "float32"},
    "draft": {"name": "bench-tiny-s", "arch_type": "ssm", "n_layers": 2,
              "d_model": 32, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
              "vocab": 256, "ssm_state": 16, "ssm_expand": 2,
              "ssm_head_dim": 16, "ssm_conv": 4, "ssm_chunk": 16,
              "tie_embeddings": True, "norm_eps": 1e-05,
              "dtype": "float32"}}


def tiny_cell(temperature: float, limits: dict, **kw) -> dict:
    """A cell's settings at tiny size. A static window stays below gamma_max,
    as the cells' does, so that the draft has read every accepted token
    before it proposes again."""
    cell = {"slots": 4, "max_prompt_len": 32, "max_new_cap": 48,
            "paged": False, "policy": "awc", "gamma": 3, "gamma_max": 4,
            "sync_every": 4, "rtt_ms": 0.0, "ramp_s": 0.5,
            "trace_chunks": 0, "sample": 6, "limits": limits}
    cell.update(kw)
    return cell


def tiny_mix(temperature: float, rate: float = 4.0) -> dict:
    return {"prompt": {"mean": 12, "sigma": 0.4, "min": 4, "max": 32},
            "output": {"mean": 20, "sigma": 0.5, "min": 4, "max": 48},
            "temperature": temperature,
            "arrivals": {"kind": "poisson", "rate_per_s": rate}}
