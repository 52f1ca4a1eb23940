"""The PyTorch port stands alone: it imports neither JAX nor anything of the
reference package ``repro``, and its entry points refuse to run quietly on
the CPU when no device was asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def test_import_leaves_jax_and_reference_unloaded():
    """A fresh interpreter (this one has JAX loaded by tests/conftest.py)
    imports every port module and finds neither ``jax`` nor ``repro``."""
    names = [m for m, _ in _modules()]
    code = ("import importlib, sys\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print('LOADED', len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_imports_jax_or_reference():
    """No module of the port, nor the card smoke test beside it, imports
    ``jax``, ``jaxlib`` or the reference package ``repro``."""
    bad = []
    paths = [path for _, path in _modules()] + [PKG.parents[1]
                                                / "chip_smoke.py"]
    for path in paths:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.name}:{node.lineno} imports {n}")
    assert not bad, bad


def test_checks_cover_the_topology_and_the_hosts():
    """The two checks above walk every module of the package, the
    topology layer and the worker hosts included."""
    names = {m for m, _ in _modules()}
    assert {"repro_torch.topology", "repro_torch.distributed.host"} <= names


@pytest.mark.parametrize("module", ["repro_torch.models.moe",
                                    "repro_torch.core.pool"])
def test_checks_cover_the_model_families_and_the_pools(module):
    """… and the MoE block and the engine-owned slot pools."""
    assert module in {m for m, _ in _modules()}


def test_engine_without_device_raises_on_a_cpu_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.engine import SpecDecodeEngine
    cfg = ModelConfig(name="t", arch_type="dense", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=1, d_ff=64, vocab=64,
                      dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpecDecodeEngine(cfg, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SpecDecodeEngine(cfg, cfg, device="cuda")


def test_kernel_wrappers_refuse_other_devices():
    """The wrappers take CPU tensors (plain version) or CUDA tensors
    (kernel), and meta tensors by name (the dry-run's shapes); anything
    else raises instead of silently copying."""
    import types
    from repro_torch.kernels.decode_attn import decode_attn_call
    q = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attn_call(q, q, q, q, q)
