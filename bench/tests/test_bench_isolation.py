"""Nothing the harness runs loads JAX or the JAX package ``repro``, by whole
top-level module name (``repro_torch`` starts with ``repro`` and is not
it), and the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

import run


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch", "repro_torch.core.session", "reproduce",
             "jaxtyping", "flaxen", "numpy", "repro", "repro.core.engine",
             "jax.numpy", "jaxlib", "flax.linen"]
    assert run.forbidden_modules(names) == ["flax.linen", "jax.numpy",
                                            "jaxlib", "repro",
                                            "repro.core.engine"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_harness_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        roots = {n.split(".")[0] for n in _imports(path)}
        assert not roots & {"jax", "jaxlib", "flax", "repro"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not any(n.split(".")[0] == "repro_torch"
                       for n in _imports(path)), path
    for path in (BENCH / "check.py", BENCH / "counts.py"):
        assert not any(n.split(".")[0] == "repro_torch"
                       for n in _imports(path)), path


def test_a_fresh_process_of_the_harness_and_the_port_loads_no_jax():
    code = ("import sys\n"
            "import run, check, serve, counts, traffic, weights, window, "
            "devtrace, layers, sweep\n"
            "from reference import common, dense, ssm\n"
            "import repro_torch.topology, repro_torch.serving, "
            "repro_torch.core.session\n"
            "for m in run.load_json(run.ROOT / 'BENCHMARK.json')"
            "['per_layer']:\n"
            "    run.reader(m['name'])\n"
            "bad = run.forbidden_modules(sys.modules)\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=BENCH, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_without_the_program_the_run_fails_and_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and bench/, the run
    exits with an error and prints nothing on standard output."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "qwen14b-gsm8k-t1-rate", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
