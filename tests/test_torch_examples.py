"""The port's examples run end to end on the CPU at their smallest flags
(``--device cpu``): quickstart (three window policies on a reduced pair,
then DSD-Sim), edge-cloud serving (one ClusterSpec as a deployment and a
simulation, then the fused sampled verify against its reference rule)
and trace capture (acceptance traces written, read back and replayed
through DSD-Sim). Each runs in its own interpreter, as a user runs it."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

CASES = {
    "quickstart_torch.py": (["--requests", "2", "--max-new", "8",
                             "--sim-requests", "10"],
                            ["awc", "DSD-Sim", "graphs=0"]),
    "edge_cloud_serving_torch.py": (["--requests", "2", "--max-new", "4"],
                                    ["served=2 pairs=2", "sim pair=wan",
                                     "== reference rule: True"]),
    "capture_traces_torch.py": (["--requests", "2", "--max-new", "8"],
                                ["saved 2 records",
                                 "replayed through DSD-Sim"]),
}


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_the_cpu(script, tmp_path):
    args, expect = CASES[script]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), "--device", "cpu",
         *args], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for text in expect:
        assert text in res.stdout, (text, res.stdout)
