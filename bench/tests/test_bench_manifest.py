"""BENCHMARK.json keeps to the benchmark's contract, and every file the
harness finds by name is there."""

import importlib
import json
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "bench/run.py"]
    assert M["paths"] == ["bench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert NAME.match(e["name"]), e["name"]
            key = (group in ("end_to_end", "per_layer"), e["name"])
            assert key not in seen, e["name"]
            seen.add(key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    texts = [e["why"] for e in M["configs"] + M["workloads"]] \
        + [e["layer"] for e in M["per_layer"]] \
        + [e["source"] for e in M["configs"]] + M["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    for c in M["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in M["workloads"]:
        ends = [m["name"] for m in M["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in ends and len(ends) >= 2, w["name"]
        layers = [m for m in M["per_layer"] if w["name"] in m["workloads"]]
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in ends, (w["name"], m["name"])
        assert w["chips"] == 1


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_file_is_found_by_name():
    cfgs = {c["name"]: c for c in M["configs"]}
    used = set()
    for w in M["workloads"]:
        cell = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert mix["prompt"]["max"] <= cell["max_prompt_len"]
        assert mix["output"]["max"] <= cell["max_new_cap"]
        used.add(w["config"])
    assert used == set(cfgs)
    for c in cfgs.values():
        assert c["file"].startswith("bench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for fam in cfg["families"].values():
            importlib.import_module(f"reference.{fam}")
    for m in M["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_metric_readers_load():
    import run
    for m in M["per_layer"]:
        assert callable(run.reader(m["name"]))
