"""Tiny CPU runs of the whole harness (reduced same-family pairs, not
cells): the result is correct, and it is not when the port runs below the
reference's precision or when the timed path is broken underneath (a step
that leaves its state unchanged, half of the batch left out, a token
altered where it is produced)."""

import copy
import json
import time

import pytest
import torch

from conftest import ROOT, TINY_DENSE, TINY_SSM, tiny_cell, tiny_mix

import run
import serve

SEED = 2**31 + 17
GREEDY = {"greedy_gap": 1e-3}
SAMPLED = {"residual_gap": 1e-3}


def measure(pair, temperature, limits, seconds=2.0, control=False, seed=SEED,
            **kw):
    cfg = {"port": pair, "families": {
        "target": pair["target"]["arch_type"],
        "draft": pair["draft"]["arch_type"]}}
    return run.measure("tiny", tiny_cell(temperature, limits, **kw), cfg,
                       tiny_mix(temperature), seed, seconds, False, "cpu",
                       control=control,
                       metrics=[{"name": "ttft_p90_ms", "unit": "ms"},
                                {"name": "setup_s", "unit": "s"}],
                       t_start=time.perf_counter())


@pytest.mark.parametrize("pair,temperature,limits", [
    (TINY_DENSE, 0.0, GREEDY), (TINY_DENSE, 1.0, SAMPLED),
    (TINY_SSM, 0.0, GREEDY)])
def test_tiny_run_is_correct(pair, temperature, limits):
    res = measure(pair, temperature, limits)
    assert res["correct"], res["checks"]
    assert res["checks"]["finished"]["value"] >= 1
    assert set(res["metrics"]) == {"ttft_p90_ms", "setup_s"}
    json.dumps(res["checks"])


def test_tiny_paged_run_is_correct():
    res = measure(TINY_DENSE, 0.0, GREEDY, paged=True, kv_block_size=8,
                  pool_slots=3)
    assert res["correct"], res["checks"]


def test_below_the_references_precision_is_not_correct(monkeypatch):
    """The port in bfloat16 against the float32 configuration."""
    build = run.build

    def low(cfg, cell, mix, params, device):
        cfg = copy.deepcopy(cfg)
        for side in cfg["port"].values():
            side["dtype"] = "bfloat16"

        def cast(t):
            if isinstance(t, dict):
                return {k: (v if k in ("A_log", "D", "dt_bias") else cast(v))
                        for k, v in t.items()}
            return t.to(torch.bfloat16)
        return build(cfg, cell, mix, {k: cast(v) for k, v in params.items()},
                     device)

    monkeypatch.setattr(run, "build", low)
    res = measure(TINY_DENSE, 0.0, GREEDY)
    assert not res["correct"]
    assert res["checks"]["greedy_gap"]["value"] > 1e-3


WIDE_DENSE = copy.deepcopy(TINY_DENSE)
WIDE_DENSE["target"].update(d_model=512, d_ff=1024, vocab=8192, head_dim=128)
WIDE_DENSE["draft"].update(d_model=256, d_ff=512, vocab=8192, head_dim=128)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_the_control_takes_the_compared_names(temperature):
    """With the control on, the compared names hold the float8 reference's
    numbers and ``correct`` is judged on them; the program's readings stay
    beside them. At the greedy cell's own limit the control of a tiny pair
    comes out not correct (the sampled cells' control is read at the
    cell's own size on the card)."""
    cell = "qwen14b-gsm8k-t1-rate" if temperature else \
        "qwen14b-cnndm-greedy-paged-batch"
    limits = run.load_json(ROOT / "bench" / "cells" / f"{cell}.json")["limits"]
    res = measure(WIDE_DENSE, temperature, limits, control=True,
                  policy="static", sample=12)
    nums = res["numbers"]
    for k, lim in limits.items():
        assert nums["program_" + k] <= lim
        assert res["checks"][k]["value"] == nums[k] != nums["program_" + k]
    if temperature:
        assert nums["accept_z"] is not None
        assert res["correct"] == all(nums[k] <= lim
                                     for k, lim in limits.items())
    else:
        assert nums["greedy_gap"] > limits["greedy_gap"]
        assert not res["correct"], res["checks"]


def _break(monkeypatch, fault):
    """Break each session of the measured window (not the warm-up)."""
    instrument = serve.Recorder.instrument

    def broken(self, sess):
        fault(sess)
        return instrument(self, sess)

    monkeypatch.setattr(serve.Recorder, "instrument", broken)


def _unchanged(sess):
    sess.run_chunk = lambda policy, max_iters=None, q_depth=0.0: \
        sess.sync_every


def _half_left_out(sess):
    chunk = sess.run_chunk

    def run_chunk(policy, max_iters=None, q_depth=0.0):
        sess._done[1::2] = True
        return chunk(policy, max_iters=max_iters, q_depth=q_depth)
    sess.run_chunk = run_chunk


def _token_altered(sess):
    chunk = sess.run_chunk

    def run_chunk(policy, max_iters=None, q_depth=0.0):
        n = chunk(policy, max_iters=max_iters, q_depth=q_depth)
        for j, rec in enumerate(sess._slots):
            if rec is not None and rec.produced > 1:
                v = sess._out_buf[j, rec.produced - 1]
                sess._out_buf[j, rec.produced - 1] = (v + 1) % 256
        return n
    sess.run_chunk = run_chunk


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _token_altered])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault,
                                            temperature):
    _break(monkeypatch, fault)
    # a static window speculates every round, so the sampled check has
    # post-rejection tokens to judge
    res = measure(TINY_DENSE, temperature,
                  GREEDY if temperature == 0 else SAMPLED, policy="static")
    assert not res["correct"], res["checks"]


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """One short run of the first cell on the card prints a correct line."""
    import subprocess
    import sys
    res = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "qwen14b-gsm8k-t1-rate", "--seed", "12345",
                          "--seconds", "10", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", ["qwen14b-gsm8k-t1-rate",
                                  "qwen14b-cnndm-greedy-paged-batch"])
def test_the_control_is_not_correct_on_the_card(card, cell):
    """The float8 reference in the program's place at the cell's own size
    and load (a short window) comes out not correct."""
    import subprocess
    import sys
    res = subprocess.run([sys.executable, "bench/run.py", "--workload", cell,
                          "--seed", "2718281828", "--seconds", "20",
                          "--trace", "0", "--control", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert not line["correct"], line["checks"]
