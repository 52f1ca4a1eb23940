"""The plain reference equals the port's own float32 forward at a tiny
size, every family; the weights' layout is the port's."""

import json

import pytest
import torch

from conftest import BENCH, ROOT, TINY_DENSE, TINY_SSM

import weights as W
from reference import common, dense, ssm


def _tree(t, p=()):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from _tree(v, p + (k,))
        else:
            yield p + (k,), (tuple(v.shape), v.dtype)


@pytest.mark.parametrize("config", [
    c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())
    ["configs"]])
@pytest.mark.parametrize("side", ["target", "draft"])
def test_layout_is_the_ports(config, side):
    """Shapes and dtypes of every leaf equal the port's init at the
    published sizes (on the meta device: nothing is drawn)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import build_model
    port = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    port = port["port"][side]
    ref = dict(_tree(build_model(ModelConfig(**port), "meta")
                     .init_params(0)))
    s = W.sizes(port)
    dt = W.DTYPES[s["dtype"]]
    mine = {p: (sh, dt if init == "zeros" or isinstance(init, tuple)
                else torch.float32)
            for p, (sh, init) in W._leaves(W.layout(s))}
    assert ref == mine


def test_draw_is_deterministic_and_scaled():
    port = TINY_DENSE["target"]
    a = W.draw(port, 123, "cpu")
    b = W.draw(port, 123, "cpu")
    c = W.draw(port, 124, "cpu")
    assert torch.equal(a["layers"]["mlp"]["w_down"],
                       b["layers"]["mlp"]["w_down"])
    assert not torch.equal(a["embed"], c["embed"])
    big = W.draw({**port, "d_model": 256, "d_ff": 1024}, 5, "cpu")
    assert abs(big["layers"]["mlp"]["w_down"].std().item() * 32 - 1) < 0.05
    assert float(big["layers"]["ln1"].abs().max()) == 0.0
    assert W.side_seeds(2**31 + 3) == W.side_seeds(2**31 + 3)
    assert W.side_seeds(1)["draft"] != W.side_seeds(1)["target"]


@pytest.mark.parametrize("pair,side,family", [
    (TINY_DENSE, "target", dense), (TINY_DENSE, "draft", dense),
    (TINY_SSM, "target", ssm), (TINY_SSM, "draft", ssm)])
def test_reference_equals_the_ports_float32_forward(pair, side, family):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import build_model
    port = pair[side]
    params = W.draw(port, 7, "cpu")
    s = W.sizes(port)
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, s["V"], (n,), generator=g) for n in (9, 21)]
    with torch.no_grad():
        h = family.hidden(params, s, seqs)
        ref = common.head(params, s, h)
        model = build_model(ModelConfig(**port), "cpu")
        off = 0
        for t in seqs:
            got, _ = model.forward_train(params, {"tokens": t[None]})
            torch.testing.assert_close(ref[off:off + len(t)], got[0],
                                       atol=2e-4, rtol=2e-4)
            off += len(t)
        low = common.head(params, s, family.hidden(params, s, seqs,
                                                   q8=True), q8=True)
    assert (low - ref).abs().max() > 1e-2
