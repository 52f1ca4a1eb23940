"""The port's memory-fit dry-run on the meta device
(``repro_torch.launch.dryrun``): rows for a dense and an SSM arch whose
static bytes equal the sum of the leaves' shard bytes worked out from the
specs, FLOPs held to an analytic count, the depth and window
extrapolations held to direct traces, the live-bytes tracker on CPU
tensors and its FLOPs to ``FlopCounterMode``'s, the kernel wrappers' meta branch, the CLI and the train
launcher's ``--production-lower``. Nothing here allocates a full-size
tensor: every step runs on meta tensors."""

import dataclasses
import json
import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import (LiveBytes, Step, depth_plan, main,
                                       micro_steps, run_one)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, InputShape, input_specs
from repro_torch.models.model import build_model
from repro_torch.sharding.specs import (ShardingRules, named_leaves,
                                        shard_shape)


def _bytes_by_hand(arch: str, shape: str, mesh_kind: str) -> int:
    """Parameters and the decode cache at their fitted shard sizes (a
    dense cache's k/v/pos_map with one sink row per device), and the
    token and position vectors of one device, each rounded up to the
    allocator's 512-byte block."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    rules = ShardingRules(mesh, cfg)
    model = build_model(cfg, "meta")
    total = 0
    for path, leaf in named_leaves(model.init_params(0)):
        spec = rules.fit(rules.param_spec(path, leaf.dim()), leaf.shape)
        total += math.prod(shard_shape(mesh, spec, tuple(leaf.shape))) \
            * leaf.dtype.itemsize
    B = SHAPES[shape].global_batch
    cache = input_specs(cfg, SHAPES[shape], model)["cache"]
    specs = rules.cache_sharding(cache, B)
    for path, leaf in named_leaves(cache):
        if not isinstance(leaf, torch.Tensor):
            continue
        local = list(shard_shape(mesh, specs[path], tuple(leaf.shape)))
        if path.split("/")[-1] in ("k", "v", "pos_map"):
            local[1] += 1
        total += math.prod(local) * leaf.dtype.itemsize
    b_dev = B // 16 if B % 16 == 0 else B
    return total + 2 * (-(-b_dev * 4 // 512) * 512)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_decode_row_fits_and_its_static_bytes_are_the_shards(arch):
    row = run_one(arch, "decode_32k", "single")
    assert row["ok"], row.get("error")
    assert row["fits"] and row["devices"] == 256
    assert row["collectives"] is None and "HLO" in row["collectives_note"]
    assert row["per_device_batch"] == 8 and row["micro_steps"] == 1
    mem = row["memory"]
    assert mem["argument_bytes"] == _bytes_by_hand(arch, "decode_32k",
                                                   "single")
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"]
                                          + mem["output_bytes"]
                                          + mem["temp_bytes"])
    # the logits of one device's rows, float32
    V = get_config(arch).vocab
    assert mem["output_bytes"] == -(-8 * V * 4 // 512) * 512
    assert set(mem["exact"]) >= {"parameters", "caches"}
    assert mem["estimated"] == ["activations"]
    assert row["meta_flops"] > 0 and row["flops_per_device"] == \
        row["meta_flops"] * 16 / 256


def test_prefill_flops_are_the_analytic_count():
    """qwen2.5-3b's chunked prefill of 4096 tokens on one device: the FLOP
    counter sees exactly the matmuls of every layer at every token, the lm
    head over the last 1024-token window, and the plain attention's two
    products against every slot (4096 + 128), within 3 % of 2 · active
    params · tokens."""
    cfg = get_config("qwen2.5-3b")
    row = run_one("qwen2.5-3b", InputShape("prefill_4k", 4096, 16,
                                           "prefill"), "single")
    assert row["ok"], row.get("error")
    T, slots, b = 4096, 4096 + 128, row["per_device_batch"]
    D, H, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = D * H * hd + 2 * D * kv * hd + H * hd * D + 3 * D * cfg.d_ff
    want = b * (2 * per_layer * cfg.n_layers * T
                + 2 * D * cfg.vocab * 1024
                + 4 * T * slots * H * hd * cfg.n_layers)
    assert row["meta_flops"] == want
    ratio = row["meta_flops"] / (2 * cfg.active_param_count() * T * b)
    assert 1.0 <= ratio <= 1.03, ratio


def test_depth_and_window_extrapolation_equal_direct_traces():
    """A 4-layer prefill of 3 windows, traced at depths 1 and 2 and at one
    and two windows, gives the FLOPs of tracing all of it; so does a train
    step traced at two of its four micro-steps."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=4)
    mesh = make_production_mesh()
    for shape in (InputShape("p3", 3072, 16, "prefill"),
                  InputShape("t", 1024, 1024, "train")):
        step = Step(cfg, shape, mesh)
        assert step.micro == (4 if shape.kind == "train" else 1)
        got = dryrun._trace(step)
        direct = dryrun._trace_once(Step(cfg, shape, mesh))
        assert got["traced_depths"] == [1, 2]
        assert got["flops"] == direct["flops"], shape.name


def test_depth_plans_match_each_family():
    for arch in ("qwen3-14b", "zamba2-1.2b", "whisper-tiny"):
        cfg = get_config(arch)
        cfgs, feats, target = depth_plan(cfg)
        w = dryrun._combine(feats, target)
        for i in range(len(target)):
            assert abs(sum(wi * f[i] for wi, f in zip(w, feats))
                       - target[i]) < 1e-9


def test_micro_step_rule_is_the_reference():
    assert micro_steps(256, 16, 4096) == 4
    assert micro_steps(256, 32, 4096) == 2
    assert micro_steps(8, 1, 1024) == 1
    assert micro_steps(48, 16, 8192) == 1        # 3 rows a device: 1 fits


def test_live_bytes_counts_allocations_until_freed():
    static = torch.zeros(1000)
    with LiveBytes(static=[static]) as live:
        a = torch.ones(1000)                      # 4000 B → 4096
        b = a + 1                                 # 4096
        view = a[10:]                             # a view: no new storage
        static.add_(1)                            # in place: not counted
        del a, view
        c = torch.ones(10)                        # 40 B → 512
        del b
    assert live.peak == 4096 * 2                  # a and b together
    assert live.live == 512
    del c


@pytest.mark.parametrize("arch,shape", [("qwen2.5-3b", "train_4k"),
                                        ("mamba2-130m", "train_4k"),
                                        ("qwen2.5-3b", "decode_32k")])
def test_live_bytes_flops_equal_flop_counter_mode(arch, shape):
    """LiveBytes applies ``torch.utils.flop_counter``'s formulas inside its
    own dispatch; ``FlopCounterMode`` over the same meta step (one layer,
    one micro-step) counts the same total, so a change in how the torch at
    hand registers its formulas shows here and not as moved rows."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    step = Step(cfg, SHAPES[shape], make_production_mesh(), trace_micro=1)
    grad = torch.enable_grad if SHAPES[shape].kind == "train" \
        else torch.no_grad
    with grad(), LiveBytes(static=step.static) as live:
        step.fn()
    with grad(), FlopCounterMode(display=False) as counter:
        step.fn()
    assert live.flops > 0
    assert live.flops == counter.get_total_flops()


def test_kernel_wrappers_take_meta_tensors_by_name():
    """Each wrapper's meta branch: the plain version's output shape, no
    launch counted, and a device it does not take still raises."""
    from repro_torch.kernels.decode_attn import (decode_attn_call,
                                                 paged_decode_attention)
    from repro_torch.kernels.ssd import (ssd_bwd_call, ssd_call,
                                         ssd_chunked_kernel)
    from repro_torch.kernels.verify.tree import (tree_accept, tree_argmax,
                                                 tree_verify_fused)
    from repro_torch.kernels.verify.verify import cdf_sample, gather_reduce
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    i32 = torch.int32
    before = dict(kernels.LAUNCHES)
    B, T, Hkv, G, hd, S = 2, 3, 2, 2, 64, 40
    assert decode_attn_call(m(B, T, Hkv, G, hd), m(B, S, Hkv, hd),
                            m(B, S, Hkv, hd), m(B, S, dt=i32),
                            m(B, T, dt=i32)).shape == (B, T, Hkv, G, hd)
    NB, bs = 6, 16
    assert paged_decode_attention(
        m(B, T, Hkv, G, hd), m(NB + 1, bs, Hkv, hd), m(NB + 1, bs, Hkv, hd),
        None, None, m(NB + 1, bs, dt=i32), m(B, 3, dt=i32), m(B, T, dt=i32),
        48).shape == (B, T, Hkv, G, hd)
    V = 50
    assert tree_argmax(m(B, T, V)).shape == (B, T)
    bits = lambda *s: m(*s, dt=torch.bool)
    n_acc, _, _ = tree_accept(m(B, T, dt=i32), m(B, T, dt=i32), m(T, dt=i32),
                              m(T, dt=i32), bits(T), bits(T, T))
    assert n_acc.shape == (B,)
    n_acc, _, _ = tree_verify_fused(m(B, T, dt=i32), m(B, T, V),
                                    m(T, dt=i32), m(T, dt=i32), bits(T),
                                    bits(T, T))
    assert n_acc.shape == (B,)
    p_at, _, _ = gather_reduce(m(B, T, dt=i32), m(B, T + 1, V), m(B, T, V))
    assert p_at.shape == (B, T)
    tok = cdf_sample(m(B, dt=i32), m(B, dt=i32), m(B, dt=i32),
                     m(B, T + 1, V), m(B, T, V), m(B))
    assert tok.shape == (B,)
    nh, N, S2 = 2, 16, 130
    ins = (m(B, S2, nh, 16), m(B, S2, N), m(B, S2, N), m(B, S2, nh), m(nh),
           m(B, nh, 16, N))
    y, h = ssd_call(*ins)
    assert y.shape == (B, S2, nh, 16) and h.shape == (B, nh, 16, N)
    grads = ssd_bwd_call(*ins, m(B, S2, nh, 16), m(B, nh, 16, N))
    assert [g.shape for g in grads] == [t.shape for t in ins]
    y, _ = ssd_chunked_kernel(*ins, 64)
    assert y.shape == (B, S2, nh, 16)
    assert kernels.LAUNCHES == before


def test_cli_rows_and_exit_codes(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    assert main(["--arch", "mamba2-130m", "--shape", "long_500k",
                 "--mesh", "single,multi,host", "--out", str(out)]) == 0
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    assert [r["mesh"] for r in rows] == ["single", "multi", "host"]
    assert all(r["ok"] and r["collectives"] is None for r in rows)
    assert rows[2]["devices"] == max(1, torch.cuda.device_count())
    text = capsys.readouterr().out
    assert text.count("[OK]") == 3
    # a failing row is recorded, not raised, and the run exits 1
    assert main(["--arch", "no-such-arch", "--shape", "decode_32k",
                 "--mesh", "single"]) == 1
    assert "[FAIL]" in capsys.readouterr().out


def test_train_launcher_production_lower(capsys):
    from repro_torch.launch import train
    assert train.main(["--arch", "qwen3-14b", "--production-lower"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    row = json.loads(lines[-1])
    assert lines[0].startswith("[OK]")
    assert (row["arch"], row["shape"], row["mesh"]) == ("qwen3-14b",
                                                        "train_4k", "single")
    assert row["ok"] and row["micro_steps"] == 4
    assert row["memory"]["gradient_bytes"] > 0
