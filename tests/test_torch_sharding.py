"""The port's mesh, partition specs, input shapes and activation hooks
(``repro_torch.launch.mesh``, ``repro_torch.sharding``,
``repro_torch.launch.shapes``) against the reference's: the reference's
``tests/test_sharding.py`` cases for ``fit_spec`` and the shapes table run
against the port, then every assigned arch's fitted specs (parameters,
caches at decode_32k and long_500k, the train state) and input stand-ins
are held equal to the reference's ``ShardingRules`` and ``input_specs``
under both production meshes. Specs key on leaf paths and depth is never
sharded, so each arch runs at its published widths with two layers."""

import dataclasses
import functools

import jax
import pytest
import torch

from repro.configs import ASSIGNED
from repro.configs import get_config as ref_config
from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.launch.shapes import input_specs as ref_input_specs
from repro.models.model import build_model as ref_build_model
from repro.sharding.specs import ShardingRules as RefRules
from repro.sharding.specs import _path_str
from repro.sharding.specs import abstract_mesh as ref_abstract_mesh
from repro.training.optimizer import AdamWConfig as RefAdamW
from repro.training.train_step import init_train_state as ref_train_state
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.shapes import SHAPES, input_specs
from repro_torch.models.model import build_model
from repro_torch.sharding import runtime
from repro_torch.sharding.specs import (NamedSharding, PartitionSpec as P,
                                        ShardingRules, abstract_mesh,
                                        cache_shard_bytes, fit_spec,
                                        leaf_shard_bytes, named_leaves,
                                        shard_bytes, shard_shape)
from repro_torch.training import AdamWConfig, init_train_state

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(multi=False):
    return abstract_mesh(*MESHES["multi" if multi else "single"])


# ----------------------------------------------------------------- fit_spec
# (the reference's cases, tests/test_sharding.py)

def test_fit_spec_keeps_divisible():
    m = _mesh()
    assert fit_spec(m, P("data", "model"), (4096, 11008)) == P("data", "model")


def test_fit_spec_relocates_nondivisible_axis():
    m = _mesh()
    # 40 heads can't shard over model=16 → model moves to head_dim=128
    out = fit_spec(m, P("data", "model", None), (5120, 40, 128))
    assert out == P("data", None, "model")


def test_fit_spec_drops_unplaceable_axis():
    m = _mesh()
    # odd vocab: nothing divides 16 except d_model which is taken
    out = fit_spec(m, P("model", "data"), (51865, 384))
    assert "model" not in [a for a in out if isinstance(a, str)] \
        or out[0] != "model"
    assert out[1] == "data" or out[-1] == "data"


def test_fit_spec_tuple_axis_degrades():
    m = _mesh(multi=True)
    # ('pod','data') = 32 doesn't divide 48 → largest dividing sub-axis (16)
    out = fit_spec(m, P(("pod", "data"), None), (48, 128))
    assert out[0] == "data"


def test_fit_spec_kv_heads_to_head_dim():
    m = _mesh()
    out = fit_spec(m, P("data", None, "model", None), (128, 32768, 8, 128))
    padded = list(out) + [None] * (4 - len(out))
    assert padded[2] != "model"                      # kv dim left unsharded
    assert "model" in [a for a in padded if isinstance(a, str)]
    assert padded[0] == "data"


def test_fit_spec_equals_reference_on_a_grid():
    """Every preferred spec of a small grid, fitted to shapes that divide
    and shapes that don't, equals the reference's ``fit_spec``."""
    from repro.sharding.specs import fit_spec as ref_fit
    from jax.sharding import PartitionSpec as RP
    prefs = [("data", "model"), ("model", None, "data"),
             (("pod", "data"), "model", None), (None, ("pod", "data")),
             (None, "model", "data", None)]
    shapes = [(4096, 11008), (40, 5120, 128), (48, 40, 128), (1, 24),
              (2, 8, 12, 64), (51865, 384)]
    for multi in (False, True):
        m = _mesh(multi)
        rm = ref_abstract_mesh(*MESHES["multi" if multi else "single"])
        for pref in prefs:
            if not multi and any(isinstance(a, tuple) for a in pref):
                continue
            for shape in shapes:
                if len(shape) < len(pref):
                    continue
                want = ref_fit(rm, RP(*pref), shape)
                assert tuple(fit_spec(m, P(*pref), shape)) == tuple(want)


def test_partition_spec_is_a_tuple_of_axes():
    assert P("data", None) == ("data", None)
    assert P(("pod", "data")) == (("pod", "data"),)
    assert repr(P("data", None)) == "P('data', None)"
    with pytest.raises(TypeError):
        P(3)


# --------------------------------------------------------------------- mesh

def test_production_meshes_and_the_host_mesh():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    host = make_host_mesh()
    assert host.axis_names == ("data", "model")
    assert host.size == max(1, torch.cuda.device_count())
    with pytest.raises(ValueError):
        Mesh(("data", "data"), (2, 2))


def test_shard_shape_and_bytes():
    m = _mesh()
    spec = fit_spec(m, P(None, "data", None, "model", None),
                    (2, 128, 512, 8, 128))
    # 8 heads cannot take model=16: it moves to the largest dim it
    # divides, the 512 slots
    assert spec == P(None, "data", "model")
    assert shard_shape(m, spec, (2, 128, 512, 8, 128)) == (2, 8, 32, 8, 128)
    assert shard_bytes(m, spec, (2, 128, 512, 8, 128), torch.bfloat16) \
        == 2 * 8 * 32 * 8 * 128 * 2
    with pytest.raises(ValueError, match="fit the spec"):
        shard_shape(m, P("model"), (40,))
    # a dense cache's k keeps one sink row per device
    k = torch.empty((2, 128, 512, 8, 128), dtype=torch.bfloat16,
                    device="meta")
    assert leaf_shard_bytes(m, k, spec, sink=True) \
        == 2 * 9 * 32 * 8 * 128 * 2


# ------------------------------------------------------------------- shapes

def test_input_shapes_table():
    assert SHAPES["train_4k"].seq_len == 4096
    assert SHAPES["train_4k"].global_batch == 256
    assert SHAPES["prefill_32k"].global_batch == 32
    assert SHAPES["decode_32k"].global_batch == 128
    assert SHAPES["long_500k"].seq_len == 524288
    assert SHAPES["long_500k"].sliding
    assert {k: tuple(dataclasses.astuple(v)) for k, v in SHAPES.items()} \
        == {k: tuple(dataclasses.astuple(v)) for k, v in REF_SHAPES.items()}


def test_decode_specs_are_meta_tensors_only():
    """input_specs allocates nothing: every tensor is on the meta device."""
    cfg = get_config("qwen2.5-3b")
    model = build_model(cfg, "meta")
    spec = input_specs(cfg, SHAPES["decode_32k"], model)
    leaves = [l for _, l in named_leaves(spec["cache"])]
    tensors = [l for l in leaves if isinstance(l, torch.Tensor)]
    assert tensors and all(t.is_meta for t in tensors)
    assert all(isinstance(l, (torch.Tensor, bool)) for l in leaves)
    assert spec["token"].shape == (128,) and spec["token"].is_meta
    spec_l = input_specs(cfg, SHAPES["long_500k"], model)
    assert spec_l["ring"] is True
    assert spec_l["window"] == cfg.serve_sliding_window
    assert spec_l["cache"].k.shape[2] == cfg.serve_sliding_window


def test_ssm_long_context_state_is_o1():
    cfg = get_config("mamba2-130m")
    spec = input_specs(cfg, SHAPES["long_500k"], build_model(cfg, "meta"))
    assert spec["cache"].state.shape == (cfg.n_layers, 1, cfg.ssm_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state)


# ------------------------------------------------- parity with the reference

def _cut(cfg):
    return dataclasses.replace(cfg, n_layers=2)


def _flat(tree) -> dict:
    return {_path_str(p): tuple(l.spec) for p, l in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]}


def _leaf_sig(leaf):
    if isinstance(leaf, (bool, int)):
        return ((), "bool" if isinstance(leaf, bool) else "int")
    return (tuple(int(s) for s in leaf.shape),
            str(leaf.dtype).replace("torch.", ""))


@functools.lru_cache(maxsize=None)
def _reference(arch: str, mesh: str) -> dict:
    """The reference's fitted specs of one arch under one mesh: params,
    caches at decode_32k and long_500k, the train state (built once)."""
    cfg = _cut(ref_config(arch))
    model = ref_build_model(cfg)
    rules = RefRules(ref_abstract_mesh(*MESHES[mesh]), cfg)
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    psh = rules.params_sharding(params)
    out = {"params": _flat(psh)}
    for s in ("decode_32k", "long_500k"):
        spec = ref_input_specs(cfg, REF_SHAPES[s], model)
        out[s] = _flat(rules.cache_sharding(spec["cache"],
                                            REF_SHAPES[s].global_batch))
    state = jax.eval_shape(lambda: ref_train_state(
        model, jax.random.PRNGKey(0), RefAdamW()))
    out["train_state"] = _flat(rules.train_state_sharding(state, psh))
    return out


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_fitted_specs_equal_the_reference(arch, mesh):
    """Parameter, cache (decode_32k, long_500k) and train-state specs of
    the port's rules equal the reference's ``ShardingRules``, leaf for leaf
    as tuples."""
    want = _reference(arch, mesh)
    cfg = _cut(get_config(arch))
    model = build_model(cfg, "meta")
    rules = ShardingRules(abstract_mesh(*MESHES[mesh]), cfg)
    as_tuples = lambda d: {k: tuple(v) for k, v in d.items()}
    psh = rules.params_sharding(model.init_params(0))
    assert as_tuples(psh) == want["params"]
    for s in ("decode_32k", "long_500k"):
        spec = input_specs(cfg, SHAPES[s], model)
        got = rules.cache_sharding(spec["cache"], SHAPES[s].global_batch)
        assert as_tuples(got) == want[s], s
    state = init_train_state(model, 0, AdamWConfig())
    assert as_tuples(rules.train_state_sharding(state, psh)) \
        == want["train_state"]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_equal_the_reference(arch):
    """Every input stand-in of the four shapes has the reference's shape
    and dtype; caches leaf for leaf under the reference's paths."""
    rcfg, cfg = _cut(ref_config(arch)), _cut(get_config(arch))
    rmodel, model = ref_build_model(rcfg), build_model(cfg, "meta")
    for name in SHAPES:
        want_spec = ref_input_specs(rcfg, REF_SHAPES[name], rmodel)
        got_spec = input_specs(cfg, SHAPES[name], model)
        assert set(got_spec) == set(want_spec), name
        for k, w in want_spec.items():
            g = got_spec[k]
            if k == "cache":
                want = {_path_str(p): _leaf_sig(l) for p, l in
                        jax.tree_util.tree_flatten_with_path(w)[0]}
                got = {p: _leaf_sig(l) for p, l in named_leaves(g)}
                assert got == want, (name, k)
            elif hasattr(w, "shape"):
                assert _leaf_sig(g) == _leaf_sig(w), (name, k)
            else:
                assert g == w, (name, k)


# --------------------------------------------------------- activation hooks

def test_hooks_return_their_tensor_untouched_and_record_in_the_dryrun():
    x = torch.zeros((2, 1024, 64))
    assert runtime.constrain(x) is x                  # nothing installed
    assert runtime.constrain_qkv(x) is x
    m = _mesh()
    act = NamedSharding(m, P("data", "model", None))
    qkv = NamedSharding(m, P("data", None, "model", None))
    with runtime.activation_sharding(act, qkv=qkv, batch_scale=8) as rec:
        assert runtime.constrain(x) is x
        q = torch.zeros((2, 1024, 40, 128))
        assert runtime.constrain_qkv(q) is q
        runtime.constrain_logits(x)                   # not installed: no-op
    assert runtime.constrain(x) is x and runtime._RECORD is None
    rows = {r["hook"]: r for r in rec.rows()}
    # fitted to the global shape: 2 rows × 8 replicas
    assert rows["residual"]["shape"] == [16, 1024, 64]
    assert rows["residual"]["spec"] == ["data", "model"]
    # 40 heads do not take model=16: it moves to the largest dim it
    # divides, the 1024 positions
    assert rows["qkv"]["spec"] == ["data", "model"]
    assert rec.axes_used("qkv") == {"data", "model"}
    assert set(rows) == {"residual", "qkv"}


def test_cache_shard_bytes_sum_the_leaves():
    m = _mesh()
    cfg = get_config("qwen2.5-3b")
    cache = build_model(cfg, "meta").init_cache(128, 1024)
    specs = ShardingRules(m, cfg).cache_sharding(cache, 128)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    # batch over data (128 / 16 = 8 rows, + the sink row); the 2 kv heads
    # cannot take model=16: it moves to the 1024 slots, pos_map's too
    kv_bytes = L * 9 * (1024 // 16) * kv * hd * 2
    pm_bytes = L * 9 * 1024 * 4
    assert cache_shard_bytes(m, cache, specs) == 2 * kv_bytes + pm_bytes
