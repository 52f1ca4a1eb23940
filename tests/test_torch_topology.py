"""The port's topology layer (``repro_torch.topology``), its wave server and
its topology launcher against the JAX reference's, on the CPU.

- Both example topologies load, validate and serialize to the reference's
  JSON byte for byte, and round-trip; ``one_pair_spec`` equals the
  reference's for the launcher's flag combinations.
- Every validation error of the reference is raised with the same message
  (one parametrised test); the smart router and a fleet trace validate as
  the reference's do.
- ``node_seed``: the documented per-node derivation, and a one-pair
  deployment draws the engine's own default weights.
- A tiny two-pair deployment (the shape of ``examples/cluster_2pair.json``:
  one shared target node, two drafts over a 2 ms and a 40 ms link, AWC)
  and a wave server, each on weights bridged from the reference, serve the
  reference's tokens per request.
- ``launch.serve --topology`` and ``--server wave`` on the CPU.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import topology as jtopo
from repro.configs.base import ModelConfig as JCfg
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core.window import StaticWindowPolicy as JStatic
from repro.models.model import Model as JModel
from repro.serving import ServeRequest as JRequest
from repro.serving import ServerConfig as JServerConfig
from repro.serving import WaveSpecDecodeServer as JWave
from repro_torch import topology as ttopo
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.window import StaticWindowPolicy
from repro_torch.launch import serve
from repro_torch.serving import (ServeRequest, ServerConfig,
                                 WaveSpecDecodeServer)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["cluster_2pair.json", "cluster_2pair_procs.json"]
TARGET = dict(name="t", arch_type="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
              dtype="float32", remat=False, qk_norm=True)
DRAFT = dict(TARGET, name="d", n_layers=1, n_kv_heads=2, qk_norm=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tiny models: faster than many,
    and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_topologies_round_trip_byte_equal(name):
    path = str(ROOT / "examples" / name)
    ours = ttopo.ClusterSpec.load(path).validate()
    ref = jtopo.ClusterSpec.load(path).validate()
    assert ours.to_json() == ref.to_json()
    again = ttopo.ClusterSpec.from_json(ours.to_json())
    assert again == ours and again.to_json() == ours.to_json()


FLAGS = [dict(), dict(link_rtt_ms=15.0, mode_policy="pipeline"),
         dict(link_rtt_ms=0.0, policy="awc", gamma=6, max_batch=2),
         dict(server="wave", requests=3, max_new=9, arrival_rate=2.5,
              temperature=0.7, seed=4)]


@pytest.mark.parametrize("i", range(len(FLAGS)))
def test_one_pair_spec_matches_reference(i):
    kw = FLAGS[i]
    ours = ttopo.one_pair_spec(**kw).validate()
    assert ours.to_json() == jtopo.one_pair_spec(**kw).validate().to_json()


def _base(pkg):
    return pkg.ClusterSpec.load(str(ROOT / "examples" / "cluster_2pair.json"))


def _set(obj, path, value):
    *head, last = path
    for k in head:
        obj = obj[k] if isinstance(obj, list) else getattr(obj, k)
    if isinstance(obj, list):
        obj[last] = value
    else:
        setattr(obj, last, value)


# each case: the (attribute path, value) edits that break the spec
INVALID = {
    "no nodes": [(("nodes",), [])],
    "no pairs": [(("pairs",), [])],
    "empty node id": [(("nodes", 0, "id"), "")],
    "duplicate node": [(("nodes", 1, "id"), "edge-lan")],
    "bad role": [(("nodes", 0, "role"), "router")],
    "negative tp": [(("nodes", 0, "tp"), -1)],
    "bad port": [(("nodes", 0, "port"), 70000)],
    "empty pair id": [(("pairs", 0, "id"), "")],
    "duplicate pair": [(("pairs", 1, "id"), "lan")],
    "unknown node ref": [(("pairs", 0, "draft"), "nowhere")],
    "wrong role": [(("pairs", 0, "draft"), "cloud")],
    "negative rtt": [(("pairs", 0, "link", "rtt_ms"), -1.0)],
    "negative jitter": [(("pairs", 0, "link", "jitter_ms"), -0.5)],
    "zero bandwidth": [(("pairs", 0, "link", "bandwidth_gbps"), 0.0)],
    "bad mode": [(("pairs", 0, "mode_policy"), "turbo")],
    "pipeline no link": [(("pairs", 0, "mode_policy"), "pipeline"),
                         (("pairs", 0, "link"), None)],
    "bad window kind": [(("pairs", 0, "window", "kind"), "oracle")],
    "gamma 0": [(("pairs", 0, "window", "gamma"), 0)],
    "process sampled": [(("pairs", 0, "process"), True),
                        (("pairs", 0, "mode_policy"), "distributed"),
                        (("pairs", 0, "window", "kind"), "static"),
                        (("serving", "temperature"), 0.5)],
    "process auto mode": [(("pairs", 0, "process"), True),
                          (("pairs", 0, "window", "kind"), "static")],
    "process awc": [(("pairs", 0, "process"), True),
                    (("pairs", 0, "mode_policy"), "distributed")],
    "process wave": [(("pairs", 0, "process"), True),
                     (("pairs", 0, "mode_policy"), "distributed"),
                     (("pairs", 0, "window", "kind"), "static"),
                     (("serving", "server"), "wave")],
    "max_batch 0": [(("serving", "max_batch"), 0)],
    "sync_every 0": [(("serving", "sync_every"), 0)],
    "pad_to 0": [(("serving", "pad_to"), 0)],
    "pipeline gamma_max 1": [(("pairs", 0, "mode_policy"), "pipeline"),
                             (("serving", "gamma_max"), 1)],
    "gamma_max 0": [(("serving", "gamma_max"), 0)],
    "negative temperature": [(("serving", "temperature"), -1.0)],
    "negative rtt_ms": [(("serving", "rtt_ms"), -2.0)],
    "bad server": [(("serving", "server"), "batch")],
    "wave two pairs": [(("serving", "server"), "wave")],
    "bad workload": [(("workload", "max_new"), 0)],
    "prompt range": [(("workload", "prompt_lo"), 48)],
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validation_errors_match_reference(case):
    msgs = []
    for pkg in (jtopo, ttopo):
        spec = _base(pkg)
        for path, value in INVALID[case]:
            _set(spec, path, value)
        with pytest.raises(pkg.TopologyError) as e:
            spec.validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("where", ["pair", "node", "serving"])
def test_unknown_field_errors_match_reference(where):
    d = json.loads((ROOT / "examples" / "cluster_2pair.json").read_text())
    target = {"pair": d["pairs"][0], "node": d["nodes"][0],
              "serving": d["serving"]}[where]
    target["colour"] = "red"
    msgs = []
    for pkg in (jtopo, ttopo):
        with pytest.raises(pkg.TopologyError) as e:
            pkg.ClusterSpec.from_dict(json.loads(json.dumps(d)))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_unported_parts_name_their_roadmap_item():
    """The parts this test once found refused (the smart router, a fleet
    trace) are ported: each validates as the reference does, and a bad
    trace raises the reference's ``workload.trace: …`` message, loaded or
    set in code."""
    for pkg in (jtopo, ttopo):
        spec = _base(pkg)
        spec.serving.router = "smart"
        assert spec.validate().serving.router == "smart"
    msgs = []
    for pkg in (jtopo, ttopo):
        d = json.loads(_base(pkg).to_json())
        d["workload"]["trace"] = {"num_requests": 3, "rate_per_s": 2.0}
        assert pkg.ClusterSpec.from_dict(d).validate().to_json() == \
            ttopo.ClusterSpec.from_dict(d).to_json()
        d["workload"]["trace"] = {"classes": []}
        spec = pkg.ClusterSpec.from_dict(d)
        with pytest.raises(pkg.TopologyError) as e:
            spec.validate()
        msgs.append(str(e.value))
        d["workload"]["trace"] = {"shape": "hourly"}
        with pytest.raises(pkg.TopologyError) as e:
            pkg.ClusterSpec.from_dict(d).validate()
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]
    assert msgs[0].startswith("workload.trace: ")


def test_node_seed_derivation():
    spec = _base(ttopo)
    spec.seed = 7
    assert [ttopo.node_seed(spec, n.id) for n in spec.nodes] == [7, 9, 8]
    one = ttopo.one_pair_spec(seed=3)
    assert [ttopo.node_seed(one, n.id) for n in one.nodes] == [3, 4]
    # a one-pair deployment draws the engine's own default weights
    cfgs = {"qwen2.5-3b": TCfg(**DRAFT), "qwen3-14b": TCfg(**TARGET)}
    dep = ttopo.build_deployment(one, model_configs=cfgs, device="cpu")
    eng = SpecDecodeEngine(TCfg(**DRAFT), TCfg(**TARGET), seed=3,
                           device="cpu")
    for ours, default in ((dep.pairs[0].engine.draft_params,
                           eng.draft_params),
                          (dep.pairs[0].engine.target_params,
                           eng.target_params)):
        assert ours["embed"].equal(default["embed"])


def _bridged(spec_ref, cfgs):
    """Reference weights per node (drawn by the reference) and the same
    weights as port tensors."""
    jp, tp = {}, {}
    for i, n in enumerate(spec_ref.nodes):
        p = jax.device_get(JModel(cfgs[n.model]).init_params(
            jax.random.PRNGKey(10 + i)))
        jp[n.id] = jax.tree.map(jnp.asarray, p)
        tp[n.id] = params_from_numpy(p, "cpu")
    return jp, tp


def _requests(make, n=6, vocab=128, seed=2):
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(0, vocab, int(rng.integers(5, 14)))
                 .astype(np.int32), int(rng.integers(4, 10)))
            for i in range(n)]


def _serve(server, reqs):
    for r in reqs:
        server.submit(r)
    return {r.request_id: np.asarray(r.tokens).tolist()
            for r in server.run()}


def test_two_pair_deployment_matches_reference():
    """``cluster_2pair.json`` with tiny configs for its model names and
    bridged node weights: the port's deployment (emulated links on the
    virtual clock) serves the reference deployment's tokens per request,
    every pair serves, and the two drafts share the target node's
    weights."""
    jcfgs = {"qwen2.5-3b": JCfg(**DRAFT), "qwen3-14b": JCfg(**TARGET)}
    tcfgs = {"qwen2.5-3b": TCfg(**DRAFT), "qwen3-14b": TCfg(**TARGET)}
    jspec, tspec = _base(jtopo), _base(ttopo)
    jp, tp = _bridged(jspec, jcfgs)
    jdep = jtopo.build_deployment(jspec, model_configs=jcfgs, node_params=jp,
                                  sleep_links=False)
    tdep = ttopo.build_deployment(tspec, model_configs=tcfgs, node_params=tp,
                                  sleep_links=False, device="cpu")
    assert tdep.vocab == jdep.vocab == 128
    ref = _serve(jdep.build_server(), _requests(JRequest))
    server = tdep.build_server()
    ours = _serve(server, _requests(ServeRequest))
    assert ours == ref
    rows = server.pair_summaries()
    assert sorted(rows) == ["lan", "wan"]
    assert all(r["requests"] > 0 for r in rows.values())
    assert rows["wan"]["link_ms"] > rows["lan"]["link_ms"] > 0
    engines = [p.engine for p in tdep.pairs]
    assert engines[0] is not engines[1]
    assert engines[0].target_params is engines[1].target_params


SSM_PAIR = dict(name="ts", arch_type="ssm", n_layers=2, d_model=64,
                n_heads=0, n_kv_heads=0, d_ff=0, vocab=128, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=8, dtype="float32", remat=False,
                tie_embeddings=True)


def _wave_pair(pair: str):
    """(reference engine, port engine): the random tiny pair, or a target
    (dense or ssm) under its noised copy (N(0, (σ·std)²) per tensor, σ
    0.02 dense and 0.2 ssm), whose acceptance lies strictly between 0 and
    1."""
    if pair == "random":
        d_kw, t_kw = DRAFT, TARGET
        t_np = jax.device_get(JModel(JCfg(**TARGET)).init_params(
            jax.random.PRNGKey(1)))
        d_np = jax.device_get(JModel(JCfg(**DRAFT)).init_params(
            jax.random.PRNGKey(2)))
    else:
        d_kw = t_kw = TARGET if pair == "noised" else SSM_PAIR
        t_np = jax.device_get(JModel(JCfg(**t_kw)).init_params(
            jax.random.PRNGKey(1)))
        rng = np.random.default_rng(5)
        sigma = 0.02 if pair == "noised" else 0.2
        d_np = jax.tree.map(lambda a: (a + sigma * a.std() * rng.normal(
            size=a.shape)).astype(a.dtype) if a.ndim else a, t_np)
    jeng = JEngine(JCfg(**d_kw), JCfg(**t_kw),
                   draft_params=jax.tree.map(jnp.asarray, d_np),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=0.0, key=jax.random.PRNGKey(0))
    teng = SpecDecodeEngine(TCfg(**d_kw), TCfg(**t_kw),
                            draft_params=params_from_numpy(d_np, "cpu"),
                            target_params=params_from_numpy(t_np, "cpu"),
                            device="cpu")
    return jeng, teng


@pytest.mark.parametrize("pair", ["random", "noised", "ssm"])
def test_wave_server_matches_reference(pair):
    """The wave server at static γ 3: tokens and per-request acceptance
    rates equal the reference wave server's, on the random pair, a noised
    dense pair and a noised ssm pair (acceptance strictly between 0 and 1
    on the noised ones)."""
    jeng, teng = _wave_pair(pair)

    def rows(server, make):
        for r in _requests(make, n=5):
            server.submit(r)
        return {r.request_id: (np.asarray(r.tokens).tolist(),
                               r.acceptance_rate) for r in server.run()}

    ref = rows(JWave(jeng, JStatic(3), JServerConfig(max_batch=2)),
               JRequest)
    ours = rows(WaveSpecDecodeServer(teng, StaticWindowPolicy(3),
                                     ServerConfig(max_batch=2)),
                ServeRequest)
    assert ours == ref
    if pair != "random":
        rates = [a for _, a in ours.values()]
        assert 0 < sum(rates) < len(rates), rates


def test_wave_server_keeps_one_session(monkeypatch):
    """Every wave of a stream admits into one session, and a second stream
    of the same geometry leases that session's pool from the engine: the
    steps are built (and on the card captured) once; the second stream's
    tokens equal the first's."""
    from repro_torch.serving import server as srv_mod
    built = []

    class Counted(srv_mod.DecodeSession):
        def __init__(self, *a, **kw):
            built.append(kw["capacity"])
            super().__init__(*a, **kw)

    monkeypatch.setattr(srv_mod, "DecodeSession", Counted)
    teng = SpecDecodeEngine(TCfg(**DRAFT), TCfg(**TARGET), seed=3,
                            device="cpu")
    wave = WaveSpecDecodeServer(teng, StaticWindowPolicy(3),
                                ServerConfig(max_batch=2, max_new_cap=9,
                                             max_prompt_len=16))
    first = _serve(wave, _requests(ServeRequest, n=5))
    sess = wave.session
    assert built == [2] and sess.iterations > 0
    (pool,) = [p for ps in teng.pools.values() for p in ps]
    steps = dict(pool.steps)
    assert set(steps) == {"round", "insert"} and not pool.leased
    again = _serve(wave, _requests(ServeRequest, n=5))
    assert built == [2, 2] and wave.session is not sess
    assert [p for ps in teng.pools.values() for p in ps] == [pool]
    assert pool.steps == steps
    assert again == first and len(first) == 5


def test_launcher_topology_and_wave_on_cpu():
    """``launch.serve --topology examples/cluster_2pair.json`` serves both
    pairs; ``--server wave`` serves the one-pair flags wave by wave and
    commits the continuous server's greedy tokens."""
    out = serve.run(["--device", "cpu", "--topology",
                     str(ROOT / "examples" / "cluster_2pair.json"),
                     "--requests", "4", "--max-new", "6"])
    s = out.summary
    assert s["pairs_deployed"] == 2 and s["requests"] == 4
    assert set(s["pairs"]) == {"lan", "wan"} and "policy" not in s
    argv = ["--device", "cpu", "--requests", "3", "--max-new", "6",
            "--max-batch", "2", "--gamma-max", "4"]
    wave = serve.run(argv + ["--server", "wave"])
    cont = serve.run(argv)
    assert wave.summary["server"] == "wave"
    by_id = lambda r: {x.request_id: x.tokens.tolist() for x in r.results}
    assert by_id(wave) == by_id(cont)
    with pytest.raises(SystemExit, match="continuous"):
        serve.run(argv + ["--server", "wave", "--link-rtt-ms", "0"])
