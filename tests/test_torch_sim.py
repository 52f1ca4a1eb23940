"""DSD-Sim in the port (``repro_torch.sim``) against the JAX reference's
``repro.sim``, on the CPU: host code only, so every number must be equal.

- The event core's ordering cases (timeouts at one time in insertion
  order, a blocking ``Store.get``, a process join, ``run(until=)``) log the
  same events.
- The mini-YAML reader parses to equal documents; the hardware model's
  prefill/decode/verify times are equal over the catalog's models and
  devices; ``fleet_trace_records`` and ``WorkloadGenerator`` give equal
  records.
- ``Analyzer.summary()`` (NaN-aware) and ``to_json()`` are equal for
  ``simulate_from_yaml`` on the reference test's document and its variants
  (dynamic and AWC windows, the pipelined overlap, routing and batching
  kinds), and for ``topology.build_simulation`` on
  ``examples/fleet_cluster.json`` under the smart and least-loaded pair
  routers, on ``examples/cluster_2pair.json``, and on a spec with a fused
  and a distributed pair (``_ForceDistributed`` and
  ``PairDispatchWindowPolicy``).
"""

import math
import random
from pathlib import Path

import pytest

from repro import fleet as jfleet
from repro import sim as jsim
from repro import topology as jtopo
from repro.core import window as jwindow
from repro_torch import fleet as tfleet
from repro_torch import sim as tsim
from repro_torch import topology as ttopo
from repro_torch.core import window as twindow
from repro_torch.core.awc import model as tawc

ROOT = Path(__file__).resolve().parents[1]


def same(a, b) -> bool:
    """Deep equality with NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def assert_same_run(ours, ref):
    assert same(ours.summary(), ref.summary())
    assert ours.to_json() == ref.to_json()


# ------------------------------------------------------------- event core

def _timeouts(sim):
    env, log = sim.Environment(), []

    def proc(name, delay):
        yield env.timeout(delay)
        log.append((name, env.now))

    env.process(proc("b", 2.0))
    env.process(proc("a", 1.0))
    env.process(proc("c", 2.0))   # same time as b: insertion order
    env.run()
    return log


def _store(sim):
    env = sim.Environment()
    store, got = sim.Store(env), []

    def consumer():
        item = yield store.get()
        got.append((item, env.now))

    def producer():
        yield env.timeout(5.0)
        store.put("x")
        yield env.timeout(1.0)
        store.put("y")

    env.process(consumer())
    env.process(consumer())
    env.process(producer())
    env.run()
    return got


def _join(sim):
    env, order = sim.Environment(), []

    def child():
        yield env.timeout(3.0)
        order.append("child")
        return 42

    def parent():
        result = yield env.process(child())
        order.append(("parent", result, env.now))

    env.process(parent())
    env.run()
    return order


def _until(sim):
    env, ticks = sim.Environment(), []

    def proc():
        for _ in range(10):
            yield env.timeout(1.0)
            ticks.append(env.now)

    env.process(proc())
    env.run(until=4.5)
    return ticks, env.now


EVENT_CASES = {"timeouts": (_timeouts, [("a", 1.0), ("b", 2.0), ("c", 2.0)]),
               "store": (_store, [("x", 5.0), ("y", 6.0)]),
               "join": (_join, ["child", ("parent", 42, 3.0)]),
               "until": (_until, ([1.0, 2.0, 3.0, 4.0], 4.5))}


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_event_core_ordering_matches_reference(case):
    run, want = EVENT_CASES[case]
    assert run(tsim) == run(jsim) == want


def test_link_delivery_matches_reference():
    out = []
    for sim in (jsim, tsim):
        env = sim.Environment()
        link = sim.Link(env, sim.LinkSpec(rtt_ms=12.0, jitter_ms=2.0,
                                          bandwidth_gbps=0.1),
                        random.Random(3))
        got = []
        for n in (64, 4096, 100):
            link.send(n, lambda n=n: got.append((n, env.now)))
        hidden = link.charge(256)
        link.record_rtt(10.0 + hidden)
        env.run()
        out.append((got, link.bytes_sent, link.messages_sent,
                    link.recent_rtt_ms, link.last_delay_ms))
    assert out[0] == out[1]


# ---------------------------------------------------------- mini-YAML, hw

YAML_DOCS = ["""
# comment
cluster:
  targets: {count: 2, hw: A100, tp: 4}
  link:
    rtt_ms: 10.5
    jitter_ms: 0
policies:
  routing: jsq   # inline comment
list_field:
  - 1
  - two
  - {a: 3}
flag: true
none_field: null
""", """
workload: {dataset: humaneval, rate_per_s: 10, num_requests: 20, seed: 1}
inline: [1, 2.5, "q", false]
nested:
  deeper:
    deepest: {x: -3, y: 1e-3}
"""]


@pytest.mark.parametrize("i", range(len(YAML_DOCS)))
def test_mini_yaml_matches_reference(i):
    ours, ref = tsim.loads(YAML_DOCS[i]), jsim.loads(YAML_DOCS[i])
    assert same(ours, ref) and ours


def test_hardware_model_times_match_reference():
    assert sorted(tsim.MODELS) == sorted(jsim.MODELS)
    assert sorted(tsim.DEVICES) == sorted(jsim.DEVICES)
    ours, ref = tsim.HardwareModel(), jsim.HardwareModel()
    for dev in sorted(tsim.DEVICES):
        assert vars(tsim.DEVICES[dev]) == vars(jsim.DEVICES[dev])
        for model in sorted(tsim.MODELS):
            for tp in (1, 4):
                assert ours.prefill_ms(dev, model, [17, 230], tp) == \
                    ref.prefill_ms(dev, model, [17, 230], tp)
                for toks in (None, [5, 5, 1]):
                    assert ours.decode_ms(dev, model, [40, 300, 2], toks,
                                          tp) == \
                        ref.decode_ms(dev, model, [40, 300, 2], toks, tp)
    for model in sorted(tsim.MODELS):
        assert vars(tsim.MODELS[model]) == vars(jsim.MODELS[model])
    cal = []
    for hw, sim in ((ours, tsim), (ref, jsim)):
        samples = [
            ("prefill", "A100", sim.OpShape([0], [64]), "llama2-7b", 0.004),
            ("prefill", "A100", sim.OpShape([0], [512]), "llama2-7b", 0.02),
            ("decode", "A40", sim.OpShape([100], [1]), "llama2-7b", 9e-4)]
        cal.append((hw.fit_calibration(samples),
                    hw.mean_abs_pct_error(samples),
                    hw.decode_ms("A40", "llama2-7b", [64, 64])))
    assert same(cal[0], cal[1])


def test_fleet_trace_records_match_reference():
    for case in (dict(shape="burst", num_requests=12, rate_per_s=50.0),
                 dict(shape="diurnal", num_requests=9, rate_per_s=20.0,
                      seed=5)):
        ours = tfleet.fleet_trace_records(tfleet.generate_requests(
            tfleet.TraceSpec(**case)), seed=2, max_gamma=8)
        ref = jfleet.fleet_trace_records(jfleet.generate_requests(
            jfleet.TraceSpec(**case)), seed=2, max_gamma=8)
        assert [r.to_json() for r in ours] == [r.to_json() for r in ref]
        assert all(r.drafter_id == -1 for r in ours)
    for ds in sorted(tsim.PROFILES):
        ours = tsim.WorkloadGenerator(ds, 12.0, 5, seed=4).generate(10)
        ref = jsim.WorkloadGenerator(ds, 12.0, 5, seed=4).generate(10)
        assert [r.to_json() for r in ours] == [r.to_json() for r in ref]


def test_fused_chunk_constants_agree():
    assert tawc.DEFAULT_FUSED_CHUNK == tsim.network.DEFAULT_FUSED_CHUNK


# --------------------------------------------------------- YAML simulations

DOC = """
cluster:
  targets: {count: 2, hw: A100, model: llama2-70b, tp: 4}
  drafters: {count: 16, hw: A40, model: llama2-7b}
  link: {rtt_ms: 10}
policies:
  routing: %(routing)s
  batching: {kind: %(batching)s, max_batch: 8}
  window: %(window)s
workload: {dataset: humaneval, rate_per_s: 10, num_requests: 20, seed: 1}
"""
YAML_CASES = {
    "reference doc": dict(routing="jsq", batching="lab",
                          window="{kind: static, gamma: 4}"),
    "dynamic": dict(routing="jsq", batching="lab",
                    window="{kind: dynamic, gamma: 3, hi: 0.7, lo: 0.3}"),
    "awc": dict(routing="jsq", batching="lab", window="{kind: awc}"),
    "fifo random": dict(routing="random", batching="fifo",
                        window="{kind: static, gamma: 5}"),
    "round robin": dict(routing="round_robin", batching="fifo",
                        window="{kind: dynamic, gamma: 2}"),
}


@pytest.mark.parametrize("case", sorted(YAML_CASES))
def test_simulate_from_yaml_matches_reference(case):
    text = DOC % YAML_CASES[case]
    ours, ref = tsim.simulate_from_yaml(text), jsim.simulate_from_yaml(text)
    assert ours.summary()["completed"] == 20
    assert_same_run(ours, ref)


@pytest.mark.parametrize("window", ["{kind: static, gamma: 4}",
                                    "{kind: awc}"])
def test_pipelined_simulation_matches_reference(window):
    """The document's simulation with the pipelined overlap model on."""
    text = DOC % dict(routing="jsq", batching="lab", window=window)
    runs = []
    for sim in (tsim, jsim):
        spec = sim.auto_topology(sim.loads(text))
        gen = sim.WorkloadGenerator(spec.workload_dataset,
                                    spec.workload_rate,
                                    spec.cluster.num_drafters, seed=spec.seed)
        runs.append(sim.DSDSimulation(
            spec.cluster, spec.policies, gen.generate(spec.num_requests),
            seed=spec.seed, fused_chunk=spec.fused_chunk,
            pipeline=True).run())
    assert runs[0].summary()["pipeline_hits"] + \
        runs[0].summary()["pipeline_misses"] > 0
    assert_same_run(*runs)


# ------------------------------------------------------ topology simulations

def _load(pkg, name):
    return pkg.ClusterSpec.load(str(ROOT / "examples" / name))


@pytest.mark.parametrize("router", ["smart", "least-loaded"])
def test_fleet_cluster_simulation_matches_reference(router):
    ours = ttopo.build_simulation(_load(ttopo, "fleet_cluster.json"),
                                  pair_router=router)
    ref = jtopo.build_simulation(_load(jtopo, "fleet_cluster.json"),
                                 pair_router=router)
    a, b = ours.run(), ref.run()
    assert a.summary()["slo"]["graded"] > 0
    assert_same_run(a, b)
    lanes = [m.drafter_id for m in a.requests.values()]
    assert lanes == [m.drafter_id for m in b.requests.values()]


def test_cluster_2pair_simulation_matches_reference():
    spec = _load(ttopo, "cluster_2pair.json")
    a = ttopo.build_simulation(spec).run()
    b = jtopo.build_simulation(_load(jtopo, "cluster_2pair.json")).run()
    assert a.summary()["completed"] == spec.workload.num_requests
    assert_same_run(a, b)


def _mixed(pkg):
    """cluster_2pair with a fused pair beside a distributed one whose
    window is dynamic: the per-pair dispatch and the forced mode."""
    spec = _load(pkg, "cluster_2pair.json")
    spec.pairs[0].mode_policy = "fused"
    spec.pairs[1].mode_policy = "distributed"
    spec.pairs[1].window = pkg.WindowSpec("dynamic", 3)
    spec.workload.num_requests = 12
    spec.workload.rate_per_s = 30.0
    return spec


def test_fused_and_distributed_pairs_match_reference():
    ours, ref = ttopo.build_simulation(_mixed(ttopo)), \
        jtopo.build_simulation(_mixed(jtopo))
    window = ours.policies.window
    assert isinstance(window, ttopo.PairDispatchWindowPolicy)
    assert isinstance(window.per_pair[0], twindow.OracleStaticPolicy)
    assert isinstance(window.per_pair[1], ttopo._ForceDistributed)
    assert window.name() == ref.policies.window.name()
    a, b = ours.run(), ref.run()
    assert_same_run(a, b)
    # the forced-distributed wrapper coerces a fused decision
    feats = twindow.FeatureSnapshot(0.0, 0.1, 40.0, 10.0, 4)
    forced = ttopo._ForceDistributed(twindow.OracleStaticPolicy(1,
                                                                fused=True))
    ref_forced = jtopo._ForceDistributed(jwindow.OracleStaticPolicy(
        1, fused=True))
    d = forced.decide("0->0", feats)
    assert (d.gamma, d.mode) == (1, "distributed")
    assert vars(d) == vars(ref_forced.decide(
        "0->0", jwindow.FeatureSnapshot(0.0, 0.1, 40.0, 10.0, 4)))
