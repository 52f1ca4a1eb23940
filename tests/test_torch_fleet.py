"""The port's fleet layer (``repro_torch.fleet``: traces, SLO grading,
rolling windows, the smart router, SLO admission, the elastic pool) and the
fleet serving path, against the JAX reference's on the CPU.

- Trace streams: every load shape and ``examples/fleet_cluster.json``'s
  trace expand to equal :class:`FleetRequest` streams, field by field; the
  reference's invalid traces raise the same messages; ``TraceSpec`` and
  ``ClusterSpec`` (with a trace) serialize to the same JSON bytes;
  ``fleet_serve_requests`` draws the same prompts.
- ``slo_report``, ``RollingQuantile``, ``pair_cost``, ``SmartPairRouter``
  and the server's SLO gate (``_apply_slo_admission``: pass, reroute, shed
  and the shed row) decide as the reference does on equal inputs; the
  elastic pool's control law takes the same decisions and logs the same
  events under a stand-in spawn.
- End to end: a tiny two-pair deployment with the smart router and a burst
  trace through ``repro_torch.launch.serve --device cpu`` and through the
  reference launcher, on the same bridged weights: equal tokens per
  request, equal graded and per-class counts. With the SLO gate rerouting
  (and shedding) the port's served tokens stay the gate-off tokens.
"""

import dataclasses
import functools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro import topology as jtopo
from repro.configs.base import ModelConfig as JCfg
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro.serving import ServeRequest as JRequest
from repro.serving import ServingPair as JPair
from repro.serving import server as jserver
from repro_torch import fleet as tfleet
from repro_torch import topology as ttopo
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.fleet import elastic as telastic
from repro_torch.launch import serve as tserve
from repro_torch.serving import PAIR_ROUTERS, ServeRequest, ServingPair

ROOT = Path(__file__).resolve().parents[1]
FLEET_JSON = ROOT / "examples" / "fleet_cluster.json"
TINY_T = dict(name="fleet-t", arch_type="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, dtype="float32",
              remat=False)
TINY_D = dict(TINY_T, name="fleet-d", n_layers=1)
JTINY = {"fleet-t": JCfg(**TINY_T), "fleet-d": JCfg(**TINY_D)}
TTINY = {"fleet-t": TCfg(**TINY_T), "fleet-d": TCfg(**TINY_D)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tiny models: faster than many,
    and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def two_pair_spec(pkg, rtt_fast=0.0, rtt_slow=40.0, max_batch=2,
                  router="least-loaded"):
    """The reference test's two-pair shape: two one-layer drafts on one
    shared two-layer target, over a fast and a slow link."""
    return pkg.ClusterSpec(
        nodes=[pkg.NodeSpec("e0", "draft", "fleet-d"),
               pkg.NodeSpec("e1", "draft", "fleet-d"),
               pkg.NodeSpec("c0", "target", "fleet-t")],
        pairs=[pkg.PairSpec("fast", "e0", "c0",
                            link=pkg.LinkSpec(rtt_ms=rtt_fast, jitter_ms=0.0),
                            window=pkg.WindowSpec("static", 3)),
               pkg.PairSpec("slow", "e1", "c0",
                            link=pkg.LinkSpec(rtt_ms=rtt_slow, jitter_ms=0.0),
                            window=pkg.WindowSpec("static", 3))],
        serving=pkg.ServingSpec(max_batch=max_batch, gamma_max=6,
                                sync_every=4, router=router),
        workload=pkg.WorkloadSpec(num_requests=4, max_new=8))


def tiny_trace(fleet, **kw):
    kw.setdefault("num_requests", 10)
    kw.setdefault("rate_per_s", 200.0)
    return fleet.TraceSpec(**kw)


def rows(reqs):
    return [dataclasses.astuple(r) for r in reqs]


# ------------------------------------------------------------ trace streams

SHAPES = {
    "constant": dict(shape="constant", seed=1),
    "diurnal": dict(shape="diurnal", diurnal_period_s=5.0,
                    diurnal_amplitude=0.7, seed=7),
    "burst": dict(shape="burst", burst_every_s=0.5, burst_len_s=0.1,
                  burst_multiplier=5.0, num_requests=24, seed=3),
    "replay": dict(shape="replay", replay_arrivals_s=[0.0, 0.1, 0.1, 0.4,
                                                      0.9], num_requests=0),
    "replay classes": dict(shape="replay",
                           replay_arrivals_s=[0.0, 0.2, 0.5],
                           replay_classes=["chat", "batch-offline", "chat"],
                           num_requests=2),
}


def _fleet_trace(pkg):
    return pkg.ClusterSpec.load(str(FLEET_JSON)).workload.trace


@pytest.mark.parametrize("case", sorted(SHAPES) + ["fleet_cluster.json"])
def test_generate_requests_equal_streams(case):
    if case == "fleet_cluster.json":
        ours = tfleet.generate_requests(_fleet_trace(ttopo))
        ref = jfleet.generate_requests(_fleet_trace(jtopo))
    else:
        ours = tfleet.generate_requests(tiny_trace(tfleet, **SHAPES[case]))
        ref = jfleet.generate_requests(tiny_trace(jfleet, **SHAPES[case]))
    assert ours and rows(ours) == rows(ref)
    assert [type(v) for v in dataclasses.astuple(ours[0])] == \
        [type(v) for v in dataclasses.astuple(ref[0])]


# each case: the edit that breaks a tiny trace (the reference test's cases,
# then the replay and burst/diurnal rules)
BAD_TRACES = {
    "negative rate": lambda t: setattr(t, "rate_per_s", -1.0),
    "zero rate": lambda t: setattr(t, "rate_per_s", 0.0),
    "negative count": lambda t: setattr(t, "num_requests", -1),
    "bad shape": lambda t: setattr(t, "shape", "weekly"),
    "no classes": lambda t: setattr(t, "classes", []),
    "amplitude": lambda t: (setattr(t, "shape", "diurnal"),
                            setattr(t, "diurnal_amplitude", 1.5)),
    "period": lambda t: (setattr(t, "shape", "diurnal"),
                         setattr(t, "diurnal_period_s", 0.0)),
    "negative prompt mean": lambda t: setattr(t.classes[0], "prompt_mean",
                                              -3.0),
    "zero output mean": lambda t: setattr(t.classes[0], "output_mean", 0.0),
    "prompt_min 0": lambda t: setattr(t.classes[0], "prompt_min", 0),
    "prompt_max < min": lambda t: setattr(t.classes[0], "prompt_max", 1),
    "negative slo": lambda t: setattr(t.classes[0], "slo_ttft_ms", -1.0),
    "alpha": lambda t: setattr(t.classes[0], "alpha", 1.5),
    "rho": lambda t: setattr(t.classes[0], "rho", 1.0),
    "negative weight": lambda t: setattr(t.classes[0], "weight", -0.1),
    "zero weights": lambda t: [setattr(c, "weight", 0.0) for c in t.classes],
    "empty name": lambda t: setattr(t.classes[0], "name", ""),
    "duplicate": lambda t: setattr(t.classes[1], "name", t.classes[0].name),
    "burst": lambda t: (setattr(t, "shape", "burst"),
                        setattr(t, "burst_multiplier", 0.5)),
    "replay empty": lambda t: setattr(t, "shape", "replay"),
    "replay negative": lambda t: (setattr(t, "shape", "replay"),
                                  setattr(t, "replay_arrivals_s", [-1.0])),
    "replay order": lambda t: (setattr(t, "shape", "replay"),
                               setattr(t, "replay_arrivals_s",
                                       [0.0, 0.5, 0.2])),
    "replay undeclared": lambda t: (setattr(t, "shape", "replay"),
                                    setattr(t, "replay_arrivals_s",
                                            [0.0, 0.2, 0.5]),
                                    setattr(t, "replay_classes",
                                            ["chat", "nope", "chat"])),
    "replay length": lambda t: (setattr(t, "shape", "replay"),
                                setattr(t, "replay_arrivals_s", [0.0, 0.2]),
                                setattr(t, "replay_classes", ["chat"])),
}


@pytest.mark.parametrize("case", sorted(BAD_TRACES))
def test_trace_validation_messages_match_reference(case):
    msgs = []
    for fleet in (jfleet, tfleet):
        t = tiny_trace(fleet)
        BAD_TRACES[case](t)
        with pytest.raises(fleet.WorkloadError) as e:
            t.validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # wrapped by the topology layer as the reference wraps it
    wrapped = []
    for pkg, fleet in ((jtopo, jfleet), (ttopo, tfleet)):
        spec = pkg.ClusterSpec.load(str(FLEET_JSON))
        spec.workload.trace = tiny_trace(fleet)
        BAD_TRACES[case](spec.workload.trace)
        with pytest.raises(pkg.TopologyError) as e:
            spec.validate()
        wrapped.append(str(e.value))
    assert wrapped[0] == wrapped[1] == f"workload.trace: {msgs[0]}"


@pytest.mark.parametrize("bad", [{"burst_hz": 3},
                                 {"classes": [{"name": "x", "color": "r"}]}])
def test_unknown_trace_fields_match_reference(bad):
    msgs = []
    for pkg, fleet in ((jtopo, jfleet), (ttopo, tfleet)):
        with pytest.raises(fleet.WorkloadError) as e:
            fleet.TraceSpec.from_dict(bad)
        msgs.append(str(e.value))
        d = json.loads(FLEET_JSON.read_text())
        d["workload"]["trace"] = bad
        with pytest.raises(pkg.TopologyError) as e:
            pkg.ClusterSpec.from_dict(d)
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


def test_trace_and_cluster_json_bytes_equal():
    # fleet_cluster.json loaded and dumped
    ours = ttopo.ClusterSpec.load(str(FLEET_JSON)).validate()
    ref = jtopo.ClusterSpec.load(str(FLEET_JSON)).validate()
    assert ours.to_json() == ref.to_json()
    assert isinstance(ours.workload.trace, tfleet.TraceSpec)
    assert ours.serving.router == "smart"
    again = ttopo.ClusterSpec.from_json(ours.to_json())
    assert again == ours and again.to_json() == ours.to_json()
    # a trace built in code, alone and inside a spec
    for case in SHAPES.values():
        t, j = tiny_trace(tfleet, **case), tiny_trace(jfleet, **case)
        assert t.to_json() == j.to_json()
        assert tfleet.TraceSpec.from_json(t.to_json()) == t
    spec, jspec = two_pair_spec(ttopo), two_pair_spec(jtopo)
    spec.workload.trace = tiny_trace(tfleet, shape="burst")
    jspec.workload.trace = tiny_trace(jfleet, shape="burst")
    assert spec.validate().to_json() == jspec.validate().to_json()


def test_fleet_serve_requests_equal_prompts():
    ours = tfleet.fleet_serve_requests(
        tfleet.generate_requests(_fleet_trace(ttopo)), vocab=151, seed=5)
    ref = jfleet.fleet_serve_requests(
        jfleet.generate_requests(_fleet_trace(jtopo)), vocab=151, seed=5)
    assert len(ours) == len(ref) == 8
    for a, b in zip(ours, ref):
        assert isinstance(a, ServeRequest)
        assert a.prompt.dtype == b.prompt.dtype
        assert np.array_equal(a.prompt, b.prompt)
        assert (a.request_id, a.max_new_tokens, a.arrival_s,
                a.request_class, a.slo_ttft_ms, a.slo_tpot_ms) == \
            (b.request_id, b.max_new_tokens, b.arrival_s, b.request_class,
             b.slo_ttft_ms, b.slo_tpot_ms)


def test_slo_report_dicts_equal():
    rng = np.random.default_rng(0)
    rows_ = []
    for i in range(40):
        rows_.append({
            "request_class": ["chat", "long", "batch", ""][i % 4],
            "slo_ttft_ms": [100.0, 300.0, 0.0, 50.0][i % 4],
            "slo_tpot_ms": [20.0, 0.0, 0.0, 10.0][i % 4],
            "ttft_ms": float(rng.uniform(0, 400)),
            "tpot_ms": float(rng.uniform(0, 40)),
            "shed": bool(rng.random() < 0.15)})
    rows_.append({"request_class": "chat", "slo_ttft_ms": 100.0})
    assert tfleet.slo_report(rows_) == jfleet.slo_report(rows_)
    assert tfleet.slo_report([]) == jfleet.slo_report([])


def test_rolling_quantile_equal_after_same_pushes():
    rng = np.random.default_rng(1)
    vals = list(rng.uniform(0, 100, 300)) + [float("nan"), float("inf")]
    vals += [5.0] * 7
    ours, ref = tfleet.RollingQuantile(64), jfleet.RollingQuantile(64)
    for k, v in enumerate(vals):
        ours.push(v)
        ref.push(v)
        if k % 17 == 0 or k >= len(vals) - 9:
            for p in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
                assert ours.quantile(p) == ref.quantile(p)
            assert len(ours) == len(ref)
            assert ours.mean() == ref.mean()
    assert repr(ours) == repr(ref)
    empty = tfleet.RollingQuantile()
    assert math.isnan(empty.p95()) and math.isnan(empty.mean())


def test_pair_cost_equal_over_grid():
    for rtt in (0.0, 2.0, 15.0, 40.0, 150.0):
        for alpha in (0.0, 0.3, 0.7, 0.98, 1.0):
            for qf in (0.0, 0.5, 1.0, 1.5):
                for long_ctx in (False, True):
                    for gamma in (1, 4, 8):
                        kw = dict(long_context=long_ctx, gamma_hint=gamma,
                                  step_ms=7.5)
                        assert tfleet.pair_cost(rtt, alpha, qf, **kw) == \
                            jfleet.pair_cost(rtt, alpha, qf, **kw)


class _FakeTransport:
    def __init__(self, rtt):
        self.recent_rtt_ms = rtt


class _FakeSession:
    def __init__(self, capacity=4, accepted=0, proposed=0):
        self.capacity = capacity
        self.accepted = accepted
        self.proposed = proposed


def _fake_pairs(make, specs):
    return [make(pair_id=f"p{i}", engine=None, policy=None,
                 transport=None if rtt is None else _FakeTransport(rtt),
                 session=_FakeSession(cap, acc, prop))
            for i, (rtt, cap, acc, prop) in enumerate(specs)]


ROUTE_CASES = [
    [(2.0, 4, 0, 0), (150.0, 4, 0, 0)],
    [(30.0, 4, 5, 100), (30.0, 4, 95, 100)],
    [(None, 2, 10, 40), (2.0, 2, 30, 40), (40.0, 4, 39, 40)],
    [(0.0, 1, 0, 0), (0.0, 1, 0, 0), (0.0, 1, 0, 0)],
]


@pytest.mark.parametrize("case", range(len(ROUTE_CASES)))
def test_smart_router_picks_equal(case):
    ours = _fake_pairs(ServingPair, ROUTE_CASES[case])
    ref = _fake_pairs(JPair, ROUTE_CASES[case])
    n = len(ours)
    for kw in (dict(), dict(long_prompt_tokens=16, gamma_hint=6)):
        t_router = PAIR_ROUTERS["smart"](**kw)
        j_router = jserver.PAIR_ROUTERS["smart"](**kw)
        for plen in (8, 16, 200):
            req = np.zeros(plen, np.int32)
            for frees in ([4] * n, [0] + [3] * (n - 1), [1] * n,
                          [0] * (n - 1) + [2], [0] * n):
                assert t_router.route(ServeRequest(0, req, 4), ours,
                                      frees) == \
                    j_router.route(JRequest(0, req, 4), ref, frees)


def test_sim_pair_routers_equal():
    from repro.fleet import routing as jrouting
    from repro_torch.fleet import routing as trouting
    assert sorted(trouting.SIM_PAIR_ROUTERS) == \
        sorted(jrouting.SIM_PAIR_ROUTERS)

    class View:
        queue_depths = [3, 0, 5]
        rtt_ms = [2.0, 40.0, 0.5]
        alpha = [0.8, 0.6, 0.3]
        max_batch = 4

    class Rec:
        def __init__(self, n):
            self.prompt_length = n

    for name in trouting.SIM_PAIR_ROUTERS:
        t = trouting.SIM_PAIR_ROUTERS[name]()
        j = jrouting.SIM_PAIR_ROUTERS[name]()
        assert t.name() == j.name()
        for n in (10, 200):
            assert t.route_pair(Rec(n), View) == j.route_pair(Rec(n), View)


# ------------------------------------------------------- SLO-aware admission

@pytest.fixture(scope="module")
def slo_deployments():
    jdep = jtopo.build_deployment(two_pair_spec(jtopo), model_configs=JTINY,
                                  sleep_links=False)
    tdep = ttopo.build_deployment(two_pair_spec(ttopo), model_configs=TTINY,
                                  sleep_links=False, device="cpu")
    return jdep, tdep


class _Clock:
    def now(self):
        return 1.0


# each case: (mode, min samples, pair 0's and pair 1's TTFT window, free
# slots, the request's TTFT SLO)
SLO_CASES = {
    "off": ("off", 2, [500.0] * 4, [10.0] * 4, [2, 2], 100.0),
    "reroute to healthy": ("reroute", 2, [500.0] * 4, [10.0] * 4, [2, 2],
                           100.0),
    "no slo on request": ("reroute", 2, [500.0] * 4, [10.0] * 4, [2, 2],
                          0.0),
    "reroute, none healthy": ("reroute", 2, [500.0] * 4, [800.0] * 4,
                              [2, 2], 100.0),
    "shed, none healthy": ("shed", 2, [500.0] * 4, [800.0] * 4, [2, 2],
                           100.0),
    "shed, healthy pair full": ("shed", 2, [500.0] * 4, [10.0] * 4, [2, 0],
                                100.0),
    "shed, unmeasured pair": ("shed", 2, [500.0] * 4, [], [1, 1], 100.0),
    "too few samples": ("shed", 8, [500.0] * 4, [800.0] * 4, [2, 2], 100.0),
    "routed pair healthy": ("shed", 2, [50.0, 60.0, 70.0], [800.0] * 4,
                            [2, 2], 100.0),
}


def _gate(server, make, case):
    mode, min_samples, q0, q1, frees, slo = SLO_CASES[case]
    server.cfg.slo_admission = mode
    server.cfg.slo_min_samples = min_samples
    for q, vals in zip(server._ttft_q, (q0, q1)):
        for v in vals:
            q.push(v)
    head = make(7, np.zeros(8, np.int32), 4, request_class="chat",
                slo_ttft_ms=slo, slo_tpot_ms=25.0)
    tail = make(8, np.zeros(9, np.int32), 4)
    arrived, pending = [head, tail], [head, tail, make(9, np.zeros(3,
                                                                   np.int32),
                                                       4)]
    got = server._apply_slo_admission(arrived, pending, 0, frees, _Clock())
    shed = [dict(dataclasses.asdict(r), tokens=np.asarray(r.tokens).tolist())
            for r in server.results]
    return (got, [r.request_id for r in arrived],
            [r.request_id for r in pending], shed, list(server._shed))


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_admission_decisions_match_reference(case, slo_deployments):
    jdep, tdep = slo_deployments
    ref = _gate(jdep.build_server(), JRequest, case)
    ours = _gate(tdep.build_server(), ServeRequest, case)
    assert ours == ref
    if case.startswith("shed, none") or case == "shed, healthy pair full":
        assert ours[0] is None and ours[3][0]["shed"]
        assert ours[3][0]["tokens"] == [] and ours[4] == [1, 0]


# ------------------------------------------------------------- elastic pool

class _FakeHandle:
    capacity = 2

    def __init__(self, pair_id, log):
        self.pair_id = pair_id
        self.log = log
        self.alive = True

    def serve(self, reqs):
        import time
        assert self.alive, "drained/reaped pair must receive no new waves"
        self.log.append((self.pair_id, [r.request_id for r in reqs]))
        time.sleep(0.01)
        from repro_torch.serving import ServeResult
        return [ServeResult(request_id=r.request_id,
                            tokens=np.zeros(1, np.int32), ttft_ms=1.0,
                            tpot_ms=1.0, e2e_ms=2.0, acceptance_rate=0.5,
                            pair_id=self.pair_id) for r in reqs]

    def shutdown(self):
        self.alive = False


def _pool(fleet, topo, log, **kw):
    spec = two_pair_spec(topo)
    return fleet.ElasticPairPool(spec, "fast",
                                 spawn_fn=lambda p: _FakeHandle(p.id, log),
                                 tick_s=0.005, **kw)


ELASTIC_CASES = {
    "reap to floor, grow": (dict(min_pairs=1, max_pairs=4,
                                 scale_up_depth=0.5, scale_down_depth=0.5),
                            3, [0, 0, 0, 50, 50, 50, 50, 0, 3]),
    "cap at max": (dict(min_pairs=1, max_pairs=2, scale_up_depth=1.0),
                   1, [10, 10, 10, 4, 0, 0]),
    "floor of two": (dict(min_pairs=2, max_pairs=3, scale_up_depth=2.0,
                          scale_down_depth=0.25), 2,
                     [0, 9, 13, 1, 0, 0, 20]),
}


@pytest.mark.parametrize("case", sorted(ELASTIC_CASES))
def test_elastic_decisions_and_events_match_reference(case):
    kw, ups, backlogs = ELASTIC_CASES[case]
    out = []
    for fleet, topo in ((jfleet, jtopo), (tfleet, ttopo)):
        log = []
        pool = _pool(fleet, topo, log, **kw)
        ids = [pool.scale_up() for _ in range(ups)]
        decisions = [pool.evaluate_scaling(b) for b in backlogs]
        events = [(k, pid) for _, k, pid in pool.events]
        summ = pool.summary()
        summ.pop("events")
        states = dict(pool._state)
        pool.shutdown()
        out.append((ids, decisions, events, summ, states))
    assert out[0] == out[1]
    assert any(d == "up" for d in out[1][1] + ["up"])


def test_elastic_run_serves_everything():
    log = []
    pool = _pool(tfleet, ttopo, log, min_pairs=1, max_pairs=3,
                 scale_up_depth=0.5)
    reqs = [ServeRequest(i, np.zeros(4, np.int32), 4) for i in range(10)]
    results = pool.run(reqs)
    assert [r.request_id for r in results] == list(range(10))
    summ = pool.summary()
    assert 2 <= summ["pairs_spawned"] <= 3
    assert summ["max_concurrent_pairs"] <= 3
    assert sum(len(ids) for _, ids in log) == 10
    assert sum(summ["served"].values()) == 10
    pool.shutdown()


def test_elastic_default_spawn_forwards_device(monkeypatch):
    """The default spawn clones the template under a fresh id and hands
    ``spawn_pair`` the pool's explicit device (the card unless asked)."""
    from repro_torch.distributed import host
    calls = []

    def fake_spawn(spec, pair, *, model_configs=None, device="cuda"):
        calls.append(([p.id for p in spec.pairs], pair.id, device,
                      model_configs))
        return _FakeHandle(pair.id, [])

    monkeypatch.setattr(host, "spawn_pair", fake_spawn)
    spec = ttopo.ClusterSpec.load(str(ROOT / "examples"
                                      / "cluster_2pair_procs.json"))
    for kw, want in ((dict(), "cuda"), (dict(device="cpu"), "cpu")):
        pool = telastic.ElasticPairPool(spec, model_configs=TTINY, **kw)
        pid = pool.scale_up()
        assert calls[-1] == ([pid], pid, want, TTINY)
        assert pid == f"{spec.pairs[0].id}-e1"
        pool.shutdown()


# ------------------------------------------------------------ end to end

def _e2e_spec(pkg, fleet, tmp_path, name):
    spec = two_pair_spec(pkg, rtt_fast=2.0, rtt_slow=40.0, router="smart")
    spec.workload.trace = fleet.TraceSpec(
        classes=[fleet.RequestClass("chat", weight=0.6, prompt_mean=10,
                                    prompt_max=24, output_mean=6,
                                    output_min=2, output_max=10,
                                    slo_ttft_ms=30000.0, slo_tpot_ms=1500.0),
                 fleet.RequestClass("long-context", weight=0.25,
                                    prompt_mean=30, prompt_min=16,
                                    prompt_max=48, output_mean=6,
                                    output_min=2, output_max=10,
                                    slo_ttft_ms=60000.0),
                 fleet.RequestClass("batch-offline", weight=0.15,
                                    prompt_mean=12, output_mean=8,
                                    output_min=2, output_max=10)],
        num_requests=10, rate_per_s=100.0, shape="burst", burst_every_s=0.05,
        burst_len_s=0.02, burst_multiplier=4.0, seed=4)
    path = tmp_path / name
    path.write_text(spec.to_json())
    return path


def _bridged(spec):
    jp, tp = {}, {}
    for i, n in enumerate(spec.nodes):
        p = jax.device_get(JModel(JTINY[n.model]).init_params(
            jax.random.PRNGKey(20 + i)))
        jp[n.id] = jax.tree.map(jnp.asarray, p)
        tp[n.id] = params_from_numpy(p, "cpu")
    return jp, tp


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The tiny smart-router burst spec served by the reference launcher
    and by the port's (``--device cpu``) on the same bridged weights."""
    tmp = tmp_path_factory.mktemp("fleet")
    jpath = _e2e_spec(jtopo, jfleet, tmp, "ref.json")
    tpath = _e2e_spec(ttopo, tfleet, tmp, "port.json")
    assert jpath.read_text() == tpath.read_text()
    jp, tp = _bridged(jtopo.ClusterSpec.load(str(jpath)))
    mp = pytest.MonkeyPatch()
    servers = []
    run = jserver.SpecDecodeServer.run

    def recording_run(self):
        servers.append(self)
        return run(self)

    try:
        mp.setattr(jserver.SpecDecodeServer, "run", recording_run)
        mp.setattr(jserve, "build_deployment", functools.partial(
            jtopo.build_deployment, model_configs=JTINY, node_params=jp,
            sleep_links=False))
        mp.setattr(tserve, "build_deployment", functools.partial(
            ttopo.build_deployment, model_configs=TTINY, sleep_links=False))
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jserve.main(["--topology", str(jpath), "--json"]) == 0
        ref_summary = json.loads(buf.getvalue())
        ref = {r.request_id: np.asarray(r.tokens).tolist()
               for r in servers[0].results}
        out = tserve.run(["--topology", str(tpath), "--device", "cpu",
                          "--json"], node_params=tp)
    finally:
        mp.undo()
    return dict(ref=ref, ref_summary=ref_summary, out=out, tp=tp,
                tpath=tpath)


def test_fleet_launcher_matches_reference(e2e):
    out, ref_s = e2e["out"], e2e["ref_summary"]
    ours = {r.request_id: r.tokens.tolist() for r in out.results}
    assert sorted(ours) == list(range(10))
    assert ours == e2e["ref"]
    s = out.summary
    assert s["slo"]["graded"] == ref_s["slo"]["graded"] > 0
    for cls, row in ref_s["slo"]["per_class"].items():
        assert s["slo"]["per_class"][cls]["requests"] == row["requests"]
        assert s["slo"]["per_class"][cls]["shed"] == row["shed"] == 0
    assert {r.request_class for r in out.results} == \
        set(ref_s["slo"]["per_class"])
    want = {r.request_id: len(r.tokens) for r in out.results}
    assert all(want[q.request_id] == q.max_new_tokens for q in out.requests)
    assert set(s["pairs"]) == {"fast", "slow"}
    assert sum(p["requests"] for p in s["pairs"].values()) == 10
    assert all(p["shed"] == 0 for p in s["pairs"].values())
    assert isinstance(out.deployment.router, tfleet.SmartPairRouter)


def _gated(e2e, mode, slo_ms):
    """The e2e stream through the port's deployment with the SLO gate in
    ``mode`` and every SLO'd class's TTFT target at ``slo_ms``, so the gate
    trusts a pair's window after one retirement."""
    spec = ttopo.ClusterSpec.load(str(e2e["tpath"]))
    for c in spec.workload.trace.classes:
        if c.slo_ttft_ms:
            c.slo_ttft_ms = slo_ms
    dep = ttopo.build_deployment(spec, model_configs=TTINY,
                                 node_params=e2e["tp"], sleep_links=False,
                                 device="cpu")
    server = dep.build_server(slo_admission=mode, slo_min_samples=1)
    reqs = tserve.spec_requests(spec, dep.vocab)
    for r in reqs:
        server.submit(r)
    return server, reqs, server.run()


def test_slo_reroute_keeps_tokens(e2e):
    """Rerouting moves requests between pairs, never their tokens: with an
    SLO no pair meets, the gate sends each SLO'd head to an unmeasured pair
    while there is one, and the served tokens are the gate-off run's."""
    server, reqs, results = _gated(e2e, "reroute", 1e-3)
    ours = {r.request_id: r.tokens.tolist() for r in results}
    assert ours == e2e["ref"]
    assert not any(r.shed for r in results)
    assert sum(server._shed) == 0


def test_slo_shed_rows(e2e):
    """Shedding under an SLO no pair meets: a shed row has no tokens and
    counts in ``slo_report``; every served row has the gate-off tokens."""
    server, reqs, results = _gated(e2e, "shed", 1e-3)
    shed = [r for r in results if r.shed]
    served = [r for r in results if not r.shed]
    assert shed and served
    assert len(shed) + len(served) == len(reqs)
    assert all(len(r.tokens) == 0 and r.slo_ttft_ms > 0 for r in shed)
    assert all(r.tokens.tolist() == e2e["ref"][r.request_id]
               for r in served)
    rep = tfleet.slo_report(tfleet.workload.serve_results_rows(results))
    assert sum(pc["shed"] for pc in rep["per_class"].values()) == len(shed)
    assert sum(server._shed) == len(shed)
    assert sum(r["shed"] for r in server.pair_summaries().values()) == \
        len(shed)
