"""Topology-first deployment API of the port (the reference
``repro/topology.py``): ONE declarative, JSON-round-trippable
:class:`ClusterSpec` that builds the real execution path, the serving
layer and DSD-Sim.

- :class:`NodeSpec`   — one device in the deployment (role ``draft`` or
  ``target``, model config name, placement hints);
- :class:`PairSpec`   — one draft→target lane: node references, its
  :class:`~repro_torch.sim.network.LinkSpec` (``None`` = colocated), its
  window policy (:class:`WindowSpec`), its mode policy, and whether its two
  sides run as worker processes (``process``);
- :class:`ClusterSpec` — nodes + pairs + serving knobs
  (:class:`ServingSpec`) + a workload (:class:`WorkloadSpec`, optionally
  a fleet :class:`~repro_torch.fleet.workload.TraceSpec`), with
  ``validate()`` and ``to_json()``/``from_json()``: the reference's schema,
  validation messages and JSON bytes.

Two factories consume the SAME spec, so sim↔real parity is a property of
the spec:

- :func:`build_deployment` turns it into a :class:`Deployment` of
  :class:`~repro_torch.serving.ServingPair` lanes driving the port's
  :class:`~repro_torch.serving.SpecDecodeServer`; ``launch.serve
  --topology cluster.json`` feeds a spec straight in, and the launcher's
  one-pair flags compile to a spec through :func:`one_pair_spec`;
- :func:`build_simulation` turns it into a matching
  :class:`~repro_torch.sim.DSDSimulation` (one sim drafter per pair,
  pair-pinned routing, per-pair links), host code only.

Weights: each node's parameters are drawn ONCE, on the device, from
:func:`node_seed` — ``spec.seed + 2·i`` for the i-th draft node and
``spec.seed + 2·i + 1`` for the i-th target node in declaration order
(a role's index counts every node of that role, whichever pairs use it) —
and shared by every pair that names the node. A one-pair spec so draws
the engine's own default (draft ``seed``, target ``seed + 1``), and the
worker hosts of a process-backed pair (:mod:`repro_torch.distributed.host`)
call the same function, so a host builds the weights the in-process
deployment of the same spec builds. The draws differ from the reference's
``jax.random`` ones; tests carry reference weights over as ``node_params``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional

from .configs import get_config
from .fleet.workload import TraceSpec, WorkloadError
from .sim.network import LinkSpec

MODE_POLICIES = ("auto", "distributed", "fused", "pipeline")
WINDOW_KINDS = ("static", "dynamic", "awc")
ROLES = ("draft", "target")

# role defaults for the DSD-Sim mapping (hardware class, hwmodel name, tp)
_SIM_ROLE_DEFAULTS = {"target": ("A100", "llama2-70b", 4),
                     "draft": ("A40", "llama2-7b", 1)}


class TopologyError(ValueError):
    """A ClusterSpec failed validation."""


@dataclass
class NodeSpec:
    """One device in the deployment.

    ``model`` names a config of :func:`repro_torch.configs.get_config`
    (reduced unless ``build_deployment(reduced=False)``) unless the factory
    is handed an override via ``model_configs``. ``device`` is a placement
    hint; ``address``/``port`` place process-backed worker hosts;
    ``hw``/``sim_model``/``tp`` describe the node to DSD-Sim and default
    per role when empty/0."""
    id: str
    role: str                    # "draft" | "target"
    model: str = ""
    device: str = ""             # e.g. "cpu", "cuda:0", "edge-phone"
    hw: str = ""                 # sim hardware class (A100/A40/...)
    sim_model: str = ""          # sim hwmodel name (llama2-7b/...)
    tp: int = 0                  # sim tensor-parallel degree (0 = default)
    address: str = ""            # host address for process-backed pairs
                                 # ("" = 127.0.0.1)
    port: int = 0                # listen port for process-backed pairs
                                 # (0 = ephemeral, handshaken over stdout)

    def sim_tuple(self) -> tuple:
        hw, model, tp = _SIM_ROLE_DEFAULTS[self.role]
        return (self.hw or hw, self.sim_model or model, self.tp or tp)


@dataclass
class WindowSpec:
    """Declarative window policy for one pair
    (:func:`repro_torch.core.window.make_window_policy` arguments)."""
    kind: str = "static"         # static | dynamic | awc
    gamma: int = 4               # static γ / dynamic γ0
    hi: float = 0.75             # dynamic raise threshold
    lo: float = 0.25             # dynamic lower threshold
    gmax: int = 12               # dynamic upper bound


@dataclass
class PairSpec:
    """One draft→target lane. ``link=None`` declares a colocated pair (no
    transport; the engine's virtual ``rtt_ms`` accounting applies);
    ``link.rtt_ms == 0`` a zero-delay in-process transport."""
    id: str
    draft: str                   # NodeSpec id (role "draft")
    target: str                  # NodeSpec id (role "target")
    link: Optional[LinkSpec] = None
    window: WindowSpec = field(default_factory=WindowSpec)
    mode_policy: str = "auto"    # auto | distributed | fused | pipeline
    process: bool = False        # run draft/target as separate OS processes
                                 # over a SocketTransport (greedy + static
                                 # window + distributed mode only)


@dataclass
class ServingSpec:
    """Serving/batching/engine knobs shared by every pair."""
    max_batch: int = 4           # slot-pool capacity per pair
    length_aware: bool = True    # LAB admission (vs FIFO)
    pad_to: int = 16
    max_prompt_len: Optional[int] = None
    max_new_cap: Optional[int] = None
    eos_id: int = -1
    sync_every: int = 8
    gamma_max: int = 12          # the steps' window bound
    temperature: float = 0.0
    rtt_ms: float = 0.0          # colocated pairs' virtual RTT charge
    router: str = "least-loaded"  # repro_torch.serving.PAIR_ROUTERS key
    server: str = "continuous"   # continuous | wave (wave: 1 colocated pair)


@dataclass
class WorkloadSpec:
    """Request stream description (drives ``launch.serve`` defaults and
    :func:`build_simulation`'s generated records).

    ``trace`` upgrades the stream to a fleet
    :class:`~repro_torch.fleet.workload.TraceSpec` — request classes with
    per-class length distributions and TTFT/TPOT SLOs, diurnal/burst/replay
    load shapes — and supersedes the flat ``num_requests``/``rate_per_s``/
    ``prompt_lo``/``prompt_hi`` surface when present."""
    dataset: str = "gsm8k"
    num_requests: int = 8
    max_new: int = 32
    rate_per_s: float = 0.0      # Poisson arrivals (0 = all at t=0)
    prompt_lo: int = 8           # synthetic prompt-length range: lengths
    prompt_hi: int = 48          # drawn from [prompt_lo, prompt_hi) —
                                 # EXCLUSIVE upper bound
    trace: Optional[TraceSpec] = None   # fleet trace (classes+SLOs+shape)


@dataclass
class ClusterSpec:
    """The whole deployment: nodes + pairs + serving knobs + workload."""
    nodes: list[NodeSpec] = field(default_factory=list)
    pairs: list[PairSpec] = field(default_factory=list)
    serving: ServingSpec = field(default_factory=ServingSpec)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    seed: int = 0

    # -- validation ----------------------------------------------------------

    def node(self, node_id: str) -> NodeSpec:
        for n in self.nodes:
            if n.id == node_id:
                return n
        raise TopologyError(f"unknown node id {node_id!r}")

    def validate(self) -> "ClusterSpec":
        """Structural validation; raises :class:`TopologyError` with the
        first violation (the reference's messages). Returns self."""
        if not self.nodes:
            raise TopologyError("a cluster needs at least one node")
        if not self.pairs:
            raise TopologyError("a cluster needs at least one pair")
        seen: set[str] = set()
        for n in self.nodes:
            if not n.id or not isinstance(n.id, str):
                raise TopologyError(f"node id must be a non-empty string, "
                                    f"got {n.id!r}")
            if n.id in seen:
                raise TopologyError(f"duplicate node id {n.id!r}")
            seen.add(n.id)
            if n.role not in ROLES:
                raise TopologyError(
                    f"node {n.id!r}: role must be one of {ROLES}, "
                    f"got {n.role!r}")
            if n.tp < 0:
                raise TopologyError(f"node {n.id!r}: tp must be >= 0")
            if not (0 <= n.port <= 65535):
                raise TopologyError(
                    f"node {n.id!r}: port must be in [0, 65535], "
                    f"got {n.port}")
        pair_ids: set[str] = set()
        for p in self.pairs:
            if not p.id or not isinstance(p.id, str):
                raise TopologyError(f"pair id must be a non-empty string, "
                                    f"got {p.id!r}")
            if p.id in pair_ids:
                raise TopologyError(f"duplicate pair id {p.id!r}")
            pair_ids.add(p.id)
            for ref, role in ((p.draft, "draft"), (p.target, "target")):
                if ref not in seen:
                    raise TopologyError(
                        f"pair {p.id!r}: unknown node ref {ref!r}")
                if self.node(ref).role != role:
                    raise TopologyError(
                        f"pair {p.id!r}: node {ref!r} has role "
                        f"{self.node(ref).role!r}, expected {role!r}")
            if p.link is not None:
                if p.link.rtt_ms < 0:
                    raise TopologyError(
                        f"pair {p.id!r}: negative rtt_ms {p.link.rtt_ms}")
                if p.link.jitter_ms < 0:
                    raise TopologyError(
                        f"pair {p.id!r}: negative jitter_ms "
                        f"{p.link.jitter_ms}")
                if p.link.bandwidth_gbps <= 0:
                    raise TopologyError(
                        f"pair {p.id!r}: bandwidth_gbps must be > 0")
            if p.mode_policy not in MODE_POLICIES:
                raise TopologyError(
                    f"pair {p.id!r}: mode_policy must be one of "
                    f"{MODE_POLICIES}, got {p.mode_policy!r}")
            if p.mode_policy == "pipeline" and p.link is None:
                raise TopologyError(
                    f"pair {p.id!r}: pipeline mode overlaps rounds across "
                    "a transport; declare a link (rtt_ms 0 = in-process)")
            w = p.window
            if w.kind not in WINDOW_KINDS:
                raise TopologyError(
                    f"pair {p.id!r}: window kind must be one of "
                    f"{WINDOW_KINDS}, got {w.kind!r}")
            if w.gamma < 1 or w.gmax < 1:
                raise TopologyError(
                    f"pair {p.id!r}: window gamma/gmax must be >= 1")
            if p.process:
                # the same restrictions the worker hosts enforce
                from .distributed.host import validate_process_pair
                validate_process_pair(self, p)
                if self.serving.server != "continuous":
                    raise TopologyError(
                        f"pair {p.id!r}: process-backed pairs need "
                        "serving.server='continuous'")
        s = self.serving
        if s.max_batch < 1:
            raise TopologyError("serving.max_batch must be >= 1")
        if s.sync_every < 1:
            raise TopologyError("serving.sync_every must be >= 1")
        if s.pad_to < 1:
            raise TopologyError("serving.pad_to must be >= 1")
        min_gmax = 2 if any(p.mode_policy == "pipeline"
                            for p in self.pairs) else 1
        if s.gamma_max < min_gmax:
            raise TopologyError(
                f"serving.gamma_max must be >= {min_gmax} "
                "(pipeline reserves one proposal slot)")
        if s.temperature < 0:
            raise TopologyError("serving.temperature must be >= 0")
        if s.rtt_ms < 0:
            raise TopologyError("serving.rtt_ms must be >= 0")
        from .serving import PAIR_ROUTERS
        if s.router not in PAIR_ROUTERS:
            raise TopologyError(
                f"unknown serving.router {s.router!r}; "
                f"available: {sorted(PAIR_ROUTERS)}")
        if s.server not in ("continuous", "wave"):
            raise TopologyError(f"unknown serving.server {s.server!r}")
        if s.server == "wave" and (len(self.pairs) != 1
                                   or self.pairs[0].link is not None):
            raise TopologyError("serving.server='wave' is the single-pair "
                                "colocated baseline")
        w = self.workload
        if w.num_requests < 0 or w.max_new < 1 or w.rate_per_s < 0:
            raise TopologyError("workload: num_requests >= 0, max_new >= 1, "
                                "rate_per_s >= 0 required")
        if not (1 <= w.prompt_lo < w.prompt_hi):
            raise TopologyError("workload: need 1 <= prompt_lo < prompt_hi "
                                "(prompt_hi is exclusive)")
        if w.trace is not None:
            try:
                w.trace.validate()
            except WorkloadError as e:
                raise TopologyError(f"workload.trace: {e}") from e
        return self

    # -- JSON round trip -----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterSpec":
        def build(dc_cls, obj):
            fields = {f.name for f in dataclasses.fields(dc_cls)}
            for k in obj:
                if k not in fields:
                    raise TopologyError(
                        f"unknown field {k!r} for {dc_cls.__name__}")
            return dc_cls(**obj)

        nodes = [build(NodeSpec, n) for n in d.get("nodes", [])]
        pairs = []
        for p in d.get("pairs", []):
            p = dict(p)
            link = p.pop("link", None)
            window = p.pop("window", None)
            pair = build(PairSpec, p)
            if link is not None:
                pair.link = build(LinkSpec, link)
            if window is not None:
                pair.window = build(WindowSpec, window)
            pairs.append(pair)
        serving = build(ServingSpec, d.get("serving", {}))
        w = dict(d.get("workload", {}))
        trace = w.pop("trace", None)
        workload = build(WorkloadSpec, w)
        if trace is not None:
            try:
                workload.trace = TraceSpec.from_dict(trace)
            except WorkloadError as e:
                raise TopologyError(f"workload.trace: {e}") from e
        return cls(nodes=nodes, pairs=pairs, serving=serving,
                   workload=workload, seed=int(d.get("seed", 0)))

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "ClusterSpec":
        with open(path) as f:
            return cls.from_json(f.read())


# --------------------------------------------------------------------------
# one-pair spec from the launcher's flags
# --------------------------------------------------------------------------

def one_pair_spec(target: str = "qwen3-14b", draft: str = "qwen2.5-3b",
                  policy: str = "static", gamma: int = 4,
                  gamma_max: int = 12, max_batch: int = 4,
                  sync_every: int = 8, temperature: float = 0.0,
                  rtt_ms: float = 10.0,
                  link_rtt_ms: Optional[float] = None,
                  link_jitter_ms: float = 1.0, link_bw_gbps: float = 1.0,
                  mode_policy: str = "auto", server: str = "continuous",
                  requests: int = 8, max_new: int = 32,
                  arrival_rate: float = 0.0, seed: int = 0) -> ClusterSpec:
    """The launcher's one-pair flag surface as a :class:`ClusterSpec` (the
    reference's shim): ``--link-rtt-ms 0`` → a zero-delay in-process link,
    ``--mode-policy pipeline`` included."""
    link = None
    if link_rtt_ms is not None:
        link = LinkSpec(rtt_ms=float(link_rtt_ms),
                        jitter_ms=float(link_jitter_ms),
                        bandwidth_gbps=float(link_bw_gbps))
    return ClusterSpec(
        nodes=[NodeSpec(id="edge0", role="draft", model=draft),
               NodeSpec(id="cloud0", role="target", model=target)],
        pairs=[PairSpec(id="pair0", draft="edge0", target="cloud0",
                        link=link,
                        window=WindowSpec(kind=policy, gamma=gamma),
                        mode_policy=mode_policy)],
        serving=ServingSpec(max_batch=max_batch, sync_every=sync_every,
                            gamma_max=gamma_max, temperature=temperature,
                            rtt_ms=rtt_ms, server=server),
        workload=WorkloadSpec(num_requests=requests, max_new=max_new,
                              rate_per_s=arrival_rate),
        seed=seed)


# --------------------------------------------------------------------------
# real-path factory
# --------------------------------------------------------------------------

def node_seed(spec: ClusterSpec, node_id: str) -> int:
    """The seed of one node's weights: ``spec.seed + 2·i`` for the i-th
    draft node, ``spec.seed + 2·i + 1`` for the i-th target node (i counts
    the nodes of that role in declaration order)."""
    index = {"draft": 0, "target": 0}
    for n in spec.nodes:
        i = index[n.role]
        index[n.role] += 1
        if n.id == node_id:
            return spec.seed + 2 * i + (n.role == "target")
    raise TopologyError(f"unknown node id {node_id!r}")


def node_configs(spec: ClusterSpec, model_configs: Optional[dict] = None,
                 reduced: bool = True) -> dict:
    """Node id → :class:`~repro_torch.configs.base.ModelConfig`: the
    ``model_configs`` override by model name, else the registered config
    (``.reduced()`` unless ``reduced=False``); the vocabularies unify to
    the smallest (one tokenizer)."""
    model_configs = model_configs or {}

    def resolve(node: NodeSpec):
        if node.model in model_configs:
            return model_configs[node.model]
        cfg = get_config(node.model)
        return cfg.reduced() if reduced else cfg

    raw = {n.id: resolve(n) for n in spec.nodes}
    vocab = min(c.vocab for c in raw.values())
    return {nid: (c if c.vocab == vocab
                  else dataclasses.replace(c, vocab=vocab))
            for nid, c in raw.items()}


def init_node_params(spec: ClusterSpec, node_id: str, cfg, device):
    """One node's weights, drawn on ``device`` from :func:`node_seed`."""
    from .models.model import build_model
    return build_model(cfg, device).init_params(node_seed(spec, node_id))


@dataclass
class Deployment:
    """The real execution path built from a spec: one
    :class:`~repro_torch.serving.ServingPair` per :class:`PairSpec`
    (engines share per-node params; each pair owns its transport and its
    window policy), plus the resolved vocab and router."""
    spec: ClusterSpec
    pairs: list                  # list[repro_torch.serving.ServingPair]
    node_configs: dict           # node id -> ModelConfig (vocab-unified)
    vocab: int
    router: Any

    def server_config(self, **overrides):
        """A :class:`~repro_torch.serving.ServerConfig` carrying the spec's
        serving knobs (the per-pair transport/mode live on the pairs);
        ``overrides`` set the port's own fields (``capture``, ``paged_kv``,
        ``kv_pool_blocks``)."""
        from .serving import ServerConfig
        s = self.spec.serving
        return ServerConfig(max_batch=s.max_batch,
                            length_aware=s.length_aware, pad_to=s.pad_to,
                            max_prompt_len=s.max_prompt_len,
                            max_new_cap=s.max_new_cap, eos_id=s.eos_id,
                            sync_every=s.sync_every, **overrides)

    def build_server(self, **overrides):
        """A :class:`~repro_torch.serving.SpecDecodeServer` over the
        deployment's pairs (the spec's ``server`` ``wave``: a
        :class:`~repro_torch.serving.WaveSpecDecodeServer` on its one
        pair)."""
        from .serving import SpecDecodeServer, WaveSpecDecodeServer
        cfg = self.server_config(**overrides)
        if self.spec.serving.server == "wave":
            pair = self.pairs[0]
            cfg.mode_policy = pair.mode_policy
            return WaveSpecDecodeServer(pair.engine, pair.policy, cfg)
        return SpecDecodeServer(cfg=cfg, pairs=self.pairs,
                                router=self.router)

    def shutdown(self) -> None:
        """Stop the worker hosts of every process-backed pair (no-op for
        an in-process deployment)."""
        for p in self.pairs:
            if p.host is not None:
                p.host.shutdown()


def build_deployment(spec: ClusterSpec, *,
                     model_configs: Optional[dict] = None,
                     node_params: Optional[dict] = None,
                     sleep_links: bool = True, reduced: bool = True,
                     device=None, host_timeout_s: float = 120.0
                     ) -> Deployment:
    """Instantiate the real path from a validated spec.

    - each node's config resolves through :func:`node_configs`;
    - parameters are built ONCE per node on ``device`` (the card unless
      ``device="cpu"``) from :func:`node_seed` — ``node_params`` overrides
      by node id with ready tensors — and shared by every in-process pair
      that names the node; process-only nodes are built inside their
      worker hosts by the same function;
    - each in-process pair gets its own engine (cached per (draft, target)
      node pair), its own transport from its :class:`LinkSpec`
      (:func:`repro_torch.distributed.make_transport`; ``sleep_links=False``
      routes emulated delays to the virtual clock) and its own window
      policy instance;
    - each ``process: true`` pair spawns its two worker hosts
      (:func:`repro_torch.distributed.host.spawn_pair`, on ``device`` too).
    """
    from .core.engine import SpecDecodeEngine
    from .core.window import make_window_policy
    from .distributed import make_transport
    from .kernels import resolve_device
    from .serving import PAIR_ROUTERS, ServingPair

    spec.validate()
    dev = resolve_device(device)
    overrides = node_params or {}
    s = spec.serving
    configs = node_configs(spec, model_configs, reduced)
    vocab = min(c.vocab for c in configs.values())

    local = {nid for p in spec.pairs if not p.process
             for nid in (p.draft, p.target)}
    params = {n.id: (overrides[n.id] if n.id in overrides
                     else init_node_params(spec, n.id, configs[n.id], dev))
              for n in spec.nodes if n.id in local}

    engines: dict = {}
    pairs: list = []
    try:
        for i, p in enumerate(spec.pairs):
            w = p.window
            policy = make_window_policy(w.kind, gamma=w.gamma, hi=w.hi,
                                        lo=w.lo, gmax=w.gmax)
            if p.process:
                from .distributed.host import spawn_pair
                handle = spawn_pair(
                    spec, p, model_configs=model_configs,
                    node_params={nid: overrides[nid]
                                 for nid in (p.draft, p.target)
                                 if nid in overrides},
                    device=dev.type, timeout_s=host_timeout_s,
                    full_size=not reduced)
                pairs.append(ServingPair(pair_id=p.id, engine=None,
                                         policy=policy, transport=None,
                                         mode_policy=p.mode_policy,
                                         host=handle))
                continue
            eng = engines.get((p.draft, p.target))
            if eng is None:
                eng = engines[(p.draft, p.target)] = SpecDecodeEngine(
                    configs[p.draft], configs[p.target],
                    draft_params=params[p.draft],
                    target_params=params[p.target],
                    temperature=s.temperature, rtt_ms=s.rtt_ms,
                    gamma_max=s.gamma_max, sync_every=s.sync_every,
                    device=dev)
            pairs.append(ServingPair(
                pair_id=p.id, engine=eng, policy=policy,
                transport=make_transport(p.link, seed=spec.seed + i,
                                         sleep=sleep_links),
                mode_policy=p.mode_policy))
    except BaseException:
        for p in pairs:          # hosts already spawned do not outlive it
            if p.host is not None:
                p.host.shutdown()
        raise
    return Deployment(spec=spec, pairs=pairs, node_configs=configs,
                      vocab=vocab, router=PAIR_ROUTERS[s.router]())


# --------------------------------------------------------------------------
# sim factory
# --------------------------------------------------------------------------

class PairDispatchWindowPolicy:
    """Window policy for multi-pair simulations: dispatches each decision
    to the pair's OWN policy instance by the sim's ``"did->tid"`` pair
    key (drafter i is pair i under :func:`build_simulation`'s mapping),
    so heterogeneous per-pair window declarations survive the shared
    ``PolicyStack.window`` slot."""

    def __init__(self, per_pair: list):
        self.per_pair = list(per_pair)

    def _policy_for(self, pair_key: str):
        did = int(str(pair_key).split("->", 1)[0])
        return self.per_pair[did % len(self.per_pair)]

    def decide(self, pair_key: str, feats):
        return self._policy_for(pair_key).decide(pair_key, feats)

    def gamma_bound(self) -> int:
        return max(p.gamma_bound() for p in self.per_pair)

    def name(self) -> str:
        return "per-pair(" + ",".join(p.name() for p in self.per_pair) + ")"


def build_simulation(spec: ClusterSpec, records: Optional[list] = None, *,
                     hwmodel=None, pipeline: Optional[bool] = None,
                     predictor=None, pair_router=None):
    """A :class:`~repro_torch.sim.DSDSimulation` matching the spec's topology.

    Mapping: sim drafter i ⇔ ``spec.pairs[i]`` (its link becomes drafter
    i's per-pair link via the scheduler's ``drafter_link_pool``); unique
    target NODES become sim target servers; routing is pair-pinned, so a
    request handed to drafter i verifies on pair i's declared target over
    pair i's declared link — the same lanes the real deployment runs.

    ``records`` replays captured acceptance traces (``TraceRecord`` with
    ``drafter_id`` = pair index, or < 0 for "assign at arrival"); when
    ``None``, the spec's :class:`WorkloadSpec` generates a synthetic
    stream — from its fleet ``trace`` (class-aware arrivals with SLOs,
    every record unpinned so the pair router assigns lanes) when one is
    declared, else the flat legacy surface. ``pair_router`` is the
    arrival-time lane policy for unpinned records: an instance, a
    ``repro_torch.fleet.routing.SIM_PAIR_ROUTERS`` key, or None for the
    spec's ``serving.router`` when that name has a sim analogue
    (least-loaded/smart; shallowest-queue otherwise). ``pipeline``
    defaults to True iff every pair declares ``mode_policy="pipeline"``
    (the sim's overlap model is simulation-global). Pairs forced
    ``fused`` simulate under an always-fused oracle policy; pairs forced
    ``distributed`` keep their window policy's γ but never enter fused
    mode (matching the real session's mode override).
    """
    from .core.window import OracleStaticPolicy, make_window_policy
    from .sim.network import LinkSpec as SimLinkSpec
    from .sim.policies import (BatchingConfig, FIFOBatching,
                               LengthAwareBatching, PinnedRouting)
    from .sim.scheduler import ClusterSpec as SimClusterSpec
    from .sim.scheduler import DSDSimulation, PolicyStack
    from .sim.trace import WorkloadGenerator

    spec.validate()
    s = spec.serving

    target_ids: list[str] = []
    for p in spec.pairs:
        if p.target not in target_ids:
            target_ids.append(p.target)
    target_pool = [spec.node(t).sim_tuple() for t in target_ids]
    draft_pool = [spec.node(p.draft).sim_tuple()[:2] for p in spec.pairs]
    pinned = [target_ids.index(p.target) for p in spec.pairs]
    drafter_links = [p.link if p.link is not None
                     else SimLinkSpec(rtt_ms=0.0, jitter_ms=0.0)
                     for p in spec.pairs]

    per_pair_policies = []
    for p in spec.pairs:
        if p.mode_policy == "fused":
            per_pair_policies.append(OracleStaticPolicy(1, fused=True))
            continue
        w = p.window
        pol = make_window_policy(w.kind, gamma=w.gamma, hi=w.hi, lo=w.lo,
                                 gmax=w.gmax, predictor=predictor)
        if p.mode_policy == "distributed":
            pol = _ForceDistributed(pol)
        per_pair_policies.append(pol)
    window = (per_pair_policies[0] if len(per_pair_policies) == 1
              else PairDispatchWindowPolicy(per_pair_policies))

    cluster = SimClusterSpec(
        num_targets=len(target_ids),
        num_drafters=len(spec.pairs),
        link=drafter_links[0],
        target_pool=target_pool,
        draft_pool=draft_pool,
        drafter_link_pool=drafter_links)
    if pair_router is None and s.router in ("least-loaded", "smart"):
        pair_router = s.router
    if isinstance(pair_router, str):
        from .fleet.routing import SIM_PAIR_ROUTERS
        pair_router = SIM_PAIR_ROUTERS[pair_router]()
    policies = PolicyStack(
        routing=PinnedRouting(pinned),
        batching=(LengthAwareBatching() if s.length_aware
                  else FIFOBatching()),
        batching_cfg=BatchingConfig(max_batch=s.max_batch, continuous=True),
        window=window,
        pair_routing=pair_router)
    if records is None and spec.workload.trace is not None:
        # fleet trace: class-aware arrivals with SLOs; unpinned records
        # (drafter_id = -1) let the pair router assign lanes at arrival —
        # the sim twin of the real server's PairRouter admission
        from .fleet.workload import fleet_trace_records, generate_requests
        records = fleet_trace_records(generate_requests(spec.workload.trace),
                                      seed=spec.seed)
    elif records is None:
        # rate 0 means "all at t=0" on the real path; the generator needs
        # a positive rate, so approximate with effectively-simultaneous
        # arrivals
        rate = spec.workload.rate_per_s or 1e6
        gen = WorkloadGenerator(spec.workload.dataset, rate,
                                len(spec.pairs), seed=spec.seed)
        records = gen.generate(spec.workload.num_requests)
        # synthetic streams exercise every declared lane: drafter i is
        # pair i, so spread requests round-robin across pairs (captured
        # traces passed via ``records`` keep their own drafter ids)
        for i, rec in enumerate(records):
            rec.drafter_id = i % len(spec.pairs)
    if pipeline is None:
        pipeline = all(p.mode_policy == "pipeline" for p in spec.pairs)
    return DSDSimulation(cluster, policies, records, hwmodel=hwmodel,
                         seed=spec.seed, pipeline=bool(pipeline))


class _ForceDistributed:
    """Mode override wrapper mirroring the real session's
    ``mode_policy="distributed"``: the wrapped policy's γ stands, fused
    decisions are coerced to distributed (γ clamped to ≥ 1)."""

    def __init__(self, inner):
        self.inner = inner

    def decide(self, pair_key, feats):
        from .core.window import WindowDecision
        d = self.inner.decide(pair_key, feats)
        if d.mode == "fused":
            return WindowDecision(max(1, d.gamma), "distributed")
        return d

    def gamma_bound(self) -> int:
        return self.inner.gamma_bound()

    def name(self) -> str:
        return f"forced-distributed({self.inner.name()})"
