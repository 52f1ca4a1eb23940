"""DSD-Sim — request-level discrete-event simulator for distributed
speculative decoding (paper §3). Host code with no device math: the port's
copy of the reference simulator, wired to the port's window policies
(:mod:`repro_torch.core.window`) and fleet layer (:mod:`repro_torch.fleet`),
so that one spec and seed give the reference's summary. :mod:`.network`
also holds the link model the real transports share."""

from .events import Environment, Store
from .network import (DEFAULT_FUSED_CHUNK, Link, LinkSpec, RttTracker,
                      expected_one_way_ms, expected_rtt_ms,
                      sample_one_way_ms, verdict_payload_bytes,
                      window_payload_bytes)
from .hwmodel import DEVICES, MODELS, HardwareModel, ModelDesc, OpShape, register_model
from .trace import (PROFILES, AcceptanceCursor, DatasetProfile, TraceRecord,
                    WorkloadGenerator, load_trace, save_trace)
from .policies import (BATCHING, ROUTING, BatchingConfig, FIFOBatching,
                       JSQRouting, LengthAwareBatching, RandomRouting,
                       RoundRobinRouting)
from .scheduler import ClusterSpec, DSDSimulation, Job, PolicyStack
from .analyzer import Analyzer, RequestMetrics
from .config import (SimSpec, auto_topology, build_simulation, load, loads,
                     simulate_from_yaml)

__all__ = [
    "Environment", "Store", "Link", "LinkSpec", "DEVICES", "MODELS",
    "HardwareModel", "ModelDesc", "OpShape", "register_model", "PROFILES",
    "AcceptanceCursor", "DatasetProfile", "TraceRecord", "WorkloadGenerator",
    "load_trace", "save_trace", "BATCHING", "ROUTING", "BatchingConfig",
    "FIFOBatching", "JSQRouting", "LengthAwareBatching", "RandomRouting",
    "RoundRobinRouting", "ClusterSpec", "DSDSimulation", "Job", "PolicyStack",
    "Analyzer", "RequestMetrics", "SimSpec", "auto_topology",
    "build_simulation", "load", "loads", "simulate_from_yaml",
]
