"""Serving substrate of the port: continuous slot-based request serving over
per-pair persistent DecodeSessions with pluggable pair routing, process-
backed pairs, SLO-aware admission, and the wave-batched baseline."""

from .server import (PAIR_ROUTERS, LeastLoadedPairRouter, PairRouter,
                     RoundRobinPairRouter, ServeRequest, ServeResult,
                     ServerConfig, ServingPair, SmartPairRouter,
                     SpecDecodeServer, WaveSpecDecodeServer)
