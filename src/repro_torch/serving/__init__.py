"""Serving substrate of the port: continuous slot-based request serving over
per-pair persistent DecodeSessions with pluggable pair routing."""

from .server import (PAIR_ROUTERS, LeastLoadedPairRouter, PairRouter,
                     RoundRobinPairRouter, ServeRequest, ServeResult,
                     ServerConfig, ServingPair, SpecDecodeServer)
