"""Simulation side of the port. Today only the edge–cloud link model
(:mod:`.network`) that the real transports share; DSD-Sim itself comes
with ROADMAP item A14."""

from .network import (DEFAULT_FUSED_CHUNK, LinkSpec, RttTracker,
                      expected_one_way_ms, expected_rtt_ms,
                      sample_one_way_ms, verdict_payload_bytes,
                      window_payload_bytes)
