"""DSD core of the PyTorch port: speculative decoding (algorithm + engine),
the continuous-batching session and Adaptive Window Control."""

from .specdec import (SlotStop, SpecDecodeOut, SpecDecodeState, VerifyResult,
                      draft_propose, expected_accepted, expected_speedup,
                      optimal_gamma, slot_stop_mask, spec_decode_step,
                      verify_window_greedy)
from .window import (AWCWindowPolicy, DynamicWindowPolicy, FeatureSnapshot,
                     OracleStaticPolicy, StaticWindowPolicy, WindowDecision)
from .engine import GenerationStats, SpecDecodeEngine
from .session import DecodeSession, SlotRecord
