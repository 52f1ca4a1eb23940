"""Assigned architecture configs (+ the paper's own draft/target pair).

Each module cites its source; ``get_config(arch_id)`` is the ``--arch``
lookup used by the launchers.
"""

from .base import ModelConfig
from . import (arctic_480b, command_r_plus_104b, deepseek_7b,
               internvl2_76b, llama4_maverick_400b_a17b, mamba2_130m,
               paper_pair, qwen2_5_3b, qwen3_14b, whisper_tiny, zamba2_1_2b)

ARCHS: dict[str, ModelConfig] = {
    "deepseek-7b": deepseek_7b.CONFIG,
    "mamba2-130m": mamba2_130m.CONFIG,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "whisper-tiny": whisper_tiny.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    # paper pair
    "llama2-7b": paper_pair.DRAFT,
    "llama2-70b": paper_pair.TARGET,
}

ASSIGNED = [k for k in ARCHS if k not in ("llama2-7b", "llama2-70b")]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
