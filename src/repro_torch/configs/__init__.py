"""Model configurations the port serves (its own copy of ``repro.configs``)."""
from __future__ import annotations

from .base import ModelConfig, ShapeCfg, reduced
from .chameleon_34b import CONFIG as chameleon_34b
from .deepseek_v3 import CONFIG as deepseek_v3
from .llama4_scout import CONFIG as llama4_scout
from .minicpm3_4b import CONFIG as minicpm3_4b
from .phi3_5_moe import CONFIG as phi3_5_moe
from .qwen1_5_0_5b import CONFIG as qwen1_5_0_5b
from .qwen2_5_14b import CONFIG as qwen2_5_14b
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b

# The decoder-only archetypes: dense GQA (qkv bias, qk-norm), MLA and MoE.
# SSM/hybrid and encoder-decoder models are not ported yet (ROADMAP queue 1
# items 11-12).
CONFIGS: dict[str, ModelConfig] = {c.name: c for c in [
    tinyllama_1_1b, minicpm3_4b, phi3_5_moe, qwen1_5_0_5b, qwen2_5_14b,
    chameleon_34b, llama4_scout, deepseek_v3]}


def get_config(arch: str) -> ModelConfig:
    if arch not in CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[arch]


__all__ = ["ModelConfig", "ShapeCfg", "CONFIGS", "get_config", "reduced"]
