"""Model configurations the port serves (its own copy of ``repro.configs``)."""
from __future__ import annotations

from .base import ModelConfig, ShapeCfg, reduced
from .minicpm3_4b import CONFIG as minicpm3_4b
from .phi3_5_moe import CONFIG as phi3_5_moe
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b

# The archetypes ported so far: dense GQA, MLA and MoE (ROADMAP queue 1).
CONFIGS: dict[str, ModelConfig] = {c.name: c for c in [tinyllama_1_1b,
                                                        minicpm3_4b,
                                                        phi3_5_moe]}


def get_config(arch: str) -> ModelConfig:
    if arch not in CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[arch]


__all__ = ["ModelConfig", "ShapeCfg", "CONFIGS", "get_config", "reduced"]
