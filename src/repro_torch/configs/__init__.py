"""Model configurations the port serves (its own copy of ``repro.configs``)."""
from __future__ import annotations

from .base import ModelConfig, ShapeCfg, reduced
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b

# Only the dense GQA archetype is ported so far (ROADMAP queue 1).
CONFIGS: dict[str, ModelConfig] = {c.name: c for c in [tinyllama_1_1b]}


def get_config(arch: str) -> ModelConfig:
    if arch not in CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[arch]


__all__ = ["ModelConfig", "ShapeCfg", "CONFIGS", "get_config", "reduced"]
