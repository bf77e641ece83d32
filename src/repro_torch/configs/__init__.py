"""Model configurations the port serves (its own copy of ``repro.configs``)."""
from __future__ import annotations

from .base import ModelConfig, ShapeCfg, reduced
from .shapes import SHAPES, applicable_shapes, skipped_shapes
from .chameleon_34b import CONFIG as chameleon_34b
from .deepseek_v3 import CONFIG as deepseek_v3
from .jamba_v0_1 import CONFIG as jamba_v0_1
from .llama4_scout import CONFIG as llama4_scout
from .mamba2_370m import CONFIG as mamba2_370m
from .minicpm3_4b import CONFIG as minicpm3_4b
from .phi3_5_moe import CONFIG as phi3_5_moe
from .qwen1_5_0_5b import CONFIG as qwen1_5_0_5b
from .qwen2_5_14b import CONFIG as qwen2_5_14b
from .tinyllama_1_1b import CONFIG as tinyllama_1_1b
from .whisper_base import CONFIG as whisper_base

# The decoder-only archetypes: dense GQA (qkv bias, qk-norm), MLA, MoE, SSM
# (Mamba-2) and the SSM/attention hybrid (Jamba); and the encoder-decoder
# (whisper, its conv/mel frontend a stub).
CONFIGS: dict[str, ModelConfig] = {c.name: c for c in [
    tinyllama_1_1b, minicpm3_4b, phi3_5_moe, qwen1_5_0_5b, qwen2_5_14b,
    chameleon_34b, llama4_scout, deepseek_v3, mamba2_370m, jamba_v0_1,
    whisper_base]}

# The ten assigned architectures, in the JAX package's order (deepseek-v3,
# the paper's own backbone, is the eleventh config and not assigned).
ASSIGNED = ["whisper-base", "qwen2.5-14b", "minicpm3-4b", "tinyllama-1.1b",
            "qwen1.5-0.5b", "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e",
            "chameleon-34b", "mamba2-370m", "jamba-v0.1-52b"]


def get_config(arch: str) -> ModelConfig:
    if arch not in CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[arch]


__all__ = ["ModelConfig", "ShapeCfg", "SHAPES", "CONFIGS", "ASSIGNED",
           "get_config", "reduced", "applicable_shapes", "skipped_shapes"]
