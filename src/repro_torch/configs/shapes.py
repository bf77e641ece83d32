"""The assigned input-shape sets (LM family: seq_len x global_batch), the
port's copy of ``repro/configs/shapes.py``.

``decode_*`` / ``long_*`` cells run the DCP decode step (one new token
against a KV cache of ``seq_len``), not the train step.  ``long_500k`` is
defined only for the sub-quadratic families (SSM and hybrid); a pure
full-attention architecture skips it.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeCfg

SHAPES: dict[str, ShapeCfg] = {
    "train_4k":    ShapeCfg("train_4k",    "train",   4_096,   256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  ShapeCfg("decode_32k",  "decode",  32_768,  128),
    "long_500k":   ShapeCfg("long_500k",   "decode",  524_288, 1),
}

# families allowed to run the 500k long-context decode cell
_SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The shape cells defined for an architecture."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in _SUBQUADRATIC_FAMILIES:
        names.append("long_500k")
    return names


def skipped_shapes(cfg: ModelConfig) -> dict[str, str]:
    """The shape cells an architecture skips, with the reason."""
    out = {}
    if cfg.family not in _SUBQUADRATIC_FAMILIES:
        out["long_500k"] = ("pure full-attention arch: 500k context requires "
                            "sub-quadratic attention (DESIGN.md §6)")
    return out
