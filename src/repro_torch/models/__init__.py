"""Model substrate (port of ``repro.models``): the decoder-only trunk
(``transformer``) and the encoder-decoder one (``encdec``), with the
architecture-generic init dispatch."""
from __future__ import annotations

from ..configs.base import ModelConfig
from . import encdec, transformer


def init_params(cfg: ModelConfig, seed: int = 0, **kw) -> dict:
    if cfg.is_encoder_decoder:
        return encdec.init_params(cfg, seed, **kw)
    return transformer.init_params(cfg, seed, **kw)

