"""Model substrate (port of ``repro.models``): the decoder-only trunk
(``transformer``) and the encoder-decoder one (``encdec``), with the
architecture-generic init, forward and loss dispatch."""
from __future__ import annotations

from ..configs.base import ModelConfig
from . import encdec, transformer


def init_params(cfg: ModelConfig, seed: int = 0, **kw) -> dict:
    if cfg.is_encoder_decoder:
        return encdec.init_params(cfg, seed, **kw)
    return transformer.init_params(cfg, seed, **kw)


def forward(cfg: ModelConfig, params: dict, batch: dict, **kw):
    """batch: {"tokens": [B, S]} (+ "frames" for enc-dec) -> logits."""
    if cfg.is_encoder_decoder:
        return encdec.forward(cfg, params, batch["frames"], batch["tokens"],
                              **kw)
    logits, _ = transformer.forward(cfg, params, batch["tokens"], **kw)
    return logits


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, **kw):
    """batch: {"tokens", "targets"} (+ "frames") -> mean cross-entropy."""
    if cfg.is_encoder_decoder:
        return encdec.loss_fn(cfg, params, batch["frames"], batch["tokens"],
                              batch["targets"], **kw)
    return transformer.loss_fn(cfg, params, batch["tokens"], batch["targets"],
                               **kw)
