"""Deterministic synthetic token pipeline (no external datasets offline): the
port's copy of ``repro/training/data.py``, pure numpy, batch for batch
the reference's.

Streams (tokens, targets) batches whose contents are a pure function of
(seed, step) — restart-safe: resuming from step N reproduces the exact
stream, which the checkpoint-resume tests rely on.  A Zipf-ish marginal over
the vocab plus a short Markov blend gives the loss a learnable structure so
example runs visibly descend.
"""
from __future__ import annotations

import numpy as np

from ..configs.base import ModelConfig


class SyntheticTokens:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._marg = (1.0 / ranks) / np.sum(1.0 / ranks)       # Zipf marginal
        self._next = rng.permutation(v)                         # Markov hop

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab_size
        base = rng.choice(v, size=(self.batch, self.seq_len + 1), p=self._marg)
        # 50% of positions follow the deterministic Markov hop (learnable)
        follow = rng.random((self.batch, self.seq_len)) < 0.5
        for t in range(1, self.seq_len + 1):
            hop = self._next[base[:, t - 1]]
            base[:, t] = np.where(follow[:, t - 1], hop, base[:, t])
        out = {"tokens": base[:, :-1].astype(np.int32),
               "targets": base[:, 1:].astype(np.int32)}
        if self.cfg.is_encoder_decoder:
            rngf = np.random.default_rng((self.seed, step, 1))
            out["frames"] = rngf.standard_normal(
                (self.batch, self.seq_len, self.cfg.d_model)).astype(np.float32)
            tgt = min(self.seq_len, self.cfg.max_target_positions)
            out["tokens"] = out["tokens"][:, :tgt]
            out["targets"] = out["targets"][:, :tgt]
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
