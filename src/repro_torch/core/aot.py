"""Per-bucket step cache (Alg. 2), port of ``repro/core/aot.py``.

The reference compiles one XLA executable per routing-table shape bucket
(M_hat, S_hat, MB_hat, W, R) and replays it.  Eager PyTorch has no compile
step: a bucket's entry is the step function built for its ``DecodeDims``
(``step_builder(key) -> (fn, table_shapes)``), and the table upload
buffers of that shape are preallocated once (``routing.DeviceTables``).
The key arithmetic — ``quantise``, the R ladder, ``key_tag`` — is the
reference's, so the same traffic lands in the same buckets.

Donation becomes in-place pool updates: the audit records whether every
state tensor's ``data_ptr()`` is the same after a step as before it
(``donation_reuses``) or not (``donation_copies``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


def _round_pow2(x: int, lo: int = 1) -> int:
    v = lo
    while v < x:
        v *= 2
    return v


@dataclass
class AOTStats:
    captured: int = 0
    capture_seconds: float = 0.0
    lookups: int = 0
    hits: int = 0
    online_compiles: int = 0
    buffer_bytes: int = 0
    # in-place accounting: a state tensor whose storage moved during a step
    # means the update was not in place (the counterpart of the
    # reference's copy-on-donate)
    donation_checks: int = 0
    donation_reuses: int = 0
    donation_copies: int = 0
    donation_unknown: int = 0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("captured", "capture_seconds", "lookups", "hits",
                 "online_compiles", "buffer_bytes", "donation_checks",
                 "donation_reuses", "donation_copies", "donation_unknown")}


class AOTGraphEngine:
    """Bucket-keyed cache of step functions, with in-place audit."""

    # pointer checks on the first WARMUP_CHECKS dispatches by default
    WARMUP_CHECKS = 8

    def __init__(self, step_builder, audit_every_step: bool = False,
                 r_ladder: tuple | None = None, key_tag: str | None = None):
        self._builder = step_builder
        self._cache: dict = {}
        self.stats = AOTStats()
        # opaque suffix appended to every bucket key (variants that use
        # different state dtypes must never share an entry)
        self.key_tag = key_tag
        self.audit_every_step = audit_every_step
        # quantisation grid for R (rotation rounds used).  None -> pow2
        # ladder capped at W-1.
        self.r_ladder = tuple(sorted(set(r_ladder))) if r_ladder else None

    def should_audit_donation(self) -> bool:
        return (self.audit_every_step
                or self.stats.donation_checks < self.WARMUP_CHECKS)

    # ---------------- bucket resolution (Alg. 2 l.19) ----------------
    def quantise(self, M: int, S: int, MB: int, W: int,
                 R: int | None = None) -> tuple:
        """Bucket key (M, S, MB quantised, W[, R quantised][, tag]); R is
        rounded up onto the ladder and capped at the full ring W-1."""
        from .routing import _quantize_dim
        tag = () if self.key_tag is None else (self.key_tag,)
        key = (M, S, _quantize_dim(MB), W)
        if R is None:
            return key + tag
        if S == 0:
            rq = 0
        elif self.r_ladder is not None:
            r = max(R, 1)
            rq = min((g for g in self.r_ladder if g >= r), default=W - 1)
            rq = min(rq, W - 1)
        else:
            rq = min(_round_pow2(max(R, 1)), W - 1)
        return key + (rq,) + tag

    # ---------------- build ----------------
    def _compile(self, key):
        if key in self._cache:
            return self._cache[key]
        t0 = time.perf_counter()
        fn, table_shapes = self._builder(key)
        self.stats.capture_seconds += time.perf_counter() - t0
        self.stats.captured += 1
        self.stats.buffer_bytes += int(sum(np.prod(s) for s in
                                           table_shapes.values())) * 4
        self._cache[key] = fn
        return fn

    # ---------------- replay (Alg. 2 l.19-24) ----------------
    def lookup_key(self, key: tuple):
        self.stats.lookups += 1
        if key in self._cache:
            self.stats.hits += 1
            return self._cache[key]
        self.stats.online_compiles += 1
        return self._compile(key)

    # ---------------- in-place accounting ----------------
    @staticmethod
    def buffer_ptrs(state: dict) -> list:
        """Storage pointer of every state tensor, in key order."""
        return [state[k].data_ptr() for k in sorted(state)]

    def note_donation(self, in_ptrs: list, state: dict) -> bool:
        """Record whether the step updated every state tensor in place.
        Returns True when all pointers are unchanged."""
        out_ptrs = self.buffer_ptrs(state)
        self.stats.donation_checks += 1
        reused = True
        for a, b in zip(in_ptrs, out_ptrs):
            if a == b:
                self.stats.donation_reuses += 1
            else:
                self.stats.donation_copies += 1
                reused = False
        return reused
