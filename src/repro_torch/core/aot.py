"""AOT graph engine (Alg. 2), port of ``repro/core/aot.py``: one CUDA graph
per routing-table bucket, captured ahead of time and replayed.

The reference compiles one XLA executable per routing-table shape bucket
(M_hat, S_hat, MB_hat, W, R) and replays it.  The port captures the
bucket's decode step (``step_builder(key) -> (fn, table_shapes)``) as one
``torch.cuda.CUDAGraph`` (``StepGraph``), so a steady step enqueues one
graph launch instead of every op of every layer.  All graphs of an engine
share one memory pool: replays run one after another on one stream, never
overlapping.  On the CPU, and on CUDA when the engine asks for eager
dispatch, an entry is the step function itself.  The key arithmetic —
``quantise``, the R ladder, ``key_tag`` — is the reference's, so the same
traffic lands in the same buckets.

A graph reads and writes the storage it was captured with: the params, the
serve state (pools; SSM models' per-slot conv windows and SSM state, and
whisper's per-slot self-attention caches, which the step advances in
place; whisper's cross pools, which it only reads) and the bucket's table
buffers (``routing.DeviceTables``).  A tensor rebound anywhere would leave the
graph on its old storage with nothing failing, so every replay checks that
no pointer moved (``InPlaceAudit``) and raises if one did.

Donation becomes in-place pool updates: the engine's audit records whether
every state tensor's ``data_ptr()`` is the same after a step as before it
(``donation_reuses``) or not (``donation_copies``).
"""
from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import moe_experts, paged_attention

# the kernel wrappers whose launches a replay counts: each tallies the calls
# recorded under capture in ``CAPTURED`` (name -> calls) and counts them
# with ``count_launches(name, n)``
COUNTED = (paged_attention, moe_experts)


def _no_span(name: str, **attrs):
    return contextlib.nullcontext(attrs)


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
    # buckets first met on the hot path (in graph mode each is captured
    # right after its first, eager, use)
    online_compiles: int = 0
    buffer_bytes: int = 0
    # bytes of device memory the engine's graph pool holds (0 without graphs)
    graph_pool_bytes: int = 0
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
                 "online_compiles", "buffer_bytes", "graph_pool_bytes",
                 "donation_checks", "donation_reuses", "donation_copies",
                 "donation_unknown")}


def _ptrs(tree, out: list) -> list:
    """``data_ptr()`` of every tensor of nested dicts, lists and tuples, in
    order (None leaves skipped)."""
    if isinstance(tree, dict):
        for v in tree.values():
            _ptrs(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _ptrs(v, out)
    elif tree is not None:
        out.append(tree.data_ptr())
    return out


def _paths(tree, path: str = "") -> list:
    """The leaf paths of ``_ptrs``'s order, for messages."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{path}/{i}")]
    return [] if tree is None else [path]


@functools.cache
def _capture_stream(device: int):
    """The side stream graphs are captured on (capture cannot use the
    default stream), one per device: cuBLAS keeps a workspace per stream,
    made at the stream's first capture."""
    return torch.cuda.Stream(device)


class InPlaceAudit:
    """The storage of a step's (params, state, tables) when it was captured;
    ``check`` raises unless every tensor is where it was."""

    def __init__(self, params, state, tables):
        self.ptrs = _ptrs((params, state, tables), [])

    def check(self, params, state, tables) -> None:
        trees = (params, state, tables)
        now = _ptrs(trees, [])
        if now == self.ptrs:
            return
        names = _paths(trees)
        moved = ([n for n, a, b in zip(names, self.ptrs, now) if a != b]
                 if len(now) == len(self.ptrs) else
                 [f"the tensor count ({len(self.ptrs)} -> {len(now)})"])
        raise RuntimeError(
            f"in-place audit: {', '.join(moved[:4])} moved since the graph "
            "was captured; a replay would read and write the old storage")


class StepGraph:
    """One bucket's decode step as a CUDA graph.

    The bucket's first call on the hot path runs the step eagerly — the
    step is applied once, as it must be, and every kernel of the bucket is
    loaded before capture — and then captures it; capture enqueues nothing
    that runs.  ``AOTGraphEngine.capture`` (offline, the elastic-join
    prewarm) captures at once.  A replay audits the storage, launches the
    graph and returns its static ``next_tokens`` and ``logits``: the next
    replay of any graph of the engine's pool may overwrite them, so the
    caller reads both before it dispatches again (the engine copies the
    tokens to pinned memory at dispatch and reads kept logits at harvest).
    The kernel launches recorded at capture (``COUNTED``) are counted at
    each replay."""

    def __init__(self, owner: "AOTGraphEngine", key: tuple, fn,
                 table_shapes: dict):
        self.owner, self.key, self.fn = owner, key, fn
        self.table_shapes = table_shapes
        self.graph = None
        self.audit = None
        self.outputs = None
        self.launches: dict = {}

    def capture(self) -> None:
        with self.owner.span("aot.capture", key=self.key, stage="graph"):
            self._capture()

    def _capture(self) -> None:
        own = self.owner
        params, state, tables = own.graph_inputs(self.table_shapes)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        stream = _capture_stream(torch.cuda.current_device())
        for mod in COUNTED:
            mod.CAPTURED.clear()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=own.pool)
                try:
                    _, toks, logits = self.fn(params, state, tables)
                finally:
                    graph.capture_end()
        except RuntimeError as err:
            raise RuntimeError(f"CUDA graph capture of bucket {self.key} "
                               f"failed: {err}") from err
        finally:
            self.launches = {mod: dict(mod.CAPTURED) for mod in COUNTED}
            for mod in COUNTED:
                mod.CAPTURED.clear()
        self.graph, self.outputs = graph, (toks, logits)
        self.audit = InPlaceAudit(params, state, tables)
        own.stats.captured += 1
        own.stats.capture_seconds += time.perf_counter() - t0
        own.stats.graph_pool_bytes = own.pool_bytes()

    def __call__(self, params, state, tables):
        if self.graph is None:
            out = self.fn(params, state, tables)
            self.capture()
            return out
        self.audit.check(params, state, tables)
        self.graph.replay()
        for mod, counts in self.launches.items():
            for name, n in counts.items():
                mod.count_launches(name, n)
        return (state, *self.outputs)


class AOTGraphEngine:
    """Offline capture + online replay of bucketed step graphs.

    ``graph_inputs``: None keeps every entry the eager step function (the
    CPU, or eager dispatch on CUDA); otherwise a callable ``table_shapes ->
    (params, state, tables)`` giving the tensors a bucket's graph captures
    (``tables`` the bucket's preallocated table buffers), and each entry is
    a ``StepGraph``."""

    # pointer checks on the first WARMUP_CHECKS dispatches by default
    WARMUP_CHECKS = 8

    def __init__(self, step_builder, audit_every_step: bool = False,
                 r_ladder: tuple | None = None, key_tag: str | None = None,
                 graph_inputs=None):
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
        self.graph_inputs = graph_inputs
        self.pool = (None if graph_inputs is None
                     else torch.cuda.graph_pool_handle())
        # ``span(name, **attrs)``: a context manager around each capture
        # (the serving engine hands its tracer's ``span``)
        self.span = _no_span

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

    # ---------------- offline capture (Alg. 2 l.7-17) ----------------
    def capture(self, keys) -> None:
        """Build (in graph mode: capture) every bucket of ``keys`` off the
        hot path."""
        for key in keys:
            self._compile(key, offline=True)

    def _compile(self, key, offline: bool):
        if key in self._cache:
            return self._cache[key]
        t0 = time.perf_counter()
        fn, table_shapes = self._builder(key)
        self.stats.buffer_bytes += int(sum(np.prod(s) for s in
                                           table_shapes.values())) * 4
        if self.graph_inputs is None:
            entry = fn
            self.stats.captured += 1
            self.stats.capture_seconds += time.perf_counter() - t0
        else:
            entry = StepGraph(self, key, fn, table_shapes)
            if offline:
                entry.capture()
        self._cache[key] = entry
        return entry

    # ---------------- online replay (Alg. 2 l.19-24) ----------------
    def lookup(self, M: int, S: int, MB: int, W: int, R: int | None = None):
        return self.lookup_key(self.quantise(M, S, MB, W, R))

    def lookup_key(self, key: tuple):
        self.stats.lookups += 1
        if key in self._cache:
            self.stats.hits += 1
            return self._cache[key]
        self.stats.online_compiles += 1
        with self.span("aot.capture", key=key, stage="build"):
            return self._compile(key, offline=False)

    @property
    def num_graphs(self) -> int:
        return len(self._cache)

    def cached_keys(self) -> list:
        """The cached bucket keys (the elastic-join prewarm enumerates them
        to capture their wider-ring variants off the hot path)."""
        return list(self._cache)

    def clear(self) -> None:
        """Drop every entry; graphs release their pool with them."""
        self._cache.clear()

    def pool_bytes(self) -> int:
        """Device bytes of the segments the graph pool holds."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

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
