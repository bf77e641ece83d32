"""Streamed KV handoff: prefill cells -> decode cluster, chunk by chunk (a
copy of ``repro/core/handoff.py``, numpy only).

Disaggregated serving splits the cluster into dedicated chunked-prefill
cells and decode cells (``ClusterState.prefill_cells``).  A long prompt is
prefilled in fixed-size token chunks on a prefill cell; every finished
chunk's KV pages stream into the decode cluster immediately (the engine
rides ``migrate.KVReshard`` — the same donated gather->scatter that powers
escalation — with coordinates from ``GlobalPageTable.move_pages``), so
decode admission overlaps the tail of prefill instead of waiting for one
monolithic forward.

The request's DCP degree is picked from the MEASURED KV footprint at
handoff time, not a prediction: each streamed chunk grows the measured
token count, and a new decode destination opens lazily only when the
bucket degree of what has ACTUALLY landed exceeds the realized binding
width.  Prefix-cache hits therefore narrow the binding mechanically — the
attached pages count toward the measured footprint but their owners are
already binding members, and a mostly-cached request streams too few novel
tokens to open extra destinations.  A prefill-cell crash truncates the
stream the same way: only what landed counts (``survived_tokens`` seeds the
partial re-prefill).

Quantized pools need no extra plumbing here: the physical write of every
streamed chunk is the engine's fused ``PrefillScatter`` (quantize-on-
scatter — page scales are derived at landing, offset-0 resets / offset>0
clips into the page's existing scale), and the page moves go through
``GlobalPageTable.move_pages``, whose scale ledger clones the source
frames' entries onto the destination.  Chunk plans themselves are
precision-blind.

Everything here is host-side bookkeeping (pure, deterministic) — pinned by
``tests/test_torch_prefix.py``; the physical transfer lives in the engine and
the priced transfer in the simulator.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Chunk:
    """One prefill chunk: absolute token positions [start, end)."""
    start: int
    end: int

    @property
    def tokens(self) -> int:
        return self.end - self.start


def plan_chunks(prefix_hit: int, prompt_len: int, chunk_tokens: int,
                page_size: int) -> list[Chunk]:
    """Chunk plan covering the NOVEL suffix ``[prefix_hit, prompt_len)``.

    ``chunk_tokens`` must be a positive multiple of ``page_size`` and
    ``prefix_hit`` page-aligned (cache hits attach whole pages), so every
    chunk boundary except the final prompt end is page-exact — each
    streamed chunk moves whole pages and the handoff needs no partial-page
    copies.  A fully-cached prompt yields an empty plan (prefill
    short-circuits entirely; the request admits straight to decode).
    """
    if chunk_tokens <= 0 or chunk_tokens % page_size:
        raise ValueError(
            f"chunk_tokens must be a positive multiple of page_size "
            f"(got {chunk_tokens} with page_size={page_size})")
    if prefix_hit % page_size:
        raise ValueError(
            f"prefix_hit must be page-aligned (got {prefix_hit})")
    if not 0 <= prefix_hit <= prompt_len:
        raise ValueError(f"prefix_hit {prefix_hit} outside "
                         f"[0, {prompt_len}]")
    out = []
    start = prefix_hit
    while start < prompt_len:
        end = min(start + chunk_tokens, prompt_len)
        out.append(Chunk(start, end))
        start = end
    return out


class HandoffTask:
    """One request's journey through a prefill cell.

    Tracks which chunks have been computed and streamed, which decode
    destinations have been opened, and how many tokens each destination
    holds.  The engine drives it against real device transfers; the
    simulator against priced ones; the tests against
    nothing at all — the accounting is identical in all three.
    """

    def __init__(self, rid: int, prompt_len: int, prefix_hit: int,
                 chunk_tokens: int, page_size: int, prefill_instance: int,
                 attach: tuple = ()):
        self.rid = rid
        self.prompt_len = prompt_len
        self.prefix_hit = prefix_hit
        self.instance = prefill_instance
        # decode instances already holding the attached prefix pages —
        # binding members from the start, so they count toward the realized
        # degree before a single novel token streams
        self.attach = tuple(dict.fromkeys(attach))
        self.chunks = plan_chunks(prefix_hit, prompt_len, chunk_tokens,
                                  page_size)
        self.computed = 0                 # chunks forward-completed+streamed
        self.dest_tokens: dict[int, int] = {}   # decode instance -> tokens

    # ---------------- accounting ----------------
    @property
    def novel_tokens(self) -> int:
        return self.prompt_len - self.prefix_hit

    @property
    def streamed_tokens(self) -> int:
        return sum(c.tokens for c in self.chunks[:self.computed])

    @property
    def measured_tokens(self) -> int:
        """KV footprint that has ACTUALLY landed on decode instances:
        attached prefix pages + streamed chunks.  This — not the predicted
        ``prompt_len`` — drives degree selection."""
        return self.prefix_hit + self.streamed_tokens

    @property
    def remaining_tokens(self) -> int:
        return self.novel_tokens - self.streamed_tokens

    @property
    def done(self) -> bool:
        return self.computed >= len(self.chunks)

    def next_chunk(self) -> Chunk | None:
        """The next chunk owed a forward pass (None when done)."""
        if self.done:
            return None
        return self.chunks[self.computed]

    def survived_tokens(self) -> int:
        """Prefix length that survives a prefill-cell crash mid-stream:
        everything already handed off lives on decode instances — a
        re-staged task resumes from here (a partial re-prefill, never a
        from-scratch recompute of streamed chunks)."""
        return self.measured_tokens

    # ---------------- measured-footprint degree ----------------
    def binding(self) -> list[int]:
        """Realized decode binding: attach owners + opened destinations."""
        return sorted(set(self.attach) | set(self.dest_tokens))

    def measured_degree(self) -> int:
        return max(len(self.binding()), 1)

    def complete_chunk(self, buckets, candidates: list[int]) -> tuple:
        """Mark the next chunk computed and pick its stream destination.

        The measured footprint INCLUDING this chunk decides whether the
        realized binding must widen: a new destination (first candidate not
        already a binding member) opens only when
        ``buckets.cp_degree(measured)`` exceeds the current binding width —
        degree selection by what landed, not by prediction.  Within the
        open destinations the chunk goes to the least-loaded (deterministic
        id tie-break), so streamed tokens stay WaterFill-balanced.

        Returns ``(chunk, destination_instance)``.
        """
        chunk = self.next_chunk()
        if chunk is None:
            raise RuntimeError(f"rid {self.rid}: all chunks already streamed")
        self.computed += 1
        measured = self.prefix_hit + self.streamed_tokens
        deg = buckets.cp_degree(measured)
        realized = set(self.attach) | set(self.dest_tokens)
        cand_set = set(candidates)
        if len(realized) < deg:
            for c in candidates:
                if c not in realized:
                    self.dest_tokens.setdefault(c, 0)
                    break
        # candidates are the CALLER-VIABLE destinations (enough headroom for
        # this chunk); an already-open destination that fell out of the list
        # is skipped this chunk, never written over capacity
        viable = [d for d in self.dest_tokens if d in cand_set]
        if not viable:
            for c in candidates:
                self.dest_tokens.setdefault(c, 0)
                viable = [c]
                break
        if not viable:
            raise ValueError(
                f"rid {self.rid}: no viable decode destination for chunk "
                f"[{chunk.start}, {chunk.end})")
        dest = min(viable, key=lambda d: (self.dest_tokens[d], d))
        self.dest_tokens[dest] += chunk.tokens
        return chunk, dest
