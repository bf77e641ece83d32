"""Global page table: logical KV page -> (instance, frame)  (§4.1).

vLLM-style shared-per-CP-group page tables assume one fixed parallelism
degree; under DCP requests in one batch have different CP sizes, so NanoCP
keeps a single cluster-wide mapping: each request owns a list of *logical*
pages, each resolving to a physical (instance_id, frame_id) tuple.  Frames
are per-instance fixed-size slots in that instance's KV pool.

The table is pure host-side data (numpy/int dicts); the control plane lowers
it into per-instance block-table tensors each iteration (core/routing.py).

Frame ownership is REFCOUNTED: a frame may be shared by several
requests (a global prefix-cache hit attaches a rid to existing full frames)
and by the prefix cache itself (``CACHE_OWNER`` holds).  Every allocation
path claims ownership, every free path releases it, and a frame returns to
its pool only when the last owner leaves.  A refcount>1 frame is IMMOVABLE
and UNWRITABLE for any single owner: divergent appends and partial-tail
writes must ``cow_split`` first (clone the owner's resident tokens into a
fresh exclusive frame — priced as a copy, the source frame stays), and a
"move" out of a shared frame is physically a copy too (the source frame is
only freed when its owner set empties).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# sentinel owner id for the global prefix cache's own holds (rids are >= 0)
CACHE_OWNER = -1

# sentinel scale for a frame whose per-page quant scale is device-derived and
# not (yet) mirrored to the host ledger (real scales are strictly positive)
SCALE_PENDING = -1.0


class KVSpillError(MemoryError):
    """Mid-decode KV growth overran its shard: request ``rid`` needs a new
    frame on ``instance`` and the instance's pool has none.

    Typed (rather than a bare allocator ``MemoryError``) so the control plane
    can react per-request: the engine catches it at the table-lowering stage
    and either escalates the request's CP degree (live KV re-shard onto a
    shard with headroom) or finishes the request with a clean OOM."""

    def __init__(self, rid: int, instance: int):
        super().__init__(
            f"request {rid}: KV pool exhausted on instance {instance} "
            f"(decode append needs a frame)")
        self.rid = rid
        self.instance = instance


@dataclass
class FramePool:
    """Per-instance physical frame allocator.

    ``stripes``: hybrid-KV page striping factor (core/dcp.py) — frame f
    belongs to device stripe f % stripes.  The allocator keeps one LIFO
    free-list per stripe and draws from the fullest stripe so a request's
    pages spread evenly across stripes (bounds the per-device block-table
    width MBT).  LIFO reuse order stays deliberately fragmentation-prone
    (the HoL experiments rely on realistic occupancy).

    ``stripes`` is ``attn_tp_geometry(cfg, tp).ps``: tp/khs devices per
    kv-head shard.  Under head grouping (tp < num_kv_heads) ps == 1 — every
    frame holds ALL of the chunk's kv-head group, so striping degenerates
    and the single free-list is exact (grouping and striping never
    compose, by construction of the geometry).
    """
    instance: int
    num_frames: int
    stripes: int = 1
    _free: list = field(default_factory=list)     # per-stripe free lists

    def __post_init__(self):
        self._free = [[] for _ in range(self.stripes)]
        for f in range(self.num_frames - 1, -1, -1):
            self._free[f % self.stripes].append(f)

    @property
    def free_frames(self) -> int:
        return sum(len(fl) for fl in self._free)

    def alloc(self, n: int) -> list[int]:
        if n > self.free_frames:
            raise MemoryError(
                f"instance {self.instance}: want {n} frames, have {self.free_frames}")
        out = []
        for _ in range(n):
            fl = max(self._free, key=len)
            out.append(fl.pop())
        return out

    def free(self, frames) -> None:
        for f in frames:
            assert 0 <= f < self.num_frames
            self._free[f % self.stripes].append(f)

    def drain(self) -> None:
        self._free = [[] for _ in range(self.stripes)]


@dataclass
class GlobalPageTable:
    """Unified logical-page mapping for the whole cluster."""
    num_instances: int
    frames_per_instance: int
    page_size: int
    stripes: int = 1
    pools: list = field(default_factory=list)
    # rid -> list of (instance, frame) in token order
    _pages: dict = field(default_factory=dict)
    # rid -> tokens used in the last (partially filled) page
    _last_fill: dict = field(default_factory=dict)
    # incremental per-instance used-token counters (hot path for the
    # scheduler's KV-load queries)
    _used: list = field(default_factory=list)
    # rid -> {instance: [frames]} cache (hot path for routing lowering)
    _frames_by_shard: dict = field(default_factory=dict)
    # rid -> {instance: np.int32 frame array}; invalidated whenever the
    # underlying frame list changes (routing lowering reads these every
    # iteration — bulk ops need ndarray views, not python lists).  Keyed by
    # rid at the top level so request teardown drops every cached view,
    # including zero-frame shards that never entered _frames_by_shard.
    _frames_np: dict = field(default_factory=dict)
    # rid -> {instance: [[start, len], ...]} — ABSOLUTE token-position ranges
    # (0-based over the request's full context) held by each shard, in the
    # shard's fill order.  Decode attention is position-agnostic past the
    # LSE merge, so the hot path never reads this; it exists so an abrupt
    # instance failure can report the EXACT positions that died with the
    # instance (``drop_instance``) for a partial-shard re-prefill
    # (``restore_ranges``) — surviving shards untouched.
    _ranges: dict = field(default_factory=dict)
    # (instance, frame) -> set of owners: rids plus CACHE_OWNER for prefix-
    # cache holds.  THE refcount ledger — a frame is live iff it has an
    # entry, and returns to its pool exactly when the set empties.
    _owners: dict = field(default_factory=dict)
    # (instance, frame) -> per-page quant scale (kernels/quant.py sidecar).
    # LIFECYCLE ledger, not the numeric truth: the device scale arrays in
    # the serve state are authoritative (scales are derived and consumed
    # inside the fused scatter/reshard bodies and never round-trip to the
    # host on the hot path), so most entries hold SCALE_PENDING.  The
    # ledger exists so frame lifecycle stays auditable — an entry is
    # created with the claim, cloned by CoW/fork, max-propagated by
    # move_pages, and dropped with the last release; ``frame_audit``
    # asserts it stays in lockstep with ``_owners``.  Always maintained
    # (bf16 engines too): the bookkeeping is dtype-independent.
    _frame_scale: dict = field(default_factory=dict)
    # monotone counter: copy-on-write splits performed (divergent appends,
    # shared-tail moves, forks) — the accounting surface for layer 4
    cow_splits: int = 0

    def __post_init__(self):
        self.pools = [FramePool(i, self.frames_per_instance, self.stripes)
                      for i in range(self.num_instances)]
        self._used = [0] * self.num_instances

    # ---------------- frame ownership (refcounts) ----------------
    def _claim(self, owner: int, instance: int, frame: int) -> None:
        self._owners.setdefault((instance, frame), set()).add(owner)
        self._frame_scale.setdefault((instance, frame), SCALE_PENDING)

    def _release(self, owner: int, instance: int, frame: int) -> bool:
        """Drop ``owner``'s claim; the frame returns to the pool only when
        the owner set empties.  Returns True iff the frame was freed."""
        key = (instance, frame)
        own = self._owners.get(key)
        assert own is not None and owner in own, (owner, key, own)
        own.discard(owner)
        if own:
            return False
        del self._owners[key]
        self._frame_scale.pop(key, None)
        self.pools[instance].free([frame])
        return True

    # ---------------- per-frame quant scales (lifecycle ledger) ----------
    def set_frame_scale(self, instance: int, frame: int, scale: float) -> None:
        """Mirror a device-derived per-page quant scale into the ledger
        (tests/tools; the hot path leaves entries SCALE_PENDING).  The frame
        must be live."""
        key = (instance, frame)
        assert key in self._owners, ("scale for an unowned frame", key)
        assert scale > 0, ("frame scales are strictly positive", key, scale)
        self._frame_scale[key] = float(scale)

    def frame_scale(self, instance: int, frame: int) -> float:
        """The ledger's scale for a live frame (SCALE_PENDING when only the
        device arrays know it)."""
        key = (instance, frame)
        assert key in self._owners, ("scale of an unowned frame", key)
        return self._frame_scale[key]

    def frame_refcount(self, instance: int, frame: int) -> int:
        return len(self._owners.get((instance, frame), ()))

    def frame_shared(self, rid: int, instance: int, frame: int) -> bool:
        """The frame has an owner BESIDES ``rid`` (another request or a
        prefix-cache hold) — rid must not write or vacate-free it."""
        return bool(self._owners.get((instance, frame), set()) - {rid})

    def cache_hold(self, instance: int, frame: int) -> None:
        """Prefix-cache hold: keeps the frame resident past its requests."""
        self._claim(CACHE_OWNER, instance, frame)

    def cache_release(self, instance: int, frame: int) -> bool:
        """Drop the cache hold; True iff that freed the frame (refcount was
        1, i.e. no active request still reads it)."""
        return self._release(CACHE_OWNER, instance, frame)

    def exclusive_frames(self, rid: int, instance: int) -> int:
        """``rid``'s frames on ``instance`` that would actually return to
        the pool if rid vacated — the honest frame gain of a relax/retract
        (shared frames stay with their other owners: a copy, not a move)."""
        return sum(1 for f in self._frames_by_shard.get(rid, {})
                   .get(instance, ())
                   if not self.frame_shared(rid, instance, f))

    def movable_tail(self, rid: int, instance: int) -> int:
        """Tokens at the shard's fill TAIL living in exclusively-owned
        frames — the most a planner may move off this shard as a true move.
        Anything deeper sits in (or behind) a refcount>1 frame: immovable
        unless priced as a CoW copy."""
        frames = self._frames_by_shard.get(rid, {}).get(instance, ())
        used = self._last_fill.get(rid, {}).get(instance, 0)
        movable = 0
        for idx in range(len(frames) - 1, -1, -1):
            if self.frame_shared(rid, instance, frames[idx]):
                break
            lo = idx * self.page_size
            movable += max(min(used, lo + self.page_size) - lo, 0)
        return movable

    # ---------------- allocation ----------------
    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def can_allocate(self, split: dict[int, int]) -> bool:
        return all(self.pools[s].free_frames >= self.pages_needed(t)
                   for s, t in split.items() if t > 0)

    def allocate(self, rid: int, split: dict[int, int],
                 prefix: dict | None = None) -> None:
        """Allocate a request's KV pages per the WaterFill split.

        ``prefix``: optional ``{instance: (start_pos, [frames])}`` — a
        prefix-cache hit.  The rid is ATTACHED to the existing FULL frames
        (an ownership claim — no allocation, no data movement): they become
        the head of each shard's fill, holding the absolute positions
        [start_pos, start_pos + len(frames)*page_size).  The attached
        ranges must tile [0, P) exactly.  ``split`` then counts only the
        NOVEL suffix tokens, which land in fresh frames after the attached
        pages (attached pages are full, so the suffix starts page-aligned)
        in sorted-instance order starting at absolute position P.

        Invariant: every live token has exactly one resolvable (instance,
        frame, offset) home, and frames are conserved — allocate/free pairs
        balance per pool.  Pinned by the page-table tests in
        tests/test_control_plane.py, the attach semantics in
        tests/test_prefix.py, and the frame-conservation audits in
        tests/test_properties.py."""
        assert rid not in self._pages, f"request {rid} already allocated"
        if not self.can_allocate(split):
            raise MemoryError(f"request {rid}: split {split} does not fit")
        self._frames_np.pop(rid, None)
        pages = []
        by_shard = {}
        shard_fill = {}
        ranges = {}
        prefix_tokens = 0
        if prefix:
            spans = sorted((prefix[s][0], len(prefix[s][1]) * self.page_size)
                           for s in prefix if prefix[s][1])
            pos = 0
            for st, ln in spans:
                assert st == pos, f"prefix ranges must tile [0, P): {spans}"
                pos += ln
            for s in sorted(prefix):
                start_pos, frames = prefix[s]
                if not frames:
                    continue
                for f in frames:
                    self._claim(rid, s, f)
                pages.extend((s, f) for f in frames)
                by_shard[s] = list(frames)
                t = len(frames) * self.page_size
                shard_fill[s] = t
                ranges[s] = [[start_pos, t]]
                self._used[s] += t
                prefix_tokens += t
        # suffix: shard s holds the contiguous range assigned by
        # migrate.shard_ranges/prefill_coords — sorted-instance order
        start = prefix_tokens
        for s in sorted(split):
            t = split[s]
            if t <= 0:
                continue
            frames = self.pools[s].alloc(self.pages_needed(t))
            for f in frames:
                self._claim(rid, s, f)
            pages.extend((s, f) for f in frames)
            by_shard.setdefault(s, []).extend(frames)
            shard_fill[s] = shard_fill.get(s, 0) + t
            ranges.setdefault(s, []).append([start, t])
            self._used[s] += t
            start += t
        self._pages[rid] = pages
        self._last_fill[rid] = shard_fill
        self._frames_by_shard[rid] = by_shard
        self._ranges[rid] = ranges

    def append_needs_frame(self, rid: int, instance: int) -> bool:
        """Whether the next ``append_token(rid, instance)`` must grow a page."""
        used = self._last_fill[rid].get(instance, 0)
        frames = self._frames_by_shard.get(rid, {}).get(instance, ())
        return used >= len(frames) * self.page_size

    def append_needs_cow(self, rid: int, instance: int) -> bool:
        """Whether the next ``append_token(rid, instance)`` would write into
        a SHARED frame (a fork/prefix sibling still reads it) — the caller
        must ``cow_split`` that tail first.  False when the append grows a
        fresh frame: new frames are always exclusive."""
        used = self._last_fill[rid].get(instance, 0)
        frames = self._frames_by_shard.get(rid, {}).get(instance, ())
        if used >= len(frames) * self.page_size:
            return False
        return self.frame_shared(rid, instance, frames[used // self.page_size])

    def append_token(self, rid: int, instance: int) -> tuple[int, int]:
        """Append one decoded token's KV on ``instance``; grows a page if
        needed.  Returns (frame, offset) of the new token.

        Raises ``KVSpillError`` (not a bare allocator error) when the shard's
        pool is exhausted — the caller decides between CP escalation and a
        request-level OOM finish."""
        shard_fill = self._last_fill[rid]
        used = shard_fill.get(instance, 0)
        my_frames = self._frames_by_shard.setdefault(rid, {}).setdefault(
            instance, [])
        cap = len(my_frames) * self.page_size
        if used >= cap:
            if self.pools[instance].free_frames < 1:
                raise KVSpillError(rid, instance)
            frame = self.pools[instance].alloc(1)[0]
            self._claim(rid, instance, frame)
            self._pages[rid].append((instance, frame))
            my_frames.append(frame)
            self._frames_np.get(rid, {}).pop(instance, None)
        frame = my_frames[used // self.page_size]
        assert not self.frame_shared(rid, instance, frame), (
            rid, instance, frame,
            "append into a shared frame — cow_split first (append_needs_cow)")
        offset = used % self.page_size
        shard_fill[instance] = used + 1
        self._used[instance] += 1
        # the appended token's absolute position is the request's total fill
        pos = sum(shard_fill.values()) - 1
        rr = self._ranges.setdefault(rid, {}).setdefault(instance, [])
        if rr and rr[-1][0] + rr[-1][1] == pos:
            rr[-1][1] += 1
        else:
            rr.append([pos, 1])
        return frame, offset

    def pop_token(self, rid: int, instance: int) -> None:
        """Roll back the MOST RECENT ``append_token(rid, instance)`` — the
        in-flight-discard path: a failure between dispatch and harvest voids
        the iteration, so the KV slot appended for its input token must be
        un-reserved before the failure accounting runs (the next dispatch
        re-appends the same token at the same position).  Frees the tail
        frame if the pop fully vacates it."""
        shard_fill = self._last_fill[rid]
        used = shard_fill.get(instance, 0)
        assert used > 0, (rid, instance, "pop_token on empty shard")
        shard_fill[instance] = used - 1
        self._used[instance] -= 1
        rr = self._ranges[rid][instance]
        rr[-1][1] -= 1
        if rr[-1][1] == 0:
            rr.pop()
        if not rr:
            del self._ranges[rid][instance]
        frames = self._frames_by_shard[rid][instance]
        if len(frames) > self.pages_needed(used - 1):
            f = frames.pop()
            self._release(rid, instance, f)
            self._pages[rid].remove((instance, f))
            self._frames_np.get(rid, {}).pop(instance, None)

    def move_pages(self, rid: int, moves) -> tuple["np.ndarray", "np.ndarray"]:
        """Re-shard bookkeeping: move KV tokens of ``rid`` between instances.

        ``moves``: [(src_instance, dst_instance, tokens)] — each move takes
        the TAIL ``tokens`` of the source shard's fill and appends them to the
        destination shard (allocating frames there, freeing fully-vacated
        source frames).  Token->shard assignment is order-agnostic for decode
        attention (LSE merge), so the tail is the cheapest correct slice.

        A shard must not appear as both a source and a destination within one
        call: the data plane applies all moves as a single gather->scatter
        whose gathers read the PRE-move pools.

        Returns ``(src_coords, dst_coords)`` int32 [3, T] (instance, frame,
        offset) per moved token, in matching order — the coordinate tensors
        ``migrate.KVReshard`` consumes.  Raises ``KVSpillError`` if a
        destination shard cannot allocate the frames it needs — callers plan
        moves against per-shard headroom (``free_frames``) so this only fires
        on a planner bug.

        Pinned by tests/test_escalation.py (escalate/relax re-shards),
        tests/test_handoff.py (chunked prefill scatters straight to decode
        destinations through these coordinates), and the ``escalation`` /
        ``disagg`` conformance shards (token equality across the move).
        """
        srcs = {s for s, _, n in moves if n > 0}
        dsts = {d for _, d, n in moves if n > 0}
        assert not (srcs & dsts), f"shard both source and destination: {srcs & dsts}"
        self._frames_np.pop(rid, None)
        shard_fill = self._last_fill[rid]
        by_shard = self._frames_by_shard.setdefault(rid, {})
        page = self.page_size
        s_cols, d_cols = [], []
        for src, dst, n in moves:
            if n <= 0:
                continue
            assert src != dst, (src, dst)
            used_s = shard_fill.get(src, 0)
            assert n <= used_s, (rid, src, n, used_s)
            fs = by_shard[src]
            pos = np.arange(used_s - n, used_s)
            s_cols.append(np.stack([np.full(n, src),
                                    np.asarray(fs)[pos // page], pos % page]))
            # contributor frames for the scale ledger: the src frames whose
            # tokens land in newly-allocated dst frames below
            src_scales = [self._frame_scale.get((src, f), SCALE_PENDING)
                          for f in {int(x) for x in np.asarray(fs)[pos // page]}]
            # destination: extend the shard's fill (allocate frames as needed)
            used_d = shard_fill.get(dst, 0)
            fd = by_shard.setdefault(dst, [])
            if used_d % page and fd and self.frame_shared(rid, dst, fd[-1]):
                # the move would append into a SHARED partial tail — CoW-split
                # it first (the copy rides the same gather->scatter: its
                # gather reads the untouched shared frame, pre-move state)
                cs, cd = self.cow_split(rid, dst, fd[-1])
                s_cols.append(cs)
                d_cols.append(cd)
            need = self.pages_needed(used_d + n) - len(fd)
            if need > 0:
                if self.pools[dst].free_frames < need:
                    raise KVSpillError(rid, dst)
                new = self.pools[dst].alloc(need)
                # dst frames requantize with a scale covering every
                # contributing src page (the device body's offset-0 rule);
                # the ledger mirrors that as the max of the KNOWN src
                # scales, or stays PENDING when none were mirrored
                known = [v for v in src_scales if v > 0]
                val = max(known) if known else SCALE_PENDING
                for f in new:
                    self._claim(rid, dst, f)
                    self._frame_scale[(dst, f)] = val
                self._pages[rid].extend((dst, f) for f in new)
                fd.extend(new)
            dpos = np.arange(used_d, used_d + n)
            d_cols.append(np.stack([np.full(n, dst),
                                    np.asarray(fd)[dpos // page], dpos % page]))
            # shrink the source: release fully-vacated frames.  A SHARED
            # source frame is not freed (its other owners keep it) — the
            # "move" out of it is physically a copy, which is exactly what
            # the gather->scatter performs; only rid's claim is dropped.
            left = used_s - n
            keep = self.pages_needed(left)
            freed = fs[keep:]
            del fs[keep:]
            if freed:
                for f in freed:
                    self._release(rid, src, f)
                gone = set(freed)
                self._pages[rid] = [(s_, f) for (s_, f) in self._pages[rid]
                                    if not (s_ == src and f in gone)]
            shard_fill[src] = left
            shard_fill[dst] = used_d + n
            self._used[src] -= n
            self._used[dst] += n
            # position bookkeeping: the moved tail's position ranges leave
            # the source's tail and append to the destination in fill order
            rmap = self._ranges.setdefault(rid, {})
            rr_s = rmap.get(src, [])
            taken, need = [], n
            while need > 0:
                st, ln = rr_s[-1]
                take = min(ln, need)
                if take == ln:
                    rr_s.pop()
                else:
                    rr_s[-1][1] = ln - take
                taken.append([st + ln - take, take])
                need -= take
            if not rr_s:
                rmap.pop(src, None)
            rr_d = rmap.setdefault(dst, [])
            for st, ln in reversed(taken):
                if rr_d and rr_d[-1][0] + rr_d[-1][1] == st:
                    rr_d[-1][1] += ln
                else:
                    rr_d.append([st, ln])
        if not s_cols:
            z = np.zeros((3, 0), np.int32)
            return z, z
        return (np.concatenate(s_cols, axis=1).astype(np.int32),
                np.concatenate(d_cols, axis=1).astype(np.int32))

    # ---------------- copy-on-write / fork ----------------
    def cow_split(self, rid: int, instance: int, frame: int
                  ) -> tuple["np.ndarray", "np.ndarray"]:
        """Clone ``rid``'s resident tokens in a SHARED frame into a fresh
        exclusive frame on the same instance (copy-on-write).  The source
        frame keeps its other owners untouched; rid's claim moves to the
        clone and rid's logical pages resolve to it from here on.

        Returns ``(src_coords, dst_coords)`` int32 [3, T] for the data-plane
        copy — same gather->scatter contract as ``move_pages`` (the gather
        reads the shared frame, which nothing scatters into).  Raises
        ``KVSpillError`` when the instance has no free frame.

        Invariant: a shared frame is never appended into — writers split
        first, so other owners' tokens are bit-identical before and after.
        Pinned by tests/test_prefix.py, the CoW/refcount audits in
        tests/test_properties.py, and the ``prefix`` conformance shard."""
        assert self.frame_shared(rid, instance, frame), (
            rid, instance, frame, "cow_split of an exclusive frame")
        frames = self._frames_by_shard[rid][instance]
        idx = frames.index(frame)
        if self.pools[instance].free_frames < 1:
            raise KVSpillError(rid, instance)
        clone = self.pools[instance].alloc(1)[0]
        self._claim(rid, instance, clone)
        # the clone is a bit-copy of the shared frame, so it inherits the
        # frame's quant scale verbatim (read before rid's claim is released)
        self._frame_scale[(instance, clone)] = self._frame_scale.get(
            (instance, frame), SCALE_PENDING)
        used = self._last_fill[rid].get(instance, 0)
        lo = idx * self.page_size
        n = min(used, lo + self.page_size) - lo
        assert n > 0, (rid, instance, frame, used)
        off = np.arange(n)
        src = np.stack([np.full(n, instance), np.full(n, frame), off])
        dst = np.stack([np.full(n, instance), np.full(n, clone), off])
        frames[idx] = clone
        pages = self._pages[rid]
        pages[pages.index((instance, frame))] = (instance, clone)
        self._frames_np.pop(rid, None)
        self._release(rid, instance, frame)
        self.cow_splits += 1
        return src.astype(np.int32), dst.astype(np.int32)

    def exclusive_tails(self, rid: int) -> tuple["np.ndarray", "np.ndarray"]:
        """Pre-pass for paths that append into existing tail slack
        (``restore_ranges``, decode appends): CoW-split every shared partial
        tail frame so the write targets are exclusively owned.  Returns the
        concatenated ``(src, dst)`` copy coords ([3, 0] when nothing was
        shared)."""
        s_cols, d_cols = [], []
        for s in sorted(self._frames_by_shard.get(rid, {})):
            frames = self._frames_by_shard[rid][s]
            used = self._last_fill.get(rid, {}).get(s, 0)
            if not frames or used % self.page_size == 0:
                continue
            if self.frame_shared(rid, s, frames[-1]):
                cs, cd = self.cow_split(rid, s, frames[-1])
                s_cols.append(cs)
                d_cols.append(cd)
        if not s_cols:
            z = np.zeros((3, 0), np.int32)
            return z, z
        return (np.concatenate(s_cols, axis=1),
                np.concatenate(d_cols, axis=1))

    def fork_request(self, child: int, parent: int
                     ) -> tuple["np.ndarray", "np.ndarray"]:
        """Fork mid-decode: ``child`` attaches to ``parent``'s resident KV.
        Full frames are SHARED (a refcount bump — zero data movement); each
        shard's PARTIAL tail frame is CoW-copied so the two branches can
        append divergent tokens without trampling each other.  The parent
        keeps the original tail (still exclusive to it); the child gets the
        clone.

        Returns ``(src, dst)`` int32 [3, T] coords of the tail copies for
        the data plane.  Pre-flight checks every needed tail frame before
        mutating anything, so a ``KVSpillError`` leaves the table
        untouched."""
        assert child not in self._pages, f"request {child} already allocated"
        fill = self._last_fill.get(parent, {})
        by_shard = self._frames_by_shard.get(parent, {})
        page = self.page_size
        tails = {s: frames[-1] for s, frames in by_shard.items()
                 if frames and fill.get(s, 0) % page}
        for s in tails:
            if self.pools[s].free_frames < 1:
                raise KVSpillError(child, s)
        pages, cby, cfill, cranges = [], {}, {}, {}
        s_cols, d_cols = [], []
        for s in sorted(by_shard):
            frames = by_shard[s]
            used = fill.get(s, 0)
            if used <= 0:
                continue
            shared = frames[:-1] if s in tails else list(frames)
            for f in shared:
                self._claim(child, s, f)
            cf = list(shared)
            if s in tails:
                clone = self.pools[s].alloc(1)[0]
                self._claim(child, s, clone)
                # bit-copy of the parent's tail -> same quant scale
                self._frame_scale[(s, clone)] = self._frame_scale.get(
                    (s, tails[s]), SCALE_PENDING)
                n = used - (len(frames) - 1) * page
                off = np.arange(n)
                s_cols.append(np.stack([np.full(n, s),
                                        np.full(n, tails[s]), off]))
                d_cols.append(np.stack([np.full(n, s),
                                        np.full(n, clone), off]))
                cf.append(clone)
                self.cow_splits += 1
            pages.extend((s, f) for f in cf)
            cby[s] = cf
            cfill[s] = used
            cranges[s] = [list(r) for r in
                          self._ranges.get(parent, {}).get(s, [])]
            self._used[s] += used
        self._pages[child] = pages
        self._frames_by_shard[child] = cby
        self._last_fill[child] = cfill
        self._ranges[child] = cranges
        if not s_cols:
            z = np.zeros((3, 0), np.int32)
            return z, z
        return (np.concatenate(s_cols, axis=1).astype(np.int32),
                np.concatenate(d_cols, axis=1).astype(np.int32))

    def free_request(self, rid: int) -> None:
        """Teardown: DECREF every frame the request maps — a frame returns
        to its pool only when no other request (and no prefix-cache hold)
        still owns it."""
        for s, f in self._pages.pop(rid, []):
            self._release(rid, s, f)
        for s, t in self._last_fill.pop(rid, {}).items():
            self._used[s] -= t
        self._frames_by_shard.pop(rid, None)
        self._frames_np.pop(rid, None)
        self._ranges.pop(rid, None)

    # ---------------- queries ----------------
    def shard_tokens(self, rid: int) -> dict[int, int]:
        """instance -> valid tokens of this request's KV on that instance."""
        return dict(self._last_fill.get(rid, {}))

    def shard_frames(self, rid: int, instance: int) -> list[int]:
        return self._frames_by_shard.get(rid, {}).get(instance, [])

    def shard_tail_slack(self, rid: int, instance: int) -> int:
        """Free token slots inside the request's OWN frames on ``instance``
        (the partial tail page).  ``move_pages`` appends into this slack
        without allocating a frame — the relaxation planner's cheapest
        receiver capacity.  A SHARED tail frame reports 0: writing into it
        would corrupt the other owners' KV, so its physical slack is not
        receiver capacity (a CoW split would spend a frame, which is no
        longer "free" slack)."""
        frames = self._frames_by_shard.get(rid, {}).get(instance, ())
        used = self._last_fill.get(rid, {}).get(instance, 0)
        if frames and self.frame_shared(rid, instance, frames[-1]):
            return 0
        return len(frames) * self.page_size - used

    def fragmented_frames(self, rid: int) -> dict[int, int]:
        """instance -> frames this request holds BEYOND the minimum
        ``pages_needed`` for its resident tokens there (0 everywhere under
        the move/append invariants — a nonzero entry means stranded pages)."""
        out = {}
        for s, frames in self._frames_by_shard.get(rid, {}).items():
            t = self._last_fill.get(rid, {}).get(s, 0)
            out[s] = len(frames) - self.pages_needed(t)
        return out

    def shard_frames_np(self, rid: int, instance: int) -> "np.ndarray":
        """``shard_frames`` as a cached int32 ndarray (do not mutate)."""
        cache = self._frames_np.setdefault(rid, {})
        arr = cache.get(instance)
        if arr is None:
            import numpy as np
            arr = np.asarray(
                self._frames_by_shard.get(rid, {}).get(instance, ()),
                dtype=np.int32)
            cache[instance] = arr
        return arr

    def instance_used_tokens(self, instance: int) -> int:
        return self._used[instance]

    def free_frames(self, instance: int) -> int:
        return self.pools[instance].free_frames

    def total_free_frames(self) -> int:
        return sum(p.free_frames for p in self.pools)

    def request_positions(self, rid: int) -> dict[int, list]:
        """instance -> [(start, len), ...] absolute token-position ranges the
        request's KV occupies on each shard (fill order).  The union across
        shards partitions [0, total_resident) for an intact request; after a
        partial drop, the holes are exactly the lost ranges."""
        return {s: [tuple(r) for r in rr]
                for s, rr in self._ranges.get(rid, {}).items() if rr}

    def frame_audit(self) -> dict[int, tuple[int, int]]:
        """instance -> (free_frames, held_frames): the leak check.  For every
        alive instance free+held must equal ``frames_per_instance``; a dead
        (drained) instance must show (0, 0) — any other total is a leaked or
        aliased frame.

        A SHARED frame counts exactly ONCE physically (the ``_owners``
        ledger is the source of truth), however many requests map it
        logically.  The audit also cross-checks the ledger against the page
        maps: every mapped page must be owned by its rid, and every owner
        entry must be mapped by some rid or be a pure prefix-cache hold —
        a mismatch is a double-free or leak in the making."""
        held = [0] * self.num_instances
        mapped = set()
        for rid, pages in self._pages.items():
            for s, f in pages:
                mapped.add((s, f))
                own = self._owners.get((s, f))
                assert own is not None and rid in own, (
                    "page mapped but not owned", rid, s, f, own)
        for (s, f), own in self._owners.items():
            assert own, ("empty owner set leaked", s, f)
            assert (s, f) in mapped or own == {CACHE_OWNER}, (
                "owned frame mapped by no request", s, f, own)
            held[s] += 1
        # scale/ownership lockstep: every live frame has exactly one scale
        # entry (PENDING or a real positive scale) and no freed frame keeps
        # a stale one — a mismatch means a movement path dropped or leaked
        # the quant sidecar
        assert set(self._frame_scale) == set(self._owners), (
            "scale ledger out of sync with frame ownership",
            set(self._frame_scale) ^ set(self._owners))
        for key, v in self._frame_scale.items():
            assert v == SCALE_PENDING or v > 0, ("illegal frame scale", key, v)
        return {s: (self.pools[s].free_frames, held[s])
                for s in range(self.num_instances)}

    def position_coords(self, rid: int, positions) -> "np.ndarray":
        """Map absolute context positions -> int32 [3, T] (instance, frame,
        offset) coords via the per-shard fill-order ranges.  Every queried
        position must be resident.  This is the scatter-target resolver for
        suffix-only prefill and for recovery re-prefill of shared ranges —
        unlike ``migrate.prefill_coords`` it makes no assumption about HOW
        positions were assigned to shards (prefix-attach breaks the
        contiguous sorted-order layout)."""
        page = self.page_size
        out = np.zeros((3, len(positions)), np.int64)
        rmap = self._ranges.get(rid, {})
        for k, p in enumerate(positions):
            p = int(p)
            hit = None
            for s, rr in rmap.items():
                fill = 0
                for st, ln in rr:
                    if st <= p < st + ln:
                        hit = (s, fill + (p - st))
                        break
                    fill += ln
                if hit is not None:
                    break
            assert hit is not None, (rid, p, "position not resident")
            s, fi = hit
            frames = self._frames_by_shard[rid][s]
            out[:, k] = (s, frames[fi // page], fi % page)
        return out.astype(np.int32)

    def aligned_pages(self, rid: int, limit: int) -> list:
        """Prompt pages eligible for the prefix cache.  Page p (absolute
        positions [p*page_size, (p+1)*page_size)) qualifies iff it sits
        page-ALIGNED and CONTIGUOUS inside a single shard's fill — then it
        occupies exactly one frame and can be attached wholesale to a later
        request.  Returns sorted [(page_index, instance, frame)] for pages
        fully below ``limit`` (the prompt length — decoded tokens are never
        cached).  Within one range, fill offset and absolute position
        advance together, so alignment checked at the range start holds for
        the whole run."""
        page = self.page_size
        out = []
        for s, rr in self._ranges.get(rid, {}).items():
            frames = self._frames_by_shard.get(rid, {}).get(s, [])
            fill = 0
            for st, ln in rr:
                if fill % page == 0 and st % page == 0:
                    for q in range(ln // page):
                        pidx = st // page + q
                        if (pidx + 1) * page <= limit:
                            out.append((pidx, s, frames[fill // page + q]))
                fill += ln
        return sorted(out)

    def drop_instance(self, instance: int) -> dict[int, list]:
        """Abrupt instance failure: PARTIAL-SHARD drop.  Frees ONLY the dead
        instance's frames — surviving shards stay untouched — and returns
        ``{rid: [(start, len), ...]}``: the exact absolute token-position
        ranges whose KV died with the instance, i.e. the ranges a recovery
        re-prefill (``restore_ranges``) must replay.  The instance's pool is
        replaced and drained so nothing allocates there until
        ``join_instance`` brings it back."""
        lost = {}
        for rid, pages in self._pages.items():
            fill = self._last_fill.get(rid, {})
            t = fill.pop(instance, None)
            ranges = self._ranges.get(rid, {}).pop(instance, None)
            dropped = self._frames_by_shard.get(rid, {}).pop(instance, None)
            if t is None and not dropped:
                continue
            if t:
                lost[rid] = [tuple(r) for r in (ranges or [])]
                assert sum(l for _, l in lost[rid]) == t, (rid, t, ranges)
            self._frames_np.pop(rid, None)
            self._pages[rid] = [(s, f) for s, f in pages if s != instance]
        # the dead instance's frames are gone for EVERY owner at once —
        # shared prefix pages included (each surviving owner re-prefills its
        # own lost ranges; the sharing is lost with the hardware).  Purge
        # the ledger before the pool reset so cache-only holds don't trip
        # the aliasing guard.
        self._owners = {(s, f): own for (s, f), own in self._owners.items()
                        if s != instance}
        self._frame_scale = {(s, f): v for (s, f), v in
                             self._frame_scale.items() if s != instance}
        self._used[instance] = 0
        # drained: nothing allocates there until join_instance brings it back
        self._fresh_pool(instance, drained=True)
        return lost

    def restore_ranges(self, rid: int, split: dict[int, int],
                       ranges) -> tuple["np.ndarray", "np.ndarray"]:
        """Failure recovery: re-home the lost absolute-position ``ranges``
        onto the alive shards per the replacement WaterFill ``split``
        (instance -> tokens), appending to each shard's EXISTING fill —
        surviving KV is never touched or re-read.

        Returns ``(positions, coords)`` in matching token order: positions
        int64 [T] (the absolute context positions to replay) and coords
        int32 [3, T] (instance, frame, offset) — the scatter target for the
        re-prefilled KV.  Positions are assigned to shards in sorted-instance
        order.  Raises ``MemoryError`` if a shard cannot allocate (callers
        plan against ``free_frames``/``shard_tail_slack``)."""
        total = sum(l for _, l in ranges)
        assert sum(split.values()) == total, (split, ranges)
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, np.zeros((3, 0), np.int32)
        positions = np.concatenate(
            [np.arange(st, st + ln) for st, ln in sorted(ranges)])
        self._frames_np.pop(rid, None)
        pages = self._pages.setdefault(rid, [])
        by_shard = self._frames_by_shard.setdefault(rid, {})
        fill = self._last_fill.setdefault(rid, {})
        rmap = self._ranges.setdefault(rid, {})
        page = self.page_size
        cols, k = [], 0
        for s in sorted(split):
            t = split[s]
            if t <= 0:
                continue
            used = fill.get(s, 0)
            fr = by_shard.setdefault(s, [])
            assert not (fr and used % page
                        and self.frame_shared(rid, s, fr[-1])), (
                rid, s, "recovery append into a SHARED tail — callers run "
                "exclusive_tails() before planning against tail slack")
            need = self.pages_needed(used + t) - len(fr)
            if need > 0:
                if self.pools[s].free_frames < need:
                    raise MemoryError(
                        f"recovery of request {rid}: instance {s} lacks "
                        f"{need} frames")
                new = self.pools[s].alloc(need)
                for f in new:
                    self._claim(rid, s, f)
                pages.extend((s, f) for f in new)
                fr.extend(new)
            j = np.arange(used, used + t)
            cols.append(np.stack([np.full(t, s),
                                  np.asarray(fr)[j // page], j % page]))
            rr = rmap.setdefault(s, [])
            for p in positions[k:k + t]:
                p = int(p)
                if rr and rr[-1][0] + rr[-1][1] == p:
                    rr[-1][1] += 1
                else:
                    rr.append([p, 1])
            fill[s] = used + t
            self._used[s] += t
            k += t
        coords = np.concatenate(cols, axis=1).astype(np.int32)
        return positions, coords

    def add_instance(self) -> int:
        """Elastic growth: append a brand-new instance with a full pool."""
        i = self.num_instances
        self.num_instances += 1
        self.pools.append(FramePool(i, self.frames_per_instance, self.stripes))
        self._used.append(0)
        return i

    def _fresh_pool(self, instance: int, drained: bool = False) -> None:
        """The ONE place a live instance's pool is replaced (join, restore,
        failure drop).  Guarded against frame aliasing: resetting the pool
        while any request still maps frames there — or while the refcount
        ledger holds STALE entries for the instance (e.g. a prefix-cache
        hold the trie forgot to release) — would hand those frames out
        twice.  ``drained``: leave the new pool empty (a dead instance must
        not serve allocations until it formally rejoins)."""
        held = [rid for rid, pages in self._pages.items()
                if any(s == instance for s, _ in pages)]
        stale = [f for (s, f) in self._owners if s == instance]
        if held or stale:
            raise RuntimeError(
                f"fresh pool for instance {instance}: frames still owned "
                f"(requests {held}, ledger entries {stale}) — resetting "
                f"would alias them")
        self._used[instance] = 0
        self.pools[instance] = FramePool(instance, self.frames_per_instance,
                                         self.stripes)
        if drained:
            self.pools[instance].drain()

    def join_instance(self, instance: int) -> None:
        """Elastic (re)join: give the instance a FRESH, fully-free pool.

        Failure (``drop_instance``) and drain both leave the instance
        frame-free, so a legitimate join never trips the aliasing guard."""
        self._fresh_pool(instance)

    def restore_instance(self, instance: int) -> None:
        """Deprecated spelling of the elastic-join path.  Kept so old call
        sites inherit the aliasing guard instead of the unconditional pool
        reset they were written against."""
        self.join_instance(instance)
