"""Global copy-on-write prefix cache: token-hash chains -> cached KV frames
(a copy of ``repro/core/prefix.py``, numpy only).

At production scale most KV is redundant — system prompts, few-shot
templates, and multi-turn history repeat across requests — so NanoCP makes
the shared prefix itself a placement object.  The cache is a TRIE over
page-granular content keys: page p's key is the blake2b chain
``h_p = H(h_{p-1} || tokens[p*page : (p+1)*page])``, so equal keys imply an
equal full transcript up to and including page p (collision probability is
negligible at 128 bits) and one flat ``{key: node}`` dict IS the trie — the
chain encodes the path.

Each node holds per-instance frame REPLICAS of that page's KV.  A replica
is pinned in the page table by a ``CACHE_OWNER`` refcount hold
(page_table.cache_hold), so it outlives the requests that prefilled it; a
new request with a matching chain ATTACHES to the replica frames
(GlobalPageTable.allocate's ``prefix=``) and prefills only its novel
suffix.  Eviction walks CACHE-ONLY replicas (frame refcount == 1 — no live
request still reads the frame) deepest-first then LRU: evicting a shallow
page would orphan every deeper page of its chain, so leaves go first.

The trie is pure host-side control-plane state.  Data movement (replicating
a hot chain onto another node) is emitted as (src, dst) coordinate tensors
for ``migrate.KVReshard`` — the same batched gather->scatter the re-shard
path uses.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np


def page_keys(tokens, page_size: int) -> tuple:
    """Chained content keys for a prompt's FULL pages (the partial tail
    page is never cacheable).  Token dtype is canonicalised to int64 so the
    same ids always hash the same."""
    out, prev = [], b""
    for p in range(len(tokens) // page_size):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(np.asarray(tokens[p * page_size:(p + 1) * page_size],
                            dtype=np.int64).tobytes())
        prev = h.digest()
        out.append(prev.hex())
    return tuple(out)


def group_keys(group: int, n_pages: int) -> tuple:
    """Synthetic key chain for workload generators: the chain a
    shared-prefix GROUP would produce, without materializing the tokens —
    requests carrying the same ``group`` share a cacheable prefix of
    ``n_pages`` pages, requests from different groups never collide."""
    out, prev = [], b""
    for p in range(n_pages):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(f"group:{group}:page:{p}".encode())
        prev = h.digest()
        out.append(prev.hex())
    return tuple(out)


@dataclass
class _Node:
    """One cached page: its chain key, depth (page index), and per-instance
    frame replicas ``{instance: [frame, last_use]}``.  ``children``: chain
    keys observed to extend this one (divergent suffixes fan out here) —
    links may dangle after an eviction; walkers must check membership."""
    key: str
    depth: int
    replicas: dict = field(default_factory=dict)
    hits: int = 0
    children: set = field(default_factory=set)


@dataclass
class PrefixTrie:
    """Cluster-wide prefix cache over chained page keys.

    Holds exactly ONE ``cache_hold`` per registered (instance, frame)
    replica — refcount conservation is the core invariant: every replica's
    hold is released exactly once (evict / release_all) or forgotten
    without release when its instance dies (``drop_instance``: the page
    table already purged the ledger)."""
    page_size: int
    nodes: dict = field(default_factory=dict)    # key -> _Node
    clock: int = 0                               # logical LRU clock
    evicted_frames: int = 0                      # monotone accounting

    def _tick(self) -> int:
        self.clock += 1
        return self.clock

    # ---------------- registration / lookup ----------------
    def insert(self, pt, rid: int, keys, limit: int) -> int:
        """Register ``rid``'s cacheable prompt pages after its prefill:
        every page-aligned single-frame prompt page (``pt.aligned_pages``)
        whose index is covered by the key chain becomes a replica, pinned
        with a cache hold.  At most one replica per (node, instance);
        re-inserting an existing replica just refreshes its LRU stamp.
        Returns the number of NEW holds taken."""
        now = self._tick()
        added = 0
        for pidx, inst, frame in pt.aligned_pages(rid, limit):
            if pidx >= len(keys):
                continue
            node = self.nodes.get(keys[pidx])
            if node is None:
                node = self.nodes[keys[pidx]] = _Node(keys[pidx], pidx)
            assert node.depth == pidx, (node.depth, pidx)
            if pidx > 0:
                parent = self.nodes.get(keys[pidx - 1])
                if parent is not None:
                    parent.children.add(keys[pidx])
            if inst in node.replicas:
                node.replicas[inst][1] = now
                continue
            pt.cache_hold(inst, frame)
            node.replicas[inst] = [frame, now]
            added += 1
        return added

    def lookup(self, keys, allowed=None) -> list:
        """Longest usable cached prefix: ``[(page_index, {instance:
        frame})]`` for pages 0..d-1, stopping at the first page with no
        replica on an ``allowed`` instance (a hole breaks the chain —
        attached prefix ranges must tile [0, P)).  Pure query: LRU stamps
        move only when the caller commits to the hit (``touch``)."""
        out = []
        for p, k in enumerate(keys):
            node = self.nodes.get(k)
            if node is None:
                break
            reps = {i: fr for i, (fr, _) in node.replicas.items()
                    if allowed is None or i in allowed}
            if not reps:
                break
            out.append((p, reps))
        return out

    def touch(self, keys, chosen) -> None:
        """Commit a hit: refresh LRU and hotness on the replicas actually
        attached.  ``chosen``: [(page_index, instance)]."""
        now = self._tick()
        for p, inst in chosen:
            node = self.nodes[keys[p]]
            node.replicas[inst][1] = now
            node.hits += 1

    # ---------------- eviction / teardown ----------------
    def evict(self, pt, frames_needed: int, instance=None, keep=()) -> int:
        """Free up to ``frames_needed`` cached frames, deepest-first then
        LRU.  Only CACHE-ONLY replicas qualify (frame refcount == 1: the
        hold is the last owner, so releasing it really frees the frame —
        a replica some live request still maps would free nothing and
        would orphan that request's hit).  ``instance`` restricts
        candidates to one pool (spill relief); ``keep`` protects the chain
        a concurrent admission just matched.  Returns frames freed."""
        keep = set(keep)
        cands = []
        for key, node in self.nodes.items():
            if key in keep:
                continue
            for inst, (frame, last) in node.replicas.items():
                if instance is not None and inst != instance:
                    continue
                if pt.frame_refcount(inst, frame) == 1:
                    cands.append((-node.depth, last, key, inst, frame))
        cands.sort()
        freed = 0
        for _, _, key, inst, frame in cands:
            if freed >= frames_needed:
                break
            node = self.nodes[key]
            del node.replicas[inst]
            if not node.replicas:
                del self.nodes[key]
            assert pt.cache_release(inst, frame), (inst, frame)
            freed += 1
            self.evicted_frames += 1
        return freed

    def chain_of(self, root_key: str) -> list:
        """The hottest cached chain starting at ``root_key``: follow the
        child with the most hits at every fan-out until the chain leaves
        the cache.  Used by hot-prefix replication to decide WHAT to copy."""
        keys, k = [], root_key
        while k is not None:
            node = self.nodes.get(k)
            if node is None:
                break
            keys.append(k)
            kids = [self.nodes[c] for c in node.children if c in self.nodes]
            k = max(kids, key=lambda n: (n.hits, n.key)).key if kids else None
        return keys

    def release_instance(self, pt, instance: int) -> int:
        """Graceful drain: drop every hold on ``instance`` BEFORE its KV is
        evacuated — cache-only frames free immediately; frames shared with
        live requests free when the drain copies them off and the owners
        release.  (Contrast ``drop_instance``: there the frames are already
        gone and releasing would double-free.)  Returns frames freed now."""
        n = 0
        for key in list(self.nodes):
            node = self.nodes[key]
            rep = node.replicas.pop(instance, None)
            if rep is not None and pt.cache_release(instance, rep[0]):
                n += 1
            if not node.replicas:
                del self.nodes[key]
        return n

    def drop_instance(self, instance: int) -> int:
        """The instance died: its replica frames vanished with the hardware
        and the page table already purged the refcount ledger — forget them
        WITHOUT releasing (a release would double-free into the fresh
        pool).  Returns replicas forgotten."""
        gone = 0
        for key in list(self.nodes):
            node = self.nodes[key]
            if node.replicas.pop(instance, None) is not None:
                gone += 1
            if not node.replicas:
                del self.nodes[key]
        return gone

    def release_all(self, pt) -> int:
        """Drop every hold (cache-off flip / teardown).  Returns frames
        actually freed (shared ones stay with their live requests)."""
        n = 0
        for node in self.nodes.values():
            for inst, (frame, _) in node.replicas.items():
                if pt.cache_release(inst, frame):
                    n += 1
        self.nodes.clear()
        return n

    # ---------------- replication ----------------
    def replicate(self, pt, keys, depth: int, dst: int
                  ) -> tuple["np.ndarray", "np.ndarray"]:
        """Copy the chain's first ``depth`` pages onto instance ``dst`` (a
        hot prefix earns a local replica so future hits stop crossing the
        node boundary).  Allocates cache-held frames on ``dst`` and returns
        ``(src, dst)`` int32 [3, T] coords for the data-plane copy
        (``migrate.KVReshard`` contract); pages already replicated on
        ``dst`` are skipped.  Raises ``MemoryError`` when ``dst`` lacks
        frames — callers plan against ``free_frames``."""
        page = self.page_size
        todo = []
        for p in range(depth):
            node = self.nodes.get(keys[p])
            assert node is not None and node.replicas, (
                p, "replicate of an uncached page")
            if dst not in node.replicas:
                src_i = min(node.replicas)
                todo.append((keys[p], src_i, node.replicas[src_i][0]))
        if not todo:
            z = np.zeros((3, 0), np.int32)
            return z, z
        if pt.pools[dst].free_frames < len(todo):
            raise MemoryError(
                f"replicate: instance {dst} lacks {len(todo)} frames")
        now = self._tick()
        s_cols, d_cols = [], []
        for key, si, sf in todo:
            df = pt.pools[dst].alloc(1)[0]
            pt.cache_hold(dst, df)
            self.nodes[key].replicas[dst] = [df, now]
            off = np.arange(page)
            s_cols.append(np.stack([np.full(page, si), np.full(page, sf),
                                    off]))
            d_cols.append(np.stack([np.full(page, dst), np.full(page, df),
                                    off]))
        return (np.concatenate(s_cols, axis=1).astype(np.int32),
                np.concatenate(d_cols, axis=1).astype(np.int32))

    # ---------------- queries ----------------
    def cached_frames(self, instance=None) -> int:
        """Replica frames currently held (optionally on one instance)."""
        return sum(1 for node in self.nodes.values()
                   for i in node.replicas
                   if instance is None or i == instance)

    def stats(self) -> dict:
        return {"nodes": len(self.nodes),
                "replicas": self.cached_frames(),
                "evicted_frames": self.evicted_frames}
