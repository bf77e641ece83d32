"""Routing-table derivation (§4.2.4, Fig. 9): plan -> static device tensors.

The control plane lowers each iteration's placement into compact int32
tensors that fully drive the data plane — Q-Route (which slots each MoE
binding sends in each ring rotation round), work lists (which rows each
instance computes attention for, over which local frames), Res-Route (which
partial rows return in each reverse round) and merge tables (how each MoE
binding reassembles its slots' partials).  All shapes are AOT-bucketed
(M_hat slots, S_hat send rows/round, N_hat work rows, MB page blocks, W
window = ``ClusterState.window``, the cluster-wide rotation ring), so one
pre-compiled executable per bucket can replay any placement
(CUDA-Graph-analogue; DESIGN.md §2).  A round whose sender and receiver sit
on different nodes simply traverses the inter-node link class — bindings
may span nodes (W < I topologies); ``RoutingTables.R`` records the highest
round actually used so the AOT engine compiles only that many rotations.

Send-buffer coordination: in round delta, instance j receives ONLY from
instance (j - delta) in the cluster ring, so sender list position p maps
deterministically to receiver buffer slot p — no handshake needed (the
paper's "a-priori-known topology" observation, §5.3).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

from .bucketing import ShapeBuckets
from .comm import ring_round
from .page_table import KVSpillError
from .state import ClusterState, IterationPlan


@dataclass
class RoutingTables:
    """Global [I, ...] int32 tensors, shard over the `data` mesh axis."""
    # static bucket dims
    W: int          # intra-node window (ring rotation rounds = W-1)
    M: int          # slots per instance (M_hat)
    S: int          # cross-send rows per round (S_hat)
    N: int          # attention work rows (N_hat)
    MB: int         # page blocks per work row
    MBT: int        # page blocks per work row PER KV STRIPE (hybrid sharding)
    R: int          # effective rotation rounds used (max CP offset this step)
    # per-slot (requests whose MoE binding is this instance)
    slot_rid: np.ndarray        # [I, M] (-1 pad)
    slot_token: np.ndarray      # [I, M] next input token id
    slot_pos: np.ndarray        # [I, M] absolute position of the new token
    slot_active: np.ndarray     # [I, M] 0/1
    append_frame: np.ndarray    # [I, M] local frame for the new token's KV
    append_off: np.ndarray      # [I, M] offset within that frame
    # Q-Route: local slot index sent in rotation round d (1..W-1)
    q_send_idx: np.ndarray      # [I, W-1, S] (-1 pad)
    # receiver-side mirror: sender's slot id per (round, position) — used by
    # the dense (all-gather) baseline backend only
    q_recv_slot: np.ndarray     # [I, W-1, S] (-1 pad)
    # work rows (partial attention on the local KV shard)
    work_src: np.ndarray        # [I, N] idx into concat(slots[M], recv[(W-1)*S])
    work_bt: np.ndarray         # [I, N, MB] local frame ids
    work_len: np.ndarray        # [I, N] kv tokens for the row (0 = inactive)
    # Res-Route: work-row index returned in reverse round d
    ret_send_idx: np.ndarray    # [I, W-1, S] (-1 pad)
    # merge: per slot, sources into concat(work rows[N], ret recv[(W-1)*S])
    merge_src: np.ndarray       # [I, M, W] (-1 = unused)
    # dense-backend merge mirror: owner round + owner work-row per source
    merge_round: np.ndarray     # [I, M, W] rotation round of source (0=local)
    merge_peer_row: np.ndarray  # [I, M, W] work-row index on the owner (-1 pad)

    def stats(self) -> dict:
        act = self.slot_active.sum(axis=1)
        cross = (self.q_send_idx >= 0).sum(axis=(1, 2))
        rows = (self.work_len > 0).sum(axis=1)
        return {
            "batch_per_instance": act,
            "cross_sends_per_instance": cross,
            "work_rows_per_instance": rows,
            "bucket": (self.M, self.S, self.N, self.MB, self.W),
        }


class TableArena:
    """Per-bucket reusable host buffers for ``RoutingTables``.

    The decode hot path lowers a table every iteration; allocating ~15 numpy
    arrays per step churns the allocator and defeats pinned-host reuse.  The
    arena keeps PING-PONG pairs of table sets per bucket key (depth 2 covers
    the engine's one-step-lookahead pipeline: the tables of the in-flight
    iteration are never rewritten while a transfer might still read them).
    """

    DEPTH = 2

    def __init__(self):
        self._cache: dict = {}
        self._turn: dict = {}

    def tables(self, I: int, M: int, S: int, N: int, MB: int,
               W: int) -> RoutingTables:
        key = (I, M, S, N, MB, W)
        pair = self._cache.get(key)
        if pair is None:
            pair = [self._fresh(I, M, S, N, MB, W)
                    for _ in range(self.DEPTH)]
            self._cache[key] = pair
            self._turn[key] = 0
        t = self._turn[key]
        self._turn[key] = (t + 1) % self.DEPTH
        tbl = pair[t]
        self._reset(tbl)
        return tbl

    @staticmethod
    def _fresh(I, M, S, N, MB, W) -> RoutingTables:
        return RoutingTables(
            W=W, M=M, S=S, N=N, MB=MB, MBT=MB, R=0,
            slot_rid=np.empty((I, M), np.int32),
            slot_token=np.empty((I, M), np.int32),
            slot_pos=np.empty((I, M), np.int32),
            slot_active=np.empty((I, M), np.int32),
            append_frame=np.empty((I, M), np.int32),
            append_off=np.empty((I, M), np.int32),
            q_send_idx=np.empty((I, W - 1, S), np.int32),
            q_recv_slot=np.empty((I, W - 1, S), np.int32),
            work_src=np.empty((I, N), np.int32),
            work_bt=np.empty((I, N, MB), np.int32),
            work_len=np.empty((I, N), np.int32),
            ret_send_idx=np.empty((I, W - 1, S), np.int32),
            merge_src=np.empty((I, M, W), np.int32),
            merge_round=np.empty((I, M, W), np.int32),
            merge_peer_row=np.empty((I, M, W), np.int32),
        )

    @staticmethod
    def _reset(tbl: RoutingTables) -> None:
        for name in ("slot_rid", "q_send_idx", "q_recv_slot", "work_src",
                     "ret_send_idx", "merge_src", "merge_peer_row"):
            getattr(tbl, name).fill(-1)
        for name in ("slot_token", "slot_pos", "slot_active", "append_frame",
                     "append_off", "work_bt", "work_len", "merge_round"):
            getattr(tbl, name).fill(0)


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Number of PRIOR occurrences of keys[i] within keys[:i] (stable)."""
    n = keys.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    new_grp = np.empty(n, bool)
    new_grp[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new_grp[1:])
    starts = np.nonzero(new_grp)[0]
    grp = np.cumsum(new_grp) - 1
    cc = np.arange(n) - starts[grp]
    out = np.empty(n, np.int64)
    out[order] = cc
    return out


def lower_plan(cluster: ClusterState, plan: IterationPlan,
               buckets: ShapeBuckets | None = None,
               append_tokens: bool = True,
               next_tokens: dict | None = None,
               arena: TableArena | None = None) -> RoutingTables:
    """Lower one iteration plan to routing tensors (vectorized).

    ``append_tokens``: allocate+record this step's new KV token on each MoE
    binding's shard (mutates the page table — one call per decode step).
    ``next_tokens``: rid -> input token id (defaults to 0; the engine feeds
    sampled ids).
    ``arena``: optional ``TableArena`` for buffer reuse on the decode hot
    path (None allocates fresh arrays — safe for callers that hold tables).

    All per-request/per-shard loops are numpy bulk ops over flat pair arrays;
    the only python-level iteration is the O(requests) collection pass over
    the host dicts (page table, slot map).
    """
    buckets = buckets or ShapeBuckets(window=cluster.window)
    I = cluster.num_instances
    # rotation window: the whole cluster is ONE ring (round d of sender m
    # reaches (m + d) % I), so a KV binding may span nodes — the node width
    # only decides which LINK CLASS a round traverses (latency model)
    W = cluster.window
    page = cluster.page_table.page_size
    pt = cluster.page_table
    act = cluster.active
    rids = sorted(act)

    # --- append pre-flight: surface KV exhaustion BEFORE any mutation ------
    # ``append_token`` below mutates the page table per request; raising
    # mid-loop would leave earlier appends applied.  Check every MoE-binding
    # shard's frame budget first so a spill raises a typed ``KVSpillError``
    # with the table untouched — the engine escalates the request (live KV
    # re-shard) or OOM-finishes it, then retries the lowering.
    if append_tokens:
        frames_wanted: dict[int, int] = {}
        for rid in rids:
            i = act[rid].moe_binding
            if pt.append_needs_frame(rid, i):
                want = frames_wanted.get(i, 0) + 1
                if want > pt.free_frames(i):
                    raise KVSpillError(rid, i)
                frames_wanted[i] = want

    # --- single collection pass over the active set ------------------------
    # per-slot rows (one per request) and flat per-(request, shard) pair
    # rows; python only walks the host dicts — every table write below is a
    # numpy bulk op.  Appends interleave (a request's append only affects
    # its own shard lengths, read right after).
    nr = len(rids)
    r_m = np.empty(nr, np.int64)              # MoE binding / slot instance
    r_b = np.empty(nr, np.int64)              # slot index
    r_pos = np.empty(nr, np.int64)            # decode position
    r_tok = np.empty(nr, np.int64)            # next input token
    ap_f = np.zeros(nr, np.int64)             # append frame / offset
    ap_o = np.zeros(nr, np.int64)
    p_m, p_b, p_s, p_d, p_t = [], [], [], [], []
    frames_of = []                            # cached np frame views per pair
    slot_map = cluster.slot_map
    tok_get = next_tokens.get if next_tokens is not None else None

    for idx, rid in enumerate(rids):
        req = act[rid]
        i, b = slot_map[rid]
        assert i == req.moe_binding, (rid, i, req.moe_binding)
        r_m[idx], r_b[idx] = i, b
        r_pos[idx] = (req.dec_prefix_len + req.generated
                      if req.dec_prefix_len >= 0 else req.length)
        r_tok[idx] = tok_get(rid, 0) if tok_get is not None else 0
        if append_tokens:
            ap_f[idx], ap_o[idx] = pt.append_token(rid, i)
        shards = pt.shard_tokens(rid)
        # zig-zag ring round per shard (comm.ring_round is bijective over
        # the window, so distinct shards get distinct rounds and the
        # (round, shard) sort equals the round-stable sort); node-local
        # shards always land in rounds <= 2*(node_width-1)
        for d, s in sorted((ring_round(s - i, W), s) for s in req.kv_binding):
            p_m.append(i)
            p_b.append(b)
            p_s.append(s)
            p_d.append(d)
            p_t.append(shards.get(s, 0))
            frames_of.append(pt.shard_frames_np(rid, s))

    p_m = np.asarray(p_m, np.int64)
    p_b = np.asarray(p_b, np.int64)
    p_s = np.asarray(p_s, np.int64)
    p_d = np.asarray(p_d, np.int64)
    p_tok = np.asarray(p_t, np.int64)
    # a binding must stay within its rotation-window SEGMENT: the ring
    # rotations (`node_rotation_pairs(node=W)`) never cross segments, so an
    # out-of-window shard would silently read another sender's rows
    assert (p_s // W == p_m // W).all(), "KV binding leaves its rotation window"

    # --- observed shape -> bucket -----------------------------------------
    max_batch = cluster.max_slots()
    # per-(sender, round) send counts decide S
    send_max = 0
    R = 0
    if p_d.size:
        remote = p_d > 0
        if remote.any():
            send_max = int(np.bincount(
                (p_m * W + p_d)[remote]).max())
            R = int(p_d.max())
    M, S, N = buckets.bucket(max(max_batch, 1), send_max)
    assert nr == 0 or (r_b < M).all(), f"slot exceeds bucket M={M}"

    # page blocks per work row (post-append shard lengths), quantised to a
    # power of two so the AOT executable family stays bounded
    max_shard = int(p_tok.max(initial=1))
    MB = _quantize_dim(-(-max(max_shard, 1) // page))
    # per-stripe block-table width: exact max per-(row, stripe) page count
    ps = cluster.kv_stripes
    if ps > 1 and frames_of:
        nfr = np.array([f.shape[0] for f in frames_of], np.int64)
        if nfr.sum():
            allf = np.concatenate([f for f in frames_of if f.shape[0]])
            pair_id = np.repeat(np.arange(len(frames_of)), nfr)
            mbt = int(np.bincount(pair_id * ps + allf % ps).max())
        else:
            mbt = 1
        MBT = min(_quantize_dim(max(mbt, 1)), MB)
    else:
        MBT = MB

    tbl = (arena.tables(I, M, S, N, MB, W) if arena is not None
           else TableArena._fresh(I, M, S, N, MB, W))
    if arena is None:
        TableArena._reset(tbl)
    tbl.MBT, tbl.R = MBT, R

    # --- per-slot tensors (bulk writes) ------------------------------------
    if rids:
        tbl.slot_rid[r_m, r_b] = np.asarray(rids)
        tbl.slot_active[r_m, r_b] = 1
        tbl.slot_token[r_m, r_b] = r_tok
        tbl.slot_pos[r_m, r_b] = r_pos
        if append_tokens:
            tbl.append_frame[r_m, r_b] = ap_f
            tbl.append_off[r_m, r_b] = ap_o

    # --- work rows, Q-route, Res-route, merge ------------------------------
    # active pairs: zero-token shards participate only when they are the MoE
    # binding's local shard (the slot's own work row)
    keep = (p_tok > 0) | (p_d == 0)
    if keep.all():
        k_m, k_b, k_s, k_d, k_tok = p_m, p_b, p_s, p_d, p_tok
        k_frames = frames_of
    else:
        k_m, k_b, k_s, k_d = p_m[keep], p_b[keep], p_s[keep], p_d[keep]
        k_tok = p_tok[keep]
        k_frames = [f for f, kp in zip(frames_of, keep) if kp]
    P_ = k_s.shape[0]
    if P_ == 0:
        return tbl

    # running counters -> vectorized cumulative counts (iteration order is
    # rid-ascending, shards by round — exactly the collection order)
    row = _cumcount(k_s)                               # work row per instance
    assert int(row.max(initial=-1)) < N, \
        f"work rows exceed bucket N={N}"
    mw = _cumcount(k_m * M + k_b)                      # merge write position
    loc = k_d == 0
    rem = ~loc
    any_rem = bool(rem.any())
    # for fixed (sender, round) the receiver is determined (ring topology),
    # so the (m, d) send counter and the (s, d) return counter agree
    p_pos = np.zeros(P_, np.int64)
    if any_rem:
        p_pos[rem] = _cumcount((k_s * W + k_d)[rem])
        assert int(p_pos.max(initial=0)) < max(S, 1), \
            f"send rows exceed bucket S={S}"

    tbl.work_len[k_s, row] = k_tok

    # block tables: one flat scatter over (pair, page) coordinates
    nb_arr = -(-k_tok // page)
    assert int(nb_arr.max(initial=0)) <= MB
    total = int(nb_arr.sum())
    if total:
        views = [f[:n] for f, n in zip(k_frames, nb_arr) if n]
        allf = np.concatenate(views)
        starts = np.cumsum(nb_arr) - nb_arr          # exclusive prefix sum
        col = np.arange(total) - np.repeat(starts, nb_arr)
        tbl.work_bt[np.repeat(k_s, nb_arr), np.repeat(row, nb_arr),
                    col] = allf

    # local rows: slot's own shard on the MoE binding
    tbl.work_src[k_s[loc], row[loc]] = k_b[loc]
    tbl.merge_src[k_m[loc], k_b[loc], mw[loc]] = row[loc]
    tbl.merge_round[k_m[loc], k_b[loc], mw[loc]] = 0
    tbl.merge_peer_row[k_m[loc], k_b[loc], mw[loc]] = row[loc]

    # remote rows: sender m emits slot b in rotation round d at position p;
    # owner s computes the row and returns it in reverse round d
    if any_rem:
        rm, rb_, rs, rd = k_m[rem], k_b[rem], k_s[rem], k_d[rem]
        rr, rp, rmw = row[rem], p_pos[rem], mw[rem]
        tbl.q_send_idx[rm, rd - 1, rp] = rb_
        tbl.q_recv_slot[rs, rd - 1, rp] = rb_
        tbl.work_src[rs, rr] = M + (rd - 1) * S + rp
        tbl.ret_send_idx[rs, rd - 1, rp] = rr
        tbl.merge_src[rm, rb_, rmw] = N + (rd - 1) * S + rp
        tbl.merge_round[rm, rb_, rmw] = rd
        tbl.merge_peer_row[rm, rb_, rmw] = rr
    return tbl


def _quantize_dim(x: int, lo: int = 4) -> int:
    """Quantise a bucket dim: powers of two up to 8, then 12.5%% steps —
    bounds the AOT family while capping padded-page waste at ~12.5%%."""
    v = lo
    while v < x and v < 8:
        v *= 2
    while v < x:
        v += max(v // 8, 1)
    return v


def _round_of(cluster: ClusterState, m: int, s: int) -> int:
    """Cluster-ring rotation round that moves data from m to s (0 if s==m)."""
    return ring_round(s - m, cluster.window)


class DeviceTables:
    """Preallocated device tensors (and pinned host staging on CUDA) for the
    routing tables, one set per set of table shapes.

    A set is ONE flat int32 device buffer (and one pinned host buffer),
    viewed as each table, so a CUDA upload writes the ``TableArena`` host
    arrays into the pinned views and copies the whole set with one
    ``non_blocking`` copy.  The device views keep their storage for the
    engine's lifetime: a bucket's CUDA graph reads them where it captured
    them (``core/aot.py``), so buckets that differ only in R share one set,
    safely, as their replays never overlap.  Reusing one staging set per
    shape is safe because the engine harvests iteration t-1 (whose copy
    precedes its tokens on the stream) before it uploads iteration t.
    """

    def __init__(self, device):
        import torch
        self.device = torch.device(device)
        self._bufs: dict = {}

    def _set(self, shapes: dict):
        """(device buffer, pinned host buffer or None, {name: (device
        view, host numpy view or None)}) for ``shapes`` {name: shape}."""
        import torch
        key = tuple(sorted((n, tuple(int(d) for d in s))
                           for n, s in shapes.items()))
        bufs = self._bufs.get(key)
        if bufs is None:
            sizes = [int(np.prod(s)) for _, s in key]
            dev = torch.empty(sum(sizes), dtype=torch.int32,
                              device=self.device)
            host = (torch.empty(sum(sizes), dtype=torch.int32,
                                pin_memory=True)
                    if self.device.type == "cuda" else None)
            views, off = {}, 0
            for (name, shape), n in zip(key, sizes):
                views[name] = (dev[off:off + n].view(shape),
                               None if host is None else
                               host[off:off + n].numpy().reshape(shape))
                off += n
            bufs = self._bufs[key] = (dev, host, views)
        return bufs

    def buffers(self, shapes: dict) -> dict:
        """The device tensors for tables of ``shapes`` {name: shape}."""
        return {n: d for n, (d, _) in self._set(shapes)[2].items()}

    def upload(self, tbl: RoutingTables) -> dict:
        import torch
        arrays = {f.name: getattr(tbl, f.name) for f in fields(tbl)
                  if isinstance(getattr(tbl, f.name), np.ndarray)}
        dev, host, views = self._set({n: v.shape for n, v in arrays.items()})
        for name, (d, h) in views.items():
            if h is None:
                d.copy_(torch.from_numpy(np.ascontiguousarray(arrays[name],
                                                              np.int32)))
            else:
                h[...] = arrays[name]
        if host is not None:
            dev.copy_(host, non_blocking=True)
        return {n: d for n, (d, _) in views.items()}


def as_device_arrays(tbl: RoutingTables, device_tables: DeviceTables) -> dict:
    """numpy tables -> dict of int32 device tensors ``[I, ...]``.

    The tensors are ``device_tables``'s preallocated buffers for this table
    shape (no per-step allocation); see ``DeviceTables`` for the CUDA path.
    """
    return device_tables.upload(tbl)
