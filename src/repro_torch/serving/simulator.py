"""Discrete-event cluster simulator for decode serving (§6 reproduction); a
copy of ``repro/serving/simulator.py`` over the port's control plane.

The CONTROL PLANE is the real NanoCP code (scheduler, page table, WaterFill,
bucketing); only the data plane's per-iteration latency is analytic
(``latency_model``, roofline-calibrated).  This is how the paper's
end-to-end figures (12-18) are reproduced without 32xH200.

Lock-step DP-EP semantics: within each decode layer every instance must
finish its attention path before the dispatch all-to-all completes, and the
combine blocks on the slowest expert rank — so each phase contributes its
per-instance MAX (the straggler effect of Fig. 4).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from heapq import heappop, heappush

import numpy as np

from ..configs.base import ModelConfig
from ..core.bucketing import ShapeBuckets
from ..core.comm import ring_round
from ..core.handoff import HandoffTask, plan_chunks
from ..core.page_table import KVSpillError
from ..core.prefix import PrefixTrie
from ..core.scheduler import BaseScheduler, UniformCPScheduler
from ..core.state import ClusterState, Request
from .latency_model import LatencyModel
from .workload import Workload


@dataclass
class PhaseBreakdown:
    """Per-iteration, per-layer phase maxima (seconds)."""
    attention: float = 0.0
    cp_comm: float = 0.0
    dispatch_combine: float = 0.0
    ffn: float = 0.0
    other: float = 0.0

    @property
    def layer_total(self) -> float:
        return (self.attention + self.cp_comm + self.dispatch_combine
                + self.ffn + self.other)


@dataclass
class SimResult:
    finished: list = field(default_factory=list)
    iterations: int = 0
    sim_time: float = 0.0
    # closed-loop SLO accounting: every submitted request ends in exactly
    # one typed outcome (finished/oom/degraded/rejected/shed) — `submitted`
    # is the honest attainment denominator, so dropping load can only ever
    # LOWER the measured curve
    submitted: int = 0                                     # trace size offered
    rejected: int = 0                                      # queue-overflow bounces
    shed: int = 0                                          # TTFT deadline expiries
    preemptions: int = 0                                   # forced relax-to-admit passes
    # time series for the balance / HoL analyses
    batch_series: list = field(default_factory=list)       # [iters, I]
    kv_series: list = field(default_factory=list)          # [iters, I]
    attn_lat_series: list = field(default_factory=list)    # [iters, I] per-layer
    a2a_lat_series: list = field(default_factory=list)     # [iters, I]
    free_mem_series: list = field(default_factory=list)    # [iters] frames free
    hol_demand_series: list = field(default_factory=list)  # [iters] frames wanted
    phase: list = field(default_factory=list)              # [iters] PhaseBreakdown
    cp_degree_hist: dict = field(default_factory=dict)     # degree -> req-iters
    sched_wall: float = 0.0                                # real control-plane s
    # mid-decode CP escalation accounting (the re-shard is charged into sim
    # time so escalating policies pay for the KV they move)
    escalations: int = 0                                   # promotion events
    escalated_tokens: int = 0                              # KV tokens moved
    escalated_pages: int = 0                               # dest frames written
    reshard_time: float = 0.0                              # total seconds charged
    oom_finishes: int = 0                                  # spills nobody could absorb
    # DCP relaxation accounting (the inverse pass: de-escalation + KV
    # consolidation once pressure subsides — its re-shard is charged into
    # sim time exactly like escalation's, so relaxing policies pay for the
    # KV they move home)
    relaxations: int = 0                                   # demotion/consolidation events
    relaxed_tokens: int = 0                                # KV tokens moved back
    relax_time: float = 0.0                                # re-shard s charged to relax
    reclaimed_cross_bindings: int = 0                      # bindings back to one node
    # cross-node (inter link class) accounting: why node boundaries are a
    # COST — zero for workloads whose bindings stay node-local
    cross_node_bytes: int = 0                              # bytes over inter links
    cross_reshard_time: float = 0.0                        # re-shard s on inter links
    cross_cp_time: float = 0.0                             # Q/Res routing s, inter
    cross_moe_time: float = 0.0                            # a2a s on inter links
    cross_escalated_tokens: int = 0                        # KV tokens across nodes
    cross_bindings: int = 0                                # request-iters spanning >=2 nodes
    # fault-tolerance / elasticity accounting (mirrors the engine's
    # hot_path_stats counters so chaos sweeps price recovery cost)
    failures: int = 0                                      # instances killed
    recovered_tokens: int = 0                              # KV tokens that survived a kill
    reprefill_tokens: int = 0                              # lost tokens replayed
    degraded_finishes: int = 0                             # requests finished early
    joins: int = 0                                         # instances (re)joined
    reprefill_time: float = 0.0                            # recovery s charged
    # global prefix-cache accounting (mirrors the engine's hot_path_stats):
    # hit tokens are prompt positions ATTACHED to cached frames instead of
    # prefilled, CoW splits are shared tails cloned before a write, and
    # every cache-driven copy is charged into sim time like a re-shard
    prompt_tokens: int = 0                                 # admitted prompt tokens
    prefix_hit_tokens: int = 0                             # tokens served from cache
    prefix_inserts: int = 0                                # new cache holds taken
    cow_splits: int = 0                                    # shared tails cloned
    cow_tokens: int = 0                                    # KV tokens those clones copied
    cow_time: float = 0.0                                  # clone copy s charged
    copy_tokens: int = 0                                   # replication/pad KV tokens copied
    evicted_prefix_frames: int = 0                         # cache frames evicted this run
    prefill_time: float = 0.0                              # novel-suffix prefill s charged
    # disaggregated prefill/decode accounting: prefill is charged CHUNKED
    # (never one monolithic lump) — colocated chunks drain one per outer
    # iteration on the global clock (bounded HoL), disaggregated chunks
    # advance per-prefill-cell clocks with every streamed handoff priced
    # by the link class it crosses
    staged: int = 0                                        # requests staged to prefill cells
    prefill_chunks: int = 0                                # chunk forwards charged
    handoff_tokens: int = 0                                # KV tokens streamed to decode
    handoff_time: float = 0.0                              # handoff transfer s charged


class _DegreeOne:
    """CP-bucket stand-in for schedulers without DCP buckets."""
    @staticmethod
    def cp_degree(length: int) -> int:
        return 1


_DEGREE_ONE = _DegreeOne()


class ClusterSimulator:
    def __init__(self, cfg: ModelConfig, scheduler: BaseScheduler,
                 num_instances: int = 32, instances_per_node: int = 8,
                 kv_capacity_tokens: int = 1_000_000, page_size: int = 64,
                 latency: LatencyModel | None = None, multi_step: int = 1,
                 sched_overhead: float = 150e-6, prefix_cache: bool = False,
                 charge_prefill: bool = False, prefill_cells: int = 0,
                 chunk_tokens: int | None = None):
        self.cfg = cfg
        self.scheduler = scheduler
        self.latency = latency or LatencyModel(cfg)
        self.multi_step = multi_step
        self.sched_overhead = sched_overhead
        if prefix_cache:
            assert cfg.has_attention and not cfg.is_encoder_decoder, \
                "prefix_cache needs a decoder-only attention arch"
        self.prefix_trie = PrefixTrie(page_size) if prefix_cache else None
        scheduler.prefix_cache = self.prefix_trie
        # charge the (novel-suffix) prefill forward into sim time — off by
        # default so existing decode-only sweeps keep their numbers; the
        # prefix-cache benchmark turns it on to measure the TTFT a hit
        # saves.  The charge is CHUNKED (core/handoff.plan_chunks), never a
        # monolithic lump: one chunk per outer iteration drains round-robin
        # across held requests, so a short prompt admitted behind a long
        # one starts decoding between the long's chunks (pinned by
        # tests/test_torch_simulator.py).
        self.charge_prefill = charge_prefill
        # disaggregated cells: dedicate the TAIL `prefill_cells` instances
        # to chunked prefill; prompts stream into the decode cluster
        # chunk-by-chunk (core/handoff.py) with the handoff priced by link
        # class.  Implies prefill charging — a disaggregated sweep that
        # didn't price prefill would show a free lunch.
        self.prefill_cells = prefill_cells
        self.chunk_tokens = chunk_tokens or 64 * page_size
        if prefill_cells:
            self.charge_prefill = True
        self._registered = set()                 # rids whose prompt is cached
        self._hold = {}           # colocated: rid -> pending chunk sizes
        self._prefill_fifo = deque()             # colocated chunk round-robin
        self._tasks = {}          # disagg: rid -> HandoffTask
        self._cell_queue = {}     # disagg: prefill instance -> deque of rids
        self._cell_clock = {}     # disagg: prefill instance -> busy-until s
        self._ready = []          # disagg: heap of (ready_time, rid)
        self.cluster = ClusterState(num_instances=num_instances,
                                    instances_per_node=instances_per_node,
                                    kv_capacity_tokens=kv_capacity_tokens,
                                    page_size=page_size,
                                    prefill_cells=prefill_cells)
        self.buckets = ShapeBuckets(
            m_buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
            s_buckets=(0, 1, 2, 4, 8, 16, 32, 64),
            window=instances_per_node)
        self._uniform_cp = isinstance(scheduler, UniformCPScheduler)
        # CP degree buckets for measured-footprint handoff degree selection;
        # non-DCP policies carry none and stream at degree 1
        self._cp_buckets = getattr(scheduler, "buckets", None) or _DEGREE_ONE

    # ------------------------------------------------------------------ #
    def _iteration_time(self, plan, res: SimResult | None = None
                        ) -> tuple[float, PhaseBreakdown,
                                   np.ndarray, np.ndarray]:
        lm, cl = self.latency, self.cluster
        I = cl.num_instances
        W = cl.instances_per_node
        ring = cl.window
        batch = plan.batch_sizes().astype(float)
        rows = np.array([len(p.work) for p in plan.instances], float)
        kv = plan.kv_tokens().astype(float)

        # per-instance cross-CP traffic (rounds used x bucketed rows) SPLIT
        # BY LINK CLASS, counted in ONE pass over the work lists: a row
        # whose shard owner sits on another node rides the inter links.
        # Only rounds a step actually uses execute (zig-zag schedule,
        # RoutingTables.R), so the charge counts DISTINCT rounds used.
        sends = np.zeros(I)
        sends_x = np.zeros(I)                 # inter-node share of `sends`
        rounds_i, rounds_x = set(), set()
        for p_ in plan.instances:
            for (_rid, m, _toks) in p_.work:
                if m != p_.instance:
                    sends[m] += 1
                    r = ring_round(p_.instance - m, ring)
                    if cl.same_node(m, p_.instance):
                        rounds_i.add(r)
                    else:
                        sends_x[m] += 1
                        rounds_x.add(r)
        r_intra = max(len(rounds_i), 1)
        r_inter = max(len(rounds_x), 1)
        attn_t = np.zeros(I)
        cp_t = np.zeros(I)
        cp_x_t = np.zeros(I)
        for s in range(I):
            if self._uniform_cp:
                group = self.scheduler.cp
                cp_t[s] = 2 * lm.dense_cp_route_time(group, batch[s])
            elif sends[s] > 0:
                loc = sends[s] - sends_x[s]
                if loc > 0:
                    sh = self.buckets.round_s(
                        max(1, int(np.ceil(loc / r_intra))))
                    cp_t[s] = 2 * lm.cp_route_time(r_intra, sh)
                if sends_x[s] > 0:
                    sx = self.buckets.round_s(
                        max(1, int(np.ceil(sends_x[s] / r_inter))))
                    cp_x_t[s] = 2 * lm.cp_route_time(r_inter, sx, inter=True)
                    cp_t[s] += cp_x_t[s]
            attn_t[s] = lm.qkv_time(batch[s]) + lm.attention_time(kv[s], rows[s])

        # EP spans the cluster: (I - W)/I of each token's expert traffic
        # crosses node boundaries on a multi-node topology
        inter_frac = (I - W) / I if cl.num_nodes > 1 else 0.0
        a2a_t = np.array([lm.a2a_time(b, inter_frac) for b in batch])
        # balanced-expert assumption: each instance's experts see the global
        # token share (expert-level imbalance is orthogonal, §2.2)
        tokens_per_inst = batch.sum() * max(self.cfg.num_experts_per_tok, 1) / I
        ffn_t = lm.ffn_time(tokens_per_inst if self.cfg.is_moe else batch.max())

        ph = PhaseBreakdown(
            attention=float(attn_t.max(initial=0.0)),
            cp_comm=float(cp_t.max(initial=0.0)),
            dispatch_combine=float(2 * a2a_t.max(initial=0.0)),
            ffn=float(ffn_t),
            other=float(lm.hw.kernel_base * 4),
        )
        n_layers = self.cfg.num_layers
        t_iter = n_layers * ph.layer_total + self.sched_overhead / self.multi_step
        if res is not None:
            res.cross_cp_time += n_layers * float(cp_x_t.max(initial=0.0))
            res.cross_node_bytes += int(
                n_layers * 2 * sends_x.sum() * lm.q_row_bytes)
            if inter_frac > 0 and self.cfg.is_moe:
                a2a_x = max(lm.a2a_link_times(b, inter_frac)[1] for b in batch)
                res.cross_moe_time += n_layers * 2 * float(a2a_x)
                res.cross_node_bytes += int(
                    n_layers * 2 * batch.sum()
                    * self.cfg.num_experts_per_tok * self.cfg.d_model * 2
                    * inter_frac)
        return t_iter, ph, attn_t + cp_t, 2 * a2a_t

    # ------------------------------------------------------------------ #
    def _charge_reshard(self, res: SimResult, records: list,
                        now: float) -> float:
        """Charge escalation AND relaxation re-shards (same collective, same
        link-class split; the accounting is kept per direction)."""
        if not records:
            return now
        cl, lm = self.cluster, self.latency
        moved = sum(e.tokens_moved for e in records)
        # split the moved tokens by the link class each move traverses:
        # cross-node re-shards ride the thin inter links
        inter = sum(n for e in records for (s, d, n) in e.moves
                    if not cl.same_node(s, d))
        t_intra = lm.kv_reshard_time(moved - inter)
        t_inter = lm.kv_reshard_time(inter, inter=True)
        res.reshard_time += t_intra + t_inter
        res.cross_reshard_time += t_inter
        res.cross_node_bytes += int(
            inter * lm.kv_bytes_per_token * lm.num_attn_layers)
        relaxed = [e for e in records if getattr(e, "is_relaxation", False)]
        escs = [e for e in records
                if not getattr(e, "is_relaxation", False)]
        res.escalations += len(escs)
        res.escalated_tokens += sum(e.tokens_moved for e in escs)
        res.escalated_pages += sum(e.pages_moved for e in escs)
        # only ESCALATION moves count as cross-node escalated KV — a
        # relaxation moving KV home over the boundary is a reclaim, not
        # more escalation pressure
        res.cross_escalated_tokens += sum(
            n for e in escs for (s, d, n) in e.moves
            if not cl.same_node(s, d))
        res.relaxations += len(relaxed)
        res.relaxed_tokens += sum(e.tokens_moved for e in relaxed)
        if relaxed:
            rt = sum(e.tokens_moved for e in relaxed)
            ri = sum(n for e in relaxed for (s, d, n) in e.moves
                     if not cl.same_node(s, d))
            res.relax_time += (lm.kv_reshard_time(rt - ri)
                               + lm.kv_reshard_time(ri, inter=True))
            res.reclaimed_cross_bindings += sum(
                1 for e in relaxed
                if len(cl.binding_nodes(e.old_binding)) > 1
                and len(cl.binding_nodes(e.new_binding)) == 1)
        return now + t_intra + t_inter

    def _charge_copies(self, res: SimResult, copies: list,
                       now: float) -> tuple[float, int]:
        """Charge cache-driven copy coords ((src, dst) [3, T] pairs — hot-
        prefix replication, CoW pads, tail clones) at the same per-link-
        class price the re-shard path pays.  Returns (now, tokens moved)."""
        cl, lm = self.cluster, self.latency
        W = cl.instances_per_node
        intra = inter = 0
        for src, dst in copies:
            n = src.shape[1]
            if n == 0:
                continue
            x = int((src[0] // W != dst[0] // W).sum())
            intra += n - x
            inter += x
        if intra + inter == 0:
            return now, 0
        t_i = lm.kv_reshard_time(intra)
        t_x = lm.kv_reshard_time(inter, inter=True)
        res.cross_reshard_time += t_x
        res.cross_node_bytes += int(
            inter * lm.kv_bytes_per_token * lm.num_attn_layers)
        return now + t_i + t_x, intra + inter

    def _register_admissions(self, res: SimResult, now: float) -> float:
        """Post-admission pass over newly placed requests: register their
        cacheable prompt pages in the trie (the engine does this at
        prefill), account hit tokens, and queue the NOVEL-suffix prefill
        as CHUNKS — the attached pages' skipped compute is exactly the
        TTFT win the share-ratio sweep measures.  Nothing is charged here:
        ``_drain_one_chunk`` charges one chunk per outer iteration so a
        long prompt can never lump its whole forward onto requests
        admitted beside it (pinned by tests/test_torch_simulator.py)."""
        cl = self.cluster
        ps = cl.page_size
        for rid, req in cl.active.items():
            if rid in self._registered:
                continue
            self._registered.add(rid)
            res.prompt_tokens += req.prompt_len
            res.prefix_hit_tokens += req.prefix_hit_tokens
            if self.prefix_trie is not None and req.prefix_keys:
                res.prefix_inserts += self.prefix_trie.insert(
                    cl.page_table, rid, req.prefix_keys, req.prompt_len)
            if (self.charge_prefill and not self.prefill_cells
                    and req.prompt_len > req.prefix_hit_tokens):
                hit = req.prefix_hit_tokens - req.prefix_hit_tokens % ps
                self._hold[rid] = [
                    c.tokens for c in plan_chunks(hit, req.prompt_len,
                                                  self.chunk_tokens, ps)]
                self._prefill_fifo.append(rid)
        return now

    def _drain_one_chunk(self, res: SimResult, now: float) -> float:
        """Colocated chunked prefill: charge ONE pending chunk into the
        global clock per outer iteration, round-robin across held
        requests.  A held request decodes nothing until its own chunks
        drain, but everyone else's decode iterations interleave with the
        chunks — bounded head-of-line blocking instead of the old
        admission-time lump."""
        cl = self.cluster
        while self._prefill_fifo:
            rid = self._prefill_fifo.popleft()
            chunks = self._hold.get(rid)
            if not chunks or rid not in cl.active:
                self._hold.pop(rid, None)
                continue
            t = self.latency.reprefill_time(chunks.pop(0))
            res.prefill_time += t
            res.prefill_chunks += 1
            if chunks:
                self._prefill_fifo.append(rid)
            else:
                del self._hold[rid]
            return now + t
        return now

    # ------------------------------------------------------------------ #
    # disaggregated prefill cells: staging, per-cell clocks, handoff
    # ------------------------------------------------------------------ #
    def _stage_tasks(self, res: SimResult, staged: list, now: float) -> None:
        """Turn this pass's scheduler stagings (``IterationPlan.staged``)
        into ``HandoffTask``s queued FIFO on their prefill cell."""
        cl = self.cluster
        ps = cl.page_size
        for req in staged:
            p = next(i for i in req.kv_binding if cl.role_of(i) == "prefill")
            attach = tuple(i for i in req.kv_binding if i != p)
            hit = req.prefix_hit_tokens - req.prefix_hit_tokens % ps
            task = HandoffTask(req.rid, req.prompt_len, hit,
                               self.chunk_tokens, ps, p, attach=attach)
            self._tasks[req.rid] = task
            self._cell_queue.setdefault(p, deque()).append(req.rid)
            res.staged += 1

    def _advance_cells(self, res: SimResult, now: float) -> None:
        """Advance every prefill cell's local clock up to ``now``: each
        completed chunk picks its decode destination from the MEASURED
        footprint (``HandoffTask.complete_chunk``), moves its pages there
        (``GlobalPageTable.move_pages`` — the engine rides the same coords
        into ``migrate.KVReshard``), and is priced by the link class the
        handoff crosses.  The handoff overlaps the NEXT chunk's compute:
        it delays the request's ready time, never the cell's clock.  A
        chunk with no viable destination stalls its cell (backpressure)
        until decode headroom frees up."""
        cl, lm = self.cluster, self.latency
        for p, q in self._cell_queue.items():
            if p in cl.dead_instances:
                continue
            t = self._cell_clock.get(p, 0.0)
            while q:
                rid = q[0]
                task = self._tasks.get(rid)
                req = cl.prefilling.get(rid)
                if task is None or req is None or task.instance != p:
                    q.popleft()
                    continue
                t0 = max(t, req.start_time)
                if t0 >= now:
                    break
                chunk = task.next_chunk()
                cands = self.scheduler.handoff_candidates(cl, task,
                                                          chunk.tokens)
                if not cands:
                    break
                chunk, dest = task.complete_chunk(self._cp_buckets, cands)
                tc = lm.reprefill_time(chunk.tokens)
                t = t0 + tc
                res.prefill_time += tc
                res.prefill_chunks += 1
                cl.page_table.move_pages(rid, [(p, dest, chunk.tokens)])
                inter = not cl.same_node(p, dest)
                th = lm.kv_reshard_time(chunk.tokens, inter=inter)
                res.handoff_time += th
                res.handoff_tokens += chunk.tokens
                if inter:
                    res.cross_reshard_time += th
                    res.cross_node_bytes += int(
                        chunk.tokens * lm.kv_bytes_per_token
                        * lm.num_attn_layers)
                if task.done:
                    q.popleft()
                    heappush(self._ready, (t + th, rid))
            self._cell_clock[p] = t

    def _admit_ready(self, res: SimResult, now: float) -> None:
        """Activate requests whose final streamed chunk has landed: the
        realized binding is the task's MEASURED one (attach owners +
        lazily opened destinations), so ``admit_handoff`` only binds MoE
        and pins the slot — no placement prediction anywhere."""
        cl = self.cluster
        while self._ready and self._ready[0][0] <= now:
            _, rid = heappop(self._ready)
            req = cl.prefilling.get(rid)
            task = self._tasks.pop(rid, None)
            if req is None or task is None:
                continue
            self.scheduler.admit_handoff(cl, req, task.binding(), now)

    def _next_prefill_event(self, now: float) -> float:
        """Earliest future time the disaggregated pipeline changes state
        (chunk completion or handoff arrival) — the idle-clock jump when
        nothing decodes but prefill cells still stream."""
        cl, lm = self.cluster, self.latency
        nxt = min((t for t, _ in self._ready), default=float("inf"))
        for p, q in self._cell_queue.items():
            if p in cl.dead_instances:
                continue
            t = self._cell_clock.get(p, 0.0)
            for rid in q:
                task = self._tasks.get(rid)
                req = cl.prefilling.get(rid)
                if task is None or req is None or task.done:
                    continue
                c = task.next_chunk()
                nxt = min(nxt, max(t, req.start_time, now)
                          + lm.reprefill_time(c.tokens))
                break
        return nxt

    def _recover_prefilling(self, res: SimResult, req, rec,
                            now: float) -> float:
        """Resolve a failure record for a request still staged in a
        prefill cell.  A dead PREFILL cell costs only the unstreamed
        tail: what already streamed lives on decode instances
        (``HandoffTask.survived_tokens``), so the task re-stages on a
        surviving cell and recomputes just the remainder — the partial
        re-prefill, priced through the normal chunk charging.  A dead
        decode destination mid-stream (or no surviving cell) degrades the
        request: a typed outcome, never a hang — the same invariant
        active-request recovery keeps."""
        cl = self.cluster
        rid = req.rid
        task = self._tasks.get(rid)
        lost = sum(n for _, n in rec.lost)
        if task is not None and task.instance in cl.dead_instances:
            q = self._cell_queue.get(task.instance)
            if q is not None and rid in q:
                q.remove(rid)
            if lost == 0 and task.done:
                return now        # fully streamed; admission proceeds
            survived = task.survived_tokens()
            cells = [p for p in cl.prefill_instances()
                     if cl.kv_headroom(p) >= lost]
            if cells and lost > 0:
                p2 = max(cells, key=lambda s: (cl.kv_headroom(s), -s))
                cl.page_table.restore_ranges(rid, {p2: lost}, rec.lost)
                req.kv_binding = sorted(set(task.binding()) | {p2})
                req.start_time = now
                t2 = HandoffTask(rid, req.prompt_len, survived,
                                 self.chunk_tokens, cl.page_size, p2,
                                 attach=tuple(task.binding()))
                self._tasks[rid] = t2
                self._cell_queue.setdefault(p2, deque()).append(rid)
                res.recovered_tokens += survived
                res.reprefill_tokens += lost
                return now
        self._tasks.pop(rid, None)
        cl.prefilling.pop(rid, None)
        cl.page_table.free_request(rid)
        cl.free_slot(rid)
        req.status = "degraded"
        req.finish_time = now
        res.finished.append(req)
        res.degraded_finishes += 1
        return now

    def _cow_tail(self, res: SimResult, rid: int, now: float) -> float:
        """Clone every shared partial tail the next write would hit (fork /
        restore slack); the copy rides the reshard collective, charged."""
        src, dst = self.cluster.page_table.exclusive_tails(rid)
        if src.shape[1] == 0:
            return now
        res.cow_splits += 1
        res.cow_tokens += src.shape[1]
        now2, _ = self._charge_copies(res, [(src, dst)], now)
        res.cow_time += now2 - now
        return now2

    def _append_decode_token(self, res: SimResult, cl: ClusterState,
                             r: Request, now: float) -> float:
        """One decode append with the engine's full spill ladder: CoW-split
        a shared tail first, on spill evict cache-only frames (cheapest
        relief — no live KV moves; ``keep`` protects the spiller's own
        chain), then force-escalate (charged), else OOM-finish."""
        pt = cl.page_table
        spill = None
        for attempt in range(2):
            try:
                if (self.prefix_trie is not None
                        and pt.append_needs_cow(r.rid, r.moe_binding)):
                    now = self._cow_tail(res, r.rid, now)
                pt.append_token(r.rid, r.moe_binding)
                return now
            except KVSpillError as err:
                spill = err
                if (attempt == 0 and self.prefix_trie is not None
                        and self.prefix_trie.evict(pt, 2,
                                                   instance=err.instance,
                                                   keep=r.prefix_keys)):
                    continue
                break
        escs = (self.scheduler.relieve_spill(cl, spill.rid, spill.instance)
                if hasattr(self.scheduler, "relieve_spill") else [])
        if escs:
            now = self._charge_reshard(res, escs, now)
            if (self.prefix_trie is not None
                    and pt.append_needs_cow(r.rid, r.moe_binding)):
                now = self._cow_tail(res, r.rid, now)
            pt.append_token(r.rid, r.moe_binding)
            return now
        cl.finish(r, now)
        r.status = "oom"
        res.finished.append(r)
        res.oom_finishes += 1
        return now

    # ------------------------------------------------------------------ #
    def _recover(self, res: SimResult, records: list, now: float) -> float:
        """Mirror of ``NanoCPEngine._recover`` minus the device scatter:
        per affected request, partial-shard re-prefill of the lost ranges
        into a replacement WaterFill placement (charged at
        ``LatencyModel.reprefill_time``) or a degraded finish.  Recovery
        never hangs a request — every record resolves here."""
        cl, pt = self.cluster, self.cluster.page_table
        append_ok = (self.cfg.has_attention
                     and not self.cfg.is_encoder_decoder)
        pinned = (self.cfg.family in ("ssm", "hybrid")
                  or self.cfg.is_encoder_decoder)
        ledger = {s: pt.free_frames(s) for s in cl.alive_instances()}
        replayed = 0
        for rec in records:
            req = rec.req
            if req.rid in cl.prefilling:
                now = self._recover_prefilling(res, req, rec, now)
                continue
            if req.rid not in cl.active:
                continue
            resident = sum(pt.shard_tokens(req.rid).values())
            ranges = list(rec.lost)
            if resident == 0 and not ranges and req.length > 0:
                ranges = [(0, req.prompt_len + req.generated)]
            lost = sum(n for _, n in ranges)
            recoverable = append_ok and not (rec.slot_lost and pinned)
            split = None
            ok = req.moe_binding >= 0 and (lost == 0 or recoverable)
            if ok and lost > 0:
                split = (self.scheduler.place_recovery(cl, req, lost, ledger)
                         if hasattr(self.scheduler, "place_recovery")
                         else None)
                ok = split is not None
            if not ok:
                cl.finish(req, now)
                req.status = "degraded"
                res.finished.append(req)
                res.degraded_finishes += 1
                continue
            if lost == 0:
                continue
            # restore appends into surviving tail slack — shared tails
            # (prefix/fork siblings) must be CoW-split first so the replay
            # never overwrites a frame another owner still reads
            if self.prefix_trie is not None:
                now = self._cow_tail(res, req.rid, now)
            pt.restore_ranges(req.rid, split, ranges)
            req.kv_binding = sorted(set(req.kv_binding) | set(split)
                                    | {req.moe_binding})
            res.recovered_tokens += resident
            res.reprefill_tokens += lost
            replayed += lost
        if replayed:
            t = self.latency.reprefill_time(replayed)
            res.reprefill_time += t
            now += t
        return now

    # ------------------------------------------------------------------ #
    def run(self, workload: Workload, horizon: float | None = None,
            failure_events: list | None = None,
            chaos_events: list | None = None) -> SimResult:
        """failure_events: optional [(time, instance), ...] — kill injection
        (back-compat spelling).  chaos_events: optional
        [(time, action, instance), ...] with action in {"kill", "join"} —
        the full membership-change schedule (``serving.chaos`` builds seeded
        ones); merged with failure_events in time order."""
        import time as _time
        res = SimResult()
        res.submitted = len(workload.requests)
        ev0 = (self.prefix_trie.evicted_frames
               if self.prefix_trie is not None else 0)
        cl = self.cluster
        arrivals = sorted(workload.requests, key=lambda r: r.arrival)
        ai = 0
        events = [(t, "kill", i) for (t, i) in (failure_events or [])]
        events += [tuple(e) for e in (chaos_events or [])]
        events.sort(key=lambda e: e[0])
        fi = 0
        now = 0.0
        horizon = horizon or float("inf")

        while now < horizon:
            # fault injection / elastic membership changes
            while fi < len(events) and events[fi][0] <= now:
                _, action, inst = events[fi]
                fi += 1
                if action == "join":
                    cl.join_instance(inst)
                    res.joins += 1
                elif inst not in cl.dead_instances:
                    records = cl.fail_instance(inst)
                    # the ledger is already purged: forget the dead
                    # replicas WITHOUT releasing (a release would
                    # double-free into the fresh pool)
                    if self.prefix_trie is not None:
                        self.prefix_trie.drop_instance(inst)
                    res.failures += 1
                    now = self._recover(res, records, now)
            # admit arrivals whose (post-prefill) ready time has passed
            while ai < len(arrivals) and arrivals[ai].arrival <= now:
                tr = arrivals[ai]
                cl.enqueue(Request(rid=tr.rid, prompt_len=tr.prompt_len,
                                   max_new_tokens=tr.max_new_tokens,
                                   arrival=tr.arrival,
                                   prefix_keys=getattr(tr, "prefix_keys",
                                                       ())), now)
                ai += 1
            # disaggregated: advance the prefill-cell clocks up to `now`
            # (streaming chunk handoffs), then activate every request whose
            # final chunk landed — BEFORE schedule(), so this iteration's
            # plan already decodes them (admission overlaps prefill's tail)
            if self.prefill_cells:
                self._advance_cells(res, now)
                self._admit_ready(res, now)
            t0 = _time.perf_counter()
            plan = self.scheduler.schedule(cl, now)
            res.sched_wall += _time.perf_counter() - t0
            if plan.staged:
                self._stage_tasks(res, plan.staged, now)
            # escalations + relaxations: page-table bookkeeping already
            # applied by the scheduler; the simulator charges the data-plane
            # re-shard time (the engine instead dispatches migrate.KVReshard)
            now = self._charge_reshard(
                res, plan.escalations + plan.relaxations, now)
            if self.prefix_trie is not None or self.charge_prefill:
                now = self._register_admissions(res, now)
            if self._prefill_fifo:
                now = self._drain_one_chunk(res, now)
            # cache-driven copies the scheduler planned (hot-prefix
            # replication, evacuation CoW pads): same collective as the
            # re-shard, charged into sim time so replication isn't free
            if plan.copies:
                now, moved = self._charge_copies(res, plan.copies, now)
                res.copy_tokens += moved
            # typed admission-control outcomes: statuses were stamped by the
            # controller; the drop is accounted HERE (finish_time + finished
            # list) so no request ever silently vanishes from the metrics
            for r in plan.rejected + plan.shed:
                r.finish_time = now
                res.finished.append(r)
            res.rejected += len(plan.rejected)
            res.shed += len(plan.shed)
            res.preemptions += plan.preemptions
            if not cl.active:
                # prefill cells may still be streaming with nothing decoding
                # yet: jump the idle clock to the next chunk/handoff event
                # instead of crawling by sched_overhead ticks
                if self.prefill_cells and (cl.prefilling or self._ready):
                    nxt = self._next_prefill_event(now)
                    if nxt < float("inf"):
                        now = max(now + self.sched_overhead, nxt)
                        continue
                if ai < len(arrivals):
                    now = max(now, arrivals[ai].arrival)
                    continue
                if (cl.waiting and self.scheduler.admission is not None
                        and any(self.scheduler.admission.deadline(r)
                                < float("inf") for r in cl.waiting)):
                    # nothing runs but deadlined requests still queue
                    # (e.g. they can never place): the clock must keep
                    # moving so their TTFT deadlines expire into a typed
                    # shed — breaking here would let a stuck request dodge
                    # its outcome (the engine's clocked loop advances identically)
                    now += self.sched_overhead
                    continue
                break

            t_iter, ph, attn_lat, a2a_lat = self._iteration_time(plan, res)
            # head-of-line bookkeeping
            res.free_mem_series.append(cl.page_table.total_free_frames())
            if cl.waiting:
                head = cl.waiting[0]
                res.hol_demand_series.append(
                    cl.page_table.pages_needed(head.length))
            else:
                res.hol_demand_series.append(0)
            res.batch_series.append(plan.batch_sizes())
            res.kv_series.append(plan.kv_tokens())
            res.attn_lat_series.append(attn_lat)
            res.a2a_lat_series.append(a2a_lat)
            res.phase.append(ph)
            for r in cl.active.values():
                d = r.cp_degree
                res.cp_degree_hist[d] = res.cp_degree_hist.get(d, 0) + 1
                if len(cl.binding_nodes(r.kv_binding)) > 1:
                    res.cross_bindings += 1

            # run ``multi_step`` decode iterations under this plan.  Each
            # decoded token's KV is APPENDED to the MoE-binding shard — the
            # same page-table growth the real data plane performs — so
            # decode-time memory pressure (and the escalations/OOMs it
            # forces) is modeled, not ignored.
            # mirror the engine's append gate: enc-dec cross pools are
            # read-only at decode (no KV growth), attention-free archs have
            # no KV at all
            append = (self.cfg.has_attention
                      and not self.cfg.is_encoder_decoder
                      and getattr(self.scheduler, "has_kv", True))
            for _ in range(self.multi_step):
                now += t_iter
                res.iterations += 1
                done = []
                for r in list(cl.active.values()):
                    if r.rid in self._hold:
                        continue      # colocated prefill chunks still owed
                    r.generated += 1
                    r.token_times.append(now)
                    if append:
                        now = self._append_decode_token(res, cl, r, now)
                        if r.status == "oom":
                            continue
                    if r.done:
                        done.append(r)
                for r in done:
                    cl.finish(r, now)
                    res.finished.append(r)
                if not cl.active:
                    break
            if (ai >= len(arrivals) and not cl.active and not cl.waiting
                    and not cl.prefilling):
                break
        res.sim_time = now
        if self.prefix_trie is not None:
            res.evicted_prefix_frames = self.prefix_trie.evicted_frames - ev0
        return res
