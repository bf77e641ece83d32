"""Dual-balanced scheduling (Alg. 1) + the paper's baseline policies.

All schedulers share one interface:  ``schedule(cluster, now) -> IterationPlan``.
They admit waiting requests (allocating KV pages through the global page
table) and (re)assign MoE bindings, producing the per-instance plan that the
routing lowering / simulator / data plane consume.

Policies:
  * DualBalancedScheduler — NanoCP (decoupled MoE/KV bindings, per-request CP
    degree from length buckets, WaterFill splits, MoE rebalancing).
  * LeastBatchScheduler   — vLLM default (batch-balanced, KV colocated).
  * LeastCacheScheduler   — KV-balanced, batch-oblivious.
  * UniformCPScheduler    — Helix-style fixed CP groups of size c.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bucketing import CPBuckets, DEFAULT_BUCKETS
from .state import ClusterState, InstancePlan, IterationPlan, Request
from .waterfill import waterfill


@dataclass
class PrefixHit:
    """A resolved prefix-cache hit, carried from ``place`` to the commit in
    ``_try_place``: the request attaches to ``attach`` ({instance:
    (start_pos, [frames])} — GlobalPageTable.allocate's ``prefix=``
    argument) and only the novel suffix needs frames.  ``chosen`` ([(page,
    instance)]) is the replica selection, committed to the trie's LRU/hit
    counters only when the placement actually lands."""
    keys: tuple
    attach: dict
    chosen: list
    tokens: int


@dataclass
class Escalation:
    """One mid-decode CP promotion: the request's KV binding grew (or its KV
    was rebalanced within the binding) and ``moves`` tokens change shards.

    Page-table bookkeeping is already applied when this record is created;
    ``src_coords``/``dst_coords`` ([3, T] int32: instance, frame, offset per
    moved token, matching order) are the coordinate tensors the data plane's
    ``migrate.KVReshard`` consumes to move the physical KV.  The engine MUST
    apply that re-shard before dispatching a step lowered from the updated
    table (the simulator instead charges ``latency_model.kv_reshard_time``).
    """
    rid: int
    old_binding: list
    new_binding: list
    moves: list                      # [(src_instance, dst_instance, tokens)]
    src_coords: np.ndarray           # [3, T] (instance, frame, offset)
    dst_coords: np.ndarray
    # escalation reasons widen the binding (bucket | headroom | spill |
    # drain); relaxation reasons shrink or defragment it (relax |
    # consolidate) — same record, same data-plane contract, opposite sign
    reason: str = "bucket"

    @property
    def is_relaxation(self) -> bool:
        return self.reason in ("relax", "consolidate")

    @property
    def tokens_moved(self) -> int:
        return int(self.src_coords.shape[1])

    @property
    def pages_moved(self) -> int:
        """Distinct destination frames written by the re-shard."""
        if self.dst_coords.shape[1] == 0:
            return 0
        key = self.dst_coords[0].astype(np.int64) * (1 << 32) + self.dst_coords[1]
        return int(np.unique(key).size)


class AdmissionController:
    """SLO-aware admission control for the closed serving loop (§6).

    State machine (every submitted request ends in EXACTLY one typed
    outcome — there is no silent drop):

        submitted -> queued -> admitted -> finished | oom | degraded
                          \\-> shed      (TTFT deadline expired while queued:
                                          even an immediate admission would
                                          violate, so the capacity goes to
                                          requests that can still make it)
                          \\-> rejected  (queue overflow: backpressure —
                                          lowest-priority newest entries
                                          still queued beyond ``max_queue``
                                          AFTER the placement loop bounce)

    Priority tiers: short (interactive) requests are tier 0 and admit ahead
    of long (batch, ``prompt_len >= long_threshold``) tier-1 requests; each
    tier carries its own TTFT deadline.  ``preempt`` arms
    preemption-by-relaxation in ``BaseScheduler.schedule``: before a tier-0
    request is left to queue (and eventually shed), the scheduler force-runs
    one cost-gated relax pass — retracting long requests' remote members,
    cross-node first, NEVER below their profiled ``CPBuckets`` degree — and
    retries the placement against the freed headroom.
    """

    def __init__(self, ttft_slo: float = float("inf"),
                 ttft_slo_long: float | None = None,
                 long_threshold: int = 100_000,
                 max_queue: int | None = None,
                 preempt: bool = True):
        if ttft_slo <= 0:
            raise ValueError(f"ttft_slo must be > 0 (got {ttft_slo!r})")
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0 (got {max_queue!r})")
        self.ttft_slo = ttft_slo
        # long-tier deadline: batch traffic tolerates a slower first token
        # (None -> 4x the interactive deadline)
        self.ttft_slo_long = (ttft_slo_long if ttft_slo_long is not None
                              else 4.0 * ttft_slo)
        self.long_threshold = long_threshold
        self.max_queue = max_queue
        self.preempt = preempt

    def tier(self, req: Request) -> int:
        """0 = short/interactive (admits first), 1 = long/batch."""
        return 1 if req.prompt_len >= self.long_threshold else 0

    def deadline(self, req: Request) -> float:
        """Absolute time by which the request's first token must land."""
        slo = self.ttft_slo if self.tier(req) == 0 else self.ttft_slo_long
        return req.arrival + slo

    def shed_expired(self, cluster: ClusterState, now: float) -> list:
        """Pre-placement admission-control pass: order the waiting queue by
        (tier, arrival) so short requests admit first and SHED entries whose
        TTFT deadline already passed — even an immediate admission would
        violate.  Statuses are stamped here (the typed outcome); the caller
        stamps ``finish_time`` and accounts them."""
        if not cluster.waiting:
            return []
        ordered = sorted(cluster.waiting,
                         key=lambda r: (self.tier(r), r.arrival, r.rid))
        shed = [r for r in ordered if now > self.deadline(r)]
        keep = [r for r in ordered if now <= self.deadline(r)]
        for r in shed:
            r.status = "shed"
        cluster.waiting.clear()
        cluster.waiting.extend(keep)
        return shed

    def enforce_cap(self, cluster: ClusterState) -> list:
        """POST-placement backpressure: REJECT the lowest-priority newest
        entries still queued beyond ``max_queue``.  Runs after the placement
        loop on purpose — the cap bounds how much work is left WAITING, so
        a burst that admits immediately never bounces off it (rejecting
        pre-placement would bounce requests an empty cluster could serve).
        The queue is already in priority order from ``shed_expired``."""
        if (self.max_queue is None
                or len(cluster.waiting) <= self.max_queue):
            return []
        keep = list(cluster.waiting)[:self.max_queue]
        rejected = list(cluster.waiting)[self.max_queue:]
        for r in rejected:
            r.status = "rejected"
        cluster.waiting.clear()
        cluster.waiting.extend(keep)
        return rejected

    def control_queue(self, cluster: ClusterState, now: float
                      ) -> tuple[list, list]:
        """Both admission-control passes back to back (no placement in
        between) — the standalone spelling for tests and callers that
        manage placement themselves."""
        shed = self.shed_expired(cluster, now)
        return self.enforce_cap(cluster), shed


def _mk_plan(cluster: ClusterState) -> IterationPlan:
    return IterationPlan([InstancePlan(i) for i in range(cluster.num_instances)])


def _fill_plan(cluster: ClusterState, plan: IterationPlan) -> IterationPlan:
    """Populate slots/work from the active set + page table."""
    for req in cluster.active.values():
        plan.instances[req.moe_binding].slots.append(req.rid)
        for s, toks in cluster.page_table.shard_tokens(req.rid).items():
            if toks > 0:
                plan.instances[s].work.append((req.rid, req.moe_binding, toks))
    return plan


class BaseScheduler:
    """Common admission loop; subclasses implement placement."""

    name = "base"
    hol_blocking = False          # stop admitting at the first non-fitting req

    def __init__(self, max_batch_per_instance: int = 256,
                 admission: AdmissionController | None = None):
        self.max_batch = max_batch_per_instance
        # SLO-aware admission controller (None = admit-everything legacy
        # behaviour: no deadlines, no queue cap, no preemption)
        self.admission = admission
        # global prefix cache (core.prefix.PrefixTrie), attached by the
        # engine/simulator when the cache is on.  None = cache off: place
        # never consults it and admission never evicts from it.
        self.prefix_cache = None

    # -- subclass hooks ---------------------------------------------------
    def place(self, cluster: ClusterState, req: Request, B=None):
        """Return (moe_binding, kv_binding list, split dict) or None.
        ``B``: per-instance MoE-binding counts (maintained by the caller)."""
        raise NotImplementedError

    def rebalance(self, cluster: ClusterState) -> None:
        """Optionally reassign MoE bindings of active requests."""

    def escalate(self, cluster: ClusterState) -> list:
        """Optionally promote running requests' CP degrees (returns
        ``Escalation`` records; page-table bookkeeping already applied)."""
        return []

    def relax(self, cluster: ClusterState, force: bool = False,
              exclude: frozenset = frozenset()) -> list:
        """Optionally demote/consolidate running requests' bindings (the
        inverse of ``escalate``; same record contract).  ``exclude``: rids
        that must NOT be touched this pass — a request already escalated or
        relaxed this step has pending frame moves, and a second move would
        batch into the same gather->scatter reading frames the first hasn't
        written yet."""
        return []

    def place_recovery(self, cluster: ClusterState, req: Request,
                       tokens: int, ledger: dict | None = None):
        """Replacement placement for ``tokens`` lost KV tokens of an ACTIVE
        request after an instance failure (the partial-shard re-prefill
        path).  Returns ``{instance: tokens}`` or None when the alive
        cluster lacks headroom — the caller then degrades the request.
        ``ledger``: optional shared {instance: free_frames} so a batch of
        recoveries cannot jointly over-commit one pool.  The base policy
        re-homes the lost tokens onto the single alive shard with the most
        headroom inside the MoE binding's rotation-window segment."""
        pt = cluster.page_table
        page = pt.page_size
        m = req.moe_binding
        if m < 0 or tokens <= 0:
            return None
        if ledger is None:
            ledger = {s: pt.free_frames(s) for s in cluster.alive_instances()}
        win = cluster.window
        best, best_cap = None, -1
        for s in cluster.alive_instances():
            if s // win != m // win:
                continue
            # a shared partial tail reports 0 slack AND costs one frame to
            # CoW-split before the recovery append can land there
            pad = 1 if pt.append_needs_cow(req.rid, s) else 0
            cap = (max(ledger.get(s, 0) - pad, 0) * page
                   + pt.shard_tail_slack(req.rid, s))
            if cap > best_cap:
                best, best_cap = s, cap
        if best is None or best_cap < tokens:
            return None
        slack = pt.shard_tail_slack(req.rid, best)
        pad = 1 if pt.append_needs_cow(req.rid, best) else 0
        ledger[best] = ledger.get(best, 0) - pad - pt.pages_needed(
            max(tokens - slack, 0))
        return {best: tokens}

    def _try_place(self, cluster: ClusterState, req: Request, batch_counts,
                   now: float) -> bool:
        """Attempt one admission: place, check batch + KV capacity, and on
        success commit the allocation/bindings.  Returns True if admitted.

        With a prefix cache attached, a bounced placement gets one retry
        after evicting cold cache-only replicas worth the request's
        worst-case frame need — live requests always outrank cached
        convenience copies, but the chain THIS request is about to hit is
        protected from its own eviction pass."""
        if self._attempt_place(cluster, req, batch_counts, now):
            return True
        if self.prefix_cache is None:
            return False
        pt = cluster.page_table
        freed = self.prefix_cache.evict(pt, pt.pages_needed(req.length),
                                        keep=req.prefix_keys)
        if freed == 0:
            return False
        return self._attempt_place(cluster, req, batch_counts, now)

    def _attempt_place(self, cluster: ClusterState, req: Request,
                       batch_counts, now: float) -> bool:
        placement = self.place(cluster, req, batch_counts)
        if placement is None:
            return False
        # prefix-aware policies return a 4th element: the resolved cache hit
        if len(placement) == 4:
            m, binding, split, hit = placement
        else:
            m, binding, split = placement
            hit = None
        if not (batch_counts[m] < self.max_batch
                and cluster.page_table.can_allocate(split)):
            return False
        cluster.page_table.allocate(req.rid, split,
                                    prefix=hit.attach if hit else None)
        if hit is not None:
            self.prefix_cache.touch(hit.keys, hit.chosen)
            req.prefix_hit_tokens = hit.tokens
        req.moe_binding, req.kv_binding = m, sorted(binding)
        req.node = cluster.node_of(m)
        req.status = "running"
        req.start_time = now
        cluster.active[req.rid] = req
        cluster.assign_slot(req.rid, m)
        batch_counts[m] += 1
        return True

    def replicate_hot(self, cluster: ClusterState) -> list:
        """Optionally replicate hot cached prefixes (policy hook; returns
        (src, dst) coordinate pairs for ``IterationPlan.copies``)."""
        return []

    # -- disaggregated prefill staging --------------------------------------
    def _resolve_stage_hit(self, cluster: ClusterState, req: Request):
        """Resolve the request's prefix-cache hit for prefill staging
        (``PrefixHit`` or None).  Base policies are cache-oblivious."""
        return None

    def _try_stage_prefill(self, cluster: ClusterState, req: Request,
                           now: float) -> str:
        """Stage one request into a dedicated prefill cell (disaggregated
        serving — only called when ``cluster.prefill_cells > 0``).

        The NOVEL prompt suffix is allocated on the least-loaded prefill
        instance; cached prefix pages attach on their decode-instance
        owners exactly as in colocated admission, so a prefix hit
        short-circuits those chunks before they are ever planned.  The
        request parks in ``cluster.prefilling`` — invisible to decode
        planning — until the streamed handoff (core/handoff.py) completes
        and ``admit_handoff`` activates it.

        Returns ``"staged"`` (parked), ``"decode"`` (fully-cached prompt:
        prefill short-circuits entirely, the caller falls through to normal
        decode admission), or ``"defer"`` (no prefill cell can hold the
        novel suffix right now)."""
        hit = self._resolve_stage_hit(cluster, req)
        novel = req.prompt_len - (hit.tokens if hit else 0)
        if hit is not None and novel <= 0:
            return "decode"
        cells = [p for p in cluster.prefill_instances()
                 if cluster.kv_headroom(p) >= novel]
        if not cells:
            return "defer"
        p = max(cells, key=lambda s: (cluster.kv_headroom(s), -s))
        split = {p: novel}
        if not cluster.page_table.can_allocate(split):
            return "defer"
        cluster.page_table.allocate(req.rid, split,
                                    prefix=hit.attach if hit else None)
        if hit is not None:
            self.prefix_cache.touch(hit.keys, hit.chosen)
            req.prefix_hit_tokens = hit.tokens
        req.status = "prefilling"
        req.start_time = now
        req.kv_binding = (sorted(set(hit.attach) | {p}) if hit
                          else [int(p)])
        cluster.prefilling[req.rid] = req
        return "staged"

    def handoff_candidates(self, cluster: ClusterState, task,
                           tokens: int) -> list[int]:
        """Ordered decode destinations able to absorb a ``tokens``-sized
        streamed chunk: members of the node already holding the most of
        this request's landed KV first (handoff traffic stays on the fast
        link class whenever it can), then the rest, least-loaded first."""
        page = cluster.page_table.page_size
        need = tokens + page            # one page of slack for the tail
        bound = task.binding()
        home = cluster.node_of(bound[0]) if bound else -1
        return sorted(
            (s for s in cluster.decode_instances()
             if cluster.kv_headroom(s) >= need),
            key=lambda s: (0 if cluster.node_of(s) == home else 1,
                           cluster.kv_load(s), s))

    def admit_handoff(self, cluster: ClusterState, req: Request,
                      binding: list, now: float) -> None:
        """Activate a request whose streamed handoff completed.

        The KV is ALREADY placed — ``binding`` is the MEASURED realized
        binding the handoff produced (attach owners + lazily opened
        destinations), not a prediction — so admission here only binds MoE
        to the least-batch member, pins the decode slot, and moves the
        request from ``prefilling`` to ``active``.  Pinned by
        tests/test_handoff.py (degree selection) and the ``disagg``
        conformance cells (token equality through the full path)."""
        holders = {s for s, t in
                   cluster.page_table.shard_tokens(req.rid).items() if t > 0}
        members = sorted(set(binding) | holders)
        B = np.bincount([r.moe_binding for r in cluster.active.values()],
                        minlength=cluster.num_instances)
        m = min(members, key=lambda s: (B[s], s))
        req.moe_binding, req.kv_binding = int(m), members
        req.node = cluster.node_of(int(m))
        req.status = "running"
        cluster.prefilling.pop(req.rid, None)
        cluster.active[req.rid] = req
        cluster.assign_slot(req.rid, int(m))

    # -- main entry ---------------------------------------------------------
    def schedule(self, cluster: ClusterState, now: float = 0.0) -> IterationPlan:
        """One control-plane pass: the single entry every caller (engine,
        simulator, launch planner) calls per iteration.

        Order is the contract (each stage sees the previous stage's state):
        rebalance -> escalate -> relax -> shed expired -> admission loop
        (prefill staging under disaggregation, placement otherwise,
        preemption-by-relaxation on a tier-0 bounce) -> queue-cap rejection
        -> hot-prefix replication -> plan fill.  Invariant: every request
        popped from the waiting queue lands in EXACTLY one typed outcome
        (admitted / staged / still-waiting / shed / rejected) — there is no
        silent drop (pinned by tests/test_admission.py and the slo
        conformance shard); escalation/relaxation records carry their page-table
        bookkeeping already applied, the physical re-shard still owed
        (pinned by tests/test_escalation.py and the escalation shard)."""
        self.rebalance(cluster)
        plan = _mk_plan(cluster)
        # escalations run BEFORE admission so new placements see the
        # post-move headroom picture (and never race a planned move's frames)
        plan.escalations = self.escalate(cluster)
        # relaxations run right after (symmetric pass): a request promoted
        # THIS step is cooldown-protected, so the two passes never fight —
        # and admissions see the post-retraction headroom picture too
        plan.relaxations = self.relax(cluster)
        # admission control, pass 1 (BEFORE placement): deadline-blown
        # entries shed and the queue reorders by (tier, arrival) so short
        # interactive requests admit first; the queue cap is enforced AFTER
        # placement (pass 2) so a burst the cluster can absorb right now is
        # never bounced
        if self.admission is not None:
            plan.shed = self.admission.shed_expired(cluster, now)
        admitted, staged, still_waiting = [], [], []
        # preemption-by-relaxation budget: at most one forced relax pass per
        # schedule() step — each pass batches its frame moves into the same
        # gather->scatter, so unbounded retries inside one step would stack
        # re-shard cost the iteration-time model never charges
        preempt_left = 1 if (self.admission is not None
                             and self.admission.preempt) else 0
        batch_counts = np.bincount(
            [r.moe_binding for r in cluster.active.values()],
            minlength=cluster.num_instances)
        while cluster.waiting:
            req = cluster.waiting.popleft()
            if cluster.prefill_cells:
                # disaggregated: novel prompt tokens go to a prefill cell;
                # only a FULLY-cached prompt (novel == 0) falls through to
                # direct decode admission — nothing to prefill, so the
                # handoff short-circuits entirely
                verdict = self._try_stage_prefill(cluster, req, now)
                if verdict == "staged":
                    staged.append(req)
                    continue
                if verdict == "defer":
                    still_waiting.append(req)
                    if self.hol_blocking:
                        break
                    continue
            ok = self._try_place(cluster, req, batch_counts, now)
            if not ok and preempt_left > 0 and self.admission.tier(req) == 0:
                # preemption-by-relaxation (relax-before-reject): before a
                # short request is left to queue (and eventually shed),
                # force a cost-gated relax of long requests' remote members
                # to free headroom, then retry the placement.  Excluded:
                # anything already moved this pass — a second move on the
                # same rid would gather frames the first move hasn't
                # scattered yet.  Retraction stays bounded by the profiled
                # bucket degree (``_try_deescalate`` floor), so preemption
                # can never starve a long request below its own SLO shape.
                exclude = frozenset(
                    {e.rid for e in plan.escalations}
                    | {e.rid for e in plan.relaxations}
                    | {r.rid for r in admitted})
                freed = self.relax(cluster, force=True, exclude=exclude)
                preempt_left -= 1
                if freed:
                    plan.relaxations.extend(freed)
                    plan.preemptions += 1
                    ok = self._try_place(cluster, req, batch_counts, now)
            if ok:
                admitted.append(req)
            else:
                still_waiting.append(req)
                if self.hol_blocking:
                    break
        for req in reversed(still_waiting):
            cluster.waiting.appendleft(req)
        # admission control, pass 2: queue-depth backpressure on whatever
        # placement could NOT absorb this step
        if self.admission is not None:
            plan.rejected = self.admission.enforce_cap(cluster)
        # hot-prefix replication LAST: a request admitted this very pass can
        # only attach to replicas whose physical copy already ran, so new
        # replicas become visible to admissions one pass later — after the
        # engine applies this plan's copies
        if self.prefix_cache is not None:
            plan.copies.extend(self.replicate_hot(cluster))
        plan = _fill_plan(cluster, plan)
        plan.admitted = admitted
        plan.staged = staged
        plan.deferred = len(still_waiting)
        cluster.moe_batch = plan.batch_sizes()
        return plan


# --------------------------------------------------------------------------- #
# NanoCP: dual-balanced scheduling with DCP (Algorithm 1)
# --------------------------------------------------------------------------- #
class DualBalancedScheduler(BaseScheduler):
    name = "nanocp"
    hol_blocking = False

    def __init__(self, buckets: CPBuckets = DEFAULT_BUCKETS,
                 max_batch_per_instance: int = 256, kv_reserve: int = 0,
                 allow_rebalance: bool = True, has_kv: bool = True,
                 allow_escalation: bool = True,
                 escalate_headroom: int | None = None,
                 allow_cross_node: bool = True,
                 inter_node_penalty: int | None = None,
                 allow_relaxation: bool = True,
                 relax_guard: int | None = None,
                 relax_cooldown: int = 4,
                 admission: AdmissionController | None = None,
                 hot_threshold: int = 4):
        super().__init__(max_batch_per_instance, admission=admission)
        self.buckets = buckets
        # prefix-cache hotness: a root chain with this many hits since its
        # last replication decision earns a per-node replica (replicate_hot)
        self.hot_threshold = hot_threshold
        self.kv_reserve = kv_reserve   # headroom tokens kept per shard for growth
        # hierarchical (two-level) placement: a binding prefers its home
        # node's members and spills across the node boundary only when the
        # whole home node cannot hold the KV (or a bucket degree exceeds the
        # node width).  ``inter_node_penalty`` (tokens) is added to remote
        # members' loads inside every WaterFill so short requests stay
        # node-local; None derives max(page_size, kv_capacity/8) per cluster.
        self.allow_cross_node = allow_cross_node
        self.inter_node_penalty = inter_node_penalty
        # SSM/hybrid archs pin recurrent state to the decode slot, so their
        # MoE binding cannot be reassigned without a state migration
        # (DESIGN.md §6); the engine disables rebalancing for them.
        self.allow_rebalance = allow_rebalance
        # attention-free archs (mamba2) have no KV cache: DCP is inapplicable
        # (DESIGN.md §6) and placement degenerates to batch balancing.
        self.has_kv = has_kv
        # mid-decode CP escalation (live KV re-sharding).  The engine turns
        # it off when decode never appends KV (whisper: cross pools are
        # read-only, the request's KV footprint cannot grow).
        self.allow_escalation = allow_escalation
        # low-water mark (tokens): escalate a request whose MoE-binding
        # shard's free space falls to/below this.  None -> derived per
        # cluster as max(kv_reserve, page_size).
        self.escalate_headroom = escalate_headroom
        # DCP relaxation (the inverse of escalation): de-escalate bindings
        # wider than the bucket degree warrants and consolidate fragmented
        # tail pages back onto the MoE-binding shard once pressure subsides.
        # Escalation gates it off exactly where escalation itself is off
        # (no decode KV growth -> nothing ever widened to relax).
        self.allow_relaxation = allow_relaxation
        # hysteresis guard band (tokens): a relaxation receiver must keep
        # MORE than low_water + guard free AFTER absorbing the retracted KV,
        # so the escalation low-water trigger cannot immediately re-fire.
        # None -> derived per cluster as max(page_size, kv_reserve).
        self.relax_guard = relax_guard
        # hysteresis cooldown (schedule() passes, including the pass that
        # set it): a request that escalated or relaxed is ineligible for
        # relaxation for this many passes — escalate<->relax thrash is
        # bounded to once per cooldown window.  Clamped to >= 1: a relax in
        # the SAME pass as an escalation would batch into one re-shard
        # whose gather reads frames the escalation hasn't written yet.
        self.relax_cooldown = max(relax_cooldown, 1)
        self._cooldown: dict = {}      # rid -> passes until relax-eligible

    def _low_water(self, cluster: ClusterState) -> int:
        if self.escalate_headroom is not None:
            return self.escalate_headroom
        return max(self.kv_reserve, cluster.page_table.page_size)

    def _penalty(self, cluster: ClusterState) -> int:
        """Inter-node link penalty in WaterFill load units (tokens)."""
        if self.inter_node_penalty is not None:
            return self.inter_node_penalty
        return max(cluster.page_table.page_size,
                   cluster.kv_capacity_tokens // 8)

    def _remote_members(self, cluster: ClusterState, node: int) -> list:
        """Cross-node fill candidates, least-loaded first ([] when the
        binding must stay node-local)."""
        if not self.allow_cross_node:
            return []
        return sorted(cluster.remote_instances(node),
                      key=lambda s: (cluster.kv_load(s), s))

    # Alg. 1, lines 1-5: rebalance MoE bindings of active requests
    def rebalance(self, cluster: ClusterState) -> None:
        if not self.allow_rebalance:
            return
        B = np.zeros(cluster.num_instances, dtype=np.int64)
        # ascending participant count: fewest feasible choices first
        for req in sorted(cluster.active.values(), key=lambda r: r.cp_degree):
            alive = [s for s in req.kv_binding if s not in cluster.dead_instances]
            if not alive:
                continue
            m = min(alive, key=lambda s: (B[s], s))
            if m != req.moe_binding:
                req.moe_binding = int(m)
                cluster.move_slot(req.rid, int(m))
            B[m] += 1

    # -- mid-decode CP escalation (live KV re-sharding) --------------------
    def escalate(self, cluster: ClusterState) -> list:
        """Promote running requests whose KV footprint outgrew their degree.

        A request escalates when (a) its TOTAL KV length (prompt + decoded)
        crossed its next ``CPBuckets`` edge, or (b) its MoE-binding shard —
        the one every decoded token's KV is appended to — fell to/below the
        low-water headroom mark.  The promotion extends ``kv_binding`` with
        the least-loaded node members and WaterFills the request's resident
        tokens across the new binding; page-table bookkeeping happens here,
        the physical move is the returned records' coordinate tensors.
        Pinned by tests/test_escalation.py and the ``escalation``
        conformance shard (token equality through a forced mid-decode
        re-shard)."""
        if not (self.has_kv and self.allow_escalation):
            return []
        out = []
        low = self._low_water(cluster)
        for rid in sorted(cluster.active):
            req = cluster.active[rid]
            if req.moe_binding in cluster.dead_instances:
                continue
            esc = self._try_escalate(cluster, req, low)
            if esc is not None:
                out.append(esc)
        return out

    # -- DCP relaxation (the inverse of escalation) -------------------------
    def relax(self, cluster: ClusterState, force: bool = False,
              exclude: frozenset = frozenset()) -> list:
        """Demote running requests whose bindings outgrew their need.

        The mirror of ``escalate``: a request relaxes when (a) its binding
        is WIDER than its ``CPBuckets`` degree warrants (after headroom/spill
        escalations or a drain whose pressure has since subsided) — members
        are retracted cross-node first, then widen-node, the exact mirror of
        the hierarchical recruitment order — or (b) fragmented partial tail
        pages strewn across donors can consolidate back onto the MoE-binding
        shard, reclaiming whole frames.  Both are hysteretic: receivers must
        keep ``low_water + guard`` free afterwards (the escalation trigger
        cannot immediately re-fire) and a request never relaxes twice within
        ``relax_cooldown`` passes (``force`` — the engine's ``compact()``
        maintenance pass and the scheduler's preemption-by-relaxation —
        overrides the cooldown, never the guard band).  ``exclude``: rids
        with pending frame moves this pass (escalated/relaxed earlier in
        the same step) — forced preemption must skip them, since the engine
        batches the whole pass into ONE gather->scatter.
        Page-table bookkeeping happens here; the physical move is the
        returned records' coordinate tensors, same as escalation.
        Pinned by tests/test_escalation.py, the escalate<->relax round
        trip in tests/test_properties.py, and the ``relaxation``
        conformance shard."""
        if not (self.has_kv and self.allow_escalation
                and self.allow_relaxation):
            return []
        out = []
        low = self._low_water(cluster)
        guard = self._relax_guard(cluster)
        touched = set()
        for rid in sorted(cluster.active):
            if rid in exclude:
                continue
            req = cluster.active[rid]
            if req.moe_binding in cluster.dead_instances:
                continue
            if not force and self._cooldown.get(rid, 0) > 0:
                continue
            rec = (self._try_deescalate(cluster, req, low, guard)
                   or self._try_consolidate(cluster, req, low, guard))
            if rec is not None:
                out.append(rec)
                self._cooldown[rid] = self.relax_cooldown
                touched.add(rid)
        if not force:
            # one pass elapses AFTER the eligibility checks: a request
            # escalated earlier in this very schedule() is blocked HERE
            # (cooldown >= 1 always — the engine batches this pass's
            # escalation and relaxation coords into ONE gather->scatter
            # whose gathers all read pre-move pools, so a same-pass relax
            # of a just-escalated request would gather frames its own
            # escalation hasn't physically written yet)
            self._cooldown = {
                r: (c if r in touched else c - 1)
                for r, c in self._cooldown.items()
                if r in cluster.active and (r in touched or c > 1)}
        return out

    def _relax_guard(self, cluster: ClusterState) -> int:
        if self.relax_guard is not None:
            return self.relax_guard
        return max(cluster.page_table.page_size, self.kv_reserve)

    def _retract_order(self, cluster: ClusterState, req: Request,
                       binding: list, shards: dict) -> list:
        """Retraction candidates, in the MIRROR of the recruitment order:
        cross-node members first (they were recruited last, as the home
        node's last resort, and each one retracted drops inter-node rounds),
        then widen-node members — cheapest-to-vacate (fewest resident
        tokens) first within each class.  The MoE binding never retracts."""
        remote = [s for s in binding
                  if s != req.moe_binding and cluster.node_of(s) != req.node]
        home = [s for s in binding
                if s != req.moe_binding and cluster.node_of(s) == req.node]
        remote.sort(key=lambda s: (shards.get(s, 0), s))
        home.sort(key=lambda s: (shards.get(s, 0), s))
        return remote + home

    def _try_deescalate(self, cluster: ClusterState, req: Request,
                        low: int, guard: int):
        """Shrink one request's binding back to its bucket degree; None when
        already at (or below) the profiled degree or no retraction fits
        under the hysteresis guard band."""
        pt = cluster.page_table
        shards = pt.shard_tokens(req.rid)
        total = sum(shards.values())
        binding = [s for s in req.kv_binding
                   if s not in cluster.dead_instances]
        m = req.moe_binding
        if m not in binding or total == 0:
            return None
        # never below the profiled argmin degree: the bucket IS the cost
        # gate (latency_model.relax_breakeven_steps documents the payoff)
        k_want = max(self.buckets.cp_degree(total), 1)
        n_extra = len(binding) - k_want
        if n_extra <= 0:
            return None
        cand = self._retract_order(cluster, req, binding, shards)
        for n in range(min(n_extra, len(cand)), 0, -1):
            drop = cand[:n]
            keep = [s for s in binding if s not in drop]
            moves = self._plan_relax_moves(cluster, req, keep, drop, low,
                                           guard)
            if moves is None:
                continue        # receivers lack guard-banded headroom
            src, dst = pt.move_pages(req.rid, moves)
            old = sorted(req.kv_binding)
            # the binding becomes exactly the retained members — a keep
            # member the WaterFill happened to leave at zero tokens STAYS
            # (pruning it would drop the degree below the bucket's k_want
            # and the bucket trigger would re-widen next pass)
            req.kv_binding = sorted(set(keep))
            return Escalation(req.rid, old, req.kv_binding, moves, src, dst,
                              reason="relax")
        return None

    def _try_consolidate(self, cluster: ClusterState, req: Request,
                         low: int, guard: int):
        """Defragment: move partial tail pages strewn across non-MoE members
        back onto the MoE-binding shard, reclaiming whole donor frames.

        Cost-gated: only applied when it reclaims MORE frames than the
        receiver allocates (net frame gain >= 1).  A donor holding a single
        partial page is fully vacated — allowed only while the binding stays
        at or above the bucket degree, so the bucket trigger cannot re-widen
        it next pass."""
        pt = cluster.page_table
        page = pt.page_size
        shards = pt.shard_tokens(req.rid)
        total = sum(shards.values())
        binding = [s for s in req.kv_binding
                   if s not in cluster.dead_instances]
        m = req.moe_binding
        if m not in binding or total == 0:
            return None
        k_want = max(self.buckets.cp_degree(total), 1)
        spare = len(binding) - k_want            # members we may fully vacate
        # receiver budget on m: guard-banded + growth-aware (the same cap as
        # de-escalation receivers — a consolidation must never consume the
        # MoE shard's append runway)
        budget = self._receiver_cap(cluster, req, m, low, guard)
        tails = []                               # (tokens, vacates_member, s)
        for s in binding:
            t = shards.get(s, 0)
            if s == m or t == 0 or t % page == 0:
                continue
            # a SHARED donor tail reclaims nothing: the frame stays with its
            # other owners after the copy-out, so the whole point of the
            # consolidation (net frame gain) evaporates — skip it
            fr = pt.shard_frames(req.rid, s)
            if fr and pt.frame_shared(req.rid, s, fr[-1]):
                continue
            tails.append((t % page, t <= page, s))
        # smallest tails first: most frames reclaimed per token moved
        tails.sort()
        moves, moved, vacated = [], 0, set()
        for t, vac, s in tails:
            if moved + t > budget or (vac and len(vacated) + 1 > spare):
                continue
            moves.append((s, m, t))
            moved += t
            if vac:
                vacated.add(s)
        if not moves:
            return None
        # net frame reclaim: every tail move frees exactly one donor frame
        need_m = pt.pages_needed(shards.get(m, 0) + moved) \
            - len(pt.shard_frames(req.rid, m))
        if len(moves) - max(need_m, 0) < 1:
            return None
        src, dst = pt.move_pages(req.rid, moves)
        old = sorted(req.kv_binding)
        # only fully-vacated donors leave the binding: pruning an untouched
        # zero-token member here could drop the degree below k_want
        req.kv_binding = sorted(set(binding) - vacated)
        return Escalation(req.rid, old, req.kv_binding, moves, src, dst,
                          reason="consolidate")

    def _receiver_cap(self, cluster: ClusterState, req: Request, s: int,
                      low: int, guard: int) -> float:
        """Tokens shard ``s`` may ABSORB in a relaxation without risking the
        escalation trigger re-firing: strictly-positive guard-banded frame
        headroom (plus the request's own free tail slots, which cost no
        frame).  The MoE-binding shard additionally reserves the request's
        REMAINING decode growth — every future append lands there, so a
        relax that fits "right now" on a still-growing request would just
        re-escalate a few steps later (the thrash the hysteresis exists to
        prevent).  0 when the shard is at/below the guard band: a relaxation
        never digs a receiver's headroom hole deeper."""
        pt = cluster.page_table
        head = cluster.kv_headroom(s) - (low + guard)
        if s == req.moe_binding:
            head -= max(req.max_new_tokens - req.generated, 0)
        if pt.append_needs_cow(req.rid, s):
            # receiving appends into a SHARED partial tail: priced as a
            # copy — the CoW split spends one frame before any token lands
            # (and shard_tail_slack already reports 0 for the shared tail)
            head -= pt.page_size
        if head <= 0:
            return 0.0
        return float(pt.shard_tail_slack(req.rid, s) + head)

    def _plan_relax_moves(self, cluster: ClusterState, req: Request,
                          keep: list, drop: list, low: int, guard: int):
        """Plan the donor->receiver moves that vacate ``drop`` onto ``keep``.
        Returns None when the retained members cannot absorb the KV while
        keeping ``low + guard`` headroom (hysteresis), else the move list
        ([] when the dropped members held no resident tokens)."""
        pt = cluster.page_table
        shards = pt.shard_tokens(req.rid)
        donors = [(s, shards.get(s, 0)) for s in drop if shards.get(s, 0) > 0]
        move_total = sum(t for _, t in donors)
        if move_total == 0:
            return []
        loads = np.array([cluster.kv_load(s) for s in keep], np.float64)
        # remote receivers carry the link penalty, mirroring every WaterFill:
        # retracted KV lands home-first
        pen = float(self._penalty(cluster))
        loads += np.array([0.0 if cluster.node_of(s) == req.node else pen
                           for s in keep])
        caps = np.array(
            [self._receiver_cap(cluster, req, s, low, guard)
             for s in keep], np.float64)
        if caps.sum() < move_total:
            return None
        target = waterfill(loads, move_total, capacities=caps)
        recvs = [(keep[i], int(t)) for i, t in enumerate(target) if t > 0]
        moves = []
        ri = 0
        for s, have in donors:
            while have > 0 and ri < len(recvs):
                d, want = recvs[ri]
                n = min(have, want)
                moves.append((s, d, n))
                have -= n
                want -= n
                recvs[ri] = (d, want)
                if want == 0:
                    ri += 1
        return moves

    def relieve_spill(self, cluster: ClusterState, rid: int,
                      instance: int) -> list:
        """Emergency path for a ``KVSpillError`` at table lowering: free
        append headroom on ``instance`` by force-escalating the spilling
        request itself, else the co-resident request with the most movable
        KV.  Returns the applied escalations ([] = nothing could move — the
        caller should OOM-finish the request)."""
        if not self.has_kv:
            return []
        low = self._low_water(cluster)
        pt = cluster.page_table
        cands = []
        if rid in cluster.active:
            cands.append(cluster.active[rid])
        others = [r for r_id, r in sorted(cluster.active.items())
                  if r_id != rid and pt.shard_tokens(r_id).get(instance, 0) > 0]
        others.sort(key=lambda r: -pt.shard_tokens(r.rid).get(instance, 0))
        cands.extend(others)
        for req in cands:
            esc = self._try_escalate(cluster, req, low, relieve=instance)
            if esc is not None:
                return [esc]
        return []

    def evacuate(self, cluster: ClusterState, instance: int,
                 partial: bool = False) -> list:
        """Drain ``instance``: move every active request's resident KV off it
        (live re-shard, no data loss) and drop it from their bindings.  The
        caller marks the instance dead and lets ``rebalance`` move MoE
        bindings; if any request's KV cannot fit elsewhere this raises with
        the page table UNTOUCHED (two-phase plan/apply — a mid-drain failure
        must not leave earlier requests' tables pointing at frames whose KV
        was never physically moved; callers that tolerate loss use
        ``ClusterState.fail_instance`` instead).

        ``partial=True`` is the drain-deadline fallback: requests whose KV
        cannot be evacuated are SKIPPED instead of aborting the drain, and
        the return value becomes ``(records, straggler_rids)`` — the caller
        applies fail-semantics (partial drop + recovery) to the stragglers
        so the drain always completes."""
        pt = cluster.page_table
        page = pt.page_size
        # phase 1: plan every request's moves against a FRAME ledger (each
        # request's tokens land in its own frames, so receiver headroom is
        # consumed at page granularity — conservatively ceil per request)
        head_frames = {s: pt.free_frames(s)
                       for s in range(cluster.num_instances)}
        plans, stragglers = [], []
        for rid in sorted(cluster.active):
            req = cluster.active[rid]
            tokens_on = pt.shard_tokens(rid).get(instance, 0)
            if instance not in req.kv_binding and tokens_on == 0:
                continue
            members = [s for s in cluster.node_instances(req.node)
                       if s != instance]
            n_home = len(members)
            moves = []
            if tokens_on > 0:
                # hierarchical receiver set: home-node members first; when
                # the home node cannot absorb the evacuated KV, recruit
                # remote-node receivers (the drain crosses the boundary
                # rather than failing — last-resort, penalty-priced below)
                home_cap = sum(head_frames[s] * page for s in members)
                if home_cap < tokens_on:
                    for s in self._remote_members(cluster, req.node):
                        if s == instance or home_cap >= tokens_on:
                            continue
                        members.append(s)
                        home_cap += head_frames[s] * page
                if not members:
                    if partial:
                        stragglers.append(rid)
                        continue
                    raise MemoryError(
                        f"evacuate({instance}): request {rid} has no "
                        f"surviving member to hold its KV")
                loads = np.array([cluster.kv_load(s) for s in members],
                                 np.float64)
                loads[n_home:] += float(self._penalty(cluster))
                # receivers whose next append lands in a SHARED frame pay
                # one ledger frame for the CoW split move_pages will perform
                pads = {s: (1 if pt.append_needs_cow(rid, s) else 0)
                        for s in members}
                caps = np.array(
                    [max(head_frames[s] - pads[s], 0) * page
                     for s in members], np.float64)
                if caps.sum() < tokens_on:
                    if partial:
                        stragglers.append(rid)
                        continue
                    raise MemoryError(
                        f"evacuate({instance}): request {rid} needs "
                        f"{tokens_on} tokens, cluster headroom "
                        f"{caps.sum():.0f}")
                split = waterfill(loads, tokens_on, capacities=caps)
                for s, t in zip(members, split):
                    if t > 0:
                        moves.append((instance, s, int(t)))
                        head_frames[s] -= -(-int(t) // page) + pads[s]
            plans.append((req, members, moves))
        # phase 2: apply (cannot fail — the ledger over-reserved frames)
        out = []
        for req, members, moves in plans:
            src, dst = pt.move_pages(req.rid, moves)
            binding = sorted(s for s in req.kv_binding
                             if s != instance and s not in cluster.dead_instances)
            holders = {s for s, t in pt.shard_tokens(req.rid).items() if t > 0}
            new_binding = sorted(holders | set(binding)) or sorted(
                set(members[:1]))
            old = sorted(req.kv_binding)
            req.kv_binding = new_binding
            self._cooldown[req.rid] = self.relax_cooldown
            out.append(Escalation(req.rid, old, new_binding, moves, src, dst,
                                  reason="drain"))
        if partial:
            return out, stragglers
        return out

    def place_recovery(self, cluster: ClusterState, req: Request,
                       tokens: int, ledger: dict | None = None):
        """NanoCP recovery placement (overrides the single-shard base
        policy): WaterFill the lost tokens over the surviving home-node
        members first, recruiting penalty-priced remote members of the same
        rotation-window segment only for the overflow — the dead shard's
        replacement stays node-local whenever the home node has headroom.
        Receiver capacity counts the request's own partial tail pages on
        surviving shards (``restore_ranges`` appends into that slack without
        a frame alloc) plus the ledgered free frames."""
        pt = cluster.page_table
        page = pt.page_size
        m = req.moe_binding
        if m < 0 or m in cluster.dead_instances or tokens <= 0:
            return None
        if ledger is None:
            ledger = {s: pt.free_frames(s) for s in cluster.alive_instances()}
        node = cluster.node_of(m)
        members = cluster.node_instances(node)
        cands = list(members)
        for s in self._remote_members(cluster, node):
            if s not in cands:
                cands.append(s)
        if not cands:
            return None
        n_home = len(members)

        # a shared partial tail reports 0 slack and costs one ledger frame
        # to CoW-split before the recovery append lands (exclusive_tails)
        pads = {s: (1 if pt.append_needs_cow(req.rid, s) else 0)
                for s in cands}

        def caps_of(reserve):
            caps = np.array([max(ledger.get(s, 0) - pads[s], 0) * page
                             + pt.shard_tail_slack(req.rid, s)
                             for s in cands], np.float64)
            if m in cands:
                mi = cands.index(m)
                caps[mi] = max(caps[mi] - reserve, 0.0)
            return caps

        caps = caps_of(self.kv_reserve)
        if caps.sum() < tokens:
            # the growth reserve is a soft preference; a degraded finish is
            # worse than a tight MoE shard, so retry without it
            caps = caps_of(0)
        if caps.sum() < tokens:
            return None
        loads = np.array([cluster.kv_load(s) for s in cands], np.float64)
        loads[n_home:] += float(self._penalty(cluster))
        split_arr = waterfill(loads, tokens, capacities=caps)
        split = {s: int(t) for s, t in zip(cands, split_arr) if t > 0}
        for s, t in split.items():
            slack = pt.shard_tail_slack(req.rid, s)
            ledger[s] = (ledger.get(s, 0) - pads[s]
                         - pt.pages_needed(max(t - slack, 0)))
        return split

    def _try_escalate(self, cluster: ClusterState, req: Request, low: int,
                      relieve: int | None = None):
        """Plan + apply one request's escalation; None when not needed or
        infeasible.  ``relieve``: force mode — the instance a decode append
        spilled on; the plan must vacate at least one frame there."""
        pt = cluster.page_table
        shards = pt.shard_tokens(req.rid)
        total = sum(shards.values())
        members = cluster.node_instances(req.node)
        remote = self._remote_members(cluster, req.node)
        if (not members and not remote) or total == 0:
            return None
        if relieve is not None and shards.get(relieve, 0) == 0:
            return None             # nothing of this request to vacate there
        binding = [s for s in req.kv_binding
                   if s not in cluster.dead_instances]
        m = req.moe_binding
        k_want = min(self.buckets.cp_degree(total),
                     len(members) + len(remote))
        need_degree = k_want > len(binding)
        need_headroom = cluster.kv_headroom(m) <= low
        force = relieve is not None
        if not (force or need_degree or need_headroom):
            return None
        # candidates home-node first: a promotion recruits a remote-node
        # member only once every home member is already in the binding
        # (cross-node escalation is the last resort)
        cand = sorted((s for s in members if s not in binding),
                      key=lambda s: (cluster.kv_load(s), s))
        cand += [s for s in remote if s not in binding]
        k_new = max(k_want, len(binding) + (1 if (need_headroom or force)
                                            else 0))
        extra = max(k_new - len(binding), 0)
        while True:
            trial = sorted(set(binding) | set(cand[:extra]))
            moves = self._plan_moves(cluster, req, trial, low, relieve)
            if moves or extra >= len(cand) or not (force or need_headroom):
                break
            # the chosen members lacked headroom: widen the trial (possibly
            # past the node boundary) before giving up — a spill relief must
            # exhaust the CLUSTER, not the home node, before the OOM finish
            extra += 1
        if not moves:
            return None
        if not force and not need_degree:
            # headroom-only trigger: the move must actually relieve m, and
            # must be worth a re-shard (>= one page) — under sustained
            # pressure this batches the migration into periodic page-sized
            # moves instead of a per-step token dribble (the typed spill
            # path stays as the exhaustion backstop)
            if not any(s == m for s, _, _ in moves):
                return None
            if sum(n for _, _, n in moves) < cluster.page_table.page_size:
                return None
        src, dst = pt.move_pages(req.rid, moves)
        holders = {s for s, t in pt.shard_tokens(req.rid).items() if t > 0}
        old = sorted(req.kv_binding)
        req.kv_binding = sorted(holders | {m})
        reason = ("spill" if force else
                  "bucket" if need_degree else "headroom")
        # a just-promoted request must not relax within the cooldown window
        # (escalate<->relax hysteresis)
        self._cooldown[req.rid] = self.relax_cooldown
        return Escalation(req.rid, old, req.kv_binding, moves, src, dst,
                          reason)

    def _plan_moves(self, cluster: ClusterState, req: Request, binding: list,
                    low: int, relieve: int | None):
        """WaterFill the request's resident tokens over ``binding`` and emit
        the donor->receiver move list reaching that split.  Donors and
        receivers are disjoint by construction (sign of cur - target), which
        is exactly the invariant ``move_pages``/the single-scatter data plane
        require."""
        pt = cluster.page_table
        page = pt.page_size
        shards = pt.shard_tokens(req.rid)
        cur = np.array([shards.get(s, 0) for s in binding], np.int64)
        total = int(cur.sum())
        if total == 0 or len(binding) < 2:
            return []
        loads = np.array([cluster.kv_load(s) - c
                          for s, c in zip(binding, cur)], np.float64)
        # remote-node members carry the link penalty: WaterFill drains the
        # home node first and puts only the overflow across the boundary
        pen = float(self._penalty(cluster))
        loads += np.array([0.0 if cluster.node_of(s) == req.node else pen
                           for s in binding])
        # receiver capacity counts the request's own partial tail-page slack
        # (move_pages appends into it without a frame alloc): without it the
        # planner strands cluster capacity and OOMs with free tail tokens on
        # every shard.  A shard whose next append lands in a SHARED frame is
        # priced one page lower: receiving there forces a CoW split first.
        caps = np.array(
            [len(pt.shard_frames(req.rid, s)) * page + cluster.kv_headroom(s)
             - (page if pt.append_needs_cow(req.rid, s) else 0)
             for s in binding], np.float64)
        # refcount>1 frames are IMMOVABLE for an escalation: only the
        # contiguous exclusively-owned fill tail may leave a shard (moving a
        # shared frame's tokens would consume destination frames without
        # freeing the source — all cost, no balance).  Pin everything deeper
        # as a per-shard WaterFill floor.
        mins = np.array([max(int(c) - pt.movable_tail(req.rid, s), 0)
                         for s, c in zip(binding, cur)], np.int64)
        mi = binding.index(req.moe_binding) if req.moe_binding in binding \
            else None
        if mi is not None:
            caps[mi] = max(caps[mi] - low, 0.0)
        if relieve is not None and relieve in binding:
            # vacating the partial tail page is what actually frees a frame
            ri = binding.index(relieve)
            if cur[ri] > 0:
                vacate = (int(cur[ri]) - 1) % page + 1
                caps[ri] = min(caps[ri], float(max(int(cur[ri]) - vacate, 0)))
        if caps.sum() < total and mi is not None:
            # relax the soft low-water reserve on the MoE binding, but keep
            # the hard frame-vacating constraint of a spill relief
            relaxed = (len(pt.shard_frames(req.rid, req.moe_binding)) * page
                       + cluster.kv_headroom(req.moe_binding))
            if relieve == req.moe_binding and cur[mi] > 0:
                vacate = (int(cur[mi]) - 1) % page + 1
                relaxed = min(relaxed, float(max(int(cur[mi]) - vacate, 0)))
            caps[mi] = relaxed
        if caps.sum() < total:
            return []
        if (mins > caps).any():
            # pinned (shared) tokens exceed a shard's cap under the relieve
            # constraint: the plan would have to move immovable frames
            return []
        target = waterfill(loads, total, capacities=caps, minimums=mins)
        delta = cur - target                      # >0 donor, <0 receiver
        donors = [(binding[i], int(d)) for i, d in enumerate(delta) if d > 0]
        recvs = [(binding[i], int(-d)) for i, d in enumerate(delta) if d < 0]
        moves = []
        di = 0
        for s, have in donors:
            while have > 0 and di < len(recvs):
                d, want = recvs[di]
                n = min(have, want)
                moves.append((s, d, n))
                have -= n
                want -= n
                recvs[di] = (d, want)
                if want == 0:
                    di += 1
        return moves

    # -- prefix-aware admission -------------------------------------------
    def _page_align(self, binding, split_arr, caps, total, page):
        """Quantize a token split to page multiples, pushing the remainder
        to the LARGEST instance id with cap room: ``allocate`` assigns
        positions in sorted-instance order, so every member before the
        remainder-holder keeps page-aligned absolute range starts — the
        alignment ``aligned_pages`` needs for THIS request's pages to be
        cacheable in turn.  Falls back to the raw split when caps are too
        tight (costs future cacheability, never correctness)."""
        arr = (np.asarray(split_arr, np.int64) // page) * page
        rem = int(total - arr.sum())
        for i in sorted(range(len(binding)), key=lambda j: -binding[j]):
            if rem == 0:
                break
            take = min(rem, int(caps[i] - arr[i]))
            if take > 0:
                arr[i] += take
                rem -= take
        if rem:
            return np.asarray(split_arr, np.int64)
        return arr

    def _resolve_hit(self, cluster: ClusterState, req: Request,
                     pool: list[int]):
        """Longest usable cached prefix within ONE rotation-window segment
        of ``pool`` (a binding never leaves its segment, so replicas
        elsewhere are unusable), replica-resolved to concrete attach runs.
        Returns a ``PrefixHit`` or None."""
        trie = self.prefix_cache
        page = cluster.page_table.page_size
        win = cluster.window
        best = None
        for seg in sorted({i // win for i in pool}):
            allowed = {i for i in pool if i // win == seg}
            hit = trie.lookup(req.prefix_keys, allowed=allowed)
            if hit and (best is None or len(hit) > len(best)):
                best = hit
        if not best:
            return None
        # per-page replica choice: extend the current instance's run while
        # it holds the next page; an instance may host only ONE contiguous
        # run (allocate's attach contract tiles [0, P) with one range per
        # shard), so a forced revisit truncates the hit instead
        chosen, runs, used, cur = [], {}, set(), None
        for p, reps in best:
            if cur in reps:
                inst = cur
            else:
                cands = [i for i in reps if i not in used]
                if not cands:
                    break
                inst = min(cands, key=lambda i: (cluster.kv_load(i), i))
                used.add(inst)
                cur = inst
            chosen.append((p, inst))
            runs.setdefault(inst, []).append((p, reps[inst]))
        if not chosen:
            return None
        attach = {inst: (pages_[0][0] * page, [f for _, f in pages_])
                  for inst, pages_ in runs.items()}
        return PrefixHit(req.prefix_keys, attach, chosen,
                         len(chosen) * page)

    def _resolve_stage_hit(self, cluster: ClusterState, req: Request):
        """Prefix hit for PREFILL STAGING: replicas must live on DECODE
        instances (staged pages on prefill cells are transient and never
        enter the trie), so the attach pool excludes prefill cells."""
        if not (self.has_kv and self.prefix_cache is not None
                and req.prefix_keys):
            return None
        return self._resolve_hit(cluster, req, cluster.decode_instances())

    def _place_prefix(self, cluster: ClusterState, req: Request, B):
        """Prefix-aware admission: resolve the longest cached prefix within
        ONE rotation-window segment (a binding never leaves its segment, so
        replicas elsewhere are unusable), ATTACH the request to the replica
        frames, and WaterFill only the novel suffix around the hit.  The
        home node is the node already holding the most attached KV — decode
        appends and the suffix stay next to the hit.  None -> no usable hit
        (the caller falls through to the normal placement)."""
        pt = cluster.page_table
        page = pt.page_size
        hit_rec = self._resolve_hit(cluster, req,
                                    cluster.alive_instances())
        if hit_rec is None:
            return None
        attach, P = hit_rec.attach, hit_rec.tokens
        node_tokens = {}
        for inst, (_, fr) in attach.items():
            n = cluster.node_of(inst)
            node_tokens[n] = node_tokens.get(n, 0) + len(fr) * page
        n_star = min(node_tokens, key=lambda n: (
            -node_tokens[n],
            sum(B[s] for s in cluster.node_instances(n)), n))
        members = cluster.node_instances(n_star)
        if not members:
            return None
        m_cands = [s for s in members
                   if cluster.kv_headroom(s) >= self.kv_reserve] or members
        m = min(m_cands, key=lambda s: (B[s], s))
        suffix = req.length - P
        if suffix <= 0:
            # fully cached prompt: nothing to prefill, appends go to m
            return int(m), sorted(set(attach) | {m}), {m: 0}, hit_rec

        def caps_of(b):
            caps = np.array([cluster.kv_headroom(s) for s in b], np.float64)
            caps[0] = max(caps[0] - self.kv_reserve, 0.0)   # b[0] is m
            return caps

        k = min(self.buckets.cp_degree(req.length), len(members))
        others = sorted((s for s in members if s != m),
                        key=lambda s: (cluster.kv_load(s), s))
        binding = [m] + others[: k - 1]
        caps = caps_of(binding)
        if caps.sum() < suffix and len(binding) < len(members):
            binding = [m] + others
            caps = caps_of(binding)
        n_home = len(binding)
        if caps.sum() < suffix:
            short = suffix - caps.sum()
            for s in self._remote_members(cluster, n_star):
                if short <= 0:
                    break
                if s in binding:
                    continue
                binding.append(s)
                short -= cluster.kv_headroom(s)
            caps = caps_of(binding)
        if caps.sum() < suffix:
            return None
        loads = np.array([cluster.kv_load(s) for s in binding], np.float64)
        loads[n_home:] += float(self._penalty(cluster))
        split_arr = waterfill(loads, suffix, capacities=caps)
        split_arr = self._page_align(binding, split_arr, caps, suffix, page)
        pairs = [(s, int(t))
                 for i, (s, t) in enumerate(zip(binding, split_arr))
                 if i < n_home or t > 0]
        split = dict(pairs)
        split.setdefault(m, 0)
        return (int(m), sorted(set(split) | set(attach)), split, hit_rec)

    def replicate_hot(self, cluster: ClusterState) -> list:
        """Per-node replication of HOT prefix chains, priced through the
        same cost model as a placement: a chain earns a replica on a node
        only when its root collected ``hot_threshold`` hits since the last
        decision, and the copy lands on the node's least-loaded instance
        only if that instance keeps its growth reserve + low-water headroom
        AFTER hosting the chain — a loaded node never trades live-KV runway
        for a convenience copy.  Returns (src, dst) coordinate pairs for
        ``IterationPlan.copies`` (the engine owes the physical copy; the
        replicas become attachable next pass)."""
        trie = self.prefix_cache
        pt = cluster.page_table
        out = []
        roots = [n for n in trie.nodes.values()
                 if n.depth == 0 and n.hits >= self.hot_threshold]
        roots.sort(key=lambda n: (-n.hits, n.key))
        for root in roots[:2]:          # at most two chains per pass
            keys = trie.chain_of(root.key)
            if not keys:
                continue
            depth = len(keys)
            for tn in range(cluster.num_nodes):
                insts = cluster.node_instances(tn)
                if not insts:
                    continue
                if all(any(i in insts for i in trie.nodes[k].replicas)
                       for k in keys if k in trie.nodes):
                    continue            # the node already holds the chain
                tgt = min(insts, key=lambda s: (cluster.kv_load(s), s))
                need = depth + pt.pages_needed(
                    self.kv_reserve + self._low_water(cluster))
                if pt.free_frames(tgt) < need:
                    continue
                src, dst = trie.replicate(pt, keys, depth, tgt)
                if src.shape[1]:
                    out.append((src, dst))
            root.hits = 0
        return out

    # Alg. 1, lines 6-18 (+ hierarchical two-level fill for W < I)
    def place(self, cluster: ClusterState, req: Request, B=None):
        """Admission placement: ``(moe_binding, kv_binding, split)`` or
        None when nothing fits (caller keeps the request queued).

        Invariants: the MoE binding is always a kv_binding member and
        reserves ``kv_reserve`` append room SPECIFICALLY (not in
        aggregate), the CP degree comes from the ``CPBuckets`` length
        profile, and the fill is hierarchical — home node first, remote
        members recruited only when the whole home node cannot hold the
        request, priced with ``inter_node_penalty`` so short requests
        stay 100% node-local.  A prefix-cache hit re-homes placement
        onto the replica holders instead (``_place_prefix``).  Pinned by
        tests/test_control_plane.py::test_dual_balanced_invariants,
        tests/test_multinode.py (node-locality + penalty), and the
        ``dense``/``multinode-fault`` conformance shards."""
        if B is None:
            B = np.bincount([r.moe_binding for r in cluster.active.values()],
                            minlength=cluster.num_instances)
        if self.has_kv and self.prefix_cache is not None and req.prefix_keys:
            hit_placement = self._place_prefix(cluster, req, B)
            if hit_placement is not None:
                return hit_placement
        # node selection: fewest total MoE-bound requests (line 7)
        nodes = [n for n in range(cluster.num_nodes) if cluster.node_instances(n)]
        if not nodes:
            return None
        n_star = min(nodes, key=lambda n: (sum(B[s] for s in cluster.node_instances(n)), n))
        members = cluster.node_instances(n_star)
        # CP degree from length buckets (line 8), sized within the home node
        k = min(self.buckets.cp_degree(req.length), len(members))
        # intra-node placement (lines 9-11)
        if not self.has_kv:                 # attention-free: batch balance only
            m = min(members, key=lambda s: (B[s], s))
            return int(m), [m], {m: 0}
        # the MoE binding takes every appended token's KV: prefer a member
        # that still has the growth reserve free (another request's spill
        # may have filled the least-batch one — placing there guarantees a
        # first-append spill)
        m_cands = [s for s in members
                   if cluster.kv_headroom(s) >= self.kv_reserve] or members
        m = min(m_cands, key=lambda s: (B[s], s))
        others = sorted((s for s in members if s != m),
                        key=lambda s: (cluster.kv_load(s), s))
        binding = [m] + others[: k - 1]

        # WaterFill token split (line 12); reserve growth room on the MoE
        # binding SPECIFICALLY — an aggregate check lets WaterFill fill m to
        # its cap, and the very first appended token then needs a frame the
        # shard doesn't have
        def caps_of(b):
            caps = np.array([cluster.kv_headroom(s) for s in b], np.float64)
            caps[0] = max(caps[0] - self.kv_reserve, 0.0)   # b[0] is m
            return caps

        # hierarchical fill: widen within the home node first, then spill
        # the binding across the node boundary ONLY when the whole home
        # node cannot hold the request
        caps = caps_of(binding)
        if caps.sum() < req.length and len(binding) < len(members):
            binding = [m] + others
            caps = caps_of(binding)
        n_home = len(binding)
        if caps.sum() < req.length:
            short = req.length - caps.sum()
            for s in self._remote_members(cluster, n_star):
                if short <= 0:
                    break
                binding.append(s)
                short -= cluster.kv_headroom(s)
            caps = caps_of(binding)
        if caps.sum() < req.length:
            return None
        loads = np.array([cluster.kv_load(s) for s in binding], np.float64)
        # remote members look penalty-tokens fuller: overflow-only crossing
        loads[n_home:] += float(self._penalty(cluster))
        split_arr = waterfill(loads, req.length, capacities=caps)
        if self.prefix_cache is not None:
            # cache on: page-align the split so this request's prompt pages
            # are cacheable — misaligned pages straddle frames and can never
            # be attached (the hit rate of every FUTURE sibling depends on
            # the FIRST request of a group landing aligned)
            split_arr = self._page_align(binding, split_arr, caps,
                                         req.length,
                                         cluster.page_table.page_size)
        # drop remote members the fill never used — short requests' bindings
        # stay literally node-local
        pairs = [(s, int(t)) for i, (s, t) in enumerate(zip(binding, split_arr))
                 if i < n_home or t > 0]
        binding = [s for s, _ in pairs]
        split = dict(pairs)
        # the MoE binding must be able to take appended tokens: ensure it is
        # in the split map even at 0 so the page table tracks it
        split.setdefault(m, 0)
        return int(m), binding, split


# --------------------------------------------------------------------------- #
# request-level baselines (vLLM policies)
# --------------------------------------------------------------------------- #
class LeastBatchScheduler(BaseScheduler):
    """vLLM default: route to the instance with the smallest running batch."""
    name = "least_batch"
    hol_blocking = True

    def place(self, cluster: ClusterState, req: Request, B=None):
        if B is None:
            B = np.bincount([r.moe_binding for r in cluster.active.values()],
                            minlength=cluster.num_instances)
        cands = [i for i in range(cluster.num_instances)
                 if i not in cluster.dead_instances]
        if not cands:
            return None
        m = min(cands, key=lambda s: (B[s], s))
        if cluster.kv_headroom(m) < req.length:
            return None
        return m, [m], {m: req.length}


class LeastCacheScheduler(BaseScheduler):
    """Route to the instance with the most free KV blocks (least cache)."""
    name = "least_cache"
    hol_blocking = True

    def place(self, cluster: ClusterState, req: Request, B=None):
        cands = [i for i in range(cluster.num_instances)
                 if i not in cluster.dead_instances]
        if not cands:
            return None
        m = min(cands, key=lambda s: (cluster.kv_load(s), s))
        if cluster.kv_headroom(m) < req.length:
            return None
        return m, [m], {m: req.length}


class UniformCPScheduler(BaseScheduler):
    """Helix-style: fixed CP groups of size ``cp``; every request's KV binding
    is its whole group (uniform degree), MoE binding = least-batch member."""
    name = "uniform_cp"
    hol_blocking = True

    def __init__(self, cp: int, max_batch_per_instance: int = 256):
        super().__init__(max_batch_per_instance)
        self.cp = cp

    def place(self, cluster: ClusterState, req: Request, B=None):
        ni, c = cluster.num_instances, self.cp
        assert ni % c == 0
        if B is None:
            B = np.bincount([r.moe_binding for r in cluster.active.values()],
                            minlength=ni)
        groups = [list(range(g * c, (g + 1) * c)) for g in range(ni // c)]
        groups = [[i for i in g if i not in cluster.dead_instances] for g in groups]
        groups = [g for g in groups if g]
        if not groups:
            return None
        g = min(groups, key=lambda g: (sum(B[s] for s in g), g[0]))
        m = min(g, key=lambda s: (B[s], s))
        # uniform split over the whole group
        per = req.length // len(g)
        split = {s: per for s in g}
        split[g[0]] += req.length - per * len(g)
        if any(cluster.kv_headroom(s) < t for s, t in split.items()):
            return None
        return m, list(g), split


SCHEDULERS = {
    "nanocp": DualBalancedScheduler,
    "least_batch": LeastBatchScheduler,
    "least_cache": LeastCacheScheduler,
    "uniform_cp": UniformCPScheduler,
}
