"""Global state management (§4.1): requests, instances, unified cluster view.

The centralized scheduler owns ONE of these per cluster; local schedulers
cannot jointly balance KV load and batch size, hence the global pool
(paper §4.1).  All state is host-side; the data plane only ever sees the
compact routing tensors lowered from it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .page_table import GlobalPageTable


@dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival: float = 0.0
    # encoder-decoder only: decoder prefix length (text tokens consumed at
    # prefill); the request's ``prompt_len`` then counts ENCODER positions
    # (the DCP-managed cross-attention KV).  -1 for decoder-only archs.
    dec_prefix_len: int = -1
    # chained page-content keys of the prompt (core/prefix.page_keys /
    # group_keys) — empty tuple means "not cacheable / cache off".  Carried
    # on the request so scheduler, simulator, and engine resolve the SAME
    # prefix identity without re-hashing tokens.
    prefix_keys: tuple = ()
    # tokens satisfied from the global prefix cache at admission (attached
    # full pages — the prefill only computes length - prefix_hit_tokens)
    prefix_hit_tokens: int = 0
    # --- dynamic ---
    generated: int = 0
    # waiting | running | finished, or a typed non-success outcome: oom
    # (KV spill nobody could absorb), degraded (failure recovery lacked
    # headroom), rejected (admission queue overflow), shed (TTFT deadline
    # expired while queued).  Every non-success status is an SLO violation
    # in the honest-denominator metrics (serving.metrics.VIOLATION_STATUSES).
    status: str = "waiting"
    kv_binding: list = field(default_factory=list)   # P_r (instance ids)
    moe_binding: int = -1            # m_r (always in kv_binding)
    node: int = -1
    # --- metrics (filled by simulator / engine) ---
    enqueue_time: float = 0.0
    start_time: float = -1.0
    finish_time: float = -1.0
    token_times: list = field(default_factory=list)

    @property
    def length(self) -> int:
        """Current context length (prompt + generated)."""
        return self.prompt_len + self.generated

    @property
    def cp_degree(self) -> int:
        return max(len(self.kv_binding), 1)

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens


@dataclass
class FailureRecord:
    """One affected ACTIVE request of an instance failure.

    ``lost``: [(start, len)] absolute token-position ranges whose KV died
    with the instance (empty when only the binding/slot was touched — or
    when the request lost EVERYTHING, which the caller detects as zero
    resident tokens).  ``slot_lost``: the request's decode slot / MoE
    binding sat on the dead instance; ``ClusterState.fail_instance`` already
    re-homed it onto a surviving binding member when one existed
    (``req.moe_binding == -1`` means nothing survived)."""
    req: "Request"
    lost: list
    slot_lost: bool


@dataclass
class ClusterState:
    """Unified view over instances, requests, and the global page table.

    Topology model: ``num_instances`` (I) instances partition into nodes of
    width ``instances_per_node`` (W).  The node boundary is a LINK-COST
    class, not a routing wall: the data plane's rotation ring spans the
    whole cluster (``window``), so a request's KV binding may cross nodes —
    the scheduler just prices inter-node members higher (hierarchical fill)
    and the latency model charges the slower inter-node link class.
    """
    num_instances: int
    instances_per_node: int
    kv_capacity_tokens: int          # per-instance KV pool size in tokens
    page_size: int = 64
    kv_stripes: int = 1              # hybrid-KV page striping (core/dcp.py)
    # data-plane rotation window (0 -> the whole cluster).  Launch shapes
    # whose collectives cannot cross a pod confine the ring to the pod;
    # bindings never leave their window segment.
    routing_window: int = 0
    # --- disaggregated prefill/decode cells ---
    # number of instances dedicated to chunked prefill, taken from the TAIL
    # of the instance range (decode keeps its node-0 alignment).  0 =
    # colocated: every instance is mixed-role, the pre-disaggregation
    # behavior.  Decode candidate sets (``node_instances`` /
    # ``remote_instances``) exclude prefill-role instances, so a decode KV
    # binding can never land on a prefill cell; staged pages reach decode
    # only through the streamed handoff (core/handoff.py).
    prefill_cells: int = 0

    page_table: GlobalPageTable = None
    active: dict = field(default_factory=dict)       # rid -> Request
    waiting: deque = field(default_factory=deque)    # FIFO of Request
    finished: list = field(default_factory=list)
    # rid -> Request staged in a prefill cell: admitted, pages allocated,
    # but held OUT of ``active`` until the streamed handoff completes so
    # decode planning (lowering, escalation, relaxation) never sees a
    # half-prefilled request
    prefilling: dict = field(default_factory=dict)
    dead_instances: set = field(default_factory=set)
    moe_batch: np.ndarray = None                     # B_s, per current iteration
    # stable decode-slot pinning: rid -> (instance, slot).  Slots persist for
    # a request's lifetime so per-slot device state (SSM states) stays put.
    slot_map: dict = field(default_factory=dict)

    def __post_init__(self):
        assert self.num_instances % self.instances_per_node == 0
        if self.routing_window:
            assert self.num_instances % self.routing_window == 0
            assert self.routing_window % self.instances_per_node == 0
        assert 0 <= self.prefill_cells < self.num_instances, \
            "prefill_cells must leave at least one decode instance"
        # the role partition is FIXED at construction (elastic growth via
        # ``join_instance`` appends decode-role instances; it never re-roles
        # an existing prefill cell mid-run)
        self._prefill_set = set(range(self.num_instances - self.prefill_cells,
                                      self.num_instances))
        self.page_table = GlobalPageTable(
            self.num_instances,
            frames_per_instance=self.kv_capacity_tokens // self.page_size,
            page_size=self.page_size, stripes=self.kv_stripes)
        self.moe_batch = np.zeros(self.num_instances, dtype=np.int64)

    # ---------------- topology ----------------
    @property
    def num_nodes(self) -> int:
        # ceil: elastic growth (``join_instance`` past the initial topology)
        # may leave the last node partially populated
        return -(-self.num_instances // self.instances_per_node)

    @property
    def window(self) -> int:
        """Data-plane rotation window: by default the whole cluster forms
        ONE ring (zig-zag rounds, ``comm.ring_round``) — node boundaries
        change the LINK CLASS a round traverses, never its reachability."""
        return self.routing_window or self.num_instances

    def node_of(self, instance: int) -> int:
        return instance // self.instances_per_node

    def same_node(self, a: int, b: int) -> bool:
        return self.node_of(a) == self.node_of(b)

    def link_class(self, a: int, b: int) -> str:
        """Link class a round/transfer between two instances traverses."""
        return "intra" if self.same_node(a, b) else "inter"

    def role_of(self, instance: int) -> str:
        """Cell role of an instance: ``"prefill"`` (dedicated chunked-prefill
        cell, tail of the instance range) or ``"decode"`` (mixed-role when
        ``prefill_cells == 0`` — it then also runs in-place prefill)."""
        return "prefill" if instance in self._prefill_set else "decode"

    def prefill_instances(self) -> list[int]:
        """Alive dedicated prefill cells (empty when colocated)."""
        return [i for i in sorted(self._prefill_set)
                if i not in self.dead_instances]

    def decode_instances(self) -> list[int]:
        """Alive decode-role instances — the only legal KV-binding members."""
        return [i for i in range(self.num_instances)
                if i not in self.dead_instances
                and i not in self._prefill_set]

    def node_instances(self, node: int) -> list[int]:
        """Alive DECODE-role instances of ``node`` (prefill cells are never
        decode placement candidates)."""
        w = self.instances_per_node
        return [i for i in range(node * w, min((node + 1) * w,
                                               self.num_instances))
                if i not in self.dead_instances
                and i not in self._prefill_set]

    def alive_instances(self) -> list[int]:
        return [i for i in range(self.num_instances)
                if i not in self.dead_instances]

    def remote_instances(self, node: int) -> list[int]:
        """Alive DECODE instances OUTSIDE ``node`` but within its
        rotation-window segment (candidates for cross-node spill — recruited
        only when the home node is full; a binding never leaves its
        window)."""
        win = self.window
        seg = (node * self.instances_per_node) // win
        return [i for i in self.alive_instances()
                if self.node_of(i) != node and i // win == seg
                and i not in self._prefill_set]

    def binding_nodes(self, binding) -> set[int]:
        return {self.node_of(s) for s in binding}

    # ---------------- loads ----------------
    def kv_load(self, instance: int) -> int:
        return self.page_table.instance_used_tokens(instance)

    def kv_loads(self) -> np.ndarray:
        return np.array([self.kv_load(i) for i in range(self.num_instances)])

    def kv_headroom(self, instance: int) -> int:
        if instance in self.dead_instances:
            return 0
        return self.page_table.free_frames(instance) * self.page_size

    # ---------------- decode-slot pinning ----------------
    def assign_slot(self, rid: int, instance: int) -> int:
        used = {b for (i, b) in self.slot_map.values() if i == instance}
        b = 0
        while b in used:
            b += 1
        self.slot_map[rid] = (instance, b)
        return b

    def move_slot(self, rid: int, instance: int) -> int:
        if rid in self.slot_map and self.slot_map[rid][0] == instance:
            return self.slot_map[rid][1]
        self.slot_map.pop(rid, None)
        return self.assign_slot(rid, instance)

    def free_slot(self, rid: int) -> None:
        self.slot_map.pop(rid, None)

    def max_slots(self) -> int:
        return max((b + 1 for (_, b) in self.slot_map.values()), default=0)

    # ---------------- lifecycle ----------------
    def enqueue(self, req: Request, now: float = 0.0) -> None:
        req.status = "waiting"
        req.enqueue_time = now
        self.waiting.append(req)

    def finish(self, req: Request, now: float = 0.0) -> None:
        req.status = "finished"
        req.finish_time = now
        self.page_table.free_request(req.rid)
        self.free_slot(req.rid)
        self.active.pop(req.rid, None)
        self.finished.append(req)

    def fail_instance(self, instance: int) -> list:
        """Abrupt instance failure: mark it dead, PARTIAL-drop its frames
        (surviving shards untouched), prune it from every binding, and
        re-home orphaned decode slots onto a surviving binding member.

        Returns a ``FailureRecord`` per affected ACTIVE or PREFILLING
        request.  Requests stay active — nothing is silently re-enqueued;
        the caller (engine / simulator) chooses the typed recovery path per
        record: partial-shard re-prefill of the lost ranges into a
        replacement placement, or a degraded finish when the cluster lacks
        headroom.  A PREFILLING request whose prefill cell died keeps its
        already-streamed pages (they live on decode instances) and owes only
        the unstreamed tail — the same partial re-prefill machinery applies
        (pinned by tests/integration/engine_disagg.py crash cell)."""
        self.dead_instances.add(instance)
        lost = self.page_table.drop_instance(instance)
        records = []
        for rid, req in self.prefilling.items():
            ranges = lost.get(rid, [])
            if not ranges and instance not in req.kv_binding:
                continue
            if instance in req.kv_binding:
                req.kv_binding = [s for s in req.kv_binding if s != instance]
            records.append(FailureRecord(req, ranges, False))
        for rid, req in self.active.items():
            slot_lost = (self.slot_map.get(rid, (-1, -1))[0] == instance
                         or req.moe_binding == instance)
            ranges = lost.get(rid, [])
            if not ranges and not slot_lost and instance not in req.kv_binding:
                continue
            if instance in req.kv_binding:
                req.kv_binding = [s for s in req.kv_binding if s != instance]
            if slot_lost:
                self.slot_map.pop(rid, None)
                alive = [s for s in req.kv_binding
                         if s not in self.dead_instances]
                if alive:
                    m = min(alive, key=self.kv_load)
                    req.moe_binding = m
                    req.node = self.node_of(m)
                    self.move_slot(rid, m)
                else:
                    # nothing of the binding survived: full KV loss.  Pick a
                    # fresh DECODE-role home so recovery has a valid MoE
                    # binding to plan around (-1 only when every decode
                    # instance is dead).
                    cands = self.decode_instances()
                    if cands:
                        m = min(cands, key=self.kv_load)
                        req.moe_binding = m
                        req.node = self.node_of(m)
                        req.kv_binding = [m]
                        self.move_slot(rid, m)
                    else:
                        req.moe_binding, req.node = -1, -1
                        req.kv_binding = []
            records.append(FailureRecord(req, ranges, slot_lost))
        return records

    def join_instance(self, instance: int) -> None:
        """Elastic scale-up / rejoin: the instance (re)enters the zig-zag
        ring with a FRESH pool via the page table's aliasing-guarded join
        path.  ``instance == num_instances`` GROWS the cluster by one
        (host-side topologies — simulator and tests; an engine's mesh is
        fixed at construction, so it only rejoins standby/failed members)."""
        if instance == self.num_instances:
            assert not self.routing_window, \
                "cluster growth under a fixed routing window"
            self.page_table.add_instance()
            self.num_instances += 1
            self.moe_batch = np.zeros(self.num_instances, dtype=np.int64)
            return
        assert 0 <= instance < self.num_instances, instance
        self.dead_instances.discard(instance)
        self.page_table.join_instance(instance)

    def recover_instance(self, instance: int) -> None:
        """Deprecated spelling of ``join_instance`` — routed through the
        elastic-join path so a returning instance cannot alias frames still
        referenced by in-flight recovery plans (the page-table guard)."""
        self.join_instance(instance)


@dataclass
class InstancePlan:
    """Per-instance slice of one iteration's execution plan."""
    instance: int
    slots: list = field(default_factory=list)    # rids with MoE binding here
    # attention work rows on this instance: (rid, moe_binding, shard_tokens)
    work: list = field(default_factory=list)

    @property
    def batch(self) -> int:
        return len(self.slots)

    @property
    def kv_tokens(self) -> int:
        return sum(w[2] for w in self.work)


@dataclass
class IterationPlan:
    instances: list
    admitted: list = field(default_factory=list)
    deferred: int = 0
    # mid-decode CP escalations decided this iteration (scheduler.Escalation
    # records; page-table bookkeeping already applied — the engine owes the
    # device-side KV re-shard before dispatching against these tables)
    escalations: list = field(default_factory=list)
    # DCP relaxations decided this iteration (same record type, reasons
    # "relax"/"consolidate"): bindings SHRANK or fragmented KV consolidated
    # back onto the MoE-binding shard.  Same contract as escalations — the
    # bookkeeping is applied, the physical re-shard is owed.
    relaxations: list = field(default_factory=list)
    # typed admission outcomes decided this pass (scheduler.AdmissionController
    # — requests REMOVED from the waiting queue, never silently dropped; the
    # caller owes them a finish_time stamp and a results entry):
    rejected: list = field(default_factory=list)   # queue-overflow backpressure
    shed: list = field(default_factory=list)       # TTFT deadline blown in queue
    # preemption-by-relaxation events: a short request's failed placement
    # triggered a forced relax pass that freed the headroom to admit it
    preemptions: int = 0
    # requests STAGED into a prefill cell this pass (disaggregated serving:
    # novel prompt tokens allocated on a prefill instance, request parked in
    # ``cluster.prefilling``).  The caller owes the chunked forwards and the
    # streamed handoff (core/handoff.py) before these ever decode.
    staged: list = field(default_factory=list)
    # data-plane KV copies decided this pass OUTSIDE the escalation records:
    # (src, dst) int32 [3, T] coordinate pairs (KVReshard contract) from
    # copy-on-write splits and hot-prefix replication.  Like escalations,
    # the bookkeeping is already applied — the engine owes the physical copy
    # before dispatching against the new tables.
    copies: list = field(default_factory=list)

    def plan_of(self, instance: int) -> InstancePlan:
        return self.instances[instance]

    def batch_sizes(self) -> np.ndarray:
        return np.array([p.batch for p in self.instances])

    def kv_tokens(self) -> np.ndarray:
        return np.array([p.kv_tokens for p in self.instances])

    def cross_sends(self, instance: int) -> int:
        """Rows instance must send Q for (CP shards on other instances)."""
        p = self.instances[instance]
        n = 0
        for peer in self.instances:
            if peer.instance == instance:
                continue
            n += sum(1 for (_, m, _) in peer.work if m == instance)
        return n
