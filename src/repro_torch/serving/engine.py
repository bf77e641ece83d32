"""NanoCP decode engine, main path (port of ``repro/serving/engine.py``).

Drives the stack end to end on one GPU: ENQUEUE -> dual-balanced
scheduling -> prefill (flash kernel) + in-place KV scatter into the paged
pools -> routing-table lowering -> per-bucket step lookup -> the four-phase
DCP decode step over the virtual (instance, tp) mesh (paged kernel) ->
sampling -> finish.

Decode hot path:

  * The serve state lives on the device for the engine's lifetime and every
    step updates the pools in place (``AOTGraphEngine.note_donation``
    audits that the pools' ``data_ptr`` never moves).
  * On CUDA each bucket's step is one CUDA graph (``core/aot.py``): a
    bucket's first step runs eagerly and is then captured, later steps
    replay it, and every replay checks that no params, pool or table
    buffer moved.  ``cuda_graphs=False`` keeps the eager step on CUDA; the
    CPU always runs it.  Every write to the pools outside the step (prefill
    scatter, re-shard, re-prefill) lands in place in the captured storage.
  * Iterations are pipelined one step ahead: ``step`` lowers iteration t's
    tables while the device still computes iteration t-1 (PyTorch enqueues
    CUDA work asynchronously), then harvests t-1's tokens — copied at
    dispatch into pinned host memory with ``non_blocking=True`` and waited
    for on a CUDA event — patches the per-slot input tokens and dispatches
    t.  ``pipeline=False`` dispatches and harvests in the same call.
  * Finish-by-length is applied at dispatch time; an EOS finish is seen one
    step late, and with ``eos_token`` set the step's device-side stop-token
    mask (``DecodeDims.eos``) sends the speculative step's KV append to the
    scratch frame, so an EOS finish leaves exactly its real tokens' KV.

Escalations and relaxations the scheduler plans are applied by the live
KV re-shard (``migrate.KVReshard``): the reference's main path relaxes
within its first decode steps.

Quantized pools (``kv_dtype="fp8"`` or ``"int8"``) store codes with
per-page scales (``kernels/quant.py``); the paged kernel dequantizes as it
reads, and the step cache keys carry the kv dtype.  ``keep_logits=True``
keeps every step's logits and records them per request at harvest
(``step_logits``), for the tolerance check of quantized serving; it is off
on the hot path.

``backend="dense"`` runs the all-gather baseline of the data plane in place
of the routed rotations (same tables, same results).  MLA models cache
their latent in one ``kv_pool`` (``core/dcp.py``); MoE models run their
experts over the instances (wide EP) in the decode step.

KV spill relief: a decode append that overruns its shard surfaces at
table lowering as a typed ``KVSpillError`` (page table untouched); the
engine escalates the request onto shards with headroom
(``scheduler.relieve_spill``, the MoE binding stays put) or, when no
shard can take the KV, finishes it with a request-level OOM
(``GenResult.oom``), and lowers again.  ``drain_instance`` evacuates an
instance's KV live and ``compact`` forces one relaxation pass, both
through the same re-shard.

Fault tolerance and elasticity: ``fail_instance`` (crash semantics, safe
between dispatch and harvest: the in-flight entries the dead instance
touched are voided and their bookkeeping rolled back; lost KV ranges are
re-prefilled into a replacement placement, or the request finishes
degraded when the cluster lacks headroom), ``join_instance`` (the rejoined
instance's wider-ring buckets are captured off the hot path) and the
forced drain (fail semantics for what cannot be evacuated).

Not ported yet, each raising ``NotImplementedError`` where the reference
would act: SSM and encoder-decoder models (items 11-12); the prefix
cache and its data-plane copies, admission control and prefill cells
(item 13).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core import dcp, migrate, routing
from ..core.aot import AOTGraphEngine
from ..core.bucketing import CPBuckets, DEFAULT_BUCKETS, ShapeBuckets
from ..core.comm import node_local_rounds, ring_round
from ..core.page_table import KVSpillError
from ..core.scheduler import BaseScheduler, DualBalancedScheduler
from ..core.state import ClusterState, Request
from ..kernels import quant
from ..models import transformer


@dataclass
class GenResult:
    rid: int
    prompt: list
    tokens: list = field(default_factory=list)
    # True when the request was finished early by a clean request-level OOM
    # (KV spill with no shard headroom anywhere to escalate into)
    oom: bool = False
    # failure-recovery outcome: None = never touched by an instance failure;
    # True = recovered (lost ranges re-prefilled: tokens equal a
    # from-scratch run); False = degraded finish (no headroom: finished
    # early with the tokens it had, a prefix of a from-scratch run)
    recovered: bool | None = None


@dataclass
class _Inflight:
    """One dispatched-but-unharvested decode iteration."""
    host: torch.Tensor           # [I, M] tokens (pinned on CUDA), filled async
    event: object                # CUDA event recorded after the copy, or None
    # (rid, request, instance, slot, is_last) snapshot at dispatch time
    slots: list
    # rid -> the instances this iteration touched for the request (its KV
    # shard holders and its slot's instance) at dispatch: the blast radius
    # of an instance failure between dispatch and harvest
    holders: dict = field(default_factory=dict)
    # [I, M, V] device logits when the engine keeps them, else None (a
    # graph's static logits: read at harvest, before the next replay)
    logits: object = None


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet "
                               f"(ROADMAP queue 1 item {item})")


class NanoCPEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *,
                 num_instances: int, instances_per_node: int,
                 kv_capacity_tokens: int, tp: int, page_size: int = 16,
                 backend: str = "routed",
                 scheduler: BaseScheduler | None = None,
                 buckets: CPBuckets = DEFAULT_BUCKETS,
                 shape_buckets: ShapeBuckets | None = None,
                 eos_token: int | None = None,
                 max_slots_per_instance: int = 16,
                 pipeline: bool = True,
                 audit_donation_every_step: bool = False,
                 admission=None, prefix_cache: bool = False,
                 prefill_cells: int = 0, kv_dtype: str = "bf16",
                 keep_logits: bool = False, device="cuda",
                 cuda_graphs: bool | None = None):
        """``params``: prefill params (``models.transformer`` layout) on
        ``device``.  The virtual mesh is ``num_instances`` x ``tp``.  Pools
        are float32, as the reference engine allocates them, or fp8/int8
        codes with per-page scales for ``kv_dtype`` "fp8"/"int8".
        ``cuda_graphs``: replay one CUDA graph per bucket (the default on
        CUDA; asking for it on the CPU raises) or, False, dispatch the
        step eagerly."""
        transformer.check_supported(cfg)
        quant.check_kv_dtype(kv_dtype)
        if admission is not None:
            raise _not_ported("SLO admission control", 13)
        if prefix_cache:
            raise _not_ported("the prefix cache", 13)
        if prefill_cells:
            raise _not_ported("disaggregated prefill cells", 13)
        self.device = resolve_device(device)
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA engine, got "
                             f"device {self.device}")
        self.cfg = cfg
        self.tp = tp
        self.keep_logits = keep_logits
        self.step_logits: dict = {}
        self.eos = eos_token
        self.pipeline = pipeline
        _, _, ps = dcp.attn_tp_geometry(cfg, tp)
        self.cluster = ClusterState(num_instances=num_instances,
                                    instances_per_node=instances_per_node,
                                    kv_capacity_tokens=kv_capacity_tokens,
                                    page_size=page_size, kv_stripes=ps)
        self.scheduler = scheduler or DualBalancedScheduler(
            buckets=buckets, allow_rebalance=True,
            max_batch_per_instance=max_slots_per_instance, has_kv=True,
            # one decode page of growth headroom on every MoE binding at
            # admission so the first appended tokens never spill
            kv_reserve=page_size, allow_escalation=True)
        self.scheduler.prefix_cache = None
        # the data plane's rotation window is the CLUSTER ring
        ring = self.cluster.window
        self.shape_buckets = shape_buckets or ShapeBuckets(window=ring)
        self.params = params
        self._dims0 = dcp.DecodeDims(
            M=max_slots_per_instance, S=0, N=1, MB=4, W=ring,
            num_frames=self.cluster.page_table.frames_per_instance + 1,
            page=page_size, data_size=num_instances, tp=tp, backend=backend,
            eos=-1 if eos_token is None else int(eos_token),
            kv_dtype=kv_dtype)
        self.decode_params = dcp.to_decode_params(cfg, params, tp)
        self.state = dcp.init_serve_state(cfg, self._dims0, num_instances,
                                          dtype=torch.float32,
                                          device=self.device)
        # quantized engines tag every bucket key with the kv dtype, as the
        # reference does (their serve states differ from a bf16 engine's)
        self.aot = AOTGraphEngine(self._build_step,
                                  audit_every_step=audit_donation_every_step,
                                  r_ladder=self._r_ladder(ring,
                                                          instances_per_node),
                                  key_tag=(kv_dtype if
                                           quant.is_quantized(kv_dtype)
                                           else None),
                                  graph_inputs=(self._graph_inputs
                                                if cuda_graphs else None))
        self._scatter = migrate.PrefillScatter(cfg, self._dims0, num_instances)
        self._reshard = migrate.KVReshard(self._scatter)
        self._arena = routing.TableArena()
        self._dev_tables = routing.DeviceTables(self.device)
        self._tok_host: dict = {}        # [I, M] shape -> pinned host buffer
        self._event = (torch.cuda.Event() if self.device.type == "cuda"
                       else None)
        self.next_tok: dict = {}
        self.results: dict = {}
        self._prompts: dict = {}
        self.finished: list = []
        self.iterations = 0
        self._inflight: _Inflight | None = None
        self._t0 = time.monotonic()
        # hot-path introspection (tests, chip_smoke.py)
        self.timings: dict = {}
        self.last_bucket: tuple | None = None
        self.last_rounds_used: int = 0
        # rows per MoE binding (B_s) of the last dispatched step's plan
        self.last_batch_sizes: np.ndarray | None = None
        self.hot_path_stats: dict = {
            "steps": 0, "async_token_fetches": 0, "speculative_slots": 0,
            "prefill_eos_finishes": 0, "escalations": 0, "relaxations": 0,
            "relax_tokens": 0, "reshard_tokens": 0, "spill_escalations": 0,
            "oom_finishes": 0, "drains": 0, "compacts": 0, "failures": 0,
            "recovered_tokens": 0, "reprefill_tokens": 0,
            "degraded_finishes": 0, "joins": 0}

    # ------------------------------------------------------------------ #
    @staticmethod
    def _r_ladder(ring: int, node_width: int) -> tuple | None:
        """Quantisation grid for rounds-used: pow2 steps plus the node-local
        bound (and the full ring as the ceiling)."""
        if ring <= 1:
            return None
        lad = {1, ring - 1}
        v = 1
        while v < ring - 1:
            v *= 2
            lad.add(v)
        nl = node_local_rounds(node_width)
        if nl >= 1:
            lad.add(nl)
        return tuple(sorted(g for g in lad if 1 <= g <= ring - 1))

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def add_request(self, prompt_tokens, max_new_tokens: int,
                    now: float | None = None) -> int:
        now = self._now() if now is None else now
        rid = len(self._prompts)
        self._prompts[rid] = list(map(int, prompt_tokens))
        self.cluster.enqueue(Request(rid=rid, prompt_len=len(prompt_tokens),
                                     max_new_tokens=max_new_tokens,
                                     arrival=now), now)
        self.results[rid] = GenResult(rid, self._prompts[rid])
        return rid

    # -- reference entry points outside the main path ------------------- #
    def add_audio_request(self, *args, **kwargs):
        raise _not_ported("encoder-decoder (whisper) serving", 12)

    def fork_request(self, parent_rid: int, max_new_tokens: int, **kwargs):
        raise _not_ported("request fork (prefix-cache CoW)", 13)

    # ------------------------------------------------------------------ #
    def _build_step(self, key):
        M, S, MB, W, R = key[:5]
        N = M + (W - 1) * S
        d = dcp.DecodeDims(M=M, S=S, N=N, MB=MB, W=W,
                           num_frames=self._dims0.num_frames,
                           page=self._dims0.page,
                           data_size=self.cluster.num_instances, tp=self.tp,
                           backend=self._dims0.backend, eos=self._dims0.eos,
                           rounds_used=R, kv_dtype=self._dims0.kv_dtype)
        I = self.cluster.num_instances
        table_shapes = {
            "slot_rid": (I, M), "slot_token": (I, M), "slot_pos": (I, M),
            "slot_active": (I, M), "append_frame": (I, M),
            "append_off": (I, M), "q_send_idx": (I, W - 1, S),
            "q_recv_slot": (I, W - 1, S), "work_src": (I, N),
            "work_bt": (I, N, MB), "work_len": (I, N),
            "ret_send_idx": (I, W - 1, S), "merge_src": (I, M, W),
            "merge_round": (I, M, W), "merge_peer_row": (I, M, W),
        }
        return dcp.build_decode_step(self.cfg, d), table_shapes

    def _graph_inputs(self, table_shapes: dict):
        """What a bucket's graph captures: the decode params, the serve
        state and the table buffers of the bucket's shapes."""
        return (self.decode_params, self.state,
                self._dev_tables.buffers(table_shapes))

    def close(self) -> None:
        """Release the step cache (the CUDA graphs and their pool)."""
        self.aot.clear()

    # ------------------------------------------------------------------ #
    def _prefill_batch(self, reqs: list, now: float) -> list:
        """Prefill admitted requests (flash kernel on CUDA) and scatter their
        KV into the pools with ONE in-place call.  The first generated token
        is sampled from the prefill logits; one batched readback serves the
        whole batch.  Returns the requests finished by a prefill-EOS."""
        ps, khs = self._scatter.ps, self._scatter.khs
        page = self._dims0.page
        kv_k, kv_v, kv_coords, firsts = [], [], [], []
        for req in reqs:
            toks = torch.as_tensor(self._prompts[req.rid],
                                   device=self.device)[None, :]
            logits, caches = transformer.forward(self.cfg, self.params, toks,
                                                 collect_kv=True,
                                                 device=self.device)
            firsts.append(logits[0, -1].argmax())
            a = torch.stack([c["kv"][0][:, 0] for c in caches], dim=1)
            b = torch.stack([c["kv"][1][:, 0] for c in caches], dim=1)
            if self.cfg.is_mla:
                # [nb, na, T, 1, kvr + dr]: MLA's single latent "head"
                kv_k.append(torch.cat([a, b], dim=-1)[..., None, :])
            else:
                # [nb, na, T, Hkv, hd] -> khs groups of kg heads (flattened)
                kv_k.append(a.reshape(*a.shape[:3], khs, -1))
                kv_v.append(b.reshape(*b.shape[:3], khs, -1))
            kv_coords.append(migrate.prefill_coords(self.cluster, req.rid,
                                                    page, ps))
        eos_done = self._record_first_tokens(
            reqs, torch.stack(firsts).tolist(), now)
        self._scatter.scatter_kv(self.state, torch.cat(kv_k, dim=2),
                                 torch.cat(kv_v, dim=2) if kv_v else None,
                                 np.concatenate(kv_coords, axis=1))
        return self._finish_prefill_eos(eos_done, now)

    def _record_first_tokens(self, reqs: list, firsts: list, now: float):
        """Record the prefill-sampled first tokens; returns the requests
        whose first token is already EOS."""
        eos_done = []
        for req, first in zip(reqs, firsts):
            first = int(first)
            self.next_tok[req.rid] = first
            self.results[req.rid].tokens.append(first)
            req.token_times.append(now)
            if self.eos is not None and first == self.eos:
                eos_done.append(req)
        return eos_done

    def _finish_prefill_eos(self, reqs: list, now: float) -> list:
        """EOS sampled straight from the prefill logits: the request is done
        before its first decode iteration (zero decode KV appends)."""
        for req in reqs:
            self.cluster.finish(req, now)
            self.finished.append(req)
            self.hot_path_stats["prefill_eos_finishes"] += 1
        return reqs

    def _apply_escalations(self, escalations: list) -> None:
        """Move the KV of this step's escalations and relaxations (their
        page-table bookkeeping already happened inside the scheduler) with
        one batched in-place re-shard, before this step's admissions
        scatter into possibly just-freed frames."""
        if not escalations:
            return
        t0 = time.perf_counter()
        src = np.concatenate([e.src_coords for e in escalations], axis=1)
        dst = np.concatenate([e.dst_coords for e in escalations], axis=1)
        self._reshard(self.state, src, dst)
        relaxed = [e for e in escalations
                   if getattr(e, "is_relaxation", False)]
        self.hot_path_stats["escalations"] += len(escalations) - len(relaxed)
        self.hot_path_stats["relaxations"] += len(relaxed)
        self.hot_path_stats["relax_tokens"] += sum(e.tokens_moved
                                                   for e in relaxed)
        self.hot_path_stats["reshard_tokens"] += int(src.shape[1])
        self.timings["reshard_us"] = (self.timings.get("reshard_us", 0.0)
                                      + (time.perf_counter() - t0) * 1e6)

    def _handle_spill(self, err: KVSpillError, now: float) -> list:
        """A decode append overran its shard at table lowering: escalate the
        spilled request onto shards with headroom, or, when no shard in the
        node can take the KV, finish it with a clean request-level OOM.
        (The reference first evicts prefix-cache replicas on the spilled
        instance; without the prefix cache there are none.)  Returns the
        requests finished here (empty when relief worked)."""
        escs = self.scheduler.relieve_spill(self.cluster, err.rid,
                                            err.instance)
        if escs:
            self._apply_escalations(escs)
            self.hot_path_stats["spill_escalations"] += len(escs)
            return []
        req = self.cluster.active.get(err.rid)
        if req is None:
            return []
        self.results[err.rid].oom = True
        self.cluster.finish(req, now)
        req.status = "oom"
        self.finished.append(req)
        self.hot_path_stats["oom_finishes"] += 1
        return [req]

    def drain_instance(self, instance: int, force: bool = False) -> list:
        """Planned drain (live migration, zero data loss): evacuate every
        request's resident KV off ``instance`` through the re-shard, mark
        the instance dead, and rebalance MoE bindings off it.  The drained
        instance's requests keep decoding with unchanged tokens.  Raises
        ``MemoryError`` (instance left serving, page table untouched) when
        the cluster cannot take its KV.

        ``force=True`` is the drain-deadline fallback: requests whose KV
        cannot be evacuated take fail semantics (their KV on the instance
        is dropped and recovered: re-prefill or a degraded finish), so a
        forced drain always completes with the instance empty and dead."""
        # dead first so the evacuation planner never picks it as a receiver;
        # rolled back when evacuate raises
        self.cluster.dead_instances.add(instance)
        stragglers = []
        try:
            if force:
                escalations, stragglers = self.scheduler.evacuate(
                    self.cluster, instance, partial=True)
            else:
                escalations = self.scheduler.evacuate(self.cluster, instance)
        except MemoryError:
            self.cluster.dead_instances.discard(instance)
            raise
        self._apply_escalations(escalations)
        if stragglers:
            # a planned drop, not a crash: the in-flight iteration stays
            # valid, so only the cluster-level partial drop runs and the
            # lost ranges re-prefill or degrade as after a crash
            self._recover(self.cluster.fail_instance(instance), self._now())
        self.scheduler.rebalance(self.cluster)
        self.hot_path_stats["drains"] += 1
        return escalations

    # ------------------------------------------------------------------ #
    def fail_instance(self, instance: int, now: float | None = None) -> list:
        """Abrupt instance failure (crash semantics), safe at any point of
        the pipelined loop, between dispatch and harvest included.

        (1) The in-flight entries whose computation touched the dead
        instance (a KV shard or the decode slot lived there) are voided and
        their dispatch-time bookkeeping rolled back, so no token of the dead
        instance is applied and no slot is freed twice; (2)
        ``ClusterState.fail_instance`` frees only the dead instance's frames
        and reports the lost token ranges; (3) each affected request is
        recovered by re-prefilling just those ranges into a replacement
        placement, or finishes degraded when the cluster lacks headroom.
        Returns the requests finished (degraded) here."""
        now = self._now() if now is None else now
        cl = self.cluster
        if not 0 <= instance < cl.num_instances:
            raise ValueError(f"fail_instance({instance}): the engine's mesh "
                             f"has {cl.num_instances} instances")
        if instance in cl.dead_instances:
            return []
        self.hot_path_stats["failures"] += 1
        infl = self._inflight
        if infl is not None:
            keep = []
            for ent in infl.slots:
                rid, req, i, b, last = ent
                if i != instance and instance not in infl.holders.get(
                        rid, frozenset()):
                    keep.append(ent)
                    continue
                # void the speculative result; the next dispatch derives the
                # same token again from next_tok
                req.generated -= 1
                if last:
                    # length-finished at dispatch, pages and slot already
                    # freed: resurrect it; its whole context is lost now,
                    # and recovery below re-prefills (or degrades) it
                    cl.finished.remove(req)
                    req.status = "running"
                    req.finish_time = -1.0
                    cl.active[rid] = req
                    if (req.moe_binding >= 0 and req.moe_binding != instance
                            and req.moe_binding not in cl.dead_instances):
                        cl.move_slot(rid, req.moe_binding)
                else:
                    # un-append this step's input token (i is the
                    # dispatch-time MoE shard)
                    cl.page_table.pop_token(rid, i)
            infl.slots = keep
        return self._recover(cl.fail_instance(instance), now)

    def _recover(self, records: list, now: float) -> list:
        """Typed recovery of ``ClusterState.fail_instance`` records:
        re-prefill of the lost ranges into a replacement WaterFill
        placement, or a degraded finish.  Returns the requests finished
        (degraded) here."""
        cl = self.cluster
        pt = cl.page_table
        ledger = {s: pt.free_frames(s) for s in cl.alive_instances()}
        items, finished = [], []
        for rec in records:
            req = rec.req
            rid = req.rid
            if rid not in cl.active:
                continue
            resident = sum(pt.shard_tokens(rid).values())
            ranges = list(rec.lost)
            if resident == 0 and not ranges and req.length > 0:
                # nothing survived anywhere (or the request was resurrected
                # from a dispatch-time finish): the whole context is lost
                ranges = [(0, req.prompt_len + req.generated)]
            lost = sum(n for _, n in ranges)
            split = None
            ok = req.moe_binding >= 0
            if ok and lost > 0:
                split = self.scheduler.place_recovery(cl, req, lost, ledger)
                ok = split is not None
            if not ok:
                # degraded finish: complete now with the tokens it has; a
                # failure never hangs a request or leaks its frames
                self.results[rid].recovered = False
                if self._inflight is not None:
                    self._inflight.slots = [e for e in self._inflight.slots
                                            if e[0] != rid]
                cl.finish(req, now)
                req.status = "degraded"
                self.finished.append(req)
                finished.append(req)
                self.hot_path_stats["degraded_finishes"] += 1
                continue
            if lost == 0:
                continue                 # only the binding/slot was touched
            self.results[rid].recovered = True
            self.hot_path_stats["recovered_tokens"] += resident
            self.hot_path_stats["reprefill_tokens"] += lost
            positions, coords = pt.restore_ranges(rid, split, ranges)
            req.kv_binding = sorted(set(req.kv_binding) | set(split)
                                    | {req.moe_binding})
            items.append((req, positions, coords))
        if items:
            self._reprefill_ranges(items)
        return finished

    def _reprefill_ranges(self, items: list) -> None:
        """Re-prefill only the lost token ranges of each recovering request:
        the prefill forward over prompt + every token recorded so far (all
        of its KV positions, at any pipeline point), its KV at the lost
        positions scattered in place into the replacement placement with
        one call.  Surviving shards are never read or rewritten; MLA
        re-prefills its latent."""
        ps, khs = self._scatter.ps, self._scatter.khs
        kv_k, kv_v, kv_coords = [], [], []
        for req, positions, coords in items:
            seq = self._prompts[req.rid] + self.results[req.rid].tokens
            toks = torch.as_tensor(seq, device=self.device)[None, :]
            _, caches = transformer.forward(self.cfg, self.params, toks,
                                            collect_kv=True,
                                            device=self.device)
            pos = torch.as_tensor(positions, device=self.device)
            a = torch.stack([c["kv"][0][:, 0] for c in caches], dim=1)[:, :, pos]
            b = torch.stack([c["kv"][1][:, 0] for c in caches], dim=1)[:, :, pos]
            if self.cfg.is_mla:
                kv_k.append(torch.cat([a, b], dim=-1)[..., None, :])
            else:
                kv_k.append(a.reshape(*a.shape[:3], khs, -1))
                kv_v.append(b.reshape(*b.shape[:3], khs, -1))
            inst, frame, off = coords
            kv_coords.append(np.stack([inst, frame % ps, frame // ps, off]))
        self._scatter.scatter_kv(self.state, torch.cat(kv_k, dim=2),
                                 torch.cat(kv_v, dim=2) if kv_v else None,
                                 np.concatenate(kv_coords, axis=1))

    def join_instance(self, instance: int, prewarm: bool = True) -> None:
        """Elastic scale-up: a failed or drained instance of the engine's
        mesh (fixed at construction) re-enters the zig-zag ring with a
        fresh pool; relaxation and escalation then spread load onto it.
        ``prewarm`` captures the buckets the wider ring reach makes
        reachable off the hot path, so recruiting the joiner replays a
        graph instead of capturing one."""
        cl = self.cluster
        if not 0 <= instance < cl.num_instances:
            raise ValueError(f"join_instance({instance}): the engine's mesh "
                             f"has {cl.num_instances} instances")
        cl.join_instance(instance)
        self.hot_path_stats["joins"] += 1
        if prewarm:
            self._prewarm_join(instance)

    def _prewarm_join(self, instance: int) -> None:
        """Capture each cached bucket at the ring reach the joiner adds (the
        most zig-zag rounds between it and an alive peer of its window
        segment)."""
        cl = self.cluster
        win = cl.window
        need = 0
        for p in cl.alive_instances():
            if p != instance and p // win == instance // win:
                need = max(need, ring_round(instance - p, win),
                           ring_round(p - instance, win))
        if need <= 0:
            return
        have = set(self.aot.cached_keys())
        new_keys = []
        for key in sorted(have, key=lambda k: k[:5]):
            M, S, MB, W, R = key[:5]
            if S == 0:
                continue
            k2 = self.aot.quantise(M, S, MB, W, max(R, need))
            if k2 not in have and k2 not in new_keys:
                new_keys.append(k2)
        self.aot.capture(new_keys)

    def compact(self) -> list:
        """Planned maintenance, the relaxation twin of ``drain_instance``:
        one forced cluster-wide relaxation pass (de-escalate bindings wider
        than their bucket degree, consolidate tail pages back onto the MoE
        binding; the cooldown is overridden, the headroom guard band is
        not), with the live re-shard applied now."""
        records = self.scheduler.relax(self.cluster, force=True)
        self._apply_escalations(records)
        self.hot_path_stats["compacts"] += 1
        return records

    @staticmethod
    def _check_plan(plan) -> None:
        """Besides admissions, escalations and relaxations, the scheduler's
        plans need movement paths that are not ported yet."""
        if plan.copies:
            raise _not_ported("data-plane KV copies (CoW / hot-prefix "
                              "replication)", 13)
        if plan.staged:
            raise _not_ported("prefill-cell staging", 13)
        if plan.rejected or plan.shed or plan.preemptions:
            raise _not_ported("SLO admission outcomes", 13)

    # ------------------------------------------------------------------ #
    def _harvest(self, now: float) -> list:
        """Wait for the in-flight iteration's tokens (copied to the host at
        dispatch), record them, and apply finishes."""
        infl = self._inflight
        if infl is None:
            return []
        self._inflight = None
        t0 = time.perf_counter()
        if infl.event is not None:
            infl.event.synchronize()
        toks = infl.host.numpy()
        logits = None if infl.logits is None else infl.logits.cpu().numpy()
        self.timings["harvest_us"] = (time.perf_counter() - t0) * 1e6
        self.hot_path_stats["async_token_fetches"] += 1
        done = []
        for rid, req, i, b, last in infl.slots:
            t = int(toks[i, b])
            self.results[rid].tokens.append(t)
            self.next_tok[rid] = t
            if logits is not None:
                self.step_logits.setdefault(rid, []).append(logits[i, b])
            req.token_times.append(now)
            if last:
                req.finish_time = now
                self.finished.append(req)
                done.append(req)
            elif self.eos is not None and t == self.eos:
                # under the lookahead pipeline the request is already
                # lowered into the next iteration: one speculative slot whose
                # input is patched to the stop token (device-side mask)
                if rid in self.cluster.active:
                    self.cluster.finish(req, now)
                    if self.pipeline:
                        self.hot_path_stats["speculative_slots"] += 1
                    self.finished.append(req)
                    done.append(req)
        return done

    def _start_token_copy(self, toks: torch.Tensor):
        """Device tokens -> host: pinned buffer + non-blocking copy + event
        on CUDA; the CPU result is already on the host."""
        if self.device.type != "cuda":
            return toks, None
        host = self._tok_host.get(tuple(toks.shape))
        if host is None:
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            self._tok_host[tuple(toks.shape)] = host
        host.copy_(toks, non_blocking=True)
        self._event.record()
        return host, self._event

    # ------------------------------------------------------------------ #
    def step(self, now: float | None = None) -> list:
        """One scheduling+decode iteration, pipelined one step ahead.

        Order: schedule -> prefill + in-place scatter -> lower routing
        tables -> harvest the in-flight iteration's tokens -> patch input
        tokens -> upload tables -> dispatch this iteration.  Returns the
        requests whose completion became visible during this call.
        """
        t_step = time.perf_counter()
        now = self._now() if now is None else now
        self.timings = {}
        plan = self.scheduler.schedule(self.cluster, now)
        self._check_plan(plan)
        self._apply_escalations(plan.escalations + plan.relaxations)
        prefill_done = []
        if plan.admitted:
            t0 = time.perf_counter()
            prefill_done = self._prefill_batch(plan.admitted, now)
            self.timings["prefill_us"] = (time.perf_counter() - t0) * 1e6
        if not self.cluster.active:
            return prefill_done + self._harvest(now)

        # -- lower THIS iteration's tables while the device computes the
        #    previous one (routing never depends on token VALUES).  A typed
        #    KV spill surfaces here, page table untouched: relieve it
        #    (escalate, or OOM-finish the request) and lower again ---------
        t0 = time.perf_counter()
        spill_done = []
        attempts = len(self.cluster.active) + 1
        while True:
            try:
                tbl = routing.lower_plan(self.cluster, plan,
                                         buckets=self.shape_buckets,
                                         append_tokens=True,
                                         next_tokens=self.next_tok,
                                         arena=self._arena)
                break
            except KVSpillError as err:
                attempts -= 1
                if attempts <= 0:
                    raise
                spill_done += self._handle_spill(err, now)
                if not self.cluster.active:
                    return prefill_done + spill_done + self._harvest(now)
        key = self.aot.quantise(tbl.M, tbl.S, tbl.MB, tbl.W, tbl.R)
        if key[2] != tbl.MB:
            raise RuntimeError(f"bucket MB {key[2]} != table MB {tbl.MB}")
        self.timings["lower_us"] = (time.perf_counter() - t0) * 1e6
        t0 = time.perf_counter()
        fn = self.aot.lookup_key(key)
        self.timings["lookup_us"] = (time.perf_counter() - t0) * 1e6

        # -- harvest the previous iteration ---------------------------------
        slots_at_lower = ({rid: self.cluster.slot_map[rid]
                           for rid in self.cluster.active}
                          if self.eos is not None and self.pipeline else None)
        done = prefill_done + spill_done + self._harvest(now)

        # -- patch per-slot input tokens now that they are all known -------
        for rid in self.cluster.active:
            i, b = self.cluster.slot_map[rid]
            tbl.slot_token[i, b] = self.next_tok[rid]
        if slots_at_lower is not None:
            # EOS finishes discovered at this harvest are already lowered
            # into THIS iteration: feed the stop token as their input so the
            # device-side check masks the KV append and the sampled output
            for req in done:
                loc = slots_at_lower.get(req.rid)
                if loc is not None:
                    tbl.slot_token[loc[0], loc[1]] = self.eos
        t0 = time.perf_counter()
        tbl_dev = routing.as_device_arrays(tbl, self._dev_tables)
        self.timings["tables_us"] = (time.perf_counter() - t0) * 1e6

        # -- dispatch (async on CUDA) + start the token readback copy -------
        t0 = time.perf_counter()
        check = self.aot.should_audit_donation()
        in_ptrs = self.aot.buffer_ptrs(self.state) if check else None
        self.state, toks, step_logits = fn(self.decode_params, self.state,
                                           tbl_dev)
        host, event = self._start_token_copy(toks)
        self.timings["dispatch_us"] = (time.perf_counter() - t0) * 1e6
        if check:
            self.aot.note_donation(in_ptrs, self.state)

        # -- dispatch-time bookkeeping: length-based finishes are
        #    deterministic, so free their pages/slots right away ------------
        snapshot, length_done, holders = [], [], {}
        pt = self.cluster.page_table
        for rid in list(self.cluster.active):
            req = self.cluster.active[rid]
            i, b = self.cluster.slot_map[rid]
            req.generated += 1
            last = len(self.results[rid].tokens) + 1 >= req.max_new_tokens
            snapshot.append((rid, req, i, b, last))
            # recorded before length finishes free the pages
            holders[rid] = frozenset(
                s for s, t in pt.shard_tokens(rid).items() if t > 0) | {i}
            if last:
                length_done.append(req)
        for req in length_done:
            self.cluster.finish(req, now)
        self._inflight = _Inflight(host, event, snapshot, holders,
                                   step_logits if self.keep_logits else None)
        self.iterations += 1
        self.last_bucket = key
        self.last_rounds_used = tbl.R
        self.last_batch_sizes = plan.batch_sizes()
        self.hot_path_stats["steps"] += 1
        if not self.pipeline:
            done += self._harvest(now)
        self.timings["step_us"] = (time.perf_counter() - t_step) * 1e6
        return done

    @property
    def pending(self) -> bool:
        """Whether requests are waiting, decoding or not yet harvested."""
        return bool(self.cluster.active or self.cluster.waiting
                    or self._inflight is not None)

    def run(self, max_iters: int = 1000) -> dict:
        it = 0
        while self.pending and it < max_iters:
            self.step()
            it += 1
        return self.results
