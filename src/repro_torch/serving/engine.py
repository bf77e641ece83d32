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

Serving features: SLO admission control (``admission=``, an
``AdmissionController`` set on the scheduler; rejected and shed requests
finish as typed outcomes, ``GenResult.rejected`` / ``shed``); the global
copy-on-write prefix cache (``prefix_cache=True``: a hit attaches cached
frames and scatters only the novel suffix, though the prefill forward
still covers the whole prompt; ``fork_request``; shared tails are split
before any append; spill relief evicts cache replicas first); and
disaggregated prefill cells (``prefill_cells=``: the tail instances run
chunked prefill, each chunk a causal forward over ``[0, end)`` whose rows
``[end - chunk_tokens, end)`` scatter straight into the decode
destinations).  Every such write lands in place in the captured pools.

SSM and hybrid models (Mamba-2, Jamba): each request's SSM state lives in
its decode slot, written by the prefill (``PrefillScatter.scatter_ssm``)
and advanced in place by every step.  The slot is pinned: one fixed M
bucket, no MoE-binding rebalance, and ``drain_instance`` refuses with
``UnsupportedDrainError``, leaving the cluster untouched.  A crash that
loses a request's slot finishes it degraded; Jamba KV lost elsewhere is
re-prefilled (its KV only).  Mamba-2 has no KV: no appends, no escalation,
no pools.  The prefix cache and prefill cells need KV appends, and
``fork_request`` a slot that can move, as in the reference.

Encoder-decoder models (whisper) take audio requests
(``add_audio_request``: stub frame embeddings and a decoder prefix).  The
prefill encodes the frames (one batched ``encode`` per group of
same-shape frame stacks), runs the decoder prefix teacher-forced, and
scatters the cross-attention KV into the paged cross pools by its DCP
placement (long audio spreads over CP degree 2-3) and the prefix's
self-attention KV into the slot's contiguous cache.  Decode never appends
to the cross pools, so nothing grows: no escalation, and with it no
relaxation, and the slots are pinned (their self caches live there).  A
request that loses KV to an instance failure finishes degraded.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core import dcp, migrate, routing
from ..core.aot import AOTGraphEngine
from ..core.bucketing import CPBuckets, DEFAULT_BUCKETS, ShapeBuckets
from ..core.comm import node_local_rounds, ring_round
from ..core.handoff import HandoffTask
from ..core.page_table import KVSpillError
from ..core.prefix import PrefixTrie, page_keys
from ..core.scheduler import BaseScheduler, DualBalancedScheduler
from ..core.state import ClusterState, Request
from ..kernels import quant
from ..models import encdec, transformer
from ..models import moe as moe_mod
from .trace import Tracer


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
    # admission-control outcomes: the request never ran (no tokens); it
    # bounced off a full queue (rejected) or its TTFT deadline expired
    # while queued (shed).  Both are typed finishes, never a silent drop.
    rejected: bool = False
    shed: bool = False


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
    # tracing on: (the step's expert bins [L_moe, I, E] copied to the host
    # with the tokens, dispatch stamp, step, capacity C) for the counter
    bins: tuple | None = None


class UnsupportedDrainError(RuntimeError):
    """``drain_instance`` on an arch whose per-slot device state (the SSM
    recurrent state, whisper's self-attention caches) cannot move with the
    slot: a graceful drain would corrupt it, so the engine refuses and
    leaves the cluster untouched.  ``fail_instance`` (crash semantics: the
    affected requests degrade) stays available."""


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
                 prefill_cells: int = 0, chunk_tokens: int | None = None,
                 kv_dtype: str = "bf16", keep_logits: bool = False,
                 device="cuda", cuda_graphs: bool | None = None):
        """``params``: prefill params (``models.transformer`` layout) on
        ``device``.  The virtual mesh is ``num_instances`` x ``tp``.  Pools
        are float32, as the reference engine allocates them, or fp8/int8
        codes with per-page scales for ``kv_dtype`` "fp8"/"int8".
        ``cuda_graphs``: replay one CUDA graph per bucket (the default on
        CUDA; asking for it on the CPU raises) or, False, dispatch the
        step eagerly.  ``admission``: an ``AdmissionController`` for the
        scheduler.  ``prefix_cache``: the global CoW prefix cache.
        ``prefill_cells``: that many tail instances run chunked prefill
        only, in chunks of ``chunk_tokens`` (a positive page multiple,
        default four pages).  SSM and hybrid models pin their slots: the
        step takes the one M bucket ``max_slots_per_instance`` unless
        ``shape_buckets`` says otherwise.  An encoder-decoder model
        (``models/encdec.py`` params) pins its slots to exactly that one
        bucket."""
        self.is_encdec = cfg.is_encoder_decoder
        if not self.is_encdec:
            transformer.check_supported(cfg)
        quant.check_kv_dtype(kv_dtype)
        # decode appends KV only where there is attention, and never to
        # whisper's read-only cross pools; per-slot SSM state and whisper's
        # self-attention caches pin the slot dimension of the serve state
        self._append_tokens = cfg.has_attention and not self.is_encdec
        self._pinned_slots = (cfg.family in ("ssm", "hybrid")
                              or self.is_encdec)
        if quant.is_quantized(kv_dtype) and not self._append_tokens:
            raise ValueError("quantized KV pools need a decoder-side paged "
                             f"attention pool; {cfg.name} has none")
        if prefix_cache and not self._append_tokens:
            raise ValueError("prefix_cache needs an attention arch")
        if prefill_cells and not (self._append_tokens
                                  and not self._pinned_slots):
            raise ValueError("prefill cells need a decoder-only attention "
                             "arch without pinned per-slot state")
        self.chunk_tokens = chunk_tokens or 4 * page_size
        if self.chunk_tokens <= 0 or self.chunk_tokens % page_size:
            raise ValueError(f"chunk_tokens must be a positive page multiple "
                             f"(got {self.chunk_tokens}, page {page_size})")
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
                                    page_size=page_size, kv_stripes=ps,
                                    prefill_cells=prefill_cells)
        self.scheduler = scheduler or DualBalancedScheduler(
            buckets=buckets, allow_rebalance=not self._pinned_slots,
            max_batch_per_instance=max_slots_per_instance,
            has_kv=cfg.has_attention,
            # one decode page of growth headroom on every MoE binding at
            # admission so the first appended tokens never spill
            kv_reserve=page_size if self._append_tokens else 0,
            allow_escalation=self._append_tokens)
        if not self._append_tokens:
            # nothing grows without KV appends: a caller's scheduler must
            # not escalate (nor, with it, relax) either
            self.scheduler.allow_escalation = False
        if admission is not None:
            self.scheduler.admission = admission
        self.prefix_trie = PrefixTrie(page_size) if prefix_cache else None
        self.scheduler.prefix_cache = self.prefix_trie
        # prefill cells: rid -> HandoffTask of a request parked in
        # cluster.prefilling; per-cell FIFO of rids owed chunk forwards; the
        # first token (device scalar) kept until its handoff completes
        self._handoff: dict = {}
        self._cell_queue: dict = {}
        self._first_tok: dict = {}
        self._cp_buckets = (getattr(self.scheduler, "buckets", None)
                            or CPBuckets(edges=(), degrees=(1,)))
        # the data plane's rotation window is the CLUSTER ring
        ring = self.cluster.window
        if shape_buckets is None and self._pinned_slots:
            shape_buckets = ShapeBuckets(m_buckets=(max_slots_per_instance,),
                                         window=ring)
        self.shape_buckets = shape_buckets or ShapeBuckets(window=ring)
        if (self.is_encdec
                and self.shape_buckets.m_buckets != (max_slots_per_instance,)):
            raise ValueError(
                "whisper's self caches pin max_slots_per_instance slots: the "
                f"M buckets must be ({max_slots_per_instance},), got "
                f"{self.shape_buckets.m_buckets}")
        self.params = params
        self._dims0 = dcp.DecodeDims(
            M=max_slots_per_instance, S=0, N=1, MB=4, W=ring,
            num_frames=self.cluster.page_table.frames_per_instance + 1,
            page=page_size, data_size=num_instances, tp=tp, backend=backend,
            eos=-1 if eos_token is None else int(eos_token),
            kv_dtype=kv_dtype)
        if self.is_encdec:
            self.decode_params = dcp.to_encdec_decode_params(cfg, params, tp)
            self.state = dcp.init_encdec_serve_state(
                cfg, self._dims0, num_instances, dtype=torch.float32,
                device=self.device)
        else:
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
        self._host_bufs: dict = {}     # (shape, dtype) -> pinned host buffer
        self._event = (torch.cuda.Event() if self.device.type == "cuda"
                       else None)
        self.next_tok: dict = {}
        self.results: dict = {}
        self._prompts: dict = {}
        self._dec_prefix: dict = {}
        self.finished: list = []
        self.iterations = 0
        self._inflight: _Inflight | None = None
        self._t0 = time.monotonic()
        # spans and counters (``serving/trace.py``); off, only the current
        # step's phase durations (``timings``)
        self.tracer = Tracer()
        self.aot.span = self.tracer.span
        # request spans while tracing: the recording they belong to, how
        # much of ``finished`` they have seen, the rids whose first token
        # the open step returned, each one's ``request.prefill`` span, and
        # rid -> (first token, that span) of each request decoding
        self._traced_recording = 0
        self._traced_finishes = 0
        self._first_tokens: list = []
        self._prefill_spans: dict = {}
        self._decode_open: dict = {}
        # hot-path introspection (tests, chip_smoke.py)
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
            "degraded_finishes": 0, "joins": 0,
            "rejected": 0, "shed": 0, "preemptions": 0,
            "prefix_hit_tokens": 0, "prefix_inserts": 0, "copy_tokens": 0,
            "forks": 0, "staged": 0, "prefill_chunks": 0,
            "handoff_tokens": 0}

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

    @property
    def timings(self) -> dict:
        """The last step's phase durations in microseconds (``step_us``,
        ``prefill_us``, ``lower_us``, ``harvest_us``, ...): the tracer's
        view of the step, kept with tracing on or off."""
        return self.tracer.timings

    def add_request(self, prompt_tokens, max_new_tokens: int,
                    now: float | None = None) -> int:
        if self.is_encdec:
            raise ValueError(f"{self.cfg.name} takes audio requests "
                             "(add_audio_request)")
        now = self._now() if now is None else now
        rid = len(self._prompts)
        self._prompts[rid] = list(map(int, prompt_tokens))
        keys = (page_keys(self._prompts[rid], self._dims0.page)
                if self.prefix_trie is not None else ())
        self.cluster.enqueue(Request(rid=rid, prompt_len=len(prompt_tokens),
                                     max_new_tokens=max_new_tokens,
                                     arrival=now, prefix_keys=keys), now)
        self.results[rid] = GenResult(rid, self._prompts[rid])
        return rid

    def add_audio_request(self, frames, dec_prefix_tokens,
                          max_new_tokens: int, now: float | None = None) -> int:
        """Whisper: enqueue an audio request.  ``frames`` [S_enc, d_model]
        stub frame embeddings (the source of the DCP-placed cross-attention
        KV; S_enc is the request's prompt length), ``dec_prefix_tokens``
        the decoder prompt.  Prefix and new tokens must fit the decoder's
        learned positions."""
        if not self.is_encdec:
            raise ValueError("add_audio_request needs an encoder-decoder "
                             f"model; {self.cfg.name} is decoder-only")
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[1] != self.cfg.d_model:
            raise ValueError(f"frames must be [S_enc, {self.cfg.d_model}], "
                             f"got {frames.shape}")
        prefix = list(map(int, dec_prefix_tokens))
        if not prefix:
            raise ValueError("the decoder prefix needs at least one token")
        if len(prefix) + max_new_tokens > self.cfg.max_target_positions:
            raise ValueError(
                f"decoder prefix {len(prefix)} + {max_new_tokens} new tokens "
                f"exceed the {self.cfg.max_target_positions} learned "
                "positions")
        now = self._now() if now is None else now
        rid = len(self._prompts)
        self._prompts[rid] = frames
        self._dec_prefix[rid] = prefix
        self.cluster.enqueue(Request(rid=rid, prompt_len=len(frames),
                                     max_new_tokens=max_new_tokens,
                                     arrival=now, dec_prefix_len=len(prefix)),
                             now)
        self.results[rid] = GenResult(rid, prefix)
        return rid

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
        build = (dcp.build_encdec_decode_step if self.is_encdec
                 else dcp.build_decode_step)
        return build(self.cfg, d), table_shapes

    def _graph_inputs(self, table_shapes: dict):
        """What a bucket's graph captures: the decode params, the serve
        state and the table buffers of the bucket's shapes."""
        return (self.decode_params, self.state,
                self._dev_tables.buffers(table_shapes))

    def close(self) -> None:
        """Release the step cache (the CUDA graphs and their pool)."""
        self.aot.clear()

    # ------------------------------------------------------------------ #
    def _pool_rows(self, caches: list, sel) -> tuple:
        """A prefill forward's KV at positions ``sel`` (a slice or an index
        tensor) in the scatter's layout: k and v as [nb, na, T, khs, kg*hd]
        (the Hkv heads in khs groups of kg), or MLA's latent as
        [nb, na, T, 1, kvr + dr] with v None.  SSM layers are skipped."""
        kv = [c["kv"] for c in caches if "kv" in c]
        a = torch.stack([k[:, 0] for k, _ in kv], dim=1)[:, :, sel]
        b = torch.stack([v[:, 0] for _, v in kv], dim=1)[:, :, sel]
        if self.cfg.is_mla:
            return torch.cat([a, b], dim=-1)[..., None, :], None
        khs = self._scatter.khs
        return (a.reshape(*a.shape[:3], khs, -1),
                b.reshape(*b.shape[:3], khs, -1))

    def _scatter_rows(self, rows: list, coords: list) -> None:
        """One in-place scatter of every (k, v) of ``rows`` to its [4, T]
        coordinates."""
        self._scatter.scatter_kv(
            self.state, torch.cat([k for k, _ in rows], dim=2),
            None if rows[0][1] is None
            else torch.cat([v for _, v in rows], dim=2),
            np.concatenate(coords, axis=1))

    def _prefill_batch(self, reqs: list, now: float) -> list:
        """Prefill admitted requests (flash kernel on CUDA) and scatter their
        KV into the pools with ONE in-place call.  The forward always covers
        the full prompt; on a prefix-cache hit only the novel suffix is
        written (the attached pages already hold the same KV, since equal
        chain keys mean an equal transcript).  The first generated token is
        sampled from the prefill logits; one batched readback serves the
        whole batch.  Returns the requests finished by a prefill-EOS."""
        if self.is_encdec:
            return self._prefill_batch_encdec(reqs, now)
        ps = self._scatter.ps
        page = self._dims0.page
        rows, coords, firsts = [], [], []
        convs, hs, slots = [], [], []
        for req in reqs:
            hit = req.prefix_hit_tokens
            toks = torch.as_tensor(self._prompts[req.rid],
                                   device=self.device)[None, :]
            logits, caches = transformer.forward(self.cfg, self.params, toks,
                                                 collect_kv=True,
                                                 device=self.device)
            firsts.append(logits[0, -1].argmax())
            if self.cfg.has_attention:
                rows.append(self._pool_rows(caches, slice(hit, None)))
                coords.append(self._prompt_coords(req, hit, page, ps))
            ssm_caches = [c["ssm"] for c in caches if "ssm" in c]
            if ssm_caches:
                # [nb, n_ssm, 1, ...]: this request's final SSM states
                convs.append(torch.stack([c for c, _ in ssm_caches], dim=1))
                hs.append(torch.stack([h for _, h in ssm_caches], dim=1))
                slots.append(self.cluster.slot_map[req.rid])
        eos_done = self._record_first_tokens(
            reqs, torch.stack(firsts).tolist(), now)
        if rows:
            self._scatter_rows(rows, coords)
        if convs:
            self._scatter.scatter_ssm(self.state, torch.cat(convs, dim=2),
                                      torch.cat(hs, dim=2),
                                      np.asarray(slots, np.int64).T)
        self._register_prefixes(reqs)
        return self._finish_prefill_eos(eos_done, now)

    def _prefill_batch_encdec(self, reqs: list, now: float) -> list:
        """Whisper admission: encode the frames, run each decoder prefix
        teacher-forced, then scatter the cross-attention KV into the paged
        cross pools (DCP-placed) and the prefix's self-attention KV into the
        slots' contiguous caches, each with ONE in-place call for the batch.

        The encoder runs once per group of same-shape frame stacks, batched
        over the leading axis only, so a request's encoder states (and its
        scatters) are those of a call on it alone: bit-equal on the CPU,
        within f32 rounding on CUDA, where cuBLAS picks its GEMM by the
        batch's rows.  Returns the requests finished by a prefill-EOS."""
        cfg = self.cfg
        page = self._dims0.page
        khs, ps = self._scatter.khs, self._scatter.ps
        by_shape: dict = {}
        for req in reqs:
            by_shape.setdefault(self._prompts[req.rid].shape, []).append(req)
        enc_of = {}
        for grp in by_shape.values():
            stack = torch.as_tensor(np.stack([self._prompts[r.rid]
                                              for r in grp]),
                                    device=self.device)
            enc = encdec.encode(cfg, self.params, stack)
            for b, r in enumerate(grp):
                enc_of[r.rid] = enc[b:b + 1]
        firsts, cross, c_coords, selfs, s_coords = [], [], [], [], []
        for req in reqs:
            toks = torch.as_tensor(self._dec_prefix[req.rid],
                                   device=self.device)[None, :]
            logits, caches = encdec.decode_forward(
                cfg, self.params, toks, enc_of[req.rid], collect_kv=True)
            firsts.append(logits[0, -1].argmax())
            # [L, 1, S, Hkv, hd] -> [L, S, khs, kg*hd]
            kc, vc = (t[:, 0].reshape(t.shape[0], t.shape[2], khs, -1)
                      for t in caches["cross_kv"])
            cross.append((kc, vc))
            c_coords.append(migrate.prefill_coords(self.cluster, req.rid,
                                                   page, ps))
            # the self cache's chunk c holds head group c % khs: tile the
            # groups over the ps page stripes
            ks, vs = (t[:, 0].reshape(t.shape[0], t.shape[2], khs, -1)
                      .repeat(1, 1, ps, 1) for t in caches["self_kv"])
            selfs.append((ks, vs))
            T0 = ks.shape[1]
            inst, slot = self.cluster.slot_map[req.rid]
            s_coords.append(np.stack([np.full(T0, inst), np.full(T0, slot),
                                      np.arange(T0)]))
        eos_done = self._record_first_tokens(
            reqs, torch.stack(firsts).tolist(), now)
        for scatter, rows, coords in (
                (self._scatter.scatter_cross_kv, cross, c_coords),
                (self._scatter.scatter_self_kv, selfs, s_coords)):
            scatter(self.state, torch.cat([k for k, _ in rows], dim=1),
                    torch.cat([v for _, v in rows], dim=1),
                    np.concatenate(coords, axis=1))
        return self._finish_prefill_eos(eos_done, now)

    def _prompt_coords(self, req, hit: int, page: int, ps: int) -> np.ndarray:
        """Scatter coordinates of the prompt tokens the prefill writes: all
        of them on a cache miss (the contiguous layout of
        ``migrate.prefill_coords``), only the novel suffix on a hit (the
        attach breaks that layout, so positions resolve through the page
        table's range map)."""
        if hit == 0:
            return migrate.prefill_coords(self.cluster, req.rid, page, ps)
        c3 = self.cluster.page_table.position_coords(
            req.rid, range(hit, req.prompt_len))
        return np.stack([c3[0], c3[1] % ps, c3[1] // ps,
                         c3[2]]).astype(np.int32)

    def _register_prefixes(self, reqs: list) -> None:
        """Register the admitted requests' cacheable prompt pages in the
        trie, before any prefill-EOS finish frees the pages, so a one-shot
        request's prefix KV outlives it."""
        if self.prefix_trie is None:
            return
        pt = self.cluster.page_table
        for req in reqs:
            if req.prefix_keys:
                self.hot_path_stats["prefix_inserts"] += \
                    self.prefix_trie.insert(pt, req.rid, req.prefix_keys,
                                            req.prompt_len)
            self.hot_path_stats["prefix_hit_tokens"] += req.prefix_hit_tokens

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
        if self.tracer.on:
            self._first_tokens += [req.rid for req in reqs]
        return eos_done

    def _finish_prefill_eos(self, reqs: list, now: float) -> list:
        """EOS sampled straight from the prefill logits: the request is done
        before its first decode iteration (zero decode KV appends)."""
        for req in reqs:
            self.cluster.finish(req, now)
            self.finished.append(req)
            self.hot_path_stats["prefill_eos_finishes"] += 1
        return reqs

    # -- disaggregated prefill cells: chunked prefill, streamed handoff -- #
    def _stage_handoff(self, req: Request) -> None:
        """Open a ``HandoffTask`` for a request the scheduler staged on a
        prefill cell (``plan.staged``): its placeholder pages are allocated
        (the novel suffix on the cell, prefix-hit pages attached on their
        decode owners); this queues its chunk forwards."""
        cl = self.cluster
        p = next(i for i in req.kv_binding if cl.role_of(i) == "prefill")
        attach = tuple(i for i in req.kv_binding if i != p)
        hit = req.prefix_hit_tokens - req.prefix_hit_tokens % self._dims0.page
        self._handoff[req.rid] = HandoffTask(
            req.rid, req.prompt_len, hit, self.chunk_tokens,
            self._dims0.page, p, attach=attach)
        self._cell_queue.setdefault(p, deque()).append(req.rid)
        self.hot_path_stats["staged"] += 1

    def _process_prefill_chunks(self, now: float) -> list:
        """Advance every alive prefill cell by ONE chunk of its head task,
        its KV scattered straight into the decode cluster.

        Streaming is position-reversed: ``move_pages`` re-homes the tail of
        the cell's placeholder fill, the chunk forward recomputes exactly
        those positions (a causal forward over ``[0, end)`` keeping rows
        ``[end - chunk, end)``; the flash kernel on CUDA) and the scatter
        writes to the decode destination.  A cell's frames therefore never
        hold live KV, and a cell crash loses no device state.  The first
        token is sampled from the full-prompt chunk and recorded when the
        handoff completes.  Returns the requests finished at activation
        (prefill-EOS)."""
        cl = self.cluster
        pt = cl.page_table
        ps = self._scatter.ps
        rows, coords, ready = [], [], []
        for p in sorted(cl.prefill_instances()):
            if p in cl.dead_instances:
                continue
            q = self._cell_queue.get(p)
            while q and (q[0] not in cl.prefilling
                         or self._handoff.get(q[0]) is None
                         or self._handoff[q[0]].instance != p):
                q.popleft()                   # stale (crashed or re-staged)
            if not q:
                continue
            rid = q[0]
            task = self._handoff[rid]
            cands = self.scheduler.handoff_candidates(
                cl, task, task.next_chunk().tokens)
            if not cands:
                continue     # decode backpressure: no headroom, retry later
            chunk, dest = task.complete_chunk(self._cp_buckets, cands)
            ranges = pt.request_positions(rid)[p]
            pos = [i for st, ln in ranges
                   for i in range(st, st + ln)][-chunk.tokens:]
            _, dst = pt.move_pages(rid, [(p, dest, chunk.tokens)])
            end = pos[-1] + 1
            toks = torch.as_tensor(self._prompts[rid][:end],
                                   device=self.device)[None, :]
            logits, caches = transformer.forward(self.cfg, self.params, toks,
                                                 collect_kv=True,
                                                 device=self.device)
            if end == task.prompt_len and rid not in self._first_tok:
                self._first_tok[rid] = logits[0, -1].argmax()
            rows.append(self._pool_rows(
                caches, torch.as_tensor(pos, device=self.device)))
            inst, frame, off = dst
            coords.append(np.stack([inst, frame % ps, frame // ps,
                                    off]).astype(np.int32))
            self.hot_path_stats["prefill_chunks"] += 1
            self.hot_path_stats["handoff_tokens"] += chunk.tokens
            if task.done:
                q.popleft()
                ready.append(rid)
        if rows:
            self._scatter_rows(rows, coords)
        return self._activate_handoffs(ready, now)

    def _activate_handoffs(self, rids: list, now: float) -> list:
        """Promote fully streamed requests to the decode cluster on their
        measured binding (``HandoffTask.binding``), record the first token,
        and finish a first-token EOS before it takes a decode slot."""
        if not rids:
            return []
        cl = self.cluster
        firsts, reqs = [], []
        for rid in rids:
            req = cl.prefilling[rid]
            task = self._handoff.pop(rid)
            self.scheduler.admit_handoff(cl, req, task.binding(), now)
            firsts.append(self._first_tok.pop(rid))
            reqs.append(req)
        eos_done = self._record_first_tokens(
            reqs, torch.stack(firsts).tolist(), now)
        self._register_prefixes(reqs)
        return self._finish_prefill_eos(eos_done, now)

    def _restage_prefilling(self, rec, now: float) -> list:
        """Recovery of a request parked mid-handoff.  A dead prefill cell
        loses only placeholder frames, so the crash costs the unstreamed
        tail: it re-stages on a surviving cell with headroom
        (``restore_ranges`` re-homes the lost positions as fresh
        placeholders, the chunk stream recomputes them).  With no such
        cell, or when a decode member holding streamed or attached pages
        died, the request finishes degraded."""
        cl = self.cluster
        pt = cl.page_table
        req = rec.req
        rid = req.rid
        task = self._handoff.get(rid)
        lost = sum(n for _, n in rec.lost)
        if (task is not None and task.instance in cl.dead_instances
                and lost > 0):
            survived = task.survived_tokens()
            cells = [c for c in cl.prefill_instances()
                     if c not in cl.dead_instances
                     and cl.kv_headroom(c) >= lost]
            if cells:
                p2 = max(cells, key=lambda c: (cl.kv_headroom(c), -c))
                pt.restore_ranges(rid, {p2: lost}, list(rec.lost))
                req.kv_binding = sorted(set(task.binding()) | {p2})
                self._handoff[rid] = HandoffTask(
                    rid, req.prompt_len, survived, self.chunk_tokens,
                    self._dims0.page, p2, attach=tuple(task.binding()))
                self._cell_queue.setdefault(p2, deque()).append(rid)
                self.results[rid].recovered = True
                self.hot_path_stats["recovered_tokens"] += survived
                self.hot_path_stats["reprefill_tokens"] += lost
                return []
        self._handoff.pop(rid, None)
        self._first_tok.pop(rid, None)
        cl.prefilling.pop(rid, None)
        pt.free_request(rid)
        self.results[rid].recovered = False
        req.status = "degraded"
        req.finish_time = now
        self.finished.append(req)
        self.hot_path_stats["degraded_finishes"] += 1
        return [req]

    def _apply_escalations(self, escalations: list) -> None:
        """Move the KV of this step's escalations and relaxations (their
        page-table bookkeeping already happened inside the scheduler) with
        one batched in-place re-shard, before this step's admissions
        scatter into possibly just-freed frames."""
        if not escalations:
            return
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

    def _apply_copies(self, copies: list) -> None:
        """Apply owed data-plane KV copies ((src, dst) [3, T] coordinate
        pairs: CoW splits, hot-prefix replication) with one in-place
        re-shard; its gathers read the pre-copy pools, so a batch whose
        sources are never destinations is safe.  Quantized pools copy with
        their scales (``migrate.KVReshard``)."""
        if not copies:
            return
        src = np.concatenate([s for s, _ in copies], axis=1)
        dst = np.concatenate([d for _, d in copies], axis=1)
        if src.shape[1] == 0:
            return
        self._reshard(self.state, src, dst)
        self.hot_path_stats["copy_tokens"] += int(src.shape[1])

    def _cow_appends(self) -> None:
        """Before lowering: an active request whose next decode append would
        land in a SHARED frame (a fork or prefix sibling still reads it)
        gets its partial tails split into exclusive clones, since
        ``routing.lower_plan`` appends into exclusive frames.  Raises
        ``KVSpillError`` into the spill loop when a clone cannot
        allocate."""
        pt = self.cluster.page_table
        copies = []
        for rid in sorted(self.cluster.active):
            req = self.cluster.active[rid]
            if (req.moe_binding >= 0
                    and pt.append_needs_cow(rid, req.moe_binding)):
                copies.append(pt.exclusive_tails(rid))
        self._apply_copies(copies)

    def _handle_spill(self, err: KVSpillError, now: float) -> list:
        """A decode append overran its shard at table lowering: evict a cold
        prefix-cache replica on the spilled instance first (cache-only
        frames go before any live request moves), else escalate the
        spilled request onto shards with headroom, or, when no shard in the
        node can take the KV, finish it with a clean request-level OOM.
        Returns the requests finished here (empty when relief worked)."""
        if self.prefix_trie is not None:
            keep = getattr(self.cluster.active.get(err.rid), "prefix_keys",
                           ())
            if self.prefix_trie.evict(self.cluster.page_table, 1,
                                      instance=err.instance, keep=keep):
                return []            # the append can take a frame now: retry
        escs = self.scheduler.relieve_spill(self.cluster, err.rid,
                                            err.instance)
        if escs:
            with self.tracer.span("engine.reshard", escalations=len(escs),
                                  spill_rid=err.rid):
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
        forced drain always completes with the instance empty and dead.

        Draining a prefill cell is the crash path with no data lost: its
        frames are placeholders (streamed KV already lives on decode
        instances), so its queued tails re-stage on surviving cells.

        Raises ``UnsupportedDrainError``, the cluster untouched, where
        per-slot state (SSM state, whisper's self caches) pins the slots
        (or the scheduler may not rebalance): the MoE binding cannot move
        without its state.  Traced as an ``engine.drain`` span."""
        with self.tracer.span("engine.drain", instance=instance,
                              force=force):
            return self._drain_instance(instance, force)

    def _drain_instance(self, instance: int, force: bool) -> list:
        if self.cluster.role_of(instance) == "prefill":
            records = self.cluster.fail_instance(instance)
            if self.prefix_trie is not None:
                self.prefix_trie.drop_instance(instance)
            self._recover(records, self._now())
            self.hot_path_stats["drains"] += 1
            return []
        if not (self._append_tokens
                and getattr(self.scheduler, "allow_rebalance", True)):
            raise UnsupportedDrainError(
                f"drain_instance({instance}): {self.cfg.name} pins per-slot "
                "device state, so the MoE binding cannot move without a "
                "slot state migration (fail_instance gives crash "
                "semantics)")
        # cache holds on the leaver go first: cache-only frames free at
        # once, frames shared with live requests become theirs and move
        # with them (not rolled back on a failed drain: losing a cache
        # replica is always safe)
        if self.prefix_trie is not None:
            self.prefix_trie.release_instance(self.cluster.page_table,
                                              instance)
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
        with self.tracer.span("engine.reshard", escalations=len(escalations)):
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
                elif self._append_tokens:
                    # un-append this step's input token (i is the
                    # dispatch-time MoE shard)
                    cl.page_table.pop_token(rid, i)
            infl.slots = keep
        records = cl.fail_instance(instance)
        if self.prefix_trie is not None:
            # the replicas died with the instance and the page table purged
            # them: forget them without a release (which would free into
            # the instance's fresh pool)
            self.prefix_trie.drop_instance(instance)
        return self._recover(records, now)

    def _recover(self, records: list, now: float) -> list:
        """Typed recovery of ``ClusterState.fail_instance`` records:
        re-prefill of the lost ranges into a replacement WaterFill
        placement, or a degraded finish.  Returns the requests finished
        (degraded) here."""
        cl = self.cluster
        pt = cl.page_table
        ledger = {s: pt.free_frames(s) for s in cl.alive_instances()}
        items, finished, cows = [], [], []
        for rec in records:
            req = rec.req
            rid = req.rid
            if rid in cl.prefilling:
                # parked mid-handoff: re-stage the unstreamed tail (or
                # degrade); the streamed prefix survives on decode instances
                finished += self._restage_prefilling(rec, now)
                continue
            if rid not in cl.active:
                continue
            resident = sum(pt.shard_tokens(rid).values())
            ranges = list(rec.lost)
            if resident == 0 and not ranges and req.length > 0:
                # nothing survived anywhere (or the request was resurrected
                # from a dispatch-time finish): the whole context is lost
                ranges = [(0, req.prompt_len + req.generated)]
            lost = sum(n for _, n in ranges)
            # lost KV is re-prefilled, but never when pinned per-slot state
            # died with the slot, nor without decode-side KV (whisper's lost
            # cross KV degrades the request)
            recoverable = (self._append_tokens
                           and not (rec.slot_lost and self._pinned_slots))
            split = None
            ok = req.moe_binding >= 0 and (lost == 0 or recoverable)
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
            # surviving shards may hold SHARED partial tails (a fork or
            # prefix sibling reads them): split them into exclusive clones
            # before restore_ranges appends into their slack
            # (place_recovery priced the clone frames)
            cows.append(pt.exclusive_tails(rid))
            positions, coords = pt.restore_ranges(rid, split, ranges)
            req.kv_binding = sorted(set(req.kv_binding) | set(split)
                                    | {req.moe_binding})
            items.append((req, positions, coords))
        self._apply_copies(cows)
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
        ps = self._scatter.ps
        rows, kv_coords = [], []
        for req, positions, coords in items:
            seq = self._prompts[req.rid] + self.results[req.rid].tokens
            toks = torch.as_tensor(seq, device=self.device)[None, :]
            _, caches = transformer.forward(self.cfg, self.params, toks,
                                            collect_kv=True,
                                            device=self.device)
            rows.append(self._pool_rows(
                caches, torch.as_tensor(positions, device=self.device)))
            inst, frame, off = coords
            kv_coords.append(np.stack([inst, frame % ps, frame // ps, off]))
        self._scatter_rows(rows, kv_coords)

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
        not), with the live re-shard applied now.  Needs KV to move."""
        if not self._append_tokens:
            raise ValueError("compact needs an attention arch")
        with self.tracer.span("engine.compact") as a:
            records = self.scheduler.relax(self.cluster, force=True)
            with self.tracer.span("engine.reshard", escalations=len(records)):
                self._apply_escalations(records)
            a["relaxations"] = len(records)
        self.hot_path_stats["compacts"] += 1
        return records

    def fork_request(self, parent_rid: int, max_new_tokens: int,
                     next_token: int | None = None,
                     now: float | None = None) -> int:
        """Fork an ACTIVE request mid-decode: the child attaches to the
        parent's resident KV (full frames shared by refcount, no data moved;
        partial tails cloned, so divergent appends never overwrite each
        other) and decodes on its own from here.

        The pipeline is settled first: one harvest (the pinned copy and its
        event), so the fork snapshots a harvested state.  ``next_token``
        overrides the child's pending token (the parent's last sample, not
        yet fed to a forward), in its transcript too, so ``prompt +
        tokens`` is always the sequence the child processes; by default it
        is the parent's.  ``max_new_tokens`` counts the child's emitted
        tokens, the inherited ones included.  Returns the child's rid.
        Needs a decoder-only attention arch whose slots can move (no SSM
        state)."""
        if not self._append_tokens or self._pinned_slots:
            raise ValueError(f"fork_request: {self.cfg.name} has per-slot "
                             "state or no KV to share")
        now = self._now() if now is None else now
        if self._inflight is not None:
            self._harvest(now)
        cl = self.cluster
        parent = cl.active.get(parent_rid)
        if parent is None:
            raise ValueError(f"fork of inactive request {parent_rid}")
        pt = cl.page_table
        rid = len(self._prompts)
        self._prompts[rid] = list(self._prompts[parent_rid])
        try:
            src, dst = pt.fork_request(rid, parent_rid)
        except KVSpillError as err:
            # the tail clones lack a frame: cold cache replicas go first
            if self.prefix_trie is None or not self.prefix_trie.evict(
                    pt, 1, instance=err.instance):
                raise
            src, dst = pt.fork_request(rid, parent_rid)
        self._apply_copies([(src, dst)])
        B = np.bincount([r.moe_binding for r in cl.active.values()],
                        minlength=cl.num_instances)
        members = [s for s in parent.kv_binding
                   if s not in cl.dead_instances] or [parent.moe_binding]
        m = int(min(members, key=lambda s: (B[s], s)))
        child = Request(rid=rid, prompt_len=parent.prompt_len,
                        max_new_tokens=max_new_tokens, arrival=now,
                        prefix_keys=parent.prefix_keys,
                        generated=parent.generated, status="running",
                        kv_binding=sorted(set(parent.kv_binding) | {m}),
                        moe_binding=m, node=cl.node_of(m), start_time=now,
                        token_times=list(parent.token_times))
        cl.active[rid] = child
        cl.assign_slot(rid, m)
        res = GenResult(rid, self._prompts[rid])
        res.tokens = list(self.results[parent_rid].tokens)
        self.results[rid] = res
        if next_token is not None:
            # the pending token's KV was never appended, so overriding the
            # input overrides the transcript entry it came from
            if not res.tokens or self.next_tok[parent_rid] != res.tokens[-1]:
                raise RuntimeError(f"fork of {parent_rid}: the pending token "
                                   "is not the transcript's last")
            res.tokens[-1] = int(next_token)
            self.next_tok[rid] = int(next_token)
        else:
            self.next_tok[rid] = self.next_tok[parent_rid]
        self.hot_path_stats["forks"] += 1
        return rid

    # ------------------------------------------------------------------ #
    def _harvest(self, now: float) -> list:
        """Wait for the in-flight iteration's tokens (copied to the host at
        dispatch), record them, and apply finishes."""
        infl = self._inflight
        if infl is None:
            return []
        self._inflight = None
        if infl.event is not None:
            infl.event.synchronize()
        toks = infl.host.numpy()
        logits = None if infl.logits is None else infl.logits.cpu().numpy()
        self.tracer.lap("engine.harvest")
        if infl.bins is not None and self.tracer.on:
            self._count_expert_bins(*infl.bins)
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

    def _count_expert_bins(self, bins, t: int, step: int, C: int) -> None:
        """Counter ``moe.expert_bins`` of a harvested step from its bins
        [L_moe, I, E]: the rows routed in all MoE layers, the rows the
        capacity bins hold (the ``bmm`` path's work), and the experts some
        row reached, a mean over the layers."""
        bins = bins.numpy()
        L, I, E = bins.shape
        self.tracer.count(
            "moe.expert_bins", t, step=step, rows=int(bins.sum()),
            padded_rows=L * E * I * C,
            experts_touched=float((bins.sum(axis=1) > 0).sum(axis=1).mean()))

    def _host_copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the host: on CUDA a non-blocking copy into a pinned
        buffer of its shape and dtype (reused: read it before the next such
        copy; the next token copy's event covers it), on the CPU a clone
        (the next step rewrites ``t``)."""
        if self.device.type != "cuda":
            return t.clone()
        key = (tuple(t.shape), t.dtype)
        host = self._host_bufs.get(key)
        if host is None:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host_bufs[key] = host
        host.copy_(t, non_blocking=True)
        return host

    def _start_token_copy(self, toks: torch.Tensor):
        """Device tokens -> host: pinned buffer + non-blocking copy + event
        on CUDA; the CPU result is already on the host."""
        if self.device.type != "cuda":
            return toks, None
        host = self._host_copy(toks)
        self._event.record()
        return host, self._event

    # ------------------------------------------------------------------ #
    def step(self, now: float | None = None) -> list:
        """One scheduling+decode iteration, pipelined one step ahead.

        Order: advance the prefill cells' chunk streams (a completed
        handoff activates before this step's schedule sees the active set)
        -> schedule (stage, admit, escalate, relax, shed, reject) -> the
        re-shard and the owed copies -> prefill + in-place scatter -> CoW
        split of shared tails and lowering of the routing tables -> harvest
        the in-flight iteration's tokens -> patch input tokens -> upload
        tables -> dispatch this iteration.  Returns the requests whose
        completion became visible during this call.  Each call is one
        ``engine.step`` span of ``self.tracer``, its phases its children.
        """
        tr = self.tracer
        if tr.on and self._traced_recording != tr.recordings:
            self._new_recording()
        tr.begin_step()
        try:
            return self._step(self._now() if now is None else now)
        finally:
            t = tr.end_step()
            if tr.on:
                self._trace_requests(t)

    def _step(self, now: float) -> list:
        tr = self.tracer
        handoff_done = []
        if self.cluster.prefill_cells:
            handoff_done = self._process_prefill_chunks(now)
            tr.lap("engine.handoff")
        plan = self.scheduler.schedule(self.cluster, now)
        for req in plan.staged:
            self._stage_handoff(req)
        # admission control's typed outcomes: the request never ran (no
        # tokens) and finishes here, flagged on its result
        dropped = []
        for req in plan.rejected + plan.shed:
            res = self.results.get(req.rid)
            if res is not None:
                if req.status == "rejected":
                    res.rejected = True
                else:
                    res.shed = True
            req.finish_time = now
            self.finished.append(req)
            dropped.append(req)
        self.hot_path_stats["rejected"] += len(plan.rejected)
        self.hot_path_stats["shed"] += len(plan.shed)
        self.hot_path_stats["preemptions"] += plan.preemptions
        tr.lap("scheduler.schedule")
        if tr.on:
            self._trace_schedule(plan, now)
        # the re-shard and the copies run before this step's admissions
        # scatter into (possibly just freed) frames
        escalations = plan.escalations + plan.relaxations
        if escalations or plan.copies:
            self._apply_escalations(escalations)
            self._apply_copies(plan.copies)
            tr.lap("engine.reshard")
            if tr.on:
                tr.note(escalations=len(escalations), copies=len(plan.copies))
        prefill_done = handoff_done + dropped
        if plan.admitted:
            prefill_done += self._prefill_batch(plan.admitted, now)
            tr.lap("engine.prefill")
            if tr.on:
                self._trace_prefill(plan.admitted)
        if not self.cluster.active:
            return prefill_done + self._harvest(now)

        # -- lower THIS iteration's tables while the device computes the
        #    previous one (routing never depends on token VALUES).  A typed
        #    KV spill surfaces here, page table untouched: relieve it
        #    (escalate, or OOM-finish the request) and lower again ---------
        spill_done = []
        attempts = len(self.cluster.active) + 1
        while True:
            try:
                if self._append_tokens:
                    self._cow_appends()
                tbl = routing.lower_plan(self.cluster, plan,
                                         buckets=self.shape_buckets,
                                         append_tokens=self._append_tokens,
                                         next_tokens=self.next_tok,
                                         arena=self._arena)
                break
            except KVSpillError as err:
                attempts -= 1
                if attempts <= 0:
                    raise
                spill_done += self._handle_spill(err, now)
                if not self.cluster.active:
                    tr.lap("routing.lower")
                    return prefill_done + spill_done + self._harvest(now)
        key = self.aot.quantise(tbl.M, tbl.S, tbl.MB, tbl.W, tbl.R)
        if key[2] != tbl.MB:
            raise RuntimeError(f"bucket MB {key[2]} != table MB {tbl.MB}")
        slots_at_lower = ({rid: self.cluster.slot_map[rid]
                           for rid in self.cluster.active}
                          if self.eos is not None and self.pipeline else None)
        tr.lap("routing.lower")
        fn = self.aot.lookup_key(key)
        tr.lap("aot.lookup")
        if tr.on:
            tr.note(bucket=key)

        # -- harvest the previous iteration ---------------------------------
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
        tbl_dev = routing.as_device_arrays(tbl, self._dev_tables)
        tr.lap("routing.tables")

        # -- dispatch (async on CUDA) + start the token readback copy -------
        check = self.aot.should_audit_donation()
        in_ptrs = self.aot.buffer_ptrs(self.state) if check else None
        self.state, toks, step_logits = fn(self.decode_params, self.state,
                                           tbl_dev)
        # tracing on: the step's expert bins go to the host with its tokens
        bins = (getattr(getattr(fn, "fn", fn), "expert_bins", None)
                if tr.on else None)
        host_bins = None if bins is None else self._host_copy(bins)
        host, event = self._start_token_copy(toks)
        t_dispatch = tr.lap("dcp.dispatch")
        batch_sizes = plan.batch_sizes()
        pt = self.cluster.page_table
        if tr.on:
            # the KV the step's paged calls read, before this dispatch's
            # length finishes free their pages
            tr.count("dcp.dispatch", t_dispatch, rows=batch_sizes.tolist(),
                     kv_tokens=[pt.instance_used_tokens(i) for i in
                                range(self.cluster.num_instances)],
                     rounds=int(tbl.R), bucket=key)
        if check:
            self.aot.note_donation(in_ptrs, self.state)

        # -- dispatch-time bookkeeping: length-based finishes are
        #    deterministic, so free their pages/slots right away ------------
        snapshot, length_done, holders = [], [], {}
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
        if host_bins is not None:
            self._inflight.bins = (host_bins, t_dispatch, tr.steps,
                                   moe_mod.capacity(self.cfg, key[0]))
        self.iterations += 1
        self.last_bucket = key
        self.last_rounds_used = tbl.R
        self.last_batch_sizes = batch_sizes
        self.hot_path_stats["steps"] += 1
        tr.lap("engine.bookkeeping")
        if not self.pipeline:
            done += self._harvest(now)
        return done

    # -- request spans (tracing on) ------------------------------------- #
    def _trace_schedule(self, plan, now: float) -> None:
        """``request.queued`` of each request this step's plan admitted,
        staged, shed or rejected: from its due time (``Request.arrival``)
        to this step's start, ``start_time - arrival`` long on the
        engine's clock (``now - arrival`` for one that never ran)."""
        tr = self.tracer
        tr.note(admitted=len(plan.admitted) + len(plan.staged),
                shed=len(plan.shed), rejected=len(plan.rejected))
        end = tr.root_start
        for req, outcome in ([(r, "admitted") for r in plan.admitted]
                             + [(r, "staged") for r in plan.staged]
                             + [(r, "shed") for r in plan.shed]
                             + [(r, "rejected") for r in plan.rejected]):
            began = req.start_time if outcome in ("admitted", "staged") \
                else now
            wait = round((began - req.arrival) * 1e9)
            tr.record("request.queued", end - wait, end, tr.last,
                      {"rid": req.rid, "outcome": outcome,
                       "wait_s": began - req.arrival})

    def _trace_prefill(self, reqs: list) -> None:
        """``request.prefill`` of each request of the batch, caused by (and
        as long as) this step's ``engine.prefill`` span."""
        tr = self.tracer
        ph = tr.spans[-1]
        new = [r.prompt_len - r.prefix_hit_tokens for r in reqs]
        tr.note(requests=len(reqs),
                prompt_tokens=sum(r.prompt_len for r in reqs),
                new_tokens=sum(new))
        for req, n in zip(reqs, new):
            self._prefill_spans[req.rid] = tr.record(
                "request.prefill", ph.start, ph.end, ph.id,
                {"rid": req.rid, "prompt_tokens": req.prompt_len,
                 "new_tokens": n})

    def _finish_kind(self, req) -> str:
        res = self.results.get(req.rid)
        if req.status in ("oom", "degraded", "rejected", "shed"):
            return req.status
        if (self.eos is not None and res is not None and res.tokens
                and res.tokens[-1] == self.eos):
            return "eos"
        return "length"

    def _trace_requests(self, t: int) -> None:
        """At a step's end: open ``request.decode`` for each request whose
        first token this step returned, and close it for each request whose
        finish it returned (token count and finish kind)."""
        for rid in self._first_tokens:
            self._decode_open[rid] = (t, self._prefill_spans.pop(rid, 0))
        self._first_tokens = []
        self._trace_finishes(t)

    def _trace_finishes(self, t: int) -> None:
        """``request.decode`` of each request finished since the last call
        (tracing on), ending at ``t``.  One that was decoding before the
        recording started starts at its start (``before_start``); one that
        never ran (shed, rejected) is empty."""
        tr = self.tracer
        fin = self.finished
        if len(fin) < self._traced_finishes:
            self._traced_finishes = 0
        for req in fin[self._traced_finishes:]:
            res = self.results.get(req.rid)
            tokens = len(res.tokens) if res else 0
            attrs = {"rid": req.rid, "tokens": tokens,
                     "finish": self._finish_kind(req)}
            opened = self._decode_open.pop(req.rid, None)
            if opened is None:
                opened = (t, 0)
                if tokens:
                    opened = (tr.anchors[0][0], 0)
                    attrs["before_start"] = True
            tr.record("request.decode", opened[0], t, opened[1], attrs)
        self._traced_finishes = len(fin)

    def _new_recording(self) -> None:
        """A recording started since the last step: finishes before it
        are not its to trace."""
        self._traced_recording = self.tracer.recordings
        self._traced_finishes = len(self.finished)
        self._first_tokens, self._prefill_spans = [], {}
        self._decode_open = {}

    @property
    def pending(self) -> bool:
        """Whether requests are waiting, prefilling on a cell, decoding or
        not yet harvested."""
        return bool(self.cluster.active or self.cluster.waiting
                    or self.cluster.prefilling or self._inflight is not None)

    def run(self, max_iters: int = 1000) -> dict:
        it = 0
        while self.pending and it < max_iters:
            self.step()
            it += 1
        return self.results
