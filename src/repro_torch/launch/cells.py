"""Cell builders: (architecture x input shape x mesh) -> a step and its
arguments (port of ``repro/launch/cells.py``).

A cell's ``args`` are ``meta`` tensors (shapes and dtypes, no storage: the
counterpart of the reference's ``ShapeDtypeStruct``s), and its ``fn`` is a
plain callable that runs unchanged on meta, CPU or CUDA tensors (it
follows the device of its arguments):

  train_4k    -> ``training.train_step`` (loss + grads + AdamW, remat,
                 microbatches), or the data-shard step with ``hybrid_reduce``
  prefill_32k -> the prefill forward with KV collection
  decode_*    -> the DCP decode step (``core/dcp.py``) on the virtual
                 (instance, tp) mesh, with the routing tables that the
                 port's own control plane lowers for the cell's requests.

The mesh is the layout record of ``launch/mesh.py``: the train and prefill
cells read it for their specs and the ``shard`` hook's log, the decode
cells for I (16 instances per pod) and tp.  The reference jits each step
with in/out shardings; the port has one card, so ``meta["specs"]`` carries
the spec trees instead (the dry run's per-device bytes).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..configs import SHAPES, get_config
from ..configs.base import ModelConfig, ShapeCfg
from ..core import dcp, routing
from ..core.bucketing import ShapeBuckets, derive_buckets
from ..core.scheduler import DualBalancedScheduler
from ..core.state import ClusterState, Request
from ..models import encdec, init_params, transformer
from ..serving.latency_model import LatencyModel
from ..training.optimizer import AdamWConfig, init_opt_state
from ..training.train_step import make_hybrid_train_step, make_train_step
from . import sharding

PAGE = 64
INSTANCES_PER_POD = 16
INSTANCES_PER_NODE = 8          # the paper's 8-GPU NVLink node: its ring window
META = torch.device("meta")


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: object                   # plain callable
    args: tuple                  # trees of meta tensors
    meta: dict                   # control-plane facts (dims, capacity, ...)


def _dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _meta_params(cfg: ModelConfig) -> dict:
    return init_params(cfg, seed=0, device=META)


def _dp(dp_axes):
    return tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]


# --------------------------------------------------------------------------- #
# train / prefill cells
# --------------------------------------------------------------------------- #
def build_train_cell(cfg: ModelConfig, shape: ShapeCfg, mesh, *,
                     multi_pod: bool = False, num_micro: int = 4,
                     remat: str = "full", fsdp: bool = True,
                     hybrid_reduce: bool = False,
                     compress: str | None = "bf16") -> Cell:
    """The train step at ``shape`` (B x S tokens).  ``fsdp`` changes the
    parameter specs only (one card holds every leaf whole).
    ``hybrid_reduce`` runs the deferred-single-reduction step over the
    data axes' shards (``make_hybrid_train_step``), with ``compress``."""
    dp_axes = _dp_axes(multi_pod)
    params = _meta_params(cfg)
    opt = init_opt_state(params)
    pspecs = sharding.train_param_specs(cfg, params, fsdp=fsdp)
    ospecs = sharding.zero_opt_specs(pspecs, params, 16, dp_axes=("data",))
    bspecs = sharding.batch_specs(cfg, dp_axes)
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32),
             "targets": _meta((B, S), torch.int32)}
    if cfg.is_encoder_decoder:
        tgt = min(S, cfg.max_target_positions)
        batch = {"tokens": _meta((B, tgt), torch.int32),
                 "targets": _meta((B, tgt), torch.int32),
                 "frames": _meta((B, S, cfg.d_model), torch.bfloat16)}
    shards = 1
    for a in dp_axes:
        shards *= mesh.shape[a]

    def train(params, opt_state, batch):
        dev = batch["tokens"].device
        if hybrid_reduce:
            # inside the reference's data-manual shard_map the constraints
            # may only use the model axis: the batch is already a shard
            step = make_hybrid_train_step(
                cfg, AdamWConfig(), shards,
                shard=sharding.make_shard_fn(mesh, ()), remat=remat,
                num_micro=num_micro, compress=compress, device=dev)
        else:
            step = make_train_step(
                cfg, AdamWConfig(), shard=sharding.make_shard_fn(mesh, dp_axes),
                remat=remat, num_micro=num_micro, device=dev)
        return step(params, opt_state, batch)

    return Cell(cfg.name, shape.name, "train", train, (params, opt, batch),
                {"num_micro": num_micro, "remat": remat,
                 "specs": (pspecs, ospecs, bspecs)})


def build_prefill_cell(cfg: ModelConfig, shape: ShapeCfg, mesh, *,
                       multi_pod: bool = False) -> Cell:
    """The prefill forward with KV collection: (last-position logits,
    caches)."""
    dp_axes = _dp_axes(multi_pod)
    params = _meta_params(cfg)
    pspecs = sharding.train_param_specs(cfg, params)
    shard_fn = sharding.make_shard_fn(mesh, dp_axes)
    B, S = shape.global_batch, shape.seq_len
    dp = _dp(dp_axes)

    if cfg.is_encoder_decoder:
        tgt = min(256, cfg.max_target_positions)

        def prefill(params, batch):
            enc = encdec.encode(cfg, params, batch["frames"], shard=shard_fn)
            logits, caches = encdec.decode_forward(cfg, params,
                                                   batch["tokens"], enc,
                                                   collect_kv=True,
                                                   shard=shard_fn)
            return logits[:, -1], caches
        batch = {"frames": _meta((B, S, cfg.d_model), torch.bfloat16),
                 "tokens": _meta((B, tgt), torch.int32)}
        bspecs = {"frames": sharding.P(dp, None, None),
                  "tokens": sharding.P(dp, None)}
    else:
        def prefill(params, batch):
            tokens = batch["tokens"]
            logits, caches = transformer.forward(cfg, params, tokens,
                                                 collect_kv=True,
                                                 shard=shard_fn,
                                                 device=tokens.device)
            return logits[:, -1], caches
        batch = {"tokens": _meta((B, S), torch.int32)}
        bspecs = {"tokens": sharding.P(dp, None)}

    return Cell(cfg.name, shape.name, "prefill", prefill, (params, batch),
                {"specs": (pspecs, bspecs)})


def build_chunked_prefill_cell(cfg: ModelConfig, shape: ShapeCfg, mesh, *,
                               multi_pod: bool = False,
                               chunk_tokens: int = 64 * PAGE) -> Cell:
    """The prefill cell's chunk step of disaggregated serving: the causal
    prefix ``[0, end)`` forwarded, and only the tail chunk's KV emitted,
    stacked over attention layers (``chunk_k``/``chunk_v`` [n_attn, nb, B,
    C, Hkv, hd]; MLA: the latent [c_kv | k_rope] in ``chunk_k``), with the
    last-position logits.  ``fn`` is the worst case (the full-prefix
    forward, the final chunk); ``meta["chunk_ends"]`` is the whole ladder
    of prefix lengths.  The output is bounded by ``chunk_tokens`` whatever
    the prompt's length.  Decoder-only attention architectures only."""
    if not (cfg.has_attention and not cfg.is_encoder_decoder
            and cfg.family not in ("ssm", "hybrid")):
        raise ValueError(f"{cfg.name}: chunked prefill cells need a "
                         "decoder-only attention arch")
    if chunk_tokens <= 0 or chunk_tokens % PAGE:
        raise ValueError(f"chunk_tokens {chunk_tokens} is not a positive "
                         f"multiple of the page ({PAGE})")
    dp_axes = _dp_axes(multi_pod)
    params = _meta_params(cfg)
    pspecs = sharding.train_param_specs(cfg, params)
    shard_fn = sharding.make_shard_fn(mesh, dp_axes)
    B, S = shape.global_batch, shape.seq_len
    C = min(chunk_tokens, S)
    pattern = cfg.block_pattern()

    def chunk_step(params, batch):
        tokens = batch["tokens"]
        logits, caches = transformer.forward(cfg, params, tokens,
                                             collect_kv=True, shard=shard_fn,
                                             device=tokens.device)
        ks, vs = [], []
        for li, kind in enumerate(pattern):
            if kind["mixer"] != "attn":
                continue
            a, b = caches[li]["kv"]
            if cfg.is_mla:
                ks.append(torch.cat([a, b], dim=-1))
            else:
                ks.append(a)
                vs.append(b)
        # [na, nb, B, T, ...] -> the tail chunk only (the T axis): the slab
        # the handoff streams; earlier chunks emitted everything before it
        out = {"last_logits": logits[:, -1],
               "chunk_k": torch.stack(ks)[:, :, :, -C:]}
        if vs:
            out["chunk_v"] = torch.stack(vs)[:, :, :, -C:]
        return out

    batch = {"tokens": _meta((B, S), torch.int32)}
    bspecs = {"tokens": sharding.P(_dp(dp_axes), None)}
    ends = tuple(min(S, e) for e in range(C, S + C, C))
    return Cell(cfg.name, shape.name, "chunked_prefill", chunk_step,
                (params, batch),
                {"chunk_tokens": C, "num_chunks": len(ends),
                 "chunk_ends": ends, "specs": (pspecs, bspecs)})


# --------------------------------------------------------------------------- #
# decode cells (the DCP step, tables from the port's control plane)
# --------------------------------------------------------------------------- #
def plan_decode_cell(cfg: ModelConfig, shape: ShapeCfg, *,
                     num_instances: int, tp: int = 16,
                     instances_per_node: int = INSTANCES_PER_NODE,
                     page: int = PAGE, latency_model=None):
    """Run the control plane for this cell's request population: every
    request prompt_len = seq_len, queued at once.  Returns (cluster,
    tables, dims).  The CP buckets come from ``latency_model`` (default
    ``LatencyModel(cfg)``, the port's H100 datasheet figures: its buckets
    differ from the reference's)."""
    gb, seq = shape.global_batch, shape.seq_len
    I, W = num_instances, instances_per_node
    _, _, ps = dcp.attn_tp_geometry(cfg, tp)
    cap = int(max(np.ceil(gb * seq / I * 1.15),
                  np.ceil(seq / W * 1.25), 16 * page))
    cap = -(-cap // page) * page
    buckets = derive_buckets(latency_model or LatencyModel(cfg),
                             max_degree=W)
    is_ssm_family = cfg.family in ("ssm", "hybrid")
    # the rotation ring stays within the pod; bindings may cross NODE
    # boundaries within the pod when a node cannot hold a request
    cluster = ClusterState(num_instances=I, instances_per_node=W,
                           kv_capacity_tokens=cap, page_size=page,
                           kv_stripes=ps,
                           routing_window=min(I, INSTANCES_PER_POD))
    m_fixed = max(1, -(-gb // I))
    sched = DualBalancedScheduler(buckets=buckets,
                                  allow_rebalance=not is_ssm_family,
                                  has_kv=cfg.has_attention)
    for rid in range(gb):
        cluster.enqueue(Request(
            rid=rid, prompt_len=seq, max_new_tokens=64,
            dec_prefix_len=(min(255, cfg.max_target_positions - 1)
                            if cfg.is_encoder_decoder else -1)))
    plan = sched.schedule(cluster)
    if plan.deferred:
        raise ValueError(f"{cfg.name}/{shape.name}: {plan.deferred} requests "
                         f"did not fit (cap={cap} tokens/instance)")
    sb = ShapeBuckets(m_buckets=(m_fixed,) if is_ssm_family
                      else (1, 2, 4, 8, 16, 32, 64, 128, 256),
                      s_buckets=(0, 1, 2, 4, 8, 16, 32),
                      window=cluster.window)
    tbl = routing.lower_plan(cluster, plan, buckets=sb,
                             append_tokens=cfg.has_attention,
                             next_tokens={r: 1 for r in cluster.active})
    dims = dcp.DecodeDims(M=tbl.M, S=tbl.S, N=tbl.N, MB=tbl.MB, MBT=tbl.MBT,
                          W=tbl.W, num_frames=cap // page + 1, page=page,
                          data_size=I, tp=tp, rounds_used=tbl.R,
                          pods=max(1, I // INSTANCES_PER_POD))
    return cluster, tbl, dims


def table_arrays(tbl) -> dict:
    """The routing tables' numpy arrays by name (what the step reads)."""
    return {f.name: getattr(tbl, f.name) for f in dataclasses.fields(tbl)
            if isinstance(getattr(tbl, f.name), np.ndarray)}


def build_decode_cell(cfg: ModelConfig, shape: ShapeCfg, mesh, *,
                      multi_pod: bool = False, backend: str = "routed",
                      rounds_used: int | None = None,
                      kv_dtype: torch.dtype | None = None,
                      weight_dtype: torch.dtype | None = None,
                      latency_model=None) -> Cell:
    """The DCP decode step for the cell's plan.  ``kv_dtype`` is the pools'
    torch dtype (default bfloat16; a float8 one gives raw codes without
    scales, read with a unit scale); ``weight_dtype`` stores the large
    decode matrices in that dtype (``dcp.quantize_decode_weights``).  On a
    multi-pod mesh the instance axis holds every pod's 16 instances, each
    pod its own expert group and rotation window."""
    tp = mesh.shape["model"]
    pods = mesh.shape.get("pod", 1)
    I_total = INSTANCES_PER_POD * pods
    cluster, tbl, dims = plan_decode_cell(cfg, shape, num_instances=I_total,
                                          tp=tp, latency_model=latency_model)
    over = {"backend": backend}
    if rounds_used is not None:
        over["rounds_used"] = rounds_used
    dims = dataclasses.replace(dims, **over)
    tbl_dev = {k: _meta(v.shape, torch.int32)
               for k, v in table_arrays(tbl).items()}
    params = _meta_params(cfg)
    kvd = kv_dtype or torch.bfloat16
    if cfg.is_encoder_decoder:
        dparams = dcp.to_encdec_decode_params(cfg, params, tp)
        state = dcp.init_encdec_serve_state(cfg, dims, I_total, dtype=kvd,
                                            device=META)
        fn = dcp.build_encdec_decode_step(cfg, dims)
    else:
        dparams = dcp.to_decode_params(cfg, params, tp)
        if weight_dtype is not None:
            dparams = dcp.quantize_decode_weights(dparams, weight_dtype)
        state = dcp.init_serve_state(cfg, dims, I_total, dtype=kvd,
                                     device=META)
        fn = dcp.build_decode_step(cfg, dims)
    meta = {"dims": {k: getattr(dims, k) for k in
                     ("M", "S", "N", "MB", "MBT", "W", "num_frames", "page",
                      "tp", "backend", "rounds_used")},
            "kv_capacity_tokens": (dims.num_frames - 1) * dims.page,
            "cp_histogram": _cp_hist(cluster)}
    return Cell(cfg.name, shape.name, "decode", fn, (dparams, state, tbl_dev),
                meta)


def _cp_hist(cluster) -> dict:
    h = {}
    for r in cluster.active.values():
        h[r.cp_degree] = h.get(r.cp_degree, 0) + 1
    return h


def build_cell(arch: str, shape_name: str, mesh, *, multi_pod: bool = False,
               **kw) -> Cell:
    """The cell of ``arch`` at ``SHAPES[shape_name]`` on ``mesh``, with the
    reference's defaults: 8 microbatches for MoE train cells (4 otherwise,
    Jamba being MoE takes 8); hybrids train with half-size (64) SSD
    chunks.  ``chunked=True``
    gives a prefill shape's chunked-prefill cell."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        kw = {k: v for k, v in kw.items()
              if k in ("num_micro", "remat", "fsdp", "hybrid_reduce",
                       "compress")}
        kw.setdefault("num_micro", 8 if cfg.is_moe else 4)
        if cfg.family == "hybrid":
            # the SSD backward is the train-memory bottleneck on wide-head
            # hybrids: half-size SSD chunks
            cfg = dataclasses.replace(cfg, ssm_chunk=64)
        return build_train_cell(cfg, shape, mesh, multi_pod=multi_pod, **kw)
    if shape.kind == "prefill":
        if kw.get("chunked"):
            return build_chunked_prefill_cell(
                cfg, shape, mesh, multi_pod=multi_pod,
                **{k: v for k, v in kw.items() if k == "chunk_tokens"})
        return build_prefill_cell(cfg, shape, mesh, multi_pod=multi_pod)
    return build_decode_cell(cfg, shape, mesh, multi_pod=multi_pod,
                             **{k: v for k, v in kw.items()
                                if k in ("backend", "rounds_used", "kv_dtype",
                                         "weight_dtype", "latency_model")})
