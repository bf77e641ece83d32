"""KV-cache migration: prefill output -> DCP-placed pool frames (§3 (2)-(3)),
port of ``repro/core/migrate.py`` (GQA pools and MLA's latent pool,
unquantized or fp8/int8).

Token->shard assignment is contiguous ranges in sorted binding order
(decode attention + LSE merge are order-agnostic over the prefix, so any
partition is exact).

Two implementations:

  * ``load_prefill_kv`` — host-side (numpy) writes into pool arrays: the
    reference semantics, used by the tests.
  * ``PrefillScatter`` — the engine's path: prefill KV (already on the
    device from the prefill forward) is written into the pools IN PLACE by
    one indexed assignment per state kind, driven by small int32
    coordinate tensors; every request admitted in one scheduler step
    batches into one call.

``KVReshard`` moves RESIDENT KV between pool coordinates (the live re-shard
behind escalation and relaxation); the reference's main path relaxes (it
consolidates fragmented tail pages onto the MoE binding) within its first
decode steps, so the engine needs it.

Quantized pools move with their per-page scales under the offset-0 rule
(``kernels/quant.py``): the scatter quantizes on the write, the re-shard
dequantizes with the source scales and requantizes against the
destination's.

Not ported yet: SSM states (ROADMAP queue 1 item 11) and whisper cross/self
KV (item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels import quant
from .dcp import DecodeDims, attn_tp_geometry, check_dims, kv_group_size
from .state import ClusterState


def attn_layer_index(cfg: ModelConfig, attn_ordinal: int) -> tuple[int, int]:
    """ordinal among attention layers -> (block index, position within block)."""
    pattern = cfg.block_pattern()
    per_block = sum(1 for k in pattern if k["mixer"] == "attn")
    return attn_ordinal // per_block, attn_ordinal % per_block


def shard_ranges(cluster: ClusterState, rid: int) -> list[tuple[int, int, int]]:
    """[(instance, start_token, num_tokens)] contiguous split of the prefix."""
    shards = cluster.page_table.shard_tokens(rid)
    out, start = [], 0
    for s in sorted(shards):
        t = shards[s]
        if t > 0:
            out.append((s, start, t))
            start += t
    return out


def load_prefill_kv(cfg: ModelConfig, cluster: ClusterState, dims: DecodeDims,
                    state_np: dict, rid: int, kv_layers) -> None:
    """Write one request's prefill KV into the (numpy) pool arrays.

    kv_layers: per attention layer, (k [len, Hkv, hd], v [len, Hkv, hd]) or
    (c_kv [len, kvr], k_rope [len, dr]) for MLA, whose latent
    [c_kv | k_rope] goes to ``kv_pool``.
    """
    page = dims.page
    pt = cluster.page_table
    ranges = shard_ranges(cluster, rid)
    _, khs, ps = attn_tp_geometry(cfg, dims.tp)
    kg = kv_group_size(cfg, dims.tp)

    # hybrid sub-pool addressing: frame f of kv-head group h lives in
    # sub-pool chunk c = (f % ps)*khs + h at local frame f // ps; the chunk
    # stores its kg = Hkv/khs heads flattened into the last dim (core/dcp.py)
    for a, (k, v) in enumerate(kv_layers):
        bi, pos = attn_layer_index(cfg, a)
        if cfg.is_mla:
            lat = np.concatenate([np.asarray(k, np.float32),
                                  np.asarray(v, np.float32)], axis=-1)
            pool = state_np["kv_pool"]           # [nb, na, I, tp, F', page, dk]
            for s, start, t in ranges:
                frames = pt.shard_frames(rid, s)
                for j in range(t):
                    f, o = frames[j // page], j % page
                    pool[bi, pos, s, (f % ps) * khs, f // ps, o] = lat[start + j]
            continue
        k = np.asarray(k, np.float32)
        v = np.asarray(v, np.float32)
        kp, vp = state_np["k_pool"], state_np["v_pool"]
        for s, start, t in ranges:
            frames = pt.shard_frames(rid, s)
            for j in range(t):
                f, o = frames[j // page], j % page
                for h in range(khs):
                    c = (f % ps) * khs + h
                    grp = slice(h * kg, (h + 1) * kg)
                    kp[bi, pos, s, c, f // ps, o] = k[start + j, grp].reshape(-1)
                    vp[bi, pos, s, c, f // ps, o] = v[start + j, grp].reshape(-1)


def prefill_coords(cluster: ClusterState, rid: int, page: int,
                   ps: int) -> np.ndarray:
    """Per-token pool coordinates for one request's prefix, token order.

    Returns int32 [4, T]: (instance, stripe = f %% ps, sub_frame = f // ps,
    offset) — exactly the hybrid sub-pool addressing of the numpy loader.
    """
    pt = cluster.page_table
    cols = []
    for s, start, t in shard_ranges(cluster, rid):
        frames = np.asarray(pt.shard_frames(rid, s), dtype=np.int64)
        j = np.arange(t)
        f = frames[j // page]
        cols.append(np.stack([np.full(t, s), f % ps, f // ps, j % page]))
    if not cols:
        return np.zeros((4, 0), np.int32)
    return np.concatenate(cols, axis=1).astype(np.int32)


class PrefillScatter:
    """In-place scatter of prefill KV into the serve state's pools.

    The reference jits a donated scatter per padded token-count bucket; in
    eager torch the indexed assignment writes into the pool storage
    directly (the pools' ``data_ptr`` never changes) and needs no padding.
    """

    def __init__(self, cfg: ModelConfig, dims: DecodeDims,
                 num_instances: int):
        check_dims(dims)
        self.cfg = cfg
        self.dims = dims
        self.I = num_instances
        _, self.khs, self.ps = attn_tp_geometry(cfg, dims.tp)
        self.kg = kv_group_size(cfg, dims.tp)

    def quantized_write(self, pool: torch.Tensor, scale: torch.Tensor,
                        x: torch.Tensor, page_ix: tuple,
                        off: torch.Tensor) -> None:
        """Write float values ``x`` [nb, na, T, khs, d] into a quantized pool
        and its scales ``[nb, na, I, tp, F']``, in place, under the offset-0
        rule: a page that receives an offset-0 token in THIS call gets a
        fresh scale, the max over the call's tokens for the page of their
        amax/qmax; every other page keeps its scale, and the new tokens clip
        into it.  page_ix = (instance, chunk, sub-frame) indices broadcasting
        to [T, khs]; off [T] the tokens' page offsets."""
        kv_dtype = self.dims.kv_dtype
        nb, na, _, tp, Fp = scale.shape
        ii, c, ff = page_ix
        lin = (ii * tp + c) * Fp + ff                              # [T, khs]
        tok = quant.amax_scale(x, kv_dtype)                         # [nb,na,T,khs]
        fresh = torch.zeros(nb, na, scale[0, 0].numel(), device=scale.device)
        fresh.scatter_reduce_(2, lin.reshape(1, 1, -1).expand(nb, na, -1),
                              tok.reshape(nb, na, -1), reduce="amax")
        at0 = (off == 0)[:, None].expand(lin.shape).to(torch.int32)
        has0 = torch.zeros(fresh.shape[2], dtype=torch.int32,
                           device=scale.device).scatter_reduce_(
            0, lin.reshape(-1), at0.reshape(-1), reduce="amax") > 0
        a, b = slice(None), slice(None)
        quant.write_offset0(pool, (a, b, ii, c, ff, off[:, None]), scale,
                            (a, b, ii, c, ff), x, fresh[:, :, lin], has0[lin],
                            kv_dtype)

    def pool_keys(self) -> tuple:
        """(pool, scale) state keys: MLA's one latent pool, or k and v."""
        if self.cfg.is_mla:
            return (("kv_pool", "kv_scale"),)
        return (("k_pool", "k_scale"), ("v_pool", "v_scale"))

    def scatter_kv(self, state: dict, k: torch.Tensor, v: torch.Tensor | None,
                   coords: np.ndarray) -> dict:
        """k, v: [nb, na, T, khs, kg*d] device tensors (the Hkv head axis
        reshaped to khs groups of kg heads); for MLA k is the latent
        [nb, na, T, 1, kvr + dr] and v is None.  coords from
        ``prefill_coords`` (concatenated over the admitted batch).  Writes
        in place; returns ``state``.  Quantized pools quantize on the
        write, with their scales (``quantized_write``)."""
        dev = k.device
        cs = torch.as_tensor(np.asarray(coords, np.int64), device=dev)
        inst, stripe, subf, off = cs
        c = stripe[:, None] * self.khs + torch.arange(self.khs, device=dev)
        ii, ff, oo = inst[:, None], subf[:, None], off[:, None]
        for (pkey, skey), x in zip(self.pool_keys(), (k, v)):
            pool = state[pkey]
            if skey in state:
                self.quantized_write(pool, state[skey], x, (ii, c, ff), off)
            else:
                pool[:, :, ii, c, ff, oo] = x.to(pool.dtype)
        return state


class KVReshard:
    """Move resident KV between pool coordinates, in place.

    ``src``/``dst``: int [3, T] (instance, frame, offset) per moved token,
    matching order (``GlobalPageTable.move_pages``).  Every moved token's KV
    is gathered from the PRE-move pools before any write, so a frame freed
    by one move and reused by another in the same batch stays correct.

    Quantized pools: the moved codes are dequantized with their SOURCE page
    scales, then requantized against the destination pages
    (``PrefillScatter.quantized_write``: pages receiving an offset-0 token
    get a fresh scale from the moved values, partly filled ones keep
    theirs).  No value is ever read with another page's scale.
    """

    def __init__(self, scatter: PrefillScatter):
        self.sc = scatter

    def __call__(self, state: dict, src: np.ndarray, dst: np.ndarray) -> dict:
        if src.shape != dst.shape or src.shape[0] != 3:
            raise ValueError(f"KVReshard: src {src.shape} / dst {dst.shape}")
        if src.shape[1] == 0:
            return state
        khs, ps = self.sc.khs, self.sc.ps
        keys = self.sc.pool_keys()
        dev = state[keys[0][0]].device
        hh = torch.arange(khs, device=dev)
        s = torch.as_tensor(np.asarray(src, np.int64), device=dev)
        d = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
        c_s = (s[1] % ps)[:, None] * khs + hh
        c_d = (d[1] % ps)[:, None] * khs + hh
        src_ix = (s[0][:, None], c_s, (s[1] // ps)[:, None], s[2][:, None])
        dst_ix = (d[0][:, None], c_d, (d[1] // ps)[:, None], d[2][:, None])
        lead = (slice(None), slice(None))
        vals = {key: state[key][lead + src_ix] for key, _ in keys}
        if keys[0][1] in state:
            for key, skey in keys:
                vals[key] = quant.dequantize(
                    vals[key], state[skey][lead + src_ix[:3]][..., None])
            for key, skey in keys:
                self.sc.quantized_write(state[key], state[skey], vals[key],
                                        dst_ix[:3], d[2])
            return state
        for key, v in vals.items():
            state[key][lead + dst_ix] = v
        return state
