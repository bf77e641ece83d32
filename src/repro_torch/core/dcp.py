"""DCP decode step (§5) on a virtual (instance, tp) mesh
(port of ``repro/core/dcp.py``: the dense GQA and MLA paths, dense and
MoE FFNs, routed and dense backends).

The JAX package runs the step per device inside ``shard_map`` over the
(`data`, `model`) mesh.  The port runs the whole mesh in one process on one
GPU: the serve state keeps its leading ``[I, tp]`` dims (pools
``[nb, n_attn, I, tp, F', page, kg*hd]``), per-device work is batched over
those dims, and each collective becomes an index op:

  * ``ppermute`` (Phase 1 q-routing, Phase 3 res-routing) -> ``comm.rotate``;
  * ``all_gather`` over instances (the dense backend) -> an index of the
    ``[I, ...]`` tensor by peer (``comm.allgather_backend``);
  * ``all_gather`` over the page-stripe subgroup -> a reshape of the tp dim
    into (stripe p, kv-head group h);
  * ``psum`` over tp -> a sum over the tp dim.

The four phases per attention layer: (1) route q rows over the zig-zag
ring, (2) paged decode attention — ONE kernel launch for every virtual
device (pools flattened to one page axis, block tables offset per device),
(3) return the partial (out, lse) rows, (4) merge them with ``merge_lse``.
Then the FFN — the TP dense FFN, or the wide-EP MoE dispatch/combine
(``moe_parallel.moe_decode_ffn``: experts over the instances, an
all-to-all each way as a transpose of the [I_src, I_dst, ...] buffer) —
and the vocab-sharded greedy sample.

Column-parallel weights keep the full ``[D, C]`` layout (chunk j is column
block j, so ``x @ w`` viewed as ``[.., tp, C/tp]`` is every device's
output); row-parallel weights are stored as ``[tp, R/tp, D]`` chunks and
their partial products summed over tp, as the reference's psum does.

MLA caches one latent "head" per token, ``[c_kv | k_rope]`` (kv_lora_rank
+ rope dims), in a single ``kv_pool`` striped over every tp device (khs = 1,
ps = tp); W_uk is absorbed into q and W_uv applied after the merge, so the
paged kernel runs MQA over the latent with v a view of k's first
kv_lora_rank dims.

Quantized pools (``kv_dtype`` fp8/int8) store codes plus per-page float32
scales ``k_scale``/``v_scale`` (MLA: one ``kv_scale``)
``[nb, n_attn, I, tp, F']``; appends quantize under the offset-0 rule
(``kernels/quant.py``) and the paged kernel dequantizes as it reads.

Not ported yet (each raises ``NotImplementedError``): SSM and
encoder-decoder steps.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import ModelConfig
from ..kernels import ops, quant
from ..models import layers as L
from ..models.transformer import block_slice, check_supported
from . import comm
from .moe_parallel import dense_decode_ffn, moe_decode_ffn


# --------------------------------------------------------------------------- #
# static decode dimensions (one AOT bucket x cluster geometry)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class DecodeDims:
    M: int                 # slots / instance
    S: int                 # cross-send rows / rotation round
    N: int                 # attention work rows / instance
    MB: int                # page blocks / work row
    W: int                 # rotation window (cluster ring)
    num_frames: int        # KV pool frames / instance
    page: int = 64
    data_size: int = 16    # instances I
    tp: int = 16
    backend: str = "routed"          # routed | dense (all-gather baseline)
    rounds_used: int = -1            # effective W-1 rounds (-1 = all)
    MBT: int = 0                     # page blocks per work row per kv stripe
                                     # (0 -> MB; hybrid sharding)
    eos: int = -1                    # stop token id; >= 0 enables the
                                     # device-side EOS mask (see
                                     # ``_mask_eos_slots``)
    kv_dtype: str = "bf16"           # "bf16" = pools in the model dtype;
                                     # "fp8"/"int8" = quantized pools

    @property
    def num_rounds(self) -> int:
        r = self.W - 1 if self.rounds_used < 0 else self.rounds_used
        return r if self.S > 0 else 0


BACKENDS = ("routed", "dense")


def check_dims(dims: DecodeDims) -> None:
    if dims.backend not in BACKENDS:
        raise ValueError(f"backend {dims.backend!r}: one of {BACKENDS}")
    quant.check_kv_dtype(dims.kv_dtype)


def attn_tp_geometry(cfg: ModelConfig, tp: int):
    """Hybrid decode-KV sharding geometry for tp-way attention TP.

    Returns (hp, khs, ps): q heads padded to a tp multiple, kv-head shards
    min(Hkv, tp), and page stripes tp/khs per kv-head group.  When
    tp < Hkv each shard owns a GROUP of kg = Hkv/tp kv heads
    (``kv_group_size``).
    """
    if not cfg.has_attention:
        return 0, 1, 1
    hp = ((cfg.num_heads + tp - 1) // tp) * tp
    hkv = 1 if cfg.is_mla else cfg.num_kv_heads
    khs = min(hkv, tp)
    if tp % khs or hkv % khs:
        raise ValueError(f"tp={tp} and num_kv_heads={hkv}: tp must divide or "
                         "be divided by the kv-head count")
    return hp, khs, tp // khs


def kv_group_size(cfg: ModelConfig, tp: int) -> int:
    """kv heads co-resident on one model chunk (tp < Hkv head-grouping)."""
    if not cfg.has_attention:
        return 1
    hkv = 1 if cfg.is_mla else max(cfg.num_kv_heads, 1)
    _, khs, _ = attn_tp_geometry(cfg, tp)
    return hkv // khs


def _head_perm(hp: int, tp: int, khs: int) -> list[int]:
    """q-head order so model-chunk c = p*khs + h carries heads
    [h*G + p*hl, ...) — after the page-subgroup gather, kv-head h's G q
    heads assemble in order.  Identity when khs==tp or khs==1."""
    ps = tp // khs
    hl = hp // tp
    G = hp // khs
    perm = []
    for c in range(tp):
        p, h = c // khs, c % khs
        perm.extend(range(h * G + p * hl, h * G + (p + 1) * hl))
    return perm


def _head_tools(cfg: ModelConfig, tp: int):
    """(pad_q, pad_q_rows, tile_kv, perm) for the hybrid-sharded head layout.
    Each takes weights with any leading dims (the stacked block axis)."""
    hp, khs, ps = attn_tp_geometry(cfg, tp)
    hkv = 1 if cfg.is_mla else max(cfg.num_kv_heads, 1)
    perm = _head_perm(hp, tp, khs)
    hq = cfg.num_heads
    g_in, g_out = hq // hkv, hp // hkv

    def pad_q(w, per):
        """[..., Hq*per] -> [..., hp*per]: pad each kv group, then permute
        heads into the model-chunk order."""
        lead = w.shape[:-1]
        w = w.reshape(*lead, hkv, g_in, per)
        w = F.pad(w, (0, 0, 0, g_out - g_in)).reshape(*lead, hp, per)
        w = w[..., torch.tensor(perm, device=w.device), :]
        return w.reshape(*lead, hp * per)

    def pad_q_rows(w, per):
        """wo [..., Hq*per, D] -> [..., hp*per, D], same grouped pad + perm."""
        lead, D = w.shape[:-2], w.shape[-1]
        w = w.reshape(*lead, hkv, g_in, per, D)
        w = F.pad(w, (0, 0, 0, 0, 0, g_out - g_in)).reshape(*lead, hp, per, D)
        w = w[..., torch.tensor(perm, device=w.device), :, :]
        return w.reshape(*lead, hp * per, D)

    def tile_kv(w, per):
        """[..., Hkv*per] -> [..., tp*(kg*per)]: chunk c = p*khs + h holds
        kv-head GROUP h (kg = Hkv/khs heads) for every page stripe p."""
        kg = hkv // khs
        lead = w.shape[:-1]
        w = w.reshape(*lead, khs, kg * per)
        w = torch.cat([w] * ps, dim=-2)
        return w.reshape(*lead, tp * kg * per)

    return pad_q, pad_q_rows, tile_kv, perm


# =========================================================================== #
# decode parameter layout
# =========================================================================== #
def to_decode_params(cfg: ModelConfig, params: dict, tp: int) -> dict:
    """Restructure prefill params for the decode step: pad q heads PER KV
    GROUP to the hybrid-sharding layout (grouped pad + chunk permutation),
    tile kv heads across page subgroups, reshape MLA's up-projections per
    head (``wk_b``/``wv_b`` ``[nb, hp, kvr, dn|dv]``, padded and permuted
    like q), and cut the row-parallel weights (``wo`` of attention and FFN)
    into ``[nb, tp, R/tp, D]`` chunks.  MoE FFN leaves pass through as
    they are (no copy); their widths are checked against tp as the
    reference's sharding requires."""
    check_supported(cfg)
    hd = cfg.head_dim_
    hp = attn_tp_geometry(cfg, tp)[0]
    pad_q, pad_q_rows, tile_kv, perm = _head_tools(cfg, tp)
    kinds = cfg.block_pattern()
    for kind in kinds:
        ffn_dims = ((cfg.moe_d_ff_, cfg.moe_d_ff_ * cfg.num_shared_experts)
                    if kind["ffn"] == "moe" else (cfg.d_ff,))
        for f in ffn_dims:
            if f % tp:
                raise ValueError(f"FFN width {f} does not split over tp={tp}")

    def row_chunks(w):
        nb, R, D = w.shape
        return w.reshape(nb, tp, R // tp, D).contiguous()

    def per_head(w, per):
        """[nb, kvr, H*per] -> [nb, hp, kvr, per], padded and permuted."""
        nb, kvr = w.shape[:2]
        w = w.reshape(nb, kvr, cfg.num_heads, per).permute(0, 2, 1, 3)
        w = F.pad(w, (0, 0, 0, 0, 0, hp - cfg.num_heads))
        return w[:, torch.tensor(perm, device=w.device)].contiguous()

    def mla_mixer(mx):
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        m = {"wkv_a": mx["wkv_a"], "kv_norm": mx["kv_norm"],
             "wk_b": per_head(mx["wk_b"], dn), "wv_b": per_head(mx["wv_b"], dv),
             "wo": row_chunks(pad_q_rows(mx["wo"], dv))}
        if cfg.q_lora_rank:
            m.update(wq_a=mx["wq_a"], q_norm=mx["q_norm"],
                     wq_b=pad_q(mx["wq_b"], dn + dr).contiguous())
        else:
            m["wq"] = pad_q(mx["wq"], dn + dr).contiguous()
        return m

    def gqa_mixer(mx):
        m = {"wq": pad_q(mx["wq"], hd).contiguous(),
             "wk": tile_kv(mx["wk"], hd).contiguous(),
             "wv": tile_kv(mx["wv"], hd).contiguous(),
             "wo": row_chunks(pad_q_rows(mx["wo"], hd))}
        if cfg.qkv_bias:        # laid out like the columns they are added to
            m.update(bq=pad_q(mx["bq"], hd).contiguous(),
                     bk=tile_kv(mx["bk"], hd).contiguous(),
                     bv=tile_kv(mx["bv"], hd).contiguous())
        if cfg.qk_norm:         # per-head scales: the same on every head
            m.update(q_norm=mx["q_norm"], k_norm=mx["k_norm"])
        return m

    def conv_layer(lp, kind):
        mx, ffn = lp["mixer"], lp["ffn"]
        mixer = mla_mixer(mx) if cfg.is_mla else gqa_mixer(mx)
        if kind["ffn"] != "moe":
            ffn = {"wi_gate": ffn["wi_gate"], "wi_up": ffn["wi_up"],
                   "wo": row_chunks(ffn["wo"])}
        return {"ln1": lp["ln1"], "ln2": lp["ln2"], "mixer": mixer,
                "ffn": ffn}

    return {"embed": params["embed"],
            "blocks": {"layers": [conv_layer(lp, kind) for lp, kind
                                  in zip(params["blocks"]["layers"], kinds)]},
            "final_norm": params["final_norm"], "head": params["head"]}


# =========================================================================== #
# serve state (KV pools), global [I, tp, ...] tensors
# =========================================================================== #
def init_serve_state(cfg: ModelConfig, dims: DecodeDims, num_instances: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed pools ``k_pool``/``v_pool`` ``[nb, n_attn, I, tp, F', page,
    kg*hd]``, or for MLA one latent ``kv_pool`` ``[..., page, kvr + dr]``;
    the last frame of each sub-pool is the scratch frame the allocator never
    hands out.

    Quantized pools (``dims.kv_dtype`` fp8/int8) hold codes of the storage
    dtype, plus ``k_scale``/``v_scale`` (MLA: ``kv_scale``)
    ``[nb, n_attn, I, tp, F']`` float32 scales set to 1 (any positive value
    works: a frame is always refilled from offset 0 before it is read)."""
    check_supported(cfg)
    check_dims(dims)
    dev = resolve_device(device)
    nb = cfg.num_blocks
    n_attn = sum(1 for k in cfg.block_pattern() if k["mixer"] == "attn")
    _, _, ps = attn_tp_geometry(cfg, dims.tp)
    kg = kv_group_size(cfg, dims.tp)
    fp = -(-(dims.num_frames - 1) // ps) + 1     # frames/stripe + scratch
    width = (cfg.kv_lora_rank + cfg.qk_rope_head_dim if cfg.is_mla
             else kg * cfg.head_dim_)
    shape = (nb, n_attn, num_instances, dims.tp, fp, dims.page, width)
    pools = ("kv_pool",) if cfg.is_mla else ("k_pool", "v_pool")
    scales = ("kv_scale",) if cfg.is_mla else ("k_scale", "v_scale")
    if not quant.is_quantized(dims.kv_dtype):
        return {k: torch.zeros(shape, dtype=dtype, device=dev) for k in pools}
    pdt = quant.kv_storage_dtype(dims.kv_dtype, dtype)
    state = {k: torch.zeros(shape, dtype=pdt, device=dev) for k in pools}
    state.update({k: torch.ones(shape[:5], dtype=torch.float32, device=dev)
                  for k in scales})
    return state


# =========================================================================== #
# step pieces
# =========================================================================== #
def _mask_eos_slots(dims: DecodeDims, tbl: dict, tokens: torch.Tensor) -> dict:
    """Device-side stop-token check (``dims.eos``).

    A slot whose input token equals the stop token can only be the
    speculative step of an EOS finish (the pipelined engine lowers iteration
    t+1 before iteration t's sampled EOS is visible on the host): clearing
    ``slot_active`` for it makes the KV append land in the scratch frame and
    the sampled token come back -1.  The uploaded table is not modified."""
    if dims.eos < 0:
        return tbl
    live = (tbl["slot_active"] != 0) & (tokens != dims.eos)
    return {**tbl, "slot_active": live.to(torch.int32)}


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                  tp: int) -> torch.Tensor:
    """Vocab-sharded embedding: each tp device gathers the rows of its vocab
    slice (zeros elsewhere), then the psum over tp.  embed [Vp, D], tokens
    [I, M] -> [I, M, D]."""
    Vp, D = embed.shape
    vs = Vp // tp
    j = torch.arange(tp, device=tokens.device)[:, None, None]
    local = tokens[None].long() - j * vs                       # [tp, I, M]
    ok = (local >= 0) & (local < vs)
    rows = embed.reshape(tp, vs, D)[j, local.clamp(0, vs - 1)]  # [tp, I, M, D]
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return rows.sum(dim=0)


def _sample_greedy(logits: torch.Tensor, tp: int) -> torch.Tensor:
    """Distributed argmax over the model-sharded vocab: each tp shard's
    first local max, then the first shard holding the overall max (the
    reference's tie-break).  logits [I, M, Vp] -> [I, M] int32."""
    I, M, Vp = logits.shape
    vs = Vp // tp
    lg = logits.reshape(I, M, tp, vs)
    loc_max = lg.amax(dim=-1)                                     # [I, M, tp]
    loc_idx = lg.argmax(dim=-1) + torch.arange(tp, device=logits.device) * vs
    win = loc_max.argmax(dim=-1, keepdim=True)                    # first max
    return torch.gather(loc_idx, -1, win)[..., 0].to(torch.int32)


def _split_pages(bt, length, ps: int, p_j: int, mbt: int, page: int):
    """Stripe each row's global block table onto page stripe ``p_j``.

    bt [..., MB] global frame ids, length [...].  Stripe p_j owns frames
    with f % ps == p_j at local index f // ps.  Owned pages keep position
    order (stable sort), so valid tokens stay a prefix.
    Returns (bt_local [..., mbt], len_local [...]).
    """
    if ps == 1:
        return bt, length
    MB = bt.shape[-1]
    pos = torch.arange(MB, device=bt.device)
    npages = -(-length // page)
    valid = pos < npages[..., None]
    own = valid & ((bt % ps) == p_j)
    order = torch.argsort(torch.where(own, pos, MB + pos), dim=-1,
                          stable=True)[..., :mbt]
    sel = torch.gather(own, -1, order)
    bt_local = torch.where(sel, torch.gather(bt // ps, -1, order),
                           torch.zeros_like(order))
    toks = (length[..., None] - pos * page).clamp(0, page)
    toks_sel = torch.gather(torch.where(own, toks, torch.zeros_like(toks)),
                            -1, order)
    return bt_local.to(bt.dtype), toks_sel.sum(dim=-1).to(length.dtype)


def _dcp_attention(dims: DecodeDims, q, k_pool, v_pool, new_k, new_v, tbl, *,
                   dk: int, dv: int, geom, scale: float, k_scale=None,
                   v_scale=None):
    """Phases 1-4 for one attention layer, every virtual device at once.

    q: [I, tp, M, hl, dk] local-slot queries.  k_pool/v_pool:
    [I, tp, F', page, kg*(dk|dv)] sub-pools (device (i, j) holds kv-head
    group j % khs, page stripe j // khs), updated IN PLACE by this step's
    appends.  new_k/new_v: [I, tp, M, kg*(dk|dv)] this step's token KV.
    MLA passes its latent pool as k_pool with v_pool = new_v = None: v is
    then the view ``k[..., :dv]`` of the same pages, and its scales are
    k_scale's.  k_scale/v_scale: [I, tp, F'] per-page scales iff the pools
    are quantized, updated in place with the appends.  ``scale`` multiplies
    the scores.
    Returns merged [I, tp, M, hl, dv].
    """
    I, tp = dims.data_size, dims.tp
    M, S, N, W = dims.M, dims.S, dims.N, dims.W
    R = dims.num_rounds
    hp, khs, ps = geom
    hl = hp // tp
    Fp, page = k_pool.shape[2], k_pool.shape[3]
    kg = k_pool.shape[-1] // dk
    dev = q.device
    jt = torch.arange(tp, device=dev)
    ii1 = torch.arange(I, device=dev)
    p_of = jt // khs                                  # page stripe of device j
    dense = dims.backend == "dense" and R > 0
    # instance i's zig-zag ring segment starts at node0[i] (dense backend)
    node0 = (ii1 // W) * W

    # -- KV append (write-then-attend) --
    # Only the frame's stripe owner writes; everyone else (and inactive
    # slots) writes into the local scratch frame (last frame of the
    # sub-pool, never handed out by the allocator).  Scratch rows may repeat
    # (offsets arange(M) % page), which leaves that frame undefined — it is
    # never read.
    act = (tbl["slot_active"] != 0)[:, None, :].expand(I, tp, M)
    af_g = tbl["append_frame"].long()[:, None, :]
    mine = act & ((af_g % ps) == p_of[None, :, None]) if ps > 1 else act
    af = torch.where(mine, af_g // ps, torch.full_like(af_g, Fp - 1))
    ao = torch.where(mine, tbl["append_off"].long()[:, None, :],
                     (torch.arange(M, device=dev) % page)[None, None, :])
    ii = ii1[:, None, None]
    jj = jt[None, :, None]
    appends = [(k_pool, k_scale, new_k)]
    if v_pool is not None:
        appends.append((v_pool, v_scale, new_v))
    for pool, sc, new in appends:
        if sc is None:
            pool[ii, jj, af, ao] = new.to(pool.dtype)
        else:
            # offset-0 rule: an append at offset 0 starts the page with this
            # token's amax/qmax; a later one clips into the page's scale.
            # Rows that repeat only hit the scratch frame, never read
            quant.write_offset0(pool, (ii, jj, af, ao), sc, (ii, jj, af), new,
                                quant.amax_scale(new, dims.kv_dtype), ao == 0,
                                dims.kv_dtype)

    # -- Phase 1: Q-routing over the zig-zag ring --
    if dense:
        # all-gather baseline: every instance holds every peer's q buffer
        # and picks the rows the routed backend would have received from
        # round d's sender
        recv_q = []
        for d in range(1, R + 1):
            src = node0 + (ii1 - node0 - int(comm.ring_delta(d))) % W
            recv_q.append(comm.gather_rows(comm.allgather_backend(q, src),
                                           tbl["q_recv_slot"][:, d - 1]))
    elif R > 0:
        recv_q = comm.route_rounds(lambda d, idx: comm.gather_rows(q, idx),
                                   tbl["q_send_idx"], R, node=W)
    else:
        recv_q = []
    q_pool = torch.cat([q] + recv_q, dim=2) if recv_q else q

    # -- Phase 2: paged attention, one launch for the whole virtual mesh --
    q_work = comm.gather_rows(q_pool, tbl["work_src"])          # [I,tp,N,hl,dk]
    if ps > 1:
        # all_gather over the stripe subgroup: device j sees the q heads of
        # every stripe p of its kv-head group (heads were chunk-permuted by
        # to_decode_params, so ascending p concatenates in head order)
        q_grp = q_work.reshape(I, ps, khs, N, hl, dk).permute(0, 2, 3, 1, 4, 5)
        q_work = q_grp.reshape(I, khs, N, ps * hl, dk)[:, jt % khs]
        mbt = dims.MBT or dims.MB
        per_p = [_split_pages(tbl["work_bt"], tbl["work_len"], ps, p, mbt, page)
                 for p in range(ps)]
        bt_dev = torch.stack([b for b, _ in per_p], dim=1)[:, p_of]
        len_dev = torch.stack([n for _, n in per_p], dim=1)[:, p_of]
    else:
        bt_dev = tbl["work_bt"][:, None].expand(I, tp, N, tbl["work_bt"].shape[-1])
        len_dev = tbl["work_len"][:, None].expand(I, tp, N)
    Gq = q_work.shape[3]
    # flatten (I, tp, F') into one page axis: device (i, j) owns pages
    # [(i*tp + j) * F', (i*tp + j + 1) * F')
    dev_off = ((ii1[:, None] * tp + jt[None, :]) * Fp)
    bt_flat = (bt_dev + dev_off[..., None, None].to(bt_dev.dtype)).reshape(
        I * tp * N, -1).to(torch.int32)
    # q stays in the model dtype; unquantized pools share it
    q_flat = q_work.reshape(I * tp * N, Gq, dk)
    if k_scale is None:
        q_flat = q_flat.to(k_pool.dtype)
    kp = k_pool.reshape(I * tp * Fp, page, kg, dk)
    ks = None if k_scale is None else k_scale.reshape(-1)
    if v_pool is None:
        # MLA: v is the latent's first dv dims, a strided view (never a
        # copy), read with the latent's scales
        vp, vs = kp[..., :dv], ks
    else:
        vp = v_pool.reshape(I * tp * Fp, page, kg, dv)
        vs = None if v_scale is None else v_scale.reshape(-1)
    out, lse = ops.paged_decode_attention(
        q_flat, kp, vp, bt_flat, len_dev.reshape(-1).to(torch.int32),
        scale=scale, k_scale=ks, v_scale=vs)
    out = out.reshape(I, tp, N, Gq, dv)
    lse = lse.reshape(I, tp, N, Gq)
    if ps > 1:
        # merge the stripe partials within the subgroup, keep own hl heads
        g_o = out.reshape(I, ps, khs, N, Gq, dv).transpose(0, 1)
        g_l = lse.reshape(I, ps, khs, N, Gq).transpose(0, 1)
        mo, ml = ops.merge_lse(g_o, g_l)                       # [I,khs,N,Gq,*]
        mo = mo.reshape(I, khs, N, ps, hl, dv)
        ml = ml.reshape(I, khs, N, ps, hl)
        out = torch.stack([mo[:, j % khs, :, j // khs] for j in range(tp)], 1)
        lse = torch.stack([ml[:, j % khs, :, j // khs] for j in range(tp)], 1)

    # -- Phases 3+4, dense baseline: every peer's partials, indexed by the
    #    owner tables (merge_round / merge_peer_row) --
    if dense:
        owner = (node0[:, None, None]
                 + (ii1[:, None, None] - node0[:, None, None]
                    + comm.ring_delta(tbl["merge_round"].long())) % W)
        row = tbl["merge_peer_row"].long()                       # [I, M, W]
        parts = comm.allgather_backend(out, owner, row.clamp(min=0))
        plse = comm.allgather_backend(lse, owner, row.clamp(min=0))
        mask = (row >= 0)[:, None].expand(I, tp, M, W)
        merged, _ = ops.merge_lse(parts.permute(3, 0, 1, 2, 4, 5),
                                  plse.permute(3, 0, 1, 2, 4),
                                  mask=mask.permute(3, 0, 1, 2))
        return merged.to(q.dtype)

    # -- Phase 3: Res-routing (reverse rotations) --
    if R > 0:
        ret_o = comm.route_rounds(lambda d, idx: comm.gather_rows(out, idx),
                                  tbl["ret_send_idx"], R, node=W, reverse=True)
        ret_l = comm.route_rounds(lambda d, idx: comm.gather_rows(lse, idx),
                                  tbl["ret_send_idx"], R, node=W, reverse=True)
        o_pool = torch.cat([out] + ret_o, dim=2)
        l_pool = torch.cat([lse] + ret_l, dim=2)
    else:
        o_pool, l_pool = out, lse

    # -- Phase 4: LSE merge per slot --
    msrc = tbl["merge_src"].reshape(I, M * W)
    parts = comm.gather_rows(o_pool, msrc).reshape(I, tp, M, W, hl, dv)
    plse = comm.gather_rows(l_pool, msrc).reshape(I, tp, M, W, hl)
    mask = (tbl["merge_src"] >= 0)[:, None].expand(I, tp, M, W)
    merged, _ = ops.merge_lse(parts.permute(3, 0, 1, 2, 4, 5),
                              plse.permute(3, 0, 1, 2, 4),
                              mask=mask.permute(3, 0, 1, 2))
    return merged.to(q.dtype)


def _to_rows(o: torch.Tensor, tp: int) -> torch.Tensor:
    """[I, tp, M, hl, d] per-device head outputs -> [tp, I*M, hl*d], the
    left operand of the row-parallel ``wo`` chunks."""
    I, _, M, hl, d = o.shape
    return o.reshape(I, tp, M, hl * d).transpose(0, 1).reshape(tp, I * M,
                                                                hl * d)


def _attn_layer(cfg: ModelConfig, dims: DecodeDims, lp: dict, x, pools,
                tbl: dict, geom):
    """One GQA attention layer for every device.  x: [I*M, D] (identical on
    each tp device); pools = (k_pool, v_pool, k_scale, v_scale), the scales
    None for unquantized pools.  Returns the layer output [I*M, D] after
    the psum."""
    I, tp, M = dims.data_size, dims.tp, dims.M
    hd = cfg.head_dim_
    hl = geom[0] // tp
    kg = kv_group_size(cfg, tp)
    mx = lp["mixer"]
    h = L.apply_norm(cfg, lp["ln1"], x)
    q, k, v = h @ mx["wq"], h @ mx["wk"], h @ mx["wv"]
    if cfg.qkv_bias:
        q = q + mx["bq"].to(q.dtype)
        k = k + mx["bk"].to(k.dtype)
        v = v + mx["bv"].to(v.dtype)
    q = q.reshape(I, M, tp, hl, hd).transpose(1, 2)
    k = k.reshape(I, M, tp, kg, hd).transpose(1, 2)
    v = v.reshape(I, M, tp, kg * hd).transpose(1, 2)
    if cfg.qk_norm:             # per head, before rope
        q = L.rms_norm_vec(q, mx["q_norm"])
        k = L.rms_norm_vec(k, mx["k_norm"])
    pos = tbl["slot_pos"][:, None, :]                           # [I, 1, M]
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta).reshape(I, tp, M, kg * hd)
    merged = _dcp_attention(dims, q, pools[0], pools[1], k, v, tbl, dk=hd,
                            dv=hd, geom=geom, scale=hd ** -0.5,
                            k_scale=pools[2],
                            v_scale=pools[3])                   # [I,tp,M,hl,hd]
    return torch.bmm(_to_rows(merged, tp), mx["wo"]).sum(dim=0)  # psum over tp


def _mla_layer(cfg: ModelConfig, dims: DecodeDims, lp: dict, x, pools,
               tbl: dict, geom):
    """One MLA layer for every device (the reference's absorbed decode).
    q_lat = q_nope . wk_b[h] joins q_rope as the [kvr + dr] latent query;
    the token's latent [c_kv | k_rope] is appended to the one latent pool;
    the merged latent output goes through wv_b[h] and the row-parallel wo,
    summed over tp.  pools = (kv_pool, None, kv_scale or None, None)."""
    I, tp, M = dims.data_size, dims.tp, dims.M
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    hl = geom[0] // tp
    mx = lp["mixer"]
    h = L.apply_norm(cfg, lp["ln1"], x)
    pos = tbl["slot_pos"][:, None, :]                           # [I, 1, M]
    if cfg.q_lora_rank:
        qn = L.rms_norm_vec(h @ mx["wq_a"], mx["q_norm"]) @ mx["wq_b"]
    else:
        qn = h @ mx["wq"]
    qn = qn.reshape(I, M, tp, hl, dn + dr).transpose(1, 2)      # [I,tp,M,hl,*]
    q_rope = L.apply_rope(qn[..., dn:], pos, cfg.rope_theta)
    q_lat = torch.einsum("itmhd,thkd->itmhk", qn[..., :dn],
                         mx["wk_b"].reshape(tp, hl, kvr, dn))
    q = torch.cat([q_lat, q_rope], dim=-1)                      # [.., kvr+dr]
    kv = h @ mx["wkv_a"]
    c_kv = L.rms_norm_vec(kv[..., :kvr], mx["kv_norm"])
    k_rope = L.apply_rope(kv[..., kvr:][:, None, :],
                          tbl["slot_pos"].reshape(I * M),
                          cfg.rope_theta)[:, 0, :]
    new_k = torch.cat([c_kv, k_rope], dim=-1).reshape(I, 1, M, kvr + dr)
    merged = _dcp_attention(dims, q, pools[0], None,
                            new_k.expand(I, tp, M, kvr + dr), None, tbl,
                            dk=kvr + dr, dv=kvr, geom=geom,
                            scale=(dn + dr) ** -0.5,
                            k_scale=pools[2])                   # [I,tp,M,hl,kvr]
    o = torch.einsum("itmhk,thkd->itmhd", merged,
                     mx["wv_b"].reshape(tp, hl, kvr, dv))
    return torch.bmm(_to_rows(o, tp), mx["wo"]).sum(dim=0)      # psum over tp


def build_decode_step(cfg: ModelConfig, dims: DecodeDims):
    """Returns ``step(params, state, tables) -> (state, next_tokens [I, M],
    logits [I, M, Vp])`` over the whole virtual mesh.

    ``params`` is the ``to_decode_params`` layout, ``state`` the
    ``init_serve_state`` pools and, for quantized pools, their scales
    (updated IN PLACE — the counterpart of the reference's donated state),
    ``tables`` the uploaded routing tables.
    """
    check_supported(cfg)
    check_dims(dims)
    pattern = cfg.block_pattern()
    if cfg.is_moe and cfg.num_experts % dims.data_size:
        raise ValueError(f"num_experts={cfg.num_experts} does not split over "
                         f"{dims.data_size} instances")
    geom = attn_tp_geometry(cfg, dims.tp)
    I, M, tp = dims.data_size, dims.M, dims.tp
    layer = _mla_layer if cfg.is_mla else _attn_layer
    names = (("kv_pool", None, "kv_scale", None) if cfg.is_mla
             else ("k_pool", "v_pool", "k_scale", "v_scale"))

    def step(params, state, tbl):
        tokens = tbl["slot_token"]                                # [I, M]
        tbl = _mask_eos_slots(dims, tbl, tokens)
        emb = params["embed"]["tok"]
        x = _embed_lookup(emb, tokens, tp).to(emb.dtype).reshape(I * M, -1)
        for bi in range(cfg.num_blocks):
            bp = block_slice(params["blocks"], bi)
            for li, kind in enumerate(pattern):
                lp = bp["layers"][li]
                pools = tuple(None if n is None or n not in state
                              else state[n][bi, li] for n in names)
                x = x + layer(cfg, dims, lp, x, pools, tbl, geom)
                if kind["ffn"] == "none":
                    continue
                h = L.apply_norm(cfg, lp["ln2"], x)
                if kind["ffn"] == "moe":
                    x = x + moe_decode_ffn(cfg, lp["ffn"], h, data_size=I,
                                           tp=tp)
                else:
                    x = x + dense_decode_ffn(cfg, lp["ffn"], h, tp)
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = L.apply_head(cfg, params["head"], params["embed"], x)
        logits = logits.float().reshape(I, M, -1)
        nxt = _sample_greedy(logits, tp)
        nxt = torch.where(tbl["slot_active"] != 0, nxt, torch.full_like(nxt, -1))
        return state, nxt, logits

    return step
