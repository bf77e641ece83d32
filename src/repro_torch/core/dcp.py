"""DCP decode step (§5) on a virtual (instance, tp) mesh
(port of ``repro/core/dcp.py``: the dense GQA, MLA and SSD paths, dense
and MoE FFNs, routed and dense backends, and the encoder-decoder step).

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
fp8 decode weights (``quantize_decode_weights``) are cast back to bf16 at
the top of each block.

SSM layers (Mamba-2, and Jamba's seven of eight) carry per-slot state
instead of KV: conv windows ``conv_x``/``conv_B``/``conv_C``
``[nb, n_ssm, I, M, cw-1, ·]`` and ``ssm_state`` ``[nb, n_ssm, I, M, nh,
hd, ns]`` float32, pinned to the request's decode slot and updated in
place by each step.  Heads and d_inner are TP over the virtual devices as
in the reference (B and C replicated); the gated RMSNorm sums each
device's squares over tp before it normalises over the whole d_inner, and
``out_proj`` is row-parallel.  Pools are indexed by attention ordinal and
SSM state by SSM ordinal within a block.  Mamba-2 has no attention and no
pools.

The encoder-decoder (whisper) step runs DCP over the cross-attention KV:
the encoder states' projections live in paged cross pools
``cross_k_pool``/``cross_v_pool`` ``[L, I, tp, F', page, kg*hd]``, placed
by DCP like a prompt's KV and READ-ONLY during decode (``_dcp_attention``
with ``new_k=None``: no append, no scratch-frame write); the decoder's
self-attention KV is a small per-slot contiguous cache ``self_k``/
``self_v`` ``[L, I, tp, M, T, kg*hd]`` (T = ``max_target_positions``),
written at the slot's decoder position and attended over ``[0, pos]`` by
plain torch (``ref.decode_attention_dense``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import ModelConfig
from ..kernels import ops, quant, ref
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
    pods: int = 1                    # independent serving groups on the
                                     # instance axis (multi-pod cells): each
                                     # pod's data_size/pods instances hold
                                     # all experts (the reference's `pod`
                                     # axis); rotations stay in W windows

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
def _row_chunks(w: torch.Tensor, tp: int) -> torch.Tensor:
    """A stacked row-parallel weight [nb, R, D] as tp chunks [nb, tp, R/tp,
    D]."""
    nb, R, D = w.shape
    return w.reshape(nb, tp, R // tp, D).contiguous()


def _gqa_decode_params(cfg: ModelConfig, mx: dict, tp: int) -> dict:
    """A stacked GQA attention's decode layout: q heads (and ``bq``) padded
    per kv group and chunk-permuted, kv heads (and ``bk``/``bv``) tiled
    over page stripes, ``wo`` padded likewise and cut into ``[nb, tp,
    R/tp, D]`` row chunks; qk-norm scales pass through."""
    hd = cfg.head_dim_
    pad_q, pad_q_rows, tile_kv, _ = _head_tools(cfg, tp)
    m = {"wq": pad_q(mx["wq"], hd).contiguous(),
         "wk": tile_kv(mx["wk"], hd).contiguous(),
         "wv": tile_kv(mx["wv"], hd).contiguous(),
         "wo": _row_chunks(pad_q_rows(mx["wo"], hd), tp)}
    if cfg.qkv_bias:            # laid out like the columns they are added to
        m.update(bq=pad_q(mx["bq"], hd).contiguous(),
                 bk=tile_kv(mx["bk"], hd).contiguous(),
                 bv=tile_kv(mx["bv"], hd).contiguous())
    if cfg.qk_norm:             # per-head scales: the same on every head
        m.update(q_norm=mx["q_norm"], k_norm=mx["k_norm"])
    return m


_QUANT_SKIP = frozenset({"ln1", "ln2", "final_norm", "router", "q_norm",
                         "k_norm", "kv_norm", "norm", "A_log", "D", "dt_bias",
                         "embed", "head"})   # embeddings feed activations


def quantize_decode_weights(dparams: dict,
                            dtype=torch.float8_e4m3fn) -> dict:
    """Store the large decode matrices in ``dtype`` (fp8 e4m3), the
    reference's rule: every bfloat16 leaf of at least 2 dims and 65,536
    values whose path names none of ``_QUANT_SKIP`` (norm scales, the SSD
    vectors, routers, embeddings and head stay as they are).  A plain
    cast, no scale; the step casts each block's fp8 leaves back to
    bfloat16 at use (``build_decode_step``).  Leaves that stay are the
    same tensors."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        if (tree.dim() >= 2 and tree.numel() >= 65_536
                and not set(path) & _QUANT_SKIP
                and tree.dtype == torch.bfloat16):
            return tree.to(dtype)
        return tree

    return walk(dparams, ())


def dequantize_at_use(tree):
    """A block's fp8 leaves cast to bfloat16 (the others as they are)."""
    if isinstance(tree, dict):
        return {k: dequantize_at_use(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dequantize_at_use(v) for v in tree]
    return (tree.to(torch.bfloat16) if tree.dtype == torch.float8_e4m3fn
            else tree)


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
    hp = attn_tp_geometry(cfg, tp)[0]
    pad_q, pad_q_rows, _, perm = _head_tools(cfg, tp)
    kinds = cfg.block_pattern()
    for kind in kinds:
        ffn_dims = {"moe": (cfg.moe_d_ff_,
                            cfg.moe_d_ff_ * cfg.num_shared_experts),
                    "dense": (cfg.d_ff,), "none": ()}[kind["ffn"]]
        for f in ffn_dims:
            if f % tp:
                raise ValueError(f"FFN width {f} does not split over tp={tp}")
    if any(k["mixer"] == "ssm" for k in kinds) and cfg.ssm_num_heads % tp:
        raise ValueError(f"{cfg.ssm_num_heads} SSM heads do not split over "
                         f"tp={tp}")

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
             "wo": _row_chunks(pad_q_rows(mx["wo"], dv), tp)}
        if cfg.q_lora_rank:
            m.update(wq_a=mx["wq_a"], q_norm=mx["q_norm"],
                     wq_b=pad_q(mx["wq_b"], dn + dr).contiguous())
        else:
            m["wq"] = pad_q(mx["wq"], dn + dr).contiguous()
        return m

    def ssm_mixer(mx):
        """in_proj split by sharding class into column views (no copy):
        z, x and dt are TP over heads, B and C replicated; the conv weights
        and biases likewise into their x, B and C parts."""
        din, ns = cfg.ssm_d_inner, cfg.ssm_state
        cut = [din, din, ns, ns, mx["in_proj"].shape[-1] - 2 * din - 2 * ns]
        m = dict(zip(("wz", "wx", "wB", "wC", "wdt"),
                     torch.split(mx["in_proj"], cut, dim=-1)))
        for name, w in (("conv", mx["conv_w"]), ("convb", mx["conv_b"])):
            m.update(zip((f"{name}_x", f"{name}_B", f"{name}_C"),
                         torch.split(w, [din, ns, ns], dim=-1)))
        m.update({k: mx[k] for k in ("A_log", "D", "dt_bias", "norm")})
        m["out_proj"] = _row_chunks(mx["out_proj"], tp)
        return m

    def conv_layer(lp, kind):
        mx = lp["mixer"]
        if kind["mixer"] == "ssm":
            mixer = ssm_mixer(mx)
        else:
            mixer = (mla_mixer(mx) if cfg.is_mla
                     else _gqa_decode_params(cfg, mx, tp))
        out = {"ln1": lp["ln1"], "mixer": mixer}
        if kind["ffn"] != "none":
            ffn = lp["ffn"]
            if kind["ffn"] == "dense":
                ffn = {"wi_gate": ffn["wi_gate"], "wi_up": ffn["wi_up"],
                       "wo": _row_chunks(ffn["wo"], tp)}
            out.update(ln2=lp["ln2"], ffn=ffn)
        return out

    return {"embed": params["embed"],
            "blocks": {"layers": [conv_layer(lp, kind) for lp, kind
                                  in zip(params["blocks"]["layers"], kinds)]},
            "final_norm": params["final_norm"], "head": params["head"]}


# =========================================================================== #
# serve state (KV pools, SSM state), global [I, ...] tensors
# =========================================================================== #
SSM_STATE = ("conv_x", "conv_B", "conv_C", "ssm_state")
# pool dtypes read as codes with a unit scale when no scales are kept
RAW_CODE_DTYPES = (torch.float8_e4m3fn, torch.int8)


def init_serve_state(cfg: ModelConfig, dims: DecodeDims, num_instances: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed pools ``k_pool``/``v_pool`` ``[nb, n_attn, I, tp, F', page,
    kg*hd]``, or for MLA one latent ``kv_pool`` ``[..., page, kvr + dr]``;
    the last frame of each sub-pool is the scratch frame the allocator never
    hands out.

    Quantized pools (``dims.kv_dtype`` fp8/int8) hold codes of the storage
    dtype, plus ``k_scale``/``v_scale`` (MLA: ``kv_scale``)
    ``[nb, n_attn, I, tp, F']`` float32 scales set to 1 (any positive value
    works: a frame is always refilled from offset 0 before it is read).

    A float8 ``dtype`` with ``kv_dtype`` "bf16" gives raw code pools, no
    scales: the paged kernel reads them with a unit scale, as the
    reference's does.

    SSM layers add their per-slot state: conv windows ``conv_x``,
    ``conv_B``, ``conv_C`` ``[nb, n_ssm, I, M, cw-1, din | ns | ns]`` in
    ``dtype`` (bfloat16 when ``dtype`` is fp8; never quantized) and
    ``ssm_state`` ``[nb, n_ssm, I, M, nh, hd, ns]`` float32.  An
    attention-free model has no pools."""
    check_supported(cfg)
    check_dims(dims)
    dev = resolve_device(device)
    nb, I = cfg.num_blocks, num_instances
    pattern = cfg.block_pattern()
    n_attn = sum(1 for k in pattern if k["mixer"] == "attn")
    n_ssm = len(pattern) - n_attn
    state = {}
    if n_attn:
        _, _, ps = attn_tp_geometry(cfg, dims.tp)
        kg = kv_group_size(cfg, dims.tp)
        fp = -(-(dims.num_frames - 1) // ps) + 1     # frames/stripe + scratch
        width = (cfg.kv_lora_rank + cfg.qk_rope_head_dim if cfg.is_mla
                 else kg * cfg.head_dim_)
        shape = (nb, n_attn, I, dims.tp, fp, dims.page, width)
        pools = ("kv_pool",) if cfg.is_mla else ("k_pool", "v_pool")
        scales = ("kv_scale",) if cfg.is_mla else ("k_scale", "v_scale")
        pdt = quant.kv_storage_dtype(dims.kv_dtype, dtype)
        state = {k: torch.zeros(shape, dtype=pdt, device=dev) for k in pools}
        if quant.is_quantized(dims.kv_dtype):
            state.update({k: torch.ones(shape[:5], dtype=torch.float32,
                                        device=dev) for k in scales})
    if n_ssm:
        din, ns = cfg.ssm_d_inner, cfg.ssm_state
        lead = (nb, n_ssm, I, dims.M, cfg.ssm_conv_width - 1)
        # raw fp8 pools are an attention-cache format: SSM state keeps bf16
        cdt = torch.bfloat16 if dtype == torch.float8_e4m3fn else dtype
        for name, width in zip(SSM_STATE, (din, ns, ns)):
            state[name] = torch.zeros(lead + (width,), dtype=cdt, device=dev)
        state["ssm_state"] = torch.zeros(
            (nb, n_ssm, I, dims.M, cfg.ssm_num_heads, cfg.ssm_head_dim, ns),
            dtype=torch.float32, device=dev)
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


def _work_tables(dims: DecodeDims, tbl: dict, geom, Fp: int, page: int):
    """The paged call's block tables and lengths for every virtual device:
    (bt [I*tp*N, MB or MBT] int32, lengths [I*tp*N] int32).  With page
    stripes (ps > 1) device j reads the pages of its stripe p_j = j // khs
    (``_split_pages``).  Pools are flattened over (I, tp, F'): device
    (i, j) owns pages [(i*tp + j) * F', (i*tp + j + 1) * F')."""
    I, tp, N = dims.data_size, dims.tp, dims.N
    _, khs, ps = geom
    dev = tbl["work_bt"].device
    jt = torch.arange(tp, device=dev)
    ii1 = torch.arange(I, device=dev)
    if ps > 1:
        mbt = dims.MBT or dims.MB
        per_p = [_split_pages(tbl["work_bt"], tbl["work_len"], ps, p, mbt,
                              page) for p in range(ps)]
        p_of = jt // khs                              # page stripe of device j
        bt_dev = torch.stack([b for b, _ in per_p], dim=1)[:, p_of]
        len_dev = torch.stack([n for _, n in per_p], dim=1)[:, p_of]
    else:
        bt_dev = tbl["work_bt"][:, None].expand(I, tp, N,
                                                tbl["work_bt"].shape[-1])
        len_dev = tbl["work_len"][:, None].expand(I, tp, N)
    dev_off = ((ii1[:, None] * tp + jt[None, :]) * Fp)
    bt_flat = (bt_dev + dev_off[..., None, None].to(bt_dev.dtype)).reshape(
        I * tp * N, -1).to(torch.int32)
    return bt_flat, len_dev.reshape(-1).to(torch.int32)


def _dcp_attention(dims: DecodeDims, q, k_pool, v_pool, new_k, new_v, tbl, *,
                   dk: int, dv: int, geom, scale: float, k_scale=None,
                   v_scale=None):
    """Phases 1-4 for one attention layer, every virtual device at once.

    q: [I, tp, M, hl, dk] local-slot queries.  k_pool/v_pool:
    [I, tp, F', page, kg*(dk|dv)] sub-pools (device (i, j) holds kv-head
    group j % khs, page stripe j // khs), updated IN PLACE by this step's
    appends.  new_k/new_v: [I, tp, M, kg*(dk|dv)] this step's token KV, or
    new_k = new_v = None for read-only pools (whisper's cross-attention:
    nothing is written, the scratch frame included).
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

    if new_k is not None:
        # -- KV append (write-then-attend) --
        # Only the frame's stripe owner writes; everyone else (and
        # inactive slots) writes into the local scratch frame (last frame of
        # the sub-pool, never handed out by the allocator).  Scratch rows
        # may repeat (offsets arange(M) % page), which leaves that frame
        # undefined — it is never read.
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
                # offset-0 rule: an append at offset 0 starts the page with
                # this token's amax/qmax; a later one clips into the page's
                # scale.  Rows that repeat only hit the scratch frame, never
                # read
                quant.write_offset0(pool, (ii, jj, af, ao), sc, (ii, jj, af),
                                    new, quant.amax_scale(new, dims.kv_dtype),
                                    ao == 0, dims.kv_dtype)

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
    Gq = q_work.shape[3]
    # the block tables depend on the tables and the pool geometry only:
    # made once per step and shared by every layer whose pools match
    key = ("work_tables", geom, Fp, page)
    if key not in tbl:
        tbl[key] = _work_tables(dims, tbl, geom, Fp, page)
    bt_flat, len_flat = tbl[key]
    # q stays in the model dtype; unquantized pools share it.  Raw fp8 or
    # int8 pools without scales (a pool dtype passed to init_serve_state
    # with kv_dtype "bf16") are read with a unit scale, as the reference's
    # kernel upcasts them
    q_flat = q_work.reshape(I * tp * N, Gq, dk)
    if k_scale is None and k_pool.dtype not in RAW_CODE_DTYPES:
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
        q_flat, kp, vp, bt_flat, len_flat, scale=scale, k_scale=ks,
        v_scale=vs)
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


def _heads(cfg: ModelConfig, dims: DecodeDims, mx: dict, h, hl: int,
           kv: bool):
    """A decode attention's projections for every device: q [I, tp, M, hl,
    hd] and, with ``kv``, the token's k and v [I, tp, M, kg*hd] (the
    column chunks of the tiled kv weights)."""
    I, tp, M, hd = dims.data_size, dims.tp, dims.M, cfg.head_dim_
    q = h @ mx["wq"]
    if cfg.qkv_bias:
        q = q + mx["bq"].to(q.dtype)
    q = q.reshape(I, M, tp, hl, hd).transpose(1, 2)
    if not kv:
        return q
    k, v = h @ mx["wk"], h @ mx["wv"]
    if cfg.qkv_bias:
        k = k + mx["bk"].to(k.dtype)
        v = v + mx["bv"].to(v.dtype)
    return (q, k.reshape(I, M, tp, -1).transpose(1, 2),
            v.reshape(I, M, tp, -1).transpose(1, 2))


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
    q, k, v = _heads(cfg, dims, mx, h, hl, kv=True)
    k = k.reshape(I, tp, M, kg, hd)
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


def _ssm_layer(cfg: ModelConfig, dims: DecodeDims, lp: dict, x, sstate):
    """One SSD decode layer for every device (heads TP over the virtual
    devices, B and C replicated).  x: [I*M, D]; sstate = (conv_x, conv_B,
    conv_C, ssm_state), this layer's [I, M, ...] views of the serve state,
    updated IN PLACE.  Returns the layer output [I*M, D] after the psum."""
    I, tp, M = dims.data_size, dims.tp, dims.M
    din, hd = cfg.ssm_d_inner, cfg.ssm_head_dim
    mx = lp["mixer"]
    conv_x, conv_B, conv_C, h_state = sstate
    h = L.apply_norm(cfg, lp["ln1"], x)
    z = h @ mx["wz"]                          # [I*M, din]: din/tp per device
    dt = h @ mx["wdt"]                        # [I*M, nh]: nh/tp per device

    def conv1(state, new, w, b):
        """Depthwise conv over the window [state | new]; the window's last
        cw-1 rows become the state."""
        win = torch.cat([state.reshape(I * M, *state.shape[2:]),
                         new[:, None, :]], dim=1)               # [I*M, cw, c]
        out = torch.einsum("mwc,wc->mc", win.float(), w.float()) + b
        state.copy_(win[:, 1:].reshape(state.shape))
        return F.silu(out).to(new.dtype)

    xin = conv1(conv_x, h @ mx["wx"], mx["conv_x"], mx["convb_x"])
    Bm = conv1(conv_B, h @ mx["wB"], mx["conv_B"], mx["convb_B"]).float()
    Cm = conv1(conv_C, h @ mx["wC"], mx["conv_C"], mx["convb_C"]).float()

    dtp = F.softplus(dt.float() + mx["dt_bias"])
    A = -torch.exp(mx["A_log"])
    xh = xin.reshape(I * M, -1, hd).float()
    decay = torch.exp(dtp * A)
    upd = torch.einsum("ms,mh,mhd->mhds", Bm, dtp, xh)
    h_new = h_state.reshape(I * M, *h_state.shape[2:]) * decay[..., None, None]
    h_new = h_new + upd
    h_state.copy_(h_new.reshape(h_state.shape))
    y = torch.einsum("ms,mhds->mhd", Cm, h_new)
    y = (y + xh * mx["D"][None, :, None]).reshape(I * M, din).to(x.dtype)
    # gated RMSNorm over the FULL d_inner: each device's sum of squares over
    # its din/tp channels, summed over tp (the reference's psum)
    g = (y * F.silu(z)).float().reshape(I * M, tp, din // tp)
    ss = g.square().sum(dim=-1, keepdim=True).sum(dim=1, keepdim=True)
    g = g * torch.rsqrt(ss / din + 1e-6) * mx["norm"].reshape(tp, din // tp)
    rows = g.to(x.dtype).transpose(0, 1)                 # [tp, I*M, din/tp]
    return torch.bmm(rows, mx["out_proj"]).sum(dim=0)    # psum over tp


def _pod_moe_ffn(cfg: ModelConfig, dims: DecodeDims, p: dict, h, fill):
    """The wide-EP MoE FFN, each pod's instances an expert group of their
    own (one group when ``dims.pods`` is 1).  ``fill`` [I, E] receives each
    (instance, expert) bin's kept rows."""
    ep = dims.data_size // dims.pods
    if dims.pods == 1:
        return moe_decode_ffn(cfg, p, h, data_size=ep, tp=dims.tp, fill=fill)
    return torch.cat([moe_decode_ffn(cfg, p, hp, data_size=ep, tp=dims.tp,
                                     fill=fp)
                      for hp, fp in zip(h.chunk(dims.pods),
                                        fill.chunk(dims.pods))])


def build_decode_step(cfg: ModelConfig, dims: DecodeDims):
    """Returns ``step(params, state, tables) -> (state, next_tokens [I, M],
    logits [I, M, Vp])`` over the whole virtual mesh.

    ``params`` is the ``to_decode_params`` layout, ``state`` the
    ``init_serve_state`` pools and, for quantized pools, their scales
    (updated IN PLACE — the counterpart of the reference's donated state),
    ``tables`` the uploaded routing tables.

    fp8 leaves (``quantize_decode_weights``) are cast to bfloat16 at the top
    of each block, right after ``block_slice``, as the reference does;
    nothing else in the step sees the storage format.

    Each call also writes the kept rows of every (MoE layer, instance,
    expert) bin, in layer order, into ``step.expert_bins`` [L_moe, I, E]
    int32 on the step's device (None for a model without MoE layers).  The
    tensor is made at the first call and written in place after, so a CUDA
    graph of the step rewrites it at each replay; nothing waits on it.
    """
    check_supported(cfg)
    check_dims(dims)
    pattern = cfg.block_pattern()
    if dims.data_size % dims.pods:
        raise ValueError(f"{dims.data_size} instances do not split into "
                         f"{dims.pods} pods")
    ep = dims.data_size // dims.pods         # instances per expert group
    if cfg.is_moe and cfg.num_experts % ep:
        raise ValueError(f"num_experts={cfg.num_experts} does not split over "
                         f"{ep} instances")
    geom = attn_tp_geometry(cfg, dims.tp)
    I, M, tp = dims.data_size, dims.M, dims.tp
    attn_layer = _mla_layer if cfg.is_mla else _attn_layer
    names = (("kv_pool", None, "kv_scale", None) if cfg.is_mla
             else ("k_pool", "v_pool", "k_scale", "v_scale"))
    moe_layers = cfg.num_blocks * sum(k["ffn"] == "moe" for k in pattern)

    def step(params, state, tbl):
        tokens = tbl["slot_token"]                                # [I, M]
        # a copy: _dcp_attention memoizes its block tables in it
        tbl = dict(_mask_eos_slots(dims, tbl, tokens))
        emb = params["embed"]["tok"]
        x = _embed_lookup(emb, tokens, tp).to(emb.dtype).reshape(I * M, -1)
        if moe_layers and step.expert_bins is None:
            step.expert_bins = torch.zeros((moe_layers, I, cfg.num_experts),
                                           dtype=torch.int32, device=x.device)
        mi = 0                        # MoE layer ordinal in the step
        for bi in range(cfg.num_blocks):
            bp = dequantize_at_use(block_slice(params["blocks"], bi))
            ai = si = 0               # attention / SSM ordinal in the block
            for li, kind in enumerate(pattern):
                lp = bp["layers"][li]
                if kind["mixer"] == "attn":
                    pools = tuple(None if n is None or n not in state
                                  else state[n][bi, ai] for n in names)
                    x = x + attn_layer(cfg, dims, lp, x, pools, tbl, geom)
                    ai += 1
                else:
                    x = x + _ssm_layer(cfg, dims, lp, x,
                                       tuple(state[n][bi, si]
                                             for n in SSM_STATE))
                    si += 1
                if kind["ffn"] == "none":
                    continue
                h = L.apply_norm(cfg, lp["ln2"], x)
                if kind["ffn"] == "moe":
                    x = x + _pod_moe_ffn(cfg, dims, lp["ffn"], h,
                                         step.expert_bins[mi])
                    mi += 1
                else:
                    x = x + dense_decode_ffn(cfg, lp["ffn"], h, tp)
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = L.apply_head(cfg, params["head"], params["embed"], x)
        logits = logits.float().reshape(I, M, -1)
        nxt = _sample_greedy(logits, tp)
        nxt = torch.where(tbl["slot_active"] != 0, nxt, torch.full_like(nxt, -1))
        return state, nxt, logits

    step.expert_bins = None
    return step


# =========================================================================== #
# encoder-decoder (whisper) decode: DCP over the cross-attention KV
# =========================================================================== #
ENCDEC_STATE = ("cross_k_pool", "cross_v_pool", "self_k", "self_v")


def _check_encdec(cfg: ModelConfig, dims: DecodeDims) -> None:
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is not an encoder-decoder model")
    check_dims(dims)
    if quant.is_quantized(dims.kv_dtype):
        raise ValueError("encoder-decoder pools are unquantized (kv_dtype "
                         f"{dims.kv_dtype!r})")


def init_encdec_serve_state(cfg: ModelConfig, dims: DecodeDims,
                            num_instances: int, dtype=torch.bfloat16,
                            device="cuda") -> dict:
    """Zeroed whisper serve state: the paged cross pools ``cross_k_pool``/
    ``cross_v_pool`` ``[L, I, tp, F', page, kg*hd]`` (the DCP-managed KV of
    the encoder states; the last frame of each sub-pool is the allocator's
    scratch frame) and the per-slot decoder self-attention caches
    ``self_k``/``self_v`` ``[L, I, tp, M, T, kg*hd]``, T the decoder's
    ``max_target_positions``.  Each model chunk stores its whole kv-head
    group (kg = 1 unless tp < num_kv_heads)."""
    _check_encdec(cfg, dims)
    dev = resolve_device(device)
    I, L = num_instances, cfg.num_layers
    _, _, ps = attn_tp_geometry(cfg, dims.tp)
    width = kv_group_size(cfg, dims.tp) * cfg.head_dim_
    fp = -(-(dims.num_frames - 1) // ps) + 1
    pool = (L, I, dims.tp, fp, dims.page, width)
    cache = (L, I, dims.tp, dims.M, cfg.max_target_positions, width)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape in zip(ENCDEC_STATE, (pool, pool, cache, cache))}


def to_encdec_decode_params(cfg: ModelConfig, params: dict, tp: int) -> dict:
    """The decoder's decode layout: the self- and the cross-attention each
    laid out as ``to_decode_params`` lays out a GQA mixer
    (``_gqa_decode_params``), the MLP's row-parallel ``wo`` cut into ``[L,
    tp, R/tp, D]`` chunks.  The encoder's weights are dropped (prefill
    only)."""
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is not an encoder-decoder model")
    if cfg.d_ff % tp:
        raise ValueError(f"FFN width {cfg.d_ff} does not split over tp={tp}")
    dec = params["dec_blocks"]
    mlp = dec["mlp"]
    return {"embed": params["embed"],
            "dec_blocks": {"ln1": dec["ln1"],
                           "self_attn": _gqa_decode_params(
                               cfg, dec["self_attn"], tp),
                           "ln_x": dec["ln_x"],
                           "cross_attn": _gqa_decode_params(
                               cfg, dec["cross_attn"], tp),
                           "ln2": dec["ln2"],
                           "mlp": {"wi": mlp["wi"], "bi": mlp["bi"],
                                   "wo": _row_chunks(mlp["wo"], tp),
                                   "bo": mlp["bo"]}},
            "final_norm": params["final_norm"], "head": params["head"]}


def build_encdec_decode_step(cfg: ModelConfig, dims: DecodeDims):
    """Returns ``step(params, state, tables) -> (state, next_tokens [I, M],
    logits [I, M, Vp])`` of the whisper decoder over the whole virtual mesh.

    ``params`` is the ``to_encdec_decode_params`` layout, ``state`` the
    ``init_encdec_serve_state`` tensors, ``tables`` the routing tables;
    ``slot_pos`` is each slot's decoder position (the new token's
    self-attention index).  Per decoder layer: self-attention over the
    slot's contiguous cache (written at ``pos`` IN PLACE, then attended
    over ``[0, pos]``), cross-attention through the four DCP phases over
    the read-only cross pools, the gelu MLP; then the vocab-sharded greedy
    sample.  The slot dimension of the self caches is pinned: the step's
    M must be theirs.
    """
    _check_encdec(cfg, dims)
    geom = attn_tp_geometry(cfg, dims.tp)
    I, M, tp = dims.data_size, dims.M, dims.tp
    hd = cfg.head_dim_
    hl = geom[0] // tp
    kg = kv_group_size(cfg, tp)

    def self_attention(mx, h, pos, sk, sv):
        """sk/sv: this layer's [I, tp, M, T, kg*hd] caches, written in
        place at each slot's ``pos``."""
        q, k, v = _heads(cfg, dims, mx, h, hl, kv=True)
        ii = torch.arange(I, device=h.device)[:, None, None]
        jj = torch.arange(tp, device=h.device)[None, :, None]
        mm = torch.arange(M, device=h.device)[None, None, :]
        pp = pos.long()[:, None, :]
        sk[ii, jj, mm, pp] = k.to(sk.dtype)
        sv[ii, jj, mm, pp] = v.to(sv.dtype)
        T = sk.shape[3]
        lengths = (pos + 1).to(torch.int32)[:, None, :].expand(I, tp, M)
        o, _ = ref.decode_attention_dense(
            q.reshape(I * tp * M, hl, hd), sk.reshape(I * tp * M, T, kg, hd),
            sv.reshape(I * tp * M, T, kg, hd), lengths.reshape(-1))
        o = o.reshape(I, tp, M, hl, hd)
        return torch.bmm(_to_rows(o, tp), mx["wo"]).sum(dim=0)  # psum

    def step(params, state, tbl):
        if state["self_k"].shape[3] != M:
            raise ValueError(f"step M {M} != the self caches' pinned slots "
                             f"{state['self_k'].shape[3]}")
        tokens, pos = tbl["slot_token"], tbl["slot_pos"]          # [I, M]
        # a copy: _dcp_attention memoizes its block tables in it
        tbl = dict(_mask_eos_slots(dims, tbl, tokens))
        emb, pos_dec = params["embed"]["tok"], params["embed"]["pos_dec"]
        x = _embed_lookup(emb, tokens, tp).to(emb.dtype)
        x = x + pos_dec[pos.long()].to(x.dtype)
        # the residual stream takes pos_dec's dtype, as the reference's does
        x = x.to(pos_dec.dtype).reshape(I * M, -1)
        for li in range(cfg.num_layers):
            lp = block_slice(params["dec_blocks"], li)
            h = L.apply_norm(cfg, lp["ln1"], x)
            x = x + self_attention(lp["self_attn"], h, pos,
                                   state["self_k"][li], state["self_v"][li])
            # cross-attention through DCP over the read-only cross pools
            h = L.apply_norm(cfg, lp["ln_x"], x)
            mx = lp["cross_attn"]
            q = _heads(cfg, dims, mx, h, hl, kv=False)
            merged = _dcp_attention(dims, q, state["cross_k_pool"][li],
                                    state["cross_v_pool"][li], None, None,
                                    tbl, dk=hd, dv=hd, geom=geom,
                                    scale=hd ** -0.5)
            x = x + torch.bmm(_to_rows(merged, tp), mx["wo"]).sum(dim=0)
            h = L.apply_norm(cfg, lp["ln2"], x)
            x = x + dense_decode_ffn(cfg, lp["mlp"], h, tp)
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = L.apply_head(cfg, params["head"], params["embed"], x)
        logits = logits.float().reshape(I, M, -1)
        nxt = _sample_greedy(logits, tp)
        nxt = torch.where(tbl["slot_active"] != 0, nxt, torch.full_like(nxt, -1))
        return state, nxt, logits

    return step
