"""Plain torch versions of every kernel (port of ``repro/kernels/ref.py``).

These are the semantics of record on the port's side: the Hopper kernels
are held against them on the card, and the CPU path runs them directly
(``ops.py`` dispatches by the tensor's device).  Layouts are the JAX
package's: q ``[B, S, H, D]`` / ``[N, Hq, D]``, pages ``[P, page, Hkv, D]``.

All functions accumulate in float32 regardless of input dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """[..., Hkv, D] -> [..., Hq, D] by repeating kv heads."""
    hkv = k.shape[-2]
    if hkv == num_q_heads:
        return k
    if num_q_heads % hkv:
        raise ValueError(f"Hq={num_q_heads} is not a multiple of Hkv={hkv}")
    return torch.repeat_interleave(k, num_q_heads // hkv, dim=-2)


# --------------------------------------------------------------------------- #
# prefill attention
# --------------------------------------------------------------------------- #
def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, kv_len: torch.Tensor | None = None):
    """Reference multi-head attention.

    q: [B, Sq, Hq, Dk]; k: [B, Skv, Hkv, Dk]; v: [B, Skv, Hkv, Dv] (GQA).
    ``q_offset``: absolute position of q[0] (chunked prefill).
    ``kv_len``: optional [B] valid kv lengths (padding mask).
    Returns out [B, Sq, Hq, Dv] (q.dtype), lse [B, Hq, Sq] (f32).
    """
    orig_dtype = q.dtype
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    k = _gqa_expand(k, Hq)
    v = _gqa_expand(v, Hq)
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    dev = q.device
    if causal:
        qi = torch.arange(Sq, device=dev)[:, None] + q_offset
        ki = torch.arange(Skv, device=dev)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    if kv_len is not None:
        mask = torch.arange(Skv, device=dev)[None, :] < kv_len[:, None]
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p / denom, v.float())
    lse = (m + torch.log(denom))[..., 0]                           # [B, Hq, Sq]
    return o.to(orig_dtype), lse


def flash_attention_blockwise(q, k, v, *, causal: bool = True,
                              scale: float | None = None, q_offset: int = 0,
                              kv_len: torch.Tensor | None = None,
                              block_k: int = 512):
    """Online softmax over kv blocks (never materialises [Sq, Skv] scores).

    Same semantics as ``flash_attention``; Skv must divide by the block.
    """
    orig_dtype = q.dtype
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    bk = min(block_k, Skv)
    if Skv % bk:
        raise ValueError(f"Skv={Skv} is not a multiple of block_k={bk}")
    dev = q.device
    scale = scale if scale is not None else D ** -0.5
    qg = (q.float() * scale).to(q.dtype).reshape(B, Sq, Hkv, G, D).float()
    if kv_len is None:
        kv_len = torch.full((B,), Skv, dtype=torch.int32, device=dev)
    rpos = torch.arange(Sq, device=dev) + q_offset
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, Dv), dtype=torch.float32, device=dev)
    for ik in range(Skv // bk):
        ks = k[:, ik * bk:(ik + 1) * bk].float()
        vs = v[:, ik * bk:(ik + 1) * bk]
        cpos = ik * bk + torch.arange(bk, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ks)
        mask = (cpos[None, :] < kv_len[:, None])[:, None, None, None, :]
        if causal:
            mask = mask & (rpos[:, None] >= cpos[None, :])[None, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgqk,bkhd->bhgqd",
                                        p.to(q.dtype).float(), vs.float())
        m = m_new
    safe_l = torch.clamp(l, min=1e-30)
    out = (acc / safe_l).reshape(B, Hq, Sq, Dv).permute(0, 2, 1, 3)
    lse = (m + torch.log(safe_l))[..., 0].reshape(B, Hq, Sq)
    return out.to(orig_dtype), lse


# --------------------------------------------------------------------------- #
# paged decode attention
# --------------------------------------------------------------------------- #
# the largest float32 K/V window the plain version gathers at once on a card
PLAIN_WINDOW_BYTES = 2 << 30


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           scale: float | None = None, k_scale=None,
                           v_scale=None):
    """Decode attention over a paged KV pool, with LSE output.

    q:            [N, Hq, Dk]      one query token per work row
    k_pages:      [P, page, Hkv, Dk]
    v_pages:      [P, page, Hkv, Dv]
    block_tables: [N, MB] int32    page ids per row (entries past length ignored)
    lengths:      [N]     int32    valid kv tokens per row; 0 => inactive row
    k_scale, v_scale: [P] float32  per-page scales of quantized (fp8/int8)
                  pools (``quant.py``); pass neither or both.  fp8/int8
                  pages without scales are raw codes, upcast as they are
                  (a unit scale), as the reference's kernel reads them
    Returns out [N, Hq, Dv] (q.dtype), lse [N, Hq] (f32; -1e30 for length 0).

    The q heads of a kv head are contiguous (kv-head-major), G = Hq/Hkv.
    Quantized pools are dequantized in the gathered window only: each page
    is upcast to float32, then multiplied by its scale.  Rows are
    independent: a call on a device whose float32 window would pass
    ``PLAIN_WINDOW_BYTES`` (a full-width decode cell's 4,096 rows of 16,448
    tokens) runs in row chunks under it.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_decode_attention: pass k_scale and v_scale "
                         "together, or neither")
    N, MB = block_tables.shape
    window = (MB * k_pages.shape[1] * k_pages.shape[2]
              * (k_pages.shape[3] + v_pages.shape[3]) * 4)
    step = max(1, PLAIN_WINDOW_BYTES // max(window, 1))
    if N > step and q.device.type not in ("cpu", "meta"):
        parts = [paged_decode_attention(
            q[i:i + step], k_pages, v_pages, block_tables[i:i + step],
            lengths[i:i + step], scale=scale, k_scale=k_scale,
            v_scale=v_scale) for i in range(0, N, step)]
        return (torch.cat([o for o, _ in parts]),
                torch.cat([l for _, l in parts]))
    orig_dtype = q.dtype
    N, Hq, Dk = q.shape
    P, page, Hkv, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    MB = block_tables.shape[1]
    G = Hq // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    bt = block_tables.long()
    k = k_pages[bt].reshape(N, MB * page, Hkv, Dk)
    v = v_pages[bt].reshape(N, MB * page, Hkv, Dv)
    if k_scale is not None:
        ks = k_scale.float()[bt].repeat_interleave(page, dim=1)    # [N, MB*page]
        vs = v_scale.float()[bt].repeat_interleave(page, dim=1)
        k = k.float() * ks[..., None, None]
        v = v.float() * vs[..., None, None]
    qg = (q.float() * scale).reshape(N, Hkv, G, Dk).to(q.dtype)
    s = torch.einsum("nhgd,nkhd->nhgk", qg.float(), k.float())     # [N,Hkv,G,L]
    valid = (torch.arange(MB * page, device=q.device)[None, :]
             < lengths[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid[:, None, None, :], p, torch.zeros_like(p))
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("nhgk,nkhd->nhgd", (p / denom).to(q.dtype).float(),
                     v.float())
    o = o.reshape(N, Hq, Dv)
    lse = (m + torch.log(denom))[..., 0].reshape(N, Hq)
    active = lengths > 0
    lse = torch.where(active[:, None], lse, torch.full_like(lse, NEG_INF))
    o = torch.where(active[:, None, None], o, torch.zeros_like(o))
    return o.to(orig_dtype), lse


def decode_attention_dense(q, k, v, lengths, *, scale: float | None = None):
    """Contiguous-KV decode: q [N,Hq,Dk], k [N,L,Hkv,Dk], v [N,L,Hkv,Dv].

    The one-page-per-row layout (page size L, identity block table).
    """
    N = q.shape[0]
    bt = torch.arange(N, dtype=torch.int32, device=q.device)[:, None]
    return paged_decode_attention(q, k, v, bt, lengths, scale=scale)


# --------------------------------------------------------------------------- #
# LSE merge (NanoCP Phase 4)
# --------------------------------------------------------------------------- #
def merge_lse(partial_out, partial_lse, mask=None):
    """Merge CP-shard partial attention results.

    partial_out: [W, ..., Dv]; partial_lse: [W, ...] f32; mask: optional
    [W, ...] bool (False entries are ignored).  The JAX reference takes
    [W, N, Hq, Dv]; any middle dims broadcast here.
    Returns merged out [..., Dv] (partial_out.dtype), merged lse [...].
    """
    orig_dtype = partial_out.dtype
    o = partial_out.float()
    lse = partial_lse.float()
    if mask is not None:
        lse = torch.where(mask[..., None] if mask.dim() < lse.dim() else mask,
                          lse, torch.full_like(lse, NEG_INF))
    m = torch.clamp(lse.amax(dim=0, keepdim=True), min=NEG_INF)
    w = torch.exp(lse - m)
    denom = torch.clamp(w.sum(dim=0), min=1e-30)
    merged = (w[..., None] * o).sum(dim=0) / denom[..., None]
    merged_lse = m[0] + torch.log(denom)
    return merged.to(orig_dtype), merged_lse


__all__ = ["flash_attention", "flash_attention_blockwise",
           "paged_decode_attention", "decode_attention_dense", "merge_lse",
           "NEG_INF"]
