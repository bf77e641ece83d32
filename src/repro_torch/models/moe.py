"""Mixture-of-Experts layer, model-level path: sort-grouped,
capacity-bounded (port of ``repro/models/moe.py``).

Two execution paths, as in the reference:
  * this module — prefill: each batch row's tokens are sort-grouped by
    expert into capacity buffers and run through the expert FFNs (one
    ``bmm`` per weight over every expert);
  * ``core/moe_parallel.py`` — decode: the same grouping per instance,
    then the dispatch/combine all-to-all over the virtual ``data`` axis.

Every function takes any leading batch dims before the token dim: a
leading dim groups independently (the reference ``vmap``s ``moe_ffn``
over batch rows).  The load-balance loss is training and is not ported
yet (ROADMAP queue 1 item 15).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import layers

# tokens per grouping chunk of a long prefill row (``moe_ffn_batched``)
CHUNK = 4096


def make_moe_params(gen, cfg: ModelConfig, *, dtype, device) -> dict:
    """Router ``[D, E]`` (float32 whatever ``dtype``, as the reference
    inits it), experts ``wi_gate``/``wi_up`` ``[E, D, F]`` and ``wo``
    ``[E, F, D]``, and an optional dense shared expert."""
    D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff_
    mk = lambda shape, dt=dtype: layers.dense_init(gen, shape, dtype=dt,
                                                   device=device)
    p = {"router": mk((D, E), torch.float32),
         "wi_gate": mk((E, D, Fe)), "wi_up": mk((E, D, Fe)),
         "wo": mk((E, Fe, D))}
    if cfg.num_shared_experts:
        p["shared"] = layers.make_mlp_params(
            gen, cfg, dtype=dtype, device=device,
            d_ff=cfg.moe_d_ff_ * cfg.num_shared_experts)
    return p


def router_topk(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x [..., T, D] -> (weights [..., T, k] float32, idx [..., T, k]
    int32).  Softmax, then the top k, renormalised.

    Ties go to the lowest expert index, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` promises no order): a stable descending sort.  All-zero
    rows (padded slots after a bias-free norm) tie on every expert, and
    which experts they take decides which real tokens a full capacity
    buffer drops."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)            # [.., T, E]
    idx = torch.argsort(probs, dim=-1, descending=True,
                        stable=True)[..., :cfg.num_experts_per_tok]
    w = torch.gather(probs, -1, idx)
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return w, idx.to(torch.int32)


def group_by_expert(topk_idx: torch.Tensor, num_experts: int, capacity: int):
    """Sort-based grouping of (token, slot) assignments into expert bins.

    topk_idx [..., T, k] -> (src_token [..., E*C] int32, T for an empty
    bin slot; slot_of [..., T, k] int32, E*C for a dropped assignment).
    Within an expert, assignments keep (token, slot) order and the first
    C are kept.  Dropped assignments write through a sentinel entry E*C,
    as the reference's ``[E*C + 1]`` buffer does, so both tables are
    bit-equal to its."""
    *lead, T, k = topk_idx.shape
    E, C = num_experts, capacity
    dev = topk_idx.device
    flat_e = topk_idx.reshape(*lead, T * k).long()
    flat_t = torch.arange(T * k, device=dev) // k
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    st = flat_t[order]
    first_of = torch.searchsorted(
        se.contiguous(),
        torch.arange(E, device=dev).expand(*lead, E).contiguous(),
        side="left")
    pos_in_e = torch.arange(T * k, device=dev) - torch.gather(first_of, -1, se)
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, torch.full_like(se, E * C))
    src_token = torch.full((*lead, E * C + 1), T, dtype=torch.long, device=dev)
    src_token.scatter_(-1, slot, st)
    src_token[..., -1] = T
    slot_of = torch.full((*lead, T * k), E * C, dtype=torch.long, device=dev)
    slot_of.scatter_(-1, order, slot)
    return (src_token[..., :-1].to(torch.int32),
            slot_of.reshape(*lead, T, k).to(torch.int32))


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Per-(group, expert) capacity ceil(T*k/E * phi), at least 1, with
    phi = ``cfg.capacity_factor``."""
    return max(1, math.ceil(tokens * cfg.num_experts_per_tok
                            / cfg.num_experts * cfg.capacity_factor))


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., T, D], idx [..., R] in [0, T] -> [..., R, D]; index T is a
    zero row (the reference's concatenated pad row)."""
    pad = torch.cat([x, x.new_zeros((*x.shape[:-2], 1, x.shape[-1]))], dim=-2)
    idx = idx.long()[..., None].expand(*idx.shape, x.shape[-1])
    return torch.gather(pad, -2, idx)


def combine(w: torch.Tensor, expert_out: torch.Tensor,
            slot_of: torch.Tensor) -> torch.Tensor:
    """Gate-weighted sum of each token's k expert outputs.  expert_out
    [..., E*C, D], slot_of [..., T, k] (E*C = dropped: a zero row), w
    [..., T, k] -> [..., T, D]."""
    *lead, T, k = slot_of.shape
    g = take_rows(expert_out, slot_of.reshape(*lead, T * k))
    g = g.reshape(*lead, T, k, expert_out.shape[-1])
    return torch.einsum("...tk,...tkd->...td", w.to(g.dtype), g)


def expert_ffn(p: dict, tok: torch.Tensor) -> torch.Tensor:
    """Gated-silu expert FFNs: tok [E, R, D] -> [E, R, D], one ``bmm`` per
    weight over every expert."""
    h = F.silu(torch.bmm(tok, p["wi_gate"])) * torch.bmm(tok, p["wi_up"])
    return torch.bmm(h, p["wo"])


def bin_rows(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The rows routed to each expert: idx [..., T, k] -> [..., E] int64."""
    flat = idx.reshape(-1, idx.shape[-2] * idx.shape[-1]).long()
    rows = torch.zeros((flat.shape[0], num_experts), dtype=torch.long,
                       device=idx.device)
    rows.scatter_add_(1, flat, torch.ones_like(flat))
    return rows.reshape(*idx.shape[:-2], num_experts)


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [..., T, D] -> [..., T, D]; each leading index groups on its own,
    with capacity C = ``capacity(cfg, T)``.

    A bin fills from its first slot, so no row lies past the fullest bin:
    the expert FFNs run on the first Cb = min(C, fullest bin) slots of
    every bin, and the result is the reference's, whose other E*(C - Cb)
    slots are empty.  Reading Cb waits on the device once (prefill only;
    the decode step never does).  At C >= T, as where no token may drop
    (DeepSeek-V3 at C = T = 2000: 14.7 GB per [E*C, D] buffer), this is
    what keeps the buffers to the tokens' size."""
    *lead, T, D = x.shape
    E = cfg.num_experts
    C = capacity(cfg, T)
    w, idx = router_topk(cfg, p["router"], x)
    src_token, slot_of = group_by_expert(idx, E, C)
    xb = x.reshape(-1, T, D)
    B = xb.shape[0]
    Cb = max(1, min(C, int(bin_rows(idx, E).max())))
    src = src_token.reshape(B, E, C)[..., :Cb].reshape(B, E * Cb)
    expert_in = take_rows(xb, src)                              # [B, E*Cb, D]
    tok = expert_in.reshape(B, E, Cb, D).transpose(0, 1).reshape(E, B * Cb, D)
    del expert_in
    out = expert_ffn(p, tok).reshape(E, B, Cb, D).transpose(0, 1)
    del tok
    # slot e*C + j of a kept row (j < Cb) is e*Cb + j here; E*C (dropped)
    # becomes E*Cb, the zero row
    slot = slot_of.reshape(B, T, -1).long()
    slot = torch.where(slot < E * C, slot // C * Cb + slot % C,
                       torch.full_like(slot, E * Cb))
    out = combine(w.reshape(B, T, -1), out.reshape(B, E * Cb, D),
                  slot).reshape(*lead, T, D)
    if cfg.num_shared_experts:
        out = out + layers.apply_mlp(cfg, p["shared"], x)
    return out.to(x.dtype)


def moe_ffn_batched(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D]; grouping and capacity are per (batch row, ``CHUNK``
    tokens).  A row longer than ``CHUNK`` runs chunk by chunk, so the
    dispatch/combine buffers peak at one chunk (the reference's
    ``lax.scan``)."""
    B, S, D = x.shape
    if S <= CHUNK:
        return moe_ffn(cfg, p, x)
    if S % CHUNK:
        raise ValueError(f"moe_ffn_batched: S={S} is not a multiple of "
                         f"CHUNK={CHUNK}")
    return torch.cat([moe_ffn(cfg, p, x[:, c:c + CHUNK])
                      for c in range(0, S, CHUNK)], dim=1)
