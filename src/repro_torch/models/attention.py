"""GQA attention layer (prefill path) + KV emission for caches
(port of ``repro/models/attention.py``)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import layers


def make_attn_params(gen, cfg: ModelConfig, *, dtype, device) -> dict:
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError("qkv bias / qk-norm attention is not ported "
                                  "yet (ROADMAP queue 1)")
    D, hd = cfg.d_model, cfg.head_dim_
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    mk = lambda shape: layers.dense_init(gen, shape, dtype=dtype, device=device)
    return {"wq": mk((D, H * hd)), "wk": mk((D, Hkv * hd)),
            "wv": mk((D, Hkv * hd)), "wo": mk((H * hd, D))}


def qkv_proj(cfg: ModelConfig, p: dict, x: torch.Tensor,
             positions: torch.Tensor):
    """x: [B, S, D] -> q [B,S,H,hd], k/v [B,S,Hkv,hd] (rope applied)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v
