"""GQA attention layer (prefill path) + KV emission for caches, and the
encoder-decoder's cross-attention over precomputed encoder KV (port of
``repro/models/attention.py``)."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from . import layers


def make_attn_params(gen, cfg: ModelConfig, *, dtype, device) -> dict:
    """Projections in ``dtype``; the optional q/k/v biases (zeros) and
    per-head q/k RMSNorm scales (ones) in float32, as the reference inits
    them."""
    D, hd = cfg.d_model, cfg.head_dim_
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    mk = lambda shape: layers.dense_init(gen, shape, dtype=dtype, device=device)
    p = {"wq": mk((D, H * hd)), "wk": mk((D, Hkv * hd)),
         "wv": mk((D, Hkv * hd)), "wo": mk((H * hd, D))}
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.qkv_bias:
        p.update(bq=torch.zeros((H * hd,), **f32),
                 bk=torch.zeros((Hkv * hd,), **f32),
                 bv=torch.zeros((Hkv * hd,), **f32))
    if cfg.qk_norm:
        p.update(q_norm=torch.ones((hd,), **f32), k_norm=torch.ones((hd,), **f32))
    return p


def qkv_proj(cfg: ModelConfig, p: dict, x: torch.Tensor,
             positions: torch.Tensor):
    """x: [B, S, D] -> q [B,S,H,hd], k/v [B,S,Hkv,hd] (rope applied).

    The biases are added in x's dtype before the head reshape; qk-norm is a
    per-head RMSNorm of q and k after it, before rope."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rms_norm_vec(q, p["q_norm"])
        k = layers.rms_norm_vec(k, p["k_norm"])
    if cfg.rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor, *, causal: bool = True):
    """Full self-attention layer body (no residual or norm): the flash
    kernel on CUDA, causal or not (the encoder's)."""
    q, k, v = qkv_proj(cfg, p, x, positions)
    o = ops.attention(q, k, v, causal=causal)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"]


def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    mem_k: torch.Tensor, mem_v: torch.Tensor):
    """x: [B, Sq, D]; mem_k/v: [B, Skv, Hkv, hd], the precomputed encoder
    KV (``encoder_kv``).  Non-causal attention of every query over every
    encoder position."""
    B, Sq, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, Sq, cfg.num_heads, cfg.head_dim_)
    o = ops.attention(q, mem_k, mem_v, causal=False)
    return o.reshape(B, Sq, -1) @ p["wo"]


def encoder_kv(cfg: ModelConfig, p: dict, mem: torch.Tensor):
    """Project encoder states [B, S, D] to the cross-attention's k and v
    [B, S, Hkv, hd], once per request."""
    B, S, _ = mem.shape
    k, v = mem @ p["wk"], mem @ p["wv"]
    if cfg.qkv_bias:
        k = k + p["bk"].to(mem.dtype)
        v = v + p["bv"].to(mem.dtype)
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim_)
    return k.reshape(shape), v.reshape(shape)
