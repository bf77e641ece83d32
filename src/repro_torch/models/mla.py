"""Multi-head Latent Attention (DeepSeek-V2/V3, MiniCPM3), port of
``repro/models/mla.py``.

The prefill path materialises per-head K/V from the latent and runs the
flash kernel (Dk = nope + rope differs from Dv); the decode path
(``core/dcp.py``) caches only the latent ``[c_kv | k_rope]`` (kv_lora_rank +
rope dims per token) and runs MQA over it with W_uk / W_uv absorbed into q
and the output.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from . import layers


def make_mla_params(gen: torch.Generator, cfg: ModelConfig, *, dtype,
                    device) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    mk = lambda shape: layers.dense_init(gen, shape, dtype=dtype, device=device)
    p = {"wkv_a": mk((D, kvr + dr)),
         "kv_norm": torch.ones((kvr,), dtype=torch.float32, device=device),
         "wk_b": mk((kvr, H * dn)), "wv_b": mk((kvr, H * dv)),
         "wo": mk((H * dv, D))}
    if qr:
        p["wq_a"] = mk((D, qr))
        p["q_norm"] = torch.ones((qr,), dtype=torch.float32, device=device)
        p["wq_b"] = mk((qr, H * (dn + dr)))
    else:
        p["wq"] = mk((D, H * (dn + dr)))
    return p


def mla_q(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """Query projection -> q_nope [B,S,H,dn], q_rope [B,S,H,dr] (rope applied)."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        q = layers.rms_norm_vec(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, cfg.num_heads, dn + dr)
    return q[..., :dn], layers.apply_rope(q[..., dn:], positions, cfg.rope_theta)


def mla_latent(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor):
    """KV latent: c_kv [B,S,kvr] (normed), k_rope [B,S,dr] (rope, head-shared)."""
    kvr = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    c_kv = layers.rms_norm_vec(kv[..., :kvr], p["kv_norm"])
    k_rope = layers.apply_rope(kv[..., kvr:][..., None, :], positions,
                               cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       positions: torch.Tensor, latent=None) -> torch.Tensor:
    """Prefill MLA (materialised K/V, causal) -> [B, S, D].  ``latent`` is
    ``mla_latent``'s output when the caller already has it."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = mla_q(cfg, p, x, positions)
    c_kv, k_rope = latent if latent is not None else mla_latent(cfg, p, x,
                                                                positions)
    k_nope = (c_kv @ p["wk_b"]).reshape(B, S, H, dn)
    v = (c_kv @ p["wv_b"]).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    o = ops.attention(q, k, v, causal=True, scale=(dn + dr) ** -0.5)
    return o.reshape(B, S, H * dv) @ p["wo"]


def mla_absorbed_q(cfg: ModelConfig, p: dict, q_nope: torch.Tensor):
    """Absorb W_uk into q for latent-space (MQA) decode:
    q_nope [..., H, dn] -> q_latent [..., H, kvr] (q_latent . c_kv ==
    q . k_nope)."""
    H, dn, kvr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    return torch.einsum("...hd,khd->...hk", q_nope,
                        p["wk_b"].reshape(kvr, H, dn))


def mla_unabsorb_out(cfg: ModelConfig, p: dict, o_latent: torch.Tensor):
    """o_latent [..., H, kvr] -> per-head value output [..., H*dv] (pre-Wo)."""
    H, dv, kvr = cfg.num_heads, cfg.v_head_dim, cfg.kv_lora_rank
    o = torch.einsum("...hk,khd->...hd", o_latent,
                     p["wv_b"].reshape(kvr, H, dv))
    return o.reshape(*o.shape[:-2], H * dv)
