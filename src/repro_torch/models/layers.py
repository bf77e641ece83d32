"""Shared building blocks: norms, RoPE, MLPs, embeddings, init helpers
(port of ``repro/models/layers.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig


def dense_init(gen: torch.Generator, shape, in_axis: int = 0, *,
               dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    std = shape[in_axis] ** -0.5
    # scaled in place: one float32 buffer per leaf (an expert stack of
    # DeepSeek-V3's is 15 GB)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(std).to(dtype)


def make_norm_params(cfg: ModelConfig, dim: int, device="cuda") -> dict:
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (with bias) or RMSNorm in float32, result in x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def rms_norm_vec(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with an explicit scale vector (MLA's
    q/kv latent norms), in float32, result in x's dtype."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., H, D]; positions: integer tensor broadcastable to x.shape[:-2].

    Rotates pairs (x[2i], x[2i+1]).
    """
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                          # [D/2]
    ang = positions.float()[..., None, None] * freqs                # [..., 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------- #
# MLP (gated silu)
# --------------------------------------------------------------------------- #
def make_mlp_params(gen, cfg: ModelConfig, *, dtype, device,
                    d_ff: int | None = None) -> dict:
    if cfg.act != "silu":
        raise NotImplementedError("gelu MLPs are not ported yet "
                                  "(ROADMAP queue 1 item 12)")
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    return {"wi_gate": dense_init(gen, (D, Fd), dtype=dtype, device=device),
            "wi_up": dense_init(gen, (D, Fd), dtype=dtype, device=device),
            "wo": dense_init(gen, (Fd, D), dtype=dtype, device=device)}


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


# --------------------------------------------------------------------------- #
# embeddings / head
# --------------------------------------------------------------------------- #
def make_embed_params(gen, cfg: ModelConfig, *, dtype, device) -> dict:
    Vp, D = cfg.padded_vocab, cfg.d_model
    return {"tok": (torch.randn((Vp, D), generator=gen, dtype=torch.float32,
                                device=device) * 0.02).to(dtype)}


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def make_head_params(gen, cfg: ModelConfig, *, dtype, device) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"w": dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype=dtype,
                            device=device)}


def apply_head(cfg: ModelConfig, head: dict, embed: dict,
               x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ embed["tok"].T
    return x @ head["w"]
