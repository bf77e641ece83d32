"""Mamba-2 / SSD (state-space duality) blocks (port of ``repro/models/ssm.py``).

The chunked SSD algorithm (arXiv:2405.21060 §6) in plain torch: the
intra-chunk quadratic (attention-like) term plus the inter-chunk linear
recurrence over chunk boundary states, run as a loop over chunks (the
reference's ``lax.scan``).  Decode is the exact single-step recurrence over
(conv_state, ssm_state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import ModelConfig
from . import layers


def make_ssm_params(gen, cfg: ModelConfig, *, dtype, device) -> dict:
    """Projections in ``dtype``; the depthwise conv weights in bfloat16 and
    the per-head / per-channel vectors in float32, as the reference inits
    them (A = -exp(A_log) = -1, a small initial dt)."""
    D = cfg.d_model
    din, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads
    conv_dim = din + 2 * ns
    mk = lambda shape: layers.dense_init(gen, shape, dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # order: [z(din) | x(din) | B(ns) | C(ns) | dt(nh)]
        "in_proj": mk((D, 2 * din + 2 * ns + nh)),
        "conv_w": torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                              **f32).mul_(0.1).to(torch.bfloat16),
        "conv_b": torch.zeros((conv_dim,), **f32),
        "A_log": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.full((nh,), -2.0, **f32),
        "norm": torch.ones((din,), **f32),
        "out_proj": mk((din, D)),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    din, ns = cfg.ssm_d_inner, cfg.ssm_state
    return torch.split(proj, [din, din, ns, ns, proj.shape[-1] - 2 * din - 2 * ns],
                       dim=-1)


def _causal_conv(cfg: ModelConfig, p: dict, u: torch.Tensor) -> torch.Tensor:
    """u: [B, S, conv_dim] depthwise causal conv of width ssm_conv_width,
    then SiLU."""
    W, S = cfg.ssm_conv_width, u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    w = p["conv_w"].to(u.dtype)
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu(out + p["conv_b"].to(u.dtype))


def _identity_shard(x, name: str):
    return x


def ssd_chunked(cfg: ModelConfig, xh, dt, A, Bm, Cm, init_state=None,
                shard=_identity_shard):
    """Chunked SSD scan.

    xh: [B, S, nh, hd]; dt: [B, S, nh] (post-softplus); A: [nh] (negative);
    Bm/Cm: [B, S, ns].  Returns y [B, S, nh, hd] (xh's dtype) and the final
    state [B, nh, hd, ns] (float32).  S is padded to a chunk multiple with
    dt = 0 steps, which are the identity for the recurrence (decay 1, no
    update).  ``shard(t, "ssm_chunk")`` sees the chunked inputs and the
    intra-chunk quadratic tensors, as in the reference.
    """
    Bsz, S, nh, hd = xh.shape
    ns = Bm.shape[-1]
    cs = min(cfg.ssm_chunk, S)
    nc = -(-S // cs)
    pad = nc * cs - S
    xf, dtf, Bf, Cf = (F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (xh, dt, Bm, Cm))
    xc = shard(xf.reshape(Bsz, nc, cs, nh, hd), "ssm_chunk")
    dtc = shard(dtf.reshape(Bsz, nc, cs, nh), "ssm_chunk")
    Bc = shard(Bf.reshape(Bsz, nc, cs, ns), "ssm_chunk")
    Cc = shard(Cf.reshape(Bsz, nc, cs, ns), "ssm_chunk")

    a_cum = torch.cumsum(dtc * A, dim=2)                     # [B, nc, cs, nh]
    a_tot = a_cum[:, :, -1, :]                               # [B, nc, nh]

    # intra-chunk quadratic term: L[i, j] = exp(a_i - a_j) for i >= j
    causal = torch.ones(cs, cs, dtype=torch.bool, device=xh.device).tril()
    diff = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # [B,nc,i,j,nh]
    L = torch.exp(diff.masked_fill(~causal[:, :, None], float("-inf")))
    CB = shard(torch.einsum("bnis,bnjs->bnij", Cc, Bc), "ssm_chunk")
    scores = shard(CB[..., None] * L, "ssm_chunk")           # [B,nc,i,j,nh]
    xdt = xc * dtc[..., None]                                # [B,nc,cs,nh,hd]
    y = shard(torch.einsum("bnijh,bnjhd->bnihd", scores, xdt), "ssm_chunk")

    # chunk boundary states: S_n = sum_j exp(a_tot - a_j) dt_j B_j (x_j)^T
    decay_to_end = torch.exp(a_tot[:, :, None, :] - a_cum)   # [B,nc,cs,nh]
    states = torch.einsum("bnjs,bnjhd->bnhds", Bc,
                          xdt * decay_to_end[..., None])     # [B,nc,nh,hd,ns]

    # inter-chunk recurrence over the chunks; each chunk reads the state
    # from before it
    h = (torch.zeros((Bsz, nh, hd, ns), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = h * torch.exp(a_tot[:, n])[:, :, None, None] + states[:, n]
    h_prevs = torch.stack(h_prev, dim=1)                      # [B,nc,nh,hd,ns]

    # inter-chunk contribution: y_i += C_i . (exp(a_cum_i) * h_prev)
    y = y + (torch.einsum("bnis,bnhds->bnihd", Cc, h_prevs)
             * torch.exp(a_cum)[..., None])
    y = y.reshape(Bsz, nc * cs, nh, hd)[:, :S]
    return y.to(xh.dtype), h


def ssm_block(cfg: ModelConfig, p: dict, x: torch.Tensor, init=None,
              shard=_identity_shard):
    """Full Mamba-2 block: x [B, S, D] -> (y [B, S, D], (conv_state
    [B, W-1, conv_dim], ssm_state [B, nh, hd, ns]))."""
    B, S, _ = x.shape
    din, ns, nh, hd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads,
                       cfg.ssm_head_dim)
    z, xin, Bm, Cm, dt = _split_proj(cfg, x @ p["in_proj"])
    u = torch.cat([xin, Bm, Cm], dim=-1)
    conv_state = u[:, -(cfg.ssm_conv_width - 1):, :]     # decode continuation
    u = _causal_conv(cfg, p, u)
    xin, Bm, Cm = torch.split(u, [din, ns, ns], dim=-1)
    dtp = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, nh, hd)
    y, h_final = ssd_chunked(cfg, xh, dtp, A, Bm, Cm, init_state=init,
                             shard=shard)
    y = y + xh.float().to(y.dtype) * p["D"].reshape(1, 1, nh, 1).to(y.dtype)
    y = layers.rms_norm_vec(y.reshape(B, S, din) * F.silu(z), p["norm"])
    return y @ p["out_proj"], (conv_state, h_final)


def ssm_decode_step(cfg: ModelConfig, p: dict, x: torch.Tensor, conv_state,
                    ssm_state):
    """Single-token decode.  x: [B, D]; conv_state [B, W-1, conv_dim];
    ssm_state [B, nh, hd, ns].  Returns (y [B, D], new_conv, new_ssm)."""
    B = x.shape[0]
    din, ns, nh, hd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads,
                       cfg.ssm_head_dim)
    z, xin, Bm, Cm, dt = _split_proj(cfg, x @ p["in_proj"])
    u_new = torch.cat([xin, Bm, Cm], dim=-1)                 # [B, conv_dim]
    window = torch.cat([conv_state, u_new[:, None, :]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"]).to(x.dtype)
    xin, Bm, Cm = torch.split(conv_out, [din, ns, ns], dim=-1)
    dtp = F.softplus(dt.float() + p["dt_bias"])              # [B, nh]
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, nh, hd).float()
    decay = torch.exp(dtp * A)                               # [B, nh]
    upd = torch.einsum("bs,bh,bhd->bhds", Bm.float(), dtp, xh)
    new_state = ssm_state.float() * decay[..., None, None] + upd
    y = torch.einsum("bs,bhds->bhd", Cm.float(), new_state)
    y = (y + xh * p["D"][None, :, None]).reshape(B, din).to(x.dtype)
    y = layers.rms_norm_vec(y * F.silu(z), p["norm"])
    return (y @ p["out_proj"], window[:, 1:, :],
            new_state.to(ssm_state.dtype))


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cuda"):
    """Zeroed (conv_state [batch, W-1, conv_dim] bfloat16, ssm_state
    [batch, nh, hd, ns] ``dtype``)."""
    device = resolve_device(device)
    conv = torch.zeros((batch, cfg.ssm_conv_width - 1,
                        cfg.ssm_d_inner + 2 * cfg.ssm_state),
                       dtype=torch.bfloat16, device=device)
    state = torch.zeros((batch, cfg.ssm_num_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=dtype, device=device)
    return conv, state
