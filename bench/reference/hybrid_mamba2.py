"""The Mamba-2 block (arXiv:2405.21060) of the plain reference, in float32
PyTorch: the mixer that ``moe_transformer.logits`` takes for a layer whose
``layer_types`` entry is ``"mamba"``, of the source's ``mamba_*`` sizes.

It imports nothing of the program and uses nothing the program derived.
It computes one sequence at a time, all positions; the recurrence
blockwise, from its equations, block by block with the state carried
between blocks.  What it computes follows the configuration file's
``departures``, as ``moe_transformer`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference import moe_transformer as base

# positions of one block of the recurrence: its decays are [T, T, heads]
BLOCK = 64


def ssd_scan(x, dt, A, B, C, block: int = BLOCK):
    """The Mamba-2 recurrence over one sequence, from h_0 = 0:

        h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t

    per head, x [S, nh, hd], dt [S, nh] (after the softplus), A [nh]
    (negative), B and C [S, G, ns] (head h reads group h // (nh / G)).
    Blockwise: with a_i the sum of dt A over the block up to i,

        y_i = sum_{j <= i} exp(a_i - a_j) dt_j (C_i . B_j) x_j
              + exp(a_i) h_before C_i,

    and the state after the block exp(a_T) h_before + sum_j exp(a_T - a_j)
    dt_j x_j B_j^T.  Returns y [S, nh, hd]."""
    S, nh, hd = x.shape
    rep = nh // B.shape[1]
    Bh, Ch = B.repeat_interleave(rep, 1), C.repeat_interleave(rep, 1)
    h = x.new_zeros(nh, hd, B.shape[-1])
    y = torch.empty_like(x)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        a = torch.cumsum(dt[s0:s1] * A, 0)                     # [T, nh]
        seg = a[:, None, :] - a[None, :, :]                    # [i, j, nh]
        later = torch.ones(s1 - s0, s1 - s0, dtype=torch.bool,
                           device=x.device).tril().logical_not()
        decay = seg.masked_fill(later[..., None], -math.inf).exp()
        cb = torch.einsum("ihs,jhs->ijh", Ch[s0:s1], Bh[s0:s1])
        xdt = x[s0:s1] * dt[s0:s1, :, None]
        y[s0:s1] = (torch.einsum("ijh,jhd->ihd", cb * decay, xdt)
                    + torch.einsum("ihs,hds->ihd", Ch[s0:s1], h)
                    * a.exp()[..., None])
        h = (h * a[-1].exp()[:, None, None]
             + torch.einsum("jh,jhd,jhs->hds", (a[-1] - a).exp(), xdt,
                            Bh[s0:s1]))
    return y


def mamba2(model, p, h, pos=None):
    """One Mamba-2 mixer over one sequence h [S, D]: in_proj to
    [z | x | B | C | dt]; a causal depthwise conv of width ``mamba_d_conv``
    with bias, then SiLU, over x, B and C; dt = softplus(dt + dt_bias),
    A = -exp(A_log); the recurrence (``ssd_scan``) plus D x; the gated
    RMSNorm over the whole d_inner, norm(y * silu(z)); out_proj."""
    S = h.shape[0]
    din = model["mamba_expand"] * model["hidden_size"]
    hd, ns = model["mamba_d_head"], model["mamba_d_state"]
    G, W = model.get("mamba_n_groups", 1), model["mamba_d_conv"]
    nh = din // hd
    z, xbc, dt = torch.split(h @ p["in_proj"], [din, din + 2 * G * ns, nh],
                             -1)
    u = F.pad(xbc, (0, 0, W - 1, 0))
    conv = p["conv_b"] + sum(p["conv_w"][i] * u[i:i + S] for i in range(W))
    x, B, C = torch.split(F.silu(conv), [din, G * ns, G * ns], -1)
    x = x.reshape(S, nh, hd)
    y = ssd_scan(x, F.softplus(dt + p["dt_bias"]), -p["A_log"].exp(),
                 B.reshape(S, G, ns), C.reshape(S, G, ns))
    y = (y + p["D"][:, None] * x).reshape(S, din)
    return base._rms(y * F.silu(z), p["norm"]) @ p["out_proj"]

