"""Hand-rolled AdamW and the LR schedule (port of
``repro/training/optimizer.py``).

Moments are float32 whatever the parameters' dtype; a parameter is written
back in its own dtype.  Decoupled weight decay applies to every leaf of
two or more dims, the reference's rule: stacked block leaves carry a
leading [nb] axis, so the stacked norm scales and SSD vectors are decayed
too (kept for parity; ROADMAP queue 3).  The update is functional: new
parameter and state trees, nothing written in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .tree import leaves, map_tree, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    """{"mu", "nu": float32 zeros like ``params``, "step": int32 0}, on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= ``max_norm``, in float32; the norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return map_tree(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """One AdamW step; returns (new_params, new_opt_state, stats)."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(p, g, mu, nu):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g.square()
        delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    flat = [leaves(t) for t in (params, grads, opt_state["mu"],
                                opt_state["nu"])]
    out = [upd(*xs) for xs in zip(*flat)]
    new = [unflatten(params, [o[i] for o in out]) for i in range(3)]
    return (new[0], {"mu": new[1], "nu": new[2], "step": step},
            {"grad_norm": gn, "lr": lr})
