"""Decode FFN on the virtual mesh (port of ``repro/core/moe_parallel.py``).

Only the dense tensor-parallel FFN is ported; the wide-EP MoE
dispatch/combine (``moe_decode_ffn``) is ROADMAP queue 1 item 10.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig


def dense_decode_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     tp: int) -> torch.Tensor:
    """Dense TP FFN for decode: column-parallel gate/up, row-parallel down,
    then the psum over tp as a sum over the tp dim.

    x: [T, D] rows of every instance (identical on each tp device).
    p["wi_gate"], p["wi_up"]: [D, F] with column chunk c = F/tp slice c;
    p["wo"]: [tp, F/tp, D] row chunks.  Returns [T, D].
    """
    if cfg.act != "silu":
        raise NotImplementedError("gelu decode FFN is not ported yet "
                                  "(ROADMAP queue 1 item 12)")
    T = x.shape[0]
    h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])            # [T, F]
    h = h.reshape(T, tp, -1).transpose(0, 1)                   # [tp, T, F/tp]
    return torch.bmm(h, p["wo"]).sum(dim=0)                    # psum over tp
