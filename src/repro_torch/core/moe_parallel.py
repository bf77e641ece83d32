"""Decode FFNs on the virtual mesh (port of ``repro/core/moe_parallel.py``):
the wide-EP MoE dispatch/combine and the dense tensor-parallel FFN.

The reference runs ``moe_decode_ffn`` per device inside ``shard_map``:
experts are sharded over the ``data`` axis (instance j hosts experts
``j*E/I .. (j+1)*E/I - 1``, each cut into tp column/row chunks over
``model``), and each MoE layer makes the paper's two all-to-all phases.
The port holds every instance's rows at once, so each all-to-all is a
transpose of the [I_src, I_dst, ...] buffer.  Each expert's FFN runs
whole (the reference's tp chunks, summed by its psum, are the same
product in another order); the dense FFN's psum over tp is a sum over
the tp dim.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..models import moe as moe_mod


def moe_decode_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                   data_size: int, tp: int) -> torch.Tensor:
    """x [I*T, D]: T rows per instance, instance-major -> [I*T, D].

    Routing and grouping are per instance, so capacity C bounds the rows
    of each (instance, expert) pair (the static-shape analogue of DeepEP's
    bounded receive buffers; the scheduler's batch balance bounds them).
    Params (the prefill layout, unsharded): ``router`` [D, E] float32,
    ``wi_gate``/``wi_up`` [E, D, F], ``wo`` [E, F, D], optional dense
    ``shared`` expert.
    """
    I, E = data_size, cfg.num_experts
    if E % I:
        raise ValueError(f"num_experts={E} does not split over {I} instances")
    e_local = E // I
    D = x.shape[-1]
    xi = x.reshape(I, -1, D)                                    # [I, T, D]
    T = xi.shape[1]
    C = moe_mod.capacity(cfg, T)

    w, idx = moe_mod.router_topk(cfg, p["router"], xi)
    src_token, slot_of = moe_mod.group_by_expert(idx, E, C)
    tok = _dispatch(xi, src_token, e_local)                     # [E, I*C, D]
    out = moe_mod.expert_ffn(p, tok)                            # [E, I*C, D]
    y = moe_mod.combine(w, _combine(out, I), slot_of).reshape(I * T, D)
    if cfg.num_shared_experts:
        sh = p["shared"]
        y = y + dense_decode_ffn(cfg, {**sh, "wo": sh["wo"].reshape(
            tp, -1, D)}, x, tp)
    return y.to(x.dtype)


def _dispatch(xi: torch.Tensor, src_token: torch.Tensor,
              e_local: int) -> torch.Tensor:
    """Fill each instance's capacity bins, then the dispatch all-to-all:
    instance i's bins for instance j's experts go to j ([I_src, I_dst,
    e_local, C, D] -> [I_dst, I_src, ...]).  xi [I, T, D], src_token
    [I, E*C] -> every expert's rows from every source: [E, I_src*C, D]."""
    I, _, D = xi.shape
    send = moe_mod.take_rows(xi, src_token)                     # [I, E*C, D]
    C = send.shape[1] // (I * e_local)
    recv = send.reshape(I, I, e_local, C, D).transpose(0, 1)
    return recv.transpose(1, 2).reshape(I * e_local, I * C, D)


def _combine(out: torch.Tensor, I: int) -> torch.Tensor:
    """The combine all-to-all, the dispatch's inverse transpose: expert
    outputs [E, I_src*C, D] -> each source's bins [I_src, E*C, D]."""
    E, R, D = out.shape
    back = out.reshape(I, E // I, I, R // I, D).transpose(1, 2)  # [I_j, I_src, ..]
    return back.transpose(0, 1).reshape(I, E * (R // I), D)


def dense_decode_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     tp: int) -> torch.Tensor:
    """Dense TP FFN for decode: column-parallel up-projection(s), row-parallel
    down, then the psum over tp as a sum over the tp dim.

    x: [T, D] rows of every instance (identical on each tp device).  Gated
    silu: p["wi_gate"], p["wi_up"] [D, F] with column chunk c = F/tp slice
    c.  Plain gelu (whisper): p["wi"] [D, F] and its bias p["bi"] [F]
    likewise, and the replicated output bias p["bo"] [D], added once after
    the psum.  p["wo"]: [tp, F/tp, D] row chunks.  Returns [T, D].
    """
    T = x.shape[0]
    if cfg.act == "silu":
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])        # [T, F]
    else:
        h = F.gelu(x @ p["wi"] + p["bi"].to(x.dtype), approximate="tanh")
    h = h.reshape(T, tp, -1).transpose(0, 1)                   # [tp, T, F/tp]
    out = torch.bmm(h, p["wo"]).sum(dim=0)                     # psum over tp
    return out if cfg.act == "silu" else out + p["bo"].to(x.dtype)
