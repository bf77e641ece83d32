"""The plain reference of a decoder-only transformer whose layers mix GQA
or latent attention (MLA) with Mamba-2 blocks (``hybrid_mamba2``), each
followed by a dense or mixture-of-experts FFN, in float32 PyTorch with
TF32 off.

It reads its sizes from a configuration file's published keys, and its
weights from the tree the benchmark made from the seed (the layout the
program takes: per-layer leaves stacked on a leading block axis).  It
imports nothing of the program and uses nothing the program derived: no
decode weights, pools or tables.  It computes the model one sequence at a
time, all positions, causal attention blockwise over query rows, each
expert over the tokens routed to it.  Each layer's mixer is the source's
``layer_types`` entry (attention where it has none, MLA where the source
has a latent); the source's ``embedding_multiplier``,
``residual_multiplier``, ``attention_multiplier`` and ``logits_scaling``
scale the embeddings, every residual branch, the attention scores and the
logits where the source gives them, and ``position_embedding_type``
``"nope"`` leaves out the rotation.

What it computes follows the configuration file's ``departures``, which are
what the program computes in place of the published model; nothing else
is left out.  Both sides share one weight layout, so a departure that only
permutes weights (RoPE's pairing) is no difference at all.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# the program's norm epsilon (a departure: the published files give theirs)
EPS = 1e-6
# bytes of attention scores one query block may hold
SCORE_BYTES = 1 << 31
# A token whose k-th and (k+1)-th router logits lie closer than a cell's
# ``router_tie`` is routed either way by rounding alone, and its position
# is left out of the comparison.  Rounding moves one router logit by about
# 1e-6, but the program's and the reference's drift apart along a long
# sequence (earlier positions routed the other way reach later ones through
# K and V), so a cell with long sequences and many MoE layers sets a wider
# margin.
#
# A token whose margin is under a cell's ``router_flip`` (a rounding-level
# tie, far under ``router_tie``) may have been routed the other way by the
# program, and in a short sequence that one position's K and V move the
# positions after it by more than ``router_tie``.  So a request whose
# served tokens do not all match is judged against the reference as it
# stands and against each variant with one such position routed the other
# way, and keeps the variant that fits best.


def set_precision(tf32: bool) -> None:
    """float32 matmuls with TF32 off (the reference), or on (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _norm(x, p):
    if "bias" in p:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + EPS) * p["scale"] + p["bias"]
    return _rms(x, p["scale"])


def _rms(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def _rope(x, pos, theta):
    """Rotate pairs (x[2i], x[2i+1]) by pos * theta^(-2i/d).  x [S, H, d]."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float32) / d)
    ang = pos.float()[:, None, None] * inv
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * c - b * s, b * c + a * s], -1).reshape(x.shape)


def _causal(q, k, v, scale):
    """softmax(q k^T * scale, causal) v, blockwise over query rows.
    q [S, H, dk], k [S, H, dk], v [S, H, dv] (kv heads already repeated)."""
    S, H = q.shape[:2]
    qh, kh, vh = (t.transpose(0, 1).contiguous() for t in (q, k, v))
    out = torch.empty(H, S, v.shape[-1], dtype=q.dtype, device=q.device)
    rows = max(1, min(S, SCORE_BYTES // (4 * H * S)))
    for s0 in range(0, S, rows):
        s1 = min(S, s0 + rows)
        sc = torch.bmm(qh[:, s0:s1], kh[:, :s1].transpose(1, 2)) * scale
        mask = (torch.arange(s0, s1, device=q.device)[:, None]
                < torch.arange(s1, device=q.device)[None, :])
        sc.masked_fill_(mask, float("-inf"))
        out[:, s0:s1] = torch.bmm(torch.softmax(sc, -1), vh[:, :s1])
    return out.transpose(0, 1)


def _gqa(model, p, h, pos):
    """GQA with RoPE, or with no position encoding where the source's
    ``position_embedding_type`` is ``"nope"``; scores scaled by the
    source's ``attention_multiplier`` where it gives one, else hd^-0.5."""
    S, D = h.shape
    H, Hkv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = model.get("head_dim", D // H)
    q = (h @ p["wq"]).reshape(S, H, hd)
    k = (h @ p["wk"]).reshape(S, Hkv, hd)
    v = (h @ p["wv"]).reshape(S, Hkv, hd)
    if model.get("position_embedding_type") != "nope":
        q = _rope(q, pos, model["rope_theta"])
        k = _rope(k, pos, model["rope_theta"])
    g = H // Hkv
    o = _causal(q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
                model.get("attention_multiplier", hd ** -0.5))
    return o.reshape(S, H * hd) @ p["wo"]


def _mla(model, p, h, pos):
    S = h.shape[0]
    H = model["num_attention_heads"]
    dn, dr = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, kvr = model["v_head_dim"], model["kv_lora_rank"]
    q = (_rms(h @ p["wq_a"], p["q_norm"]) @ p["wq_b"]).reshape(S, H, dn + dr)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, model["rope_theta"])],
                  -1)
    kv = h @ p["wkv_a"]
    c = _rms(kv[:, :kvr], p["kv_norm"])
    k_rope = _rope(kv[:, None, kvr:], pos, model["rope_theta"])
    k = torch.cat([(c @ p["wk_b"]).reshape(S, H, dn),
                   k_rope.expand(S, H, dr)], -1)
    v = (c @ p["wv_b"]).reshape(S, H, dv)
    o = _causal(q, k, v, (dn + dr) ** -0.5)
    return o.reshape(S, H * dv) @ p["wo"]


def _mlp(p, h):
    return (F.silu(h @ p["wi_gate"]) * (h @ p["wi_up"])) @ p["wo"]


def _moe(model, p, h, flip=None):
    """Softmax over every expert, the top k (ties to the lower index),
    renormalised; each expert over its tokens; plus the shared expert.
    Also returns each token's margin between its k-th and (k+1)-th router
    logits.  The rows ``flip`` (a list of positions) take the (k+1)-th
    expert in place of the k-th."""
    k = model["num_experts_per_tok"]
    logit = h @ p["router"]
    probs = torch.softmax(logit, -1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    if flip:
        rows = torch.as_tensor(flip, device=h.device)
        kth = order[rows, k - 1].clone()
        order[rows, k - 1] = order[rows, k]
        order[rows, k] = kth
    top = order[:, :k]
    kth = torch.gather(logit, -1, order[:, k - 1:k + 1])
    margin = (kth[:, 0] - kth[:, 1]).abs()
    w = torch.gather(probs, -1, top)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    # the (token, slot) pairs grouped by expert, with one read of the counts
    flat = top.flatten()
    pairs = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=p["router"].shape[-1]).tolist()
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        sel = pairs[start:start + n]
        start += n
        tok, slot = sel // k, sel % k
        he = h[tok]
        y = (F.silu(he @ p["wi_gate"][e]) * (he @ p["wi_up"][e])) @ p["wo"][e]
        out.index_add_(0, tok, y * w[tok, slot, None])
    if "shared" in p:
        out = out + _mlp(p["shared"], h)
    return out, margin


def mixer(model, kind: str):
    """The mixer of a layer of ``kind`` (``common.layer_kinds``): Mamba-2,
    or attention, MLA where the source has a latent (``kv_lora_rank``),
    else GQA."""
    if kind == "mamba":
        from bench.reference.hybrid_mamba2 import mamba2
        return mamba2
    return _mla if "kv_lora_rank" in model else _gqa


def ffn(model, p, h, i, flip):
    """Layer i's FFN over h, and each position's router margin (None on a
    dense layer); ``flip`` as ``logits`` takes it."""
    from bench.common import layer_is_moe
    if not layer_is_moe(model, i):
        return _mlp(p, h), None
    rows = [flip[0]] if flip is not None and flip[1] == i else None
    return _moe(model, p, h, rows)


def head(params):
    """The output head [D, padded vocab]: its own, or the token embeddings'
    transpose where the configuration ties the two (the program's tree
    then has no head)."""
    own = params.get("head", {})
    return own["w"] if "w" in own else params["embed"]["tok"].T


def _layer(params, i):
    """Layer i's leaves: block i // period, position i % period."""
    layers = params["blocks"]["layers"]
    period = len(layers)

    def pick(t):
        if isinstance(t, dict):
            return {k: pick(v) for k, v in t.items()}
        return t[i // period]
    return pick(layers[i % period])


def logits(model: dict, params: dict, tokens: torch.Tensor,
           last: int, flip: tuple = None) -> tuple:
    """The float32 logits over the vocabulary at the last ``last`` positions
    of ``tokens`` [S] (one sequence, all of its positions computed), at
    every position the least margin, over the MoE layers, between the k-th
    and (k+1)-th router logits of its own token, and the layer of that
    margin.  ``flip`` (position, layer) routes that one token of that
    layer to its (k+1)-th expert in place of its k-th."""
    from bench.common import layer_kinds
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    res = model.get("residual_multiplier", 1.0)
    x = (params["embed"]["tok"][tokens]
         * model.get("embedding_multiplier", 1.0))
    margin = torch.full((S,), math.inf, device=tokens.device)
    where = torch.zeros(S, dtype=torch.long, device=tokens.device)
    for i, kind in enumerate(layer_kinds(model)):
        lp = _layer(params, i)
        x = x + res * mixer(model, kind["mixer"])(
            model, lp["mixer"], _norm(x, lp["ln1"]), pos)
        f, m = ffn(model, lp["ffn"], _norm(x, lp["ln2"]), i, flip)
        if m is not None:
            where = torch.where(m < margin, i, where)
            margin = torch.minimum(margin, m)
        x = x + res * f
    x = _norm(x[S - last:], params["final_norm"])
    return (x @ head(params)[:, :model["vocab_size"]]
            / model.get("logits_scaling", 1.0), margin, where)


def _judge(model, params, seq, n, srv, router_tie, tf32_control, flip):
    """One reading of a request against the reference routed as it
    stands, or with ``flip`` (position, layer) routed the other way."""
    S = seq.shape[0]
    set_precision(False)
    with torch.no_grad():
        ref, margin, where = logits(model, params, seq, n, flip)
    tie = margin[S - n:] < router_tie
    keep = ~tie
    best = ref.max(-1).values

    def gap_of(tokens):
        g = best - ref.gather(-1, tokens[:, None])[:, 0]
        return torch.where(keep, g, torch.zeros_like(g))
    g = gap_of(srv)
    j = int(g.argmax())
    at = S - n + j
    out = {"ties": int(tie.sum()), "gap": float(g[j]), "control": None,
           "worst": {"served_index": j, "position": at,
                     "router_margin": float(margin[at]),
                     "ties_before": int((margin[:at] < router_tie).sum()),
                     "flipped": flip},
           "margin": margin, "where": where}
    if tf32_control:
        set_precision(True)
        try:
            with torch.no_grad():
                low = logits(model, params, seq, n, flip)[0]
        finally:
            set_precision(False)
        out["control"] = float(gap_of(low.argmax(-1)).max())
    return out


def gaps(model: dict, params: dict, prompt, served, *, router_tie: float,
         router_flip: float = 0.0, tf32_control: bool = False) -> dict:
    """For one request, over every served token (the first from the
    prefill, the rest from decode) whose position has no router tie (a
    margin under ``router_tie``): the
    widest gap by which the served token's logit lies below the reference's
    best, where it lies (``worst``: the served token's index, its position,
    its least router margin, the positions before it at a router tie, and
    the position and layer routed the other way, if any),
    and, with ``tf32_control``, the widest gap of the token a TF32 run of
    this reference puts first at the same positions.  Where a gap is above
    0, each is the least over the reference as it stands and its variants
    with one position whose margin is under ``router_flip`` routed the
    other way."""
    dev = params["embed"]["tok"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), device=dev)
    n = len(served)
    srv = torch.as_tensor(served, device=dev)
    if int(srv.max()) >= model["vocab_size"] or int(srv.min()) < 0:
        return {"positions": n, "ties": 0, "gap": math.inf,
                "control": None, "worst": None}
    best = first = _judge(model, params, seq, n, srv, router_tie,
                          tf32_control, None)
    flips = torch.nonzero(first["margin"] < router_flip)[:, 0].tolist()
    ctrl = first["control"]
    judged = 1
    if first["gap"] > 0 or (ctrl or 0) > 0:
        for at in flips:
            v = _judge(model, params, seq, n, srv, router_tie, tf32_control,
                       (at, int(first["where"][at])))
            judged += 1
            if v["control"] is not None:
                ctrl = min(ctrl, v["control"])
            if v["gap"] < best["gap"]:
                best = v
    return {"positions": n, "ties": best["ties"], "gap": best["gap"],
            "control": ctrl, "worst": best["worst"], "judged": judged}
