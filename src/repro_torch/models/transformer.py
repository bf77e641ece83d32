"""Decoder-only trunk: init + prefill forward for the dense GQA, MLA and
MoE families (port of ``repro/models/transformer.py``).

The trunk is ``cfg.num_blocks`` repeats of a ``cfg.block_period``-layer
block pattern; block parameters are stacked on a leading axis (the JAX
package's ``params["blocks"]`` layout, which it ``lax.scan``s) and the
forward loops over them.  SSM and encoder-decoder families raise
``NotImplementedError`` (ROADMAP queue 1 items 11-12).
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..kernels import ops
from . import attention as attn_mod
from . import layers, mla, moe


def check_supported(cfg: ModelConfig) -> None:
    """The port serves every decoder-only attention family: dense GQA (with
    qkv bias or qk-norm), MLA and MoE."""
    if cfg.family in ("ssm", "hybrid") or not cfg.has_attention:
        raise NotImplementedError("SSM/hybrid models are not ported yet "
                                  "(ROADMAP queue 1 item 11)")
    if cfg.is_encoder_decoder:
        raise NotImplementedError("encoder-decoder models are not ported yet "
                                  "(ROADMAP queue 1 item 12)")


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``.

    Matrices are ``dtype`` (bf16 by default, as the JAX init makes them),
    norm scales float32.  The numbers differ from the JAX init's; tests
    convert JAX weights with ``repro_torch.params`` instead.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = {"dtype": dtype, "device": dev}

    make_mixer = mla.make_mla_params if cfg.is_mla else attn_mod.make_attn_params

    def layer_params(kind):
        make_ffn = (moe.make_moe_params if kind["ffn"] == "moe"
                    else layers.make_mlp_params)
        return {"ln1": layers.make_norm_params(cfg, cfg.d_model, dev),
                "mixer": make_mixer(gen, cfg, **kw),
                "ln2": layers.make_norm_params(cfg, cfg.d_model, dev),
                "ffn": make_ffn(gen, cfg, **kw)}

    # each block is written into preallocated stacked leaves as soon as it
    # is made: the peak is the stack plus one block, never two stacks (and
    # a single block is its own stack, a view)
    pattern = cfg.block_pattern()
    stacked = None
    for bi in range(cfg.num_blocks):
        blk = [layer_params(kind) for kind in pattern]
        if cfg.num_blocks == 1:
            stacked = _map(blk, lambda t: t[None])
            break
        if stacked is None:
            stacked = _map(blk, lambda t: t.new_empty((cfg.num_blocks,
                                                       *t.shape)))
        _map2(stacked, blk, lambda s, t: s[bi].copy_(t))
        del blk
    return {"embed": layers.make_embed_params(gen, cfg, **kw),
            "blocks": {"layers": stacked},
            "final_norm": layers.make_norm_params(cfg, cfg.d_model, dev),
            "head": layers.make_head_params(gen, cfg, **kw)}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _map2(a, b, fn):
    if isinstance(a, dict):
        for k in a:
            _map2(a[k], b[k], fn)
    elif isinstance(a, list):
        for x, y in zip(a, b):
            _map2(x, y, fn)
    else:
        fn(a, b)


def block_slice(tree, i: int):
    """Block ``i`` of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: block_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [block_slice(v, i) for v in tree]
    return tree[i]


# --------------------------------------------------------------------------- #
# forward (prefill)
# --------------------------------------------------------------------------- #
def apply_layer(cfg: ModelConfig, kind: dict, lp: dict, x: torch.Tensor,
                positions: torch.Tensor, collect_kv: bool):
    """One layer: pre-norm attention + pre-norm FFN with residuals.

    Returns (x, aux) where aux holds the prefill cache material: (k, v), or
    MLA's latent (c_kv, k_rope).
    """
    aux = {}
    h = layers.apply_norm(cfg, lp["ln1"], x)
    if cfg.is_mla:
        lat = mla.mla_latent(cfg, lp["mixer"], h, positions)
        if collect_kv:
            aux["kv"] = lat
        x = x + mla.mla_self_attention(cfg, lp["mixer"], h, positions,
                                       latent=lat)
    else:
        q, k, v = attn_mod.qkv_proj(cfg, lp["mixer"], h, positions)
        if collect_kv:
            aux["kv"] = (k, v)
        o = ops.attention(q, k, v, causal=True)
        B, S = h.shape[:2]
        x = x + o.reshape(B, S, -1) @ lp["mixer"]["wo"]
    h = layers.apply_norm(cfg, lp["ln2"], x)
    if kind["ffn"] == "moe":
        x = x + moe.moe_ffn_batched(cfg, lp["ffn"], h)
    else:
        x = x + layers.apply_mlp(cfg, lp["ffn"], h)
    return x, aux


def forward(cfg: ModelConfig, params: dict, tokens, *,
            positions: torch.Tensor | None = None, collect_kv: bool = False,
            device="cuda"):
    """tokens [B, S] -> (logits [B, S, Vp], caches).

    ``caches`` (with ``collect_kv``) is a list over the block pattern of
    ``{"kv": (k, v)}`` with k/v stacked over blocks: [nb, B, S, Hkv, hd]
    (MLA: (c_kv [nb, B, S, kvr], k_rope [nb, B, S, dr])), as the JAX scan
    stacks them; otherwise None.  ``params`` must live on
    ``device``; the tokens are moved there.
    """
    check_supported(cfg)
    tokens = torch.as_tensor(tokens, device=resolve_device(device))
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = layers.embed_tokens(params["embed"], tokens)
    pattern = cfg.block_pattern()
    auxes = [[] for _ in pattern]
    for bi in range(cfg.num_blocks):
        bp = block_slice(params["blocks"], bi)
        for li, kind in enumerate(pattern):
            x, aux = apply_layer(cfg, kind, bp["layers"][li], x, positions,
                                 collect_kv)
            auxes[li].append(aux)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = layers.apply_head(cfg, params["head"], params["embed"], x)
    if not collect_kv:
        return logits, None
    caches = [{"kv": tuple(torch.stack([a["kv"][j] for a in per_layer])
                           for j in range(2))}
              for per_layer in auxes]
    return logits, caches
