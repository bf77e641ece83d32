"""Encoder-decoder trunk: whisper-base's backbone, its conv/mel frontend a
stub (port of ``repro/models/encdec.py``).

The encoder takes precomputed frame embeddings [B, S_enc, D] (the stub for
the conv1d + mel frontend, positions assumed baked in) through pre-LN
blocks of non-causal self-attention and the gelu MLP.  The decoder is a
pre-LN stack of causal self-attention, cross-attention over the encoder
states and the gelu MLP, with learned positions (``embed.pos_dec``).  Each
attention goes through ``kernels.ops.attention``: the flash kernel on CUDA
(non-causal for the encoder and the cross-attention).

Block parameters are stacked on a leading axis (``enc_blocks``,
``dec_blocks``), the JAX package's layout, and the passes loop over them.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..kernels import ops
from . import attention as attn_mod
from . import layers
from .transformer import (_identity_shard, block_slice, cross_entropy,
                          make_generator)


def _stack(trees: list):
    """Per-layer parameter dicts -> one dict of [n, ...] stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, in
    the reference's tree: ``embed`` (``tok``, ``pos_dec``), ``enc_blocks``
    (``ln1``, ``attn``, ``ln2``, ``mlp``), ``enc_norm``, ``dec_blocks``
    (``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``),
    ``final_norm`` and ``head``.  Matrices and embeddings in ``dtype``;
    norms and biases float32.  The numbers differ from the JAX init's.  On
    ``meta``, shapes and dtypes only."""
    dev = resolve_device(device)
    gen = make_generator(dev, seed)
    kw = {"dtype": dtype, "device": dev}

    def norm():
        return layers.make_norm_params(cfg, cfg.d_model, dev)

    enc = [{"ln1": norm(), "attn": attn_mod.make_attn_params(gen, cfg, **kw),
            "ln2": norm(), "mlp": layers.make_mlp_params(gen, cfg, **kw)}
           for _ in range(cfg.num_encoder_layers)]
    dec = [{"ln1": norm(),
            "self_attn": attn_mod.make_attn_params(gen, cfg, **kw),
            "ln_x": norm(),
            "cross_attn": attn_mod.make_attn_params(gen, cfg, **kw),
            "ln2": norm(), "mlp": layers.make_mlp_params(gen, cfg, **kw)}
           for _ in range(cfg.num_layers)]
    return {"embed": layers.make_embed_params(gen, cfg, **kw),
            "enc_blocks": _stack(enc), "enc_norm": norm(),
            "dec_blocks": _stack(dec), "final_norm": norm(),
            "head": layers.make_head_params(gen, cfg, **kw)}


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
           shard: Callable = _identity_shard) -> torch.Tensor:
    """frames [B, S_enc, D] stub embeddings -> encoder states [B, S_enc, D].
    Batching is over the leading axis only: a row's states do not depend on
    the other rows.  ``shard`` is the activation hook
    (``models.transformer.forward``)."""
    B, S, _ = frames.shape
    positions = torch.arange(S, device=frames.device)[None, :].expand(B, S)
    x = shard(frames, "hidden")
    for i in range(cfg.num_encoder_layers):
        bp = block_slice(params["enc_blocks"], i)
        h = layers.apply_norm(cfg, bp["ln1"], x)
        x = x + attn_mod.self_attention(cfg, bp["attn"], h, positions,
                                        causal=False)
        h = layers.apply_norm(cfg, bp["ln2"], x)
        x = shard(x + layers.apply_mlp(cfg, bp["mlp"], h), "hidden")
    return layers.apply_norm(cfg, params["enc_norm"], x)


def decode_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   enc_states: torch.Tensor, *, collect_kv: bool = False,
                   shard: Callable = _identity_shard):
    """Teacher-forced decoder pass: tokens [B, S_dec] over ``enc_states``
    -> (logits [B, S_dec, Vp], caches).

    With ``collect_kv`` the caches are ``{"self_kv": (k, v), "cross_kv":
    (k, v)}``, each stacked over decoder layers: self [L, B, S_dec, Hkv,
    hd], cross [L, B, S_enc, Hkv, hd] (the JAX scan's layout); otherwise
    None."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = layers.embed_tokens(params["embed"], tokens)
    x = shard(x + params["embed"]["pos_dec"][:S][None].to(x.dtype), "hidden")
    kv = {"self_kv": ([], []), "cross_kv": ([], [])}
    for i in range(cfg.num_layers):
        bp = block_slice(params["dec_blocks"], i)
        h = layers.apply_norm(cfg, bp["ln1"], x)
        q, k, v = attn_mod.qkv_proj(cfg, bp["self_attn"], h, positions)
        o = ops.attention(q, k, v, causal=True)
        x = x + o.reshape(B, S, -1) @ bp["self_attn"]["wo"]
        h = layers.apply_norm(cfg, bp["ln_x"], x)
        mem_k, mem_v = attn_mod.encoder_kv(cfg, bp["cross_attn"], enc_states)
        x = x + attn_mod.cross_attention(cfg, bp["cross_attn"], h, mem_k,
                                         mem_v)
        h = layers.apply_norm(cfg, bp["ln2"], x)
        x = shard(x + layers.apply_mlp(cfg, bp["mlp"], h), "hidden")
        if collect_kv:
            for name, pair in (("self_kv", (k, v)), ("cross_kv",
                                                     (mem_k, mem_v))):
                kv[name][0].append(pair[0])
                kv[name][1].append(pair[1])
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = shard(layers.apply_head(cfg, params["head"], params["embed"], x),
                   "logits")
    if not collect_kv:
        return logits, None
    return logits, {name: tuple(torch.stack(t) for t in pair)
                    for name, pair in kv.items()}


def forward(cfg: ModelConfig, params: dict, frames, tokens, *,
            shard: Callable = _identity_shard, remat: str = "none",
            device="cuda") -> torch.Tensor:
    """Full encoder-decoder pass -> logits [B, S_dec, Vp].  ``params`` must
    live on ``device``; frames and tokens are moved there.  ``remat`` is
    accepted and ignored, as the reference's ``forward`` does."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, device=dev)
    tokens = torch.as_tensor(tokens, device=dev)
    logits, _ = decode_forward(cfg, params, tokens,
                               encode(cfg, params, frames, shard=shard),
                               shard=shard)
    return logits


def loss_fn(cfg: ModelConfig, params: dict, frames, tokens, targets, *,
            shard: Callable = _identity_shard, remat: str = "none",
            device="cuda") -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder over the frames."""
    logits = forward(cfg, params, frames, tokens, shard=shard, remat=remat,
                     device=device)
    return cross_entropy(logits, targets)
