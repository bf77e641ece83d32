"""Decoder-only trunk: init, the prefill and train forward (with the
reference's remat policies) and the loss, for the dense GQA, MLA, MoE, SSM
(Mamba-2) and hybrid (Jamba) families (port of
``repro/models/transformer.py``).

The trunk is ``cfg.num_blocks`` repeats of a ``cfg.block_period``-layer
block pattern; block parameters are stacked on a leading axis (the JAX
package's ``params["blocks"]`` layout, which it ``lax.scan``s) and the
forward loops over them.  A layer's mixer is attention or an SSD block
(``kind["mixer"]``); its FFN is dense, MoE or, for Mamba-2, absent.  The
encoder-decoder family has its own trunk (``models/encdec.py``;
``models.init_params`` dispatches by config).
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from typing import Callable

from .. import resolve_device
from ..configs.base import ModelConfig
from ..kernels import ops
from . import attention as attn_mod
from . import layers, mla, moe, ssm


def _identity_shard(x, name: str):
    """The default activation hook: ``x`` unchanged."""
    return x


def check_supported(cfg: ModelConfig) -> None:
    """The decoder-only trunk (and its decode step) takes every
    decoder-only family: dense GQA (with qkv bias or qk-norm), MLA, MoE,
    SSM and the SSM/attention hybrid.  An encoder-decoder config goes
    through ``models/encdec.py`` and ``dcp``'s ``encdec`` functions."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: use "
                         "models.encdec (or models.init_params) and the "
                         "dcp encdec step")


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed``.

    Matrices are ``dtype`` (bf16 by default, as the JAX init makes them),
    norm scales float32.  The numbers differ from the JAX init's; tests
    convert JAX weights with ``repro_torch.params`` instead.  On ``meta``
    the tensors have shapes and dtypes only (the launch layer's dry run).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    gen = make_generator(dev, seed)
    kw = {"dtype": dtype, "device": dev}

    make_attn = mla.make_mla_params if cfg.is_mla else attn_mod.make_attn_params

    def layer_params(kind):
        make_mixer = make_attn if kind["mixer"] == "attn" else ssm.make_ssm_params
        p = {"ln1": layers.make_norm_params(cfg, cfg.d_model, dev),
             "mixer": make_mixer(gen, cfg, **kw)}
        if kind["ffn"] != "none":
            make_ffn = (moe.make_moe_params if kind["ffn"] == "moe"
                        else layers.make_mlp_params)
            p["ln2"] = layers.make_norm_params(cfg, cfg.d_model, dev)
            p["ffn"] = make_ffn(gen, cfg, **kw)
        return p

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


def make_generator(dev: torch.device, seed: int):
    """The init's seeded generator on ``dev``; None on ``meta``, which has
    no generator and no values to draw."""
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)


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
                positions: torch.Tensor, collect_kv: bool,
                shard: Callable = _identity_shard):
    """One layer: pre-norm mixer (attention or SSD) + pre-norm FFN with
    residuals, each residual sum passed through ``shard(.., "hidden")``.

    Returns (x, aux) where aux holds the prefill cache material: (k, v),
    MLA's latent (c_kv, k_rope), or an SSD layer's (conv_state, ssm_state).
    """
    aux = {}
    h = layers.apply_norm(cfg, lp["ln1"], x)
    if kind["mixer"] == "ssm":
        mix, states = ssm.ssm_block(cfg, lp["mixer"], h, shard=shard)
        if collect_kv:
            aux["ssm"] = states
    elif cfg.is_mla:
        lat = mla.mla_latent(cfg, lp["mixer"], h, positions)
        if collect_kv:
            aux["kv"] = lat
        mix = mla.mla_self_attention(cfg, lp["mixer"], h, positions,
                                     latent=lat)
    else:
        q, k, v = attn_mod.qkv_proj(cfg, lp["mixer"], h, positions)
        if collect_kv:
            aux["kv"] = (k, v)
        o = ops.attention(q, k, v, causal=True)
        B, S = h.shape[:2]
        mix = o.reshape(B, S, -1) @ lp["mixer"]["wo"]
    x = shard(x + mix, "hidden")
    if kind["ffn"] == "none":
        return x, aux
    h = layers.apply_norm(cfg, lp["ln2"], x)
    if kind["ffn"] == "moe":
        f = moe.moe_ffn_batched(cfg, lp["ffn"], h)
    else:
        f = layers.apply_mlp(cfg, lp["ffn"], h)
    return shard(x + f, "hidden"), aux


# --------------------------------------------------------------------------- #
# remat policies (the reference's ``jax.checkpoint`` around its scan body)
# --------------------------------------------------------------------------- #
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, func, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the 2-D weight products,
    recompute the rest (``bmm``, the flash op, norms, elementwise)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if func in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the remat policy ``remat``: "none" keeps every
    activation for the backward, "full" recomputes ``fn`` in the backward,
    "dots" recomputes all but its ``aten.mm`` / ``aten.addmm`` outputs.
    The forward draws no random numbers (no dropout), so no RNG state is
    stashed for the recompute (a host tensor, which the meta dry run
    would see leave the meta device)."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               preserve_rng_state=False)
    if remat == "dots":
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=functools.partial(
                                   ckpt.create_selective_checkpoint_contexts,
                                   _save_dots))
    raise ValueError(f"remat must be none, dots or full, got {remat!r}")


def forward(cfg: ModelConfig, params: dict, tokens, *,
            positions: torch.Tensor | None = None, collect_kv: bool = False,
            shard: Callable = _identity_shard, remat: str = "none",
            device="cuda"):
    """tokens [B, S] -> (logits [B, S, Vp], caches).

    ``caches`` (with ``collect_kv``) is a list over the block pattern of
    ``{"kv": (k, v)}`` with k/v stacked over blocks: [nb, B, S, Hkv, hd]
    (MLA: (c_kv [nb, B, S, kvr], k_rope [nb, B, S, dr])), or for an SSD
    layer ``{"ssm": (conv_state [nb, B, W-1, conv_dim], ssm_state
    [nb, B, nh, hd, ns])}``, as the JAX scan stacks them; otherwise None.
    ``params`` must live on ``device``; the tokens are moved there.

    ``remat`` ("none" | "dots" | "full") applies to each block of
    ``cfg.block_pattern()``, as the reference's checkpointed scan body; under
    "full" a block of several layers (Jamba's 8) also checkpoints each
    layer, so the backward holds one layer's internals at a time.  It
    changes no value, only what the backward keeps and recomputes.

    ``shard(x, name)`` is the launch layer's activation hook
    (``launch.sharding.make_shard_fn``), called where the reference places
    its sharding constraints: the embedded tokens and each residual sum
    ("hidden"), the SSD scan's chunked tensors ("ssm_chunk") and the logits
    ("logits").  It must return ``x``'s values; the default is the
    identity.
    """
    check_supported(cfg)
    tokens = torch.as_tensor(tokens, device=resolve_device(device))
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = shard(layers.embed_tokens(params["embed"], tokens), "hidden")
    pattern = cfg.block_pattern()
    nested = remat == "full" and len(pattern) > 1 and not collect_kv

    def block_fn(x, bp):
        auxes = []
        for li, kind in enumerate(pattern):
            layer = functools.partial(apply_layer, cfg, kind, shard=shard)
            if nested:
                x, aux = remat_call("full", layer, bp["layers"][li], x,
                                    positions, collect_kv)
            else:
                x, aux = layer(bp["layers"][li], x, positions, collect_kv)
            auxes.append(aux)
        return x, auxes

    auxes = [[] for _ in pattern]
    for bi in range(cfg.num_blocks):
        x, block_aux = remat_call(remat, block_fn, x,
                                  block_slice(params["blocks"], bi))
        for li, aux in enumerate(block_aux):
            auxes[li].append(aux)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = shard(layers.apply_head(cfg, params["head"], params["embed"], x),
                   "logits")
    if not collect_kv:
        return logits, None
    caches = [{name: tuple(torch.stack([a[name][j] for a in per_layer])
                           for j in range(2))
               for name in per_layer[0]}
              for per_layer in auxes]
    return logits, caches


def cross_entropy(logits: torch.Tensor, targets) -> torch.Tensor:
    """Mean next-token cross-entropy in float32: logsumexp - gold logit
    (over the padded vocab, as the reference)."""
    logits = logits.float()
    targets = torch.as_tensor(targets, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold).mean()


def loss_fn(cfg: ModelConfig, params: dict, tokens, targets, *,
            shard: Callable = _identity_shard, remat: str = "none",
            device="cuda") -> torch.Tensor:
    """Mean next-token cross-entropy (targets = tokens shifted by the
    caller)."""
    logits, _ = forward(cfg, params, tokens, shard=shard, remat=remat,
                        device=device)
    return cross_entropy(logits, targets)
