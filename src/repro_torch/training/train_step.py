"""Training step: loss -> (accumulated, optionally compressed) grads -> AdamW
(port of ``repro/training/train_step.py``).

  * microbatch gradient accumulation (a loop over microbatches with
    float32 accumulators, the reference's ``lax.scan``);
  * remat policies ("none" | "dots" | "full") threaded into the model;
  * the data-parallel steps (``make_hybrid_train_step``,
    ``make_compressed_train_step``) run on one device: the batch is split
    into ``data_shards`` blocks of rows along a leading virtual ``data``
    axis (``shard_map``'s partition), each shard takes its own grads, and
    the cross-shard ``pmean`` is a sum over the shards in the grads' dtype
    (bfloat16 when compressed) divided by their number.

``shard`` is the launch layer's activation hook
(``launch.sharding.make_shard_fn``), passed to the model's loss as the
reference passes it; None leaves the model's identity default.
Parameters come in as plain tensors; each loss call takes its grads with
respect to detached copies of the leaves, so a ``block_slice`` view of a
stacked leaf accumulates into the stacked leaf.
"""
from __future__ import annotations

import torch

from .. import models
from ..configs.base import ModelConfig
from .optimizer import AdamWConfig, adamw_update
from .tree import leaves, map_tree, unflatten

_COMPRESS = {None: None, "bf16": torch.bfloat16}


def make_loss_fn(cfg: ModelConfig, shard=None, remat: str = "dots",
                 device="cuda"):
    kw = {"remat": remat, "device": device}
    if shard is not None:
        kw["shard"] = shard

    def loss_fn(params, batch):
        return models.loss_fn(cfg, params, batch, **kw)
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): grads shaped like ``params``, each in its leaf's dtype
    (zeros for a leaf the loss does not reach, as JAX gives)."""
    req = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, req), batch)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(req, grads)]
    return loss.detach(), unflatten(params, grads)


def _per_microbatch(loss_fn, params):
    """``value_and_grad`` for each microbatch.  On ``meta`` (the launch
    layer's dry run) every microbatch and data shard has the same shapes
    and no values, so the first call's result stands for the rest, as the
    reference's ``lax.scan`` traces its body once."""
    memo = []
    shape_only = leaves(params)[0].device.type == "meta"

    def vg(mb):
        if memo:
            return memo[0]
        out = value_and_grad(loss_fn, params, mb)
        if shape_only:
            memo.append(out)
        return out
    return vg


def split_rows(batch: dict, n: int) -> list[dict]:
    """``n`` consecutive blocks of the batch's leading (row) axis."""
    def block(x, i):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows does not split into {n}")
        return x[i * (b // n):(i + 1) * (b // n)]
    return [{k: block(v, i) for k, v in batch.items()} for i in range(n)]


def _check_compress(compress):
    if compress not in _COMPRESS:
        raise ValueError(f"compress must be None or 'bf16', got {compress!r}")
    return _COMPRESS[compress]


def accumulate_grads(loss_fn, params, batch, num_micro: int = 1,
                     compress: str | None = None):
    """Returns (mean loss, grads).  ``batch`` leaves: [B, ...]; the
    microbatch loop splits B into ``num_micro`` chunks.

    ``compress``: None | "bf16" — each microbatch's grads are cast to
    bfloat16 (the compressed all-reduce's payload) before they are summed
    in float32.  With one microbatch the grads keep the (cast) leaf dtype,
    with several they are float32, as the reference returns them."""
    cast = _check_compress(compress)
    if num_micro == 1:
        loss, grads = value_and_grad(loss_fn, params, batch)
        if cast is not None:
            grads = map_tree(lambda g: g.to(cast), grads)
        return loss, grads
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
    acc = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    vg = _per_microbatch(loss_fn, params)
    for mb in split_rows(batch, num_micro):
        loss, grads = vg(mb)
        if cast is not None:
            grads = map_tree(lambda g: g.to(cast), grads)
        acc = map_tree(lambda a, g: a + g.float(), acc, grads)
        loss_sum = loss_sum.to(loss.device) + loss
    return loss_sum / num_micro, map_tree(lambda g: g / num_micro, acc)


def _update(opt_cfg: AdamWConfig, params, opt_state, loss, grads):
    params, opt_state, stats = adamw_update(opt_cfg, params, grads, opt_state)
    stats["loss"] = loss
    return params, opt_state, stats


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    shard=None, remat: str = "dots", num_micro: int = 1,
                    device="cuda"):
    """One optimizer step on the whole batch: (params, opt_state, batch) ->
    (params, opt_state, stats with "loss", "grad_norm", "lr")."""
    loss_fn = make_loss_fn(cfg, shard=shard, remat=remat, device=device)

    def train_step(params, opt_state, batch):
        loss, grads = accumulate_grads(loss_fn, params, batch,
                                       num_micro=num_micro)
        return _update(opt_cfg, params, opt_state, loss, grads)

    return train_step


def _data_mean(shard_fn, batch: dict, data_shards: int):
    """``shard_fn`` on each block of the virtual ``data`` axis, then the
    ``pmean`` of its (loss, grads): a sum in the grads' dtype over the
    shards, divided by their number."""
    losses, total = [], None
    for sb in split_rows(batch, data_shards):
        loss, grads = shard_fn(sb)
        losses.append(loss)
        total = grads if total is None else map_tree(torch.add, total, grads)
    return (torch.stack(losses).mean(),
            map_tree(lambda g: g / data_shards, total))


def make_hybrid_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                           data_shards: int, *, shard=None,
                           remat: str = "full", num_micro: int = 4,
                           compress: str | None = "bf16", device="cuda"):
    """Deferred-single-reduction train step: each data shard accumulates its
    microbatch grads locally (in bfloat16 when compressed, else float32),
    and the cross-shard mean happens once, in that dtype, before the cast
    to float32 and the division by ``num_micro``."""
    loss_fn = make_loss_fn(cfg, shard=shard, remat=remat, device=device)
    acc_dtype = _check_compress(compress) or torch.float32

    def train_step(params, opt_state, batch):
        vg = _per_microbatch(loss_fn, params)

        def shard_grads(sb):
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves(params)[0].device)
            acc = None
            for mb in split_rows(sb, num_micro):
                loss, grads = vg(mb)
                grads = map_tree(lambda g: g.to(acc_dtype), grads)
                acc = grads if acc is None else map_tree(torch.add, acc, grads)
                loss_sum = loss_sum.to(loss.device) + loss
            return loss_sum / num_micro, acc
        loss, grads = _data_mean(shard_grads, batch, data_shards)
        grads = map_tree(lambda g: g.float() / num_micro, grads)
        return _update(opt_cfg, params, opt_state, loss, grads)

    return train_step


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                               data_shards: int, *, remat: str = "dots",
                               num_micro: int = 1, compress: str = "bf16",
                               device="cuda"):
    """Data-parallel train step with a bfloat16-compressed gradient mean:
    each shard's ``accumulate_grads`` (compressed), cast to float32, then
    the mean over the shards."""
    loss_fn = make_loss_fn(cfg, remat=remat, device=device)
    _check_compress(compress)

    def train_step(params, opt_state, batch):
        def shard_grads(sb):
            loss, grads = accumulate_grads(loss_fn, params, sb,
                                           num_micro=num_micro,
                                           compress=compress)
            return loss, map_tree(lambda g: g.float(), grads)
        loss, grads = _data_mean(shard_grads, batch, data_shards)
        return _update(opt_cfg, params, opt_state, loss, grads)

    return train_step
