"""Full-width TinyLlama-1.1B (d_model 2048, vocab 32000; depth cut to one
layer) through both packages on the CPU.

The test holds the port's own init (``transformer.init_params``, the one
the card's train phase starts from) to the reference's at full width:
every leaf's standard deviation within 1% of the reference's, its mean
within 1% of that deviation, and the logits' scale on one batch within
5%.

Run as a script, it is the witness for the card's train learning rate:
the reference's ``make_train_step`` (jit) and the port's take 5 AdamW
steps at the reference smoke test's schedule (lr 1e-3, warmup 2, total
10) from the same reference weights in float32 at B 1 x S 128
(``SyntheticTokens``, seed 0), and the port again from its own init; it
prints the three loss trajectories and the largest difference between
the first two as one JSON line (about a minute and 8 GB of host memory):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_width.py
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import init_params as jinit
from repro.training import optimizer as joptimizer, train_step as jtrain_step
from repro_torch import params as P
from repro_torch.configs import CONFIGS
from repro_torch.models import transformer
from repro_torch.training import data, optimizer, train_step

from test_torch_train_models import _one_thread  # noqa: F401

ARCH = "tinyllama-1.1b"
CFG = dataclasses.replace(CONFIGS[ARCH], num_layers=1)
JCFG = dataclasses.replace(JCONFIGS[ARCH], num_layers=1)
STD_TOL, MEAN_TOL, LOGIT_TOL = 1e-2, 1e-2, 5e-2


def _paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float32)


def _ref_init() -> dict:
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jinit(jax.random.PRNGKey(0), JCFG))


def _own_init() -> dict:
    return transformer.init_params(CFG, seed=0, device="cpu",
                                   dtype=torch.float32)


def test_full_width_init_scales_match_reference():
    ref_np = _ref_init()
    own = _own_init()
    ref_leaves = list(_paths(ref_np))
    own_leaves = list(_paths(own))
    assert [p for p, _ in own_leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(ref_leaves, own_leaves):
        assert a.shape == b.shape, path
        ra, rb = float(a.std()), float(b.std())
        assert abs(rb - ra) <= STD_TOL * ra, (path, ra, rb)
        assert abs(float(b.mean()) - float(a.mean())) <= MEAN_TOL * ra, path
    tokens = np.random.default_rng(0).integers(0, CFG.vocab_size, (1, 32))
    with torch.no_grad():
        lg_ref = transformer.forward(CFG, P.from_jax(ref_np, device="cpu"),
                                     tokens, device="cpu")[0]
        lg_own = transformer.forward(CFG, own, tokens, device="cpu")[0]
    sr = float(lg_ref[..., :CFG.vocab_size].std())
    so = float(lg_own[..., :CFG.vocab_size].std())
    assert abs(so - sr) <= LOGIT_TOL * sr, (sr, so)


def _port_losses(params, ds, opt_cfg, steps: int) -> list:
    step_fn = train_step.make_train_step(CFG, opt_cfg, device="cpu")
    opt, losses = optimizer.init_opt_state(params), []
    for i in range(steps):
        params, opt, stats = step_fn(params, opt, ds.batch_at(i))
        losses.append(float(stats["loss"]))
    return losses


def lr_witness(lr: float = 1e-3, steps: int = 5, batch: int = 1,
               seq: int = 128) -> dict:
    ds = data.SyntheticTokens(CFG, batch=batch, seq_len=seq, seed=0)
    ref_np = _ref_init()
    jfn = jax.jit(jtrain_step.make_train_step(
        JCFG, joptimizer.AdamWConfig(lr=lr, warmup_steps=2, total_steps=10)))
    jp = jax.tree.map(jnp.asarray, ref_np)
    jo, jl = joptimizer.init_opt_state(jp), []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
        jp, jo, stats = jfn(jp, jo, b)
        jl.append(float(stats["loss"]))
    del jp, jo, jfn
    opt_cfg = optimizer.AdamWConfig(lr=lr, warmup_steps=2, total_steps=10)
    pl = _port_losses(P.from_jax(ref_np, device="cpu"), ds, opt_cfg, steps)
    del ref_np
    ol = _port_losses(_own_init(), ds, opt_cfg, steps)
    return {"model": CFG.name, "num_layers": CFG.num_layers, "lr": lr,
            "batch": batch, "seq": seq, "reference": jl,
            "port_on_reference_init": pl, "port_own_init": ol,
            "max_abs_diff": max(abs(a - b) for a, b in zip(jl, pl))}


if __name__ == "__main__":
    print(json.dumps(lr_witness()))
