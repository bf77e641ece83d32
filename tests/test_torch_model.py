"""The port's dense prefill forward and weight converter, held against the
JAX package on reduced tinyllama (2 layers, vocab 256) in float32.

Tolerance: atol = rtol = 1e-4 on logits and collected k/v (the same f32
model evaluated by two frameworks, whose matmuls sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.models import init_params as jinit, transformer as jtransformer
from repro_torch import params as P
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.models import transformer

TOL = 1e-4


def _setup(dtype=jnp.float32):
    jcfg = jreduced(JCONFIGS["tinyllama-1.1b"], num_layers=2, vocab_size=256)
    cfg = reduced(CONFIGS["tinyllama-1.1b"], num_layers=2, vocab_size=256)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    if dtype is not None:
        jparams = jax.tree.map(lambda x: x.astype(dtype), jparams)
    return jcfg, cfg, jparams


def test_config_copy_matches_reference():
    """The port's copy of the config dataclass has the reference's fields,
    defaults and derived values (the two classes are distinct types)."""
    assert (dataclasses.asdict(get_config("tinyllama-1.1b"))
            == dataclasses.asdict(JCONFIGS["tinyllama-1.1b"]))
    jcfg, cfg, _ = _setup()
    for f in jcfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.block_pattern() == jcfg.block_pattern()
    assert cfg.padded_vocab == jcfg.padded_vocab


@pytest.mark.parametrize("B,S", [(1, 77), (2, 33)])
def test_forward_logits_and_kv_match_jax(B, S):
    jcfg, cfg, jparams = _setup()
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(S).integers(0, 256, (B, S))
    lj, cj = jtransformer.forward(jcfg, jparams, jnp.asarray(toks),
                                  collect_kv=True)
    lt, ct = transformer.forward(cfg, params, torch.as_tensor(toks),
                                 collect_kv=True, device="cpu")
    assert lt.shape == lj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    for li in range(len(cfg.block_pattern())):
        for j in range(2):
            got, want = ct[li]["kv"][j].numpy(), np.asarray(cj[li]["kv"][j])
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    _, none = transformer.forward(cfg, params, torch.as_tensor(toks),
                                  device="cpu")
    assert none is None


def test_params_round_trip_is_exact():
    """JAX tree -> torch -> numpy -> torch is exact, bf16 leaves included
    (the JAX init's own dtypes: bf16 matrices, f32 norm scales)."""
    _, _, jparams = _setup(dtype=None)
    np_tree = jax.tree.map(np.asarray, jparams)
    tp = P.from_jax(np_tree, device="cpu")
    assert tp["blocks"]["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert tp["final_norm"]["scale"].dtype == torch.float32
    back = P.to_jax(tp)
    flat_a = jax.tree.leaves(np_tree)
    flat_b = jax.tree.leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    again = P.from_jax(back, device="cpu", dtype=torch.bfloat16)
    for a, b in zip(jax.tree.leaves(P.to_jax(tp)), jax.tree.leaves(P.to_jax(again))):
        np.testing.assert_array_equal(a, b)
    # the JAX side restores its own tree from the numpy leaves
    restored = jax.tree.map(lambda a, ref: jnp.asarray(a, ref.dtype), back,
                            jparams)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_init_params_layout_and_seed():
    """``init_params`` builds the reference's stacked layout from a seeded
    torch.Generator: same shapes as the JAX init, reproducible per seed."""
    jcfg, cfg, jparams = _setup(dtype=None)
    a = transformer.init_params(cfg, seed=3, device="cpu")
    b = transformer.init_params(cfg, seed=3, device="cpu")
    c = transformer.init_params(cfg, seed=4, device="cpu")
    shapes_j = [tuple(x.shape) for x in jax.tree.leaves(jparams)]
    shapes_t = [tuple(x.shape) for x in jax.tree.leaves(P.to_jax(a))]
    assert shapes_j == shapes_t
    wa = a["blocks"]["layers"][0]["mixer"]["wq"]
    assert torch.equal(wa, b["blocks"]["layers"][0]["mixer"]["wq"])
    assert not torch.equal(wa, c["blocks"]["layers"][0]["mixer"]["wq"])
    logits, _ = transformer.forward(cfg, a, torch.zeros((1, 5), dtype=torch.long),
                                    device="cpu")
    assert torch.isfinite(logits.float()).all()
