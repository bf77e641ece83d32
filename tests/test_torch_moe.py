"""The port's MoE (``repro_torch.models.moe``, ``core.moe_parallel``) and
layernorm, held against the JAX package on the CPU.

Reduced phi3.5-moe (4 experts, top-2, expert d_ff 64, layernorm); weights
come from the JAX init (cast to float32) through ``repro_torch.params``,
inputs are drawn with numpy.  Integer routing tables must be bit-equal to
the reference's; float outputs agree within the tolerance each test
states (relative to the largest reference value: the reduced init's
expert weights take E as their fan-in, so outputs reach ~1e2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.models import (init_params as jinit, layers as jlayers,
                          moe as jmoe, transformer as jtransformer)
from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.moe_parallel import moe_decode_ffn
from repro_torch.models import layers, moe, transformer

ARCH = "phi3.5-moe-42b-a6.6b"
RTOL = 1e-5


def _models(**over):
    jcfg = jreduced(JCONFIGS[ARCH], vocab_size=256, **over)
    cfg = reduced(CONFIGS[ARCH], vocab_size=256, **over)
    raw = jinit(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32), raw)
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params, raw


def _ffn(jparams, block=0):
    """Block ``block``'s MoE FFN leaves: (numpy for JAX, torch)."""
    fp = jax.tree.map(lambda a: np.array(a[block]),
                      jparams["blocks"]["layers"][0]["ffn"])
    return fp, jax.tree.map(torch.from_numpy, fp)


def _rows(T, D, seed=0, zero=()):
    x = np.random.default_rng(seed).standard_normal((T, D)).astype(np.float32)
    x[list(zero)] = 0.0
    return x


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def test_converter_keeps_router_float32_and_stacked_experts():
    """bf16 JAX weights convert leaf by leaf: the router stays float32, the
    experts keep their stacked [nb, E, D, F] / [nb, E, F, D] layout."""
    jcfg, _, cfg, _, raw = _models()
    conv = P.from_jax(jax.tree.map(np.asarray, raw), device="cpu")
    ffn = conv["blocks"]["layers"][0]["ffn"]
    nb, E, D, Fe = cfg.num_blocks, cfg.num_experts, cfg.d_model, cfg.moe_d_ff_
    assert ffn["router"].dtype == torch.float32
    assert ffn["router"].shape == (nb, D, E)
    for name, shape in (("wi_gate", (nb, E, D, Fe)), ("wi_up", (nb, E, D, Fe)),
                        ("wo", (nb, E, Fe, D))):
        assert ffn[name].dtype == torch.bfloat16 and ffn[name].shape == shape
        np.testing.assert_array_equal(
            ffn[name].float().numpy(),
            np.asarray(raw["blocks"]["layers"][0]["ffn"][name], np.float32))
    # the port's own init has the same tree, shapes and dtypes
    own = transformer.init_params(cfg, seed=0, device="cpu")
    flat = lambda t: {k: (v.shape, v.dtype) for k, v in
                      t["blocks"]["layers"][0]["ffn"].items()}
    assert flat(own) == flat(conv)


@pytest.mark.parametrize("zero", [(), (3, 4, 5, 6)], ids=["dense", "zero-rows"])
def test_router_topk_matches_jax(zero):
    jcfg, jparams, cfg, _, _ = _models()
    fp, tp = _ffn(jparams)
    x = _rows(32, cfg.d_model, zero=zero)
    wj, ij = jmoe.router_topk(jcfg, jnp.asarray(fp["router"]), jnp.asarray(x))
    wt, it = moe.router_topk(cfg, tp["router"], torch.from_numpy(x))
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-6)
    if zero:          # ties: the lowest expert indices, as lax.top_k
        assert (it.numpy()[list(zero)] == [0, 1]).all()


@pytest.mark.parametrize("cf", [1.25, 8.0], ids=["cf1.25-drops", "cf8"])
def test_group_by_expert_tables_bit_equal(cf):
    """src_token and slot_of equal the reference's int32 tables bit for bit,
    with all-zero rows (which tie on every expert) among real ones; at
    capacity factor 1.25 some assignments are dropped."""
    jcfg, jparams, cfg, _, _ = _models(capacity_factor=cf)
    fp, tp = _ffn(jparams)
    T, E = 24, cfg.num_experts
    x = _rows(T, cfg.d_model, seed=1, zero=(5, 6, 7, 8, 20))
    _, ij = jmoe.router_topk(jcfg, jnp.asarray(fp["router"]), jnp.asarray(x))
    C = moe.capacity(cfg, T)
    sj, oj = jmoe.group_by_expert(ij, E, C)
    st, ot = moe.group_by_expert(torch.from_numpy(np.array(ij)), E, C)
    assert st.dtype == ot.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    dropped = int((ot.numpy() == E * C).sum())
    assert (dropped > 0) == (cf == 1.25), dropped


@pytest.mark.parametrize("case", ["rows", "batched", "chunked", "shared"])
def test_moe_ffn_matches_jax(case):
    """``moe_ffn`` on one row of tokens, ``moe_ffn_batched`` over two batch
    rows and over a row longer than its 4096-token chunk (grouped chunk by
    chunk), and a shared-expert override (``num_shared_experts=1``)."""
    over = {"num_shared_experts": 1} if case == "shared" else {}
    jcfg, jparams, cfg, _, _ = _models(**over)
    fp, tp = _ffn(jparams)
    jp = jax.tree.map(jnp.asarray, fp)
    D = cfg.d_model
    if case in ("rows", "shared"):
        x = _rows(40, D, zero=(7,))
        want = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x))
        got = moe.moe_ffn(cfg, tp, torch.from_numpy(x))
    else:
        S = 2 * moe.CHUNK if case == "chunked" else 48
        x = _rows(2 * S, D).reshape(2, S, D)
        want = jmoe.moe_ffn_batched(jcfg, jp, jnp.asarray(x))
        got = moe.moe_ffn_batched(cfg, tp, torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("I,TP,shared", [(4, 2, 0), (2, 4, 0), (4, 2, 1)],
                         ids=["4x2", "2x4", "4x2-shared"])
def test_moe_decode_ffn_matches_jax_moe_ffn(I, TP, shared):
    """The port's wide-EP dispatch/combine on the virtual (I, TP) mesh,
    row for row against the reference's model-level ``moe_ffn`` run on each
    instance's rows (same per-instance capacity), at the default capacity
    factor 1.25, with padded all-zero rows."""
    jcfg, jparams, cfg, _, _ = _models(num_shared_experts=shared)
    fp, tp = _ffn(jparams)
    jp = jax.tree.map(jnp.asarray, fp)
    T = 6
    x = _rows(I * T, cfg.d_model, seed=2, zero=(1, T + 2, I * T - 1))
    got = moe_decode_ffn(cfg, tp, torch.from_numpy(x), data_size=I, tp=TP)
    want = np.concatenate([np.asarray(jmoe.moe_ffn(jcfg, jp,
                                                   jnp.asarray(x[i * T:(i + 1) * T])))
                           for i in range(I)])
    _close(got.numpy(), want)


def test_layernorm_matches_jax():
    jcfg, _, cfg, _, _ = _models()
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, cfg.d_model)) * 4 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    want = jlayers.apply_norm(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = layers.apply_norm(cfg, jax.tree.map(torch.from_numpy, p),
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert set(layers.make_norm_params(cfg, 8, "cpu")) == {"scale", "bias"}


def test_forward_logits_and_kv_match_jax():
    jcfg, jparams, cfg, params, _ = _models(capacity_factor=8.0)
    toks = np.random.default_rng(4).integers(0, 256, (2, 37))
    lj, cj = jtransformer.forward(jcfg, jparams, jnp.asarray(toks),
                                  collect_kv=True)
    lt, ct = transformer.forward(cfg, params, toks, collect_kv=True,
                                 device="cpu")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(ct[0]["kv"], cj[0]["kv"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
