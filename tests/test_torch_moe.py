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
from types import SimpleNamespace

from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core import dcp
from repro_torch.core.moe_parallel import moe_decode_ffn
from repro_torch.kernels import moe_experts, ops
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


# the routed-rows path (``kernels/moe_experts.py``) against the bmm path:
# configurations shaped like the benchmark's, cut to d_model 64, at the
# capacity factor E/k that drops no token (C = T, each bin up to T rows)
MOE_SHAPES = {"phi": ("phi3.5-moe-42b-a6.6b", 16, 2),
              "dsv3": ("deepseek-v3", 32, 8)}
ROUTED_CASES = [(I, case) for I in (1, 4)
                for case in ("empty_experts", "one_expert", "idle_slots")]
ROUTED_CASES.append((4, "pods2"))


def _moe_shaped(shape, shared, dtype=torch.float32):
    name, E, k = MOE_SHAPES[shape]
    cfg = reduced(CONFIGS[name], num_experts=E, num_experts_per_tok=k,
                  moe_d_ff=48, capacity_factor=E / k,
                  num_shared_experts=shared)
    p = moe.make_moe_params(torch.Generator().manual_seed(7), cfg,
                            dtype=dtype, device="cpu")
    return cfg, p


def _routed_rows(case, cfg, p, I):
    """(x [I*T, D], params) for ``case``: few rows, so most experts get
    none; every row on expert 3 first (its fill is T = C in each
    instance); a bucket of 8 slots with 3 live rows, the idle ones all
    one row, as an idle slot's token is; or 4 rows an instance."""
    T = {"empty_experts": 2, "one_expert": 6, "idle_slots": 8, "pods2": 4}[case]
    D = cfg.d_model
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((I, T, D)).astype(np.float32))
    if case == "one_expert":
        router = p["router"].clone()
        router[0, 3] = 100.0
        x[..., 0] = 10.0
        p = {**p, "router": router}
    elif case == "idle_slots":
        x[:, 3:] = x[0, 0]
    return x.reshape(I * T, D).to(p["wi_gate"].dtype), p


def _routed_run(cfg, p, x, I, case, fill):
    if case == "pods2":
        return dcp._pod_moe_ffn(cfg, SimpleNamespace(data_size=I, pods=2,
                                                      tp=2), p, x, fill)
    return moe_decode_ffn(cfg, p, x, data_size=I, tp=2, fill=fill)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("I,case", ROUTED_CASES,
                         ids=[f"I{i}-{c}" for i, c in ROUTED_CASES])
@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("shape", list(MOE_SHAPES))
def test_routed_rows_path_equals_the_bmm_path(monkeypatch, shape, shared, I,
                                              case, dtype):
    """``moe_decode_ffn`` through the routed-rows wrapper (its plain version
    on the CPU: the kernel's plan, compact rows and in-order combine) equals
    the bmm path on the same routing tables, and both write the same
    fills: every routed row, as none is dropped."""
    cfg, p = _moe_shaped(shape, shared, dtype)
    x, p = _routed_rows(case, cfg, p, I)
    E, T = cfg.num_experts, x.shape[0] // I
    fills = [torch.full((I, E), -1, dtype=torch.int32) for _ in range(2)]
    want = _routed_run(cfg, p, x, I, case, fills[0])
    monkeypatch.setattr(ops, "_plain", lambda t: False)
    got = _routed_run(cfg, p, x, I, case, fills[1])
    assert got.dtype == want.dtype == dtype
    _close(got.float().numpy(), want.float().numpy(),
           RTOL if dtype == torch.float32 else 2e-2)
    _, idx = moe.router_topk(cfg, p["router"], x.reshape(I, T, -1))
    routed = moe.bin_rows(idx, E).to(torch.int32)
    assert torch.equal(fills[0], routed) and torch.equal(fills[1], routed)
    if case == "empty_experts":
        assert (routed.sum(0) == 0).any()
    elif case == "one_expert":
        assert (routed[:, 3] == moe.capacity(cfg, T)).all()
    elif case == "idle_slots":      # the idle rows pile onto k experts
        assert routed.sum(0).max() >= I * (T - 3)


def test_routed_rows_plan_lists_each_bins_rows():
    """``plan``: expert e's compact rows are [boff[e*I], boff[(e+1)*I]),
    bin (i, e)'s slot j is row boff[e*I + i] + j, and it lists the x row
    src_token names there (at a capacity that drops assignments too)."""
    I, T, E, k, C = 3, 5, 4, 2, 2
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(np.stack([np.stack([rng.permutation(E)[:k]
                                               for _ in range(T)])
                                     for _ in range(I)])).to(torch.int32)
    src, slot_of = moe.group_by_expert(idx, E, C)
    fill, boff, x_row = moe_experts.plan(src, T, E, I * T * k)
    assert fill.tolist() == moe.bin_rows(idx, E).clamp(max=C).tolist()
    assert boff[-1] == fill.sum() and (x_row[int(boff[-1]):] == -1).all()
    for i in range(I):
        for e in range(E):
            for j in range(int(fill[i, e])):
                assert x_row[boff[e * I + i] + j] == i * T + src[i, e * C + j]
    for e in range(E):
        assert boff[(e + 1) * I] - boff[e * I] == fill[:, e].sum()


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
