"""SSM (Mamba-2 / SSD) and hybrid (Jamba) serving in the port, held against
the JAX package on the CPU: ``models/ssm.py`` (the chunked scan, the block,
the decode step continuing a prefill; a port of tests/test_models.py's SSM
tests), the reduced models' forward, the in-place SSM scatter against the
numpy loaders (tests/test_hot_path.py), and the engine's transcripts
against greedy JAX (the reference's four SSM conformance cells,
tests/integration/engine_conformance.py, pipelined and not).

Weights come from the JAX init (cast to float32) through
``repro_torch.params``, with the SSD vectors the init makes 0, 1 or -2
perturbed first (A_log and dt_bias shifted by N(0, 0.5), D and the gated
norm's scale 1 + N(0, 0.3), the conv bias N(0, 0.5)) so that a dropped
term shows.  Inputs are drawn with numpy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core import dcp as jdcp, migrate as jmigrate
from repro.models import init_params as jinit, ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core import dcp, migrate
from repro_torch.core.bucketing import CPBuckets
from repro_torch.models import ssm, transformer
from repro_torch.serving.engine import NanoCPEngine

MAMBA2 = "mamba2-370m"
JAMBA = "jamba-v0.1-52b"
VOCAB = 256


@pytest.fixture(autouse=True, scope="module")
def _first_parallel_exp():
    """A CPU build of torch (2.13.0+cpu) can return wrong values from the
    first multithreaded ``torch.exp`` of a process (seen as a 1e-4 relative
    error in the SSD scan's decay matrix in about one process in five,
    never after one earlier call; no other op showed it).  One call before
    the module's tests keeps that fault of the library out of the
    comparisons."""
    torch.exp(torch.zeros(1 << 16))


def _perturb_ssm(np_tree, seed: int = 0):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        if name == "conv_b":
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        if name in ("norm", "D"):
            return (1.0 + rng.normal(0.0, 0.3, x.shape)).astype(np.float32)
        if name in ("A_log", "dt_bias"):
            return (x + rng.normal(0.0, 0.5, x.shape)).astype(np.float32)
        return np.asarray(x, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, np_tree)


@functools.cache
def _models(arch):
    """(jcfg, jparams, cfg, params): reduced, vocab 256, capacity factor 8
    (no token dropped), perturbed SSD vectors."""
    over = {"vocab_size": VOCAB}
    if JCONFIGS[arch].is_moe:
        over["capacity_factor"] = 8.0
    jcfg, cfg = jreduced(JCONFIGS[arch], **over), reduced(CONFIGS[arch], **over)
    np_params = _perturb_ssm(jax.tree.map(np.asarray,
                                          jinit(jax.random.PRNGKey(0), jcfg)))
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            P.from_jax(np_params, device="cpu"))


def _mixer(arch="mamba2-370m"):
    """One SSD layer's (numpy) mixer params of the reduced model."""
    jcfg, jparams, cfg, params = _models(arch)
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["layers"][0]["mixer"])
    p = {k: v[0] for k, v in params["blocks"]["layers"][0]["mixer"].items()}
    return jcfg, jp, cfg, p


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------------- #
# models/ssm.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
def test_ssd_chunked_matches_jax(with_init):
    """S = 50 is not a multiple of the chunk (32), so the dt = 0 padding
    runs; y and the final state agree within 1e-5, from a zero or a given
    initial state."""
    jcfg, _, cfg, _ = _models(MAMBA2)
    assert cfg.ssm_chunk == 32
    rng = np.random.default_rng(0)
    B, S = 2, 50
    nh, hd, ns = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, S, ns)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ns)).astype(np.float32)
    h0 = (rng.standard_normal((B, nh, hd, ns)).astype(np.float32)
          if with_init else None)
    y, h = ssm.ssd_chunked(cfg, *map(torch.from_numpy, (xh, dt, A, Bm, Cm)),
                           init_state=None if h0 is None
                           else torch.from_numpy(h0))
    jy, jh = jssm.ssd_chunked(jcfg, *map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                              init_state=None if h0 is None
                              else jnp.asarray(h0))
    assert y.shape == (B, S, nh, hd) and h.shape == (B, nh, hd, ns)
    _close(y, jy, 1e-5)
    _close(h, jh, 1e-5)


def test_ssm_block_and_decode_step_match_jax():
    """The block over S = 64 tokens and its states equal JAX's; the decode
    step from the block's states over token 64 equals the full block's row
    64 (and JAX's decode step)."""
    jcfg, jp, cfg, p = _mixer()
    rng = np.random.default_rng(1)
    B, S = 2, 64
    x = rng.standard_normal((B, S + 1, cfg.d_model)).astype(np.float32)
    y_full, _ = ssm.ssm_block(cfg, p, torch.from_numpy(x))
    y_pre, (conv, h) = ssm.ssm_block(cfg, p, torch.from_numpy(x[:, :S]))
    jy_pre, (jconv, jh) = jssm.ssm_block(jcfg, jp, jnp.asarray(x[:, :S]))
    _close(y_pre, jy_pre, 1e-5)
    _close(conv, jconv, 1e-6)
    _close(h, jh, 1e-5)
    y_step, conv2, h2 = ssm.ssm_decode_step(cfg, p, torch.from_numpy(x[:, S]),
                                            conv, h)
    jy_step, jconv2, jh2 = jssm.ssm_decode_step(jcfg, jp, jnp.asarray(x[:, S]),
                                                jconv, jh)
    _close(y_step, y_full[:, S], 1e-4)
    _close(y_step, jy_step, 1e-5)
    _close(conv2, jconv2, 1e-6)
    _close(h2, jh2, 1e-5)
    conv0, h0 = ssm.init_ssm_state(cfg, B, device="cpu")
    jconv0, jh0 = jssm.init_ssm_state(jcfg, B)
    assert conv0.shape == jconv0.shape and conv0.dtype == torch.bfloat16
    assert h0.shape == jh0.shape and not h0.any()


@pytest.mark.parametrize("arch", [MAMBA2, JAMBA], ids=["mamba2", "jamba"])
def test_init_params_tree_matches_jax(arch):
    """The port's own init builds the reference's tree: an SSD mixer per
    SSM layer, no ln2/ffn on Mamba-2's layers, the same leaf shapes, and
    the conv weights in bfloat16."""
    jcfg, jparams, cfg, _ = _models(arch)
    params = transformer.init_params(cfg, seed=0, device="cpu",
                                     dtype=torch.float32)
    paths = lambda tree: {jax.tree_util.keystr(p): tuple(x.shape) for p, x
                          in jax.tree_util.tree_leaves_with_path(tree)}
    assert paths(params) == paths(jparams)
    for lp, kind in zip(params["blocks"]["layers"], cfg.block_pattern()):
        assert ("ffn" in lp) == (kind["ffn"] != "none")
        if kind["mixer"] == "ssm":
            assert lp["mixer"]["conv_w"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", [MAMBA2, JAMBA], ids=["mamba2", "jamba"])
def test_forward_matches_jax(arch):
    """Reduced Mamba-2 (2 SSD layers, no FFN) and Jamba (two blocks of 7
    SSD + 1 attention layers, MoE on odd layers): logits within 1e-4 of
    JAX's, and every layer's prefill caches (KV or SSM states) too."""
    jcfg, jparams, cfg, params = _models(arch)
    toks = np.random.default_rng(2).integers(0, VOCAB, (1, 50))
    logits, caches = transformer.forward(cfg, params, torch.as_tensor(toks),
                                         collect_kv=True, device="cpu")
    jlogits, jcaches = jtransformer.forward(jcfg, jparams, jnp.asarray(toks),
                                            collect_kv=True)
    assert np.abs(logits.numpy() - np.asarray(jlogits)).max() \
        <= 1e-4 * np.abs(np.asarray(jlogits)).max()
    assert [sorted(c) for c in caches] == [sorted(c) for c in jcaches]
    for c, jc in zip(caches, jcaches):
        for name in c:
            for a, b in zip(c[name], jc[name]):
                _close(a, b, 1e-4)


def test_scatter_ssm_equals_numpy_loaders():
    """``PrefillScatter.scatter_ssm`` writes a batch of requests' SSM states
    in place, bit-equal to the port's and the reference's numpy loader
    (reduced Jamba: two blocks of seven SSD layers, at (2, 2))."""
    jcfg, _, cfg, _ = _models(JAMBA)
    I, nb = 2, cfg.num_blocks
    n_ssm = sum(1 for k in cfg.block_pattern() if k["mixer"] == "ssm")
    din, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads
    cw, hd = cfg.ssm_conv_width, cfg.ssm_head_dim
    dims = dcp.DecodeDims(M=4, S=0, N=4, MB=4, W=I, num_frames=17, page=16,
                          data_size=I, tp=2)
    jdims = jdcp.DecodeDims(M=4, S=0, N=4, MB=4, W=I, num_frames=17, page=16,
                            data_size=I, tp=2)
    state = dcp.init_serve_state(cfg, dims, I, dtype=torch.float32,
                                 device="cpu")
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    state_np = {k: v.numpy().copy() for k, v in state.items()}
    jstate = jax.tree.map(np.array, jdcp.init_serve_state(
        jcfg, jdims, I, dtype=jnp.float32))
    assert {k: v.shape for k, v in state_np.items()} == \
        {k: v.shape for k, v in jstate.items()}
    rng = np.random.default_rng(3)
    reqs = [(1, 2), (0, 3), (1, 0)]                 # (instance, slot)
    convs, hs = [], []
    for inst, slot in reqs:
        layers = [(rng.standard_normal((cw - 1, din + 2 * ns)),
                   rng.standard_normal((nh, hd, ns))) for _ in range(nb * n_ssm)]
        migrate.load_prefill_ssm(cfg, state_np, inst, slot, layers)
        jmigrate.load_prefill_ssm(jcfg, jstate, inst, slot, layers)
        convs.append(np.stack([c for c, _ in layers]).reshape(
            nb, n_ssm, 1, cw - 1, din + 2 * ns))
        hs.append(np.stack([h for _, h in layers]).reshape(
            nb, n_ssm, 1, nh, hd, ns))
    out = migrate.PrefillScatter(cfg, dims, I).scatter_ssm(
        state, torch.from_numpy(np.concatenate(convs, 2)).float(),
        torch.from_numpy(np.concatenate(hs, 2)).float(),
        np.array(reqs).T)
    assert out is state and {k: v.data_ptr() for k, v in state.items()} == ptrs
    for k in dcp.SSM_STATE:
        np.testing.assert_array_equal(state[k].numpy(), state_np[k])
        np.testing.assert_array_equal(state_np[k], jstate[k])


# --------------------------------------------------------------------------- #
# the engine: the reference's SSM conformance cells
# --------------------------------------------------------------------------- #
CONFORMANCE_LENS = (24, 90, 180)
STEPS = 4


@functools.cache
def _jax_forward(arch):
    """JAX's forward of the reduced model, jitted once (compiled per
    sequence length)."""
    jcfg = _models(arch)[0]
    return jax.jit(lambda p, t: jtransformer.forward(jcfg, p, t)[0])


def _jax_argmax(arch, prompt, transcript):
    """JAX greedy choice at every generated position, teacher-forced."""
    seq = np.concatenate([np.asarray(prompt),
                          np.asarray(transcript[:-1], np.int64)])
    logits = _jax_forward(arch)(_models(arch)[1], jnp.asarray(seq)[None])
    return np.asarray(logits[0, len(prompt) - 1:]).argmax(-1).tolist()


@pytest.mark.parametrize("arch,I,TP", [(JAMBA, 4, 2), (JAMBA, 2, 4),
                                       (MAMBA2, 4, 2), (MAMBA2, 2, 2)],
                         ids=["jamba-4x2", "jamba-2x4", "mamba2-4x2",
                              "mamba2-2x2"])
@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_engine_ssm_conformance(arch, I, TP, pipeline):
    """Three prompts (24/90/180 tokens, 4 new each) through the engine with
    pinned slots (one M bucket of 4, no rebalance): every transcript equals
    greedy JAX; the SSM state and pools stay in place; Mamba-2 appends no
    KV and has no pools."""
    _, _, cfg, params = _models(arch)
    eng = NanoCPEngine(cfg, params, num_instances=I, instances_per_node=I,
                       kv_capacity_tokens=4096, page_size=16, tp=TP,
                       buckets=CPBuckets(edges=(64, 160), degrees=(1, 2, 3)),
                       max_slots_per_instance=4, pipeline=pipeline,
                       audit_donation_every_step=True, device="cpu")
    assert not eng.scheduler.allow_rebalance
    assert eng.shape_buckets.m_buckets == (4,)
    assert ("k_pool" in eng.state) == (arch == JAMBA)
    assert eng.state["ssm_state"].shape[3] == 4
    ptrs = {k: v.data_ptr() for k, v in eng.state.items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (L,)) for L in CONFORMANCE_LENS]
    for p in prompts:
        eng.add_request(p, max_new_tokens=STEPS)
    eng.step()
    assert not eng.cluster.waiting, "all requests must admit at step 1"
    for _ in range(16):
        if not eng.pending:
            break
        eng.step()
    assert not eng.pending
    for rid, res in eng.results.items():
        assert len(res.tokens) == STEPS, (rid, res.tokens)
        assert res.tokens == _jax_argmax(arch, prompts[rid], res.tokens), rid
    assert {k: v.data_ptr() for k, v in eng.state.items()} == ptrs
    st = eng.aot.stats
    assert st.donation_copies == 0 and st.donation_reuses > 0
    assert all(key[0] == 4 for key in eng.aot.cached_keys())
    if arch == MAMBA2:
        assert eng.cluster.page_table.instance_used_tokens(0) == 0
        assert eng.hot_path_stats["escalations"] == 0


def test_pinned_archs_refuse_what_the_reference_refuses():
    """The reference's refusals on these archs: quantized pools, the
    prefix cache and prefill cells need KV (attention-free Mamba-2);
    ``fork_request`` and prefill cells need slots that can move (Jamba)."""
    kw = dict(num_instances=2, instances_per_node=2, kv_capacity_tokens=512,
              tp=2, max_slots_per_instance=4, device="cpu")
    _, _, mcfg, mparams = _models(MAMBA2)
    for bad in ({"kv_dtype": "fp8"}, {"prefix_cache": True},
                {"prefill_cells": 1}):
        with pytest.raises(ValueError):
            NanoCPEngine(mcfg, mparams, **kw, **bad)
    _, _, jcfg, jparams = _models(JAMBA)
    with pytest.raises(ValueError, match="prefill cells"):
        NanoCPEngine(jcfg, jparams, **kw, prefill_cells=1)
    eng = NanoCPEngine(jcfg, jparams, **kw)
    eng.add_request(np.arange(20), max_new_tokens=4)
    eng.step()
    with pytest.raises(ValueError, match="fork_request"):
        eng.fork_request(0, max_new_tokens=4)
