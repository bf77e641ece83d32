"""The port's training substrate held against the JAX package on the same
numpy inputs: the flash op's gradient (its CPU backward is the port of
``flash_backward``), AdamW and its schedule, the synthetic data, the
checkpoint format both ways, gradient accumulation and the data-parallel
steps, the 10-step loss trajectory, and the load-balance loss.

Tolerances: flash grads atol 2e-5 in float32 (the reference's
``test_flash_gradients_vs_oracle``) and 2e-2 in bfloat16; optimizer
updates 1e-6 relative; a 10-step loss trajectory 1e-4 (ten f32 steps of
one model in two frameworks); data and checkpoints bit for bit.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_backward as jflash_backward
from repro.models import init_params as jinit, moe as jmoe
from repro.training import checkpoint as jcheckpoint, data as jdata
from repro.training import optimizer as joptimizer, train_step as jtrain_step
from repro_torch import params as P
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import moe
from repro_torch.training import checkpoint, data, optimizer, train_step
from repro_torch.training.tree import leaves, map_tree

ARCH = "tinyllama-1.1b"
CFG = reduced(CONFIGS[ARCH], num_layers=2)
JCFG = jreduced(JCONFIGS[ARCH], num_layers=2)
OPT = optimizer.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100)
JOPT = joptimizer.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small ops, and beside the
    other test workers on the same cores a multithreaded torch spends its
    time waiting at its own barriers (25x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_params(seed: int = 0):
    """The JAX init in float32: (numpy tree, port tree on the CPU)."""
    np_tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                           jinit(jax.random.PRNGKey(seed), JCFG))
    return np_tree, P.from_jax(np_tree, device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --------------------------------------------------------------------------- #
# flash backward
# --------------------------------------------------------------------------- #
FLASH_CASES = {
    # name: (B, Sq, Skv, Hq, Hkv, Dk, Dv, causal, kv_len, dtype)
    "gqa_causal_128": (1, 128, 128, 4, 2, 64, 64, True, None, torch.float32),
    "ragged_skv_200": (2, 200, 200, 4, 2, 32, 32, True, None, torch.float32),
    "dk24_dv16": (2, 200, 200, 4, 1, 24, 16, True, None, torch.float32),
    "cross_8x200": (2, 8, 200, 4, 2, 16, 16, False, None, torch.float32),
    "kv_len_zero_row": (2, 40, 200, 4, 2, 16, 16, False, [130, 0],
                        torch.float32),
    "bf16": (2, 200, 200, 4, 2, 32, 32, True, None, torch.bfloat16),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_vs_autograd_and_jax(case):
    """The op's CPU backward against autograd through the plain forward and
    against the reference's jnp ``flash_backward`` (scanned over 32- or
    40-key blocks there, 128-key blocks with a partial last one here), on the
    same inputs and cotangent.  A row that sees no key gives zero grads
    (the kernel's out is 0 there); the plain version averages v on such a
    row, so its autograd comparison takes a zero cotangent on it."""
    B, Sq, Skv, Hq, Hkv, Dk, Dv, causal, kvl, dtype = FLASH_CASES[case]
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, Sq, Hq, Dk), (B, Skv, Hkv, Dk), (B, Skv, Hkv, Dv)))
    do = rng.standard_normal((B, Sq, Hq, Dv)).astype(np.float32)
    kl = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    kw = dict(causal=causal, kv_len=kl)

    def leaves_(arrs):
        return [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrs]

    t = leaves_((q, k, v))
    out, lse = fa.flash_attention(*t, **kw)
    g_op = torch.autograd.grad(out, t, torch.from_numpy(do).to(dtype))
    assert [g.dtype for g in g_op] == [dtype] * 3
    t2 = leaves_((q, k, v))
    seen = (np.ones(B) if kvl is None else (np.array(kvl) > 0)).astype(np.float32)
    do_seen = torch.from_numpy(do * seen[:, None, None, None]).to(dtype)
    g_plain = torch.autograd.grad(ref.flash_attention(*t2, **kw)[0], t2,
                                  do_seen)
    for a, b in zip(g_op, g_plain):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0)
    if kvl is not None:
        for g in g_op:
            assert not g[np.array(kvl) == 0].any()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = [jnp.asarray(x, jdt) for x in (q, k, v)]
    jo = jnp.asarray(out.detach().float().numpy(), jdt)
    jg = jflash_backward(*j, jo, jnp.asarray(lse.detach().numpy()), jnp.asarray(do, jdt),
                         scale=Dk ** -0.5, causal=causal,
                         kv_len=None if kvl is None else jnp.asarray(kvl, jnp.int32),
                         bk=next(b for b in (40, 32) if Skv % b == 0))
    for a, b in zip(g_op, jg):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=tol, rtol=0)


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #
def test_lr_schedule_and_norms_match_jax():
    cfg = optimizer.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = joptimizer.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    for s in range(121):
        assert abs(float(optimizer.lr_at(cfg, s))
                   - float(joptimizer.lr_at(jcfg, s))) <= 1e-6 * 3e-4, s
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": [rng.standard_normal((3,)).astype(np.float32) * 4,
                  rng.standard_normal((2, 2, 2)).astype(np.float32)]}
    t = map_tree(torch.from_numpy, tree)
    j = jax.tree.map(jnp.asarray, tree)
    assert _rel(optimizer.global_norm(t), joptimizer.global_norm(j)) <= 1e-6
    for max_norm in (0.5, 100.0):
        c, n = optimizer.clip_by_global_norm(t, max_norm)
        jc, jn = joptimizer.clip_by_global_norm(j, max_norm)
        assert _rel(n, jn) <= 1e-6
        for a, b in zip(leaves(c), jax.tree.leaves(jc)):
            assert _rel(a, b) <= 1e-6


def test_adamw_update_matches_jax():
    """Two AdamW steps on the reduced TinyLlama tree with seeded grads:
    params, moments and step equal JAX's within 1e-6 relative, including
    the decay of the stacked [nb, D] norm scales (the reference's
    ``ndim >= 2`` rule)."""
    np_tree, params = _f32_params()
    jparams = jax.tree.map(jnp.asarray, np_tree)
    opt, jopt = optimizer.init_opt_state(params), joptimizer.init_opt_state(jparams)
    jupdate = jax.jit(joptimizer.adamw_update, static_argnums=0)
    rng = np.random.default_rng(4)
    for _ in range(2):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32) * 0.1, np_tree)
        params, opt, st = optimizer.adamw_update(
            OPT, params, P.from_jax(g, device="cpu"), opt)
        jparams, jopt, jst = jupdate(
            JOPT, jparams, jax.tree.map(jnp.asarray, g), jopt)
        assert _rel(st["grad_norm"], jst["grad_norm"]) <= 1e-6
        assert _rel(st["lr"], jst["lr"]) <= 1e-6
    for tree, jtree in ((params, jparams), (opt["mu"], jopt["mu"]),
                        (opt["nu"], jopt["nu"])):
        for a, b in zip(leaves(tree), jax.tree.leaves(jtree)):
            assert a.dtype == torch.float32
            assert _rel(a, b) <= 1e-6
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 2
    ln1 = params["blocks"]["layers"][0]["ln1"]["scale"]
    assert ln1.dim() == 2 and not torch.equal(
        ln1, torch.tensor(np_tree["blocks"]["layers"][0]["ln1"]["scale"]))


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", [ARCH, "whisper-base"])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_tokens_bit_equal_to_reference(arch, seed):
    ds = data.SyntheticTokens(get_config(arch), batch=3, seq_len=40, seed=seed)
    jds = jdata.SyntheticTokens(JCONFIGS[arch], batch=3, seq_len=40, seed=seed)
    for step in (0, 5):
        a, b = ds.batch_at(step), jds.batch_at(step)
        assert sorted(a) == sorted(b)
        assert ("frames" in a) == (arch == "whisper-base")
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_data_pipeline_deterministic():
    ds = data.SyntheticTokens(CFG, batch=4, seq_len=32, seed=7)
    a = ds.batch_at(5)
    b = data.SyntheticTokens(CFG, batch=4, seq_len=32, seed=7).batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(ds.batch_at(5)["tokens"], ds.batch_at(6)["tokens"])


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def test_checkpoint_atomic_and_latest():
    params = {"w": torch.arange(8, dtype=torch.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, params)
        checkpoint.save(d, 2, map_tree(lambda x: x + 1, params))
        assert checkpoint.latest_step(d) == 2
        assert sorted(os.listdir(d)) == ["LATEST", "step_00000001",
                                         "step_00000002"]
        rest = checkpoint.restore(d, params, device="cpu")
        assert rest["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(rest["w"].float().numpy(),
                                      np.arange(8) + 1)


def test_async_checkpointer():
    with tempfile.TemporaryDirectory() as d:
        ck = checkpoint.AsyncCheckpointer(d)
        x = torch.zeros(4)
        for s in (1, 2, 3):
            x.fill_(s)
            ck.submit(s, {"x": x})
        x.fill_(-1)                 # the host copy is the writer's own
        ck.close()
        assert not ck._t.is_alive()
        assert checkpoint.latest_step(d) == 3
        np.testing.assert_array_equal(
            checkpoint.restore(d, {"x": x}, device="cpu")["x"].numpy(),
            np.full(4, 3.0))


def _ckpt_trees():
    """The same bf16 params + AdamW state as a JAX tree and a port tree."""
    jparams = jinit(jax.random.PRNGKey(1), JCFG)            # bf16 matrices
    jopt = joptimizer.init_opt_state(jparams)
    jopt["step"] = jnp.asarray(7, jnp.int32)
    jopt["mu"] = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, jnp.float32),
                              jparams)
    jtree = {"params": jparams, "opt": jopt}
    tree = P.from_jax(jax.tree.map(np.asarray, jtree), device="cpu")
    return jtree, tree


def _assert_bit_equal(tree, jtree):
    flat, jflat = leaves(tree), jax.tree.leaves(jtree)
    assert len(flat) == len(jflat)
    dtypes = set()
    for a, b in zip(flat, jflat):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        dtypes.add(str(b.dtype))
        b = np.asarray(b)
        if str(b.dtype) == "bfloat16":
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)
    assert {"bfloat16", "float32", "int32"} <= dtypes


def test_reference_checkpoint_restores_into_port():
    jtree, tree = _ckpt_trees()
    with tempfile.TemporaryDirectory() as d:
        jcheckpoint.save(d, 7, jtree)
        like = map_tree(torch.zeros_like, tree)
        _assert_bit_equal(checkpoint.restore(d, like, device="cpu"), jtree)


def test_port_checkpoint_restores_into_reference():
    jtree, tree = _ckpt_trees()
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 7, tree)
        with open(os.path.join(d, "step_00000007", "manifest.json")) as f:
            assert f"{jax.tree.structure(jtree)}" in f.read()
        _assert_bit_equal(tree, jcheckpoint.restore(d, jtree))


def _run(step_fn, params, opt, ds, start, steps):
    losses = []
    for i in range(start, start + steps):
        params, opt, stats = step_fn(params, opt, ds.batch_at(i))
        losses.append(float(stats["loss"]))
    return params, opt, losses


def test_checkpoint_resume_bitwise():
    """Crash/restart: resuming from a checkpoint reproduces the exact run."""
    _, params = _f32_params()
    step_fn = train_step.make_train_step(CFG, OPT, num_micro=2, device="cpu")
    ds = data.SyntheticTokens(CFG, batch=4, seq_len=32)
    p1, o1, _ = _run(step_fn, params, optimizer.init_opt_state(params), ds, 0, 3)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 3, {"params": p1, "opt": o1})
        p_ref, _, l_ref = _run(step_fn, p1, o1, ds, 3, 2)
        like = map_tree(torch.empty_like, {"params": p1, "opt": o1})
        rest = checkpoint.restore(d, like, device="cpu")
        p_new, _, l_new = _run(step_fn, rest["params"], rest["opt"], ds, 3, 2)
    assert l_ref == l_new
    for a, b in zip(leaves(p_ref), leaves(p_new)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# accumulation, compression, the data-parallel steps
# --------------------------------------------------------------------------- #
def _batch(n_rows=8, seq=32):
    return data.SyntheticTokens(CFG, batch=n_rows, seq_len=seq).batch_at(0)


def test_microbatches_equal_one_batch():
    _, params = _f32_params()
    loss_fn = train_step.make_loss_fn(CFG, remat="none", device="cpu")
    batch = _batch(4)
    l1, g1 = train_step.accumulate_grads(loss_fn, params, batch)
    l2, g2 = train_step.accumulate_grads(loss_fn, params, batch, num_micro=2)
    assert _rel(l2, l1) <= 1e-6
    for a, b in zip(leaves(g2), leaves(g1)):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_grad_compression_close_to_exact():
    _, params = _f32_params()
    loss_fn = train_step.make_loss_fn(CFG, remat="none", device="cpu")
    batch = _batch(4)
    _, g_exact = train_step.accumulate_grads(loss_fn, params, batch)
    _, g_comp = train_step.accumulate_grads(loss_fn, params, batch,
                                            compress="bf16")
    for a, b in zip(leaves(g_exact), leaves(g_comp)):
        assert b.dtype == torch.bfloat16
        assert _rel(b.float(), a) < 2e-2


@pytest.mark.parametrize("compress,tol", [(None, 1e-6), ("bf16", 2e-2)])
def test_data_parallel_steps_match_exact(compress, tol):
    """The hybrid (deferred single reduction) and compressed steps at 4
    virtual data shards against ``make_train_step`` (tests/integration/
    hybrid_train.py): the loss, and every parameter after one AdamW step,
    within 1e-6 uncompressed and 2e-2 with the bf16 payload."""
    _, params = _f32_params()
    opt_cfg = optimizer.AdamWConfig(lr=1e-3)
    batch = _batch(8)
    exact = train_step.make_train_step(CFG, opt_cfg, num_micro=2,
                                       device="cpu")
    p_exact, _, s_exact = exact(params, optimizer.init_opt_state(params), batch)
    for make in (train_step.make_hybrid_train_step,
                 train_step.make_compressed_train_step):
        step = make(CFG, opt_cfg, 4, num_micro=2, compress=compress,
                    device="cpu")
        p, _, s = step(params, optimizer.init_opt_state(params), batch)
        assert _rel(s["loss"], s_exact["loss"]) <= 1e-6, make.__name__
        for a, b in zip(leaves(p), leaves(p_exact)):
            assert _rel(a, b) < tol, make.__name__


# --------------------------------------------------------------------------- #
# the loss trajectory against JAX
# --------------------------------------------------------------------------- #
def test_loss_descends_like_jax():
    """The reference's ``test_loss_descends`` (reduced TinyLlama, 2 layers,
    f32, num_micro 2, 10 steps) through both packages from the same
    weights: every step's loss within 1e-4 of JAX's, and it descends."""
    np_tree, params = _f32_params()
    ds = data.SyntheticTokens(CFG, batch=8, seq_len=64)
    step_fn = train_step.make_train_step(CFG, OPT, num_micro=2, device="cpu")
    _, _, losses = _run(step_fn, params, optimizer.init_opt_state(params),
                        ds, 0, 10)
    jfn = jax.jit(jtrain_step.make_train_step(JCFG, JOPT, num_micro=2))
    jparams = jax.tree.map(jnp.asarray, np_tree)
    jopt = joptimizer.init_opt_state(jparams)
    jlosses = []
    for i in range(10):
        b = {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
        jparams, jopt, stats = jfn(jparams, jopt, b)
        jlosses.append(float(stats["loss"]))
    assert np.abs(np.array(losses) - np.array(jlosses)).max() <= 1e-4, (
        losses, jlosses)
    assert losses[-1] < losses[0] - 0.2


# --------------------------------------------------------------------------- #
# MoE load-balance loss
# --------------------------------------------------------------------------- #
def test_aux_load_balance_loss_matches_jax():
    arch = "phi3.5-moe-42b-a6.6b"
    cfg, jcfg = reduced(CONFIGS[arch]), jreduced(JCONFIGS[arch])
    rng = np.random.default_rng(6)
    w = rng.standard_normal((cfg.d_model, cfg.num_experts)).astype(np.float32)
    x = rng.standard_normal((50, cfg.d_model)).astype(np.float32)
    got = moe.aux_load_balance_loss(cfg, torch.from_numpy(w),
                                    torch.from_numpy(x))
    want = jmoe.aux_load_balance_loss(jcfg, jnp.asarray(w), jnp.asarray(x))
    assert _rel(got, want) <= 1e-6
