"""Training through the port's models, held against the JAX package on
reduced configs: the loss and every gradient leaf against
``jax.value_and_grad(repro.models.loss_fn)`` on the same converted float32
weights and batch; the three remat policies; and a bf16 smoke train step
on all eleven reduced configs.

Weights are the JAX init, converted, with every bias drawn from N(0, 0.5),
every norm scale from 1 + N(0, 0.3) and the SSD vectors shifted (the
init's zeros and ones would hide a dropped branch).  MoE configs run at
capacity factor 8 (no token dropped).  Tolerances: the loss within 1e-5
absolute; each gradient leaf max|d| <= 1e-4 * max|g_jax| (the same f32
model in two frameworks, whose matmuls sum in different orders), with
max|g_jax| floored at 1e-4 of the model's largest gradient entry for the
leaves whose gradient is zero in exact arithmetic.

Five archetypes' parity runs here (dense GQA, MLA, MoE, SSM,
encoder-decoder); the other six configs' runs the same check in
tests/test_torch_train_archetypes.py, so that each file stays under a
minute and the workers spread them (each JAX value-and-grad costs
seconds of compile on the CPU).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import models as jmodels
from repro.configs import ASSIGNED, CONFIGS as JCONFIGS, reduced as jreduced
from repro_torch import models
from repro_torch.models import encdec, transformer
from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.training import optimizer, train_step
from repro_torch.training.tree import leaves, unflatten

VOCAB = 256
B, S, S_DEC = 2, 64, 32
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
# a leaf whose gradient is zero in exact arithmetic holds rounding noise in
# both packages (an attention k bias shifts all of a row's scores alike,
# which softmax ignores; a top-1 router's renormalised weight is 1): its
# scale is floored at 1e-4 of the model's largest gradient entry
GRAD_FLOOR = 1e-4
ARCHETYPES = ["tinyllama-1.1b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
              "mamba2-370m", "whisper-base"]
ALL = list(ASSIGNED) + ["deepseek-v3"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small ops, and beside the
    other test workers on the same cores a multithreaded torch spends its
    time waiting at its own barriers (25x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _first_parallel_exp():
    """The CPU torch build here can return wrong values from the first
    multithreaded ``torch.exp`` of a process (the SSD decay matrix; see
    tests/test_torch_ssm.py): one call before the SSD-touching tests."""
    torch.exp(torch.zeros(1 << 16))


def perturb(np_tree, seed: int = 0):
    """Biases N(0, 0.5), norm scales 1 + N(0, 0.3), A_log / dt_bias shifted
    by N(0, 0.5); every leaf float32."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        if name in ("bq", "bk", "bv", "bi", "bo", "bias", "conv_b"):
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        if name in ("scale", "q_norm", "k_norm", "kv_norm", "norm", "D"):
            return (1.0 + rng.normal(0.0, 0.3, x.shape)).astype(np.float32)
        if name in ("A_log", "dt_bias"):
            return (x + rng.normal(0.0, 0.5, x.shape)).astype(np.float32)
        return np.asarray(x, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, np_tree)


@functools.cache
def _models(arch):
    over = {"vocab_size": VOCAB}
    if JCONFIGS[arch].is_moe:
        over["capacity_factor"] = 8.0
    jcfg, cfg = jreduced(JCONFIGS[arch], **over), reduced(CONFIGS[arch], **over)
    np_tree = perturb(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                   jmodels.init_params(jax.random.PRNGKey(0),
                                                       jcfg)))
    return jcfg, np_tree, cfg


def _batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    s = S_DEC if cfg.is_encoder_decoder else S
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return batch


def _port_grads(cfg, np_tree, batch, remat="none"):
    params = P.from_jax(np_tree, device="cpu")
    loss_fn = train_step.make_loss_fn(cfg, remat=remat, device="cpu")
    return train_step.value_and_grad(loss_fn, params, batch)


@pytest.mark.parametrize("arch", ARCHETYPES)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


def check_loss_and_grads(arch):
    """Loss within 1e-5 and each gradient leaf within 1e-4 of its largest
    entry, against ``jax.value_and_grad(repro.models.loss_fn)``."""
    _first_parallel_exp()
    jcfg, np_tree, cfg = _models(arch)
    batch = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.loss_fn(jcfg, p, b)))(
        jax.tree.map(jnp.asarray, np_tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_grads(cfg, np_tree, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL, (float(loss),
                                                         float(jloss))
    jflat = jax.tree.leaves(jgrads)
    flat = leaves(grads)
    assert len(flat) == len(jflat)
    floor = GRAD_FLOOR * max(float(np.abs(np.asarray(g)).max())
                             for g in jflat)
    for (path, jg), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                             flat):
        jg = np.asarray(jg, np.float32)
        assert g.shape == jg.shape, path
        scale = max(float(np.abs(jg).max()), floor)
        err = float(np.abs(g.numpy() - jg).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err, scale)


class CountMM(TorchDispatchMode):
    """Counts ``aten.mm`` / ``aten.addmm`` calls that reach the kernel
    (``n``), and host reads of a device value (``syncs``: MoE's fullest
    bin)."""

    def __init__(self):
        super().__init__()
        self.n = self.syncs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        if func == torch.ops.aten._local_scalar_dense.default:
            self.syncs += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b"])
def test_remat_changes_no_value(arch):
    """Loss and grads equal under "none", "dots" and "full" (Jamba: a block
    of 8 layers, nested per-layer checkpoints under "full").  Counting the
    2-D products that run during the backward: "dots" recomputes none of
    the forward's (it saved them); "full" recomputes them, all but a
    checkpointed region's last ones, whose outputs no backward reads (the
    recompute stops once it has what the backward saved), and a nested
    layer's twice.  Jamba's MoE layers read their fullest bin on the host
    once per forward; each recompute reads it again (the same value:
    routing is deterministic), so "dots" adds one read per MoE layer and
    nested "full" up to two (its block recompute also stops early)."""
    _first_parallel_exp()
    _, np_tree, cfg = _models(arch)
    batch = _batch(cfg)
    params = P.from_jax(np_tree, device="cpu")
    out, bwd_mm, bwd_syncs = {}, {}, {}
    with CountMM() as fwd:
        models.loss_fn(cfg, params, batch, device="cpu")
    for remat in ("none", "dots", "full"):
        loss_fn = train_step.make_loss_fn(cfg, remat=remat, device="cpu")
        req = [p.detach().requires_grad_() for p in leaves(params)]
        loss = loss_fn(unflatten(params, req), batch)
        with CountMM() as mm:
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        out[remat] = (loss.detach(), grads)
        bwd_mm[remat], bwd_syncs[remat] = mm.n, mm.syncs
    ref_loss, ref_grads = out["none"]
    for remat in ("dots", "full"):
        loss, grads = out[remat]
        assert torch.equal(loss, ref_loss), remat
        for a, b in zip(grads, ref_grads):
            assert (a is None) == (b is None)
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert fwd.n > 0
    assert bwd_mm["dots"] == bwd_mm["none"]
    # nested: the block's recompute runs each layer, whose own checkpoint
    # recomputes it again in the backward
    passes = 2 if len(cfg.block_pattern()) > 1 else 1
    assert fwd.n // 2 < bwd_mm["full"] - bwd_mm["none"] < passes * fwd.n
    moe_reads = sum(k["ffn"] == "moe" for k in cfg.layer_kinds())
    assert fwd.syncs == moe_reads
    assert (bwd_syncs["none"], bwd_syncs["dots"]) == (0, moe_reads)
    assert moe_reads <= bwd_syncs["full"] <= passes * moe_reads


@pytest.mark.parametrize("arch", ALL)
def test_smoke_forward_and_train_bf16(arch):
    """The reference's smoke test on the port alone: bf16 weights from the
    port's init, logits of the right shape, one AdamW train step with a
    finite loss and grad norm."""
    _first_parallel_exp()
    cfg = reduced(CONFIGS[arch])
    params = models.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "targets": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
        batch["tokens"] = batch["tokens"][:, :S_DEC]
        batch["targets"] = batch["targets"][:, :S_DEC]
    if cfg.is_encoder_decoder:
        logits = encdec.forward(cfg, params, batch["frames"], batch["tokens"],
                                device="cpu")
    else:
        logits, _ = transformer.forward(cfg, params, batch["tokens"],
                                        device="cpu")
    assert logits.shape == (B, S_DEC if cfg.is_encoder_decoder else S,
                            cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all()
    step = train_step.make_train_step(
        cfg, optimizer.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10),
        device="cpu")
    params2, opt2, stats = step(params, optimizer.init_opt_state(params),
                                batch)
    assert np.isfinite(float(stats["loss"]))
    assert np.isfinite(float(stats["grad_norm"]))
    assert int(opt2["step"]) == 1
    assert all(a.dtype == b.dtype for a, b in zip(leaves(params2),
                                                  leaves(params)))
