"""The launch layer's ``shard`` activation hook held against the JAX
package's: the sequence of (name, shape, spec) constraints through
forward and loss for reduced dense GQA, MLA, MoE, Mamba-2, Jamba and
whisper, and the hook's specs with no data axes and with two pods.

The reference's side is recorded by its own ``make_shard_fn`` while
``jax.lax.with_sharding_constraint`` is replaced by a recorder (pytest's
``monkeypatch``).  Its scans trace their body once, so the six archetypes
run at one block, traced; TinyLlama at two blocks runs under
``jax.disable_jit`` (its scan then runs block by block, as the port's
loop does), which pins the per-block repetition.  No JAX file changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import mesh as jmesh, sharding as jsharding
from repro.models import encdec as jencdec, init_params as jinit
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch import params as P
from repro_torch.launch import mesh, sharding
from repro_torch.models import encdec, transformer
from test_torch_launch import _one_thread  # noqa: F401


HOOK_ARCHS = ("tinyllama-1.1b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
              "mamba2-370m", "jamba-v0.1-52b", "whisper-base")


def _reference_log(monkeypatch, run, eager: bool) -> list:
    """(name, shape, spec) of every constraint the reference's own
    ``make_shard_fn`` places while ``run(shard)`` is traced, or runs
    eagerly."""
    hits, log = [], []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: hits.append(s.spec) or x)
    base = jsharding.make_shard_fn(jmesh.make_test_mesh(1, 1))

    def shard(x, name):
        n = len(hits)
        y = base(x, name)
        if len(hits) > n:
            log.append((name, tuple(x.shape), tuple(hits[-1])))
        return y

    if eager:
        with jax.disable_jit():
            run(shard)
    else:
        jax.make_jaxpr(lambda: run(shard))()
    return log


CASES = [(a, 1) for a in HOOK_ARCHS] + [("tinyllama-1.1b", 2)]


@pytest.mark.parametrize("arch,blocks", CASES,
                         ids=[f"{a}-{b}blk" for a, b in CASES])
def test_shard_hook_sequence_equals_the_reference(arch, blocks, monkeypatch):
    """Reduced configs (16 tokens; 64 for the SSD families: two chunks),
    forward then loss: the port's hook logs the reference's sequence of
    (name, shape, spec), and the outputs are bit-equal with and without
    it."""
    base = jconfigs.CONFIGS[arch]
    over = {"num_layers": base.block_period * blocks}
    if base.is_moe:
        over["capacity_factor"] = 8.0
    if base.is_encoder_decoder:
        over["num_encoder_layers"] = blocks
    jcfg = jconfigs.reduced(jconfigs.CONFIGS[arch], vocab_size=256, **over)
    cfg = configs.reduced(configs.CONFIGS[arch], vocab_size=256, **over)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jinit(jax.random.PRNGKey(0), jcfg))
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    S = 64 if cfg.family in ("ssm", "hybrid") else 16
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    frames = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        def jrun(shard):
            jencdec.forward(jcfg, jparams, jnp.asarray(frames),
                            jnp.asarray(toks), shard=shard)
            jencdec.loss_fn(jcfg, jparams, jnp.asarray(frames),
                            jnp.asarray(toks), jnp.asarray(tgts), shard=shard)

        def prun(**kw):
            return (encdec.forward(cfg, params, frames, toks, device="cpu",
                                   **kw),
                    encdec.loss_fn(cfg, params, frames, toks, tgts,
                                   device="cpu", **kw))
    else:
        def jrun(shard):
            jtransformer.forward(jcfg, jparams, jnp.asarray(toks), shard=shard)
            jtransformer.loss_fn(jcfg, jparams, jnp.asarray(toks),
                                 jnp.asarray(tgts), shard=shard)

        def prun(**kw):
            return (transformer.forward(cfg, params, toks, device="cpu",
                                        **kw)[0],
                    transformer.loss_fn(cfg, params, toks, tgts,
                                        device="cpu", **kw))
    want = _reference_log(monkeypatch, jrun, eager=blocks > 1)
    m = mesh.make_test_mesh(1, 1)
    with torch.no_grad():
        hooked = prun(shard=sharding.make_shard_fn(m))
        plain = prun()
    assert [(n, s, tuple(p)) for n, s, p in m.log] == want
    assert len(want) > 4
    for a, b in zip(hooked, plain):
        assert torch.equal(a, b)


def test_shard_fn_data_axes_and_mesh_record(monkeypatch):
    """The hook with no data axes (inside the data-shard step: the model
    axis only) and with two pods places the reference's specs, returns x
    itself and logs nothing for other names; the mesh record reads as the
    reference's mesh does.  ``to_named`` has no counterpart."""
    m = mesh.make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.shape.get("pod", 1) == 2
    assert mesh.make_production_mesh().shape.get("pod", 1) == 1
    hits = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: hits.append(tuple(s.spec)) or x)
    jm = jmesh.make_test_mesh(1, 1, pod=1)
    x = torch.zeros(2, 8, 4)
    for dp in ((), ("pod", "data")):
        for name, shape in (("hidden", (2, 8, 4)), ("logits", (2, 8, 4)),
                            ("ssm_chunk", (2, 8, 4, 3)), ("other", (2, 8))):
            t = x.new_zeros(shape)
            n = len(m.log)
            assert sharding.make_shard_fn(m, dp)(t, name) is t
            jsharding.make_shard_fn(jm, dp)(jnp.zeros(shape), name)
            if name == "other":
                assert len(m.log) == n
            else:
                assert m.log[-1][:2] == (name, shape)
                assert tuple(m.log[-1][2]) == hits[-1]
    assert not hasattr(sharding, "to_named")
