"""The decoder-only archetypes ported last, held against the JAX package on
reduced configs (2 layers, d_model 64, vocab 256) in float32: qkv bias
(Qwen1.5 with tied embeddings, Qwen2.5), qk-norm (Chameleon, and
Llama-4-Scout with MoE top-1 plus a shared expert) and DeepSeek-V3 (MLA
with MoE top-2 of 4 plus a shared expert, reduced).

The JAX init makes the biases 0 and the norm scales 1, where a dropped
bias or norm would not show, so the numpy leaves are perturbed before
conversion: every bias from N(0, 0.5), every norm scale from 1 + N(0, 0.3).
Tolerance: atol = rtol = 1e-4 on logits and collected k/v (the same f32
model in two frameworks, whose matmuls sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.models import init_params as jinit, moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import params as P
from repro_torch.configs import CONFIGS, ModelConfig, get_config, reduced
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.models import moe, transformer
from repro_torch.serving.engine import NanoCPEngine

TOL = 1e-4
ARCHS = ["qwen1.5-0.5b", "qwen2.5-14b", "chameleon-34b",
         "llama4-scout-17b-a16e", "deepseek-v3"]


def perturb(np_tree, seed: int = 0):
    """numpy leaves with every q/k/v bias from N(0, 0.5) and every norm
    scale (layer norms, q/k norms, MLA's latent norms) from 1 + N(0, 0.3)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        if name in ("bq", "bk", "bv"):
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        if name in ("scale", "q_norm", "k_norm", "kv_norm"):
            return (1.0 + rng.normal(0.0, 0.3, x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, np_tree)


def _models(arch, **over):
    """Reduced JAX and port configs and perturbed float32 weights: the JAX
    tree (jnp leaves) and the port's converted copy."""
    if JCONFIGS[arch].is_moe:
        over.setdefault("capacity_factor", 8.0)
    jcfg = jreduced(JCONFIGS[arch], vocab_size=256, **over)
    cfg = reduced(CONFIGS[arch], vocab_size=256, **over)
    np_tree = perturb(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                   jinit(jax.random.PRNGKey(0), jcfg)))
    return (jcfg, jax.tree.map(jnp.asarray, np_tree), cfg,
            P.from_jax(np_tree, device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_registered_copy(arch):
    """Registered under its name, field for field the reference's config
    (source string included)."""
    assert arch in CONFIGS
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(JCONFIGS[arch]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_kv_match_jax(arch):
    jcfg, jparams, cfg, params = _models(arch)
    toks = np.random.default_rng(1).integers(0, 256, (2, 21))
    lj, cj = jtransformer.forward(jcfg, jparams, jnp.asarray(toks),
                                  collect_kv=True)
    lt, ct = transformer.forward(cfg, params, torch.as_tensor(toks),
                                 collect_kv=True, device="cpu")
    assert lt.shape == lj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    for li in range(len(cfg.block_pattern())):
        for j in range(2):         # (k, v), or MLA's (c_kv, k_rope)
            got, want = ct[li]["kv"][j].numpy(), np.asarray(cj[li]["kv"][j])
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_conversion_carry_bias_and_norm_leaves(arch):
    """``init_params`` builds the JAX init's tree (same leaves, same
    shapes; biases 0 and q/k norm scales 1), and ``params.from_jax``
    carries the perturbed bias and norm leaves exactly."""
    jcfg, jparams, cfg, params = _models(arch)
    mine = transformer.init_params(cfg, seed=0, device="cpu",
                                   dtype=torch.float32)
    j_leaves = jax.tree_util.tree_leaves_with_path(jparams)
    t_leaves = jax.tree_util.tree_leaves_with_path(P.to_jax(mine))
    assert ([(jax.tree_util.keystr(k), v.shape) for k, v in j_leaves]
            == [(jax.tree_util.keystr(k), v.shape) for k, v in t_leaves])
    mixer, jmixer = mine["blocks"]["layers"][0]["mixer"], None
    names = ({"bq", "bk", "bv"} if cfg.qkv_bias else set()) | (
        {"q_norm", "k_norm"} if cfg.qk_norm else set())
    assert names <= set(mixer)
    for n in names:
        assert torch.equal(mixer[n], torch.full_like(
            mixer[n], 1.0 if n.endswith("norm") else 0.0))
    conv = P.to_jax(params)
    for (kp, want), (_, got) in zip(j_leaves,
                                    jax.tree_util.tree_leaves_with_path(conv)):
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=jax.tree_util.keystr(kp))
    jmixer = jparams["blocks"]["layers"][0]["mixer"]
    for n in names:             # the perturbation reached these leaves
        assert np.abs(np.asarray(jmixer[n]) - (1.0 if n.endswith("norm")
                                               else 0.0)).max() > 0.1


def test_only_ssm_and_encoder_decoder_configs_raise():
    """Every decoder-only attention config of the reference is served;
    SSM/hybrid and encoder-decoder configs raise, naming their items."""
    for name, jcfg in JCONFIGS.items():
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        if cfg.family in ("ssm", "hybrid") or not cfg.has_attention:
            with pytest.raises(NotImplementedError, match="item 11"):
                transformer.check_supported(cfg)
        elif cfg.is_encoder_decoder:
            with pytest.raises(NotImplementedError, match="item 12"):
                transformer.check_supported(cfg)
        else:
            transformer.check_supported(cfg)
            assert name in CONFIGS


def test_moe_ffn_runs_only_the_filled_bins():
    """At C >= T (no drop) the prefill FFN runs the first Cb = fullest-bin
    slots of every bin, and equals the reference's FFN over all C slots:
    reduced DeepSeek-V3 (4 experts top-2 plus a shared expert) at capacity
    factor E/k = 2, so C = T."""
    jcfg, jparams, cfg, params = _models("deepseek-v3", capacity_factor=2.0)
    T = 37
    x = np.random.default_rng(2).standard_normal((T, cfg.d_model)).astype(
        np.float32)
    ffn = params["blocks"]["layers"][0]["ffn"]
    jffn = jax.tree.map(lambda a: a[0], jparams["blocks"]["layers"][0]["ffn"])
    _, idx = moe.router_topk(cfg, ffn["router"][0], torch.from_numpy(x))
    assert int(moe.bin_rows(idx, cfg.num_experts).max()) < moe.capacity(cfg, T)
    got = moe.moe_ffn(cfg, jax.tree.map(lambda a: a[0], ffn),
                      torch.from_numpy(x))
    want = jmoe.moe_ffn(jcfg, jffn, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_qwen_engine_transcripts_equal_jax_greedy():
    """Reduced Qwen1.5 (q/k/v biases, tied embeddings: the head is the
    embedding's transpose) through ``NanoCPEngine`` on a (2, 2) mesh:
    every transcript equals greedy JAX ``transformer.forward``,
    teacher-forced."""
    jcfg, jparams, cfg, params = _models("qwen1.5-0.5b")
    assert cfg.qkv_bias and cfg.tie_embeddings and "w" not in params["head"]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (L,)) for L in (50, 130, 40)]
    eng = NanoCPEngine(cfg, params, num_instances=2, instances_per_node=2,
                       kv_capacity_tokens=1024, page_size=16, tp=2,
                       buckets=CPBuckets(edges=(100,), degrees=(1, 2)),
                       shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                  s_buckets=(0, 1, 2, 4),
                                                  window=2),
                       device="cpu")
    for p in prompts:
        eng.add_request(p, max_new_tokens=5)
    results = eng.run(max_iters=30)
    assert sorted(results) == [0, 1, 2]
    for rid, prompt in enumerate(prompts):
        toks = results[rid].tokens
        assert len(toks) == 5
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int64)])
        logits, _ = jtransformer.forward(jcfg, jparams, jnp.asarray(seq)[None])
        ref = np.asarray(logits[0, len(prompt) - 1:]).argmax(-1).tolist()
        assert toks == ref, (rid, toks, ref)
