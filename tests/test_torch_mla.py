"""The port's MLA (multi-head latent attention) path held against the JAX
package on reduced minicpm3 (2 layers, vocab 256; q_lora 32, kv_lora 32,
nope 16, rope 8, v 16, so the decode latent is Dk 40 / Dv 32), in float32.

  * config copy, ``models/mla.py`` functions and ``transformer.forward``
    (logits and the collected latents ``(c_kv, k_rope)``): atol = rtol =
    1e-5 (the same f32 model evaluated by two frameworks, whose matmuls sum
    in different orders; the worst difference seen is 4e-6);
  * the weight converter carries every MLA mixer leaf exactly;
  * ``to_decode_params`` and ``init_serve_state`` (f32/fp8/int8) equal
    JAX's layouts at tp 2 and 4, where the latent stripes over every tp
    device;
  * the prefill scatter equals the port's numpy loader and JAX's
    ``load_prefill_kv`` bit for bit, and the scatter and live re-shard of
    the latent pool (f32 and fp8, with its ``kv_scale``) equal JAX's;
  * the plain paged decode at the latent's shape (G = 4 q heads over one
    latent head of 288, v the view ``k[..., :256]``) matches JAX's
    ``kernels/ref.py`` to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core import dcp as jdcp, migrate as jmigrate
from repro.kernels import quant as jquant, ref as jref
from repro.models import init_params as jinit, mla as jmla
from repro.models import transformer as jtransformer
from repro_torch import params as P
from repro_torch.configs import CONFIGS, get_config, reduced
from repro_torch.core import dcp, migrate
from repro_torch.core.state import ClusterState
from repro_torch.kernels import ref
from repro_torch.models import mla, transformer

TOL = 1e-5
ARCH = "minicpm3-4b"
MIXER_KEYS = {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b",
              "wo"}


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(JCONFIGS[ARCH], vocab_size=256)
    cfg = reduced(CONFIGS[ARCH], vocab_size=256)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jinit(jax.random.PRNGKey(0), jcfg))
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def test_mla_config_copy_matches_reference(models):
    assert (dataclasses.asdict(get_config(ARCH))
            == dataclasses.asdict(JCONFIGS[ARCH]))
    jcfg, _, cfg, _ = models
    for f in jcfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.is_mla and cfg.block_pattern() == jcfg.block_pattern()
    assert cfg.kv_lora_rank + cfg.qk_rope_head_dim == 40
    full = get_config(ARCH)
    assert full.kv_lora_rank + full.qk_rope_head_dim == 288


@pytest.mark.parametrize("B,S", [(1, 77), (2, 33)])
def test_mla_functions_match_jax(models, B, S):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["layers"][0]["mixer"])
    tp_ = {k: v[0] for k, v in params["blocks"]["layers"][0]["mixer"].items()}
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    pj, pt = jnp.asarray(pos), torch.from_numpy(pos.copy())

    def close(got, want):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)

    for got, want in zip(mla.mla_q(cfg, tp_, xt, pt),
                         jmla.mla_q(jcfg, jp, xj, pj)):
        close(got, want)
    for got, want in zip(mla.mla_latent(cfg, tp_, xt, pt),
                         jmla.mla_latent(jcfg, jp, xj, pj)):
        close(got, want)
    close(mla.mla_self_attention(cfg, tp_, xt, pt),
          jmla.mla_self_attention(jcfg, jp, xj, pj))
    qn = rng.standard_normal((B, S, cfg.num_heads,
                              cfg.qk_nope_head_dim)).astype(np.float32)
    close(mla.mla_absorbed_q(cfg, tp_, torch.from_numpy(qn)),
          jmla.mla_absorbed_q(jcfg, jp, jnp.asarray(qn)))
    ol = rng.standard_normal((B, S, cfg.num_heads,
                              cfg.kv_lora_rank)).astype(np.float32)
    close(mla.mla_unabsorb_out(cfg, tp_, torch.from_numpy(ol)),
          jmla.mla_unabsorb_out(jcfg, jp, jnp.asarray(ol)))


@pytest.mark.parametrize("B,S", [(1, 77), (2, 33)])
def test_mla_forward_logits_and_latents_match_jax(models, B, S):
    jcfg, jparams, cfg, params = models
    toks = np.random.default_rng(S).integers(0, 256, (B, S))
    lj, cj = jtransformer.forward(jcfg, jparams, jnp.asarray(toks),
                                  collect_kv=True)
    lt, ct = transformer.forward(cfg, params, torch.as_tensor(toks),
                                 collect_kv=True, device="cpu")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    for li in range(len(cfg.block_pattern())):
        for j, width in enumerate((cfg.kv_lora_rank, cfg.qk_rope_head_dim)):
            got, want = ct[li]["kv"][j].numpy(), np.asarray(cj[li]["kv"][j])
            assert got.shape == want.shape == (cfg.num_blocks, B, S, width)
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_mla_weight_conversion_and_init_layout(models):
    """``from_jax`` carries every MLA mixer leaf exactly (and ``to_jax``
    brings it back); the port's own init has JAX's layout."""
    _, jparams, cfg, params = models
    jmx = jparams["blocks"]["layers"][0]["mixer"]
    tmx = params["blocks"]["layers"][0]["mixer"]
    assert set(tmx) == set(jmx) == MIXER_KEYS
    for k in MIXER_KEYS:
        np.testing.assert_array_equal(tmx[k].numpy(), np.asarray(jmx[k]))
    back = P.to_jax(params)
    for k in MIXER_KEYS:
        np.testing.assert_array_equal(back["blocks"]["layers"][0]["mixer"][k],
                                      np.asarray(jmx[k]))
    jshapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                           jreduced(JCONFIGS[ARCH])))
    own = transformer.init_params(reduced(CONFIGS[ARCH]), seed=0, device="cpu")
    jl, tl = jax.tree.leaves(jshapes), jax.tree.leaves(P.to_jax(own))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("tp", [2, 4])
def test_mla_decode_params_match_jax(models, tp):
    """wq_b padded per head, wk_b/wv_b as [nb, hp, kvr, dn|dv] permuted
    like q, wo cut into tp row chunks (JAX keeps [nb, hp*dv, D] and lets
    the sharding cut it)."""
    jcfg, jparams, cfg, params = models
    jd = jax.tree.map(np.asarray, jdcp.to_decode_params(jcfg, jparams, tp))
    td = dcp.to_decode_params(cfg, params, tp)
    jl, tl = jd["blocks"]["layers"][0], td["blocks"]["layers"][0]
    assert set(tl["mixer"]) == set(jl["mixer"]) == MIXER_KEYS
    for k, want in jl["mixer"].items():
        got = tl["mixer"][k].numpy()
        if k == "wo":
            got = got.reshape(want.shape)
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(tl["ffn"]["wo"].numpy().reshape(
        jl["ffn"]["wo"].shape), jl["ffn"]["wo"])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8", "int8"])
def test_mla_serve_state_matches_jax(kv_dtype, tp):
    jcfg = jreduced(JCONFIGS[ARCH], vocab_size=256)
    cfg = reduced(CONFIGS[ARCH], vocab_size=256)
    kw = dict(M=2, S=0, N=2, MB=4, W=2, num_frames=33, page=16, data_size=2,
              tp=tp, kv_dtype=kv_dtype)
    js = jdcp.init_serve_state(jcfg, jdcp.DecodeDims(**kw), 2,
                               dtype=jnp.float32)
    ts = dcp.init_serve_state(cfg, dcp.DecodeDims(**kw), 2,
                              dtype=torch.float32, device="cpu")
    assert sorted(ts) == sorted(js)
    assert "kv_pool" in ts and ts["kv_pool"].shape[-1] == 40
    for k in ts:
        assert tuple(ts[k].shape) == js[k].shape, k
        np.testing.assert_array_equal(_bits(ts[k]), _bits(js[k]), err_msg=k)
    assert dcp.attn_tp_geometry(cfg, tp) == jdcp.attn_tp_geometry(jcfg, tp)
    assert dcp.attn_tp_geometry(cfg, tp)[1:] == (1, tp)


def _latent_setup(kv_dtype, tp, dst_fill=0):
    """A 2-instance cluster holding one request of L tokens on instance 0
    (plus ``dst_fill`` on instance 1), and numpy latents for it."""
    jcfg = jreduced(JCONFIGS[ARCH], vocab_size=256)
    cfg = reduced(CONFIGS[ARCH], vocab_size=256)
    I, page, L = 2, 8, 37
    _, _, ps = dcp.attn_tp_geometry(cfg, tp)
    kw = dict(M=4, S=0, N=4, MB=8, W=I, num_frames=65, page=page,
              data_size=I, tp=tp, kv_dtype=kv_dtype)
    dims, jdims = dcp.DecodeDims(**kw), jdcp.DecodeDims(**kw)
    cl = ClusterState(num_instances=I, instances_per_node=I,
                      kv_capacity_tokens=64 * page, page_size=page,
                      kv_stripes=ps)
    cl.page_table.allocate(0, {0: L, 1: dst_fill} if dst_fill else {0: L})
    rng = np.random.default_rng(11)
    T = L + dst_fill
    na = 1
    c_kv = rng.standard_normal((cfg.num_blocks, na, T, cfg.kv_lora_rank))
    k_rope = rng.standard_normal((cfg.num_blocks, na, T, cfg.qk_rope_head_dim))
    return (jcfg, cfg, cl, dims, jdims, c_kv.astype(np.float32),
            k_rope.astype(np.float32))


@pytest.mark.parametrize("tp", [2, 4])
def test_mla_prefill_scatter_matches_loaders(tp):
    jcfg, cfg, cl, dims, jdims, c_kv, k_rope = _latent_setup("bf16", tp)
    I = dims.data_size
    state = dcp.init_serve_state(cfg, dims, I, dtype=torch.float32,
                                 device="cpu")
    np_port = {k: np.zeros(v.shape, np.float32) for k, v in state.items()}
    np_jax = {k: np.zeros(v.shape, np.float32) for k, v in state.items()}
    layers = [(c_kv[b, 0], k_rope[b, 0]) for b in range(cfg.num_blocks)]
    migrate.load_prefill_kv(cfg, cl, dims, np_port, 0, layers)
    jmigrate.load_prefill_kv(jcfg, cl, jdims, np_jax, 0, layers)
    sc = migrate.PrefillScatter(cfg, dims, I)
    lat = torch.from_numpy(np.concatenate([c_kv, k_rope], -1))[..., None, :]
    sc.scatter_kv(state, lat, None,
                  migrate.prefill_coords(cl, 0, dims.page, sc.ps))
    np.testing.assert_array_equal(state["kv_pool"].numpy(), np_port["kv_pool"])
    np.testing.assert_array_equal(np_port["kv_pool"], np_jax["kv_pool"])
    # every token's latent landed on exactly one stripe
    assert int((np.abs(np_port["kv_pool"]).sum(-1) > 0).sum()) == c_kv.shape[2] * cfg.num_blocks


@pytest.mark.parametrize("dst_fill", [0, 5], ids=["fresh-dst", "partial-dst"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"], ids=["f32", "fp8"])
def test_mla_scatter_and_reshard_match_jax(kv_dtype, dst_fill):
    """Scatter a request's latents, then move 16 of its tokens to the other
    instance through ``KVReshard``: the latent pool (and, for fp8, its
    ``kv_scale``) equals JAX's bit for bit after both, in place."""
    tp = 4
    jcfg, cfg, cl, dims, jdims, c_kv, k_rope = _latent_setup(kv_dtype, tp,
                                                             dst_fill)
    I = dims.data_size
    tstate = dcp.init_serve_state(cfg, dims, I, dtype=torch.float32,
                                  device="cpu")
    jstate = jdcp.init_serve_state(jcfg, jdims, I, dtype=jnp.float32)
    keys = sorted(tstate)
    assert keys == sorted(jstate) == (["kv_pool"] if kv_dtype == "bf16"
                                      else ["kv_pool", "kv_scale"])
    sc = migrate.PrefillScatter(cfg, dims, I)
    jsc = jmigrate.PrefillScatter(jcfg, jdims, I)
    lat = np.concatenate([c_kv, k_rope], -1)[..., None, :]
    coords = migrate.prefill_coords(cl, 0, dims.page, sc.ps)
    T = lat.shape[2]
    parts = (slice(0, 21), slice(21, T)) if dst_fill else (slice(0, T),)
    for part in parts:
        sc.scatter_kv(tstate, torch.from_numpy(lat[:, :, part]), None,
                      coords[:, part])
        jstate = jsc.scatter_kv(jstate, jnp.asarray(lat[:, :, part]), None,
                                coords[:, part])
    for k in keys:
        np.testing.assert_array_equal(_bits(tstate[k]), _bits(jstate[k]), k)
    ptrs = {k: t.data_ptr() for k, t in tstate.items()}
    src, dst = cl.page_table.move_pages(0, [(0, 1, 16)])
    migrate.KVReshard(sc)(tstate, src, dst)
    jstate = jmigrate.KVReshard(jsc)(jstate, src, dst)
    cl.page_table.frame_audit()
    assert {k: t.data_ptr() for k, t in tstate.items()} == ptrs
    for k in keys:
        np.testing.assert_array_equal(_bits(tstate[k]), _bits(jstate[k]), k)


@pytest.mark.parametrize("kv_dtype", [None, "fp8", "int8"])
def test_plain_paged_decode_latent_shape_matches_jax(kv_dtype):
    """G = 4 q heads over MLA's single latent head of 288 (MiniCPM3-4B's
    kv_lora 256 + rope 32), v = k[..., :256] as a view, ragged lengths with
    an empty row; quantized pools share one scale per page for k and v."""
    rng = np.random.default_rng(4)
    N, Pn, page, MB, dk, dv = 5, 16, 16, 3, 288, 256
    q = rng.standard_normal((N, 4, dk)).astype(np.float32)
    k = rng.standard_normal((Pn, page, 1, dk)).astype(np.float32)
    bt = rng.permutation(Pn)[:N * MB].reshape(N, MB).astype(np.int32)
    lengths = np.array([0, 1, 16, 40, 48], np.int32)
    scale = (64 + 32) ** -0.5
    jk, kw, tkw = jnp.asarray(k), {}, {}
    tk = torch.from_numpy(k)
    if kv_dtype is not None:
        sc = jquant.amax_scale(jk.reshape(Pn, -1), kv_dtype)
        jk = jquant.quantize(jk, sc[:, None, None, None], kv_dtype)
        a = np.asarray(jk)
        tk = torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.int8 if a.dtype == np.int8 else torch.float8_e4m3fn)
        kw = dict(k_scale=sc, v_scale=sc)
        ts = torch.from_numpy(np.array(sc))
        tkw = dict(k_scale=ts, v_scale=ts)
    jo, jl = jref.paged_decode_attention(jnp.asarray(q), jk, jk[..., :dv],
                                         jnp.asarray(bt), jnp.asarray(lengths),
                                         scale=scale, **kw)
    tv = tk[..., :dv]
    assert tv.data_ptr() == tk.data_ptr() and not tv.is_contiguous()
    to, tl = ref.paged_decode_attention(torch.from_numpy(q), tk, tv,
                                        torch.from_numpy(bt),
                                        torch.from_numpy(lengths),
                                        scale=scale, **tkw)
    assert tuple(to.shape) == (N, 4, dv)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert float(tl[0].max()) == np.float32(ref.NEG_INF)
    assert float(to[0].abs().max()) == 0
