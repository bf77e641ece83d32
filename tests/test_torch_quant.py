"""The port's quantized paged-KV path (fp8 e4m3 / int8 pools with per-page
scales) held against the JAX package on the CPU: a port of
tests/test_quant.py and of tests/integration/engine_quant.py's four
conformance cells.

  * ``quant`` helpers: scales, codes (as bytes) and dequantized values equal
    JAX's bit for bit.  JAX's scales are taken from ``jax.jit`` of its
    helper, as its decode step, scatter and re-shard run it (XLA turns the
    divide by the constant qmax into a multiply by its float32 reciprocal;
    eager JAX divides, and differs by at most one ulp).
  * plain quantized paged decode vs JAX ``ref.paged_decode_attention`` with
    scales, float32 atol = rtol = 1e-5; both within the reference's bound
    of the unquantized result (0.35 fp8 / 0.08 int8).
  * prefill scatter and live re-shard: pool codes and scales equal JAX's bit
    for bit; the dequantized destination within 0.25 fp8 / 0.05 int8 of
    the original KV.
  * engine cells: ``NanoCPEngine`` with quantized pools against JAX
    ``transformer.forward`` teacher-forced on the engine's transcript, under
    the reference's contract (|dlogit| <= 1.5 fp8 / 0.5 int8 per step, an
    argmax miss only at a near-tie, near-ties at most half the steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core import dcp as jdcp, migrate as jmigrate
from repro.kernels import paged_attention as jpa
from repro.kernels import quant as jquant, ref as jref
from repro.models import init_params as jinit, transformer as jtransformer
from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core import dcp, migrate
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.core.state import ClusterState
from repro_torch.kernels import paged_attention as pa, quant
from repro_torch.serving.engine import NanoCPEngine


def _bits(a) -> np.ndarray:
    """The raw bytes of an array or tensor (fp8 as its codes)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _to_torch_codes(j) -> torch.Tensor:
    """A JAX code array as the torch tensor of the same bytes and dtype."""
    a = np.asarray(j)
    dt = torch.int8 if a.dtype == np.int8 else torch.float8_e4m3fn
    return torch.from_numpy(a.view(np.uint8).copy()).view(dt)


# --------------------------------------------------------------------------- #
# format helpers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kv_dtype", ["fp8", "int8"])
def test_quant_helpers_match_jax_bit_for_bit(kv_dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((512, 64)).astype(np.float32)
    x *= (np.float32(10.0) ** rng.integers(-4, 4, (512, 1))).astype(np.float32)
    x[0] = 0.0                                        # floored scale
    jsc = np.asarray(jax.jit(lambda a: jquant.amax_scale(a, kv_dtype))(
        jnp.asarray(x)))
    tsc = quant.amax_scale(torch.from_numpy(x), kv_dtype)
    np.testing.assert_array_equal(_bits(tsc), _bits(jsc))
    assert tsc[0].item() == np.float32(quant.SCALE_FLOOR)
    # clip some values: scales below the rows' own amax
    sc = jsc * np.float32(0.6)
    jq = jquant.quantize(jnp.asarray(x), jnp.asarray(sc)[:, None], kv_dtype)
    tq = quant.quantize(torch.from_numpy(x), torch.from_numpy(sc)[:, None],
                        kv_dtype)
    assert tq.dtype == quant.kv_storage_dtype(kv_dtype, torch.float32)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    jd = jquant.dequantize(jq, jnp.asarray(sc)[:, None])
    td = quant.dequantize(tq, torch.from_numpy(sc)[:, None])
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    assert quant.kv_qmax(kv_dtype) == jquant.kv_qmax(kv_dtype)
    assert quant.kv_bytes_per_value(kv_dtype) == jquant.kv_bytes_per_value(kv_dtype)


@pytest.mark.parametrize("kv_dtype,rel", [("fp8", 1 / 8), ("int8", 1 / 127)])
def test_quant_roundtrip_error_bound(kv_dtype, rel):
    """Port of tests/test_quant.py: per-PAGE scaling keeps the round-trip
    error within the dtype's step of each page's own amax."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 16, 4, 32)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-3, 4, (6, 1, 1, 1))
    x = torch.from_numpy(x)
    scale = quant.amax_scale(x.reshape(6, -1), kv_dtype)
    q = quant.quantize(x, scale[:, None, None, None], kv_dtype)
    back = quant.dequantize(q, scale[:, None, None, None])
    err = (back - x).abs().amax(dim=(1, 2, 3))
    amax = x.abs().reshape(6, -1).amax(dim=1)
    assert bool((err <= amax * rel).all()), (kv_dtype, err / amax)


def test_kv_dtype_checks_match_jax():
    assert not quant.is_quantized("bf16") and quant.is_quantized("fp8")
    assert quant.kv_storage_dtype("bf16", torch.float32) == torch.float32
    assert quant.kv_storage_dtype("int8", torch.float32) == torch.int8
    assert quant.kv_bytes_per_value("bf16") == jquant.kv_bytes_per_value("bf16")
    with pytest.raises(ValueError):
        quant.check_kv_dtype("fp16")


# --------------------------------------------------------------------------- #
# plain quantized paged decode
# --------------------------------------------------------------------------- #
def _quantized_pages(rng, Pn, page, H, d, kv_dtype):
    """Float pages, their codes and per-page scales, made by JAX."""
    x = jnp.asarray(rng.standard_normal((Pn, page, H, d)), jnp.float32)
    sc = jquant.amax_scale(x.reshape(Pn, -1), kv_dtype)
    return x, jquant.quantize(x, sc[:, None, None, None], kv_dtype), sc


GEOMS = [("gqa", 4, 4, 32, 32), ("grouped", 4, 2, 32, 32),
         ("mla", 4, 1, 64, 48)]


@pytest.mark.parametrize("kv_dtype,tol", [("fp8", 0.35), ("int8", 0.08)])
@pytest.mark.parametrize("name,Hq,Hkv,dk,dv", GEOMS)
def test_quantized_paged_decode_plain_vs_jax(name, Hq, Hkv, dk, dv, kv_dtype,
                                             tol):
    rng = np.random.default_rng(1)
    N, Pn, page, MB = 4, 8, 16, 2
    q = jnp.asarray(rng.standard_normal((N, Hq, dk)), jnp.float32)
    k, kq, ks = _quantized_pages(rng, Pn, page, Hkv, dk, kv_dtype)
    v, vq, vs = _quantized_pages(rng, Pn, page, Hkv, dv, kv_dtype)
    bt = rng.permutation(Pn)[:N * MB].reshape(N, MB).astype(np.int32)
    lengths = rng.integers(1, MB * page + 1, (N,)).astype(np.int32)
    lengths[0] = 0                                  # inactive (CP padding) row

    j_exact, j_lse = jref.paged_decode_attention(q, k, v, jnp.asarray(bt),
                                                 jnp.asarray(lengths))
    j_got, j_lse_q = jref.paged_decode_attention(
        q, kq, vq, jnp.asarray(bt), jnp.asarray(lengths), k_scale=ks,
        v_scale=vs)
    t_got, t_lse_q = pa.paged_decode_attention(
        torch.from_numpy(np.array(q)), _to_torch_codes(kq),
        _to_torch_codes(vq), torch.from_numpy(bt), torch.from_numpy(lengths),
        k_scale=torch.from_numpy(np.array(ks)),
        v_scale=torch.from_numpy(np.array(vs)))
    np.testing.assert_allclose(t_got.numpy(), np.asarray(j_got), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(t_lse_q.numpy(), np.asarray(j_lse_q),
                               atol=1e-5, rtol=1e-5)
    for got, lse in ((t_got.numpy(), t_lse_q.numpy()),
                     (np.asarray(j_got), np.asarray(j_lse_q))):
        assert np.max(np.abs(got - np.asarray(j_exact))) <= tol, (name, kv_dtype)
        assert np.max(np.abs(lse - np.asarray(j_lse))) <= tol


def test_quantized_paged_decode_plain_vs_pallas_interpret():
    """The plain version computes what the Pallas kernel's fused dequant
    computes (interpret mode), on the same codes and scales."""
    rng = np.random.default_rng(2)
    N, Pn, page, MB, Hq, Hkv, d = 4, 8, 16, 3, 4, 2, 32
    q = jnp.asarray(rng.standard_normal((N, Hq, d)), jnp.float32)
    _, kq, ks = _quantized_pages(rng, Pn, page, Hkv, d, "int8")
    _, vq, vs = _quantized_pages(rng, Pn, page, Hkv, d, "int8")
    bt = rng.integers(0, Pn, (N, MB)).astype(np.int32)
    lengths = rng.integers(1, MB * page + 1, (N,)).astype(np.int32)
    o_pl, l_pl = jpa.paged_decode_attention(
        q, kq, vq, jnp.asarray(bt), jnp.asarray(lengths), k_scale=ks,
        v_scale=vs, interpret=True)
    o_t, l_t = pa.paged_decode_attention(
        torch.from_numpy(np.array(q)), _to_torch_codes(kq),
        _to_torch_codes(vq), torch.from_numpy(bt), torch.from_numpy(lengths),
        k_scale=torch.from_numpy(np.array(ks)),
        v_scale=torch.from_numpy(np.array(vs)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_pl), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_pl), atol=1e-5,
                               rtol=1e-5)


def test_quantized_paged_decode_needs_both_scales():
    q = torch.zeros(1, 2, 8)
    kp = torch.zeros(2, 4, 1, 8, dtype=torch.int8)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        pa.paged_decode_attention(q, kp, kp, bt, ln, k_scale=torch.ones(2))


# --------------------------------------------------------------------------- #
# prefill scatter and live re-shard, both packages from the same numpy KV
# --------------------------------------------------------------------------- #
def _assert_state_equal(tstate: dict, jstate: dict, keys) -> None:
    for key in keys:
        np.testing.assert_array_equal(_bits(tstate[key]), _bits(jstate[key]),
                                      err_msg=key)


@pytest.mark.parametrize("dst_fill", [0, 5], ids=["fresh-dst", "partial-dst"])
@pytest.mark.parametrize("kv_dtype,tol", [("fp8", 0.25), ("int8", 0.05)])
def test_scatter_and_reshard_match_jax(kv_dtype, tol, dst_fill):
    """The set-up of tests/test_quant.py::test_reshard_moves_scales_with_values
    through both packages.  With ``dst_fill`` > 0 the clip paths run too:
    the prefill scatter takes two calls, so the second call's first page
    clips into the scale the first call set, and the destination shard
    already holds a partial page, which the moved tokens clip into.
    Clipped values can be far from the originals, so the error bound is
    checked on the reference's own set-up only."""
    cfg = reduced(CONFIGS["tinyllama-1.1b"])
    jcfg = jreduced(JCONFIGS["tinyllama-1.1b"])
    I, page, L, tp = 2, 8, 37, 2
    kw = dict(M=4, S=0, N=4, MB=8, W=I, num_frames=65, page=page,
              data_size=I, tp=tp, kv_dtype=kv_dtype)
    dims, jdims = dcp.DecodeDims(**kw), jdcp.DecodeDims(**kw)
    cl = ClusterState(num_instances=I, instances_per_node=I,
                      kv_capacity_tokens=64 * page, page_size=page)
    shards = {0: L, 1: dst_fill} if dst_fill else {0: L}
    cl.page_table.allocate(0, shards)
    nb, hkv, hd = cfg.num_blocks, cfg.num_kv_heads, cfg.head_dim_
    na = sum(1 for b in cfg.block_pattern() if b["mixer"] == "attn")
    T = L + dst_fill
    rng = np.random.default_rng(3)
    k_np = rng.standard_normal((nb, na, T, hkv, hd)).astype(np.float32)
    v_np = rng.standard_normal((nb, na, T, hkv, hd)).astype(np.float32)

    tstate = dcp.init_serve_state(cfg, dims, I, dtype=torch.float32,
                                  device="cpu")
    jstate = jdcp.init_serve_state(jcfg, jdims, I, dtype=jnp.float32)
    assert sorted(tstate) == sorted(jstate) == ["k_pool", "k_scale",
                                                 "v_pool", "v_scale"]
    sc = migrate.PrefillScatter(cfg, dims, I)
    jsc = jmigrate.PrefillScatter(jcfg, jdims, I)
    khs = sc.khs
    coords = migrate.prefill_coords(cl, 0, page, sc.ps)
    parts = (slice(0, 21), slice(21, T)) if dst_fill else (slice(0, T),)
    for part in parts:                              # 21 % page != 0
        kk, vv = k_np[:, :, part, :khs], v_np[:, :, part, :khs]
        sc.scatter_kv(tstate, torch.from_numpy(kk), torch.from_numpy(vv),
                      coords[:, part])
        jstate = jsc.scatter_kv(jstate, jnp.asarray(kk), jnp.asarray(vv),
                                coords[:, part])
    _assert_state_equal(tstate, jstate, sorted(tstate))

    ptrs = {k: t.data_ptr() for k, t in tstate.items()}
    moved = 16
    src, dst = cl.page_table.move_pages(0, [(0, 1, moved)])
    migrate.KVReshard(sc)(tstate, src, dst)
    jstate = jmigrate.KVReshard(jsc)(jstate, src, dst)
    cl.page_table.frame_audit()
    assert {k: t.data_ptr() for k, t in tstate.items()} == ptrs
    _assert_state_equal(tstate, jstate, sorted(tstate))

    if dst_fill:
        return
    # the moved tokens decode back out of shard 1 within quantization error
    kp = quant.dequantize(tstate["k_pool"], tstate["k_scale"][..., None, None])
    ps, worst = sc.ps, 0.0
    for t in range(moved):
        i, f, o = (int(dst[0][t]), int(dst[1][t]), int(dst[2][t]))
        tok = L - moved + t
        for h in range(khs):
            got = kp[:, :, i, (f % ps) * khs + h, f // ps, o].numpy()
            worst = max(worst, float(np.max(np.abs(got - k_np[:, :, tok, h]))))
    assert worst <= tol, (kv_dtype, worst)


# --------------------------------------------------------------------------- #
# engine cells (tests/integration/engine_quant.py, in process)
# --------------------------------------------------------------------------- #
VOCAB = 256
LOGIT_TOL = {"fp8": 1.5, "int8": 0.5}
QUANT_CELLS = [("fp8", 2, 2, False), ("fp8", 4, 1, False),
               ("int8", 2, 2, False), ("fp8", 2, 2, True)]


def _quant_models(arch="tinyllama-1.1b", **over):
    jcfg = jreduced(JCONFIGS[arch], vocab_size=VOCAB, **over)
    cfg = reduced(CONFIGS[arch], vocab_size=VOCAB, **over)
    jparams = jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
        jinit(jax.random.PRNGKey(0), jcfg))
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def quant_models():
    return _quant_models()


@pytest.mark.parametrize("kv_dtype,I,TP,escalate", QUANT_CELLS,
                         ids=["fp8-2-2", "fp8-4-1", "int8-2-2",
                              "fp8-2-2-escalate"])
def test_engine_quant_cell(quant_models, kv_dtype, I, TP, escalate):
    _engine_quant_cell(quant_models, kv_dtype, I, TP, escalate)


def test_engine_quant_cell_deepseek_fp8():
    """The same cell on reduced DeepSeek-V3 (MLA's fp8 latent pool, MoE top-2
    of 4 plus a shared expert, capacity factor 8): quantized MLA + MoE held
    to the reference's contract, at the reference's own reduced setting."""
    _engine_quant_cell(_quant_models("deepseek-v3", capacity_factor=8.0),
                       "fp8", 2, 2, False)


def _engine_quant_cell(models, kv_dtype, I, TP, escalate):
    jcfg, jparams, cfg, params = models
    tol = LOGIT_TOL[kv_dtype]
    if escalate:
        edges, degrees = (48,), (1, 2)
    else:
        edges = (64, 160)
        degrees = (1, 2, 3) if I >= 3 else (1, 2, 2)
    eng = NanoCPEngine(
        cfg, params, num_instances=I, instances_per_node=I, tp=TP,
        kv_capacity_tokens=4096, page_size=16,
        buckets=CPBuckets(edges=edges, degrees=degrees),
        shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4), s_buckets=(0, 1, 2, 4),
                                   window=I),
        max_slots_per_instance=4, audit_donation_every_step=True,
        kv_dtype=kv_dtype, keep_logits=True, device="cpu")
    pools, scales = ((("kv_pool",), {"kv_scale"}) if cfg.is_mla
                     else (("k_pool", "v_pool"), {"k_scale", "v_scale"}))
    assert scales <= set(eng.state)
    for name in pools:
        assert eng.state[name].dtype == quant.kv_storage_dtype(kv_dtype,
                                                               torch.float32)
    ptrs = {k: t.data_ptr() for k, t in eng.state.items()}
    rng = np.random.default_rng(0)
    lens, new = ((40,), 24) if escalate else ((24, 90, 180), 6)
    prompts = {eng.add_request(rng.integers(0, VOCAB, (n,)),
                               max_new_tokens=new): None for n in lens}
    for rid in prompts:
        prompts[rid] = list(eng._prompts[rid])
    eng.step()
    assert not eng.cluster.waiting, "all requests must admit at step 1"
    for _ in range(96):
        if not eng.pending:
            break
        eng.step()
    assert not eng.pending

    hp = eng.hot_path_stats
    if escalate:
        assert hp["escalations"] >= 1 and hp["reshard_tokens"] > 0, hp
        assert len(eng.finished[0].kv_binding) == 2, eng.finished[0].kv_binding

    # the reference's numerics contract, teacher-forced: one JAX forward per
    # request over prompt + transcript gives the reference logits at every
    # generated position
    near_ties = total = 0
    worst = 0.0
    for rid, res in eng.results.items():
        seq = prompts[rid] + res.tokens[:-1]
        ref_logits, _ = jtransformer.forward(jcfg, jparams,
                                             jnp.asarray(seq)[None])
        ref = np.asarray(ref_logits[0, len(prompts[rid]) - 1:], np.float32)
        assert len(res.tokens) == new
        assert res.tokens[0] == int(ref[0].argmax()), rid
        steps = eng.step_logits[rid]
        assert len(steps) == len(res.tokens) - 1, (rid, len(steps))
        for j, got in enumerate(steps):
            r = ref[j + 1]
            delta = float(np.max(np.abs(got[:VOCAB] - r)))
            worst = max(worst, delta)
            assert delta <= tol, (rid, j, delta, tol)
            order = np.argsort(r)
            total += 1
            if res.tokens[j + 1] != int(order[-1]):
                margin = float(r[order[-1]] - r[order[-2]])
                assert margin <= tol, (rid, j, margin, tol)
                near_ties += 1
    assert near_ties <= total // 2, (near_ties, total)
    print(f"{cfg.name} {kv_dtype}: worst |dlogit| {worst:.4f}, near-ties "
          f"{near_ties}/{total}")

    st = eng.aot.stats
    assert st.donation_checks == hp["steps"] > 0 and st.donation_copies == 0
    assert {k: t.data_ptr() for k, t in eng.state.items()} == ptrs
    assert eng.last_bucket[-1] == kv_dtype, eng.last_bucket
    eng.cluster.page_table.frame_audit()
