"""The port's launch layer held against the JAX package's, on the CPU: the
shape sets and the assigned list, the routed/dense byte counts, the train
and ZeRO-1 specs leaf for leaf at full width (the reference on
``jax.eval_shape``, the port on ``meta``), the decode cells' control plane
(tables bit-equal under the reference's hardware figures, and the pinned
difference under the port's H100 ones), fp8 decode weights (the same
leaves, bit-equal codes, and the DCP step with them), raw fp8 pools
without scales, and the chunked-prefill cell.  The ``shard`` hook is in
``test_torch_launch_hook.py``.  The DCP steps of JAX run in a subprocess
with 8 forced host devices.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.core import comm as jcomm, dcp as jdcp
from repro.kernels import ref as jref
from repro.launch import cells as jcells, mesh as jmesh, sharding as jsharding
from repro.models import init_params as jinit
from repro.serving.latency_model import HardwareModel as JHardwareModel
from repro_torch import configs
from repro_torch import params as P
from repro_torch.core import comm, dcp, routing
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.core.scheduler import DualBalancedScheduler
from repro_torch.core.state import ClusterState, Request
from repro_torch.kernels import ref
from repro_torch.launch import cells, dryrun, mesh, sharding
from repro_torch.models import init_params
from repro_torch.serving.latency_model import HardwareModel, LatencyModel

ARCHS = sorted(configs.CONFIGS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (several test processes share the machine), and
    one ``torch.exp`` first (``test_torch_dcp._first_parallel_exp``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.exp(torch.zeros(1 << 16))
    yield
    torch.set_num_threads(n)


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _ref_leaves(tree, is_leaf=None) -> dict:
    """A JAX tree as {path: leaf}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(_key(k) for k in path): leaf for path, leaf in flat}


def _port_leaves(tree, prefix: str = "") -> dict:
    """A port tree of dicts and lists as {path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _specs(tree, jax_side: bool) -> dict:
    if jax_side:
        leaves = _ref_leaves(tree, is_leaf=lambda x: isinstance(x, JP))
    else:
        leaves = _port_leaves(tree)
    return {k: tuple(v) for k, v in leaves.items()}


def _ref_hw_model(cfg) -> LatencyModel:
    """The port's latency model on the reference's hardware figures."""
    return LatencyModel(cfg, hw=HardwareModel(
        **dataclasses.asdict(JHardwareModel())))


# --------------------------------------------------------------------------- #
# shapes, byte counts, specs
# --------------------------------------------------------------------------- #
def test_shapes_assigned_and_skips_equal_the_reference():
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    for arch in ARCHS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        assert (configs.applicable_shapes(cfg)
                == jconfigs.applicable_shapes(jcfg))
        assert configs.skipped_shapes(cfg) == jconfigs.skipped_shapes(jcfg)


def test_routed_and_dense_bytes_equal_the_reference():
    for a in (0, 1, 3, 13, 15):
        for b in (0, 1, 7, 128):
            for c in (2, 512, 1152):
                assert comm.routed_bytes(a, b, c) == jcomm.routed_bytes(a, b, c)
                assert comm.dense_bytes(a + 1, b, c) == jcomm.dense_bytes(
                    a + 1, b, c)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_zero_specs_equal_the_reference(arch):
    """Full width: ``train_param_specs`` (FSDP on and off),
    ``zero_opt_specs`` and ``batch_specs`` (one pod and two) leaf for
    leaf."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jparams = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    params = init_params(cfg, device="meta")
    shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in
              _ref_leaves(jparams).items()}
    assert shapes == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                      for k, v in _port_leaves(params).items()}
    for fsdp in (True, False):
        jps = jsharding.train_param_specs(jcfg, jparams, fsdp=fsdp)
        ps = sharding.train_param_specs(cfg, params, fsdp=fsdp)
        assert _specs(ps, False) == _specs(jps, True), fsdp
    jz = jsharding.zero_opt_specs(jps, jparams, 16)
    z = sharding.zero_opt_specs(ps, params, 16)
    assert _specs(z, False) == _specs(jz, True)
    for dp in (("data",), ("pod", "data")):
        assert _specs(sharding.batch_specs(cfg, dp), False) == _specs(
            jsharding.batch_specs(jcfg, dp), True)


# --------------------------------------------------------------------------- #
# decode cells: the control plane
# --------------------------------------------------------------------------- #
DECODE_CASES = [(a, s) for a in ARCHS
                for s in configs.applicable_shapes(configs.get_config(a))
                if configs.SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("arch,shape", DECODE_CASES,
                         ids=[f"{a}-{s}" for a, s in DECODE_CASES])
def test_plan_decode_cell_equals_the_reference(arch, shape):
    """At (I 16, TP 16) with the port's latency model on the reference's
    hardware figures: the lowered tables bit-equal, the dims and the CP
    histogram equal."""
    cfg = configs.get_config(arch)
    jcl, jtbl, jd = jcells.plan_decode_cell(
        jconfigs.get_config(arch), jconfigs.SHAPES[shape], num_instances=16,
        tp=16)
    cl, tbl, d = cells.plan_decode_cell(cfg, configs.SHAPES[shape],
                                        num_instances=16, tp=16,
                                        latency_model=_ref_hw_model(cfg))
    arrays = cells.table_arrays(tbl)
    jarrays = {f.name: getattr(jtbl, f.name) for f in dataclasses.fields(jtbl)
               if isinstance(getattr(jtbl, f.name), np.ndarray)}
    assert arrays.keys() == jarrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(v, jarrays[k], err_msg=k)
    for f in ("M", "S", "N", "MB", "MBT", "W", "num_frames", "page", "tp",
              "rounds_used", "backend"):
        assert getattr(d, f) == getattr(jd, f), f
    assert cells._cp_hist(cl) == jcells._cp_hist(jcl)


def test_h100_buckets_differ_from_the_reference_on_qwen():
    """The deliberate difference: the port's H100 datasheet figures give
    other CP buckets, so Qwen1.5 ``decode_32k`` plans CP 1 for all 128
    requests where the reference plans CP 2."""
    jcl, _, jd = jcells.plan_decode_cell(
        jconfigs.get_config("qwen1.5-0.5b"), jconfigs.SHAPES["decode_32k"],
        num_instances=16, tp=16)
    cl, _, d = cells.plan_decode_cell(
        configs.get_config("qwen1.5-0.5b"), configs.SHAPES["decode_32k"],
        num_instances=16, tp=16)
    assert jcells._cp_hist(jcl) == {2: 128}
    assert cells._cp_hist(cl) == {1: 128}
    assert jd.rounds_used > 0 and d.rounds_used == 0


# --------------------------------------------------------------------------- #
# fp8 decode weights
# --------------------------------------------------------------------------- #
NON_ENCDEC = [a for a in ARCHS if not configs.CONFIGS[a].is_encoder_decoder]


@pytest.mark.parametrize("arch", NON_ENCDEC)
def test_quantize_decode_weights_picks_the_reference_leaves(arch):
    """Full width: the same decode leaves (paths and shapes' sizes) and
    the same ones in fp8."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jd = jax.eval_shape(lambda: jdcp.quantize_decode_weights(
        jdcp.to_decode_params(jcfg, jinit(jax.random.PRNGKey(0), jcfg), 16)))
    d = dcp.quantize_decode_weights(
        dcp.to_decode_params(cfg, init_params(cfg, device="meta"), 16))
    jl, pl = _ref_leaves(jd), _port_leaves(d)
    assert jl.keys() == pl.keys()
    assert {k: int(np.prod(v.shape)) for k, v in jl.items()} == {
        k: v.numel() for k, v in pl.items()}
    fp8 = {k for k, v in pl.items() if v.dtype == torch.float8_e4m3fn}
    assert fp8 == {k for k, v in jl.items() if v.dtype == jnp.float8_e4m3fn}
    assert fp8


# reduced TinyLlama wide enough that its FFN and q/o projections pass the
# rule's 65,536 values (the k/v projections and norms stay bf16)
FP8_OVER = dict(vocab_size=256, d_model=256, d_ff=512, num_heads=16,
                num_kv_heads=2, head_dim=16)


def _fp8_models():
    jcfg = jconfigs.reduced(jconfigs.CONFIGS["tinyllama-1.1b"], **FP8_OVER)
    cfg = configs.reduced(configs.CONFIGS["tinyllama-1.1b"], **FP8_OVER)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)           # bf16 matrices
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def test_fp8_codes_bit_equal_the_reference():
    jcfg, jparams, cfg, params = _fp8_models()
    jq = _ref_leaves(jdcp.quantize_decode_weights(
        jdcp.to_decode_params(jcfg, jparams, 4)))
    pq = _port_leaves(dcp.quantize_decode_weights(
        dcp.to_decode_params(cfg, params, 4)))
    fp8 = [k for k, v in pq.items() if v.dtype == torch.float8_e4m3fn]
    assert sorted(fp8) == sorted(k for k, v in jq.items()
                                 if v.dtype == jnp.float8_e4m3fn)
    assert len(fp8) >= 4
    for k in fp8:
        np.testing.assert_array_equal(
            pq[k].contiguous().view(torch.uint8).numpy().reshape(-1),
            np.asarray(jq[k]).view(np.uint8).reshape(-1), err_msg=k)


# The JAX side of the fp8-weight and raw-fp8-pool steps, run by
# ``python -c`` with I*TP host devices: one step each from the recorded
# pools and tables.
_JAX_STEP = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import CONFIGS, reduced
from repro.core import dcp
from repro.models import init_params

rec = dict(np.load(sys.argv[1]))
I, TP, nf, page, M, S, N, MB, MBT = (int(x) for x in rec["meta"])
over = {k: int(v) for k, v in zip(rec["over_keys"], rec["over_vals"])}
cfg = reduced(CONFIGS["tinyllama-1.1b"], **over)
params = init_params(jax.random.PRNGKey(0), cfg)
mesh = compat.make_mesh((I, TP), ("data", "model"))
d = dcp.DecodeDims(M=M, S=S, N=N, MB=MB, MBT=MBT, W=I, num_frames=nf,
                   page=page, data_size=I, tp=TP)
tbl = {k[4:]: jnp.asarray(v) for k, v in rec.items() if k.startswith("tbl/")}
out = {}
for case, wdt, pdt in (("bf16w", None, jnp.bfloat16),
                       ("fp8w", jnp.float8_e4m3fn, jnp.bfloat16),
                       ("rawpool", None, jnp.float8_e4m3fn)):
    dp = dcp.to_decode_params(cfg, params, TP)
    if wdt is not None:
        dp = dcp.quantize_decode_weights(dp, wdt)
    state = {k: jnp.asarray(rec[f"{case}/pool/{k}"].view(
                 jnp.bfloat16 if pdt == jnp.bfloat16 else jnp.float8_e4m3fn))
             for k in ("k_pool", "v_pool")}
    step = dcp.make_serve_step(cfg, d, mesh, dp, state, tbl, donate=False)
    state, toks, logits = step(dp, state, tbl)
    out[f"{case}/logits"] = np.asarray(logits, np.float32)
    out[f"{case}/tokens"] = np.asarray(toks)
np.savez(sys.argv[2], **out)
"""
I_, TP_ = 2, 4
# bf16 weights and activations: XLA's CPU step and the port's round in
# other places (XLA folds the logits' cast to float32 into the head's
# product; the port rounds them to bf16 first), and a one-ulp change
# anywhere moves the logits of a random-weight stack by a few ulps.
# Measured max|d| / max|ref|: bf16 weights 0.0145, fp8 weights 0.0129,
# raw fp8 pools 0.0139; held to bf16's 2e-2, as the card's twins are.
STEP_TOL = 2e-2


@pytest.fixture(scope="module")
def fp8_steps(tmp_path_factory):
    """One decode step of reduced TinyLlama at (I 2, TP 4), from the same
    tables and seeded pools, in both packages: with fp8 decode weights on
    bf16 pools, and with bf16 weights on raw fp8 pools (no scales)."""
    _, _, cfg, params = _fp8_models()
    _, khs, ps = dcp.attn_tp_geometry(cfg, TP_)
    cluster = ClusterState(num_instances=I_, instances_per_node=I_,
                           kv_capacity_tokens=1024, page_size=16,
                           kv_stripes=ps)
    sched = DualBalancedScheduler(
        buckets=CPBuckets(edges=(100,), degrees=(1, 2)), has_kv=True)
    for r, L in {0: 50, 1: 300, 2: 130}.items():
        cluster.enqueue(Request(rid=r, prompt_len=L, max_new_tokens=4))
    plan = sched.schedule(cluster)
    tbl = routing.lower_plan(
        cluster, plan, buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                            s_buckets=(0, 1, 2, 4), window=I_),
        append_tokens=True, next_tokens={r: 7 + r for r in cluster.active})
    nf = cluster.page_table.frames_per_instance + 1
    d = dcp.DecodeDims(M=tbl.M, S=tbl.S, N=tbl.N, MB=tbl.MB, MBT=tbl.MBT,
                       W=I_, num_frames=nf, page=16, data_size=I_, tp=TP_)
    assert d.num_rounds > 0
    rec = {"meta": np.array([I_, TP_, nf, 16, d.M, d.S, d.N, d.MB, d.MBT]),
           "over_keys": np.array(list(FP8_OVER)),
           "over_vals": np.array(list(FP8_OVER.values()))}
    rec.update({f"tbl/{k}": v.astype(np.int32)
                for k, v in cells.table_arrays(tbl).items()})
    rng = np.random.default_rng(1)
    port = {}
    for case, wdt, pdt in (("bf16w", None, torch.bfloat16),
                           ("fp8w", torch.float8_e4m3fn, torch.bfloat16),
                           ("rawpool", None, torch.float8_e4m3fn)):
        state = dcp.init_serve_state(cfg, d, I_, dtype=pdt, device="cpu")
        for k in ("k_pool", "v_pool"):
            vals = torch.from_numpy(rng.standard_normal(state[k].shape,
                                                        dtype=np.float32))
            state[k].copy_(vals.to(pdt))
            rec[f"{case}/pool/{k}"] = state[k].view(torch.uint8).numpy().copy()
        dp = dcp.to_decode_params(cfg, params, TP_)
        if wdt is not None:
            dp = dcp.quantize_decode_weights(dp, wdt)
        _, toks, logits = dcp.build_decode_step(cfg, d)(
            dp, state,
            routing.as_device_arrays(tbl, routing.DeviceTables("cpu")))
        port[case] = (logits.numpy(), toks.numpy())
    f_in = tmp_path_factory.mktemp("fp8") / "port.npz"
    f_out = f_in.with_name("jax.npz")
    np.savez(f_in, **rec)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={I_ * TP_}",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run([sys.executable, "-c", _JAX_STEP, str(f_in),
                           str(f_out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return port, dict(np.load(f_out)), tbl


@pytest.mark.parametrize("case", ["bf16w", "fp8w", "rawpool"])
def test_fp8_weight_and_raw_pool_steps_match_jax(fp8_steps, case):
    """The port's DCP step with bf16 weights (the baseline), with fp8
    decode weights (cast to bf16 at use), and with raw fp8 pools read with
    a unit scale, against JAX's step on the same tables, pools and
    weights: logits within STEP_TOL x max|ref|, the same greedy tokens for
    the active slots but where JAX's top-2 gap is under that bound."""
    port, jout, tbl = fp8_steps
    lg, toks = port[case]
    jl = jout[f"{case}/logits"]
    assert np.abs(lg - jl).max() <= STEP_TOL * np.abs(jl).max()
    act = tbl.slot_active != 0
    top2 = np.sort(jl, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < STEP_TOL * np.abs(jl).max()
    differ = act & (toks != jout[f"{case}/tokens"])
    assert not (differ & ~tie).any()


def test_fp8_weights_cast_at_use_only():
    """The step on fp8 weights equals the step on the same weights cast to
    bf16 before it, bit for bit (CPU): the cast is the only difference."""
    _, _, cfg, params = _fp8_models()
    cl, tbl, d = cells.plan_decode_cell(
        cfg, configs.ShapeCfg("d", "decode", 2048, 8), num_instances=4,
        tp=2, instances_per_node=4, page=16)
    q = dcp.quantize_decode_weights(dcp.to_decode_params(cfg, params, 2))
    deq = jax.tree.map(lambda t: t.to(torch.bfloat16)
                       if t.dtype == torch.float8_e4m3fn else t, q)
    state = dcp.init_serve_state(cfg, d, 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    for k in ("k_pool", "v_pool"):
        state[k].copy_(torch.randn(state[k].shape, generator=g))
    tables = routing.as_device_arrays(tbl, routing.DeviceTables("cpu"))
    step = dcp.build_decode_step(cfg, d)
    a = step(q, {k: v.clone() for k, v in state.items()}, tables)[2]
    b = step(deq, {k: v.clone() for k, v in state.items()}, tables)[2]
    assert torch.equal(a, b)


def test_raw_code_pages_read_with_a_unit_scale():
    """The plain paged version on fp8 / int8 pages without scales equals
    itself with all-one scales, and the reference's plain version on the
    same raw pages."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((6, 8, 16)).astype(np.float32)
    kv = rng.standard_normal((10, 16, 2, 16)).astype(np.float32)
    bt = rng.integers(0, 10, (6, 3)).astype(np.int32)
    ln = np.array([48, 0, 17, 33, 1, 40], np.int32)
    ones = torch.ones(10)
    for dt, jdt in ((torch.float8_e4m3fn, jnp.float8_e4m3fn),
                    (torch.int8, jnp.int8)):
        k = torch.from_numpy(kv * (4 if dt == torch.int8 else 1)).to(dt)
        v = torch.from_numpy(-kv * (4 if dt == torch.int8 else 1)).to(dt)
        args = (torch.from_numpy(q), k, v, torch.from_numpy(bt),
                torch.from_numpy(ln))
        o, l = ref.paged_decode_attention(*args)
        o1, l1 = ref.paged_decode_attention(*args, k_scale=ones, v_scale=ones)
        assert torch.equal(o, o1) and torch.equal(l, l1)
        jo, jl = jref.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k.float().numpy()).astype(jdt),
            jnp.asarray(v.float().numpy()).astype(jdt), jnp.asarray(bt),
            jnp.asarray(ln))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------- #
# the chunked-prefill cell (port of tests/test_handoff.py's)
# --------------------------------------------------------------------------- #
def test_chunked_prefill_cell_bounds_output_to_chunk():
    """``build_chunked_prefill_cell``: the worst-case chunk step's KV
    output is bounded by ``chunk_tokens`` (the layer-batched tail slab),
    the ladder covers the prompt in page-aligned chunks; the step runs on
    meta and on CPU tensors, and on the JAX init's weights its output
    equals the reference cell's within 2e-2 x max|ref| (bf16 weights)."""
    jcfg = jconfigs.reduced(jconfigs.CONFIGS["tinyllama-1.1b"], vocab_size=128)
    cfg = configs.reduced(configs.CONFIGS["tinyllama-1.1b"], vocab_size=128)
    shape = configs.ShapeCfg("prefill_tiny", "prefill", seq_len=320,
                             global_batch=1)
    cell = cells.build_chunked_prefill_cell(cfg, shape,
                                            mesh.make_test_mesh(1, 1),
                                            chunk_tokens=cells.PAGE * 2)
    assert cell.kind == "chunked_prefill"
    C = cell.meta["chunk_tokens"]
    assert C == cells.PAGE * 2
    assert cell.meta["chunk_ends"][-1] == 320
    assert cell.meta["num_chunks"] == -(-320 // C)
    for a, b in zip(cell.meta["chunk_ends"], cell.meta["chunk_ends"][1:]):
        assert b - a <= C and a % cells.PAGE == 0
    out, _ = dryrun.run_meta(cell.fn, cell.args)
    assert out["chunk_k"].shape[3] == C          # [na, nb, B, C, H, hd]
    assert out["chunk_v"].shape[3] == C
    assert out["last_logits"].shape == (1, cfg.vocab_size)
    # runnable: the worst-case chunk on CPU tensors, against the reference
    jcell = jcells.build_chunked_prefill_cell(
        jcfg, jconfigs.ShapeCfg("prefill_tiny", "prefill", 320, 1),
        jmesh.make_test_mesh(1, 1), chunk_tokens=jcells.PAGE * 2)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(0, 128, (1, 320)).astype(np.int32)
    jout = jcell.fn(jparams, {"tokens": jnp.asarray(toks)})
    got = cell.fn(P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu"),
                  {"tokens": torch.from_numpy(toks)})
    for k in ("last_logits", "chunk_k", "chunk_v"):
        want = np.asarray(jout[k], np.float32)
        have = got[k].float().numpy()
        assert have.shape == want.shape, k
        assert np.abs(have - want).max() <= 2e-2 * np.abs(want).max(), k
