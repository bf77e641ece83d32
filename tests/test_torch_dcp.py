"""The port's DCP decode step on its virtual mesh, held against the JAX
package (a port of tests/integration/dcp_equivalence.py for the dense GQA,
MLA and MoE archetypes, routed and dense backends, on the CPU).

Weights come from the JAX init (cast to float32) through
``repro_torch.params``; prompts are drawn with numpy.  Per-step tokens must
equal the argmax of JAX ``transformer.forward`` over the same sequence,
and the step logits its logits within a relative 1e-4: checked
teacher-forced, one JAX forward per request over prompt + the port's
transcript, so the reference compiles once per request.  The prefill
scatter must equal the port's numpy loader and
``repro.core.migrate.load_prefill_kv`` bit for bit.

MoE configs run at capacity factor 8.0, as the reference's own MoE tests
do: no token is dropped, so decode (capacity per instance) and prefill
(capacity per request) route alike.  The configs with qkv bias, qk-norm or
DeepSeek-V3's MLA + MoE run with perturbed weights: every bias drawn from
N(0, 0.5) and every norm scale from 1 + N(0, 0.3) before conversion (the
JAX init makes them 0 and 1, where a dropped branch would not show).  At I >= 4 the reference's own MoE DCP
step diverges from its forward (ROADMAP queue 3), so the port is held
against JAX's step only at I = 2.
"""
import os
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core import comm as jcomm, dcp as jdcp, migrate as jmigrate
from repro.models import init_params as jinit, transformer as jtransformer
from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core import comm, dcp, migrate, routing
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.core.scheduler import DualBalancedScheduler
from repro_torch.core.state import ClusterState, Request
from repro_torch.models import transformer

PAGE = 16
PROMPTS = {0: 50, 1: 130, 2: 40, 3: 260, 4: 64}
STEPS = 3
MOE = "phi3.5-moe-42b-a6.6b"
STEP_LOGIT_RTOL = 1e-4
# configs whose weights are perturbed before conversion (module note)
PERTURBED = ("qwen1.5-0.5b", "llama4-scout-17b-a16e", "deepseek-v3")


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


def _models(kv=None, arch="tinyllama-1.1b"):
    over = {} if kv is None else {"num_kv_heads": kv}
    if JCONFIGS[arch].is_moe:
        over["capacity_factor"] = 8.0
    jcfg = jreduced(JCONFIGS[arch], vocab_size=256, **over)
    cfg = reduced(CONFIGS[arch], vocab_size=256, **over)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jinit(jax.random.PRNGKey(0), jcfg))
    if arch in PERTURBED:
        jparams = jax.tree.map(jnp.asarray,
                               perturb(jax.tree.map(np.asarray, jparams)))
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _kv_layers(caches):
    """Per attention layer (k [len, Hkv, hd], v) — MLA: (c_kv [len, kvr],
    k_rope [len, dr]) — numpy, block-major."""
    k, v = caches[0]["kv"]
    return [(k[b, 0].numpy(), v[b, 0].numpy()) for b in range(k.shape[0])]


def _scatter_prefill(cfg, scatter, state, caches, coords, khs):
    """One request's prefill KV through ``PrefillScatter`` as the engine
    hands it over: [nb, 1, T, khs, kg*hd] k and v, or MLA's latent
    [nb, 1, T, 1, kvr + dr] alone."""
    a = caches[0]["kv"][0][:, 0][:, None]
    b = caches[0]["kv"][1][:, 0][:, None]
    if cfg.is_mla:
        return scatter.scatter_kv(state, torch.cat([a, b], -1)[..., None, :],
                                  None, coords)
    return scatter.scatter_kv(state, a.reshape(*a.shape[:3], khs, -1),
                              b.reshape(*b.shape[:3], khs, -1), coords)


def _apply_moves(reshard, state, records):
    """The live KV re-shard of a plan's escalation/relaxation records."""
    if records:
        reshard(state, np.concatenate([e.src_coords for e in records], axis=1),
                np.concatenate([e.dst_coords for e in records], axis=1))


@pytest.mark.parametrize(
    "I,TP,kv,arch,backend",
    [(4, 2, None, "tinyllama-1.1b", "routed"),
     (2, 4, None, "tinyllama-1.1b", "routed"),
     (2, 2, 4, "tinyllama-1.1b", "routed"),
     (4, 2, None, "minicpm3-4b", "routed"),
     (2, 4, None, "minicpm3-4b", "routed"),
     (4, 2, None, "tinyllama-1.1b", "dense"),
     (2, 4, None, "minicpm3-4b", "dense"),
     (4, 2, None, MOE, "routed"),
     (2, 4, None, MOE, "routed"),
     (4, 2, None, "qwen1.5-0.5b", "routed"),
     (4, 2, None, "llama4-scout-17b-a16e", "routed"),
     (2, 4, None, "deepseek-v3", "routed"),
     (8, 1, None, "tinyllama-1.1b", "routed")],
    ids=["4x2", "2x4-striped", "2x2-kv4-grouped", "minicpm3-4x2",
         "minicpm3-2x4", "4x2-dense", "minicpm3-2x4-dense", "phi3.5-moe-4x2",
         "phi3.5-moe-2x4", "qwen1.5-4x2", "llama4-scout-4x2",
         "deepseek-v3-2x4", "8x1-wide-ring"])
def test_dcp_decode_equals_reference(I, TP, kv, arch, backend):
    jcfg, jparams, cfg, params = _models(kv, arch)
    _, khs, ps = dcp.attn_tp_geometry(cfg, TP)
    if cfg.is_mla:
        assert (khs, ps) == (1, TP)          # the latent stripes over all tp
    elif (I, TP) == (2, 4):
        assert ps == 2                       # page striping is exercised
    if kv == 4:
        assert dcp.kv_group_size(cfg, TP) == 2   # head grouping is exercised
    cluster = ClusterState(num_instances=I, instances_per_node=I,
                           kv_capacity_tokens=2048, page_size=PAGE,
                           kv_stripes=ps)
    sched = DualBalancedScheduler(buckets=CPBuckets(edges=(100, 256),
                                                    degrees=(1, 2, 3)),
                                  has_kv=True)
    rng = np.random.default_rng(0)
    prompt_tokens = {r: rng.integers(0, cfg.vocab_size, (L,))
                     for r, L in PROMPTS.items()}
    for r, L in PROMPTS.items():
        cluster.enqueue(Request(rid=r, prompt_len=L, max_new_tokens=STEPS))
    plan = sched.schedule(cluster)
    assert len(plan.admitted) == len(PROMPTS)

    dims0 = dcp.DecodeDims(M=2, S=2, N=2 + 3 * 2, MB=0, W=I,
                           num_frames=cluster.page_table.frames_per_instance + 1,
                           page=PAGE, data_size=I, tp=TP, backend=backend)
    state = dcp.init_serve_state(cfg, dims0, I, dtype=torch.float32,
                                 device="cpu")
    state_np = {k: np.zeros(v.shape, np.float32) for k, v in state.items()}
    state_jax_loader = {k: np.zeros(v.shape, np.float32) for k, v in state.items()}
    jdims0 = jdcp.DecodeDims(M=2, S=2, N=8, MB=0, W=I,
                             num_frames=dims0.num_frames, page=PAGE,
                             data_size=I, tp=TP)
    scatter = migrate.PrefillScatter(cfg, dims0, I)

    gen = {}
    for r, toks in prompt_tokens.items():
        logits, caches = transformer.forward(cfg, params,
                                             torch.as_tensor(toks)[None],
                                             collect_kv=True, device="cpu")
        gen[r] = [int(logits[0, -1].argmax())]
        kv_layers = _kv_layers(caches)
        migrate.load_prefill_kv(cfg, cluster, dims0, state_np, r, kv_layers)
        jmigrate.load_prefill_kv(jcfg, cluster, jdims0, state_jax_loader, r,
                                 kv_layers)
        _scatter_prefill(cfg, scatter, state, caches,
                         migrate.prefill_coords(cluster, r, PAGE, ps), khs)
    for name in state:
        np.testing.assert_array_equal(state[name].numpy(), state_np[name])
        np.testing.assert_array_equal(state_np[name], state_jax_loader[name])

    dparams = dcp.to_decode_params(cfg, params, TP)
    dev_tables = routing.DeviceTables("cpu")
    shape_buckets = ShapeBuckets(m_buckets=(1, 2, 4, 8),
                                 s_buckets=(0, 1, 2, 4, 8), window=I)
    next_tok = {r: g[0] for r, g in gen.items()}
    step_logits = {r: [] for r in PROMPTS}
    reshard = migrate.KVReshard(scatter)
    for _ in range(STEPS):
        plan = sched.schedule(cluster)
        # the plan's relaxations already moved pages in the page table: move
        # their KV too, as the engine does
        _apply_moves(reshard, state, plan.escalations + plan.relaxations)
        tbl = routing.lower_plan(cluster, plan, buckets=shape_buckets,
                                 append_tokens=True, next_tokens=next_tok)
        d = dcp.DecodeDims(M=tbl.M, S=tbl.S, N=tbl.N, MB=tbl.MB, MBT=tbl.MBT,
                           W=I, num_frames=dims0.num_frames, page=PAGE,
                           data_size=I, tp=TP, backend=backend)
        assert d.num_rounds > 0              # both backends route q rows
        state, toks, logits = dcp.build_decode_step(cfg, d)(
            dparams, state, routing.as_device_arrays(tbl, dev_tables))
        for r in PROMPTS:
            i, b = cluster.slot_map[r]
            gen[r].append(int(toks[i, b]))
            step_logits[r].append(logits[i, b].numpy())
            next_tok[r] = gen[r][-1]
        for r in list(cluster.active):
            cluster.active[r].generated += 1

    # teacher-forced reference: one JAX forward per request
    for r, toks in prompt_tokens.items():
        seq = np.concatenate([toks, gen[r][:-1]])
        ref_logits, _ = jtransformer.forward(jcfg, jparams,
                                             jnp.asarray(seq)[None, :])
        ref = np.asarray(ref_logits[0, len(toks) - 1:]).argmax(-1)
        assert ref.tolist() == gen[r], (I, TP, kv, r, ref.tolist(), gen[r])
        want = np.asarray(ref_logits[0, len(toks):])
        err = np.abs(np.stack(step_logits[r]) - want).max()
        assert err <= STEP_LOGIT_RTOL * np.abs(want).max(), (r, err)


# --------------------------------------------------------------------------- #
# quantized pools: the port's step against JAX's on the same inputs
# --------------------------------------------------------------------------- #
# Both steps start from the same quantized pools, so their logits differ only
# by float32 rounding and, where an appended value's code falls the other way,
# one quantization step of that value.  Worst |dlogit| seen here: 3.6e-6
# (fp8) and 3.3e-3 (int8, one flipped code), on logits of std 1.0.  Swapping
# k_scale and v_scale at the kernel call moves them by 2.3-2.4, flattening
# the scales in (tp, I, F') order instead of the pools' (I, tp, F') by 4.6.
STEP_LOGIT_TOL = 1e-2
QUANT_STEPS = 3


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy().copy()


def _port_run(kv_dtype: str, I: int, TP: int, arch: str) -> dict:
    """The port's prefill, scatter (quantized for fp8/int8, float32 pools
    for "bf16") and QUANT_STEPS decode steps; records each step's tables,
    the state before and after it (pools as raw bytes) and its logits."""
    _, jparams, cfg, params = _models(arch=arch)
    _, khs, ps = dcp.attn_tp_geometry(cfg, TP)
    cluster = ClusterState(num_instances=I, instances_per_node=I,
                           kv_capacity_tokens=2048, page_size=PAGE,
                           kv_stripes=ps)
    sched = DualBalancedScheduler(buckets=CPBuckets(edges=(100, 256),
                                                    degrees=(1, 2, 3)),
                                  has_kv=True)
    rng = np.random.default_rng(0)
    for r, L in PROMPTS.items():
        cluster.enqueue(Request(rid=r, prompt_len=L, max_new_tokens=QUANT_STEPS))
    assert len(sched.schedule(cluster).admitted) == len(PROMPTS)
    nf = cluster.page_table.frames_per_instance + 1
    dims0 = dcp.DecodeDims(M=2, S=2, N=8, MB=0, W=I, num_frames=nf,
                           page=PAGE, data_size=I, tp=TP, kv_dtype=kv_dtype)
    state = dcp.init_serve_state(cfg, dims0, I, dtype=torch.float32,
                                 device="cpu")
    scatter = migrate.PrefillScatter(cfg, dims0, I)
    next_tok = {}
    for r, L in PROMPTS.items():
        toks = rng.integers(0, cfg.vocab_size, (L,))
        logits, caches = transformer.forward(cfg, params,
                                             torch.as_tensor(toks)[None],
                                             collect_kv=True, device="cpu")
        next_tok[r] = int(logits[0, -1].argmax())
        _scatter_prefill(cfg, scatter, state, caches,
                         migrate.prefill_coords(cluster, r, PAGE, ps), khs)
    dparams = dcp.to_decode_params(cfg, params, TP)
    dev_tables = routing.DeviceTables("cpu")
    buckets = ShapeBuckets(m_buckets=(1, 2, 4, 8), s_buckets=(0, 1, 2, 4, 8),
                           window=I)
    rec = {"meta": np.array([I, TP, nf, QUANT_STEPS, PAGE]),
           "kv_dtype": np.array(kv_dtype), "arch": np.array(arch)}
    for i, leaf in enumerate(jax.tree.leaves(jparams)):
        rec[f"param/{i}"] = np.asarray(leaf)
    for t in range(QUANT_STEPS):
        plan = sched.schedule(cluster)
        tbl = routing.lower_plan(cluster, plan, buckets=buckets,
                                 append_tokens=True, next_tokens=next_tok)
        d = dcp.DecodeDims(M=tbl.M, S=tbl.S, N=tbl.N, MB=tbl.MB, MBT=tbl.MBT,
                           W=I, num_frames=nf, page=PAGE, data_size=I, tp=TP,
                           kv_dtype=kv_dtype)
        rec[f"{t}/dims"] = np.array([d.M, d.S, d.N, d.MB, d.MBT])
        for f in fields(tbl):
            v = getattr(tbl, f.name)
            if isinstance(v, np.ndarray):
                rec[f"{t}/tbl/{f.name}"] = v.astype(np.int32)
        for k, v in state.items():
            rec[f"{t}/pre/{k}"] = _bytes(v)
        state, toks, logits = dcp.build_decode_step(cfg, d)(
            dparams, state, routing.as_device_arrays(tbl, dev_tables))
        for k, v in state.items():
            rec[f"{t}/post/{k}"] = _bytes(v)
        rec[f"{t}/logits"] = logits.numpy()
        for r in PROMPTS:
            i, b = cluster.slot_map[r]
            next_tok[r] = int(toks[i, b])
        for r in list(cluster.active):
            cluster.active[r].generated += 1
    return rec


# The JAX side, run by ``python -c`` in a process with I*TP host devices:
# JAX's step (``repro.core.dcp``) on each recorded step's pre-state and
# tables, with the JAX params the port's were made from.
_JAX_STEPS = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import CONFIGS, reduced
from repro.core import dcp
from repro.models import init_params

rec = dict(np.load(sys.argv[1]))
I, TP, nf, steps, page = (int(x) for x in rec["meta"])
kv_dtype = str(rec["kv_dtype"])
base = CONFIGS[str(rec["arch"])]
cfg = reduced(base, vocab_size=256,
              **({"capacity_factor": 8.0} if base.is_moe else {}))
keys = [k[len("0/pre/"):] for k in rec if k.startswith("0/pre/")]
tree = jax.tree.structure(jax.eval_shape(
    lambda: init_params(jax.random.PRNGKey(0), cfg)))
params = jax.tree.unflatten(tree, [jnp.asarray(rec[f"param/{i}"])
                                   for i in range(tree.num_leaves)])
code_dt = {"fp8": jnp.float8_e4m3fn, "int8": np.int8}.get(kv_dtype,
                                                          np.float32)
mesh = compat.make_mesh((I, TP), ("data", "model"))
dparams = jax.jit(lambda p: dcp.to_decode_params(cfg, p, TP))(params)
out, fns = {}, {}
for t in range(steps):
    key = tuple(int(x) for x in rec[f"{t}/dims"])
    M, S, N, MB, MBT = key
    d = dcp.DecodeDims(M=M, S=S, N=N, MB=MB, MBT=MBT, W=I, num_frames=nf,
                       page=page, data_size=I, tp=TP, kv_dtype=kv_dtype)
    state = {k: jnp.asarray(rec[f"{t}/pre/{k}"].view(
                 code_dt if "pool" in k else np.float32))
             for k in keys}
    tbl = {k.split("/")[-1]: jnp.asarray(v) for k, v in rec.items()
           if k.startswith(f"{t}/tbl/")}
    if key not in fns:
        fns[key] = dcp.make_serve_step(cfg, d, mesh, dparams, state, tbl,
                                       donate=False)
    state, _, logits = fns[key](dparams, state, tbl)
    for k, v in state.items():
        out[f"{t}/post/{k}"] = np.ascontiguousarray(np.asarray(v)).view(np.uint8)
    out[f"{t}/logits"] = np.asarray(logits, np.float32)
np.savez(sys.argv[2], **out)
"""


def _jax_steps(rec: dict, tmp_path) -> dict:
    """Run ``_JAX_STEPS`` on a ``_port_run`` record in a subprocess with 8
    forced host devices; returns its outputs."""
    f_in, f_out = tmp_path / "port.npz", tmp_path / "jax.npz"
    np.savez(f_in, **rec)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run([sys.executable, "-c", _JAX_STEPS, str(f_in),
                           str(f_out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(f_out))


def test_dcp_moe_step_matches_jax_step(tmp_path):
    """Reduced phi3.5-moe at (2, 4), where the reference's own MoE DCP step
    equals its forward: from the same float32 pools and tables, every
    step's logits agree with JAX's step within a relative 1e-5, and so do
    the pools it wrote (scratch frames excepted)."""
    rec = _port_run("bf16", 2, 4, MOE)
    jout = _jax_steps(rec, tmp_path)
    for t in range(QUANT_STEPS):
        lg_p, lg_j = rec[f"{t}/logits"], jout[f"{t}/logits"]
        assert np.abs(lg_p - lg_j).max() <= 1e-5 * np.abs(lg_j).max(), t
        for kind in ("k", "v"):
            pp = rec[f"{t}/post/{kind}_pool"].view(np.float32)
            pj = jout[f"{t}/post/{kind}_pool"].view(np.float32)
            np.testing.assert_allclose(pp.reshape(pj.shape)[..., :-1, :, :],
                                       pj[..., :-1, :, :], rtol=1e-5,
                                       atol=1e-5)


def _code_step(codes: np.ndarray, kv_dtype: str) -> np.ndarray:
    """One quantization step at each code's magnitude (the spacing of
    int8, or of fp8 e4m3 with its 3 mantissa bits and subnormals below
    2**-6)."""
    if kv_dtype == "int8":
        return np.ones_like(codes)
    e = np.floor(np.log2(np.maximum(np.abs(codes), 2.0 ** -6)))
    return 2.0 ** (e - 3)


@pytest.mark.parametrize("kv_dtype,I,TP,arch",
                         [("fp8", 4, 2, "tinyllama-1.1b"),
                          ("int8", 2, 2, "tinyllama-1.1b"),
                          ("fp8", 2, 4, "minicpm3-4b"),
                          ("fp8", 2, 4, MOE)],
                         ids=["fp8-4x2", "int8-2x2", "fp8-minicpm3-2x4",
                              "fp8-phi3.5-moe-2x4"])
def test_dcp_quantized_step_matches_jax(kv_dtype, I, TP, arch, tmp_path):
    """Both steps from the same quantized pools and tables, every step:

      * scales bit-equal, except a page an offset-0 append set from this
        token's KV, whose float32 projection the two frameworks round
        differently: there within a relative 1e-5;
      * pool codes bit-equal except at this step's appends, and every
        dequantized value within one quantization step at its magnitude
        (plus a relative 1e-5 for the scale);
      * logits within ``STEP_LOGIT_TOL`` (1e-2), far inside the lossy
        serving bound: the same quantized inputs give the same attention.

    The JAX step needs I*TP devices, so it runs in a subprocess with forced
    host devices.  Scratch frames (last of each sub-pool) take repeated
    writes in either order and are not compared.  MLA's one latent pool
    and its ``kv_scale`` are striped over every tp device."""
    rec = _port_run(kv_dtype, I, TP, arch)
    cfg = reduced(CONFIGS[arch], vocab_size=256)
    _, khs, ps = dcp.attn_tp_geometry(cfg, TP)
    kinds = ("kv",) if cfg.is_mla else ("k", "v")
    jout = _jax_steps(rec, tmp_path)
    code_dt = torch.float8_e4m3fn if kv_dtype == "fp8" else torch.int8
    for t in range(QUANT_STEPS):
        lg_p, lg_j = rec[f"{t}/logits"], jout[f"{t}/logits"]
        assert np.max(np.abs(lg_p - lg_j)) <= STEP_LOGIT_TOL, t
        act = rec[f"{t}/tbl/slot_active"] != 0
        af, ao = rec[f"{t}/tbl/append_frame"], rec[f"{t}/tbl/append_off"]
        for kind in kinds:
            sp = rec[f"{t}/post/{kind}_scale"].view(np.float32)[..., :-1]
            sj = jout[f"{t}/post/{kind}_scale"].view(np.float32)[..., :-1]
            fresh = np.zeros(sp.shape[2:], bool)        # [I, tp, F'-1]
            appended = np.zeros(sp.shape[2:] + (PAGE,), bool)
            for i, b in zip(*np.nonzero(act)):
                # the append's sub-pool chunks and local frame
                f, o = af[i, b], ao[i, b]
                for c in (f % ps) * khs + np.arange(khs):
                    appended[i, c, f // ps, o] = True
                    fresh[i, c, f // ps] |= o == 0
            same = sp == sj
            assert same[:, :, ~fresh].all(), (t, kind)
            np.testing.assert_allclose(sp, sj, rtol=1e-5, atol=0)
            cp = torch.from_numpy(rec[f"{t}/post/{kind}_pool"]).view(
                code_dt).float().numpy()[..., :-1, :, :]
            cj = torch.from_numpy(jout[f"{t}/post/{kind}_pool"]).view(
                code_dt).float().numpy()[..., :-1, :, :]
            assert (cp == cj)[:, :, ~appended].all(), (t, kind)
            dp, dj = cp * sp[..., None, None], cj * sj[..., None, None]
            step = np.maximum(_code_step(cp, kv_dtype), _code_step(cj, kv_dtype))
            bound = (step * np.maximum(sp, sj)[..., None, None]
                     + 1e-5 * np.abs(dj))
            assert (np.abs(dp - dj) <= bound).all(), (t, kind)


# --------------------------------------------------------------------------- #
# comm on the virtual mesh
# --------------------------------------------------------------------------- #
def test_comm_ring_schedule_matches_reference():
    for r in range(0, 16):
        assert comm.ring_delta(r) == jcomm.ring_delta(r)
    for size in range(1, 10):
        for off in range(-size, 2 * size):
            assert comm.ring_round(off, size) == jcomm.ring_round(off, size)
        assert comm.node_local_rounds(size) == jcomm.node_local_rounds(size)
        for node in (d for d in range(1, size + 1) if size % d == 0):
            for delta in range(-3, 4):
                assert (comm.node_rotation_pairs(size, node, delta)
                        == jcomm.node_rotation_pairs(size, node, delta))


@pytest.mark.parametrize("I,node", [(4, 4), (8, 4), (6, 2)])
def test_rotate_delivers_what_the_ppermute_pairs_send(I, node):
    """``rotate`` (the port's ppermute) hands receiver b the buffer of the
    sender that ``node_rotation_pairs`` pairs with b, for every delta."""
    buf = torch.arange(I * 3 * 2, dtype=torch.float32).reshape(I, 3, 2)
    for delta in (-2, -1, 1, 2, 3):
        got = comm.rotate(buf, delta, node)
        want = torch.empty_like(buf)
        for a, b in comm.node_rotation_pairs(I, node, delta):
            want[b] = buf[a]
        assert torch.equal(got, want), (delta, got, want)


def test_gather_rows_matches_reference_per_device():
    """The batched row gather equals the reference's per-device gather
    (-1 entries give zero rows) on every (instance, tp) device."""
    rng = np.random.default_rng(7)
    I, tp, R, S = 3, 2, 5, 4
    pool = rng.standard_normal((I, tp, R, 2, 3)).astype(np.float32)
    idx = rng.integers(-1, R, (I, S)).astype(np.int32)
    got = comm.gather_rows(torch.from_numpy(pool), torch.from_numpy(idx))
    assert got.shape == (I, tp, S, 2, 3)
    for i in range(I):
        for j in range(tp):
            want = jcomm.gather_rows(jnp.asarray(pool[i, j]),
                                     jnp.asarray(idx[i]))
            np.testing.assert_array_equal(got[i, j].numpy(), np.asarray(want))
