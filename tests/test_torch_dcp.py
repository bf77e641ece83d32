"""The port's DCP decode step on its virtual mesh, held against the JAX
package (a port of tests/integration/dcp_equivalence.py for the dense GQA
archetype, on the CPU).

Weights come from the JAX init (cast to float32) through
``repro_torch.params``; prompts are drawn with numpy.  Per-step tokens must
equal the argmax of JAX ``transformer.forward`` over the same sequence:
checked teacher-forced, one JAX forward per request over prompt + the
port's transcript, so the reference compiles once per request.  The
prefill scatter must equal the port's numpy loader and
``repro.core.migrate.load_prefill_kv`` bit for bit.
"""
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


def _models(kv=None):
    over = {} if kv is None else {"num_kv_heads": kv}
    jcfg = jreduced(JCONFIGS["tinyllama-1.1b"], vocab_size=256, **over)
    cfg = reduced(CONFIGS["tinyllama-1.1b"], vocab_size=256, **over)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jinit(jax.random.PRNGKey(0), jcfg))
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _kv_layers(caches):
    """Per attention layer (k [len, Hkv, hd], v) numpy, block-major."""
    k, v = caches[0]["kv"]
    return [(k[b, 0].numpy(), v[b, 0].numpy()) for b in range(k.shape[0])]


@pytest.mark.parametrize("I,TP,kv", [(4, 2, None), (2, 4, None), (2, 2, 4)],
                         ids=["4x2", "2x4-striped", "2x2-kv4-grouped"])
def test_dcp_decode_equals_reference(I, TP, kv):
    jcfg, jparams, cfg, params = _models(kv)
    _, khs, ps = dcp.attn_tp_geometry(cfg, TP)
    if (I, TP) == (2, 4):
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
                           page=PAGE, data_size=I, tp=TP)
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
        k3 = caches[0]["kv"][0][:, 0][:, None]           # [nb, 1, T, Hkv, hd]
        v3 = caches[0]["kv"][1][:, 0][:, None]
        scatter.scatter_kv(state, k3.reshape(*k3.shape[:3], khs, -1),
                           v3.reshape(*v3.shape[:3], khs, -1),
                           migrate.prefill_coords(cluster, r, PAGE, ps))
    for name in state:
        np.testing.assert_array_equal(state[name].numpy(), state_np[name])
        np.testing.assert_array_equal(state_np[name], state_jax_loader[name])

    dparams = dcp.to_decode_params(cfg, params, TP)
    dev_tables = routing.DeviceTables("cpu")
    shape_buckets = ShapeBuckets(m_buckets=(1, 2, 4, 8),
                                 s_buckets=(0, 1, 2, 4, 8), window=I)
    next_tok = {r: g[0] for r, g in gen.items()}
    for _ in range(STEPS):
        plan = sched.schedule(cluster)
        tbl = routing.lower_plan(cluster, plan, buckets=shape_buckets,
                                 append_tokens=True, next_tokens=next_tok)
        d = dcp.DecodeDims(M=tbl.M, S=tbl.S, N=tbl.N, MB=tbl.MB, MBT=tbl.MBT,
                           W=I, num_frames=dims0.num_frames, page=PAGE,
                           data_size=I, tp=TP)
        state, toks, _ = dcp.build_decode_step(cfg, d)(
            dparams, state, routing.as_device_arrays(tbl, dev_tables))
        for r in PROMPTS:
            i, b = cluster.slot_map[r]
            gen[r].append(int(toks[i, b]))
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
