"""Encoder-decoder (whisper) serving in the port, held against the JAX
package on the CPU: the gelu MLP, layernorm, ``models/encdec.py``
(``encode``, ``decode_forward`` and its caches), the init tree, the
in-place cross/self KV scatters against the numpy loaders, the DCP decode
step over the read-only cross pools at (4, 2) and (2, 4) (the requests of
tests/integration/whisper_equivalence.py, with the scheduler built as the
engine builds it), and the engine on the reference's two whisper
conformance cells (tests/integration/engine_conformance.py).

Reduced whisper (2 encoder + 2 decoder layers, d_model 64, 4 heads of 16
over 2 kv heads, vocab 256) in float32.  The JAX init makes every bias 0
and every layernorm scale 1, where a dropped branch would not show, so the
numpy leaves are perturbed before conversion: every q/k/v bias, ``bi``,
``bo`` and layernorm bias from N(0, 0.5), every layernorm scale from
1 + N(0, 0.3).  Transcripts are checked teacher-forced against JAX's
``decode_forward`` (one forward per request over prefix + transcript).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core import dcp as jdcp, migrate as jmigrate
from repro.models import encdec as jencdec, init_params as jinit
from repro.models import layers as jlayers
from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core import dcp, migrate, routing
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.core.scheduler import DualBalancedScheduler
from repro_torch.core.state import ClusterState, Request
from repro_torch.models import encdec, layers
from repro_torch.models import init_params as init_any
from repro_torch.serving.engine import NanoCPEngine

ARCH = "whisper-base"
VOCAB = 256
TOL = 1e-5
STEP_LOGIT_RTOL = 1e-4
PAGE = 16


def perturb(np_tree, seed: int = 0):
    """Every bias from N(0, 0.5), every layernorm scale from 1 + N(0, 0.3)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", None)
        if name in ("bq", "bk", "bv", "bi", "bo", "bias"):
            return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.3, x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, np_tree)


@functools.cache
def _models():
    """(jcfg, jparams, cfg, params): reduced whisper, perturbed, float32."""
    jcfg = jreduced(JCONFIGS[ARCH], vocab_size=VOCAB)
    cfg = reduced(CONFIGS[ARCH], vocab_size=VOCAB)
    np_tree = perturb(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                   jinit(jax.random.PRNGKey(0), jcfg)))
    return (jcfg, jax.tree.map(jnp.asarray, np_tree), cfg,
            P.from_jax(np_tree, device="cpu"))


@functools.cache
def _jax_encode():
    jcfg = _models()[0]
    return jax.jit(lambda p, f: jencdec.encode(jcfg, p, f))


@functools.cache
def _jax_decode():
    jcfg = _models()[0]
    return jax.jit(lambda p, t, e: jencdec.decode_forward(jcfg, p, t, e)[0])


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _jax_teacher_forced(frames, prefix, transcript):
    """JAX's logits at every generated position [len(transcript), Vp],
    teacher-forced on ``transcript``."""
    _, jparams, _, _ = _models()
    enc = _jax_encode()(jparams, jnp.asarray(frames)[None])
    seq = np.concatenate([np.asarray(prefix), np.asarray(transcript[:-1],
                                                         np.int64)])
    logits = _jax_decode()(jparams, jnp.asarray(seq)[None], enc)
    return np.asarray(logits[0, len(prefix) - 1:])


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def test_init_tree_matches_jax():
    """The port's own init (and the ``models.init_params`` dispatch) builds
    the reference's tree: the same keys and leaf shapes, ``pos_dec`` over
    the decoder's learned positions, tied embeddings (an empty head)."""
    _, jparams, cfg, _ = _models()
    params = init_any(cfg, seed=0, device="cpu", dtype=torch.float32)
    paths = lambda tree: {jax.tree_util.keystr(p): tuple(x.shape) for p, x
                          in jax.tree_util.tree_leaves_with_path(tree)}
    assert paths(params) == paths(jparams)
    assert params["embed"]["pos_dec"].shape == (cfg.max_target_positions,
                                                cfg.d_model)
    assert params["head"] == {}
    assert params["dec_blocks"]["mlp"]["bi"].dtype == torch.float32


def test_gelu_mlp_and_layernorm_match_jax():
    """The tanh-gelu MLP with its biases and the layernorm with its bias,
    on decoder layer 0's perturbed weights."""
    jcfg, jparams, cfg, params = _models()
    x = np.random.default_rng(1).standard_normal((2, 7, cfg.d_model)).astype(
        np.float32)
    jl = jax.tree.map(lambda t: t[0], jparams["dec_blocks"])
    pl = {k: {n: t[0] for n, t in v.items()}
          for k, v in params["dec_blocks"].items()
          if k in ("mlp", "ln2")}
    _close(layers.apply_mlp(cfg, pl["mlp"], torch.from_numpy(x)),
           jlayers.apply_mlp(jcfg, jl["mlp"], jnp.asarray(x)))
    _close(layers.apply_norm(cfg, pl["ln2"], torch.from_numpy(x)),
           jlayers.apply_norm(jcfg, jl["ln2"], jnp.asarray(x)))


def test_encode_and_decode_forward_match_jax():
    """``encode`` (non-causal) and ``decode_forward`` with ``collect_kv``:
    logits and the self/cross caches within 1e-5 of JAX's.  The encoder
    batched over two same-shape stacks equals it run on each alone, bit
    for bit, and ``encdec.forward`` gives the same logits."""
    jcfg, jparams, cfg, params = _models()
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, VOCAB, (2, 6))
    enc = encdec.encode(cfg, params, torch.from_numpy(frames))
    jenc = jencdec.encode(jcfg, jparams, jnp.asarray(frames))
    _close(enc, jenc)
    for b in range(2):
        one = encdec.encode(cfg, params, torch.from_numpy(frames[b:b + 1]))
        assert torch.equal(one[0], enc[b])
    logits, caches = encdec.decode_forward(cfg, params, torch.as_tensor(toks),
                                           enc, collect_kv=True)
    jlogits, jcaches = jencdec.decode_forward(jcfg, jparams, jnp.asarray(toks),
                                              jenc, collect_kv=True)
    _close(logits, jlogits)
    assert sorted(caches) == sorted(jcaches) == ["cross_kv", "self_kv"]
    for name in caches:
        for a, b in zip(caches[name], jcaches[name]):
            assert a.shape == b.shape
            _close(a, b)
    full = encdec.forward(cfg, params, frames, toks, device="cpu")
    assert torch.equal(full, logits)


# --------------------------------------------------------------------------- #
# the prefill scatters
# --------------------------------------------------------------------------- #
def test_cross_and_self_scatters_equal_numpy_loaders():
    """``scatter_cross_kv`` / ``scatter_self_kv`` write a batch of
    requests in place, bit-equal to the port's and the reference's numpy
    loaders, at (2, 4): two page stripes per kv-head group, the self
    caches' head groups tiled over them."""
    jcfg, _, cfg, _ = _models()
    I, TP = 2, 4
    _, khs, ps = dcp.attn_tp_geometry(cfg, TP)
    kg = dcp.kv_group_size(cfg, TP)
    assert ps == 2
    cluster = ClusterState(num_instances=I, instances_per_node=I,
                           kv_capacity_tokens=1024, page_size=PAGE,
                           kv_stripes=ps)
    sched = DualBalancedScheduler(buckets=CPBuckets(edges=(64,),
                                                    degrees=(1, 2)),
                                  allow_rebalance=False, allow_escalation=False)
    reqs = {0: (90, 3), 1: (20, 5), 2: (150, 2)}
    for r, (L, t0) in reqs.items():
        cluster.enqueue(Request(rid=r, prompt_len=L, max_new_tokens=4,
                                dec_prefix_len=t0))
    assert len(sched.schedule(cluster).admitted) == len(reqs)
    nf = cluster.page_table.frames_per_instance + 1
    dims = dcp.DecodeDims(M=4, S=0, N=4, MB=4, W=I, num_frames=nf, page=PAGE,
                          data_size=I, tp=TP)
    jdims = jdcp.DecodeDims(M=4, S=0, N=4, MB=4, W=I, num_frames=nf,
                            page=PAGE, data_size=I, tp=TP)
    state = dcp.init_encdec_serve_state(cfg, dims, I, dtype=torch.float32,
                                        device="cpu")
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    state_np = {k: v.numpy().copy() for k, v in state.items()}
    jstate = jax.tree.map(np.array, jdcp.init_encdec_serve_state(
        jcfg, jdims, I, dtype=jnp.float32))
    assert {k: v.shape for k, v in state_np.items()} == \
        {k: v.shape for k, v in jstate.items()}
    sc = migrate.PrefillScatter(cfg, dims, I)
    rng = np.random.default_rng(3)
    hkv, hd, L = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    ck, cv, cc, sk, sv, ss = [], [], [], [], [], []
    for r, (S, t0) in reqs.items():
        cross = [tuple(rng.standard_normal((S, hkv, hd)) for _ in range(2))
                 for _ in range(L)]
        own = [tuple(rng.standard_normal((t0, hkv, hd)) for _ in range(2))
               for _ in range(L)]
        inst, slot = cluster.slot_map[r]
        for mod, cf, dm, st in ((migrate, cfg, dims, state_np),
                                (jmigrate, jcfg, jdims, jstate)):
            mod.load_prefill_cross_kv(cf, cluster, dm, st, r, cross)
            mod.load_prefill_self_kv(cf, dm, st, inst, slot, own)
        as_t = lambda layers_, j: torch.from_numpy(
            np.stack([x[j] for x in layers_])).float()
        ck.append(as_t(cross, 0).reshape(L, S, khs, kg * hd))
        cv.append(as_t(cross, 1).reshape(L, S, khs, kg * hd))
        cc.append(migrate.prefill_coords(cluster, r, PAGE, ps))
        sk.append(as_t(own, 0).reshape(L, t0, khs, -1).repeat(1, 1, ps, 1))
        sv.append(as_t(own, 1).reshape(L, t0, khs, -1).repeat(1, 1, ps, 1))
        ss.append(np.stack([np.full(t0, inst), np.full(t0, slot),
                            np.arange(t0)]))
    assert sc.scatter_cross_kv(state, torch.cat(ck, 1), torch.cat(cv, 1),
                               np.concatenate(cc, 1)) is state
    sc.scatter_self_kv(state, torch.cat(sk, 1), torch.cat(sv, 1),
                       np.concatenate(ss, 1))
    assert {k: v.data_ptr() for k, v in state.items()} == ptrs
    for k in dcp.ENCDEC_STATE:
        assert state_np[k].any()
        np.testing.assert_array_equal(state[k].numpy(), state_np[k])
        np.testing.assert_array_equal(state_np[k], jstate[k])


# --------------------------------------------------------------------------- #
# the DCP decode step (whisper_equivalence.py's requests)
# --------------------------------------------------------------------------- #
# (encoder frames, decoder prefix tokens)
EQUIV_REQS = {0: (80, 3), 1: (300, 5), 2: (150, 2), 3: (48, 4)}
EQUIV_STEPS = 4


@pytest.mark.parametrize("I,TP", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
def test_dcp_step_equals_greedy_jax(I, TP):
    """The hand-driven encdec step over the read-only cross pools, with the
    scheduler the engine builds for whisper (no escalation, hence no
    relaxation; pinned slots, one M bucket of 4): every token equals JAX's
    greedy ``decode_forward`` and every step's logits are within a
    relative 1e-4 of it.  The 300-frame request spreads over CP degree 3
    at (4, 2) (2 at (2, 4)).  No plan moves KV, the relaxation planner
    offers no move even when forced, and the cross pools are bit-equal
    before and after the steps."""
    jcfg, jparams, cfg, params = _models()
    _, khs, ps = dcp.attn_tp_geometry(cfg, TP)
    M = 4
    cluster = ClusterState(num_instances=I, instances_per_node=I,
                           kv_capacity_tokens=2048, page_size=PAGE,
                           kv_stripes=ps)
    sched = DualBalancedScheduler(
        buckets=CPBuckets(edges=(100, 256),
                          degrees=(1, 2, 3) if I >= 3 else (1, 2, 2)),
        allow_rebalance=False, max_batch_per_instance=M, has_kv=True,
        kv_reserve=0, allow_escalation=False)
    rng = np.random.default_rng(0)
    frames = {r: rng.standard_normal((L, cfg.d_model)).astype(np.float32)
              for r, (L, _) in EQUIV_REQS.items()}
    prefix = {r: rng.integers(0, VOCAB, (t0,))
              for r, (_, t0) in EQUIV_REQS.items()}
    for r, (L, t0) in EQUIV_REQS.items():
        cluster.enqueue(Request(rid=r, prompt_len=L,
                                max_new_tokens=EQUIV_STEPS,
                                dec_prefix_len=t0))
    plan = sched.schedule(cluster)
    assert len(plan.admitted) == len(EQUIV_REQS)
    assert max(len(cluster.active[r].kv_binding) for r in EQUIV_REQS) == \
        (3 if I >= 3 else 2)
    nf = cluster.page_table.frames_per_instance + 1
    dims0 = dcp.DecodeDims(M=M, S=0, N=M, MB=4, W=I, num_frames=nf,
                           page=PAGE, data_size=I, tp=TP)
    state = dcp.init_encdec_serve_state(cfg, dims0, I, dtype=torch.float32,
                                        device="cpu")
    sc = migrate.PrefillScatter(cfg, dims0, I)
    gen = {}
    for r in EQUIV_REQS:
        enc = encdec.encode(cfg, params, torch.from_numpy(frames[r])[None])
        logits, caches = encdec.decode_forward(
            cfg, params, torch.as_tensor(prefix[r])[None], enc,
            collect_kv=True)
        gen[r] = [int(logits[0, -1].argmax())]
        k, v = (t[:, 0].reshape(t.shape[0], t.shape[2], khs, -1)
                for t in caches["cross_kv"])
        sc.scatter_cross_kv(state, k, v,
                            migrate.prefill_coords(cluster, r, PAGE, ps))
        k, v = (t[:, 0].reshape(t.shape[0], t.shape[2], khs, -1)
                .repeat(1, 1, ps, 1) for t in caches["self_kv"])
        inst, slot = cluster.slot_map[r]
        t0 = k.shape[1]
        sc.scatter_self_kv(state, k, v, np.stack([
            np.full(t0, inst), np.full(t0, slot), np.arange(t0)]))
    cross0 = {k: state[k].clone() for k in ("cross_k_pool", "cross_v_pool")}

    dparams = dcp.to_encdec_decode_params(cfg, params, TP)
    dev_tables = routing.DeviceTables("cpu")
    buckets = ShapeBuckets(m_buckets=(M,), window=I)
    step_logits = {r: [] for r in EQUIV_REQS}
    routed = 0
    for _ in range(EQUIV_STEPS - 1):
        plan = sched.schedule(cluster)
        assert not plan.escalations and not plan.relaxations
        assert sched.relax(cluster, force=True) == []
        tbl = routing.lower_plan(cluster, plan, buckets=buckets,
                                 append_tokens=False,
                                 next_tokens={r: g[-1] for r, g in gen.items()})
        d = dcp.DecodeDims(M=tbl.M, S=tbl.S, N=tbl.N, MB=tbl.MB, MBT=tbl.MBT,
                           W=I, num_frames=nf, page=PAGE, data_size=I, tp=TP)
        routed = max(routed, d.num_rounds)
        state, toks, logits = dcp.build_encdec_decode_step(cfg, d)(
            dparams, state, routing.as_device_arrays(tbl, dev_tables))
        for r in EQUIV_REQS:
            i, b = cluster.slot_map[r]
            gen[r].append(int(toks[i, b]))
            step_logits[r].append(logits[i, b].numpy())
        for r in list(cluster.active):
            cluster.active[r].generated += 1
    assert routed > 0                        # q rows crossed instances
    for k, v in cross0.items():
        assert torch.equal(state[k], v), f"{k} changed during decode"
    for r in EQUIV_REQS:
        want = _jax_teacher_forced(frames[r], prefix[r], gen[r])
        assert want.argmax(-1).tolist() == gen[r], (r, gen[r])
        err = np.abs(np.stack(step_logits[r]) - want[1:]).max()
        assert err <= STEP_LOGIT_RTOL * np.abs(want[1:]).max(), (r, err)


# --------------------------------------------------------------------------- #
# the engine: the reference's whisper conformance cells
# --------------------------------------------------------------------------- #
CONFORMANCE = [(40, 3), (130, 5), (130, 2)]     # (frames, prefix tokens)
STEPS = 4


@pytest.mark.parametrize("I,TP", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
def test_engine_whisper_conformance(I, TP):
    """Three audio requests (two of the same shape: one batched encode)
    through the engine, pipelined: every transcript equals greedy JAX,
    escalation and relaxation are off, the pools stay in place and the
    cross pools are not written by any decode step."""
    _, _, cfg, params = _models()
    eng = NanoCPEngine(cfg, params, num_instances=I, instances_per_node=I,
                       kv_capacity_tokens=4096, page_size=PAGE, tp=TP,
                       buckets=CPBuckets(edges=(64, 160),
                                         degrees=(1, 2, 3) if I >= 3
                                         else (1, 2, 2)),
                       max_slots_per_instance=4,
                       audit_donation_every_step=True, device="cpu")
    assert not eng.scheduler.allow_escalation
    assert not eng.scheduler.allow_rebalance
    assert eng.shape_buckets.m_buckets == (4,)
    rng = np.random.default_rng(0)
    frames = {r: rng.standard_normal((L, cfg.d_model)).astype(np.float32)
              for r, (L, _) in enumerate(CONFORMANCE)}
    prefix = {r: rng.integers(0, VOCAB, (t0,))
              for r, (_, t0) in enumerate(CONFORMANCE)}
    for r in range(len(CONFORMANCE)):
        eng.add_audio_request(frames[r], prefix[r], max_new_tokens=STEPS)
    ptrs = {k: v.data_ptr() for k, v in eng.state.items()}
    eng.step()
    assert not eng.cluster.waiting, "all requests must admit at step 1"
    cross0 = {k: eng.state[k].clone() for k in ("cross_k_pool",
                                                "cross_v_pool")}
    for _ in range(16):
        if not eng.pending:
            break
        eng.step()
    assert not eng.pending
    for k, v in cross0.items():
        assert torch.equal(eng.state[k], v)
    for rid, res in eng.results.items():
        assert len(res.tokens) == STEPS, (rid, res.tokens)
        want = _jax_teacher_forced(frames[rid], prefix[rid], res.tokens)
        assert res.tokens == want.argmax(-1).tolist(), rid
    assert {k: v.data_ptr() for k, v in eng.state.items()} == ptrs
    hp = eng.hot_path_stats
    assert hp["escalations"] == hp["relaxations"] == 0
    st = eng.aot.stats
    assert st.donation_copies == 0 and st.donation_reuses > 0
    eng.cluster.page_table.frame_audit()
    for i in range(I):
        assert eng.cluster.page_table.instance_used_tokens(i) == 0


def test_engine_whisper_crash_degrades_and_drain_refuses():
    """Pinned self caches, as in the reference: ``drain_instance`` raises
    ``UnsupportedDrainError`` and changes nothing; a crash of an instance
    holding a request's cross KV finishes that request degraded (never
    re-prefilled) with a greedy prefix, the others stay greedy, and no
    frame leaks."""
    from repro_torch.serving.engine import UnsupportedDrainError
    _, _, cfg, params = _models()
    eng = NanoCPEngine(cfg, params, num_instances=4, instances_per_node=4,
                       kv_capacity_tokens=4096, page_size=PAGE, tp=2,
                       buckets=CPBuckets(edges=(64, 160), degrees=(1, 2, 3)),
                       max_slots_per_instance=4, device="cpu")
    rng = np.random.default_rng(0)
    frames = {r: rng.standard_normal((L, cfg.d_model)).astype(np.float32)
              for r, (L, _) in enumerate(CONFORMANCE)}
    prefix = {r: rng.integers(0, VOCAB, (t0,))
              for r, (_, t0) in enumerate(CONFORMANCE)}
    for r in range(len(CONFORMANCE)):
        eng.add_audio_request(frames[r], prefix[r], max_new_tokens=STEPS + 2)
    eng.step()
    eng.step()
    pt = eng.cluster.page_table
    before = pt.frame_audit()
    with pytest.raises(UnsupportedDrainError, match="pins per-slot"):
        eng.drain_instance(0)
    assert pt.frame_audit() == before and not eng.cluster.dead_instances
    # the crash takes a shard of request 1's cross KV (130 frames: CP 2)
    victim = next(s for s, t in pt.shard_tokens(1).items()
                  if t > 0 and s != eng.cluster.slot_map[1][0])
    hit = {r for r in eng.cluster.active
           if pt.shard_tokens(r).get(victim, 0) > 0
           or eng.cluster.slot_map[r][0] == victim}
    eng.fail_instance(victim)
    for _ in range(16):
        if not eng.pending:
            break
        eng.step()
    assert not eng.pending
    assert eng.hot_path_stats["reprefill_tokens"] == 0
    for rid, res in eng.results.items():
        want = _jax_teacher_forced(frames[rid], prefix[rid], res.tokens)
        assert res.tokens == want.argmax(-1).tolist(), rid
        if rid in hit:
            assert res.recovered is False and len(res.tokens) < STEPS + 2
        else:
            assert res.recovered is None and len(res.tokens) == STEPS + 2
    for i, (free, held) in pt.frame_audit().items():
        assert held == 0, (i, free, held)
