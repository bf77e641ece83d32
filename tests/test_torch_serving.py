"""The port's engine serving features on the CPU, held against the JAX
package: ports of the reference's ``engine_slo.py`` (shed, reject,
preempt, parity), ``engine_prefix.py`` (equality, fork, evict, chaos) and
``engine_disagg.py`` (TinyLlama at (6, 1), MiniCPM3 at (8, 1) over two
nodes, a prefill-cell crash) cells, at the reference's reduced sizes.

Weights come from the JAX init (cast to float32) through
``repro_torch.params``; prompts are drawn with numpy as the reference's
cells draw them.  Every transcript of a request that runs must equal
greedy JAX ``transformer.forward`` teacher-forced (one forward per request
over prompt + transcript), every cell asserts the reference's outcomes
and invariants, ends with no frame leaked or aliased, and keeps every
pool where it was allocated (the port's donation check: no step, copy or
scatter moved a pool).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.models import init_params as jinit, transformer as jtransformer
from repro.serving import latency_model as jlatency
from repro.serving import simulator as jsimulator, slo as jslo
from repro.core.scheduler import (AdmissionController as JAdmission,
                                  DualBalancedScheduler as JScheduler)
from repro.core.bucketing import CPBuckets as JCPBuckets
from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.core.scheduler import (AdmissionController,
                                        DualBalancedScheduler)
from repro_torch.serving import slo
from repro_torch.serving.engine import NanoCPEngine
from repro_torch.serving.latency_model import HardwareModel, LatencyModel
from repro_torch.serving.simulator import ClusterSimulator

VOCAB = 256
PAGE = 16
ARCH = "tinyllama-1.1b"
MLA = "minicpm3-4b"


@functools.cache
def _arch_models(arch):
    over = {"vocab_size": VOCAB}
    jcfg = jreduced(JCONFIGS[arch], **over)
    cfg = reduced(CONFIGS[arch], **over)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jinit(jax.random.PRNGKey(0), jcfg))
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture
def models(request):
    """(jcfg, jparams, cfg, params) of the case's ``arch`` (TinyLlama by
    default), made once per module."""
    return _arch_models(getattr(request, "param", ARCH))


def _greedy(models, prompt, transcript):
    """JAX greedy choice at every generated position, teacher-forced."""
    jcfg, jparams = models[:2]
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(transcript[:-1], np.int64)])
    logits, _ = jtransformer.forward(jcfg, jparams, jnp.asarray(seq)[None])
    return np.asarray(logits[0, len(prompt) - 1:]).argmax(-1).tolist()


def _check_greedy(models, eng, prompts, new_tokens, skip=()):
    """Every transcript full length and greedy; a skipped (dropped)
    request emitted no token."""
    for rid, prompt in enumerate(prompts):
        toks = eng.results[rid].tokens
        if rid in skip:
            assert toks == [], (rid, "a dropped request emitted tokens")
            continue
        n = new_tokens[rid] if isinstance(new_tokens, (list, tuple)) \
            else new_tokens
        assert len(toks) == n, (rid, toks)
        assert toks == _greedy(models, prompt, toks), rid


def _check_frames(cl):
    """No leaked or aliased frame anywhere after the run."""
    for s, (free, held) in cl.page_table.frame_audit().items():
        if s in cl.dead_instances:
            assert held == 0, (s, free, held)
        else:
            assert free + held == cl.page_table.frames_per_instance, \
                (s, free, held)


def _pool_ptrs(eng):
    return {k: v.data_ptr() for k, v in eng.state.items()}


def _check_end(eng, ptrs):
    """Drained, no frame leaked, no pool moved."""
    cl = eng.cluster
    assert not (cl.active or cl.waiting or cl.prefilling) \
        and eng._inflight is None
    _check_frames(cl)
    assert _pool_ptrs(eng) == ptrs
    assert eng.aot.stats.donation_copies == 0, eng.aot.stats.as_dict()


def _drain(eng, max_steps):
    for _ in range(max_steps):
        if not eng.pending:
            return
        eng.step()
    raise AssertionError(f"run exceeded {max_steps} steps")


# --------------------------------------------------------------------------- #
# engine_slo.py: shed, reject, preempt, parity
# --------------------------------------------------------------------------- #
def _slo_engine(cfg, params, *, cap, buckets, admission, pipeline,
                kv_reserve=0, escalate_headroom=None, relax_guard=None,
                relax_cooldown=4, slots=4):
    sched = DualBalancedScheduler(
        buckets=buckets, max_batch_per_instance=8, kv_reserve=kv_reserve,
        escalate_headroom=escalate_headroom, relax_guard=relax_guard,
        relax_cooldown=relax_cooldown, admission=admission)
    eng = NanoCPEngine(
        cfg, params, num_instances=2, instances_per_node=2, tp=2,
        kv_capacity_tokens=cap, page_size=PAGE, buckets=buckets,
        shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4, 8),
                                   s_buckets=(0, 1, 2, 4), window=2),
        scheduler=sched, max_slots_per_instance=slots, pipeline=pipeline,
        audit_donation_every_step=True, device="cpu")
    return eng, sched


def _conservation(eng, n):
    """Each submitted request has exactly one typed outcome."""
    fin = {r.rid: r for r in eng.finished}
    assert len(fin) == n == len(eng.finished), (len(fin), n)
    oc = slo.outcome_counts(eng.finished)
    assert sum(oc.values()) == n, oc
    for r in eng.finished:
        assert r.status in slo.OUTCOMES and r.finish_time >= 0.0, r
    return fin, oc


def _slo_shed(models, pipeline):
    cfg, params = models[2:]
    buckets = CPBuckets(edges=(100_000,), degrees=(1, 2))
    adm = AdmissionController(ttft_slo=0.01, ttft_slo_long=0.01,
                              long_threshold=100_000, preempt=False)
    eng, _ = _slo_engine(cfg, params, cap=256, buckets=buckets,
                         admission=adm, pipeline=pipeline)
    ptrs = _pool_ptrs(eng)
    rng = np.random.default_rng(0)
    # A and B fill both instances; C cannot place and its 0.011 deadline
    # expires while they decode
    reqs = [(200, 40), (200, 40), (112, 4)]
    prompts = [rng.integers(0, VOCAB, (L,)) for L, _ in reqs]
    arrivals = {0: [0, 1], 2: [2]}
    for step in range(400):
        now = step * 0.0005
        for rid in arrivals.get(step, ()):
            eng.add_request(prompts[rid], reqs[rid][1], now=now)
        if not eng.pending and step > 3:
            break
        eng.step(now=now)
    _check_end(eng, ptrs)
    fin, oc = _conservation(eng, 3)
    hp = eng.hot_path_stats
    assert fin[2].status == "shed" and eng.results[2].shed
    assert hp["shed"] == 1 and hp["rejected"] == 0, hp
    assert fin[2].finish_time > adm.deadline(fin[2])
    assert oc["finished"] == 2 and oc["shed"] == 1, oc
    _check_greedy(models, eng, prompts, [n for _, n in reqs], skip={2})


def _slo_reject(models, pipeline):
    cfg, params = models[2:]
    buckets = CPBuckets(edges=(100_000,), degrees=(1, 2))
    adm = AdmissionController(ttft_slo=1e9, long_threshold=100_000,
                              max_queue=1, preempt=False)
    eng, _ = _slo_engine(cfg, params, cap=256, buckets=buckets,
                         admission=adm, pipeline=pipeline)
    ptrs = _pool_ptrs(eng)
    rng = np.random.default_rng(1)
    # A and B fill the box; C and D queue, the cap of one bounces D
    reqs = [(200, 24), (200, 24), (112, 4), (112, 4)]
    prompts = [rng.integers(0, VOCAB, (L,)) for L, _ in reqs]
    eng.add_request(prompts[0], 24, now=0.0)
    eng.add_request(prompts[1], 24, now=0.0)
    eng.step(now=0.0)
    eng.add_request(prompts[2], 4, now=0.001)
    eng.add_request(prompts[3], 4, now=0.002)
    for step in range(1, 400):
        if not eng.pending:
            break
        eng.step(now=step * 0.0005)
    _check_end(eng, ptrs)
    fin, oc = _conservation(eng, 4)
    hp = eng.hot_path_stats
    assert fin[3].status == "rejected" and eng.results[3].rejected
    assert hp["rejected"] == 1 and hp["shed"] == 0, hp
    assert oc["finished"] == 3 and oc["rejected"] == 1, oc
    _check_greedy(models, eng, prompts, [n for _, n in reqs], skip={3})


def _slo_preempt(models, pipeline):
    cfg, params = models[2:]
    buckets = CPBuckets(edges=(100_000,), degrees=(1, 2))
    adm = AdmissionController(ttft_slo=1e9, long_threshold=100_000,
                              preempt=True)
    eng, sched = _slo_engine(cfg, params, cap=256, buckets=buckets,
                             admission=adm, pipeline=pipeline, kv_reserve=0,
                             escalate_headroom=16, relax_guard=0,
                             relax_cooldown=64)
    ptrs = _pool_ptrs(eng)
    relax_log = []
    orig_relax = sched.relax

    def relax(cluster, force=False, exclude=frozenset()):
        recs = orig_relax(cluster, force=force, exclude=exclude)
        for rec in recs:
            length = (cluster.active[rec.rid].length
                      if rec.rid in cluster.active else None)
            relax_log.append((force, length, rec))
        return recs

    sched.relax = relax
    rng = np.random.default_rng(2)
    # A escalates under its own growth; B cannot place until the forced
    # relax pass pulls A's fragment home
    reqs = [(128, 100), (220, 45), (112, 4)]
    prompts = [rng.integers(0, VOCAB, (L,)) for L, _ in reqs]
    arrivals = {0: [0, 1], 30: [2]}
    for step in range(400):
        now = float(step)
        for rid in arrivals.get(step, ()):
            eng.add_request(prompts[rid], reqs[rid][1], now=now)
        if not eng.pending and step > 30:
            break
        eng.step(now=now)
    _check_end(eng, ptrs)
    fin, oc = _conservation(eng, 3)
    hp = eng.hot_path_stats
    forced = [(ln, rec) for f, ln, rec in relax_log if f]
    assert hp["preemptions"] >= 1 and forced, hp
    for length, rec in forced:
        assert len(rec.new_binding) >= 1, rec
        if length is not None:
            assert len(rec.new_binding) >= buckets.cp_degree(length), rec
        assert set(rec.new_binding) <= set(rec.old_binding), rec
    assert oc["finished"] == 3 and oc["shed"] == 0 and oc["rejected"] == 0
    _check_greedy(models, eng, prompts, [n for _, n in reqs])


def _hw_of_reference() -> HardwareModel:
    """The reference's hardware constants, read from the JAX package."""
    return HardwareModel(**dataclasses.asdict(jlatency.HardwareModel()))


def _slo_parity(models, pipeline):
    """The same trace through the simulator and the clocked engine gives
    the same typed-outcome histogram, and the reference's simulator gives
    it too.  Both of the port's tiers price time with the reference's
    hardware constants, so its deadlines mean what they mean there."""
    jcfg, _, cfg, params = models
    hw = _hw_of_reference()
    buckets = CPBuckets(edges=(128,), degrees=(1, 2))

    def admission():
        return AdmissionController(ttft_slo=0.005, ttft_slo_long=0.02,
                                   long_threshold=100, preempt=True)

    def sim():
        return ClusterSimulator(
            cfg, DualBalancedScheduler(buckets=buckets,
                                       max_batch_per_instance=8,
                                       kv_reserve=16, admission=admission()),
            num_instances=2, instances_per_node=2, kv_capacity_tokens=192,
            page_size=PAGE, latency=LatencyModel(cfg, hw=hw))

    wl = slo.make_tiny_trace(6, 2, gap=0.0004, short_len=40, long_len=400,
                             decode=4)
    sim_fin, sim_sub, _ = slo.run_sim_trace(sim(), wl, horizon=5.0)
    sim_oc = slo.outcome_counts(sim_fin)
    jsim = jsimulator.ClusterSimulator(
        jcfg, JScheduler(buckets=JCPBuckets(edges=(128,), degrees=(1, 2)),
                         max_batch_per_instance=8, kv_reserve=16,
                         admission=JAdmission(ttft_slo=0.005,
                                              ttft_slo_long=0.02,
                                              long_threshold=100,
                                              preempt=True)),
        num_instances=2, instances_per_node=2, kv_capacity_tokens=192,
        page_size=PAGE)
    jwl = jslo.make_tiny_trace(6, 2, gap=0.0004, short_len=40, long_len=400,
                               decode=4)
    ref_oc = jslo.outcome_counts(jslo.run_sim_trace(jsim, jwl,
                                                    horizon=5.0)[0])

    eng, _ = _slo_engine(cfg, params, cap=192, buckets=buckets,
                         admission=None, pipeline=pipeline, kv_reserve=16,
                         slots=8)
    eng.scheduler.admission = admission()
    ptrs = _pool_ptrs(eng)
    eng_fin, eng_sub, _ = slo.run_engine_clocked(eng, wl, shadow=sim(),
                                                 max_iters=1200)
    eng_oc = slo.outcome_counts(eng_fin)
    assert sim_sub == eng_sub == len(wl.requests)
    assert sim_oc == eng_oc == ref_oc, (sim_oc, eng_oc, ref_oc)
    assert eng_oc["finished"] == 6 and eng_oc["shed"] == 2, eng_oc
    assert len(eng_fin) == eng_sub and len(sim_fin) == sim_sub
    _check_end(eng, ptrs)
    trace = {t.rid: t for t in wl.requests}
    for r in eng_fin:
        toks = eng.results[r.rid].tokens
        if r.status != "finished":
            assert toks == [], r.rid
            continue
        tr = trace[r.rid]
        prompt = [1 + (r.rid * 31 + k) % 97 for k in range(tr.prompt_len)]
        assert len(toks) == tr.max_new_tokens
        assert toks == _greedy(models, prompt, toks), r.rid


SLO = {"shed": _slo_shed, "reject": _slo_reject, "preempt": _slo_preempt,
       "parity": _slo_parity}
SLO_CELLS = [("shed", False), ("shed", True), ("reject", False),
             ("reject", True), ("preempt", False), ("preempt", True),
             ("parity", False)]


@pytest.mark.parametrize("mode,pipeline", SLO_CELLS,
                         ids=[f"{m}-{'pipe' if p else 'nopipe'}"
                              for m, p in SLO_CELLS])
def test_engine_slo(models, mode, pipeline):
    SLO[mode](models, pipeline)


# --------------------------------------------------------------------------- #
# engine_prefix.py: equality, fork, evict, chaos
# --------------------------------------------------------------------------- #
def _prefix_engine(cfg, params, I, TP, cap=4096, cache=True):
    degrees = (1, 2, 3) if I >= 3 else (1, 2, 2)
    return NanoCPEngine(
        cfg, params, num_instances=I, instances_per_node=I,
        kv_capacity_tokens=cap, page_size=PAGE, tp=TP,
        buckets=CPBuckets(edges=(64, 160), degrees=degrees),
        shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4), s_buckets=(0, 1, 2, 4),
                                   window=I),
        max_slots_per_instance=4, audit_donation_every_step=True,
        prefix_cache=cache, device="cpu")


def _prefix_equality(models, I, TP):
    cfg, params = models[2:]
    rng = np.random.default_rng(0)
    shared = rng.integers(0, VOCAB, (3 * PAGE,))
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, (n,))])
               for n in (12, 30, 2)]

    def run(cache):
        eng = _prefix_engine(cfg, params, I, TP, cache=cache)
        ptrs = _pool_ptrs(eng)
        # rid 0 prefills (and fills the cache) before its siblings arrive
        eng.add_request(prompts[0], max_new_tokens=6)
        eng.step()
        eng.step()
        for p in prompts[1:]:
            eng.add_request(p, max_new_tokens=6)
        _drain(eng, 64)
        _check_end(eng, ptrs)
        return eng

    on, off = run(True), run(False)
    assert on.hot_path_stats["prefix_hit_tokens"] == 2 * 3 * PAGE
    assert on.hot_path_stats["prefix_inserts"] > 0
    assert off.hot_path_stats["prefix_hit_tokens"] == 0
    for rid in range(3):
        assert on.results[rid].tokens == off.results[rid].tokens, rid
    _check_greedy(models, on, prompts, 6)


def _prefix_fork(models):
    cfg, params = models[2:]
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, VOCAB, (PAGE + 12,))     # a partial tail page
    n_new = 12
    eng = _prefix_engine(cfg, params, 4, 2)
    ptrs = _pool_ptrs(eng)
    eng.add_request(prompt, max_new_tokens=n_new)
    for _ in range(5):
        eng.step()
    if eng._inflight is not None:
        eng._harvest(eng._now())
    k = len(eng.results[0].tokens)
    assert 3 <= k < n_new, k
    pending = eng.results[0].tokens[-1]
    forced = (pending + 1) % VOCAB
    child = eng.fork_request(0, n_new, next_token=forced)
    assert eng.results[child].tokens == eng.results[0].tokens[:k - 1] + [
        forced]
    assert eng.cluster.page_table.cow_splits >= 1
    assert eng.hot_path_stats["copy_tokens"] > 0
    assert eng.hot_path_stats["forks"] == 1
    _drain(eng, 64)
    _check_end(eng, ptrs)
    _check_greedy(models, eng, [prompt], n_new)
    parent, toks = eng.results[0].tokens, eng.results[child].tokens
    # the child: the parent's first k - 1 tokens, the forced one, then
    # greedy over its own sequence
    assert len(toks) == n_new and toks[:k - 1] == parent[:k - 1]
    assert toks[k - 1] == forced != parent[k - 1]
    assert toks[k:] == _greedy(models, prompt, toks)[k:]


def _prefix_evict(models):
    cfg, params = models[2:]
    rng = np.random.default_rng(2)
    shared = rng.integers(0, VOCAB, (2 * PAGE,))
    eng = _prefix_engine(cfg, params, 2, 2, cap=192)     # 12 frames each
    ptrs = _pool_ptrs(eng)
    p0 = np.concatenate([shared, rng.integers(0, VOCAB, (8,))])
    p1 = np.concatenate([shared, rng.integers(0, VOCAB, (4,))])
    eng.add_request(p0, max_new_tokens=2)
    eng.step()
    eng.step()
    eng.add_request(p1, max_new_tokens=2)
    _drain(eng, 32)
    assert eng.hot_path_stats["prefix_hit_tokens"] == 2 * PAGE
    assert eng.prefix_trie.cached_frames() > 0
    p2 = rng.integers(0, VOCAB, (90,))
    p3 = rng.integers(0, VOCAB, (90,))
    eng.add_request(p2, max_new_tokens=96)
    eng.add_request(p3, max_new_tokens=96)
    _drain(eng, 200)
    _check_end(eng, ptrs)
    assert eng.prefix_trie.evicted_frames > 0
    _check_greedy(models, eng, [p0, p1, p2, p3], [2, 2, 96, 96])


def _prefix_chaos(models):
    cfg, params = models[2:]
    rng = np.random.default_rng(3)
    shared = rng.integers(0, VOCAB, (3 * PAGE,))
    p0 = np.concatenate([shared, rng.integers(0, VOCAB, (12,))])
    p1 = np.concatenate([shared, rng.integers(0, VOCAB, (24,))])
    eng = _prefix_engine(cfg, params, 4, 2)
    ptrs = _pool_ptrs(eng)
    eng.add_request(p0, max_new_tokens=16)
    eng.step()
    eng.step()
    eng.add_request(p1, max_new_tokens=16)
    for _ in range(16):
        if not (eng.cluster.waiting
                or eng.hot_path_stats["prefix_hit_tokens"] == 0):
            break
        eng.step()
    assert eng.hot_path_stats["prefix_hit_tokens"] == 3 * PAGE
    trie = eng.prefix_trie
    victim = min(i for node in trie.nodes.values() for i in node.replicas)
    for _ in range(3):
        eng.step()
    eng.fail_instance(victim)
    assert all(victim not in node.replicas for node in trie.nodes.values())
    _drain(eng, 96)
    _check_end(eng, ptrs)
    assert eng.hot_path_stats["reprefill_tokens"] >= 2 * 3 * PAGE
    _check_greedy(models, eng, [p0, p1], 16)
    assert eng.results[0].recovered and eng.results[1].recovered


PREFIX_CELLS = {"equality-4-2": lambda m: _prefix_equality(m, 4, 2),
                "equality-2-4": lambda m: _prefix_equality(m, 2, 4),
                "fork": _prefix_fork, "evict": _prefix_evict,
                "chaos": _prefix_chaos}


@pytest.mark.parametrize("cell", list(PREFIX_CELLS))
def test_engine_prefix(models, cell):
    PREFIX_CELLS[cell](models)


# --------------------------------------------------------------------------- #
# engine_disagg.py: tinyllama (6, 1) w6, minicpm3 (8, 1) w4, crash
# --------------------------------------------------------------------------- #
CELLS, CHUNK, STEPS = 2, 32, 4


def _disagg_engine(cfg, params, I, TP, w, cells):
    return NanoCPEngine(
        cfg, params, num_instances=I, instances_per_node=w, tp=TP,
        kv_capacity_tokens=4096, page_size=PAGE,
        buckets=CPBuckets(edges=(64, 160), degrees=(1, 2, 3)),
        shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4), s_buckets=(0, 1, 2, 4),
                                   window=I),
        max_slots_per_instance=4, prefill_cells=cells, chunk_tokens=CHUNK,
        audit_donation_every_step=True, device="cpu")


def _disagg(models, I, TP, w, crash):
    cfg, params = models[2:]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (L,)) for L in (24, 90, 180)]
    eng = _disagg_engine(cfg, params, I, TP, w, CELLS)
    ptrs = _pool_ptrs(eng)
    for p in prompts:
        eng.add_request(p, max_new_tokens=STEPS)
    eng.step()
    assert not eng.cluster.waiting
    assert eng.hot_path_stats["staged"] == len(prompts)
    assert set(eng.cluster.prefilling) == set(range(len(prompts)))
    crashed = False
    for _ in range(300):
        if not eng.pending:
            break
        task = eng._handoff.get(2)
        if crash and not crashed and task is not None \
                and task.computed >= 1 and not task.done:
            eng.fail_instance(task.instance)
            crashed = True
        eng.step()
    assert crashed or not crash
    _check_end(eng, ptrs)
    for req in eng.finished:
        assert all(eng.cluster.role_of(s) == "decode"
                   for s in req.kv_binding), (req.rid, req.kv_binding)
    hp = eng.hot_path_stats
    assert hp["prefill_chunks"] >= sum(-(-len(p) // CHUNK) for p in prompts)
    assert hp["handoff_tokens"] >= sum(len(p) for p in prompts)
    if crash:
        assert eng.results[2].recovered is True
        assert hp["reprefill_tokens"] > 0 and hp["recovered_tokens"] > 0
    colo = _disagg_engine(cfg, params, I, TP, w, 0)
    for p in prompts:
        colo.add_request(p, max_new_tokens=STEPS)
    _drain(colo, 300)
    for rid in range(len(prompts)):
        assert eng.results[rid].tokens == colo.results[rid].tokens, rid
    _check_greedy(models, eng, prompts, STEPS)


DISAGG_CELLS = [(ARCH, 6, 1, 6, False), (MLA, 8, 1, 4, False),
                (ARCH, 6, 1, 6, True)]


@pytest.mark.parametrize("models,I,TP,w,crash",
                         [pytest.param(*c, id=f"{c[0]}-{c[1]}x{c[2]}-w{c[3]}"
                                       + ("-crash" if c[4] else ""))
                          for c in DISAGG_CELLS], indirect=["models"])
def test_engine_disagg(models, I, TP, w, crash):
    _disagg(models, I, TP, w, crash)


def test_admission_prefix_and_cells_validate():
    """``chunk_tokens`` must be a positive page multiple; an admission
    controller lands on the scheduler, the prefix trie on the scheduler
    and the engine, the prefill cells in the cluster."""
    cfg, params = _arch_models(ARCH)[2:]
    kw = dict(num_instances=4, instances_per_node=4, kv_capacity_tokens=256,
              tp=1, device="cpu")
    for bad in (24, -16):
        with pytest.raises(ValueError, match="chunk_tokens"):
            NanoCPEngine(cfg, params, chunk_tokens=bad, **kw)
    adm = AdmissionController(ttft_slo=1.0)
    eng = NanoCPEngine(cfg, params, admission=adm, prefix_cache=True,
                       prefill_cells=1, **kw)
    assert eng.scheduler.admission is adm
    assert eng.scheduler.prefix_cache is eng.prefix_trie is not None
    assert eng.cluster.prefill_instances() == [3]
    assert eng.chunk_tokens == 4 * PAGE


def test_recovery_splits_shared_tails(models):
    """A crash recovery that restores lost ranges onto a surviving shard
    whose partial tail frame is shared (here held as a sibling would hold
    it) first splits that tail into an exclusive clone (``_recover``'s
    ``exclusive_tails``): the shared frame keeps its bytes, the request
    re-prefills and finishes greedy, and no frame leaks once the holds
    are released."""
    cfg, params = models[2:]
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, VOCAB, (300,))
    eng = _prefix_engine(cfg, params, 4, 2)
    ptrs = _pool_ptrs(eng)
    eng.add_request(prompt, max_new_tokens=12)
    for _ in range(3):
        eng.step()
    cl = eng.cluster
    pt = cl.page_table
    req = cl.active[0]
    shards = {s: t for s, t in pt.shard_tokens(0).items() if t > 0}
    victim = max(s for s in shards if s != req.moe_binding)
    held = []
    for s in sorted(set(shards) - {victim}):
        frames = pt.shard_frames(0, s)
        if shards[s] % PAGE:
            pt.cache_hold(s, frames[-1])
            held.append((s, frames[-1]))
    assert held
    before = {(s, f): eng.state["k_pool"][:, :, s, :, f // eng._scatter.ps]
              .clone() for s, f in held}
    eng.fail_instance(victim)
    assert eng.hot_path_stats["copy_tokens"] > 0
    assert eng.hot_path_stats["reprefill_tokens"] > 0
    _drain(eng, 64)
    for (s, f), k in before.items():
        assert torch.equal(
            eng.state["k_pool"][:, :, s, :, f // eng._scatter.ps], k), (s, f)
        assert pt.cache_release(s, f)
    _check_end(eng, ptrs)
    assert eng.results[0].recovered is True
    _check_greedy(models, eng, [prompt], 12)
