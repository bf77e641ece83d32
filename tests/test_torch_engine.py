"""The port's ``NanoCPEngine`` main path on the CPU, held against the JAX
package (a port of tests/integration/engine_generation.py and of
tests/test_eos.py).

Weights come from the JAX init (cast to float32) through
``repro_torch.params``; prompts are drawn with numpy.  Transcripts must
equal greedy JAX ``transformer.forward`` token for token.  The check is
teacher-forced: one JAX forward per request over prompt + transcript, with
the argmax at every generated position, so the reference compiles once per
request.  Pools must be updated in place (stable ``data_ptr``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.core.aot import AOTGraphEngine as JAOT
from repro.models import init_params as jinit, transformer as jtransformer
from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.aot import AOTGraphEngine
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.core.scheduler import DualBalancedScheduler
from repro_torch.models import transformer
from repro_torch.serving.engine import NanoCPEngine

PROMPT_LENS = (50, 300, 120, 40, 200)
NEW_TOKENS = 5


def _models(arch="tinyllama-1.1b", **over):
    jcfg = jreduced(JCONFIGS[arch], num_layers=2, **over)
    cfg = reduced(CONFIGS[arch], num_layers=2, **over)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jinit(jax.random.PRNGKey(0), jcfg))
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _jax_argmax(jcfg, jparams, prompt, transcript):
    """JAX greedy choice at every generated position, teacher-forced on
    ``transcript`` (one forward over prompt + transcript[:-1])."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(transcript[:-1],
                                                         np.int64)])
    logits, _ = jtransformer.forward(jcfg, jparams, jnp.asarray(seq)[None])
    return np.asarray(logits[0, len(prompt) - 1:]).argmax(-1).tolist()


def _pool_ptrs(eng):
    return {k: v.data_ptr() for k, v in eng.state.items()}


# --------------------------------------------------------------------------- #
# engine_generation: (I, TP) = (4, 2), five prompts, pipelined and not
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def generation():
    jcfg, jparams, cfg, params = _models(vocab_size=256)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (L,)) for L in PROMPT_LENS]
    runs = {}
    for pipeline in (True, False):
        eng = NanoCPEngine(cfg, params, num_instances=4, instances_per_node=4,
                           kv_capacity_tokens=2048, page_size=16, tp=2,
                           buckets=CPBuckets(edges=(100, 256),
                                             degrees=(1, 2, 3)),
                           shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                      s_buckets=(0, 1, 2, 4),
                                                      window=4),
                           pipeline=pipeline, audit_donation_every_step=True,
                           device="cpu")
        ptrs = _pool_ptrs(eng)
        for p in prompts:
            eng.add_request(p, max_new_tokens=NEW_TOKENS)
        timing_keys, it = set(), 0
        while eng.pending and it < 30:
            eng.step()
            timing_keys |= set(eng.timings)
            it += 1
        eng.timing_keys = timing_keys
        runs[pipeline] = (eng, {r: eng.results[r].tokens for r in eng.results},
                          ptrs)
    # the reference: one JAX forward per request on the pipelined transcript
    ref = {rid: _jax_argmax(jcfg, jparams, prompts[rid], toks)
           for rid, toks in runs[True][1].items()}
    return prompts, runs, ref


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_engine_transcripts_equal_jax_greedy(generation, pipeline):
    prompts, runs, ref = generation
    eng, toks, _ = runs[pipeline]
    assert sorted(toks) == list(range(len(prompts)))
    for rid, t in toks.items():
        assert len(t) == NEW_TOKENS, (rid, t)
        assert t == ref[rid], (pipeline, rid, t, ref[rid])
    assert not eng.pending and len(eng.finished) == len(prompts)


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_engine_pools_update_in_place(generation, pipeline):
    """Every step wrote into the same pool storage (the counterpart of the
    reference's donated serve state), and the step cache was replayed."""
    _, runs, _ = generation
    eng, _, ptrs = runs[pipeline]
    stats = eng.aot.stats
    assert _pool_ptrs(eng) == ptrs
    assert stats.donation_checks == eng.hot_path_stats["steps"] > 0
    assert stats.donation_copies == 0 and stats.donation_reuses > 0
    assert stats.hits > 0 and stats.lookups == eng.hot_path_stats["steps"]
    # async harvest: one token fetch per dispatched step
    assert (eng.hot_path_stats["async_token_fetches"]
            == eng.hot_path_stats["steps"])


def test_engine_step_timings_and_bucket(generation):
    _, runs, _ = generation
    eng = runs[True][0]
    assert eng.last_bucket is not None and len(eng.last_bucket) == 5
    assert eng.timing_keys >= {"prefill_us", "lower_us", "lookup_us",
                               "harvest_us", "tables_us", "dispatch_us",
                               "step_us"}
    assert eng.iterations == eng.hot_path_stats["steps"]


# --------------------------------------------------------------------------- #
# MLA (reduced minicpm3, decode Dk 40 / Dv 32): the same traffic at (4, 2),
# and the reference's ``mla`` escalation cell (engine_escalation.py)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mla_generation():
    jcfg, jparams, cfg, params = _models("minicpm3-4b", vocab_size=256)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (L,)) for L in PROMPT_LENS]
    runs = {}
    for pipeline in (True, False):
        eng = NanoCPEngine(cfg, params, num_instances=4, instances_per_node=4,
                           kv_capacity_tokens=2048, page_size=16, tp=2,
                           buckets=CPBuckets(edges=(100, 256),
                                             degrees=(1, 2, 3)),
                           shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                      s_buckets=(0, 1, 2, 4),
                                                      window=4),
                           pipeline=pipeline, audit_donation_every_step=True,
                           device="cpu")
        ptrs = _pool_ptrs(eng)
        for p in prompts:
            eng.add_request(p, max_new_tokens=NEW_TOKENS)
        eng.run(max_iters=30)
        runs[pipeline] = (eng, ptrs)
    ref = {rid: _jax_argmax(jcfg, jparams, prompts[rid], r.tokens)
           for rid, r in runs[True][0].results.items()}
    return prompts, runs, ref


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_mla_engine_transcripts_equal_jax_greedy(mla_generation, pipeline):
    """MLA serving through the engine: the latent pool (one ``kv_pool``
    striped over both tp devices) is filled by the prefill scatter, grows
    by the step's appends in place, and the transcripts equal greedy JAX
    ``transformer.forward``."""
    prompts, runs, ref = mla_generation
    eng, ptrs = runs[pipeline]
    assert set(eng.state) == {"kv_pool"}
    assert eng.state["kv_pool"].shape[-1] == 40           # kvr 32 + rope 8
    assert sorted(eng.results) == list(range(len(prompts)))
    for rid, res in eng.results.items():
        assert len(res.tokens) == NEW_TOKENS, (rid, res.tokens)
        assert res.tokens == ref[rid], (pipeline, rid, res.tokens, ref[rid])
    assert not eng.pending and len(eng.finished) == len(prompts)
    assert _pool_ptrs(eng) == ptrs
    assert eng.aot.stats.donation_copies == 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp8"], ids=["f32", "fp8"])
def test_mla_escalation_moves_latent_and_equals_greedy(kv_dtype):
    """The reference's ``mla`` escalation mode: (2, 2), one 40-token prompt
    decoding 24 tokens across the CP bucket edge at 48; the live re-shard
    moves the latent (and its scales, for fp8 pools).  Float pools must
    stay equal to greedy; fp8 ones must keep the first token and stay
    within the quantized contract's logit bound (1.5)."""
    jcfg, jparams, cfg, params = _models("minicpm3-4b", vocab_size=256)
    eng = NanoCPEngine(cfg, params, num_instances=2, instances_per_node=2,
                       kv_capacity_tokens=4096, page_size=16, tp=2,
                       buckets=CPBuckets(edges=(48,), degrees=(1, 2)),
                       shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                  s_buckets=(0, 1, 2, 4),
                                                  window=2),
                       max_slots_per_instance=4, kv_dtype=kv_dtype,
                       keep_logits=True, audit_donation_every_step=True,
                       device="cpu")
    prompt = np.random.default_rng(0).integers(0, 256, (40,))
    rid = eng.add_request(prompt, max_new_tokens=24)
    eng.step()
    assert eng.cluster.active[rid].cp_degree == 1, "must admit un-escalated"
    ptrs = _pool_ptrs(eng)
    eng.run(max_iters=60)
    hp = eng.hot_path_stats
    assert hp["escalations"] >= 1 and hp["reshard_tokens"] > 0, hp
    assert len(eng.finished[0].kv_binding) == 2
    assert _pool_ptrs(eng) == ptrs and eng.aot.stats.donation_copies == 0
    toks = eng.results[rid].tokens
    assert len(toks) == 24
    ref = _jax_argmax(jcfg, jparams, prompt, toks)
    if kv_dtype == "bf16":
        assert toks == ref, (toks, ref)
        return
    assert set(eng.state) == {"kv_pool", "kv_scale"}
    assert toks[0] == ref[0]
    seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int64)])
    lj, _ = jtransformer.forward(jcfg, jparams, jnp.asarray(seq)[None])
    ref_lg = np.asarray(lj[0, len(prompt):, :cfg.vocab_size])
    got = np.stack(eng.step_logits[rid])[:, :cfg.vocab_size]
    assert np.abs(got - ref_lg).max() <= 1.5


# --------------------------------------------------------------------------- #
# MoE (reduced phi3.5-moe, capacity factor 8.0: no token dropped, so decode
# and prefill route alike): the main path's traffic at (4, 2)
# --------------------------------------------------------------------------- #
MOE = "phi3.5-moe-42b-a6.6b"


@pytest.fixture(scope="module")
def moe_generation():
    jcfg, jparams, cfg, params = _models(MOE, vocab_size=256,
                                         capacity_factor=8.0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (L,)) for L in PROMPT_LENS]
    runs = {}
    for pipeline in (True, False):
        eng = NanoCPEngine(cfg, params, num_instances=4, instances_per_node=4,
                           kv_capacity_tokens=2048, page_size=16, tp=2,
                           buckets=CPBuckets(edges=(100, 256),
                                             degrees=(1, 2, 3)),
                           shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                      s_buckets=(0, 1, 2, 4),
                                                      window=4),
                           pipeline=pipeline, audit_donation_every_step=True,
                           device="cpu")
        ptrs = _pool_ptrs(eng)
        for p in prompts:
            eng.add_request(p, max_new_tokens=NEW_TOKENS)
        eng.run(max_iters=30)
        runs[pipeline] = (eng, ptrs)
    ref = {rid: _jax_argmax(jcfg, jparams, prompts[rid], r.tokens)
           for rid, r in runs[True][0].results.items()}
    return prompts, runs, ref


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_moe_engine_transcripts_equal_jax_greedy(moe_generation, pipeline):
    """Wide-EP MoE serving through the engine on a (4, 2) mesh: each
    instance hosts one of the four experts, and the transcripts equal
    greedy JAX ``transformer.forward``."""
    prompts, runs, ref = moe_generation
    eng, ptrs = runs[pipeline]
    assert sorted(eng.results) == list(range(len(prompts)))
    for rid, res in eng.results.items():
        assert len(res.tokens) == NEW_TOKENS, (rid, res.tokens)
        assert res.tokens == ref[rid], (pipeline, rid, res.tokens, ref[rid])
    assert not eng.pending and len(eng.finished) == len(prompts)
    assert _pool_ptrs(eng) == ptrs
    assert eng.aot.stats.donation_copies == 0


# --------------------------------------------------------------------------- #
# spill relief, OOM finish, compact and drain: ports of the reference's
# engine_escalation.py (headroom, oom), engine_relaxation.py (compact) and
# engine_multinode.py (drain) cells, held against greedy JAX forward
# --------------------------------------------------------------------------- #
def _cell_engine(cfg, params, *, I, W, tp, cap, edges, degrees, window,
                 pipeline=True, escalate=True):
    """The reference cells' engine.  ``escalate=False`` turns off the
    scheduler's own escalation (bucket edge, low-water mark), so decode
    growth surfaces as a typed spill at table lowering."""
    sched = DualBalancedScheduler(
        buckets=CPBuckets(edges=edges, degrees=degrees), allow_rebalance=True,
        max_batch_per_instance=4, has_kv=True, kv_reserve=16,
        allow_escalation=escalate)
    return NanoCPEngine(cfg, params, num_instances=I, instances_per_node=W,
                        tp=tp, kv_capacity_tokens=cap, page_size=16,
                        scheduler=sched,
                        shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                   s_buckets=(0, 1, 2, 4),
                                                   window=window),
                        max_slots_per_instance=4, pipeline=pipeline,
                        audit_donation_every_step=True, device="cpu")


def _drive(eng, max_steps):
    """Run the engine to the end; returns the MoE bindings each request
    held while it was active."""
    bindings: dict = {}
    for _ in range(max_steps):
        for rid, req in eng.cluster.active.items():
            bindings.setdefault(rid, set()).add(req.moe_binding)
        if not eng.pending:
            break
        eng.step()
    assert not eng.pending
    return bindings


# mode: (arch, kv_capacity_tokens, edges, prompt_len, max_new, escalate)
SPILL_CELLS = {
    "headroom": ("tinyllama-1.1b", 96, (100_000,), 40, 40, True),
    "spill": ("tinyllama-1.1b", 96, (100_000,), 40, 64, False),
    "oom": ("tinyllama-1.1b", 48, (16,), 24, 100, True),
    "moe-spill": (MOE, 96, (100_000,), 40, 64, False),
}


@pytest.mark.parametrize("mode,pipeline",
                         [("headroom", True), ("headroom", False),
                          ("spill", True), ("spill", False),
                          ("oom", True), ("oom", False),
                          ("moe-spill", True)],
                         ids=["headroom-pipelined", "headroom-non-pipelined",
                              "spill-pipelined", "spill-non-pipelined",
                              "oom-pipelined", "oom-non-pipelined",
                              "moe-spill"])
def test_spill_relief_and_oom_finish(mode, pipeline):
    """(2, 2) with a pool of a few pages per instance.  ``headroom``: decode
    fills the MoE-binding shard and the low-water mark escalates the KV
    onto the other instance.  ``spill`` (and reduced phi3.5-moe's
    ``moe-spill``): with the scheduler's escalation off the append spills
    at table lowering, and the engine's spill relief escalates it.  Either
    way the MoE binding stays put and tokens equal greedy.  ``oom``: the
    whole node's pools run out mid-decode; the request finishes with
    ``GenResult.oom`` and its emitted tokens are a prefix of greedy."""
    arch, cap, edges, plen, max_new, escalate = SPILL_CELLS[mode]
    over = {"capacity_factor": 8.0} if arch == MOE else {}
    jcfg, jparams, cfg, params = _models(arch, vocab_size=256, **over)
    eng = _cell_engine(cfg, params, I=2, W=2, tp=2, cap=cap, edges=edges,
                       degrees=(1, 2), window=2, pipeline=pipeline,
                       escalate=escalate)
    ptrs = _pool_ptrs(eng)
    prompt = np.random.default_rng(0).integers(0, 256, (plen,))
    rid = eng.add_request(prompt, max_new_tokens=max_new)
    eng.step()
    assert not eng.cluster.waiting, "request must admit at step 1"
    if mode != "oom":                       # oom admits pre-split (deg 2)
        assert eng.cluster.active[rid].cp_degree == 1
    bindings = _drive(eng, max_new + 32)
    res, hp = eng.results[rid], eng.hot_path_stats
    assert _pool_ptrs(eng) == ptrs and eng.aot.stats.donation_copies == 0
    assert res.tokens == _jax_argmax(jcfg, jparams, prompt, res.tokens)
    if mode == "oom":
        assert res.oom and hp["oom_finishes"] == 1, hp
        assert 0 < len(res.tokens) < max_new
        assert hp["escalations"] + hp["spill_escalations"] >= 1, hp
        return
    assert not res.oom and len(res.tokens) == max_new
    assert hp["escalations" if escalate else "spill_escalations"] >= 1, hp
    assert hp["reshard_tokens"] > 0, hp
    fin = [r for r in eng.finished if r.rid == rid][0]
    assert len(fin.kv_binding) == 2, fin.kv_binding
    assert len(bindings[rid]) == 1, bindings     # the KV moved, the MoE
                                                 # binding did not


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_compact_after_drain_equals_greedy(pipeline):
    """engine_relaxation.py's ``compact`` cell: (4, 2), three requests; the
    busiest MoE binding's instance is drained (its KV spreads), then
    ``compact`` relaxes the widened bindings back inside their old ones;
    every transcript equals greedy."""
    jcfg, jparams, cfg, params = _models(vocab_size=256)
    reqs = [(24, 12), (90, 12), (180, 12)]
    eng = _cell_engine(cfg, params, I=4, W=4, tp=2, cap=4096,
                       edges=(64, 160), degrees=(1, 2, 3), window=4,
                       pipeline=pipeline)
    ptrs = _pool_ptrs(eng)
    cl = eng.cluster
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (L,)) for L, _ in reqs]
    for p, (_, n) in zip(prompts, reqs):
        eng.add_request(p, max_new_tokens=n)
    for _ in range(3):
        eng.step()
    assert not cl.waiting
    victim = int(np.bincount([r.moe_binding for r in cl.active.values()],
                             minlength=4).argmax())
    assert eng.drain_instance(victim)
    assert cl.page_table.instance_used_tokens(victim) == 0
    pre = {r: sorted(cl.active[r].kv_binding) for r in cl.active}
    compacted = eng.compact()
    assert compacted, "post-drain compact must relax something"
    for rec in compacted:
        assert set(rec.new_binding) <= set(rec.old_binding), rec
        assert sorted(rec.old_binding) == pre[rec.rid], rec
    assert any(len(r.new_binding) < len(r.old_binding) or r.tokens_moved
               for r in compacted)
    _drive(eng, 60)
    hp = eng.hot_path_stats
    assert hp["compacts"] == 1 and hp["drains"] == 1, hp
    assert hp["relaxations"] >= 1, hp
    assert _pool_ptrs(eng) == ptrs and eng.aot.stats.donation_copies == 0
    for rid, (_, n) in enumerate(reqs):
        toks = eng.results[rid].tokens
        assert len(toks) == n and not eng.results[rid].oom
        assert toks == _jax_argmax(jcfg, jparams, prompts[rid], toks), rid


def test_drain_evacuates_across_nodes_equals_greedy():
    """engine_multinode.py's ``drain`` cell: (4, 2) in two nodes of two
    instances; draining the long request's MoE binding moves its KV
    across the node boundary (its node partner cannot hold it), the
    drained instance ends empty, and both transcripts equal greedy."""
    jcfg, jparams, cfg, params = _models(vocab_size=256)
    eng = _cell_engine(cfg, params, I=4, W=2, tp=2, cap=64,
                       edges=(100_000,), degrees=(1, 2), window=4)
    cl = eng.cluster
    assert cl.num_nodes == 2
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (L,)) for L in (90, 20)]
    for p in prompts:
        eng.add_request(p, max_new_tokens=10)
    eng.step()
    assert not cl.waiting
    eng.step()
    drained = cl.active[0].moe_binding
    escs = eng.drain_instance(drained)
    assert escs, "drain must evacuate resident KV"
    assert any(n and not cl.same_node(s, d) for e in escs
               for (s, d, n) in e.moves), escs
    assert cl.page_table.instance_used_tokens(drained) == 0
    assert drained in cl.dead_instances
    _drive(eng, 50)
    assert eng.hot_path_stats["drains"] == 1
    for rid, p in enumerate(prompts):
        toks = eng.results[rid].tokens
        assert len(toks) == 10 and not eng.results[rid].oom
        assert toks == _jax_argmax(jcfg, jparams, p, toks), rid


# --------------------------------------------------------------------------- #
# test_eos ports: single instance, kv=1, a real stop token
# --------------------------------------------------------------------------- #
EOS_PROMPT_LEN = 20
EOS_VOCAB = 128


@pytest.fixture(scope="module")
def eos_setup():
    """Models, prompt, and the port's own greedy sequence (eager CPU
    forwards), held once against JAX greedy by a teacher-forced forward."""
    jcfg, jparams, cfg, params = _models(vocab_size=EOS_VOCAB, num_kv_heads=1)
    prompt = np.random.default_rng(0).integers(0, EOS_VOCAB, (EOS_PROMPT_LEN,))
    seq, greedy = list(map(int, prompt)), []
    for _ in range(8):
        logits, _ = transformer.forward(cfg, params, torch.as_tensor(seq)[None],
                                        device="cpu")
        greedy.append(int(logits[0, -1].argmax()))
        seq.append(greedy[-1])
    assert _jax_argmax(jcfg, jparams, prompt, greedy) == greedy
    return cfg, params, prompt, greedy


def _eos_engine(cfg, params, prompt, *, eos, pipeline, max_new=8):
    eng = NanoCPEngine(cfg, params, num_instances=1, instances_per_node=1,
                       kv_capacity_tokens=1024, page_size=16, tp=1,
                       eos_token=eos, pipeline=pipeline,
                       shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                  s_buckets=(0,), window=1),
                       device="cpu")
    eng.add_request(prompt, max_new_tokens=max_new)
    return eng


def _kv_entries(eng) -> int:
    """Distinct (frame, offset) pool positions holding a written KV entry,
    scratch frame (last frame of the sub-pool) excluded."""
    kp = eng.state["k_pool"].numpy()    # [nb, na, I, tp, F', page, kg*hd]
    nz = np.abs(kp).max(axis=(0, 1, -1))[0, 0]          # [F', page]
    return int((nz[:-1] > 0).sum())


def _pick_eos(greedy, at_step: int) -> int:
    eos = greedy[at_step]
    assert eos not in greedy[:at_step], greedy
    return eos


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_eos_appends_exactly_t_kv_entries(eos_setup, pipeline):
    cfg, params, prompt, greedy = eos_setup
    eos = _pick_eos(greedy, 2)                 # sampled at the 3rd emission
    eng = _eos_engine(cfg, params, prompt, eos=eos, pipeline=pipeline)
    res = eng.run(max_iters=30)
    toks = res[0].tokens
    assert toks[-1] == eos and len(toks) == 3, toks
    assert eng.finished and eng.finished[0].rid == 0
    expect = EOS_PROMPT_LEN + len(toks) - 1
    assert _kv_entries(eng) == expect, (pipeline, _kv_entries(eng), expect)
    spec = eng.hot_path_stats["speculative_slots"]
    assert spec == (1 if pipeline else 0), eng.hot_path_stats


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_eos_at_prefill_finishes_without_decode(eos_setup, pipeline):
    cfg, params, prompt, greedy = eos_setup
    eos = greedy[0]
    eng = _eos_engine(cfg, params, prompt, eos=eos, pipeline=pipeline)
    done = eng.step()
    assert [r.rid for r in done] == [0]
    res = eng.run(max_iters=10)
    assert res[0].tokens == [eos]
    assert eng.hot_path_stats["prefill_eos_finishes"] == 1
    assert eng.hot_path_stats["speculative_slots"] == 0
    assert _kv_entries(eng) == EOS_PROMPT_LEN
    assert not eng.cluster.active and not eng.cluster.waiting


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "non-pipelined"])
def test_eos_tokens_match_reference_up_to_stop(eos_setup, pipeline):
    """With a stop token set, the emissions are exactly greedy JAX
    ``transformer.forward`` truncated at (and including) the first EOS.

    The stop token is the first greedy token from the 4th emission on that
    was not sampled before.  (The reference test asks for the 4th emission
    itself, which on this seed repeats the 2nd, so its helper rejects it.)
    """
    cfg, params, prompt, greedy = eos_setup
    at = next(i for i in range(3, len(greedy)) if greedy[i] not in greedy[:i])
    eos = _pick_eos(greedy, at)
    eng = _eos_engine(cfg, params, prompt, eos=eos, pipeline=pipeline)
    res = eng.run(max_iters=30)
    assert res[0].tokens == greedy[:greedy.index(eos) + 1]


# --------------------------------------------------------------------------- #
# per-bucket step cache: the reference's key arithmetic
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("ladder", [None, (1, 2, 4, 6, 7)])
def test_aot_quantise_matches_reference(ladder):
    ours = AOTGraphEngine(None, r_ladder=ladder)
    ref = JAOT(None, r_ladder=ladder)
    for M in (1, 3, 16):
        for S in (0, 2):
            for MB in (1, 5, 9, 13, 40, 100):
                for R in (None, 1, 2, 3, 5, 7):
                    assert (ours.quantise(M, S, MB, 8, R)
                            == ref.quantise(M, S, MB, 8, R))


def test_aot_in_place_audit_detects_moved_storage():
    eng = AOTGraphEngine(None)
    state = {"k_pool": torch.zeros(4), "v_pool": torch.zeros(4)}
    before = eng.buffer_ptrs(state)
    assert eng.note_donation(before, state)
    state["v_pool"] = state["v_pool"] + 1          # not in place
    assert not eng.note_donation(before, state)
    assert (eng.stats.donation_checks, eng.stats.donation_reuses,
            eng.stats.donation_copies) == (2, 3, 1)
