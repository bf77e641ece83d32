"""Fault tolerance and elasticity of the port's engine on the CPU, held
against the JAX package: ports of the reference's ``engine_chaos.py``
cells (kill, killnode, degraded, join, drainforce, refusal), its
``engine_fault.py`` drain cell and the ``engine_multinode.py`` cells
place, escalate and conform.

Weights come from the JAX init (cast to float32) through
``repro_torch.params``; prompts are drawn with numpy.  Every request must
end full length and equal greedy JAX ``transformer.forward`` token for
token, whether untouched or recovered, or be a degraded finish where the
cell allows one, whose tokens are then a prefix of greedy.  The check is
teacher-forced: one JAX forward per request over prompt + transcript.
Every cell ends with no frame leaked or aliased, in a bounded number of
steps, and with the pools updated in place throughout.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS, reduced as jreduced
from repro.models import init_params as jinit, transformer as jtransformer
from repro_torch import params as P
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.core.comm import node_local_rounds
from repro_torch.serving.chaos import (JOIN, KILL, ChaosEvent, ChaosSchedule,
                                       run_engine_with_chaos)
from repro_torch.serving.engine import NanoCPEngine, UnsupportedDrainError

VOCAB = 256
ARCH = "tinyllama-1.1b"
MLA = "minicpm3-4b"
SSM = "mamba2-370m"


@pytest.fixture(autouse=True, scope="module")
def _first_parallel_exp():
    """A CPU build of torch (2.13.0+cpu) can return wrong values from the
    first multithreaded ``torch.exp`` of a process (seen as a 1e-4 relative
    error in the SSD scan's decay matrix in about one process in five,
    never after one earlier call; no other op showed it).  One call before
    the module's tests keeps that fault of the library out of the
    comparisons."""
    torch.exp(torch.zeros(1 << 16))


@functools.cache
def _arch_models(arch):
    jcfg = jreduced(JCONFIGS[arch], vocab_size=VOCAB)
    cfg = reduced(CONFIGS[arch], vocab_size=VOCAB)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jinit(jax.random.PRNGKey(0), jcfg))
    params = P.from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture
def models(request):
    """(jcfg, jparams, cfg, params) of the case's ``arch`` (TinyLlama by
    default), made once per module."""
    return _arch_models(getattr(request, "param", ARCH))


def _greedy_argmax(jcfg, jparams, prompt, transcript):
    """JAX greedy choice at every generated position, teacher-forced."""
    seq = np.concatenate([np.asarray(prompt),
                          np.asarray(transcript[:-1], np.int64)])
    logits, _ = jtransformer.forward(jcfg, jparams, jnp.asarray(seq)[None])
    return np.asarray(logits[0, len(prompt) - 1:]).argmax(-1).tolist()


def _engine(cfg, params, I, W, tp, cap, edges, degrees, pipeline=True):
    return NanoCPEngine(
        cfg, params, num_instances=I, instances_per_node=W, tp=tp,
        kv_capacity_tokens=cap, page_size=16,
        buckets=CPBuckets(edges=edges, degrees=degrees),
        # SSM models keep the engine's one pinned M bucket
        shape_buckets=None if cfg.family in ("ssm", "hybrid")
        else ShapeBuckets(m_buckets=(1, 2, 4), s_buckets=(0, 1, 2, 4),
                          window=I),
        max_slots_per_instance=4, pipeline=pipeline,
        audit_donation_every_step=True, device="cpu")


def _add(eng, reqs):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (L,)) for L, _ in reqs]
    for p, (_, n) in zip(prompts, reqs):
        eng.add_request(p, max_new_tokens=n)
    return prompts


def _drain(eng, max_steps, on_step=None):
    """Step to completion, bounded: a hung recovery fails here."""
    for step in range(max_steps):
        if not eng.pending:
            return
        if on_step is not None:
            on_step(step)
        eng.step()
    raise AssertionError(f"run exceeded {max_steps} steps")


def _check_frames(cl):
    """No leaked or aliased frame anywhere after the run."""
    for s, (free, held) in cl.page_table.frame_audit().items():
        if s in cl.dead_instances:
            assert held == 0, (s, free, held)
            assert free in (0, cl.page_table.frames_per_instance), (s, free)
        else:
            assert free + held == cl.page_table.frames_per_instance, \
                (s, free, held)


def _check_end(models, eng, prompts, reqs, ptrs, degraded_ok=()):
    """The cell's end state: drained, no frame leaked, pools in place, and
    every transcript greedy (full length) or, where allowed, a degraded
    greedy prefix."""
    jcfg, jparams, _, _ = models
    cl = eng.cluster
    assert not cl.active and not cl.waiting and eng._inflight is None
    _check_frames(cl)
    assert {k: v.data_ptr() for k, v in eng.state.items()} == ptrs
    assert eng.aot.stats.donation_copies == 0
    for rid, (_, n) in enumerate(reqs):
        res = eng.results[rid]
        ref = _greedy_argmax(jcfg, jparams, prompts[rid], res.tokens)
        assert res.tokens == ref, (rid, res.tokens, ref)
        if res.recovered is False:
            assert rid in degraded_ok, (rid, "unexpected degraded finish")
            assert 0 < len(res.tokens) < n, (rid, res.tokens)
        else:
            assert len(res.tokens) == n and not res.oom, (rid, res.tokens)


# --------------------------------------------------------------------------- #
# engine_chaos.py: kill, killnode, degraded, join, drainforce, refusal
# --------------------------------------------------------------------------- #
# mode: (I, W_node, tp, cap, edges, degrees, [(prompt, max_new), ...])
CHAOS = {
    "kill":       (4, 4, 2, 4096, (64, 160), (1, 2, 3),
                   [(24, 12), (90, 12), (180, 12)]),
    "killnode":   (8, 4, 1, 256, (100_000,), (1, 2),
                   [(420, 24), (16, 8), (24, 48)]),
    "degraded":   (2, 2, 2, 256, (100_000,), (1, 2), [(330, 24), (48, 12)]),
    "join":       (8, 4, 1, 128, (100_000,), (1, 2),
                   [(420, 40), (16, 4), (24, 64)]),
    "drainforce": (2, 2, 2, 256, (100_000,), (1, 2), [(330, 24), (48, 24)]),
    "refusal":    (2, 2, 2, 4096, (100_000,), (1, 1), [(24, 8), (48, 8)]),
}


@pytest.mark.parametrize("mode,pipeline,models",
                         [("kill", True, ARCH), ("kill", False, ARCH),
                          ("kill", True, MLA), ("killnode", True, ARCH),
                          ("degraded", True, ARCH), ("degraded", False, ARCH),
                          ("join", True, ARCH), ("drainforce", True, ARCH),
                          ("refusal", True, SSM), ("refusal", False, SSM)],
                         ids=["kill-pipe", "kill-nopipe", "kill-mla-pipe",
                              "killnode-pipe", "degraded-pipe",
                              "degraded-nopipe", "join-pipe",
                              "drainforce-pipe", "refusal-pipe",
                              "refusal-nopipe"],
                         indirect=["models"])
def test_engine_chaos(models, mode, pipeline):
    """An instance fails (or joins, or is force-drained) in the mid-flight
    window between a step's dispatch and its harvest.  ``kill``/
    ``killnode``: the watched request's MoE binding dies; its lost KV (MLA:
    its latent) is re-prefilled and every transcript still equals greedy.  ``degraded``/
    ``drainforce``: the survivor lacks headroom, so the big request
    finishes degraded with a greedy prefix, the other exactly.  ``join``:
    the dead instance rejoins, load spreads back onto it and the steady
    state returns to node-local rounds.  ``refusal`` (attention-free
    Mamba-2, whose SSM state is pinned to its slot): a drain raises
    ``UnsupportedDrainError`` and changes nothing; a crash then degrades
    only the requests whose slot it held."""
    _, _, cfg, params = models
    I, W, tp, cap, edges, degrees, reqs = CHAOS[mode]
    eng = _engine(cfg, params, I, W, tp, cap, edges, degrees, pipeline)
    ptrs = {k: v.data_ptr() for k, v in eng.state.items()}
    prompts = _add(eng, reqs)
    cl = eng.cluster
    max_steps = max(n for _, n in reqs) + 64
    eng.step()                                  # admission
    assert not cl.waiting, "all requests must admit at step 1"
    eng.step()
    watched = len(reqs) - 1 if mode == "kill" else 0
    degraded_ok = ()
    hp = eng.hot_path_stats

    if mode in ("kill", "killnode"):
        victim = cl.active[watched].moe_binding
        assert cl.page_table.shard_tokens(watched).get(victim, 0) > 0
        if mode == "kill":
            assert (eng._inflight is not None) == pipeline
            run_engine_with_chaos(eng, ChaosSchedule([ChaosEvent(0, KILL,
                                                                 victim)]),
                                  max_steps)
        else:
            eng.step()
            assert eng._inflight is not None, "kill must hit mid-flight"
            eng.fail_instance(victim)
            assert victim in cl.dead_instances
            _drain(eng, max_steps)
        assert hp["failures"] == 1 and hp["degraded_finishes"] == 0, hp
        assert hp["recovered_tokens"] > 0 and hp["reprefill_tokens"] > 0, hp
        assert eng.results[watched].recovered is True
        fin = {r.rid: r for r in eng.finished}
        assert victim not in fin[watched].kv_binding
        assert fin[watched].moe_binding != victim

    elif mode in ("degraded", "drainforce"):
        shards = cl.page_table.shard_tokens(0)
        victim = max(shards, key=shards.get)
        assert (eng._inflight is not None) == pipeline
        if mode == "degraded":
            degraded = eng.fail_instance(victim)
            assert hp["failures"] == 1
        else:
            eng.drain_instance(victim, force=True)
            assert hp["drains"] == 1 and hp["failures"] == 0, hp
            degraded = [r for r in eng.finished
                        if eng.results[r.rid].recovered is False]
        assert victim in cl.dead_instances
        assert cl.page_table.instance_used_tokens(victim) == 0
        assert [r.rid for r in degraded] == [0]
        assert eng.results[0].recovered is False
        assert hp["degraded_finishes"] == 1, hp
        degraded_ok = (0,)
        _drain(eng, max_steps)

    elif mode == "refusal":
        def snapshot():
            return (set(cl.dead_instances), dict(cl.slot_map),
                    {r: (q.moe_binding, list(q.kv_binding))
                     for r, q in cl.active.items()},
                    cl.page_table.frame_audit(), dict(hp),
                    {k: v.clone() for k, v in eng.state.items()})

        before = snapshot()
        with pytest.raises(UnsupportedDrainError, match="pins per-slot"):
            eng.drain_instance(0)
        after = snapshot()
        assert after[:5] == before[:5], "a refused drain mutated the cluster"
        assert all(torch.equal(after[5][k], v) for k, v in before[5].items())
        victim = cl.active[0].moe_binding
        on_victim = {r for r, (i, _) in cl.slot_map.items() if i == victim}
        degraded = eng.fail_instance(victim)
        assert {r.rid for r in degraded} == on_victim and 0 in on_victim
        assert eng.results[0].recovered is False
        degraded_ok = tuple(on_victim)
        _drain(eng, max_steps)
        assert hp["failures"] == 1, hp
        assert hp["degraded_finishes"] == len(on_victim), hp

    else:                                        # join
        victim = cl.active[watched].moe_binding
        eng.step()
        assert eng._inflight is not None
        eng.fail_instance(victim)
        seen = {"peak_nodes": 0, "joiner_loaded": False, "keys": None,
                "ring_misses": []}

        def on_step(step):
            if step == 8:
                eng.join_instance(victim)
                assert victim not in cl.dead_instances
                seen["keys"] = set(eng.aot.cached_keys())
            elif seen["keys"] is not None and eng.last_bucket[1] > 0:
                # a routed step after the join found its bucket cached: the
                # prewarm covered the wider ring reach
                if eng.last_bucket not in seen["keys"]:
                    seen["ring_misses"].append(eng.last_bucket)
            if watched in cl.active:
                seen["peak_nodes"] = max(seen["peak_nodes"], len(
                    cl.binding_nodes(cl.active[watched].kv_binding)))
            if seen["keys"] is not None and cl.kv_load(victim) > 0:
                seen["joiner_loaded"] = True

        _drain(eng, max_steps, on_step=on_step)
        assert hp["failures"] == 1 and hp["joins"] == 1, hp
        assert hp["degraded_finishes"] == 0, hp
        assert not seen["ring_misses"], seen["ring_misses"]
        assert seen["peak_nodes"] >= 2, "pressure never recruited node 1"
        assert seen["joiner_loaded"], "no load spread onto the joiner"
        assert eng.last_rounds_used <= node_local_rounds(W)

    _check_end(models, eng, prompts, reqs, ptrs, degraded_ok)


def test_seeded_chaos_schedule_is_the_references():
    """The schedule a seed gives is the reference's, event for event."""
    from repro.serving.chaos import ChaosSchedule as JChaosSchedule
    for seed in range(4):
        ours = ChaosSchedule.seeded(seed, 8, 40, kills=2, joins=1,
                                    protect=(0,))
        ref = JChaosSchedule.seeded(seed, 8, 40, kills=2, joins=1,
                                    protect=(0,))
        assert ([(e.step, e.action, e.instance) for e in ours.events]
                == [(e.step, e.action, e.instance) for e in ref.events])
        assert {e.action for e in ours.events} == {KILL, JOIN}
        assert ours.as_time_events(0.5) == ref.as_time_events(0.5)


# --------------------------------------------------------------------------- #
# engine_fault.py's drain cell and engine_multinode.py's place / escalate /
# conform cells (its drain cell is test_torch_engine.py's)
# --------------------------------------------------------------------------- #
# mode: (I, W_node, tp, cap, edges, degrees, prompt_lens, max_new)
CELLS = {
    "fault-drain": (4, 4, 2, 4096, (64, 160), (1, 2, 3), (24, 90, 180), 8),
    "place":       (8, 4, 1, 64, (100_000,), (1, 2), (300, 24), 4),
    "escalate":    (4, 2, 2, 48, (100_000,), (1, 2), (40,), 72),
    "conform":     (8, 4, 1, 4096, (100_000,), (1, 2), (24, 90, 180), 4),
}


@pytest.mark.parametrize("mode", list(CELLS))
def test_engine_fault_and_multinode(models, mode):
    """``fault-drain``: the instance with the most MoE bindings is drained
    mid-run (its KV evacuates, bindings rebalance off it) and the tokens
    stay equal.  ``place``: a request longer than its whole home node
    admits across the node boundary while a short one stays node-local.
    ``escalate``: decode growth exhausts the home node and escalation
    recruits a remote member.  ``conform``: plain traffic stays node-local.
    Tokens equal greedy in every cell."""
    _, _, cfg, params = models
    I, W, tp, cap, edges, degrees, plens, max_new = CELLS[mode]
    eng = _engine(cfg, params, I, W, tp, cap, edges, degrees)
    ptrs = {k: v.data_ptr() for k, v in eng.state.items()}
    reqs = [(L, max_new) for L in plens]
    prompts = _add(eng, reqs)
    cl = eng.cluster
    assert cl.num_nodes == I // W and cl.window == I
    eng.step()
    assert not cl.waiting, "all requests must admit at step 1"
    nodes = {rid: len(cl.binding_nodes(r.kv_binding))
             for rid, r in cl.active.items()}
    if mode == "place":
        assert nodes[0] >= 2 and nodes[1] == 1, nodes
    if mode == "conform":
        assert set(nodes.values()) == {1}, nodes
    eng.step()
    if mode == "fault-drain":
        eng.step()
        bindings = [r.moe_binding for r in cl.active.values()]
        victim = int(np.bincount(bindings, minlength=I).argmax())
        eng.drain_instance(victim)
        assert cl.page_table.instance_used_tokens(victim) == 0
        for rid, req in cl.active.items():
            assert victim not in req.kv_binding, (rid, req.kv_binding)
            assert req.moe_binding != victim
            assert cl.slot_map[rid][0] == req.moe_binding
    _drain(eng, max_new + 32)
    hp = eng.hot_path_stats
    fin = {r.rid: r for r in eng.finished}
    if mode == "fault-drain":
        assert hp["drains"] == 1, hp
    if mode == "escalate":
        assert hp["escalations"] + hp["spill_escalations"] >= 1, hp
        assert hp["reshard_tokens"] > 0
        assert len(cl.binding_nodes(fin[0].kv_binding)) >= 2
    if mode == "place":
        assert len(cl.binding_nodes(fin[0].kv_binding)) >= 2
    if mode == "conform":
        assert all(len(cl.binding_nodes(f.kv_binding)) == 1
                   for f in fin.values())
    _check_end(models, eng, prompts, reqs, ptrs)
