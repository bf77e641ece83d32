"""The serving engine's tracer (``repro_torch/serving/trace.py``) on the CPU.

Reduced TinyLlama engines at (4, 2) as ``test_torch_engine.py`` builds them
(the port's own random weights: no transcript is checked against JAX
here, only that tracing changes none).  With tracing off the engine keeps
its ``timings`` and records nothing; on, every step is one root span tiled
by its phases, each request's spans share its id, the per-instance KV
counter equals a scan of the page table at dispatch, and a span maps onto
``torch.profiler``'s timeline.
"""
import inspect
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.bucketing import CPBuckets, ShapeBuckets
from repro_torch.core.scheduler import DualBalancedScheduler
from repro_torch.models import init_params
from repro_torch.serving import trace
from repro_torch.serving.engine import NanoCPEngine

PROMPT_LENS = (50, 300, 120, 40, 200)
NEW_TOKENS = 5
PHASES = ["engine.handoff", "scheduler.schedule", "engine.reshard",
          "engine.prefill", "routing.lower", "aot.lookup", "engine.harvest",
          "routing.tables", "dcp.dispatch", "engine.bookkeeping"]
# without the pipeline the step harvests its own iteration after dispatch
PHASES_NOPIPE = [p for p in PHASES if p != "engine.harvest"] + [
    "engine.harvest"]
TIMING_KEYS = {"handoff_us", "reshard_us", "prefill_us", "lower_us",
               "lookup_us", "harvest_us", "tables_us", "dispatch_us",
               "step_us"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = reduced(CONFIGS["tinyllama-1.1b"], num_layers=2, vocab_size=256)
    return cfg, init_params(cfg, 0, device="cpu", dtype=torch.float32)


def _engine(model, pipeline=True):
    cfg, params = model
    return NanoCPEngine(cfg, params, num_instances=4, instances_per_node=4,
                        kv_capacity_tokens=2048, page_size=16, tp=2,
                        buckets=CPBuckets(edges=(100, 256),
                                          degrees=(1, 2, 3)),
                        shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                   s_buckets=(0, 1, 2, 4),
                                                   window=4),
                        pipeline=pipeline, device="cpu")


def _cell_engine(model, cap, edges, escalate):
    """(2, 2) with a pool of a few pages per instance (the spill cells of
    ``test_torch_engine.py``)."""
    cfg, params = model
    sched = DualBalancedScheduler(
        buckets=CPBuckets(edges=edges, degrees=(1, 2)), allow_rebalance=True,
        max_batch_per_instance=4, has_kv=True, kv_reserve=16,
        allow_escalation=escalate)
    return NanoCPEngine(cfg, params, num_instances=2, instances_per_node=2,
                        tp=2, kv_capacity_tokens=cap, page_size=16,
                        scheduler=sched,
                        shape_buckets=ShapeBuckets(m_buckets=(1, 2, 4),
                                                   s_buckets=(0, 1, 2, 4),
                                                   window=2),
                        max_slots_per_instance=4, device="cpu")


def _serve(eng, traced: bool, scan=None):
    """The five prompts through ``eng``; returns each step's ``timings``
    (a copy) and each step's ``scan()`` taken at dispatch."""
    rng = np.random.default_rng(0)
    if traced:
        eng.tracer.start()
    for L in PROMPT_LENS:
        eng.add_request(rng.integers(0, 256, (L,)), max_new_tokens=NEW_TOKENS)
    scans = []
    if scan is not None:
        copy = eng._start_token_copy

        def at_dispatch(toks):
            scans.append(scan(eng))
            return copy(toks)
        eng._start_token_copy = at_dispatch
    timings, it = [], 0
    while eng.pending and it < 30:
        eng.step()
        timings.append(dict(eng.timings))
        it += 1
    if traced:
        eng.tracer.stop()
    return timings, scans


def _kv_scan(eng):
    """Per instance, the KV tokens of every request the page table holds,
    and whether one of them finishes at this dispatch."""
    pt, cl = eng.cluster.page_table, eng.cluster
    kv = [sum(pt.shard_tokens(rid).get(i, 0) for rid in cl.active)
          for i in range(cl.num_instances)]
    finishing = [rid for rid, req in cl.active.items()
                 if len(eng.results[rid].tokens) + 1 >= req.max_new_tokens]
    return kv, finishing


@pytest.fixture(scope="module")
def runs(model):
    out = {}
    for name, traced, pipeline in (("off", False, True), ("on", True, True),
                                   ("on-nopipe", True, False)):
        eng = _engine(model, pipeline)
        timings, scans = _serve(eng, traced,
                                _kv_scan if name == "on" else None)
        out[name] = (eng, timings, scans)
    return out


def _roots(tr):
    return sorted((s for s in tr.spans if s.name == "engine.step"),
                  key=lambda s: s.attrs["step"])


def test_tracing_off_records_nothing_and_keeps_the_timings(runs):
    eng, timings, _ = runs["off"]
    assert eng.tracer.spans == [] and eng.tracer.counters == []
    assert all(set(t) <= TIMING_KEYS and "step_us" in t for t in timings)
    assert set().union(*timings) >= TIMING_KEYS - {"handoff_us",
                                                   "reshard_us"}
    on = runs["on"][0]
    assert ({r: x.tokens for r, x in eng.results.items()}
            == {r: x.tokens for r, x in on.results.items()})


@pytest.mark.parametrize("run,order", [("on", PHASES),
                                       ("on-nopipe", PHASES_NOPIPE)],
                         ids=["pipelined", "non-pipelined"])
def test_each_step_is_one_root_tiled_by_its_phases(runs, run, order):
    eng, timings, _ = runs[run]
    tr = eng.tracer
    roots = _roots(tr)
    assert [r.attrs["step"] for r in roots] == list(range(1, len(timings)
                                                          + 1))
    for root, tm in zip(roots, timings):
        kids = tr.children(root.id)
        names = [s.name for s in kids]
        assert names == sorted(names, key=order.index), names
        assert kids[0].start == root.start and kids[-1].end <= root.end
        assert all(a.end == b.start for a, b in zip(kids, kids[1:]))
        assert root.attrs["decoded"] == ("dcp.dispatch" in names)
        assert tm["step_us"] == (root.end - root.start) / 1e3
        for s in kids:
            key = trace.TIMING_KEYS.get(s.name)
            if key is not None:
                assert tm[key] == (s.end - s.start) / 1e3, (s.name, tm)
        assert {trace.TIMING_KEYS[n] for n in names
                if n in trace.TIMING_KEYS} | {"step_us"} == set(tm)


def test_a_step_that_returns_early_closes_its_root(runs):
    eng, timings, _ = runs["on"]
    last = _roots(eng.tracer)[-1]
    assert [s.name for s in eng.tracer.children(last.id)] == [
        "scheduler.schedule", "engine.harvest"]
    assert not last.attrs["decoded"] and "step_us" in timings[-1]


def test_a_spill_to_oom_closes_its_root_and_the_reshard_nests(model):
    """The ``oom`` cell (pools run out mid-decode: spill escalations, then
    an OOM finish that leaves nothing active, so the step returns from its
    spill loop) and the ``spill`` cell (the scheduler's escalation off:
    every relief is a spill re-shard inside ``routing.lower``)."""
    for cap, edges, plen, max_new, escalate, oom in (
            (48, (16,), 24, 100, True, True),
            (96, (100_000,), 40, 64, False, False)):
        eng = _cell_engine(model, cap, edges, escalate)
        tr = eng.tracer
        tr.start()
        rid = eng.add_request(np.arange(plen) % 256, max_new_tokens=max_new)
        timings = []
        while eng.pending and len(timings) < max_new + 32:
            eng.step()
            timings.append(dict(eng.timings))
        tr.stop()
        byid = {s.id: s for s in tr.spans}
        roots = _roots(tr)
        assert len(roots) == len(timings)
        nested = [s for s in tr.spans if s.name == "engine.reshard"
                  and byid[s.parent].name == "routing.lower"]
        assert (sum(s.attrs["escalations"] for s in nested)
                == eng.hot_path_stats["spill_escalations"])
        assert nested or escalate
        for s in nested:
            lower = byid[s.parent]
            assert lower.start <= s.start <= s.end <= lower.end
            step = next(i for i, r in enumerate(roots)
                        if r.id == lower.parent)
            phase = sum(k.end - k.start for k in tr.children(roots[step].id)
                        if k.name == "engine.reshard")
            assert timings[step].get("reshard_us", 0.0) == phase / 1e3
        decode = tr.request(rid)[-1]
        assert eng.results[rid].oom == oom
        if oom:
            assert decode.attrs["finish"] == "oom"
            root = next(r for r in roots if r.end == decode.end)
            assert [s.name for s in tr.children(root.id)][-2:] == [
                "routing.lower", "engine.harvest"]
        else:
            assert decode.attrs["finish"] == "length"


def test_each_request_has_its_spans_under_one_rid(runs):
    eng, _, _ = runs["on"]
    tr = eng.tracer
    byid = {s.id: s for s in tr.spans}
    reqs = {r.rid: r for r in eng.finished}
    assert sorted(reqs) == list(range(len(PROMPT_LENS)))
    for rid, req in reqs.items():
        q, p, d = tr.request(rid)
        assert [q.name, p.name, d.name] == ["request.queued",
                                            "request.prefill",
                                            "request.decode"]
        assert q.end - q.start == round((req.start_time - req.arrival) * 1e9)
        assert q.attrs["wait_s"] == req.start_time - req.arrival
        sched = byid[q.parent]
        assert sched.name == "scheduler.schedule"
        assert q.end == byid[sched.parent].start    # the admitting step
        pre = byid[p.parent]
        assert pre.name == "engine.prefill"
        assert (p.start, p.end) == (pre.start, pre.end)
        assert p.attrs["prompt_tokens"] == PROMPT_LENS[rid]
        assert d.parent == p.id and p.end <= d.start <= d.end
        assert d.attrs == {"rid": rid, "tokens": NEW_TOKENS,
                           "finish": "length"}
        # the decode span runs from the step that returned the first token
        # to the step that returned the last
        assert d.start == byid[pre.parent].end
        assert any(r.end == d.end for r in _roots(tr))


def test_the_kv_counter_equals_a_scan_of_the_page_table(runs):
    eng, _, scans = runs["on"]
    counts = eng.tracer.counters
    assert len(counts) == len(scans) == eng.hot_path_stats["steps"]
    finishing = 0
    for c, (kv, ending) in zip(counts, scans):
        assert c.name == "dcp.dispatch"
        assert c.values["kv_tokens"] == kv
        finishing += len(ending)
    assert finishing == len(PROMPT_LENS)
    roots = {r.attrs["step"]: r for r in _roots(eng.tracer)}
    for c in counts:
        disp = [s for s in eng.tracer.children(roots[c.step].id)
                if s.name == "dcp.dispatch"]
        assert [s.end for s in disp] == [c.t]
        assert len(c.values["bucket"]) == 5 and c.values["rounds"] >= 0


def test_the_rows_counter_is_the_plans_batch_sizes(model):
    eng = _engine(model)
    eng.tracer.start()
    rng = np.random.default_rng(1)
    for L in PROMPT_LENS:
        eng.add_request(rng.integers(0, 256, (L,)), max_new_tokens=NEW_TOKENS)
    while eng.pending:
        eng.step()
        if "dispatch_us" in eng.timings:
            c = eng.tracer.counters[-1]
            assert c.values["rows"] == eng.last_batch_sizes.tolist()
            assert c.values["rounds"] == eng.last_rounds_used
            assert c.values["bucket"] == eng.last_bucket
    eng.tracer.stop()


@pytest.mark.parametrize("traced", [False, True], ids=["off", "on"])
def test_drain_and_compact_are_roots_and_leave_the_steps_timings(model,
                                                                 traced):
    """Between steps a drain and a compact re-shard KV; they are spans of
    their own and write nothing into the last step's ``timings``."""
    eng = _engine(model)
    cl = eng.cluster
    if traced:
        eng.tracer.start()
    rng = np.random.default_rng(0)
    for L in (24, 90, 180):
        eng.add_request(rng.integers(0, 256, (L,)), max_new_tokens=12)
    for _ in range(3):
        eng.step()
    before = dict(eng.timings)
    victim = int(np.bincount([r.moe_binding for r in cl.active.values()],
                             minlength=4).argmax())
    assert eng.drain_instance(victim)
    assert eng.compact()
    assert eng.timings == before
    while eng.pending:
        eng.step()
    if not traced:
        assert eng.tracer.spans == []
        return
    eng.tracer.stop()
    tr = eng.tracer
    for name in ("engine.drain", "engine.compact"):
        (root,) = [s for s in tr.spans if s.name == name]
        assert root.parent == 0
        (kid,) = tr.children(root.id)
        assert kid.name == "engine.reshard"
        assert root.start <= kid.start <= kid.end <= root.end
    assert [s for s in tr.spans if s.name == "engine.drain"][0].attrs[
        "instance"] == victim


@pytest.mark.parametrize("traced", [False, True], ids=["off", "on"])
def test_the_expert_bins_counter_is_the_steps_routes(monkeypatch, traced):
    """Reduced Phi-3.5-MoE at (4, 2), capacity factor E/k: each harvested
    step's ``moe.expert_bins`` counter sums ``bin_rows`` of the routes its
    MoE layers took (taken again from each layer's input), counts the
    capacity bins and the experts reached, under the dispatching step's
    number; with tracing off no bins are copied and no counter kept."""
    from repro_torch.core import dcp
    from repro_torch.models import moe
    cfg = reduced(CONFIGS["phi3.5-moe-42b-a6.6b"], num_layers=2,
                  vocab_size=256, capacity_factor=2.0)
    eng = _engine((cfg, init_params(cfg, 0, device="cpu",
                                    dtype=torch.float32)))
    layers, real = [], dcp.moe_decode_ffn

    def routed(cfg, p, x, *, data_size, tp, fill=None):
        _, idx = moe.router_topk(cfg, p["router"],
                                 x.reshape(data_size, -1, x.shape[-1]))
        layers.append((x.shape[0] // data_size,
                       moe.bin_rows(idx, cfg.num_experts)))
        return real(cfg, p, x, data_size=data_size, tp=tp, fill=fill)
    monkeypatch.setattr(dcp, "moe_decode_ffn", routed)
    copies, host_copy = [], eng._host_copy

    def copied(t):
        copies.append(t.shape)
        return host_copy(t)
    monkeypatch.setattr(eng, "_host_copy", copied)
    _serve(eng, traced)
    bins = [c for c in eng.tracer.counters if c.name == "moe.expert_bins"]
    if not traced:
        assert layers and not copies and not bins
        return
    dispatches = [c for c in eng.tracer.counters if c.name == "dcp.dispatch"]
    L, E, I = cfg.num_layers, cfg.num_experts, 4
    assert len(layers) == L * len(dispatches)
    assert len(bins) == len(copies) == len(dispatches) > 0
    assert set(copies) == {(L, I, E)}
    for n, (c, d) in enumerate(zip(bins, dispatches)):
        T = layers[n * L][0]
        routes = torch.stack([b for _, b in layers[n * L:(n + 1) * L]])
        assert c.step == d.step
        assert c.values == {
            "rows": int(routes.sum()),
            "padded_rows": L * E * I * moe.capacity(cfg, T),
            "experts_touched": float((routes.sum(1) > 0).sum(1).float()
                                     .mean())}


def test_a_span_maps_onto_the_profilers_timeline():
    """A tracer span around each ``record_function`` block lands on the
    profiler's (kineto's) clock within 50 us of the block's own edges."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = trace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        tr.start()
        for i in range(5):
            with tr.span("outer", i=i):
                with record_function(f"block{i}"):
                    time.sleep(0.005)
        tr.stop()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = [s for s in tr.spans if s.name == "outer"]
    assert len(spans) == 5 and abs(tr.drift_ns) < 50_000
    for s in spans:
        e = events[f"block{s.attrs['i']}"]
        start, end = tr.to_profiler_ns(s.start), tr.to_profiler_ns(s.end)
        assert start - 50_000 <= e.start_ns() and e.end_ns() <= end + 50_000
        assert e.start_ns() - start < 50_000 and end - e.end_ns() < 50_000


def test_the_step_reads_no_clock_of_its_own():
    src = "".join(inspect.getsource(f) for f in (
        NanoCPEngine.step, NanoCPEngine._step, NanoCPEngine._harvest,
        NanoCPEngine._apply_escalations))
    assert "perf_counter" not in src and "time." not in src
