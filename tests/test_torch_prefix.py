"""The port's copies of the prefix cache (``core/prefix.py``), the streamed
handoff plan (``core/handoff.py``) and the serving metrics
(``serving/metrics.py``) held equal to the JAX package's on seeded inputs:
the same script of operations runs through both packages and every result
it records must be equal."""
import numpy as np
import pytest

from repro.core import handoff as jhandoff
from repro.core import page_table as jpage_table, prefix as jprefix
from repro.core.bucketing import CPBuckets as JCPBuckets
from repro.serving import metrics as jmetrics
from repro_torch.core import handoff, page_table, prefix
from repro_torch.core.bucketing import CPBuckets
from repro_torch.core.state import Request
from repro_torch.serving import metrics

PAGE = 16
PORT = (page_table, prefix)
JAX = (jpage_table, jprefix)


def _trie_script(mods, seed: int) -> list:
    """Admit requests sharing a few prompt heads (attaching to cached pages
    on a hit), register their pages, free them, evict under pressure with
    ``instance`` and ``keep``, release one instance and drop another.
    Returns the log of every result, the trie's stats and the page table's
    frame audit along the way."""
    pt_mod, px = mods
    I = 4
    pt = pt_mod.GlobalPageTable(I, frames_per_instance=24, page_size=PAGE)
    trie = px.PrefixTrie(PAGE)
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, 50, (k * PAGE,)).tolist() for k in (1, 2, 3)]
    log, live, rid = [], [], 0
    for _ in range(60):
        op = int(rng.integers(0, 6))
        if op <= 2:
            toks = heads[int(rng.integers(3))] + rng.integers(
                0, 50, (int(rng.integers(1, 2 * PAGE)),)).tolist()
            keys = px.page_keys(toks, PAGE)
            hit = trie.lookup(keys)
            inst = int(rng.integers(I))
            attach = {}
            if hit:
                owner = min(hit[-1][1])
                pages = [p for p, reps in hit if owner in reps]
                if pages == list(range(len(pages))):
                    attach = {owner: (0, [hit[p][1][owner] for p in pages])}
                    trie.touch(keys, [(p, owner) for p in pages])
            hit_tok = sum(len(f) for _, f in attach.values()) * PAGE
            split = {inst: len(toks) - hit_tok}
            if pt.pools[inst].free_frames < -(-split[inst] // PAGE) + 1:
                log.append(("evict", trie.evict(pt, 2, instance=inst,
                                                keep=keys)))
                continue
            pt.allocate(rid, split, prefix=attach or None)
            log.append(("admit", rid, hit_tok,
                        trie.insert(pt, rid, keys, len(toks))))
            live.append(rid)
            rid += 1
        elif op == 3 and live:
            victim = live.pop(int(rng.integers(len(live))))
            pt.free_request(victim)
            log.append(("free", victim))
        elif op == 4:
            log.append(("evict", trie.evict(pt, int(rng.integers(1, 4)))))
        else:
            keys = px.page_keys(heads[int(rng.integers(3))], PAGE)
            log.append(("lookup", [(p, sorted(r.items()))
                                   for p, r in trie.lookup(keys)]))
        log.append(("stats", trie.stats(), trie.cached_frames(1),
                    sorted(pt.frame_audit().items())))
    log.append(("release", trie.release_instance(pt, 2)))
    log.append(("drop", trie.drop_instance(3)))
    log.append(("chain", [len(trie.chain_of(k)) for k in sorted(trie.nodes)]))
    log.append(("stats", trie.stats(), sorted(pt.frame_audit().items())))
    log.append(("release_all", trie.release_all(pt)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_trie_script_equals_reference(seed):
    got, want = _trie_script(PORT, seed), _trie_script(JAX, seed)
    assert got == want
    assert any(e[0] == "admit" and e[2] > 0 for e in got), "no prefix hit"
    assert any(e[0] == "evict" and e[1] > 0 for e in got), "nothing evicted"


@pytest.mark.parametrize("seed", [0, 1])
def test_page_and_group_keys_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 15, 16, 47, 200):
        toks = rng.integers(0, 32000, (n,))
        assert prefix.page_keys(toks, PAGE) == jprefix.page_keys(toks, PAGE)
        assert prefix.page_keys(toks.astype(np.int32), 8) == \
            jprefix.page_keys(toks.tolist(), 8)
    for g in range(3):
        assert prefix.group_keys(g, 5) == jprefix.group_keys(g, 5)


def _handoff_script(mods, seed: int) -> list:
    """Chunk plans on seeded (hit, prompt, chunk) triples, then handoff
    tasks streamed to completion against seeded candidate lists."""
    hmod, buckets = mods
    rng = np.random.default_rng(seed)
    log = []
    for _ in range(20):
        chunk = PAGE * int(rng.integers(1, 5))
        prompt = int(rng.integers(1, 400))
        hit = PAGE * int(rng.integers(0, prompt // PAGE + 1))
        log.append([(c.start, c.end) for c in
                    hmod.plan_chunks(hit, prompt, chunk, PAGE)])
        task = hmod.HandoffTask(0, prompt, hit, chunk, PAGE, 7,
                                attach=tuple(sorted(
                                    set(rng.integers(0, 6, (2,)).tolist()))))
        while not task.done:
            cands = sorted(set(rng.integers(0, 6, (3,)).tolist()))
            c, dest = task.complete_chunk(buckets, cands)
            log.append((c.start, c.end, dest, task.streamed_tokens,
                        task.measured_tokens, task.remaining_tokens,
                        task.survived_tokens(), task.binding(),
                        task.measured_degree()))
    for bad in ((0, 10, 24), (8, 40, 32), (64, 40, 32)):
        with pytest.raises(ValueError):
            hmod.plan_chunks(*bad, PAGE)
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_handoff_plans_and_tasks_equal_reference(seed):
    got = _handoff_script(
        (handoff, CPBuckets(edges=(64, 160), degrees=(1, 2, 3))), seed)
    want = _handoff_script(
        (jhandoff, JCPBuckets(edges=(64, 160), degrees=(1, 2, 3))), seed)
    assert got == want and len(got) > 20


def _finished(seed: int) -> list:
    """A seeded finished list: staggered arrivals, token times with gaps,
    and every typed outcome."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(40):
        arrival = float(rng.uniform(0, 2))
        n = int(rng.integers(0, 12))
        first = arrival + float(rng.exponential(0.05))
        times = list(first + np.cumsum(rng.exponential(0.02, n)))
        r = Request(rid=rid, prompt_len=int(rng.integers(8, 4000)),
                    max_new_tokens=max(n, 1), arrival=arrival,
                    start_time=arrival + 0.01)
        r.status = ("finished", "finished", "finished", "oom", "degraded",
                    "rejected", "shed")[int(rng.integers(7))]
        if r.status in ("rejected", "shed"):
            times = []
        r.token_times = times
        r.finish_time = times[-1] if times else arrival + 0.5
        r.generated = len(times)
        out.append(r)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal_reference(seed):
    fin = _finished(seed)

    def table(m):
        return [
            [m.ttft(r) for r in fin], [m.tpot(r) for r in fin],
            [m.tpot_with_queueing(r) for r in fin],
            m.slo_attainment(fin, 0.03, submitted=50, ttft_slo=0.06),
            m.slo_attainment(fin, 0.05, tpot_fn=m.tpot_with_queueing),
            m.goodput(fin, 0.04, duration=3.0, submitted=50),
            m.goodput(fin, 0.05, ttft_slo=0.1),
            m.p99_tpot(fin), m.mean_tpot(fin), m.p99_ttft(fin),
            m.mean_ttft(fin), m.imbalance_pct([3, 5, 9, 1]),
            m.imbalance_pct([0, 0]),
            m.max_sustainable_rate(
                lambda rate: fin[:int(rate)], [5, 10, 20, 40], 0.05)]

    got, want = table(metrics), table(jmetrics)
    assert repr(got) == repr(want)
