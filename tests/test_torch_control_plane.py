"""The port's host control plane (numpy copies of the scheduler, page table,
WaterFill, bucketing and routing-table lowering) held against the JAX
package's: one seeded request trace goes through both packages'
``DualBalancedScheduler.schedule`` + ``routing.lower_plan`` for many steps,
with arrivals, finishes, escalations and relaxations.  Every plan and every
lowered int32 table must be bit-equal.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import bucketing as jbucketing, routing as jrouting
from repro.core import scheduler as jscheduler, state as jstate
from repro_torch.core import bucketing, routing, scheduler, state

STEPS = 60
PAGE = 16


def _norm(x):
    """A comparable, package-free form of plans, records and tables."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, _norm(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    if isinstance(x, dict):
        return tuple(sorted((k, _norm(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return tuple(sorted(x))
    if isinstance(x, np.generic):
        return x.item()
    return x


def _trace(seed: int):
    """(arrival step, prompt_len, max_new_tokens) per request.  Request 0
    grows across two CPBuckets edges while it decodes (bucket escalations);
    the rest arrive over the first steps with mixed lengths."""
    rng = np.random.default_rng(seed)
    reqs = [(0, 40, 70)]
    for _ in range(11):
        reqs.append((int(rng.integers(0, 12)), int(rng.integers(10, 260)),
                     int(rng.integers(3, 40))))
    return reqs


def _drive(pkgs, I, node, stripes, seed):
    """Run the trace through one package's control plane; returns the
    per-step (plan, tables) records and the escalation/relaxation count."""
    bk, rt, sc, st = pkgs
    cluster = st.ClusterState(num_instances=I, instances_per_node=node,
                              kv_capacity_tokens=1024, page_size=PAGE,
                              kv_stripes=stripes)
    sched = sc.DualBalancedScheduler(
        buckets=bk.CPBuckets(edges=(48, 96), degrees=(1, 2, 3)),
        kv_reserve=PAGE, max_batch_per_instance=8)
    shape_buckets = bk.ShapeBuckets(m_buckets=(1, 2, 4, 8),
                                    s_buckets=(0, 1, 2, 4, 8), window=I)
    arena = rt.TableArena()
    pending = sorted(enumerate(_trace(seed)), key=lambda r: (r[1][0], r[0]))
    records, moves = [], {"escalations": 0, "relaxations": 0}
    for step in range(STEPS):
        while pending and pending[0][1][0] <= step:
            rid, (_, plen, new) = pending.pop(0)
            cluster.enqueue(st.Request(rid=rid, prompt_len=plen,
                                       max_new_tokens=new, arrival=step),
                            float(step))
        plan = sched.schedule(cluster, float(step))
        moves["escalations"] += len(plan.escalations)
        moves["relaxations"] += len(plan.relaxations)
        if not cluster.active:
            records.append((_norm(plan), None))
            continue
        next_tokens = {rid: (rid * 31 + step) % 256 for rid in cluster.active}
        tbl = rt.lower_plan(cluster, plan, buckets=shape_buckets,
                            append_tokens=True, next_tokens=next_tokens,
                            arena=arena)
        records.append((_norm(plan), _norm(tbl)))
        for rid in sorted(cluster.active):
            req = cluster.active[rid]
            req.generated += 1
            if req.done:
                cluster.finish(req, float(step))
    return records, moves


@pytest.mark.parametrize("I,node,stripes", [(4, 4, 1), (4, 2, 1), (2, 2, 2)],
                         ids=["4-one-node", "4-two-nodes", "2-striped"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plans_and_tables_bit_equal(I, node, stripes, seed):
    ref, ref_moves = _drive((jbucketing, jrouting, jscheduler, jstate),
                            I, node, stripes, seed)
    got, got_moves = _drive((bucketing, routing, scheduler, state),
                            I, node, stripes, seed)
    assert got_moves == ref_moves
    # the trace exercises the live re-shard paths the engine applies
    assert ref_moves["escalations"] >= 1, ref_moves
    assert len(got) == len(ref) == STEPS
    for step, (a, b) in enumerate(zip(got, ref)):
        assert a[0] == b[0], f"plan differs at step {step}"
        assert a[1] == b[1], f"tables differ at step {step}"
    # the trace runs to completion: every request was admitted and decoded
    assert sum(1 for _, t in got if t is not None) > STEPS // 2
