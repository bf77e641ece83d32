"""Closed-loop SLO serving harness (§6): one trace, two execution tiers (a
copy of ``repro/serving/slo.py``).

Composes the pieces the repo already had into the loop the paper evaluates:
``AdmissionController`` (deadlines, shedding, preemption-by-relaxation) +
a workload trace + either execution tier —

- **simulator tier**: ``ClusterSimulator.run`` at paper scale (32xH200
  analytic data plane, real control plane);
- **engine tier**: the REAL ``NanoCPEngine`` driven on a *virtual model
  clock* — every ``step(now=...)`` advances ``now`` by the shadow
  simulator's analytic iteration time for the engine's own cluster state.
  Tokens, admission, preemption, page tables, and re-shard collectives are
  all real; only the wall clock is modeled, so SLO timing is deterministic
  (CI-stable) and directly comparable to the simulator tier on the same
  trace (the sim-vs-engine parity smoke).

Both tiers return the same ``(finished, submitted)`` shape the honest
metrics take, so a request that never ran still counts as a violation.
"""
from __future__ import annotations

from collections import Counter

from ..core.scheduler import _fill_plan, _mk_plan
from . import metrics
from .simulator import ClusterSimulator
from .workload import TraceRequest, Workload

# typed-outcome keys reported by ``summarize`` (superset of
# metrics.VIOLATION_STATUSES plus the success bucket)
OUTCOMES = ("finished", "oom", "degraded", "rejected", "shed")


def make_tiny_trace(n_short: int, n_long: int, *, gap: float,
                    short_len: int = 8, long_len: int = 48,
                    decode: int = 6, start: float = 0.0) -> Workload:
    """Deterministic engine-scale trace: ``n_short`` short and ``n_long``
    long requests interleaved at a fixed ``gap`` between arrivals (long
    ones first at each arrival tie, so admission ordering — not arrival
    luck — decides who runs).  Lengths are engine-sized (tens of tokens);
    pair with an ``AdmissionController(long_threshold=...)`` between the
    two lengths."""
    reqs, t, rid = [], start, 0
    for i in range(max(n_short, n_long)):
        if i < n_long:
            reqs.append(TraceRequest(rid, t, long_len, decode))
            rid += 1
        if i < n_short:
            reqs.append(TraceRequest(rid, t, short_len, decode))
            rid += 1
        t += gap
    return Workload(f"tiny_{n_short}s_{n_long}l", reqs)


def outcome_counts(finished) -> dict:
    """Typed-outcome histogram over a finished list; conservation check
    material (every submitted request must land in exactly one bucket)."""
    c = Counter(getattr(r, "status", "finished") for r in finished)
    return {k: c.get(k, 0) for k in OUTCOMES}


def summarize(finished, submitted: int, *, slo: float, ttft_slo=None,
              duration=None, tpot_fn=None) -> dict:
    """The sweep's per-run metric row, honest denominator throughout."""
    return {
        "submitted": int(submitted),
        "attainment": metrics.slo_attainment(
            finished, slo, submitted=submitted, ttft_slo=ttft_slo,
            tpot_fn=tpot_fn),
        "goodput": metrics.goodput(
            finished, slo, duration=duration, submitted=submitted,
            ttft_slo=ttft_slo, tpot_fn=tpot_fn),
        "p99_tpot": metrics.p99_tpot(finished, tpot_fn),
        "mean_tpot": metrics.mean_tpot(finished, tpot_fn),
        "p99_ttft": metrics.p99_ttft(finished),
        "mean_ttft": metrics.mean_ttft(finished),
        "outcomes": outcome_counts(finished),
    }


def run_sim_trace(sim: ClusterSimulator, workload: Workload, *,
                  horizon: float | None = None):
    """Simulator tier: returns ``(finished, submitted, res)``."""
    res = sim.run(workload, horizon=horizon)
    return res.finished, res.submitted, res


def run_engine_clocked(eng, workload: Workload, *, shadow: ClusterSimulator,
                       max_iters: int = 4000):
    """Engine tier on the virtual model clock.

    ``shadow`` must be built with the engine's cfg and cluster geometry; it
    is re-pointed at the engine's LIVE cluster so its analytic
    ``_iteration_time`` prices exactly the plan the engine just ran.
    Prompts are synthesized deterministically from the trace (rid-seeded),
    so the same trace always produces the same tokens AND the same SLO
    timeline.  Returns ``(finished, submitted, now)``.
    """
    shadow.cluster = eng.cluster
    arrivals = sorted(workload.requests, key=lambda r: r.arrival)
    ai, now = 0, 0.0
    for _ in range(max_iters):
        while ai < len(arrivals) and arrivals[ai].arrival <= now:
            tr = arrivals[ai]
            prompt = [1 + (tr.rid * 31 + k) % 97 for k in range(tr.prompt_len)]
            eng.add_request(prompt, tr.max_new_tokens, now=tr.arrival)
            ai += 1
        idle = not (eng.cluster.active or eng.cluster.waiting
                    or eng._inflight is not None)
        if idle:
            if ai >= len(arrivals):
                break
            now = max(now, arrivals[ai].arrival)
            continue
        eng.step(now=now)
        # price the iteration the engine just ran: the plan is rebuilt from
        # the live cluster (active set + page table) post-step, the exact
        # state the analytic model charges for in the simulator tier
        if eng.cluster.active:
            plan = _fill_plan(eng.cluster, _mk_plan(eng.cluster))
            t_iter, _, _, _ = shadow._iteration_time(plan)
            now += t_iter
        else:
            # nothing ran (queue blocked or trailing harvest): the clock
            # still advances by the control-plane overhead so queued
            # deadlines can expire instead of freezing time
            now += shadow.sched_overhead
    return list(eng.finished), len(arrivals), now
