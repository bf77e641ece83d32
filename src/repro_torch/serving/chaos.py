"""Deterministic chaos harness: scripted membership changes for the engine
(a copy of ``repro/serving/chaos.py``, numpy only).

Fault tolerance is only testable if the faults are REPRODUCIBLE: a chaos run
that kills a different instance at a different step on every execution cannot
gate CI.  This module pins the whole schedule — which instance, which action,
which step — either explicitly or from a seed (``ChaosSchedule.seeded``), so
a failing cell replays bit-for-bit.

``run_engine_with_chaos`` drives a real ``NanoCPEngine`` step loop, applying
each step's events BEFORE the step dispatches — i.e. between the previous
dispatch and its harvest, the mid-flight window the engine's failure path
must survive.  The loop is BOUNDED: exceeding the step budget is an
assertion (the "failure never hangs" invariant), not a timeout.
``as_time_events`` gives the same events time-stamped, for a simulator's
clock.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

KILL = "kill"
JOIN = "join"


@dataclass(frozen=True)
class ChaosEvent:
    step: int                 # engine iteration index the event fires before
    action: str               # "kill" | "join"
    instance: int

    def __post_init__(self):
        assert self.action in (KILL, JOIN), self.action
        assert self.step >= 0 and self.instance >= 0


@dataclass
class ChaosSchedule:
    events: list = field(default_factory=list)

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: (e.step, e.action))

    def at(self, step: int) -> list:
        return [e for e in self.events if e.step == step]

    @property
    def max_step(self) -> int:
        return max((e.step for e in self.events), default=0)

    @classmethod
    def seeded(cls, seed: int, num_instances: int, horizon: int,
               kills: int = 1, joins: int = 0,
               protect: tuple = ()) -> "ChaosSchedule":
        """A reproducible random kill/join schedule.

        Kills pick distinct instances outside ``protect``; each join
        revives a previously killed instance at a later step (a join with
        nothing dead would be a no-op membership-wise).  ``horizon`` bounds
        the step indices so the schedule fits inside a test's step budget.
        """
        rng = np.random.default_rng(seed)
        cands = [i for i in range(num_instances) if i not in protect]
        assert kills <= len(cands), (kills, cands)
        victims = list(rng.choice(cands, size=kills, replace=False))
        events = []
        dead = []
        for v in victims:
            step = int(rng.integers(1, max(horizon // 2, 2)))
            events.append(ChaosEvent(step, KILL, int(v)))
            dead.append((step, int(v)))
        rng.shuffle(dead)
        for step_k, v in dead[:joins]:
            step = int(rng.integers(step_k + 1, max(horizon, step_k + 2)))
            events.append(ChaosEvent(step, JOIN, v))
        return cls(events)

    def as_time_events(self, t_per_step: float) -> list:
        """[(time, action, instance), ...] for the simulator's clock."""
        return [(e.step * t_per_step, e.action, e.instance)
                for e in self.events]


def apply_event(engine, ev: ChaosEvent) -> list:
    """Fire one event against a live engine.  Returns the degraded-finished
    requests (kill) or [] (join)."""
    if ev.action == KILL:
        return engine.fail_instance(ev.instance)
    engine.join_instance(ev.instance)
    return []


def run_engine_with_chaos(engine, schedule: ChaosSchedule,
                          max_steps: int) -> dict:
    """Drive the engine to completion under the schedule, bounded.

    Events fire BEFORE their step's dispatch — i.e. while the previous
    iteration is still in flight (the harvest hasn't happened), exercising
    the mid-flight discard path.  Asserts the cluster fully drains within
    ``max_steps`` iterations: a hung recovery fails the assertion rather
    than wedging the test run."""
    steps = 0
    while (engine.cluster.active or engine.cluster.waiting
           or engine._inflight is not None):
        assert steps < max_steps, \
            f"chaos run exceeded {max_steps} steps — recovery hung"
        for ev in schedule.at(steps):
            apply_event(engine, ev)
        engine.step()
        steps += 1
    # late events beyond the drain point still fire (e.g. a join scheduled
    # after the last request finished)
    for s in range(steps, schedule.max_step + 1):
        for ev in schedule.at(s):
            apply_event(engine, ev)
    return engine.results
