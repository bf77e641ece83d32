"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and a cell's rate, and makes every request of a
run: its schedule from the mix's ``trace_seed``, its token ids from the
run's seed.

Frozen here from the program's ``serving/workload.py`` (Table 1's
ShareGPT-4o intervals, log-uniform lengths inside an interval, Poisson
arrivals), with changes that keep the work of a run the same from seed to
seed:

- the number of arrivals in a phase is fixed (rate x seconds), and their
  times are a Poisson process conditioned on that count;
- prompt and output lengths are stratified: the i-th of n lengths is the
  mixture's quantile at (i + 1/2) / n, the same multiset for every run;
- arrival times, and which lengths arrive when, are drawn from the mix's
  ``trace_seed``: one fixed trace per mix and rate, replayed by every run,
  as a recorded trace would be, so that every run of a cell serves the same
  arrivals and the spread between runs is the system's, not the trace's.
  The run's seed draws the token ids (and, elsewhere, the weights and the
  checked sample).

A run's arrivals come in three phases: the lead-in (before the window),
the window, and the drain (after the window, so that the requests of the
window finish under the same load).  A mix may also hold long
``sessions``, prefilled in set-up, which decode through all three.

Mix keys: ``trace_seed``; ``prompt_intervals`` [[lo, hi, share], ...]
(shares renormalised over the listed intervals); ``output_tokens``
[lo, hi] (log-uniform); ``sessions`` {count, prompt_tokens,
max_new_tokens} (optional).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Arrival:
    due: float               # seconds from the window's start (< 0: lead-in)
    prompt: np.ndarray       # int64 token ids
    max_new_tokens: int
    phase: str               # "session", "lead_in", "window" or "drain"


def _log_uniform(lo: float, hi: float, t: float) -> int:
    return int(math.exp(math.log(lo) + t * (math.log(hi) - math.log(lo))))


def prompt_quantile(mix: dict, u: float) -> int:
    """The mixture's prompt length at quantile ``u`` in [0, 1)."""
    table = mix["prompt_intervals"]
    total = sum(p for _, _, p in table)
    acc = 0.0
    for lo, hi, p in table:
        share = p / total
        if u < acc + share or (lo, hi, p) == tuple(table[-1]):
            return _log_uniform(lo, hi, min((u - acc) / share, 1.0))
        acc += share
    raise AssertionError("unreachable")


def stratified_lengths(mix: dict, n: int) -> tuple[list, list]:
    """The n prompt and output lengths of a phase, before shuffling."""
    us = [(i + 0.5) / n for i in range(n)]
    lo, hi = mix["output_tokens"]
    return ([prompt_quantile(mix, u) for u in us],
            [_log_uniform(lo, hi, u) for u in us])


def poisson_times(rng: np.random.Generator, n: int, seconds: float) -> list:
    """n arrival times in [0, seconds) of a Poisson process conditioned on
    n arrivals: normalised cumulative exponential gaps."""
    gaps = rng.exponential(1.0, n + 1)
    return list(np.cumsum(gaps)[:n] / gaps.sum() * seconds)


def generate(mix: dict, *, rate: float, lead_in_s: float, window_s: float,
             vocab: int, seed: int, drain_s: float = 0.0) -> list:
    """Every request of a run, sessions first, then by due time."""
    ids = np.random.default_rng([int(seed), 0x7AFF1C])
    out = []
    s = mix.get("sessions")
    if s:
        for _ in range(s["count"]):
            out.append(Arrival(float("-inf"),
                               ids.integers(0, vocab, s["prompt_tokens"]),
                               s["max_new_tokens"], "session"))
    for k, (phase, start, seconds) in enumerate(
            (("lead_in", -lead_in_s, lead_in_s), ("window", 0.0, window_s),
             ("drain", window_s, drain_s))):
        n = int(round(rate * seconds))
        if n == 0:
            continue
        trace = np.random.default_rng([int(mix["trace_seed"]), k])
        prompts, outputs = stratified_lengths(mix, n)
        p_order, o_order = trace.permutation(n), trace.permutation(n)
        times = poisson_times(trace, n, seconds)
        for j in range(n):
            out.append(Arrival(float(start + times[j]),
                               ids.integers(0, vocab, prompts[p_order[j]]),
                               outputs[o_order[j]], phase))
    return out
