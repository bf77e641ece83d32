"""Synthetic variable-length workload traces (§2.1, Table 1); a copy of
``repro/serving/workload.py``, numpy only.

Reproduces the paper's evaluation mix: ShareGPT-4o-like short conversational
requests blended with GitHub-Issue-like long-context requests at a given
long-request ratio (1% / 5% in the paper), with Poisson arrivals.  Interval
shares follow Table 1; lengths inside an interval are log-uniform.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.prefix import group_keys

# Table 1 interval shares: (lo, hi, probability)
SHAREGPT_4O = [(64, 1_000, 0.857), (1_000, 10_000, 0.107),
               (10_000, 100_000, 0.035)]
GITHUB_ISSUE = [(100_000, 500_000, 0.6506), (500_000, 1_000_000, 0.3494)]
OPENROUTER = [(64, 1_000, 0.3182), (1_000, 10_000, 0.5008),
              (10_000, 100_000, 0.1642), (100_000, 500_000, 0.0167)]

DATASETS = {"sharegpt4o": SHAREGPT_4O, "github_issue": GITHUB_ISSUE,
            "openrouter": OPENROUTER}


def _sample_interval(rng: np.random.Generator, table) -> int:
    ps = np.array([p for _, _, p in table])
    ps = ps / ps.sum()
    i = rng.choice(len(table), p=ps)
    lo, hi, _ = table[i]
    return int(np.exp(rng.uniform(np.log(lo), np.log(hi))))


@dataclass
class TraceRequest:
    rid: int
    arrival: float
    prompt_len: int
    max_new_tokens: int
    # content keys of the prompt's cacheable page chain (empty = unique
    # prompt).  Synthetic traces derive them from a shared-prefix GROUP via
    # ``core.prefix.group_keys`` — requests in the same group share a chain
    # prefix, so the simulator's prefix cache sees the same hit structure a
    # token-level trace would produce
    prefix_keys: tuple = ()


@dataclass
class Workload:
    """A reproducible request trace."""
    name: str
    requests: list = field(default_factory=list)

    def interval_shares(self, edges=(1_000, 10_000, 100_000, 500_000)) -> dict:
        lens = np.array([r.prompt_len for r in self.requests])
        out, lo = {}, 0
        for e in (*edges, np.inf):
            key = f"{lo}-{e}"
            # an empty trace (rate * duration rounded down to zero arrivals)
            # has zero share everywhere — not a NaN that poisons the sweep
            out[key] = (float(((lens >= lo) & (lens < e)).mean())
                        if lens.size else 0.0)
            lo = e
        return out

    def prefix_share(self, page_size: int = 64) -> float:
        """Fraction of trace prompt tokens covered by shared-prefix key
        chains (key chains are page-granular: each key pins ``page_size``
        tokens).  0.0 for traces generated without ``shared_prefix_groups``
        — the realized knob the share-ratio sweep varies."""
        tot = sum(r.prompt_len for r in self.requests)
        if tot == 0:
            return 0.0
        shared = sum(min(len(r.prefix_keys) * page_size, r.prompt_len)
                     for r in self.requests)
        return shared / tot


def shares_table(shares: dict) -> list:
    """An ``[(lo, hi, p)]`` sampling table from a *measured*
    ``Workload.interval_shares()`` dict (``{"lo-hi": share}``) — the
    closed loop of the SLO sweep: measure a live trace's interval
    distribution, then regenerate matched synthetic traffic from it
    instead of the two-point long-ratio blend.  Zero-share intervals are
    dropped; the unbounded tail bucket (``"...-inf"``) is clamped to the
    generator's 1M-token ceiling (Table 1's own max)."""
    table = []
    for key, p in shares.items():
        if not p > 0:
            continue
        lo_s, _, hi_s = key.partition("-")
        lo = max(int(float(lo_s)), 64)       # log-uniform needs lo > 0
        hi = float(hi_s)
        hi = 1_000_000 if not np.isfinite(hi) else int(hi)
        if hi <= lo:
            raise ValueError(f"shares_table: bad interval {key!r}")
        table.append((lo, hi, float(p)))
    if not table:
        raise ValueError("shares_table: every interval has zero share")
    return table


def make_workload(kind: str, *, rate: float, duration: float,
                  long_ratio: float = 0.0, seed: int = 0,
                  decode_lo: int = 64, decode_hi: int = 512,
                  shares: dict | None = None,
                  shared_prefix_groups: int = 0,
                  shared_prefix_frac: float = 0.5,
                  page_size: int = 64) -> Workload:
    """kind: sharegpt4o | github_issue | mixed | openrouter | shares.

    ``rate`` requests/s Poisson for ``duration`` seconds.  ``long_ratio``
    only applies to kind="mixed" (paper: 0.01 / 0.05).

    kind="shares" samples prompt lengths from a MEASURED interval
    distribution instead of a named dataset: pass ``shares`` in the
    ``Workload.interval_shares()`` format (``{"lo-hi": probability}``) and
    the generator reproduces that mix (see ``shares_table``) — e.g.
    regenerate traffic matched to yesterday's live trace.

    ``shared_prefix_groups`` > 0 models system-prompt / few-shot template
    reuse: each request joins one of that many groups (uniform) and carries
    ``prefix_keys`` for the first ``shared_prefix_frac`` of its prompt,
    rounded down to whole ``page_size`` pages, via ``group_keys`` — two
    requests from the same group share the longest common page chain their
    lengths allow; different groups never collide.  Fewer groups / higher
    frac = more cacheable KV.

    Reproducible by construction: the same ``seed`` (with the same
    parameters) yields an identical trace — arrivals, lengths, and decode
    budgets all come from one ``default_rng(seed)`` stream.  The trace may
    legitimately be EMPTY (first Poisson arrival >= duration at low
    rate x duration); consumers must treat that as zero load, not an error.
    """
    if not rate > 0:
        raise ValueError(f"make_workload: rate must be > 0 (got {rate!r})")
    if duration < 0:
        raise ValueError(
            f"make_workload: duration must be >= 0 (got {duration!r})")
    if decode_hi < decode_lo:
        raise ValueError(
            f"make_workload: decode_hi ({decode_hi}) < decode_lo "
            f"({decode_lo})")
    if decode_lo <= 0:
        raise ValueError(
            f"make_workload: decode_lo must be > 0 (got {decode_lo})")
    if kind == "shares":
        if shares is None:
            raise ValueError("make_workload: kind='shares' needs a shares= "
                             "dict (Workload.interval_shares() format)")
        measured = shares_table(shares)
    elif shares is not None:
        raise ValueError(
            f"make_workload: shares= only applies to kind='shares' "
            f"(got kind={kind!r})")
    elif kind != "mixed" and kind not in DATASETS:
        raise ValueError(f"make_workload: unknown kind {kind!r} "
                         f"(want shares | mixed | {' | '.join(DATASETS)})")
    if shared_prefix_groups < 0:
        raise ValueError("make_workload: shared_prefix_groups must be >= 0 "
                         f"(got {shared_prefix_groups!r})")
    if not 0.0 <= shared_prefix_frac <= 1.0:
        raise ValueError("make_workload: shared_prefix_frac must be in "
                         f"[0, 1] (got {shared_prefix_frac!r})")
    rng = np.random.default_rng(seed)
    # per-group key chains are deterministic in the group id, so they are
    # built lazily and memoized at the longest depth seen
    chains: dict[int, tuple] = {}
    reqs, t, rid = [], 0.0, 0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= duration:
            break
        if kind == "shares":
            table = measured
        elif kind == "mixed":
            table = GITHUB_ISSUE if rng.random() < long_ratio else SHAREGPT_4O
        else:
            table = DATASETS[kind]
        plen = _sample_interval(rng, table)
        dlen = int(rng.integers(decode_lo, decode_hi + 1))
        keys = ()
        if shared_prefix_groups > 0:
            g = int(rng.integers(shared_prefix_groups))
            n_pages = int(plen * shared_prefix_frac) // page_size
            if n_pages > 0:
                if len(chains.get(g, ())) < n_pages:
                    chains[g] = group_keys(g, n_pages)
                keys = chains[g][:n_pages]
        reqs.append(TraceRequest(rid, t, plen, dlen, prefix_keys=keys))
        rid += 1
    label = kind if kind != "mixed" else f"mixed_{long_ratio:.0%}"
    return Workload(label, reqs)
