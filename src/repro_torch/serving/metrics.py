"""Serving metrics: TTFT, TPOT, SLO attainment, goodput, imbalance (§6)
(a copy of ``repro/serving/metrics.py``, numpy only).

SLO definitions follow the paper: TTFT is arrival -> first emitted token
(queueing + prefill), TPOT is the mean inter-token gap DURING decode.  The
honest-denominator rule makes the curves un-gameable: ``slo_attainment`` /
``goodput`` are computed over ALL submitted requests, so a request the
controller rejected, shed, OOM-finished, or degraded counts as a violation
— shedding load can only ever LOWER measured attainment, never raise it.
"""
from __future__ import annotations

import numpy as np

# typed non-success outcomes (Request.status): every one is an SLO violation
# in the attainment/goodput denominator, whatever its latency numbers say
VIOLATION_STATUSES = frozenset({"rejected", "shed", "oom", "degraded"})


def ttft(req) -> float:
    """Time to first token: arrival -> first emitted token (queueing +
    prefill).  ``inf`` when the request never produced a token (still
    queued, rejected, or shed)."""
    tt = getattr(req, "token_times", None)
    if not tt:
        return float("inf")
    return tt[0] - req.arrival


def tpot(req) -> float:
    """Decode-normalized time per output token: the mean inter-token gap
    over the request's emitted tokens (the paper's TPOT SLO definition —
    queueing and prefill live in ``ttft``, not here).  A single-token
    request has no decode gap and trivially meets any TPOT SLO (0.0);
    requests without per-token timestamps fall back to the queueing-
    inclusive normalization (``tpot_with_queueing``)."""
    if req.generated <= 0 or req.finish_time < 0:
        return float("inf")
    tt = getattr(req, "token_times", None)
    if tt:
        if len(tt) < 2:
            return 0.0
        return (tt[-1] - tt[0]) / (len(tt) - 1)
    return tpot_with_queueing(req)


def tpot_with_queueing(req) -> float:
    """Legacy normalization: (finish - arrival) / tokens — folds queueing
    delay and prefill into the per-token number, so head-of-line blocking
    shows up exactly as in the paper's Fig. 12/14 reproductions.  Kept as
    an explicit alias; the SLO metrics default to the decode-normalized
    ``tpot``."""
    if req.generated <= 0 or req.finish_time < 0:
        return float("inf")
    return (req.finish_time - req.arrival) / req.generated


def _ok(req, slo: float, ttft_slo: float | None, tpot_fn) -> bool:
    """One request's SLO verdict: a typed non-success outcome is always a
    violation; otherwise both the TPOT and (optional) TTFT budgets hold."""
    if getattr(req, "status", "finished") in VIOLATION_STATUSES:
        return False
    if tpot_fn(req) > slo:
        return False
    if ttft_slo is not None and ttft(req) > ttft_slo:
        return False
    return True


def slo_attainment(requests, slo: float = 0.05, *, submitted: int | None = None,
                   ttft_slo: float | None = None, tpot_fn=None) -> float:
    """Fraction of ALL submitted requests that finished within the SLO.

    ``submitted``: total requests offered to the system.  The denominator is
    ``max(submitted, len(requests))`` — a request that never reached the
    finished list (still queued at horizon, dropped upstream) counts as a
    violation, and typed non-success finishes (rejected / shed / oom /
    degraded) are violations regardless of their latency numbers.  This is
    the bugfix that makes load-shedding unable to inflate the curve.
    """
    tpot_fn = tpot_fn or tpot
    n = len(requests)
    denom = max(submitted or 0, n)
    if denom == 0:
        return 0.0
    good = sum(1 for r in requests if _ok(r, slo, ttft_slo, tpot_fn))
    return good / denom


def goodput(requests, slo: float = 0.05, *, duration: float | None = None,
            submitted: int | None = None, ttft_slo: float | None = None,
            tpot_fn=None) -> float:
    """SLO-attaining completed requests per second.  Violations (including
    rejected/shed/oom/degraded outcomes) contribute nothing; ``duration``
    defaults to the last finish time observed (0 throughput when nothing
    finished).  ``submitted`` is accepted for signature symmetry with
    ``slo_attainment`` (it does not change the numerator)."""
    del submitted
    tpot_fn = tpot_fn or tpot
    good = sum(1 for r in requests if _ok(r, slo, ttft_slo, tpot_fn))
    if duration is None:
        duration = max((r.finish_time for r in requests
                        if r.finish_time >= 0), default=0.0)
    if duration <= 0:
        return 0.0
    return good / duration


def _finite(requests, fn) -> list:
    """Evaluate ``fn`` ONCE per request and keep the finite values."""
    vals = [fn(r) for r in requests]
    return [v for v in vals if np.isfinite(v)]


def p99_tpot(requests, tpot_fn=None) -> float:
    ts = _finite(requests, tpot_fn or tpot)
    return float(np.percentile(ts, 99)) if ts else float("inf")


def mean_tpot(requests, tpot_fn=None) -> float:
    ts = _finite(requests, tpot_fn or tpot)
    return float(np.mean(ts)) if ts else float("inf")


def p99_ttft(requests) -> float:
    ts = _finite(requests, ttft)
    return float(np.percentile(ts, 99)) if ts else float("inf")


def mean_ttft(requests) -> float:
    ts = _finite(requests, ttft)
    return float(np.mean(ts)) if ts else float("inf")


def prefix_hit_rate(result) -> float:
    """Fraction of admitted prompt tokens served from the global prefix
    cache (attached to cached frames instead of prefilled).  Takes any
    object with ``prefix_hit_tokens`` / ``prompt_tokens`` counters — the
    simulator's ``SimResult`` or an engine stats dict wrapper.  0.0 when no
    prompt tokens were admitted (cache off or empty trace)."""
    tot = getattr(result, "prompt_tokens", 0)
    if tot <= 0:
        return 0.0
    return getattr(result, "prefix_hit_tokens", 0) / tot


def imbalance_pct(values) -> float:
    """(max/mean - 1) * 100; the paper's per-instance imbalance metric."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0 or v.mean() <= 0:
        return 0.0
    return float((v.max() / v.mean() - 1.0) * 100.0)


def max_sustainable_rate(run_fn, rates, slo: float = 0.05,
                         target: float = 0.99, *, ttft_slo: float | None = None,
                         tpot_fn=None) -> tuple[float, dict]:
    """Largest rate in ``rates`` whose run meets ``target`` SLO attainment,
    plus per-rate stats.

    Scans the FULL rate list — attainment is NOT monotone in offered rate
    once admission control and preemption land (a mid-range rate can dip
    below target while a higher rate, with more preemption headroom freed,
    recovers), so the old early-break picked the wrong knee.  ``run_fn(rate)``
    returns either a list of finished requests or a ``(requests, submitted)``
    tuple; pass the tuple form so unserved requests count as violations.
    """
    best, stats = 0.0, {}
    for rate in rates:
        out = run_fn(rate)
        reqs, sub = out if isinstance(out, tuple) else (out, None)
        att = slo_attainment(reqs, slo, submitted=sub, ttft_slo=ttft_slo,
                             tpot_fn=tpot_fn)
        stats[rate] = {"attainment": att, "p99_tpot": p99_tpot(reqs, tpot_fn),
                       "mean_tpot": mean_tpot(reqs, tpot_fn),
                       "p99_ttft": p99_ttft(reqs),
                       "finished": len(reqs),
                       "submitted": sub if sub is not None else len(reqs)}
        if att >= target:
            best = max(best, rate)
    return best, stats
