"""The end-to-end arithmetic, from the harness's own stamps.

Frozen from the program's ``serving/metrics.py``: TTFT is due time to first
token; TPOT is the mean gap between a request's tokens,
(last - first) / (tokens - 1).  Here every stamp is the host clock when
``NanoCPEngine.step()`` returned the token, and a request's TTFT starts at
its due time, not when the generator got round to adding it, so a stall
counts against every request queued behind it.

TTFT's sample is every request due inside the window.  TPOT's is every
request due inside the window before ``tpot_until``: the window's last
seconds, and the drain after it, let those finish under the same load.  A
session that decodes through the window adds one TPOT: the mean gap of the
tokens it emitted inside it.  A request that failed (rejected, shed,
finished by an OOM, without a first token when the drain ended, or in
TPOT's sample and unfinished then) adds no latency and counts in
``failed``.
"""
from __future__ import annotations

import numpy as np


def tpot(stamps: list) -> float | None:
    if len(stamps) < 2:
        return None
    return (stamps[-1] - stamps[0]) / (len(stamps) - 1)


def summarize(requests: list, w0: float, w1: float,
              tpot_until: float) -> dict:
    """``requests``: dicts with ``phase``, ``due`` (host clock), ``stamps``
    (host clock of each token), ``failed``.  Returns the end-to-end metrics
    (ms, tokens/s) and the counts."""
    ttfts, tpots = [], []
    attempted = failed = 0
    in_window = 0
    for r in requests:
        st = r["stamps"]
        in_window += sum(1 for t in st if w0 <= t < w1)
        if r["phase"] == "session":
            g = tpot([t for t in st if w0 <= t < w1])
            if g is not None:
                tpots.append(g)
            continue
        if r["phase"] != "window":
            continue
        attempted += 1
        if r["failed"] or not st:
            failed += 1
            continue
        ttfts.append(st[0] - r["due"])
        g = tpot(st) if r["due"] < tpot_until else None
        if g is not None:
            tpots.append(g)
    if not ttfts or not tpots:
        raise RuntimeError("no request of the window finished")
    return {"ttft_p95_ms": float(np.percentile(ttfts, 95)) * 1e3,
            "tpot_p50_ms": float(np.percentile(tpots, 50)) * 1e3,
            "tpot_p95_ms": float(np.percentile(tpots, 95)) * 1e3,
            "output_tokens_per_s": in_window / (w1 - w0),
            "attempted": attempted, "failed": failed,
            "ttft_samples": len(ttfts), "tpot_samples": len(tpots)}
