"""WaterFill: minimax KV-token split across a request's KV binding (Alg. 1 l.12).

Distributes ``total`` tokens over instances with existing loads ``loads`` so
that the peak post-allocation load max_s(K_s + split_s) is minimised, filling
lower-loaded instances first (water-filling).  Exact integer solution.
"""
from __future__ import annotations

import numpy as np


def waterfill(loads, total: int, capacities=None, minimums=None) -> np.ndarray:
    """loads: [k] current KV loads; total: tokens to place.

    capacities: optional [k] per-instance remaining capacity caps; the split
    never exceeds them (if infeasible, the residual spills onto the instance
    with the most remaining headroom — CanAllocate rejects such plans anyway).

    minimums: optional [k] per-instance FLOORS — tokens that must stay on
    their instance no matter the water level.  This is how refcounted
    sharing enters every placement decision: a refcount>1 frame is
    immovable-unless-CoW-split, so planners pin the shared tokens via
    ``minimums`` and let the fill only distribute what can actually move.
    Floors are granted first (clamped to caps), then the remainder
    water-fills on top.

    Returns int64 split [k] with split.sum() == total.
    """
    if minimums is not None:
        mins = np.asarray(minimums, dtype=np.int64)
        assert mins.shape == np.shape(loads) and (mins >= 0).all(), mins
        if mins.any():
            caps = (np.full(len(mins), np.inf) if capacities is None
                    else np.asarray(capacities, dtype=np.float64))
            mins = np.minimum(mins, np.maximum(caps, 0)).astype(np.int64)
            if mins.sum() >= total:
                # floors alone cover (or exceed) the total: grant
                # proportionally from the tail — callers pass floors that
                # sum <= total, so this is the degenerate exact-fit case
                out = mins.copy()
                excess = int(out.sum() - total)
                for j in np.argsort(-(np.asarray(loads) + out)):
                    d = min(excess, int(out[j]))
                    out[j] -= d
                    excess -= d
                    if excess == 0:
                        break
                return out
            rest = waterfill(np.asarray(loads) + mins, total - int(mins.sum()),
                             None if capacities is None else caps - mins)
            return rest + mins
    loads = np.asarray(loads, dtype=np.float64)
    k = loads.shape[0]
    assert k >= 1
    if total <= 0:
        return np.zeros(k, dtype=np.int64)
    caps = (np.full(k, np.inf) if capacities is None
            else np.asarray(capacities, dtype=np.float64))

    # water level via sort + prefix sums (ignoring caps), then clip+redistribute
    split = np.zeros(k, dtype=np.float64)
    remaining = float(total)
    active = np.ones(k, dtype=bool)
    for _ in range(k):
        idx = np.where(active)[0]
        if idx.size == 0 or remaining <= 0:
            break
        l = loads[idx] + split[idx]
        order = np.argsort(l)
        ls = l[order]
        # find water level among active instances
        csum = np.cumsum(ls)
        level = None
        for j in range(len(ls)):
            # level if we fill the first j+1 instances up to ls[j+1] (or spread rest)
            cap_j = (ls[j + 1] if j + 1 < len(ls) else np.inf)
            need = (j + 1) * cap_j - csum[j]
            if need >= remaining or j + 1 == len(ls):
                level = (csum[j] + remaining) / (j + 1)
                fill_idx = idx[order[: j + 1]]
                break
        add = np.maximum(level - (loads[fill_idx] + split[fill_idx]), 0.0)
        # respect caps
        head = caps[fill_idx] - split[fill_idx]
        add = np.minimum(add, np.maximum(head, 0.0))
        split[fill_idx] += add
        remaining -= float(add.sum())
        # instances at cap leave the active set
        active &= (split < caps - 1e-9)
        if remaining <= 1e-9:
            break
    if remaining > 1e-9:  # all capped: spill onto max-headroom instance
        j = int(np.argmax(caps - split))
        split[j] += remaining

    # integerise preserving the total, biasing remainders to least-loaded
    # instances that still have cap headroom
    base = np.floor(split).astype(np.int64)
    rem = int(total - base.sum())
    if rem > 0:
        order = np.argsort(loads + base)
        guard = 0
        while rem > 0 and guard < rem + k + 1:
            progressed = False
            for j in order:
                if rem == 0:
                    break
                if base[j] + 1 <= caps[j] or not np.isfinite(caps[j]):
                    base[j] += 1
                    rem -= 1
                    progressed = True
            guard += 1
            if not progressed:           # infeasible caps: spill (caller rejects)
                base[int(np.argmax(caps - base))] += rem
                rem = 0
    elif rem < 0:
        order = np.argsort(-(loads + base))
        take = -rem
        for j in order:
            d = min(take, int(base[j]))
            base[j] -= d
            take -= d
            if take == 0:
                break
    assert base.sum() == total, (base, total)
    return base


def peak_after(loads, split) -> float:
    return float(np.max(np.asarray(loads) + np.asarray(split)))
