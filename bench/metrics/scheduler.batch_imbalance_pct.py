"""Decode batch imbalance (%): per decode step of the window, (max - mean)
/ mean of the live rows bound to each instance (``last_batch_sizes``, the
engine's counter of the dispatched plan), averaged over the steps; the
arithmetic of the program's ``metrics.imbalance_pct``."""


def read(rec):
    vals = []
    for s in rec["steps"]:
        b = s["batch_sizes"]
        if s["decode"] and b and sum(b) > 0:
            mean = sum(b) / len(b)
            vals.append((max(b) / mean - 1.0) * 100.0)
    return sum(vals) / len(vals) if vals else None
