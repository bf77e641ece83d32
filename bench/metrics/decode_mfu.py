"""The whole decode step's share of the chip's peak (%): per decode step of
the window, the least time the chip could take for it (the larger of its
operations over the float32 peak and its bytes over HBM bandwidth,
``counts.decode_step``: every weight once, the expected experts its rows
touch, each KV token once), summed, over the window's time outside the
prefills (the prefill blocks the step loop; its host span is the engine's
``prefill_us``)."""
from bench import counts


def read(rec):
    model = rec["model"]
    least = sum(counts.least_seconds(*counts.decode_step(
        model, s["rows"], s["kv_tokens"]))
        for s in rec["steps"] if s["decode"] and s["rows"])
    prefill = sum(s["timings"].get("prefill_us", 0.0)
                  for s in rec["steps"]) / 1e6
    span = rec["window_s"] - prefill
    return 100.0 * least / span if least and span > 0 else None
