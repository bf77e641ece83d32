"""Prefill host time per prefilled request (ms): the engine's
``timings["prefill_us"]`` summed over the window's steps, divided by the
requests whose first token those steps returned."""


def read(rec):
    us = sum(s["timings"].get("prefill_us", 0.0) for s in rec["steps"])
    n = sum(len(s["prefills"]) for s in rec["steps"])
    return us / 1e3 / n if n else None
