"""Engine host time per decode step (ms): from the engine's own ``timings``
of each step of the window that dispatched a decode, everything but the
harvest's wait on the device and the prefill (device work the step waits
for); the mean over those steps."""


def read(rec):
    ms = [(t["step_us"] - t.get("harvest_us", 0.0) - t.get("prefill_us", 0.0))
          / 1e3 for t in (s["timings"] for s in rec["steps"] if s["decode"])]
    return sum(ms) / len(ms) if ms else None
