"""The program's own spans and counters (``NanoCPEngine.tracer``) read
against the device trace of a window.

``reduce`` takes the engine's tracer, the window's ``torch.profiler`` run
and the harness's requests, and returns what three readings need, under
``rec["program"]``:

* ``queue_wait_ms``: each window request's ``request.queued`` span (a
  request still unadmitted when the tracer stopped counts up to then);
  ``queue_wait_p95_ms`` reads its 95th percentile, as ``e2e`` takes TTFT's.
* ``kv_tokens``: the per-instance KV counter of each window dispatch;
  ``kv_imbalance_pct`` reads (max - mean) / mean, averaged over them.
* ``exposed_idle_ms``: per window ``engine.step`` that decoded, the device
  idle time inside it outside its ``engine.prefill`` child;
  ``exposed_host_ms_per_step`` reads their mean.
* ``idle_by_span``: every idle interval of the window put down to the
  innermost program span open when it began, or to "outside the engine";
  ``idle_inside_span`` splits the same idle time by the innermost span each
  part of it falls in (a gap that begins in ``engine.harvest``, while the
  host waits for the step before, runs on through ``routing.tables`` and
  ``dcp.dispatch`` until the next launch).

Against an engine without a tracer ``reduce`` gives ``{"program": None}``
and every reading None.  Run as a script, it drives one run of a cell the
way ``bench/run.py --trace 1`` does, with the program's tracer on
(``--tracer 1``) or off (0), and prints the per-layer metrics, these
readings and the idle seconds by span as one JSON line; it checks no output
against the reference.  ``--tracer 2`` measures the tracer's cost instead:
on and off every 20 steps of the window, the host time per decode step and
the time in the tracer's own calls, each way (``cost``):

    python3 bench/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> --tracer <0|1>
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

OUTSIDE = "outside the engine"


# --------------------------------------------------------------------------- #
# the device's busy and idle time
# --------------------------------------------------------------------------- #
def busy_intervals(prof) -> np.ndarray:
    """The union of every device operation's interval in a
    ``torch.profiler`` run, as sorted disjoint [start, end) rows (ns)."""
    from torch.autograd import DeviceType
    ops = sorted((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() != DeviceType.CPU
                 and not e.is_user_annotation())
    return merge(ops)


def merge(ops) -> np.ndarray:
    out = []
    for s, e in sorted(ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, np.int64).reshape(-1, 2)


def idle_intervals(busy: np.ndarray, w0: int, w1: int) -> np.ndarray:
    """The complement of ``busy`` inside [w0, w1)."""
    b = np.clip(busy, w0, w1)
    b = b[b[:, 1] > b[:, 0]]
    edges = np.concatenate([[w0], b.ravel(), [w1]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def idle_between(idle: np.ndarray, a, b) -> np.ndarray:
    """Idle ns inside each [a, b) (arrays), from sorted idle rows."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    cum = np.concatenate([[0], np.cumsum(idle[:, 1] - idle[:, 0])])

    def before(t):
        k = np.searchsorted(idle[:, 0], t, side="right") - 1
        ok = k >= 0
        kk = np.where(ok, k, 0)
        part = np.clip(t - idle[kk, 0], 0, idle[kk, 1] - idle[kk, 0])
        return np.where(ok, cum[kk] + part, 0)
    return before(b) - before(a)


def attribute(idle: np.ndarray, spans: list) -> dict:
    """Idle seconds by the name of the innermost span open when each idle
    interval began (``spans``: (id, parent, name, start, end), on the
    device trace's clock; spans of one depth never overlap)."""
    depth, byid = {}, {s[0]: s for s in spans}

    def d(s):
        if s[0] not in depth:
            p = byid.get(s[1])
            depth[s[0]] = 0 if p is None else d(p) + 1
        return depth[s[0]]
    levels: dict = {}
    for s in spans:
        levels.setdefault(d(s), []).append(s)
    g = idle[:, 0]
    who = np.full(len(g), -1)
    names = []
    for lv in sorted(levels, reverse=True):
        row = sorted(levels[lv], key=lambda s: s[3])
        st = np.array([s[3] for s in row], np.int64)
        en = np.array([s[4] for s in row], np.int64)
        k = np.searchsorted(st, g, side="right") - 1
        kk = np.where(k >= 0, k, 0)
        hit = (k >= 0) & (en[kk] > g) & (who < 0)
        who[hit] = len(names) + kk[hit]
        names += [s[2] for s in row]
    out: dict = {}
    length = (idle[:, 1] - idle[:, 0]) * 1e-9
    for w, s in zip(who, length):
        name = names[w] if w >= 0 else OUTSIDE
        out[name] = out.get(name, 0.0) + float(s)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def inside(idle: np.ndarray, spans: list) -> dict:
    """Idle seconds by the name of the innermost span they fall in (each
    span's idle time less its children's), and outside every span."""
    if not spans:
        return {OUTSIDE: float((idle[:, 1] - idle[:, 0]).sum() * 1e-9)}
    own = idle_between(idle, [s[3] for s in spans],
                       [s[4] for s in spans]).astype(np.float64)
    at = {s[0]: i for i, s in enumerate(spans)}
    excl = own.copy()
    for s, v in zip(spans, own):
        if s[1] in at:
            excl[at[s[1]]] -= v
    out = {OUTSIDE: float((idle[:, 1] - idle[:, 0]).sum() - sum(
        v for s, v in zip(spans, own) if s[1] not in at)) * 1e-9}
    for s, v in zip(spans, excl):
        out[s[2]] = out.get(s[2], 0.0) + float(v) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# --------------------------------------------------------------------------- #
# the reduction
# --------------------------------------------------------------------------- #
def reduce_program(spans: list, counters: list, busy: np.ndarray,
                   window: tuple, stop: int, reqs: dict) -> dict:
    """``spans`` (id, parent, name, start, end, attrs) and ``counters``
    (name, t, step, values) already on the device trace's clock, as are
    ``window`` (its start and end) and ``stop`` (when the tracer stopped);
    ``reqs``: rid -> {"phase", "due" (same clock)}."""
    w0, w1 = window
    idle = idle_intervals(busy, w0, w1)
    engine = [s[:5] for s in spans if not s[2].startswith("request.")]
    queued = {s[5]["rid"]: (s[4] - s[3]) / 1e6 for s in spans
              if s[2] == "request.queued"}
    waits = [queued.get(rid, (stop - r["due"]) / 1e6)
             for rid, r in sorted(reqs.items()) if r["phase"] == "window"]
    kv = [list(c[3]["kv_tokens"]) for c in counters
          if c[0] == "dcp.dispatch" and w0 <= c[1] < w1]
    steps = [s for s in spans if s[2] == "engine.step" and s[5]["decoded"]
             and w0 <= s[3] and s[4] <= w1]
    prefill = {s[1]: (s[3], s[4]) for s in spans if s[2] == "engine.prefill"}
    exposed = []
    if steps:
        a = [s[3] for s in steps]
        b = [s[4] for s in steps]
        pa = [prefill.get(s[0], (s[3], s[3]))[0] for s in steps]
        pb = [prefill.get(s[0], (s[3], s[3]))[1] for s in steps]
        exposed = ((idle_between(idle, a, b) - idle_between(idle, pa, pb))
                   / 1e6).tolist()
    return {"queue_wait_ms": waits, "kv_tokens": kv,
            "exposed_idle_ms": exposed,
            "idle_by_span": attribute(idle, engine) if len(idle) else {},
            "idle_inside_span": inside(idle, engine) if len(idle) else {},
            "idle_s": float((idle[:, 1] - idle[:, 0]).sum() * 1e-9)}


def reduce(eng, prof, host_ns: tuple, reqs: dict) -> dict:
    """``rec["program"]`` from ``eng.tracer`` (stopped), the window's
    profiler run ``prof``, the window on ``time.perf_counter_ns``
    (``host_ns``) and the harness's requests (``due`` on
    ``time.perf_counter``); None without a tracer or a recording."""
    tracer = getattr(eng, "tracer", None)
    if tracer is None or len(getattr(tracer, "anchors", ())) < 2:
        return {"program": None}
    m = tracer.to_profiler_ns
    spans = [(s.id, s.parent, s.name, m(s.start), m(s.end), s.attrs)
             for s in tracer.spans]
    counters = [(c.name, m(c.t), c.step, c.values) for c in tracer.counters]
    due = {rid: dict(r, due=m(round(r["due"] * 1e9)))
           for rid, r in reqs.items()}
    out = reduce_program(spans, counters, busy_intervals(prof),
                         (m(host_ns[0]), m(host_ns[1])),
                         m(tracer.anchors[-1][0]), due)
    out["drift_ns"] = tracer.drift_ns
    return {"program": out}


# --------------------------------------------------------------------------- #
# the readings
# --------------------------------------------------------------------------- #
def queue_wait_p95_ms(rec: dict):
    p = rec.get("program")
    if not p or not p["queue_wait_ms"]:
        return None
    return float(np.percentile(p["queue_wait_ms"], 95))


def kv_imbalance_pct(rec: dict):
    p = rec.get("program")
    vals = [(max(k) / (sum(k) / len(k)) - 1.0) * 100.0
            for k in (p or {}).get("kv_tokens", []) if sum(k) > 0]
    return sum(vals) / len(vals) if vals else None


def exposed_host_ms_per_step(rec: dict):
    p = rec.get("program")
    if not p or not p["exposed_idle_ms"]:
        return None
    return sum(p["exposed_idle_ms"]) / len(p["exposed_idle_ms"])


READINGS = {"scheduler.queue_wait_p95_ms": queue_wait_p95_ms,
            "kv.instance_imbalance_pct": kv_imbalance_pct,
            "engine.exposed_host_ms_per_step": exposed_host_ms_per_step}


# --------------------------------------------------------------------------- #
# one run of a cell with the program's tracer
# --------------------------------------------------------------------------- #
# what runs for the tracer: engine methods only with it on, tracer methods
# with it on (``note``, ``record``, ``count``) or on and off
ENGINE_TRACING = ("_trace_schedule", "_trace_prefill", "_trace_requests",
                  "_new_recording")
TRACER_CALLS = ("note", "record", "count", "lap", "begin_step", "end_step")


def alternate(h, block: int) -> None:
    """While ``h`` records, switch its engine's tracer on and off every
    ``block`` steps, and clock each call of what runs for the tracer (the
    outermost call only); each step's record gets ``tracer`` (on or off)
    and ``tracer_ns`` (the time in those calls)."""
    eng, tr = h.eng, h.eng.tracer
    depth, spent, seen = [0], [0], [0]

    def clocked(fn):
        def run(*a, **k):
            if depth[0]:
                return fn(*a, **k)
            depth[0] = 1
            t = time.perf_counter_ns()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter_ns() - t
                depth[0] = 0
        return run
    for name in ENGINE_TRACING:
        setattr(eng, name, clocked(getattr(eng, name)))
    for name in TRACER_CALLS:
        setattr(tr, name, clocked(getattr(tr, name)))
    inner = h.step

    def step():
        if h.recording:
            k = seen[0] % (2 * block)
            if k == 0:
                tr.start()
            elif k == block:
                tr.stop()
            seen[0] += 1
        spent[0] = 0
        inner()
        if h.recording:
            h.steps[-1].update(tracer=tr.on, tracer_ns=spent[0])
    h.step = step


def cost(steps: list) -> dict:
    """Per decode step with the tracer on and off: the mean and median of
    ``engine.host_ms_per_step``'s arithmetic and the mean time in the
    tracer's calls."""
    out = {}
    for on in (True, False):
        st = [s for s in steps if s["decode"] and s.get("tracer") is on]
        host = [(t["step_us"] - t.get("harvest_us", 0.0)
                 - t.get("prefill_us", 0.0)) / 1e3
                for t in (s["timings"] for s in st)]
        key = "on" if on else "off"
        out[key] = {"steps": len(st),
                    "host_ms_mean": float(np.mean(host)) if host else None,
                    "host_ms_median": (float(np.median(host)) if host
                                       else None),
                    "tracer_us_mean": (float(np.mean(
                        [s["tracer_ns"] for s in st])) / 1e3 if st
                        else None)}
    return out


def run_traced(cell: dict, seed: int, seconds: float, program: int, *,
               device: str = "cuda", cfg=None) -> dict:
    from bench import common, e2e
    from bench.harness import Harness
    from bench.run import read_metrics
    from bench.trace import DeviceTrace
    h = Harness(cell, seed, seconds, device=device, cfg=cfg)
    h.setup()
    t_lead = time.perf_counter()
    w0 = t_lead + cell["lead_in_s"]
    w1 = w0 + seconds
    tpot_until = max(w0, w1 - cell["finish_s"])
    queue = h.schedule(w0)
    h.drive(queue, w0)
    if program == 2:
        alternate(h, 20)
    dev = DeviceTrace()
    dev.start()
    if program == 1:
        h.eng.tracer.start()
    h.recording = True
    h.drive(queue, w1)
    h.recording = False
    dev.stop()
    t_close = time.perf_counter()
    h.finish(queue, t_close + cell["drain_s"], tpot_until)
    if program:
        h.eng.tracer.stop()
    try:
        summary = e2e.summarize(list(h.reqs.values()), w0, w1, tpot_until)
    except RuntimeError:                 # a window too short for TPOT
        summary = {}
    rec = {"model": cell["model"], "cell": cell, "steps": h.steps,
           "aot_online_window": 0, **dev.reduce(h.spans)}
    rec.update(reduce(h.eng, dev.prof, dev.host_ns, h.reqs))
    spec = common.load_json(common.ROOT / "BENCHMARK.json")
    metrics = {k: v["value"] for k, v in read_metrics(
        spec["per_layer"], rec).items()}
    metrics.update({k: f(rec) for k, f in READINGS.items()})
    p = rec["program"] or {}
    return {"workload": cell["name"], "seed": seed, "tracer": program,
            "setup_s": t_lead - T_PROCESS,
            "e2e": {k: summary.get(k) for k in (
                "ttft_p95_ms", "tpot_p50_ms", "tpot_p95_ms",
                "output_tokens_per_s")},
            "metrics": metrics,
            "idle_window_s": rec["window_s"] - rec["busy_s"],
            "idle_attributed_s": p.get("idle_s"),
            "idle_by_span": p.get("idle_by_span"),
            "idle_inside_span": p.get("idle_inside_span"),
            "drift_ns": p.get("drift_ns"),
            "spans": len(h.eng.tracer.spans) if program else 0,
            "decode_steps": sum(1 for s in h.steps if s["decode"]),
            "cost": cost(h.steps) if program == 2 else None}


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from bench import common
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tracer", type=int, choices=(0, 1, 2), default=1)
    a = p.parse_args(argv)
    cell = common.load_cell(a.workload)
    out = run_traced(cell, a.seed, a.seconds, a.tracer)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
