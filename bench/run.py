"""The benchmark of ``repro_torch`` on one H100: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run sets up (kernels, weights from the seed, the engine, the cell's long
sessions, every decode graph it can meet), drives the cell's open loop for
a lead-in and then for the measured window, drains, checks a sample of the
served tokens against the plain reference, and prints one JSON line last on
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a device trace of the window.
It exits non-zero, printing no result, without enough CUDA devices, or if
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import common, e2e  # noqa: E402
from bench.harness import Harness, check_outputs, log  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_devices(n: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        log(f"needs {n} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        sys.exit(2)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metrics(spec: list, rec: dict) -> dict:
    """Each per-layer metric's reader, ``metrics/<name>.py``; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in spec:
        path = common.BENCH / "metrics" / f"{m['name']}.py"
        sp = importlib.util.spec_from_file_location(
            "bench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(mod)
        v = mod.read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", cfg=None,
             tf32_control: bool = False) -> dict:
    """One run; returns the result line's fields and what was compared."""
    h = Harness(cell, seed, seconds, device=device, cfg=cfg)
    h.setup()
    lead = cell["lead_in_s"]
    t_lead = time.perf_counter()
    setup_s = t_lead - T_PROCESS
    w0 = t_lead + lead
    w1 = w0 + seconds
    tpot_until = max(w0, w1 - cell["finish_s"])
    queue = h.schedule(w0)
    h.drive(queue, w0)
    aot0 = h.eng.aot.stats.online_compiles
    tracer = None
    if trace:
        from bench.trace import DeviceTrace
        tracer = DeviceTrace()
        tracer.start()
    h.recording = trace
    h.drive(queue, w1)
    h.recording = False
    if tracer is not None:
        tracer.stop()
    aot_window = h.eng.aot.stats.online_compiles - aot0
    t_close = time.perf_counter()
    # the drain's time runs from the close, which a trace's stop delays
    h.finish(queue, t_close + cell["drain_s"], tpot_until)
    t_drained = time.perf_counter()
    summary = e2e.summarize(list(h.reqs.values()), w0, w1, tpot_until)
    late = h.lateness
    log(f"generator: {len(late)} requests added, lateness mean "
        f"{sum(late) / max(len(late), 1) * 1e3:.3f} ms, max "
        f"{max(late, default=0.0) * 1e3:.3f} ms")
    log(f"window: {summary['attempted']} requests, {summary['failed']} "
        f"failed, {summary['ttft_samples']} TTFT and "
        f"{summary['tpot_samples']} TPOT samples; online graph captures "
        f"{aot_window}; engine counters {json.dumps(h.eng.hot_path_stats)}")
    peak = h.peak_bytes()
    sample = h.choose_sample()
    outputs = h.outputs(sample)
    rec = None
    if trace:
        rec = {"model": cell["model"], "cell": cell, "steps": h.steps,
               "aot_online_window": aot_window,
               **tracer.reduce(h.spans)}
    h.release_engine()
    t_ref = time.perf_counter()
    checked = check_outputs(cell["model"], h.params, outputs,
                            router_tie=cell["limits"]["router_tie"],
                            router_flip=cell["limits"].get("router_flip", 0.0),
                            tf32_control=tf32_control)
    t_end = time.perf_counter()
    log(f"reference: {checked['requests']} requests, {checked['tokens']} "
        f"served tokens checked ({checked['router_ties']} at a router tie, "
        f"left out; {checked['reference_passes']} reference passes) in "
        f"{t_end - t_ref:.2f} s; widest gap at "
        f"{json.dumps(checked['worst'])}")
    log(f"phases: set-up {setup_s:.2f} s, lead-in {w0 - t_lead:.2f} s, "
        f"window {w1 - w0:.2f} s, closed {t_close - w1:.2f} s late, drain "
        f"{t_drained - t_close:.2f} s, sample and release "
        f"{t_ref - t_drained:.2f} s, reference {t_end - t_ref:.2f} s, "
        f"in all {t_end - T_PROCESS:.2f} s")
    return {"summary": summary, "setup_s": setup_s, "peak": peak,
            "checked": checked, "rec": rec, "harness": h}


def result_line(spec: dict, cell: dict, out: dict, trace: bool,
                kind: str) -> dict:
    """The last line: ``correct``, the counts, the metrics of the run's
    kind, the device, with a trace the breakdown, and last what was
    compared beside its limit."""
    limit = cell["limits"]["max_logit_gap"]
    gap = out["checked"]["max_logit_gap"]
    s = out["summary"]
    device = {"platform": "gpu", "kind": kind, "count": cell.get("chips", 1),
              "memory_peak_bytes": int(out["peak"])}
    result = {"correct": gap <= limit, "attempted": s["attempted"],
              "failed": s["failed"]}
    if trace:
        rec = out["rec"]
        per = [m for m in spec["per_layer"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        result["metrics"] = read_metrics(per, rec)
        device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["device"] = device
        result["breakdown"] = {"device_ops": rec["device_ops"],
                               "idle_gaps": rec["idle_gaps"]}
    else:
        vals = dict(s, setup_s=out["setup_s"])
        result["metrics"] = {
            m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
            for m in spec["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])}
        result["device"] = device
    result["compared"] = {"max_logit_gap": {"value": gap, "limit": limit}}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell = common.load_cell(args.workload)
    require_devices(cell.get("chips", 1))
    import torch
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"the JAX package or JAX was loaded: {bad}")
        return 3
    spec = common.load_json(common.ROOT / "BENCHMARK.json")
    result = result_line(spec, cell, out, bool(args.trace),
                         torch.cuda.get_device_name(0))
    c = result["compared"]["max_logit_gap"]
    log(f"compared: max_logit_gap {c['value']!r} limit {c['limit']!r} "
        f"({out['checked']['requests']} requests, "
        f"{out['checked']['tokens']} served tokens)")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
