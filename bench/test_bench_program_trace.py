"""The reduction of the program's spans and counters against a device
trace (``bench/program_trace.py``) on the CPU: hand-computed idle
attribution and readings on synthetic spans, a real tracer on a fake
clock, and an engine without a tracer, which gives nothing."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import program_trace as pt  # noqa: E402


def test_busy_idle_and_idle_between():
    busy = pt.merge([(10, 20), (15, 30), (40, 50), (60, 70)])
    assert busy.tolist() == [[10, 30], [40, 50], [60, 70]]
    idle = pt.idle_intervals(busy, 0, 65)
    assert idle.tolist() == [[0, 10], [30, 40], [50, 60]]
    assert pt.idle_intervals(busy, 12, 45).tolist() == [[30, 40]]
    got = pt.idle_between(idle, [0, 5, 35, 0, 61], [65, 35, 55, 0, 65])
    assert got.tolist() == [30, 10, 10, 0, 0]


def test_each_idle_interval_goes_to_the_innermost_open_span():
    # two steps; the first has phases lower [0, 20) and dispatch [20, 40)
    # with a capture [22, 30) inside the dispatch; the second no children
    spans = [(1, 0, "engine.step", 0, 40), (2, 1, "routing.lower", 0, 20),
             (3, 1, "dcp.dispatch", 20, 40), (4, 3, "aot.capture", 22, 30),
             (5, 0, "engine.step", 50, 60)]
    idle = np.array([[5, 8], [20, 21], [25, 27], [30, 34], [44, 49],
                     [55, 56], [60, 62]], np.int64)
    got = pt.attribute(idle, spans)
    assert got == pytest.approx({"routing.lower": 3e-9,
                                 "dcp.dispatch": 5e-9, "aot.capture": 2e-9,
                                 pt.OUTSIDE: 7e-9, "engine.step": 1e-9})
    assert sum(got.values()) == pytest.approx(18e-9)
    # by where each part of the idle time falls: [44, 49) and [60, 62)
    # outside; [55, 56) in step 2; the rest where it began
    assert pt.inside(idle, spans) == pytest.approx(
        {"routing.lower": 3e-9, "dcp.dispatch": 5e-9, "aot.capture": 2e-9,
         pt.OUTSIDE: 7e-9, "engine.step": 1e-9})
    assert pt.inside(np.array([[38, 52]], np.int64), spans) == \
        pytest.approx({"dcp.dispatch": 2e-9, pt.OUTSIDE: 10e-9,
                       "engine.step": 2e-9, "routing.lower": 0.0,
                       "aot.capture": 0.0})


def _synthetic():
    """Two decode steps in a window [0, 1000) ns: the first with a prefill
    [100, 300); the device busy [50, 150), [250, 400), [600, 900)."""
    spans = [
        (1, 0, "engine.step", 0, 400, {"step": 1, "decoded": True}),
        (2, 1, "scheduler.schedule", 0, 100, None),
        (3, 1, "engine.prefill", 100, 300, {"requests": 1}),
        (4, 1, "dcp.dispatch", 300, 400, None),
        (5, 0, "engine.step", 500, 800, {"step": 2, "decoded": True}),
        (6, 5, "routing.lower", 500, 700, None),
        (7, 5, "dcp.dispatch", 700, 800, None),
        (8, 0, "engine.step", 800, 900, {"step": 3, "decoded": False}),
        (9, 2, "request.queued", -200, 0, {"rid": 0}),
        (10, 2, "request.queued", 0, 0, {"rid": 1}),
        (11, 3, "request.prefill", 100, 300, {"rid": 0}),
    ]
    counters = [("dcp.dispatch", 400, 1, {"kv_tokens": [10, 20, 30, 40]}),
                ("dcp.dispatch", 800, 2, {"kv_tokens": [25, 25, 25, 25]}),
                ("dcp.dispatch", 1200, 4, {"kv_tokens": [0, 0, 0, 100]})]
    busy = pt.merge([(50, 150), (250, 400), (600, 900)])
    reqs = {0: {"phase": "window", "due": -200},
            1: {"phase": "window", "due": 0},
            2: {"phase": "window", "due": 700},
            3: {"phase": "lead_in", "due": -900}}
    return spans, counters, busy, reqs


def test_the_reduction_and_its_readings_by_hand():
    spans, counters, busy, reqs = _synthetic()
    p = pt.reduce_program(spans, counters, busy, (0, 1000), 1500, reqs)
    # request 2 was never admitted: it waits from 700 to the stop at 1500
    assert p["queue_wait_ms"] == [200e-6, 0.0, 800e-6]
    assert p["kv_tokens"] == [[10, 20, 30, 40], [25, 25, 25, 25]]
    # step 1: idle [0, 50) and [150, 250) inside it; [150, 250) lies in
    # its prefill, so 50 ns exposed; step 2: idle [500, 600), 100 ns
    assert p["exposed_idle_ms"] == [50e-6, 100e-6]
    assert p["idle_s"] == pytest.approx(450e-9)
    # [400, 600) began between the steps, though it runs on into step 2
    assert p["idle_by_span"] == pytest.approx(
        {"scheduler.schedule": 50e-9, "engine.prefill": 100e-9,
         pt.OUTSIDE: 300e-9})
    assert p["idle_inside_span"] == pytest.approx(
        {"scheduler.schedule": 50e-9, "engine.prefill": 100e-9,
         "routing.lower": 100e-9, pt.OUTSIDE: 200e-9, "dcp.dispatch": 0.0,
         "engine.step": 0.0})
    rec = {"program": p}
    assert pt.queue_wait_p95_ms(rec) == pytest.approx(
        float(np.percentile([200e-6, 0.0, 800e-6], 95)))
    # (40 / 25 - 1) and 0, averaged
    assert pt.kv_imbalance_pct(rec) == pytest.approx(30.0)
    assert pt.exposed_host_ms_per_step(rec) == pytest.approx(75e-6)


@pytest.mark.parametrize("rec", [{}, {"program": None},
                                 {"program": {"queue_wait_ms": [],
                                              "kv_tokens": [],
                                              "exposed_idle_ms": []}}],
                         ids=["parent-rec", "no-tracer", "empty"])
def test_the_readings_are_none_with_nothing_to_read(rec):
    assert all(f(rec) is None for f in pt.READINGS.values())


def test_an_engine_without_a_tracer_gives_nothing():
    stub = SimpleNamespace(timings={})
    assert pt.reduce(stub, None, (0, 1), {}) == {"program": None}
    from repro_torch.serving.trace import Tracer
    never = SimpleNamespace(tracer=Tracer())
    assert pt.reduce(never, None, (0, 1), {}) == {"program": None}


class _Event:
    def __init__(self, s, e):
        self.s, self.e = s, e

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


def test_a_real_tracer_on_a_fake_clock(monkeypatch):
    """The tracer's stamps mapped through its anchors: the profiler's clock
    1e9 ns ahead of ``perf_counter`` and running 1% fast (the drift)."""
    from repro_torch.serving import trace
    perf = iter([0, 0,            # start's anchor
                 100, 300, 400,   # step 1: begin, prefill, dispatch
                 500,             # end
                 1000, 1000])     # stop's anchor
    monkeypatch.setattr(trace, "_clock", lambda: next(perf))
    unix = [10**9 + 1010, 10**9]
    real = trace.time.time_ns
    monkeypatch.setattr(trace.time, "time_ns",
                        lambda: unix.pop() if unix else real())
    tr = trace.Tracer()
    tr.start()
    tr.begin_step()
    tr.lap("engine.prefill")
    tr.lap("dcp.dispatch")
    tr.end_step()
    tr.stop()
    assert tr.drift_ns == 10
    assert tr.timings == {"prefill_us": 0.2, "dispatch_us": 0.1,
                          "step_us": 0.4}
    eng = SimpleNamespace(tracer=tr)
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=(
        SimpleNamespace(events=lambda: [_Event(10**9 + 150, 10**9 + 250),
                                        _Event(10**9 + 350, 10**9 + 505)]))))
    p = pt.reduce(eng, prof, (0, 1000), {})["program"]
    # on the profiler's clock the step is [101, 505), its prefill
    # [101, 303): idle [101, 150) and [250, 303) in the prefill, [303, 350)
    # outside it; the idle [0, 150) and [505, 1010) began outside the step
    assert p["exposed_idle_ms"] == [47e-6]
    assert p["drift_ns"] == 10
    assert p["idle_by_span"] == pytest.approx(
        {pt.OUTSIDE: 150e-9 + 505e-9, "engine.prefill": 100e-9})


def test_a_whole_traced_run_on_the_cpu(monkeypatch):
    """``run_traced`` at a reduced size (``test_bench_run.py``'s tiny cell),
    tracer on and off: with it, the three readings and idle seconds that add
    up to the window's idle time; without it, None."""
    import torch
    from bench.test_bench_run import tiny_cell, tiny_cfg
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = tiny_cell("gqa_moe")
        cfg = tiny_cfg(cell["model"])
        on = pt.run_traced(cell, 2**31 + 77, 1.5, True, device="cpu",
                           cfg=cfg)
        off = pt.run_traced(cell, 2**31 + 77, 1.5, False, device="cpu",
                            cfg=cfg)
        both = pt.run_traced(cell, 2**31 + 77, 1.5, 2, device="cpu",
                             cfg=cfg)
    finally:
        torch.set_num_threads(n)
    m = on["metrics"]
    assert 0 <= m["scheduler.queue_wait_p95_ms"] <= on["e2e"]["ttft_p95_ms"]
    assert m["kv.instance_imbalance_pct"] >= 0
    assert m["engine.exposed_host_ms_per_step"] > 0
    assert on["idle_attributed_s"] == pytest.approx(on["idle_window_s"],
                                                    rel=1e-3)
    assert sum(on["idle_by_span"].values()) == pytest.approx(
        on["idle_attributed_s"])
    assert sum(on["idle_inside_span"].values()) == pytest.approx(
        on["idle_attributed_s"])
    assert on["spans"] > 0 and off["spans"] == 0
    assert all(off["metrics"][k] is None for k in pt.READINGS)
    assert off["metrics"]["engine.host_ms_per_step"] > 0
    c = both["cost"]
    assert c["on"]["steps"] > 0 and c["off"]["steps"] > 0
    assert c["on"]["tracer_us_mean"] > c["off"]["tracer_us_mean"] > 0
    assert on["cost"] is None
