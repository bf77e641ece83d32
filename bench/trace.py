"""The device trace of a traced run (``--trace 1``): ``torch.profiler`` over
the measured window, reduced to what the per-layer metrics and the result
line read.

Kernels that a CUDA graph replay ran are told apart from eagerly launched
ones by the runtime call that launched them (``cudaGraphLaunch``), through
the correlation id the trace gives both; the decode step is the engine's
only graph.
"""
from __future__ import annotations

import time

GRAPH_LAUNCH = "cudaGraphLaunch"


class DeviceTrace:
    """Start with ``start()`` at the window's start, ``stop()`` at its end;
    ``reduce()`` afterwards (outside the window)."""

    def __init__(self):
        import torch.profiler as tp
        self.prof = tp.profile(activities=[tp.ProfilerActivity.CPU,
                                           tp.ProfilerActivity.CUDA])
        self.host_ns = (0, 0)

    def start(self) -> None:
        import torch
        self.prof.start()
        t = time.perf_counter_ns()
        with torch.profiler.record_function("bench.window"):
            pass
        self.host_ns = (t, 0)

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.host_ns = (self.host_ns[0], time.perf_counter_ns())
        self.prof.stop()

    def reduce(self, spans: list) -> dict:
        """Kernel seconds by name, busy seconds (the union of every device
        operation's interval), seconds of graph-replayed kernels, graph
        launches, and the longest idle gaps, each named by the host span
        (``spans``: (start_ns, end_ns, label) on ``time.perf_counter_ns``)
        that was running when it began."""
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        runtime, dev, marks = {}, [], []
        for e in events:
            if e.device_type() == DeviceType.CPU:
                name = e.name()
                if name.startswith("cuda"):
                    runtime[e.correlation_id()] = name
                elif name == "bench.window":
                    marks.append(e.start_ns())
            elif not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.name(),
                            e.correlation_id(), e.linked_correlation_id()))
        dev.sort()
        by_name: dict = {}
        graph_s = 0.0
        busy = 0
        gaps = []
        cur_s = cur_e = None
        for s, e, name, corr, link in dev:
            d = (e - s) * 1e-9
            by_name[name] = by_name.get(name, 0.0) + d
            if GRAPH_LAUNCH in (runtime.get(corr), runtime.get(link)):
                graph_s += d
            if cur_e is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        # the trace's clock against the host's: the window mark was
        # recorded right after start()
        offset = (marks[0] - self.host_ns[0]) if marks else 0
        gaps.sort(reverse=True)
        idle = []
        for length, at in gaps[:10]:
            host = at - offset
            label = next((lab for s, e, lab in spans if s <= host < e),
                         "harness between steps")
            idle.append([label, length * 1e-9])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy * 1e-9, "kernel_s": by_name,
                "graph_kernel_s": graph_s,
                "graph_launches": sum(1 for n in runtime.values()
                                      if n == GRAPH_LAUNCH),
                "device_ops": [[n, s] for n, s in top], "idle_gaps": idle,
                "window_s": (self.host_ns[1] - self.host_ns[0]) * 1e-9}
