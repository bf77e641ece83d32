"""Device time of one decode step (ms): the trace's kernels launched by CUDA
graph replays (the engine replays one graph per decode step) over the
window, divided by the replays."""


def read(rec):
    n = rec["graph_launches"]
    return rec["graph_kernel_s"] * 1e3 / n if n and rec["graph_kernel_s"] else None
