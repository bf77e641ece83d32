"""The knee sweep of a cell: set up once, then for each rate the cell's
lead-in, one window of its traffic at that rate and its drain, and then
every request of that rate finished before the next rate.  For each rate it prints the tails, the tokens per second, the
backlog (requests due and not finished) at the window's start, middle and
end with its least-squares slope over the window, and the requests still
queued at the end: the knee is the highest rate whose backlog does not
grow through the window.

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 3 4 5
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import common, e2e  # noqa: E402
from bench.harness import Harness, log  # noqa: E402
from bench.run import require_devices  # noqa: E402
from bench.traffic.generate import generate  # noqa: E402


def backlog(reqs: list, t: float) -> int:
    """Requests due by t that had not finished by t."""
    return sum(1 for r in reqs if r["due"] <= t and not (
        r["done"] and r["stamps"] and r["stamps"][-1] <= t))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--drain", type=float, default=60.0)
    args = p.parse_args(argv)
    cell = common.load_cell(args.workload)
    require_devices(cell.get("chips", 1))
    h = Harness(cell, args.seed, args.seconds)
    h.setup()
    for rate in args.rates:
        h.arrivals = [a for a in generate(
            cell["mix"], rate=rate, lead_in_s=cell["lead_in_s"],
            window_s=args.seconds, drain_s=cell["drain_s"],
            vocab=cell["model"]["vocab_size"], seed=args.seed)
            if a.phase != "session"]
        first = len(h.reqs)
        w0 = time.perf_counter() + cell["lead_in_s"]
        w1 = w0 + args.seconds
        tpot_until = max(w0, w1 - cell["finish_s"])
        queue = h.schedule(w0)
        h.drive(queue, w1)
        mine = [h.reqs[r] for r in list(h.reqs)[first:]]
        waiting = len(h.eng.cluster.waiting)
        h.finish(queue, w1 + cell["drain_s"], tpot_until)
        # the rest of this rate's requests leave before the next rate
        end = time.perf_counter() + args.drain
        while time.perf_counter() < end and any(
                h.reqs[r]["phase"] != "session" for r in h.live):
            h.step()
        n = 21
        ts = [args.seconds * i / (n - 1) for i in range(n)]
        b = [backlog(mine, w0 + t) for t in ts]
        mt, mb = sum(ts) / n, sum(b) / n
        slope = (sum((t - mt) * (v - mb) for t, v in zip(ts, b))
                 / sum((t - mt) ** 2 for t in ts))
        s = e2e.summarize(mine + [r for r in h.reqs.values()
                                  if r["phase"] == "session"], w0, w1,
                          tpot_until)
        row = {"rate_per_s": rate, "backlog_start": b[0],
               "backlog_mid": b[n // 2], "backlog_end": b[-1],
               "backlog_slope_per_s": slope, "waiting_at_end": waiting, **s,
               "online_captures": h.eng.aot.stats.online_compiles}
        log(json.dumps(row))
        print(json.dumps(row), flush=True)
        for r in mine:          # a drained rate's requests leave the loop
            r["phase"] = "swept"
    return 0


if __name__ == "__main__":
    sys.exit(main())
