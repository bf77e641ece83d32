"""The control of ``correct``: one run of a cell, then the reference over
the sampled prompts and served tokens twice, in float32 with TF32 off and
with TF32 on.  Prints the program's widest gap and the control's (the gap
of the token TF32 puts first at the same positions) as one JSON line, with
the run's end-to-end numbers, and each put through the result line's
``correct`` at the cell's limit: the program must come out correct and the
control not, else it exits 1.

    python3 bench/control.py --workload <cell> --seed <n> --seconds <s>

The limit of ``max_logit_gap`` in a cell's file lies between the largest
program reading over a dozen seeds and the smallest control reading.  The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import common  # noqa: E402
from bench.run import (parse, require_devices, result_line,  # noqa: E402
                       run_cell)


def main(argv=None) -> int:
    args = parse(argv)
    cell = common.load_cell(args.workload)
    require_devices(cell.get("chips", 1))
    out = run_cell(cell, args.seed, args.seconds, False, tf32_control=True)
    c = out["checked"]
    s = out["summary"]
    spec = common.load_json(common.ROOT / "BENCHMARK.json")

    def correct(gap):
        o = dict(out, checked=dict(c, max_logit_gap=gap))
        return result_line(spec, cell, o, False, "")["correct"]
    program_ok = correct(c["max_logit_gap"])
    control_ok = correct(c["control_max_logit_gap"])
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "program_correct": program_ok,
                      "control_correct": control_ok,
                      "program_max_logit_gap": c["max_logit_gap"],
                      "control_max_logit_gap": c["control_max_logit_gap"],
                      "requests": c["requests"], "tokens": c["tokens"],
                      "router_ties": c["router_ties"], "worst": c["worst"],
                      "limit": cell["limits"]["max_logit_gap"],
                      "setup_s": out["setup_s"], "peak_bytes": out["peak"],
                      **{k: s[k] for k in ("tpot_p50_ms", "tpot_p95_ms",
                                           "ttft_p95_ms",
                                           "output_tokens_per_s", "attempted",
                                           "failed")}}), flush=True)
    return 0 if program_ok and not control_ok else 1


if __name__ == "__main__":
    sys.exit(main())
