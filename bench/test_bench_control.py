"""The control of ``correct`` on the card, at a size a test run can hold:
the reference computed with TF32 on, in the program's place, must come out
not correct, while the program run beside it is correct.  At the cells'
own sizes ``bench/control.py`` reads the same two numbers, and the cells'
files hold the limits set from them; one layer amplifies less than eight,
so this size has a limit of its own (LIMIT), set from its own readings on
the card: the program 0 to 2.4e-7, the control 0.138 to 0.428.

    PYTHONPATH=src python -m pytest -q -m cuda bench/test_bench_control.py
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import common  # noqa: E402
from bench.run import run_cell  # noqa: E402

LIMIT = 0.05


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _cell() -> tuple:
    """Phi-3.5-MoE's widths, one layer, 4 of its 16 experts, short chat."""
    cell = common.load_cell("phi35moe_8of32.long_sessions")
    model = dict(cell["model"], num_hidden_layers=1, num_local_experts=4)
    base = common.build_model_config(cell["model"])
    cfg = dataclasses.replace(base, **common.port_fields(model),
                              capacity_factor=2.0)
    cell.update(model=model, rate_per_s=6.0, lead_in_s=1.0, finish_s=0,
                drain_s=60,
                mix={"trace_seed": 1, "prompt_intervals": [[64, 1000, 1.0]],
                     "output_tokens": [64, 256]})
    cell["engine"] = dict(cell["engine"], kv_capacity_tokens=16384)
    return cell, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2**31 + 7, 4_000_000_003])
def test_tf32_control_is_not_correct(card, seed):
    cell, cfg = _cell()
    out = run_cell(cell, seed, 8.0, False, cfg=cfg, tf32_control=True)
    c, limit = out["checked"], LIMIT
    print(f"seed {seed}: program {c['max_logit_gap']!r}, control "
          f"{c['control_max_logit_gap']!r}, limit {limit!r}")
    assert c["tokens"] >= 500
    assert c["max_logit_gap"] <= limit
    assert c["control_max_logit_gap"] > limit
