"""The benchmark's yardstick on the CPU: the traffic generator, the
end-to-end arithmetic, the operation and byte counts, the result line's
schema, the configuration files against ``BENCHMARK.json`` and the port,
and that nothing under ``bench/`` imports JAX, its package or its
benchmarks."""
from __future__ import annotations

import ast
import json
import math
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import common, counts, e2e  # noqa: E402
from bench.run import result_line  # noqa: E402
from bench.traffic.generate import generate  # noqa: E402

SPEC = common.load_json(ROOT / "BENCHMARK.json")
BIG_SEED = 2**31 + 12345
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


# --------------------------------------------------------------------------- #
# traffic
# --------------------------------------------------------------------------- #
def _gen(mix, seed, rate=4.0):
    return generate(mix, rate=rate, lead_in_s=5, window_s=20, vocab=1000,
                    seed=seed)


@pytest.mark.parametrize("mix_name", ["chat", "long_sessions"])
def test_one_seed_gives_the_same_inputs(mix_name):
    mix = common.load_json(common.BENCH / "traffic" / f"{mix_name}.json")
    a, b = _gen(mix, BIG_SEED), _gen(mix, BIG_SEED)
    assert [(x.due, x.max_new_tokens, x.phase, x.prompt.tolist())
            for x in a] == [(x.due, x.max_new_tokens, x.phase,
                             x.prompt.tolist()) for x in b]


@pytest.mark.parametrize("mix_name", ["chat", "long_sessions"])
def test_seeds_share_the_schedule_and_the_lengths(mix_name):
    mix = common.load_json(common.BENCH / "traffic" / f"{mix_name}.json")
    a, b = _gen(mix, 7), _gen(mix, BIG_SEED)
    assert [(x.due, len(x.prompt), x.max_new_tokens, x.phase) for x in a] \
        == [(x.due, len(x.prompt), x.max_new_tokens, x.phase) for x in b]
    assert any(x.prompt.tolist() != y.prompt.tolist() for x, y in zip(a, b))
    win = [x for x in a if x.phase == "window"]
    assert len(win) == 80 and all(0 <= x.due < 20 for x in win)
    assert len([x for x in a if x.phase == "lead_in"]) == 20
    lens = sorted(len(x.prompt) for x in win)
    # the stratified quantiles: 0.857 / 0.964 of the mass below 1,000
    assert sum(n < 1000 for n in lens) == round(80 * 0.857 / 0.964)
    assert max(lens) <= 4096
    assert all(64 <= x.max_new_tokens <= 512 for x in win)
    sessions = [x for x in a if x.phase == "session"]
    assert [len(x.prompt) for x in sessions] == (
        [12288] * 4 if mix_name == "long_sessions" else [])


# --------------------------------------------------------------------------- #
# end-to-end arithmetic
# --------------------------------------------------------------------------- #
def test_end_to_end_arithmetic_on_a_hand_made_trace():
    reqs = [
        # due 10.0: first token 10.5, then 3 more 0.1 s apart -> TPOT 0.1
        {"phase": "window", "due": 10.0, "failed": False,
         "stamps": [10.5, 10.6, 10.7, 10.8]},
        # due 11.0: TTFT 0.2, TPOT (12.0 - 11.2) / 2 = 0.4
        {"phase": "window", "due": 11.0, "failed": False,
         "stamps": [11.2, 11.6, 12.0]},
        {"phase": "window", "due": 11.2, "failed": True, "stamps": [12.1]},
        # due after TPOT's cut (11.5): TTFT 0.1 only, its gaps not a TPOT
        {"phase": "window", "due": 11.6, "failed": False,
         "stamps": [11.7, 11.9]},
        # a lead-in request: its tokens inside the window count, nothing else
        {"phase": "lead_in", "due": 9.0, "failed": False,
         "stamps": [9.5, 10.1, 10.2]},
        # a drain request: after the window, nothing
        {"phase": "drain", "due": 12.0, "failed": False,
         "stamps": [12.2, 12.3]},
        # a session: one TPOT from its gaps inside the window, 0.3
        {"phase": "session", "due": 0.0, "failed": False,
         "stamps": [5.0, 10.0, 10.3, 10.6, 13.0]},
    ]
    s = e2e.summarize(reqs, 10.0, 12.0, 11.5)
    assert s["attempted"] == 4 and s["failed"] == 1
    assert s["ttft_samples"] == 3 and s["tpot_samples"] == 3
    # TTFTs 0.5, 0.2 and 0.1: p95 = 0.2 + 0.9 * 0.3
    assert s["ttft_p95_ms"] == pytest.approx((0.2 + 0.9 * 0.3) * 1e3)
    # TPOTs 0.1, 0.4 and the session's 0.3
    assert s["tpot_p50_ms"] == pytest.approx(300.0)
    assert s["tpot_p95_ms"] == pytest.approx((0.3 + 0.9 * 0.1) * 1e3)
    # tokens stamped in [10, 12): 4 + 2 + 0 + 2 + 2 + 0 + 3 = 13 over 2 s
    assert s["output_tokens_per_s"] == pytest.approx(6.5)


# --------------------------------------------------------------------------- #
# counts
# --------------------------------------------------------------------------- #
GQA = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
       "head_dim": 16, "num_hidden_layers": 2, "intermediate_size": 32,
       "vocab_size": 100, "num_local_experts": 4, "num_experts_per_tok": 2}


def test_flash_counts_by_hand():
    # S 3: 6 unmasked pairs x 4 heads x (16 + 16) x 2 = 1,536 operations;
    # q 3x4x16, k and v 3x2x16 each, out 3x4x16: 576 floats
    flops, nbytes = counts.flash_prefill(GQA, 3)
    assert flops == 1536 and nbytes == 576 * 4


def test_paged_counts_by_hand():
    # 2 rows over 40 KV tokens: 40 x 4 heads x 32 x 2 = 10,240 operations;
    # KV 40 x 2 x 2 x 16 floats, q/out/lse 2 x 4 x 33, tables 40/16 + 4
    flops, nbytes = counts.paged_decode(GQA, 2, 40, page=16)
    assert flops == 10240
    assert nbytes == 4 * 40 * 64 + 4 * 2 * 4 * 33 + 4 * (40 / 16 + 4)


def test_decode_step_counts_every_expert_at_most_once():
    few, many = counts.decode_step(GQA, 1, 10), counts.decode_step(GQA, 500, 10)
    expert = 3 * 64 * 32 * 4
    # 500 rows touch all 4 experts of each layer, 1 row 2: their bytes,
    # once; and per row its embedding, and per row and layer its q, output
    # and log-sum-exp and two table entries
    assert many[1] - few[1] == pytest.approx(
        2 * (4 - counts.expected_experts(4, 2, 1)) * expert + 4 * 499 * 64
        + 2 * (4 * 499 * 4 * 33 + 4 * 2 * 499), rel=1e-12)
    assert counts.expected_experts(4, 2, 1) == pytest.approx(2.0)


# --------------------------------------------------------------------------- #
# the result line
# --------------------------------------------------------------------------- #
def _fake_out():
    steps = [{"timings": {"step_us": 40e3, "harvest_us": 30e3,
                          "dispatch_us": 50.0}, "decode": True, "rows": 64,
              "kv_tokens": 50000, "batch_sizes": [16, 16, 20, 12],
              "prefills": [], "t0": 0, "t1": 1},
             {"timings": {"step_us": 300e3, "harvest_us": 1e3,
                          "prefill_us": 250e3, "dispatch_us": 50.0},
              "decode": True, "rows": 65, "kv_tokens": 52000,
              "batch_sizes": [16, 17, 20, 12], "prefills": [2000],
              "t0": 1, "t1": 2}]
    rec = {"model": common.load_json(common.BENCH / "configs"
                                     / "phi35moe_8of32.json"),
           "steps": steps, "aot_online_window": 0, "busy_s": 0.9,
           "window_s": 1.0, "graph_kernel_s": 0.08, "graph_launches": 2,
           "kernel_s": {"void paged_split_kernel<float, float, 1, 2>(Args)":
                        0.01, "flash_fwd_f32(Params, int)": 0.02},
           "device_ops": [["x", 0.5]], "idle_gaps": [["engine.step", 0.1]]}
    rec["cell"] = common.load_cell("phi35moe_8of32.long_sessions")
    return {"summary": {"attempted": 10, "failed": 0, "ttft_p95_ms": 1.0,
                        "tpot_p50_ms": 2.0, "tpot_p95_ms": 3.0,
                        "output_tokens_per_s": 4.0},
            "setup_s": 5.0, "peak": 7e10, "rec": rec,
            "checked": {"max_logit_gap": 0.0}}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_result_line_meets_the_schema(cell, trace):
    c = common.load_cell(cell)
    r = result_line(SPEC, c, _fake_out(), trace, "NVIDIA H100 80GB HBM3")
    line = json.loads(json.dumps(r))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "compared" and line["correct"] is True
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    want = SPEC["per_layer"] if trace else SPEC["end_to_end"]
    assert set(line["metrics"]) == {m["name"] for m in want}
    for m in want:
        v = line["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and math.isfinite(v["value"])
    if trace:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
        for m in ("paged_decode_roofline", "flash_fwd_roofline",
                  "decode_mfu"):
            assert 0 < line["metrics"][m]["value"] <= 100


# --------------------------------------------------------------------------- #
# BENCHMARK.json, configuration files and the port
# --------------------------------------------------------------------------- #
def test_benchmark_json_names_files_that_exist():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for w in SPEC["workloads"]:
        cell = common.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["why"]) == (
            w["config"], w["traffic"], w["why"])
    for m in SPEC["per_layer"]:
        assert (common.BENCH / "metrics" / f"{m['name']}.py").exists()
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_a_configuration_file_keeps_every_published_width(entry):
    model = common.load_json(ROOT / entry["file"])
    assert model["source"] == entry["source"]
    # reduced names exactly the keys whose value differs from the source's
    assert sorted(model["reduced"]) == sorted(entry["reduced"])
    for key, vals in model["reduced"].items():
        assert model[key] == vals["here"] != vals["source"]
        assert key not in common.WIDTH_KEYS
    cfg = common.build_model_config(model)
    H = model["num_attention_heads"]
    want = {"d_model": model["hidden_size"], "num_heads": H,
            "d_ff": model["intermediate_size"],
            "vocab_size": model["vocab_size"],
            "num_experts": (model.get("n_routed_experts")
                            or model.get("num_local_experts")),
            "num_experts_per_tok": model["num_experts_per_tok"],
            "moe_d_ff_": model.get("moe_intermediate_size",
                                   model["intermediate_size"]),
            "num_shared_experts": model.get("n_shared_experts", 0),
            "num_layers": model["num_hidden_layers"]}
    if "kv_lora_rank" in model:
        want.update({k: model[k] for k in (
            "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
            "qk_rope_head_dim", "v_head_dim")})
    else:
        want.update(num_kv_heads=model["num_key_value_heads"],
                    head_dim_=model["hidden_size"] // H)
    assert {k: getattr(cfg, k) for k in want} == want
    kinds = cfg.layer_kinds()
    assert [k["ffn"] == "moe" for k in kinds] == [
        common.layer_is_moe(model, i) for i in range(len(kinds))]


def test_dsv3_keeps_its_leading_dense_layer():
    model = common.load_json(common.BENCH / "configs" / "dsv3_2of61.json")
    kinds = common.build_model_config(model).layer_kinds()
    assert [k["ffn"] for k in kinds] == ["dense", "moe"]
    assert model["topk_group"] == 4 and model["n_group"] == 8
    assert model["rope_scaling"]["type"] == "yarn"


# --------------------------------------------------------------------------- #
# imports
# --------------------------------------------------------------------------- #
def test_nothing_under_bench_imports_jax_or_its_package():
    banned = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    for path in common.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            tops = {m.split(".")[0] for m in mods}
            assert not tops & banned, f"{path}: imports {tops & banned}"


def test_the_reference_imports_nothing_of_the_program():
    path = common.BENCH / "reference" / "moe_transformer.py"
    src = path.read_text()
    assert "repro_torch" not in src and "import jax" not in src
