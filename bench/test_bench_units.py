"""The benchmark's yardstick on the CPU: the traffic generator, the
end-to-end arithmetic, the operation and byte counts, the result line's
schema, the configuration files against ``BENCHMARK.json`` and the port,
the weights made from the seed, the hybrid reference's Mamba-2 block, and
that nothing under ``bench/`` imports JAX, its package or its
benchmarks."""
from __future__ import annotations

import ast
import dataclasses
import hashlib
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


# a hybrid's source keys: Mamba-2 layers of d_inner 128 (8 heads of 16,
# state 16, one group, conv 4) beside attention
MAMBA = {"mamba_d_state": 16, "mamba_d_head": 16, "mamba_n_heads": 8,
         "mamba_expand": 2, "mamba_n_groups": 1, "mamba_d_conv": 4,
         "mamba_chunk_size": 32}


def test_decode_step_counts_a_mamba_layer_by_hand():
    dense = dict(GQA, num_local_experts=0, layer_types=["mamba", "attention"],
                 **MAMBA)
    attn_only = dict(dense, layer_types=["attention", "attention"])
    rows, kv = 3, 40
    f, b = counts.decode_step(dense, rows, kv)
    fa, ba = counts.decode_step(attn_only, rows, kv)
    # a Mamba-2 layer: in_proj 64 x (2 x 128 + 2 x 16 + 8), conv 4 x 160 and
    # its bias 160, out_proj 128 x 64, A_log / D / dt_bias 3 x 8, norm 128
    mamba = 64 * 296 + 5 * 160 + 128 * 64 + 24 + 128
    # attention: q 64 x 64, k and v 64 x 32 each, out 64 x 64
    attn = 64 * 64 + 2 * 64 * 32 + 64 * 64
    pf, pb = counts.paged_decode(dense, rows, kv)
    # each row's conv window 3 x 160 and state 8 x 16 x 16, read and written
    state_bytes = 2 * 4 * rows * (3 * 160 + 8 * 16 * 16)
    assert b == ba + 4 * (mamba - attn) - pb + state_bytes
    assert f == fa + 2 * rows * (mamba - attn) - pf + 5 * rows * 8 * 16 * 16
    assert counts.attention_layers(dense) == 1


def test_decode_step_counts_a_shared_mlp_of_its_own_width():
    shared = dict(GQA, shared_intermediate_size=48)
    f, b = counts.decode_step(shared, 5, 40)
    f0, b0 = counts.decode_step(GQA, 5, 40)
    assert b - b0 == 2 * 4 * 3 * 64 * 48
    assert f - f0 == 2 * 2 * 5 * 3 * 64 * 48


@pytest.mark.parametrize("name", ["paged_decode_roofline",
                                  "flash_fwd_roofline"])
def test_the_kernel_shares_count_attention_layers_only(name):
    from bench.run import read_metrics
    spec = [m for m in SPEC["per_layer"] if m["name"] == name]
    rec = _fake_out()["rec"]
    model = dict(rec["model"], num_hidden_layers=10, **MAMBA)
    full = read_metrics(spec, dict(rec, model=model))[name]["value"]
    model["layer_types"] = ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
    one = read_metrics(spec, dict(rec, model=model))[name]["value"]
    assert one == pytest.approx(full / 10, rel=1e-12)


# the parent's readings (before configurations could name their mixers):
# sha-256 of make_weights on each accepted configuration cut by
# ``configs.base.reduced``, seed BIG_SEED
PARENT_WEIGHTS = {
    "phi35moe_8of32":
        "21be11c47d7dd7384b3d425566fdc3d15dca0392f55f1f9b9cc105b843ff62b8",
    "dsv3_2of61":
        "c35a20a8f845368f432ba6084785b4322275f6c6742cea598822d314223f7fb2",
}
# (rows, KV tokens): decode_step's (operations, bytes) and paged_decode's
# times the layers; then (S): flash_prefill's times the layers
PARENT_COUNTS = {
    "phi35moe_8of32": {
        "decode": [
            (1, 0, 3451387904.0, 6903055424.0, 0.0, 263232.0),
            (1, 1000, 3582459904.0, 6968593424.0, 131072000.0, 65801232.0),
            (1, 123457, 19633143808.0, 14994180290.0,
             16181755904.0, 8091388098.0),
            (7, 0, 24159715328.0, 26324861120.0, 0.0, 1842624.0),
            (7, 1000, 24290787328.0, 26390399120.0, 131072000.0, 67380624.0),
            (7, 123457, 40341471232.0, 34415985986.0,
             16181755904.0, 8092967490.0),
            (64, 0, 220888825856.0, 42145000513.31332, 0.0, 16846848.0),
            (64, 1000, 221019897856.0, 42210538513.31332,
             131072000.0, 82384848.0),
            (64, 123457, 237070581760.0, 50236125379.31332,
             16181755904.0, 8107971714.0),
            (500, 0, 1725693952000.0, 42274737408.0, 0.0, 131616000.0),
            (500, 1000, 1725825024000.0, 42340275408.0,
             131072000.0, 197154000.0),
            (500, 123457, 1741875707904.0, 50365862274.0,
             16181755904.0, 8222740866.0),
        ],
        "flash": [
            (1, 131072.0, 327680),
            (100, 661913600.0, 32768000),
            (4096, 1099780063232.0, 1342177280),
        ],
    },
    "dsv3_2of61": {
        "decode": [
            (1, 0, 4190896128.0, 8382936080.0, 0.0, 1115152.0),
            (1, 1000, 4747952128.0, 8387544580.0, 557056000.0, 5723652.0),
            (1, 123457, 72963358720.0, 8951887664.5,
             68772462592.0, 570066736.5),
            (7, 0, 29336272896.0, 15967363467.3125, 0.0, 7806064.0),
            (7, 1000, 29893328896.0, 15971971967.3125,
             557056000.0, 12414564.0),
            (7, 123457, 98108735488.0, 16536315051.8125,
             68772462592.0, 576757648.5),
            (64, 0, 268217352192.0, 46231350314.510056, 0.0, 71369728.0),
            (64, 1000, 268774408192.0, 46235958814.510056,
             557056000.0, 75978228.0),
            (64, 123457, 336989814784.0, 46800301899.010056,
             68772462592.0, 640321312.5),
            (500, 0, 2095448064000.0, 52641568965.50897, 0.0, 557576000.0),
            (500, 1000, 2096005120000.0, 52646177465.50897,
             557056000.0, 562184500.0),
            (500, 123457, 2164220526592.0, 53210520550.00897,
             68772462592.0, 1126527584.5),
        ],
        "flash": [
            (1, 163840.0, 655360),
            (100, 827392000.0, 65536000),
            (4096, 1374725079040.0, 2684354560),
        ],
    },
}


@pytest.mark.parametrize("name", sorted(PARENT_COUNTS))
def test_the_accepted_configurations_count_as_at_the_parent(name):
    model = common.load_json(common.BENCH / "configs" / f"{name}.json")
    L = counts.attention_layers(model)
    for rows, kv, *want in PARENT_COUNTS[name]["decode"]:
        pf, pb = counts.paged_decode(model, rows, kv, 16)
        assert [*counts.decode_step(model, rows, kv), L * pf, L * pb] == want
    for S, *want in PARENT_COUNTS[name]["flash"]:
        ff, fb = counts.flash_prefill(model, S)
        assert [L * ff, L * fb] == want


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


def _granite(**over) -> dict:
    """granite-4.0-h-small's published keys that set the port's fields, at
    one period of 10 layers."""
    return {"num_hidden_layers": 10, "hidden_size": 4096,
            "num_attention_heads": 32, "num_key_value_heads": 8,
            "intermediate_size": 768, "shared_intermediate_size": 1536,
            "num_local_experts": 72, "num_experts_per_tok": 10,
            "vocab_size": 100352, "rope_theta": 10000,
            "position_embedding_type": "nope",
            "layer_types": ["mamba"] * 5 + ["attention"] + ["mamba"] * 4,
            "mamba_d_state": 128, "mamba_d_head": 64, "mamba_n_heads": 128,
            "mamba_expand": 2, "mamba_n_groups": 1, "mamba_d_conv": 4,
            "mamba_chunk_size": 256, **over}


@pytest.mark.parametrize("periods", [1, 4])
def test_a_granite_shaped_pattern_gives_the_ports_terms(periods):
    g = _granite()
    model = _granite(num_hidden_layers=10 * periods,
                     layer_types=g["layer_types"] * periods)
    f = common.port_fields(model)
    assert (f["attn_every"], f["attn_offset"]) == (10, 5)
    assert (f["moe_every"], f["moe_offset"]) == (1, 0)
    assert (f["ssm_state"], f["ssm_head_dim"], f["ssm_expand"],
            f["ssm_conv_width"], f["ssm_chunk"]) == (128, 64, 2, 4, 256)
    assert "num_shared_experts" not in f
    kinds = common.layer_kinds(model)
    assert [k["mixer"] for k in kinds].count("attention") == periods
    assert counts.attention_layers(model) == periods
    with pytest.raises(ValueError, match="one group"):
        common.port_fields(_granite(mamba_n_groups=2))
    with pytest.raises(ValueError, match="not periodic"):
        common.port_fields(_granite(layer_types=["attention"] * 2
                                    + ["mamba"] * 8))


@pytest.mark.parametrize("name", sorted(PARENT_WEIGHTS))
def test_full_attention_in_layer_types_is_plain_attention(name):
    """``"full_attention"``, as many published files spell plain causal
    attention, reads as attention: a file of such layers builds and counts
    as the same file with no ``layer_types``; a kind the port does not run
    is refused by name."""
    model = common.load_json(common.BENCH / "configs" / f"{name}.json")
    L = model["num_hidden_layers"]
    spelled = dict(model, layer_types=["full_attention"] * L)
    assert common.layer_kinds(spelled) == common.layer_kinds(model)
    assert common.port_fields(spelled) == common.port_fields(model)
    assert common.build_model_config(spelled) == \
        common.build_model_config(model)
    assert counts.decode_step(spelled, 64, 4096) == \
        counts.decode_step(model, 64, 4096)
    g = _granite(layer_types=["mamba"] * 5 + ["full_attention"]
                 + ["mamba"] * 4)
    assert (common.port_fields(g)["attn_every"],
            common.port_fields(g)["attn_offset"]) == (10, 5)
    with pytest.raises(ValueError, match="sliding_attention"):
        common.layer_kinds(dict(model, layer_types=["sliding_attention"]
                                + ["full_attention"] * (L - 1)))


def test_port_fields_map_further_published_keys():
    """``port.fields`` maps a published key onto a port field, checked
    like every other: the port's number builds, another is refused."""
    model = common.load_json(common.BENCH / "configs" / "phi35moe_8of32.json")
    model["port"] = dict(model["port"],
                         fields={"tie_embeddings": "tie_word_embeddings"})
    assert common.build_model_config(model).tie_embeddings is False
    with pytest.raises(ValueError, match="tie_embeddings"):
        common.build_model_config(dict(model, tie_word_embeddings=True))
    model["port"]["fields"] = {"no_such_field": "vocab_size"}
    with pytest.raises(ValueError, match="no field no_such_field"):
        common.build_model_config(model)


def test_a_hybrid_file_is_checked_against_the_ports_ssm_heads():
    """Jamba-v0.1's widths in one period of 8 (attention at 4, MoE on odd
    layers), its Mamba layers at the port's SSD sizes."""
    model = {"num_hidden_layers": 8, "hidden_size": 4096,
             "num_attention_heads": 32, "num_key_value_heads": 8,
             "intermediate_size": 14336, "num_local_experts": 16,
             "num_experts_per_tok": 2, "first_k_dense_replace": 1,
             "moe_layer_freq": 2, "vocab_size": 65536, "rope_theta": 10000,
             "layer_types": ["mamba"] * 4 + ["attention"] + ["mamba"] * 3,
             "mamba_d_state": 64, "mamba_d_head": 64, "mamba_n_heads": 128,
             "mamba_expand": 2, "mamba_d_conv": 4, "mamba_chunk_size": 128,
             "port": {"arch": "jamba-v0.1-52b", "capacity_factor": 8.0}}
    cfg = common.build_model_config(model)
    assert [k["mixer"] for k in cfg.layer_kinds()] == [
        "ssm" if k["mixer"] == "mamba" else "attn"
        for k in common.layer_kinds(model)]
    assert cfg.ssm_num_heads == 128
    with pytest.raises(ValueError, match="Mamba-2 heads"):
        common.build_model_config(dict(model, mamba_n_heads=64))


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
    paths = sorted((common.BENCH / "reference").glob("*.py"))
    assert {p.name for p in paths} >= {"moe_transformer.py",
                                       "hybrid_mamba2.py"}
    for path in paths:
        src = path.read_text()
        assert "repro_torch" not in src and "import jax" not in src, path


# --------------------------------------------------------------------------- #
# weights from the seed
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(PARENT_WEIGHTS))
def test_the_accepted_configurations_weights_are_the_parents(name):
    import torch
    from repro_torch.configs.base import reduced
    model = common.load_json(common.BENCH / "configs" / f"{name}.json")
    params = common.make_weights(reduced(common.build_model_config(model)),
                                 BIG_SEED, "cpu")
    h = hashlib.sha256()
    for _, t in common._leaves(params):
        assert t.dtype == torch.float32
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == PARENT_WEIGHTS[name]


def _hybrid(layers: int = 4, **over) -> dict:
    """A tiny hybrid on the port's Jamba: Mamba-2, Mamba-2, attention,
    Mamba-2 in each period of 4, MoE every other layer."""
    return {"num_hidden_layers": layers, "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 16, "intermediate_size": 128, "num_local_experts": 4,
            "num_experts_per_tok": 2, "first_k_dense_replace": 1,
            "moe_layer_freq": 2, "vocab_size": 250, "rope_theta": 10000.0,
            "layer_types": ["mamba", "mamba", "attention", "mamba"]
            * (layers // 4), **MAMBA,
            "port": {"arch": "jamba-v0.1-52b", "capacity_factor": 2.0},
            **over}


def _hybrid_cfg(model: dict):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(model["port"]["arch"]),
                               **common.port_fields(model))


def _mamba_leaves(params, name: str):
    import torch
    return torch.cat([t.flatten() for path, t in common._leaves(params)
                      if path[-1] == name and "mixer" in path])


@pytest.mark.parametrize("layers", [4, 12])
def test_state_space_weights_keep_their_ranges_whatever_the_depth(layers):
    """Each Mamba-2 vector has its own distribution, the same on one block
    as on three."""
    import torch
    import torch.nn.functional as F
    model = _hybrid(layers)
    cfg = _hybrid_cfg(model)
    assert cfg.num_blocks == layers // 4
    params = common.make_weights(cfg, BIG_SEED, "cpu")
    n_ssm = 3 * cfg.num_blocks
    A = _mamba_leaves(params, "A_log").exp()
    dt = F.softplus(_mamba_leaves(params, "dt_bias"))
    assert A.numel() == 8 * n_ssm
    assert A.min() >= 1.0 and A.max() <= 16.0 and 4 < A.mean() < 13
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert -2.6 < dt.log10().mean() < -1.4
    for name, mean, std in (("D", 1.0, 0.1), ("norm", 1.0, 0.1),
                            ("conv_b", 0.0, 0.1), ("conv_w", 0.0, 0.5)):
        t = _mamba_leaves(params, name)
        assert abs(float(t.mean()) - mean) < 4 * std / t.numel() ** 0.5
        # the sample's std lies within 4 of its standard errors
        assert abs(float(t.std()) / std - 1) < 4 / (2 * t.numel()) ** 0.5
    for path, t in common._leaves(params):
        assert torch.isfinite(t).all(), path


# --------------------------------------------------------------------------- #
# the hybrid reference's Mamba-2 block
# --------------------------------------------------------------------------- #
def _mamba2_by_token(model, p, h):
    """The Mamba-2 block, one position and one head at a time."""
    import torch
    import torch.nn.functional as F
    D = model["hidden_size"]
    din = model["mamba_expand"] * D
    hd, ns = model["mamba_d_head"], model["mamba_d_state"]
    G, W = model["mamba_n_groups"], model["mamba_d_conv"]
    nh = din // hd
    proj = h @ p["in_proj"]
    window = torch.zeros(W, din + 2 * G * ns)
    state = torch.zeros(nh, hd, ns)
    out = []
    for t in range(h.shape[0]):
        z = proj[t, :din]
        window = torch.cat([window[1:], proj[t, din:2 * din + 2 * G * ns][None]])
        c = F.silu((window * p["conv_w"]).sum(0) + p["conv_b"])
        x = c[:din].reshape(nh, hd)
        B = c[din:din + G * ns].reshape(G, ns)
        C = c[din + G * ns:].reshape(G, ns)
        dt = F.softplus(proj[t, -nh:] + p["dt_bias"])
        y = torch.empty(nh, hd)
        for k in range(nh):
            g = k // (nh // G)
            a = torch.exp(-dt[k] * torch.exp(p["A_log"][k]))
            state[k] = a * state[k] + dt[k] * torch.outer(x[k], B[g])
            y[k] = state[k] @ C[g] + p["D"][k] * x[k]
        g = y.flatten() * F.silu(z)
        g = g * torch.rsqrt(g.square().mean() + 1e-6) * p["norm"]
        out.append(g @ p["out_proj"])
    return torch.stack(out)


@pytest.mark.parametrize("groups", [1, 2])
def test_the_mamba2_block_equals_a_per_token_loop(groups):
    import torch
    from bench.reference import hybrid_mamba2
    model = _hybrid(mamba_n_groups=groups)
    din, ns, nh, W = 128, 16, 8, 4
    conv = din + 2 * groups * ns
    gen = torch.Generator().manual_seed(5)
    shapes = {"in_proj": (64, 2 * din + 2 * groups * ns + nh),
              "conv_w": (W, conv), "conv_b": (conv,), "A_log": (nh,),
              "D": (nh,), "dt_bias": (nh,), "norm": (din,),
              "out_proj": (din, 64)}
    p = {}
    for name, shape in shapes.items():
        z = torch.randn(shape, generator=gen)
        p[name] = common.RULES.get(name, common._matrix)(z, shape)
    # 150 positions: two whole blocks of the scan and part of a third
    h = torch.randn(150, 64, generator=gen)
    with torch.no_grad():
        got = hybrid_mamba2.mamba2(model, p, h)
        want = _mamba2_by_token(model, p, h)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_the_hybrid_reference_takes_granites_published_keys():
    """A tied head is the embeddings' transpose, its padded rows 0; the
    multipliers scale what the source says they scale; NoPE leaves out the
    rotation."""
    import torch
    from bench.reference import moe_transformer as ref
    model = _hybrid(tie_word_embeddings=True)
    model["port"] = dict(model["port"],
                         fields={"tie_embeddings": "tie_word_embeddings"})
    params = common.make_weights(_hybrid_cfg(model), BIG_SEED, "cpu")
    tok = params["embed"]["tok"]
    assert "head" not in params and not tok[250:].any()
    seq = torch.randint(0, 250, (40,),
                        generator=torch.Generator().manual_seed(3))

    def run(**over):
        with torch.no_grad():
            return ref.logits(dict(model, **over), params, seq, 5)[0]
    plain = run()
    assert torch.equal(run(logits_scaling=2), plain / 2)
    hd = model["head_dim"]
    assert torch.equal(run(attention_multiplier=hd ** -0.5), plain)
    assert not torch.allclose(run(position_embedding_type="nope"), plain)
    # with no residual branch the logits are the scaled embeddings' own
    x = ref._norm(tok[seq[-5:]] * 12, params["final_norm"])
    assert torch.allclose(run(residual_multiplier=0, embedding_multiplier=12),
                          x @ tok[:250].T, rtol=1e-5, atol=1e-5)


def test_the_mamba2_block_equals_the_ports_ssm_block():
    import torch
    from bench.reference import hybrid_mamba2
    from repro_torch.models import ssm
    from repro_torch.models.transformer import block_slice
    model = _hybrid()
    cfg = _hybrid_cfg(model)
    params = common.make_weights(cfg, BIG_SEED, "cpu")
    p = block_slice(params["blocks"]["layers"][1]["mixer"], 0)
    # 100 positions: three whole chunks of the port's scan (32) and a part
    h = torch.randn(100, 64, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        got = hybrid_mamba2.mamba2(model, p, h)
        want = ssm.ssm_block(cfg, p, h[None])[0][0]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)
