"""A whole run of the harness on the CPU, at a reduced size: the reference
against ``repro_torch`` on both configurations' patterns (GQA with MoE on
every layer; MLA with a leading dense layer, then MoE with a shared
expert) and on a hybrid's (Mamba-2 and GQA layers, MoE every other layer,
its reference named by its file's ``"reference"``), and ``correct`` coming out false under
each fault a served cell can have, planted in the timed path underneath.

The run skips only the look for a chip: set-up, the sessions at CP 2, the
open loop, the drain, the sample and the reference are the ones a run on
the card drives.
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

import torch  # noqa: E402

from bench import common  # noqa: E402
from bench.run import run_cell  # noqa: E402

LIMIT = 1e-3

MODELS = {
    "gqa_moe": {"num_hidden_layers": 2, "hidden_size": 64,
                "num_attention_heads": 4, "num_key_value_heads": 2,
                "head_dim": 16, "intermediate_size": 128,
                "num_local_experts": 4, "num_experts_per_tok": 2,
                "vocab_size": 250, "rope_theta": 10000.0,
                "port": {"arch": "phi3.5-moe-42b-a6.6b",
                         "capacity_factor": 2.0}},
    "mla_dense_moe": {"num_hidden_layers": 2, "first_k_dense_replace": 1,
                      "hidden_size": 64, "num_attention_heads": 4,
                      "num_key_value_heads": 4, "intermediate_size": 128,
                      "moe_intermediate_size": 64, "n_routed_experts": 4,
                      "num_experts_per_tok": 2, "n_shared_experts": 1,
                      "q_lora_rank": 32, "kv_lora_rank": 32,
                      "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                      "v_head_dim": 16, "vocab_size": 250,
                      "rope_theta": 10000.0,
                      "port": {"arch": "deepseek-v3", "capacity_factor": 2.0}},
    "mamba2_attn_moe": {"num_hidden_layers": 4, "hidden_size": 64,
                        "num_attention_heads": 4, "num_key_value_heads": 2,
                        "head_dim": 16, "intermediate_size": 128,
                        "num_local_experts": 4, "num_experts_per_tok": 2,
                        "first_k_dense_replace": 1, "moe_layer_freq": 2,
                        "layer_types": ["mamba", "mamba", "attention",
                                        "mamba"],
                        "mamba_d_state": 16, "mamba_d_head": 16,
                        "mamba_n_heads": 8, "mamba_expand": 2,
                        "mamba_n_groups": 1, "mamba_d_conv": 4,
                        "mamba_chunk_size": 32, "vocab_size": 250,
                        "rope_theta": 10000.0, "reference": "moe_transformer",
                        "port": {"arch": "jamba-v0.1-52b",
                                 "capacity_factor": 2.0}},
}

MIX = {"trace_seed": 1, "prompt_intervals": [[16, 64, 0.9], [64, 160, 0.1]],
       "output_tokens": [4, 10],
       "sessions": {"count": 2, "prompt_tokens": 256, "max_new_tokens": 200}}


def tiny_cfg(model: dict):
    """The port's registered config at the model dict's reduced widths."""
    common.use_program_path()
    from repro_torch.configs import get_config
    base = get_config(model["port"]["arch"])
    return dataclasses.replace(base, **common.port_fields(model),
                               capacity_factor=model["port"]["capacity_factor"],
                               name=base.name + "-bench-tiny")


def tiny_cell(kind: str) -> dict:
    return {"name": f"tiny.{kind}", "model": MODELS[kind], "mix": MIX,
            "engine": {"num_instances": 4, "instances_per_node": 4, "tp": 2,
                       "page_size": 16, "kv_capacity_tokens": 1024,
                       "max_slots_per_instance": 8, "cp_edges": [200],
                       "cp_degrees": [1, 2]},
            "rate_per_s": 16.0, "lead_in_s": 0.25, "finish_s": 0,
            "sample_tokens": 12000, "drain_s": 60,
            "limits": {"max_logit_gap": LIMIT, "router_tie": 1e-4}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(kind: str, seed: int = 3):
    cell = tiny_cell(kind)
    return run_cell(cell, seed, 0.5, False, device="cpu",
                    cfg=tiny_cfg(cell["model"]))


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_reference_agrees_with_the_port(kind):
    out = run(kind)
    s, c = out["summary"], out["checked"]
    assert s["attempted"] == 8 and s["failed"] == 0
    assert c["requests"] >= 3 and c["tokens"] >= 20
    assert c["max_logit_gap"] <= LIMIT / 10
    # the sessions decode at CP 2: their KV lies on two instances
    h = out["harness"]
    assert all(len(r["stamps"]) > 5 for r in h.reqs.values()
               if r["phase"] == "session")


def _wrap_step(monkeypatch, fault):
    """Plant ``fault(state_before, state, tokens, tables) -> tokens`` in
    every decode step the engine builds."""
    from repro_torch.core import dcp

    real = dcp.build_decode_step

    def build(cfg, dims):
        step = real(cfg, dims)

        def faulty(params, state, tbl):
            before = {k: v.clone() for k, v in state.items()}
            state, toks, logits = step(params, state, tbl)
            return state, fault(before, state, toks, tbl), logits
        return faulty
    monkeypatch.setattr(dcp, "build_decode_step", build)


def _token_altered(before, state, toks, tbl):
    return torch.where(toks >= 0, (toks + 1) % 250, toks)


def _state_unchanged(before, state, toks, tbl):
    for k, v in before.items():
        state[k].copy_(v)
    return toks


def _recurrent_state_unchanged(before, state, toks, tbl):
    """The conv windows and SSM state restored, the KV pools updated."""
    from repro_torch.core.dcp import SSM_STATE
    for k in SSM_STATE:
        state[k].copy_(before[k])
    return toks


FAULTS = ["token_altered", "state_unchanged", "exchange_left_out",
          "half_batch_left_out"]


@pytest.mark.parametrize("kind, fault", [
    *(pytest.param("gqa_moe", f, id=f) for f in FAULTS),
    *(pytest.param("mamba2_attn_moe", f, id=f"mamba2_attn_moe-{f}")
      for f in FAULTS + ["recurrent_state_unchanged"])])
def test_a_broken_timed_path_is_not_correct(monkeypatch, kind, fault):
    common.use_program_path()
    from repro_torch.core import comm, moe_parallel
    if fault == "token_altered":
        _wrap_step(monkeypatch, _token_altered)
    elif fault == "state_unchanged":
        _wrap_step(monkeypatch, _state_unchanged)
    elif fault == "recurrent_state_unchanged":
        _wrap_step(monkeypatch, _recurrent_state_unchanged)
    elif fault == "exchange_left_out":
        # the rotation between instances delivers nothing
        monkeypatch.setattr(comm, "rotate",
                            lambda buf, delta, node: torch.zeros_like(buf))
    else:
        real = moe_parallel.moe_decode_ffn

        def half(cfg, p, x, **kw):
            y = real(cfg, p, x, **kw)
            y[y.shape[0] // 2:] = 0
            return y
        monkeypatch.setattr(moe_parallel, "moe_decode_ffn", half)
        from repro_torch.core import dcp
        monkeypatch.setattr(dcp, "moe_decode_ffn", half)
    out = run(kind, seed=5)
    assert out["checked"]["max_logit_gap"] > LIMIT


def _greedy(model, params, prompt, n, flip=None):
    """``n`` tokens of the reference's own greedy decode, with ``flip``
    (position, layer) routed the other way in every pass."""
    ref = common.load_reference(model)
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            lg = ref.logits(model, params, torch.as_tensor(seq), 1, flip)[0]
            seq.append(int(lg[-1].argmax()))
    return seq[len(prompt):]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_a_route_flipped_at_a_rounding_tie_is_explained_and_no_more(kind):
    """Tokens served with one prompt position routed the other way read
    a gap against the reference as it stands, none once that position's
    margin is under ``router_flip``, and an altered token still reads its
    gap under every variant."""
    # a third layer, every layer MoE, so that a flip before the last
    # reaches later positions
    model = dict(MODELS[kind], num_hidden_layers=3, first_k_dense_replace=0,
                 moe_layer_freq=1)
    if "layer_types" in model:
        model["layer_types"] = ["mamba", "mamba", "attention"]
    ref = common.load_reference(model)
    params = common.make_weights(tiny_cfg(model), 11, "cpu")
    gen = torch.Generator().manual_seed(7)
    for _ in range(20):
        prompt = torch.randint(0, 250, (24,), generator=gen).tolist()
        with torch.no_grad():
            _, margin, layer = ref.logits(model, params,
                                          torch.as_tensor(prompt), 1)
        early = torch.where(layer[:-1] < 2, margin[:-1], torch.inf)
        at = int(early.argmin())
        flip = (at, int(layer[at]))
        served = _greedy(model, params, prompt, 12, flip)
        plain = ref.gaps(model, params, prompt, served, router_tie=0.0)
        if plain["gap"] > 0.01:
            break
    else:
        pytest.fail("no flipped route moved a served token")
    fits = float(margin[at]) * 1.01
    flipped = ref.gaps(model, params, prompt, served, router_tie=0.0,
                       router_flip=fits)
    assert flipped["gap"] <= 1e-4 and flipped["worst"]["flipped"] == flip
    altered = list(served)
    altered[-1] = (altered[-1] + 1) % 250
    bad = ref.gaps(model, params, prompt, altered, router_tie=0.0,
                   router_flip=fits)
    assert bad["gap"] > 0.05
