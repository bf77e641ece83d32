"""Operations and bytes, from shapes and lengths alone, and the card's peaks:
the yardstick of every roofline share and of ``decode_mfu``.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; work that depends on the data (a causal mask, the
experts a step's rows touch) is counted as these inputs need it.
"""
from __future__ import annotations

from .common import layer_kinds

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores (the
# port leaves TF32 off), and HBM3 bandwidth; at the 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
F32 = 4


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


# --------------------------------------------------------------------------- #
# attention kernels
# --------------------------------------------------------------------------- #
def attn_dims(model: dict) -> dict:
    """Per-layer attention shapes: q heads, kv heads, the dims q.k and p.v
    run over, and what the decode pools hold per token and layer."""
    H = model["num_attention_heads"]
    if "kv_lora_rank" in model:
        dr, kvr = model["qk_rope_head_dim"], model["kv_lora_rank"]
        # prefill: per-head K/V materialised; decode: one latent row a token
        return {"H": H, "Hkv_prefill": H,
                "dk_prefill": model["qk_nope_head_dim"] + dr,
                "dv_prefill": model["v_head_dim"],
                "Hkv_decode": 1, "dk_decode": kvr + dr, "dv_decode": kvr,
                "kv_row_floats": kvr + dr}
    hd = model.get("head_dim", model["hidden_size"] // H)
    Hkv = model["num_key_value_heads"]
    return {"H": H, "Hkv_prefill": Hkv, "dk_prefill": hd, "dv_prefill": hd,
            "Hkv_decode": Hkv, "dk_decode": hd, "dv_decode": hd,
            "kv_row_floats": 2 * Hkv * hd}


def flash_prefill(model: dict, S: int) -> tuple[float, float]:
    """(operations, bytes) of one causal prefill attention call of S tokens
    (one layer): q.k and p.v over the S(S+1)/2 unmasked pairs of each head;
    q, k, v and the output once, in float32."""
    a = attn_dims(model)
    pairs = S * (S + 1) / 2
    flops = 2.0 * a["H"] * pairs * (a["dk_prefill"] + a["dv_prefill"])
    nbytes = F32 * S * (a["H"] * a["dk_prefill"]
                        + a["Hkv_prefill"] * (a["dk_prefill"]
                                              + a["dv_prefill"])
                        + a["H"] * a["dv_prefill"])
    return flops, nbytes


def paged_decode(model: dict, rows: int, kv_tokens: int,
                 page: int = 16) -> tuple[float, float]:
    """(operations, bytes) of one layer's paged decode call over ``rows``
    query rows reading ``kv_tokens`` valid KV tokens in all: every valid
    token's pool row once (a latent row once), q, the output and its
    log-sum-exp once, and one int32 block-table entry per page."""
    a = attn_dims(model)
    flops = 2.0 * a["H"] * kv_tokens * (a["dk_decode"] + a["dv_decode"])
    nbytes = (F32 * kv_tokens * a["kv_row_floats"]
              + F32 * rows * a["H"] * (a["dk_decode"] + a["dv_decode"] + 1)
              + 4 * (kv_tokens / page + 2 * rows))
    return flops, nbytes


# --------------------------------------------------------------------------- #
# a whole decode step
# --------------------------------------------------------------------------- #
def _attn_params(model: dict) -> int:
    D, H = model["hidden_size"], model["num_attention_heads"]
    if "kv_lora_rank" in model:
        qr, kvr = model["q_lora_rank"], model["kv_lora_rank"]
        dn, dr = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
        dv = model["v_head_dim"]
        return (D * qr + qr * H * (dn + dr) + D * (kvr + dr)
                + kvr * H * (dn + dv) + H * dv * D)
    hd = model.get("head_dim", D // H)
    Hkv = model["num_key_value_heads"]
    return D * H * hd + 2 * D * Hkv * hd + H * hd * D


def attention_layers(model: dict) -> int:
    """The layers with attention: each makes one paged call a decode step
    and one flash call a prefilled prompt."""
    return sum(k["mixer"] == "attention" for k in layer_kinds(model))


def mamba_dims(model: dict) -> dict:
    """A Mamba-2 layer's sizes: d_inner, heads, head dim, state, groups and
    conv width, and the channels the conv runs over (x, B and C)."""
    din = model["mamba_expand"] * model["hidden_size"]
    hd, ns = model["mamba_d_head"], model["mamba_d_state"]
    G = model.get("mamba_n_groups", 1)
    return {"din": din, "nh": din // hd, "hd": hd, "ns": ns, "G": G,
            "W": model["mamba_d_conv"], "conv": din + 2 * G * ns}


def _mamba_params(model: dict) -> int:
    """in_proj D x (2 din + 2 G ns + nh), the conv filter and bias, out_proj
    din x D, and the per-head (A_log, D, dt_bias) and per-channel (the
    gated norm's scale) vectors."""
    m = mamba_dims(model)
    D = model["hidden_size"]
    return (D * (2 * m["din"] + 2 * m["G"] * m["ns"] + m["nh"])
            + (m["W"] + 1) * m["conv"] + m["din"] * D + 3 * m["nh"]
            + m["din"])


def mamba_state(model: dict, rows: int) -> tuple[float, float]:
    """(operations, bytes) of ``rows`` rows' recurrent state in one Mamba-2
    layer's decode step: each row's conv window (W-1) x conv channels and
    SSM state nh x hd x ns read once and written once, both float32: the
    serve state ``core/dcp.py`` allocates for the float32 pools the harness
    serves, as every count here assumes float32.  (bf16 or fp8 pools would
    keep the conv windows in bf16, the SSM state still in float32.)
    Operations: the state's decay, update and read-out, 5 per state
    element."""
    m = mamba_dims(model)
    state = m["nh"] * m["hd"] * m["ns"]
    nbytes = 2.0 * F32 * rows * ((m["W"] - 1) * m["conv"] + state)
    return 5.0 * rows * state, nbytes


def expected_experts(E: int, k: int, rows: int) -> float:
    """Experts touched by ``rows`` rows each routed to k of E, in
    expectation: E (1 - (1 - k/E)^rows)."""
    return E * (1.0 - (1.0 - k / E) ** rows)


def decode_step(model: dict, rows: int, kv_tokens: int) -> tuple[float, float]:
    """(operations, bytes) of one decode step of ``rows`` rows reading
    ``kv_tokens`` KV tokens per attention layer.  Bytes: every weight the
    step needs once (for an expert layer, the expected count of experts the
    rows touch, since the harness cannot see the routes; a shared expert or
    a shared MLP of ``shared_intermediate_size`` always), each valid KV
    token of an attention layer once, each row's recurrent state of a
    Mamba-2 layer read and written once, embeddings of the rows.
    Operations: 2 per weight a row uses, plus attention over its KV and the
    recurrence over its state."""
    D = model["hidden_size"]
    V = model["vocab_size"]
    E = model.get("n_routed_experts") or model.get("num_local_experts") or 0
    k = model.get("num_experts_per_tok", 0)
    expert = 3 * D * model.get("moe_intermediate_size",
                               model["intermediate_size"])
    shared = (model.get("n_shared_experts", 0) * expert
              + 3 * D * model.get("shared_intermediate_size", 0))
    dense = 3 * D * model["intermediate_size"]
    w_bytes = w_flops = s_bytes = s_flops = 0.0
    for kind in layer_kinds(model):
        if kind["mixer"] == "attention":
            a = _attn_params(model)
        else:
            a = _mamba_params(model)
            f, b = mamba_state(model, rows)
            s_flops += f
            s_bytes += b
        w_bytes += F32 * a
        w_flops += 2.0 * rows * a
        if kind["ffn"] == "moe":
            w_bytes += F32 * (D * E + shared
                              + expected_experts(E, k, rows) * expert)
            w_flops += 2.0 * rows * (D * E + shared + k * expert)
        else:
            w_bytes += F32 * dense
            w_flops += 2.0 * rows * dense
    w_bytes += F32 * D * V + F32 * rows * D     # head, embedding rows
    w_flops += 2.0 * rows * D * V
    at_f, at_b = paged_decode(model, rows, kv_tokens)
    L = attention_layers(model)
    return w_flops + L * at_f + s_flops, w_bytes + L * at_b + s_bytes
