"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, MoE 16 experts top-1 + 1 shared expert; early fusion (stub).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attention="gqa",
    qk_norm=True,
    num_experts=16,
    num_experts_per_tok=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    frontend="vq_stub",      # early-fusion vision tokens provided as token ids
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
