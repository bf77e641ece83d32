"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400,
vocab=32064, MoE 16 experts top-2 on every layer.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    attention="gqa",
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=6400,
    norm="layernorm",
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)
