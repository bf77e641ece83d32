"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536, MoE 16 experts top-2 every other layer, Mamba:attn 7:1.

Layer pattern (period 8): attention at idx%8==4, SSM elsewhere; MoE FFN at
odd layers.  NOTE (hardware adaptation, DESIGN.md §2): Jamba v0.1 uses
Mamba-1 selective-scan blocks; we implement them in the SSD (Mamba-2)
matmul formulation for MXU efficiency, with d_state widened 16->64 to keep
the SSD head structure (recorded deviation).
[arXiv:2403.19887; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attention="gqa",
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    source="arXiv:2403.19887; hf",
)
