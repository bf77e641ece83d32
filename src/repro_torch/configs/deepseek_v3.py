"""deepseek-v3 — the paper's own serving backbone (NanoCP evaluates on
DeepSeek-V3 / Kimi-K2).  61L d_model=7168, MLA (kv_lora=512, rope=64),
256 routed experts top-8 + 1 shared, first 3 layers dense.
[arXiv:2412.19437; hf] — used for extra dry-run cells, not in the assigned
40-cell table.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3",
    family="moe",
    num_layers=60,             # 60 uniform MoE layers scanned; (the real model's
                               # 3 leading dense layers are folded into the MoE
                               # stack for scan uniformity -- dry-run only)
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    source="arXiv:2412.19437; hf",
)
