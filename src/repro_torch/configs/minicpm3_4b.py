"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA.

Multi-head latent attention (DeepSeek-V2-style): q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64.  Decode caches the compressed latent
(kv_lora + rope = 288/token) and runs MQA over it (FlashMLA analogue).
[hf:openbmb/MiniCPM3-4B; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    source="hf:openbmb/MiniCPM3-4B; hf",
)
