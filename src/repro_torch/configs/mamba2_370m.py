"""mamba2-370m [ssm]: 48L d_model=1024 attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality) blocks: d_inner = 2*d_model = 2048, head_dim 64
-> 32 SSM heads.  No KV cache; decode carries (conv_state, ssm_state).
[arXiv:2405.21060; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
