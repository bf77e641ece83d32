"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.

Early-fusion VQ image tokens (frontend stub: ids only), qk-norm.
[arXiv:2405.09818; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    attention="gqa",
    qk_norm=True,
    frontend="vq_stub",
    source="arXiv:2405.09818; unverified",
)
