"""whisper-base [audio]: enc-dec, conv frontend stubbed.

6L enc + 6L dec, d_model=512, 8H (kv=8), d_ff=2048, vocab=51865.
[arXiv:2212.04356; unverified]
The conv1d/mel frontend is a STUB: ``input_specs()`` supplies precomputed
frame embeddings of shape (B, S, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,            # decoder layers
    num_encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    attention="gqa",
    qkv_bias=True,           # whisper uses q/v bias (k bias ~0; we keep full bias)
    act="gelu",
    norm="layernorm",
    rope=False,              # learned absolute positions
    is_encoder_decoder=True,
    max_target_positions=256,
    frontend="audio_stub",
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
