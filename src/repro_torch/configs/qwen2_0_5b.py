"""Qwen2-0.5B [arXiv:2407.10671]. 24L d=896 14H (GQA kv=2) ff=4864, QKV bias."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    layer_pattern="a",
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    rope=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf",
))
