"""Qwen2-7B [arXiv:2407.10671]. 28L d=3584 28H (GQA kv=4) ff=18944, QKV bias."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    layer_pattern="a",
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    rope=True,
    rope_theta=1e6,
    source="arXiv:2407.10671; hf",
))
