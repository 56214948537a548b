"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d=2048 32H (kv=32) ff=5632 vocab=100352; LayerNorm.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    layer_pattern="a",
    norm="layernorm",
    act="silu",
    rope=True,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
))
