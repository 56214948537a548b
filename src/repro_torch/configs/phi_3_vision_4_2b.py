"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct].

phi3-mini backbone: 32L d=3072 32H (kv=32) ff=8192 vocab=32064.  The CLIP
vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings that are prefixed to the token embeddings.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    layer_pattern="a",
    norm="rmsnorm",
    act="silu",
    rope=True,
    frontend="vision",
    n_frontend_tokens=256,     # stubbed CLIP patch tokens
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
))
