"""Whisper-tiny [arXiv:2212.04356]. Enc-dec backbone, 4L d=384 6H ff=1536.

The conv audio frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings [B, 1500, d_model] for the encoder.
"""

from .base import EncoderConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    layer_pattern="a",
    qkv_bias=True,
    mlp_bias=True,
    norm="layernorm",
    act="gelu",
    rope=False,                # learned/sinusoidal absolute positions
    encoder=EncoderConfig(n_layers=4, n_frames=1500),
    frontend="audio",
    source="arXiv:2212.04356; unverified",
))
