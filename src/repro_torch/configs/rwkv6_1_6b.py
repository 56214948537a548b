"""RWKV6 (Finch) 1.6B [arXiv:2404.05892].

24L d_model=2048, attention-free with data-dependent decay, d_ff=7168
(channel-mix), vocab=65536.  32 heads of dim 64 for the WKV state.
"""

from .base import ModelConfig, RWKVConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,               # d_model / head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern="r",
    norm="layernorm",
    act="relu_sq",            # rwkv channel-mix uses squared relu
    rope=False,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, tokenshift_lora=32),
    source="arXiv:2404.05892; unverified",
))
