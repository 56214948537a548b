"""Jamba v0.1 52B [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Hybrid: attention :
mamba = 1:7 (one attention layer per 8-layer block, at in-block index 3, per
the paper's Jamba block); MoE (16 experts, top-2) on every other layer.
"""

from .base import MambaConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern="mmmammmm",     # 1:7 attn:mamba, attention at index 3
    norm="rmsnorm",
    act="silu",
    rope=False,                   # Jamba uses no positional encoding
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, moe_layers="odd"),
    source="arXiv:2403.19887; hf",
))
