"""granite-3.0-1b-a400m-base [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) vocab=49155; MoE: 32 experts top-8, expert
FFN dim 512 (d_ff per assignment), every layer.
"""

from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    layer_pattern="a",
    norm="rmsnorm",
    act="silu",
    rope=True,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512, moe_layers="all"),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
))
