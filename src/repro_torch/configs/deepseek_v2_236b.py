"""DeepSeek-V2 236B [arXiv:2405.04434].

60L d_model=5120 128H, MLA (kv_lora=512, rope head 64), vocab=102400;
MoE: 2 shared + 160 routed experts, top-6, expert FFN dim 1536.
"""

from .base import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: latent-compressed; heads share the latent
    d_ff=1536,
    vocab_size=102400,
    layer_pattern="l",       # latent attention everywhere
    norm="rmsnorm",
    act="silu",
    rope=True,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  moe_layers="all"),
    source="arXiv:2405.04434; hf",
))
