"""MiniCPM-2B [arXiv:2404.06395]. 40L d=2304 36H ff=5760; WSD LR schedule.

Llama-like architecture; the WSD (warmup-stable-decay) schedule is
``optim/schedule.py:wsd_schedule``, as in the reference's
``repro/optim/schedule.py``, and is selected by this config.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    layer_pattern="a",
    norm="rmsnorm",
    act="silu",
    rope=True,
    tie_embeddings=True,
    source="arXiv:2404.06395; hf",
))

LR_SCHEDULE = "wsd"  # consumed by repro/optim/schedule.py
