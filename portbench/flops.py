"""The yardstick's arithmetic: the chip's peaks, the model's FLOPs a token
and the least time a byte-bound kernel could take.

Peaks are one NVIDIA H100 SXM's published dense rates at its 700 W limit:
989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.

Model FLOPs count what the model needs, not what the program computes:
six times the matrix parameters a token passes through (forward and
backward, the active experts only: top k routed and the shared ones, and
the router; the head over the published vocabulary, not the padded
table), plus causal attention's two products, ``QK^T`` and ``PV``, over
the ``(S + 1) / 2`` keys a query sees on average, forward and backward.
No recomputation, no one-hot dispatch, no capacity padding, no masked
half of the score matrix.
"""

from __future__ import annotations

from typing import Dict

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def active_matmul_params(s: Dict) -> int:
    d, h, L = s["d_model"], s["n_heads"], s["n_layers"]
    if s["kind"] == "mla":
        m = s["mla"]
        qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
        attn = (d * m["q_lora_rank"] + m["q_lora_rank"] * h * qk
                + d * (m["kv_lora_rank"] + m["qk_rope_head_dim"])
                + m["kv_lora_rank"] * h * (m["qk_nope_head_dim"]
                                           + m["v_head_dim"])
                + h * m["v_head_dim"] * d)
    else:
        hd, kvh = s["head_dim"], s["n_kv_heads"]
        attn = 2 * d * h * hd + 2 * d * kvh * hd
    e = s["moe"]
    mlp = (d * e["n_experts"]
           + (e["top_k"] + e["n_shared"]) * 3 * d * e["d_expert"])
    return L * (attn + mlp) + d * s["vocab_size"]


def attention_flops_per_token(s: Dict, seq_len: int) -> float:
    if s["kind"] == "mla":
        m = s["mla"]
        dk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
        dv = m["v_head_dim"]
    else:
        dk = dv = s["head_dim"]
    fwd = 2 * s["n_heads"] * (dk + dv) * (seq_len + 1) / 2
    return 3 * fwd * s["n_layers"]


def model_flops_per_token(s: Dict, seq_len: int) -> float:
    return 6 * active_matmul_params(s) + attention_flops_per_token(s, seq_len)


def bound_s(nbytes: float, flops: float = 0.0,
            flops_rate: float = BF16_FLOPS) -> float:
    """The least time: the larger of the bytes over the memory rate and the
    operations over their peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_rate)
