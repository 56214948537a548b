"""GQA attention for training: the reference's blockwise online-softmax
attention (``repro/models/attention.py``) in PyTorch.

Sequences of at most ``kv_block`` keys take the one-block path
(``_plain_attention``); longer ones take the blockwise online-softmax loop
(``_flash_fwd_core``) so no [S, S] score matrix is built.  The backward is
torch autograd through this math: in the reference the backward is jnp
code too (``_flash_vjp_bwd``), not a kernel.  Score matmuls accumulate and
return f32, as ``preferred_element_type=f32`` does in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import Params, apply_rope, dense_init

NEG_INF = -1e30


def _plain_attention(q, k, v, mask_bias, scale):
    """q: [B,Sq,H,D] k,v: [B,Skv,KVH,D] -> [B,Sq,H,D] (f32 softmax)."""
    b, sq, h, dk = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dk)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = scores + mask_bias  # [1,1,1,Sq,Skv] broadcast
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def _causal_bias(sq, skv, causal, device):
    """0 where ``q_pos >= k_pos`` (or everywhere without ``causal``), NEG_INF
    above the diagonal; [1,1,1,Sq,Skv] f32."""
    if not causal:
        return torch.zeros((1, 1, 1, sq, skv), dtype=torch.float32,
                           device=device)
    bias = torch.full((sq, skv), NEG_INF, dtype=torch.float32, device=device)
    return bias.triu(1)[None, None, None]


def _flash_fwd_core(q, k, v, causal, kv_block, scale):
    """Online softmax over KV blocks.  Returns out [B,Sq,H,Dv]."""
    b, sq, h, dk = q.shape
    _, skv, kvh, dv = v.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dk).to(torch.float32)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(sq, device=q.device)
    for start in range(0, skv, kv_block):
        kk = k[:, start:start + kv_block]
        vv = v[:, start:start + kv_block]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                              kk.to(torch.float32)) * scale
        if causal:
            k_pos = start + torch.arange(kv_block, device=q.device)
            scores = scores.masked_fill(q_pos[:, None] < k_pos[None, :],
                                        NEG_INF)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        o = (o * alpha[..., None]
             + torch.einsum("bhgqk,bkhd->bhgqd", p.to(vv.dtype), vv
                            ).to(torch.float32))
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = (o / l_safe[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, kv_block: int = 512,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Sq, H, Dk]; k: [B, Skv, KVH, Dk]; v: [B, Skv, KVH, Dv]."""
    _, sq, _, dk = q.shape
    skv = v.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    if skv <= kv_block:  # small sequences: one block, no loop
        return _plain_attention(q, k, v,
                                _causal_bias(sq, skv, causal, q.device),
                                scale)
    if skv % kv_block != 0:
        kv_block = next(b for b in range(kv_block, 0, -1) if skv % b == 0)
    return _flash_fwd_core(q, k, v, causal, kv_block, scale)


# --------------------------------------------------------------------------- #
# GQA attention layer
# --------------------------------------------------------------------------- #
def init_gqa(gen: torch.Generator, cfg: ModelConfig, n: int, *,
             dtype: torch.dtype, device: torch.device) -> Params:
    """``n`` stacked layers' attention params, leading dim ``n``."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "wq": dense_init(gen, (n, d, h * hd), **kw),
        "wk": dense_init(gen, (n, d, kvh * hd), **kw),
        "wv": dense_init(gen, (n, d, kvh * hd), **kw),
        "wo": dense_init(gen, (n, h * hd, d),
                         scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h * hd), **kw)
        p["bk"] = torch.zeros((n, kvh * hd), **kw)
        p["bv"] = torch.zeros((n, kvh * hd), **kw)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, h, hd), k.reshape(b, s, kvh, hd),
            v.reshape(b, s, kvh, hd))


def gqa_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                causal: bool = True, kv_block: int = 512,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention.  Returns (out, {k, v}: [B, S, KVH, D])."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = blockwise_attention(q, k, v, causal=causal, kv_block=kv_block)
    return out.reshape(b, s, -1) @ p["wo"], {"k": k, "v": v}
