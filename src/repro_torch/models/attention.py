"""GQA attention: the reference's blockwise online-softmax attention and
its KV-cache decode (``repro/models/attention.py``) in PyTorch.

Sequences of at most ``kv_block`` keys take the one-block path
(``_plain_attention``); longer ones take the blockwise online-softmax loop
(``_flash_fwd_core``) so no [S, S] score matrix is built.  That loop is
differentiated as the reference's ``jax.custom_vjp`` (``_flash_vjp``) does
it, by ``_FlashAttention``: the forward saves only (q, k, v, out, lse) and
the backward recomputes each KV block's scores from ``lse``, in plain
PyTorch (the reference's backward is jnp code too, not a kernel).  Score
matmuls accumulate and return f32, as ``preferred_element_type=f32`` does
in the reference.

Under ``set_attention_impl("pallas")`` full-sequence attention with
``Sq == Skv`` (the prefill) goes to the flash-attention kernel instead, as
in the reference.  Decode (``decode_attention``, ``gqa_decode``,
``gqa_decode_q8``) is plain PyTorch, as it is plain jnp in the reference,
and writes the new position into the cache tensors in place (the reference
donates the cache to ``jit`` for the same effect).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist.flatbuf import encode_int8, int8_scale
from ..kernels.ops import flash_attention_op
from .layers import Params, apply_rope, dense_init

NEG_INF = -1e30

# "blockwise" (the online-softmax loop below; the default, and the only
# choice for training) or "pallas" (the reference's name for its flash
# kernel: here the CUDA flash-attention kernel on the card and its plain
# PyTorch version on the CPU, through ``kernels.ops.flash_attention_op``)
_ATTN_IMPL = "blockwise"


def set_attention_impl(impl: str) -> None:
    global _ATTN_IMPL
    if impl not in ("blockwise", "pallas"):
        raise ValueError(f"attention impl {impl!r}: 'blockwise' or 'pallas'")
    _ATTN_IMPL = impl


def get_attention_impl() -> str:
    return _ATTN_IMPL


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


def _causal_bias(sq, skv, q_offset, causal, device):
    """0 where ``q_offset + q_pos >= k_pos`` (or everywhere without
    ``causal``), NEG_INF above the diagonal; [1,1,1,Sq,Skv] f32."""
    if not causal:
        return torch.zeros((1, 1, 1, sq, skv), dtype=torch.float32,
                           device=device)
    bias = torch.full((sq, skv), NEG_INF, dtype=torch.float32, device=device)
    return bias.triu(1 + q_offset)[None, None, None]


def _block_mask(sq, kv_block, q_offset, start, device):
    """True where ``q_offset + q_pos >= k_pos`` for keys [start, start +
    kv_block); [Sq, kv_block]."""
    q_pos = torch.arange(q_offset, q_offset + sq, device=device)
    k_pos = start + torch.arange(kv_block, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _flash_fwd_core(q, k, v, causal, q_offset, kv_block, scale):
    """Online softmax over KV blocks.  Returns (out [B,Sq,H,Dv], lse
    [B,KVH,G,Sq] f32)."""
    b, sq, h, dk = q.shape
    _, skv, kvh, dv = v.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dk).to(torch.float32)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, kvh, g, sq, dv), dtype=torch.float32, device=q.device)
    for start in range(0, skv, kv_block):
        kk = k[:, start:start + kv_block]
        vv = v[:, start:start + kv_block]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                              kk.to(torch.float32)) * scale
        if causal:
            scores = scores.masked_fill(
                ~_block_mask(sq, kv_block, q_offset, start, q.device),
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
    lse = m + torch.log(l_safe)
    return out.reshape(b, sq, h, dv).to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, do, causal, q_offset, kv_block, scale):
    """The reference's ``_flash_vjp_bwd``: per KV block, p = exp(s - lse)
    recomputed in f32, then dv = p^T do, ds = p (do v^T - delta) scale,
    dq += ds k, dk = ds^T q.  Grads come back in the inputs' dtypes."""
    b, sq, h, dk = q.shape
    _, skv, kvh, dv = v.shape
    g = h // kvh
    f32 = torch.float32
    qg = q.reshape(b, sq, kvh, g, dk).to(f32)
    dog = do.reshape(b, sq, kvh, g, dv).to(f32)
    outg = out.reshape(b, sq, kvh, g, dv).to(f32)
    # delta = rowsum(do * out): the softmax-jacobian diagonal correction
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dog, outg)
    dq = torch.zeros((b, sq, kvh, g, dk), dtype=f32, device=q.device)
    dk_out = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv_out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    for start in range(0, skv, kv_block):
        kkf = k[:, start:start + kv_block].to(f32)
        vvf = v[:, start:start + kv_block].to(f32)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kkf) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            p = p.masked_fill(
                ~_block_mask(sq, kv_block, q_offset, start, q.device), 0.0)
        dv_out[:, start:start + kv_block] = torch.einsum(
            "bhgqk,bqhgd->bkhd", p, dog)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vvf)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kkf)
        dk_out[:, start:start + kv_block] = torch.einsum(
            "bhgqk,bqhgd->bkhd", ds, qg)
    return dq.reshape(b, sq, h, dk).to(q.dtype), dk_out, dv_out


class _FlashAttention(torch.autograd.Function):
    """The blockwise loop with the reference's flash VJP: saves exactly
    (q, k, v, out, lse), recomputes the scores block by block in the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_block, scale):
        out, lse = _flash_fwd_core(q, k, v, causal, q_offset, kv_block,
                                   scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, kv_block, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, out, lse, do, *ctx.args),
                None, None, None, None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, q_offset: int = 0,
                        kv_block: int = 512,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Sq, H, Dk]; k: [B, Skv, KVH, Dk]; v: [B, Skv, KVH, Dv].
    ``q_offset`` is the absolute position of q[0] for the causal mask."""
    _, sq, _, dk = q.shape
    skv, dv = v.shape[1], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    if (_ATTN_IMPL == "pallas" and dk == dv and q_offset == 0 and sq == skv
            and sq % 16 == 0):
        # the reference's dispatch condition; the kernel reads the
        # [B, S, H, D] tensors through transposed views
        out = flash_attention_op(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 scale=scale, block_q=min(128, sq),
                                 block_k=min(128, skv))
        return out.transpose(1, 2)
    if skv <= kv_block:  # small sequences: one block, no loop
        return _plain_attention(
            q, k, v, _causal_bias(sq, skv, q_offset, causal, q.device), scale)
    if skv % kv_block != 0:
        kv_block = next(b for b in range(kv_block, 0, -1) if skv % b == 0)
    return _FlashAttention.apply(q, k, v, causal, q_offset, kv_block, scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention over a [B, S, KVH, D] cache; q: [B, H, D].

    Positions from ``length`` on are masked.  The scores are f32 from the
    cache's own values, as ``preferred_element_type=f32`` gives them in the
    reference: a bf16 cache is widened to f32 for the score product (one
    layer's k at a time), not multiplied in bf16, which would round each
    score to bf16.  The probabilities go back to the cache's dtype for the
    product with v, as in the reference."""
    b, s, kvh, dk = k_cache.shape
    h = q.shape[1]
    g = h // kvh
    dv = v_cache.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = q.reshape(b, kvh, g, dk).to(torch.float32)
    # one pass: widen and lay k out as [B, KVH, S, D] for the batched product
    kf = torch.empty((b, kvh, s, dk), dtype=torch.float32,
                     device=k_cache.device)
    kf.copy_(k_cache.permute(0, 2, 1, 3))
    scores = torch.matmul(qg, kf.transpose(-1, -2)) * scale  # [B,KVH,G,S]
    del kf
    valid = torch.arange(s, device=q.device) < length
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v_cache.dtype), v_cache.permute(0, 2, 1, 3))
    return out.reshape(b, 1, h, dv)


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
    """Full-sequence attention (train / prefill).  Returns (out, kv) where
    kv is the cache contribution {k, v}: [B, S, KVH, D] after RoPE."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = blockwise_attention(q, k, v, causal=causal, kv_block=kv_block)
    return out.reshape(b, s, -1) @ p["wo"], {"k": k, "v": v}


def _rope_at(q, k, pos: int, cfg: ModelConfig):
    posv = torch.full((1,), pos, device=q.device)
    return (apply_rope(q, posv, cfg.rope_theta),
            apply_rope(k, posv, cfg.rope_theta))


def gqa_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: [B, 1, d]; cache {k, v}: [B, S, KVH, D];
    ``pos``: the current position (cache length so far).  Position ``pos``
    of the cache tensors is written in place; the returned dict holds the
    same tensors."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        q, k = _rope_at(q, k, pos, cfg)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    out = decode_attention(q[:, 0], cache["k"], cache["v"], pos + 1)
    return out.reshape(b, 1, -1) @ p["wo"], {"k": cache["k"],
                                             "v": cache["v"]}


def quantize_kv(t: torch.Tensor, *, reciprocal: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], f32 scale [...]): one symmetric scale per
    head vector, ``max(max|t| / 127, 1e-30)``.  ``reciprocal=True`` takes
    the division as the reference's jitted decode does (a multiply by
    f32(1/127)), ``False`` as its eager one (``flatbuf.int8_scale``)."""
    tf32 = t.to(torch.float32)
    s = int8_scale(tf32.abs().amax(dim=-1), reciprocal=reciprocal)
    return encode_int8(tf32, s[..., None]), s


def gqa_decode_q8(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  pos: int, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against an int8 KV cache.

    Cache: {k_q, v_q: int8 [B,S,KVH,D]; k_s, v_s: f32 [B,S,KVH]}, one
    symmetric scale per (position, KV head), written in place at ``pos``.
    The reference computes the scale as ``max|t| / 127.0``, which ``jit``
    (its serving path) turns into a multiply by f32(1/127); this is the
    jitted scale (``quantize_kv``)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope:
        q, k = _rope_at(q, k, pos, cfg)
    for name, t in (("k", k), ("v", v)):
        qv, sv = quantize_kv(t)
        cache[f"{name}_q"][:, pos] = qv[:, 0]
        cache[f"{name}_s"][:, pos] = sv[:, 0]
    k_q, v_q, k_s, v_s = (cache[n] for n in ("k_q", "v_q", "k_s", "v_s"))

    kvh, h, dk = k_q.shape[2], q.shape[2], q.shape[-1]
    g = h // kvh
    scale = 1.0 / math.sqrt(dk)
    qg = q[:, 0].reshape(b, kvh, g, dk).to(torch.float32)
    # scores on the int8 payload, per-position scales folded in afterwards
    scores = torch.matmul(qg, k_q.permute(0, 2, 3, 1).to(torch.float32)
                          ) * scale
    scores = scores * k_s.transpose(1, 2)[:, :, None, :]
    valid = torch.arange(k_q.shape[1], device=x.device) < pos + 1
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    probs_v = probs * v_s.transpose(1, 2)[:, :, None, :]
    out = torch.matmul(probs_v, v_q.permute(0, 2, 1, 3).to(torch.float32))
    out = out.reshape(b, 1, h * v_q.shape[-1]).to(x.dtype) @ p["wo"]
    return out, {"k_q": k_q, "v_q": v_q, "k_s": k_s, "v_s": v_s}
