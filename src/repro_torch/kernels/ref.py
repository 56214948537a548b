"""PyTorch twins of the reference's eager oracles (``repro/kernels/ref.py``),
one for every kernel.

They keep the oracles' own arithmetic: ``flash_attention_ref`` is the
dense softmax with the oracle's causal mask ``tril(k=skv-sq)`` (the
kernel's mask has no offset; the two differ only where ``Sq != Skv``,
which the model never sends to the kernel), ``quantize_ref`` divides by 127
(the jitted main path multiplies by its f32 reciprocal, see ``quantize.py``),
``dequant_aggregate_ref`` and ``grad_aggregate_ref`` sum the rows with one
``einsum``, and ``scatter_aggregate_ref`` forms ``(q * scale) * w`` (the
kernel forms ``q * (scale * w)``).  The tests hold them against the JAX
oracles, and the kernels' plain versions against them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KVH, Skv, D] -> [B, H, Sq, D] in q's
    dtype.  One dense [Sq, Skv] softmax in f32: an oracle for small shapes."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, kvh, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return o.reshape(b, h, sq, d).to(q.dtype)


def dequant_aggregate_ref(q: torch.Tensor, scales: torch.Tensor,
                          weights: torch.Tensor, *, block: int = 256,
                          orig_len: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [N, D_pad] int8; scales: [N, D_pad/block]; weights: [N]
    -> (agg f32 [orig_len or D_pad], sumsq [] f32)."""
    n, d_pad = q.shape
    x = (q.reshape(n, d_pad // block, block).to(torch.float32)
         * scales[:, :, None].to(torch.float32)).reshape(n, d_pad)
    if orig_len is not None:
        x = x[:, :orig_len]
    agg = torch.einsum("nd,n->d", x, weights.to(torch.float32))
    return agg, torch.sum(agg * agg)


def grad_aggregate_ref(updates: torch.Tensor, weights: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """updates: [N, D]; weights: [N] -> (agg [D] of updates' dtype,
    sumsq [] f32 of the f32 agg)."""
    agg = torch.einsum("nd,n->d", updates.to(torch.float32),
                       weights.to(torch.float32))
    return agg.to(updates.dtype), torch.sum(agg * agg)


def quantize_ref(x: torch.Tensor, *, block: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [D] (D % block == 0) -> (q int8 [D], scales f32 [D/block])."""
    d = x.shape[0]
    xb = x.reshape(d // block, block).to(torch.float32)
    # a tensor divisor: on the card PyTorch turns division by a Python
    # scalar into a multiply by its reciprocal, which is not the oracle
    div = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(xb.abs().amax(dim=1) / div, 1e-30)
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(d), scale


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor, *,
                   block: int = 256) -> torch.Tensor:
    """q: int8 [D], scales: [D/block] -> f32 [D], ``q * scale`` per block."""
    d = q.shape[0]
    xb = q.reshape(d // block, block).to(torch.float32) * scales[:, None]
    return xb.reshape(d)


def scatter_aggregate_ref(idx: torch.Tensor, q: torch.Tensor,
                          scales: torch.Tensor, weights: torch.Tensor, *,
                          d_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense scatter-add oracle for the sparse receive path.

    idx: [N, K] int32 (negative or >= d_out -> dropped slot); q: [N, K]
    int8; scales, weights: [N] -> (agg f32 [d_out], sumsq [] f32).
    """
    vals = (q.to(torch.float32) * scales[:, None].to(torch.float32)
            * weights[:, None].to(torch.float32))
    valid = (idx >= 0) & (idx < d_out)
    vals = torch.where(valid, vals, 0.0)
    safe = torch.where(valid, idx, 0).to(torch.int64)
    agg = torch.zeros(d_out, dtype=torch.float32, device=q.device)
    agg.index_put_((safe.ravel(),), vals.ravel(), accumulate=True)
    return agg, torch.sum(agg * agg)


def switch_sum_ref(q: torch.Tensor, *,
                   orig_len: Optional[int] = None) -> torch.Tensor:
    """Fixed-point switch aggregation oracle (overflow-widened).

    q: [N, D_pad] int8 (members quantized with one shared scale)
    -> int32 sums [orig_len or D_pad].
    """
    s = torch.sum(q.to(torch.int32), dim=0, dtype=torch.int32)
    return s[:orig_len] if orig_len is not None else s
