"""PyTorch twins of the reference's eager oracles (``repro/kernels/ref.py``)
for the kernels this port carries so far.

They keep the oracles' own arithmetic: ``quantize_ref`` divides by 127
(the jitted main path multiplies by its f32 reciprocal, see ``quantize.py``)
and ``dequant_aggregate_ref`` and ``grad_aggregate_ref`` sum the rows
with one ``einsum``.  The tests
hold them against the JAX oracles, and the kernels' plain versions against
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
