"""Public wrappers for the port's kernels.

A tensor on the card goes to the hand-written CUDA kernel; a tensor on the
CPU goes to the kernel's plain PyTorch version (that is how the CPU tests
run); any other device raises.  There is no fallback: a CUDA tensor that the
kernel refuses raises.  Each wrapper counts its kernel launches in a plain
integer attribute, ``<wrapper>.launches``, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .dequant_aggregate import dequant_aggregate, dequant_aggregate_plain
from .grad_aggregate import grad_aggregate, grad_aggregate_plain
from .quantize import quantize, quantize_plain


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel, False for the plain version."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def quantize_op(x: torch.Tensor, *, block: int = 256
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [D] -> (q int8 [D_pad], scales f32 [D_pad/block]); x is zero-padded
    to a ``block`` multiple first."""
    pad = (-x.shape[0]) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    if _route(x, "quantize_op"):
        out = quantize(x.contiguous(), block=block)
        quantize_op.launches += 1
        return out
    return quantize_plain(x, block=block)


def dequant_aggregate_op(q: torch.Tensor, scales: torch.Tensor,
                         weights: torch.Tensor, *, block: int = 256,
                         orig_len: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused receive path: int8 payloads [N, D_pad] -> dequantize ->
    weighted sum -> (agg f32 [orig_len or D_pad], ||agg||^2)."""
    if _route(q, "dequant_aggregate_op"):
        out = dequant_aggregate(q, scales, weights, block=block,
                                orig_len=orig_len)
        dequant_aggregate_op.launches += 1
        return out
    return dequant_aggregate_plain(q, scales, weights, block=block,
                                   orig_len=orig_len)


def grad_aggregate_op(updates: torch.Tensor, weights: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregator compute: updates [N, D] (f32 or bf16) -> weighted sum in
    f32 -> (agg [D] of updates' dtype, ||agg||^2 f32).  A ragged D is
    masked inside the kernel, with no pad copy."""
    if _route(updates, "grad_aggregate_op"):
        out = grad_aggregate(updates, weights)
        grad_aggregate_op.launches += 1
        return out
    return grad_aggregate_plain(updates, weights)


quantize_op.launches = 0
dequant_aggregate_op.launches = 0
grad_aggregate_op.launches = 0
