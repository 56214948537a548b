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

from . import ref
from .dequant_aggregate import dequant_aggregate, dequant_aggregate_plain
from .flash_attention import flash_attention, flash_attention_plain
from .grad_aggregate import grad_aggregate, grad_aggregate_plain
from .quantize import (dequantize, dequantize_plain, quantize,
                       quantize_plain)
from .scatter_aggregate import scatter_aggregate, scatter_aggregate_plain
from .switch_sum import switch_sum, switch_sum_plain


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _route(t: torch.Tensor, what: str, *others: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version, by ``t``'s device.
    A DTensor among ``t`` and ``others`` raises: a kernel and its plain
    version take one rank's local tensors, and nothing here gathers a
    sharded one (the model hands the kernels its local shards,
    ``models/attention.py:blockwise_attention``)."""
    if any(_is_dtensor(x) for x in (t, *others)):
        raise TypeError(f"{what}: got a DTensor; pass this rank's local "
                        "tensors (DTensor.to_local())")
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


def dequantize_op(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256,
                  orig_len: Optional[int] = None) -> torch.Tensor:
    """Unfused decode of one int8 payload: q [D_pad], scales [D_pad/block]
    -> x f32 [orig_len or D_pad].  With ``orig_len`` the result is a view
    of the decoded buffer."""
    if _route(q, "dequantize_op", scales):
        x = dequantize(q, scales, block=block)
        dequantize_op.launches += 1
    else:
        x = dequantize_plain(q, scales, block=block)
    return x[:orig_len] if orig_len is not None else x


def compress_update(update_flat: torch.Tensor, *, block: int = 256
                    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], float]:
    """Round-trip helper of the PS path: ``((q, scales), ratio)``, the ratio
    being the update's bytes over the padded payload's and scales'."""
    q, s = quantize_op(update_flat, block=block)
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    return (q, s), nbytes(update_flat) / (nbytes(q) + nbytes(s))


def dequant_aggregate_op(q: torch.Tensor, scales: torch.Tensor,
                         weights: torch.Tensor, *, block: int = 256,
                         orig_len: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused receive path: int8 payloads [N, D_pad] -> dequantize ->
    weighted sum -> (agg f32 [orig_len or D_pad], ||agg||^2).  The unfused
    composition is ``dequantize_op`` per row, stacked, then
    ``grad_aggregate_op``, which writes and reads N decoded f32 copies."""
    if _route(q, "dequant_aggregate_op", scales, weights):
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
    if _route(updates, "grad_aggregate_op", weights):
        out = grad_aggregate(updates, weights)
        grad_aggregate_op.launches += 1
        return out
    return grad_aggregate_plain(updates, weights)


def switch_sum_op(q: torch.Tensor, *, window: int = 256,
                  orig_len: Optional[int] = None) -> torch.Tensor:
    """In-network switch aggregation: the pod's int8 payloads [N, D_pad]
    (one shared scale, D_pad a whole number of ``window`` slots) -> exact
    int32 sums [orig_len or D_pad]."""
    if _route(q, "switch_sum_op"):
        out = switch_sum(q, window=window, orig_len=orig_len)
        switch_sum_op.launches += 1
        return out
    return switch_sum_plain(q, window=window, orig_len=orig_len)


def scatter_aggregate_op(idx: torch.Tensor, q: torch.Tensor,
                         scales: torch.Tensor, weights: torch.Tensor, *,
                         d_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse receive path of the bounded-loss tier: scatter-add N top-k
    int8 chunks (idx [N, K] int32, -1 = dropped slot) into the dense bucket
    -> (agg f32 [d_out], ||agg||^2), with no dense buffer per sender."""
    if _route(idx, "scatter_aggregate_op", q, scales, weights):
        out = scatter_aggregate(idx, q, scales, weights, d_out=d_out)
        scatter_aggregate_op.launches += 1
        return out
    return scatter_aggregate_plain(idx, q, scales, weights, d_out=d_out)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, scale: Optional[float] = None,
                       block_q: int = 128, block_k: int = 128
                       ) -> torch.Tensor:
    """Forward attention, q [B, H, Sq, D] against k, v [B, KVH, Skv, D] ->
    [B, H, Sq, D] in q's dtype (the reference's ``flash_attention``
    arguments; ``block_q``/``block_k`` do not set the CUDA kernel's tiles).
    Forward only: it raises where autograd would record it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_op has no backward: the reference's Pallas "
            "flash kernel is forward-only and the port carries no backward "
            "kernel; call it under torch.no_grad() or on tensors that do not "
            "require grad (training takes the blockwise attention)")
    kw = dict(causal=causal, scale=scale, block_q=block_q, block_k=block_k)
    if _route(q, "flash_attention_op", k, v):
        out = flash_attention(q, k, v, **kw)
        flash_attention_op.launches += 1
        return out
    return flash_attention_plain(q, k, v, **kw)


quantize_op.launches = 0
dequantize_op.launches = 0
dequant_aggregate_op.launches = 0
grad_aggregate_op.launches = 0
switch_sum_op.launches = 0
scatter_aggregate_op.launches = 0
flash_attention_op.launches = 0


# the oracles, re-exported as the reference does
flash_attention_ref = ref.flash_attention_ref
grad_aggregate_ref = ref.grad_aggregate_ref
quantize_ref = ref.quantize_ref
dequantize_ref = ref.dequantize_ref
scatter_aggregate_ref = ref.scatter_aggregate_ref
switch_sum_ref = ref.switch_sum_ref
