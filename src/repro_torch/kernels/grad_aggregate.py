"""Fused weighted gradient aggregation + sum of squares: the CUDA kernel and
its plain version.

``grad_aggregate`` launches the hand-written Hopper kernel in
``csrc/grad_aggregate.cu`` (the port of the Pallas ``_agg_kernel`` in
``repro/kernels/grad_aggregate.py``); ``grad_aggregate_plain`` computes the
same function in PyTorch.  Both give, for updates ``u [N, D]`` (f32 or
bf16) and weights ``w [N]``,

    agg   = sum_n w_n * u_n     in f32, rows summed in order, cast to u's dtype
    sumsq = sum(agg ** 2)       of the f32 agg

This is the aggregator's compute of the in-graph MLfabric step: the
cross-pod stage of every bucket, with N the number of pods.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .build import check_launch, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    """(library, entry point, columns per CTA = length of the partials)."""
    lib = load("grad_aggregate")
    fn = lib.repro_grad_aggregate
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + \
        [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_grad_aggregate_tile.restype = ctypes.c_int64
    return lib, fn, lib.repro_grad_aggregate_tile()


def _check_shapes(updates: torch.Tensor, weights: torch.Tensor) -> None:
    if updates.dim() != 2 or updates.shape[0] < 1 or updates.shape[1] < 1:
        raise ValueError(f"updates must be [N, D], got {tuple(updates.shape)}")
    if tuple(weights.shape) != (updates.shape[0],):
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"N={updates.shape[0]}")


def grad_aggregate_plain(updates: torch.Tensor, weights: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """updates: [N, D]; weights: [N] -> (agg [D] of updates' dtype,
    sumsq [] f32).  Row by row, ``agg = agg + u[i] * w[i]`` in f32."""
    _check_shapes(updates, weights)
    w = weights.to(torch.float32)
    agg = torch.zeros(updates.shape[1], dtype=torch.float32,
                      device=updates.device)
    for i in range(updates.shape[0]):
        agg = agg + updates[i].to(torch.float32) * w[i]
    return agg.to(updates.dtype), torch.sum(agg * agg)


def grad_aggregate(updates: torch.Tensor, weights: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel.  updates: contiguous f32 or bf16 [N, D] on a card,
    starting anywhere (a view into a flat buffer is fine); weights: f32 [N]
    on the same card -> (agg [D] of updates' dtype, sumsq [] f32)."""
    _check_shapes(updates, weights)
    if not updates.is_cuda:
        raise ValueError("grad_aggregate kernel needs updates on a card, got "
                         f"{updates.device}")
    if updates.dtype not in _DTYPES or not updates.is_contiguous():
        raise ValueError("grad_aggregate kernel takes contiguous float32 or "
                         f"bfloat16 updates, got {updates.dtype}")
    if (not weights.is_cuda or weights.device != updates.device
            or weights.dtype != torch.float32 or not weights.is_contiguous()):
        raise ValueError("grad_aggregate kernel takes contiguous float32 "
                         "weights on the card of the updates, got "
                         f"{weights.dtype} on {weights.device}")
    n, d = updates.shape
    lib, fn, tile = _kernel()
    agg = torch.empty(d, dtype=updates.dtype, device=updates.device)
    partial = torch.empty(-(-d // tile), dtype=torch.float32,
                          device=updates.device)
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(updates.data_ptr(), weights.data_ptr(), agg.data_ptr(),
                partial.data_ptr(), n, d, _DTYPES[updates.dtype], stream)
    check_launch(lib, rc, "grad_aggregate")
    return agg, torch.sum(partial)
