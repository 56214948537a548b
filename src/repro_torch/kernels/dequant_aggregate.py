"""Fused int8 dequantize -> weighted aggregate -> sum of squares: the CUDA
kernel and its plain version.

``dequant_aggregate`` launches the hand-written Hopper kernel in
``csrc/dequant_aggregate.cu`` (the port of the Pallas ``_fused_kernel`` in
``repro/kernels/dequant_aggregate.py``); ``dequant_aggregate_plain``
computes the same function in PyTorch.  Both give

    agg[:orig_len] = sum_n w_n * (q_n * s_n)     (rows summed in order)
    sumsq          = sum(agg ** 2)

This is the receiving end of the flat int8 wire: with N=1 and w=1 it
decodes one worker's update and yields ``||u||^2`` without a second pass;
with N > 1 it is the aggregator host's weighted sum.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .build import check_launch, load


@functools.lru_cache(maxsize=None)
def _kernel():
    """(library, entry point, columns per CTA = length of the partials)."""
    lib = load("dequant_aggregate")
    fn = lib.repro_dequant_aggregate
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_dequant_aggregate_tile.restype = ctypes.c_int64
    return lib, fn, lib.repro_dequant_aggregate_tile()


def _check_shapes(q, scales, weights, block, orig_len) -> int:
    if q.dim() != 2:
        raise ValueError(f"q must be [N, D_pad], got {tuple(q.shape)}")
    n, d_pad = q.shape
    if d_pad % block:
        raise ValueError(f"D_pad {d_pad} is not a multiple of block {block}")
    if tuple(scales.shape) != (n, d_pad // block):
        raise ValueError(f"scales {tuple(scales.shape)} do not match q "
                         f"{tuple(q.shape)} at block {block}")
    if tuple(weights.shape) != (n,):
        raise ValueError(f"weights {tuple(weights.shape)} do not match N={n}")
    d_out = d_pad if orig_len is None else orig_len
    if not 0 < d_out <= d_pad:
        raise ValueError(f"orig_len {d_out} outside (0, {d_pad}]")
    return d_out


def dequant_aggregate_plain(q: torch.Tensor, scales: torch.Tensor,
                            weights: torch.Tensor, *, block: int = 256,
                            orig_len: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [N, D_pad] int8; scales: [N, D_pad/block]; weights: [N]
    -> (agg f32 [orig_len or D_pad], sumsq [] f32)."""
    d_out = _check_shapes(q, scales, weights, block, orig_len)
    n, d_pad = q.shape
    w = weights.to(torch.float32)
    agg = torch.zeros(d_out, dtype=torch.float32, device=q.device)
    for i in range(n):
        x = (q[i].reshape(d_pad // block, block).to(torch.float32)
             * scales[i, :, None].to(torch.float32)).reshape(d_pad)[:d_out]
        agg = agg + x * w[i]
    return agg, torch.sum(agg * agg)


def dequant_aggregate(q: torch.Tensor, scales: torch.Tensor,
                      weights: torch.Tensor, *, block: int = 256,
                      orig_len: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel.  q int8 [N, D_pad], scales f32 [N, D_pad/block] and
    weights f32 [N], contiguous on one card; block % 4 == 0.
    -> (agg f32 [orig_len or D_pad], sumsq [] f32)."""
    d_out = _check_shapes(q, scales, weights, block, orig_len)
    for name, t, dt in (("q", q, torch.int8), ("scales", scales, torch.float32),
                        ("weights", weights, torch.float32)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"dequant_aggregate kernel needs {name} on the "
                             f"card of q, got {t.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"dequant_aggregate kernel takes contiguous {dt} "
                             f"{name}, got {t.dtype}")
    if block % 4:
        raise ValueError(f"dequant_aggregate kernel needs block % 4 == 0, "
                         f"got {block}")
    # The kernel reads 4 payload bytes a load, so q must start 4-byte
    # aligned.  Every caller hands it a fresh buffer: the quantizer's output
    # (flat_compress_roundtrip, and the in-graph step's cross-pod stage on a
    # pod axis of one) or the all-gather of such outputs across pods.
    if q.data_ptr() % 4:
        raise ValueError("dequant_aggregate kernel needs 4-byte aligned q")
    n, d_pad = q.shape
    lib, fn, tile = _kernel()
    agg = torch.empty(d_out, dtype=torch.float32, device=q.device)
    partial = torch.empty(-(-d_out // tile), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), scales.data_ptr(), weights.data_ptr(),
                agg.data_ptr(), partial.data_ptr(), n, d_pad, d_out, block,
                stream)
    check_launch(lib, rc, "dequant_aggregate")
    return agg, torch.sum(partial)
