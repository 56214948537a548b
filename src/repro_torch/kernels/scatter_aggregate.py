"""Sparse int8 chunks -> dense weighted aggregate -> sum of squares: the
CUDA kernel and its plain version.

``scatter_aggregate`` launches the hand-written Hopper kernel in
``csrc/scatter_aggregate.cu`` (the port of the Pallas ``_scatter_kernel`` in
``repro/kernels/scatter_aggregate.py``); ``scatter_aggregate_plain``
computes the same function in PyTorch.  Both give, for N senders' chunks
``idx [N, K]`` int32, ``q [N, K]`` int8, ``scales [N]`` and ``weights [N]``,

    agg   = zeros(d_out); for each sender n in order:
            agg[idx[n, k]] += q[n, k] * (scales[n] * weights[n])
    sumsq = sum(agg ** 2)

Slots with ``idx < 0`` (transport-dropped) or ``idx >= d_out`` add nothing;
duplicate positions accumulate.  The product is grouped as the Pallas kernel
groups it, ``q * (scale * w)``; the oracle ``ref.scatter_aggregate_ref``
forms ``(q * scale) * w``, which rounds differently where ``w != 1``.  This
is the receiving end of the bounded-loss cross-pod stage (``keep_inter``),
with N the number of pods.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .build import check_launch, load


@functools.lru_cache(maxsize=None)
def _kernel():
    """(library, entry point, columns per CTA of the norm partials)."""
    lib = load("scatter_aggregate")
    fn = lib.repro_scatter_aggregate
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_scatter_aggregate_tile.restype = ctypes.c_int64
    return lib, fn, lib.repro_scatter_aggregate_tile()


def _check(idx, q, scales, weights, d_out: int) -> None:
    if idx.dim() != 2 or idx.shape[0] < 1 or idx.shape[1] < 1:
        raise ValueError(f"idx must be [N, K], N, K >= 1, got "
                         f"{tuple(idx.shape)}")
    n = idx.shape[0]
    if tuple(q.shape) != tuple(idx.shape):
        raise ValueError(f"q {tuple(q.shape)} does not match idx "
                         f"{tuple(idx.shape)}")
    if tuple(scales.shape) != (n,) or tuple(weights.shape) != (n,):
        raise ValueError(f"scales {tuple(scales.shape)} and weights "
                         f"{tuple(weights.shape)} must be [{n}]")
    if idx.dtype != torch.int32 or q.dtype != torch.int8:
        raise ValueError(f"idx must be int32 and q int8, got {idx.dtype}, "
                         f"{q.dtype}")
    if d_out < 1:
        raise ValueError(f"d_out must be positive, got {d_out}")


def scatter_aggregate_plain(idx: torch.Tensor, q: torch.Tensor,
                            scales: torch.Tensor, weights: torch.Tensor, *,
                            d_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx: [N, K] int32; q: [N, K] int8; scales, weights: [N]
    -> (agg f32 [d_out], sumsq [] f32).  One scatter-add per sender, in
    order."""
    _check(idx, q, scales, weights, d_out)
    sw = scales.to(torch.float32) * weights.to(torch.float32)
    agg = torch.zeros(d_out, dtype=torch.float32, device=q.device)
    for i in range(idx.shape[0]):
        live = (idx[i] >= 0) & (idx[i] < d_out)
        agg.index_add_(0, idx[i][live].to(torch.int64),
                       q[i][live].to(torch.float32) * sw[i])
    return agg, torch.sum(agg * agg)


def scatter_aggregate(idx: torch.Tensor, q: torch.Tensor,
                      scales: torch.Tensor, weights: torch.Tensor, *,
                      d_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel.  idx int32 [N, K], q int8 [N, K], scales and weights
    f32 [N], contiguous on one card -> (agg f32 [d_out], sumsq [] f32)."""
    _check(idx, q, scales, weights, d_out)
    for name, t, dt in (("idx", idx, torch.int32), ("q", q, torch.int8),
                        ("scales", scales, torch.float32),
                        ("weights", weights, torch.float32)):
        if not t.is_cuda or t.device != idx.device:
            raise ValueError(f"scatter_aggregate kernel needs {name} on the "
                             f"card of idx, got {t.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"scatter_aggregate kernel takes contiguous {dt}"
                             f" {name}, got {t.dtype}")
    n, k = idx.shape
    lib, fn, tile = _kernel()
    agg = torch.empty(d_out, dtype=torch.float32, device=idx.device)
    partial = torch.empty(-(-d_out // tile), dtype=torch.float32,
                          device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(idx.data_ptr(), q.data_ptr(), scales.data_ptr(),
                weights.data_ptr(), agg.data_ptr(), partial.data_ptr(), n, k,
                d_out, stream)
    check_launch(lib, rc, "scatter_aggregate")
    return agg, torch.sum(partial)
