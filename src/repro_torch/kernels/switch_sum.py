"""Exact int32 column sums of shared-scale int8 rows (the in-network switch
sum): the CUDA kernel and its plain version.

``switch_sum`` launches the hand-written Hopper kernel in
``csrc/switch_sum.cu`` (the port of the Pallas ``_switch_sum_kernel`` in
``repro/kernels/switch_sum.py``); ``switch_sum_plain`` computes the same
function in PyTorch.  Both give, for the pod's gathered wire payload
``q [N, D_pad]`` int8,

    out = sum_n q[n, :orig_len]      in int32

The int32 widening is the overflow headroom a switch pipeline applies per
packet: int8 lanes would saturate at two members sending 127.  Integer sums
are exact in any order, so the kernel is bit-equal to the plain version.
``window`` is the switch's slot size: ``D_pad`` must be a whole number of
windows, as the reference asserts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import check_launch, load


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load("switch_sum")
    fn = lib.repro_switch_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(q: torch.Tensor, window: int, orig_len: Optional[int]) -> int:
    if q.dim() != 2 or q.shape[0] < 1:
        raise ValueError(f"q must be [N, D_pad], got {tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise ValueError(f"switch_sum takes int8 payloads, got {q.dtype}")
    d_pad = q.shape[1]
    if window < 1 or d_pad % window:
        raise ValueError(f"D_pad {d_pad} is not a multiple of window "
                         f"{window}")
    d_out = d_pad if orig_len is None else orig_len
    if not 0 < d_out <= d_pad:
        raise ValueError(f"orig_len {d_out} outside (0, {d_pad}]")
    return d_out


def switch_sum_plain(q: torch.Tensor, *, window: int = 256,
                     orig_len: Optional[int] = None) -> torch.Tensor:
    """q: [N, D_pad] int8 -> int32 sums [orig_len or D_pad], row by row."""
    d_out = _check(q, window, orig_len)
    out = torch.zeros(d_out, dtype=torch.int32, device=q.device)
    for row in q[:, :d_out]:
        out += row.to(torch.int32)
    return out


def switch_sum(q: torch.Tensor, *, window: int = 256,
               orig_len: Optional[int] = None) -> torch.Tensor:
    """The CUDA kernel.  q: contiguous int8 [N, D_pad] on a card, every row
    4-byte aligned (a fresh padded or gathered buffer is)
    -> int32 [orig_len or D_pad]."""
    d_out = _check(q, window, orig_len)
    if not q.is_cuda:
        raise ValueError(f"switch_sum kernel needs q on a card, got "
                         f"{q.device}")
    if not q.is_contiguous():
        raise ValueError("switch_sum kernel takes a contiguous q")
    n, d_pad = q.shape
    if q.data_ptr() % 4 or d_pad % 4:
        raise ValueError("switch_sum kernel needs 4-byte aligned rows: q "
                         f"at {q.data_ptr() % 4} bytes past 4, D_pad "
                         f"{d_pad}")
    lib, fn = _kernel()
    out = torch.empty(d_out, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), out.data_ptr(), n, d_pad, d_out, stream)
    check_launch(lib, rc, "switch_sum")
    return out
