"""Block-wise symmetric int8 quantization: the CUDA kernel and its plain
version.

``quantize`` launches the hand-written Hopper kernel in
``csrc/quantize.cu`` (the port of the Pallas ``_quant_kernel`` in
``repro/kernels/quantize.py``); ``quantize_plain`` computes the same
function in PyTorch.  Both give, per ``block`` of x,

    scale = max(max|x| * f32(1/127), 1e-30)
    q     = clip(round_half_even(x / scale), -127, 127)  as int8

The scale is a multiply by the f32 reciprocal of 127 because that is what
the reference's jitted path computes (XLA rewrites ``/ 127.0`` into it);
the eager oracle ``ref.quantize_ref`` divides and may differ in the last
bit of a scale.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .build import check_launch, load

_INV_127 = 1.0 / 127.0


@functools.lru_cache(maxsize=None)
def _kernel():
    """(library, entry point, the block size the kernel is built for)."""
    lib = load("quantize")
    fn = lib.repro_quantize
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn, lib.repro_quantize_block()


def quantize_plain(x: torch.Tensor, *, block: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [D] (D % block == 0) -> (q int8 [D], scales f32 [D/block])."""
    d = x.shape[0]
    if d % block:
        raise ValueError(f"length {d} is not a multiple of block {block}")
    xb = x.reshape(d // block, block).to(torch.float32)
    inv = torch.full((), _INV_127, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(xb.abs().amax(dim=1) * inv, 1e-30)
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(d), scale


def quantize(x: torch.Tensor, *, block: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel.  x: contiguous f32 [D] on the card, D % 256 == 0,
    starting anywhere (a view into a flat buffer is fine: the kernel reads
    16 bytes a load where x is 16-byte aligned and one float otherwise)
    -> (q int8 [D], scales f32 [D/256])."""
    lib, fn, kernel_block = _kernel()
    if block != kernel_block:
        raise ValueError(f"the CUDA quantize kernel takes block="
                         f"{kernel_block}, got {block}")
    if not x.is_cuda:
        raise ValueError(f"quantize kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("quantize kernel takes a contiguous 1-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] % block:
        raise ValueError(f"length {x.shape[0]} is not a multiple of {block}")
    n_blocks = x.shape[0] // block
    q = torch.empty(x.shape[0], dtype=torch.int8, device=x.device)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), n_blocks,
                stream)
    check_launch(lib, rc, "quantize")
    return q, scales
