"""Block-wise symmetric int8 quantization and its inverse: the CUDA
kernels and their plain versions.

``quantize`` and ``dequantize`` launch the hand-written Hopper kernels in
``csrc/quantize.cu`` (the ports of the Pallas ``_quant_kernel`` and
``_dequant_kernel`` in ``repro/kernels/quantize.py``); ``quantize_plain``
and ``dequantize_plain`` compute the same functions in PyTorch.
``quantize`` gives, per ``block`` of x,

    scale = max(max|x| * f32(1/127), 1e-30)
    q     = clip(round_half_even(x / scale), -127, 127)  as int8

The scale is a multiply by the f32 reciprocal of 127 because that is what
the reference's jitted path computes (XLA rewrites ``/ 127.0`` into it);
the eager oracle ``ref.quantize_ref`` divides and may differ in the last
bit of a scale.  ``dequantize`` gives ``x = q * scale`` per block, one f32
product rounded once, cast to the output dtype (f32 or bf16).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .build import check_launch, load

_INV_127 = 1.0 / 127.0
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.lru_cache(maxsize=None)
def _dequant_kernel():
    lib = load("quantize")
    fn = lib.repro_dequantize
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + \
        [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_dequant(q: torch.Tensor, scales: torch.Tensor, block: int) -> int:
    if q.dim() != 1 or scales.dim() != 1:
        raise ValueError(f"dequantize takes q [D] and scales [D/block], got "
                         f"{tuple(q.shape)} and {tuple(scales.shape)}")
    d = q.shape[0]
    if block <= 0 or d % block:
        raise ValueError(f"length {d} is not a multiple of block {block}")
    if scales.shape[0] != d // block:
        raise ValueError(f"scales {tuple(scales.shape)} do not match q "
                         f"[{d}] at block {block}")
    return d // block


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor, *,
                     block: int = 256, dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """q: int8 [D] (D % block == 0), scales: f32 [D/block] -> [D] of
    ``dtype``: each block's ``q * scale`` in f32, then cast."""
    n = _check_dequant(q, scales, block)
    x = q.view(n, block).to(torch.float32) * scales.to(torch.float32)[:, None]
    return x.view(-1).to(dtype)


def dequantize(q: torch.Tensor, scales: torch.Tensor, *, block: int = 256,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The CUDA kernel.  q: contiguous int8 [D] on the card, starting
    anywhere (16-byte loads where q is 16-byte aligned, byte loads
    otherwise); scales: contiguous f32 [D/block] on the same card; block a
    multiple of 16 -> [D] of ``dtype`` (f32 or bf16)."""
    _check_dequant(q, scales, block)
    if not q.is_cuda or not scales.is_cuda or scales.device != q.device:
        raise ValueError(f"dequantize kernel needs q and scales on one card, "
                         f"got {q.device} and {scales.device}")
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"dequantize kernel takes contiguous int8 q, got "
                         f"{q.dtype}")
    if scales.dtype != torch.float32 or not scales.is_contiguous():
        raise ValueError(f"dequantize kernel takes contiguous float32 "
                         f"scales, got {scales.dtype}")
    if block % 16:
        raise ValueError(f"dequantize kernel needs block % 16 == 0, got "
                         f"{block}")
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"dequantize kernel writes float32 or bfloat16, not "
                         f"{dtype}")
    lib, fn = _dequant_kernel()
    out = torch.empty(q.shape[0], dtype=dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), q.shape[0],
                block, _OUT_DTYPES[dtype], stream)
    check_launch(lib, rc, "dequantize")
    return out
