"""Forward flash attention: the CUDA kernel and its plain version.

``flash_attention`` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (the port of the Pallas ``_flash_kernel`` in
``repro/kernels/flash_attention.py``); ``flash_attention_plain`` computes
the same function in PyTorch.  Both take q ``[B, H, Sq, D]`` and k, v
``[B, KVH, Skv, D]`` (H a multiple of KVH; head h reads KV head
``h // (H // KVH)``) and give ``[B, H, Sq, D]`` in q's dtype:

    s   = (q . k) * scale          in f32, scale = 1/sqrt(D) by default
    s   = -1e30 where causal and k_pos > q_pos   (no offset)
    out = online softmax over key blocks: acc / max(l, 1e-30)

The mask has no offset, as in the Pallas kernel; the model sends only
``Sq == Skv`` here.  ``block_q`` and ``block_k`` are the reference's tile
arguments: the CUDA kernel ignores both and tiles 64 x 64 (what suits
Hopper's shared memory, not the TPU's VMEM), the plain version steps over
keys in blocks of ``block_k``.  Neither has a backward: the reference's
Pallas kernel has none either.

The kernel has two bodies in one source, chosen by dtype: bf16 inputs run
on the tensor cores (``wgmma``: q.k^T in bf16 with f32 sums, and p.v with
p split exactly into three bf16 terms, so every product stays exact as
with p in f32; K and V arrive by ``cp.async``), f32 inputs on the CUDA
cores.  No input of one type reaches the other body.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .build import check_launch, load

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D q [B,H,Sq,D] and k, v "
                         f"[B,KVH,Skv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(f"{h} q heads do not group over {k.shape[1]} KV "
                         "heads")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None, block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """The Pallas kernel's math in PyTorch: vectorised over batch, heads and
    q rows, one loop step per block of ``block_k`` keys, so no [Sq, Skv]
    score matrix is built.  ``block_q`` is accepted and not used."""
    _check_shapes(q, k, v)
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    block_k = min(block_k, skv)
    qf = q.reshape(b, kvh, g, sq, d).to(torch.float32)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32,
                      device=q.device)
    q_pos = torch.arange(sq, device=q.device)
    for start in range(0, skv, block_k):
        kb = k[:, :, None, start:start + block_k].to(torch.float32)
        vb = v[:, :, None, start:start + block_k].to(torch.float32)
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            k_pos = start + torch.arange(kb.shape[3], device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, h, sq, d).to(q.dtype)


def _aligned(t: torch.Tensor) -> bool:
    """Unit last stride, 16-byte start and 16-byte steps between rows."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """The CUDA kernel.  q, k, v: f32 (the CUDA-core body) or bf16 (the
    tensor-core body), all one type, on one card, D in {32, 64, 96, 128}, any
    strides with a unit last stride and 16-byte steps (so transposed views
    of [B, S, H, D] tensors go in as they are) -> [B, H, Sq, D] of q's
    dtype, laid out as q is.  ``block_q`` and ``block_k`` are accepted and
    not used."""
    _check_shapes(q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel needs q, k, v on one card, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one type, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if skv < 1:
        raise ValueError("flash_attention kernel needs at least one key")
    if not all(_aligned(t) for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs a unit last stride, "
                         "16-byte aligned starts and 16-byte row steps")
    # preserve_format: a transposed view of [B, S, H, D] gets an output laid
    # out the same way, so transposing it back is free (a view that is not
    # dense gets a contiguous output); either way aligned as q's rows are
    out = torch.empty_like(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    shape = (ctypes.c_int64 * 6)(b, h, kvh, sq, skv, d)
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *out.stride())
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ctypes.addressof(shape), ctypes.addressof(strides),
                float(scale), int(bool(causal)), _DTYPES[q.dtype], stream)
    check_launch(lib, rc, "flash_attention")
    return out
