"""The int8 wire, worked out plainly: a float32 vector cut into blocks of
256 (the last one zero-padded), each block sent as round(x / scale) in
[-127, 127] with ``scale = max|x| / 127``, and read back as ``q * scale``.

Two layouts carry a gradient tree over it, in the program's leaf order:

* ``"buckets"`` (the in-graph step): the leaves are packed back to back and
  cut greedily, in order, into buckets of at most ``bucket_bytes`` f32
  bytes (a leaf larger than that is a bucket of its own); each bucket is
  one wire vector, so a block may hold the end of one leaf and the start
  of the next.
* ``"leaf_padded"`` (MLfabric-A's update): every leaf is zero-padded to a
  whole number of blocks and the tree is one wire vector.
"""

from __future__ import annotations

from typing import List

import torch

BLOCK = 256


PIECE = BLOCK * 2 ** 18       # elements worked at once


def _blocks(xb: torch.Tensor) -> torch.Tensor:
    scale = xb.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(xb / safe), -127, 127) * scale


def roundtrip_(x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous 1-D f32) through the wire and back, in place, a
    piece of whole blocks at a time."""
    n = x.numel()
    whole = n - n % BLOCK
    for i in range(0, whole, PIECE):
        j = min(i + PIECE, whole)
        x[i:j] = _blocks(x[i:j].view(-1, BLOCK)).view(-1)
    if whole < n:
        tail = torch.nn.functional.pad(x[whole:], (0, BLOCK - (n - whole)))
        x[whole:] = _blocks(tail.view(1, BLOCK)).view(-1)[:n - whole]
    return x


def buckets(sizes: List[int], bucket_bytes: int) -> List[List[int]]:
    """Leaf indices of each bucket, in leaf order."""
    out, cur, nbytes = [], [], 0
    for i, s in enumerate(sizes):
        if cur and nbytes + 4 * s > bucket_bytes:
            out.append(cur)
            cur, nbytes = [], 0
        cur.append(i)
        nbytes += 4 * s
    if cur:
        out.append(cur)
    return out


@torch.no_grad()
def tree_roundtrip(grads: List[torch.Tensor], layout: str,
                   bucket_bytes: int = 4 * 2 ** 20) -> List[torch.Tensor]:
    """Every leaf of ``grads`` (f32, in leaf order) as the wire delivers
    it; a leaf that is a bucket or a vector of its own is worked in
    place."""
    if layout == "leaf_padded":
        return [roundtrip_(g.contiguous().view(-1)).view(g.shape)
                for g in grads]
    if layout != "buckets":
        raise ValueError(layout)
    out: List[torch.Tensor] = [None] * len(grads)
    for idx in buckets([g.numel() for g in grads], bucket_bytes):
        if len(idx) == 1:
            g = grads[idx[0]].contiguous()
            out[idx[0]] = roundtrip_(g.view(-1)).view(g.shape)
            continue
        vec = roundtrip_(torch.cat([grads[i].reshape(-1) for i in idx]))
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = vec[off:off + n].view(grads[i].shape)
            off += n
    return out
