"""Flat-bucket layout and the flat int8 wire round-trip (dense half).

The control plane schedules whole *buckets* (paper §4: updates are the unit
of transfer), so the data plane moves each bucket as one contiguous array.
The planners are pure Python, copied from ``repro/dist/flatbuf.py`` (that
module imports JAX at the top); ``pack_leaves``, ``bucket_slice``,
``unpack_bucket`` and ``flat_compress_roundtrip`` are its data movements in
PyTorch.

Leaf order is the reference's sorted-key order (``repro_torch.tree``): the
layout, the per-leaf padding and hence every quantization block depend on
it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..tree import tree_flatten, tree_unflatten

Params = Any


# --------------------------------------------------------------------------- #
# bucket planning (pure; unit-tested without devices)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Bucket:
    """One transfer unit: which flat-leaf indices it carries and its size."""

    indices: Tuple[int, ...]
    nbytes: int


def plan_buckets(leaf_nbytes: Sequence[int], bucket_bytes: int, *,
                 shortest_first: bool = True) -> List[Bucket]:
    """Greedy-pack leaves (in tree order) into <= ``bucket_bytes`` buckets.

    A leaf larger than ``bucket_bytes`` becomes its own bucket — MLfabric
    never splits an update, it orders whole transfers.  With
    ``shortest_first`` the buckets are issued smallest-first (Alg. 2's
    SJF rule); ties keep tree order so the plan is deterministic.
    """
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive: {bucket_bytes}")
    buckets: List[Bucket] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, nbytes in enumerate(leaf_nbytes):
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(Bucket(tuple(cur), cur_bytes))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(Bucket(tuple(cur), cur_bytes))
    if shortest_first:
        buckets.sort(key=lambda b: (b.nbytes, b.indices))
    return buckets


# --------------------------------------------------------------------------- #
# flat layout
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class FlatLayout:
    """Where every leaf and bucket lives inside the flat buffer.

    All offsets/sizes are in *elements* of the packed dtype.  Buckets are in
    issue (SJF) order; leaf offsets are in tree order, so a bucket's range is
    ``[leaf_offsets[b.indices[0]], ...last leaf end)``.
    """

    buckets: Tuple[Bucket, ...]
    leaf_sizes: Tuple[int, ...]
    leaf_offsets: Tuple[int, ...]       # element offset in the flat buffer
    bucket_starts: Tuple[int, ...]      # parallel to ``buckets``
    bucket_sizes: Tuple[int, ...]       # elements, parallel to ``buckets``
    total: int


def plan_flat_layout(leaf_sizes: Sequence[int], bucket_bytes: int, *,
                     elem_bytes: int = 4,
                     shortest_first: bool = True) -> FlatLayout:
    """Plan buckets over ``leaf_sizes`` (elements) and derive flat offsets.

    Because greedy packing consumes leaves in tree order, each bucket's
    indices form a contiguous range; the flat buffer is laid out in the
    same order, making every bucket a contiguous slice.
    """
    buckets = plan_buckets([s * elem_bytes for s in leaf_sizes], bucket_bytes,
                           shortest_first=shortest_first)
    offsets: List[int] = []
    off = 0
    for s in leaf_sizes:
        offsets.append(off)
        off += s
    starts, sizes = [], []
    for b in buckets:
        lo, hi = b.indices[0], b.indices[-1]
        if b.indices != tuple(range(lo, hi + 1)):
            raise AssertionError(
                "greedy packing must yield contiguous tree-order buckets")
        starts.append(offsets[lo])
        sizes.append(offsets[hi] + leaf_sizes[hi] - offsets[lo])
    return FlatLayout(buckets=tuple(buckets), leaf_sizes=tuple(leaf_sizes),
                      leaf_offsets=tuple(offsets),
                      bucket_starts=tuple(starts), bucket_sizes=tuple(sizes),
                      total=off)


# --------------------------------------------------------------------------- #
# pack / unpack
# --------------------------------------------------------------------------- #
def pack_leaves(leaves: Sequence[torch.Tensor],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Every leaf, raveled and cast, in one flat buffer (one ``cat``)."""
    if len(leaves) == 1:
        return leaves[0].to(dtype).ravel()
    return torch.cat([l.to(dtype).ravel() for l in leaves])


def bucket_slice(flat: torch.Tensor, layout: FlatLayout, k: int
                 ) -> torch.Tensor:
    """Bucket ``k`` of the flat buffer: a view, not a copy."""
    start = layout.bucket_starts[k]
    return flat[start:start + layout.bucket_sizes[k]]


def unpack_bucket(vec: torch.Tensor, layout: FlatLayout, k: int,
                  leaves: Sequence[torch.Tensor]
                  ) -> List[Tuple[int, torch.Tensor]]:
    """Split a reduced bucket back into ``(leaf_index, leaf)`` pairs: views
    of ``vec`` reshaped to each leaf's shape, cast to its dtype (the cast
    copies where the dtype differs).  ``leaves`` supplies shapes and
    dtypes."""
    out = []
    start = layout.bucket_starts[k]
    for i in layout.buckets[k].indices:
        off = layout.leaf_offsets[i] - start
        ref = leaves[i]
        out.append((i, vec[off:off + ref.numel()].view(ref.shape)
                    .to(ref.dtype)))
    return out


def padded_size(leaf_sizes: Sequence[int], block: int = 256) -> int:
    """Length of the flat wire buffer: every leaf padded to ``block``."""
    return sum(s + (-s % block) for s in leaf_sizes)


# --------------------------------------------------------------------------- #
# flat wire round-trip (the PS data plane)
# --------------------------------------------------------------------------- #
def flat_compress_roundtrip(tree: Params, *, block: int = 256
                            ) -> Tuple[Params, float]:
    """int8-quantize a tree as ONE flat buffer and decode it with the fused
    dequantize+norm kernel.

    This is what an aggregator host receiving the update executes: the wire
    carries the flat int8 payload + scales, and the fused
    ``dequant_aggregate`` pass both reconstructs f32 and produces
    ``||u||^2`` without a second sweep.  Returns the decoded tree (its
    leaves are views of one decoded buffer) and ``||u||``.

    Each leaf is zero-padded to a ``block`` multiple before packing so no
    quantization block ever spans a leaf boundary — a tiny-magnitude leaf
    (bias, norm scale) sharing a block with a large-magnitude neighbour
    would otherwise round to all-zero int8 and never train.  The pad zeros
    add nothing to the norm.
    """
    from ..kernels.ops import dequant_aggregate_op, quantize_op

    leaves, treedef = tree_flatten(tree)
    flat = pack_leaves([F.pad(l.to(torch.float32).ravel(),
                              (0, -l.numel() % block)) for l in leaves])
    q, s = quantize_op(flat, block=block)
    ones = torch.ones((1,), dtype=torch.float32, device=flat.device)
    decoded, ssq = dequant_aggregate_op(q[None, :], s[None, :], ones,
                                        block=block, orig_len=flat.numel())
    out, off = [], 0
    for leaf in leaves:
        out.append(decoded[off:off + leaf.numel()].view(leaf.shape)
                   .to(leaf.dtype))
        off += leaf.numel() + (-leaf.numel() % block)
    norm = torch.sqrt(ssq)
    return tree_unflatten(treedef, out), float(norm)
