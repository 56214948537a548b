"""Flat-bucket layout, the flat int8 wire round-trip, and the bounded-loss
wire format.

The control plane schedules whole *buckets* (paper §4: updates are the unit
of transfer), so the data plane moves each bucket as one contiguous array.
The planners are pure Python, copied from ``repro/dist/flatbuf.py`` (that
module imports JAX at the top); ``pack_leaves``, ``bucket_slice``,
``unpack_bucket`` and ``flat_compress_roundtrip`` are its data movements in
PyTorch.  The sparse half (§12) is ``topk_sparsify``, ``sparse_quantize``,
``SparseChunk`` and the per-sender ``ErrorFeedback`` compressor.

Leaf order is the reference's sorted-key order (``repro_torch.tree``): the
layout, the per-leaf padding and hence every quantization block depend on
it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..obs.trace import region
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
    """Every leaf, raveled and cast, in one flat buffer: each is cast as it
    is copied into its place, so no cast copy of the whole tree is made
    beside the buffer."""
    if len(leaves) == 1:
        return leaves[0].to(dtype).ravel()
    flat = torch.empty(sum(l.numel() for l in leaves), dtype=dtype,
                       device=leaves[0].device)
    start = 0
    for l in leaves:
        flat[start:start + l.numel()].view(l.shape).copy_(l)
        start += l.numel()
    return flat


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
    with region("mlfabric.wire", floats=sum(l.numel() for l in leaves)):
        flat = pack_leaves([F.pad(l.to(torch.float32).ravel(),
                                  (0, -l.numel() % block)) for l in leaves])
        q, s = quantize_op(flat, block=block)
        ones = torch.ones((1,), dtype=torch.float32, device=flat.device)
        decoded, ssq = dequant_aggregate_op(q[None, :], s[None, :], ones,
                                            block=block,
                                            orig_len=flat.numel())
        out, off = [], 0
        for leaf in leaves:
            out.append(decoded[off:off + leaf.numel()].view(leaf.shape)
                       .to(leaf.dtype))
            off += leaf.numel() + (-leaf.numel() % block)
        with region("mlfabric.sync", read="wire_norm"):
            norm = float(torch.sqrt(ssq))
    return tree_unflatten(treedef, out), norm


# --------------------------------------------------------------------------- #
# bounded-loss wire format: top-k sparsification + error feedback (§12)
# --------------------------------------------------------------------------- #
_INV_127 = 1.0 / 127.0


def topk_sparsify(vec: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """|.|-top-k of a flat vector -> (idx int32 [k], vals f32 [k]), largest
    first.  Equal magnitudes come lower index first, as ``jax.lax.top_k``
    orders them (``torch.topk`` promises no order for ties); the order
    decides which slots a drop mask hits, so it is part of the wire."""
    x = vec.to(torch.float32)
    _, order = torch.sort(x.abs(), descending=True, stable=True)
    idx = order[:k]
    return idx.to(torch.int32), x[idx]


def int8_scale(amax: torch.Tensor, *, reciprocal: bool = False
               ) -> torch.Tensor:
    """The int8 scale of a chunk whose largest magnitude is ``amax``:
    ``amax / 127``, floored at 1e-30 like ``quantize_ref``.

    The reference computes ``amax / 127.0`` in two ways: eagerly (as
    ``ErrorFeedback.compress`` runs it) a division, and under ``jit`` (as the
    switch and sparse cross-pod stages run it) a multiply by f32(1/127),
    which XLA substitutes; the two differ in the last bit of some scales.
    ``reciprocal=True`` gives the jitted one."""
    if reciprocal:
        scale = amax * torch.full((), _INV_127, dtype=torch.float32,
                                  device=amax.device)
    else:
        # a tensor divisor: on the card PyTorch turns division by a Python
        # scalar into a multiply by its reciprocal
        scale = amax / torch.full((), 127.0, dtype=torch.float32,
                                  device=amax.device)
    return torch.clamp_min(scale, 1e-30)


def encode_int8(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round_half_even(v / scale), -127, 127)`` as int8; ``v /
    scale`` is a division in the reference both eagerly and under
    ``jit``."""
    return torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)


def sparse_quantize(vals: torch.Tensor, *, reciprocal: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize one sparse chunk's values with a single scale
    (``int8_scale`` of max|vals|; ``reciprocal=True`` as under ``jit``)."""
    v = vals.to(torch.float32)
    scale = int8_scale(v.abs().max(), reciprocal=reciprocal)
    return encode_int8(v, scale), scale


def drop_slots(idx: torch.Tensor, drop_mask: Any) -> torch.Tensor:
    """``idx`` with the slots the transport dropped set to -1.  ``drop_mask``
    (bool, True = dropped) is cut to ``len(idx)``; a short one leaves the
    remaining slots alive."""
    k = idx.shape[0]
    drop = torch.as_tensor(drop_mask, dtype=torch.bool,
                           device=idx.device).ravel()[:k]
    if drop.shape[0] < k:
        drop = torch.cat([drop, drop.new_zeros(k - drop.shape[0])])
    return torch.where(drop, -1, idx)


@dataclass(frozen=True)
class SparseChunk:
    """One sender's bounded-loss wire payload for a flat bucket.

    ``idx`` entries of -1 mark slots the transport dropped (the receiver's
    scatter kernel treats them as zero contribution); ``q``/``scale`` are
    the surviving int8 values.  ``flushed`` counts coordinates the sender
    had to force-deliver reliably to honor its residual bound.
    """

    idx: torch.Tensor       # int32 [k]; -1 = transport-dropped slot
    q: torch.Tensor         # int8 [k]
    scale: torch.Tensor     # f32 []
    flushed: int = 0


class ErrorFeedback:
    """Per-sender error-feedback compressor for the bounded-loss tier.

    ``compress`` adds the carried residual, selects the top-k coordinates,
    applies the transport's drop pattern, int8-quantizes the survivors and
    keeps ``residual = x - delivered``.  The open-loop bound "residual
    shrinks by the top-k mass" is false under adversarial drops (losing the
    single largest coordinate keeps nearly all the mass), so the bound is
    *enforced*: while ``||residual|| > bound`` the largest residual
    coordinates are flushed exactly (the transport's reliable-retransmit
    path) and counted in ``flushed_total``.  ``||residual|| <= bound``
    therefore holds after every call.  The state lives on ``device``: the
    card unless the caller names another.
    """

    def __init__(self, dim: int, *, device: DeviceLike = None):
        self.dim = int(dim)
        self.device = resolve_device(device)
        self.residual = torch.zeros(self.dim, dtype=torch.float32,
                                    device=self.device)
        self.flushed_total = 0

    def compress(self, vec: Any, *, keep: float,
                 bound: Optional[float] = None, drop_mask: Any = None
                 ) -> Tuple[SparseChunk, torch.Tensor]:
        """-> (wire chunk, exactly-delivered dense contribution).

        ``keep`` is the top-k fraction; ``drop_mask`` (bool, >= k long,
        True = dropped) is the transport's loss pattern over the k selected
        slots; ``bound`` is the phase-aware residual-norm ceiling (None =
        accept any residual).  The dense return includes both the lossy
        scatter contribution and any bound-enforcement flushes, i.e. it is
        exactly what the aggregate will contain for this sender.
        """
        if not (0.0 < keep <= 1.0):
            raise ValueError(f"keep must be in (0, 1]: {keep}")
        x = torch.as_tensor(vec, device=self.device).to(torch.float32) \
            + self.residual
        d = self.dim
        k = max(1, min(d, int(round(keep * d))))
        idx, vals = topk_sparsify(x, k)
        if drop_mask is not None:
            idx = drop_slots(idx, drop_mask)
        q, scale = sparse_quantize(vals)
        live = idx >= 0
        deq = torch.where(live, q.to(torch.float32) * scale, 0.0)
        delivered = torch.zeros(d, dtype=torch.float32, device=self.device)
        delivered.index_add_(0, torch.where(live, idx, 0).to(torch.int64),
                             deq)
        residual = x - delivered
        flushed = 0
        if bound is not None:
            # terminates in <= ceil(d/k) rounds: each zeroes k more
            # coordinates of the residual
            while float(torch.sqrt(torch.sum(residual * residual))) > bound:
                fi, fv = topk_sparsify(residual, k)
                fi = fi.to(torch.int64)
                delivered.index_add_(0, fi, fv)
                residual[fi] = 0.0
                flushed += k
        self.residual = residual
        self.flushed_total += flushed
        return SparseChunk(idx=idx, q=q, scale=scale,
                           flushed=flushed), delivered
