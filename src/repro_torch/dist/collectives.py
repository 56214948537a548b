"""MLfabric gradient reduction as explicit collectives over a mesh.

The port of ``repro/dist/collectives.py``.  It reduces a gradient tree on
the schedule the paper's control plane plans:

* **Flat buckets** (``dist/flatbuf.py``): the whole gradient is packed once
  into one flat f32 buffer, and every planned bucket is a view of it, so a
  bucket is one transfer unit, as it is one unit in the control plane's
  schedule (paper §4).
* **Shortest-job-first issue order** (Alg. 2, §5.1.1): buckets are issued
  smallest first, in ``layout.buckets`` order.  The reference chains its
  buckets through ``optimization_barrier`` so that XLA cannot reorder them;
  eager PyTorch issues each collective when it is called, and collectives
  on one process group complete in issue order, so issuing the buckets in
  layout order is the chain.  There is no token.
* **Hierarchical aggregation** (§5.2): an intra-pod stage over the
  ``data`` axis, then a cross-pod stage over the ``pod`` axis that mirrors
  the paper's aggregator hosts: every pod's partial sum is all-gathered
  into ``[P, D]`` and summed by the ``grad_aggregate`` kernel, or, with
  ``compress_inter``, quantized to int8 (``quantize``), gathered, and
  decoded and summed in one pass (``dequant_aggregate``).
* **The in-network switch** (``backend="switch"`` / ``"hierarchical"``,
  DESIGN.md §13, SwitchML): the intra-pod stage is a fixed-point sum.  The
  members agree on one scale (a MAX all-reduce of their amax, times
  f32(1/127) as the reference's jitted code computes it), quantize to int8
  against it, all-gather the int8 payloads, and the ``switch_sum`` kernel
  adds them exactly in int32; the sum times the scale is the pod's
  aggregate.  It runs on every bucket, also on a data axis of one, where
  the MAX is the local one and the gather is the identity.
  ``"hierarchical"`` also forces the int8 cross-pod stage.
* **The bounded-loss cross-pod stage** (``keep_inter``, §12): every pod
  ships only its top-k coordinates as ``(idx int32, q int8, scale f32)``;
  ``drop_mask_inter`` marks the slots the transport lost (``idx = -1``);
  the ``scatter_aggregate`` kernel adds the gathered chunks into the dense
  bucket.  Deliberately lossy: pair it with a sender's ``ErrorFeedback``.

A group of one needs no collective: its all-reduce and all-gather are
identities, so on an axis of size 1 the bucket view itself goes on to the
next stage.  On a ``(pod=1, data=1)`` mesh every bucket therefore reaches
the cross-pod kernels as a view into the flat buffer, which may start at
any element; the kernels take such views.

With the host backend the intra-pod all-reduces of all buckets are issued
first (``async_op``), then each bucket's cross-pod stage in the same order,
so on NCCL the host never waits for the wire; numerics do not depend on it.
The switch stage waits for its scale, so it runs bucket by bucket.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.ops import (dequant_aggregate_op, grad_aggregate_op,
                           quantize_op, scatter_aggregate_op, switch_sum_op)
from ..obs.trace import region
from ..tree import tree_flatten, tree_leaves, tree_unflatten
from .flatbuf import (FlatLayout, bucket_slice, drop_slots, encode_int8,
                      int8_scale, pack_leaves, plan_flat_layout,
                      sparse_quantize, topk_sparsify, unpack_bucket)

Params = Any
DropMask = Optional[Union[Callable[[int], Any], Any]]

__all__ = ["loss_drop_mask", "mlfabric_grad_reduce", "plan_reduce",
           "reduce_flat_buckets", "reduce_packed", "unpack_reduced"]

BACKENDS = ("host", "switch", "hierarchical")


def _intra_pod_switch_sum(vec: torch.Tensor, group, n: int, *,
                          window: int = 256) -> torch.Tensor:
    """Intra-pod stage in switch mode: fixed-point in-network aggregation.

    The pod switch only adds integers, so the members agree on one shared
    scale (the MAX of their amax; every member takes part), quantize to
    int8 against it, and the switch (the ``switch_sum`` kernel over the
    gathered wire payload) emits exact int32 sums that any member
    dequantizes with the same scale.  The only error is the one rounding to
    the int8 grid.
    """
    d = vec.shape[0]
    vec = vec.to(torch.float32)
    amax = vec.abs().max().reshape(1)
    if n > 1:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = int8_scale(amax[0], reciprocal=True)     # as under jit
    q = encode_int8(vec, scale)
    pad = (-d) % window
    if pad:
        q = F.pad(q, (0, pad))
    qs = _all_gather(q, group, n) if n > 1 else q[None]  # [W, D_pad] wire
    s = switch_sum_op(qs, window=window, orig_len=d)
    return s.to(torch.float32) * scale


def loss_drop_mask(loss: Any, src: str, dst: str, t: float,
                   k: int) -> np.ndarray:
    """Derive the sparse wire's per-slot drop mask from the simulator's
    :class:`~repro_torch.core.network.LossSchedule`.

    The schedule is a fluid model — ``instant_loss`` returns an expected
    drop *rate* for the path at ``t`` — so the mask realizes that rate
    deterministically: ``round(drop * k)`` of the ``k`` top-k slots,
    evenly spaced across the payload (a burst on the wire hits slots
    uniformly since top-k order is magnitude order, not position order).
    """
    drop, _ = loss.instant_loss(src, dst, t)
    mask = np.zeros(k, dtype=bool)
    n_drop = int(round(drop * k))
    if n_drop > 0:
        mask[np.floor(np.arange(n_drop) * (k / n_drop)).astype(int)] = True
    return mask


def _all_gather(vec: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[n, D]``: every member's ``vec``, in group rank order."""
    out = vec.new_empty((n, vec.shape[0]))
    dist.all_gather(list(out.unbind(0)), vec, group=group)
    return out


def _inter_pod_aggregate(vec: torch.Tensor, group, n_pods: int, *,
                         compress: bool) -> torch.Tensor:
    """Cross-pod stage: gather every pod's partial aggregate and run the
    aggregator's fused compute from ``kernels/``.

    With ``compress`` the wire payload is the int8 blocks + f32 scales and
    the receiving aggregator runs one fused dequantize+aggregate+norm pass
    over the stacked payloads, never materializing per-pod f32 copies.
    """
    ones = torch.ones((n_pods,), dtype=torch.float32, device=vec.device)
    if compress:
        d = vec.shape[0]
        q, s = quantize_op(vec)                      # pads internally
        if n_pods > 1:
            q = _all_gather(q, group, n_pods)        # [P, D_pad] int8 wire
            s = _all_gather(s, group, n_pods)        # [P, D_pad/block] f32
        else:
            q, s = q[None], s[None]
        agg, _ = dequant_aggregate_op(q, s, ones, orig_len=d)
        return agg
    gathered = (_all_gather(vec, group, n_pods) if n_pods > 1
                else vec[None])                      # [P, D] f32 wire
    agg, _ = grad_aggregate_op(gathered, ones)
    return agg


def _inter_pod_aggregate_sparse(vec: torch.Tensor, group, n_pods: int, *,
                                keep: float, drop_mask: Any = None
                                ) -> torch.Tensor:
    """Bounded-loss cross-pod stage: every pod ships only its top-k
    coordinates as ``(idx int32, q int8, scale f32)`` and the receiving
    host scatter-adds the gathered chunks into the dense bucket with the
    ``scatter_aggregate`` kernel (no per-pod dense reconstruction).

    The wire shrinks to ``keep * (4 + 1) / 4`` of the dense f32 payload.
    ``drop_mask`` (bool, typically from :func:`loss_drop_mask`) marks the
    slots the transport lost in flight: they go on the wire as ``idx = -1``,
    which the kernel skips.
    """
    d = vec.shape[0]
    k = max(1, min(d, int(round(keep * d))))
    idx, vals = topk_sparsify(vec, k)
    if drop_mask is not None:
        idx = drop_slots(idx, drop_mask)
    q, scale = sparse_quantize(vals, reciprocal=True)   # as under jit
    scale = scale.reshape(1)
    if n_pods > 1:
        idx = _all_gather(idx, group, n_pods)        # [P, K] int32 wire
        q = _all_gather(q, group, n_pods)            # [P, K] int8 wire
        scale = _all_gather(scale, group, n_pods).reshape(n_pods)
    else:
        idx, q = idx[None], q[None]
    ones = torch.ones((n_pods,), dtype=torch.float32, device=vec.device)
    agg, _ = scatter_aggregate_op(idx, q, scale, ones, d_out=d)
    return agg


# --------------------------------------------------------------------------- #
# staged flat-bucket reduction
# --------------------------------------------------------------------------- #
def plan_reduce(tree: Params, *, bucket_bytes: int,
                shortest_first: bool = True) -> FlatLayout:
    """Plan the flat-bucket layout for a gradient tree (f32 transfer)."""
    return plan_flat_layout([l.numel() for l in tree_leaves(tree)],
                            bucket_bytes, elem_bytes=4,
                            shortest_first=shortest_first)


def reduce_flat_buckets(grads: Params, layout: FlatLayout,
                        **kw) -> List[torch.Tensor]:
    """Pack ``grads`` flat and reduce every bucket over ``mesh`` in issue
    order (:func:`reduce_packed`, which takes the same keywords).  No
    result aliases ``grads``: where nothing would copy the one f32 leaf of
    a tree, it is copied here."""
    leaves = tree_leaves(grads)
    flat = pack_leaves(leaves)                       # one cat
    if len(leaves) == 1 and leaves[0].dtype == torch.float32:
        flat = flat.clone()                          # else a view of it
    return reduce_packed(flat, layout, **kw)


def reduce_packed(flat: torch.Tensor, layout: FlatLayout, *, mesh,
                  intra_axis: str, inter_axis: Optional[str],
                  compress_inter: bool, mean_over: int,
                  keep_inter: Optional[float] = None,
                  backend: str = "host",
                  drop_mask_inter: DropMask = None,
                  tracer: Any = None) -> List[torch.Tensor]:
    """Reduce every bucket of ``flat`` (a gradient tree packed by
    ``flatbuf.pack_leaves``, whose tree the caller may then free) over
    ``mesh`` in issue order; returns the reduced bucket vectors in
    ``layout.buckets`` order.  With ``mean_over == 1`` and no stage that
    copies (a host reduce over axes of one), they are views of ``flat``.

    Unlike the reference there is no chain token to thread: calling this
    once per gradient chunk keeps every collective in the planned order.
    ``backend`` picks the intra-pod aggregation: ``"host"`` is the f32
    all-reduce; ``"switch"`` the fixed-point in-network sum
    (``_intra_pod_switch_sum``); ``"hierarchical"`` is the switch plus the
    forced int8 cross-pod stage.  ``keep_inter`` replaces the dense
    cross-pod stage with the sparse one; ``drop_mask_inter`` feeds its
    per-slot transport drops, as a bool mask or a callable ``k -> mask``
    (e.g. ``functools.partial(loss_drop_mask, loss, src, dst, t)``), since
    the top-k slot count varies per bucket.
    ``tracer`` (a ``repro_torch.obs.trace.Tracer``) gets one ``bucket`` span
    per bucket, from the issue of its intra-pod reduce to the return of its
    cross-pod stage, on the host clock (collectives and kernels run
    asynchronously on a card, so this is issue time, not device time).
    While a profiler records, each bucket's wait, aggregation and mean run
    inside an ``mlfabric.bucket`` span on the profiler's clock, beside the
    device work they launch.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
    if backend == "hierarchical":
        compress_inter = True
    n_intra = mesh.shape[intra_axis]
    n_inter = mesh.shape[inter_axis] if inter_axis is not None else 1
    timed = tracer is not None
    t0 = time.perf_counter() if timed else 0.0
    issued = []
    for k in range(len(layout.buckets)):
        t_issue = time.perf_counter() - t0 if timed else 0.0
        vec = bucket_slice(flat, layout, k)          # a view
        work = None
        if backend == "host" and n_intra > 1:
            # a copy: the reduce writes in place, and the flat buffer may
            # be a gradient itself (one f32 leaf packs to a view of it)
            vec = vec.clone()
            work = dist.all_reduce(vec, group=mesh.groups[intra_axis],
                                   async_op=True)
        issued.append((vec, work, t_issue))
    reduced: List[torch.Tensor] = []
    for k, (vec, work, t_issue) in enumerate(issued):
        b = layout.buckets[k]
        with region("mlfabric.bucket", bucket=k, bytes=b.nbytes):
            if work is not None:
                work.wait()
            if backend != "host":
                vec = _intra_pod_switch_sum(vec, mesh.groups[intra_axis],
                                            n_intra)
            if inter_axis is not None:
                group = mesh.groups[inter_axis]
                if keep_inter is not None:
                    d_bkt = vec.shape[0]
                    k_top = max(1, min(d_bkt, int(round(keep_inter * d_bkt))))
                    mask = (drop_mask_inter(k_top) if callable(drop_mask_inter)
                            else drop_mask_inter)
                    vec = _inter_pod_aggregate_sparse(vec, group, n_inter,
                                                      keep=keep_inter,
                                                      drop_mask=mask)
                else:
                    vec = _inter_pod_aggregate(vec, group, n_inter,
                                               compress=compress_inter)
            # dividing by one changes no bit: skip the bucket's copy
            reduced.append(vec if mean_over == 1 else vec / mean_over)
        if timed:
            tracer.span(f"bucket{k} ({len(b.indices)} leaves)", cat="bucket",
                        track=intra_axis, ts=t_issue,
                        dur=time.perf_counter() - t0 - t_issue,
                        args={"bucket": k, "bytes": b.nbytes,
                              "leaves": list(b.indices),
                              "inter": inter_axis or "",
                              "backend": backend,
                              "compressed": bool(compress_inter),
                              "keep": keep_inter if keep_inter is not None
                              else 1.0})
    return reduced


def unpack_reduced(reduced: List[torch.Tensor], layout: FlatLayout,
                   tree: Params) -> Params:
    """Carve the reduced bucket vectors back into ``tree``'s structure
    (views of each bucket, cast to each leaf's dtype)."""
    leaves, treedef = tree_flatten(tree)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for k, vec in enumerate(reduced):
        for i, leaf in unpack_bucket(vec, layout, k, leaves):
            out[i] = leaf
    return tree_unflatten(treedef, out)


def mlfabric_grad_reduce(grads: Params, *, mesh, intra_axis: str = "data",
                         inter_axis: Optional[str] = None,
                         bucket_bytes: int = 4 * 2 ** 20,
                         shortest_first: bool = True,
                         compress_inter: bool = False,
                         keep_inter: Optional[float] = None,
                         backend: str = "host",
                         drop_mask_inter: DropMask = None,
                         mean_over: int = 1, tracer: Any = None) -> Params:
    """Scheduled hierarchical mean of a gradient tree over ``mesh``.

    Equal (to f32 reduction tolerance; int8 tolerance with
    ``compress_inter`` or a switch ``backend``) to the sum of ``grads`` over
    the ranks of the intra- and inter-pod axes divided by ``mean_over``,
    executed as an explicit flat-bucket schedule.  ``backend`` selects the
    intra-pod aggregation ("host" f32 all-reduce, "switch"/"hierarchical"
    fixed-point in-network sum, see ``reduce_flat_buckets``).  With
    ``keep_inter`` the cross-pod stage ships only each pod's top-k fraction
    (the bounded-loss wire format), deliberately lossy: pair it with a
    sender's ``ErrorFeedback``, and ``drop_mask_inter`` to realize the
    simulator's transport drops on this wire.  Every rank of the mesh must
    call it with trees of the same shapes.
    """
    if not tree_leaves(grads):
        return grads
    layout = plan_reduce(grads, bucket_bytes=bucket_bytes,
                         shortest_first=shortest_first)
    reduced = reduce_flat_buckets(
        grads, layout, mesh=mesh, intra_axis=intra_axis,
        inter_axis=inter_axis, compress_inter=compress_inter,
        keep_inter=keep_inter, backend=backend,
        drop_mask_inter=drop_mask_inter, mean_over=mean_over, tracer=tracer)
    return unpack_reduced(reduced, layout, grads)
