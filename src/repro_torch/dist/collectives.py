"""MLfabric gradient reduction as explicit collectives over a mesh.

The port of ``repro/dist/collectives.py``, host backend.  It reduces a
gradient tree on the schedule the paper's control plane plans:

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
* **Hierarchical aggregation** (§5.2): an intra-pod all-reduce over the
  ``data`` axis, then a cross-pod stage over the ``pod`` axis that mirrors
  the paper's aggregator hosts: every pod's partial sum is all-gathered
  into ``[P, D]`` and summed by the ``grad_aggregate`` kernel, or, with
  ``compress_inter``, quantized to int8 (``quantize``), gathered, and
  decoded and summed in one pass (``dequant_aggregate``).

A group of one needs no collective: its all-reduce and all-gather are
identities, so on an axis of size 1 the bucket view itself goes on to the
next stage.  On a ``(pod=1, data=1)`` mesh every bucket therefore reaches
the cross-pod kernels as a view into the flat buffer, which may start at
any element; the kernels take such views.

The intra-pod all-reduces of all buckets are issued first (``async_op``),
then each bucket's cross-pod stage in the same order, so on NCCL the host
never waits for the wire; numerics do not depend on it.

Not ported yet (ROADMAP slice 4): ``backend="switch"`` and
``"hierarchical"`` (the fixed-point switch sum, kernel ``switch_sum``) and
the sparse ``keep_inter`` stage (kernel ``scatter_aggregate``).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.ops import dequant_aggregate_op, grad_aggregate_op, quantize_op
from ..tree import tree_flatten, tree_leaves, tree_unflatten
from .flatbuf import (FlatLayout, bucket_slice, pack_leaves, plan_flat_layout,
                      unpack_bucket)

Params = Any

__all__ = ["loss_drop_mask", "mlfabric_grad_reduce", "plan_reduce",
           "reduce_flat_buckets", "unpack_reduced"]

BACKENDS = ("host", "switch", "hierarchical")


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


# --------------------------------------------------------------------------- #
# staged flat-bucket reduction
# --------------------------------------------------------------------------- #
def plan_reduce(tree: Params, *, bucket_bytes: int,
                shortest_first: bool = True) -> FlatLayout:
    """Plan the flat-bucket layout for a gradient tree (f32 transfer)."""
    return plan_flat_layout([l.numel() for l in tree_leaves(tree)],
                            bucket_bytes, elem_bytes=4,
                            shortest_first=shortest_first)


def _check_backend(backend: str, keep_inter) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
    if backend != "host":
        raise NotImplementedError(
            f"backend={backend!r} (the switch sum) is ROADMAP slice 4; the "
            "port reduces with the host backend only")
    if keep_inter is not None:
        raise NotImplementedError(
            "keep_inter (the sparse bounded-loss cross-pod stage) is ROADMAP "
            "slice 4; the port reduces dense buckets only")


def reduce_flat_buckets(grads: Params, layout: FlatLayout, *, mesh,
                        intra_axis: str, inter_axis: Optional[str],
                        compress_inter: bool, mean_over: int,
                        keep_inter: Optional[float] = None,
                        backend: str = "host",
                        tracer: Any = None) -> List[torch.Tensor]:
    """Pack ``grads`` flat and reduce every bucket over ``mesh`` in issue
    order; returns the reduced bucket vectors in ``layout.buckets`` order.

    Unlike the reference there is no chain token to thread: calling this
    once per gradient chunk keeps every collective in the planned order.
    ``keep_inter`` and a ``backend`` other than "host" raise (ROADMAP slice
    4).
    ``tracer`` (a ``repro_torch.obs.trace.Tracer``) gets one ``bucket`` span
    per bucket, from the issue of its intra-pod reduce to the return of its
    cross-pod stage, on the host clock (collectives and kernels run
    asynchronously on a card, so this is issue time, not device time).
    """
    _check_backend(backend, keep_inter)
    flat = pack_leaves(tree_leaves(grads))           # one cat
    n_intra = mesh.shape[intra_axis]
    n_inter = mesh.shape[inter_axis] if inter_axis is not None else 1
    t0 = time.perf_counter()
    issued = []
    for k in range(len(layout.buckets)):
        t_issue = time.perf_counter() - t0
        vec = bucket_slice(flat, layout, k)          # a view
        work = None
        if n_intra > 1:
            # a copy: the reduce writes in place, and the flat buffer may
            # be a gradient itself (one f32 leaf packs to a view of it)
            vec = vec.clone()
            work = dist.all_reduce(vec, group=mesh.groups[intra_axis],
                                   async_op=True)
        issued.append((vec, work, t_issue))
    reduced: List[torch.Tensor] = []
    for k, (vec, work, t_issue) in enumerate(issued):
        if work is not None:
            work.wait()
        if inter_axis is not None:
            vec = _inter_pod_aggregate(vec, mesh.groups[inter_axis], n_inter,
                                       compress=compress_inter)
        reduced.append(vec / mean_over)
        if tracer is not None:
            b = layout.buckets[k]
            tracer.span(f"bucket{k} ({len(b.indices)} leaves)", cat="bucket",
                        track=intra_axis, ts=t_issue,
                        dur=time.perf_counter() - t0 - t_issue,
                        args={"bucket": k, "bytes": b.nbytes,
                              "leaves": list(b.indices),
                              "inter": inter_axis or "",
                              "backend": backend,
                              "compressed": bool(compress_inter),
                              "keep": 1.0})
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
                         mean_over: int = 1, tracer: Any = None) -> Params:
    """Scheduled hierarchical mean of a gradient tree over ``mesh``.

    Equal (to f32 reduction tolerance; int8 tolerance with
    ``compress_inter``) to the sum of ``grads`` over the ranks of the
    intra- and inter-pod axes divided by ``mean_over``, executed as an
    explicit flat-bucket schedule.  Every rank of the mesh must call it
    with trees of the same shapes.
    """
    if not tree_leaves(grads):
        return grads
    layout = plan_reduce(grads, bucket_bytes=bucket_bytes,
                         shortest_first=shortest_first)
    reduced = reduce_flat_buckets(
        grads, layout, mesh=mesh, intra_axis=intra_axis,
        inter_axis=inter_axis, compress_inter=compress_inter,
        keep_inter=keep_inter, backend=backend, mean_over=mean_over,
        tracer=tracer)
    return unpack_reduced(reduced, layout, grads)
