"""The port's device mesh: named axes over ``torch.distributed`` ranks.

The reference lays a ``jax.sharding.Mesh`` over its devices and reduces
over named axes inside ``shard_map``.  Here one process drives one device,
and a :class:`Mesh` names the axes, a subset of ``("pod", "data",
"model")`` in that order, over the ranks of the default process group,
row-major: on a ``(pod, data, model)`` mesh rank = ``(pod * data + data
index) * model + model index``.  For every axis it holds one process group
per line of ranks along that axis: the intra-pod groups (axis ``data``),
the inter-pod groups of the ranks with the same data index (axis ``pod``)
and the tensor-parallel groups (axis ``model``).

A mesh whose ``model`` axis is above 1 also carries a
``torch.distributed.device_mesh.DeviceMesh`` over the same ranks (its axes
above 1), whose per-axis groups it uses: the steps lay their params,
batches and caches out as DTensors on it (``dist/sharding.py``).  Without one the groups are
made directly, as before the sharding slice, and nothing is a DTensor.

The caller, a test, or ``chip_smoke.py`` initializes the default process
group first; ``make_host_mesh`` does it for a single process.  On a card
host one process may own the default group with the backend
``"cpu:gloo,cuda:nccl"``, so the same step runs on the card and on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from torch.distributed.device_mesh import DeviceMesh

from ..device import DeviceLike, resolve_device

AXES = ("pod", "data", "model")


@dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the default process group.

    ``groups[axis]`` is this rank's process group along ``axis``, or None
    where the axis has size 1 (a group of one needs no collective)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    device: torch.device
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    device_mesh: Optional[DeviceMesh] = None

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes``."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def _coords(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _line_groups(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 rank: int, world: int
                 ) -> Dict[str, Optional[dist.ProcessGroup]]:
    """This rank's group along each axis (None where the axis has size 1),
    made by creating one group per line of ranks along every axis."""
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for ax, name in enumerate(axis_names):
        groups[name] = None
        if shape[ax] == 1:
            continue
        # one group per line of ranks along `name`, in rank order
        for r in range(world):
            c = _coords(r, shape)
            if c[ax] != 0:
                continue
            ranks = []
            for i in range(shape[ax]):
                cc = list(c)
                cc[ax] = i
                ranks.append(sum(x * math.prod(shape[j + 1:])
                                 for j, x in enumerate(cc)))
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    return groups


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: DeviceLike = None) -> Mesh:
    """A mesh of ``shape`` over the default process group, whose world size
    must be ``prod(shape)``.  Every rank must call this, in the same order
    as any other ``new_group``: each rank creates every group, including
    those it is not in.  ``device`` defaults to the current card."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} does not match axes "
                         f"{axis_names}")
    if not set(axis_names) <= set(AXES) or "data" not in axis_names:
        raise ValueError(f"mesh axes must include 'data' and come from "
                         f"{AXES}, got {axis_names}")
    if axis_names != tuple(a for a in AXES if a in axis_names):
        raise ValueError(f"mesh axes {axis_names} must come in the order "
                         f"{AXES}")
    sizes = dict(zip(axis_names, shape))
    if not dist.is_initialized():
        raise RuntimeError("initialize the default process group "
                           "(torch.distributed.init_process_group) before "
                           "make_mesh, or use make_host_mesh")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {sizes} needs {math.prod(shape)} ranks, the "
                         f"default process group has {world}")
    dev = resolve_device(device)
    rank = dist.get_rank()
    coords = dict(zip(axis_names, _coords(rank, shape)))
    device_mesh = None
    if sizes.get("model", 1) > 1:
        # over the axes above 1 only: an axis of one splits nothing, and
        # each more mesh dim multiplies the layouts DTensor's redistribution
        # planner searches (a pod axis of one made a step 60x slower)
        dm_axes = tuple(a for a in axis_names if sizes[a] > 1)
        device_mesh = DeviceMesh(
            dev.type, torch.arange(world).reshape([sizes[a] for a in dm_axes]),
            mesh_dim_names=dm_axes)
        groups = {name: device_mesh.get_group(name) if sizes[name] > 1
                  else None for name in axis_names}
    else:
        groups = _line_groups(shape, axis_names, rank, world)
    return Mesh(axis_names=axis_names, shape=sizes, device=dev, rank=rank,
                coords=coords, groups=groups, device_mesh=device_mesh)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: DeviceLike = None) -> Mesh:
    """A ``(pod=1, data)`` mesh, with a trailing ``model`` axis when
    ``model > 1``, over the default process group, whose world must be
    ``data * model``.  Where no process group exists a world of one is
    initialized first (gloo for the CPU, and NCCL for CUDA tensors where
    the card has it), which fits the default ``(1, 1)``.  With a pod axis
    every bucket of the MLfabric step passes through the cross-pod
    aggregator kernel, at N=1.  (The reference's host mesh is ``(data,
    model)`` over its local devices; the port keeps its pod axis of one.)"""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "gloo"
        if torch.cuda.is_available() and dist.is_nccl_available():
            backend = "cpu:gloo,cuda:nccl"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if model > 1:
        return make_mesh((1, data, model), ("pod", "data", "model"),
                         device=dev)
    return make_mesh((1, data), ("pod", "data"), device=dev)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), over
    a default process group of that size.

    Axes: ``data`` (batch / gradient reduce-scatter), ``model`` (tensor /
    expert / sequence parallel), plus ``pod`` for the cross-pod axis — the
    hierarchy MLfabric's aggregation tree maps onto (DESIGN.md §3).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
