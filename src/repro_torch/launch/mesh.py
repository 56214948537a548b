"""The port's device mesh: named axes over ``torch.distributed`` ranks.

The reference lays a ``jax.sharding.Mesh`` over its devices and reduces
over named axes inside ``shard_map``.  Here one process drives one device,
and a :class:`Mesh` names the axes ``("pod", "data")`` (optionally a
trailing ``"model"`` of size 1) over the ranks of the default process
group, row-major: with ``data`` ranks per pod, rank = ``pod * data + data
index``.  For every axis it holds one process group per line of ranks
along that axis: the intra-pod groups (axis ``data``) and the inter-pod
groups of the ranks with the same data index (axis ``pod``).

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
    sizes = dict(zip(axis_names, shape))
    if sizes.get("model", 1) != 1:
        raise NotImplementedError(
            "a model axis of size > 1 is tensor parallelism, ROADMAP "
            "slice 5; the port's mesh carries pod and data axes only")
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
    return Mesh(axis_names=axis_names, shape=sizes, device=dev, rank=rank,
                coords=coords, groups=groups)


def make_host_mesh(*, device: DeviceLike = None) -> Mesh:
    """A ``(pod=1, data=1)`` mesh for one process, initializing a world of
    one first if no process group exists (gloo for the CPU, and NCCL for
    CUDA tensors where the card has it).  With a pod axis every bucket of
    the MLfabric step passes through the cross-pod aggregator kernel, at
    N=1."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "gloo"
        if torch.cuda.is_available() and dist.is_nccl_available():
            backend = "cpu:gloo,cuda:nccl"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("pod", "data"), device=dev)
