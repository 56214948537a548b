"""Parameter and optimizer-state trees between the JAX package and the
port, through numpy.

A JAX param tree, handed over as nested dicts of numpy arrays, becomes the
port's tree of tensors with the same keys and the same stacked ``[L, ...]``
layer leaves, and back.  Optimizer states cross too: a ``MomentumState``
or ``AdamWState`` (the reference's NamedTuples, whatever package defined
them) becomes the port's class of the same name, field for field, and
``to_numpy`` keeps the port's class, whose fields a caller hands to the
reference's constructor.  numpy has no bfloat16 of its own, so bf16
travels as float32: widening bf16 to f32 and narrowing that f32 back to
bf16 are both exact.  Whole checkpoint directories need no conversion:
both packages write the same files with the same leaf names
(``repro_torch.checkpoint``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .tree import tree_map

Tree = Any


def _is_float(a: np.ndarray) -> bool:
    # ml_dtypes' bfloat16 (what ``np.asarray`` of a JAX bf16 array gives)
    # reports kind 'V', so it is recognised by name
    return a.dtype.kind == "f" or a.dtype.name == "bfloat16"


def to_torch(tree: Tree, *, dtype: Optional[torch.dtype] = None,
             device: DeviceLike = None, mesh=None,
             specs: Optional[Tree] = None) -> Tree:
    """numpy tree (params or an optimizer state) -> tensor tree on
    ``device``.

    Float leaves become ``dtype`` (default: bf16 for bf16 leaves, else the
    leaf's own float type) by way of float32; other leaves keep their type.

    With a ``mesh`` whose ``model`` axis is above 1 and ``specs`` (a spec
    tree of the same structure, e.g. ``dist.sharding.param_shardings``),
    each leaf becomes a DTensor laid out by its spec: this rank converts
    and keeps only its own block of the array, on ``mesh.device``.
    """
    if mesh is not None:
        from torch.distributed.tensor import DTensor

        from .dist.sharding import placements, shard_slices
        blocks = tree_map(lambda a, s: np.asarray(a)[shard_slices(
            mesh, s, np.shape(a), mesh.coords)], tree, specs)
        local = to_torch(blocks, dtype=dtype, device=mesh.device)
        return tree_map(lambda t, s: DTensor.from_local(
            t.contiguous(), mesh.device_mesh, placements(mesh, s),
            run_check=False), local, specs)
    dev = resolve_device(device)

    def conv(leaf):
        a = np.asarray(leaf)
        if not _is_float(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        target = dtype
        if target is None:
            target = (torch.bfloat16 if a.dtype.name == "bfloat16"
                      else torch.from_numpy(np.zeros((), a.dtype)).dtype)
        f32 = np.ascontiguousarray(a.astype(np.float32))
        return torch.from_numpy(f32).to(device=dev, dtype=target)

    return _as_port_states(tree_map(conv, tree))


def _as_port_states(tree: Tree) -> Tree:
    """Rebuild NamedTuples named like the port's optimizer states as the
    port's classes."""
    from .optim import AdamWState, MomentumState
    classes = {c.__name__: c for c in (MomentumState, AdamWState)}
    if isinstance(tree, dict):
        return {k: _as_port_states(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        cls = classes.get(type(tree).__name__, type(tree))
        return cls(*(_as_port_states(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_as_port_states(v) for v in tree)
    return tree


def to_numpy(tree: Tree) -> Tree:
    """tensor tree -> numpy tree; float leaves come back as float32.  A
    DTensor leaf is gathered whole first (a collective: every rank of its
    mesh calls this)."""
    from torch.distributed.tensor import DTensor

    def conv(t: torch.Tensor):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.detach().cpu()
        if t.is_floating_point():
            t = t.float()
        return t.numpy()

    return tree_map(conv, tree)
