"""Parameter trees between the JAX package and the port, through numpy.

A JAX param tree, handed over as nested dicts of numpy arrays, becomes the
port's tree of tensors with the same keys and the same stacked ``[L, ...]``
layer leaves, and back.  numpy has no bfloat16 of its own, so bf16 travels
as float32: widening bf16 to f32 and narrowing that f32 back to bf16 are
both exact.
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
             device: DeviceLike = None) -> Tree:
    """numpy tree -> tensor tree on ``device``.

    Float leaves become ``dtype`` (default: bf16 for bf16 leaves, else the
    leaf's own float type) by way of float32; other leaves keep their type.
    """
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

    return tree_map(conv, tree)


def to_numpy(tree: Tree) -> Tree:
    """tensor tree -> numpy tree; float leaves come back as float32."""
    def conv(t: torch.Tensor):
        t = t.detach().cpu()
        if t.is_floating_point():
            t = t.float()
        return t.numpy()

    return tree_map(conv, tree)
