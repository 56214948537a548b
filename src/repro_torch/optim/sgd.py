"""The update norm workers ship with ``push()`` (paper Table 1).

The server's eq.-2 momentum rule lives in ``ps/server.py``; this module
carries what the worker side of MLfabric-A needs.
"""

from __future__ import annotations

from typing import Any

import torch

from ..tree import tree_leaves

Params = Any


def update_norm(update: Params) -> torch.Tensor:
    """||u||_2 over the whole update tree, accumulated in f32 — the norm the
    scheduler's divergence bound reads."""
    sq = sum(torch.sum(torch.square(u.to(torch.float32)))
             for u in tree_leaves(update))
    return torch.sqrt(sq)
