"""Parameter server: versioned model + momentum update rule (paper eq. 2).

    w_{t+1} = w_t + u_t^j + gamma * (w_t - w_{t-1})

The server owns: the model tree, the momentum history ``h`` (the state the
replication bound reasons over), the version counter, and the delay tracker.
Updates arrive in scheduler-committed order; each carries the model version
it was computed from, so the server records the realized delay distribution
(which MLfabric's ordering narrows — eq. 4).

Unlike the reference's immutable arrays, ``push`` updates ``params`` and
``history`` in place (at full width each is a gigabyte or more).  The
server therefore starts from its own copy of the initial params, and
``pull()`` hands out the live tensors: a caller that needs a snapshot must
copy it.  The trainer computes each update from the pulled params before
the next push, so it needs none.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..core.delay import DelayTracker
from ..obs.trace import region
from ..tree import tree_leaves, tree_map

Params = Any


class ParameterServer:
    def __init__(self, params: Params, *, gamma: float = 0.9):
        self.params = tree_map(lambda p: p.detach().clone(), params)
        self.gamma = gamma
        self.history: Params = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        self.version = 0
        self.delays = DelayTracker()

    # ------------------------------------------------------------------ #
    def pull(self) -> Tuple[Params, int]:
        """Latest model + its version (live tensors, see the module note)."""
        return self.params, self.version

    @torch.no_grad()
    def push(self, update: Params, version_used: int) -> int:
        """Apply one (possibly aggregated) update; returns new version.

        h <- u + gamma * h (f32); p <- p + h, summed in f32 and rounded to
        p's dtype."""
        self.delays.record(self.version - version_used)
        with region("mlfabric.update"):
            for p, h, u in zip(tree_leaves(self.params),
                               tree_leaves(self.history),
                               tree_leaves(update)):
                h.mul_(self.gamma).add_(u.to(torch.float32))
                p.add_(h)
        self.version += 1
        return self.version

    def history_norm(self) -> float:
        return float(torch.sqrt(sum(torch.sum(torch.square(h))
                                    for h in tree_leaves(self.history))))
