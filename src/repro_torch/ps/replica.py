"""Replica server: applies the same updates in the same order (§3.3).

The replica trails the primary by the punted updates; the divergence between
the two is exactly what ``repro_torch/core/replication.py`` bounds.  On
primary failure, the replica's model + the regenerate-list realize the
paper's recovery ("lost work ... recovered by generating fresh worker
updates using the latest model at the replica").
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from ..tree import tree_leaves
from .server import ParameterServer

Params = Any


class ReplicaServer(ParameterServer):
    def __init__(self, params: Params, *, gamma: float = 0.9):
        super().__init__(params, gamma=gamma)
        self.applied_uids: List[int] = []

    def apply_replicated(self, update: Params, version_used: int,
                         uid: int) -> None:
        self.push(update, version_used)
        self.applied_uids.append(uid)

    def exact_divergence(self, primary: ParameterServer) -> float:
        """||w_s - w_r||_2 — exact, for tests (the scheduler only ever uses
        the norm-based upper bound)."""
        sq = sum(torch.sum(torch.square(ps.to(torch.float32)
                                        - pr.to(torch.float32)))
                 for ps, pr in zip(tree_leaves(primary.params),
                                   tree_leaves(self.params)))
        return float(torch.sqrt(sq))


def promote_replica(replica: Any) -> Tuple[Params, int, int]:
    """Unified §3.3 promotion across both replica flavors.

    * ``ReplicaServer`` (real-tensor PS data plane): the replica has
      applied an exact prefix of the server's updates — its params/version
      become the primary's, and the lead (updates it never saw) is
      regenerated by the *simulator*'s bookkeeping, so the lost count here
      is 0.
    * ``BoundedDivergenceReplica`` (``repro_torch.checkpoint``, used by
      ``ElasticSession``): ``recover()`` reports how many offered updates
      the replica snapshot trails by — the caller's regenerate-list.

    Returns ``(params, version_or_step, n_lost_updates_to_regenerate)``.
    """
    if isinstance(replica, ReplicaServer):
        return replica.params, replica.version, 0
    params, step, lost = replica.recover()   # BoundedDivergenceReplica
    return params, step, lost
