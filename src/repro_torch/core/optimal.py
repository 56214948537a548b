"""Brute-force reference for the joint scheduling ILP (paper §10.1).

The paper formulates a joint ILP over transfer rates ``r_g(t)``, destinations
``dst(g)`` and orderings, and notes it is intractable; MLfabric decomposes it
into the three heuristics of §5.  For *tiny* instances we can recover the
exact optimum by exhaustive enumeration over (a) permutations of the update
order and (b) aggregator assignments, evaluating each candidate with the
same maximal-rate reservation semantics.  Tests use this to check that the
heuristic stack stays within a small factor of optimal.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .aggregation import aggregate_updates
from .network import NetworkState
from .ordering import Update


@dataclass
class OptimalResult:
    order: Tuple[int, ...]           # uids in transfer order
    assignment: Dict[int, int]       # uid -> group (0 = direct)
    makespan: float
    avg_commit: float


def _respects_deadlines(perm: Sequence[Update]) -> bool:
    return all(g.deadline is None or g.deadline >= i + 1
               for i, g in enumerate(perm))


def brute_force_schedule(updates: Sequence[Update], network: NetworkState,
                         server: str, aggregators: Sequence[str], *,
                         objective: str = "avg_commit",
                         t_now: float = 0.0,
                         max_updates: int = 6) -> OptimalResult:
    """Exact optimum over order permutations x Alg.3 group splits.

    Only feasible for ``len(updates) <= max_updates`` (factorial blow-up);
    raises otherwise.  Aggregator grouping is delegated to the same
    exhaustive split enumeration as Alg. 3 (which *is* exhaustive over
    contiguous partitions once the order is fixed).
    """
    if len(updates) > max_updates:
        raise ValueError(f"brute force limited to {max_updates} updates")

    best: Optional[OptimalResult] = None
    for perm in itertools.permutations(updates):
        if not _respects_deadlines(perm):
            continue
        res = aggregate_updates(list(perm), network, server, aggregators,
                                t_now=t_now, objective=objective)
        key = res.avg_commit if objective == "avg_commit" else res.makespan
        best_key = (best.avg_commit if objective == "avg_commit"
                    else best.makespan) if best else float("inf")
        if key < best_key - 1e-12:
            best = OptimalResult(order=tuple(g.uid for g in perm),
                                 assignment=dict(res.assignment),
                                 makespan=res.makespan,
                                 avg_commit=res.avg_commit)
    if best is None:
        raise RuntimeError("no deadline-feasible permutation exists")
    return best
