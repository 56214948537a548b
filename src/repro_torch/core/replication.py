"""Bounded-consistency replication (paper §3.3, §5.3).

Workers forward a copy of each update to the replica; MLfabric schedules
these copies opportunistically on *spare* capacity (the network state already
carries the primary-server reservations), in the *same order* as the server,
and guarantees the server/replica model divergence stays below ``Div_max``.

Divergence is never computed on the actual tensors — it is upper-bounded
from the *norms* the workers ship with ``push()`` (Table 1), using the
momentum recursion of eq. 2:

    apply(u):  w' = w + u + gamma*h ;   h' = u + gamma*h

If the server has applied ``j`` updates ``u_1..u_j`` that the replica has
not, then (generalizing eq. 7):

    w_s - w_r = (sum_{t=1..j} gamma^t) h0  +  sum_i (sum_{t=0..j-i} gamma^t) u_i

and the triangle inequality gives the computable bound used here (the square
of the paper's Cauchy-Schwarz form, eqs. 10-11).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .aggregation import AggregationResult, aggregate_updates
from .network import NetworkState, Transfer
from .ordering import Update


def _geom(gamma: float, n: int) -> float:
    """``sum_{t=0..n-1} gamma^t`` (n terms)."""
    if n <= 0:
        return 0.0
    if abs(1.0 - gamma) < 1e-12:
        return float(n)
    return (1.0 - gamma ** n) / (1.0 - gamma)


def divergence_bound(h_norm: float, pending_norms: Sequence[float],
                     gamma: float) -> float:
    """Upper bound on ``||w_s - w_r||`` when the server leads the replica by
    the updates whose norms are ``pending_norms`` (oldest first)."""
    j = len(pending_norms)
    if j == 0:
        return 0.0
    bound = gamma * _geom(gamma, j) * h_norm     # (gamma + ... + gamma^j) h0
    for i, n in enumerate(pending_norms, start=1):
        bound += _geom(gamma, j - i + 1) * n     # (1 + ... + gamma^{j-i}) u_i
    return bound


@dataclass
class ReplicationState:
    """Carries divergence bookkeeping across scheduler batches.

    ``h_norm_ub`` is a running upper bound on ``||h||`` (momentum history) at
    the *replica's* commit frontier; ``punted`` are updates already committed
    at the server whose replica copies were deferred to a later batch.
    """

    gamma: float
    div_max: float
    h_norm_ub: float = 0.0
    punted: List[Update] = field(default_factory=list)

    def advance_history(self, norms: Sequence[float]) -> None:
        """Fold replica-committed update norms into the history bound."""
        for n in norms:
            self.h_norm_ub = self.gamma * self.h_norm_ub + n

    def divergence(self, extra_pending: Sequence[Update] = ()) -> float:
        pending = [u.norm for u in self.punted] + [u.norm for u in extra_pending]
        return divergence_bound(self.h_norm_ub, pending, self.gamma)


@dataclass
class ReplicationResult:
    frozen: List[Update]                 # replica transfers committed this batch
    punted: List[Update]                 # deferred to the next batch
    replica_plan: Optional[AggregationResult]
    delayed_server_uids: List[int]       # server commits delayed for lead-reduction
    divergence_after: float
    network: NetworkState


def plan_replication(order: Sequence[Update],
                     server_commit_times: Dict[int, float],
                     network: NetworkState, replica: str,
                     replica_aggregators: Sequence[str],
                     state: ReplicationState, *,
                     t_now: float = 0.0) -> ReplicationResult:
    """§5.3: schedule replica copies on spare capacity; bound divergence.

    ``network`` must already include the primary-server reservations (it is
    the ``AggregationResult.network`` of the tentative server plan); it is
    mutated with the frozen replica reservations.

    Lead-reduction is realized by *delaying the commit* of the last server
    update(s) until enough replica commits have landed — the server-side
    transfer schedule is untouched (the transfer may complete, but the apply
    is held), which matches the paper's "delay just the last update in the
    tentative server schedule" without re-planning the whole batch.
    """
    order = list(order)
    # Replica sees: previously punted updates first, then this batch (same
    # order as the server, §5.3 "same order as O(U)").
    replica_queue: List[Update] = list(state.punted) + order

    if not replica_queue:
        return ReplicationResult([], [], None, [], state.divergence(), network)

    plan = aggregate_updates(replica_queue, network, replica,
                             replica_aggregators, t_now=t_now,
                             objective="makespan")

    t_last = max(server_commit_times.values()) if server_commit_times else t_now

    # Longest prefix of the replica queue fully committed by a given time.
    def prefix_at(t: float) -> int:
        n = 0
        for u in replica_queue:
            if plan.commit_times[u.uid] <= t + 1e-9:
                n += 1
            else:
                break
        return n

    n_frozen = prefix_at(t_last)
    # Updates the server will have applied by its last commit = punted backlog
    # + the whole batch; replica will have applied the frozen prefix.  The
    # history term must be evaluated AT the replica's post-freeze frontier
    # (fold the frozen norms in first) so that ``divergence_after`` equals
    # what ``state.divergence()`` reports once the batch's bookkeeping is
    # advanced — the two are the same quantity at the same frontier.
    h_ub = state.h_norm_ub
    for u in replica_queue[:n_frozen]:
        h_ub = state.gamma * h_ub + u.norm
    pending_after = replica_queue[n_frozen:]
    div = divergence_bound(h_ub, [u.norm for u in pending_after], state.gamma)

    # Lead reduction: hold the last server commits until more replica commits
    # land, extending the frozen prefix until the bound is met.  Every
    # extension step past ``n_frozen`` forces one more replica commit before
    # the server's tail may apply, so one more server commit (from the END
    # of the tentative order) is delayed — the delayed set must GROW with
    # the extension, not stay pinned at the single last commit.  Only this
    # batch's ``order`` can still be held (the punted backlog is already
    # applied at the server), so the delay count saturates at ``len(order)``.
    extend = n_frozen
    while div > state.div_max and extend < len(replica_queue):
        h_ub = state.gamma * h_ub + replica_queue[extend].norm
        extend += 1
        pending_after = replica_queue[extend:]
        div = divergence_bound(h_ub, [u.norm for u in pending_after],
                               state.gamma)
    k_delayed = min(extend - n_frozen, len(order))
    delayed = [u.uid for u in order[len(order) - k_delayed:]] if k_delayed \
        else []
    n_frozen = extend

    frozen = replica_queue[:n_frozen]
    punted = replica_queue[n_frozen:]

    # Book-keeping for the next batch.
    state.advance_history([u.norm for u in frozen])
    state.punted = punted

    return ReplicationResult(frozen=frozen, punted=punted, replica_plan=plan,
                             delayed_server_uids=delayed,
                             divergence_after=div, network=plan.network)
