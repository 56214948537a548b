"""Update ordering (paper §5.1, Algs. 1-2).

Given a batch of ready gradient updates and the current network state, decide
the order in which they are transferred to the (single) server so that

  1. average transfer-completion time is minimized (shortest-transfer-first,
     §5.1.1) — fast model-update rate, fresher models earlier;
  2. per-update delay bounds hold, via deadlines ``dl(g) = v(g) + tau_max -
     v_init`` (eq. 9, §5.1.2);
  3. no network/server resource is left fallow: a deadline pick whose
     transfer would outlast the *next* pick is dropped at the worker
     (look-ahead drop rule, §5.1.3 / Alg. 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .network import NetworkState, Transfer


@dataclass
class Update:
    """A ready gradient update pending transfer to the server.

    ``version`` is the model version it was computed from; ``norm`` is
    ``||u||_2`` shipped with the push() call (Table 1) — used by replication.
    """

    uid: int
    worker: str
    size: float
    version: int
    norm: float = 0.0
    t_avail: float = 0.0
    # filled in by the scheduler:
    deadline: Optional[int] = None

    def __hash__(self) -> int:
        return hash(self.uid)


@dataclass
class OrderingResult:
    order: List[Update]                      # committed transfer/apply order
    dropped: List[Update]                    # discarded at the worker (§5.1.3)
    transfers: Dict[int, Transfer]           # uid -> reserved transfer
    network: NetworkState                    # state after all reservations

    @property
    def makespan(self) -> float:
        if not self.transfers:
            return 0.0
        return max(t.t_end for t in self.transfers.values())

    @property
    def avg_completion(self) -> float:
        if not self.transfers:
            return 0.0
        return sum(t.t_end for t in self.transfers.values()) / len(self.transfers)


def assign_deadlines(updates: Sequence[Update], tau_max: int, v_init: int) -> None:
    """Eq. 9: ``dl(g) = v(g) + tau_max - v_init`` (1-indexed apply position)."""
    for g in updates:
        g.deadline = g.version + tau_max - v_init


def shortest_update(candidates: Sequence[Update], network: NetworkState,
                    server: str, t_now: float) -> Tuple[Optional[Update], float]:
    """Alg. 1 inner step: the candidate with least completion time ``t_en``."""
    best, best_t = None, float("inf")
    for g in candidates:
        t_en = network.transfer_time(g.worker, server, g.size,
                                     max(g.t_avail, t_now))
        if t_en < best_t:
            best, best_t = g, t_en
    return best, best_t


def _pick(iteration: int, candidates: Sequence[Update], network: NetworkState,
          server: str, t_now: float) -> Tuple[Optional[Update], float, bool]:
    """``ShrtDline`` (Alg. 2): deadline-due update if one exists, else SJF.

    Returns ``(update, t_en, was_deadline_pick)``.
    """
    due = [g for g in candidates if g.deadline is not None and g.deadline <= iteration]
    if due:
        # Most urgent first; ties broken by shortest transfer.
        g = min(due, key=lambda g: (g.deadline,
                                    network.transfer_time(g.worker, server, g.size,
                                                          max(g.t_avail, t_now))))
        t_en = network.transfer_time(g.worker, server, g.size, max(g.t_avail, t_now))
        return g, t_en, True
    g, t_en = shortest_update(candidates, network, server, t_now)
    return g, t_en, False


def order_updates(updates: Sequence[Update], network: NetworkState, server: str,
                  *, tau_max: Optional[int] = None, v_init: int = 0,
                  t_now: float = 0.0, reserve: bool = True) -> OrderingResult:
    """Alg. 2: final update ordering with deadlines and the drop rule.

    ``network`` is mutated with reservations when ``reserve`` is True
    (callers that only want the order should pass a copy).
    """
    if tau_max is not None:
        assign_deadlines(updates, tau_max, v_init)

    nw = network if reserve else network.overlay()
    pending: List[Update] = list(updates)
    order: List[Update] = []
    dropped: List[Update] = []
    transfers: Dict[int, Transfer] = {}

    iteration = 0
    while pending:
        iteration += 1
        # An update whose deadline already passed can no longer meet its
        # delay bound at any position -> discard it at the worker (§3.1.1
        # "no update with delay > tau_max should be applied to the model").
        expired = [g for g in pending
                   if g.deadline is not None and g.deadline < iteration]
        for g in expired:
            pending.remove(g)
            dropped.append(g)
        if not pending:
            break

        g_star, t_star, was_deadline = _pick(iteration, pending, nw, server, t_now)
        if g_star is None:
            break
        pending.remove(g_star)

        if was_deadline and pending:
            # Look-ahead (§5.1.3): if the next pick would complete before the
            # current deadline-pick even after reserving its bandwidth, the
            # deadline pick would leave the server idle -> drop it now.
            look = nw.overlay()
            look.reserve(g_star.worker, server, g_star.size,
                         max(g_star.t_avail, t_now))
            g_next, t_next, _ = _pick(iteration + 1, pending, look, server, t_now)
            if g_next is not None and t_star > t_next:
                dropped.append(g_star)
                iteration -= 1  # position was not consumed
                continue

        transfers[g_star.uid] = nw.reserve(g_star.worker, server, g_star.size,
                                           max(g_star.t_avail, t_now))
        order.append(g_star)

    return OrderingResult(order=order, dropped=dropped, transfers=transfers,
                          network=nw)


def order_updates_multiserver(
        updates: Sequence[Update], component_sizes: Dict[str, float],
        network: NetworkState, servers: Sequence[str], *,
        tau_max: Optional[int] = None, v_init: int = 0, t_now: float = 0.0,
) -> OrderingResult:
    """§10.2: model sharded over multiple servers.

    Every update ``g`` has one component per server (all the same version /
    deadline).  Network resources for *all* components are reserved together
    and ``t_en(g) = max_j t_en(g^j)`` (eq. 18) so every model shard is
    updated at a uniform rate.
    """
    if tau_max is not None:
        assign_deadlines(updates, tau_max, v_init)

    nw = network
    pending: List[Update] = list(updates)
    order: List[Update] = []
    transfers: Dict[int, Transfer] = {}
    uid_gen = iter(range(10 ** 9, 2 * 10 ** 9))

    def joint_t_en(g: Update, net: NetworkState) -> float:
        return max(net.transfer_time(g.worker, s, component_sizes[s],
                                     max(g.t_avail, t_now)) for s in servers)

    iteration = 0
    while pending:
        iteration += 1
        due = [g for g in pending if g.deadline is not None and g.deadline <= iteration]
        pool = due if due else pending
        g_star = min(pool, key=lambda g: joint_t_en(g, nw))
        pending.remove(g_star)
        for s in servers:
            tr = nw.reserve(g_star.worker, s, component_sizes[s],
                            max(g_star.t_avail, t_now))
            transfers[next(uid_gen)] = tr
        order.append(g_star)

    return OrderingResult(order=order, dropped=[], transfers=transfers, network=nw)
