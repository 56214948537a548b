"""In-network aggregation (paper §5.2, Alg. 3).

Given the committed order O(U), partition updates into ``k+1`` groups:
group 0 streams directly to the server; each group ``i >= 1`` is summed at a
pre-assigned aggregator and only the aggregate travels to the server.  The
partition is chosen by exhaustively enumerating the ``|U|+1`` split points
``n`` (size of the direct group) and greedily growing aggregator groups under
the paper's *efficiency constraint*: aggregating all of group ``i`` must not
finish later than the time at which groups ``0..i-1`` have fully arrived at
the server — the server NIC is never left fallow.

The best pattern minimizes the makespan (time until the last aggregate
arrives at the server; the paper's Alg. 3 objective).  For asynchronous mode
the average commit time (eq. 17) is also reported.

Two planners produce *identical* plans (property-tested against each other):

* ``planner="exhaustive"`` — the literal Alg. 3: every case ``n`` replays
  the direct prefix from scratch on a fresh network copy (O(|U|) network
  reservations per case, O(|U|^2) overall).
* ``planner="incremental"`` (default) — dynamic clusters re-plan on every
  topology change, so planning is a hot path.  The direct-prefix
  reservations and arrival times are memoized across cases (case ``n+1``
  extends case ``n`` by one reservation), and two exact lower bounds prune
  the enumeration: the prefix arrival bound (any case with a direct prefix
  already arriving later than the best plan cannot win — both objectives),
  and, within a case, the efficiency-constraint running ``t_max`` (makespan
  objective).  Sub-quadratic in practice at N=64 (see
  ``benchmarks/run.py:bench_incremental_planner``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .network import NetworkState, Transfer
from .ordering import Update

DIRECT = 0  # aggregator id 0 == "forward straight to the server"


@dataclass
class AggGroup:
    """One group of the partition: its members and concrete transfers."""

    aggregator: Optional[str]          # None for the direct group
    members: List[Update] = field(default_factory=list)
    member_transfers: List[Transfer] = field(default_factory=list)
    aggregate_transfer: Optional[Transfer] = None  # aggregator -> server

    @property
    def t_commit(self) -> float:
        """Time the group's contribution is fully applied at the server."""
        if self.aggregate_transfer is not None:
            return self.aggregate_transfer.t_end
        if not self.member_transfers:
            return 0.0
        return max(t.t_end for t in self.member_transfers)


@dataclass
class AggregationResult:
    groups: List[AggGroup]
    assignment: Dict[int, int]          # update uid -> group index (0 = direct)
    makespan: float
    network: NetworkState
    # commit time of each update at the server (direct: its own transfer end;
    # aggregated: the group aggregate's arrival) keyed by uid:
    commit_times: Dict[int, float] = field(default_factory=dict)

    @property
    def avg_commit(self) -> float:
        if not self.commit_times:
            return 0.0
        return sum(self.commit_times.values()) / len(self.commit_times)

    @property
    def n_direct(self) -> int:
        return len(self.groups[0].members) if self.groups else 0


def _evaluate_case(n: int, order: Sequence[Update], network: NetworkState,
                   server: str, aggregators: Sequence[str],
                   t_now: float) -> Optional[AggregationResult]:
    """One case of Alg. 3: first ``n`` updates direct, rest greedily grouped."""
    nw = network.overlay()
    direct = AggGroup(aggregator=None)
    groups: List[AggGroup] = [direct]
    assignment: Dict[int, int] = {}
    commit_times: Dict[int, float] = {}

    # (1) first n updates straight to the server (Alg. 3 lines 3-7)
    t_max = t_now
    for g in order[:n]:
        tr = nw.reserve(g.worker, server, g.size, max(g.t_avail, t_now))
        direct.members.append(g)
        direct.member_transfers.append(tr)
        assignment[g.uid] = DIRECT
        commit_times[g.uid] = tr.t_end
        t_max = tr.t_end  # server is busy receiving until the last direct one

    # (2) greedily pack the remaining updates into aggregator groups
    aid = 0                      # index into `aggregators`
    current: Optional[AggGroup] = None

    def close_group(grp: AggGroup) -> float:
        """Reserve the aggregate->server transfer; return its arrival time."""
        agg_size = max(m.size for m in grp.members)  # sum keeps tensor size
        t_ready = max(t.t_end for t in grp.member_transfers)
        tr = nw.reserve(grp.aggregator, server, agg_size, t_ready)
        grp.aggregate_transfer = tr
        for m in grp.members:
            commit_times[m.uid] = tr.t_end
        return tr.t_end

    i = n
    while i < len(order):
        g = order[i]
        if current is None:
            if aid >= len(aggregators):
                return None  # out of aggregators -> case infeasible
            current = AggGroup(aggregator=aggregators[aid])
            groups.append(current)
            aid += 1
        t_en = nw.transfer_time(g.worker, current.aggregator, g.size,
                                max(g.t_avail, t_now))
        if current.members and t_en > t_max:
            # Efficiency constraint violated (Alg. 3 lines 10-15): close the
            # current group and retry this update with the next aggregator.
            t_max = close_group(current)
            current = None
            continue
        tr = nw.reserve(g.worker, current.aggregator, g.size,
                        max(g.t_avail, t_now))
        current.members.append(g)
        current.member_transfers.append(tr)
        assignment[g.uid] = len(groups) - 1
        i += 1

    if current is not None and current.members:
        t_max = close_group(current)

    makespan = max(commit_times.values(), default=t_now)
    return AggregationResult(groups=groups, assignment=assignment,
                             makespan=makespan, network=nw,
                             commit_times=commit_times)


def _evaluate_case_from_prefix(
        order: Sequence[Update], n: int, prefix_net: NetworkState,
        prefix_members: Sequence[Update], prefix_transfers: Sequence[Transfer],
        prefix_commits: Dict[int, float], t_last: float, server: str,
        aggregators: Sequence[str], t_now: float, *,
        bound: Optional[float] = None, objective: str = "makespan",
        suffix_lb: Optional[Sequence[float]] = None,
        prefix_sum: float = 0.0) -> Optional[AggregationResult]:
    """Case ``n`` of Alg. 3 given a memoized direct prefix.

    ``prefix_net`` already carries the first ``n`` direct reservations;
    ``t_last`` is the last direct transfer's arrival (the efficiency-
    constraint threshold).  ``bound`` abandons the case once a running
    lower bound on its objective proves it cannot strictly beat the
    incumbent — for makespan the running ``t_max`` / member arrivals, for
    avg_commit the committed sum plus open-member arrivals plus the
    ``suffix_lb`` solo bounds of unprocessed updates.  Both prune exactly
    the cases the exhaustive scan would reject anyway.
    """
    nw = prefix_net.overlay()
    direct = AggGroup(aggregator=None, members=list(prefix_members),
                      member_transfers=list(prefix_transfers))
    groups: List[AggGroup] = [direct]
    assignment: Dict[int, int] = {g.uid: DIRECT for g in direct.members}
    commit_times: Dict[int, float] = dict(prefix_commits)
    t_max = t_last
    n_total = len(order)
    sum_committed = prefix_sum   # commit times fixed so far (avg bound)
    open_arrivals = 0.0          # aggregator arrivals of the open group

    def close_group(grp: AggGroup) -> float:
        nonlocal sum_committed, open_arrivals
        agg_size = max(m.size for m in grp.members)  # sum keeps tensor size
        t_ready = max(t.t_end for t in grp.member_transfers)
        tr = nw.reserve(grp.aggregator, server, agg_size, t_ready)
        grp.aggregate_transfer = tr
        for m in grp.members:
            commit_times[m.uid] = tr.t_end
        sum_committed += tr.t_end * len(grp.members)
        open_arrivals = 0.0
        return tr.t_end

    aid = 0
    current: Optional[AggGroup] = None
    i = n
    while i < len(order):
        g = order[i]
        if current is None:
            if aid >= len(aggregators):
                return None  # out of aggregators -> case infeasible
            current = AggGroup(aggregator=aggregators[aid])
            groups.append(current)
            aid += 1
        # plan-then-commit: one profile computation per decision (the
        # exhaustive reference recomputes it in transfer_time + reserve)
        tr = nw.plan_transfer(g.worker, current.aggregator, g.size,
                              max(g.t_avail, t_now))
        t_en = tr.t_end if tr is not None else float("inf")
        if current.members and t_en > t_max:
            t_max = close_group(current)
            if bound is not None:
                if objective == "makespan":
                    if t_max >= bound - 1e-12:
                        return None  # makespan >= t_max: cannot beat it
                elif suffix_lb is not None:
                    lb = (sum_committed + suffix_lb[i]) / n_total
                    if lb >= bound - 1e-12:
                        return None
            current = None
            continue
        if tr is None:
            raise RuntimeError(f"transfer {g.worker}->{current.aggregator} "
                               f"of {g.size}B can never finish")
        if bound is not None and objective == "makespan" \
                and t_en >= bound - 1e-12:
            # accepted member commits no earlier than its aggregator
            # arrival -> makespan >= bound: cannot beat the incumbent
            return None
        nw.commit_transfer(tr)
        current.members.append(g)
        current.member_transfers.append(tr)
        assignment[g.uid] = len(groups) - 1
        open_arrivals += t_en
        i += 1
        if bound is not None and objective != "makespan" \
                and suffix_lb is not None:
            # open members commit no earlier than their arrivals; the rest
            # no earlier than their solo uplink bounds
            lb = (sum_committed + open_arrivals + suffix_lb[i]) / n_total
            if lb >= bound - 1e-12:
                return None

    if current is not None and current.members:
        t_max = close_group(current)

    makespan = max(commit_times.values(), default=t_now)
    return AggregationResult(groups=groups, assignment=assignment,
                             makespan=makespan, network=nw,
                             commit_times=commit_times)


def _aggregate_incremental(order: List[Update], network: NetworkState,
                           server: str, aggregators: Sequence[str],
                           t_now: float, objective: str) -> AggregationResult:
    """Incremental enumeration: memoized prefix + exact pruning bounds."""
    n_total = len(order)

    # Per-update lower bound on its commit time under ANY case: its own
    # bytes through its worker's uplink on the un-reserved input network
    # (every plan — direct or via an aggregator — must first push the
    # update off the worker; reservations only slow this down).
    suffix_lb = [0.0] * (n_total + 1)
    if objective != "makespan":
        for i in range(n_total - 1, -1, -1):
            g = order[i]
            t0 = max(g.t_avail, t_now)
            lb = (t0 if g.worker == server
                  else network.up[g.worker].time_to_consume(t0, g.size))
            suffix_lb[i] = suffix_lb[i + 1] + lb

    prefix_net = network.overlay()
    prefix_members: List[Update] = []
    prefix_transfers: List[Transfer] = []
    prefix_commits: Dict[int, float] = {}
    t_last = t_now          # last direct arrival (efficiency threshold)
    prefix_maxend = t_now   # max direct arrival (monotone lower bound)
    prefix_sum = 0.0

    best: Optional[AggregationResult] = None
    best_key = float("inf")
    for n in range(n_total + 1):
        if best is not None:
            # Prefix arrival bound: every case m >= n commits the first n
            # updates at exactly these (memoized) times, so its key is at
            # least ``lb`` — once that reaches the incumbent, stop.
            lb = (prefix_maxend if objective == "makespan"
                  else (prefix_sum + suffix_lb[n]) / n_total)
            if lb >= best_key - 1e-12:
                break
        bound = best_key if best is not None else None
        res = _evaluate_case_from_prefix(
            order, n, prefix_net, prefix_members, prefix_transfers,
            prefix_commits, t_last, server, aggregators, t_now, bound=bound,
            objective=objective, suffix_lb=suffix_lb, prefix_sum=prefix_sum)
        if res is not None:
            key = res.makespan if objective == "makespan" else res.avg_commit
            if key < best_key - 1e-12:
                best, best_key = res, key
        if n < n_total:  # extend the memoized prefix by one reservation
            g = order[n]
            tr = prefix_net.reserve(g.worker, server, g.size,
                                    max(g.t_avail, t_now))
            prefix_members.append(g)
            prefix_transfers.append(tr)
            prefix_commits[g.uid] = tr.t_end
            t_last = tr.t_end
            prefix_maxend = max(prefix_maxend, tr.t_end)
            prefix_sum += tr.t_end
    assert best is not None, "n == |U| (all-direct) is always feasible"
    # The winner's overlay chains through the memoized prefix, which the
    # loop kept mutating after the case was evaluated — rebuild the plan's
    # network against the pristine input by replaying its own transfers
    # (O(batch) commits, independent of fleet size).  Plan content
    # (groups / assignment / commit times) is untouched.
    final = network.overlay()
    for grp in best.groups:
        for tr in grp.member_transfers:
            final.commit_transfer(tr)
        if grp.aggregate_transfer is not None:
            final.commit_transfer(grp.aggregate_transfer)
    best.network = final
    return best


def aggregate_updates(order: Sequence[Update], network: NetworkState,
                      server: str, aggregators: Sequence[str], *,
                      t_now: float = 0.0, objective: str = "makespan",
                      planner: str = "incremental") -> AggregationResult:
    """Alg. 3: enumerate the ``|U|+1`` direct-group sizes, keep the best.

    ``objective``: ``"makespan"`` (sync, eq. 16) or ``"avg_commit"`` (async,
    eq. 17).  ``planner``: ``"incremental"`` (default; memoized prefix +
    pruning, same plan) or ``"exhaustive"`` (the literal Alg. 3 reference).
    The input ``network`` is *not* mutated; the chosen case's reservations
    live in the copy-on-write overlay returned in the result.
    """
    order = list(order)
    if not order:
        return AggregationResult(groups=[AggGroup(aggregator=None)], assignment={},
                                 makespan=t_now, network=network.overlay())
    if planner == "incremental":
        return _aggregate_incremental(order, network, server, aggregators,
                                      t_now, objective)
    if planner != "exhaustive":
        raise ValueError(f"unknown planner {planner!r}")
    best: Optional[AggregationResult] = None
    for n in range(len(order) + 1):
        res = _evaluate_case(n, order, network, server, aggregators, t_now)
        if res is None:
            continue
        key = res.makespan if objective == "makespan" else res.avg_commit
        best_key = (best.makespan if objective == "makespan" else best.avg_commit) \
            if best is not None else float("inf")
        if key < best_key - 1e-12:
            best = res
    assert best is not None, "n == |U| (all-direct) is always feasible"
    return best


def plan_distribution(model_size: float, requesters: Sequence[str],
                      network: NetworkState, server: str,
                      distributors: Sequence[str], *,
                      t_now: float = 0.0) -> Dict[str, float]:
    """Model distribution tree (paper §10.3).

    Batched pull requests are served with the same model version through
    ``k`` distributors, mirroring Alg. 3 with transfer times replaced by
    server->distributor and distributor->worker times.  The server sends the
    model to the *last* distributor first and proceeds backwards, while the
    first group of workers reads directly from the server.

    Returns the time each requester receives the model.
    """
    recv_time: Dict[str, float] = {}
    best: Optional[Dict[str, float]] = None
    for n in range(len(requesters) + 1):
        nw = network.overlay()
        times: Dict[str, float] = {}
        t_max = t_now
        feasible = True
        # direct group
        for w in requesters[:n]:
            tr = nw.reserve(server, w, model_size, t_now)
            times[w] = tr.t_end
            t_max = tr.t_end
        # distributor groups (greedy, same efficiency constraint)
        rest = list(requesters[n:])
        aid = 0
        while rest:
            if aid >= len(distributors):
                feasible = False
                break
            dist = distributors[aid]
            d_tr = nw.reserve(server, dist, model_size, t_now)
            group: List[str] = []
            while rest:
                w = rest[0]
                t_en = nw.transfer_time(dist, w, model_size, d_tr.t_end)
                if group and t_en > t_max:
                    break
                tr = nw.reserve(dist, w, model_size, d_tr.t_end)
                times[w] = tr.t_end
                group.append(w)
                rest.pop(0)
            if group:
                t_max = max(t_max, max(times[w] for w in group))
            aid += 1
        if not feasible:
            continue
        makespan = max(times.values(), default=t_now)
        if best is None or makespan < max(best.values(), default=float("inf")):
            best = times
    assert best is not None
    return best
