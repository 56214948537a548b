"""Event-driven plan repair (ROADMAP item 2; paper §7 dynamic clusters).

Per-batch replanning is the control-plane hot path: in a dynamic cluster
every ``WorkerJoin`` / ``WorkerLeave`` / ``BandwidthTrace`` used to trigger a
full Alg. 3 re-run even when the event could not possibly change the plan.
At U=4096 hosts almost no event touches the handful of hosts a given batch
actually reads, so repair is a footprint check, not a replan:

* **Tier 1 — footprint check, O(|changes|).**  Alg. 3's decision process
  reads exactly the uplinks of the batch's member workers, the links of the
  aggregator roster, and the server downlink (:func:`plan_footprint`).  An
  event whose hosts are disjoint from that set cannot alter any profile the
  planner computed, so the previous plan *is* the full replan — identity by
  planner determinism, property-tested in ``tests/test_repair.py``.  All of
  the batch plan's reservations are kept intact.

* **Tier 2 — scoped replan.**  An event inside the footprint (a member
  departed, an aggregator's NIC changed, a roster change) re-runs Alg. 3 on
  the surviving order against the *post-event* network.  Reservations at
  this tier live in copy-on-write overlays (``NetworkState.overlay``), so
  "releasing" the stale plan is dropping its overlay — no per-transfer
  subtraction, no phantom bandwidth.

Both tiers return a plan identical to a from-scratch replan of the
surviving updates on the current network — tier 2 trivially (it *is* one),
tier 1 by the footprint argument.  That identity is the repair invariant
everything downstream (enactment, replication planning) relies on.

``ClusterSim(plan_repair=True)`` wires the same idea into *enacted* plans:
an ``AggregatorFail``/``WorkerLeave`` mid-flight re-plans only the affected
groups' surviving members immediately on the actual network (which still
carries every unaffected reservation), instead of parking them in the
pending pool until the next batch tick.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import AbstractSet, FrozenSet, List, Optional, Sequence

from .aggregation import AggregationResult, aggregate_updates
from .network import NetworkState
from .ordering import Update


def plan_footprint(order: Sequence[Update], server: str,
                   aggregators: Sequence[str]) -> FrozenSet[str]:
    """Hosts whose links Alg. 3 reads when planning ``order``.

    Conservative and cheap: every member worker (uplink), every aggregator
    in the roster (probed for the efficiency constraint even when unused in
    the winning case), and the server (downlink).  Any event outside this
    set cannot change a single profile the planner computes.
    """
    fp = {u.worker for u in order}
    fp.update(aggregators)
    fp.add(server)
    return frozenset(fp)


@dataclass
class RepairResult:
    """Outcome of one repair: the (possibly unchanged) plan + accounting."""

    plan: AggregationResult
    replanned: bool                 # tier 2 taken?
    dropped_uids: List[int]         # departed members removed from the plan
    footprint_size: int

    @property
    def kept(self) -> bool:
        return not self.replanned


def repair_aggregation(prev: AggregationResult, order: Sequence[Update],
                       network: NetworkState, server: str,
                       aggregators: Sequence[str], *, t_now: float = 0.0,
                       objective: str = "makespan",
                       changed: AbstractSet[str] = frozenset(),
                       departed: AbstractSet[str] = frozenset(),
                       prev_aggregators: Optional[Sequence[str]] = None,
                       planner: str = "incremental") -> RepairResult:
    """Repair ``prev`` (planned for ``order``) after a topology/rate event.

    ``changed`` — hosts whose NIC rates changed (``BandwidthTrace``, churn)
    or that joined the roster; ``departed`` — hosts that left the cluster;
    ``prev_aggregators`` — the roster ``prev`` was planned with, when it
    differs from ``aggregators`` (a roster change is a plan input change,
    so any symmetric difference forces a replan even when the host in
    question appears in neither the order nor the new roster).  ``network``
    is the *post-event* scheduler view.  Returns a plan guaranteed
    identical to ``aggregate_updates`` run from scratch on the surviving
    order against ``network``.
    """
    old_roster = aggregators if prev_aggregators is None else prev_aggregators
    fp = plan_footprint(order, server, aggregators) \
        | frozenset(old_roster)
    relevant = ((set(changed) | set(departed)) & fp) \
        | (set(old_roster) ^ set(aggregators))
    if not relevant:
        # Tier 1: the event is invisible to every profile this plan was
        # built from — the previous plan IS the full replan.
        return RepairResult(plan=prev, replanned=False, dropped_uids=[],
                            footprint_size=len(fp))

    # Tier 2: departed members' updates are gone with their worker; replan
    # the survivors from the batch's base view.  The stale plan's
    # reservations live in its overlay, which is simply dropped.
    surviving = [u for u in order if u.worker not in departed]
    dropped = [u.uid for u in order if u.worker in departed]
    live_aggs = [a for a in aggregators if a not in departed]
    plan = aggregate_updates(surviving, network, server, live_aggs,
                             t_now=t_now, objective=objective,
                             planner=planner)
    return RepairResult(plan=plan, replanned=True, dropped_uids=dropped,
                        footprint_size=len(fp))
