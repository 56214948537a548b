"""Pluggable aggregation backends: host, switch, and hierarchical.

MLfabric's premise is that the communication library should choose the
aggregation pattern *holistically* — yet until this module existed the
strategy was hard-wired: Alg. 3's greedy host-aggregator packing lived in
``aggregation.py`` and everything else (scheduler, repair, ClusterSim)
called it directly.  ``AggregationBackend`` is the seam: a backend
*proposes groups*, *reserves transfers* on the (possibly lagged) network
view, *accounts wire bytes*, and tells the simulator how to handle member
and aggregator failure.  Three implementations ship:

``host``
    The pre-existing path, verbatim: :func:`~.aggregation.aggregate_updates`
    (Alg. 3 greedy packing under the efficiency constraint).  Plans are
    byte-identical to calling ``aggregate_updates`` directly — the golden
    traces pin this.

``switch``
    SwitchML-style in-network aggregation ("Scaling Distributed Machine
    Learning with In-Network Aggregation", PAPERS.md): each pod owns a
    programmable switch (host ``switch{p}``) that sums *fixed-point*
    gradients in a small streaming pool of slots.  Workers stream int8
    blocks (a ``wire_factor`` fraction of the f32 update: int8 payload
    plus one f32 scale per 256-float block), a worker's window of blocks
    occupies a slot until the pod's sum for that window drains upstream,
    and pool exhaustion spills the update to the host path.  The pod sum
    drains directly to the server.

``hierarchical``
    Switch aggregation intra-pod, MLfabric host aggregation inter-pod:
    each pod's drain becomes a *pseudo-update* sourced at the switch, and
    the host tier (``aggregate_updates``) plans those pseudo-updates plus
    any spilled updates through the ordinary aggregator roster.

The switch fluid model (DESIGN.md §13): with member receive curves
``recv_m(t)`` (wire bytes delivered to the switch) and drain curve
``dr(t)``, a window ``w`` can only leave its slot once *every* member has
delivered window ``w`` and the summed window has drained, so

    occupied(t) = ceil( (max_m recv_m(t) - drained(t)) / slot_bytes )
    drained(t)  = min( dr(t), min over incomplete members of recv_m(t) )

All curves are piecewise linear, so the maximum occupancy is attained at
a profile breakpoint — admission evaluates it there and rejects (spills)
any member that would push the peak past ``pool_slots``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .aggregation import AggGroup, AggregationResult, aggregate_updates
from .network import NetworkState, Profile, Transfer
from .ordering import Update

__all__ = [
    "AggregationBackend", "HostBackend", "SwitchBackend", "SwitchConfig",
    "SwitchGroupPlan", "SwitchPlanResult", "make_backend",
    "profile_bytes_by", "profile_time_to",
]

# int8 payload + one f32 scale per 256-float block, relative to f32 wire
# size: (256*1 + 4) / (256*4).  Matches the quantize/dequant_aggregate
# kernel wire format (kernels/quantize.py, block=256).
INT8_WIRE_FACTOR = (256 * 1 + 4) / (256 * 4)


# --------------------------------------------------------------------------- #
#  profile helpers (fluid-model bookkeeping)
# --------------------------------------------------------------------------- #

def profile_bytes_by(profile: Profile, t: float) -> float:
    """Bytes delivered by ``t`` on a piecewise-constant-rate profile."""
    total = 0.0
    for t0, t1, r in profile.chunks:
        if t <= t0:
            break
        total += r * (min(t, t1) - t0)
    return total


def profile_time_to(profile: Profile, nbytes: float) -> float:
    """Earliest time at which ``nbytes`` have been delivered."""
    if nbytes <= 0:
        return profile.t_start
    remaining = nbytes
    for t0, t1, r in profile.chunks:
        cap = r * (t1 - t0)
        if cap >= remaining and r > 0:
            return t0 + remaining / r
        remaining -= cap
    return profile.t_end


# --------------------------------------------------------------------------- #
#  configuration
# --------------------------------------------------------------------------- #

@dataclass
class SwitchConfig:
    """Topology + capacity of the per-pod aggregation switches.

    ``pod_size`` workers share one switch host (``switch{p}`` for pod
    ``p = worker_index // pod_size``).  The switch holds at most
    ``pool_slots`` in-flight windows of ``slot_bytes`` wire bytes each —
    SwitchML's "limited memory, fixed-point only" constraint.
    """

    pod_size: int = 8
    pool_slots: int = 8
    slot_bytes: float = 4e6          # wire bytes per slot window
    wire_factor: float = INT8_WIRE_FACTOR
    switch_bw: Optional[float] = None  # None -> the network's default_bw

    def pod_of(self, host: str) -> Optional[int]:
        """Pod index of a worker host, ``None`` for non-pod hosts."""
        if host.startswith("worker"):
            try:
                return int(host[len("worker"):]) // self.pod_size
            except ValueError:
                return None
        return None

    def switch_host(self, pod: int) -> str:
        return f"switch{pod}"


# --------------------------------------------------------------------------- #
#  plan structures
# --------------------------------------------------------------------------- #

@dataclass
class SwitchGroupPlan:
    """One pod's switch aggregation: members stream int8 windows in,
    the pod sum drains upstream once the first window is complete."""

    switch: str
    pod: int
    members: List[Update] = field(default_factory=list)
    member_transfers: List[Transfer] = field(default_factory=list)
    wire_sizes: Dict[int, float] = field(default_factory=dict)
    drain_transfer: Optional[Transfer] = None
    drain_dst: str = ""
    drain_size: float = 0.0
    t_first_window: float = 0.0     # earliest drain start (first window done)
    t_ready: float = 0.0            # all member streams finished
    max_occupancy: int = 0          # peak slots held (<= pool_slots)
    pseudo_uid: Optional[int] = None  # hierarchical: host-tier pseudo update


@dataclass
class SwitchPlanResult(AggregationResult):
    """An :class:`AggregationResult` plus the switch-tier structure.

    ``groups`` / ``assignment`` / ``commit_times`` present the combined
    view over *real* uids (switch groups appear as :class:`AggGroup`
    entries whose aggregator is the switch host); the extra fields below
    carry what the simulator needs to enact the two-tier plan.
    """

    switch_groups: List[SwitchGroupPlan] = field(default_factory=list)
    host_plan: Optional[AggregationResult] = None
    pseudo_members: Dict[int, SwitchGroupPlan] = field(default_factory=dict)
    spilled_uids: frozenset = frozenset()
    spill_count: int = 0
    occupancy_peak: int = 0
    # uid -> why it took the host path ("no-switch" | "unreachable" |
    # "pool-exhausted"); feeds the attribution engine's causal span args
    spill_reasons: Dict[int, str] = field(default_factory=dict)


# --------------------------------------------------------------------------- #
#  backends
# --------------------------------------------------------------------------- #

class AggregationBackend:
    """Protocol for aggregation strategies.

    ``plan`` proposes groups and reserves their transfers on an overlay of
    ``network``; ``wire_size`` is the bytes a member transfer actually
    carries (the simulator uses it for byte accounting and refunds on
    member failure); ``dead_switches`` is shared mutable state the
    simulator updates on ``SwitchFail`` so replans route around lost
    switch capacity (aggregator failure on the *host* tier is handled by
    the roster, exactly as before).
    """

    name = "abstract"

    def __init__(self) -> None:
        self.dead_switches: set = set()

    def plan(self, order: Sequence[Update], network: NetworkState,
             server: str, aggregators: Sequence[str], *, t_now: float = 0.0,
             objective: str = "makespan",
             planner: str = "incremental") -> AggregationResult:
        raise NotImplementedError

    def wire_size(self, update: Update) -> float:
        """Wire bytes of a member transfer for ``update``."""
        return update.size

    def switch_hosts(self, workers: Sequence[str]) -> List[str]:
        """Switch hosts this backend needs in the network (host tier: none)."""
        return []


class HostBackend(AggregationBackend):
    """The pre-refactor path: Alg. 3 greedy host-aggregator packing.

    ``plan`` delegates verbatim to :func:`aggregate_updates` — same
    arguments, same overlay semantics, same result object — so plans (and
    therefore the golden traces) are byte-identical to the direct call.
    """

    name = "host"

    def plan(self, order, network, server, aggregators, *, t_now=0.0,
             objective="makespan", planner="incremental"):
        return aggregate_updates(order, network, server, aggregators,
                                 t_now=t_now, objective=objective,
                                 planner=planner)


class SwitchBackend(AggregationBackend):
    """SwitchML-style per-pod switch aggregation (optionally hierarchical).

    Pure switch mode drains each pod sum directly to the server; with
    ``hierarchical=True`` the pod sums become pseudo-updates planned
    through the MLfabric host tier instead.  Updates from hosts with no
    (live) switch, and updates the slot pool cannot admit, spill to the
    host path in both modes.
    """

    def __init__(self, config: Optional[SwitchConfig] = None, *,
                 hierarchical: bool = False) -> None:
        super().__init__()
        self.config = config or SwitchConfig()
        self.hierarchical = hierarchical
        self.name = "hierarchical" if hierarchical else "switch"

    # -- topology ---------------------------------------------------------- #
    def switch_hosts(self, workers: Sequence[str]) -> List[str]:
        pods = sorted({p for p in map(self.config.pod_of, workers)
                       if p is not None})
        return [self.config.switch_host(p) for p in pods]

    def _live_switch(self, worker: str, network: NetworkState) -> Optional[str]:
        pod = self.config.pod_of(worker)
        if pod is None:
            return None
        sw = self.config.switch_host(pod)
        if sw in self.dead_switches or sw not in network.up:
            return None
        return sw

    def wire_size(self, update: Update) -> float:
        return update.size * self.config.wire_factor

    # -- fluid slot model -------------------------------------------------- #
    def _max_occupancy(self, member_profiles: List[Profile],
                       member_sizes: List[float],
                       drain: Optional[Profile]) -> int:
        """Peak slot occupancy over all profile breakpoints."""
        slot = self.config.slot_bytes
        points = set()
        for prof in member_profiles:
            for t0, t1, _ in prof.chunks:
                points.add(t0)
                points.add(t1)
        if drain is not None:
            for t0, t1, _ in drain.chunks:
                points.add(t0)
                points.add(t1)
        peak = 0
        for t in sorted(points):
            recv = [profile_bytes_by(p, t) for p in member_profiles]
            fastest = max(recv)
            # a member that has fully streamed stops gating the window sum
            gating = [r for r, s in zip(recv, member_sizes) if r < s - 1e-9]
            slowest = min(gating) if gating else fastest
            drained = slowest if drain is None else min(
                profile_bytes_by(drain, t), slowest)
            held = max(0.0, fastest - drained)
            peak = max(peak, int(math.ceil(held / slot - 1e-9)))
        return peak

    # -- planning ---------------------------------------------------------- #
    def plan(self, order, network, server, aggregators, *, t_now=0.0,
             objective="makespan", planner="incremental"):
        cfg = self.config
        nw = network.overlay()
        by_pod: Dict[str, List[Update]] = {}
        spilled: List[Update] = []
        spill_reasons: Dict[int, str] = {}
        for u in order:
            sw = self._live_switch(u.worker, nw)
            if sw is None:
                spilled.append(u)
                spill_reasons[u.uid] = "no-switch"
            else:
                by_pod.setdefault(sw, []).append(u)

        switch_groups: List[SwitchGroupPlan] = []
        spill_count = 0
        for sw in sorted(by_pod):
            pod = int(sw[len("switch"):])
            sg = SwitchGroupPlan(switch=sw, pod=pod,
                                 drain_dst="" if self.hierarchical else server)
            profiles: List[Profile] = []
            sizes: List[float] = []
            for u in by_pod[sw]:
                wsize = self.wire_size(u)
                tr = nw.plan_transfer(u.worker, sw, wsize,
                                      max(u.t_avail, t_now))
                if tr is None:
                    spilled.append(u)
                    spill_reasons[u.uid] = "unreachable"
                    spill_count += 1
                    continue
                # tentative drain for the admission check: pod sum so far
                # plus the candidate, draining toward the server from the
                # first-complete-window time
                cand_profiles = profiles + [tr.profile]
                cand_sizes = sizes + [wsize]
                drain_size = cfg.wire_factor * max(
                    m.size for m in sg.members + [u])
                t_first = max(
                    profile_time_to(p, min(cfg.slot_bytes, s))
                    for p, s in zip(cand_profiles, cand_sizes))
                drain = nw.plan_transfer(sw, server, drain_size, t_first)
                occ = self._max_occupancy(
                    cand_profiles, cand_sizes,
                    drain.profile if drain is not None else None)
                if occ > cfg.pool_slots and sg.members:
                    spilled.append(u)          # pool exhausted -> host path
                    spill_reasons[u.uid] = "pool-exhausted"
                    spill_count += 1
                    continue
                nw.commit_transfer(tr)
                sg.members.append(u)
                sg.member_transfers.append(tr)
                sg.wire_sizes[u.uid] = wsize
                profiles.append(tr.profile)
                sizes.append(wsize)
                sg.max_occupancy = min(occ, cfg.pool_slots)
            if not sg.members:
                continue
            sg.drain_size = cfg.wire_factor * max(m.size for m in sg.members)
            sg.t_first_window = max(
                profile_time_to(p, min(cfg.slot_bytes, s))
                for p, s in zip(profiles, sizes))
            sg.t_ready = max(tr.t_end for tr in sg.member_transfers)
            switch_groups.append(sg)

        # drains: pure switch reserves switch->server now; hierarchical
        # turns each pod sum into a pseudo-update for the host tier
        pseudo_members: Dict[int, SwitchGroupPlan] = {}
        host_order: List[Update] = list(spilled)
        if self.hierarchical:
            for sg in switch_groups:
                sg.pseudo_uid = -(sg.pod + 1)
                pseudo_members[sg.pseudo_uid] = sg
                host_order.append(Update(
                    uid=sg.pseudo_uid, worker=sg.switch, size=sg.drain_size,
                    version=min(m.version for m in sg.members),
                    norm=max(m.norm for m in sg.members),
                    t_avail=sg.t_first_window))
        else:
            for sg in switch_groups:
                sg.drain_transfer = nw.reserve(sg.switch, server,
                                               sg.drain_size,
                                               sg.t_first_window)

        host_plan = aggregate_updates(host_order, nw, server,
                                      list(aggregators), t_now=t_now,
                                      objective=objective, planner=planner)

        # -- combined view over real uids ---------------------------------- #
        groups: List[AggGroup] = [host_plan.groups[0]]
        for sg in switch_groups:
            groups.append(AggGroup(aggregator=sg.switch, members=sg.members,
                                   member_transfers=sg.member_transfers,
                                   aggregate_transfer=sg.drain_transfer))
        n_sw = len(switch_groups)
        assignment: Dict[int, int] = {}
        commit: Dict[int, float] = {}
        for gi, sg in enumerate(switch_groups):
            for m in sg.members:
                assignment[m.uid] = 1 + gi
                if sg.drain_transfer is not None:
                    commit[m.uid] = max(sg.drain_transfer.t_end, sg.t_ready)
        for g in host_plan.groups[1:]:
            groups.append(g)
        for uid, gi in host_plan.assignment.items():
            if uid < 0:
                continue
            assignment[uid] = gi if gi == 0 else gi + n_sw
        for uid, t in host_plan.commit_times.items():
            if uid < 0:
                sg = pseudo_members[uid]
                for m in sg.members:
                    commit[m.uid] = max(t, sg.t_ready)
            else:
                commit[uid] = t

        makespan = max(commit.values()) if commit else t_now
        return SwitchPlanResult(
            groups=groups, assignment=assignment, makespan=makespan,
            network=host_plan.network, commit_times=commit,
            switch_groups=switch_groups, host_plan=host_plan,
            pseudo_members=pseudo_members,
            spilled_uids=frozenset(u.uid for u in spilled),
            spill_count=spill_count,
            spill_reasons=spill_reasons,
            occupancy_peak=max((sg.max_occupancy for sg in switch_groups),
                               default=0))


def make_backend(cfg) -> AggregationBackend:
    """Build the backend named by ``cfg.backend`` (a SchedulerConfig)."""
    kind = getattr(cfg, "backend", "host")
    if kind == "host":
        return HostBackend()
    switch_cfg = getattr(cfg, "switch", None)
    if kind == "switch":
        return SwitchBackend(switch_cfg)
    if kind == "hierarchical":
        return SwitchBackend(switch_cfg, hierarchical=True)
    raise ValueError(f"unknown aggregation backend {kind!r}")
