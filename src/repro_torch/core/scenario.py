"""Dynamic-cluster scenarios: a declarative timeline of cluster events.

The paper's headline claim ("up to 3x ... in realistic dynamic cluster
settings", §7) needs clusters whose membership and network change *during*
a run: workers joining or leaving, aggregator roles failing, trace-driven
per-host bandwidth shifts, and monitoring-lag changes.  A :class:`Scenario`
is an immutable, time-sorted list of such events; consumers (``ClusterSim``,
``FairShareAsync``, ``SyncSim``, ``ElasticSession``) pull the events into
their own event loops and interpret the subset that applies to them through
an ``apply_event`` hook.

Event semantics (see DESIGN.md §7 for the full re-plan story):

* ``WorkerJoin``    — a new host appears, starts computing immediately and
                      refills a failed aggregator-roster slot if one is
                      open (a join for an already-alive host is a no-op).
* ``WorkerLeave``   — the host vanishes: pending and in-flight updates from
                      it are lost (counted as drops, unfinished
                      reservations released); if it was serving as an
                      aggregator, its in-flight groups are re-routed.
* ``AggregatorFail``— the aggregation *role* on a host fails (the host keeps
                      computing); in-flight groups through it are re-planned.
* ``BandwidthTrace``— one point of a per-host NIC trace (up/down rate from
                      this time on); ``bandwidth_trace()`` expands a whole
                      trace into events.
* ``MonitorLagChange`` — the monitor's report lag changes (paper §7 studies
                      scheduling under stale network views).
* ``ServerFail``    — the primary parameter server dies (§3.3): in-flight
                      server transfers are lost, pending updates enter the
                      regenerate-list, and — when a replica is configured —
                      the bounded-divergence replica is promoted (either
                      immediately, or at an explicit ``ReplicaPromote``
                      event if the timeline carries one).
* ``ReplicaPromote``— explicitly promote the replica to primary (split
                      from ``ServerFail`` to model detection/failover lag).
* ``PacketLoss``    — the host's NIC starts *dropping* a fraction ``rate``
                      of the bytes it sends/receives (``direction``), until
                      ``until`` (or indefinitely).  How the cluster reacts
                      is the transport policy's business (DESIGN.md §12):
                      retransmit on residual capacity, or accept the loss
                      via sparsification + error feedback.
* ``LinkDegrade``   — the host's NIC starts *corrupting* a fraction
                      ``corrupt_rate`` of bytes.  Corrupt bytes are garbage
                      (failed checksum), not a sparse subset of gradient
                      coordinates, so even the bounded-loss transport must
                      repair them.

Times are seconds on the simulator clock; ``ElasticSession.run_scenario``
reinterprets them as step indices (its "clock" is the step counter).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ScenarioEvent:
    """Base class: something that happens to the cluster at ``time``."""

    time: float


@dataclass(frozen=True)
class WorkerJoin(ScenarioEvent):
    """A new worker host appears at ``time``.

    ``worker`` of ``None`` lets the consumer pick a fresh name; ``up`` /
    ``down`` of ``None`` use the consumer's default NIC bandwidth.
    """

    worker: Optional[str] = None
    up: Optional[float] = None
    down: Optional[float] = None


@dataclass(frozen=True)
class WorkerLeave(ScenarioEvent):
    worker: str = ""


@dataclass(frozen=True)
class AggregatorFail(ScenarioEvent):
    host: str = ""


@dataclass(frozen=True)
class SwitchFail(ScenarioEvent):
    """An in-network aggregation switch (``switch{pod}``) fails at ``time``.

    Only meaningful under the switch/hierarchical backends (DESIGN.md
    §13): in-flight pod groups through the switch are released and their
    members rescheduled; later plans spill that pod to the host path.
    """

    switch: str = ""


@dataclass(frozen=True)
class BandwidthTrace(ScenarioEvent):
    """Set ``host``'s NIC rates from ``time`` on (``None`` leaves a
    direction unchanged)."""

    host: str = ""
    up: Optional[float] = None
    down: Optional[float] = None


@dataclass(frozen=True)
class MonitorLagChange(ScenarioEvent):
    lag: float = 0.0


@dataclass(frozen=True)
class ServerFail(ScenarioEvent):
    """The parameter server at ``server`` fails at ``time``.

    ``server`` of ``""`` means the consumer's configured primary.  A
    failure with no replica configured halts training (the paper's
    motivation for §3.3); with a replica, promotion follows — at this
    event when the timeline has no ``ReplicaPromote``, else at that event.
    """

    server: str = ""


@dataclass(frozen=True)
class ReplicaPromote(ScenarioEvent):
    """Promote the configured replica to primary at ``time`` (only
    meaningful after a ``ServerFail``; a no-op otherwise).

    ``replica`` of ``""`` means the consumer's configured replica; naming
    a host that is NOT the configured replica makes the event a no-op
    (there is no such standby to promote)."""

    replica: str = ""


@dataclass(frozen=True)
class PacketLoss(ScenarioEvent):
    """``host``'s links start dropping a fraction ``rate`` of bytes at
    ``time``; the loss clears at ``until`` (``None`` = until further
    notice — a later ``PacketLoss(rate=0.0)`` also clears it).

    ``direction`` selects the lossy side: ``"up"`` (bytes the host sends),
    ``"down"`` (bytes it receives) or ``"both"``.  ``rate`` must be in
    ``[0, 1)`` — a rate of 1.0 would make every transfer unfinishable.
    """

    host: str = ""
    rate: float = 0.0
    until: Optional[float] = None
    direction: str = "both"

    def __post_init__(self) -> None:
        if not (0.0 <= self.rate < 1.0):
            raise ValueError(f"loss rate must be in [0, 1): {self.rate}")
        if self.direction not in ("up", "down", "both"):
            raise ValueError(f"direction must be up/down/both: {self.direction}")
        if self.until is not None and self.until < self.time:
            raise ValueError(f"until {self.until} precedes time {self.time}")


@dataclass(frozen=True)
class LinkDegrade(ScenarioEvent):
    """``host``'s links start corrupting a fraction ``corrupt_rate`` of
    bytes at ``time`` (cleared at ``until``).  Corruption differs from
    ``PacketLoss`` in how the bounded-loss transport treats it: corrupt
    bytes are always retransmitted (they carry no usable information),
    whereas dropped bytes may be absorbed by error feedback."""

    host: str = ""
    corrupt_rate: float = 0.0
    until: Optional[float] = None
    direction: str = "both"

    def __post_init__(self) -> None:
        if not (0.0 <= self.corrupt_rate < 1.0):
            raise ValueError(
                f"corrupt rate must be in [0, 1): {self.corrupt_rate}")
        if self.direction not in ("up", "down", "both"):
            raise ValueError(f"direction must be up/down/both: {self.direction}")
        if self.until is not None and self.until < self.time:
            raise ValueError(f"until {self.until} precedes time {self.time}")


def bandwidth_trace(host: str,
                    points: Iterable[Tuple[float, float, float]],
                    ) -> List[BandwidthTrace]:
    """Expand ``(time, up, down)`` trace points into events for one host."""
    return [BandwidthTrace(time=t, host=host, up=up, down=down)
            for t, up, down in points]


@dataclass
class Scenario:
    """A named, time-sorted event timeline.

    Construction sorts by time (stable: simultaneous events keep their
    authored order) and validates times are finite and non-negative.
    """

    events: List[ScenarioEvent] = field(default_factory=list)
    name: str = "scenario"

    def __post_init__(self) -> None:
        for ev in self.events:
            if not (ev.time >= 0.0 and ev.time != float("inf")):
                raise ValueError(f"event time must be finite and >= 0: {ev}")
        self.events = sorted(self.events, key=lambda e: e.time)

    def __iter__(self) -> Iterator[ScenarioEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def merged(self, other: "Scenario", name: Optional[str] = None) -> "Scenario":
        return Scenario(list(self.events) + list(other.events),
                        name=name or f"{self.name}+{other.name}")

    # convenience filters ------------------------------------------------- #
    def of_type(self, *types: type) -> List[ScenarioEvent]:
        return [e for e in self.events if isinstance(e, types)]

    @property
    def leaves(self) -> List[WorkerLeave]:
        return self.of_type(WorkerLeave)  # type: ignore[return-value]

    @property
    def joins(self) -> List[WorkerJoin]:
        return self.of_type(WorkerJoin)  # type: ignore[return-value]


__all__ = [
    "Scenario", "ScenarioEvent", "WorkerJoin", "WorkerLeave",
    "AggregatorFail", "SwitchFail", "BandwidthTrace", "MonitorLagChange",
    "ServerFail", "ReplicaPromote", "PacketLoss", "LinkDegrade",
    "bandwidth_trace",
]
