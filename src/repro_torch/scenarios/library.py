"""Named scenario builders for the paper's dynamic-cluster experiments.

Each builder returns a :class:`repro.core.scenario.Scenario` parameterized
on cluster size and timing, so benchmarks, examples and tests drive the
exact same timelines.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

from ..core.network import gbps
from ..core.scenario import (AggregatorFail, BandwidthTrace, LinkDegrade,
                             MonitorLagChange, PacketLoss, ReplicaPromote,
                             Scenario, ScenarioEvent, ServerFail, WorkerJoin,
                             WorkerLeave, bandwidth_trace)


def churn(n_workers: int, *, leave_at: float = 5.0, rejoin_at: float = 15.0,
          fraction: float = 0.25, name: str = "churn") -> Scenario:
    """The paper's dynamic-cluster table: a fraction of workers leaves at
    ``leave_at`` and the same count of fresh workers joins at ``rejoin_at``.

    The leavers are the *last* workers (so default aggregators, hosted on
    the first workers, survive — aggregator death is exercised separately
    by :func:`aggregator_outage`).
    """
    n_leave = max(1, int(n_workers * fraction))
    events: list[ScenarioEvent] = [
        WorkerLeave(time=leave_at, worker=f"worker{n_workers - 1 - i}")
        for i in range(n_leave)]
    events += [WorkerJoin(time=rejoin_at) for _ in range(n_leave)]
    return Scenario(events, name=name)


def aggregator_outage(aggregators: Sequence[str], *, fail_at: float = 4.0,
                      name: str = "aggregator-outage") -> Scenario:
    """Every listed aggregator role fails at ``fail_at`` (hosts keep
    computing): exercises re-routing of in-flight aggregation groups."""
    return Scenario([AggregatorFail(time=fail_at, host=a) for a in aggregators],
                    name=name)


def flash_crowd(n_joins: int, *, start: float = 2.0, interval: float = 0.5,
                up: Optional[float] = None, down: Optional[float] = None,
                name: str = "flash-crowd") -> Scenario:
    """Workers arrive one-by-one (elastic scale-up under load)."""
    return Scenario([WorkerJoin(time=start + i * interval, up=up, down=down)
                     for i in range(n_joins)], name=name)


def congestion_wave(workers: Sequence[str], *, start: float = 3.0,
                    duration: float = 4.0, low=gbps(1), high=gbps(10),
                    stagger: float = 0.5, name: str = "congestion-wave",
                    ) -> Scenario:
    """A rolling background-traffic wave: each host's NIC dips to ``low``
    for ``duration`` seconds, staggered by ``stagger`` — the trace-driven
    analogue of the paper's N settings."""
    events: list[ScenarioEvent] = []
    for i, w in enumerate(workers):
        t0 = start + i * stagger
        events += bandwidth_trace(w, [(t0, low, low),
                                      (t0 + duration, high, high)])
    return Scenario(events, name=name)


def degraded_monitor(*, at: float = 5.0, lag: float = 2.0,
                     recover_at: Optional[float] = None,
                     recovered_lag: float = 0.2,
                     name: str = "degraded-monitor") -> Scenario:
    """The bandwidth monitor's report lag degrades (and optionally
    recovers): the scheduler plans on an increasingly stale network view."""
    events: list[ScenarioEvent] = [MonitorLagChange(time=at, lag=lag)]
    if recover_at is not None:
        events.append(MonitorLagChange(time=recover_at, lag=recovered_lag))
    return Scenario(events, name=name)


def server_failover(*, fail_at: float = 5.0,
                    promote_at: Optional[float] = None,
                    name: str = "server-failover") -> Scenario:
    """§3.3/§5.3: the primary parameter server dies at ``fail_at``.

    With ``promote_at`` unset the consumer promotes its replica at the
    failure itself (zero detection lag); setting it models a failover
    window during which training is stalled.  Consumers without a replica
    (``FairShareAsync``, ``SyncSim``) replay the same timeline via
    checkpoint-restore — the paper's recovery-time comparison."""
    events: list[ScenarioEvent] = [ServerFail(time=fail_at)]
    if promote_at is not None:
        if promote_at < fail_at:
            raise ValueError("promote_at must not precede fail_at")
        events.append(ReplicaPromote(time=promote_at))
    return Scenario(events, name=name)


def burst_loss(workers: Sequence[str], *, start: float = 2.0,
               duration: float = 1.5, rate: float = 0.3,
               interval: float = 4.0, bursts: int = 2,
               name: str = "burst-loss") -> Scenario:
    """Periodic loss bursts: every ``interval`` seconds each listed host's
    links drop ``rate`` of transfer bytes for ``duration`` seconds (a flaky
    ToR / lossy-tunnel episode).  Windows are explicit ``until`` bounds, so
    between bursts the fabric is clean."""
    if bursts < 1:
        raise ValueError(f"bursts must be >= 1: {bursts}")
    events: list[ScenarioEvent] = []
    for b in range(bursts):
        t0 = start + b * interval
        events += [PacketLoss(time=t0, host=w, rate=rate, until=t0 + duration)
                   for w in workers]
    return Scenario(events, name=name)


def congestion_loss(workers: Sequence[str], *, start: float = 3.0,
                    duration: float = 4.0, rate: float = 0.15,
                    corrupt_rate: float = 0.05, low=gbps(1), high=gbps(10),
                    stagger: float = 0.5, name: str = "congestion-loss",
                    ) -> Scenario:
    """:func:`congestion_wave` plus its loss signature: while a host's NIC
    is dipped its queues overflow (``PacketLoss``) and the stressed link
    corrupts a further fraction of bytes (``LinkDegrade``), both ending
    with the wave.  Exercises bandwidth *and* loss dynamics together."""
    events: list[ScenarioEvent] = []
    for i, w in enumerate(workers):
        t0 = start + i * stagger
        t1 = t0 + duration
        events += bandwidth_trace(w, [(t0, low, low), (t1, high, high)])
        events.append(PacketLoss(time=t0, host=w, rate=rate, until=t1))
        if corrupt_rate > 0.0:
            events.append(LinkDegrade(time=t0, host=w,
                                      corrupt_rate=corrupt_rate, until=t1))
    return Scenario(events, name=name)


def pod_stress(n_workers: int, *, start: float = 0.5,
               server_down=gbps(2.5), server_up=gbps(10),
               recover_at: Optional[float] = None, high=gbps(10),
               name: str = "pod-stress") -> Scenario:
    """The pod-heavy regime: the server's *downlink* collapses to
    ``server_down`` at ``start`` (an incast-congested ToR port) while
    every worker NIC stays fast, so total cross-fabric fan-in — not any
    member uplink — bounds the makespan.  This is the regime in-network
    aggregation is built for: a pod switch pre-sums its members so the
    server ingests one drained pseudo-update per pod (int8 wire) instead
    of ``pod_size`` f32 updates, and the hierarchical backend's host tier
    schedules those few drains over the choked downlink."""
    events = bandwidth_trace("server", [(start, server_up, server_down)])
    if recover_at is not None:
        events += bandwidth_trace("server", [(recover_at, high, high)])
    return Scenario(events, name=name)


def paper_dynamic_cluster(n_workers: int, *, seed: int = 0,
                          horizon: float = 30.0,
                          name: str = "paper-dynamic-cluster") -> Scenario:
    """The composite used by the paper-table benchmark: churn + an
    aggregator failure + a congestion wave, deterministically derived from
    ``seed`` so MLfabric and the baselines replay the identical timeline."""
    rng = random.Random(seed)
    s = churn(n_workers, leave_at=horizon / 6, rejoin_at=horizon / 2)
    s = s.merged(aggregator_outage([f"worker{rng.randrange(2)}"],
                                   fail_at=horizon / 3))
    wave_hosts = [f"worker{i}" for i in
                  sorted(rng.sample(range(n_workers), max(2, n_workers // 4)))]
    s = s.merged(congestion_wave(wave_hosts, start=horizon / 4))
    return Scenario(list(s.events), name=name)


__all__ = ["churn", "aggregator_outage", "flash_crowd", "congestion_wave",
           "burst_loss", "congestion_loss", "degraded_monitor",
           "pod_stress", "server_failover", "paper_dynamic_cluster"]
