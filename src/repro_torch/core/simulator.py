"""Discrete-event cluster simulator (paper §7 experiment harness).

Reproduces the paper's evaluation environment: N workers with compute
stragglers (settings C1-C3), per-host NIC bandwidth fluctuation (N1-N3), a
monitor that reports bandwidth changes to the scheduler with a lag, a
scheduler that batches push requests every ``batch_interval`` seconds, and a
parameter server applying updates with momentum (eq. 2).

Two fidelity modes share the same event loop:

* **timing mode** (default): updates are metadata only; used by benchmarks
  that reproduce the paper's timing tables.
* **training mode**: the caller provides ``on_compute`` / ``on_commit``
  callbacks that move real tensors (see ``repro/ps/async_trainer.py``); the
  simulator decides *when/what order*, the trainer decides *values*.

Dynamic clusters (the paper's "realistic dynamic cluster settings"): pass a
``scenario`` — a time-sorted list of :mod:`repro.core.scenario` events — and
the simulator applies each through :meth:`ClusterSim.apply_event`: workers
join (and start computing) or leave (their pending and in-flight updates are
dropped), aggregator roles fail (in-flight groups through them are
re-routed: members go back to the pending pool and the next batch re-plans
them on the surviving topology), per-host bandwidth follows a trace, and the
monitor's lag changes mid-run.  Membership changes reach the scheduler
immediately (control-plane events, unlike data-plane bandwidth which is
monitor-lagged).

Fault tolerance (§3.3/§5.3, DESIGN.md §9): with ``cfg.replica`` set the
simulator *enacts* the replication plan — frozen copies ride spare actual-
network capacity, replica commits release in server-commit order, and
``delayed_server_uids`` hold server commit events (§5.3 lead reduction).
``ServerFail`` kills the primary (in-flight traffic lost, pending updates
confiscated into the regenerate-list) and the replica is promoted —
immediately, or at an explicit ``ReplicaPromote`` event — after which
training continues from the replica's bounded-divergence frontier.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.critpath import dominant_bottleneck, find_collector
from ..obs.metrics import MetricsRegistry
from .aggregation import AggregationResult
from .backends import SwitchPlanResult, profile_time_to
from .delay import DelayTracker
from .harness import HookBus, NULL_BUS
from .network import LossSchedule, NetworkState, Transfer, gbps, mb
from .ordering import Update
from .scenario import (AggregatorFail, BandwidthTrace, LinkDegrade,
                       MonitorLagChange, PacketLoss, ReplicaPromote, Scenario,
                       ScenarioEvent, ServerFail, SwitchFail, WorkerJoin,
                       WorkerLeave)
from .scheduler import BatchPlan, MLfabricScheduler, SchedulerConfig


# --------------------------------------------------------------------------- #
# workload models (paper §7 "Background compute and network load")
# --------------------------------------------------------------------------- #
@dataclass
class StragglerModel:
    """Each compute phase is slowed by ``factor`` with probability ``prob``."""

    prob: float = 0.10
    factor: float = 2.0

    def sample(self, rng: random.Random) -> float:
        return self.factor if rng.random() < self.prob else 1.0

    def sample_batch(self, rng: random.Random, n: int):
        """Vectorized draw of ``n`` slowdown factors (one numpy op, not ``n``
        Python RNG round-trips — the U=4096 fan-out path).  Matches the
        reference's ``jax.random`` draw in distribution, not bit for bit."""
        u = np.random.default_rng(rng.getrandbits(32)).random(n)
        return np.where(u < self.prob, self.factor, 1.0)


# Paper defaults: C1=(10%,2x), C2=(10%,4x), C3=(4%,2x)
C1 = StragglerModel(0.10, 2.0)
C2 = StragglerModel(0.10, 4.0)
C3 = StragglerModel(0.04, 2.0)


@dataclass
class BandwidthModel:
    """Every ``period`` seconds each NIC re-draws its rate from ``levels``."""

    period: float = 5.0
    levels: Sequence[float] = (gbps(1), gbps(2.5), gbps(3.3), gbps(5), gbps(10))
    probs: Sequence[float] = (0.0, 0.0, 0.0, 0.1, 0.9)

    def sample(self, rng: random.Random) -> float:
        return rng.choices(list(self.levels), weights=list(self.probs))[0]

    def sample_batch(self, rng: random.Random, n: int):
        """Vectorized draw of ``n`` NIC rates (categorical over ``levels``)."""
        p = np.asarray(self.probs, dtype=np.float64)
        idx = np.random.default_rng(rng.getrandbits(32)).choice(
            len(self.levels), size=n, p=p / p.sum())
        return np.asarray(self.levels)[idx]


N1 = BandwidthModel()
N2 = BandwidthModel(probs=(0.0, 0.1, 0.1, 0.1, 0.7))
N3 = BandwidthModel(probs=(0.5, 0.0, 0.0, 0.0, 0.5))
N_STATIC = BandwidthModel(probs=(0.0, 0.0, 0.0, 0.0, 1.0))


# --------------------------------------------------------------------------- #
# transport policy (DESIGN.md §12)
# --------------------------------------------------------------------------- #
@dataclass
class TransportConfig:
    """How the cluster reacts to ``PacketLoss``/``LinkDegrade`` link faults.

    ``policy``:

    * ``"lossless"`` — ideal links: loss is *measured* (byte counters) but
      never repaired; commits proceed as if every byte arrived.  The bench
      baseline (and the semantics of ``transport=None``, minus counters).
    * ``"reliable"`` — lost and corrupt chunks are detected at the receiver
      and retransmitted on the sender's residual ``Timeline`` capacity with
      exponential backoff, up to ``max_retries`` rounds and a per-transfer
      ``deadline``; a transfer that exhausts either is failed and its
      update dropped (the worker recomputes, as for a scenario drop).
    * ``"bounded"`` — bounded-loss degradation: *dropped* gradient bytes up
      to the allowed fraction are absorbed by top-k + error feedback
      (``repro.dist.flatbuf.ErrorFeedback``) and never retransmitted; only
      the excess over the allowance — and ALL corrupt bytes, which carry no
      usable coordinates — is repaired as in ``"reliable"``.

    The allowed drop fraction is ``phase_policy.allowed_loss()`` when a
    phase-aware policy object is attached (see
    ``repro.dist.policy.PhaseLossPolicy``), else the static
    ``loss_tolerance``.  ``inflate_sjf`` feeds the expected repair traffic
    back into Alg. 2/3 planning: the scheduler sees loss-inflated job
    sizes (capped at ``max_inflation``) computed from the *lagged* loss
    view, mirroring how bandwidth reaches it through the monitor.
    """

    policy: str = "reliable"
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    max_retries: int = 8
    deadline: float = math.inf
    tolerance_bytes: float = 1500.0      # residual below one MTU: delivered
    loss_tolerance: float = 0.0
    phase_policy: Optional[Any] = None   # duck-typed: .allowed_loss()
    inflate_sjf: bool = True
    max_inflation: float = 4.0

    def __post_init__(self) -> None:
        if self.policy not in ("lossless", "reliable", "bounded"):
            raise ValueError(f"unknown transport policy {self.policy!r}")

    def allowed_loss(self) -> float:
        if self.phase_policy is not None:
            return float(self.phase_policy.allowed_loss())
        return self.loss_tolerance

    def repair_fraction(self, drop: float, corrupt: float) -> float:
        """Fraction of a transfer's bytes this policy must retransmit.

        ``drop``/``corrupt`` are byte fractions of the whole transfer
        (``LossSchedule.transfer_loss`` already charges corruption only to
        bytes that survived the drop stage, so the two are disjoint).
        """
        if self.policy == "lossless":
            return 0.0
        if self.policy == "reliable":
            return drop + corrupt
        return max(0.0, drop - self.allowed_loss()) + corrupt


# --------------------------------------------------------------------------- #
# simulation records
# --------------------------------------------------------------------------- #
@dataclass
class CommitRecord:
    time: float
    worker: str
    uid: int
    version_used: int       # model version the gradient was computed from
    version_committed: int  # model version right before this commit
    aggregated: bool

    @property
    def delay(self) -> int:
        return self.version_committed - self.version_used


# Event counters that live in the result's metrics registry rather than as
# dataclass fields.  Attribute access (``result.joins``, ``result.joins += 1``)
# keeps working through generated property pairs below, so every historical
# call site and test is unchanged — but there is exactly ONE accumulator per
# quantity, shared by ``ClusterSim``, the baselines, and any harness callback
# reading ``result.metrics``.
_COUNTER_METRICS: Dict[str, str] = {
    # dynamic-cluster accounting:
    "scenario_events_applied": "scenario/events_applied",
    "scenario_drops": "scenario/drops",     # updates lost to WorkerLeave
    "reroutes": "scenario/reroutes",        # in-flight re-plans (agg death)
    "repairs": "scenario/repairs",          # event-driven plan repairs
    "joins": "scenario/joins",
    "leaves": "scenario/leaves",
    # fault-tolerance plane (§3.3 / §5.3):
    "replica_commits": "replica/commits",   # updates applied at the replica
    "server_commits_delayed": "replica/server_commits_delayed",  # §5.3 holds
    "server_fails": "failover/server_fails",
    "promotions": "failover/promotions",
    "regen_pending": "failover/regen_pending",   # confiscated for regen
    "regenerated": "failover/regenerated",  # gap + regen-list at promotion
    "rolled_back": "failover/rolled_back",  # checkpoint-restore baselines
    # bounded-loss transport tier (DESIGN.md §12):
    "transport_loss_events": "transport/loss_events",  # lossy-link edicts
    "retransmits": "transport/retransmits",    # repair rounds reserved
    "transport_timeouts": "transport/timeouts",  # gave up: deadline passed
    "transport_expired": "transport/expired",    # gave up: retries exhausted
    "replica_resourced": "transport/replica_resourced",  # lossy copy fallback
    # switch aggregation backend (DESIGN.md §13):
    "switch_groups": "switch/groups",        # pod groups enacted
    "switch_drains": "switch/drains",        # pod sums drained upstream
    "switch_spills": "switch/spills",        # pool-exhausted -> host path
    "switch_fails": "switch/fails",          # SwitchFail events applied
}

_RECOVERY_METRIC = "failover/recovery_time"


@dataclass
class SimResult:
    commits: List[CommitRecord] = field(default_factory=list)
    drops: int = 0
    sim_time: float = 0.0
    delay: DelayTracker = field(default_factory=DelayTracker)
    bytes_to_server: float = 0.0
    bytes_to_replica: float = 0.0
    # every byte that crossed any link on the update path: member->aggregator
    # hops plus everything in ``bytes_to_server`` (direct + aggregate hops).
    bytes_in_network: float = 0.0
    replica_divergence_trace: List[Tuple[float, float]] = field(default_factory=list)
    scheduler_batches: int = 0
    scheduler_wall_time: float = 0.0
    # dynamic-cluster + fault-tolerance counters (see ``_COUNTER_METRICS``)
    # plus anything a harness callback records, all in one registry:
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)

    @property
    def n_commits(self) -> int:
        return len(self.commits)

    @property
    def commit_rate(self) -> float:
        return self.n_commits / self.sim_time if self.sim_time > 0 else 0.0

    @property
    def recovery_time(self) -> float:
        """Fail -> first post-promotion commit (inf: no recovery happened)."""
        return self.metrics.gauge(_RECOVERY_METRIC, initial=math.inf).value

    @recovery_time.setter
    def recovery_time(self, value: float) -> None:
        self.metrics.gauge(_RECOVERY_METRIC, initial=math.inf).set(value)

    # -- shared recording helpers (simulator + baselines) --------------- #
    def record_commit(self, rec: CommitRecord) -> None:
        self.commits.append(rec)
        self.delay.record(rec.delay)

    def record_scenario_drop(self, *, count_total: bool = False) -> None:
        """One update lost to a scenario event.  ``ClusterSim`` folds
        scenario drops into ``drops`` at the end of ``run``; the fair-share
        baseline has no scheduler drop count and tallies directly
        (``count_total``)."""
        self.metrics.counter(_COUNTER_METRICS["scenario_drops"]).inc()
        if count_total:
            self.drops += 1


def _counter_property(metric: str) -> property:
    def _get(self) -> int:
        return int(self.metrics.counter(metric).value)

    def _set(self, value: int) -> None:
        self.metrics.counter(metric).value = value

    return property(_get, _set)


for _attr, _metric in _COUNTER_METRICS.items():
    setattr(SimResult, _attr, _counter_property(_metric))


# --------------------------------------------------------------------------- #
# the simulator
# --------------------------------------------------------------------------- #
class ClusterSim:
    """Event-driven MLfabric cluster (PS mode).

    Hosts: ``worker0..N-1``, ``server``, optional ``replica``; aggregators
    are co-hosted with workers (paper §7) and named by their host.
    Membership is dynamic when a ``scenario`` is given.
    """

    def __init__(
        self,
        n_workers: int,
        scheduler_config: SchedulerConfig,
        *,
        update_size: float = mb(100.0),
        model_size: Optional[float] = None,
        compute_time: float = 0.1,
        straggler: StragglerModel = C1,
        bandwidth: BandwidthModel = N_STATIC,
        default_bw: float = gbps(10),
        monitor_lag: float = 0.2,
        seed: int = 0,
        scenario: Optional[Scenario] = None,
        on_compute: Optional[Callable[[str, int], Tuple[float, float]]] = None,
        on_commit: Optional[Callable[[CommitRecord], None]] = None,
        on_drop: Optional[Callable[[str, int], None]] = None,
        on_join: Optional[Callable[[str, float], None]] = None,
        on_replica_commit: Optional[Callable[[int, float], None]] = None,
        on_promote: Optional[Callable[[float, int], None]] = None,
        hooks: Optional[HookBus] = None,
        plan_repair: bool = False,
        vector_compute: bool = False,
        transport: Optional[TransportConfig] = None,
    ):
        self.n_workers = n_workers
        self.workers = [f"worker{i}" for i in range(n_workers)]
        # Own copy: the roster mutates on topology events and must never
        # leak into (or be detached by) other sims sharing the caller's
        # config object.
        self.cfg = dataclasses.replace(
            scheduler_config, aggregators=list(scheduler_config.aggregators))
        self.update_size = update_size
        self.model_size = model_size if model_size is not None else update_size
        self.compute_time = compute_time
        self.straggler = straggler
        self.bandwidth = bandwidth
        self.default_bw = default_bw
        self.monitor_lag = monitor_lag
        self.rng = random.Random(seed)
        self.scenario = scenario
        self.on_compute = on_compute
        self.on_commit = on_commit
        self.on_drop = on_drop
        self.on_join = on_join
        self.on_replica_commit = on_replica_commit
        self.on_promote = on_promote
        # telemetry plane (DESIGN.md §10): harness hook bus + its tracer.
        # Defaults to the shared no-op bus, so the uninstrumented path only
        # pays do-nothing calls (pinned by the golden-trace test).
        self.hooks = hooks if hooks is not None else NULL_BUS
        self.trace = self.hooks.tracer
        # Event-driven repair (ROADMAP item 2): mid-flight topology events
        # re-plan only the affected groups' survivors immediately instead of
        # parking them in the pending pool until the next batch tick.
        self.plan_repair = plan_repair
        # jnp-vectorized worker loops (initial compute fan-out + per-period
        # NIC re-draws): one batched draw instead of O(U) RNG round-trips.
        # Off by default — it consumes the seeded RNG differently, so the
        # golden traces pin the scalar path.
        self.vector_compute = vector_compute

        hosts = list(self.workers) + [self.cfg.server]
        if self.cfg.replica:
            hosts.append(self.cfg.replica)
        self.net_actual = NetworkState(hosts, default_bw)
        self.net_lagged = NetworkState(hosts, default_bw)

        # critical-path attribution (DESIGN.md §14): when a
        # CritPathCallback rides the bus, enactment records causal legs
        # into its collector and the actual network tags reservations
        # with per-segment binding-link attribution.  The shared no-op
        # collector keeps the default path identical (golden-pinned).
        self.crit = find_collector(self.hooks)
        if self.crit.enabled:
            self.net_actual.attribution = True

        # bounded-loss transport tier (DESIGN.md §12).  ``loss_actual``
        # carries the true link loss rates; ``loss_lagged`` is what the
        # monitor has reported so far (SJF size inflation plans on it).
        # Both stay empty — and every query exactly 0.0 — until a
        # PacketLoss/LinkDegrade event fires, so a loss-free run takes the
        # identical code path regardless of ``transport`` (the zero-loss
        # golden guarantee: zero extra RNG draws, zero trace deltas).
        self.transport = transport
        self.loss_actual = LossSchedule()
        self.loss_lagged = LossSchedule()

        # Live aggregator roster: the scheduler reads ``cfg.aggregators`` on
        # every batch, so aliasing the list makes topology changes take
        # effect at the very next re-plan.  Failed slots are refilled by
        # joining workers, up to the initial roster size.
        self.aggregators: List[str] = self.cfg.aggregators
        self._initial_agg_count = len(self.aggregators)
        # pods of vacated roster slots: joiners refill same-pod first
        # (untagged ``None`` slots — no switch topology — match anyone,
        # reproducing the pre-pod refill behavior exactly)
        self._agg_vacancy_pods: List[Optional[int]] = []

        self.scheduler = MLfabricScheduler(self.cfg)
        # aggregation backend (DESIGN.md §13): the scheduler owns it; the
        # simulator shares its dead-switch set so SwitchFail events steer
        # every subsequent plan/repair around the lost capacity
        self.backend = self.scheduler.backend
        self.switch_cfg = getattr(self.backend, "config", None)
        for sw in self.backend.switch_hosts(self.workers):
            bw = (self.switch_cfg.switch_bw
                  if self.switch_cfg.switch_bw is not None else default_bw)
            self.net_actual.add_host(sw, bw)
            self.net_lagged.add_host(sw, bw)
        self.result = SimResult()

        self._uid = itertools.count()
        self._eid = itertools.count()
        self._events: List[Tuple[float, int, str, dict]] = []
        self._pending: List[Update] = []      # push requests awaiting a batch
        self._uid_meta: Dict[int, dict] = {}  # uid -> {worker, version}
        self.v_server = 0                     # committed model version

        # dynamic-membership state
        self._dead: set = set()                    # departed workers
        self._inflight: Dict[int, dict] = {}       # uid -> {update, aggregator}
        self._commit_epoch: Dict[int, int] = {}    # uid -> live event epoch
        self._next_worker_id = n_workers

        # fault-tolerance plane (§3.3): replica data path + failover state.
        # The replica applies updates in SERVER-COMMIT order (§3.3 "same
        # order"): server commits append uids to ``_replica_queue`` and a
        # copy arrival only releases replica commits while the queue head
        # has arrived, so the replica's state is always an exact prefix of
        # the server's apply sequence.
        self.v_replica = 0                         # replica commit frontier
        self._replica_inflight: Dict[int, dict] = {}   # uid -> {update, transfer}
        self._replica_epoch: Dict[int, int] = {}
        self._replica_queue: List[int] = []        # server-commit order
        self._replica_next = 0                     # queue release cursor
        self._replica_arrived: set = set()         # copies landed, not released
        self._replica_gap: Dict[int, dict] = {}    # server-committed, replica-pending
        self._regen: List[dict] = []               # confiscated update metadata
        self._stalled: set = set()                 # workers awaiting promotion restart
        self._server_failed = False
        self._replica_promoted = False
        self._fail_time: Optional[float] = None
        # only promotes that can actually fire (unnamed, or naming the
        # configured replica) may suppress auto-promotion on ServerFail
        self._promote_times = sorted(
            ev.time for ev in (scenario or [])
            if isinstance(ev, ReplicaPromote)
            and (not ev.replica or ev.replica == self.cfg.replica))

    # ------------------------------------------------------------------ #
    def _push_event(self, t: float, kind: str, **payload) -> None:
        heapq.heappush(self._events, (t, next(self._eid), kind, payload))

    # ------------------------------------------------------------------ #
    def run(self, *, until_time: float = math.inf,
            until_commits: int = 10 ** 9) -> SimResult:
        self.hooks.on_run_start(self)
        t = 0.0
        # seed events: every worker starts computing; NIC fluctuations begin.
        if self.vector_compute and self.workers:
            slows = self.straggler.sample_batch(self.rng, len(self.workers))
            for w, slow in zip(self.workers, slows.tolist()):
                self._push_event(t + self.compute_time * slow, "compute_done",
                                 worker=w)
        else:
            for w in self.workers:
                self._schedule_compute(w, t)
        if self.bandwidth.period < math.inf:
            self._push_event(self.bandwidth.period, "bw_change")
        self._push_event(self.cfg.batch_interval, "batch")
        if self.scenario is not None:
            for ev in self.scenario:
                self._push_event(ev.time, "scenario", event=ev)

        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            if t > until_time or self.result.n_commits >= until_commits:
                break
            handler = getattr(self, f"_on_{kind}")
            handler(t, **payload)

        self.result.sim_time = min(t, until_time)
        self.result.drops = self.scheduler.n_dropped + self.result.scenario_drops
        self.hooks.on_run_end(self, self.result)
        return self.result

    # ------------------------------------------------------------------ #
    # scenario events (public hook: scenarios drive the event loop here)
    # ------------------------------------------------------------------ #
    def apply_event(self, t: float, ev: ScenarioEvent) -> None:
        """Apply one cluster event at simulator time ``t``."""
        if isinstance(ev, WorkerJoin):
            self._apply_join(t, ev)
        elif isinstance(ev, WorkerLeave):
            self._apply_leave(t, ev.worker)
        elif isinstance(ev, AggregatorFail):
            self._apply_aggregator_fail(t, ev.host)
        elif isinstance(ev, SwitchFail):
            self._apply_switch_fail(t, ev.switch)
        elif isinstance(ev, BandwidthTrace):
            if ev.host in self.net_actual.up and ev.host not in self._dead:
                self.net_actual.set_bandwidth(ev.host, t, up=ev.up, down=ev.down)
                self._push_event(t + self.monitor_lag, "monitor_report",
                                 host=ev.host, up=ev.up, down=ev.down)
        elif isinstance(ev, MonitorLagChange):
            self.monitor_lag = ev.lag
        elif isinstance(ev, PacketLoss):
            if ev.host in self.net_actual.up and ev.host not in self._dead:
                self.loss_actual.set_drop(ev.host, t, ev.rate,
                                          until=ev.until,
                                          direction=ev.direction)
                self.result.transport_loss_events += 1
                self._push_event(t + self.monitor_lag, "loss_report",
                                 host=ev.host, drop=ev.rate, corrupt=None,
                                 until=ev.until, direction=ev.direction)
        elif isinstance(ev, LinkDegrade):
            if ev.host in self.net_actual.up and ev.host not in self._dead:
                self.loss_actual.set_corrupt(ev.host, t, ev.corrupt_rate,
                                             until=ev.until,
                                             direction=ev.direction)
                self.result.transport_loss_events += 1
                self._push_event(t + self.monitor_lag, "loss_report",
                                 host=ev.host, drop=None,
                                 corrupt=ev.corrupt_rate,
                                 until=ev.until, direction=ev.direction)
        elif isinstance(ev, ServerFail):
            self._apply_server_fail(t, ev.server or self.cfg.server)
        elif isinstance(ev, ReplicaPromote):
            # the event may name the standby; it must be the configured one
            if not ev.replica or ev.replica == self.cfg.replica:
                # consume this event's slot so a ServerFail at the SAME
                # timestamp (authored after a no-op promote) still
                # auto-promotes instead of waiting for it forever
                try:
                    self._promote_times.remove(ev.time)
                except ValueError:
                    pass
                self._apply_promote(t)
        else:
            raise TypeError(f"unknown scenario event {ev!r}")
        self.result.scenario_events_applied += 1
        self.trace.instant(type(ev).__name__, cat="scenario",
                           track="scenario", ts=t)
        self.hooks.on_event(self, t, ev)

    def _on_scenario(self, t: float, event: ScenarioEvent) -> None:
        self.apply_event(t, event)

    def _apply_join(self, t: float, ev: WorkerJoin) -> None:
        name = ev.worker
        if name is None:
            while (f"worker{self._next_worker_id}" in self.net_actual.up
                   or f"worker{self._next_worker_id}" in self._dead):
                self._next_worker_id += 1
            name = f"worker{self._next_worker_id}"
            self._next_worker_id += 1
        if name in self.workers:
            return  # already alive: a duplicate join must not fork a
                    # second compute loop for the same host
        up = ev.up if ev.up is not None else self.default_bw
        down = ev.down if ev.down is not None else self.default_bw
        for net in (self.net_actual, self.net_lagged):
            if name in net.up:        # rejoin of a departed host
                net.set_bandwidth(name, t, up=up, down=down)
            else:
                net.add_host(name, self.default_bw)
                net.set_bandwidth(name, t, up=up, down=down)
        self._dead.discard(name)
        self.workers.append(name)
        self.n_workers = len(self.workers)
        # aggregation duty: a joiner refills a failed slot in the roster.
        # Vacancies remember the failed aggregator's pod; a same-pod joiner
        # takes that slot first, and a cross-pod joiner only takes untagged
        # slots — filling a pod-tagged slot from another pod would silently
        # move aggregation traffic across the pod boundary and skew the
        # switch-vs-host comparison.  Without a switch topology every
        # vacancy is untagged, so this is exactly the old size-capped append.
        if self._agg_vacancy_pods:
            pod = self._pod_of(name)
            slot: Optional[int] = None
            if pod is not None and pod in self._agg_vacancy_pods:
                slot = self._agg_vacancy_pods.index(pod)
            elif None in self._agg_vacancy_pods:
                slot = self._agg_vacancy_pods.index(None)
            elif pod is None:
                slot = 0    # podless joiner: any vacancy beats a short roster
            if slot is not None:
                del self._agg_vacancy_pods[slot]
                self.aggregators.append(name)
        self.result.joins += 1
        if self.on_join:
            self.on_join(name, t)
        self._schedule_compute(name, t)

    def _apply_leave(self, t: float, worker: str) -> None:
        if worker in self._dead or worker not in self.workers:
            return
        self.workers.remove(worker)
        self._dead.add(worker)
        self.n_workers = len(self.workers)
        self.result.leaves += 1
        # An aggregator-leaver's role fails FIRST: groups through it are
        # re-routed into the pending pool (including the leaver's own
        # member updates, which the pending filter below then discards) and
        # the dead group's reservations are released exactly once.
        if worker in self.aggregators:
            self._apply_aggregator_fail(t, worker)
        # pending (not yet planned) updates from the leaver are lost.  With
        # a replica configured they enter the regenerate-list instead (the
        # paper's recovery story: lost work is recovered by fresh worker
        # updates, here from the survivors at promotion time); without one
        # they are plain scenario drops.
        lost = [u for u in self._pending if u.worker == worker]
        self._pending = [u for u in self._pending if u.worker != worker]
        for u in lost:
            if self.cfg.replica is not None:
                self._confiscate(u.uid)
            else:
                self._drop_lost(u.uid)
        # in-flight updates *from* the leaver are lost mid-transfer: the
        # unfinished transfer's reservation is freed and its bytes refunded
        # (other members of the same aggregation group are unaffected —
        # each uid commits independently)
        for uid, info in list(self._inflight.items()):
            if info["update"].worker == worker:
                self._cancel_commit(uid)
                del self._inflight[uid]
                direct = info["aggregator"] is None
                size = info.get("wire_size", info["update"].size)
                self._release_unfinished(
                    t, info["transfer"],
                    refund_server=size if direct else 0.0,
                    refund_network=size)
                self._release_chain(t, info.get("xmit_chain", ()),
                                    to_server=direct)
                if self.cfg.replica is not None:
                    self._confiscate(uid)
                else:
                    self._drop_lost(uid)
        # in-flight *replica copies* sourced at the leaver: a copy of a
        # SERVER-COMMITTED update (it is in the gap) is re-sourced from the
        # server, which holds it — the replica stream must stay gap-free or
        # the plan-time divergence bookkeeping (``advance_history`` on
        # freeze) would be invalidated.  A copy of an update the leave
        # itself just cancelled (never committed) is moot: both sides skip
        # it, so the bound bookkeeping stays conservative.
        for uid, info in list(self._replica_inflight.items()):
            tr = info["transfer"]
            if tr.src != worker or tr.t_end <= t:
                continue
            if uid in self._replica_gap and not self._server_failed:
                self.net_actual.release(tr)
                for ctr in info.pop("xmit_chain", ()):
                    if ctr.t_end > t:
                        self.net_actual.release(ctr)
                        self.result.bytes_to_replica -= ctr.size
                        self.result.bytes_in_network -= ctr.size
                self._replica_epoch[uid] = self._replica_epoch.get(uid, 0) + 1
                new_tr = self.net_actual.reserve(self.cfg.server,
                                                 self.cfg.replica,
                                                 info["update"].size, t)
                info["transfer"] = new_tr
                self._push_event(new_tr.t_end, "replica_arrive", uid=uid,
                                 epoch=self._replica_epoch[uid])
            else:
                self._cancel_replica_copy(t, uid)
        # punted replica copies owned by the leaver would otherwise be
        # re-planned against a host the network no longer knows: re-source
        # them from the server (which holds every committed update — punts
        # are always of committed work), mirroring ``_enact_replica``.
        rep_state = self.scheduler.replication_state
        rep_state.punted = [
            dataclasses.replace(u, worker=self.cfg.server)
            if u.worker == worker else u
            for u in rep_state.punted]
        # membership is control-plane: both network views drop the host now
        # (after releases) so state stays bounded under churn — a departed
        # NIC's timelines would otherwise live in every copy() forever
        for net in (self.net_actual, self.net_lagged):
            net.remove_host(worker)
        self.loss_actual.remove_host(worker)
        self.loss_lagged.remove_host(worker)

    def _apply_aggregator_fail(self, t: float, host: str) -> None:
        if host in self.aggregators:
            self.aggregators.remove(host)
            self._agg_vacancy_pods.append(self._pod_of(host))
        # Re-route in-flight groups through the dead aggregator: surviving
        # members return to the pending pool (their gradient is resent from
        # the worker) and the next batch re-plans them on the new topology.
        # The dead group's unfinished reservations are freed — otherwise
        # phantom flows would throttle the retransmissions — and the
        # never-delivered aggregate's bytes are refunded.  Switch-backend
        # groups route through here too (``aggregator`` is the switch host,
        # member transfers carry ``wire_size`` int8 bytes, and hierarchical
        # plans add a second ``agg2`` hop: host-tier aggregator -> server).
        released_aggregates: set = set()
        rerouted: List[Update] = []
        for uid, info in list(self._inflight.items()):
            if info["aggregator"] == host or host in info.get("agg_hosts", ()):
                self._cancel_commit(uid)
                del self._inflight[uid]
                self._release_unfinished(
                    t, info["transfer"],
                    refund_network=info.get("wire_size", info["update"].size))
                self._release_chain(t, info.get("xmit_chain", ()),
                                    to_server=False)
                self._release_group_tail(t, info, released_aggregates)
                u: Update = info["update"]
                u.t_avail = t
                rerouted.append(u)
                self.result.reroutes += 1
                self.trace.instant("reroute", cat="scenario", track="scenario",
                                   ts=t, args={"uid": uid, "aggregator": host})
        if rerouted:
            if self.plan_repair and not self._server_failed:
                self._repair_replan(t, rerouted)
            else:
                self._pending.extend(rerouted)

    def _release_group_tail(self, t: float, info: dict,
                            released: set) -> None:
        """Free a cancelled group's downstream reservations exactly once:
        the aggregate (or switch-drain) transfer, and — for hierarchical
        switch plans — the host-tier second hop."""
        agg_tr = info.get("agg_transfer")
        if agg_tr is not None and agg_tr.uid not in released:
            released.add(agg_tr.uid)
            to_server = info.get("agg_to_server", True)
            self._release_unfinished(
                t, agg_tr,
                refund_server=agg_tr.size if to_server else 0.0,
                refund_network=agg_tr.size)
            self._release_chain(t, info.get("agg_chain", ()),
                                to_server=to_server)
        agg2 = info.get("agg2_transfer")
        if agg2 is not None and agg2.uid not in released:
            released.add(agg2.uid)
            self._release_unfinished(t, agg2, refund_server=agg2.size,
                                     refund_network=agg2.size)
            self._release_chain(t, info.get("agg2_chain", ()), to_server=True)

    def _pod_of(self, host: str) -> Optional[int]:
        return (self.switch_cfg.pod_of(host)
                if self.switch_cfg is not None else None)

    def _apply_switch_fail(self, t: float, switch: str) -> None:
        """An aggregation switch dies: in-flight pod groups through it are
        released and re-routed exactly like a host-aggregator failure, and
        the backend's dead-switch set makes every later plan spill the pod
        to the host path."""
        if switch in self.backend.dead_switches \
                or switch not in self.net_actual.up:
            return
        self.backend.dead_switches.add(switch)
        self.result.switch_fails += 1
        self.trace.instant("switch_fail", cat="switch", track=switch, ts=t)
        self._apply_aggregator_fail(t, switch)
        for net in (self.net_actual, self.net_lagged):
            net.remove_host(switch)
        self.loss_actual.remove_host(switch)
        self.loss_lagged.remove_host(switch)

    def _repair_replan(self, t: float, updates: List[Update]) -> None:
        """Event-driven plan repair (ROADMAP item 2, ``plan_repair=True``).

        Re-plan only the affected groups' surviving members, immediately,
        on the actual network — which still carries every unaffected
        reservation, so the rest of the batch plan is kept intact — instead
        of parking them in the pending pool until the next batch tick.
        Updates whose owner departed follow the usual confiscate/drop path.
        """
        alive = [u for u in updates if u.worker not in self._dead]
        for u in updates:
            if u.worker in self._dead:
                if self.cfg.replica is not None:
                    self._confiscate(u.uid)
                else:
                    self._drop_lost(u.uid)
        if not alive:
            return
        # deterministic SJF order (Alg. 2's core rule) for the mini-batch;
        # no tau/drop pass — these updates were already admitted once
        order = sorted(alive, key=lambda u: (u.size, u.uid))
        agg = self.backend.plan(order, self.net_actual, self.cfg.server,
                                list(self.aggregators), t_now=t,
                                objective="avg_commit",
                                planner=self.cfg.planner)
        if self.crit.enabled:
            self.crit.planned(t, [u.uid for u in order])
        commit = self._enact(agg, t)
        self.result.repairs += 1
        self.trace.instant("repair", cat="scenario", track="scenario", ts=t,
                           args={"updates": len(order)})
        for u in order:
            if u.uid not in commit:
                continue    # transport gave up on it (reliable-mode fail)
            self._push_event(commit[u.uid], "commit", uid=u.uid,
                             epoch=self._commit_epoch.get(u.uid, 0),
                             aggregated=agg.assignment.get(u.uid, 0) != 0)

    def _release_unfinished(self, t: float, tr, *, refund_server: float = 0.0,
                            refund_network: float = 0.0) -> None:
        """Free a cancelled transfer's reservation and refund its byte
        counters — but only if it had not already completed by ``t``
        (delivered bytes stay both reserved-in-the-past and counted)."""
        if tr is None or tr.t_end <= t:
            return
        self.net_actual.release(tr)
        self.result.bytes_to_server -= refund_server
        self.result.bytes_in_network -= refund_network

    def _drop_lost(self, uid: int) -> None:
        meta = self._uid_meta.pop(uid, None)
        self.result.record_scenario_drop()
        if meta is not None and self.on_drop:
            self.on_drop(meta["worker"], meta["version"])

    def _cancel_commit(self, uid: int) -> None:
        """Invalidate the scheduled commit event for ``uid`` (stale events
        carry an older epoch and are ignored when they fire)."""
        self._commit_epoch[uid] = self._commit_epoch.get(uid, 0) + 1

    def _confiscate(self, uid: int) -> None:
        """Move a lost update into the regenerate-list (§3.3 recovery).

        The trainer's payload slot is freed via ``on_drop`` (the tensor is
        NOT replayed — regeneration means fresh updates from the promoted
        model); a surviving owner is restarted at promotion time."""
        meta = self._uid_meta.pop(uid, None)
        if meta is None:
            return
        self._regen.append(meta)
        self.result.regen_pending += 1
        if self.on_drop:
            self.on_drop(meta["worker"], meta["version"])
        if meta["worker"] not in self._dead:
            self._stalled.add(meta["worker"])

    def _cancel_replica_copy(self, t: float, uid: int) -> None:
        """Invalidate an in-flight replica copy and refund its bytes."""
        self._replica_epoch[uid] = self._replica_epoch.get(uid, 0) + 1
        info = self._replica_inflight.pop(uid, None)
        if info is None:
            return
        if info["transfer"].t_end > t:
            self.net_actual.release(info["transfer"])
            self.result.bytes_to_replica -= info["update"].size
            self.result.bytes_in_network -= info["update"].size
        for ctr in info.get("xmit_chain", ()):
            if ctr.t_end > t:
                self.net_actual.release(ctr)
                self.result.bytes_to_replica -= ctr.size
                self.result.bytes_in_network -= ctr.size

    # ------------------------------------------------------------------ #
    # server failure and replica promotion (§3.3)
    # ------------------------------------------------------------------ #
    def _apply_server_fail(self, t: float, host: str) -> None:
        """The primary dies: in-flight server traffic is lost, pending
        updates enter the regenerate-list, and (with a replica, unless the
        timeline carries an explicit ``ReplicaPromote``) promotion runs
        immediately.

        This applies to the CURRENT primary — including a promoted
        replica: a second failure after promotion finds no replica left
        and halts training (the docstring semantics of ``ServerFail``)."""
        if self._server_failed or host != self.cfg.server:
            return
        self._server_failed = True
        self._fail_time = t
        self.result.server_fails += 1
        self.trace.instant("server_fail", cat="failover", track=host, ts=t)
        self.hooks.on_failover(self, t, {"host": host})
        # every server-bound transfer dies with the server
        released_aggregates: set = set()
        for uid, info in list(self._inflight.items()):
            self._cancel_commit(uid)
            direct = info["aggregator"] is None
            size = info.get("wire_size", info["update"].size)
            self._release_unfinished(t, info["transfer"],
                                     refund_server=size if direct else 0.0,
                                     refund_network=size)
            self._release_chain(t, info.get("xmit_chain", ()),
                                to_server=direct)
            self._release_group_tail(t, info, released_aggregates)
            self._confiscate(uid)
        self._inflight.clear()
        # pending updates targeted the dead server -> regenerate-list
        for u in self._pending:
            self._confiscate(u.uid)
        self._pending.clear()
        # replica copies re-sourced at the (now dead) server can never land
        for uid, info in list(self._replica_inflight.items()):
            if info["transfer"].src == host:
                self._cancel_replica_copy(t, uid)
        for net in (self.net_actual, self.net_lagged):
            net.set_bandwidth(host, t, up=0.0, down=0.0)
        # promote immediately unless an explicit ReplicaPromote can STILL
        # fire (one that already fired before the failure was a no-op and
        # must not suppress the automatic promotion — training would halt
        # forever despite a healthy replica)
        if self.cfg.replica is not None \
                and not any(pt >= t for pt in self._promote_times):
            self._apply_promote(t)

    def _apply_promote(self, t: float) -> None:
        """Promote the replica to primary: it keeps its (bounded-divergence)
        model, the committed-version counter rolls back to the replica's
        frontier, and surviving workers whose updates were confiscated
        restart compute against the promoted model — the paper's "fresh
        worker updates using the latest model at the replica"."""
        if self._replica_promoted or self.cfg.replica is None \
                or not self._server_failed:
            return
        self._server_failed = False
        self._replica_promoted = True
        self.result.promotions += 1
        # copies still in flight are cancelled: their content is the gap,
        # which is regenerated rather than replayed
        for uid in list(self._replica_inflight):
            self._cancel_replica_copy(t, uid)
        self.cfg.server = self.cfg.replica     # same host, new role
        self.cfg.replica = None                # replication plane retires
        gap = len(self._replica_gap)
        self.result.regenerated += gap + len(self._regen)
        self._replica_gap.clear()
        self._replica_arrived.clear()
        self._replica_queue = []
        self._replica_next = 0
        self.v_server = self.v_replica         # roll back to the frontier
        self.scheduler.v_server = self.v_replica
        # updates computed during the failed window carry version stamps
        # from the PRE-rollback counter; clamp them to the promoted
        # frontier or they would commit with negative delay and corrupt
        # the delay statistics (and the delay-adaptive LR downstream)
        for u in self._pending:
            u.version = min(u.version, self.v_replica)
        for meta in self._uid_meta.values():
            meta["version"] = min(meta["version"], self.v_replica)
        # the failover span covers dead-primary time: fail -> promotion
        if self._fail_time is not None:
            self.trace.span("failover", cat="failover", track=self.cfg.server,
                            ts=self._fail_time, dur=t - self._fail_time,
                            args={"gap": gap,
                                  "regenerated": gap + len(self._regen)})
        self.hooks.on_replica_promote(self, t, gap)
        if self.on_promote:
            self.on_promote(t, gap)
        for w in sorted(self._stalled):
            if w in self._dead or w not in self.workers:
                continue   # regeneration falls to the remaining survivors
            pull = self.net_actual.transfer_time(self.cfg.server, w,
                                                 self.model_size, t)
            self._schedule_compute(w, pull)
        self._stalled.clear()
        self._regen.clear()

    # ------------------------------------------------------------------ #
    # event handlers
    # ------------------------------------------------------------------ #
    def _schedule_compute(self, worker: str, t_start: float) -> None:
        slow = self.straggler.sample(self.rng)
        self._push_event(t_start + self.compute_time * slow, "compute_done",
                         worker=worker)

    def _on_compute_done(self, t: float, worker: str) -> None:
        if worker in self._dead:
            return
        version = self.v_server  # model version the worker pulled
        size, norm = (self.on_compute(worker, version) if self.on_compute
                      else (self.update_size,
                            1.0 / math.sqrt(1 + len(self.result.commits))))
        uid = next(self._uid)
        self._uid_meta[uid] = {"worker": worker, "version": version}
        self._pending.append(Update(uid=uid, worker=worker, size=size,
                                    version=version, norm=norm, t_avail=t))
        self.crit.ready(uid, t)

    def _on_bw_change(self, t: float) -> None:
        """Paper's N settings: every period, every NIC re-draws its rate."""
        if self.vector_compute and self.workers:
            draws = self.bandwidth.sample_batch(
                self.rng, 2 * len(self.workers)).tolist()
            ups, downs = draws[::2], draws[1::2]
        else:
            ups = downs = None
        for i, w in enumerate(self.workers):
            if ups is not None:
                up, down = ups[i], downs[i]
            else:
                up, down = (self.bandwidth.sample(self.rng),
                            self.bandwidth.sample(self.rng))
            self.net_actual.set_bandwidth(w, t, up=up, down=down)
            self._push_event(t + self.monitor_lag, "monitor_report",
                             host=w, up=up, down=down)
        self._push_event(t + self.bandwidth.period, "bw_change")

    def _on_monitor_report(self, t: float, host: str, up: Optional[float],
                           down: Optional[float]) -> None:
        if host in self._dead:
            return  # departed before the report landed
        self.net_lagged.set_bandwidth(host, t, up=up, down=down)

    def _on_loss_report(self, t: float, host: str, drop: Optional[float],
                        corrupt: Optional[float], until: Optional[float],
                        direction: str) -> None:
        """Loss rates reach the scheduler's view monitor-lagged, exactly
        like bandwidth.  A window that closed before the report landed is
        stale news and never enters the lagged view."""
        if host in self._dead:
            return
        if until is not None and until <= t:
            return
        if drop is not None:
            self.loss_lagged.set_drop(host, t, drop, until=until,
                                      direction=direction)
        if corrupt is not None:
            self.loss_lagged.set_corrupt(host, t, corrupt, until=until,
                                         direction=direction)

    def _on_batch(self, t: float) -> None:
        self._push_event(t + self.cfg.batch_interval, "batch")
        # every planner/enact query clamps to max(t_avail, t_now), so
        # history left of the batch clock is dead weight — compact it or
        # long churn scenarios grow every Timeline without bound
        self.net_actual.compact(t)
        self.net_lagged.compact(t)
        self.loss_actual.compact(t)
        self.loss_lagged.compact(t)
        if self._server_failed:
            # primary down, replica not yet promoted: nothing can be
            # planned (the batch clock keeps ticking so scheduling resumes
            # the moment promotion lands); freshly computed updates keep
            # accruing in ``_pending`` and commit after promotion
            return
        if not self._pending:
            # §5.3 bookkeeping continues even on empty batches: the
            # divergence bound is a property of the replica's lag, not of
            # this batch's traffic, so the trace must not skip quiet (or
            # punt-everything) batches — those are exactly where it grows
            if self.cfg.replica is not None:
                self.result.replica_divergence_trace.append(
                    (t, self.scheduler.replication_state.divergence()))
            return
        batch, self._pending = self._pending, []

        batch_idx = self.result.scheduler_batches
        self.hooks.on_batch_start(self, batch_idx,
                                  {"t": t, "updates": len(batch)})
        import time as _time
        w0 = _time.perf_counter()
        # Alg. 2/3 feedback: under an active transport, SJF plans on
        # loss-inflated job sizes (expected total bytes including repair
        # rounds, from the monitor-lagged loss view).  Sizes are mutated in
        # place and restored bit-exact after planning — the plan holds the
        # same mutable Update objects, so enactment and replication see the
        # true sizes, and the planner's overlay reservations are discarded
        # with the overlay anyway.
        inflate = (self.transport is not None and self.transport.inflate_sjf
                   and self.loss_lagged.active)
        if inflate:
            orig_sizes = [(u, u.size) for u in batch]
            gauge = self.result.metrics.gauge
            for u in batch:
                u.size *= self._inflation_factor(u.worker, t)
            if self.transport.policy == "bounded":
                gauge("transport/allowed_loss").set(
                    self.transport.allowed_loss())
        # the scheduler plans entirely on copy-on-write overlays, so the
        # lagged view is passed by reference — the old per-batch deep copy
        # was O(hosts) and dominated planning cost at U=4096
        plan = self.scheduler.schedule_batch(batch, self.net_lagged, t_now=t)
        if inflate:
            for u, s in orig_sizes:
                u.size = s
        self.result.scheduler_wall_time += _time.perf_counter() - w0
        self.result.scheduler_batches += 1
        # sim-time only in the trace: planner wall-clock goes to metrics, so
        # the chrome export stays byte-deterministic for the golden test
        self.trace.instant("plan", cat="scheduler", track="scheduler", ts=t,
                           args={"batch": batch_idx, "updates": len(batch),
                                 "planned": len(plan.order),
                                 "dropped": len(plan.dropped)})
        if self.crit.enabled:
            self.crit.planned(t, [g.uid for g in plan.order])

        # Enact the plan on the *actual* network: replay the same structure
        # (order, grouping) and take true completion times from it.
        commit_times = self._enact(plan.aggregation, t)

        for g in plan.dropped:
            meta = self._uid_meta.pop(g.uid)
            if self.on_drop:
                self.on_drop(meta["worker"], meta["version"])
            # dropped at the worker itself -> it restarts compute right away
            if meta["worker"] not in self._dead:
                self._schedule_compute(meta["worker"], t)

        if plan.replication is not None:
            # record the bound on EVERY planned batch (a batch that punts
            # everything is precisely when divergence grows)
            self.result.replica_divergence_trace.append(
                (t, plan.replication.divergence_after))
            t_catchup = self._enact_replica(plan.replication, t)
            # §5.3 lead reduction made real: the held server commits do
            # not apply until the extended frozen prefix has landed
            delayed = set(plan.replication.delayed_server_uids)
            self.result.server_commits_delayed += len(delayed)
            for uid in delayed:
                if uid in commit_times and commit_times[uid] < t_catchup:
                    commit_times[uid] = t_catchup
                    self.crit.hold(uid, t_catchup)

        for g in plan.order:
            if g.uid not in commit_times:
                continue    # transport gave up on it (reliable-mode fail)
            self._push_event(commit_times[g.uid], "commit", uid=g.uid,
                             epoch=self._commit_epoch.get(g.uid, 0),
                             aggregated=plan.aggregation.assignment.get(g.uid, 0) != 0)
        self.hooks.on_batch_end(self, batch_idx,
                                {"t": t, "planned": len(plan.order),
                                 "dropped": len(plan.dropped)})

    def _xargs(self, args: dict, tr: Transfer) -> dict:
        """Causal/link enrichment of span args (DESIGN.md §14).

        Adds the reservation's transfer id, the path's link ids, and the
        dominant binding link.  Only with an attribution collector
        attached — the pinned golden traces never see the extra keys.
        """
        if self.crit.enabled:
            args["xfer"] = tr.uid
            if tr.src != tr.dst:
                args["links"] = [f"{tr.src}:up", f"{tr.dst}:down"]
            bn = dominant_bottleneck(tr)
            if bn is not None:
                args["bottleneck"] = bn
        return args

    def _enact(self, agg: AggregationResult, t_now: float) -> Dict[int, float]:
        """Replay the plan's structure on the actual network -> true times.

        Byte accounting (pinned by tests against ``AggregationResult``):
        ``bytes_to_server`` counts only what crosses the server's downlink —
        each direct update once, and one ``max(member sizes)`` aggregate per
        aggregator group (summing gradients keeps tensor size, §3.2).
        Member->aggregator hops never land in ``bytes_to_server``; they are
        charged to ``bytes_in_network``, which counts every hop.
        """
        if isinstance(agg, SwitchPlanResult):
            return self._enact_switch(agg, t_now)
        commit: Dict[int, float] = {}
        server = self.cfg.server
        failed: List[Tuple[int, float]] = []
        for grp in agg.groups:
            if grp.aggregator is None:
                for g in grp.members:
                    tr, t_done, chain, ok = self._deliver(
                        g.worker, server, g.size, max(g.t_avail, t_now),
                        uid=g.uid, kind="direct", to_server=True)
                    self.result.bytes_to_server += g.size
                    self.result.bytes_in_network += g.size
                    self._inflight[g.uid] = {"update": g, "aggregator": None,
                                             "transfer": tr,
                                             "xmit_chain": chain}
                    self.crit.principal(g.uid, "direct", tr, t_done, chain)
                    self.trace.span(f"{g.worker}->{server}", cat="transfer",
                                    track=g.worker, ts=tr.t_start,
                                    dur=tr.t_end - tr.t_start,
                                    args=self._xargs(
                                        {"uid": g.uid, "bytes": g.size,
                                         "kind": "direct"}, tr))
                    if ok:
                        commit[g.uid] = t_done
                    else:
                        failed.append((g.uid, t_done))
            else:
                t_ready = t_now
                agg_size = 0.0
                ok_members = []
                for g in grp.members:
                    tr, t_done, chain, ok = self._deliver(
                        g.worker, grp.aggregator, g.size,
                        max(g.t_avail, t_now),
                        uid=g.uid, kind="member", to_server=False)
                    self.result.bytes_in_network += g.size
                    self._inflight[g.uid] = {"update": g,
                                             "aggregator": grp.aggregator,
                                             "transfer": tr,
                                             "xmit_chain": chain}
                    self.crit.principal(g.uid, "member", tr, t_done, chain)
                    self.trace.span(f"{g.worker}->{grp.aggregator}",
                                    cat="transfer", track=g.worker,
                                    ts=tr.t_start, dur=tr.t_end - tr.t_start,
                                    args=self._xargs(
                                        {"uid": g.uid, "bytes": g.size,
                                         "kind": "member"}, tr))
                    if ok:
                        t_ready = max(t_ready, t_done)
                        agg_size = max(agg_size, g.size)
                        ok_members.append(g)
                    else:
                        failed.append((g.uid, t_done))
                if ok_members:
                    tr, t_done, chain, ok = self._deliver(
                        grp.aggregator, server, agg_size, t_ready,
                        uid=None, kind="aggregate", to_server=True)
                    self.result.bytes_to_server += agg_size
                    self.result.bytes_in_network += agg_size
                    for g in ok_members:
                        self._inflight[g.uid]["agg_transfer"] = tr
                        self._inflight[g.uid]["agg_chain"] = chain
                        self.crit.hop(g.uid, 1, t_ready, tr, t_done, chain)
                        if ok:
                            commit[g.uid] = t_done
                        else:
                            failed.append((g.uid, t_done))
                    self.trace.span(
                        f"{grp.aggregator}->{server} (x{len(ok_members)})",
                        cat="aggregate", track=grp.aggregator,
                        ts=tr.t_start, dur=tr.t_end - tr.t_start,
                        args=self._xargs(
                            {"members": sorted(g.uid for g in ok_members),
                             "bytes": agg_size}, tr))
        for uid, t_fail in failed:
            self._push_event(t_fail, "transport_fail", uid=uid)
        return commit

    def _enact_switch(self, agg: SwitchPlanResult,
                      t_now: float) -> Dict[int, float]:
        """Replay a switch/hierarchical backend plan on the actual network.

        Pod members stream ``wire_size`` int8 bytes to their switch; the
        pod sum drains upstream from the first-complete-window time
        (recomputed on the *actual* member profiles) and a uid's commit is
        clamped to its pod's last member stream — the final window cannot
        drain before every member delivered it.  Hierarchical plans route
        the drain through the host tier (``host_plan``'s pseudo-updates);
        spilled updates take the verbatim host path inside that same plan.
        """
        commit: Dict[int, float] = {}
        server = self.cfg.server
        failed: List[Tuple[int, float]] = []
        slot_bytes = self.switch_cfg.slot_bytes
        self.result.switch_spills += agg.spill_count
        peak = self.result.metrics.gauge("switch/occupancy_peak")
        if agg.occupancy_peak > peak.value:
            peak.set(agg.occupancy_peak)

        # -- intra-pod stage: member streams into each switch ------------- #
        pod_state: Dict[int, dict] = {}     # pseudo uid -> enacted pod state
        for sg in agg.switch_groups:
            ok_members: List[Update] = []
            t_ready = t_now
            t_first = t_now
            for g in sg.members:
                wsize = sg.wire_sizes[g.uid]
                tr, t_done, chain, ok = self._deliver(
                    g.worker, sg.switch, wsize, max(g.t_avail, t_now),
                    uid=g.uid, kind="member", to_server=False)
                self.result.bytes_in_network += wsize
                self._inflight[g.uid] = {"update": g, "aggregator": sg.switch,
                                         "transfer": tr, "xmit_chain": chain,
                                         "wire_size": wsize}
                self.crit.principal(g.uid, "switch-member", tr, t_done, chain)
                self.trace.span(f"{g.worker}->{sg.switch}", cat="transfer",
                                track=g.worker, ts=tr.t_start,
                                dur=tr.t_end - tr.t_start,
                                args=self._xargs(
                                    {"uid": g.uid, "bytes": wsize,
                                     "kind": "switch-member"}, tr))
                if ok:
                    ok_members.append(g)
                    t_ready = max(t_ready, t_done)
                    t_first = max(t_first, profile_time_to(
                        tr.profile, min(slot_bytes, wsize)))
                else:
                    failed.append((g.uid, t_done))
            if not ok_members:
                continue
            self.result.switch_groups += 1
            if sg.pseudo_uid is not None:
                pod_state[sg.pseudo_uid] = {"sg": sg, "ok": ok_members,
                                            "t_ready": t_ready,
                                            "t_first": t_first}
                continue
            # pure switch: the pod sum drains straight to the server
            tr2, t_done2, chain2, ok2 = self._deliver(
                sg.switch, server, sg.drain_size, max(t_first, t_now),
                uid=None, kind="aggregate", to_server=True)
            self.result.bytes_to_server += sg.drain_size
            self.result.bytes_in_network += sg.drain_size
            self.result.switch_drains += 1
            for g in ok_members:
                info = self._inflight[g.uid]
                info["agg_transfer"] = tr2
                info["agg_chain"] = chain2
                # ready=t_ready: commit waits for the slowest member
                # stream even after the drain lands (final-window clamp)
                self.crit.hop(g.uid, 1, max(t_first, t_now), tr2, t_done2,
                              chain2, ready=t_ready)
                if ok2:
                    commit[g.uid] = max(t_done2, t_ready)
                else:
                    failed.append((g.uid, t_done2))
            self.trace.span(f"{sg.switch}->{server} (x{len(ok_members)})",
                            cat="switch", track=sg.switch, ts=tr2.t_start,
                            dur=tr2.t_end - tr2.t_start,
                            args=self._xargs(
                                {"members": sorted(g.uid for g in ok_members),
                                 "bytes": sg.drain_size, "pod": sg.pod,
                                 "slots": sg.max_occupancy}, tr2))

        # -- host tier: spilled updates + (hierarchical) pod drains -------- #
        host_plan = agg.host_plan
        for grp in (host_plan.groups if host_plan is not None else []):
            if grp.aggregator is None:
                for g in grp.members:
                    if g.uid < 0:
                        self._enact_pod_drain(pod_state.get(g.uid), server,
                                              t_now, commit, failed,
                                              direct=True)
                        continue
                    tr, t_done, chain, ok = self._deliver(
                        g.worker, server, g.size, max(g.t_avail, t_now),
                        uid=g.uid, kind="direct", to_server=True)
                    self.result.bytes_to_server += g.size
                    self.result.bytes_in_network += g.size
                    self._inflight[g.uid] = {"update": g, "aggregator": None,
                                             "transfer": tr,
                                             "xmit_chain": chain}
                    # real uids in a switch plan's host tier are spills
                    self.crit.principal(g.uid, "spill-direct", tr, t_done,
                                        chain)
                    sargs = {"uid": g.uid, "bytes": g.size, "kind": "direct"}
                    if self.crit.enabled:
                        sargs["spill"] = agg.spill_reasons.get(g.uid, "spill")
                    self.trace.span(f"{g.worker}->{server}", cat="transfer",
                                    track=g.worker, ts=tr.t_start,
                                    dur=tr.t_end - tr.t_start,
                                    args=self._xargs(sargs, tr))
                    if ok:
                        commit[g.uid] = t_done
                    else:
                        failed.append((g.uid, t_done))
                continue
            # host aggregator group: real spilled members and/or pod drains
            t_ready = t_now
            agg_size = 0.0
            ok_real: List[Update] = []
            pods_in: List[dict] = []
            for g in grp.members:
                if g.uid < 0:
                    st = pod_state.get(g.uid)
                    if st is None:
                        continue    # every member of the pod failed en route
                    sg = st["sg"]
                    tr, t_done, chain, ok = self._deliver(
                        sg.switch, grp.aggregator, sg.drain_size,
                        max(st["t_first"], t_now),
                        uid=None, kind="member", to_server=False)
                    self.result.bytes_in_network += sg.drain_size
                    self.result.switch_drains += 1
                    for m in st["ok"]:
                        info = self._inflight[m.uid]
                        info["agg_transfer"] = tr
                        info["agg_chain"] = chain
                        info["agg_to_server"] = False
                        info["agg_hosts"] = (grp.aggregator,)
                        self.crit.hop(m.uid, 1, max(st["t_first"], t_now),
                                      tr, t_done, chain)
                    self.trace.span(
                        f"{sg.switch}->{grp.aggregator} "
                        f"(x{len(st['ok'])})",
                        cat="switch", track=sg.switch, ts=tr.t_start,
                        dur=tr.t_end - tr.t_start,
                        args=self._xargs(
                            {"members": sorted(m.uid for m in st["ok"]),
                             "bytes": sg.drain_size, "pod": sg.pod,
                             "slots": sg.max_occupancy}, tr))
                    if ok:
                        t_ready = max(t_ready, t_done, st["t_ready"])
                        agg_size = max(agg_size, sg.drain_size)
                        pods_in.append(st)
                    else:
                        for m in st["ok"]:
                            failed.append((m.uid, t_done))
                    continue
                tr, t_done, chain, ok = self._deliver(
                    g.worker, grp.aggregator, g.size, max(g.t_avail, t_now),
                    uid=g.uid, kind="member", to_server=False)
                self.result.bytes_in_network += g.size
                self._inflight[g.uid] = {"update": g,
                                         "aggregator": grp.aggregator,
                                         "transfer": tr, "xmit_chain": chain}
                self.crit.principal(g.uid, "spill-member", tr, t_done, chain)
                sargs = {"uid": g.uid, "bytes": g.size, "kind": "member"}
                if self.crit.enabled:
                    sargs["spill"] = agg.spill_reasons.get(g.uid, "spill")
                self.trace.span(f"{g.worker}->{grp.aggregator}",
                                cat="transfer", track=g.worker,
                                ts=tr.t_start, dur=tr.t_end - tr.t_start,
                                args=self._xargs(sargs, tr))
                if ok:
                    t_ready = max(t_ready, t_done)
                    agg_size = max(agg_size, g.size)
                    ok_real.append(g)
                else:
                    failed.append((g.uid, t_done))
            if not (ok_real or pods_in):
                continue
            tr2, t_done2, chain2, ok2 = self._deliver(
                grp.aggregator, server, agg_size, t_ready,
                uid=None, kind="aggregate", to_server=True)
            self.result.bytes_to_server += agg_size
            self.result.bytes_in_network += agg_size
            uids = []
            for g in ok_real:
                info = self._inflight[g.uid]
                info["agg_transfer"] = tr2
                info["agg_chain"] = chain2
                uids.append(g.uid)
                self.crit.hop(g.uid, 2, t_ready, tr2, t_done2, chain2)
                if ok2:
                    commit[g.uid] = t_done2
                else:
                    failed.append((g.uid, t_done2))
            for st in pods_in:
                for m in st["ok"]:
                    info = self._inflight.get(m.uid)
                    if info is not None:
                        info["agg2_transfer"] = tr2
                        info["agg2_chain"] = chain2
                    uids.append(m.uid)
                    self.crit.hop(m.uid, 2, t_ready, tr2, t_done2, chain2)
                    if ok2:
                        commit[m.uid] = t_done2
                    else:
                        failed.append((m.uid, t_done2))
            self.trace.span(f"{grp.aggregator}->{server} (x{len(uids)})",
                            cat="aggregate", track=grp.aggregator,
                            ts=tr2.t_start, dur=tr2.t_end - tr2.t_start,
                            args=self._xargs({"members": sorted(uids),
                                              "bytes": agg_size}, tr2))

        for uid, t_fail in failed:
            self._push_event(t_fail, "transport_fail", uid=uid)
        return commit

    def _enact_pod_drain(self, st: Optional[dict], server: str, t_now: float,
                         commit: Dict[int, float],
                         failed: List[Tuple[int, float]], *,
                         direct: bool) -> None:
        """Drain one pod's sum directly to the server (the host tier put
        the pseudo-update in the direct group)."""
        if st is None:
            return      # every member of the pod failed en route
        sg = st["sg"]
        tr, t_done, chain, ok = self._deliver(
            sg.switch, server, sg.drain_size, max(st["t_first"], t_now),
            uid=None, kind="aggregate", to_server=True)
        self.result.bytes_to_server += sg.drain_size
        self.result.bytes_in_network += sg.drain_size
        self.result.switch_drains += 1
        for m in st["ok"]:
            info = self._inflight[m.uid]
            info["agg_transfer"] = tr
            info["agg_chain"] = chain
            self.crit.hop(m.uid, 1, max(st["t_first"], t_now), tr, t_done,
                          chain, ready=st["t_ready"])
            if ok:
                commit[m.uid] = max(t_done, st["t_ready"])
            else:
                failed.append((m.uid, t_done))
        self.trace.span(f"{sg.switch}->{server} (x{len(st['ok'])})",
                        cat="switch", track=sg.switch, ts=tr.t_start,
                        dur=tr.t_end - tr.t_start,
                        args=self._xargs(
                            {"members": sorted(m.uid for m in st["ok"]),
                             "bytes": sg.drain_size, "pod": sg.pod,
                             "slots": sg.max_occupancy}, tr))

    def _deliver(self, src: str, dst: str, size: float, t_avail: float, *,
                 uid: Optional[int], kind: str, to_server: bool,
                 to_replica: bool = False,
                 ) -> Tuple[Transfer, float, List[Transfer], bool]:
        """Reserve one payload transfer plus any transport repair rounds.

        Returns ``(tr, t_done, chain, ok)``: the principal reservation, the
        time the payload is *usefully* complete (last repair round landed),
        the list of repair-round reservations, and whether the transport
        succeeded.  With no transport configured, or while no loss timeline
        exists, this is byte-for-byte the pre-transport reserve path — one
        ``reserve`` call, ``t_done == tr.t_end`` — which is what keeps a
        zero-loss run golden-identical.

        Repair rounds (``"reliable"``, or ``"bounded"`` excess/corruption)
        ride the sender's *residual* capacity: the principal reservation is
        already booked, so each round is a fresh greedy profile over
        whatever the schedule left, ``backoff_base * backoff_factor^k``
        after the previous round finished.  Rounds themselves are repaired
        to completion (the receiver knows exactly which chunks are still
        missing), shrinking the residual geometrically; below
        ``tolerance_bytes`` the transfer counts as delivered.  Charges to
        ``bytes_in_network`` (and ``bytes_to_server`` for server-bound
        hops) match the refunds in the cancellation paths.
        """
        tr = self.net_actual.reserve(src, dst, size, t_avail)
        tc = self.transport
        if tc is None or not self.loss_actual.active:
            return tr, tr.t_end, [], True
        drop, corrupt = self.loss_actual.transfer_loss(src, dst, tr.profile)
        if drop <= 0.0 and corrupt <= 0.0:
            return tr, tr.t_end, [], True
        m = self.result.metrics
        if drop > 0.0:
            m.counter("transport/bytes_lost").inc(size * drop)
        if corrupt > 0.0:
            m.counter("transport/bytes_corrupted").inc(size * corrupt)
        if tc.policy == "bounded" and drop > 0.0:
            accepted = min(drop, tc.allowed_loss())
            if accepted > 0.0:
                m.counter("transport/bytes_accepted").inc(size * accepted)
        remaining = size * tc.repair_fraction(drop, corrupt)
        if remaining <= tc.tolerance_bytes:
            return tr, tr.t_end, [], True
        chain: List[Transfer] = []
        t_done = tr.t_end
        deadline = t_avail + tc.deadline
        backoff = tc.backoff_base
        rounds = 0
        while remaining > tc.tolerance_bytes:
            if rounds >= tc.max_retries:
                self.result.transport_expired += 1
                self.trace.instant("transport_expired", cat="transport",
                                   track=src, ts=t_done,
                                   args={"uid": uid, "kind": kind,
                                         "residual": remaining})
                return tr, t_done, chain, False
            t_retry = t_done + backoff
            if t_retry > deadline:
                self.result.transport_timeouts += 1
                self.trace.instant("transport_timeout", cat="transport",
                                   track=src, ts=t_done,
                                   args={"uid": uid, "kind": kind,
                                         "residual": remaining})
                return tr, t_done, chain, False
            rtr = self.net_actual.reserve(src, dst, remaining, t_retry)
            chain.append(rtr)
            self.result.retransmits += 1
            m.counter("transport/bytes_retransmitted").inc(remaining)
            self.result.bytes_in_network += remaining
            if to_server:
                self.result.bytes_to_server += remaining
            if to_replica:
                self.result.bytes_to_replica += remaining
            self.trace.span(f"retry{rounds + 1} {src}->{dst}",
                            cat="transport", track=src, ts=rtr.t_start,
                            dur=rtr.t_end - rtr.t_start,
                            args=self._xargs(
                                {"uid": uid, "kind": kind,
                                 "bytes": remaining, "backoff": backoff},
                                rtr))
            d2, c2 = self.loss_actual.transfer_loss(src, dst, rtr.profile)
            if d2 > 0.0:
                m.counter("transport/bytes_lost").inc(remaining * d2)
            if c2 > 0.0:
                m.counter("transport/bytes_corrupted").inc(remaining * c2)
            remaining *= d2 + c2    # repair rounds must land fully
            t_done = rtr.t_end
            backoff *= tc.backoff_factor
            rounds += 1
        return tr, t_done, chain, True

    def _inflation_factor(self, worker: str, t: float) -> float:
        """Expected total-bytes multiplier for SJF planning: geometric sum
        of repair rounds, ``1 / (1 - p_repair)``, from the lagged loss
        view of the worker->server path (capped at ``max_inflation``)."""
        tc = self.transport
        drop, corrupt = self.loss_lagged.instant_loss(worker, self.cfg.server, t)
        p = tc.repair_fraction(drop, (1.0 - drop) * corrupt)
        if p <= 0.0:
            return 1.0
        if p >= 1.0:
            return tc.max_inflation
        return min(1.0 / (1.0 - p), tc.max_inflation)

    def _release_chain(self, t: float, chain, *, to_server: bool) -> None:
        """Free a cancelled delivery's unfinished repair-round reservations
        (mirrors the per-round charges in :meth:`_deliver`)."""
        for ctr in chain:
            self._release_unfinished(
                t, ctr, refund_server=ctr.size if to_server else 0.0,
                refund_network=ctr.size)

    def _on_transport_fail(self, t: float, uid: int) -> None:
        """The transport gave up on ``uid`` (deadline or retries): the
        update is dropped and its worker recomputes — same recovery as a
        scenario drop, separately counted.  A uid already cancelled by a
        topology event (leave/failover) arrives here with no metadata and
        is a no-op."""
        self._inflight.pop(uid, None)
        meta = self._uid_meta.pop(uid, None)
        if meta is None:
            return
        self._cancel_commit(uid)
        self.result.record_scenario_drop()
        if self.on_drop:
            self.on_drop(meta["worker"], meta["version"])
        if meta["worker"] not in self._dead:
            self._schedule_compute(meta["worker"], t)

    def _enact_replica(self, rep, t_now: float) -> float:
        """Enact this batch's frozen replica copies on the actual network.

        Copies ride on *spare* capacity by construction: their reservations
        are made after every server-bound reservation of the same batch, so
        they only consume what the primary schedule left over.  Enactment
        is direct source->replica per frozen update (the replica-aggregator
        topology shapes the *plan*'s freeze/punt decision; see DESIGN.md
        §9); a departed owner's copy is sourced from the server, which
        holds the committed update.  Returns the catch-up time — when the
        last copy of the frozen prefix lands (``t_now`` if nothing froze).

        Copies ride the same lossy links as everything else: under an
        active transport each copy pays retransmit/backoff costs through
        :meth:`_deliver` (ROADMAP item 3 headroom closed).  Replication
        can never *accept* loss — a partial copy would break the replica's
        exact-prefix invariant — so a copy whose transport gives up
        (deadline/retries) is re-sourced from the server once, on the
        ideal path, after the failed attempt ends.
        """
        replica = self.cfg.replica
        t_catchup = t_now
        for u in rep.frozen:
            src = u.worker if u.worker not in self._dead else self.cfg.server
            tr, t_done, chain, ok = self._deliver(
                src, replica, u.size, max(u.t_avail, t_now),
                uid=u.uid, kind="replica", to_server=False, to_replica=True)
            self.result.bytes_to_replica += u.size
            self.result.bytes_in_network += u.size
            self._replica_inflight[u.uid] = {"update": u, "transfer": tr,
                                             "xmit_chain": chain}
            self.trace.span(f"{src}->{replica}", cat="replica", track=src,
                            ts=tr.t_start, dur=tr.t_end - tr.t_start,
                            args={"uid": u.uid, "bytes": u.size})
            if not ok:
                rtr = self.net_actual.reserve(self.cfg.server, replica,
                                              u.size, t_done)
                self.result.bytes_to_replica += u.size
                self.result.bytes_in_network += u.size
                self.result.replica_resourced += 1
                self._replica_inflight[u.uid]["transfer"] = rtr
                t_done = rtr.t_end
                self.trace.span(f"{self.cfg.server}->{replica} (re-source)",
                                cat="replica", track=self.cfg.server,
                                ts=rtr.t_start, dur=rtr.t_end - rtr.t_start,
                                args={"uid": u.uid, "bytes": u.size})
            t_catchup = max(t_catchup, t_done)
            self._push_event(t_done, "replica_arrive", uid=u.uid,
                             epoch=self._replica_epoch.get(u.uid, 0))
        return t_catchup

    def _on_replica_arrive(self, t: float, uid: int, epoch: int = 0) -> None:
        if epoch != self._replica_epoch.get(uid, 0):
            return  # stale: copy was cancelled or re-sourced
        self._replica_inflight.pop(uid, None)
        self._replica_arrived.add(uid)
        self._drain_replica_commits(t)

    def _drain_replica_commits(self, t: float) -> None:
        """Release replica commits strictly in server-commit order: the
        queue head must both have server-committed (it is in the queue)
        and have its copy landed (it is in ``_replica_arrived``)."""
        while self._replica_next < len(self._replica_queue):
            uid = self._replica_queue[self._replica_next]
            if uid not in self._replica_arrived:
                break
            self._replica_next += 1
            self._replica_arrived.discard(uid)
            self._replica_gap.pop(uid, None)
            self.v_replica += 1
            self.result.replica_commits += 1
            self.trace.instant("replica_commit", cat="replica",
                               track=self.cfg.replica, ts=t,
                               args={"uid": uid, "v_replica": self.v_replica})
            if self.on_replica_commit:
                self.on_replica_commit(uid, t)

    def _on_commit(self, t: float, uid: int, aggregated: bool,
                   epoch: int = 0) -> None:
        if epoch != self._commit_epoch.get(uid, 0):
            return  # stale event: the update was re-routed or lost
        self._inflight.pop(uid, None)
        meta = self._uid_meta.pop(uid)
        rec = CommitRecord(time=t, worker=meta["worker"], uid=uid,
                           version_used=meta["version"],
                           version_committed=self.v_server,
                           aggregated=aggregated)
        self.v_server += 1
        self.result.record_commit(rec)
        self.trace.instant("commit", cat="commit", track=self.cfg.server,
                           ts=t, args={"uid": uid, "worker": rec.worker,
                                       "delay": rec.delay,
                                       "aggregated": aggregated})
        if self._replica_promoted and self._fail_time is not None \
                and self.result.recovery_time == math.inf:
            self.result.recovery_time = t - self._fail_time
        self.hooks.on_commit(self, rec)
        if self.on_commit:
            self.on_commit(rec)
        if self.cfg.replica is not None:
            # the server's apply sequence IS the replica's apply sequence:
            # this uid joins the release queue (and the gap, until its
            # copy lands and every earlier commit has been released).
            # After ``on_commit`` — the trainer stages the committed
            # payload for the replica inside that callback.
            self._replica_gap[uid] = meta
            self._replica_queue.append(uid)
            self._drain_replica_commits(t)
        # worker pulls the fresh model and starts the next mini-batch.
        if meta["worker"] not in self._dead:
            pull = self.net_actual.transfer_time(self.cfg.server, meta["worker"],
                                                 self.model_size, t)
            self._schedule_compute(meta["worker"], pull)
