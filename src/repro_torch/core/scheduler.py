"""The MLfabric scheduler (paper §4-5): ordering -> aggregation -> replication.

Per batch of ready updates the scheduler runs, in sequence,

  1. ``order_updates``     (Alg. 2)  — transfer/apply order, delay bounds,
                                        look-ahead drops;
  2. the aggregation backend (Alg. 3 for ``backend="host"``; see
     ``core/backends.py``)          — partition into direct + aggregator
                                        groups, concrete transfer schedules;
  3. ``plan_replication``  (§5.3)    — opportunistic replica copies under a
                                        divergence bound.

yielding delay-bounded, divergence-bounded, network-efficient fast model
updates.  The scheduler only ever sees update *metadata* (size, version,
norm) — never tensors — mirroring the paper's control/data separation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .aggregation import AggregationResult
from .backends import make_backend
from .network import NetworkState
from .ordering import Update, OrderingResult, order_updates
from .replication import ReplicationResult, ReplicationState, plan_replication


@dataclass
class SchedulerConfig:
    server: str
    aggregators: Sequence[str] = ()
    replica: Optional[str] = None
    replica_aggregators: Sequence[str] = ()
    tau_max: Optional[int] = None          # delay bound (None = unbounded)
    div_max: float = float("inf")          # divergence bound (replication)
    gamma: float = 0.9                     # server momentum (eq. 2)
    batch_interval: float = 0.1            # 100 ms batching (paper §7)
    mode: str = "async"                    # "async" | "sync" (§6)
    planner: str = "incremental"           # Alg. 3 planner ("exhaustive" ref)
    backend: str = "host"                  # "host" | "switch" | "hierarchical"
    switch: Optional[object] = None        # SwitchConfig (switch backends)


@dataclass
class BatchPlan:
    """Concrete schedules for one batch: the scheduler's full output."""

    ordering: OrderingResult
    aggregation: AggregationResult
    replication: Optional[ReplicationResult]
    # uid -> commit time at the server (aggregation-aware):
    commit_times: Dict[int, float] = field(default_factory=dict)

    @property
    def order(self) -> List[Update]:
        return self.ordering.order

    @property
    def dropped(self) -> List[Update]:
        return self.ordering.dropped

    @property
    def makespan(self) -> float:
        return self.aggregation.makespan


class MLfabricScheduler:
    """Stateful batch scheduler; owns the divergence bookkeeping."""

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self.backend = make_backend(config)
        self.replication_state = ReplicationState(
            gamma=config.gamma, div_max=config.div_max)
        self.v_server = 0          # model version at the server
        self.n_dropped = 0
        self.n_scheduled = 0

    # ------------------------------------------------------------------ #
    def schedule_batch(self, updates: Sequence[Update], network: NetworkState,
                       *, t_now: float = 0.0) -> BatchPlan:
        """Run the three algorithms on one batch against ``network``.

        ``network`` is the scheduler's *view* (possibly monitor-lagged).  It
        is never mutated: every pass plans on a copy-on-write overlay, and
        the accepted plan's reservations live in ``plan.aggregation.network``
        (an overlay whose base is ``network``).
        """
        cfg = self.config

        if cfg.mode == "sync":
            # §6: ordering does not apply to synchronous SGD - aggregation
            # starts from the plain update list (completion-time objective
            # switches to makespan, eq. 16).
            ordering = OrderingResult(order=list(updates), dropped=[],
                                      transfers={}, network=network)
            agg = self.backend.plan(ordering.order, network, cfg.server,
                                    cfg.aggregators, t_now=t_now,
                                    objective="makespan", planner=cfg.planner)
        else:
            # Plan the order on a scratch overlay (reservations are re-made
            # by the aggregation pass, which owns the concrete schedules).
            ordering = order_updates(list(updates), network.overlay(), cfg.server,
                                     tau_max=cfg.tau_max, v_init=self.v_server,
                                     t_now=t_now)
            agg = self.backend.plan(ordering.order, network, cfg.server,
                                    cfg.aggregators, t_now=t_now,
                                    objective="avg_commit",
                                    planner=cfg.planner)

        replication: Optional[ReplicationResult] = None
        if cfg.replica is not None:
            replication = plan_replication(
                ordering.order, agg.commit_times, agg.network, cfg.replica,
                cfg.replica_aggregators, self.replication_state, t_now=t_now)

        self.v_server += len(ordering.order)
        self.n_dropped += len(ordering.dropped)
        self.n_scheduled += len(ordering.order)

        return BatchPlan(ordering=ordering, aggregation=agg,
                         replication=replication,
                         commit_times=dict(agg.commit_times))

    # ------------------------------------------------------------------ #
    @property
    def drop_fraction(self) -> float:
        total = self.n_dropped + self.n_scheduled
        return self.n_dropped / total if total else 0.0
