"""MLfabric core: the paper's contribution as a composable library.

Layers (bottom-up):

* ``network``     — time-varying link model + bandwidth reservation (Fig. 4)
* ``ordering``    — Alg. 2 update ordering (SJF + deadlines + drop rule)
* ``aggregation`` — Alg. 3 in-network aggregation groups (+ §10.3 distribution)
* ``backends``    — pluggable aggregation strategies: host / switch / hierarchical
* ``replication`` — §5.3 bounded-consistency replication (norm-bound, eq. 10)
* ``delay``       — §3.1 delay management / adaptive LR (eq. 4)
* ``scheduler``   — §4 batch scheduler composing the three algorithms
* ``scenario``    — dynamic-cluster event timelines (join/leave/fail/traces)
* ``simulator``   — §7 discrete-event cluster harness (C/N settings)
* ``baselines``   — vanilla async PS, RR-Sync, Tr-Sync comparisons
* ``optimal``     — §10.1 exact reference for tiny instances
"""

from .network import LossSchedule, NetworkState, Timeline, Transfer, gbps, mb
from .ordering import Update, OrderingResult, assign_deadlines, order_updates
from .aggregation import AggregationResult, aggregate_updates, plan_distribution
from .backends import (AggregationBackend, HostBackend, SwitchBackend,
                       SwitchConfig, SwitchPlanResult, make_backend)
from .replication import (ReplicationResult, ReplicationState,
                          divergence_bound, plan_replication)
from .delay import DelayTracker, adadelay_lr, bounded_delay_lr, convergence_bound
from .scheduler import BatchPlan, MLfabricScheduler, SchedulerConfig
from .scenario import (AggregatorFail, BandwidthTrace, LinkDegrade,
                       MonitorLagChange, PacketLoss, ReplicaPromote, Scenario,
                       ScenarioEvent, ServerFail, SwitchFail, WorkerJoin,
                       WorkerLeave, bandwidth_trace)
from .simulator import (BandwidthModel, ClusterSim, CommitRecord, SimResult,
                        StragglerModel, TransportConfig,
                        C1, C2, C3, N1, N2, N3, N_STATIC)
from .baselines import (FairShareAsync, SyncSim, max_min_rates,
                        ring_allreduce_time, tree_allreduce_time)
from .optimal import brute_force_schedule

__all__ = [
    "LossSchedule", "NetworkState", "Timeline", "Transfer", "gbps", "mb",
    "Update", "OrderingResult", "assign_deadlines", "order_updates",
    "AggregationResult", "aggregate_updates", "plan_distribution",
    "AggregationBackend", "HostBackend", "SwitchBackend", "SwitchConfig",
    "SwitchPlanResult", "make_backend",
    "ReplicationResult", "ReplicationState", "divergence_bound",
    "plan_replication",
    "DelayTracker", "adadelay_lr", "bounded_delay_lr", "convergence_bound",
    "BatchPlan", "MLfabricScheduler", "SchedulerConfig",
    "Scenario", "ScenarioEvent", "WorkerJoin", "WorkerLeave",
    "AggregatorFail", "SwitchFail", "BandwidthTrace", "MonitorLagChange",
    "ServerFail", "ReplicaPromote", "PacketLoss", "LinkDegrade",
    "bandwidth_trace",
    "BandwidthModel", "ClusterSim", "CommitRecord", "SimResult",
    "StragglerModel", "TransportConfig",
    "C1", "C2", "C3", "N1", "N2", "N3", "N_STATIC",
    "FairShareAsync", "SyncSim", "max_min_rates", "ring_allreduce_time",
    "tree_allreduce_time", "brute_force_schedule",
]
