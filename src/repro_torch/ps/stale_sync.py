"""Stale-synchronous (SSP) training (paper §6).

SSP lets fast workers run ahead of the slowest by at most K iterations
(typically K~2).  The paper's §6 comparison: with K=2 the max model
staleness is 2*num_workers, but a worker >2x slower than the rest *halts
everyone*; MLfabric-A with delay bound tau_max = 2*num_workers gives the
same staleness guarantee without halting — which `compare_ssp_mlfabric`
demonstrates.  MLfabric's contribution to SSP itself is update aggregation
(in-network control), which SSP implementations typically lack.
"""

from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.harness import HookBus, StepLoop, make_bus
from ..core.network import NetworkState, gbps, mb
from ..core.ordering import Update
from ..core.scheduler import MLfabricScheduler, SchedulerConfig
from ..core.simulator import BandwidthModel, N_STATIC, StragglerModel, C1


@dataclass
class SSPResult:
    sim_time: float
    iterations_done: Dict[str, int]
    halt_time: float = 0.0          # total time fast workers spent blocked

    @property
    def throughput(self) -> float:
        return sum(self.iterations_done.values()) / max(self.sim_time, 1e-9)


class StaleSyncSim:
    """Timing model of SSP: worker i may start iteration t only when every
    other worker has finished iteration t - K."""

    def __init__(self, n_workers: int, *, k: int = 2,
                 compute_time: float = 0.1, update_size: float = mb(100),
                 straggler: StragglerModel = C1,
                 bandwidth: BandwidthModel = N_STATIC,
                 default_bw: float = gbps(10), seed: int = 0,
                 aggregate: bool = False, aggregators: int = 2,
                 callbacks=(), hooks: Optional[HookBus] = None):
        self.hooks = hooks if hooks is not None else make_bus(callbacks)
        self.n = n_workers
        self.k = k
        self.compute = compute_time
        self.size = update_size
        self.straggler = straggler
        self.rng = random.Random(seed)
        self.default_bw = default_bw
        self.aggregate = aggregate
        self.aggregators = aggregators

    def run(self, n_iterations: int) -> SSPResult:
        # finish[w][t] = time worker w finishes iteration t
        finish = [[0.0] * (n_iterations + 1) for _ in range(self.n)]
        halt = 0.0

        def _iteration(idx: int, t: int) -> Dict[str, float]:
            nonlocal halt
            for w in range(self.n):
                # SSP barrier: wait for everyone's iteration t-K
                gate = 0.0
                if t - self.k >= 1:
                    gate = max(finish[v][t - self.k] for v in range(self.n))
                start = max(finish[w][t - 1], gate)
                halt += max(0.0, gate - finish[w][t - 1])
                comp = self.compute * self.straggler.sample(self.rng)
                # communication: push the update to the server
                comm = self.size / self.default_bw
                if self.aggregate:
                    # MLfabric-style aggregation amortizes server-side
                    # bandwidth across the group (best case 1/groups)
                    comm = comm / max(min(self.aggregators + 1, self.n), 1)
                finish[w][t] = start + comp + comm
            return {"halt_time": halt}

        StepLoop(_iteration, bus=self.hooks, source=self).run(
            range(1, n_iterations + 1))
        sim_time = max(finish[w][n_iterations] for w in range(self.n))
        return SSPResult(sim_time=sim_time,
                         iterations_done={f"w{i}": n_iterations
                                          for i in range(self.n)},
                         halt_time=halt)


def compare_ssp_mlfabric(n_workers: int = 8, *, k: int = 2,
                         slow_factor: float = 4.0, n_iterations: int = 50,
                         seed: int = 0) -> Dict[str, float]:
    """Paper §6's argument, quantified: one worker slowed by ``slow_factor``
    halts SSP (fast workers idle at the K-barrier) while MLfabric-A with
    tau_max = K*n keeps everyone busy (no barrier; staleness bounded by
    the scheduler instead)."""
    from ..core.simulator import ClusterSim

    strag = StragglerModel(prob=1.0 / n_workers, factor=slow_factor)
    ssp = StaleSyncSim(n_workers, k=k, straggler=strag, seed=seed).run(
        n_iterations)

    cfg = SchedulerConfig(server="server",
                          aggregators=[f"worker{i}" for i in range(2)],
                          tau_max=k * n_workers, mode="async")
    fab = ClusterSim(n_workers, cfg, update_size=mb(100), compute_time=0.1,
                     straggler=strag, bandwidth=N_STATIC, seed=seed)
    fres = fab.run(until_commits=n_iterations * n_workers)
    return {
        "ssp_time": ssp.sim_time,
        "ssp_halt_time": ssp.halt_time,
        "mlfabric_time": fres.sim_time,
        "mlfabric_max_delay": float(fres.delay.max),
        "staleness_bound": float(k * n_workers),
    }
