"""MLfabric-S: synchronous SGD with network-aware aggregation (paper §6).

The PyTorch twin of ``repro/ps/sync_trainer.py``: the schedule comes from
the same copied scheduler and ``random.Random(seed)``, so one seed gives
one schedule in both packages; the gradients come from autograd.

Per iteration every worker computes a gradient on its mini-batch shard; the
batch of ready updates is handed to the scheduler in *sync* mode (no
ordering/dropping — Alg. 3 aggregation only), summed, and applied once.
``allreduce_via_ps`` realizes the paper's MPI AllReduce API on top of the
PS primitives: push(root, update) + get(root) with a randomly-chosen root.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.harness import HookBus, StepLoop, make_bus
from ..core.network import NetworkState, gbps, mb
from ..core.ordering import Update
from ..core.scheduler import MLfabricScheduler, SchedulerConfig
from ..core.simulator import BandwidthModel, N_STATIC, StragglerModel, C1
from ..device import DeviceLike, check_on_device, resolve_device
from ..models.api import value_and_grad
from ..optim.sgd import update_norm
from ..tree import tree_leaves, tree_map
from .server import ParameterServer

Params = Any


@dataclass
class SyncIterationStats:
    compute_time: float
    comm_time: float
    n_direct: int
    n_aggregated: int


class SyncTrainer:
    """Synchronous data-parallel SGD through the MLfabric scheduler.

    ``device`` is where the params must lie; it defaults to the card and
    raises on a host without one (pass ``device="cpu"`` to train on the
    CPU)."""

    def __init__(self, init_params: Params, loss_fn: Callable,
                 data_fn: Callable, *, n_workers: int = 8,
                 base_lr: float = 0.5, gamma: float = 0.9,
                 update_size: float = mb(100), compute_time: float = 0.1,
                 straggler: StragglerModel = C1,
                 bandwidth: BandwidthModel = N_STATIC,
                 default_bw: float = gbps(10), aggregators: int = 2,
                 seed: int = 0, has_aux: bool = False,
                 callbacks=(), hooks: Optional[HookBus] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on_device(tree_leaves(init_params), self.device, "a param")
        self.hooks = hooks if hooks is not None else make_bus(callbacks)
        self.server = ParameterServer(init_params, gamma=gamma)
        self.n_workers = n_workers
        self.base_lr = base_lr
        self.data_fn = data_fn
        self.compute_time = compute_time
        self.update_size = update_size
        self.straggler = straggler
        self.bandwidth = bandwidth
        self.default_bw = default_bw
        self.rng = random.Random(seed)
        self._loss_fn = loss_fn
        self._has_aux = has_aux
        self.agg_hosts = [f"worker{i}" for i in range(min(aggregators,
                                                          n_workers))]
        self.cfg = SchedulerConfig(server="server", aggregators=self.agg_hosts,
                                   gamma=gamma, mode="sync")
        self.scheduler = MLfabricScheduler(self.cfg)
        self.stats: List[SyncIterationStats] = []
        self._step = 0

    def _fresh_network(self) -> NetworkState:
        hosts = [f"worker{i}" for i in range(self.n_workers)] + ["server"]
        net = NetworkState(hosts, self.default_bw)
        for h in hosts[:-1]:
            net.set_bandwidth(h, 0.0, up=self.bandwidth.sample(self.rng),
                              down=self.bandwidth.sample(self.rng))
        return net

    def step(self) -> Tuple[float, SyncIterationStats]:
        """One synchronous iteration.  Returns (iteration wall time, stats)."""
        params, version = self.server.pull()
        # all workers compute on their shard of the global batch
        grads, norms = [], []
        compute_times = []
        for i in range(self.n_workers):
            batch = self.data_fn(f"worker{i}", self._step)
            _, g = value_and_grad(self._loss_fn, params, batch,
                                  has_aux=self._has_aux)
            grads.append(g)
            norms.append(float(update_norm(g)))
            compute_times.append(self.compute_time
                                 * self.straggler.sample(self.rng))
        t_compute = max(compute_times)   # sync: slowest worker gates

        # schedule the batch of ready updates through Alg. 3
        updates = [Update(uid=i, worker=f"worker{i}", size=self.update_size,
                          version=version, norm=norms[i], t_avail=compute_times[i])
                   for i in range(self.n_workers)]
        plan = self.scheduler.schedule_batch(updates, self._fresh_network(),
                                             t_now=0.0)
        t_comm = plan.makespan - t_compute if plan.makespan > t_compute else \
            plan.makespan
        n_agg = sum(1 for g in plan.aggregation.assignment.values() if g != 0)

        # apply the summed update (aggregation is a weighted sum -> the
        # server sees one combined update per iteration)
        with torch.no_grad():
            # a tensor divisor: on the card PyTorch turns division by a
            # Python number into a multiply by its reciprocal
            n = torch.tensor(len(grads), dtype=torch.float32,
                             device=self.device)
            mean_grad = tree_map(
                lambda *gs: sum(g.to(torch.float32) for g in gs) / n, *grads)
            update = tree_map(lambda g: -self.base_lr * g, mean_grad)
        self.server.push(update, version)
        self._step += 1

        stats = SyncIterationStats(compute_time=t_compute,
                                   comm_time=max(t_comm, 0.0),
                                   n_direct=plan.aggregation.n_direct,
                                   n_aggregated=n_agg)
        self.stats.append(stats)
        # sync mode applies ONE combined update per iteration: that is the
        # commit this driver reports to the harness
        self.hooks.on_commit(self, stats)
        return plan.makespan, stats

    def run(self, n_iterations: int) -> List[SyncIterationStats]:
        def _step(i: int, _item) -> Dict[str, float]:
            makespan, stats = self.step()
            return {"makespan": makespan, "compute_time": stats.compute_time,
                    "comm_time": stats.comm_time}

        StepLoop(_step, bus=self.hooks, source=self).run(range(n_iterations))
        return self.stats


def allreduce_via_ps(updates: List[Params], *, seed: int = 0) -> Params:
    """The paper's AllReduce API (§6): push all updates to a randomly-chosen
    root (acting as the aggregation-tree root) and read back the sum."""
    rng = random.Random(seed)
    root = rng.randrange(len(updates))  # noqa: F841 (root choice is nominal)
    return tree_map(lambda *xs: sum(x.to(torch.float32) for x in xs),
                    *updates)
