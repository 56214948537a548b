"""MLfabric-A: asynchronous PS training driven by the event simulator.

The simulator decides *when* each worker's update is computed and *in what
order* updates commit (delay-bounded, network-aware); this trainer supplies
the *values*: real gradients computed against the stale model the worker
pulled, applied at the server with eq. 2.  The PyTorch twin of
``repro/ps/async_trainer.py``: the control plane is the same copied
``ClusterSim``, so one seed gives one schedule in both packages.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.harness import HookBus, make_bus
from ..core.network import mb
from ..core.scenario import Scenario
from ..core.scheduler import SchedulerConfig
from ..core.simulator import (BandwidthModel, ClusterSim, CommitRecord,
                              N_STATIC, StragglerModel, C1)
from ..device import DeviceLike, check_on_device, resolve_device
from ..dist.flatbuf import flat_compress_roundtrip
from ..obs.trace import region
from ..tree import tree_leaves
from .replica import ReplicaServer
from .server import ParameterServer
from .worker import Worker

Params = Any


@dataclass
class AsyncTrainResult:
    losses: List[Tuple[float, float]] = field(default_factory=list)  # (time, loss)
    commits: int = 0
    drops: int = 0
    delay_stats: Dict[str, float] = field(default_factory=dict)
    sim_time: float = 0.0
    # fault-tolerance plane (replicate=True):
    replica_commits: int = 0
    promotions: int = 0
    recovery_time: float = math.inf
    regenerated: int = 0

    @property
    def final_loss(self) -> float:
        return self.losses[-1][1] if self.losses else math.inf


class AsyncTrainer:
    """Couples ClusterSim (timing) with real gradient computation.

    ``device`` is where the params must lie; it defaults to the card and
    raises on a host without one (pass ``device="cpu"`` to train on the
    CPU)."""

    def __init__(self, init_params: Params, loss_fn: Callable, data_fn: Callable,
                 *, n_workers: int = 8, tau_max: Optional[int] = 30,
                 base_lr: float = 0.5, gamma: float = 0.9,
                 delay_adaptive: bool = True, update_size: float = mb(100),
                 compute_time: float = 0.1,
                 straggler: StragglerModel = C1,
                 bandwidth: BandwidthModel = N_STATIC,
                 aggregators: int = 2, seed: int = 0,
                 scenario: Optional[Scenario] = None,
                 compress: bool = False,
                 replicate: bool = False, div_max: float = 2.0,
                 eval_fn: Optional[Callable] = None, has_aux: bool = False,
                 callbacks: Sequence[Any] = (),
                 hooks: Optional[HookBus] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_on_device(tree_leaves(init_params), self.device, "a param")
        self.hooks = hooks if hooks is not None else make_bus(callbacks)
        self.server = ParameterServer(init_params, gamma=gamma)
        # ``replicate`` runs a real-tensor ReplicaServer (§3.3) that applies
        # the identical decoded payloads in server-commit order, so primary
        # and replica agree bit for bit on their common prefix; on a
        # ``ServerFail`` scenario event the replica is promoted.
        self.replica = ReplicaServer(init_params, gamma=gamma) \
            if replicate else None
        self._replica_pending: Dict[int, Tuple[Params, int]] = {}
        # ``compress`` routes every worker update through the flat int8
        # wire (dist/flatbuf): one quantize over the packed update, the
        # fused dequantize+norm at the receiving end.  The simulator sees
        # the 4x-smaller wire size.
        self.compress = compress
        self.wire_size = update_size / (4.0 if compress else 1.0)
        self.data_fn = data_fn
        self.eval_fn = eval_fn
        self._worker_kw = dict(base_lr=base_lr, delay_adaptive=delay_adaptive,
                               has_aux=has_aux)
        self._loss_fn = loss_fn
        self.workers = {
            f"worker{i}": Worker(f"worker{i}", loss_fn, **self._worker_kw)
            for i in range(n_workers)}
        # the (single) in-flight update payload per worker
        self._payloads: Dict[str, Tuple[Params, int]] = {}
        self._t = 0

        agg_hosts = [f"worker{i}" for i in range(min(aggregators, n_workers))]
        cfg = SchedulerConfig(server="server", aggregators=agg_hosts,
                              tau_max=tau_max, gamma=gamma, mode="async",
                              replica="replica" if replicate else None,
                              replica_aggregators=(), div_max=div_max)
        self.sim = ClusterSim(
            n_workers, cfg, update_size=update_size,
            compute_time=compute_time, straggler=straggler,
            bandwidth=bandwidth, seed=seed, scenario=scenario,
            on_compute=self._on_compute, on_commit=self._on_commit,
            on_drop=self._on_drop, on_join=self._on_join,
            on_replica_commit=self._on_replica_commit if replicate else None,
            on_promote=self._on_promote if replicate else None,
            hooks=self.hooks)
        self.result = AsyncTrainResult()

    # -- dynamic membership (scenario WorkerJoin events) -------------------- #
    def _on_join(self, worker: str, t: float) -> None:
        if worker not in self.workers:
            self.workers[worker] = Worker(worker, self._loss_fn,
                                          **self._worker_kw)

    # -- simulator callbacks ------------------------------------------------ #
    # A worker has at most ONE update in flight (it pulls a new model only
    # after its previous push commits or is dropped), so a single payload
    # slot per worker is enough.
    def _on_compute(self, worker: str, version: int) -> Tuple[float, float]:
        """Simulator asks: worker computes an update against the CURRENT
        server model (the version it just pulled)."""
        with region("mlfabric.compute", worker=worker, version=version,
                    t=self._t):
            params, v = self.server.pull()
            with region("mlfabric.data"):
                batch = self.data_fn(worker, self._t)
            self._t += 1
            w = self.workers[worker]
            update, norm = w.compute_update(
                params, batch, version=v, t=self._t,
                observed_delay=int(self.server.delays.mean)
                if w.delay_adaptive else 0)
            if self.compress:
                update, norm = flat_compress_roundtrip(update)
        if worker in self._payloads:
            raise RuntimeError(f"{worker} already has an update in flight")
        self._payloads[worker] = (update, v)
        return self.wire_size, norm

    def _on_commit(self, rec: CommitRecord) -> None:
        update, version_used = self._payloads.pop(rec.worker)
        with region("mlfabric.commit", uid=rec.uid, worker=rec.worker,
                    version=version_used):
            self.server.push(update, version_used)
            if self.replica is not None:
                # stage the identical (already wire-decoded) payload for the
                # replica: the simulator releases it once the copy lands and
                # every earlier server commit has been replica-applied
                self._replica_pending[rec.uid] = (update, version_used)
            self.result.commits += 1
            if self.eval_fn and self.result.commits % 10 == 0:
                loss = float(self.eval_fn(self.server.params))
                self.result.losses.append((rec.time, loss))

    def _on_replica_commit(self, uid: int, t: float) -> None:
        update, version_used = self._replica_pending.pop(uid)
        self.replica.apply_replicated(update, version_used, uid)
        self.result.replica_commits += 1

    def _on_promote(self, t: float, gap: int) -> None:
        """§3.3 failover: the replica (an exact prefix of the primary's
        apply sequence) becomes the primary, momentum history included; the
        ``gap`` updates it never saw are regenerated by the restarted
        workers, not replayed."""
        self.server = self.replica
        self.replica = None
        self._replica_pending.clear()
        self.result.promotions += 1

    def _on_drop(self, worker: str, version: int) -> None:
        self._payloads.pop(worker, None)  # lost work (paper §5.1.3)

    # -- run ---------------------------------------------------------------- #
    def run(self, *, until_commits: int = 100,
            until_time: float = math.inf) -> AsyncTrainResult:
        with region("mlfabric.run"):
            sim_res = self.sim.run(until_commits=until_commits,
                                   until_time=until_time)
        self.result.drops = sim_res.drops
        self.result.sim_time = sim_res.sim_time
        self.result.delay_stats = sim_res.delay.summary()
        self.result.recovery_time = sim_res.recovery_time
        self.result.regenerated = sim_res.regenerated
        if self.eval_fn:
            loss = float(self.eval_fn(self.server.params))
            self.result.losses.append((sim_res.sim_time, loss))
        return self.result
