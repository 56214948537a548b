"""State-of-the-art baselines the paper compares against (§7 "Algorithms").

* ``FairShareAsync`` — vanilla PS async: all pending pushes share links
  max-min fairly (Fig. 1(a) "network bandwidth is shared"), the server
  applies updates in transfer-completion order.
* ``ring_allreduce_time`` / ``tree_allreduce_time`` — RR-Sync / Tr-Sync
  per-iteration communication models under time-varying bandwidth.
* ``SyncSim`` — synchronous SGD loop: iteration time = slowest compute +
  AllReduce time (ring or tree), with straggler/bandwidth sampling matching
  ``ClusterSim`` settings.
"""

from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs.metrics import MetricsRegistry

from .network import gbps
from .scenario import (AggregatorFail, BandwidthTrace, LinkDegrade,
                       MonitorLagChange, PacketLoss, ReplicaPromote, Scenario,
                       ScenarioEvent, ServerFail, WorkerJoin, WorkerLeave)
from .simulator import BandwidthModel, CommitRecord, N_STATIC, SimResult, StragglerModel, C1


# --------------------------------------------------------------------------- #
# max-min fair sharing (progressive filling) for the vanilla-async baseline
# --------------------------------------------------------------------------- #
def max_min_rates(flows: Sequence[Tuple[int, str, str]],
                  up_cap: Dict[str, float],
                  down_cap: Dict[str, float]) -> Dict[int, float]:
    """Max-min fair rates for flows (id, src, dst) over host up/down links."""
    rates: Dict[int, float] = {}
    active = {fid: (s, d) for fid, s, d in flows}
    cap: Dict[Tuple[str, str], float] = {}
    members: Dict[Tuple[str, str], set] = {}
    for fid, (s, d) in active.items():
        for link in (("up", s), ("down", d)):
            cap.setdefault(link, up_cap[s] if link[0] == "up" else down_cap[d])
            members.setdefault(link, set()).add(fid)
    while active:
        # link with the smallest equal share
        best_link, best_share = None, math.inf
        for link, fids in members.items():
            live = fids & active.keys()
            if not live:
                continue
            share = cap[link] / len(live)
            if share < best_share:
                best_link, best_share = link, share
        if best_link is None:
            break
        for fid in list(members[best_link] & active.keys()):
            rates[fid] = best_share
            s, d = active.pop(fid)
            for link in (("up", s), ("down", d)):
                cap[link] -= best_share
        cap[best_link] = 0.0
    return rates


class FairShareAsync:
    """Vanilla PS-async simulator: concurrent fair-shared pushes (Fig. 1a).

    Supports the same dynamic-cluster ``scenario`` timelines as
    ``ClusterSim`` so the paper's churn comparison is apples-to-apples:
    joins add a computing worker, leaves kill the worker's in-flight flow
    (the update is lost), bandwidth traces override NIC rates.  Monitor-lag
    events are no-ops (there is no scheduler to mislead) and aggregator
    failures are no-ops (there are no aggregators).

    ``ServerFail`` replays via **checkpoint-restore** (the paper's §7.3
    comparison point — vanilla PS has no bounded-divergence replica): all
    progress since the last periodic checkpoint (every
    ``checkpoint_interval`` sim-seconds) is rolled back, in-flight flows
    die, and every worker idles for ``restore_time`` (reloading the
    snapshot) before recomputing.  ``SimResult.recovery_time`` records
    ``restore_time + lost progress window`` (the rolled-back commits stay
    counted in the delay tracker; only the commit list is rewound).
    """

    def __init__(self, n_workers: int, server: str = "server", *,
                 update_size: float, compute_time: float = 0.1,
                 straggler: StragglerModel = C1,
                 bandwidth: BandwidthModel = N_STATIC,
                 default_bw: float = gbps(10), seed: int = 0,
                 scenario: Optional[Scenario] = None,
                 checkpoint_interval: float = 10.0,
                 restore_time: Optional[float] = None):
        self.workers = [f"worker{i}" for i in range(n_workers)]
        self.server = server
        self.update_size = update_size
        self.compute_time = compute_time
        self.straggler = straggler
        self.bandwidth = bandwidth
        self.default_bw = default_bw
        self.rng = random.Random(seed)
        self.up = {h: default_bw for h in self.workers + [server]}
        self.down = dict(self.up)
        self.result = SimResult()
        self.scenario = scenario
        self.checkpoint_interval = checkpoint_interval
        # default restore cost: re-reading one model-size snapshot at NIC rate
        self.restore_time = (restore_time if restore_time is not None
                             else update_size / default_bw)
        self._uid = itertools.count()
        self._dead: set = set()
        self._next_worker_id = n_workers
        self._v_server = 0

    # -- scenario hook -------------------------------------------------- #
    def apply_event(self, t: float, ev: ScenarioEvent,
                    compute_done: List[Tuple[float, str]],
                    flows: Dict[int, List]) -> None:
        if isinstance(ev, WorkerJoin):
            name = ev.worker
            if name is None:
                while (f"worker{self._next_worker_id}" in self.up
                       or f"worker{self._next_worker_id}" in self._dead):
                    self._next_worker_id += 1
                name = f"worker{self._next_worker_id}"
                self._next_worker_id += 1
            if name in self.workers:
                return  # already alive: no second compute loop
            self.up[name] = ev.up if ev.up is not None else self.default_bw
            self.down[name] = ev.down if ev.down is not None else self.default_bw
            self._dead.discard(name)
            self.workers.append(name)
            heapq.heappush(compute_done,
                           (t + self.compute_time * self.straggler.sample(self.rng),
                            name))
            self.result.joins += 1
        elif isinstance(ev, WorkerLeave):
            if ev.worker in self._dead or ev.worker not in self.workers:
                return
            self.workers.remove(ev.worker)
            self._dead.add(ev.worker)
            self.result.leaves += 1
            for fid in [fid for fid, f in flows.items() if f[1] == ev.worker]:
                flows.pop(fid)
                self.result.record_scenario_drop(count_total=True)
            # bounded state under churn: drop the departed NIC's rate
            # entries (mirrors NetworkState.remove_host in ClusterSim)
            self.up.pop(ev.worker, None)
            self.down.pop(ev.worker, None)
        elif isinstance(ev, BandwidthTrace):
            if ev.host in self.up and ev.host not in self._dead:
                if ev.up is not None:
                    self.up[ev.host] = ev.up
                if ev.down is not None:
                    self.down[ev.host] = ev.down
        elif isinstance(ev, ServerFail):
            # checkpoint-restore: rewind to the last periodic snapshot,
            # lose in-flight pushes, idle everyone through the restore
            last_ckpt = (math.floor(t / self.checkpoint_interval)
                         * self.checkpoint_interval)
            kept = [c for c in self.result.commits if c.time <= last_ckpt]
            self.result.rolled_back += len(self.result.commits) - len(kept)
            self.result.commits = kept
            self.result.server_fails += 1
            self._v_server = len(kept)
            for fid in list(flows):
                flows.pop(fid)
                self.result.record_scenario_drop(count_total=True)
            compute_done.clear()
            for w in self.workers:
                heapq.heappush(
                    compute_done,
                    (t + self.restore_time
                     + self.compute_time * self.straggler.sample(self.rng), w))
            self.result.recovery_time = self.restore_time + (t - last_ckpt)
        elif isinstance(ev, (AggregatorFail, MonitorLagChange, ReplicaPromote,
                             PacketLoss, LinkDegrade)):
            pass  # vanilla async: no aggregators, no monitor, no replica;
                  # loss events replay as ideal links (no transport tier)
        else:
            raise TypeError(f"unknown scenario event {ev!r}")
        self.result.scenario_events_applied += 1

    def run(self, *, until_time: float = math.inf,
            until_commits: int = 10 ** 9) -> SimResult:
        t = 0.0
        next_bw = self.bandwidth.period
        pending_events = list(self.scenario) if self.scenario else []
        # flow state: fid -> [remaining_bytes, worker, version_used]
        flows: Dict[int, List] = {}
        compute_done: List[Tuple[float, str]] = []
        for w in self.workers:
            heapq.heappush(compute_done,
                           (self.compute_time * self.straggler.sample(self.rng), w))

        while t < until_time and self.result.n_commits < until_commits:
            rates = max_min_rates([(fid, f[1], self.server)
                                   for fid, f in flows.items()],
                                  self.up, self.down)
            # next event: flow completion, compute done, bandwidth change,
            # or the next scenario event
            t_flow, fid_done = math.inf, None
            for fid, f in flows.items():
                r = rates.get(fid, 0.0)
                if r > 0:
                    eta = t + f[0] / r
                    if eta < t_flow:
                        t_flow, fid_done = eta, fid
            t_comp = compute_done[0][0] if compute_done else math.inf
            t_scen = pending_events[0].time if pending_events else math.inf
            t_next = min(t_flow, t_comp, next_bw, t_scen, until_time)
            # progress all flows to t_next
            for fid, f in flows.items():
                f[0] -= rates.get(fid, 0.0) * (t_next - t)
            t = t_next
            if t >= until_time:
                break
            if t == t_scen:
                self.apply_event(t, pending_events.pop(0), compute_done, flows)
            elif t == t_flow and fid_done is not None:
                _, w, v_used = flows.pop(fid_done)
                rec = CommitRecord(time=t, worker=w, uid=fid_done,
                                   version_used=v_used,
                                   version_committed=self._v_server,
                                   aggregated=False)
                self._v_server += 1
                self.result.record_commit(rec)
                self.result.bytes_to_server += self.update_size
                self.result.bytes_in_network += self.update_size
                heapq.heappush(compute_done,
                               (t + self.compute_time * self.straggler.sample(self.rng), w))
            elif t == t_comp:
                _, w = heapq.heappop(compute_done)
                if w not in self._dead:
                    flows[next(self._uid)] = [self.update_size, w,
                                              self._v_server]
            elif t == next_bw:
                for h in self.workers:
                    self.up[h] = self.bandwidth.sample(self.rng)
                    self.down[h] = self.bandwidth.sample(self.rng)
                next_bw += self.bandwidth.period
        self.result.sim_time = t
        return self.result


# --------------------------------------------------------------------------- #
# synchronous AllReduce models
# --------------------------------------------------------------------------- #
def ring_allreduce_time(size: float, bws: Sequence[float]) -> float:
    """Bandwidth-optimal ring: 2(N-1) steps of ``size/N`` at the slowest link.

    ``bws``: effective per-worker link bandwidth (min of up/down) this
    iteration.  The ring step rate is set by the slowest participant.
    """
    n = len(bws)
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) * (size / n) / min(bws)


def tree_allreduce_time(size: float, bws: Sequence[float],
                        seed: int = 0) -> float:
    """Binary-tree AllReduce: log2(N) aggregation rounds + log2(N) broadcast
    rounds; each round ships the full update, paced by the slowest pair."""
    n = len(bws)
    if n <= 1:
        return 0.0
    rng = random.Random(seed)
    order = list(range(n))
    rng.shuffle(order)
    total = 0.0
    level = order
    while len(level) > 1:
        pair_bws = [min(bws[level[i]], bws[level[i + 1]])
                    for i in range(0, len(level) - 1, 2)]
        total += size / min(pair_bws)
        level = level[::2]
    return 2.0 * total  # reduce + broadcast


@dataclass
class SyncResult:
    iteration_times: List[float] = field(default_factory=list)
    # checkpoint-restore failover accounting (ServerFail events) lives in
    # the same registry namespace as ``SimResult`` — one accumulator per
    # quantity across every trainer (DESIGN.md §10):
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)

    @property
    def recovery_time(self) -> float:
        return self.metrics.gauge("failover/recovery_time",
                                  initial=math.inf).value

    @recovery_time.setter
    def recovery_time(self, value: float) -> None:
        self.metrics.gauge("failover/recovery_time",
                           initial=math.inf).set(value)

    @property
    def rolled_back(self) -> int:
        return int(self.metrics.counter("failover/rolled_back").value)

    @rolled_back.setter
    def rolled_back(self, value: int) -> None:
        self.metrics.counter("failover/rolled_back").value = value

    @property
    def total_time(self) -> float:
        return sum(self.iteration_times)

    @property
    def mean_iteration(self) -> float:
        return self.total_time / len(self.iteration_times) if self.iteration_times else 0.0


class SyncSim:
    """RR-Sync / Tr-Sync simulation under straggler + bandwidth settings.

    Scenario support is membership-only (synchronous SGD must reform the
    ring/tree at an iteration boundary anyway): ``WorkerJoin`` /
    ``WorkerLeave`` events grow/shrink the participant count at the first
    boundary after their time; ``ServerFail`` replays as checkpoint-restore
    (iterations since the last ``checkpoint_interval`` snapshot are redone
    and the restore itself costs ``restore_time``); other events are
    ignored.
    """

    def __init__(self, n_workers: int, *, update_size: float,
                 compute_time: float = 0.1, straggler: StragglerModel = C1,
                 bandwidth: BandwidthModel = N_STATIC,
                 default_bw: float = gbps(10), variant: str = "ring",
                 seed: int = 0, scenario: Optional[Scenario] = None,
                 checkpoint_interval: float = 10.0,
                 restore_time: Optional[float] = None):
        self.n = n_workers
        self.update_size = update_size
        self.compute_time = compute_time
        self.straggler = straggler
        self.bandwidth = bandwidth
        self.default_bw = default_bw
        self.variant = variant
        self.rng = random.Random(seed)
        self.scenario = scenario
        self.checkpoint_interval = checkpoint_interval
        self.restore_time = (restore_time if restore_time is not None
                             else update_size / default_bw)

    def run(self, n_iterations: int) -> SyncResult:
        res = SyncResult()
        t = 0.0
        names = [f"worker{i}" for i in range(self.n)]
        bws = [self.default_bw] * self.n
        next_bw = self.bandwidth.period
        next_id = self.n
        iter_ends: List[Tuple[float, float]] = []   # (end time, duration)
        pending = [e for e in (self.scenario or [])
                   if isinstance(e, (WorkerJoin, WorkerLeave, ServerFail))]
        for it in range(n_iterations):
            while pending and pending[0].time <= t:
                ev = pending.pop(0)
                if isinstance(ev, WorkerJoin):
                    names.append(ev.worker or f"worker{next_id}")
                    next_id += 1
                    bws.append(ev.up if ev.up is not None else self.default_bw)
                elif isinstance(ev, ServerFail):
                    # checkpoint-restore at the iteration boundary: redo
                    # every iteration since the last periodic snapshot,
                    # plus the snapshot reload itself
                    last_ckpt = (math.floor(t / self.checkpoint_interval)
                                 * self.checkpoint_interval)
                    redo = [d for te, d in iter_ends if te > last_ckpt]
                    res.rolled_back += len(redo)
                    penalty = self.restore_time + sum(redo)
                    res.recovery_time = penalty
                    res.iteration_times.append(penalty)
                    t += penalty
                    # the restore block is wall-clock work too: record it
                    # so a LATER failure rewinding into this window redoes
                    # it instead of under-counting
                    iter_ends.append((t, penalty))
                elif isinstance(ev, WorkerLeave) \
                        and len(names) > 1 and ev.worker in names:
                    i = names.index(ev.worker)  # drop THIS worker's NIC slot
                    names.pop(i)
                    bws.pop(i)
                self.n = len(names)
            comp = max(self.compute_time * self.straggler.sample(self.rng)
                       for _ in range(self.n))
            if self.variant == "ring":
                comm = ring_allreduce_time(self.update_size, bws)
            else:
                comm = tree_allreduce_time(self.update_size, bws, seed=it)
            t += comp + comm
            res.iteration_times.append(comp + comm)
            iter_ends.append((t, comp + comm))
            while t >= next_bw:
                bws = [min(self.bandwidth.sample(self.rng),
                           self.bandwidth.sample(self.rng)) for _ in range(self.n)]
                next_bw += self.bandwidth.period
        return res
