"""Dynamic clusters: the paper's headline setting, end to end.

Replays one declarative scenario timeline — churn (8 of 32 workers leave
and later rejoin), an aggregator failure, and a rolling congestion wave —
against MLfabric-A and both baselines, then shows in-flight re-routing
when an aggregator dies mid-transfer (the PyTorch port's control plane).

    PYTHONPATH=src python examples_torch/dynamic_cluster.py [--device cpu]

The control plane is host code; ``--device`` (default ``cuda``, which
raises on a host without a card) names the card the port would train on.
"""

import argparse
import sys
sys.path.insert(0, "src")

from repro_torch.core import (AggregatorFail, ClusterSim, FairShareAsync,
                              Scenario, SchedulerConfig, SyncSim, C2, N2,
                              gbps, mb)
from repro_torch.device import resolve_device
from repro_torch.scenarios import paper_dynamic_cluster


def headline_table(n=32, horizon=30.0):
    scen = paper_dynamic_cluster(n, seed=0, horizon=horizon)
    print(f"=== scenario '{scen.name}' ({len(scen)} events) ===")
    for ev in scen:
        print(f"  t={ev.time:6.2f}s  {type(ev).__name__:16s} "
              f"{getattr(ev, 'worker', getattr(ev, 'host', '')) or '(new)'}")

    cfg = SchedulerConfig(server="server",
                          aggregators=[f"worker{i}" for i in range(8)],
                          tau_max=100, mode="async", batch_interval=1.0)
    fab = ClusterSim(n, cfg, update_size=mb(100), compute_time=0.05,
                     straggler=C2, bandwidth=N2, seed=7,
                     scenario=paper_dynamic_cluster(n, seed=0, horizon=horizon)
                     ).run(until_time=horizon)
    van = FairShareAsync(n, update_size=mb(100), compute_time=0.05,
                         straggler=C2, bandwidth=N2, seed=7,
                         scenario=paper_dynamic_cluster(n, seed=0,
                                                        horizon=horizon)
                         ).run(until_time=horizon)
    sync = SyncSim(n, update_size=mb(100), compute_time=0.05, straggler=C2,
                   bandwidth=N2, seed=7,
                   scenario=paper_dynamic_cluster(n, seed=0, horizon=horizon))
    sres = sync.run(int(horizon / 0.3))

    agg = sum(1 for c in fab.commits if c.aggregated) / max(fab.n_commits, 1)
    print(f"\n=== C2 stragglers + N2 bandwidth + churn, {n} workers, "
          f"{horizon:.0f}s ===")
    print(f"MLfabric-A : {fab.commit_rate:6.1f} commits/s  "
          f"({agg:.0%} aggregated, {fab.drops} drops, "
          f"delay max {fab.delay.max})")
    print(f"FairShare  : {van.commit_rate:6.1f} commits/s  "
          f"(delay max {van.delay.max})")
    print(f"RR-Sync    : {1.0 / max(sres.mean_iteration / n, 1e-9):6.1f} "
          f"grads/s    (iteration {sres.mean_iteration * 1e3:.0f} ms)")
    print(f"speedup vs fair-share async: "
          f"{fab.commit_rate / max(van.commit_rate, 1e-9):.2f}x")


def reroute_demo():
    """Slow links keep groups in flight long enough for the aggregator to
    die under them -> surviving members re-plan on the next batch."""
    cfg = SchedulerConfig(server="server", aggregators=["worker0", "worker1"],
                          mode="async", batch_interval=0.1)
    sim = ClusterSim(8, cfg, update_size=mb(400), compute_time=0.02,
                     default_bw=gbps(1), seed=3,
                     scenario=Scenario([
                         AggregatorFail(time=1.0, host="worker0"),
                         AggregatorFail(time=1.0, host="worker1")]))
    res = sim.run(until_time=12.0)
    print(f"\n=== aggregator failure at t=1.0s (both aggregators) ===")
    print(f"re-routed in-flight updates: {res.reroutes}; "
          f"commits {res.n_commits}, all via direct paths after the failure")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    resolve_device(ap.parse_args().device)
    headline_table()
    reroute_demo()
