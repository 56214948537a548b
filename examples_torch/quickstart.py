"""Quickstart: the MLfabric scheduler in 60 lines (the PyTorch port).

Builds a small cluster network, submits a batch of gradient updates, and
shows the three algorithms working together: delay-bounded ordering
(Alg. 2), in-network aggregation (Alg. 3) and bounded-divergence
replication (§5.3).

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The control plane is host code; ``--device`` (default ``cuda``, which
raises on a host without a card) names the card the port would train on.
"""

import argparse
import sys
sys.path.insert(0, "src")

from repro_torch.core import (MLfabricScheduler, NetworkState, SchedulerConfig,
                        Update, gbps, mb)
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    resolve_device(ap.parse_args().device)
    # 8 workers + server + replica + 2 aggregators on a 10 Gbps fabric;
    # worker3 is stuck behind a 1 Gbps uplink.
    hosts = [f"worker{i}" for i in range(8)] + ["server", "replica"]
    net = NetworkState(hosts, default_bw=gbps(10))
    net.set_bandwidth("worker3", 0.0, up=gbps(1))

    cfg = SchedulerConfig(
        server="server",
        aggregators=["worker0", "worker1"],
        replica="replica",
        replica_aggregators=["worker2"],
        tau_max=6,               # delay bound (paper §3.1)
        div_max=2.0,             # divergence bound (paper §3.3)
        gamma=0.9,
        mode="async",
    )
    sched = MLfabricScheduler(cfg)

    # a batch of ready updates: 100 MB each, various staleness
    updates = [
        Update(uid=i, worker=f"worker{i}", size=mb(100),
               version=-(i % 4), norm=1.0, t_avail=0.01 * i)
        for i in range(8)
    ]

    plan = sched.schedule_batch(updates, net)

    print("=== MLfabric batch plan ===")
    print(f"commit order : {[u.uid for u in plan.order]}")
    print(f"dropped      : {[u.uid for u in plan.dropped]} "
          f"(delay bound would leave the network fallow)")
    for gi, grp in enumerate(plan.aggregation.groups):
        kind = "direct->server" if grp.aggregator is None \
            else f"via {grp.aggregator}"
        print(f"group {gi}: {[u.uid for u in grp.members]} {kind}")
    print(f"makespan     : {plan.makespan*1e3:.0f} ms")
    print(f"avg commit   : {plan.aggregation.avg_commit*1e3:.0f} ms")
    if plan.replication:
        r = plan.replication
        print(f"replicated   : {[u.uid for u in r.frozen]} "
              f"(punted {len(r.punted)}, divergence bound "
              f"{r.divergence_after:.2f} <= {cfg.div_max})")


if __name__ == "__main__":
    main()
