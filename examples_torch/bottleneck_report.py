"""Why was this run slow?  Critical-path attribution end to end.

Runs the ``pod_stress`` preset (server downlink choked to 2.5 Gbps at
t=0.5s) under the host and hierarchical aggregation backends with a
:class:`~repro_torch.obs.CritPathCallback` attached, then prints each run's
:class:`~repro_torch.obs.BottleneckReport` — per-commit time decomposed into
queue / transmit / aggregate-wait / drain / apply phases, with the top
contended links ranked by how long they were the *binding* bottleneck —
and the diff between the two runs (the attribution view of the
hierarchical backend's win: the wire stops being the critical path).

Also writes a Perfetto-loadable trace with per-link reserved-bandwidth
counter tracks to ``runs/bottleneck_example_trace.json``.

    PYTHONPATH=src python examples_torch/bottleneck_report.py [--quick] \
        [--device cpu]

The PyTorch port's control plane and observability (host code);
``--device`` (default ``cuda``, which raises on a host without a card)
names the card the port would train on.
"""

import argparse
import os
import sys
sys.path.insert(0, "src")

from repro_torch.core import (C2, N2, ClusterSim, SchedulerConfig,
                              SwitchConfig, gbps, mb)
from repro_torch.core.harness import HookBus
from repro_torch.obs import CritPathCallback, Tracer, compare_reports, \
    render_comparison
from repro_torch.device import resolve_device
from repro_torch.scenarios import pod_stress


def run_backend(backend, *, n, commits, horizon, keep_trace=False):
    cb = CritPathCallback(name=backend, top_k=5)
    tracer = Tracer(process_name="mlfabric-bottleneck")
    cfg = SchedulerConfig(server="server",
                          aggregators=["worker0", "worker1"],
                          tau_max=100, mode="async", batch_interval=0.5,
                          backend=backend,
                          switch=SwitchConfig(pod_size=4))
    sim = ClusterSim(n, cfg, update_size=mb(100), compute_time=0.05,
                     straggler=C2, bandwidth=N2, seed=7,
                     scenario=pod_stress(n, server_down=gbps(2.5)),
                     hooks=HookBus([cb], tracer=tracer))
    sim.run(until_time=horizon, until_commits=commits)
    if keep_trace:
        os.makedirs("runs", exist_ok=True)
        tracer.write_chrome("runs/bottleneck_example_trace.json")
    return cb.report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="fewer workers / commits (CI smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    resolve_device(args.device)
    n = 8 if args.quick else 12
    commits = 30 if args.quick else 60

    reports = {}
    for backend in ("host", "hierarchical"):
        rep = run_backend(backend, n=n, commits=commits, horizon=60.0,
                          keep_trace=(backend == "host"))
        reports[backend] = rep
        print(rep.render())
        print()

    host, hier = reports["host"], reports["hierarchical"]
    print(render_comparison(compare_reports(host, hier)))
    print()
    print(f"host backend: {100 * host.network_share:.0f}% of every commit's "
          f"critical path is the network ({host.wire_seconds:.1f}s on the "
          f"wire, mostly {host.dominant_link}).")
    print(f"hierarchical: network share falls to "
          f"{100 * hier.network_share:.0f}% "
          f"({hier.wire_seconds:.1f}s on the wire) — the int8 pod drains "
          "take the server downlink off the critical path.")
    print("trace with per-link bandwidth counters: "
          "runs/bottleneck_example_trace.json (load in ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
