"""Server failover at laptop scale (paper §3.3 / §5.3 / §7.3), in the
PyTorch port.

Two demos:

1. **Recovery-time table** (timing mode): the same ``server_failover``
   timeline is replayed by MLfabric (bounded-divergence replica promoted
   in place) and by the baselines (checkpoint-restore: rewind to the last
   periodic snapshot and redo the lost window).  The setup is
   ``benchmarks/run.py:bench_failover_recovery``'s, run on the port's
   control plane.
2. **Real-tensor kill** (training mode): ``AsyncTrainer(replicate=True)``
   trains a quadratic on the card while a ``ReplicaServer`` applies the
   identical update payloads in server-commit order; the primary is
   killed mid-run, the replica is promoted, and training converges anyway.

    PYTHONPATH=src python examples_torch/failover.py [--device cpu]

``--device`` defaults to ``cuda`` and raises on a host without a card.
"""

import argparse
import sys
import time
sys.path.insert(0, "src")

import torch

from repro_torch.core import (ClusterSim, FairShareAsync, SchedulerConfig,
                              SyncSim, mb)
from repro_torch.core.scenario import Scenario, ServerFail
from repro_torch.core.simulator import StragglerModel
from repro_torch.device import resolve_device
from repro_torch.ps import AsyncTrainer
from repro_torch.scenarios import server_failover

NO_STRAGGLE = StragglerModel(0, 1)


def recovery_table():
    # ``bench_failover_recovery``'s setup: 16 workers, 50 MB updates, the
    # primary killed at t=6s, baselines checkpointing every 10s
    n, size, horizon = 16, mb(50), 14.0
    t0 = time.perf_counter()
    scen = server_failover(fail_at=6.0)
    cfg = SchedulerConfig(server="server", aggregators=["worker0", "worker1"],
                          tau_max=30, mode="async", replica="replica",
                          replica_aggregators=(), div_max=4.0, gamma=0.9)
    fab = ClusterSim(n, cfg, update_size=size, compute_time=0.05,
                     straggler=NO_STRAGGLE, seed=7,
                     scenario=scen).run(until_time=horizon)
    van = FairShareAsync(n, update_size=size, compute_time=0.05,
                         straggler=NO_STRAGGLE, seed=7, scenario=scen,
                         checkpoint_interval=10.0).run(until_time=horizon)
    sync = SyncSim(n, update_size=size, compute_time=0.05,
                   straggler=NO_STRAGGLE, seed=7, scenario=scen,
                   checkpoint_interval=10.0).run(int(horizon / 0.2))
    dt = time.perf_counter() - t0
    # work-equivalent recovery: fail -> the regenerated count of fresh
    # commits has landed
    post = sorted(c.time for c in fab.commits if c.time > 6.0)
    refill = (post[fab.regenerated - 1] - 6.0
              if 0 < fab.regenerated <= len(post) else fab.recovery_time)
    # the benchmark's record line: name, microseconds, derived figures
    print(f"failover_recovery,{dt*1e6:.0f},"
          f"replica={fab.recovery_time:.2f}s(refill={refill:.2f}s);"
          f"ckpt_fairshare={van.recovery_time:.2f}s"
          f"(rolled_back={van.rolled_back});"
          f"ckpt_rrsync={sync.recovery_time:.2f}s"
          f"(rolled_back={sync.rolled_back});"
          f"downtime_speedup="
          f"{van.recovery_time / max(fab.recovery_time, 1e-9):.1f}x;"
          f"work_equiv_speedup="
          f"{van.recovery_time / max(refill, 1e-9):.1f}x",
          flush=True)

    print(f"\nprimary killed at t={6.0:.0f}s "
          f"({n} workers, 50 MB updates)\n")
    print(f"{'mechanism':<38s} {'recovery':>9s} {'work lost':>10s}")
    print(f"{'MLfabric replica promotion (§3.3)':<38s} "
          f"{fab.recovery_time:8.2f}s {fab.regenerated:7d} upd")
    print(f"{'FairShare async + 10s checkpoints':<38s} "
          f"{van.recovery_time:8.2f}s {van.rolled_back:7d} upd")
    print(f"{'RR-Sync + 10s checkpoints':<38s} "
          f"{sync.recovery_time:8.2f}s {sync.rolled_back:7d} iter")
    print(f"\nreplica promotion resumes "
          f"{van.recovery_time/max(fab.recovery_time,1e-9):.0f}x faster "
          f"(and has regenerated the lost work after "
          f"{refill:.2f}s — still "
          f"{van.recovery_time/max(refill,1e-9):.0f}x ahead of "
          f"the checkpoint rewind); its 'lost' updates are fresh progress "
          f"from the promoted model, never recomputed history")


def real_tensor_kill(device):
    target = torch.tensor([3.0, -2.0, 1.0, 0.5], device=device)

    def quad_loss(p, b):
        return torch.sum(torch.square(p["w"] - b["target"]))

    trainer = AsyncTrainer(
        {"w": torch.zeros(4, device=device)}, quad_loss,
        lambda w, t: {"target": target},
        n_workers=4, tau_max=8, base_lr=0.05, gamma=0.5,
        delay_adaptive=False, update_size=mb(5), compute_time=0.05,
        straggler=NO_STRAGGLE, replicate=True, div_max=1.0,
        scenario=Scenario([ServerFail(time=2.0)]),
        eval_fn=lambda p: quad_loss(p, {"target": target}), device=device)
    res = trainer.run(until_commits=150)
    print(f"\nreal-tensor kill at t=2s: {res.commits} commits "
          f"({res.replica_commits} replicated), "
          f"{res.promotions} promotion, "
          f"recovery {res.recovery_time*1e3:.0f} ms, "
          f"{res.regenerated} updates regenerated")
    print(f"final loss {res.final_loss:.2e} — training survived the "
          f"primary's death")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)
    recovery_table()
    real_tensor_kill(dev)
