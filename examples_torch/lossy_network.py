"""Lossy networks: the bounded-loss transport tier end to end.

Replays the ``burst_loss`` and ``congestion_loss`` scenario presets
against the three transport policies —

* ``lossless``  — loss events are measured but links deliver everything
                  (the idealized fabric every earlier example assumed);
* ``reliable``  — lost/corrupted bytes are retransmitted on the sender's
                  residual uplink with exponential backoff, so loss shows
                  up as straggling, never as a wrong aggregate;
* ``bounded``   — the trainer accepts drops up to a phase-aware allowance
                  and only repairs the excess (plus all corruption),
                  trading gradient mass for commit rate the same way §5.3
                  trades replica divergence for throughput

— then shows the sender-side half of the bounded mode: top-k + error
feedback, whose residual bound is *enforced* (see DESIGN.md §12), in the
PyTorch port: ``ErrorFeedback`` keeps its residual on the card and
compresses gradients that lie there.

    PYTHONPATH=src python examples_torch/lossy_network.py [--device cpu]

``--device`` defaults to ``cuda`` and raises on a host without a card.
"""

import argparse
import sys
sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core import (ClusterSim, SchedulerConfig, TransportConfig,
                              C2, N2, mb)
from repro_torch.device import resolve_device
from repro_torch.scenarios import burst_loss, congestion_loss


def policy_table(n=16, horizon=12.0):
    presets = {
        "burst-loss": lambda: burst_loss(
            [f"worker{i}" for i in range(0, n, 2)],
            start=2.0, duration=1.5, rate=0.3, interval=4.0, bursts=2),
        "congestion-loss": lambda: congestion_loss(
            [f"worker{i}" for i in range(0, n, 4)],
            start=3.0, duration=4.0, rate=0.15, corrupt_rate=0.05),
    }
    policies = {
        "lossless": TransportConfig(policy="lossless"),
        "reliable": TransportConfig(policy="reliable"),
        "bounded": TransportConfig(policy="bounded", loss_tolerance=0.3),
    }
    for preset, make in presets.items():
        print(f"=== scenario '{preset}' x transport policies "
              f"({n} workers, {horizon:.0f}s, C2/N2) ===")
        for pname, tc in policies.items():
            cfg = SchedulerConfig(server="server",
                                  aggregators=["worker0", "worker1"],
                                  tau_max=100, mode="async",
                                  batch_interval=0.5)
            res = ClusterSim(n, cfg, update_size=mb(100), compute_time=0.05,
                             straggler=C2, bandwidth=N2, seed=7,
                             scenario=make(), transport=tc,
                             ).run(until_time=horizon)
            m = res.metrics
            lost = m.counter('transport/bytes_lost').value / 1e6
            accepted = m.counter('transport/bytes_accepted').value / 1e6
            print(f"  {pname:9s}: {res.commit_rate:6.1f} commits/s  "
                  f"retx {res.retransmits:3d}  "
                  f"timeouts {res.transport_timeouts + res.transport_expired}"
                  f"  lost {lost:7.1f} MB  accepted {accepted:6.1f} MB")
        print()


def error_feedback_demo(device, d=4096, steps=30, seed=0):
    """The sender half of bounded mode: the per-slot drops come from the
    same ``burst_loss`` schedule the simulator replays — during the burst
    windows 25% of the top-k slots vanish, outside them none do — and the
    enforced error-feedback residual never exceeds its bound while the
    aggregate tracks the true gradient sum."""
    from repro_torch.core import LossSchedule
    from repro_torch.dist import ErrorFeedback, loss_drop_mask

    # the sender's view of the burst_loss preset: 1.5s-long 25%-drop
    # bursts every 4s on worker0's uplink (one step per 0.5s below)
    loss = LossSchedule()
    for b in range(2):
        loss.set_drop("worker0", 2.0 + b * 4.0, 0.25, until=3.5 + b * 4.0,
                      direction="up")

    rng = np.random.default_rng(seed)
    ef = ErrorFeedback(d, device=device)
    true_sum = torch.zeros(d, dtype=torch.float32, device=device)
    delivered_sum = torch.zeros(d, dtype=torch.float32, device=device)
    worst = 0.0
    for step in range(steps):
        g = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(
            device)
        bound = 0.5 * float(torch.linalg.norm(g))
        drop = loss_drop_mask(loss, "worker0", "server", 0.5 * step,
                              d // 10)               # keep=0.1 -> k = d/10
        _, delivered = ef.compress(g, keep=0.1, bound=bound, drop_mask=drop)
        true_sum += g
        delivered_sum += delivered
        resid = float(torch.linalg.norm(ef.residual))
        worst = max(worst, resid / bound)
    err = float(torch.linalg.norm(delivered_sum - true_sum)
                / torch.linalg.norm(true_sum))
    print(f"=== error feedback, d={d}, keep=10%, burst_loss-driven drops, "
          f"{steps} steps ===")
    print(f"worst residual/bound: {worst:.3f} (enforced <= 1)")
    print(f"relative error of delivered sum vs true sum: {err:.3f}")
    print(f"coords force-flushed to honor the bound: {ef.flushed_total}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)
    policy_table()
    error_feedback_demo(dev)
