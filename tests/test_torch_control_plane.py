"""The port's copy of the control plane reproduces the reference's goldens.

``tests/golden/cluster_sim_trace.txt`` pins a seeded ``ClusterSim`` run of
the JAX package (stragglers, bandwidth churn, a dynamic-cluster scenario,
aggregation and tau_max drops all active).  The port's copy, configured the
same way, must reproduce it line for line.  The vectorized draws, the one
place the copy departs from the reference (numpy in place of
``jax.random``), must match the models' distributions.
"""

import random

import numpy as np

from repro_torch.core.network import gbps, mb
from repro_torch.core.scenario import (AggregatorFail, Scenario, WorkerJoin,
                                       WorkerLeave, bandwidth_trace)
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.simulator import (C2, N2, BandwidthModel, ClusterSim,
                                        StragglerModel)
from test_golden_trace import GOLDEN_PATH, render_trace


def port_golden_run():
    """``tests/test_golden_trace.py:golden_run`` on the port's classes."""
    scenario = Scenario(
        [WorkerLeave(time=2.0, worker="worker5"),
         AggregatorFail(time=2.5, host="worker0"),
         WorkerJoin(time=4.0)]
        + bandwidth_trace("worker2", [(1.0, gbps(1), gbps(1)),
                                      (3.0, gbps(10), gbps(10))]))
    cfg = SchedulerConfig(server="server",
                          aggregators=["worker0", "worker1"],
                          tau_max=12, mode="async", batch_interval=0.1)
    sim = ClusterSim(6, cfg, update_size=mb(100), compute_time=0.05,
                     straggler=C2, bandwidth=N2, monitor_lag=0.2, seed=42,
                     default_bw=gbps(1.5), scenario=scenario)
    return sim.run(until_time=8.0)


def test_port_reproduces_golden_trace():
    with open(GOLDEN_PATH) as f:
        expected = f.read()
    assert render_trace(port_golden_run()) == expected


def test_vector_draws_match_distributions():
    rng = random.Random(0)
    slows = StragglerModel(prob=0.25, factor=3.0).sample_batch(rng, 40000)
    assert set(np.unique(slows).tolist()) <= {1.0, 3.0}
    assert abs(float(np.mean(slows == 3.0)) - 0.25) < 0.01
    model = BandwidthModel(probs=(0.0, 0.1, 0.1, 0.1, 0.7))
    rates = model.sample_batch(rng, 40000)
    for level, p in zip(model.levels, model.probs):
        assert abs(float(np.mean(rates == level)) - p) < 0.01


def test_vector_compute_runs_without_jax():
    cfg = SchedulerConfig(server="server", aggregators=["worker0"],
                          tau_max=8, mode="async")
    sim = ClusterSim(16, cfg, update_size=mb(10), compute_time=0.05,
                     straggler=C2, bandwidth=N2, seed=3, vector_compute=True)
    res = sim.run(until_commits=40)
    assert len(res.commits) >= 40
