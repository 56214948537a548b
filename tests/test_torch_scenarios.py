"""The port's copies of the paper's dynamic-cluster scenarios and of the
phase profiler and roofline model, against the JAX package's.

* Every library builder gives the reference's events (type and fields,
  in order) over a grid of arguments; the twins of
  ``tests/test_scenario.py``'s deterministic-builder and churn tests hold
  on the port's ``ClusterSim`` and on its ``AsyncTrainer`` (CPU).
* Under ``churn`` the reduced qwen2-0.5b ``AsyncTrainer(compress=True)``
  commits the same (worker, version used, version committed) sequence as
  the JAX trainer from the same converted f32 params, and its eval losses
  agree within 1e-3: the limit of ``test_torch_slice.py``'s trainer parity,
  for its reason (f32 sums in another order can put a value on the other
  side of an int8 rounding tie).
* The twins of ``tests/test_obs.py``'s profiler and roofline tests, and
  ``aggregator_hbm_traffic`` equal to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscen
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.obs import aggregator_hbm_traffic as j_traffic
from repro.ps import AsyncTrainer as JAsyncTrainer
from repro_torch import scenarios as tscen
from repro_torch.configs import get_config
from repro_torch.core.network import gbps, mb
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.simulator import (C2, ClusterSim, N_STATIC,
                                        StragglerModel)
from repro_torch.data import SyntheticLM
from repro_torch.interop import to_torch
from repro_torch.models import build_model
from repro_torch.obs import (PhaseProfiler, aggregator_hbm_traffic,
                             measure_planner_latency)
from repro_torch.ps import AsyncTrainer
from repro_torch.scenarios import (churn, congestion_wave, flash_crowd,
                                   paper_dynamic_cluster)

NO_STRAGGLE = StragglerModel(0, 1)


def ml_cfg(**kw):
    base = dict(server="server", aggregators=["worker0", "worker1"],
                tau_max=30, mode="async")
    base.update(kw)
    return SchedulerConfig(**base)


def _events(scenario):
    return [(type(e).__name__, dataclasses.asdict(e)) for e in scenario]


# --------------------------------------------------------------------------- #
# the library
# --------------------------------------------------------------------------- #
WORKERS = ["worker0", "worker2", "worker5"]
BUILDERS = [
    ("churn", (8,), {}),
    ("churn", (6,), dict(leave_at=1.0, rejoin_at=2.0, fraction=0.34)),
    ("churn", (3,), dict(fraction=0.1, name="small")),
    ("aggregator_outage", (["worker0", "worker1"],), dict(fail_at=2.5)),
    ("flash_crowd", (3,), dict(start=1.0, interval=0.25, up=gbps(5))),
    ("congestion_wave", (WORKERS,), {}),
    ("congestion_wave", (WORKERS,), dict(start=0.5, duration=1.0,
                                         low=gbps(2), stagger=0.0)),
    ("degraded_monitor", (), {}),
    ("degraded_monitor", (), dict(at=1.0, lag=0.5, recover_at=3.0)),
    ("server_failover", (), {}),
    ("server_failover", (), dict(fail_at=2.0, promote_at=2.5)),
    ("burst_loss", (WORKERS,), {}),
    ("burst_loss", (WORKERS[:1],), dict(rate=0.1, bursts=3, interval=1.0)),
    ("congestion_loss", (WORKERS,), {}),
    ("congestion_loss", (WORKERS,), dict(corrupt_rate=0.0, rate=0.4)),
    ("pod_stress", (8,), {}),
    ("pod_stress", (4,), dict(start=1.0, recover_at=4.0)),
    ("paper_dynamic_cluster", (4,), {}),
    ("paper_dynamic_cluster", (16,), dict(seed=3, horizon=12.0)),
    ("paper_dynamic_cluster", (9,), dict(seed=7, horizon=100.0)),
]


def test_library_exports_the_reference_names():
    assert tscen.__all__ == jscen.__all__


@pytest.mark.parametrize("name,args,kw", BUILDERS)
def test_builder_events_match_reference(name, args, kw):
    port = getattr(tscen, name)(*args, **kw)
    ref = getattr(jscen, name)(*args, **kw)
    assert port.name == ref.name
    assert _events(port) == _events(ref)


def test_library_builders_deterministic():
    a = paper_dynamic_cluster(16, seed=3)
    b = paper_dynamic_cluster(16, seed=3)
    assert a.events == b.events
    assert len(flash_crowd(4)) == 4
    assert len(congestion_wave(["w0", "w1"])) == 4


def test_training_mode_survives_churn():
    """on_compute/on_commit/on_drop stay consistent under churn: every
    computed update is committed or dropped exactly once."""
    seen = {"computed": 0, "committed": 0, "dropped": 0}

    def on_compute(worker, version):
        seen["computed"] += 1
        return mb(10), 1.0

    scen = churn(6, leave_at=1.0, rejoin_at=2.0, fraction=0.34)
    sim = ClusterSim(6, ml_cfg(), update_size=mb(10), compute_time=0.05,
                     straggler=NO_STRAGGLE, bandwidth=N_STATIC, seed=1,
                     scenario=scen, on_compute=on_compute,
                     on_commit=lambda rec: seen.__setitem__(
                         "committed", seen["committed"] + 1),
                     on_drop=lambda w, v: seen.__setitem__(
                         "dropped", seen["dropped"] + 1))
    res = sim.run(until_time=4.0)
    assert res.joins == 2 and res.leaves == 2
    assert seen["committed"] == res.n_commits
    assert seen["computed"] == seen["committed"] + seen["dropped"] \
        + len(sim._uid_meta)


def _quad_trainer(scenario, n_workers, **kw):
    """The port's AsyncTrainer on a 3-parameter quadratic: the control
    plane's bookkeeping with real tensors, fast."""
    loss = lambda p, b: torch.sum(torch.square(p["w"] - b["t"]))
    data = lambda w, t: {"t": torch.ones(3)}
    return AsyncTrainer({"w": torch.zeros(3)}, loss, data,
                        n_workers=n_workers, tau_max=30, update_size=mb(10),
                        compute_time=0.05, straggler=NO_STRAGGLE,
                        bandwidth=N_STATIC, seed=1, scenario=scenario,
                        device="cpu", **kw)


@pytest.mark.parametrize("compress", [False, True])
def test_async_trainer_survives_churn(compress):
    """The same claim on the port's AsyncTrainer: every update it computes
    is committed, dropped or still pending, and no worker keeps an update
    in flight it cannot account for."""
    tr = _quad_trainer(churn(6, leave_at=1.0, rejoin_at=2.0, fraction=0.34),
                       6, compress=compress)
    res = tr.run(until_time=4.0)
    sim = tr.sim.result
    assert sim.joins == 2 and sim.leaves == 2
    assert res.commits == sim.n_commits
    assert tr._t == res.commits + res.drops + len(tr.sim._uid_meta)
    assert len(tr._payloads) == len(tr.sim._uid_meta)
    joined = {c.worker for c in sim.commits} - {f"worker{i}"
                                               for i in range(6)}
    assert len(joined) == 2                 # both new hosts commit
    assert not [c for c in sim.commits
                if c.worker in ("worker4", "worker5") and c.time > 1.5]


def test_async_trainer_under_paper_dynamic_cluster():
    """The paper's composite timeline (churn, an aggregator outage and a
    congestion wave) on the port's trainer: one leave, one join, commits in
    every window, conservation."""
    scen = paper_dynamic_cluster(4, seed=0, horizon=6.0)
    tr = _quad_trainer(scen, 4)
    res = tr.run(until_time=6.0)
    sim = tr.sim.result
    assert sim.leaves == 1 and sim.joins == 1
    windows = [0, 0, 0]
    for c in sim.commits:
        windows[(c.time >= 1.0) + (c.time >= 3.0)] += 1
    assert all(n > 0 for n in windows), windows
    assert tr._t == res.commits + res.drops + len(tr.sim._uid_meta)


# --------------------------------------------------------------------------- #
# the reduced-qwen2 trainer under churn, port against JAX
# --------------------------------------------------------------------------- #
CHURN_KW = dict(n_workers=3, tau_max=8, base_lr=0.5, gamma=0.0,
                delay_adaptive=False, update_size=mb(10), compute_time=0.05,
                straggler=C2, bandwidth=N_STATIC, aggregators=2,
                has_aux=True, seed=0, compress=True)
# worker2 leaves after the first round of commits and a fresh worker3
# joins a round later; 10 commits span both and reach the eval at 10 (each
# worker is a JAX grad compile: three workers and one joiner keep it short)
CHURN_COMMITS = 10
CHURN_LEAVE, CHURN_REJOIN = 0.12, 0.22


def _cursor(worker, t):
    return int(worker.removeprefix("worker")) * 997 + t


def test_churn_trainer_matches_jax():
    cfg = j_get_config("qwen2-0.5b").reduced()
    jmodel = j_build_model(cfg, dtype=jnp.float32)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)
    eval_np = src.batch(12345, 8)

    @jax.jit
    def j_eval(p):
        return jmodel.loss_fn(p, {k: jnp.asarray(v)
                                  for k, v in eval_np.items()})[0]

    jtr = JAsyncTrainer(
        jparams, jmodel.loss_fn,
        lambda w, t: {k: jnp.asarray(v)
                      for k, v in src.batch(_cursor(w, t), 4).items()},
        eval_fn=j_eval, scenario=jscen.churn(3, leave_at=CHURN_LEAVE,
                                             rejoin_at=CHURN_REJOIN),
        **CHURN_KW)
    jres = jtr.run(until_commits=CHURN_COMMITS)

    tmodel = build_model(get_config("qwen2-0.5b").reduced(),
                         dtype=torch.float32, device="cpu")
    eval_t = {k: torch.from_numpy(v) for k, v in eval_np.items()}

    def t_eval(p):
        with torch.no_grad():
            return tmodel.loss_fn(p, eval_t)[0]

    ttr = AsyncTrainer(
        to_torch(jax.tree.map(np.asarray, jparams), device="cpu"),
        tmodel.loss_fn,
        lambda w, t: {k: torch.from_numpy(v)
                      for k, v in src.batch(_cursor(w, t), 4).items()},
        eval_fn=t_eval, scenario=churn(3, leave_at=CHURN_LEAVE,
                                       rejoin_at=CHURN_REJOIN),
        device="cpu", **CHURN_KW)
    tres = ttr.run(until_commits=CHURN_COMMITS)

    def seq(sim):
        return [(c.worker, c.version_used, c.version_committed)
                for c in sim.result.commits]

    assert ttr.sim.result.leaves == jtr.sim.result.leaves == 1
    assert ttr.sim.result.joins == jtr.sim.result.joins == 1
    assert seq(ttr.sim) == seq(jtr.sim)
    assert any(w == "worker3" for w, _, _ in seq(ttr.sim))  # the joiner
    # commits land before the leave, between it and the rejoin, and after
    windows = [0, 0, 0]
    for c in ttr.sim.result.commits:
        windows[(c.time >= CHURN_LEAVE) + (c.time >= CHURN_REJOIN)] += 1
    assert all(n > 0 for n in windows), windows
    assert len(tres.losses) == 2            # the eval at 10 and the last
    assert tres.drops == jres.drops and tres.sim_time == jres.sim_time
    assert [t for t, _ in tres.losses] == [t for t, _ in jres.losses]
    np.testing.assert_allclose([l for _, l in tres.losses],
                               [l for _, l in jres.losses], rtol=0, atol=1e-3)


# --------------------------------------------------------------------------- #
# the profiler and the roofline model
# --------------------------------------------------------------------------- #
def test_phase_profiler_probes_and_hooks():
    prof = PhaseProfiler()
    with prof.phase("plan"):
        pass
    prof.on_batch_start(None, 0)
    prof.on_batch_end(None, 0)
    prof.on_commit(None, object())
    prof.on_failover(None, 1.0)
    summary = prof.summary(roofline_n=8, roofline_d=4096)
    m = summary["metrics"]
    assert m["phase/plan"]["count"] == 1
    assert m["phase/batch"]["count"] == 1
    assert m["commits"] == 1 and m["failovers"] == 1
    assert summary["roofline"]["ratio"] > 1.0


def test_phase_profiler_on_the_trainer():
    """Attached to the port's AsyncTrainer: one ``commits`` count per
    commit and the scenario's events counted."""
    prof = PhaseProfiler()
    tr = _quad_trainer(churn(4, leave_at=0.3, rejoin_at=0.6), 4,
                       callbacks=[prof])
    res = tr.run(until_commits=20)
    m = prof.summary()["metrics"]
    assert m["commits"] == res.commits
    assert m["events"] >= 2
    assert m["runs"] == 1.0


def test_roofline_model_monotone_in_fanin():
    r4 = aggregator_hbm_traffic(4, 65536)
    r16 = aggregator_hbm_traffic(16, 65536)
    assert r16["ratio"] > r4["ratio"] > 1.0


@pytest.mark.parametrize("n,d,kw", [
    (1, 494_147_584, {}), (4, 65536, {}), (16, 65536, {}),
    (3, 1000, dict(quant_block=128)), (8, 4096, dict(compressed=False))])
def test_roofline_matches_reference(n, d, kw):
    assert aggregator_hbm_traffic(n, d, **kw) == j_traffic(n, d, **kw)


@pytest.mark.parametrize("planner", ["incremental"])
def test_measure_planner_latency_rows(planner):
    rows = measure_planner_latency((4, 8), n_aggregators=2, repeats=1,
                                   planner=planner)
    assert [r["u"] for r in rows] == [4.0, 8.0]
    for r in rows:
        assert r["latency_s"] > 0.0
        assert r["latency_per_u_us"] == pytest.approx(
            r["latency_s"] / r["u"] * 1e6)
