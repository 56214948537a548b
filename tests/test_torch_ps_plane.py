"""The rest of the port's PS plane against the JAX package's: pod-async
training, synchronous training and ``allreduce_via_ps``, SSP, elastic
sessions and replica promotion.

* Schedules (commits, drops, delay statistics, simulated time, per-round
  stats) come from the copied control plane and ``random.Random``: equal
  exactly.
* Params of the quadratic problems: rtol 1e-5 / atol 1e-6 against the
  reference.  Both compute the same f32 gradients of a quadratic; jit may
  fuse the reference's arithmetic differently, and with ``compress`` a
  difference in the last bit can move one int8 rounding, which the
  tolerance covers at these magnitudes.
* SSP and its comparison with MLfabric-A are pure Python over the copied
  control plane: identical outputs.
* Elastic sessions: the twins of ``tests/test_elastic_scenario.py``'s
  single-device tests and of ``tests/test_pod_async_elastic.py``'s elastic
  tests, the same hook sequence as the reference, and its 8 -> 6 device
  scenario run in one process over eight ``torch.device("cpu")`` entries,
  the builder splitting the batch over ``grid.shape["data"]``: final ``w``
  within rtol/atol 1e-6 of the from-scratch 6-way run (shard means summed
  in another order), as the reference holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scenario import Scenario as JScenario
from repro.core.scenario import WorkerJoin as JWorkerJoin
from repro.core.scenario import WorkerLeave as JWorkerLeave
from repro.checkpoint import BoundedDivergenceReplica as JReplica
from repro.dist.elastic import ElasticSession as JElasticSession
from repro.ps import PodAsyncTrainer as JPodAsyncTrainer
from repro.ps import SyncTrainer as JSyncTrainer
from repro.ps import allreduce_via_ps as j_allreduce_via_ps
from repro.ps.stale_sync import StaleSyncSim as JStaleSyncSim
from repro.ps.stale_sync import compare_ssp_mlfabric as j_compare_ssp
from repro.core.simulator import StragglerModel as JStragglerModel
from repro_torch.checkpoint import BoundedDivergenceReplica
from repro_torch.core.network import mb
from repro_torch.core.scenario import (Scenario, ServerFail, WorkerJoin,
                                       WorkerLeave)
from repro_torch.core.simulator import StragglerModel
from repro_torch.dist.elastic import ElasticSession, Grid, surviving_mesh
from repro_torch.kernels import ops
from repro_torch.ps import (PodAsyncTrainer, ReplicaServer, StaleSyncSim,
                            SyncTrainer, allreduce_via_ps,
                            compare_ssp_mlfabric, promote_replica)


def quad_loss(params, batch):
    return torch.sum(torch.square(params["w"] - batch["target"]))


def j_quad_loss(params, batch):
    return jnp.sum(jnp.square(params["w"] - batch["target"]))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=1e-5,
                               atol=1e-6)


def _same_schedule(tres, jres):
    assert tres.commits == jres.commits
    assert tres.drops == jres.drops
    assert tres.delay_stats == jres.delay_stats
    assert tres.sim_time == jres.sim_time
    assert [t for t, _ in tres.losses] == [t for t, _ in jres.losses]
    np.testing.assert_allclose([l for _, l in tres.losses],
                               [l for _, l in jres.losses], rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------- #
# pod-async
# --------------------------------------------------------------------------- #
def _pod_pair(target, init, straggler, **kw):
    t = torch.tensor(target, dtype=torch.float32)
    jt = jnp.asarray(target, jnp.float32)
    tr = PodAsyncTrainer(
        {"w": torch.tensor(init, dtype=torch.float32)}, quad_loss,
        lambda pod, step: {"target": t}, straggler=StragglerModel(*straggler),
        eval_fn=lambda p: quad_loss(p, {"target": t}), device="cpu", **kw)
    jtr = JPodAsyncTrainer(
        {"w": jnp.asarray(init, jnp.float32)}, j_quad_loss,
        lambda pod, step: {"target": jt},
        straggler=JStragglerModel(*straggler),
        eval_fn=lambda p: j_quad_loss(p, {"target": jt}), **kw)
    return tr, jtr


class TestPodAsync:
    def test_converges_with_local_steps(self):
        tr, jtr = _pod_pair([2.0, -1.0, 0.5, 3.0], [0.0] * 4, (0.25, 3.0),
                            n_pods=4, local_steps=4, inner_lr=0.05,
                            tau_max=6, gamma=0.0, update_size=mb(200),
                            compute_time=0.2, seed=0)
        res, jres = tr.run(until_commits=40), jtr.run(until_commits=40)
        assert res.commits >= 40
        assert res.delay_stats["max"] <= 6       # pod-level delay bound
        assert res.final_loss < 0.05, res.final_loss
        _same_schedule(res, jres)
        _close(tr.server.params["w"], jtr.server.params["w"])

    def test_compression_converges_same_problem(self):
        """int8-compressed pod deltas still converge; wire size is 4x less
        (visible through the simulator's transfer model); the CPU runs the
        kernels' plain versions and counts no launch."""
        results = {}
        before = (ops.quantize_op.launches, ops.dequant_aggregate_op.launches)
        for compress in (False, True):
            tr, jtr = _pod_pair([1.0, -2.0], [0.0, 0.0], (0, 1), n_pods=2,
                                local_steps=3, inner_lr=0.1, tau_max=4,
                                gamma=0.0, update_size=mb(400),
                                compute_time=0.05, compress=compress, seed=1)
            results[compress] = tr.run(until_commits=24)
            _same_schedule(results[compress], jtr.run(until_commits=24))
            _close(tr.server.params["w"], jtr.server.params["w"])
            assert tr.compress == compress
        assert results[True].final_loss < 0.05
        assert results[True].sim_time < results[False].sim_time
        assert (ops.quantize_op.launches,
                ops.dequant_aggregate_op.launches) == before

    def test_pod_delta_equals_local_training(self):
        """One pod, no contention: the committed model matches running the
        same local steps directly (delta semantics are exact)."""
        t = torch.tensor([1.0])
        tr = PodAsyncTrainer({"w": torch.zeros(1)}, quad_loss,
                             lambda p, s: {"target": t}, n_pods=1,
                             local_steps=5, inner_lr=0.1, gamma=0.0,
                             compute_time=0.05, update_size=mb(10),
                             straggler=StragglerModel(0, 1), seed=2,
                             device="cpu")
        tr.run(until_commits=1)
        w = torch.zeros(1)
        for _ in range(5):
            w = w - 0.1 * 2 * (w - t)
        torch.testing.assert_close(tr.server.params["w"], w, rtol=1e-5,
                                   atol=0)

    def test_bf16_params_keep_their_dtype(self):
        t = torch.tensor([1.0, 2.0])
        tr = PodAsyncTrainer({"w": torch.zeros(2, dtype=torch.bfloat16)},
                             quad_loss, lambda p, s: {"target": t},
                             n_pods=2, local_steps=2, compress=True,
                             straggler=StragglerModel(0, 1), device="cpu")
        tr.run(until_commits=4)
        assert tr.server.params["w"].dtype == torch.bfloat16
        assert tr.server.history["w"].dtype == torch.float32


# --------------------------------------------------------------------------- #
# synchronous training and the AllReduce API
# --------------------------------------------------------------------------- #
class TestSyncTrainer:
    def test_sync_step_applies_mean(self):
        t = torch.tensor([1.0, 1.0])
        tr = SyncTrainer({"w": torch.zeros(2)}, quad_loss,
                         lambda w, s: {"target": t}, n_workers=4,
                         base_lr=0.25, gamma=0.0, update_size=mb(10),
                         device="cpu")
        tr.step()
        # grad = 2(w - t) = -2; update = -lr * mean_grad = 0.5
        torch.testing.assert_close(tr.server.params["w"],
                                   torch.tensor([0.5, 0.5]), rtol=1e-5,
                                   atol=0)

    def test_aggregation_used_under_stragglers_same_as_reference(self):
        """Same seed, same rounds: the per-round stats equal the
        reference's, and the params agree."""
        rng = np.random.default_rng(0)
        targets = rng.standard_normal((8, 3)).astype(np.float32)
        tt = [torch.from_numpy(x) for x in targets]
        jt = [jnp.asarray(x) for x in targets]
        kw = dict(n_workers=8, update_size=mb(100), aggregators=3, seed=1,
                  base_lr=0.1, gamma=0.5)
        tr = SyncTrainer({"w": torch.ones(3)}, quad_loss,
                         lambda w, s: {"target": tt[int(w[6:])]},
                         straggler=StragglerModel(0.5, 4.0), device="cpu",
                         **kw)
        jtr = JSyncTrainer({"w": jnp.ones(3)}, j_quad_loss,
                           lambda w, s: {"target": jt[int(w[6:])]},
                           straggler=JStragglerModel(0.5, 4.0), **kw)
        tr.run(3)
        jtr.run(3)
        assert any(s.n_aggregated > 0 for s in tr.stats)
        assert [vars(s) for s in tr.stats] == [vars(s) for s in jtr.stats]
        _close(tr.server.params["w"], jtr.server.params["w"])
        assert tr.server.version == jtr.server.version == 3

    def test_allreduce_via_ps(self):
        rng = np.random.default_rng(3)
        ups = [{"a": rng.standard_normal(5).astype(np.float32),
                "b": {"c": rng.standard_normal((2, 2)).astype(np.float32)}}
               for _ in range(4)]
        tups = [{"a": torch.from_numpy(u["a"]).bfloat16(),
                 "b": {"c": torch.from_numpy(u["b"]["c"])}} for u in ups]
        jups = [{"a": jnp.asarray(u["a"], jnp.bfloat16),
                 "b": {"c": jnp.asarray(u["b"]["c"])}} for u in ups]
        got = allreduce_via_ps(tups, seed=5)
        want = j_allreduce_via_ps(jups, seed=5)
        assert got["a"].dtype == torch.float32
        np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
        np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                      np.asarray(want["b"]["c"]))


# --------------------------------------------------------------------------- #
# stale-synchronous parallel
# --------------------------------------------------------------------------- #
class TestStaleSync:
    @pytest.mark.parametrize("aggregate", [False, True])
    def test_ssp_identical_to_reference(self, aggregate):
        slow, jslow = StragglerModel(0.125, 4.0), JStragglerModel(0.125, 4.0)
        res = StaleSyncSim(8, k=2, straggler=slow, aggregate=aggregate,
                           seed=0).run(30)
        jres = JStaleSyncSim(8, k=2, straggler=jslow, aggregate=aggregate,
                             seed=0).run(30)
        assert vars(res) == vars(jres)
        assert res.throughput == jres.throughput
        if not aggregate:
            assert res.halt_time > 0.0

    def test_mlfabric_matches_staleness_without_halting(self):
        cmp = compare_ssp_mlfabric(n_workers=8, k=2, slow_factor=4.0,
                                   n_iterations=20, seed=1)
        assert cmp == j_compare_ssp(n_workers=8, k=2, slow_factor=4.0,
                                    n_iterations=20, seed=1)
        assert cmp["mlfabric_max_delay"] <= cmp["staleness_bound"]
        assert cmp["ssp_halt_time"] > 0.0

    def test_aggregation_helps_ssp(self):
        s = StragglerModel(0, 1)
        plain = StaleSyncSim(8, k=2, straggler=s, aggregate=False,
                             seed=2).run(30)
        agg = StaleSyncSim(8, k=2, straggler=s, aggregate=True,
                           seed=2).run(30)
        assert agg.sim_time < plain.sim_time


# --------------------------------------------------------------------------- #
# elastic sessions
# --------------------------------------------------------------------------- #
class Recorder:
    HOOKS = ("on_run_start", "on_batch_start", "on_batch_end", "on_commit",
             "on_event", "on_failover", "on_replica_promote", "on_run_end")

    def __init__(self):
        self.calls = []
        for h in self.HOOKS:
            setattr(self, h, self._rec(h))

    def _rec(self, name):
        return lambda source, *args: self.calls.append(name)


def _quad_builder(grid):
    def step(state, batch):
        params, opt = state
        w = params["w"]
        new_w = w - 0.1 * (2.0 * (w - batch["target"]) / w.numel())
        return ({"w": new_w}, opt), {"update_norm": 0.0}
    return step


def _j_quad_builder(mesh):
    @jax.jit
    def step(state, batch):
        params, opt = state
        g = jax.grad(lambda p: jnp.mean(
            jnp.square(p["w"] - batch["target"])))(params)
        new_p = jax.tree.map(lambda p, gg: p - 0.1 * gg, params, g)
        return (new_p, opt), {"update_norm": 0.0}
    return step


def _fail_builder(grid):
    def step(state, batch):
        params, opt = state
        g = 2.0 * (params["w"] - batch["target"])
        new_p = {"w": params["w"] - 0.1 * g}
        return (new_p, opt), {"update_norm": 0.1 * torch.linalg.norm(g),
                              "loss": quad_loss(new_p, batch)}
    return step


class TestElastic:
    def test_surviving_mesh_shrinks_data_axis(self):
        grid = surviving_mesh([torch.device("cpu")], data=1, model=1)
        assert isinstance(grid, Grid) and grid.shape == {"data": 1,
                                                         "model": 1}
        devs = [torch.device("cpu")] * 7
        grid = surviving_mesh(devs, data=8, model=2)
        assert grid.shape == {"data": 3, "model": 2}
        assert grid.devices.shape == (3, 2)
        with pytest.raises(ValueError):
            surviving_mesh([], data=1)
        with pytest.raises(ValueError):
            surviving_mesh(devs[:1], model=2)

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ElasticSession(step_fn_builder=_quad_builder,
                           init_state=({"w": torch.zeros(2)}, {}))

    def test_fail_restore_resume_same_hooks_as_reference(self):
        """Lose devices mid-training; the session rebuilds and resumes from
        the bounded-divergence replica; loss keeps decreasing.  The replica
        lags the same number of updates as the reference's, and the hooks
        fire in the same order."""
        target = np.array([3.0, -1.0], np.float32)
        rec, jrec = Recorder(), Recorder()
        sess = ElasticSession(
            step_fn_builder=_fail_builder,
            init_state=({"w": torch.zeros(2)}, {}), data_axis=1,
            model_axis=1, device="cpu", callbacks=[rec],
            replica=BoundedDivergenceReplica(div_max=0.5, gamma=0.0))

        def j_builder(mesh):
            @jax.jit
            def step(state, batch):
                params, opt = state
                g = jax.grad(lambda p: j_quad_loss(p, batch))(params)
                new_p = jax.tree.map(lambda p, gg: p - 0.1 * gg, params, g)
                gn = jnp.sqrt(sum(jnp.sum(jnp.square(x))
                                  for x in jax.tree.leaves(g)))
                return (new_p, opt), {"update_norm": gn * 0.1,
                                      "loss": j_quad_loss(new_p, batch)}
            return step

        jsess = JElasticSession(
            step_fn_builder=j_builder, init_state=({"w": jnp.zeros(2)}, {}),
            data_axis=1, model_axis=1, callbacks=[jrec],
            replica=JReplica(div_max=0.5, gamma=0.0))
        batches = [{"target": torch.from_numpy(target)}] * 10
        jbatches = [{"target": jnp.asarray(target)}] * 10
        sess.run_steps(batches)
        jsess.run_steps(jbatches)
        loss_before = float(quad_loss(sess.state[0], batches[0]))

        info = sess.fail(n_lost_devices=0)
        jinfo = jsess.fail(n_lost_devices=0)
        assert "replica" in info["restored_from"]
        assert info["restored_from"] == jinfo["restored_from"]
        assert info["lost_updates"] == jinfo["lost_updates"]
        assert info["mesh_shape"] == dict(jinfo["mesh_shape"])
        assert sess.rebuilds == 1 and sess.step_idx == jsess.step_idx
        _close(sess.state[0]["w"], jsess.state[0]["w"])

        sess.run_steps(batches)
        jsess.run_steps(jbatches)
        loss_after = float(quad_loss(sess.state[0], batches[0]))
        assert loss_after <= loss_before + 1e-6
        assert rec.calls == jrec.calls
        assert "on_replica_promote" in rec.calls

    def test_server_fail_promotes_in_place(self):
        sess = ElasticSession(
            step_fn_builder=_fail_builder,
            init_state=({"w": torch.zeros(2)}, {}), device="cpu",
            replica=BoundedDivergenceReplica(div_max=1.0, gamma=0.0))
        batches = [{"target": torch.tensor([3.0, -1.0])}] * 6
        infos = sess.run_scenario(Scenario([ServerFail(time=4)]), batches)
        assert len(infos) == 1 and sess.rebuilds == 0
        assert infos[0]["restored_from"].startswith("replica:step_")
        assert sess.step_idx == 4 - infos[0]["lost_updates"] + 2

    def test_events_fire_at_step_index(self):
        sess = ElasticSession(step_fn_builder=_quad_builder,
                              init_state=({"w": torch.zeros(2)}, {}),
                              data_axis=1, model_axis=1, device="cpu")
        jsess = JElasticSession(step_fn_builder=_j_quad_builder,
                                init_state=({"w": jnp.zeros(2)}, {}),
                                data_axis=1, model_axis=1)
        infos = sess.run_scenario(
            Scenario([WorkerLeave(time=3, worker="worker0")]),
            [{"target": torch.ones(2)}] * 6, devices_per_worker=0)
        jinfos = jsess.run_scenario(
            JScenario([JWorkerLeave(time=3, worker="worker0")]),
            [{"target": jnp.ones(2)}] * 6, devices_per_worker=0)
        assert len(infos) == 1 and sess.rebuilds == 1
        assert sess.step_idx == 6  # all batches still ran
        assert [{**i, "mesh_shape": dict(i["mesh_shape"])} for i in infos] \
            == [{**i, "mesh_shape": dict(i["mesh_shape"])} for i in jinfos]
        _close(sess.state[0]["w"], jsess.state[0]["w"])

    def test_join_without_spares_is_noop(self):
        sess = ElasticSession(step_fn_builder=_quad_builder,
                              init_state=({"w": torch.zeros(2)}, {}),
                              data_axis=1, model_axis=1, device="cpu")
        infos = sess.run_scenario(Scenario([WorkerJoin(time=1)]),
                                  [{"target": torch.ones(2)}] * 3)
        assert infos == [] and sess.rebuilds == 0
        jsess = JElasticSession(step_fn_builder=_j_quad_builder,
                                init_state=({"w": jnp.zeros(2)}, {}))
        assert jsess.run_scenario(JScenario([JWorkerJoin(time=1)]),
                                  [{"target": jnp.ones(2)}] * 3) == infos

    def test_join_with_spares_grows_the_grid(self):
        cpu = torch.device("cpu")
        sess = ElasticSession(step_fn_builder=_quad_builder,
                              init_state=({"w": torch.zeros(2)}, {}),
                              data_axis=2, devices=[cpu])
        infos = sess.run_scenario(Scenario([WorkerJoin(time=1)]),
                                  [{"target": torch.ones(2)}] * 3,
                                  spare_devices=[cpu])
        assert infos[0]["mesh_shape"] == {"data": 2, "model": 1}
        assert sess.rebuilds == 1 and len(sess.devices) == 2


def _sharded_builder(grid):
    """The reference's 8-device step with its data-sharded batch: each
    data shard's mean-squared-error gradient on its grid device, averaged
    (equal shards, so the mean of shard means is the global mean)."""
    n = grid.shape["data"]

    def step(state, batch):
        params, opt = state
        grads = []
        for x, y, dev in zip(batch["x"].chunk(n), batch["y"].chunk(n),
                             grid.devices[:, 0]):
            w = params["w"].to(dev).detach().requires_grad_(True)
            loss = torch.mean(torch.square(x.to(dev) @ w - y.to(dev)))
            grads.append(torch.autograd.grad(loss, w)[0])
        g = torch.stack(grads).mean(0)
        new_p = {"w": (params["w"] - 0.05 * g).detach()}
        return (new_p, opt), {"update_norm": 0.05 * float(torch.linalg.norm(
            g))}
    return step


def test_elastic_scenario_eight_to_six_devices():
    """Two WorkerLeave events before step 5 shrink an 8-way data-parallel
    session to 6; the div_max=0 replica syncs every step, so recovery
    loses nothing, and training ends where a from-scratch 6-way run does."""
    rng = np.random.default_rng(0)
    batches = [{"x": torch.from_numpy(rng.normal(size=(24, 4))
                                      .astype(np.float32)),
                "y": torch.from_numpy(rng.normal(size=(24,))
                                      .astype(np.float32))}
               for _ in range(10)]
    init = {"w": torch.zeros(4)}
    cpus = [torch.device("cpu")] * 8
    sess = ElasticSession(step_fn_builder=_sharded_builder,
                          init_state=(init, {}), data_axis=8, model_axis=1,
                          devices=cpus,
                          replica=BoundedDivergenceReplica(div_max=0.0,
                                                           gamma=0.0))
    scen = Scenario([WorkerLeave(time=5, worker="worker6"),
                     WorkerLeave(time=5, worker="worker7")])
    infos = sess.run_scenario(scen, batches, devices_per_worker=1)
    assert len(infos) == 2, infos
    assert all("replica" in i["restored_from"] for i in infos), infos
    assert all(i["lost_updates"] == 0 for i in infos), infos
    assert [i["mesh_shape"]["data"] for i in infos] == [7, 6]
    assert sess.mesh.shape["data"] == 6 and len(sess.devices) == 6

    ref = ElasticSession(step_fn_builder=_sharded_builder,
                         init_state=(init, {}), data_axis=6, model_axis=1,
                         devices=cpus[:6])
    ref.run_steps(batches)
    assert ref.mesh.shape["data"] == 6
    got, want = sess.state[0]["w"].numpy(), ref.state[0]["w"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x, y = batches[0]["x"].numpy(), batches[0]["y"].numpy()
    assert np.mean((x @ got - y) ** 2) < np.mean(y ** 2)


# --------------------------------------------------------------------------- #
# replica promotion, both flavours
# --------------------------------------------------------------------------- #
def test_promote_replica_server():
    rep = ReplicaServer({"w": torch.zeros(2)})
    rep.apply_replicated({"w": torch.ones(2)}, 0, uid=0)
    params, version, lost = promote_replica(rep)
    torch.testing.assert_close(params["w"], torch.ones(2))
    assert version == 1 and lost == 0


def test_promote_bounded_divergence_replica():
    r, jr = BoundedDivergenceReplica(div_max=5.0), JReplica(div_max=5.0)
    from repro.ps.replica import promote_replica as j_promote
    for step, norm in enumerate([0.3, 0.3, 0.3, 0.9, 0.1]):
        r.offer(step, {"w": torch.full((2,), float(step))}, norm)
        jr.offer(step, {"w": jnp.full((2,), float(step))}, norm)
    params, step, lost = promote_replica(r)
    jparams, jstep, jlost = j_promote(jr)
    assert (step, lost) == (jstep, jlost) and lost > 0
    np.testing.assert_array_equal(params["w"].numpy(), np.asarray(jparams["w"]))
    with pytest.raises(RuntimeError):
        promote_replica(BoundedDivergenceReplica(div_max=1.0))
