"""The port's whole slice: MLfabric-A training through the int8 wire.

* Parity: the port's and the JAX package's ``AsyncTrainer(compress=True)``
  train the reduced qwen2-0.5b from the same converted f32 params on the
  same batches.  The schedule (commits, drops, delay statistics) must be
  identical — with ``replicate=False`` nothing in it reads the update
  values.  The eval losses agree within 1e-3: every kernel and the model
  match at 1e-5 or better, but f32 sums in another order can put a value
  on the other side of an int8 rounding tie, which moves that parameter by
  a whole quantization step, and training carries such steps on.
* The port alone meets the claims of
  ``tests/test_system.py::test_end_to_end_async_lm_training`` and of
  ``tests/test_failover.py::test_midrun_primary_kill_recovers_within_divmax``.
* The package imports neither JAX nor the JAX package, not even after a
  world-of-one in-graph MLfabric step, the tiers, a prefill and decode
  steps, the serve loop, one step of the training CLI, pod-async, sync
  and SSP training, an elastic session, a paper scenario under the phase
  profiler and the qwen2-7b, phi-3-vision and granite-moe families, and
  never falls back to the CPU unasked.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.ps import AsyncTrainer as JAsyncTrainer
from repro_torch.configs import get_config
from repro_torch.core import C2, N_STATIC, mb
from repro_torch.data import SyntheticLM
from repro_torch.interop import to_torch
from repro_torch.models import build_model
from repro_torch.ps import AsyncTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_KW = dict(n_workers=4, tau_max=8, base_lr=0.5, gamma=0.0,
                delay_adaptive=False, update_size=mb(10), compute_time=0.05,
                straggler=C2, bandwidth=N_STATIC, aggregators=2, has_aux=True,
                seed=0)


def _cursor(worker, t):
    # not hash(worker): str hashes are salted per process
    return int(worker.removeprefix("worker")) * 997 + t


def _port_trainer(params, *, compress, dtype):
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, dtype=dtype, device="cpu")
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)

    def data_fn(worker, t):
        return {k: torch.from_numpy(v)
                for k, v in src.batch(_cursor(worker, t), 4).items()}

    eval_batch = {k: torch.from_numpy(v)
                  for k, v in src.batch(12345, 8).items()}

    def eval_fn(p):
        with torch.no_grad():
            return model.loss_fn(p, eval_batch)[0]

    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    tr = AsyncTrainer(params, model.loss_fn, data_fn, eval_fn=eval_fn,
                      compress=compress, device="cpu", **TRAIN_KW)
    return tr, float(eval_fn(params))


def test_port_matches_jax_trainer():
    cfg = j_get_config("qwen2-0.5b").reduced()
    jmodel = j_build_model(cfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.key(0))
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)

    def data_fn(worker, t):
        return {k: jnp.asarray(v)
                for k, v in src.batch(_cursor(worker, t), 4).items()}

    eval_batch = {k: jnp.asarray(v) for k, v in src.batch(12345, 8).items()}

    @jax.jit
    def eval_fn(params):
        return jmodel.loss_fn(params, eval_batch)[0]

    jres = JAsyncTrainer(jparams, jmodel.loss_fn, data_fn, eval_fn=eval_fn,
                         compress=True, **TRAIN_KW).run(until_commits=20)
    tparams = to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    tr, _ = _port_trainer(tparams, compress=True, dtype=torch.float32)
    tres = tr.run(until_commits=20)

    assert tres.commits == jres.commits >= 20
    assert tres.drops == jres.drops
    assert tres.delay_stats == jres.delay_stats
    assert tres.sim_time == jres.sim_time
    assert [t for t, _ in tres.losses] == [t for t, _ in jres.losses]
    np.testing.assert_allclose([l for _, l in tres.losses],
                               [l for _, l in jres.losses], rtol=0, atol=1e-3)


@pytest.mark.parametrize("compress", [False, True])
def test_port_end_to_end_async_lm_training(compress):
    """The claim of test_end_to_end_async_lm_training, on the port: loss
    decreases and delays stay bounded, with and without the int8 wire."""
    tr, loss0 = _port_trainer(None, compress=compress, dtype=torch.bfloat16)
    res = tr.run(until_commits=60)
    assert res.commits >= 60
    assert res.delay_stats["max"] <= 8
    assert res.final_loss < loss0 - 0.2, (loss0, res.final_loss)


def test_server_owns_its_params():
    """Updates land in place on the server's own copy, never on the
    caller's tensors."""
    tr, _ = _port_trainer(None, compress=True, dtype=torch.float32)
    cfg = get_config("qwen2-0.5b").reduced()
    params = build_model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(1))
    before = params["layers"]["mlp"]["up"].clone()
    tr2 = AsyncTrainer(params, tr._loss_fn, tr.data_fn, device="cpu",
                       compress=True, **TRAIN_KW)
    tr2.run(until_commits=5)
    assert torch.equal(params["layers"]["mlp"]["up"], before)
    assert not torch.equal(tr2.server.params["layers"]["mlp"]["up"], before)


def test_port_midrun_primary_kill_recovers_within_divmax():
    """The port's twin of test_failover.py's real-tensor claim:
    AsyncTrainer(replicate=True) killed mid-run promotes its ReplicaServer,
    which is bit-identical to a never-failed run at the replica's frontier
    and within Div_max of it at the pre-fail frontier."""
    from repro_torch.core.network import gbps
    from repro_torch.core.scenario import BandwidthTrace, Scenario, ServerFail
    from repro_torch.core.simulator import StragglerModel

    target = torch.tensor([3.0, -2.0, 1.0, 0.5, -1.5, 2.5])

    def quad_loss(p, b):
        return torch.sum(torch.square(p["w"] - b["target"]))

    div = 0.75
    kw = dict(n_workers=4, tau_max=8, base_lr=0.02, gamma=0.5,
              delay_adaptive=False, update_size=mb(20), compute_time=0.05,
              straggler=StragglerModel(0, 1), bandwidth=N_STATIC, seed=0,
              replicate=True, div_max=div, device="cpu",
              eval_fn=lambda p: quad_loss(p, {"target": target}))
    data_fn = lambda w, t: {"target": target}  # noqa: E731
    init = {"w": torch.zeros(6)}
    slow = [BandwidthTrace(time=0.0, host="replica", down=gbps(0.35))]

    ref = AsyncTrainer(init, quad_loss, data_fn,
                       scenario=Scenario(list(slow)), **kw)
    hist = {0: init["w"].clone()}
    orig_push = ref.server.push

    def rec_push(u, v):
        out = orig_push(u, v)
        hist[out] = ref.server.params["w"].clone()
        return out

    ref.server.push = rec_push
    ref.run(until_time=8.0)

    tr = AsyncTrainer(init, quad_loss, data_fn,
                      scenario=Scenario(list(slow) + [ServerFail(time=1.55)]),
                      **kw)
    cap = {}
    orig_prom = tr._on_promote

    def prom(t, gap):
        cap["v_fail"] = len(tr.sim.result.commits)
        orig_prom(t, gap)
        cap["v_rep"] = tr.sim.v_replica
        cap["params"] = tr.server.params["w"].clone()

    tr.sim.on_promote = prom
    res = tr.run(until_time=8.0)

    assert res.promotions == 1
    assert cap["v_rep"] <= cap["v_fail"]
    assert torch.equal(cap["params"], hist[cap["v_rep"]])
    assert float(torch.linalg.norm(hist[cap["v_fail"]] - cap["params"])) \
        <= div + 1e-6
    for r in (ref.sim.result, tr.sim.result):
        assert all(x <= div + 1e-9 for _, x in r.replica_divergence_trace)
    assert res.commits > cap["v_fail"]
    assert res.final_loss < float(quad_loss({"w": cap["params"]},
                                            {"target": target}))
    assert np.isfinite(res.recovery_time)


_ISOLATION_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import torch
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    sys.path.insert(0, {repo!r})
    import chip_smoke  # noqa: F401

    from repro_torch.configs import get_config
    from repro_torch.core import mb
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.ps import AsyncTrainer

    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, seed=0)
    data_fn = lambda w, t: {{k: torch.from_numpy(v)
                             for k, v in src.batch(t, 2).items()}}
    params = model.init(torch.Generator().manual_seed(0))
    res = AsyncTrainer(params, model.loss_fn, data_fn, n_workers=2,
                       update_size=mb(1), has_aux=True, compress=True,
                       device="cpu").run(until_commits=3)
    assert res.commits >= 3

    # the in-graph MLfabric step on a world of one, compressed
    import dataclasses
    import repro_torch.dist.collectives  # noqa: F401
    import repro_torch.launch.mesh, repro_torch.launch.steps  # noqa: F401
    from repro_torch.configs import get_shape
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.optim import momentum_sgd_init
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=16,
                                global_batch=2)
    step = build_step(cfg, shape, make_host_mesh(device="cpu"),
                      grad_path="mlfabric", compress_inter=True,
                      bucket_bytes=1024)
    _, _, m = step.fn(params, momentum_sgd_init(params), data_fn(0, 0))
    assert torch.isfinite(m["loss"])

    # the switch and bounded-loss tiers, the sender's error feedback and
    # the phase-aware policy
    import functools
    import repro_torch.dist.policy, repro_torch.kernels.switch_sum  # noqa
    import repro_torch.kernels.scatter_aggregate  # noqa: F401
    from repro_torch.core.network import LossSchedule
    from repro_torch.dist import (ErrorFeedback, PhaseLossPolicy,
                                  loss_drop_mask, mlfabric_grad_reduce)
    from repro_torch.tree import tree_leaves
    sched = LossSchedule()
    sched.set_drop("pod0", 0.0, 0.25, direction="up")
    mesh = make_host_mesh(device="cpu")
    for kw in (dict(backend="hierarchical"),
               dict(backend="switch", keep_inter=0.1,
                    drop_mask_inter=functools.partial(
                        loss_drop_mask, sched, "pod0", "pod1", 0.0))):
        out = mlfabric_grad_reduce(params, mesh=mesh, inter_axis="pod",
                                   bucket_bytes=1024, **kw)
        assert all(torch.isfinite(v).all() for v in tree_leaves(out))
    pol = PhaseLossPolicy()
    ef = ErrorFeedback(256, device="cpu")
    g = torch.randn(256, generator=torch.Generator().manual_seed(0))
    ef.compress(g, keep=pol.topk_keep(), bound=0.5 * float(g.norm()),
                drop_mask=loss_drop_mask(sched, "pod0", "pod1", 0.0, 26))
    assert float(ef.residual.norm()) <= 0.5 * float(g.norm())

    # serving: a prefill under the flash-attention impl, decode steps with
    # both caches, and the serve loop
    import repro_torch.launch.serve  # noqa: F401
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import attention
    attention.set_attention_impl("pallas")
    toks = torch.from_numpy(data_fn(0, 0)["tokens"].numpy())
    logits, _ = model.prefill(params, {{"tokens": toks}})
    assert torch.isfinite(logits).all()
    for kv_int8 in (False, True):
        cache = model.init_cache(2, 4, kv_int8=kv_int8)
        for pos in range(3):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, pos:pos + 1], pos)
        assert torch.isfinite(logits).all()
    done, _, _ = serve(model, params, [Request(0, toks[0, :4].numpy())],
                       1, 6)
    assert len(done[0].output) == 2

    # slice 3: the training CLI for one step with a checkpoint and the
    # replica, pod-async with the int8 wire, sync, SSP, an elastic session,
    # the unfused receive
    import tempfile
    from repro_torch.launch import train
    attention.set_attention_impl("blockwise")    # training takes blockwise
    with tempfile.TemporaryDirectory() as d:
        run = train.train(["--steps", "1", "--batch", "2", "--seq", "16",
                           "--div-max", "1", "--ckpt-dir", d,
                           "--device", "cpu"])
        assert run.losses and run.replica.syncs == 1
    from repro_torch.dist import ElasticSession
    from repro_torch.kernels import compress_update, dequantize_op
    from repro_torch.ps import (PodAsyncTrainer, StaleSyncSim, SyncTrainer,
                                compare_ssp_mlfabric)
    quad = lambda p, b: torch.sum(torch.square(p["w"] - b["t"]))
    tgt = lambda w, t: {{"t": torch.ones(3)}}
    PodAsyncTrainer({{"w": torch.zeros(3)}}, quad, tgt, n_pods=2,
                    compress=True, device="cpu").run(until_commits=2)
    SyncTrainer({{"w": torch.zeros(3)}}, quad, tgt, n_workers=2,
                device="cpu").run(1)
    StaleSyncSim(2).run(2)
    compare_ssp_mlfabric(n_workers=2, n_iterations=2)
    sess = ElasticSession(step_fn_builder=lambda g: lambda s, b: (s, {{}}),
                          init_state=({{"w": torch.zeros(2)}}, {{}}),
                          device="cpu")
    sess.run_steps([None])
    (q, s), _ = compress_update(torch.ones(300))
    assert dequantize_op(q, s, orig_len=300).shape == (300,)

    # slice 7: a paper scenario under the phase profiler, the roofline
    # model, and the qwen2-7b, phi-3-vision and granite-moe families
    from repro_torch.obs import PhaseProfiler, aggregator_hbm_traffic
    from repro_torch.scenarios import paper_dynamic_cluster
    prof = PhaseProfiler()
    res = AsyncTrainer(params, model.loss_fn, data_fn, n_workers=4,
                       update_size=mb(1), has_aux=True, compress=True,
                       scenario=paper_dynamic_cluster(4, horizon=1.0),
                       callbacks=[prof], device="cpu").run(until_commits=3)
    assert prof.summary()["metrics"]["commits"] == res.commits
    assert aggregator_hbm_traffic(4, 1024)["ratio"] > 1.0
    from repro_torch.models import text_len
    for arch in ("qwen2-7b", "phi-3-vision-4.2b", "granite-moe-1b-a400m"):
        fcfg = get_config(arch).reduced()
        fm = build_model(fcfg, dtype=torch.float32, device="cpu")
        fp = fm.init(torch.Generator().manual_seed(0))
        fb = {{"tokens": torch.zeros((1, text_len(fcfg, 16)),
                                    dtype=torch.int32)}}
        if fcfg.frontend == "vision":
            fb["frontend_embeds"] = torch.zeros(
                (1, fcfg.n_frontend_tokens, fcfg.d_model))
        total, aux = fm.loss_fn(fp, {{**fb, "labels": fb["tokens"]}})
        assert torch.isfinite(total) and (float(aux["aux_loss"]) > 0) == (
            fcfg.moe is not None)
        logits, _ = fm.prefill(fp, fb)
        logits, _ = fm.decode_step(fp, fm.init_cache(1, 4),
                                   fb["tokens"][:, :1], 0)
        assert torch.isfinite(logits).all()
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
    print("LEAKED", bad)
    sys.exit(1 if bad else 0)
""")


def test_port_imports_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATION_SCRIPT.format(repo=REPO)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncTrainer(params, model.loss_fn, lambda w, t: None, has_aux=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_torch({"w": np.zeros(3, np.float32)})
    from repro_torch.launch import make_host_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
