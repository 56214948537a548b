"""The port's training steps against the JAX package's ``build_step``.

Model and data: the reduced qwen2-0.5b in f32, its params initialized by
JAX and converted through numpy, and one ``SyntheticLM`` batch of global
batch 8 at seq 32.  JAX runs ``build_step(..., grad_path=...)`` on a
``(2, 2, 1)`` ``("pod", "data", "model")`` mesh of 4 CPU devices in one
subprocess; the port runs the same steps on a 2-pod x 2-data world of four
gloo processes at the same time.  Each world starts once for the file.

Tolerances:
* loss within rtol 1e-5, and params after one step within rtol 1e-4 /
  atol 1e-6 for auto, mlfabric and ``overlap_chunks=2``: the same f32 math
  summed in other orders by XLA and by PyTorch (the tolerance of
  ``tests/test_torch_model.py``'s gradients);
* compressed: within ``lr`` times the bound of
  ``tests/test_torch_collectives.py`` (one int8 step of each pod's block
  scale, over ``mean_over``), on top of the f32 tolerance.
The port-only twins of ``tests/test_dist_path.py`` keep that file's
tolerances (loss 1e-3 / 1e-2, params rtol/atol 3e-2).
"""

import dataclasses
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
from repro_torch.configs import get_config, get_shape
from repro_torch.data import SyntheticLM
from repro_torch.launch import build_step, make_host_mesh, run_local_world
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.optim import momentum_sgd_init
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS, LR, SEQ, BATCH = 4, 0.1, 32, 8
CASES = {
    "auto": dict(grad_path="auto"),
    "mlfabric": dict(grad_path="mlfabric"),
    "compressed": dict(grad_path="mlfabric", compress_inter=True,
                       bucket_bytes=1024),
    "overlap2": dict(grad_path="mlfabric", overlap_chunks=2),
}

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, get_shape
    from repro.data import SyntheticLM
    from repro.dist.compat import AxisType, make_mesh
    from repro.launch.steps import build_step
    from repro.models import build_model
    from repro.optim.sgd import momentum_sgd_init

    out, cases, lr, seq, batch = (sys.argv[1], eval(sys.argv[2]),
                                  float(sys.argv[3]), int(sys.argv[4]),
                                  int(sys.argv[5]))
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
    cfg = get_config("qwen2-0.5b").reduced()
    params = build_model(cfg, dtype=jnp.float32).init(jax.random.key(0))
    opt = momentum_sgd_init(params)
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                global_batch=batch)
    b = {k: jnp.asarray(v)
         for k, v in SyntheticLM(cfg.vocab_size, seq, seed=0).batch(
             0, batch).items()}
    res = {}
    for name, kw in cases.items():
        bnd = build_step(cfg, shape, mesh, lr=lr, **kw)
        f = jax.jit(bnd.fn, in_shardings=bnd.in_shardings,
                    out_shardings=bnd.out_shardings)
        p2, _, m = f(jax.device_get(params), jax.device_get(opt), b)
        for i, l in enumerate(jax.tree_util.tree_leaves(p2)):
            res[f"{name}/{i}"] = np.asarray(l)
        res[f"{name}/loss"] = np.float32(m["loss"])
    np.savez(out, **res)
""")

_PORT_SCRIPT = textwrap.dedent("""
    import dataclasses
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.launch import build_step, init_rank, make_mesh
    rank, world, (inp, out, cases, lr, seq, batch) = init_rank("gloo")
    cases, lr, seq, batch = eval(cases), float(lr), int(seq), int(batch)
    import repro_torch.dist.collectives as col
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    cfg = get_config("qwen2-0.5b").reduced()
    _, treedef = tree_flatten(build_model(cfg, dtype=torch.float32,
                                          device="cpu").init(
        torch.Generator().manual_seed(0)))
    data = np.load(inp)
    params = tree_unflatten(treedef, [torch.from_numpy(data[f"init/{i}"])
                                      for i in range(len(data.files))])
    opt = momentum_sgd_init(params)
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                global_batch=batch)
    b = {k: torch.from_numpy(v)
         for k, v in SyntheticLM(cfg.vocab_size, seq, seed=0).batch(
             0, batch).items()}

    scales = []
    decode = col.dequant_aggregate_op
    def recording(q, s, w, **kw):
        scales.append((s.clone(), kw["orig_len"]))
        return decode(q, s, w, **kw)
    col.dequant_aggregate_op = recording

    res = {}
    for name, kw in cases.items():
        scales.clear()
        p2, _, m = build_step(cfg, shape, mesh, lr=lr, **kw).fn(params, opt,
                                                                b)
        for i, l in enumerate(tree_leaves(p2)):
            res[f"{name}/{i}"] = l.numpy()
        res[f"{name}/loss"] = np.float32(m["loss"])
        if scales:
            layout = col.plan_reduce(params, bucket_bytes=kw["bucket_bytes"])
            bounds = [(s.sum(0) / world).repeat_interleave(256)[:n]
                      for s, n in scales]
            assert len(bounds) == len(layout.buckets)
            for i, l in enumerate(tree_leaves(
                    col.unpack_reduced(bounds, layout, params))):
                res[f"bound:{name}/{i}"] = l.numpy()
    np.savez(f"{out}/rank{rank}.npz", **res)
""")


def _jax_init():
    cfg = j_get_config("qwen2-0.5b").reduced()
    params = j_build_model(cfg, dtype=jnp.float32).init(jax.random.key(0))
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("steps")
    init = _jax_init()
    inp = tmp / "init.npz"
    np.savez(inp, **{f"init/{i}": l for i, l in enumerate(init)})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    args = (repr(CASES), LR, SEQ, BATCH)
    jax_out = tmp / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(jax_out), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        run_local_world(_PORT_SCRIPT, N_RANKS, args=(inp, tmp, *args),
                        env=env, timeout_s=240)
        log = jax_proc.communicate(timeout=240)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log[-3000:]
    port = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N_RANKS)]
    return init, port, dict(np.load(jax_out))


def _leaves(res, case, n):
    return [res[f"{case}/{i}"] for i in range(n)]


def test_ranks_stay_replicated(runs):
    _, port, _ = runs
    for r in range(1, N_RANKS):
        for k in port[0]:
            np.testing.assert_array_equal(port[r][k], port[0][k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(runs, case):
    init, port, jres = runs
    np.testing.assert_allclose(port[0][f"{case}/loss"], jres[f"{case}/loss"],
                               rtol=1e-5)
    got, ref = _leaves(port[0], case, len(init)), _leaves(jres, case,
                                                          len(init))
    for i, (g, r, p0) in enumerate(zip(got, ref, init)):
        assert g.shape == r.shape
        if np.any(r != p0):             # a leaf JAX moved moved here too
            assert np.any(g != p0), i
        if case == "compressed":
            bound = LR * port[0][f"bound:{case}/{i}"]
            assert np.all(np.abs(g - r) <= bound + 1e-6 + 1e-4 * np.abs(r)), i
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6,
                                       err_msg=(case, i))


@pytest.mark.parametrize("case", ["mlfabric", "overlap2"])
def test_mlfabric_grad_path_matches_auto(runs, case):
    """The port's twin of tests/test_dist_path.py's claim: the scheduled
    collective path equals the all-reduce of every leaf after one step."""
    init, port, _ = runs
    assert abs(float(port[0]["auto/loss"]) - float(port[0][f"{case}/loss"])) \
        < 1e-3
    for a, b in zip(_leaves(port[0], "auto", len(init)),
                    _leaves(port[0], case, len(init))):
        np.testing.assert_allclose(a, b, rtol=3e-2, atol=3e-2)


def _port_setup(seq, batch, seed=0):
    cfg = get_config("qwen2-0.5b").reduced()
    params = build_model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(seed))
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                global_batch=batch)
    b = {k: torch.from_numpy(v) for k, v in
         SyntheticLM(cfg.vocab_size, seq, seed=0).batch(0, batch).items()}
    return cfg, params, shape, b


def test_gradient_accumulation_matches_full_batch():
    """The port's twin of tests/test_dist_path.py's claim: microbatches=4
    gives the same loss and params as one full batch."""
    cfg, params, shape, b = _port_setup(64, 8)
    mesh = make_host_mesh(device="cpu")
    opt = momentum_sgd_init(params)
    outs = {}
    for m in (1, 4):
        p2, _, metrics = build_step(cfg, shape, mesh, lr=0.1,
                                    microbatches=m).fn(params, opt, b)
        outs[m] = (p2, float(metrics["loss"]), float(metrics["grad_norm"]))
    assert abs(outs[1][1] - outs[4][1]) < 1e-2, (outs[1][1], outs[4][1])
    assert outs[1][2] > 0 and abs(outs[1][2] - outs[4][2]) < 1e-2 * outs[1][2]
    for a, b_ in zip(tree_leaves(outs[1][0]), tree_leaves(outs[4][0])):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=3e-2,
                                   atol=3e-2)


def test_step_leaves_its_inputs_alone():
    cfg, params, shape, b = _port_setup(32, 4)
    before = [p.clone() for p in tree_leaves(params)]
    opt = momentum_sgd_init(params)
    mesh = make_host_mesh(device="cpu")
    p2, o2, _ = build_step(cfg, shape, mesh, grad_path="mlfabric",
                           lr=0.1).fn(params, opt, b)
    for p, p0 in zip(tree_leaves(params), before):
        assert torch.equal(p, p0)
    assert all(not torch.any(h) for h in tree_leaves(opt.history))
    assert any(torch.any(h) for h in tree_leaves(o2.history))


@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k"])
def test_serving_shapes_raise(kind):
    cfg = get_config("qwen2-0.5b").reduced()
    mesh = make_host_mesh(device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        build_step(cfg, get_shape(kind), mesh)


def test_remat_changes_nothing():
    """Rematerialized layers recompute the same forward: equal loss and
    equal gradients with and without remat."""
    cfg, params, _, b = _port_setup(32, 2)
    leaves, treedef = tree_flatten(params)
    out = {}
    for remat in (True, False):
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = tf.loss_fn(tree_unflatten(treedef, live), b, cfg,
                             remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, live))
    assert torch.equal(out[True][0], out[False][0])
    for a, b_ in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("kw", [dict(grad_path="mlfabric", overlap_chunks=3),
                                dict(grad_path="auto", microbatches=3)])
def test_batch_that_does_not_split_raises(kw):
    cfg, _, shape, _ = _port_setup(32, 4)
    with pytest.raises(ValueError, match="does not split"):
        build_step(cfg, shape, make_host_mesh(device="cpu"), **kw)
