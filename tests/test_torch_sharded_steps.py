"""The port's steps on a ``model`` axis (DTensor) against the JAX package's
``build_step`` on the same mesh shapes.

Model and data: the reduced qwen2-0.5b in f32 (4 q heads, 2 KV heads), its
params initialized by JAX and carried into each rank's shards through
``interop.to_torch(..., mesh=, specs=)``, and one ``SyntheticLM`` batch of
global batch 8 at seq 32.  JAX runs ``build_step`` under ``jit`` with the
bundle's shardings on 4 forced CPU devices in one subprocess; the port runs
the same steps on one world of four gloo processes at the same time, on
three meshes:

* ``(data=2, model=2)``: heads divide, so attention runs on 2 q heads and
  1 KV head a rank;
* ``(data=1, model=4)``: the 2 KV heads do not divide, so attention
  replicates over ``model``, as GSPMD lays it out;
* ``(pod=2, data=1, model=2)``: the compressed MLfabric step (the int8
  wire runs across pods).

Steps: auto, mlfabric and ``overlap_chunks=2`` on the first two, auto
with 2 microbatches on the first, the compressed step on the third; the prefill of the first 4 rows' 32 tokens
and 3 decode steps after it (a 64-position cache, the sequence over
``model``), on the first two.

Tolerances: loss within rtol 1e-5 and params within rtol 1e-4 / atol 1e-6
(``tests/test_torch_steps.py``'s f32 rule); compressed within ``lr`` times
one int8 step of each pod's block scale over ``mean_over`` on top of it;
prefill logits and cache and decode logits within 1e-5 (atol and rtol).
Every output param leaf is a DTensor laid out by ``param_shardings``
(stripped of the batch axes for mlfabric), holding only its shard.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro_torch.launch import run_local_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS, LR, SEQ, BATCH = 4, 0.1, 32, 8
PREFILL_ROWS, CACHE_LEN, DECODE_STEPS = 4, 64, 3
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "p2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
JAX_MESHES = {**MESHES, "1x1": ((1, 1), ("data", "model"))}
TRAIN = {"auto": dict(grad_path="auto"),
         "auto_mb2": dict(grad_path="auto", microbatches=2),
         "mlfabric": dict(grad_path="mlfabric"),
         "overlap2": dict(grad_path="mlfabric", overlap_chunks=2),
         "compressed": dict(grad_path="mlfabric", compress_inter=True,
                            bucket_bytes=1024)}
CASES = [(m, c) for m in ("2x2", "1x4") for c in ("auto", "mlfabric",
                                                  "overlap2")] + [
    ("2x2", "auto_mb2"), ("p2x1x2", "compressed")]
SERVE_MESHES = ("2x2", "1x4")
# the reference's MLfabric step does not compile with a data axis of one
# beside a model axis above one (jax 0.9.0: XLA's "cross-partition
# allreduce must be in (partial) manual partitioning mode" for the pmean
# over data); there it runs on the mesh with the model axis folded to one,
# which GSPMD's layout does not change the values of
REF_MESH = {("1x4", "mlfabric"): "1x1", ("1x4", "overlap2"): "1x1"}

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

    out = sys.argv[1]
    meshes, train, cases, serve_meshes, (lr, seq, batch, rows, cache_len,
                                         steps), ref_mesh = (
        eval(a) for a in sys.argv[2:8])
    cfg = get_config("qwen2-0.5b").reduced()
    params = build_model(cfg, dtype=jnp.float32).init(jax.random.key(0))
    opt = momentum_sgd_init(params)
    b = {k: jnp.asarray(v)
         for k, v in SyntheticLM(cfg.vocab_size, seq, seed=0).batch(
             0, batch).items()}
    tshape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                 global_batch=batch)
    pshape = dataclasses.replace(get_shape("prefill_32k"), seq_len=seq,
                                 global_batch=rows)
    dshape = dataclasses.replace(get_shape("decode_32k"), seq_len=cache_len,
                                 global_batch=rows)
    res = {}

    def run(bnd, *args):
        return jax.jit(bnd.fn, in_shardings=bnd.in_shardings,
                       out_shardings=bnd.out_shardings)(*args)

    for mname, (shape, axes) in meshes.items():
        mesh = make_mesh(shape, axes, devices=jax.devices()[:np.prod(shape)],
                         axis_types=(AxisType.Auto,) * len(axes))
        for m, case in cases:
            if ref_mesh.get((m, case), m) != mname:
                continue
            p2, _, met = run(build_step(cfg, tshape, mesh, lr=lr,
                                        **train[case]),
                             jax.device_get(params), jax.device_get(opt), b)
            for i, l in enumerate(jax.tree_util.tree_leaves(p2)):
                res[f"{m}/{case}/{i}"] = np.asarray(l)
            res[f"{m}/{case}/loss"] = np.float32(met["loss"])
        if mname not in serve_meshes:
            continue
        logits, cache = run(build_step(cfg, pshape, mesh),
                            jax.device_get(params),
                            {"tokens": b["tokens"][:rows]})
        res[f"{mname}/prefill/logits"] = np.asarray(logits)
        for k, v in cache["layers"].items():
            res[f"{mname}/prefill/{k}"] = np.asarray(v)
        full = {"layers": {}}
        for k, v in cache["layers"].items():
            whole = np.zeros(v.shape[:2] + (cache_len,) + v.shape[3:],
                             np.float32)
            whole[:, :, :seq] = np.asarray(v)
            full["layers"][k] = whole
        step = build_step(cfg, dshape, mesh)
        for i in range(steps):
            logits, full = run(step, jax.device_get(params), full,
                               b["labels"][:rows, i:i + 1],
                               jnp.int32(seq + i))
            res[f"{mname}/decode/{i}"] = np.asarray(logits)
        for k, v in full["layers"].items():
            res[f"{mname}/decode/{k}"] = np.asarray(v)
    np.savez(out, **res)
""")

_PORT_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.launch import build_step, init_rank, make_mesh
    rank, world, (inp, out, meshes, train, cases, serve_meshes,
                  consts) = init_rank("gloo")
    meshes, train, cases, serve_meshes = (eval(meshes), eval(train),
                                          eval(cases), eval(serve_meshes))
    lr, seq, batch, rows, cache_len, steps = eval(consts)
    import repro_torch.dist.collectives as col
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import sharding as shd
    from repro_torch.interop import to_numpy, to_torch
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_flatten, tree_leaves, tree_map
    from repro_torch.tree import tree_unflatten

    cfg = get_config("qwen2-0.5b").reduced()
    _, treedef = tree_flatten(build_model(cfg, dtype=torch.float32,
                                          device="cpu").init(
        torch.Generator().manual_seed(0)))
    data = np.load(inp)
    init = tree_unflatten(treedef, [data[f"init/{i}"]
                                    for i in range(len(data.files))])
    b = {k: torch.from_numpy(v)
         for k, v in SyntheticLM(cfg.vocab_size, seq, seed=0).batch(
             0, batch).items()}
    tshape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                 global_batch=batch)
    pshape = dataclasses.replace(get_shape("prefill_32k"), seq_len=seq,
                                 global_batch=rows)
    dshape = dataclasses.replace(get_shape("decode_32k"), seq_len=cache_len,
                                 global_batch=rows)

    scales = []
    decode = col.dequant_aggregate_op
    def recording(q, s, w, **kw):
        scales.append((s.clone(), kw["orig_len"]))
        return decode(q, s, w, **kw)
    col.dequant_aggregate_op = recording

    def layout_ok(tree, specs, mesh):
        # every leaf a DTensor laid out by its spec, holding its shard only
        from torch.distributed.tensor import DTensor
        for t, s in zip(tree_leaves(tree), tree_leaves(specs)):
            if not isinstance(t, DTensor):
                return False
            if list(t.placements) != shd.placements(mesh, s):
                return False
            if t.to_local().numel() * shd.spec_shards(mesh, s) != t.numel():
                return False
        return True

    res, checks = {}, {}
    from repro_torch.launch import make_host_mesh
    hm = make_host_mesh(2, 2, device="cpu")
    checks["host_mesh"] = [list(hm.axis_names), hm.shape,
                           list(hm.device_mesh.mesh_dim_names),
                           sorted(a for a, g in hm.groups.items() if g)]
    for mname, (shape, axes) in meshes.items():
        mesh = make_mesh(shape, axes, device="cpu")
        specs = shd.param_shardings(cfg, mesh, init)
        for m, case in cases:
            if m != mname:
                continue
            kw = train[case]
            sp = specs if kw["grad_path"] == "auto" else tree_map(
                shd.strip_data, specs)
            params = to_torch(init, mesh=mesh, specs=sp)
            opt = momentum_sgd_init(params)
            checks[f"{m}/{case}/in"] = layout_ok(params, sp, mesh)
            scales.clear()
            p2, o2, met = build_step(cfg, tshape, mesh, lr=lr, **kw).fn(
                params, opt, b)
            checks[f"{m}/{case}/out"] = (layout_ok(p2, sp, mesh) and
                                         layout_ok(o2.history, sp, mesh))
            for i, l in enumerate(tree_leaves(to_numpy(p2))):
                res[f"{m}/{case}/{i}"] = l
            res[f"{m}/{case}/loss"] = np.float32(met["loss"])
            if scales:
                # one int8 step of each pod's block scale, over mean_over
                whole = tree_map(torch.from_numpy, init)
                layout = col.plan_reduce(whole,
                                         bucket_bytes=kw["bucket_bytes"])
                assert len(scales) == len(layout.buckets), len(scales)
                n = shd._axis_size(mesh, shd.data_axes(mesh))
                bounds = [(s.sum(0) / n).repeat_interleave(256)[:k]
                          for s, k in scales]
                for i, l in enumerate(tree_leaves(col.unpack_reduced(
                        bounds, layout, whole))):
                    res[f"bound:{m}/{case}/{i}"] = l.numpy()
        if mname not in serve_meshes:
            continue
        params = to_torch(init, mesh=mesh, specs=specs)
        logits, cache = build_step(cfg, pshape, mesh).fn(
            params, {"tokens": b["tokens"][:rows]})
        cspecs = shd.cache_shardings(cfg, mesh, cache, rows)
        checks[f"{mname}/prefill/cache"] = layout_ok(cache, cspecs, mesh)
        res[f"{mname}/prefill/logits"] = to_numpy(logits)
        for k, v in to_numpy(cache)["layers"].items():
            res[f"{mname}/prefill/{k}"] = v
        whole = tf.init_cache(cfg, rows, cache_len, torch.float32,
                              device="cpu")
        for k, v in cache["layers"].items():
            whole["layers"][k][:, :, :seq] = v.full_tensor()
        dspecs = shd.cache_shardings(cfg, mesh, whole, rows)
        dc = shd.shard_tree(whole, mesh, dspecs)
        step = build_step(cfg, dshape, mesh)
        for i in range(steps):
            logits, dc = step.fn(params, dc, b["labels"][:rows, i:i + 1],
                                 seq + i)
            res[f"{mname}/decode/{i}"] = to_numpy(logits)
        checks[f"{mname}/decode/cache"] = layout_ok(dc, dspecs, mesh)
        for k, v in to_numpy(dc)["layers"].items():
            res[f"{mname}/decode/{k}"] = v
    np.savez(f"{out}/rank{rank}.npz", **res)
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(checks, f)
""")


def _jax_init():
    cfg = j_get_config("qwen2-0.5b").reduced()
    params = j_build_model(cfg, dtype=jnp.float32).init(jax.random.key(0))
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_steps")
    init = _jax_init()
    inp = tmp / "init.npz"
    np.savez(inp, **{f"init/{i}": l for i, l in enumerate(init)})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    args = tuple(map(repr, (MESHES, TRAIN, CASES, SERVE_MESHES,
                            (LR, SEQ, BATCH, PREFILL_ROWS, CACHE_LEN,
                             DECODE_STEPS))))
    jax_out = tmp / "jax.npz"
    jax_args = (repr(JAX_MESHES), *args[1:], repr(REF_MESH))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(jax_out), *jax_args],
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
    import json
    port = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N_RANKS)]
    checks = [json.loads((tmp / f"rank{r}.json").read_text())
              for r in range(N_RANKS)]
    return init, port, checks, dict(np.load(jax_out))


def test_ranks_agree(runs):
    """Every rank gathers the same whole values."""
    _, port, _, _ = runs
    for r in range(1, N_RANKS):
        for k in port[0]:
            np.testing.assert_array_equal(port[r][k], port[0][k], err_msg=k)


@pytest.mark.parametrize("mesh,case", CASES)
def test_step_matches_jax(runs, mesh, case):
    init, port, _, jres = runs
    key = f"{mesh}/{case}"
    np.testing.assert_allclose(port[0][f"{key}/loss"], jres[f"{key}/loss"],
                               rtol=1e-5)
    for i, p0 in enumerate(init):
        g, r = port[0][f"{key}/{i}"], jres[f"{key}/{i}"]
        assert g.shape == r.shape
        if np.any(r != p0):             # a leaf JAX moved moved here too
            assert np.any(g != p0), i
        bound = LR * port[0].get(f"bound:{key}/{i}", np.zeros_like(g))
        assert np.all(np.abs(g - r) <= bound + 1e-6 + 1e-4 * np.abs(r)), (
            key, i, float(np.abs(g - r).max()))


@pytest.mark.parametrize("mesh,case", CASES)
def test_step_layout(runs, mesh, case):
    """Params and history in and out laid out by ``param_shardings``
    (stripped for mlfabric), each rank holding its shard only."""
    _, _, checks, _ = runs
    for r in range(N_RANKS):
        assert checks[r][f"{mesh}/{case}/in"], r
        assert checks[r][f"{mesh}/{case}/out"], r


@pytest.mark.parametrize("mesh", SERVE_MESHES)
def test_prefill_matches_jax(runs, mesh):
    _, port, checks, jres = runs
    for k in ("logits", "k", "v"):
        np.testing.assert_allclose(port[0][f"{mesh}/prefill/{k}"],
                                   jres[f"{mesh}/prefill/{k}"],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert all(c[f"{mesh}/prefill/cache"] for c in checks)


@pytest.mark.parametrize("mesh", SERVE_MESHES)
def test_decode_matches_jax(runs, mesh):
    """3 steps against a cache whose sequence is split over ``model``: the
    logits of each step and the cache written in place (the rank holding
    each position), within 1e-5."""
    _, port, checks, jres = runs
    for i in range(DECODE_STEPS):
        np.testing.assert_allclose(port[0][f"{mesh}/decode/{i}"],
                                   jres[f"{mesh}/decode/{i}"],
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))
    for k in ("k", "v"):
        got, ref = port[0][f"{mesh}/decode/{k}"], jres[f"{mesh}/decode/{k}"]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        # the decoded positions hold values, the ones after stay zero
        assert np.all(np.any(got[:, :, SEQ:SEQ + DECODE_STEPS] != 0,
                             axis=(0, 3, 4)))
        assert not np.any(got[:, :, SEQ + DECODE_STEPS:])
    assert all(c[f"{mesh}/decode/cache"] for c in checks)


def test_host_mesh_with_model_axis(runs):
    """``make_host_mesh(data=2, model=2)`` on the world of four: a pod axis
    of one, and a DeviceMesh and groups over the axes above one."""
    _, _, checks, _ = runs
    for r, c in enumerate(checks):
        assert c["host_mesh"] == [["pod", "data", "model"],
                                  {"pod": 1, "data": 2, "model": 2},
                                  ["data", "model"], ["data", "model"]], r
