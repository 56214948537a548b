"""The harness of the sharded twins (``tests/test_torch_sharded_*.py``,
``tests/test_torch_steps_moe.py``): the port's steps on a world of four
gloo processes against the JAX package's ``build_step`` under ``jit`` on 4
forced CPU devices, on the same mesh shapes, the same params and the same
batches.

A test file names its *plan*: the reduced configs it runs (with any cut of
depth), the training cases ``(arch, mesh, case)`` and the serving runs
``(arch, mesh, kind)``.  ``run_twins`` starts one JAX subprocess and one
4-rank world for the whole plan, at the same time, and returns their
results as numpy arrays:

* the params JAX initializes (key 0, f32, under ``jit``), carried into
  each rank through
  ``interop.to_torch`` (into its shards, ``mesh=``/``specs=``, on a mesh
  with a ``model`` axis) and into the JAX subprocess as they are;
* one ``SyntheticLM`` batch of global batch 8 at seq 32 a config, with
  seeded normal frames for an encoder-decoder;
* prefill of the first 4 rows, then 3 decode steps from position 32 on a
  64-position cache holding the prefill's entries (``decode``), or on a
  seeded int8 cache whose first 32 positions are random payloads and
  scales (``decode_q8``: the reference's ``kv_int8=True``).

Meshes are named: ``"2x2"`` is ``(data=2, model=2)``, ``"1x4"`` is
``(data=1, model=4)``, ``"1x1"`` (JAX only) is one device; ``"4"`` is the
data-axis mesh, ``(data=4)`` in the port and ``(data=4, model=1)`` in
JAX.  The reference's MLfabric step does not compile with a data axis of
one beside a model axis above one (jax 0.9.0), so there it runs on
``"1x1"`` (``REF_MESH``), which GSPMD's layout does not change the values
of.

Result keys: ``{arch}/{mesh}/{case}/{i}`` (param leaf i after the step),
``.../loss`` and ``.../aux_loss`` (the port's per rank), and
``{arch}/{mesh}/{kind}/...`` for serving.  Each rank of the port also
reports whether every param leaf in and out, and every cache leaf, is a
DTensor laid out by ``param_shardings`` (stripped of the batch axes for
MLfabric) or ``cache_shardings``, holding only its shard.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS, LR, SEQ, BATCH = 4, 0.1, 32, 8
PREFILL_ROWS, CACHE_LEN, DECODE_STEPS = 4, 64, 3
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4": ((4,), ("data",))}
JAX_MESHES = {"2x2": ((2, 2), ("data", "model")),
              "1x4": ((1, 4), ("data", "model")),
              "1x1": ((1, 1), ("data", "model")),
              "4": ((4, 1), ("data", "model"))}
TRAIN = {"auto": dict(grad_path="auto"),
         "auto_mb2": dict(grad_path="auto", microbatches=2),
         "mlfabric": dict(grad_path="mlfabric")}
REF_MESH = {("1x4", "mlfabric"): "1x1"}
# cache leaves that hold positions (padded to CACHE_LEN for decode); the
# recurrent states and whisper's cross_kv are carried as they are
SEQ_LEAVES = ("k", "v", "ckv", "krope")

_COMMON = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    out, inp, plan = sys.argv[1], sys.argv[2], eval(sys.argv[3])
    (meshes, train, ref_mesh, seq_leaves, (lr, seq, batch, rows, cache_len,
                                           steps)) = plan["consts"]
    data = np.load(inp)

    def reduced(get_config, arch):
        return dataclasses.replace(get_config(arch).reduced(),
                                   **plan["cuts"].get(arch, {}))

    def batch_np(arch, n=None):
        return {k.split("/")[2]: data[k][:n] for k in data.files
                if k.startswith(f"batch/{arch}/")}

    def q8_np(arch):
        return {k.split("/")[2]: data[k] for k in data.files
                if k.startswith(f"q8/{arch}/")}
""")

_JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
""") + _COMMON + textwrap.dedent("""
    import jax, jax.numpy as jnp
    from repro.configs import get_config, get_shape
    from repro.dist.compat import AxisType, make_mesh
    from repro.launch.steps import build_step
    from repro.models import build_model
    from repro.optim.sgd import momentum_sgd_init

    tshape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                 global_batch=batch)
    pshape = dataclasses.replace(get_shape("prefill_32k"), seq_len=seq,
                                 global_batch=rows)
    dshape = dataclasses.replace(get_shape("decode_32k"), seq_len=cache_len,
                                 global_batch=rows)
    res = {}

    def mesh_of(name):
        shape, axes = meshes[name]
        return make_mesh(shape, axes, devices=jax.devices()[:np.prod(shape)],
                         axis_types=(AxisType.Auto,) * len(axes))

    def run(bnd, *args):
        return jax.jit(bnd.fn, in_shardings=bnd.in_shardings,
                       out_shardings=bnd.out_shardings)(*args)

    def put(prefix, tree):
        for i, l in enumerate(jax.tree_util.tree_leaves(tree)):
            res[f"{prefix}/{i}"] = np.asarray(l, np.float32)

    for arch in plan["archs"]:
        cfg = reduced(get_config, arch)
        leaves, treedef = jax.tree_util.tree_flatten(jax.eval_shape(
            build_model(cfg, dtype=jnp.float32).init, jax.random.key(0)))
        params = jax.tree_util.tree_unflatten(treedef, [
            data[f"init/{arch}/{i}"] for i in range(len(leaves))])
        b = {k: jnp.asarray(v) for k, v in batch_np(arch).items()}
        for a, m, case in plan["train"]:
            if a != arch:
                continue
            p2, _, met = run(build_step(cfg, tshape,
                                        mesh_of(ref_mesh.get((m, case), m)),
                                        lr=lr, **train[case]),
                             params, momentum_sgd_init(params), b)
            put(f"{arch}/{m}/{case}", p2)
            res[f"{arch}/{m}/{case}/loss"] = np.float32(met["loss"])
            res[f"{arch}/{m}/{case}/aux_loss"] = np.float32(met["aux_loss"])
        for a, m, kind in plan["serve"]:
            if a != arch:
                continue
            mesh = mesh_of(m)
            key = f"{arch}/{m}/{kind}"
            pb = {k: v[:rows] for k, v in b.items() if k != "labels"}
            if kind == "prefill":
                logits, cache = run(build_step(cfg, pshape, mesh), params,
                                    pb)
                res[f"{key}/logits"] = np.asarray(logits)
                put(f"{key}/cache", cache)
                continue
            if kind == "decode_q8":
                full = {"layers": {k: jnp.asarray(v)
                                   for k, v in q8_np(arch).items()}}
            else:
                _, cache = jax.jit(build_model(cfg, dtype=jnp.float32
                                               ).prefill)(params, pb)

                def pad(path, v):
                    name = path[-1].key if hasattr(path[-1], "key") else ""
                    if name not in seq_leaves:
                        return v
                    whole = np.zeros(v.shape[:2] + (cache_len,) + v.shape[3:],
                                     np.float32)
                    whole[:, :, :seq] = np.asarray(v)
                    return jnp.asarray(whole)

                full = dict(cache, layers=jax.tree_util.tree_map_with_path(
                    pad, cache["layers"]))
            step = build_step(cfg, dshape, mesh,
                              kv_int8=kind == "decode_q8")
            for i in range(steps):
                logits, full = run(step, params, full,
                                   b["labels"][:rows, i:i + 1],
                                   jnp.int32(seq + i))
                res[f"{key}/{i}"] = np.asarray(logits)
            put(f"{key}/cache", full["layers"])
    np.savez(out, **res)
""")

_PORT_SCRIPT = textwrap.dedent("""
    import json
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import build_step, init_rank, make_mesh
    rank, world, _ = init_rank("gloo")
""") + _COMMON.replace("sys.argv[1], sys.argv[2], eval(sys.argv[3])",
                       "sys.argv[4], sys.argv[5], eval(sys.argv[6])") + \
    textwrap.dedent("""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.dist import sharding as shd
    from repro_torch.interop import to_numpy, to_torch
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import (tree_flatten, tree_flatten_with_path,
                                  tree_leaves, tree_map, tree_unflatten)

    tshape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                 global_batch=batch)
    pshape = dataclasses.replace(get_shape("prefill_32k"), seq_len=seq,
                                 global_batch=rows)
    dshape = dataclasses.replace(get_shape("decode_32k"), seq_len=cache_len,
                                 global_batch=rows)
    res, checks, made = {}, {}, {}

    def mesh_of(name):
        if name not in made:
            made[name] = make_mesh(*meshes[name], device="cpu")
        return made[name]

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

    def put(prefix, tree):
        for i, l in enumerate(tree_leaves(to_numpy(tree))):
            res[f"{prefix}/{i}"] = l

    def torch_batch(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}

    for arch in plan["archs"]:
        cfg = reduced(get_config, arch)
        leaves, treedef = tree_flatten(build_model(
            cfg, dtype=torch.float32, device="cpu").init(
                torch.Generator().manual_seed(0)))
        init = tree_unflatten(treedef, [data[f"init/{arch}/{i}"]
                                        for i in range(len(leaves))])
        b = torch_batch(batch_np(arch))
        for a, m, case in plan["train"]:
            if a != arch:
                continue
            mesh, key, kw = mesh_of(m), f"{arch}/{m}/{case}", train[case]
            sharded = mesh.device_mesh is not None
            if sharded:
                specs = shd.param_shardings(cfg, mesh, init)
                sp = specs if kw["grad_path"] == "auto" else tree_map(
                    shd.strip_data, specs)
                params = to_torch(init, mesh=mesh, specs=sp)
                checks[f"{key}/in"] = layout_ok(params, sp, mesh)
            else:
                params = to_torch(init, device="cpu")
            opt = momentum_sgd_init(params)
            p2, o2, met = build_step(cfg, tshape, mesh, lr=lr, **kw).fn(
                params, opt, b)
            if sharded:
                checks[f"{key}/out"] = (layout_ok(p2, sp, mesh) and
                                        layout_ok(o2.history, sp, mesh))
            put(key, p2)
            res[f"{key}/loss"] = np.float32(met["loss"])
            res[f"{key}/aux_loss"] = np.float32(met["aux_loss"])
        for a, m, kind in plan["serve"]:
            if a != arch:
                continue
            mesh, key = mesh_of(m), f"{arch}/{m}/{kind}"
            specs = shd.param_shardings(cfg, mesh, init)
            params = to_torch(init, mesh=mesh, specs=specs)
            pb = {k: v[:rows] for k, v in b.items() if k != "labels"}
            if kind == "prefill":
                logits, cache = build_step(cfg, pshape, mesh).fn(params, pb)
                checks[f"{key}/cache"] = layout_ok(cache, shd.cache_shardings(
                    cfg, mesh, cache, rows), mesh)
                res[f"{key}/logits"] = to_numpy(logits)
                put(f"{key}/cache", cache)
                continue
            if kind == "decode_q8":
                whole = {"layers": torch_batch(q8_np(arch))}
            else:
                plain = to_torch(init, device="cpu")
                _, cache = tf.prefill(plain, pb, cfg)
                named, cdef = tree_flatten_with_path(cache["layers"])
                whole = dict(cache, layers=tree_unflatten(cdef, [
                    torch.cat([t, t.new_zeros(t.shape[:2] + (cache_len - seq,)
                                              + t.shape[3:])], dim=2)
                    if path.split("/")[-1] in seq_leaves else t
                    for path, t in named]))
            dspecs = shd.cache_shardings(cfg, mesh, whole, rows)
            dc = shd.shard_tree(whole, mesh, dspecs)
            step = build_step(cfg, dshape, mesh)
            for i in range(steps):
                logits, dc = step.fn(params, dc, b["labels"][:rows, i:i + 1],
                                     seq + i)
                res[f"{key}/{i}"] = to_numpy(logits)
            checks[f"{key}/cache"] = layout_ok(dc, dspecs, mesh)
            put(f"{key}/cache", dc["layers"])
    np.savez(f"{out}/rank{rank}.npz", **res)
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(checks, f)
""")


def _inputs(plan: dict) -> dict:
    """The JAX-initialized params, the batches and the int8 caches of the
    plan, as numpy arrays keyed as the scripts read them."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data import SyntheticLM
    from repro.models import build_model
    from repro.models import transformer as jtf

    out = {}
    for arch in plan["archs"]:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  **plan["cuts"].get(arch, {}))
        params = jax.jit(build_model(cfg, dtype=jnp.float32).init)(
            jax.random.key(0))
        for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
            out[f"init/{arch}/{i}"] = np.asarray(leaf)
        b = SyntheticLM(cfg.vocab_size, SEQ, seed=0).batch(0, BATCH)
        if cfg.frontend == "audio":
            b["frontend_embeds"] = np.random.default_rng(1).standard_normal(
                (BATCH, cfg.encoder.n_frames, cfg.d_model)).astype(
                    np.float32)
        out.update({f"batch/{arch}/{k}": v for k, v in b.items()})
        if any(kind == "decode_q8" for a, _, kind in plan["serve"]
               if a == arch):
            rng = np.random.default_rng(2)
            cache = jtf.init_cache(cfg, PREFILL_ROWS, CACHE_LEN,
                                   kv_int8=True)["layers"]
            for k, v in cache.items():
                filled = np.zeros(v.shape, np.float32 if k.endswith("_s")
                                  else np.int8)
                if k.endswith("_s"):
                    filled[:, :, :SEQ] = rng.uniform(
                        1e-3, 2e-2, v[:, :, :SEQ].shape)
                else:
                    filled[:, :, :SEQ] = rng.integers(
                        -127, 128, v[:, :, :SEQ].shape)
                out[f"q8/{arch}/{k}"] = filled
    return out


def run_twins(tmp, plan: dict):
    """Run ``plan`` in JAX and in the port; return (the params JAX
    initialized, ``{arch: [leaves]}``; the port's results per rank; its
    layout checks per rank; JAX's results)."""
    from repro_torch.launch import run_local_world

    plan = dict(plan, consts=(JAX_MESHES, TRAIN, REF_MESH, SEQ_LEAVES,
                              (LR, SEQ, BATCH, PREFILL_ROWS, CACHE_LEN,
                               DECODE_STEPS)))
    inputs = _inputs(plan)
    inp = tmp / "inputs.npz"
    np.savez(inp, **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jax_out = tmp / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(jax_out), str(inp),
         repr(plan)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    port_plan = dict(plan, consts=(MESHES,) + plan["consts"][1:])
    try:
        run_local_world(_PORT_SCRIPT, N_RANKS,
                        args=(tmp, inp, repr(port_plan)), env=env,
                        timeout_s=400)
        log = jax_proc.communicate(timeout=400)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log[-3000:]
    init = {arch: [inputs[f"init/{arch}/{i}"] for i in range(
        sum(k.startswith(f"init/{arch}/") for k in inputs))]
        for arch in plan["archs"]}
    port = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N_RANKS)]
    checks = [json.loads((tmp / f"rank{r}.json").read_text())
              for r in range(N_RANKS)]
    return init, port, checks, dict(np.load(jax_out))


# --------------------------------------------------------------------------- #
# the checks the test files parametrize
# --------------------------------------------------------------------------- #
def check_ranks_agree(port) -> None:
    """Every rank gathers the same whole values: the loss is the global one
    on every rank, and so is the aux loss, but the MLfabric step's, which
    is each rank's own, as the reference's (``shard_map`` with rank-local
    losses)."""
    for r in range(1, N_RANKS):
        for k in port[0]:
            if not k.endswith("mlfabric/aux_loss"):
                np.testing.assert_array_equal(port[r][k], port[0][k],
                                              err_msg=k)


def check_step(runs, arch: str, mesh: str, case: str, *,
               atol: float = 1e-6) -> None:
    """Loss and aux loss within rtol 1e-5 on every rank, params after the
    step within rtol 1e-4 / ``atol`` (the f32 rule of
    ``tests/test_torch_steps.py``), and every leaf JAX moved moved.  The
    MLfabric step's aux loss is the first rank's own, as the reference
    returns its first device's."""
    init, port, _, jres = runs
    key = f"{arch}/{mesh}/{case}"
    for r in range(N_RANKS):
        for m in ("loss", "aux_loss"):
            if m == "aux_loss" and case == "mlfabric" and r:
                continue
            np.testing.assert_allclose(port[r][f"{key}/{m}"],
                                       jres[f"{key}/{m}"], rtol=1e-5,
                                       err_msg=(r, m))
    for i, p0 in enumerate(init[arch]):
        g, ref = port[0][f"{key}/{i}"], jres[f"{key}/{i}"]
        assert g.shape == ref.shape
        if np.any(ref != p0):
            assert np.any(g != p0), i
        np.testing.assert_allclose(g, ref, rtol=1e-4, atol=atol,
                                   err_msg=(key, i))


def check_layout(checks, prefix: str) -> None:
    """Every rank's layout checks under ``prefix`` hold (and there are
    some)."""
    for r, c in enumerate(checks):
        mine = [k for k in c if k.startswith(prefix + "/")]
        assert mine, (r, prefix)
        assert all(c[k] for k in mine), (r, {k: c[k] for k in mine})


def check_serve(runs, arch: str, mesh: str, kind: str, *,
                atol: float = 1e-5, rtol: float = 1e-5) -> None:
    """Prefill logits, or each decode step's logits, and every cache leaf
    after them within ``atol``/``rtol``; an int8 payload within one step
    of the reference's (a rounding tie of a value the two sides compute
    in other orders)."""
    _, port, _, jres = runs
    key = f"{arch}/{mesh}/{kind}"
    logits = ["logits"] if kind == "prefill" else [
        str(i) for i in range(DECODE_STEPS)]
    for k in logits:
        np.testing.assert_allclose(port[0][f"{key}/{k}"], jres[f"{key}/{k}"],
                                   rtol=rtol, atol=atol, err_msg=k)
    cache = sorted(k for k in jres if k.startswith(f"{key}/cache/"))
    assert cache and len(cache) == len(
        [k for k in port[0] if k.startswith(f"{key}/cache/")])
    for k in cache:
        got, ref = port[0][k], jres[k]
        assert got.shape == ref.shape, k
        if kind == "decode_q8" and not np.any(ref % 1):
            # int8 payload: one step at most, on a few entries
            assert np.abs(got - ref).max() <= 1, k
            assert np.mean(got != ref) < 1e-3, k
        else:
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                       err_msg=k)
