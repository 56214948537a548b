"""The port's MLfabric gradient reduction on a 2-pod x 2-data world of gloo
processes, against the numpy mean and against the JAX package's
``mlfabric_grad_reduce`` on a ``("pod", "data")`` mesh of 4 CPU devices.

Both sides get the same numpy gradients, one slice per rank as
``tests/test_dist_path.py`` builds them.  The four port ranks run at once
(``repro_torch.launch.run_local_world``) while one JAX subprocess runs
beside them; each world starts once for the whole file.

Tolerances:
* against the numpy mean, those of ``tests/test_dist_path.py``: rtol/atol
  1e-5 for the f32 paths, 5e-2 with the int8 cross-pod stage or a switch
  backend;
* against JAX, rtol 1e-6 (atol 1e-7) for the f32 paths: both sum two
  members per stage, and the port's aggregator kernel sums pods in order;
* the switch, hierarchical and sparse (``keep_inter``) paths against JAX:
  bit for bit.  The switch sum is exact integer arithmetic between IEEE
  products and quotients; the scales are ``amax * f32(1/127)`` on both
  sides (XLA's rewrite of ``/ 127`` under ``jit``); the top-k breaks ties
  lower index first on both sides; the scatter adds one value per column
  per pod, pods in order; two members or pods sum in one order;
* the sparse paths against the numpy mean would say nothing (they drop
  mass on purpose): they are held bit for bit against an independent numpy
  emulation of the stage instead;
* compressed against JAX: the intra-pod sums may differ by f32 rounding,
  which can move a value at an int8 tie by one step of its block's scale
  in each pod: |port - jax| <= sum over pods of that block's scale, divided
  by ``mean_over`` (scales recorded from the port's own run), plus rtol
  1e-6 for the scales' own rounding.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.dist.collectives import mlfabric_grad_reduce
from repro_torch.launch import make_host_mesh, run_local_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4
CASES = {
    "default": dict(),
    "tiny_buckets": dict(bucket_bytes=1024),
    "fifo": dict(shortest_first=False),
    "compressed": dict(compress_inter=True),
    # bucket [b] starts at element 5: an unaligned view with no pad
    "compressed_unaligned": dict(compress_inter=True, bucket_bytes=1024),
    "switch": dict(backend="switch"),
    "hierarchical": dict(backend="hierarchical"),
    "keep_0.1": dict(keep_inter=0.1),
    "keep_0.5": dict(keep_inter=0.5),
    # "loss": loss_drop_mask over a 25%-drop LossSchedule (callable k -> mask)
    "keep_loss": dict(keep_inter=0.1, drop_mask_inter="loss"),
    # one fixed mask, cut to k or padded with False per bucket
    "keep_mask_tiny": dict(keep_inter=0.5, bucket_bytes=1024,
                           drop_mask_inter=[i % 3 == 0 for i in range(40)]),
    "switch_keep": dict(backend="switch", keep_inter=0.1),
}
COMPRESSED = ("compressed", "compressed_unaligned")
SPARSE = ("keep_0.1", "keep_0.5", "keep_loss", "keep_mask_tiny",
          "switch_keep")
DENSE = [c for c in CASES if c not in SPARSE]


def _inputs():
    rng = np.random.default_rng(0)
    grads = {"w1": rng.normal(size=(N_RANKS, 33, 7)),
             "w2": rng.normal(size=(N_RANKS, 512)),
             "bias": rng.normal(size=(N_RANKS, 5)),
             "big": rng.normal(size=(N_RANKS, 3000))}
    small = {"a": rng.normal(size=(N_RANKS, 5)),
             "b": rng.normal(size=(N_RANKS, 256))}
    return ({k: v.astype(np.float32) for k, v in grads.items()},
            {k: v.astype(np.float32) for k, v in small.items()})


def _tree_for(case, grads, small):
    return small if case == "compressed_unaligned" else grads


_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P
    import functools
    from repro.core.network import LossSchedule
    from repro.dist.collectives import loss_drop_mask, mlfabric_grad_reduce
    from repro.dist.compat import make_mesh, shard_map

    inp, out, cases = sys.argv[1], sys.argv[2], eval(sys.argv[3])
    sched = LossSchedule()
    sched.set_drop("pod0", 0.0, 0.25, direction="up")
    for kw in cases.values():
        if kw.get("drop_mask_inter") == "loss":
            kw["drop_mask_inter"] = functools.partial(
                loss_drop_mask, sched, "pod0", "pod1", 0.0)
    data = np.load(inp)
    trees = {"grads": {k[2:]: data[k] for k in data if k.startswith("g_")},
             "small": {k[2:]: data[k] for k in data if k.startswith("s_")}}
    mesh = make_mesh((2, 2), ("pod", "data"))
    res = {}
    for name, kw in cases.items():
        tree = trees["small" if name == "compressed_unaligned" else "grads"]
        def body(g):
            return mlfabric_grad_reduce(g, intra_axis="data",
                                        inter_axis="pod", mean_over=4, **kw)
        specs = jax.tree.map(lambda _: P(("pod", "data")), tree)
        outs = jax.tree.map(lambda _: P(), tree)
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs,),
                              out_specs=outs, check_vma=False))
        for k, v in jax.device_get(f(tree)).items():
            res[f"{name}/{k}"] = np.asarray(v)
    np.savez(out, **res)
""")

_PORT_SCRIPT = textwrap.dedent("""
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.launch import init_rank, make_mesh
    rank, world, (inp, out, cases) = init_rank("gloo")
    cases = eval(cases)
    import functools
    import repro_torch.dist.collectives as col
    from repro_torch.core.network import LossSchedule
    sched = LossSchedule()
    sched.set_drop("pod0", 0.0, 0.25, direction="up")
    for kw in cases.values():
        if kw.get("drop_mask_inter") == "loss":
            kw["drop_mask_inter"] = functools.partial(
                col.loss_drop_mask, sched, "pod0", "pod1", 0.0)

    data = np.load(inp)
    trees = {"grads": {k[2:]: data[k] for k in data if k.startswith("g_")},
             "small": {k[2:]: data[k] for k in data if k.startswith("s_")}}
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    assert mesh.rank == rank == 2 * mesh.coords["pod"] + mesh.coords["data"]

    # record every decode's gathered scales: the compressed bound
    scales = []
    decode = col.dequant_aggregate_op
    def recording(q, s, w, **kw):
        scales.append((s.clone(), kw["orig_len"]))
        return decode(q, s, w, **kw)
    col.dequant_aggregate_op = recording

    res = {}
    for name, kw in cases.items():
        tree = trees["small" if name == "compressed_unaligned" else "grads"]
        mine = {k: torch.from_numpy(v[rank:rank + 1].copy())
                for k, v in tree.items()}
        scales.clear()
        got = col.mlfabric_grad_reduce(mine, mesh=mesh, intra_axis="data",
                                       inter_axis="pod", mean_over=4, **kw)
        for k, v in got.items():
            res[f"{name}/{k}"] = v.numpy()
        if scales:
            layout = col.plan_reduce(mine, bucket_bytes=kw.get(
                "bucket_bytes", 4 * 2 ** 20))
            bounds = [(s.sum(0) / 4).repeat_interleave(256)[:n]
                      for s, n in scales]
            assert len(bounds) == len(layout.buckets)
            for k, v in col.unpack_reduced(bounds, layout, mine).items():
                res[f"bound:{name}/{k}"] = v.numpy()
    np.savez(f"{out}/rank{rank}.npz", **res)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    grads, small = _inputs()
    inp = tmp / "inputs.npz"
    np.savez(inp, **{f"g_{k}": v for k, v in grads.items()},
             **{f"s_{k}": v for k, v in small.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jax_out = tmp / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(inp), str(jax_out),
         repr(CASES)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    try:
        run_local_world(_PORT_SCRIPT, N_RANKS,
                        args=(inp, tmp, repr(CASES)), env=env,
                        timeout_s=240)
        log = jax_proc.communicate(timeout=240)[0]
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log[-3000:]
    port = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N_RANKS)]
    return grads, small, port, dict(np.load(jax_out))


def test_every_rank_gets_the_same_result(runs):
    _, _, port, _ = runs
    for r in range(1, N_RANKS):
        assert port[r].keys() == port[0].keys()
        for k in port[0]:
            np.testing.assert_array_equal(port[r][k], port[0][k], err_msg=k)


@pytest.mark.parametrize("case", DENSE)
def test_matches_numpy_mean(runs, case):
    grads, small, port, _ = runs
    tree = _tree_for(case, grads, small)
    tol = (dict(rtol=5e-2, atol=5e-2)
           if case in COMPRESSED + ("switch", "hierarchical")
           else dict(rtol=1e-5, atol=1e-5))
    for k, v in tree.items():
        got = port[0][f"{case}/{k}"]
        assert got.shape == (1,) + v.shape[1:] and got.dtype == np.float32
        np.testing.assert_allclose(got, v.mean(axis=0, keepdims=True),
                                   err_msg=(case, k), **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(runs, case):
    grads, small, port, jax_res = runs
    for k in _tree_for(case, grads, small):
        got, ref = port[0][f"{case}/{k}"], jax_res[f"{case}/{k}"]
        assert got.shape == ref.shape
        if case in SPARSE + ("switch", "hierarchical"):
            # every stage is exact integer arithmetic, an IEEE product or
            # quotient, or a sum of two members in one order, and the top-k
            # tie rule is JAX's: bit for bit
            np.testing.assert_array_equal(got, ref, err_msg=(case, k))
        elif case in COMPRESSED:
            bound = port[0][f"bound:{case}/{k}"]
            assert np.all(np.abs(got - ref)
                          <= bound + 1e-6 * np.abs(ref)), (case, k)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7,
                                       err_msg=(case, k))


def _np_switch(x):
    """The switch stage over one pod's members ``x [2, D]`` in numpy: one
    shared scale, int8 against it, exact integer sum, times the scale."""
    scale = max(np.abs(x).max() * np.float32(1 / 127), np.float32(1e-30))
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int32)
    return q.sum(0).astype(np.float32) * scale


def _np_sparse_mean(tree, kw):
    """The sparse cross-pod stage emulated in numpy, bucket by bucket, from
    the ranks' gradients: intra-pod sum (or switch), stable top-k of |x|,
    the drop mask cut or padded to k, one f32(1/127) scale per chunk, int8,
    and the pods' chunks added in pod order."""
    from repro_torch.core.network import LossSchedule
    from repro_torch.dist.collectives import loss_drop_mask
    from repro_torch.dist.flatbuf import plan_flat_layout

    keys = sorted(tree)
    flat = np.concatenate([tree[k].reshape(N_RANKS, -1) for k in keys], 1)
    layout = plan_flat_layout([tree[k][0].size for k in keys],
                              kw.get("bucket_bytes", 4 * 2 ** 20))
    sched = LossSchedule()
    sched.set_drop("pod0", 0.0, 0.25, direction="up")
    out = np.zeros(flat.shape[1], np.float32)
    for start, d in zip(layout.bucket_starts, layout.bucket_sizes):
        k = max(1, min(d, int(round(kw["keep_inter"] * d))))
        spec = kw.get("drop_mask_inter")
        drop = np.zeros(k, bool)
        if spec == "loss":
            drop = loss_drop_mask(sched, "pod0", "pod1", 0.0, k)
        elif spec is not None:
            drop[:min(k, len(spec))] = spec[:k]
        agg = np.zeros(d, np.float32)
        for pod in range(2):
            x = flat[2 * pod:2 * pod + 2, start:start + d]
            part = (_np_switch(x) if kw.get("backend") == "switch"
                    else x[0] + x[1])
            idx = np.argsort(-np.abs(part), kind="stable")[:k]
            vals = part[idx]
            scale = max(np.abs(vals).max() * np.float32(1 / 127),
                        np.float32(1e-30))
            q = np.clip(np.rint(vals / scale), -127, 127)
            live = ~drop
            agg[idx[live]] += q[live].astype(np.float32) * scale
        out[start:start + d] = agg / np.float32(4)
    res, off = {}, 0
    for k in keys:
        n = tree[k][0].size
        res[k] = out[off:off + n].reshape((1,) + tree[k].shape[1:])
        off += n
    return res


@pytest.mark.parametrize("case", SPARSE)
def test_sparse_matches_numpy_emulation(runs, case):
    """The bounded-loss stage against an independent numpy emulation, bit
    for bit; the 25% transport drops leave fewer coordinates than none."""
    grads, small, port, _ = runs
    want = _np_sparse_mean(_tree_for(case, grads, small), CASES[case])
    for k, v in want.items():
        np.testing.assert_array_equal(port[0][f"{case}/{k}"], v,
                                      err_msg=(case, k))
    if case == "keep_loss":
        assert 0 < np.count_nonzero(port[0]["keep_loss/big"]) \
            < np.count_nonzero(port[0]["keep_0.1/big"])


def test_unknown_backend_raises():
    mesh = make_host_mesh(device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        mlfabric_grad_reduce({"w": torch.ones(8)}, mesh=mesh,
                             backend="ring")


@pytest.mark.parametrize("tier", [
    dict(compress_inter=False), dict(compress_inter=True),
    dict(backend="switch"), dict(backend="hierarchical"),
    dict(keep_inter=0.1), dict(backend="switch", keep_inter=0.5)],
    ids=["False", "True", "switch", "hierarchical", "keep", "switch_keep"])
def test_bucket_spans_match_jax(tier):
    """One ``bucket`` span per issued bucket, in issue order, with the
    reference's names, track and args (``backend``, ``compressed``,
    ``keep``; times aside: the reference's are trace-time, the port's
    issue time)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.collectives import mlfabric_grad_reduce as j_reduce
    from repro.dist.compat import make_mesh as j_make_mesh, shard_map
    from repro.obs.trace import Tracer as JTracer
    from repro_torch.obs.trace import Tracer

    grads, _ = _inputs()
    tree = {k: v[:1] for k, v in grads.items()}
    kw = dict(intra_axis="data", inter_axis="pod", bucket_bytes=2048, **tier)
    jt, tt = JTracer(), Tracer()
    mesh = j_make_mesh((1, 1), ("pod", "data"))
    specs = jax.tree.map(lambda _: P(("pod", "data")), tree)
    jax.jit(shard_map(lambda g: j_reduce(g, tracer=jt, **kw), mesh=mesh,
                      in_specs=(specs,), out_specs=specs,
                      check_vma=False))(jax.tree.map(jnp.asarray, tree))
    mlfabric_grad_reduce({k: torch.from_numpy(v) for k, v in tree.items()},
                         mesh=make_host_mesh(device="cpu"), tracer=tt, **kw)
    assert len(tt.events) == len(jt.events) > 1
    for t, j in zip(tt.events, jt.events):
        assert (t.name, t.cat, t.track, t.args) == \
            (j.name, j.cat, j.track, j.args)
