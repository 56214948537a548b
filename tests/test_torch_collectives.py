"""The port's MLfabric gradient reduction on a 2-pod x 2-data world of gloo
processes, against the numpy mean and against the JAX package's
``mlfabric_grad_reduce`` on a ``("pod", "data")`` mesh of 4 CPU devices.

Both sides get the same numpy gradients, one slice per rank as
``tests/test_dist_path.py`` builds them.  The four port ranks run at once
(``repro_torch.launch.run_local_world``) while one JAX subprocess runs
beside them; each world starts once for the whole file.

Tolerances:
* against the numpy mean, those of ``tests/test_dist_path.py``: rtol/atol
  1e-5 for the f32 paths, 5e-2 with the int8 cross-pod stage;
* against JAX, rtol 1e-6 (atol 1e-7) for the f32 paths: both sum two
  members per stage, and the port's aggregator kernel sums pods in order;
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
}
COMPRESSED = ("compressed", "compressed_unaligned")


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
    from repro.dist.collectives import mlfabric_grad_reduce
    from repro.dist.compat import make_mesh, shard_map

    inp, out, cases = sys.argv[1], sys.argv[2], eval(sys.argv[3])
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
    import repro_torch.dist.collectives as col

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


@pytest.mark.parametrize("case", list(CASES))
def test_matches_numpy_mean(runs, case):
    grads, small, port, _ = runs
    tree = _tree_for(case, grads, small)
    tol = (dict(rtol=5e-2, atol=5e-2) if case in COMPRESSED
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
        if case in COMPRESSED:
            bound = port[0][f"bound:{case}/{k}"]
            assert np.all(np.abs(got - ref)
                          <= bound + 1e-6 * np.abs(ref)), (case, k)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7,
                                       err_msg=(case, k))


@pytest.mark.parametrize("kw", [dict(backend="switch"),
                                dict(backend="hierarchical"),
                                dict(keep_inter=0.1)])
def test_slice_4_paths_raise(kw):
    mesh = make_host_mesh(device="cpu")
    with pytest.raises(NotImplementedError, match="slice 4"):
        mlfabric_grad_reduce({"w": torch.ones(8)}, mesh=mesh,
                             inter_axis="pod", **kw)


def test_unknown_backend_raises():
    mesh = make_host_mesh(device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        mlfabric_grad_reduce({"w": torch.ones(8)}, mesh=mesh,
                             backend="ring")


@pytest.mark.parametrize("compress", [False, True])
def test_bucket_spans_match_jax(compress):
    """One ``bucket`` span per issued bucket, in issue order, with the
    reference's names, track and args (times aside: the reference's are
    trace-time, the port's issue time)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.collectives import mlfabric_grad_reduce as j_reduce
    from repro.dist.compat import make_mesh as j_make_mesh, shard_map
    from repro.obs.trace import Tracer as JTracer
    from repro_torch.obs.trace import Tracer

    grads, _ = _inputs()
    tree = {k: v[:1] for k, v in grads.items()}
    kw = dict(intra_axis="data", inter_axis="pod", bucket_bytes=2048,
              compress_inter=compress)
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
