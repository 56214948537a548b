"""The port's partition rules (``dist/sharding.py``), activation policy
(``dist/policy.py``) and meshes (``launch/mesh.py``) against the JAX
package's.

One JAX subprocess with 512 forced host devices computes the reference's
specs on the meshes ``(1, 1)``, ``(2, 2)``, ``(1, 4)``, ``(16, 16)`` and
``(2, 16, 16)``: ``param_shardings`` of every config at full width (from
``params_specs``, abstract) and of its reduced twin, and on the reduced
configs ``cache_shardings``, ``batch_shardings``, ``activation_policy``,
``head_policy`` and ``batch_spec_axes``.  The port computes the same from
``models.api.params_specs`` on the ``meta`` device and a ``MeshShape``,
with no process group; specs must be equal entry for entry.  The per-rank
param bytes of ``param_bytes_per_rank`` must equal the bytes the
reference's specs give.

One torch-only subprocess runs what needs a default process group, over
PyTorch's fake backend: ``make_production_mesh`` at 256 and 512 ranks,
``placements``' pod-major order against DTensor's own offsets, a bound
policy's ``constrain`` on a DTensor, and the kernels' wrappers refusing a
DTensor.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config, get_shape, list_configs
from repro_torch.dist import sharding as shd
from repro_torch.dist.policy import (P, _fit_spec, constrain, current_policy,
                                     sharding_policy)
from repro_torch.launch import batch_axes
from repro_torch.models import transformer as tf
from repro_torch.models.api import params_specs
from repro_torch.tree import tree_flatten_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list_configs()
BATCHES = (1, 2, 8, 32, 48)
CACHE_BATCH, CACHE_LEN, TRAIN_LEN = 32, 64, 64
# the cuts the four-card cell will be sized from: one jamba group of 8
# layers, one deepseek-v2 layer
CUTS = {"jamba-v0.1-52b": 8, "deepseek-v2-236b": 1}

_JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import dataclasses, json, math, sys
    import jax
    from repro.configs import get_config, get_shape, list_configs
    from repro.dist import sharding as shd
    from repro.dist.compat import AxisType, make_mesh
    from repro.models import api

    meshes, batches, cache_batch, cache_len, train_len, cuts = (
        json.loads(a) for a in sys.argv[2:8])

    def norm(spec):
        out = []
        for e in tuple(spec):
            if isinstance(e, tuple):
                e = list(e) if len(e) > 1 else e[0]
            out.append(e)
        return out

    def name(path):
        parts = []
        for k in path:
            if hasattr(k, "key"):
                parts.append(str(k.key))
            elif hasattr(k, "name"):
                parts.append("." + k.name)
            else:
                parts.append(str(k.idx))
        return "/".join(parts)

    def specs(tree, shardings):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        sh = jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))
        return {name(p): [list(l.shape), norm(s.spec)]
                for (p, l), s in zip(leaves, sh)}

    def nbytes(tree, shardings, mesh):
        total = 0
        sh = jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))
        for l, s in zip(jax.tree_util.tree_leaves(tree), sh):
            n = 1
            for e in tuple(s.spec):
                for a in (e if isinstance(e, tuple) else (e,)):
                    if a is not None:
                        n *= mesh.shape[a]
            total += math.prod(l.shape) * l.dtype.itemsize // n
        return total

    configs = {}
    for arch in list_configs():
        cfg = get_config(arch)
        configs[(arch, "full")] = cfg
        configs[(arch, "reduced")] = cfg.reduced()
        if arch in cuts:
            configs[(arch, "cut")] = dataclasses.replace(
                cfg, n_layers=cuts[arch])
    abstract = {k: api.params_specs(c) for k, c in configs.items()}
    out = {}
    for mname, (shape, axes) in meshes.items():
        mesh = make_mesh(shape, axes, devices=jax.devices()[:math.prod(shape)],
                         axis_types=(AxisType.Auto,) * len(axes))
        res = out[mname] = {}
        for (arch, kind), cfg in configs.items():
            psh = shd.param_shardings(cfg, mesh, abstract[(arch, kind)])
            r = res.setdefault(arch, {})
            r[f"params_{kind}"] = specs(abstract[(arch, kind)], psh)
            if mname == "1x1":
                r[f"dtypes_{kind}"] = {
                    name(p): str(l.dtype) for p, l in
                    jax.tree_util.tree_flatten_with_path(
                        abstract[(arch, kind)])[0]}
            r[f"bytes_{kind}"] = nbytes(abstract[(arch, kind)], psh, mesh)
            if kind != "reduced":
                continue
            cache = api.cache_specs(cfg, cache_batch, cache_len)
            r["cache"] = specs(cache, shd.cache_shardings(
                cfg, mesh, cache, cache_batch))
            tshape = dataclasses.replace(get_shape("train_4k"),
                                         seq_len=train_len,
                                         global_batch=cache_batch)
            bspecs = api.input_specs(cfg, tshape)
            r["batch"] = specs(bspecs, shd.batch_shardings(
                cfg, tshape, mesh, bspecs))
            r["activation"] = {
                str(b): {k: norm(v) for k, v in shd.activation_policy(
                    cfg, mesh, b).items()} for b in batches}
            r["head_policy"] = shd.head_policy(cfg, mesh)
        res["batch_spec_axes"] = {str(b): shd.batch_spec_axes(mesh, b)
                                  for b in batches}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")

_FAKE_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.policy import P, constrain, sharding_policy
    from repro_torch.kernels import ops
    from repro_torch.launch import make_production_mesh

    multi_pod, rank = sys.argv[1] == "1", int(sys.argv[2])
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    dm = mesh.device_mesh
    out = {"axis_names": list(mesh.axis_names), "shape": mesh.shape,
           "coords": mesh.coords,
           "device_mesh": [list(dm.mesh_dim_names), list(dm.mesh.shape)],
           "groups": {a: dist.get_world_size(g)
                      for a, g in mesh.groups.items()},
           "batch_axes": list(shd.data_axes(mesh))}
    # a [64, 32] leaf over the batch hierarchy and model: the block this
    # rank holds, by shard_slices and by DTensor's own offsets
    spec = P(shd.data_axes(mesh), "model")
    pl = shd.placements(mesh, spec)
    sl = shd.shard_slices(mesh, spec, (64, 32), mesh.coords)
    shape, offset = compute_local_shape_and_global_offset((64, 32), dm, pl)
    out["placements"] = [repr(p) for p in pl]
    out["slices"] = [[s.start, s.stop] for s in sl]
    out["dtensor_block"] = [[o, o + n] for o, n in zip(offset, shape)]
    # a bound policy lays a DTensor out by the fitted spec; an all-None
    # fit and a name the policy lacks leave it as it is
    x = DTensor.from_local(torch.zeros(64, 32, 8), dm,
                           [Replicate()] * dm.ndim, run_check=False)
    act = {"residual": P(shd.data_axes(mesh), "model", None),
           "odd": P(None, None, "model")}
    with sharding_policy(mesh, act):
        y = constrain(x, "residual")
        out["constrained"] = [repr(p) for p in y.placements]
        out["odd_is_x"] = constrain(x, "odd") is x
        out["unknown_is_x"] = constrain(x, "nonexistent") is x
        t = torch.ones(64, 32, 8)
        out["plain_is_x"] = constrain(t, "residual") is t
    refused = {}
    q = DTensor.from_local(torch.zeros(1, 2, 16, 32), dm,
                           [Replicate()] * dm.ndim, run_check=False)
    plain = torch.zeros(1, 2, 16, 32)
    w = torch.ones(2)
    for what, call in {
            "flash_attention_op": lambda: ops.flash_attention_op(
                plain, q, plain, causal=True),
            "grad_aggregate_op": lambda: ops.grad_aggregate_op(
                q.reshape(2, -1), w),
            "quantize_op": lambda: ops.quantize_op(q.reshape(-1))}.items():
        try:
            call()
            refused[what] = "ran"
        except TypeError as e:
            refused[what] = str(e)
    out["refused"] = refused
    print(json.dumps(out))
""")


def _norm(spec):
    return [list(e) if isinstance(e, tuple) and len(e) > 1
            else e[0] if isinstance(e, tuple) else e for e in spec]


def _mesh(name):
    shape, axes = MESHES[name]
    return shd.MeshShape(axes, dict(zip(axes, shape)))


def _specs(tree, spec_tree):
    specs = dict(tree_flatten_with_path(spec_tree)[0])
    return {path: [list(leaf.shape), _norm(specs[path])]
            for path, leaf in tree_flatten_with_path(tree)[0]}


def _configs(arch):
    cfg = get_config(arch)
    out = {"full": cfg, "reduced": cfg.reduced()}
    if arch in CUTS:
        out["cut"] = dataclasses.replace(cfg, n_layers=CUTS[arch])
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    args = [json.dumps(a) for a in (MESHES, BATCHES, CACHE_BATCH, CACHE_LEN,
                                    TRAIN_LEN, CUTS)]
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out),
                           *args], capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def fake_worlds():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = {}
    # a rank with pod, data and model coordinates all nonzero (512) and
    # one with data and model nonzero (256)
    for multi_pod, rank in ((0, 3 * 16 + 5), (1, 256 + 3 * 16 + 5)):
        proc = subprocess.run([sys.executable, "-c", _FAKE_SCRIPT,
                               str(multi_pod), str(rank)],
                              capture_output=True, text=True, env=env,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[multi_pod] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(ref, arch, mesh_name):
    """Every leaf of the full-width config (from ``meta`` tensors), its
    reduced twin and its cut (jamba, deepseek-v2) gets the reference's
    spec, and the tree has the reference's paths, shapes and dtypes."""
    mesh = _mesh(mesh_name)
    for kind, cfg in _configs(arch).items():
        abstract = params_specs(cfg)
        assert all(t.device.type == "meta"
                   for _, t in tree_flatten_with_path(abstract)[0])
        got = _specs(abstract, shd.param_shardings(cfg, mesh, abstract))
        assert got == ref[mesh_name][arch][f"params_{kind}"], (arch, kind)
        dtypes = {path: str(t.dtype).replace("torch.", "")
                  for path, t in tree_flatten_with_path(abstract)[0]}
        assert dtypes == ref["1x1"][arch][f"dtypes_{kind}"], (arch, kind)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_bytes_per_rank(ref, mesh_name):
    """``param_bytes_per_rank`` equals the bytes the reference's specs
    leave each rank, for every config, full, reduced and cut."""
    mesh = _mesh(mesh_name)
    for arch in ARCHS:
        for kind, cfg in _configs(arch).items():
            assert shd.param_bytes_per_rank(cfg, mesh, params_specs(cfg)) \
                == ref[mesh_name][arch][f"bytes_{kind}"], (arch, kind)


def test_param_bytes_pinned():
    """The per-rank numbers PERF.md §4 quotes (bf16 leaves, f32 routers
    and states as the configs have them)."""
    def mib(arch, mesh_name, layers=None):
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        return shd.param_bytes_per_rank(cfg, _mesh(mesh_name),
                                        params_specs(cfg)) / 2 ** 20
    assert mib("qwen2-0.5b", "1x1") == pytest.approx(942.51, abs=0.01)
    assert mib("qwen2-0.5b", "16x16") == pytest.approx(3.82, abs=0.01)
    assert mib("deepseek-v2-236b", "2x16x16") == pytest.approx(1971.80,
                                                                abs=0.01)
    assert mib("deepseek-v2-236b", "1x4", layers=1) == pytest.approx(
        2396.81, abs=0.01)
    assert mib("jamba-v0.1-52b", "1x4", layers=8) == pytest.approx(
        6341.54, abs=0.01)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_and_activation_match_reference(ref, arch):
    """On the reduced config: ``cache_shardings`` of the decode cache (the
    port's ``init_cache`` on ``meta``, plus an encoder-decoder's
    ``cross_kv``), ``batch_shardings`` of the training inputs,
    ``activation_policy`` at several global batches and ``head_policy``,
    on every mesh."""
    cfg = get_config(arch).reduced()
    cache = tf.init_cache(cfg, CACHE_BATCH, CACHE_LEN, torch.bfloat16,
                          device="meta")
    for name in MESHES:
        mesh, r = _mesh(name), ref[name][arch]
        if cfg.encoder is not None:
            # the reference's abstract cache carries the prefill's cross_kv
            kv = torch.empty(r["cache"]["cross_kv/0"][0], device="meta")
            cache["cross_kv"] = (kv, kv)
        assert _specs(cache, shd.cache_shardings(
            cfg, mesh, cache, CACHE_BATCH)) == r["cache"], name
        batch = {k.split("/")[-1]: torch.empty(shape, device="meta")
                 for k, (shape, _) in r["batch"].items()}
        shape = dataclasses.replace(get_shape("train_4k"), seq_len=TRAIN_LEN,
                                    global_batch=CACHE_BATCH)
        assert _specs(batch, shd.batch_shardings(cfg, shape, mesh, batch)) \
            == r["batch"], name
        for b in BATCHES:
            got = {k: _norm(v) for k, v in shd.activation_policy(
                cfg, mesh, b).items()}
            assert got == r["activation"][str(b)], (name, b)
        assert shd.head_policy(cfg, mesh) == r["head_policy"], name


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_axes_fallback(ref, mesh_name):
    """``batch_spec_axes`` takes ``(pod, data)``, falls back to ``data``,
    or gives None, as the reference does; ``batch_axes`` names the batch
    hierarchy."""
    mesh = _mesh(mesh_name)
    for b in BATCHES:
        got = shd.batch_spec_axes(mesh, b)
        want = ref[mesh_name]["batch_spec_axes"][str(b)]
        assert (list(got) if got else got) == want, b
    assert batch_axes(mesh) == shd.data_axes(mesh) == (
        ("pod", "data") if "pod" in mesh.axis_names else ("data",))


def test_head_policy_selection():
    """A model axis of one divides every head count; a model axis of 4
    divides none of the reduced qwen2's 2 KV heads."""
    assert shd.head_policy(get_config("stablelm-1.6b"), _mesh("1x1"))
    assert shd.head_policy(get_config("qwen2-0.5b").reduced(), _mesh("2x2"))
    assert not shd.head_policy(get_config("qwen2-0.5b").reduced(),
                               _mesh("1x4"))


class TestPolicy:
    def test_constrain_is_identity_without_policy(self):
        assert current_policy() is None
        x = torch.ones(4, 8)
        assert constrain(x, "residual") is x

    def test_policy_binds_and_unbinds(self):
        mesh = _mesh("2x2")
        with sharding_policy(mesh, {"residual": P(None, "model", None)}):
            assert current_policy() is not None
            # a plain tensor and an unknown name pass through untouched
            y = torch.ones(2, 4, 8)
            assert constrain(y, "residual") is y
            z = torch.ones(3)
            assert constrain(z, "nonexistent") is z
        assert current_policy() is None

    def test_non_dividing_axis_is_dropped(self):
        mesh = _mesh("1x4")
        assert _fit_spec(mesh, P("model"), (7,)) == P(None)
        assert _fit_spec(mesh, P(None, "model"), (3, 8)) == P(None, "model")
        # rank-adjusted: padded with None, cut to the tensor's rank
        assert _fit_spec(mesh, P("data"), (4, 4)) == P("data", None)
        assert _fit_spec(mesh, P("data", "model", None), (4,)) == P("data")

    def test_spec_is_one_leaf(self):
        """A spec tree flattens to one leaf per spec, as JAX keeps a
        ``PartitionSpec`` whole."""
        tree = {"a": P("data", None), "b": (P(), P(("pod", "data")))}
        leaves = [l for _, l in tree_flatten_with_path(tree)[0]]
        assert leaves == [P("data", None), P(), P(("pod", "data"))]


class TestMeshHelpers:
    def test_data_axes_without_pod(self):
        assert shd.data_axes(_mesh("2x2")) == ("data",)

    def test_batch_spec_axes_divisible(self):
        assert shd.batch_spec_axes(_mesh("16x16"), 16) == ("data",)
        assert shd.batch_spec_axes(_mesh("2x16x16"), 64) == ("pod", "data")
        assert shd.batch_spec_axes(_mesh("2x16x16"), 16) == ("data",)
        assert shd.batch_spec_axes(_mesh("2x16x16"), 8) is None


@pytest.mark.parametrize("multi_pod", [0, 1])
def test_production_mesh_over_fake_backend(fake_worlds, multi_pod):
    """16 x 16 over 256 ranks, 2 x 16 x 16 over 512, with a DeviceMesh
    over the same ranks and a group of the axis' size per axis."""
    r = fake_worlds[multi_pod]
    if multi_pod:
        assert r["axis_names"] == ["pod", "data", "model"]
        assert r["shape"] == {"pod": 2, "data": 16, "model": 16}
        assert r["coords"] == {"pod": 1, "data": 3, "model": 5}
        assert r["groups"] == {"pod": 2, "data": 16, "model": 16}
    else:
        assert r["axis_names"] == ["data", "model"]
        assert r["shape"] == {"data": 16, "model": 16}
        assert r["coords"] == {"data": 3, "model": 5}
        assert r["groups"] == {"data": 16, "model": 16}
    assert r["device_mesh"] == [r["axis_names"],
                                [r["shape"][a] for a in r["axis_names"]]]


@pytest.mark.parametrize("multi_pod", [0, 1])
def test_placements_pod_major(fake_worlds, multi_pod):
    """``P(("pod", "data"), "model")``: Shard(0) on pod and data, Shard(1)
    on model; the block ``shard_slices`` names is DTensor's own, and on the
    512 mesh it is block ``pod * 16 + data`` of 32, as JAX lays it out."""
    r = fake_worlds[multi_pod]
    if multi_pod:
        assert r["placements"] == ["Shard(dim=0)", "Shard(dim=0)",
                                   "Shard(dim=1)"]
        i = 1 * 16 + 3
        assert r["slices"] == [[2 * i, 2 * i + 2], [10, 12]]
    else:
        assert r["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert r["slices"] == [[12, 16], [10, 12]]
    assert r["slices"] == r["dtensor_block"]


def test_placements_refuse_minor_major():
    """A tuple whose axes run against the mesh order has no DTensor
    placement; one axis cannot split two dims."""
    mesh = _mesh("2x16x16")
    with pytest.raises(ValueError):
        shd.placements(mesh, P(("data", "pod")))
    with pytest.raises(ValueError):
        shd.placements(mesh, P("model", "model"))


@pytest.mark.parametrize("multi_pod", [0, 1])
def test_constrain_lays_out_dtensor(fake_worlds, multi_pod):
    """Under a bound policy ``constrain`` redistributes a DTensor to the
    fitted spec; a spec that fits nowhere, an unknown name and a plain
    tensor are left as they are."""
    r = fake_worlds[multi_pod]
    want = (["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=1)"] if multi_pod
            else ["Shard(dim=0)", "Shard(dim=1)"])
    assert r["constrained"] == want
    assert r["odd_is_x"] and r["unknown_is_x"] and r["plain_is_x"]


@pytest.mark.parametrize("multi_pod", [0, 1])
def test_kernels_refuse_dtensor(fake_worlds, multi_pod):
    """No kernel and no plain version takes a DTensor: each wrapper raises
    naming itself, before any work."""
    refused = fake_worlds[multi_pod]["refused"]
    for what, msg in refused.items():
        assert msg.startswith(f"{what}: got a DTensor"), (what, msg)
