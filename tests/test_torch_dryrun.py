"""The port's dry-run against the reference's: ``models.api.input_specs`` /
``cache_specs``, the kernels' shape rules, ``launch/op_analysis.py`` and
``launch/dryrun.py``.

* For every applicable (arch x shape), with and without ``kv_int8``,
  ``input_specs`` matches the reference's ``ShapeDtypeStruct``s leaf for
  leaf, path, shape and dtype (the stronger twin of
  ``tests/test_configs_smoke.py::test_input_specs_cover_all_cells``).
* The twin of ``tests/test_obs.py::test_dryrun_bottleneck_speaks_the_
  shared_dialect``: the same attribution function, the H100 constants,
  and a bf16 ``[1, 256]`` all-gather on a fake 4-rank world counting 512
  bytes.
* ``OpAnalysis`` on known work: 2*M*N*K for a CPU matmul, the peak of a
  known sequence of allocations, the flash kernel's FLOPs.
* The shape rules give the kernels' output shapes and dtypes on
  ``FakeTensor``s and count a launch, and leave the CPU route as it was
  (a plain ``meta`` tensor still raises, ``tests/test_torch_kernels.py``).
* The compressed MLfabric step traced on 2x16x16 through its kernels.
* Per-rank FLOPs of three cells (train, prefill, decode) on 16x16 for a
  cut of qwen2-0.5b, the port's ``run_cell`` against the reference's
  loop-aware ``flops_per_device``, within 5%: each package in its own
  subprocess, the config swapped there.  The cut keeps qwen2's layer
  kinds and gives every split dim a multiple of 16 (16 heads of 32, d 512,
  ff 1024, vocab 4096): DTensor cannot split 14 heads over 16 ranks where
  GSPMD pads them, which ROADMAP C records with the full cell's numbers.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs import get_config as j_get_config
from repro.models import api as j_api
from repro_torch.configs import get_config, get_shape, list_configs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import cache_specs, input_specs
from repro_torch.obs.report import roofline_attribution
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in list_configs() for s in J_SHAPES
         if j_applicable(j_get_config(a), J_SHAPES[s])[0]]
FLOPS_RTOL = 0.05
CUT = dict(n_heads=16, n_kv_heads=16, d_head=32, d_model=512, d_ff=1024,
           vocab_size=4096)
CUT_CELLS = ["train_4k", "prefill_32k", "decode_32k"]
KERNELS = ["quantize", "dequantize", "dequant_aggregate", "grad_aggregate",
           "switch_sum", "scatter_aggregate", "flash_attention"]


def _ref_leaves(tree):
    return [(jax.tree_util.keystr(p), tuple(l.shape), np.dtype(l.dtype).name)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree):
    return [(tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for l in tree_leaves(tree)]


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape, kv_int8):
    ref = j_api.input_specs(j_get_config(arch), J_SHAPES[shape],
                            kv_int8=kv_int8)
    got = input_specs(get_config(arch), get_shape(shape), kv_int8=kv_int8)
    assert sorted(got) == sorted(ref)
    want = _ref_leaves(ref)
    assert [w[1:] for w in want] == _port_leaves(got), want
    assert all(l.device.type == "meta" for l in tree_leaves(got))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-tiny",
                                  "qwen2-0.5b"])
def test_cache_specs_keep_the_reference_tree(arch):
    """A hybrid's tuple of slots, whisper's ``cross_kv`` pair, the int8
    cache's four leaves a layer."""
    for kv_int8 in (False, True):
        ref = j_api.cache_specs(j_get_config(arch), 3, 40, kv_int8=kv_int8)
        got = cache_specs(get_config(arch), 3, 40, kv_int8=kv_int8)
        assert isinstance(got["layers"], tuple) == isinstance(
            ref["layers"], tuple)
        assert ("cross_kv" in got) == ("cross_kv" in ref)
        assert [w[1:] for w in _ref_leaves(ref)] == _port_leaves(got)


def test_dryrun_bottleneck_speaks_the_shared_dialect():
    assert dryrun.roofline_attribution is roofline_attribution
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.ICI_BW) == (
        989e12, 3.35e12, 50e9)
    r = roofline_attribution(1e15 / dryrun.PEAK_FLOPS, 1e12 / dryrun.HBM_BW,
                             1e12 / dryrun.ICI_BW)
    assert r["bottleneck"] == "collective"
    assert r["share"]["collective"] > r["share"]["memory"]


# --------------------------------------------------------------------------- #
# op_analysis on known work
# --------------------------------------------------------------------------- #
def test_op_analysis_counts_a_cpu_matmul():
    a, b = torch.randn(64, 48), torch.randn(48, 20)
    with OpAnalysis() as oa:
        c = a @ b
        torch.bmm(a[None], b[None])
    assert oa.flops == 2 * (2 * 64 * 48 * 20)
    assert oa.flops_by_op == {"aten.mm": 2 * 64 * 48 * 20,
                              "aten.bmm": 2 * 64 * 48 * 20}
    # mm reads a and b and writes c
    assert oa.bytes >= (a.numel() + b.numel() + c.numel()) * 4


@pytest.mark.parametrize("fake", [False, True])
def test_op_analysis_peak_of_a_known_sequence(fake):
    ctx = FakeTensorMode() if fake else torch.no_grad()
    with ctx:
        a = torch.empty(1000)                       # 4,000 live before
        oa = OpAnalysis()
        oa.track({"a": a, "view": a[10:]})          # one storage
        with oa:
            b = torch.empty(500, dtype=torch.bfloat16)      # +1,000
            c = torch.empty(2000)                           # +8,000
            del c                                           # -8,000
            d = b.view(10, 50)                              # a view: +0
            e = torch.empty(3000, dtype=torch.int8)         # +3,000
        assert oa.peak_bytes == 4000 + 1000 + 8000
        assert oa.peak_holders == {"aten.empty": 9000, "argument": 4000}
        assert oa.live_bytes == 4000 + 1000 + 3000
        del b, d, e
        assert oa.live_bytes == 4000


def test_op_analysis_counts_the_flash_kernel():
    with FakeTensorMode():
        q = torch.empty(2, 4, 128, 64, dtype=torch.bfloat16)
        k = torch.empty(2, 4, 128, 64, dtype=torch.bfloat16)
        with OpAnalysis() as oa:
            out = ops.flash_attention_op(q, k, k, causal=True)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert oa.launches == {"flash_attention": 1}
    assert oa.flops == 4 * 2 * 4 * 64 * (128 * 129 // 2)


# --------------------------------------------------------------------------- #
# the kernels' shape rules
# --------------------------------------------------------------------------- #
def _calls(t):
    """{kernel: a call of its wrapper} on inputs made by ``t(shape,
    dtype)``."""
    x = t((1000,), torch.float32)
    q = t((3, 1024), torch.int8)
    s = t((3, 4), torch.float32)
    w = t((3,), torch.float32)
    idx = t((3, 50), torch.int32)
    fl = t((2, 4, 64, 32), torch.bfloat16)
    return {
        "quantize": lambda: ops.quantize_op(x),
        "dequantize": lambda: ops.dequantize_op(q[0], s[0], orig_len=1000),
        "dequant_aggregate": lambda: ops.dequant_aggregate_op(
            q, s, w, orig_len=1000),
        "grad_aggregate": lambda: ops.grad_aggregate_op(
            t((3, 77), torch.bfloat16), w),
        "switch_sum": lambda: ops.switch_sum_op(q, orig_len=1000),
        "scatter_aggregate": lambda: ops.scatter_aggregate_op(
            idx, t((3, 50), torch.int8), w, w, d_out=1000),
        "flash_attention": lambda: ops.flash_attention_op(fl, fl, fl),
    }


def _real(shape, dtype):
    g = torch.Generator().manual_seed(1)
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, dtype=dtype)
    if dtype == torch.int32:
        return torch.randint(0, 1000, shape, generator=g, dtype=dtype)
    return torch.rand(shape, generator=g).to(dtype)


def _shapes(out):
    return [(tuple(o.shape), o.dtype) for o in
            (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name", KERNELS)
def test_shape_rules_give_the_kernels_outputs(name):
    wrapper = getattr(ops, f"{name}_op")
    before = wrapper.launches
    want = _shapes(_calls(_real)[name]())
    assert wrapper.launches == before          # the CPU route: no launch
    with FakeTensorMode():
        got = _calls(lambda s, d: torch.empty(s, dtype=d))[name]()
    assert _shapes(got) == want
    assert wrapper.launches == before          # the shape rule: no launch
    with FakeTensorMode():                     # fake tensors on meta too
        meta = _calls(lambda s, d: torch.empty(s, dtype=d, device="meta"))
        assert _shapes(meta[name]()) == want
    assert wrapper.launches == before


def test_cpu_route_is_the_plain_version():
    x = _real((1000,), torch.float32)
    q, s = ops.quantize_op(x)
    q2, s2 = ops.quantize_plain(torch.nn.functional.pad(x, (0, 24)))
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert ops._route(x, "t") == ops.PLAIN
    with FakeTensorMode():
        assert ops._route(torch.empty(3), "t") == ops.SHAPE
    with pytest.raises(ValueError, match="no kernel"):
        ops._route(torch.empty(3, device="meta"), "t")
    with pytest.raises(RuntimeError, match="shape rule"):
        torch.ops.repro_torch.quantize(x, 256)


# --------------------------------------------------------------------------- #
# run_cell against the reference's, each in its own process
# --------------------------------------------------------------------------- #
_PORT_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import OpAnalysis

    cut, cells = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    out = {}
    dryrun.fake_world(4)
    x = torch.zeros(1, 256, dtype=torch.bfloat16)
    with OpAnalysis() as oa:
        funcol.all_gather_tensor(x, 0, list(range(4))).wait()
    out["funcol"] = oa.collective_by_kind
    with OpAnalysis() as oa:
        dist.all_gather_into_tensor(x.new_empty(4, 256), x)
    out["c10d"] = oa.collective_by_kind
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), **cut)
    dryrun.get_config = lambda arch: cfg
    for shape in cells:
        out[shape] = dryrun.run_cell("qwen2-0.5b", shape, out_dir=None)
    out["mlfabric_2x16x16"] = dryrun.run_cell(
        "qwen2-0.5b", "train_4k", multi_pod=True, out_dir=None,
        step_kwargs={"grad_path": "mlfabric", "compress_inter": True})
    print(json.dumps(out))
""")

_REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import repro.launch.dryrun as dryrun       # sets the device count first
    from repro.configs import get_config

    cut, cells = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), **cut)
    dryrun.get_config = lambda arch: cfg
    print(json.dumps({s: dryrun.run_cell("qwen2-0.5b", s, out_dir=None)
                      for s in cells}))
""")


@pytest.fixture(scope="module")
def cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    args = [json.dumps(CUT), json.dumps(CUT_CELLS)]
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", script, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for name, script in (("port", _PORT_SCRIPT), ("ref", _REF_SCRIPT))}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_all_gather_counts_its_operand(cells):
    assert cells["port"]["funcol"] == {"all-gather": 512}
    assert cells["port"]["c10d"] == {"all-gather": 512}


@pytest.mark.parametrize("shape", CUT_CELLS)
def test_flops_per_rank_match_the_reference(cells, shape):
    port, ref = cells["port"][shape], cells["ref"][shape]
    assert port["status"] == ref["status"] == "ok"
    assert port["n_devices"] == ref["n_devices"] == 256
    np.testing.assert_allclose(port["flops_per_device"],
                               ref["flops_per_device"], rtol=FLOPS_RTOL)
    assert set(port) >= (set(ref) - {"lower_s", "compile_s"}) | {"trace_s"}
    assert port["bottleneck"] in ("compute", "memory", "collective")


def test_sharded_mlfabric_step_traces_through_the_wire(cells):
    """The compressed MLfabric step's donating call on 2x16x16: one
    ``quantize`` and one ``dequant_aggregate`` a bucket, an all-gather
    over pods."""
    res = cells["port"]["mlfabric_2x16x16"]
    assert res["status"] == "ok" and res["n_devices"] == 512
    n = res["launches"]["quantize"]
    assert n > 0 and res["launches"] == {"quantize": n,
                                         "dequant_aggregate": n}
    assert res["collective_by_kind"]["all-gather"] > 0


def test_skipped_cells_give_the_reference_reason():
    res = dryrun.run_cell("qwen2-0.5b", "long_500k", out_dir=None)
    ok, why = j_applicable(j_get_config("qwen2-0.5b"), J_SHAPES["long_500k"])
    assert not ok and res == {"arch": "qwen2-0.5b", "shape": "long_500k",
                              "status": "skipped", "reason": why}
