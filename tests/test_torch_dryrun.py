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
  ff 1024, vocab 4096).
* The same cut with qwen2's own 14 q and 2 KV heads, which divide no axis
  of 16: the blockwise loop splits the query positions with the heads,
  7 heads (one KV group) and half the queries a rank
  (``models/attention.py:_attend_split``), so its train and prefill
  FLOPs a rank are at most ``PAD_FLOPS_RATIO`` of the reference's (what
  the split reads, 1.04x on train from the loss's recompute, plus
  ``FLOPS_RTOL``; 1.2x when the heads were padded).
* The cut with 6 q and 6 KV heads, fewer than the 16 ranks (whisper's
  count): 3 heads and an eighth of the queries a rank, no zero head; its
  train and prefill FLOPs a rank at most 1.2x the reference's.
* A cut of deepseek-v2 (16/16 heads, d 512, vocab 4096, 16 experts, the
  MLA latents 64 and 256: every split dim divides 16): its train and
  prefill FLOPs a rank within ``FLOPS_RTOL`` of the reference's, the
  router on each rank's own tokens and the q latent's gradient on each
  rank's block of its columns (1.230x on train when the router's
  backward ran on the global batch and ``q_down``'s on the whole latent).
* The train step's and the prefill's peak a rank on the cuts at most
  twice the reference's, and no op holding more than 0.5 GB of it: the
  loss takes the vocab-split logits on each rank's block and recomputes
  each chunk in the backward (``models/layers.py:chunked_loss``), and
  the experts' one-hots are built for a rank's own groups and experts
  only (``models/moe.py``; 4.03 GB of ``aten.zeros`` on the deepseek-v2
  cut when every rank built the global batch's).
* The prefill's decode cache laid out a layer at a time
  (``models/transformer.py:CacheStack``): no op of its layout
  (``op_analysis.scope("cache")``) ever holds more than the cache's own
  bytes a rank under ``cache_shardings``, on the cut whose kv heads are
  split over ``model`` (one all-to-all a leaf) and on the one whose kv
  heads are replicated (a local slice).
* DTensor's searches over global-shape tensors go uncounted
  (``op_analysis.SHADOWED``): one DTensor ``softplus`` of ``x.float()``,
  forward and backward, on a fake world of 16 holds at most 16x its
  local bf16 input at its peak and no more than a local f32 block in any
  op (6.88 GB, ``aten.empty`` 2.15 GB of it, when the decomposition search
  for ``softplus_backward`` was counted); a cut of jamba (the reduced
  config's 16 layers at the cut's widths, 16 experts of 1,024) in the peak
  tests, whose mamba layers take that path.
* ``--save-hlo``: the CLI on the qwen2 cut writes ``<tag>.ops.txt`` beside
  ``<tag>.json``, its totals equal to ``flops_per_device`` and
  ``bytes_per_device``.
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

from _torch_cuts import SOURCE as _CUT_SOURCE
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs import get_config as j_get_config
from repro.models import api as j_api
from repro_torch.configs import get_config, get_shape, list_configs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import (OpAnalysis, op_listing,
                                            read_op_listing)
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
# qwen2's own heads on the cut: neither count divides 16
CUT_14 = dict(CUT, n_heads=14, n_kv_heads=2)
CUT_14_CELLS = ["train_4k", "prefill_32k"]
# the query split reads 1.038x (train) and 1.000x (prefill) of the
# reference's FLOPs a rank on the 14/2 cut; plus FLOPS_RTOL
PAD_FLOPS_RATIO = 1.09
# whisper's 6/6 heads on the cut: fewer q heads than the 16 ranks
CUT_6 = dict(CUT, n_heads=6, n_kv_heads=6)
CUT_6_CELLS = ["train_4k", "prefill_32k"]
FEW_HEADS_RATIO = 1.2
# deepseek-v2 cut so that every split dim divides 16: its MLA latent (the
# q latent's block of 16 a rank) and its 16 experts (one a rank)
DS = "deepseek-v2-236b"
CUT_DS = {"n_heads": 16, "n_kv_heads": 16, "d_model": 512,
          "vocab_size": 4096, "moe.n_experts": 16, "mla.kv_lora_rank": 64,
          "mla.q_lora_rank": 256}
CUT_DS_CELLS = ["train_4k", "prefill_32k"]
# jamba's reduced 16 layers ("mmmammmm" twice) at the cut's widths, its 16
# experts of 1,024 one a rank
JAMBA = "jamba-v0.1-52b"
CUT_JAMBA = dict(CUT, **{"moe.n_experts": 16, "moe.d_expert": 1024})
CUT_JAMBA_CELLS = ["train_4k", "prefill_32k"]
PEAK_RATIO, HOLDER_BYTES = 2.0, 0.5e9
# the softplus probe: a local bf16 block of each of 16 fake ranks
PROBE_RANKS, PROBE_LOCAL = 16, (64, 1024, 256)
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


def test_op_listing_totals_are_the_counts():
    """``OpAnalysis.ops`` by overload and operands, written and read back
    by ``op_listing``/``read_op_listing``: largest FLOPs first, totals
    equal to the analysis's FLOPs and bytes."""
    a, b = torch.randn(64, 48), torch.randn(48, 20)
    with OpAnalysis() as oa:
        for _ in range(3):
            c = a @ b
        torch.bmm(a[None], b[None])
        c.add_(1.0).exp()
    text = op_listing(oa.ops, "title")
    got = read_op_listing(text)
    assert got["total"] == {"flops": oa.flops, "bytes": oa.bytes,
                            "count": sum(v[0] for v in oa.ops.values())}
    assert got["rows"] == oa.ops
    mm = got["rows"]["aten.mm.default float32[64,48] float32[48,20]"]
    assert mm == [3, 3 * 2 * 64 * 48 * 20,
                  3 * (64 * 48 + 48 * 20 + 64 * 20) * 4]
    lines = [l for l in text.splitlines() if not l.startswith("#")]
    assert lines[0].split()[3] == "aten.mm.default"
    assert lines[1].split()[3] == "aten.bmm.default"
    flops = [int(l.split()[0]) for l in lines[:-1]]
    assert flops == sorted(flops, reverse=True)
    assert text.startswith("# title\n")


def test_op_analysis_restores_what_it_shadows():
    import importlib
    from repro_torch.launch.op_analysis import SHADOWED
    raw = [importlib.import_module(m).__dict__[c].__dict__[a]
           for m, c, a in SHADOWED]
    with OpAnalysis():
        now = [importlib.import_module(m).__dict__[c].__dict__[a]
               for m, c, a in SHADOWED]
        assert all(x is not y for x, y in zip(raw, now))
    assert raw == [importlib.import_module(m).__dict__[c].__dict__[a]
                   for m, c, a in SHADOWED]


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
_PORT_CELLS = _CUT_SOURCE + textwrap.dedent("""
    import json, sys
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun

    def cut_cells(cuts):
        out = {}
        for name, (arch, cut, cells) in cuts.items():
            cfg = cut_config(get_config(arch).reduced(), cut)
            dryrun.get_config = lambda arch: cfg
            out[name] = {shape: dryrun.run_cell(arch, shape, out_dir=None)
                         for shape in cells}
        return out
""")

_PORT_CELLS_SCRIPT = _PORT_CELLS + textwrap.dedent("""
    print(json.dumps(cut_cells(json.loads(sys.argv[1]))))
""")

_PORT_SCRIPT = _PORT_CELLS + textwrap.dedent("""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    import torch.nn.functional as F
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch.op_analysis import OpAnalysis

    cuts, out_dir = json.loads(sys.argv[1]), sys.argv[2]
    ranks, shape = json.loads(sys.argv[3])
    out = {}
    dryrun.fake_world(ranks)
    mesh = init_device_mesh("cpu", (ranks,))
    with FakeTensorMode(allow_non_fake_inputs=True):
        local = torch.empty(shape, dtype=torch.bfloat16, requires_grad=True)
        x = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
        oa = OpAnalysis()
        oa.track(x)
        with oa:
            F.softplus(x.float()).sum().backward()
    out["softplus"] = {"peak_bytes": oa.peak_bytes,
                       "peak_holders": oa.peak_holders, "ops": oa.ops}
    dryrun.fake_world(4)
    x = torch.zeros(1, 256, dtype=torch.bfloat16)
    with OpAnalysis() as oa:
        funcol.all_gather_tensor(x, 0, list(range(4))).wait()
    out["funcol"] = oa.collective_by_kind
    with OpAnalysis() as oa:
        dist.all_gather_into_tensor(x.new_empty(4, 256), x)
    out["c10d"] = oa.collective_by_kind
    out.update(cut_cells(cuts))
    arch, cut, _ = cuts["cut"]
    cfg = cut_config(get_config(arch).reduced(), cut)
    out["mlfabric_2x16x16"] = dryrun.run_cell(
        arch, "train_4k", multi_pod=True, out_dir=None,
        step_kwargs={"grad_path": "mlfabric", "compress_inter": True})
    dryrun.get_config = lambda arch: cfg
    sys.argv = ["dryrun", "--arch", arch, "--shape", "train_4k",
                "--out", out_dir, "--save-hlo"]
    out["cli_rc"] = dryrun.main()
    print(json.dumps(out))
""")

_REF_SCRIPT = _CUT_SOURCE + textwrap.dedent("""
    import json, sys
    import repro.launch.dryrun as dryrun       # sets the device count first
    from repro.configs import get_config

    out = {}
    for name, (arch, cut, cells) in json.loads(sys.argv[1]).items():
        cfg = cut_config(get_config(arch).reduced(), cut)
        dryrun.get_config = lambda arch: cfg
        out[name] = {s: dryrun.run_cell(arch, s, out_dir=None)
                     for s in cells}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dryrun_cli"))


@pytest.fixture(scope="module")
def cells(cli_dir):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    cuts = {"cut": ["qwen2-0.5b", CUT, CUT_CELLS],
            "cut14": ["qwen2-0.5b", CUT_14, CUT_14_CELLS],
            "cut6": ["qwen2-0.5b", CUT_6, CUT_6_CELLS],
            "cut_ds": [DS, CUT_DS, CUT_DS_CELLS]}
    jamba = {"cut_jamba": [JAMBA, CUT_JAMBA, CUT_JAMBA_CELLS]}
    # the port's jamba cells each in a process of their own: the trace of
    # its mamba layers' chunked scans takes 70-90 s a cell here
    jobs = [("port", _PORT_SCRIPT, [json.dumps(cuts), cli_dir,
                                    json.dumps([PROBE_RANKS, PROBE_LOCAL])]),
            *(("port", _PORT_CELLS_SCRIPT,
               [json.dumps({"cut_jamba": [JAMBA, CUT_JAMBA, [shape]]})])
              for shape in CUT_JAMBA_CELLS),
            ("ref", _REF_SCRIPT, [json.dumps({**cuts, **jamba})])]
    procs = [(side, subprocess.Popen(
        [sys.executable, "-c", script, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env))
        for side, script, args in jobs]
    out = {"port": {}, "ref": {}}
    for side, p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        for name, res in json.loads(stdout.strip().splitlines()[-1]).items():
            if isinstance(res, dict) and name in out[side]:
                out[side][name].update(res)
            else:
                out[side][name] = res
    return out


def test_all_gather_counts_its_operand(cells):
    assert cells["port"]["funcol"] == {"all-gather": 512}
    assert cells["port"]["c10d"] == {"all-gather": 512}


@pytest.mark.parametrize("shape", CUT_CELLS)
def test_flops_per_rank_match_the_reference(cells, shape):
    port, ref = cells["port"]["cut"][shape], cells["ref"]["cut"][shape]
    assert port["status"] == ref["status"] == "ok"
    assert port["n_devices"] == ref["n_devices"] == 256
    np.testing.assert_allclose(port["flops_per_device"],
                               ref["flops_per_device"], rtol=FLOPS_RTOL)
    assert set(port) >= (set(ref) - {"lower_s", "compile_s"}) | {"trace_s"}
    assert port["bottleneck"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("shape", CUT_14_CELLS)
def test_flops_of_heads_that_do_not_divide_within_the_padding(cells, shape):
    port, ref = cells["port"]["cut14"][shape], cells["ref"]["cut14"][shape]
    assert port["status"] == ref["status"] == "ok"
    assert port["flops_per_device"] <= (PAD_FLOPS_RATIO
                                        * ref["flops_per_device"])


@pytest.mark.parametrize("shape", CUT_6_CELLS)
def test_flops_of_fewer_heads_than_ranks(cells, shape):
    port, ref = cells["port"]["cut6"][shape], cells["ref"]["cut6"][shape]
    assert port["status"] == ref["status"] == "ok"
    assert port["flops_per_device"] <= (FEW_HEADS_RATIO
                                        * ref["flops_per_device"])


@pytest.mark.parametrize("shape", CUT_DS_CELLS)
def test_flops_of_routed_experts_and_latent_attention(cells, shape):
    """The deepseek-v2 cut: the router on each rank's own tokens and the
    q latent's gradient on each rank's block of its columns
    (``models/moe.py``, ``models/layers.py:_WholeRowsGrad``): the FLOPs a
    rank within ``FLOPS_RTOL`` of the reference's."""
    port, ref = cells["port"]["cut_ds"][shape], cells["ref"]["cut_ds"][shape]
    assert port["status"] == ref["status"] == "ok"
    np.testing.assert_allclose(port["flops_per_device"],
                               ref["flops_per_device"], rtol=FLOPS_RTOL)


def _check_peak(cells, cut, shape):
    port = cells["port"][cut][shape]["memory"]
    ref = cells["ref"][cut][shape]["memory"]
    assert port["peak_bytes"] <= PEAK_RATIO * ref["peak_bytes"]
    assert max(port["peak_holders"].values()) <= HOLDER_BYTES, \
        port["peak_holders"]


@pytest.mark.parametrize("cut", ["cut", "cut14", "cut_ds", "cut_jamba"])
def test_train_peak_within_twice_the_reference(cells, cut):
    _check_peak(cells, cut, "train_4k")


@pytest.mark.parametrize("cut", ["cut", "cut14", "cut_ds", "cut_jamba"])
def test_prefill_peak_within_twice_the_reference(cells, cut):
    _check_peak(cells, cut, "prefill_32k")


def test_decomposition_search_is_not_the_ranks_memory(cells):
    """One DTensor ``softplus`` forward and backward on a fake world of 16:
    DTensor finds ``softplus_backward``'s sharding by running its
    decomposition on global-shape tensors, which ``OpAnalysis`` must not
    count.  The peak at most 16x the local input's bytes, no op above a
    local f32 block."""
    local = int(np.prod(PROBE_LOCAL))
    got = cells["port"]["softplus"]
    assert got["peak_bytes"] <= 16 * 2 * local, got
    assert max(got["peak_holders"].values()) <= 4 * local, got
    # the ops counted are the rank's: none moves a global-shape tensor
    # (the backward's seed is a view of the whole shape, moving nothing)
    whole = f"[{PROBE_RANKS * PROBE_LOCAL[0]},"
    assert "aten.softplus_backward.default" in " ".join(got["ops"])
    assert not any(whole in key and (flops or moved)
                   for key, (_, flops, moved) in got["ops"].items()), \
        got["ops"]


def test_save_hlo_writes_the_op_listing(cells, cli_dir):
    """``--save-hlo`` on the qwen2 cut: ``<tag>.ops.txt`` beside
    ``<tag>.json``, its totals the JSON's FLOPs and bytes a rank, no op
    run under DTensor's searches in it."""
    assert cells["port"]["cli_rc"] == 0
    tag = os.path.join(cli_dir, "qwen2-0.5b__train_4k__16-16")
    with open(tag + ".json") as f:
        res = json.load(f)
    with open(tag + ".ops.txt") as f:
        text = f.read()
    listing = read_op_listing(text)
    assert listing["total"]["flops"] == res["flops_per_device"] > 0
    assert listing["total"]["bytes"] == res["bytes_per_device"] > 0
    assert sum(v[1] for v in listing["rows"].values()) == \
        listing["total"]["flops"]
    assert any(k.startswith("aten.mm.default bfloat16[")
               for k in listing["rows"])
    # the same cell traced first in the process: DTensor's sharding cache
    # was cold then, warm now, and no count depends on it
    first = cells["port"]["cut"]["train_4k"]
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device"):
        assert res[key] == first[key], key
    assert res["memory"]["peak_bytes"] == first["memory"]["peak_bytes"]


def _cache_bytes_per_rank(cut: dict, shape: str) -> int:
    """The prefill's cache bytes one rank holds on 16x16 under
    ``cache_shardings``."""
    import dataclasses

    from repro_torch.dist import sharding as shd
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), **cut)
    sh = get_shape(shape)
    mesh = shd.MeshShape(("data", "model"), {"data": 16, "model": 16})
    specs = cache_specs(cfg, sh.global_batch, sh.seq_len)
    lay = shd.cache_shardings(cfg, mesh, specs, sh.global_batch)
    return sum(t.numel() * t.element_size() // shd.spec_shards(mesh, s)
               for t, s in zip(tree_leaves(specs), tree_leaves(lay)))


@pytest.mark.parametrize("cut", ["cut", "cut14"])
def test_no_cache_holder_exceeds_the_cache_bytes(cells, cut):
    """Every op laying the prefill's cache out holds at most the cache's
    bytes a rank at any time: no rank gathers the whole sequence or every
    layer's heads."""
    cut_cfg = {"cut": CUT, "cut14": CUT_14}[cut]
    held = {k: v for k, v in cells["port"][cut]["prefill_32k"]["memory"][
        "scope_peaks"].items() if k.startswith("cache/")}
    want = _cache_bytes_per_rank(cut_cfg, "prefill_32k")
    assert held and max(held.values()) <= want, (held, want)


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
