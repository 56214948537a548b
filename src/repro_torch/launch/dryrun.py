"""Multi-pod dry-run of the port: trace every (arch x shape) cell's step on
the production meshes, one rank's share, and derive its roofline inputs.

The port of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles each step for 256 or 512 fake devices and reads XLA's analyses,
this runs in one process as rank 0 of a ``"fake"`` process group of 256
(16x16) or 512 (2x16x16) ranks: the step's ``args`` (``StepBundle.args``,
laid out by the same sharding rules as DTensors) become ``FakeTensor``s,
which hold no data, and the donating call of the step runs on them under
:class:`~repro_torch.launch.op_analysis.OpAnalysis`, which counts that
rank's FLOPs, bytes, collective bytes, kernel launches and peak live bytes.
The kernels answer through their shape rules (``kernels/ops.py``).

The fake tensors lie on the card where PyTorch is built for CUDA, else on
the CPU (a CPU-only build cannot index a tensor on a CUDA device, even a
fake one); nothing runs on either, and no number below is measured.

Each cell's result goes to ``<out>/<tag>.json``.  With ``--save-hlo`` the
op listing goes beside it, ``<tag>.ops.txt``: the port's counterpart of the
reference's ``<tag>.hlo.txt``, one line per (op, operand dtypes and
shapes) with its FLOPs, bytes and count, largest FLOPs first, and a
``total`` line equal to the JSON's ``flops_per_device`` and
``bytes_per_device`` (``op_analysis.op_listing``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k [--multipod] [--out runs/dryrun_torch] [--save-hlo]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..configs.base import get_config, list_configs
from ..configs.shapes import SHAPES, applicable, get_shape
from ..dist import sharding as shd
from ..obs.report import roofline_attribution
from ..tree import tree_map
from .mesh import Mesh, make_production_mesh
from .op_analysis import OpAnalysis, op_listing, storages
from .steps import StepBundle, build_step

# NVIDIA H100 SXM roofline targets (NVIDIA's data sheet, dense rates, at the
# card's full 700 W power limit)
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card (tensor cores, dense)
HBM_BW = 3.35e12             # HBM3 bytes/s per card
# bytes/s a card sends off its host: one 400 Gb/s NDR InfiniBand port per
# card, since both 16-wide axes of the production meshes span two or more
# 8-card hosts (NVLink stays inside a host)
ICI_BW = 50e9


def trace_device() -> torch.device:
    """Where the fake tensors lie: the card where PyTorch has CUDA."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def fake_world(world: int) -> None:
    """Make the default process group rank 0 of a ``"fake"`` group of
    ``world`` ranks (its collectives return at once and move nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake_leaf(spec: torch.Tensor, device: torch.device) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device=device)


def _fake_sharded(spec: torch.Tensor, mesh: Mesh, pspec) -> torch.Tensor:
    """A DTensor of ``spec``'s global shape laid out by ``pspec``, whose
    local block is a fake tensor of this rank's shape."""
    from torch.distributed.tensor import DTensor
    block = shd.shard_slices(mesh, pspec, tuple(spec.shape), mesh.coords)
    local = [len(range(*s.indices(n))) for s, n in zip(block, spec.shape)]
    return DTensor.from_local(
        torch.empty(local, dtype=spec.dtype, device=mesh.device),
        mesh.device_mesh, shd.placements(mesh, pspec), shape=spec.shape,
        stride=spec.stride(), run_check=False)


def fake_args(bundle: StepBundle, cfg, shape, mesh: Mesh,
              grad_path: str = "auto") -> tuple:
    """``bundle.args`` as fake tensors, as the step takes them: plain on a
    mesh without a ``model`` axis; on one with it, params and history laid
    out by ``param_shardings`` (the data entries stripped for the MLfabric
    step) and a decode cache by ``cache_shardings``, the batch and tokens
    plain (the port's sharded steps take the global batch).  Call under
    ``FakeTensorMode``."""
    plain = lambda t: _fake_leaf(t, mesh.device)  # noqa: E731
    if mesh.device_mesh is None:
        out = tree_map(plain, bundle.args)
    else:
        params = bundle.args[0]
        psh = shd.param_shardings(cfg, mesh, params)
        if grad_path == "mlfabric":
            psh = tree_map(shd.strip_data, psh)
        lay = lambda t, s: _fake_sharded(t, mesh, s)  # noqa: E731
        if shape.kind == "train":
            opt = bundle.args[1]
            out = (tree_map(lay, params, psh),
                   type(opt)(tree_map(lay, opt.history, psh)),
                   tree_map(plain, bundle.args[2]))
        elif shape.kind == "prefill":
            out = (tree_map(lay, params, psh), tree_map(plain,
                                                        bundle.args[1]))
        else:
            cache = bundle.args[1]
            csh = shd.cache_shardings(cfg, mesh, cache, shape.global_batch)
            out = (tree_map(lay, params, psh), tree_map(lay, cache, csh),
                   plain(bundle.args[2]), bundle.args[3])
    if shape.kind == "decode":     # the last position: attention over all
        out = (*out[:3], shape.seq_len - 1)
    return out


def analyze_step(bundle: StepBundle, cfg, shape, mesh: Mesh,
                 grad_path: str = "auto", *, donate: bool = True
                 ) -> Dict[str, Any]:
    """Trace the donating call of ``bundle`` (``fn`` without ``donate``)
    once on fake args under :class:`OpAnalysis`; its counts, the argument
    and output bytes, and the seconds the trace took."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    oa = OpAnalysis()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = fake_args(bundle, cfg, shape, mesh, grad_path)
        oa.track(args)
        arg_bytes = oa.live_bytes
        with oa:
            out = (bundle.donating() if donate else bundle.fn)(*args)
        held = storages(args)     # a donated arg returned is no output
        out_bytes = sum(st.nbytes() for k, st in storages(out).items()
                        if k not in held)
        del out, args, held
    res = oa.summary()
    res.update(argument_bytes=arg_bytes, output_bytes=out_bytes,
               trace_s=time.perf_counter() - t0)
    return res


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: Optional[str] = "runs/dryrun_torch",
             save_hlo: bool = False, step_kwargs=None) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    world = 512 if multi_pod else 256
    fake_world(world)
    mesh = make_production_mesh(multi_pod=multi_pod, device=trace_device())
    kw = dict(step_kwargs or {})
    bundle = build_step(cfg, shape, mesh, **kw)
    a = analyze_step(bundle, cfg, shape, mesh,
                     kw.get("grad_path", "auto"))
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": world,
        "status": "ok",
        "trace_s": round(a["trace_s"], 1),
        "trace_device": str(mesh.device),
        # one rank's numbers; eager dispatch runs every layer, so there is
        # no loop to multiply and the raw numbers are the loop-aware ones
        "flops_per_device_raw": a["flops"],
        "flops_per_device": a["flops"],
        "bytes_per_device": a["bytes"],
        "collective_bytes_raw": a["collective_bytes"],
        "collective_bytes_per_device": a["collective_bytes"],
        "collective_by_kind": a["collective_by_kind"],
        "launches": a["launches"],
        "memory": {
            "argument_bytes": a["argument_bytes"],
            "output_bytes": a["output_bytes"],
            "temp_bytes": a["peak_bytes"] - a["argument_bytes"],
            "peak_bytes": a["peak_bytes"],
            "peak_holders": a["peak_holders"],
            "scope_peaks": a["scope_peaks"],
        },
        "t_compute": a["flops"] / PEAK_FLOPS,
        "t_memory": a["bytes"] / HBM_BW,
        "t_collective": a["collective_bytes"] / ICI_BW,
    }
    roofline = roofline_attribution(result["t_compute"], result["t_memory"],
                                    result["t_collective"])
    result["bottleneck"] = roofline["bottleneck"]
    result["bottleneck_share"] = roofline["share"]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{shape_name}__{result['mesh'].replace('x', '-')}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=2)
        if save_hlo:
            with open(os.path.join(out_dir, tag + ".ops.txt"), "w") as f:
                f.write(op_listing(a["ops"], f"{arch} {shape_name} on "
                                   f"{result['mesh']}, one rank of {world}"))
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (see --list)")
    ap.add_argument("--shape", help="input shape name")
    ap.add_argument("--multipod", action="store_true",
                    help="2x16x16 multi-pod mesh (default: 16x16)")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's op listing to <tag>.ops.txt")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV cache for decode cells")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation slices for train cells")
    args = ap.parse_args()

    if args.list:
        for a in list_configs():
            print(a)
        return 0

    cells = ([(args.arch, args.shape)] if not args.all else
             [(a, s) for a in list_configs() for s in SHAPES])
    failures = 0
    for arch, shape in cells:
        try:
            kw = {}
            if args.kv_int8 and SHAPES[shape].kind == "decode":
                kw["kv_int8"] = True
            if args.microbatches > 1 and SHAPES[shape].kind == "train":
                kw["microbatches"] = args.microbatches
            res = run_cell(arch, shape, multi_pod=args.multipod,
                           out_dir=args.out, save_hlo=args.save_hlo,
                           step_kwargs=kw)
        except Exception:
            traceback.print_exc()
            res = {"arch": arch, "shape": shape, "status": "FAILED"}
            failures += 1
        line = (f"{res['arch']:24s} {res['shape']:12s} {res['status']:8s}")
        if res["status"] == "ok":
            line += (f" trace={res['trace_s']:7.1f}s"
                     f" flops/dev={res['flops_per_device']:.3e}"
                     f" coll/dev={res['collective_bytes_per_device']:.3e}"
                     f" peakmem={res['memory']['peak_bytes']/1e9:6.2f}GB"
                     f" bound={res['bottleneck']}")
        print(line, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
