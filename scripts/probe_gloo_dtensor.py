#!/usr/bin/env python3
"""Which collectives gloo carries for DTensor on CUDA tensors, on one card.

    python3 scripts/probe_gloo_dtensor.py

Starts worlds of four gloo processes that share the one card, each with a
``(data=2, model=2)`` ``DeviceMesh``, and tries each collective that
DTensor's redistributions issue (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``) on a
7.3 MB bf16 tensor (one residual of a 4,096-token Qwen2-0.5B sequence
over two ranks), checked bit for bit against the same redistribution on
CPU tensors.  One world per variant, so a crash ends only its own:

1. ``eager``: the eager ``torch.distributed`` call on CUDA tensors;
2. ``dtensor_host_staged``: DTensor's ``redistribute`` on CUDA tensors
   with ``launch.local.stage_collectives_through_host`` installed (what
   ``chip_smoke.py``'s ``sharded`` phase runs);
3. ``dtensor``: DTensor's ``redistribute`` on CUDA tensors as PyTorch
   ships it (its functional collectives).

Each line: the variant, whether every rank ran every collective and got
the CPU's bits, each collective's milliseconds per call (median of 5
after one warm-up, ending in a synchronization) or its error, and the
world's exit codes; then the card's ``nvidia-smi`` name and power limit.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("eager", "dtensor_host_staged", "dtensor")
COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce", "all_to_all_single")

_RANK = textwrap.dedent("""
    import faulthandler, json, statistics, sys, time
    faulthandler.enable()
    import torch, torch.distributed as dist
    from repro_torch.launch import init_rank
    rank, world, (variant,) = init_rank("gloo")
    torch.cuda.set_device(0)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    if variant == "dtensor_host_staged":
        from repro_torch.launch.local import stage_collectives_through_host
        stage_collectives_through_host()
    shape = (2, 2)
    meshes = {d: DeviceMesh(d, torch.arange(4).reshape(shape),
                            mesh_dim_names=("data", "model"))
              for d in ("cpu", "cuda")}
    gm = {d: m.get_group("model") for d, m in meshes.items()}
    n = 4096 * 896                    # bf16 elements: 7.3 MB

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    def eager(name, dev):
        g = torch.Generator().manual_seed(rank)
        x = torch.randn(n, generator=g).to(dev, torch.bfloat16)
        grp = gm[dev]
        if name == "all_reduce":
            out = x.clone()
            return out, lambda: dist.all_reduce(out, group=grp)
        if name == "all_gather_into_tensor":
            out = x.new_empty(2 * n)
            return out, lambda: dist.all_gather_into_tensor(out, x,
                                                            group=grp)
        if name == "reduce_scatter_tensor":
            out = x.new_empty(n // 2)
            return out, lambda: dist.reduce_scatter_tensor(out, x,
                                                           group=grp)
        out = x.new_empty(n)
        return out, lambda: dist.all_to_all_single(out, x, group=grp)

    PLACE = {"all_reduce": ([Replicate(), Partial()],
                            [Replicate(), Replicate()]),
             "all_gather_into_tensor": ([Replicate(), Shard(0)],
                                        [Replicate(), Replicate()]),
             "reduce_scatter_tensor": ([Replicate(), Partial()],
                                       [Replicate(), Shard(0)]),
             "all_to_all_single": ([Replicate(), Shard(0)],
                                   [Replicate(), Shard(1)])}

    def redistributed(name, dev):
        g = torch.Generator().manual_seed(rank)
        x = torch.randn(2, n // 2, generator=g).to(dev, torch.bfloat16)
        src, dst = PLACE[name]
        d = DTensor.from_local(x, meshes[dev], src, run_check=False)
        return lambda: d.redistribute(placements=dst).to_local()

    res = {"rank": rank, "torch": torch.__version__,
           "cuda": torch.version.cuda, "collectives": {}}
    for name in COLLECTIVES:
        print(json.dumps({"start": name}), flush=True)
        try:
            if variant == "eager":
                want, fn = eager(name, "cpu")
                fn()
                got, fn = eager(name, "cuda")
                ms = timed(fn)
                got, fn = eager(name, "cuda")
                fn()
            else:
                want = redistributed(name, "cpu")()
                fn = redistributed(name, "cuda")
                ms = timed(fn)
                got = fn()
            res["collectives"][name] = {
                "ok": bool(torch.equal(got.cpu(), want)), "ms": ms}
        except Exception as e:
            res["collectives"][name] = {"ok": False, "error": repr(e)[:300]}
    print(json.dumps(res), flush=True)
""").replace("COLLECTIVES", repr(COLLECTIVES))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_gloo_dtensor: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import run_local_world
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ok = {}
    for variant in VARIANTS:
        try:
            outs = run_local_world(_RANK, 4, args=(variant,), env=env,
                                   timeout_s=180)
        except RuntimeError as e:
            ok[variant] = False
            print(json.dumps({"variant": variant, "world_ran": False,
                              "error": str(e)[-2500:]}), flush=True)
            continue
        ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        ok[variant] = all(r["collectives"][c]["ok"] for r in ranks
                          for c in COLLECTIVES)
        print(json.dumps({"variant": variant, "world_ran": True,
                          "all_ok": ok[variant], "torch": ranks[0]["torch"],
                          "cuda": ranks[0]["cuda"],
                          "rank0": ranks[0]["collectives"],
                          "failed": {r["rank"]: [c for c in COLLECTIVES
                                                 if not r["collectives"][c][
                                                     "ok"]]
                                     for r in ranks}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "ok": ok}))
    return 0 if ok["dtensor_host_staged"] else 1


if __name__ == "__main__":
    sys.exit(main())
