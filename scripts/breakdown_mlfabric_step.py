#!/usr/bin/env python3
"""Where a step of the in-graph MLfabric training step spends its time, on
one card.

    python3 scripts/breakdown_mlfabric_step.py [TRACE_PATH]

Builds the step of ``chip_smoke.py``'s ``mlfabric_step`` phase (full-width
Qwen2-0.5B in bf16, seq 4096, global batch 2, a ``(pod=1, data=1)`` mesh,
remat, 4 MiB buckets) and prints one JSON line per part:

1. ``layers``: for the uncompressed and the compressed cross-pod stage,
   the layers of one step, each timed on the host clock between two
   ``torch.cuda.synchronize()`` calls, median of 3 after one warm-up: the
   forward and backward, ``reduce_flat_buckets`` (pack, the per-bucket
   kernels, the divide), ``unpack_reduced``, ``momentum_sgd_update``, and
   the whole step through ``StepBundle.fn``.
2. ``profile``: one step of each configuration (uncompressed, compressed,
   ``overlap_chunks=2``) under ``torch.profiler`` after a warm-up step:
   wall time, summed device time and busy share, the device time of each
   of the port's kernels and its share of the step, and the top kernels.
   The Chrome trace of the uncompressed step goes to ``TRACE_PATH``
   (default ``build/mlfabric_step_trace.json.gz``).

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ITERS = 4
OUR_KERNELS = ("grad_aggregate_kernel", "dequant_aggregate_kernel",
               "quantize_kernel")


def synced(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dev_us(e) -> float:
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else getattr(e, "self_cuda_time_total", 0)


def main() -> int:
    import torch
    import torch.distributed
    if not torch.cuda.is_available():
        print("breakdown_mlfabric_step: no CUDA device available",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.collectives import (plan_reduce,
                                              reduce_flat_buckets,
                                              unpack_reduced)
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import build_model
    from repro_torch.optim import momentum_sgd_init, momentum_sgd_update

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()     # so no step below pays for nvcc

    cfg = get_config(cs.FULL_ARCH)
    params = build_model(cfg, dtype=torch.bfloat16, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    opt = momentum_sgd_init(params)
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=cs.STEP_BATCH)
    mesh = make_host_mesh(device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        cfg.vocab_size, shape.seq_len, seed=0).batch(0, cs.STEP_BATCH).items()}
    layout = plan_reduce(params, bucket_bytes=4 * 2 ** 20)
    kw = dict(lr=cs.STEP_LR, gamma=cs.STEP_GAMMA, remat=True)

    # 1. the layers of one step ----------------------------------------------
    for compress in (False, True):
        spans = {k: [] for k in ("forward_backward", "reduce_flat_buckets",
                                 "unpack_reduced", "momentum_sgd_update",
                                 "step")}
        step = build_step(cfg, shape, mesh, grad_path="mlfabric",
                          compress_inter=compress, **kw)
        for _ in range(ITERS):
            (_, grads), dt = synced(lambda: value_and_grad(params, batch,
                                                           cfg, True))
            spans["forward_backward"].append(dt)
            with torch.no_grad():
                reduced, dt = synced(lambda: reduce_flat_buckets(
                    grads, layout, mesh=mesh, intra_axis="data",
                    inter_axis="pod", compress_inter=compress, mean_over=1))
            spans["reduce_flat_buckets"].append(dt)
            del grads
            g2, dt = synced(lambda: unpack_reduced(reduced, layout, params))
            spans["unpack_reduced"].append(dt)
            del reduced
            _, dt = synced(lambda: momentum_sgd_update(
                params, g2, opt, lr=cs.STEP_LR, gamma=cs.STEP_GAMMA))
            spans["momentum_sgd_update"].append(dt)
            del g2
            _, dt = synced(lambda: step.fn(params, opt, batch))
            spans["step"].append(dt)
        cs.emit({"part": "layers", "compress_inter": compress,
                 "buckets": len(layout.buckets),
                 "median_s": {k: statistics.median(v[1:])
                              for k, v in spans.items()},
                 "first_s": {k: v[0] for k, v in spans.items()}})

    # 2. one profiled step per configuration ----------------------------------
    from torch.profiler import ProfilerActivity, profile
    for name, extra in {"mlfabric": {}, "compressed": {"compress_inter": True},
                        "overlap2": {"overlap_chunks": 2}}.items():
        step = build_step(cfg, shape, mesh, grad_path="mlfabric", **kw,
                          **extra)
        synced(lambda: step.fn(params, opt, batch))          # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step.fn(params, opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
        events.sort(key=dev_us, reverse=True)
        total_us = sum(dev_us(e) for e in events)
        ours = {k: {"calls": sum(e.count for e in events if k in e.key),
                    "device_ms": sum(dev_us(e) for e in events
                                     if k in e.key) * 1e-3}
                for k in OUR_KERNELS}
        for v in ours.values():
            v["share_of_step"] = v["device_ms"] * 1e-3 / wall
        if name == "mlfabric":
            trace_path = Path(sys.argv[1]) if len(sys.argv) > 1 else \
                ROOT / "build" / "mlfabric_step_trace.json.gz"
            trace_path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace_path))
        cs.emit({"part": "profile", "config": name, "wall_s": wall,
                 "device_s": total_us * 1e-6,
                 "device_busy_share": total_us * 1e-6 / wall,
                 "kernels": ours,
                 "top": [{"name": e.key[:100], "calls": e.count,
                          "device_ms": dev_us(e) * 1e-3}
                         for e in events[:12]]})
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
