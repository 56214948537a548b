#!/usr/bin/env python3
"""Where a reduce of each aggregation tier spends its time, on one card.

    python3 scripts/breakdown_tiers.py

Builds the input of ``chip_smoke.py``'s ``tiers`` phase (the full-width
Qwen2-0.5B gradient from one forward and backward, 494,147,456 f32
values, 10 buckets of 4 MiB, a ``(pod=1, data=1)`` mesh) and prints one
JSON line per part:

1. ``layers``: for each tier (host, switch, hierarchical, keep_inter 0.1
   with 25% transport drops, switch + keep_inter), the inclusive host time
   of each stage of one ``mlfabric_grad_reduce``, summed over its buckets,
   median of 3 after one warm-up.  Every stage is wrapped so that it
   starts and ends with ``torch.cuda.synchronize()``: the stages are
   ``reduce_flat_buckets``, ``pack_leaves``, the switch stage
   (``_intra_pod_switch_sum``, and inside it ``switch_sum_op``), the dense
   cross-pod stage (``_inter_pod_aggregate``), the sparse one
   (``_inter_pod_aggregate_sparse``, and inside it the drop-mask callable,
   ``topk_sparsify``, ``drop_slots``, ``sparse_quantize`` and
   ``scatter_aggregate_op``) and ``unpack_reduced``.  The synchronizations
   add to the whole; ``reduce_s`` is the same reduce unwrapped.
2. ``profile``: one reduce of each tier under ``torch.profiler`` after a
   warm-up: wall time, summed device time and busy share, the device time
   of each of the port's kernels, and the top kernels.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import functools
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ITERS = 4
STAGES = ("reduce_flat_buckets", "pack_leaves", "_intra_pod_switch_sum",
          "switch_sum_op", "_inter_pod_aggregate",
          "_inter_pod_aggregate_sparse", "topk_sparsify", "drop_slots",
          "sparse_quantize", "scatter_aggregate_op", "unpack_reduced")
OUR_KERNELS = ("switch_sum_kernel", "scatter_pass_kernel", "sumsq_kernel",
               "grad_aggregate_kernel", "dequant_aggregate_kernel",
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


class StageTimer:
    """Wraps ``names`` of a module in synchronized timers while active."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.spent = defaultdict(float)

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*a, **kw):
            out, dt = synced(lambda: fn(*a, **kw))
            self.spent[name] += dt
            return out
        return timed

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.module, n, self.wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("breakdown_tiers: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.dist import collectives as col
    from repro_torch.launch import make_host_mesh

    dev = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()     # so no reduce below pays for nvcc
    grads, _ = cs.full_width_grads(dev)
    mesh = make_host_mesh(device=dev)

    def reduce(kw):
        return col.mlfabric_grad_reduce(grads, mesh=mesh, inter_axis="pod",
                                        **kw)

    # 1. the stages of one reduce ---------------------------------------------
    for name in cs.TIERS:
        per_iter, whole = [], []
        for _ in range(ITERS):
            _, dt = synced(lambda: reduce(cs.tier_kwargs(name)))
            whole.append(dt)
            with StageTimer(col, STAGES) as t:
                kw = cs.tier_kwargs(name)
                if "drop_mask_inter" in kw:
                    kw["drop_mask_inter"] = t.wrap("drop_mask_inter",
                                                   kw["drop_mask_inter"])
                synced(lambda: reduce(kw))
            per_iter.append(dict(t.spent))
        keys = sorted({k for d in per_iter for k in d})
        cs.emit({"part": "layers", "config": name, "kw": cs.TIERS[name],
                 "reduce_s": statistics.median(whole[1:]),
                 "median_s": {k: statistics.median(d.get(k, 0.0)
                                                   for d in per_iter[1:])
                              for k in keys}})

    # 2. one profiled reduce per tier ------------------------------------------
    from torch.profiler import ProfilerActivity, profile
    for name in cs.TIERS:
        kw = cs.tier_kwargs(name)
        synced(lambda: reduce(kw))                          # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reduce(kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
        events.sort(key=dev_us, reverse=True)
        total_us = sum(dev_us(e) for e in events)
        ours = {k: {"calls": sum(e.count for e in events if k in e.key),
                    "device_ms": sum(dev_us(e) for e in events
                                     if k in e.key) / 1e3}
                for k in OUR_KERNELS}
        cs.emit({"part": "profile", "config": name, "wall_s": wall,
                 "device_s": total_us / 1e6,
                 "busy_share": total_us / 1e6 / wall,
                 "ours": {k: v for k, v in ours.items() if v["calls"]},
                 "top": [{"name": e.key[:90], "calls": e.count,
                          "device_ms": dev_us(e) / 1e3} for e in events[:8]]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
