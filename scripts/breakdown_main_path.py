#!/usr/bin/env python3
"""Where a commit of the port's main path spends its time, on one card.

    python3 scripts/breakdown_main_path.py [TRACE_PATH]

Builds the same full-width trainer as ``chip_smoke.py`` (Qwen2-0.5B, bf16,
MLfabric-A with ``compress=True``) and prints one JSON line per part:

1. ``commits``: the host-clock interval of every commit of an 8-commit run
   (a callback synchronizes the card at each commit), so the first,
   warm-up commit shows apart from the steady ones.
2. ``layers``: the layers one update passes through, each timed on the
   host clock between two ``torch.cuda.synchronize()`` calls, median of 5
   after one warm-up: the forward alone, ``Worker.compute_update``
   (forward, backward, update, norm), ``flat_compress_roundtrip`` (the int8
   wire, both kernels inside) and ``ParameterServer.push``.
3. ``profile``: a second 8-commit run under ``torch.profiler``: device
   time by kernel (the top entries), the summed device time, the wall time
   and the device's busy share.  The Chrome trace goes to ``TRACE_PATH``
   (default ``build/main_path_trace.json.gz``).

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LAYER_ITERS = 6


class CommitClock:
    """Trainer callback: host time at each commit, after a synchronize."""

    def __init__(self):
        self.times = []

    def on_run_start(self, source):
        import torch
        torch.cuda.synchronize()
        self.times.append(time.perf_counter())

    def on_commit(self, source, record):
        import torch
        torch.cuda.synchronize()
        self.times.append(time.perf_counter())


def synced(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("breakdown_main_path: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.dist.flatbuf import flat_compress_roundtrip

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()   # so no commit below pays for nvcc

    # 1. per-commit intervals -------------------------------------------------
    clock = CommitClock()
    tr, setup = cs.full_width_trainer(dev, callbacks=[clock])
    res = tr.run(until_commits=cs.MAIN_COMMITS)
    gaps = [b - a for a, b in zip(clock.times, clock.times[1:])]
    cs.emit({"part": "commits", "commits": res.commits,
             "updates_computed": setup["drawn"]["n"], "commit_s": gaps,
             "first_s": gaps[0], "steady_median_s": statistics.median(gaps[1:])})

    # 2. the layers of one update ---------------------------------------------
    model, data_fn = setup["model"], setup["data_fn"]
    worker = tr.workers["worker0"]
    spans = {"forward": [], "compute_update": [],
             "flat_compress_roundtrip": [], "server_push": []}
    for i in range(LAYER_ITERS):
        params, version = tr.server.pull()
        batch = data_fn("worker0", 10_000 + i)
        with torch.no_grad():
            _, dt = synced(lambda: model.loss_fn(params, batch))
        spans["forward"].append(dt)
        (update, _), dt = synced(lambda: worker.compute_update(
            params, batch, version=version, t=1))
        spans["compute_update"].append(dt)
        (decoded, _), dt = synced(lambda: flat_compress_roundtrip(update))
        spans["flat_compress_roundtrip"].append(dt)
        del update
        _, dt = synced(lambda: tr.server.push(decoded, version))
        spans["server_push"].append(dt)
        del decoded
    cs.emit({"part": "layers", "seq_len": cs.SEQ_LEN, "batch": cs.BATCH,
             "median_s": {k: statistics.median(v[1:])
                          for k, v in spans.items()},
             "first_s": {k: v[0] for k, v in spans.items()}})
    del tr

    # 3. a profiled run -------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile
    tr, _ = cs.full_width_trainer(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(until_commits=cs.MAIN_COMMITS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # device-side entries only (kernels, copies, sets): a CPU op's own
    # device time repeats its kernels' time
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    events.sort(key=dev_us, reverse=True)
    total_us = sum(dev_us(e) for e in events)
    trace_path = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        ROOT / "build" / "main_path_trace.json.gz"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    by_ops_us = sum(dev_us(e) for e in prof.key_averages()
                    if not str(e.device_type).endswith("CUDA"))
    cs.emit({"part": "profile", "commits": cs.MAIN_COMMITS, "wall_s": wall,
             "device_s": total_us * 1e-6, "device_s_by_ops": by_ops_us * 1e-6,
             "device_busy_share": total_us * 1e-6 / wall,
             "top": [{"name": e.key[:120], "calls": e.count,
                      "device_ms": dev_us(e) * 1e-3} for e in events[:15]]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
