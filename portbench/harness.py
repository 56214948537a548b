"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

``run_cell`` is the whole run without the look for a chip (``run.py`` looks
first, and the CPU tests call this on the CPU at a cut size).  With
``trace`` the window runs under ``torch.profiler`` and the cell's per-layer
metrics are read from it; without, its end-to-end metrics are taken.
After the window the program's peak memory is read, its state freed, and
the reference follows the first updates from the same seed; the numbers of
``compare.py`` against the cell's limits decide ``correct``.
"""

from __future__ import annotations

import importlib.util
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from . import compare, spec
from .flops import model_flops_per_token
from .reference import train as ref_train

OUT = spec.ROOT / "portbench_out"


@dataclass
class LayerContext:
    """What a per-layer reader reads: the traced window's summary, the
    tokens it completed, updates computed and applied in it, the model
    FLOPs a token, and host seconds measured around the program."""

    trace: object
    tokens: int
    computed: int
    updates: int
    window_s: float
    flops_per_token: float
    host: Dict[str, float] = field(default_factory=dict)


def _layer_reader(name: str):
    path = spec.BENCH / "layers" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(
        f"portbench.layers.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: torch.device, t_start: float,
             sizes_fn: Callable[[Dict], Dict] = None,
             traffic_over: Optional[Dict] = None, control: bool = False,
             dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The result line of one run, as a dict whose last key, ``checks``,
    holds the numbers compared beside their limits.  ``sizes_fn`` cuts
    the configuration's sizes and ``traffic_over`` its traffic (the CPU
    tests); ``control`` puts the reference in fp8 in the program's place
    (``faults.py`` plants faults in the program itself)."""
    from . import program
    c = spec.cell(name)
    s = spec.sizes(c["config"])
    if sizes_fn is not None:
        s = sizes_fn(s)
    t = dict(c["traffic"], **(traffic_over or {}))
    cfg = program.model_config(s, c["config_name"])
    program.check_program(cfg, s)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ranges = program.Ranges() if trace else None
    runner_cls = {"step": program.StepRunner,
                  "async": program.AsyncRunner}[t["entry"]]
    runner = runner_cls(cfg, s, t, seed, device, ranges=ranges, dtype=dtype)
    prof = None
    clock = time.perf_counter

    def start_window():
        nonlocal prof, setup_s
        sync()
        setup_s = clock() - t_start
        if ranges is not None:
            ranges.wire.clear()
        if trace:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            prof.__enter__()
        window_range.__enter__()

    window_range = torch.profiler.record_function("portbench.window")
    setup_s = None
    if t["entry"] == "step":
        first = runner.first()
        start_window()
        win = runner.window(seconds, clock)
        computed = win["updates"]
    else:
        runner.run(seconds, clock, on_window_start=start_window)
        first = runner.first()
        win = runner.window()
        computed = runner.computed_in_window
    window_range.__exit__(None, None, None)
    summary = None
    if trace:
        prof.__exit__(None, None, None)
        OUT.mkdir(exist_ok=True)
        path = OUT / f"{name}.trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        from .trace import read_chrome
        summary = read_chrome(path)
        summary.wire = list(ranges.wire)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    schedule_ok = runner.schedule_ok() if t["entry"] == "async" else True
    args = runner.reference_args()
    if ranges is not None:
        ranges.restore()
    runner.close()
    del runner

    args["store"] = dtype
    prog = first
    if control:
        prog = ref_train.follow(s, seed, device, n=program.FIRST,
                                precision="fp8", **dict(args, routes=None))
        args["routes"] = prog["routes"]
    t_ref = clock()
    ref = ref_train.follow(s, seed, device, n=program.FIRST, **args)
    t_ref = clock() - t_ref
    read = compare.readings(prog, ref)
    correct, checks = compare.decide(read, c["limits"])
    correct = correct and schedule_ok
    if t["entry"] == "async":
        checks["schedule"] = {"value": int(not schedule_ok), "limit": 0}

    metrics: Dict[str, Dict] = {}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda
                else "cpu", "count": 1, "memory_peak_bytes": peak}
    out: Dict = {"correct": correct, "attempted": win["attempted"],
                 "failed": win["failed"]}
    wanted = spec.metrics_for(name, trace)
    if not trace:
        values = {"train_tokens_per_s": win["tokens"] / win["seconds"],
                  "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        for m in wanted:
            metrics[m] = {"value": values[m], "unit": wanted[m]["unit"]}
    else:
        ctx = LayerContext(
            trace=summary, tokens=win["tokens"], computed=computed,
            updates=win["updates"], window_s=summary.window_s,
            flops_per_token=model_flops_per_token(s, t["seq_len"]),
            host={k: win[k] for k in ("control_plane_s",) if k in win})
        for m in wanted:
            v = _layer_reader(m)(ctx)
            if v is not None:
                metrics[m] = {"value": v, "unit": wanted[m]["unit"]}
        dev_info.update(busy_s=summary.busy_s(), window_s=summary.window_s)
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           summary.top_ops()],
                            "idle_gaps": [list(x) for x in
                                          summary.idle_gaps()]}
    out["metrics"] = metrics
    out["device"] = dev_info
    out["updates"] = {"window": win["updates"], "window_s": win["seconds"],
                      "reference_s": t_ref,
                      "first_losses": prog["losses"],
                      "reference_losses": ref["losses"],
                      "readings": {k: read[k]["value"]
                                   for k in compare.NUMBERS},
                      "worst": {k: read[k]["where"]
                                for k in compare.NUMBERS},
                      "left_out": read["_left_out"],
                      "program": {k: v for k, v in prog.items()
                                  if k != "routes"},
                      "reference": {k: v for k, v in ref.items()
                                    if k != "routes"}}
    out["checks"] = checks
    return out
