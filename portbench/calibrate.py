"""The readings that a cell's limits are set from, at the cell's own size:
one run of the cell with no measured window for each seed and each of
``--what``, in this process, and one JSON line for each run with every
number of ``compare.py`` against the float32 reference.  ``program`` is the
program as the benchmark runs it (the lower readings), ``control`` the
reference in fp8 put in the program's place, and each name of
``faults.FAULTS`` the program with that fault planted (the upper ones).
``stale`` reads 1 on ``grad`` and ``change`` by the comparison's measure.
The benchmark's runs never call this.

    python3 portbench/calibrate.py --workload NAME --seeds 101 102 103 \
        --what program control half_batch altered route

On a CUDA card it runs there; without one, at the CPU tests' cut size.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def reading(name: str, seed: int, device, what: str = "program",
            cut: bool = False, traffic_over=None):
    """The result of one run of ``name`` on ``seed`` with no measured
    window, as ``harness.run_cell`` gives it, with ``what`` in the
    program's place (see the module's text)."""
    from portbench import faults, harness, spec
    kw = {"sizes_fn": spec.reduced_sizes} if cut else {}
    with faults.planted(what if what in faults.FAULTS else None):
        return harness.run_cell(name, seed, 0.0, False, device=device,
                                t_start=time.perf_counter(),
                                traffic_over=traffic_over,
                                control=what == "control", **kw)


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["program"])
    a = ap.parse_args(argv)
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    over = None if cuda else {"seq_len": 256, "rows": 2}
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    for seed in a.seeds:
        for what in a.what:
            t0 = time.perf_counter()
            out = reading(a.workload, seed, dev, what, cut=not cuda,
                          traffic_over=over)
            u = out["updates"]
            print(json.dumps({
                "workload": a.workload, "seed": seed, "what": what,
                "device": kind, "correct": out["correct"],
                "readings": u["readings"], "worst": u["worst"],
                "reference_s": u["reference_s"],
                "seconds": time.perf_counter() - t0}), flush=True)
            del out
            if cuda:
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
