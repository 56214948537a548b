"""Run chosen phases of ``chip_smoke.py`` from several checkouts on one card,
each checkout in a fresh process, in the order given, and print every JSON
line they emit tagged with the checkout.  Two versions of the port are
compared this way within one machine:

    git archive HEAD~1 | tar -x -C build/parent
    python3 scripts/pair_phases.py build/parent . . build/parent

Phases, in this order: the ``flash_attention`` and ``scatter_aggregate``
kernel lines (``kernel_flash_attention``, ``kernel_scatter_aggregate``),
then cell B (``mlfabric_step``: s/step and peak memory of the in-graph
step, which trains through the blockwise attention's backward), cell C
(``tiers``: ms per reduce, among them keep and switch + keep) and cell D
(``serve``: the 32k prefill through the flash kernel, decode, the serve
loop).  ``--phases a,b`` picks a subset by those names.  Ends with one
summary line of the readings that change between the versions.  Needs a
CUDA card; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

PHASES = ("flash", "scatter", "mlfabric_step", "tiers", "serve")

_RUN = """
import sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as c
phases = sys.argv[1].split(",")
c.phase_device()
c.phase_build()
dev = torch.device("cuda", 0)
rows = {}
if "flash" in phases:
    c.kernel_flash_attention(dev, rows)
if "scatter" in phases:
    c.kernel_scatter_aggregate(torch.Generator(device=dev).manual_seed(1234),
                               dev, rows)
if "mlfabric_step" in phases:
    c.phase_mlfabric_step()
if "tiers" in phases:
    c.phase_tiers()
if "serve" in phases:
    c.phase_serve()
"""


def run(root: str, phases) -> list:
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, ",".join(phases)],
        cwd=root, capture_output=True, text=True, timeout=1500,
        env=dict(os.environ, PYTHONPATH=""))
    if proc.returncode:
        raise RuntimeError(f"{root} failed:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def summary(root: str, lines: list) -> dict:
    """The readings compared between versions, from one checkout's lines."""
    out = {"checkout": root}
    for r in lines:
        if r.get("kernel") == "flash_attention" and "ms" in r:
            out[f"flash_ms_B{r['B']}_S{r['S']}_D{r['D']}_"
                f"{r.get('dtype', 'bfloat16')}"] = r["ms"]
        if r.get("kernel") == "scatter_aggregate" and "ms" in r:
            out[f"scatter_ms_N{r['N']}"] = r["ms"]
        if r.get("phase") == "mlfabric_step" and "s_per_step" in r:
            out[f"step_s_{r['config']}"] = r["s_per_step"]
            out[f"step_peak_{r['config']}"] = r.get("max_memory_allocated")
        if r.get("phase") == "tiers" and "ms_per_reduce" in r:
            out[f"tier_ms_{r['config']}"] = r["ms_per_reduce"]
        if r.get("phase") == "serve" and r.get("part") == "prefill":
            out["prefill_s"] = r["s_per_prefill"]
    return out


def main(argv) -> int:
    phases = PHASES
    if argv[:1] == ["--phases"]:
        phases = tuple(argv[1].split(","))
        argv = argv[2:]
    if not argv or any(p not in PHASES for p in phases):
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        if not (Path(root) / "chip_smoke.py").is_file():
            print(f"{root}: no chip_smoke.py there", file=sys.stderr)
            return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    rows = []
    for i, root in enumerate(argv):
        lines = run(root, phases)
        for r in lines:
            print(json.dumps({"run": i, "checkout": root, **r}), flush=True)
        rows.append(summary(root, lines))
    print(json.dumps({"summary": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
