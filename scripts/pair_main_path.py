"""Time cell A, ``chip_smoke.py``'s ``main_path`` phase (MLfabric-A on the
full-width Qwen2-0.5B, 8 commits), from several checkouts on one card, each
run in a fresh process, in the order given.  Two versions of the port are
compared this way within one machine:

    git archive HEAD~1 | tar -x -C build/parent
    python3 scripts/pair_main_path.py build/parent . . build/parent

Each process builds the kernels, then runs the phase twice: the first run
pays the process's first-use costs (allocator growth, library handles)
and is reported as ``cold_ms_per_commit``; the second is the reading.
A spec ``DIR+kernels`` runs that checkout's kernel phase first in the same
process, as ``chip_smoke.py`` does, to show what the earlier phase leaves
behind.  A spec ``DIR+remat`` runs the trainer with the model's default
``remat=True`` (only for a checkout whose ``phase_main_path`` takes
``remat``), and ``DIR+pg`` first sets up the world-of-one process group
the kernel phase sets up (``make_host_mesh``; slice 2 and later).
Prints each warm ``main_path`` line with its spec, then one summary line.
Needs a CUDA card; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

_RUN = """
import sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as c
flag = sys.argv[1]
c.phase_device()
c.phase_build()
if flag == "kernels":
    c.phase_kernels()
if flag == "pg":
    from repro_torch.launch import make_host_mesh
    make_host_mesh(device=torch.device("cuda", 0))
for _ in range(2):
    if flag == "remat":
        c.phase_main_path(remat=True)
    else:
        c.phase_main_path()
"""


def run(spec: str) -> dict:
    root, _, flag = spec.partition("+")
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, flag],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=""))
    if proc.returncode:
        raise RuntimeError(f"{spec} failed:\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}")
    runs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{") and '"main_path"' in line]
    if len(runs) != 2:
        raise RuntimeError(f"{spec}: {len(runs)} main_path lines:\n"
                           f"{proc.stdout[-2000:]}")
    cold, warm = runs
    return {"spec": spec, **warm,
            "cold_wall_s_per_commit": cold["wall_s_per_commit"]}


def main(specs) -> int:
    if not specs:
        print(__doc__, file=sys.stderr)
        return 2
    for s in specs:
        root, _, flag = s.partition("+")
        if not (Path(root) / "chip_smoke.py").is_file():
            print(f"{s}: no chip_smoke.py there", file=sys.stderr)
            return 2
        if flag not in ("", "kernels", "remat", "pg"):
            print(f"{s}: unknown flag {flag!r}", file=sys.stderr)
            return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    rows = []
    for s in specs:
        r = run(s)
        rows.append(r)
        print(json.dumps(r), flush=True)
    print(json.dumps({"summary": [
        {"spec": r["spec"], "ms_per_commit": 1e3 * r["wall_s_per_commit"],
         "cold_ms_per_commit": 1e3 * r["cold_wall_s_per_commit"],
         "commits": r["commits"], "updates_computed": r["updates_computed"],
         "max_memory_allocated": r["max_memory_allocated"]}
        for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
