"""Run one Python program as a world of processes on this host.

``run_local_world(code, n)`` starts ``python -c code`` ``n`` times at once,
rank ``r`` with ``argv[1:] = [r, n, store, *args]``, where ``store`` is a
file for ``torch.distributed``'s ``FileStore`` in a fresh directory, so
worlds running side by side never share a port or a store.  Each rank
calls :func:`init_rank` first.  Nothing here knows of a cluster: the world
is these processes on this host.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist


def init_rank(backend: str = "gloo", *, timeout_s: float = 120.0
              ) -> Tuple[int, int, List[str]]:
    """In a rank of :func:`run_local_world`: join the default process group
    and return ``(rank, world_size, extra args)``."""
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return rank, world, sys.argv[4:]


def run_local_world(code: str, world_size: int, *,
                    args: Sequence[str] = (),
                    env: Optional[Dict[str, str]] = None,
                    timeout_s: float = 300.0) -> List[str]:
    """Run ``code`` as ``world_size`` ranks at once; return each rank's
    output (stdout and stderr).  Raises if a rank fails or the time limit
    passes; every process is ended before this returns."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world_size), store,
             *map(str, args)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world_size)]
        outs: List[str] = []
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(
                f"ranks {bad} of {world_size} failed:\n" + "\n".join(
                    f"--- rank {r} (exit {procs[r].returncode})\n"
                    f"{outs[r][-3000:]}" for r in bad))
        return outs
