"""Run one Python program as a world of processes on this host.

``run_local_world(code, n)`` starts ``python -c code`` ``n`` times at once,
rank ``r`` with ``argv[1:] = [r, n, store, *args]``, where ``store`` is a
file for ``torch.distributed``'s ``FileStore`` in a fresh directory, so
worlds running side by side never share a port or a store.  Each rank
calls :func:`init_rank` first.  Nothing here knows of a cluster: the world
is these processes on this host.

Such a world of gloo processes may share one card (NCCL cannot put two
ranks on one card).  Gloo carries the eager collectives on CUDA tensors,
but the functional collectives that DTensor issues crash a gloo rank on
CUDA tensors (PyTorch 2.11, ``scripts/probe_gloo_dtensor.py``), so
``init_rank(..., host_staged_collectives=True)`` routes those through the
host: :func:`stage_collectives_through_host`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the functional collectives DTensor issues, with their CUDA kernels
# replaced by :func:`stage_collectives_through_host`
_STAGED = (("_c10d_functional", "all_gather_into_tensor"),
           ("_c10d_functional", "reduce_scatter_tensor"),
           ("_c10d_functional", "all_reduce"),
           ("_c10d_functional", "all_to_all_single"),
           ("_c10d_functional", "broadcast"),
           ("_dtensor", "shard_dim_alltoall"))
_STAGING_LIBS: list = []


def init_rank(backend: str = "gloo", *, timeout_s: float = 120.0,
              host_staged_collectives: bool = False
              ) -> Tuple[int, int, List[str]]:
    """In a rank of :func:`run_local_world`: join the default process group
    and return ``(rank, world_size, extra args)``.  With
    ``host_staged_collectives`` DTensor's collectives on CUDA tensors go
    through the host (:func:`stage_collectives_through_host`)."""
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    if host_staged_collectives:
        stage_collectives_through_host()
    return rank, world, sys.argv[4:]


def stage_collectives_through_host() -> None:
    """Give each functional collective (``torch.ops._c10d_functional`` and
    DTensor's ``shard_dim_alltoall``) a CUDA kernel that copies its input
    to the host, runs the same op's CPU kernel over the same process group
    to its end, and copies the result back to the input's card: what gloo
    does with a CUDA tensor inside its eager collectives.  The result is
    complete when the op returns, so ``wait_tensor`` on CUDA is the
    identity.  For a world of gloo processes sharing one card only: it
    replaces the kernels NCCL would run in this process."""
    if _STAGING_LIBS:
        return
    libs = {ns: torch.library.Library(ns, "IMPL")
            for ns in {ns for ns, _ in _STAGED}}
    wait = torch.ops._c10d_functional.wait_tensor.default

    def staged(op):
        def run(x, *args):
            return wait(op(x.cpu(), *args)).to(x.device)
        return run

    for ns, name in _STAGED:
        op = getattr(getattr(torch.ops, ns), name).default
        libs[ns].impl(name, staged(op), "CUDA")
    libs["_c10d_functional"].impl("wait_tensor", lambda t: t, "CUDA")
    _STAGING_LIBS.extend(libs.values())


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
