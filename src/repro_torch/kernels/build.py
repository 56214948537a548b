"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``src/repro_torch/csrc/`` becomes one shared library with a
plain C interface, compiled for Hopper (``sm_90a``) at first use into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``).  A library is named by the hash of its source and flags,
so an edited source is rebuilt and an unchanged one is reused.  Nothing here
runs at import time: the CPU tests import every module on hosts without
``nvcc``.

No flag may relax IEEE arithmetic (``--use_fast_math``, ``-prec-div=false``,
``-ftz=true``): the quantizer's payload must match the plain version bit for
bit, the aggregators' sums must match their plain loops bit for bit, and
the attention kernel's ``expf`` and division stay the accurate ones.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"quantize": "quantize.cu",
           "dequant_aggregate": "dequant_aggregate.cu",
           "grad_aggregate": "grad_aggregate.cu",
           "switch_sum": "switch_sum.cu",
           "scatter_aggregate": "scatter_aggregate.cu",
           "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                           "the CUDA kernels can only be built where the "
                           "CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: {"seconds", "ptxas",
    "cached"}}``; raises with the compiler's output if any build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {SOURCES[name]} (exit {proc.returncode})"
                          f"\n{log}")
            continue
        # atomic: a process building at the same time never sees half a file
        os.replace(tmp, target)
        ptxas = " | ".join(l.strip() for l in log.splitlines()
                           if "ptxas info" in l and ("Used" in l or "spill" in l))
        out[name] = {"seconds": time.perf_counter() - t0, "ptxas": ptxas,
                     "cached": False}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if need be."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if the C entry point reported a CUDA error for its launch."""
    if rc != 0:
        lib.repro_error_string.restype = ctypes.c_char_p
        msg = lib.repro_error_string(ctypes.c_int(rc)).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc} "
                           f"({msg})")
