#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit.  Every line it prints is one JSON object:

1. ``device``: the card's name, count, and ``nvidia-smi``'s name and power
   limit.  Exits non-zero, printing no result, without a CUDA device.
2. ``build``: compiles every CUDA kernel of the port from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once).
3. ``kernel``: calls each kernel on the card at the main path's shapes and
   holds it against its plain PyTorch version on the same inputs: the
   quantizer's payload and scales and the N=1 decode bit-equal, the N=8
   ragged decode within rtol 1e-6, the sums of squares within rtol 1e-5.
   Times each with CUDA events beside its bound (the larger of its bytes
   over the memory rate and its flops over the f32 rate).  Also
   ``grad_aggregate`` at N = 1, 2, 4 on the full-width embedding bucket
   (136,249,344 columns) and at N=3 on a ragged D in f32 and bf16, agg
   bit-equal; ``quantize`` on a view one float off 16-byte alignment,
   bit-equal; ``dequant_aggregate`` timed at N = 2, 4 on the embedding
   bucket; and one compressed ``mlfabric_grad_reduce`` of a tree whose
   second bucket is such a view, on the card against the CPU.
4. ``reduced_parity``: the reduced qwen2-0.5b slice trained on the card
   (kernels) and on the CPU (plain versions) from the same f32 params; the
   eval losses must agree.
5. ``main_path``: MLfabric-A ``AsyncTrainer(compress=True)`` training the
   full-width Qwen2-0.5B (24 layers, d 896, bf16, seeded random weights)
   for at least 8 commits.  Every eval loss must be finite and each
   kernel's launch count must equal the number of updates computed.
6. ``reduced_step_parity``: one in-graph MLfabric step of the reduced
   qwen2-0.5b in f32 on a ``(pod=1, data=1)`` mesh with 1 KiB buckets
   (uncompressed, compressed, ``overlap_chunks=2``), on the card and on
   the CPU from the same params and batch.
7. ``mlfabric_step``: the in-graph MLfabric step
   (``launch.steps.build_step(..., grad_path="mlfabric")``) on the
   full-width Qwen2-0.5B in bf16 at seq 4096, global batch 2, in three
   configurations of 1 warm-up and 3 timed steps each; finite losses,
   kernel launches equal to buckets x steps (x chunks), and agreement with
   the "auto" step.
8. ``mlfabric_ranks``: the same step on a 2-pod x 2-data world of four
   gloo processes sharing the card, reduced model, against the auto step.
9. The ``{"kernels": [...]}`` summary, then ``{"ok": true, ...}`` last.

Any failed check raises, so the script exits non-zero.  It imports nothing
of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
FULL_ARCH = "qwen2-0.5b"
MAIN_COMMITS = 8
SEQ_LEN, BATCH = 256, 2
REDUCED_COMMITS = 10
REDUCED_LOSS_RTOL = 1e-4
EMBED_D = 152_064 * 896          # the full-width embedding bucket, % 256 == 0
STEP_BATCH = 2                   # train_4k's global batch 256, cut to 2
STEP_LR, STEP_GAMMA = 1e-3, 0.9
STEP_TIMED = 3
REDUCED_STEP_LR = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the (f32, CUDA-core) flops over their peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def bound_by(nbytes: float, flops: float = 0.0) -> str:
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
            else "operations")


def ops_launches():
    from repro_torch.kernels import ops
    return {"quantize": ops.quantize_op.launches,
            "dequant_aggregate": ops.dequant_aggregate_op.launches,
            "grad_aggregate": ops.grad_aggregate_op.launches}


def zero_launches() -> None:
    from repro_torch.kernels import ops
    ops.quantize_op.launches = 0
    ops.dequant_aggregate_op.launches = 0
    ops.grad_aggregate_op.launches = 0


def rel_err(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# --------------------------------------------------------------------------- #
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    res = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": res})


def full_width_flat_len() -> int:
    """Length of the full-width update's flat wire buffer (each leaf padded
    to a 256 block), from the parameter shapes."""
    from repro_torch.configs import get_config
    from repro_torch.dist.flatbuf import padded_size
    c = get_config(FULL_ARCH)
    L, d, ff = c.n_layers, c.d_model, c.d_ff
    q_w, kv_w = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    sizes = [c.padded_vocab * d, d,                       # embed, final norm
             L * kv_w, L * q_w, L * kv_w,                 # bk bq bv
             L * d * kv_w, L * q_w * d, L * d * q_w, L * d * kv_w,  # wk wo wq wv
             L * ff * d, L * d * ff, L * d * ff,          # down gate up
             L * d, L * d]                                # norm1 norm2
    return padded_size(sizes)


def phase_kernels():
    import torch
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate_plain
    from repro_torch.kernels.ops import dequant_aggregate_op, quantize_op
    from repro_torch.kernels.quantize import quantize_plain

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = {}

    # -- quantize at the full-width flat update length ----------------------
    d = full_width_flat_len()
    x = torch.randn(d, generator=gen, device=dev) * 1e-3
    x[-3 * 256:] = 0.0                 # all-zero (pad) blocks: scale 1e-30
    q_k, s_k = quantize_op(x)
    q_p, s_p = quantize_plain(x)
    torch.cuda.synchronize()
    check(torch.equal(q_k, q_p), "quantize: q differs from the plain version")
    check(torch.equal(s_k, s_p),
          "quantize: scales differ from the plain version")
    err = max(float((q_k.int() - q_p.int()).abs().max()),
              float((s_k - s_p).abs().max()))
    ms = cuda_ms(lambda: quantize_op(x), iters=20)
    plain_ms = cuda_ms(lambda: quantize_plain(x), iters=3, warmup=1)
    nbytes = 4 * d + d + 4 * (d // 256)
    flops = 5 * d              # |x|, max, divide, round, clamp per element
    rows["quantize"] = dict(
        name="quantize", route="cuda",
        source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:38",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops),
        library_ms=None)
    emit({"phase": "kernel", "kernel": "quantize", "D": d,
          "bit_equal": True, **rows["quantize"]})

    # -- dequant_aggregate at N=1 on the same payload ------------------------
    ones = torch.ones(1, device=dev)
    q1, s1 = q_k[None, :], s_k[None, :]
    del x, q_p, s_p
    agg_k, ssq_k = dequant_aggregate_op(q1, s1, ones, orig_len=d)
    agg_p, ssq_p = dequant_aggregate_plain(q1, s1, ones, orig_len=d)
    torch.cuda.synchronize()
    check(torch.equal(agg_k, agg_p),
          "dequant_aggregate N=1: agg differs from the plain version")
    check(rel_err(ssq_k, ssq_p) <= 1e-5,
          f"dequant_aggregate N=1: ssq {float(ssq_k)} vs {float(ssq_p)}")
    err1 = float((agg_k - agg_p).abs().max())
    del agg_k, agg_p
    ms = cuda_ms(lambda: dequant_aggregate_op(q1, s1, ones, orig_len=d),
                 iters=20)
    plain_ms = cuda_ms(lambda: dequant_aggregate_plain(q1, s1, ones,
                                                       orig_len=d),
                       iters=3, warmup=1)
    nbytes = d + 4 * (d // 256) + 4 + 4 * d + 4
    flops = 5 * d              # q*s, *w, +, and the square and sum
    rows["dequant_aggregate"] = dict(
        name="dequant_aggregate", route="cuda",
        source="src/repro_torch/csrc/dequant_aggregate.cu",
        replaces="src/repro/kernels/dequant_aggregate.py:78",
        max_abs_err=err1, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops),
        library_ms=None)
    emit({"phase": "kernel", "kernel": "dequant_aggregate", "N": 1, "D": d,
          "bit_equal": True, "ssq_rel_err": rel_err(ssq_k, ssq_p),
          **rows["dequant_aggregate"]})
    del q1, s1, q_k, s_k

    # -- dequant_aggregate at N=8, ragged D -----------------------------------
    n, d_pad = 8, 2 ** 20 + 3 * 256
    orig_len = d_pad - 99
    q8 = torch.randint(-127, 128, (n, d_pad), generator=gen, device=dev,
                       dtype=torch.int8)
    s8 = torch.rand((n, d_pad // 256), generator=gen, device=dev) * 1e-2
    w8 = torch.rand((n,), generator=gen, device=dev) + 0.5
    agg_k, ssq_k = dequant_aggregate_op(q8, s8, w8, orig_len=orig_len)
    agg_p, ssq_p = dequant_aggregate_plain(q8, s8, w8, orig_len=orig_len)
    torch.cuda.synchronize()
    check(agg_k.shape == (orig_len,), "dequant_aggregate N=8: wrong shape")
    err8 = float((agg_k - agg_p).abs().max())
    check(torch.allclose(agg_k, agg_p, rtol=1e-6, atol=0.0),
          f"dequant_aggregate N=8: max abs err {err8}")
    check(rel_err(ssq_k, ssq_p) <= 1e-5,
          f"dequant_aggregate N=8: ssq {float(ssq_k)} vs {float(ssq_p)}")
    ms8 = cuda_ms(lambda: dequant_aggregate_op(q8, s8, w8, orig_len=orig_len),
                  iters=50)
    emit({"phase": "kernel", "kernel": "dequant_aggregate", "N": n,
          "D_pad": d_pad, "orig_len": orig_len, "max_abs_err": err8,
          "bit_equal": bool(torch.equal(agg_k, agg_p)),
          "ssq_rel_err": rel_err(ssq_k, ssq_p), "ms": ms8,
          "bound_ms": bound_ms(n * d_pad + 4 * n * (d_pad // 256) + 4 * n
                               + 4 * orig_len + 4, 3 * n * orig_len)})
    del q8, s8, w8, agg_k, agg_p
    rows["dequant_aggregate"]["max_abs_err"] = max(
        rows["dequant_aggregate"]["max_abs_err"], err8)

    kernel_dequant_aggregate_pods(gen, dev, rows)
    kernel_quantize_unaligned(gen, dev, rows)
    kernel_grad_aggregate(gen, dev, rows)
    kernel_reduce_unaligned_tree(dev)
    return rows


def kernel_dequant_aggregate_pods(gen, dev, rows) -> None:
    """The N > 1 decode where the kernel dominates: N = 2, 4 pods on the
    full-width embedding bucket, weights 1 as the cross-pod stage gives
    them."""
    import torch
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate_plain
    from repro_torch.kernels.ops import dequant_aggregate_op

    d = EMBED_D
    for n in (2, 4):
        q = torch.randint(-127, 128, (n, d), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((n, d // 256), generator=gen, device=dev) * 1e-3
        w = torch.ones(n, device=dev)
        agg_k, ssq_k = dequant_aggregate_op(q, s, w, orig_len=d)
        agg_p, ssq_p = dequant_aggregate_plain(q, s, w, orig_len=d)
        torch.cuda.synchronize()
        check(torch.equal(agg_k, agg_p),
              f"dequant_aggregate N={n}: agg differs from the plain version")
        check(rel_err(ssq_k, ssq_p) <= 1e-5,
              f"dequant_aggregate N={n}: ssq {float(ssq_k)} vs "
              f"{float(ssq_p)}")
        del agg_k, agg_p
        ms = cuda_ms(lambda: dequant_aggregate_op(q, s, w, orig_len=d),
                     iters=10)
        nbytes = n * d + 4 * n * (d // 256) + 4 * n + 4 * d + 4
        flops = 4 * n * d + 2 * d
        emit({"phase": "kernel", "kernel": "dequant_aggregate", "N": n,
              "D": d, "bit_equal": True, "ssq_rel_err": rel_err(ssq_k, ssq_p),
              "ms": ms, "bound_ms": bound_ms(nbytes, flops),
              "bound_by": bound_by(nbytes, flops)})
        del q, s


def kernel_quantize_unaligned(gen, dev, rows) -> None:
    """quantize on a bucket-like view that starts one float past a 16-byte
    boundary, at the embedding bucket's length: the kernel's scalar-load
    variant, bit-equal, timed beside the aligned one."""
    import torch
    from repro_torch.kernels.ops import quantize_op
    from repro_torch.kernels.quantize import quantize_plain

    d = EMBED_D
    base = torch.randn(d + 4, generator=gen, device=dev) * 1e-3
    view, aligned = base[1:1 + d], base[:d]
    check(view.data_ptr() % 16 == 4, "the view should start off alignment")
    q_k, s_k = quantize_op(view)
    q_p, s_p = quantize_plain(view)
    torch.cuda.synchronize()
    check(torch.equal(q_k, q_p) and torch.equal(s_k, s_p),
          "quantize on an unaligned view differs from the plain version")
    del q_k, s_k, q_p, s_p
    ms = cuda_ms(lambda: quantize_op(view), iters=10)
    ms_aligned = cuda_ms(lambda: quantize_op(aligned), iters=10)
    nbytes = 4 * d + d + 4 * (d // 256)
    emit({"phase": "kernel", "kernel": "quantize", "D": d, "offset_bytes": 4,
          "bit_equal": True, "ms": ms, "ms_aligned_view": ms_aligned,
          "bound_ms": bound_ms(nbytes, 5 * d),
          "bound_by": bound_by(nbytes, 5 * d)})


def kernel_grad_aggregate(gen, dev, rows) -> None:
    """grad_aggregate at N = 1, 2, 4 pods on the full-width embedding
    bucket (N=1 is what the single-card step runs) and at N=3 on a ragged
    D in f32 and bf16; agg bit-equal to the plain row loop, ssq within
    rtol 1e-5.  The library yardstick is ``w @ u`` (cuBLAS gemv): the agg
    alone, without the norm."""
    import torch
    from repro_torch.kernels.grad_aggregate import grad_aggregate_plain
    from repro_torch.kernels.ops import grad_aggregate_op

    d = EMBED_D
    for n in (1, 2, 4):
        u = torch.randn((n, d), generator=gen, device=dev) * 1e-3
        w = (torch.ones(n, device=dev) if n == 1 else
             torch.rand(n, generator=gen, device=dev) + 0.5)
        agg_k, ssq_k = grad_aggregate_op(u, w)
        agg_p, ssq_p = grad_aggregate_plain(u, w)
        torch.cuda.synchronize()
        check(torch.equal(agg_k, agg_p),
              f"grad_aggregate N={n}: agg differs from the plain version")
        check(rel_err(ssq_k, ssq_p) <= 1e-5,
              f"grad_aggregate N={n}: ssq {float(ssq_k)} vs {float(ssq_p)}")
        err = float((agg_k - agg_p).abs().max())
        del agg_k, agg_p
        ms = cuda_ms(lambda: grad_aggregate_op(u, w), iters=10)
        plain_ms = cuda_ms(lambda: grad_aggregate_plain(u, w), iters=3,
                           warmup=1)
        library_ms = cuda_ms(lambda: w @ u, iters=10)
        nbytes = 4 * n * d + 4 * n + 4 * d + 4 * -(-d // 1024)
        flops = 2 * n * d + 2 * d
        row = dict(name="grad_aggregate", route="cuda",
                   source="src/repro_torch/csrc/grad_aggregate.cu",
                   replaces="src/repro/kernels/grad_aggregate.py:45",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms(nbytes, flops),
                   bound_by=bound_by(nbytes, flops), library_ms=library_ms)
        emit({"phase": "kernel", "kernel": "grad_aggregate", "N": n, "D": d,
              "dtype": "float32", "bit_equal": True,
              "ssq_rel_err": rel_err(ssq_k, ssq_p),
              "library": "w @ u (agg only, no norm)", **row})
        if n == 1:                      # the shape the single-card step runs
            rows["grad_aggregate"] = row
        del u, w

    n, d = 3, 2 ** 20 + 99
    for dtype in (torch.float32, torch.bfloat16):
        u = (torch.randn((n, d), generator=gen, device=dev)).to(dtype)
        w = torch.rand(n, generator=gen, device=dev) + 0.5
        agg_k, ssq_k = grad_aggregate_op(u, w)
        agg_p, ssq_p = grad_aggregate_plain(u, w)
        torch.cuda.synchronize()
        check(agg_k.dtype == dtype and torch.equal(agg_k, agg_p),
              f"grad_aggregate N=3 ragged {dtype}: agg differs")
        check(rel_err(ssq_k, ssq_p) <= 1e-5,
              f"grad_aggregate N=3 ragged {dtype}: ssq differs")
        emit({"phase": "kernel", "kernel": "grad_aggregate", "N": n, "D": d,
              "dtype": str(dtype).removeprefix("torch."), "bit_equal": True,
              "ssq_rel_err": rel_err(ssq_k, ssq_p)})


def kernel_reduce_unaligned_tree(dev) -> None:
    """One compressed mlfabric_grad_reduce of ``{a: [5], b: [256]}`` with
    1 KiB buckets on a world of one: bucket [b] reaches quantize as a view
    20 bytes into the flat buffer, with no pad.  The card must match the
    CPU bit for bit."""
    import torch
    from repro_torch.dist.collectives import mlfabric_grad_reduce
    from repro_torch.launch import make_host_mesh, make_mesh

    mesh_card = make_host_mesh(device=dev)
    mesh_cpu = make_mesh((1, 1), ("pod", "data"), device="cpu")
    g = torch.Generator().manual_seed(5)
    tree = {"a": torch.randn(5, generator=g), "b": torch.randn(256,
                                                              generator=g)}
    kw = dict(intra_axis="data", inter_axis="pod", compress_inter=True,
              bucket_bytes=1024)
    before = ops_launches()
    card = mlfabric_grad_reduce({k: v.to(dev) for k, v in tree.items()},
                                mesh=mesh_card, **kw)
    launched = {k: v - before[k] for k, v in ops_launches().items()}
    cpu = mlfabric_grad_reduce(tree, mesh=mesh_cpu, **kw)
    torch.cuda.synchronize()
    check(launched["quantize"] == 2 and launched["dequant_aggregate"] == 2,
          f"unaligned-tree reduce launched {launched}")
    for k in tree:
        check(torch.equal(card[k].cpu(), cpu[k]),
              f"unaligned-tree reduce: leaf {k} differs card vs CPU")
    emit({"phase": "kernel", "kernel": "mlfabric_grad_reduce",
          "tree": {"a": 5, "b": 256}, "bucket_bytes": 1024,
          "compress_inter": True, "launches": launched,
          "card_equals_cpu": True})


def _reduced_run(device: str, init_np, steps: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import C2, N_STATIC, mb
    from repro_torch.data import SyntheticLM
    from repro_torch.interop import to_torch
    from repro_torch.models import build_model
    from repro_torch.ps import AsyncTrainer

    cfg = get_config(FULL_ARCH).reduced()
    model = build_model(cfg, dtype=torch.float32, device=device)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)

    def to_dev(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def data_fn(worker, t):
        return to_dev(src.batch(int(worker.removeprefix("worker")) * 997 + t,
                                4))

    eval_batch = to_dev(src.batch(12345, 8))

    def eval_fn(params):
        with torch.no_grad():
            return model.loss_fn(params, eval_batch)[0]

    params = to_torch(init_np, dtype=torch.float32, device=device)
    tr = AsyncTrainer(params, model.loss_fn, data_fn, n_workers=4, tau_max=8,
                      base_lr=0.5, gamma=0.0, delay_adaptive=False,
                      update_size=mb(10), compute_time=0.05, straggler=C2,
                      bandwidth=N_STATIC, aggregators=2, eval_fn=eval_fn,
                      has_aux=True, seed=0, compress=True, device=device)
    return tr.run(until_commits=steps)


def phase_reduced_parity():
    """The reduced slice on the card (kernels) against the CPU (plain
    versions) from the same params: the same schedule, and eval losses
    within ``REDUCED_LOSS_RTOL``.  The kernels match their plain versions
    bit for bit, but f32 matmuls on the card sum in another order than on
    the CPU, and where such a last-bit difference meets a rounding tie of
    the int8 quantizer it becomes a whole quantization step; training
    amplifies those steps commit by commit (on an H100 80GB HBM3: 9.5e-7
    apart after 10 commits, 1.03e-3 after 20), so the check stops at 10."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import to_numpy
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg = get_config(FULL_ARCH).reduced()
    init = to_numpy(build_model(cfg, dtype=torch.float32, device="cpu")
                    .init(torch.Generator().manual_seed(0)))
    launches0 = ops.quantize_op.launches
    gpu = _reduced_run("cuda", init, REDUCED_COMMITS)
    check(ops.quantize_op.launches > launches0,
          "reduced run on the card did not launch the kernels")
    cpu = _reduced_run("cpu", init, REDUCED_COMMITS)
    check(gpu.commits == cpu.commits and gpu.drops == cpu.drops,
          f"schedules differ: {gpu.commits}/{gpu.drops} vs "
          f"{cpu.commits}/{cpu.drops}")
    diffs = [abs(a[1] - b[1]) for a, b in zip(gpu.losses, cpu.losses)]
    emit({"phase": "reduced_parity", "commits": gpu.commits,
          "losses_card": [l for _, l in gpu.losses],
          "losses_cpu": [l for _, l in cpu.losses],
          "max_abs_loss_diff": max(diffs)})
    check(len(gpu.losses) == len(cpu.losses)
          and all(d <= REDUCED_LOSS_RTOL * abs(b[1])
                  for d, b in zip(diffs, cpu.losses)),
          f"reduced slice: card and CPU losses differ by {max(diffs)}")


def full_width_trainer(dev, callbacks=(), remat: bool = False):
    """The main path's trainer: MLfabric-A over the full-width Qwen2-0.5B
    in bf16 from the port's seeded init, ``compress=True``, by default
    without the model's default ``remat``.  Returns the
    trainer and a dict of what was set up (``drawn["n"]`` counts the batches
    drawn, one per update computed)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import N_STATIC
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.ps import AsyncTrainer
    from repro_torch.tree import tree_leaves

    cfg = get_config(FULL_ARCH)
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN, seed=0)
    drawn = {"n": 0}

    def data_fn(worker, t):
        drawn["n"] += 1
        b = src.batch(int(worker.removeprefix("worker")) * 100003 + t, BATCH)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    eval_batch = {k: torch.from_numpy(v).to(dev)
                  for k, v in src.batch(12345, BATCH).items()}

    def eval_fn(p):
        with torch.no_grad():
            return model.loss_fn(p, eval_batch)[0]

    setup = {"cfg": cfg, "model": model, "drawn": drawn, "init_s": init_s,
             "params": sum(p.numel() for p in tree_leaves(params)),
             "loss_before": float(eval_fn(params)), "data_fn": data_fn}
    # no remat by default: at seq 256 x batch 2 the activations are small
    # beside the params, and in eager PyTorch a recomputed forward costs its
    # host dispatch again on a path the host already bounds
    loss_fn = functools.partial(model.loss_fn, remat=remat)
    tr = AsyncTrainer(params, loss_fn, data_fn, n_workers=4, tau_max=8,
                      base_lr=0.1, gamma=0.0, delay_adaptive=False,
                      update_size=4.0 * full_width_flat_len(),
                      bandwidth=N_STATIC, aggregators=2, eval_fn=eval_fn,
                      has_aux=True, seed=0, compress=True, device=dev,
                      callbacks=callbacks)
    return tr, setup


def phase_main_path(remat: bool = False):
    import torch
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    tr, setup = full_width_trainer(dev, remat=remat)
    cfg, drawn = setup["cfg"], setup["drawn"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    res = tr.run(until_commits=MAIN_COMMITS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"quantize": ops.quantize_op.launches,
                "dequant_aggregate": ops.dequant_aggregate_op.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [l for _, l in res.losses]
    emit({"phase": "main_path", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": setup["params"],
          "dtype": "bfloat16", "seq_len": SEQ_LEN, "batch": BATCH,
          "n_workers": 4, "remat": remat, "commits": res.commits,
          "drops": res.drops, "updates_computed": drawn["n"],
          "launches": launches, "delay_stats": res.delay_stats,
          "loss_before": setup["loss_before"], "eval_losses": losses,
          "init_s": setup["init_s"],
          "wall_s": wall, "wall_s_per_commit": wall / max(res.commits, 1),
          "max_memory_allocated": peak})
    check(res.commits >= MAIN_COMMITS, f"only {res.commits} commits")
    check(bool(losses) and all(math.isfinite(l) for l in losses),
          f"non-finite eval loss: {losses}")
    for name, n in launches.items():
        check(n == drawn["n"] and n >= res.commits,
              f"{name} launched {n} times for {drawn['n']} updates")
    return launches


# --------------------------------------------------------------------------- #
# the in-graph MLfabric step (launch/steps.py)
# --------------------------------------------------------------------------- #
class ScaleRecorder:
    """Records the scales every cross-pod int8 decode receives, for the
    bound of a compressed step: a value at a rounding tie may move by one
    int8 step of its block's scale in each pod."""

    def __enter__(self):
        from repro_torch.dist import collectives as col
        self.col, self.decode, self.calls = col, col.dequant_aggregate_op, []

        def recording(q, s, w, **kw):
            self.calls.append((s.clone(), kw["orig_len"]))
            return self.decode(q, s, w, **kw)

        col.dequant_aggregate_op = recording
        return self

    def __exit__(self, *exc):
        self.col.dequant_aggregate_op = self.decode

    def bound(self, layout, tree, mean_over: int):
        """Per element of ``tree``: the sum over pods of its block's scale,
        over ``mean_over``."""
        vecs = [(s.sum(0) / mean_over).repeat_interleave(256)[:n]
                for s, n in self.calls]
        check(len(vecs) == len(layout.buckets),
              f"{len(vecs)} decodes for {len(layout.buckets)} buckets")
        return self.col.unpack_reduced(vecs, layout, tree)


def phase_reduced_step_parity():
    """One in-graph MLfabric step of the reduced qwen2-0.5b in f32 on the
    card (kernels) and on the CPU (plain versions), from the same params
    and batch, on a ``(pod=1, data=1)`` mesh with 1 KiB buckets: loss
    within rtol 1e-5; params within rtol 1e-5 / atol 1e-7, and compressed
    within one int8 step of each block's update (``lr`` x the block's
    scale, from the CPU run) on top."""
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.collectives import plan_reduce
    from repro_torch.launch import build_step, make_host_mesh, make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda", 0)
    cfg = get_config(FULL_ARCH).reduced()
    params = build_model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=32,
                                global_batch=4)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg.vocab_size, 32, seed=0).batch(0, 4).items()}
    meshes = {"card": make_host_mesh(device=dev),
              "cpu": make_mesh((1, 1), ("pod", "data"), device="cpu")}
    inputs = {"cpu": params,
              "card": tree_map(lambda p: p.to(dev), params)}
    layout = plan_reduce(params, bucket_bytes=1024)
    padded = sum(1 for n in layout.bucket_sizes if n % 256)
    for name, kw in {"mlfabric": {}, "compressed": {"compress_inter": True},
                     "overlap2": {"overlap_chunks": 2}}.items():
        out = {}
        for where in ("card", "cpu"):
            step = build_step(cfg, shape, meshes[where], grad_path="mlfabric",
                              lr=REDUCED_STEP_LR, bucket_bytes=1024, **kw)
            zero_launches()
            with ScaleRecorder() as rec:
                p2, _, m = step.fn(inputs[where],
                                   momentum_sgd_init(inputs[where]), batch)
            out[where] = (tree_leaves(p2), float(m["loss"]), ops_launches(),
                          rec)
        (pk, lk, launched, _), (pc, lc, _, rec) = out["card"], out["cpu"]
        n_agg = "dequant_aggregate" if kw.get("compress_inter") else \
            "grad_aggregate"
        chunks = kw.get("overlap_chunks", 1)
        check(launched[n_agg] == len(layout.buckets) * chunks,
              f"reduced step {name}: {launched} for {len(layout.buckets)} "
              "buckets")
        check(rel_err(lk, lc) <= 1e-5, f"reduced step {name}: loss {lk} vs "
              f"{lc}")
        if kw.get("compress_inter"):
            slack = [REDUCED_STEP_LR * b for b in
                     tree_leaves(rec.bound(layout, params, 1))]
        else:
            slack = [torch.zeros_like(p) for p in pc]
        worst = 0.0
        for a, b, e in zip(pk, pc, slack):
            diff = (a.cpu() - b).abs()
            lim = e + 1e-5 * b.abs() + 1e-7
            check(bool(torch.all(diff <= lim)),
                  f"reduced step {name}: params differ by up to "
                  f"{float(diff.max())}")
            worst = max(worst, float(diff.max()))
        emit({"phase": "reduced_step_parity", "config": name,
              "buckets": len(layout.buckets), "padded_buckets": padded,
              "launches": launched, "loss_card": lk, "loss_cpu": lc,
              "max_abs_param_diff": worst})


def phase_mlfabric_step():
    """The in-graph MLfabric step on the full-width Qwen2-0.5B in bf16 at
    train_4k's seq 4096 with global batch 2 (not 256: one card's memory
    and this script's time), ``(pod=1, data=1)`` mesh, remat, 4 MiB
    buckets.  Three configurations of 1 warm-up and ``STEP_TIMED`` timed
    steps each; then one "auto" step from the same params against the
    first mlfabric step."""
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.collectives import plan_reduce
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = get_config(FULL_ARCH)
    params = build_model(cfg, dtype=torch.bfloat16, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=STEP_BATCH)
    mesh = make_host_mesh(device=dev)
    src = SyntheticLM(cfg.vocab_size, shape.seq_len, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in src.batch(i, STEP_BATCH).items()}
               for i in range(1 + STEP_TIMED)]
    n_buckets = len(plan_reduce(params, bucket_bytes=4 * 2 ** 20).buckets)
    opt0 = momentum_sgd_init(params)
    kw = dict(lr=STEP_LR, gamma=STEP_GAMMA, remat=True)
    totals = {"quantize": 0, "dequant_aggregate": 0, "grad_aggregate": 0}
    first = None
    for name, extra in {"mlfabric": {}, "compressed": {"compress_inter": True},
                        "overlap2": {"overlap_chunks": 2}}.items():
        step = build_step(cfg, shape, mesh, grad_path="mlfabric", **kw,
                          **extra)
        p, o = params, opt0
        losses, secs = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            p, o, m = step.fn(p, o, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if first is None:
                first = (p, losses[0])
        launched = ops_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        for k in totals:
            totals[k] += launched[k]
        steps = len(batches) * extra.get("overlap_chunks", 1)
        want = ({"quantize": n_buckets * steps,
                 "dequant_aggregate": n_buckets * steps, "grad_aggregate": 0}
                if extra.get("compress_inter") else
                {"quantize": 0, "dequant_aggregate": 0,
                 "grad_aggregate": n_buckets * steps})
        timed = secs[1:]
        s_step = sum(timed) / len(timed)
        emit({"phase": "mlfabric_step", "config": name, "arch": cfg.name,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "dtype": "bfloat16", "seq_len": shape.seq_len,
              "global_batch": STEP_BATCH, "mesh": mesh.shape,
              "buckets": n_buckets, "steps": len(batches), "losses": losses,
              "launches": launched, "warmup_s": secs[0], "step_s": timed,
              "s_per_step": s_step,
              "tokens_per_s": STEP_BATCH * shape.seq_len / s_step,
              "max_memory_allocated": peak})
        check(all(math.isfinite(l) for l in losses),
              f"mlfabric_step {name}: non-finite loss {losses}")
        check(launched == want, f"mlfabric_step {name}: launched {launched},"
              f" want {want}")
        del p, o, step
    auto = build_step(cfg, shape, mesh, grad_path="auto", **kw)
    pa, _, ma = auto.fn(params, opt0, batches[0])
    la = float(ma["loss"])
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(pa), tree_leaves(first[0])))
    emit({"phase": "mlfabric_step", "config": "auto_vs_mlfabric",
          "loss_auto": la, "loss_mlfabric": first[1],
          "grad_norm_auto": float(ma["grad_norm"]),
          "max_abs_param_diff": worst})
    # a smoke check at the reference test's bf16 tolerance, not a
    # correctness bound: on a world of one no reduction is exercised (the
    # 2-pod x 2-data world is held tight in phase_mlfabric_ranks)
    check(abs(la - first[1]) <= 1e-3,
          f"auto and mlfabric losses differ: {la} vs {first[1]}")
    for a, b, i in zip(tree_leaves(pa), tree_leaves(first[0]),
                       tree_leaves(params)):
        check(torch.allclose(a.float(), b.float(), rtol=3e-2, atol=3e-2),
              "auto and mlfabric params differ beyond 3e-2")
        check(bool(torch.any(b != i)) or not bool(torch.any(a != i)),
              "a leaf the auto step moved did not move under mlfabric")
    return totals


_RANKS_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from repro_torch.launch import build_step, init_rank, make_mesh
    rank, world, _ = init_rank("gloo")
    torch.cuda.set_device(0)
    import repro_torch.dist.collectives as col
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_leaves

    LR = 0.1
    mesh = make_mesh((2, 2), ("pod", "data"), device="cuda")
    cfg = get_config("qwen2-0.5b").reduced()
    params = build_model(cfg, dtype=torch.float32, device="cuda").init(
        torch.Generator().manual_seed(0))
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=32,
                                global_batch=8)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg.vocab_size, 32, seed=0).batch(0, 8).items()}

    scales = []
    decode = col.dequant_aggregate_op
    def recording(q, s, w, **kw):
        scales.append((s.clone(), kw["orig_len"]))
        return decode(q, s, w, **kw)
    col.dequant_aggregate_op = recording

    out = {}
    for name, kw in {"auto": dict(grad_path="auto"),
                     "mlfabric": dict(grad_path="mlfabric"),
                     "compressed": dict(grad_path="mlfabric",
                                        compress_inter=True,
                                        bucket_bytes=1024),
                     "overlap2": dict(grad_path="mlfabric",
                                      overlap_chunks=2)}.items():
        ops.grad_aggregate_op.launches = 0
        ops.dequant_aggregate_op.launches = 0
        scales.clear()
        p2, _, m = build_step(cfg, shape, mesh, lr=LR, **kw).fn(
            params, momentum_sgd_init(params), batch)
        out[name] = (float(m["loss"]), tree_leaves(p2),
                     {"grad_aggregate": ops.grad_aggregate_op.launches,
                      "dequant_aggregate": ops.dequant_aggregate_op.launches})
        if scales:
            # a value may move by up to one int8 step of its block's scale
            # in each pod; the step divides the sum by the world
            layout = col.plan_reduce(params, bucket_bytes=1024)
            assert len(scales) == len(layout.buckets), len(scales)
            slack = tree_leaves(col.unpack_reduced(
                [(s.sum(0) / world).repeat_interleave(256)[:n]
                 for s, n in scales], layout, params))
    la, pa, _ = out["auto"]
    p0 = tree_leaves(params)
    res = {"rank": rank, "coords": mesh.coords}
    for name in ("mlfabric", "compressed", "overlap2"):
        l, p, launched = out[name]
        # exact cases: the f32 tolerance of the CPU test against JAX; the
        # compressed case adds lr x its int8 bound
        extra = ([LR * e for e in slack] if name == "compressed"
                 else [torch.zeros_like(a) for a in pa])
        close = all(bool(torch.all((a - b).abs()
                                   <= e + 1e-6 + 1e-4 * a.abs()))
                    for a, b, e in zip(pa, p, extra))
        moved = all(bool(torch.any(b != i)) for a, b, i in zip(pa, p, p0)
                    if bool(torch.any(a != i)))
        res[name] = {"loss": l, "loss_auto": la, "launches": launched,
                     "max_abs_param_diff": max(
                         float((a - b).abs().max()) for a, b in zip(pa, p)),
                     "close": close, "moved": moved,
                     "ok": abs(l - la) <= 1e-5 * abs(la) and close and moved}
    print(json.dumps(res), flush=True)
""")


def phase_mlfabric_ranks():
    """The step on a 2-pod x 2-data world of four gloo processes sharing
    the one card (reduced qwen2-0.5b, f32): mlfabric, compressed and
    ``overlap_chunks=2`` against the auto step on every rank.  Loss within
    rtol 1e-5; params within rtol 1e-4 / atol 1e-6 (the CPU test's f32
    tolerance against JAX), plus ``lr`` x one int8 step per pod compressed;
    every leaf the auto step moved must move."""
    from repro_torch.launch import run_local_world

    src = str(Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    outs = run_local_world(_RANKS_SCRIPT, 4, env=env, timeout_s=300)
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    emit({"phase": "mlfabric_ranks", "world": "pod=2 x data=2, gloo, one card",
          "ranks": res})
    for r in res:
        for name in ("mlfabric", "compressed", "overlap2"):
            check(r[name]["ok"], f"rank {r['rank']} {name}: {r[name]}")
        check(r["mlfabric"]["launches"]["grad_aggregate"] >= 1
              and r["compressed"]["launches"]["dequant_aggregate"] >= 1,
              f"rank {r['rank']}: the kernels did not run: {r}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_reduced_parity()
    launches = phase_main_path()
    phase_reduced_step_parity()
    step_launches = phase_mlfabric_step()
    phase_mlfabric_ranks()
    import torch.distributed as dist
    dist.destroy_process_group()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    total = {k: launches.get(k, 0) + step_launches[k] for k in step_launches}
    for k, n in total.items():
        check(n > 0, f"{k} was not launched on the main paths")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "launches_by_path": {"main_path": launches,
                               "mlfabric_step": step_launches}})
    emit({"kernels": [{key: {**rows[k], "launches": total[k]}[key]
                       for key in keys}
                      for k in ("quantize", "dequant_aggregate",
                                "grad_aggregate")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
