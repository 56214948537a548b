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
   Times both with CUDA events beside the memory bound.
4. ``reduced_parity``: the reduced qwen2-0.5b slice trained on the card
   (kernels) and on the CPU (plain versions) from the same f32 params; the
   eval losses must agree.
5. ``main_path``: MLfabric-A ``AsyncTrainer(compress=True)`` training the
   full-width Qwen2-0.5B (24 layers, d 896, bf16, seeded random weights)
   for at least 8 commits.  Every eval loss must be finite and each
   kernel's launch count must equal the number of updates computed.
6. The ``{"kernels": [...]}`` summary, then ``{"ok": true, ...}`` last.

Any failed check raises, so the script exits non-zero.  It imports nothing
of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FULL_ARCH = "qwen2-0.5b"
MAIN_COMMITS = 8
SEQ_LEN, BATCH = 256, 2
REDUCED_COMMITS = 10
REDUCED_LOSS_RTOL = 1e-4


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


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


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
    rows["quantize"] = dict(
        name="quantize", route="cuda",
        source="src/repro_torch/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:38",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
        bound_by="bytes", library_ms=None)
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
    rows["dequant_aggregate"] = dict(
        name="dequant_aggregate", route="cuda",
        source="src/repro_torch/csrc/dequant_aggregate.cu",
        replaces="src/repro/kernels/dequant_aggregate.py:78",
        max_abs_err=err1, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms(nbytes), bound_by="bytes", library_ms=None)
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
                               + 4 * orig_len + 4)})
    return rows


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


def full_width_trainer(dev, callbacks=()):
    """The main path's trainer: MLfabric-A over the full-width Qwen2-0.5B
    in bf16 from the port's seeded init, ``compress=True``.  Returns the
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
    tr = AsyncTrainer(params, model.loss_fn, data_fn, n_workers=4, tau_max=8,
                      base_lr=0.1, gamma=0.0, delay_adaptive=False,
                      update_size=4.0 * full_width_flat_len(),
                      bandwidth=N_STATIC, aggregators=2, eval_fn=eval_fn,
                      has_aux=True, seed=0, compress=True, device=dev,
                      callbacks=callbacks)
    return tr, setup


def phase_main_path():
    import torch
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    tr, setup = full_width_trainer(dev)
    cfg, drawn = setup["cfg"], setup["drawn"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.quantize_op.launches = 0
    ops.dequant_aggregate_op.launches = 0
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
          "n_workers": 4, "commits": res.commits,
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_reduced_parity()
    launches = phase_main_path()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: {**rows[k], "launches": launches[k]}[key]
                       for key in keys}
                      for k in ("quantize", "dequant_aggregate")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
