#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and check them.

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
   bucket; one compressed ``mlfabric_grad_reduce`` of a tree whose
   second bucket is such a view, on the card against the CPU;
   ``switch_sum`` at N = 1, 2, 4 on the embedding bucket, on a ragged
   ``orig_len`` and at 300 members of +127, bit-equal; and
   ``scatter_aggregate`` at N = 1, 2, 4 with K = 13,624,934 top-k slots
   (25% dropped) into the embedding bucket, agg ``torch.equal``, plus a
   duplicates case within its stated bound; ``dequantize`` at the
   full-width flat update length in f32 and bf16, on a view 4 bytes off
   and with a ragged ``orig_len``, bit-equal, timed beside its plain
   version and ``torch.mul(q.view(n, 256), scales[:, None], out=...)``;
   and
   ``unfused_receive``: N = 1, 2, 8 payloads of the embedding bucket
   through ``dequantize_op`` each, stacked, then ``grad_aggregate_op``,
   bit-equal to ``dequant_aggregate_op``, both timed.
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
7. ``reduced_tier_parity``: the reduced qwen2-0.5b's f32 gradient through
   the switch, hierarchical, keep_inter and switch + keep_inter tiers on
   the card and on the CPU: ``torch.equal``.
8. ``mlfabric_step``: the in-graph MLfabric step
   (``launch.steps.build_step(..., grad_path="mlfabric")``) on the
   full-width Qwen2-0.5B in bf16 at seq 4096, global batch 2, in three
   configurations of 1 warm-up and 3 timed steps each; finite losses,
   kernel launches equal to buckets x steps (x chunks), and agreement with
   the "auto" step.
9. ``tiers_setup`` and ``tiers``: ``mlfabric_grad_reduce`` of the
   full-width gradient (one forward and backward, 494,147,456 values, 10
   buckets) with the host, switch, hierarchical, keep_inter (25% transport
   drops) and switch + keep_inter tiers, 1 warm-up and 3 timed reduces
   each: ms per reduce, launches, peak memory and exact checks; then 3
   rounds of one sender's ``ErrorFeedback`` over the embedding bucket.
10. ``kernel`` lines for ``flash_attention`` (in step 3): Qwen2-0.5B's 14/2
   heads of 64 in bf16, causal, timed at (B 2, S 4096) and at the prefill
   shape (B 1, S 32768) beside its plain version, SDPA and its bound
   (both products on the bf16 tensor cores; the earlier bound with p.v
   at the f32 rate and the kernel's own four products beside it);
   checked, untimed, at D 32 f32, 32/32 heads, not causal, a ragged S of
   4000, on [B, S, H, D] views, D 128 f32, D 32 and 128 in bf16, S of 16
   and 48, and D 96 (bf16 ragged and not causal, f32 ragged, S 48).
   Within atol 2e-5 / rtol 1e-5 in f32 and one bf16 ulp in bf16.  Timed
   too, with SDPA and the bound: phi-3-vision's D 96 (32/32 heads, B 1,
   S 4096) in bf16 and f32, and qwen2-7b's D 128 (28/4 heads, S 32768).
11. ``reduced_serve_parity``: the reduced qwen2-0.5b and stablelm-1.6b in
   f32 under the "pallas" impl, card against CPU: prefill logits and
   cache, 24 decode steps (teacher-forced, then greedy) with the
   model-dtype and the int8 cache; greedy tokens identical.
12. ``serve``: the full-width Qwen2-0.5B in bf16: a 32k prefill through
   ``build_step(prefill_32k)`` at batch 1 (24 flash launches each) against
   the "blockwise" impl; a ``decode_32k`` step at batch 128 against a
   51.5 GB cache at pos 32767 (written in place); ``launch.serve.serve``
   on 8 requests of 128 tokens, batch 4, 64 new tokens; prefill against
   teacher-forced decode on the first batch, in bf16 and in f32.
13. ``train``: the training CLI (``launch.train``) on the full-width
   Qwen2-0.5B, 4 steps at batch 8 x seq 128 with checkpoints at steps 2
   and 4 and the bounded-divergence replica; the step-4 checkpoint moved
   out, the same command resumes from step 2 and must land on the same
   step-4 params and momentum, bit for bit.  Seconds per step, save and
   restore, the replica's syncs and savings, peak memory.
14. ``pod_async``: ``PodAsyncTrainer(compress=True)`` at full width, 4
   pods of 2 local steps at seq 256 x batch 2, 8 commits: one quantize
   and one dequant_aggregate launch per pod delta, nothing else.
15. ``elastic``: an ``ElasticSession`` with the CLI's step at full width
   and a replica; a ``ServerFail`` promotes it: the replica's step and
   params, its lead as ``lost_updates``, finite losses after.
16. ``reduced_ps_parity``: the reduced qwen2-0.5b in f32 through
   ``PodAsyncTrainer`` (int8 wire and without) and ``SyncTrainer``, card
   against CPU on seeds 0-2: identical schedules, params and losses within
   the limits stated at ``PS_PARITY_LEAF_TOL``; on seed 0 the int8 wire
   done on the host must give the kernels' params bit for bit, and a
   planted round-toward-zero wire must fail the limit.
17. ``mlfabric_ranks``: the same step on a 2-pod x 2-data world of four
   gloo processes sharing the card, reduced model, against the auto step;
   then the three tiers on that world.
18. ``reduced_family_parity``: the reduced qwen2-7b, phi-3-vision (with
   patch embeddings) and granite-moe in f32, card against CPU: loss, aux
   loss, the "pallas" prefill's logits and cache and 4 decode steps.
19. ``scenario``: cell A's MLfabric-A under
   ``scenarios.paper_dynamic_cluster(4, horizon=12)`` (a leave, an
   aggregator outage, a congestion wave, a join) with a ``PhaseProfiler``:
   commits in each window, the leaver's late commits, conservation of
   updates, launches per update, the profiler's roofline bytes beside
   ``dequant_aggregate``'s time.
20. ``moe_train``: MLfabric-A on the full-width granite-moe-1b-a400m
   (1.33 B parameters, an f32 router), 8 commits: the int8 wire on the
   whole flat update, finite losses, aux losses above zero.
21. ``moe_serve``: granite's 32k prefill at batch 1 under "pallas" (24
   flash launches a prefill) against "blockwise" with the routing held
   (``RouteHold``), 8 decode steps from it, and prefill against decode at
   a drop-free capacity with the decode's routing held.
22. ``vlm_serve``: phi-3-vision's 4096-position prefill (256 stub patch
   embeddings and 3,840 tokens; flash at D 96, 32 launches) against
   "blockwise", 8 decode steps from it.
23. ``qwen2_7b_serve``: cell D's serve phase on qwen2-7b (28 flash launches
   at D 128 a prefill; decode at pos 32767 at batch 16 on a 30.1 GB cache).
24. The ``{"kernels": [...]}`` summary (seven kernels), then
   ``{"ok": true, ...}`` last.

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


KERNELS = ("quantize", "dequant_aggregate", "grad_aggregate", "switch_sum",
           "scatter_aggregate", "flash_attention", "dequantize")


def ops_launches():
    from repro_torch.kernels import ops
    return {k: getattr(ops, f"{k}_op").launches for k in KERNELS}


def zero_launches() -> None:
    from repro_torch.kernels import ops
    for k in KERNELS:
        getattr(ops, f"{k}_op").launches = 0


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
    kernel_switch_sum(gen, dev, rows)
    kernel_scatter_aggregate(gen, dev, rows)
    kernel_flash_attention(dev, rows)
    kernel_dequantize(gen, dev, rows)
    return rows


def kernel_dequantize(gen, dev, rows) -> None:
    """``dequantize`` at the full-width flat update length, f32 and bf16
    out, on a view 4 bytes into a larger payload and with a ragged
    ``orig_len``: each bit-equal to ``dequantize_plain``, timed beside its
    plain version and the one PyTorch call that computes the same
    function, ``torch.mul(q.view(n, 256), scales[:, None], out=...)``
    (int8 x f32 promotes to f32 in one kernel, which writes the f32 or bf16
    ``out``)."""
    import torch
    from repro_torch.kernels.ops import dequantize_op
    from repro_torch.kernels.quantize import dequantize, dequantize_plain

    d = full_width_flat_len()
    n = d // 256
    buf = torch.randint(-127, 128, (d + 16,), generator=gen, device=dev,
                        dtype=torch.int8)
    s = torch.rand((n,), generator=gen, device=dev) * 1e-3
    err = 0.0
    for name, q, dtype, orig_len in (
            ("f32", buf[:d], torch.float32, None),
            ("bf16", buf[:d], torch.bfloat16, None),
            ("view_4_bytes_off", buf[4:4 + d], torch.float32, None),
            ("ragged", buf[:d], torch.float32, d - 99)):
        # f32 through the op the unfused receive calls; bf16 out through
        # the kernel's wrapper, which alone takes ``dtype``
        run = ((lambda: dequantize_op(q, s, orig_len=orig_len))
               if dtype == torch.float32
               else (lambda: dequantize(q, s, dtype=dtype)[:orig_len]))
        out_k = run()
        out_p = dequantize_plain(q, s, dtype=dtype)[:orig_len]
        torch.cuda.synchronize()
        check(out_k.shape == out_p.shape and out_k.dtype == dtype,
              f"dequantize {name}: shape or dtype")
        equal = bool(torch.equal(out_k, out_p))
        e = float((out_k.float() - out_p.float()).abs().max())
        err = max(err, e)
        del out_k, out_p
        check(equal, f"dequantize {name}: differs from the plain version "
                     f"by {e}")
        out_bytes = (2 if dtype == torch.bfloat16 else 4) * d
        nbytes = d + 4 * n + out_bytes
        row = {"phase": "kernel", "kernel": "dequantize", "case": name,
               "D": d, "out": str(dtype).removeprefix("torch."),
               "orig_len": orig_len, "bit_equal": equal, "max_abs_err": e,
               "bound_ms": bound_ms(nbytes, d), "bound_by": bound_by(nbytes,
                                                                     d)}
        # the one PyTorch call: int8 x f32 promotes to f32 in one kernel,
        # which writes a bf16 ``out`` directly
        lib_out = torch.empty((n, 256), dtype=dtype, device=dev)
        row["ms"] = cuda_ms(run, iters=20)
        row["plain_ms"] = cuda_ms(
            lambda: dequantize_plain(q, s, dtype=dtype)[:orig_len], iters=3,
            warmup=1)
        row["library_ms"] = cuda_ms(
            lambda: torch.mul(q.view(n, 256), s[:, None], out=lib_out),
            iters=20)
        del lib_out
        emit(row)
        if name == "f32":
            rows["dequantize"] = dict(
                name="dequantize", route="cuda",
                source="src/repro_torch/csrc/quantize.cu",
                replaces="src/repro/kernels/quantize.py:57",
                max_abs_err=e, ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"])
    rows["dequantize"]["max_abs_err"] = err
    del buf, s
    gc.collect()
    torch.cuda.empty_cache()


UNFUSED_NS = (1, 2, 8)


def unfused_receive(q, s, w, orig_len):
    """The reference's unfused receive composition (``repro/kernels/ops.py``
    names it beside ``dequant_aggregate_op``): decode each int8 payload with
    ``dequantize_op``, stack, and sum with ``grad_aggregate_op``."""
    import torch
    from repro_torch.kernels.ops import dequantize_op, grad_aggregate_op
    deq = torch.stack([dequantize_op(q[i], s[i], orig_len=orig_len)
                       for i in range(q.shape[0])])
    return grad_aggregate_op(deq, w)


def phase_unfused_receive() -> dict:
    """N = 1, 2, 8 int8 payloads of the largest bucket (136,249,344
    values) decoded both ways: the unfused composition against the fused
    ``dequant_aggregate_op``.  Bit-equal expected: both round each product
    q * s, then each w * x, and sum the rows in order.  One untimed run of
    the composition per N is the path run (counts zeroed before, read
    after); both are then timed.  Modelled bytes: unfused 9ND + 4D
    (dequantize reads ND, writes 4ND; grad_aggregate reads 4ND, writes 4D),
    the stack copy beside it adds 8ND; fused ND + 4D (plus the scales)."""
    import torch
    from repro_torch.kernels.ops import dequant_aggregate_op

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(77)
    d = EMBED_D
    total = dict.fromkeys(KERNELS, 0)
    for n in UNFUSED_NS:
        q = torch.randint(-127, 128, (n, d), generator=gen, device=dev,
                          dtype=torch.int8)
        s = torch.rand((n, d // 256), generator=gen, device=dev) * 1e-3
        w = torch.rand((n,), generator=gen, device=dev) + 0.5
        zero_launches()
        agg_u, ssq_u = unfused_receive(q, s, w, d)
        torch.cuda.synchronize()
        launched = ops_launches()
        want = dict.fromkeys(KERNELS, 0)
        want.update(dequantize=n, grad_aggregate=1)
        check(launched == want, f"unfused receive N={n}: launches "
                                f"{launched}")
        for k in KERNELS:
            total[k] += launched[k]
        agg_f, ssq_f = dequant_aggregate_op(q, s, w, orig_len=d)
        torch.cuda.synchronize()
        equal = bool(torch.equal(agg_u, agg_f))
        gap = int((agg_u.view(torch.int32).long()
                   - agg_f.view(torch.int32).long()).abs().max())
        del agg_u, agg_f
        ms_u = cuda_ms(lambda: unfused_receive(q, s, w, d), iters=5, warmup=1)
        ms_f = cuda_ms(lambda: dequant_aggregate_op(q, s, w, orig_len=d),
                       iters=20)
        scales = 4 * n * (d // 256)
        emit({"phase": "kernel", "kernel": "unfused_receive", "N": n,
              "D": d, "bit_equal": equal, "max_ulp_gap": gap,
              "ssq_rel_err": rel_err(ssq_u, ssq_f),
              "unfused_ms": ms_u, "fused_ms": ms_f,
              "unfused_bytes_model": 9 * n * d + 4 * d + scales,
              "unfused_bytes_with_stack": 17 * n * d + 4 * d + scales,
              "fused_bytes_model": n * d + 4 * d + scales,
              "launches": launched})
        check(equal, f"unfused receive N={n}: {gap} ulps from the fused "
                     "kernel")
        check(rel_err(ssq_u, ssq_f) <= 1e-5,
              f"unfused receive N={n}: ssq {float(ssq_u)} vs {float(ssq_f)}")
        del q, s, w
        gc.collect()
        torch.cuda.empty_cache()
    return total


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


def kernel_switch_sum(gen, dev, rows) -> None:
    """switch_sum at N = 1, 2, 4 members on the full-width embedding bucket
    (N=1 is what the single-card tiers run), a ragged ``orig_len`` (the
    smallest bucket's 28,544 in a 28,672 pad) and 300 members at +127;
    bit-equal to the plain version.  Integer adds are counted against the
    f32 CUDA-core rate, the nearest entry of the card's table; bytes bind.
    The library yardstick is ``torch.sum(q[:, :orig_len], dim=0,
    dtype=torch.int32)``."""
    import torch
    from repro_torch.kernels.ops import switch_sum_op
    from repro_torch.kernels.switch_sum import switch_sum_plain

    d = EMBED_D
    for n in (1, 2, 4):
        q = torch.randint(-127, 128, (n, d), generator=gen, device=dev,
                          dtype=torch.int8)
        got = switch_sum_op(q, orig_len=d)
        want = switch_sum_plain(q, orig_len=d)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"switch_sum N={n}: differs from the plain version")
        err = float((got - want).abs().max())
        del got, want
        ms = cuda_ms(lambda: switch_sum_op(q, orig_len=d), iters=10)
        plain_ms = cuda_ms(lambda: switch_sum_plain(q, orig_len=d), iters=3,
                           warmup=1)
        library_ms = cuda_ms(lambda: torch.sum(q[:, :d], dim=0,
                                               dtype=torch.int32), iters=10)
        nbytes, ops_ = n * d + 4 * d, n * d
        row = dict(name="switch_sum", route="cuda",
                   source="src/repro_torch/csrc/switch_sum.cu",
                   replaces="src/repro/kernels/switch_sum.py:52",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms(nbytes, ops_),
                   bound_by=bound_by(nbytes, ops_), library_ms=library_ms)
        emit({"phase": "kernel", "kernel": "switch_sum", "N": n, "D_pad": d,
              "orig_len": d, "bit_equal": True,
              "library": "torch.sum(q, dim=0, dtype=int32)", **row})
        if n == 1:
            rows["switch_sum"] = row
        del q
    for n, d_pad, orig_len, fill in ((2, 28_672, 28_544, None),
                                     (300, 65_536, 65_536, 127)):
        q = (torch.full((n, d_pad), fill, dtype=torch.int8, device=dev)
             if fill is not None else
             torch.randint(-127, 128, (n, d_pad), generator=gen, device=dev,
                           dtype=torch.int8))
        got = switch_sum_op(q, orig_len=orig_len)
        want = switch_sum_plain(q, orig_len=orig_len)
        torch.cuda.synchronize()
        check(got.shape == (orig_len,) and torch.equal(got, want),
              f"switch_sum N={n} orig_len={orig_len}: differs")
        if fill is not None:
            check(int(got.min()) == int(got.max()) == n * fill,
                  f"switch_sum overflow case: {int(got.min())}")
        emit({"phase": "kernel", "kernel": "switch_sum", "N": n,
              "D_pad": d_pad, "orig_len": orig_len, "bit_equal": True,
              "fill": fill, "max": int(got.max())})


def _sparse_chunks(gen, dev, n: int, k: int, d: int):
    """n senders' chunks as the sparse stage builds them: idx from the
    |.|-top-k of a random vector, 25% of the slots dropped (-1), random
    int8 values and scales, weights 1."""
    import torch
    from repro_torch.dist.flatbuf import topk_sparsify

    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    for i in range(n):
        idx[i] = topk_sparsify(torch.randn(d, generator=gen, device=dev),
                               k)[0]
    idx[torch.rand((n, k), generator=gen, device=dev) < 0.25] = -1
    q = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
    return idx, q, s, torch.ones(n, device=dev)


def kernel_scatter_aggregate(gen, dev, rows) -> None:
    """scatter_aggregate at N = 1, 2, 4 pods with K = 13,624,934 slots
    (keep 0.1 of the embedding bucket) into d_out = 136,249,344: agg
    ``torch.equal`` to the plain version (distinct indices per sender),
    sum of squares rtol 1e-5; and a duplicates case, whose atomic adds
    meet in a varying order: within 2 m 2^-24 sum|v| per column for m
    adds.  The library yardstick ``index_put_(accumulate=True)`` of the
    live slots' values into a zeroed buffer gives agg only (no norm)."""
    import torch
    from repro_torch.kernels.ops import scatter_aggregate_op
    from repro_torch.kernels.scatter_aggregate import scatter_aggregate_plain

    d = EMBED_D
    k = int(round(0.1 * d))
    for n in (1, 2, 4):
        idx, q, s, w = _sparse_chunks(gen, dev, n, k, d)
        agg_k, ssq_k = scatter_aggregate_op(idx, q, s, w, d_out=d)
        agg_p, ssq_p = scatter_aggregate_plain(idx, q, s, w, d_out=d)
        torch.cuda.synchronize()
        check(torch.equal(agg_k, agg_p),
              f"scatter_aggregate N={n}: agg differs from the plain version")
        check(rel_err(ssq_k, ssq_p) <= 1e-5,
              f"scatter_aggregate N={n}: ssq {float(ssq_k)} vs "
              f"{float(ssq_p)}")
        err = float((agg_k - agg_p).abs().max())
        live = idx >= 0
        n_live = int(live.sum())
        del agg_k, agg_p
        ms = cuda_ms(lambda: scatter_aggregate_op(idx, q, s, w, d_out=d),
                     iters=10)
        plain_ms = cuda_ms(lambda: scatter_aggregate_plain(idx, q, s, w,
                                                           d_out=d),
                           iters=3, warmup=1)
        pos = idx[live].to(torch.int64)
        vals = (q.to(torch.float32) * (s * w)[:, None])[live]
        out = torch.zeros(d, device=dev)
        library_ms = cuda_ms(lambda: out.index_put_((pos,), vals,
                                                    accumulate=True),
                             iters=10)
        del pos, vals, out
        nbytes = 5 * n * k + 8 * n + 4 * d
        ops_ = 2 * n_live + 2 * d
        row = dict(name="scatter_aggregate", route="cuda",
                   source="src/repro_torch/csrc/scatter_aggregate.cu",
                   replaces="src/repro/kernels/scatter_aggregate.py:82",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms(nbytes, ops_),
                   bound_by=bound_by(nbytes, ops_), library_ms=library_ms)
        emit({"phase": "kernel", "kernel": "scatter_aggregate", "N": n,
              "K": k, "d_out": d, "live_slots": n_live, "bit_equal": True,
              "ssq_rel_err": rel_err(ssq_k, ssq_p),
              "library": "index_put_(accumulate=True) of the live slots "
                         "(agg only, no zero fill, no norm)", **row})
        if n == 1:
            rows["scatter_aggregate"] = row
        del idx, q, s, w

    n, k, d = 2, 2 ** 20, 2 ** 16
    idx = torch.randint(0, d, (n, k), generator=gen, device=dev,
                        dtype=torch.int32)
    q = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand(n, generator=gen, device=dev) + 0.5
    w = torch.rand(n, generator=gen, device=dev) + 0.5
    agg_k, ssq_k = scatter_aggregate_op(idx, q, s, w, d_out=d)
    agg_p, ssq_p = scatter_aggregate_plain(idx, q, s, w, d_out=d)
    v = (q.to(torch.float64) * (s * w).to(torch.float64)[:, None]).abs()
    absum = torch.zeros(d, dtype=torch.float64, device=dev).index_add_(
        0, idx.ravel().to(torch.int64), v.ravel())
    m = int(torch.bincount(idx.ravel().to(torch.int64), minlength=d).max())
    diff = (agg_k - agg_p).abs().to(torch.float64)
    check(bool(torch.all(diff <= 2 * m * 2.0 ** -24 * absum)),
          f"scatter_aggregate duplicates: max abs err {float(diff.max())}")
    check(rel_err(ssq_k, ssq_p) <= 1e-5, "scatter_aggregate duplicates: ssq")
    emit({"phase": "kernel", "kernel": "scatter_aggregate", "N": n, "K": k,
          "d_out": d, "duplicates_per_column_max": m,
          "bit_equal": bool(torch.equal(agg_k, agg_p)),
          "max_abs_err": float(diff.max()),
          "ssq_rel_err": rel_err(ssq_k, ssq_p)})


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


def full_width_trainer(dev, callbacks=(), remat: bool = False,
                       arch: str = FULL_ARCH, scenario=None):
    """The main path's trainer: MLfabric-A over the full-width ``arch``
    (Qwen2-0.5B by default) in bf16 from the port's seeded init,
    ``compress=True``, by default without the model's default ``remat``,
    under ``scenario`` if one is given.  Returns the trainer and a dict of
    what was set up (``drawn["n"]`` counts the batches drawn, one per
    update computed; ``aux`` the aux loss of each update's forward)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import N_STATIC
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.flatbuf import padded_size
    from repro_torch.models import build_model
    from repro_torch.ps import AsyncTrainer
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
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

    flat_len = padded_size([p.numel() for p in tree_leaves(params)])
    setup = {"cfg": cfg, "model": model, "drawn": drawn, "init_s": init_s,
             "params": sum(p.numel() for p in tree_leaves(params)),
             "flat_len": flat_len, "aux": [],
             "loss_before": float(eval_fn(params)), "data_fn": data_fn,
             "eval_batch": eval_batch}

    # no remat by default: at seq 256 x batch 2 the activations are small
    # beside the params, and in eager PyTorch a recomputed forward costs its
    # host dispatch again on a path the host already bounds
    def loss_fn(p, batch):
        out = model.loss_fn(p, batch, remat=remat)
        setup["aux"].append(out[1]["aux_loss"].detach())
        return out

    tr = AsyncTrainer(params, loss_fn, data_fn, n_workers=4, tau_max=8,
                      base_lr=0.1, gamma=0.0, delay_adaptive=False,
                      update_size=4.0 * flat_len,
                      bandwidth=N_STATIC, aggregators=2, eval_fn=eval_fn,
                      has_aux=True, seed=0, compress=True, device=dev,
                      callbacks=callbacks, scenario=scenario)
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
    totals = dict.fromkeys(KERNELS, 0)
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
        want = dict.fromkeys(KERNELS, 0)
        if extra.get("compress_inter"):
            want.update(quantize=n_buckets * steps,
                        dequant_aggregate=n_buckets * steps)
        else:
            want["grad_aggregate"] = n_buckets * steps
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


# --------------------------------------------------------------------------- #
# the switch and bounded-loss tiers (dist/collectives.py, flatbuf.py)
# --------------------------------------------------------------------------- #
TIER_KEEP = 0.1
TIER_DROP = 0.25
TIER_TIMED = 3
TIERS = {"host": {}, "switch": {"backend": "switch"},
         "hierarchical": {"backend": "hierarchical"},
         "keep": {"keep_inter": TIER_KEEP, "drop_mask_inter": "loss"},
         "switch_keep": {"backend": "switch", "keep_inter": TIER_KEEP}}


def tier_drop_fn():
    """``k -> mask`` from ``loss_drop_mask`` on a LossSchedule whose pod0
    uplink drops ``TIER_DROP`` of its bytes: ``round(0.25 k)`` slots."""
    import functools
    from repro_torch.core.network import LossSchedule
    from repro_torch.dist.collectives import loss_drop_mask

    sched = LossSchedule()
    sched.set_drop("pod0", 0.0, TIER_DROP, direction="up")
    return functools.partial(loss_drop_mask, sched, "pod0", "pod1", 0.0)


def tier_kwargs(name: str, masks=None) -> dict:
    """The reduce's keywords for tier ``name``; ``masks`` (a list) records
    every drop mask handed out, in bucket order."""
    kw = dict(TIERS[name])
    masks = [] if masks is None else masks
    if kw.get("drop_mask_inter") == "loss":
        drop = tier_drop_fn()

        def recording(k):
            masks.append(drop(k))
            return masks[-1]

        kw["drop_mask_inter"] = recording
    return kw


def tier_launches(name: str, n_buckets: int) -> dict:
    """Kernel launches of one reduce of tier ``name`` on a (pod=1, data=1)
    mesh: every non-host backend runs the switch sum on every bucket, and
    the cross-pod stage runs its kernel at N=1."""
    want = dict.fromkeys(KERNELS, 0)
    kw = TIERS[name]
    if kw.get("backend", "host") != "host":
        want["switch_sum"] = n_buckets
    if "keep_inter" in kw:
        want["scatter_aggregate"] = n_buckets
    elif kw.get("backend") == "hierarchical":
        want["quantize"] = want["dequant_aggregate"] = n_buckets
    else:
        want["grad_aggregate"] = n_buckets
    return want


def grid_error(g, o, scale):
    """(|o - g|, its limit) in f64, per element: an int8 grid value times
    its shared ``scale`` lies within half a scale of ``g``, plus the
    rounding of the quotient ``g / scale`` (under one ulp of g) and of the
    product ``q * scale`` (half an ulp of o): two ulps of the larger."""
    import torch
    big = torch.maximum(g.abs(), o.abs())
    ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
    err = (o.to(torch.float64) - g.to(torch.float64)).abs()
    return err, 0.5 * float(scale) + 2.0 * ulp.to(torch.float64)


def full_width_grads(dev):
    """One forward and backward of the full-width bf16 Qwen2-0.5B from the
    port's seeded init on a SyntheticLM batch (seq 256 x batch 2), as an
    f32 tree: the reduce packs to f32 anyway, and f32 leaves keep the
    checks free of a bf16 rounding of the result."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model, value_and_grad
    from repro_torch.models.transformer import loss_fn
    from repro_torch.tree import tree_map

    cfg = get_config(FULL_ARCH)
    params = build_model(cfg, dtype=torch.bfloat16, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        cfg.vocab_size, SEQ_LEN, seed=0).batch(0, BATCH).items()}
    (_, metrics), grads = value_and_grad(
        functools.partial(loss_fn, cfg=cfg, remat=False), params, batch,
        has_aux=True)
    del params
    out = tree_map(lambda g: g.to(torch.float32), grads)
    del grads
    return out, float(metrics["loss"].detach())


def phase_tiers():
    """The switch and bounded-loss tiers on the full-width gradient
    (494,147,456 values, 10 buckets of 4 MiB) on the (pod=1, data=1) mesh:
    host (the baseline), switch, hierarchical, keep_inter 0.1 with 25%
    transport drops from ``loss_drop_mask``, and switch + keep_inter; 1
    warm-up and ``TIER_TIMED`` timed reduces each.  Checks that hold
    exactly: host equal to the gradient; switch within half its bucket's
    shared scale of the gradient plus two ulps (``grid_error``); keep
    nonzero only at undropped top-k indices, each within that, with
    round(0.25 k) drops per bucket; everything finite.  Then 3 rounds of one sender's ErrorFeedback over the
    embedding bucket with the same drops and bound 0.5 ||g||."""
    import torch
    from repro_torch.dist.collectives import mlfabric_grad_reduce, plan_reduce
    from repro_torch.dist.flatbuf import bucket_slice, pack_leaves
    from repro_torch.launch import make_host_mesh
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    grads, loss = full_width_grads(dev)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    n_values = sum(g.numel() for g in tree_leaves(grads))
    mesh = make_host_mesh(device=dev)
    layout = plan_reduce(grads, bucket_bytes=4 * 2 ** 20)
    n_buckets = len(layout.buckets)
    flat_g = pack_leaves(tree_leaves(grads))
    inv = torch.full((), 1.0 / 127.0, dtype=torch.float32, device=dev)
    shared = [torch.clamp_min(bucket_slice(flat_g, layout, b).abs().max()
                              * inv, 1e-30) for b in range(n_buckets)]
    emit({"phase": "tiers_setup", "arch": FULL_ARCH, "values": n_values,
          "leaves": len(tree_leaves(grads)), "loss": loss,
          "grad_s": grad_s, "buckets": list(layout.bucket_sizes)})
    totals = dict.fromkeys(KERNELS, 0)
    for name in TIERS:
        masks = []
        kw = tier_kwargs(name, masks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        secs = []
        for _ in range(1 + TIER_TIMED):
            masks.clear()
            t0 = time.perf_counter()
            out = mlfabric_grad_reduce(grads, mesh=mesh, inter_axis="pod",
                                       **kw)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launched = ops_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        for k in totals:
            totals[k] += launched[k]
        want = {k: v * (1 + TIER_TIMED)
                for k, v in tier_launches(name, n_buckets).items()}
        flat_o = pack_leaves(tree_leaves(out))
        del out
        checks = {"finite": bool(torch.isfinite(flat_o).all())}
        check(checks["finite"], f"tiers {name}: non-finite result")
        if name == "host":
            # one pod, one member: the aggregate of one row is the row
            checks["equals_gradient"] = bool(torch.equal(flat_o, flat_g))
            check(checks["equals_gradient"], "tiers host: result is not g")
        if name == "switch":
            worst = 0.0
            for b in range(n_buckets):
                g = bucket_slice(flat_g, layout, b)
                o = bucket_slice(flat_o, layout, b)
                err, lim = grid_error(g, o, shared[b])
                check(bool(torch.all(err <= lim)),
                      f"tiers switch bucket {b}: off the int8 grid by "
                      f"{float((err - lim).max())}")
                worst = max(worst, float((err / float(shared[b])).max()))
                del err, lim
            checks["max_err_in_scales"] = worst
        if name == "keep":
            check(len(masks) == n_buckets, f"{len(masks)} drop masks")
            drops = []
            for b in range(n_buckets):
                g = bucket_slice(flat_g, layout, b)
                o = bucket_slice(flat_o, layout, b)
                d = g.shape[0]
                k = max(1, min(d, int(round(TIER_KEEP * d))))
                mask = torch.as_tensor(masks[b], device=dev)
                check(mask.shape == (k,) and
                      int(mask.sum()) == int(round(TIER_DROP * k)),
                      f"tiers keep bucket {b}: {int(mask.sum())} drops of "
                      f"{k}")
                drops.append(int(mask.sum()))
                order = torch.sort(g.abs(), descending=True,
                                   stable=True)[1][:k]
                alive = torch.zeros(d, dtype=torch.bool, device=dev)
                alive[order[~mask]] = True
                check(not bool(torch.any((o != 0) & ~alive)),
                      f"tiers keep bucket {b}: a nonzero outside the "
                      "undropped top-k")
                err, lim = grid_error(g, o, shared[b])
                check(bool(torch.all((err <= lim) | ~alive)),
                      f"tiers keep bucket {b}: off the int8 grid")
                del err, lim
            checks["drops"] = drops
        timed = secs[1:]
        emit({"phase": "tiers", "config": name, "kw": TIERS[name],
              "buckets": n_buckets, "reduces": len(secs),
              "launches": launched, "warmup_s": secs[0], "reduce_s": timed,
              "ms_per_reduce": 1e3 * sum(timed) / len(timed),
              "max_memory_allocated": peak, "checks": checks})
        check(launched == want, f"tiers {name}: launched {launched}, want "
              f"{want}")
        del flat_o
    tier_error_feedback(flat_g, layout, dev)
    del grads, flat_g
    return totals


def tier_error_feedback(flat_g, layout, dev) -> None:
    """3 rounds of one sender's ErrorFeedback (keep 0.1) over the embedding
    bucket, drops from the tiers' LossSchedule, bound 0.5 ||g||: the
    residual within the bound after every round, and delivered plus
    residual equal to the inputs at tests/test_loss_tolerant.py's
    tolerance."""
    import torch
    from repro_torch.dist.flatbuf import ErrorFeedback, bucket_slice

    b = layout.bucket_sizes.index(EMBED_D)
    g = bucket_slice(flat_g, layout, b)
    ef = ErrorFeedback(EMBED_D, device=dev)
    bound = 0.5 * float(g.norm())
    drop = tier_drop_fn()
    k = max(1, min(EMBED_D, int(round(TIER_KEEP * EMBED_D))))
    total_in = torch.zeros(EMBED_D, dtype=torch.float64, device=dev)
    total_out = torch.zeros_like(total_in)
    rounds = []
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk, delivered = ef.compress(g, keep=TIER_KEEP, bound=bound,
                                       drop_mask=drop(k))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        total_in += g.to(torch.float64)
        total_out += delivered.to(torch.float64)
        resid = float(ef.residual.norm())
        check(resid <= bound * (1 + 1e-4),
              f"error feedback round {r}: residual {resid} > {bound}")
        rounds.append({"s": secs, "residual_norm": resid,
                       "flushed": chunk.flushed,
                       "dropped": int((chunk.idx < 0).sum())})
    gap = total_in - (total_out + ef.residual.to(torch.float64))
    lim = 1e-3 * max(1.0, float(total_in.abs().max()))
    emit({"phase": "tiers", "config": "error_feedback", "D": EMBED_D,
          "k": k, "bound": bound, "rounds": rounds,
          "flushed_total": ef.flushed_total,
          "max_abs_gap": float(gap.abs().max()), "gap_limit": lim})
    check(float(gap.abs().max()) <= lim,
          f"error feedback: delivered + residual off by {float(gap.abs().max())}")


def phase_reduced_tier_parity():
    """The reduced qwen2-0.5b's f32 gradient (one forward and backward on
    the CPU) reduced through the four non-host tiers with 1 KiB buckets on
    the card (kernels) and on the CPU (plain versions), from the same
    tensor: ``torch.equal``, since integer sums are exact, the tie rule is
    fixed, the quantizers are bit-equal and the scatter adds one value per
    column."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.collectives import mlfabric_grad_reduce, plan_reduce
    from repro_torch.launch import make_host_mesh, make_mesh
    from repro_torch.models import build_model, value_and_grad
    from repro_torch.models.transformer import loss_fn
    from repro_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda", 0)
    cfg = get_config(FULL_ARCH).reduced()
    params = build_model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg.vocab_size, 32, seed=0).batch(0, 4).items()}
    _, grads = value_and_grad(functools.partial(loss_fn, cfg=cfg,
                                                remat=False),
                              params, batch, has_aux=True)
    meshes = {"card": make_host_mesh(device=dev),
              "cpu": make_mesh((1, 1), ("pod", "data"), device="cpu")}
    inputs = {"cpu": grads, "card": tree_map(lambda g: g.to(dev), grads)}
    n_buckets = len(plan_reduce(grads, bucket_bytes=1024).buckets)
    for name in ("switch", "hierarchical", "keep", "switch_keep"):
        out = {}
        for where in ("card", "cpu"):
            zero_launches()
            out[where] = (tree_leaves(mlfabric_grad_reduce(
                inputs[where], mesh=meshes[where], inter_axis="pod",
                bucket_bytes=1024, **tier_kwargs(name))), ops_launches())
        (card, launched), (cpu, _) = out["card"], out["cpu"]
        equal = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
        worst = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(card, cpu))
        emit({"phase": "reduced_tier_parity", "config": name,
              "buckets": n_buckets, "launches": launched,
              "card_equals_cpu": equal, "max_abs_diff": worst})
        check(launched == tier_launches(name, n_buckets),
              f"reduced tier {name}: launched {launched}")
        check(equal, f"reduced tier {name}: card and CPU differ by {worst}")


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

    # the switch and bounded-loss tiers on this world: the gradients of
    # tests/test_dist_path.py's collectives check, one row per rank; the
    # kernels run at N=2 (members of a pod, pods)
    import functools, hashlib
    import numpy as np
    from repro_torch.core.network import LossSchedule
    rng = np.random.default_rng(0)
    g_all = {k: rng.normal(size=(world,) + s).astype(np.float32)
             for k, s in (("w1", (33, 7)), ("w2", (512,)), ("bias", (5,)),
                          ("big", (3000,)))}
    mine = {k: torch.from_numpy(v[rank].copy()).cuda()
            for k, v in g_all.items()}
    sched = LossSchedule()
    sched.set_drop("pod0", 0.0, 0.25, direction="up")
    drop = functools.partial(col.loss_drop_mask, sched, "pod0", "pod1", 0.0)
    rows_seen = []
    for op in ("switch_sum_op", "scatter_aggregate_op"):
        def rec(*a, _orig=getattr(col, op), _op=op, **kw):
            rows_seen.append((_op, int(a[0].shape[0])))
            return _orig(*a, **kw)
        setattr(col, op, rec)
    res["tiers"] = {}
    for name, kw in {"switch": dict(backend="switch"),
                     "hierarchical": dict(backend="hierarchical"),
                     "keep": dict(keep_inter=0.1,
                                  drop_mask_inter=drop)}.items():
        rows_seen.clear()
        ops.switch_sum_op.launches = 0
        ops.scatter_aggregate_op.launches = 0
        got = col.mlfabric_grad_reduce(mine, mesh=mesh, inter_axis="pod",
                                       mean_over=world, **kw)
        got = {k: v.cpu().numpy() for k, v in got.items()}
        flat = np.concatenate([got[k].ravel() for k in sorted(got)])
        err = {k: float(np.abs(got[k] - g_all[k].mean(0)).max())
               for k in got}
        res["tiers"][name] = {
            "sha256": hashlib.sha256(flat.tobytes()).hexdigest(),
            "finite": bool(np.isfinite(flat).all()),
            "max_abs_err_vs_mean": max(err.values()),
            "within_5e-2": all(bool(np.all(
                np.abs(got[k] - g_all[k].mean(0))
                <= 5e-2 + 5e-2 * np.abs(g_all[k].mean(0)))) for k in got),
            "launches": {"switch_sum": ops.switch_sum_op.launches,
                         "scatter_aggregate":
                             ops.scatter_aggregate_op.launches},
            "rows": sorted(set(rows_seen))}
    print(json.dumps(res), flush=True)
""")


def phase_mlfabric_ranks():
    """The step on a 2-pod x 2-data world of four gloo processes sharing
    the one card (reduced qwen2-0.5b, f32): mlfabric, compressed and
    ``overlap_chunks=2`` against the auto step on every rank.  Loss within
    rtol 1e-5; params within rtol 1e-4 / atol 1e-6 (the CPU test's f32
    tolerance against JAX), plus ``lr`` x one int8 step per pod compressed;
    every leaf the auto step moved must move.  Then ``mlfabric_grad_reduce``
    with the switch, hierarchical and keep_inter tiers on the same world:
    every rank the same result, switch and hierarchical within the CPU
    test's 5e-2 of the numpy mean, and switch_sum and scatter_aggregate
    launched at N=2 on every rank."""
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
        t = r["tiers"]
        for name in t:
            check(t[name]["finite"], f"rank {r['rank']} tier {name}")
            check(t[name]["sha256"] == res[0]["tiers"][name]["sha256"],
                  f"tier {name}: rank {r['rank']} differs from rank 0")
        for name in ("switch", "hierarchical"):
            check(t[name]["within_5e-2"],
                  f"rank {r['rank']} tier {name}: {t[name]}")
            check(t[name]["launches"]["switch_sum"] >= 1
                  and t[name]["rows"] == [["switch_sum_op", 2]],
                  f"rank {r['rank']} tier {name}: switch_sum at N=2 did "
                  f"not run: {t[name]}")
        check(t["keep"]["launches"]["scatter_aggregate"] >= 1
              and t["keep"]["rows"] == [["scatter_aggregate_op", 2]],
              f"rank {r['rank']}: scatter_aggregate at N=2 did not run")


# --------------------------------------------------------------------------- #
# serving (slice 5): the flash-attention kernel, prefill, decode, serve()
# --------------------------------------------------------------------------- #
BF16_TC_FLOPS = 989e12           # H100 SXM bf16 dense, tensor cores
ATTN_HEADS, ATTN_KV_HEADS, ATTN_D = 14, 2, 64    # Qwen2-0.5B
PREFILL_BATCH = 1                # prefill_32k's global batch 32, cut to 1
PREFILL_TIMED = 2
DECODE_TIMED = 3
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 4, 128, 64
SERVE_PARITY_PREFILL = 32          # a multiple of 16: the flash kernel's
SERVE_PARITY_PROMPT, SERVE_PARITY_NEW = 16, 9      # 24 decode steps
# two bf16 paths through 24 layers: twice the largest sound reading of
# scripts/serve_tolerance.py over 6 seeds (3.9% / 5.4%), below what a
# causal mask one key off (88% / 132%) and float8 q, k, v (16% / 24%) read;
# qwen2-7b (28 layers) is inside the same rule: sound up to 4.0% / 5.1%,
# float8 17.4% / 24.0%, the mask 85.6% / 126%
BF16_PREFILL_TOL = 8e-2          # the 32k prefill, "pallas" vs "blockwise"
BF16_CACHE_TOL = 2e-1            # the prefill vs the decode-built cache
F32_REL_TOL = 1e-3               # two f32 paths through 24 layers
# phi-3-vision-4.2b's own, by the same rule: its 4096-position prefill
# with patch embeddings (32 layers, D 96) reads up to 4.9% sound, float8
# 13.8%, the mask 32.4%
VLM_PREFILL_TOL = 1e-1           # its prefill, "pallas" vs "blockwise"
# granite-moe-1b-a400m's own bf16 limits, by the same rule (twice the
# largest sound reading of scripts/serve_tolerance.py over 6 seeds, below
# what a mask one key off and float8 q, k, v read), with the routing held
# (RouteHold): sound up to 11.4% / 12.9%, float8 39.9% / 55.6%, the mask
# 83.9% / 130%.  Free-running routing reads as much as those faults
MOE_PREFILL_TOL = 2.3e-1         # its 32k prefill, "pallas" vs "blockwise"
MOE_CACHE_TOL = 2.6e-1           # its prefill vs the decode-built cache


def attn_work(b: int, h: int, kvh: int, s: int, d: int, causal: bool):
    """(bytes, flops) of one bf16 attention call: q, k, v read once and the
    output written once; ``flops`` is what each of the two products (q.k^T
    and p.v) does over the unmasked (q, k) pairs."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return (2 * b * s * d * (2 * h + 2 * kvh), 2.0 * pairs * d * h * b)


def attn_bound(nbytes: float, flops: float) -> tuple:
    """(bound_ms, bound_by) of one bf16 attention call: both products
    (q.k^T and p.v, ``flops`` each) at the bf16 tensor cores' rate, the
    least any design can take (the exps are not counted), or the bytes if
    they take longer."""
    ops_s = 2 * flops / BF16_TC_FLOPS
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations")


def attn_bound_f32_pv_ms(flops: float) -> float:
    """The bound of a design that keeps p.v on the CUDA cores, as the f32
    body does: q.k^T on the bf16 tensor cores and p.v, with p in f32, at
    the f32 CUDA-core rate, the larger of the two (they run on different
    units)."""
    return max(flops / BF16_TC_FLOPS, flops / F32_FLOPS) * 1e3


# the timed shapes, bf16 and causal unless named: Qwen2-0.5B's 14/2 heads
# of 64 at (B 2, S 4096) and at the prefill shape (B 1, S 32768; the
# kernel line's row), phi-3-vision's head dim 96 (32/32 heads; its
# 4096-position prefill) in both bodies and qwen2-7b's 28/4 heads of 128
# at 32k.  (B, H, KVH, S, D, dtype, seed)
FLASH_TIMED = {
    "qwen2-0.5b B 2 S 4096": (2, ATTN_HEADS, ATTN_KV_HEADS, 4096, ATTN_D,
                              "bfloat16", 4096),
    "qwen2-0.5b prefill": (PREFILL_BATCH, ATTN_HEADS, ATTN_KV_HEADS, 32768,
                           ATTN_D, "bfloat16", 32768),
    "phi-3-vision D 96 bf16": (1, 32, 32, 4096, 96, "bfloat16", 4192),
    "phi-3-vision D 96 f32": (1, 32, 32, 4096, 96, "float32", 4192),
    "qwen2-7b D 128 bf16": (1, 28, 4, 32768, 128, "bfloat16", 32896),
}
FLASH_KERNEL_LINE = "qwen2-0.5b prefill"

# the bf16 kernel's own tensor-core work: q.k^T once and p.v three times
# (p split exactly into three bf16 terms, csrc/flash_attention.cu)
ATTN_DESIGN_PRODUCTS = 4


def attn_check(out, ref, what: str) -> dict:
    """max_abs_err and rel_err of the kernel against its plain version,
    held to atol 2e-5 / rtol 1e-5 in f32 and one bf16 ulp in bf16 (f32
    sums in other orders, rounded to bf16 apart)."""
    import torch
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    rel = err / max(float(ref.float().abs().max()), 1e-30)
    if out.dtype == torch.float32:
        ok = bool((diff <= 2e-5 + 1e-5 * ref.abs()).all())
    else:
        ok = bool((diff <= 1e-6 + 2 ** -7 * ref.float().abs()).all())
    check(ok and out.shape == ref.shape and out.dtype == ref.dtype,
          f"flash_attention {what}: max abs err {err} (rel {rel})")
    return {"max_abs_err": err, "rel_err": rel}


def sdpa_ms(q, k, v) -> float:
    """ms of PyTorch's fused causal attention on the same inputs, the
    yardstick of ``library_ms``: ``scaled_dot_product_attention`` with
    ``enable_gqa=True``, held to its fused backends (the math backend would
    build the [S, S] scores: 60 GB at 32k)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters=10, warmup=2)


def kernel_flash_attention(dev, rows) -> None:
    """Timed at the ``FLASH_TIMED`` shapes and held against the plain
    version there and, untimed, at D 32 f32, 32/32 heads (stablelm), not
    causal, a ragged S of 4000, [B, S, H, D] views, D 128 f32, D 32 and
    128 in bf16, S of 16 and 48 and three D 96 cases.  ``library_ms`` is
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``;
    a bf16 row's ``bound_ms`` counts both products on the bf16 tensor
    cores, an f32 row's at the f32 CUDA-core rate."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ops import flash_attention_op

    def inputs(b, h, kvh, s, d, dtype, seed, strided=False):
        g = torch.Generator(device=dev).manual_seed(seed)
        out = []
        for n in (h, kvh, kvh):
            shape = (b, s, n, d) if strided else (b, n, s, d)
            t = torch.randn(shape, generator=g, device=dev).to(dtype)
            out.append(t.transpose(1, 2) if strided else t)
        return out

    with torch.no_grad():
        for what, (b, h, kvh, s, d, dt, seed) in FLASH_TIMED.items():
            # transposed [B, S, H, D] views, as the prefill hands them over
            dtype = getattr(torch, dt)
            q, k, v = inputs(b, h, kvh, s, d, dtype, seed=seed, strided=True)
            out = flash_attention_op(q, k, v)
            ref = flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            errs = attn_check(out, ref, what)
            del out, ref
            ms = cuda_ms(lambda: flash_attention_op(q, k, v),
                         iters=3 if s > 4096 else 10, warmup=1)
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v),
                               iters=1, warmup=1)
            library_ms = sdpa_ms(q, k, v)
            nbytes, flops = attn_work(b, h, kvh, s, d, True)
            if dtype == torch.float32:   # 4-byte elements, CUDA-core rate
                nbytes *= 2
                bound, by = (bound_ms(nbytes, 2 * flops),
                             bound_by(nbytes, 2 * flops))
                design = {}
            else:
                bound, by = attn_bound(nbytes, flops)
                design = {
                    "bound_f32_pv_ms": attn_bound_f32_pv_ms(flops),
                    "design_products": ATTN_DESIGN_PRODUCTS,
                    "design_tensor_core_ms":
                        ATTN_DESIGN_PRODUCTS * flops / BF16_TC_FLOPS * 1e3,
                    "bound_all_f32_ms": 2 * flops / F32_FLOPS * 1e3}
            row = dict(name="flash_attention", route="cuda",
                       source="src/repro_torch/csrc/flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention.py:82",
                       **errs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=by, library_ms=library_ms)
            emit({"phase": "kernel", "kernel": "flash_attention",
                  "case": what, "timed": True, "B": b, "H": h, "KVH": kvh,
                  "S": s, "D": d, "dtype": dt, "causal": True,
                  "layout": "BSHD views", **row, "flops": 2 * flops,
                  "bytes": nbytes, "bound_share": bound / ms, **design,
                  "tflops": 2 * flops / ms / 1e9})
            if what == FLASH_KERNEL_LINE:
                rows["flash_attention"] = row
            del q, k, v
        for what, (b, h, kvh, s, d, dtype, causal, strided) in {
                "reduced D 32 f32": (2, 4, 2, 1024, 32, torch.float32, True,
                                     False),
                "stablelm 32/32 heads": (1, 32, 32, 2048, 64, torch.bfloat16,
                                         True, False),
                "not causal": (1, 14, 2, 2048, 64, torch.bfloat16, False,
                               False),
                "ragged S 4000": (1, 14, 2, 4000, 64, torch.bfloat16, True,
                                  False),
                "[B,S,H,D] views": (2, 14, 2, 2048, 64, torch.bfloat16, True,
                                    True),
                "D 128 f32": (1, 8, 2, 1000, 128, torch.float32, True, True),
                "D 32 bf16": (2, 4, 2, 1024, 32, torch.bfloat16, True,
                              False),
                "D 128 bf16": (1, 8, 2, 1000, 128, torch.bfloat16, True,
                               True),
                "S 16": (1, 14, 2, 16, 64, torch.bfloat16, True, True),
                "S 48 not causal": (1, 14, 2, 48, 64, torch.bfloat16, False,
                                    False),
                "D 96 bf16 ragged S 1000 not causal": (
                    1, 8, 2, 1000, 96, torch.bfloat16, False, True),
                "D 96 f32 ragged S 4000": (1, 8, 2, 4000, 96, torch.float32,
                                           True, False),
                "D 96 bf16 S 48": (2, 4, 2, 48, 96, torch.bfloat16, True,
                                   True),
        }.items():
            q, k, v = inputs(b, h, kvh, s, d, dtype, seed=s + h,
                             strided=strided)
            out = flash_attention_op(q, k, v, causal=causal)
            ref = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            emit({"phase": "kernel", "kernel": "flash_attention",
                  "case": what, "B": b, "H": h, "KVH": kvh, "S": s, "D": d,
                  "dtype": str(dtype).removeprefix("torch."),
                  "causal": causal, **attn_check(out, ref, what)})
    gc.collect()
    torch.cuda.empty_cache()


def _serve_parity_run(arch: str, device: str, init_np, kv_int8: bool):
    """Prefill of ``SERVE_PARITY_PREFILL``-token prompts, then 24 decode
    steps from their first token: teacher-forced to
    ``SERVE_PARITY_PROMPT`` tokens, then greedy; f32, under "pallas"."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import to_torch
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg, dtype=torch.float32, device=device)
    params = to_torch(init_np, dtype=torch.float32, device=device)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, SERVE_PARITY_PREFILL)).astype(np.int32))
    logits_pre, cache_pre = model.prefill(params,
                                          {"tokens": prompts.to(device)})
    max_len = SERVE_PARITY_PROMPT + SERVE_PARITY_NEW
    cache = model.init_cache(2, max_len, kv_int8=kv_int8)
    tok, logits, toks = prompts[:, :1].to(device), [], []
    for pos in range(max_len - 1):
        lg, cache = model.decode_step(params, cache, tok, pos)
        logits.append(lg.cpu())
        if pos + 1 < SERVE_PARITY_PROMPT:
            tok = prompts[:, pos + 1:pos + 2].to(device)
        else:
            tok = torch.argmax(lg, -1, keepdim=True).to(torch.int32)
            toks.append(tok.cpu())
    return (logits_pre.cpu(), {k: t.cpu() for k, t in
                               cache_pre["layers"].items()},
            torch.stack(logits), torch.cat(toks, 1),
            {k: t.cpu() for k, t in cache["layers"].items()})


def phase_reduced_serve_parity():
    """Reduced qwen2-0.5b and stablelm-1.6b in f32 under "pallas" on the
    card (flash kernel) and on the CPU (plain versions) from the same
    params: prefill logits and cache, and every decode step's logits, for
    the model-dtype cache and ``kv_int8``, within atol 1e-4 / rtol 1e-4
    (f32 sums in other orders on each side); greedy tokens identical; int8
    payloads within one step where a rounding tie may fall either way, on
    at most 0.1% of them, and scales within rtol 1e-5."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import to_numpy
    from repro_torch.kernels import ops
    from repro_torch.models import attention, build_model

    attention.set_attention_impl("pallas")
    try:
        for arch in ("qwen2-0.5b", "stablelm-1.6b"):
            cfg = get_config(arch).reduced()
            init = to_numpy(build_model(cfg, dtype=torch.float32,
                                        device="cpu")
                            .init(torch.Generator().manual_seed(0)))
            for kv_int8 in (False, True):
                before = ops.flash_attention_op.launches
                card = _serve_parity_run(arch, "cuda", init, kv_int8)
                check(ops.flash_attention_op.launches
                      == before + cfg.n_layers,
                      f"{arch}: the card's prefill did not launch the "
                      "flash kernel once per layer")
                cpu = _serve_parity_run(arch, "cpu", init, kv_int8)
                errs = {}
                for name, a, b in (
                        ("prefill_logits", card[0], cpu[0]),
                        *((f"prefill_{k}", card[1][k], cpu[1][k])
                          for k in card[1]),
                        ("decode_logits", card[2], cpu[2])):
                    errs[name] = float((a - b).abs().max())
                    check(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
                          f"{arch} kv_int8={kv_int8} {name}: card and CPU "
                          f"differ by {errs[name]}")
                flips = 0
                for k in card[4]:
                    a, b = card[4][k], cpu[4][k]
                    if k.endswith("_q"):
                        d = (a.int() - b.int()).abs()
                        flips += int((d > 0).sum())
                        check(int(d.max()) <= 1
                              and float((d > 0).float().mean()) <= 1e-3,
                              f"{arch} int8 {k}: {int((d > 0).sum())} "
                              "payloads differ")
                    else:
                        check(torch.allclose(a, b, rtol=1e-5 if kv_int8
                                             else 1e-4,
                                             atol=0 if kv_int8 else 1e-4),
                              f"{arch} cache {k}: card and CPU differ")
                same = bool(torch.equal(card[3], cpu[3]))
                emit({"phase": "reduced_serve_parity", "arch": arch,
                      "kv_int8": kv_int8, "impl": "pallas",
                      "prefill": SERVE_PARITY_PREFILL,
                      "prompt": SERVE_PARITY_PROMPT,
                      "greedy_steps": SERVE_PARITY_NEW,
                      "max_abs_err": errs, "int8_payload_flips": flips,
                      "greedy_tokens_equal": same,
                      "tokens_card": card[3].tolist()})
                check(same, f"{arch} kv_int8={kv_int8}: greedy tokens differ")
    finally:
        attention.set_attention_impl("blockwise")


def _bf16_rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def prefill_rel(logits, cache, logits_ref, cache_ref) -> dict:
    """Largest difference of two prefills' logits and caches, each over
    the largest value of the second."""
    return {"logits": _bf16_rel(logits, logits_ref),
            **{k: _bf16_rel(cache["layers"][k], cache_ref["layers"][k])
               for k in ("k", "v")}}


def cache_row_stats(cache, cache_ref, limit: float) -> dict:
    """Per cache row (layer, batch row, position) of k and v: the largest
    difference over the largest value of ``cache_ref`` (over the positions
    ``cache`` holds); the share of rows above ``limit`` and the median and 99th
    percentile of the rows' readings.  A sparse-expert model's bf16 paths
    can route a token to other experts (a near tie in the router, or a
    capacity slot taken by a token before it), which moves that token's
    later rows as a whole: these say how many rows moved, where the
    largest reading says only that one did."""
    import torch
    out = {}
    for k in ("k", "v"):
        a = cache["layers"][k].float()
        b = cache_ref["layers"][k][:, :, :a.shape[2]].float()
        rows = ((a - b).abs().amax(dim=(-2, -1))
                / max(float(b.abs().max()), 1e-30)).flatten()
        out[k] = {"rows_over": float((rows > limit).float().mean()),
                  "q50": float(torch.quantile(rows, 0.5)),
                  "q99": float(torch.quantile(rows, 0.99))}
    return out


def decode_built(model, params, prompts, max_len: int):
    """Teacher-forced decode of ``prompts`` from position 0 under
    "blockwise": (the logits at the last prompt position, the cache)."""
    from repro_torch.models import attention
    attention.set_attention_impl("blockwise")
    cache = model.init_cache(prompts.shape[0], max_len)
    for pos in range(prompts.shape[1]):
        logits, cache = model.decode_step(params, cache,
                                          prompts[:, pos:pos + 1], pos)
    return logits, cache


def prefill_vs_decode(model, params, prompts, logits_dec, cache_dec,
                      row_limit: float = None) -> dict:
    """The "pallas" prefill of ``prompts`` against the logits and cache
    that ``decode_built`` gave for them: per layer, the largest difference
    of k and v over the prefill's largest value; the logits' difference;
    the prefill's top-1 margins and the rows whose top-1 agree; with
    ``row_limit``, ``cache_row_stats`` at that limit."""
    from repro_torch.models import attention
    attention.set_attention_impl("pallas")
    logits_pre, cache_pre = model.prefill(params, {"tokens": prompts})
    attention.set_attention_impl("blockwise")
    n = prompts.shape[1]
    rel = {k: [_bf16_rel(cache_dec["layers"][k][i, :, :n],
                         cache_pre["layers"][k][i])
               for i in range(cache_pre["layers"][k].shape[0])]
           for k in ("k", "v")}
    top2 = logits_pre.float().topk(2, dim=-1).values
    rows = ({} if row_limit is None else
            {"rows": cache_row_stats(cache_pre, cache_dec, row_limit)})
    return {**rows,
            "cache_rel_err_layer0": {k: v[0] for k, v in rel.items()},
            "cache_rel_err_max": {k: max(v) for k, v in rel.items()},
            "logits_rel_err": _bf16_rel(logits_dec, logits_pre),
            "logits_max_abs_err": float((logits_dec.float()
                                         - logits_pre.float()).abs().max()),
            "top1_minus_top2": (top2[:, 0] - top2[:, 1]).tolist(),
            "top1_equal_rows": int((logits_pre.argmax(-1)
                                    == logits_dec.argmax(-1)).sum())}


def phase_serve():
    """Cell D: ``serve_cell`` on the full-width Qwen2-0.5B, ``decode_32k``
    at its batch of 128."""
    from repro_torch.configs import SHAPES
    return serve_cell(FULL_ARCH, "serve", SHAPES["decode_32k"].global_batch)


def serve_cell(arch: str, phase: str, decode_batch: int):
    """Serving the full-width ``arch`` in bf16 on one card.

    * prefill: ``prefill_cell`` at ``prefill_32k``'s seq 32768 with batch
      1 (not 32: with the CUDA-core kernel a batch of 32 took minutes).
    * decode: ``build_step(cfg, decode_32k)`` at ``decode_batch`` against
      a cache of 32768 positions filled from a seeded generator, at pos
      32767, 1 warm-up and ``DECODE_TIMED`` timed; bound: the cache and
      the params read once at the memory rate.
    * serve: ``launch.serve.serve`` on ``SERVE_REQUESTS`` requests of
      ``SERVE_PROMPT`` tokens, batch ``SERVE_BATCH``, ``SERVE_NEW`` new
      tokens each.
    * consistency: prefill of the first batch's prompts against the cache
      that teacher-forced decode builds for them, in bf16 (k, v within
      ``BF16_CACHE_TOL`` of the largest value) and in f32 (k, v and logits
      within ``F32_REL_TOL``, and the same top-1 at the last prompt
      position on at least 3 of 4 rows).

    Returns the launches of prefill, decode and serve (zeroed before)."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    mesh = make_host_mesh(device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    # -- prefill ------------------------------------------------------------
    tokens = torch.randint(0, cfg.vocab_size,
                           (PREFILL_BATCH, SHAPES["prefill_32k"].seq_len),
                           generator=gen, device=dev, dtype=torch.int32)
    logits, cache, prefill_launches = prefill_cell(phase, cfg, model, params,
                                                   {"tokens": tokens})
    del logits, cache, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # -- decode at decode_32k ----------------------------------------------
    shape = dataclasses.replace(SHAPES["decode_32k"],
                                global_batch=decode_batch)
    step = build_step(cfg, shape, mesh)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    for t in cache["layers"].values():
        for layer in t:
            layer.normal_(generator=gen)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in cache["layers"].values())
    tok = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1),
                        generator=gen, device=dev, dtype=torch.int32)
    pos = shape.seq_len - 1
    ptr = cache["layers"]["k"].data_ptr()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for _ in range(1 + DECODE_TIMED):
        t0 = time.perf_counter()
        logits, cache = step.fn(params, cache, tok, pos)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    ms_step = sum(secs[1:]) / DECODE_TIMED * 1e3
    decode_bound = (cache_bytes + param_bytes) / HBM_BYTES_PER_S * 1e3
    emit({"phase": phase, "part": "decode", "seq_len": shape.seq_len,
          "batch": shape.global_batch, "pos": pos, "cache_bytes": cache_bytes,
          "param_bytes": param_bytes, "warmup_ms": secs[0] * 1e3,
          "step_ms": [s * 1e3 for s in secs[1:]], "ms_per_step": ms_step,
          "bound_ms": decode_bound, "bound_share": decode_bound / ms_step,
          "tokens_per_s": shape.global_batch / ms_step * 1e3,
          "max_memory_allocated": peak})
    check(cache["layers"]["k"].data_ptr() == ptr,
          "decode did not write its cache in place")
    check(bool(torch.isfinite(logits).all()) and logits.shape
          == (shape.global_batch, cfg.padded_vocab), "decode logits")
    del cache, logits, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- the serve loop ------------------------------------------------------
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, SERVE_PROMPT)
                    .astype(np.int32)) for i in range(SERVE_REQUESTS)]
    max_len = SERVE_PROMPT + SERVE_NEW
    done, steps, dt = serve(model, params, reqs, SERVE_BATCH, max_len)
    serve_launches = ops_launches()
    n_new = sum(len(r.output) for r in done)
    emit({"phase": phase, "part": "serve_loop", "requests": len(done),
          "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
          "max_new": SERVE_NEW, "decode_steps": steps, "seconds": dt,
          "steps_per_s": steps / dt, "generated_tokens": n_new,
          "generated_tokens_per_s": n_new / dt,
          "first_outputs": [r.output[:8] for r in done[:2]]})
    check(steps == SERVE_REQUESTS // SERVE_BATCH * (max_len - 1)
          and n_new == SERVE_REQUESTS * SERVE_NEW, "serve loop counts")
    check(serve_launches == prefill_launches,
          f"decode launched kernels: {serve_launches}")

    # -- consistency of prefill and decode (a check, not the serve path) ----
    prompts = torch.from_numpy(np.stack([r.prompt for r in
                                         done[:SERVE_BATCH]])).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        m = model if dtype == torch.bfloat16 else build_model(
            cfg, dtype=dtype, device=dev)
        p = tree_map(lambda t: t.to(dtype), params)
        r = prefill_vs_decode(m, p, prompts,
                              *decode_built(m, p, prompts, max_len))
        name = str(dtype).removeprefix("torch.")
        emit({"phase": phase, "part": "prefill_vs_decode", "dtype": name,
              "rows": SERVE_BATCH, "positions": SERVE_PROMPT, **r})
        limit = BF16_CACHE_TOL if dtype == torch.bfloat16 else F32_REL_TOL
        check(all(v <= limit for v in r["cache_rel_err_max"].values()),
              f"{name} prefill and decode caches differ: {r}")
        # the random-weight model's logits are flat: in bf16 the top-2 gap
        # lies below the noise of two bf16 paths, so top-1 is held in f32
        if dtype == torch.float32:
            check(r["logits_rel_err"] <= F32_REL_TOL,
                  "f32 prefill and decode logits differ")
            check(r["top1_equal_rows"] >= SERVE_BATCH - 1,
                  f"prefill and decode top-1 agree on "
                  f"{r['top1_equal_rows']} of {SERVE_BATCH} rows")
        del m, p
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return serve_launches


# --------------------------------------------------------------------------- #
# slice 3: the training CLI, checkpoints, the replica, the rest of the PS
# plane and elastic sessions
# --------------------------------------------------------------------------- #
TRAIN_ARGV = ["--arch", FULL_ARCH, "--full", "--batch", "8", "--seq", "128",
              "--steps", "4", "--ckpt-every", "2", "--div-max", "5",
              "--schedule", "cosine", "--log-every", "1"]
POD_COMMITS = 8
ELASTIC_STEPS, ELASTIC_FAIL_AT, ELASTIC_LR = 6, 3, 0.3
PS_PARITY_COMMITS, PS_PARITY_ROUNDS = 8, 3
PS_PARITY_SEEDS = (0, 1, 2)
# card against CPU on the reduced model, f32.  Without int8 the params
# differ only by f32 sums in other orders: each leaf within
# PS_PARITY_LEAF_TOL of its largest magnitude.  With the int8 wire such a
# last-bit difference can move a value across a rounding boundary, one
# quantization step (1/127 of its block's largest delta): a leaf that
# starts at zero (the q/k/v biases) then differs by that step over its own
# small magnitude, so the compressed run is held on the whole tree: the
# difference within PS_PARITY_MOVE_TOL of the distance the params moved.
# On an H100, seeds 0-23 read 6.3e-4 to 2.47e-3 of the distance, and a
# wire planted with round toward zero in ``quantize`` 2.45e-2 to 3.10e-2:
# the limit sits near their geometric mean, about 3x from each.  Two
# controls on the first seed hold it to account in every run: the planted
# wire must read above it, and the card run with the wire done on the
# host by the plain versions must be bit-equal to the card run with the
# kernels, which no planted wire is (a scale one ulp high reads like a
# sound run, so only this bit-equality catches it).  PERF.md section 6
# has the readings.
PS_PARITY_LEAF_TOL = 1e-5
PS_PARITY_MOVE_TOL = 8e-3
PS_PARITY_LOSS_RTOL = 1e-4
PS_PARITY_FAULTS = ("round_toward_zero", "scale_one_ulp")
PS_PARITY_CAUGHT = ("round_toward_zero",)


def _npz_max_diff(a_path: str, b_path: str) -> float:
    """Largest |difference| between two npz files' arrays, leaf by leaf
    (0.0 where every leaf is equal)."""
    import numpy as np
    with np.load(a_path) as a, np.load(b_path) as b:
        check(sorted(a.files) == sorted(b.files),
              f"{a_path} and {b_path} hold other leaves")
        worst = 0.0
        for k in a.files:
            x, y = a[k], b[k]
            if not np.array_equal(x, y):
                worst = max(worst, float(np.abs(x.astype(np.float64)
                                                - y).max()))
        return worst


def phase_train() -> dict:
    """The training CLI at full width (``launch.train.train``, the body of
    ``main``): 4 steps with checkpoints at 2 and 4 and the replica; then
    the step-4 checkpoint is moved out and the same command resumes from
    step 2.  The resumed step-4 params and momentum must equal the
    uninterrupted run's (bit for bit, in memory and on disk)."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import train as cli
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda", 0)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ckdir = os.path.join(root, "ckpt")
    argv = TRAIN_ARGV + ["--ckpt-dir", ckdir]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        out1 = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out1):
            run1 = cli.train(argv)
        wall1 = time.perf_counter() - t0
        launched = ops_launches()
        step4 = "step_0000000004"
        ck_bytes = sum(os.path.getsize(os.path.join(ckdir, step4, f))
                       for f in os.listdir(os.path.join(ckdir, step4)))
        shutil.move(os.path.join(ckdir, step4), os.path.join(root, step4))
        out2 = io.StringIO()
        with contextlib.redirect_stdout(out2):
            run2 = cli.train(argv)
        peak = torch.cuda.max_memory_allocated(dev)
        launched2 = ops_launches()
        diff_p = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(tree_leaves(run1.params),
                                     tree_leaves(run2.params)))
        diff_o = max(float((a - b).abs().max())
                     for a, b in zip(tree_leaves(run1.opt),
                                     tree_leaves(run2.opt)))
        disk = {f: _npz_max_diff(os.path.join(root, step4, f),
                                 os.path.join(ckdir, step4, f))
                for f in ("params.npz", "opt.npz")}
        timed = run1.step_seconds[1:]
        emit({"phase": "train", "argv": TRAIN_ARGV,
              "lines_first": out1.getvalue().splitlines(),
              "lines_resumed": out2.getvalue().splitlines(),
              "losses": run1.losses, "losses_resumed": run2.losses,
              "step_s": run1.step_seconds, "s_per_step": sum(timed)
              / len(timed), "save_s": run1.save_seconds + run2.save_seconds,
              "restore_s": run2.restore_seconds, "ckpt_bytes": ck_bytes,
              "replica_syncs": run1.replica.syncs,
              "replication_savings": run1.replica.replication_savings,
              "replica_step": run1.replica.replica_step,
              "resumed_max_abs_diff": {"params": diff_p, "momentum": diff_o,
                                       **disk},
              "wall_s_first_run": wall1, "launches": launched,
              "max_memory_allocated": peak})
        check(all(math.isfinite(l) for l in run1.losses + run2.losses),
              "train: a loss is not finite")
        check(run2.start_step == 2 and len(run2.losses) == 2,
              "train: the second run did not resume from step 2")
        check(run2.losses == run1.losses[2:],
              f"train: resumed losses {run2.losses} vs {run1.losses[2:]}")
        check(diff_p == 0.0 and diff_o == 0.0
              and all(v == 0.0 for v in disk.values()),
              f"train: resumed step 4 differs: params {diff_p}, momentum "
              f"{diff_o}, files {disk}")
        check(run1.replica.syncs >= 1, "train: the replica never synced")
        check(launched == launched2 == dict.fromkeys(KERNELS, 0),
              f"train: the CLI's step launched kernels: {launched2}")
        return launched
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _full_width_model(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(FULL_ARCH)
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    return cfg, model, model.init(torch.Generator(device=dev).manual_seed(0))


def phase_pod_async() -> dict:
    """``PodAsyncTrainer(compress=True)`` at full width, cell A's seq 256 x
    batch 2 per local step, 4 pods of 2 local steps, 8 commits: one
    ``quantize`` and one ``dequant_aggregate`` per pod delta, nothing
    else."""
    import torch
    from repro_torch.core import N_STATIC
    from repro_torch.data import SyntheticLM
    from repro_torch.ps import PodAsyncTrainer

    dev = torch.device("cuda", 0)
    cfg, model, params = _full_width_model(dev)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN, seed=0)

    def data_fn(pod, t):
        b = src.batch(int(pod.removeprefix("worker")) * 100003 + t, BATCH)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    eval_batch = data_fn("worker9", 12345)

    def eval_fn(p):
        with torch.no_grad():
            return model.loss_fn(p, eval_batch)[0]

    loss_fn = functools.partial(model.loss_fn, remat=False)
    tr = PodAsyncTrainer(params, loss_fn, data_fn, n_pods=4, local_steps=2,
                         inner_lr=0.1, tau_max=4, gamma=0.6, compress=True,
                         update_size=4.0 * full_width_flat_len(),
                         bandwidth=N_STATIC, eval_fn=eval_fn, has_aux=True,
                         seed=0, device=dev)
    del params
    loss0 = float(eval_fn(tr.server.params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    res = tr.run(until_commits=POD_COMMITS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = ops_launches()
    deltas = tr._t // tr.local_steps
    losses = [l for _, l in res.losses]
    emit({"phase": "pod_async", "arch": cfg.name, "dtype": "bfloat16",
          "seq_len": SEQ_LEN, "batch": BATCH, "n_pods": 4, "local_steps": 2,
          "commits": res.commits, "drops": res.drops, "deltas": deltas,
          "delay_stats": res.delay_stats, "loss_before": loss0,
          "eval_losses": losses, "wall_s": wall,
          "wall_s_per_commit": wall / max(res.commits, 1),
          "launches": launched,
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})
    check(res.commits >= POD_COMMITS, f"pod_async: {res.commits} commits")
    check(bool(losses) and all(math.isfinite(l) for l in losses),
          f"pod_async: eval losses {losses}")
    want = dict.fromkeys(KERNELS, 0)
    want.update(quantize=deltas, dequant_aggregate=deltas)
    check(launched == want, f"pod_async: launches {launched} for {deltas} "
                            "pod deltas")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launched


class _PromotionProbe:
    """Hook callback that times a session's replica promotion and reads
    the replica as it stood when the primary failed."""

    def __init__(self):
        self.failed_at = None
        self.seen = []
        self.losses = []

    def on_failover(self, sess, t, info=None):
        import torch
        torch.cuda.synchronize()
        r = sess.replica
        self.failed_at = dict(step=sess.step_idx, t0=time.perf_counter(),
                              replica_step=r.replica_step,
                              lead=len(r.pending_norms),
                              replica=r.replica)

    def on_replica_promote(self, sess, t, lost):
        import torch
        from repro_torch.tree import tree_leaves
        torch.cuda.synchronize()
        seconds = time.perf_counter() - self.failed_at["t0"]
        equal = all(torch.equal(a.cpu(), b) for a, b in zip(
            tree_leaves(sess.state[0]),
            tree_leaves(self.failed_at.pop("replica"))))
        self.seen.append(dict(self.failed_at, step_after=sess.step_idx,
                              lost=lost, seconds=seconds,
                              params_equal=equal))

    def on_batch_end(self, sess, step, metrics=None):
        if metrics:
            self.losses.append((sess.step_idx, metrics["loss"]))


def phase_elastic() -> dict:
    """An ``ElasticSession`` on the card with the CLI's step (autograd and
    eq. 2 at lr 0.3) over the full-width model at batch 8 x seq 128, and a
    ``BoundedDivergenceReplica`` (gamma 0.9) whose ``div_max`` is set after
    the first step to six times that step's update norm: with updates of
    about that norm the bound reads 1.9 and 4.6 of them after two and three
    steps and 8.1 after four, so the replica trails by two steps at the
    ``ServerFail`` before step 4.  The promotion must give the session the
    replica's step and params, report the replica's lead as
    ``lost_updates``, and training go on with finite losses."""
    import torch
    from repro_torch.checkpoint import BoundedDivergenceReplica
    from repro_torch.core.scenario import Scenario, ServerFail
    from repro_torch.data import DataPipeline, SyntheticLM
    from repro_torch.dist import ElasticSession
    from repro_torch.launch.train import make_step_fn
    from repro_torch.optim import momentum_sgd_init

    dev = torch.device("cuda", 0)
    cfg, model, params = _full_width_model(dev)
    step = make_step_fn(model, gamma=0.9)

    def builder(grid):
        def run(state, batch):
            p, o, loss, gnorm = step(*state, batch, ELASTIC_LR)
            return (p, o), {"update_norm": float(gnorm) * ELASTIC_LR,
                            "loss": float(loss)}
        return run

    pipe = DataPipeline(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=128,
                                    seed=0), global_batch=8)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.next_batch().items()}
               for _ in range(ELASTIC_STEPS)]
    replica = BoundedDivergenceReplica(div_max=float("inf"), gamma=0.9)
    probe = _PromotionProbe()
    sess = ElasticSession(step_fn_builder=builder,
                          init_state=(params, momentum_sgd_init(params)),
                          replica=replica, device=dev, callbacks=[probe])
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    sess.run_steps(batches[:1])
    replica.div_max = 6.0 * replica.h_norm_ub
    infos = sess.run_scenario(Scenario([ServerFail(time=ELASTIC_FAIL_AT - 1)]),
                              batches[1:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = ops_launches()
    check(len(probe.seen) == 1 and len(infos) == 1,
          f"elastic: {len(probe.seen)} promotions")
    pr = probe.seen[0]
    emit({"phase": "elastic", "arch": cfg.name, "dtype": "bfloat16",
          "batch": 8, "seq_len": 128, "steps_run": len(probe.losses),
          "losses": probe.losses, "div_max": replica.div_max,
          "failed_at_step": pr["step"], "replica_step": pr["replica_step"],
          "replica_lead": pr["lead"], "lost_updates": infos[0]["lost_updates"],
          "restored_from": infos[0]["restored_from"],
          "promotion_s": pr["seconds"], "params_equal": pr["params_equal"],
          "replica_syncs": replica.syncs,
          "replication_savings": replica.replication_savings,
          "wall_s": wall, "launches": launched,
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})
    check(pr["step_after"] == pr["replica_step"]
          and infos[0]["restored_from"] == f"replica:step_{pr['replica_step']}",
          f"elastic: promoted to step {pr['step_after']}, replica at "
          f"{pr['replica_step']}")
    check(pr["lost"] == pr["lead"] == infos[0]["lost_updates"]
          == pr["step"] - pr["replica_step"],
          f"elastic: lost {pr['lost']}, lead {pr['lead']}")
    check(pr["params_equal"], "elastic: the promoted params are not the "
                              "replica's")
    check(len(probe.losses) == ELASTIC_STEPS
          and all(math.isfinite(l) for _, l in probe.losses),
          f"elastic: losses {probe.losses}")
    check(launched == dict.fromkeys(KERNELS, 0),
          f"elastic: the CLI's step launched kernels: {launched}")
    del sess, batches, probe
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def _param_gaps(card, cpu, init) -> dict:
    """Card against CPU: the worst leaf (its largest |difference| over its
    largest magnitude), how many values differ by more than 1e-6 of their
    leaf's largest magnitude, and the whole tree's ||difference|| over the
    ||distance moved from init||."""
    import torch
    worst, n_off, diff2, move2 = ("", 0.0), 0, 0.0, 0.0
    for (name, a), (_, b), (_, p0) in zip(card, cpu, init):
        a, b, p0 = a.cpu().double(), b.cpu().double(), p0.cpu().double()
        d = (a - b).abs()
        top = max(float(b.abs().max()), 1e-30)
        if float(d.max()) / top > worst[1]:
            worst = (name, float(d.max()) / top)
        n_off += int((d > 1e-6 * top).sum())
        diff2 += float(torch.sum(d * d))
        move2 += float(torch.sum((b - p0) ** 2))
    return {"worst_leaf": worst[0], "worst_leaf_gap": worst[1],
            "values_off": n_off,
            "diff_over_move": math.sqrt(diff2) / max(math.sqrt(move2), 1e-30)}


def _reduced_ps_init(seed: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import to_numpy
    from repro_torch.models import build_model
    cfg = get_config(FULL_ARCH).reduced()
    return to_numpy(build_model(cfg, dtype=torch.float32, device="cpu")
                    .init(torch.Generator().manual_seed(seed)))


def _reduced_ps_run(device: str, init_np, trainer: str, seed: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import N_STATIC, mb
    from repro_torch.data import SyntheticLM
    from repro_torch.interop import to_torch
    from repro_torch.models import build_model
    from repro_torch.ps import PodAsyncTrainer, SyncTrainer
    from repro_torch.tree import tree_flatten_with_path

    cfg = get_config(FULL_ARCH).reduced()
    model = build_model(cfg, dtype=torch.float32, device=device)
    src = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=seed)

    def data_fn(worker, t):
        b = src.batch(int(worker.removeprefix("worker")) * 997 + t, 4)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    eval_batch = data_fn("worker9", 12345)

    def eval_fn(params):
        with torch.no_grad():
            return model.loss_fn(params, eval_batch)[0]

    params = to_torch(init_np, dtype=torch.float32, device=device)
    if trainer.startswith("pod_async"):
        tr = PodAsyncTrainer(params, model.loss_fn, data_fn, n_pods=4,
                             local_steps=2, inner_lr=0.2, tau_max=4,
                             gamma=0.6, compress=trainer == "pod_async",
                             update_size=mb(10), bandwidth=N_STATIC,
                             eval_fn=eval_fn, has_aux=True, seed=seed,
                             device=device)
        res = tr.run(until_commits=PS_PARITY_COMMITS)
        sched = (res.commits, res.drops, res.delay_stats, res.sim_time)
        losses = [l for _, l in res.losses]
    else:
        tr = SyncTrainer(params, model.loss_fn, data_fn, n_workers=4,
                         base_lr=0.2, gamma=0.6, update_size=mb(10),
                         aggregators=2, has_aux=True, seed=seed,
                         device=device)
        sched = [dataclasses.asdict(x) for x in tr.run(PS_PARITY_ROUNDS)]
        losses = [float(eval_fn(tr.server.params))]
    return sched, losses, tree_flatten_with_path(tr.server.params)[0]


class _Wire:
    """Swaps the int8 wire that ``flat_compress_roundtrip`` calls
    (``ops.quantize_op`` and ``ops.dequant_aggregate_op``) for one card
    run.  ``"host"``: both run their plain versions on host copies, the
    results copied back.  A planted fault: the kernels run, then
    ``"round_toward_zero"`` recomputes q with ``trunc`` in place of
    round-to-nearest and ``"scale_one_ulp"`` raises every scale by one
    ulp.  The ops look their counters up by their module-level names, so
    the stand-ins carry counters of their own: launches made in a control
    run never reach the counters the paths are checked by."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops
        kind = self.kind
        self.real = real_q, real_d = ops.quantize_op, ops.dequant_aggregate_op

        def quantize(x, *, block=256):
            if kind == "host":
                q, s = real_q(x.cpu(), block=block)
                return q.to(x.device), s.to(x.device)
            q, s = real_q(x, block=block)
            if kind == "round_toward_zero":
                q = torch.clamp(torch.trunc(x.view(-1, block) / s[:, None]),
                                -127, 127).to(torch.int8).view(-1)
            elif kind == "scale_one_ulp":
                s = torch.nextafter(s, torch.full_like(s, math.inf))
            else:
                raise ValueError(kind)
            return q, s

        def dequant_aggregate(q, s, w, **kw):
            if kind != "host":
                return real_d(q, s, w, **kw)
            return tuple(t.to(q.device)
                         for t in real_d(q.cpu(), s.cpu(), w.cpu(), **kw))

        quantize.launches = dequant_aggregate.launches = 0
        ops.quantize_op, ops.dequant_aggregate_op = quantize, dequant_aggregate
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.quantize_op, ops.dequant_aggregate_op = self.real
        return False


def phase_reduced_ps_parity(seeds=PS_PARITY_SEEDS) -> None:
    """The reduced qwen2-0.5b in f32 through ``PodAsyncTrainer`` (8
    commits; with the int8 wire and without) and ``SyncTrainer`` (3
    rounds) on the card and on the CPU from the same params, for each of
    ``seeds`` (params, data and schedule): identical schedules, eval losses
    within ``PS_PARITY_LOSS_RTOL``, params as the limits above say.  On the
    first seed the compressed run's controls: the host wire (bit-equal to
    the card run) and the planted faults (each of ``PS_PARITY_CAUGHT`` above
    ``PS_PARITY_MOVE_TOL``)."""
    import torch
    from repro_torch.interop import to_torch
    from repro_torch.tree import tree_flatten_with_path

    for seed in seeds:
        init = _reduced_ps_init(seed)
        init_leaves = tree_flatten_with_path(to_torch(init, device="cpu"))[0]
        for trainer in ("pod_async", "pod_async_uncompressed", "sync"):
            t0 = time.perf_counter()
            zero_launches()
            card = _reduced_ps_run("cuda", init, trainer, seed)
            launched = ops_launches()
            t1 = time.perf_counter()
            cpu = _reduced_ps_run("cpu", init, trainer, seed)
            gaps = _param_gaps(card[2], cpu[2], init_leaves)
            emit({"phase": "reduced_ps_parity", "trainer": trainer,
                  "seed": seed, "schedule_equal": card[0] == cpu[0],
                  "losses_card": card[1], "losses_cpu": cpu[1], **gaps,
                  "launches": launched, "card_s": t1 - t0,
                  "cpu_s": time.perf_counter() - t1})
            check(card[0] == cpu[0], f"{trainer}: schedules differ")
            check(all(abs(a - b) <= PS_PARITY_LOSS_RTOL * abs(b)
                      for a, b in zip(card[1], cpu[1])),
                  f"{trainer}: losses {card[1]} vs {cpu[1]}")
            if trainer != "pod_async":
                check(gaps["worst_leaf_gap"] <= PS_PARITY_LEAF_TOL,
                      f"{trainer} seed {seed}: params {gaps}")
                continue
            check(gaps["diff_over_move"] <= PS_PARITY_MOVE_TOL,
                  f"{trainer} seed {seed}: params {gaps}")
            check(launched["quantize"] > 0
                  and launched["quantize"] == launched["dequant_aggregate"],
                  f"pod_async on the card: launches {launched}")
            if seed != seeds[0]:
                continue
            for kind in ("host",) + PS_PARITY_FAULTS:
                t0 = time.perf_counter()
                with _Wire(kind):
                    ctl = _reduced_ps_run("cuda", init, trainer, seed)
                vs_cpu = _param_gaps(ctl[2], cpu[2], init_leaves)
                equal = all(torch.equal(a, b) for (_, a), (_, b)
                            in zip(ctl[2], card[2]))
                emit({"phase": "reduced_ps_parity", "trainer": trainer,
                      "seed": seed, "wire": kind,
                      "schedule_equal": ctl[0] == cpu[0],
                      "bit_equal_to_kernel_wire": equal,
                      "losses_card": ctl[1], **vs_cpu,
                      "card_s": time.perf_counter() - t0})
                check(equal == (kind == "host"),
                      f"pod_async: the card run with the {kind} wire is "
                      f"{'' if equal else 'not '}bit-equal to the kernel "
                      "wire's")
                if kind in PS_PARITY_CAUGHT:
                    check(vs_cpu["diff_over_move"] > PS_PARITY_MOVE_TOL,
                          f"pod_async: the planted {kind} wire passes the "
                          f"limit: {vs_cpu}")


# --------------------------------------------------------------------------- #
# slice 7: the paper's dynamic cluster, sparse experts, the vision prefix
# and qwen2-7b
# --------------------------------------------------------------------------- #
# paper_dynamic_cluster(4, seed=0, horizon=12): worker3 leaves at 2 s, a
# fresh worker joins at 6 s, worker1's aggregator role fails at 4 s and
# worker0's and worker3's NICs dip to 1 Gb/s from 3 s for 4 s; cell A's
# full-width update (a 494 MB int8 wire) commits before, between and after
FAMILY_ARCHS = ("qwen2-7b", "phi-3-vision-4.2b", "granite-moe-1b-a400m")
SCENARIO_HORIZON = 12.0
MOE_ARCH, MOE_COMMITS = "granite-moe-1b-a400m", 8
VLM_ARCH, VLM_SEQ = "phi-3-vision-4.2b", 4096
DENSE_7B_ARCH, DENSE_7B_DECODE_BATCH = "qwen2-7b", 16
AFTER_PREFILL_STEPS = 8
FAMILY_PARITY_SEQ, FAMILY_PARITY_STEPS = 64, 4


def _ties(launches: dict, updates: int, what: str) -> None:
    """One quantize and one dequant_aggregate per update computed, nothing
    else: the wire of every update, as ``phase_main_path`` holds it."""
    want = dict.fromkeys(KERNELS, 0)
    want.update(quantize=updates, dequant_aggregate=updates)
    check(launches == want, f"{what}: launches {launches} for {updates} "
                            "updates computed")


def phase_scenario(rows) -> dict:
    """Cell H: MLfabric-A on the full-width Qwen2-0.5B under the paper's
    dynamic cluster (``scenarios.paper_dynamic_cluster``), with a
    ``PhaseProfiler`` attached, until ``SCENARIO_HORIZON`` simulated
    seconds: one leave and one join, commits before the leave, between the
    leave and the join and after it, the leaver committing nothing after it
    left but the one update a worker may have in flight, every update
    computed committed, dropped or still pending, finite losses, and one
    quantize and one dequant_aggregate per update.  The profiler's roofline
    model (``aggregator_hbm_traffic`` at n = 1 and the flat update's
    length) is printed beside ``dequant_aggregate``'s measured time."""
    import torch
    from repro_torch.core.scenario import WorkerJoin, WorkerLeave
    from repro_torch.obs import PhaseProfiler
    from repro_torch.scenarios import paper_dynamic_cluster

    dev = torch.device("cuda", 0)
    scen = paper_dynamic_cluster(4, seed=0, horizon=SCENARIO_HORIZON)
    leave = next(e for e in scen if isinstance(e, WorkerLeave))
    join = next(e for e in scen if isinstance(e, WorkerJoin))
    prof = PhaseProfiler()
    tr, setup = full_width_trainer(dev, callbacks=[prof], scenario=scen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    res = tr.run(until_time=SCENARIO_HORIZON, until_commits=10 ** 9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops_launches()
    sim = tr.sim.result
    times = [c.time for c in sim.commits]
    windows = {"before_leave": sum(t < leave.time for t in times),
               "leave_to_join": sum(leave.time <= t < join.time
                                    for t in times),
               "after_join": sum(t >= join.time for t in times)}
    late = [c.time for c in sim.commits
            if c.worker == leave.worker and c.time > leave.time]
    joined = sorted({c.worker for c in sim.commits} - {f"worker{i}"
                                                       for i in range(4)})
    pending = len(tr.sim._uid_meta)
    computed = setup["drawn"]["n"]
    summary = prof.summary(roofline_n=1, roofline_d=setup["flat_len"])
    model_bytes = summary["roofline"]["fused_bytes"]
    losses = [l for _, l in res.losses]
    emit({"phase": "scenario", "scenario": scen.name, "arch": FULL_ARCH,
          "horizon_s": SCENARIO_HORIZON,
          "events": [(type(e).__name__, e.time) for e in scen],
          "leaves": sim.leaves, "joins": sim.joins, "joined": joined,
          "commits": res.commits, "drops": res.drops,
          "updates_computed": computed, "pending": pending,
          "commit_windows": windows, "leaver_commits_after_leave": late,
          "delay_stats": res.delay_stats, "sim_time": res.sim_time,
          "loss_before": setup["loss_before"], "eval_losses": losses,
          "wall_s": wall, "wall_s_per_commit": wall / max(res.commits, 1),
          "launches": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
          "profiler": summary["metrics"],
          "roofline_n1": summary["roofline"],
          "roofline_fused_ms_at_hbm_rate":
              model_bytes / HBM_BYTES_PER_S * 1e3,
          "dequant_aggregate_ms": rows["dequant_aggregate"]["ms"]})
    check(sim.leaves == 1 and sim.joins == 1,
          f"scenario: {sim.leaves} leaves, {sim.joins} joins")
    check(all(n > 0 for n in windows.values()),
          f"scenario: a window without commits: {windows}")
    check(len(late) <= 1, f"scenario: {leave.worker} committed {late} after "
                          f"it left at {leave.time}")
    check(joined != [], "scenario: the joined worker never committed")
    check(computed == res.commits + res.drops + pending,
          f"scenario: {computed} updates computed, {res.commits} committed, "
          f"{res.drops} dropped, {pending} pending")
    check(bool(losses) and all(math.isfinite(l) for l in losses),
          f"scenario: eval losses {losses}")
    check(summary["metrics"]["commits"] == res.commits,
          "scenario: the profiler missed commits")
    _ties(launches, computed, "scenario")
    check(computed >= res.commits, "scenario: fewer updates than commits")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_moe_train() -> dict:
    """Cell I: MLfabric-A on the full-width granite-moe-1b-a400m (24
    layers of 32 experts, top 8, an f32 router beside bf16 experts) with
    cell A's settings, ``MOE_COMMITS`` commits: the int8 wire on the whole
    flat update, one quantize and one dequant_aggregate per update; every
    loss and aux loss finite and each aux loss above zero."""
    import torch

    dev = torch.device("cuda", 0)
    tr, setup = full_width_trainer(dev, arch=MOE_ARCH)
    model, cfg = setup["model"], setup["cfg"]
    setup["aux"].clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    res = tr.run(until_commits=MOE_COMMITS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    computed = setup["drawn"]["n"]
    aux = [float(a) for a in setup["aux"]]
    with torch.no_grad():
        total, m = model.loss_fn(tr.server.params, setup["eval_batch"])
    losses = [l for _, l in res.losses]
    emit({"phase": "moe_train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
          "params": setup["params"], "flat_len": setup["flat_len"],
          "dtype": "bfloat16", "router_dtype": str(
              tr.server.params["layers"]["mlp"]["router"].dtype),
          "seq_len": SEQ_LEN, "batch": BATCH, "n_workers": 4,
          "commits": res.commits, "drops": res.drops,
          "updates_computed": computed, "delay_stats": res.delay_stats,
          "loss_before": setup["loss_before"], "eval_losses": losses,
          "update_aux_losses": aux, "final_loss": float(m["loss"]),
          "final_aux_loss": float(m["aux_loss"]),
          # the stack sums its layers' losses: balanced routing reads 1 a
          # layer, all tokens on one expert n_experts
          "aux_loss_per_layer": [a / cfg.n_layers
                                 for a in aux + [float(m["aux_loss"])]],
          "wall_s": wall,
          "wall_s_per_commit": wall / max(res.commits, 1),
          "launches": launches, "max_memory_allocated": peak})
    check(res.commits >= MOE_COMMITS, f"moe_train: {res.commits} commits")
    check(bool(losses) and all(math.isfinite(l) for l in losses)
          and math.isfinite(float(total)), f"moe_train: losses {losses}")
    check(len(aux) == computed and all(math.isfinite(a) and a > 0
                                       for a in aux + [float(m["aux_loss"])]),
          f"moe_train: aux losses {aux}")
    _ties(launches, computed, "moe_train")
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class RouteHold:
    """Holds a sparse-expert model's routing fixed between two bf16 paths.

    A bf16 path through 24 layers of 32 experts routes some tokens to other
    experts than another bf16 path does: a near tie among the router's
    probabilities, then the capacity slots of every later token of its
    chunk; the changed tokens change the tokens that attend to them.  On
    the full-width granite-moe (random weights) the sound 32k prefill
    reads 102-130% off and moves 14-16% of its cache rows past
    ``MOE_PREFILL_TOL``, near a causal mask one key off (103-113%, 18-20%;
    ``scripts/serve_tolerance.py --free-routing``), so no limit on the
    free-running comparison tells a fault from sound.
    Inside ``with RouteHold() as hold``, ``hold.record()`` makes every call
    of ``models.moe.router_topk`` keep its choice of experts, and
    ``hold.replay(plan)`` makes the next run take the recorded choices
    back, call by call, with the gates read from its own router
    probabilities: the two paths then differ only continuously (attention,
    rounding, the gates), as a dense model's do.  ``plan=None`` replays in
    call order (another prefill); ``decode_plan(n_layers)`` turns the
    one-token steps of ``decode_built`` into the prefill's per-layer
    calls."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.topk = moe, moe.router_topk
        self.calls, self.plan = [], None
        moe.router_topk = self._router_topk
        return self

    def __exit__(self, *exc):
        self.moe.router_topk = self.topk

    def record(self) -> None:
        self.calls, self.plan = [], None

    def replay(self, plan=None) -> None:
        self.plan = list(self.calls if plan is None else plan)

    def decode_plan(self, n_layers: int) -> list:
        """Per layer, the recorded one-token steps' choices side by side
        along the sequence: what a prefill of those positions calls."""
        import torch
        steps = len(self.calls) // n_layers
        return [torch.cat([self.calls[t * n_layers + layer]
                           for t in range(steps)], dim=1)
                for layer in range(n_layers)]

    def _router_topk(self, probs, k):
        if self.plan is None:
            vals, idx = self.topk(probs, k)
            self.calls.append(idx)
            return vals, idx
        idx = self.plan.pop(0)
        check(tuple(idx.shape) == tuple(probs.shape[:-1]) + (k,),
              f"route hold: replayed {tuple(idx.shape)} for "
              f"{tuple(probs.shape)}")
        return probs.gather(-1, idx), idx


def prefill_limit(cfg) -> float:
    """The bf16 limit of ``cfg``'s serving prefill, "pallas" against
    "blockwise"."""
    if cfg.moe is not None:
        return MOE_PREFILL_TOL
    return VLM_PREFILL_TOL if cfg.frontend == "vision" else BF16_PREFILL_TOL


def routing_drops(calls, moe) -> dict:
    """How much a sparse-expert prefill dropped, from the routing that
    ``RouteHold`` recorded (one ``[G, T, K]`` tensor of expert indices a
    layer, each of the G rows a dispatch group with ``capacity(T)`` slots
    an expert), the slots claimed in ``_dispatch_chunk``'s priority order:
    per layer the share of (token, choice) pairs whose expert was full,
    and the largest share of tokens that lost every choice."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.moe import capacity
    shares, lost_all = [], 0.0
    for idx in calls:
        g, t, k = idx.shape
        cap = capacity(t, moe)
        counts = torch.zeros((g, moe.n_experts), dtype=torch.int64,
                             device=idx.device)
        kept = torch.zeros((g, t), dtype=torch.int64, device=idx.device)
        for c in range(k):
            onehot = F.one_hot(idx[..., c], moe.n_experts)
            pos = (torch.cumsum(onehot, 1) - 1 + counts[:, None]).gather(
                -1, idx[..., c, None])[..., 0]
            kept += pos < cap
            counts += onehot.sum(1)
        shares.append(1.0 - float(kept.sum()) / (g * t * k))
        lost_all = max(lost_all, float((kept == 0).float().mean()))
    return {"dropped_choice_share": shares,
            "dropped_choice_share_mean": sum(shares) / max(len(shares), 1),
            "tokens_lost_every_choice_max": lost_all}


def prefill_cell(phase: str, cfg, model, params, batch) -> tuple:
    """A prefill of ``batch`` through ``build_step`` under "pallas": 1
    warm-up and ``PREFILL_TIMED`` timed, one flash launch a layer each and
    nothing else; then under "blockwise", logits and cache within
    ``prefill_limit`` of the largest value.  For a config with experts
    the "blockwise" run records its routing and one more "pallas" prefill
    replays it (``RouteHold``): that pair is checked, within
    ``MOE_PREFILL_TOL``, and the timed prefill's free-running difference is
    printed beside it, with the share of choices the "blockwise" run
    dropped (``routing_drops``).  Returns the "pallas" logits and cache and the
    launches."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.models import attention

    dev = model.device
    b, n = batch["tokens"].shape
    seq = n + (batch["frontend_embeds"].shape[1]
               if "frontend_embeds" in batch else 0)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=seq,
                                global_batch=b)
    step = build_step(cfg, shape, make_host_mesh(device=dev))
    attention.set_attention_impl("pallas")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    secs = []
    for _ in range(1 + PREFILL_TIMED):
        t0 = time.perf_counter()
        logits, cache = step.fn(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = ops_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    held = {}
    with RouteHold() as hold:
        attention.set_attention_impl("blockwise")
        t0 = time.perf_counter()
        logits_bw, cache_bw = step.fn(params, batch)
        torch.cuda.synchronize()
        blockwise_s = time.perf_counter() - t0
        rel = prefill_rel(logits, cache, logits_bw, cache_bw)
        if cfg.moe is not None:
            held["drops_blockwise"] = routing_drops(hold.calls, cfg.moe)
            held["rel_err_free_routing"] = rel
            held["rows_free_routing"] = cache_row_stats(
                cache, cache_bw, MOE_PREFILL_TOL)
            attention.set_attention_impl("pallas")
            hold.replay()
            rel = prefill_rel(*step.fn(params, batch), logits_bw, cache_bw)
            held["routing_held_calls"] = len(hold.calls)
            attention.set_attention_impl("blockwise")
    s_prefill = sum(secs[1:]) / PREFILL_TIMED
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = cfg.n_layers * (1 + PREFILL_TIMED)
    emit({"phase": phase, "part": "prefill", "arch": cfg.name,
          "n_layers": cfg.n_layers, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "head_dim": cfg.head_dim, "dtype": "bfloat16", "impl": "pallas",
          "seq_len": seq, "text_tokens": n, "batch": b,
          "warmup_s": secs[0], "prefill_s": secs[1:],
          "s_per_prefill": s_prefill,
          "prompt_tokens_per_s": b * seq / s_prefill,
          "max_memory_allocated": peak, "launches": launches,
          "blockwise_s": blockwise_s, "rel_err_vs_blockwise": rel,
          **held, "top1_equal_vs_blockwise": bool(torch.equal(
              logits.argmax(-1), logits_bw.argmax(-1)))})
    check(launches == want, f"{phase}: prefill launched {launches}, want "
                            f"{want}")
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (b, cfg.padded_vocab), f"{phase}: logits")
    check(tuple(cache["layers"]["k"].shape) == (
        cfg.n_layers, b, seq, cfg.n_kv_heads, cfg.head_dim),
        f"{phase}: cache shape")
    limit = prefill_limit(cfg)
    check(all(r <= limit for r in rel.values()),
          f"{phase}: pallas and blockwise prefill differ: {rel}")
    del logits_bw, cache_bw
    return logits, cache, launches


def decode_after_prefill(phase: str, model, params, logits, cache,
                         steps: int) -> list:
    """``steps`` greedy decode steps that continue a prefill: its cache
    copied into one of ``steps`` more positions.  Returns the tokens."""
    import torch
    n_layers, b, seq = cache["layers"]["k"].shape[:3]
    dec = model.init_cache(b, seq + steps)
    for k, t in cache["layers"].items():
        dec["layers"][k][:, :, :seq].copy_(t)
    tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
    launches0 = ops_launches()
    secs, toks = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        logits, dec = model.decode_step(params, dec, tok, seq + i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()), f"{phase}: decode logits")
        tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
        toks.append(tok[:, 0].tolist())
    emit({"phase": phase, "part": "decode_after_prefill", "batch": b,
          "from_pos": seq, "steps": steps, "step_ms": [x * 1e3 for x in secs],
          "ms_per_step": sum(secs[1:]) / (steps - 1) * 1e3, "tokens": toks})
    check(ops_launches() == launches0, f"{phase}: decode launched kernels")
    return toks


def phase_moe_serve() -> dict:
    """Cell J: the full-width granite-moe-1b-a400m in bf16: a 32k prefill
    at batch 1 under "pallas" (flash at D 64, 16/8 heads, 24 launches a
    prefill; the experts' dispatch over 128 chunks of 256) against
    "blockwise" with the routing held (``RouteHold``; within
    ``MOE_PREFILL_TOL``), then ``AFTER_PREFILL_STEPS`` decode steps from
    it.  Prefill against teacher-forced decode runs at a drop-free capacity
    factor (the experts' count: a 256-token chunk, capacity 80, and a
    one-token step, capacity 1, drop other tokens by design) with the
    decode's routing held in the prefill (bf16 within ``MOE_CACHE_TOL``,
    f32 within ``F32_REL_TOL``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = get_config(MOE_ARCH)
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, 32768),
                           generator=gen, device=dev, dtype=torch.int32)
    logits, cache, launches = prefill_cell("moe_serve", cfg, model, params,
                                           {"tokens": tokens})
    decode_after_prefill("moe_serve", model, params, logits, cache,
                         AFTER_PREFILL_STEPS)
    del logits, cache, tokens
    gc.collect()
    torch.cuda.empty_cache()

    free = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    ).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        m = build_model(free, dtype=dtype, device=dev)
        p = tree_map(lambda t: t if t.dtype == torch.float32 else t.to(dtype),
                     params)
        limit = MOE_CACHE_TOL if dtype == torch.bfloat16 else F32_REL_TOL
        with RouteHold() as hold:
            dec = decode_built(m, p, prompts, SERVE_PROMPT + SERVE_NEW)
            hold.replay(hold.decode_plan(cfg.n_layers))
            r = prefill_vs_decode(m, p, prompts, *dec, row_limit=limit)
        name = str(dtype).removeprefix("torch.")
        emit({"phase": "moe_serve", "part": "prefill_vs_decode",
              "dtype": name, "capacity_factor": free.moe.capacity_factor,
              "routing": "held", "rows": SERVE_BATCH,
              "positions": SERVE_PROMPT, **r})
        check(all(v <= limit for v in r["cache_rel_err_max"].values()),
              f"moe_serve {name}: prefill and decode caches differ: {r}")
        if dtype == torch.float32:
            check(r["logits_rel_err"] <= F32_REL_TOL,
                  "moe_serve: f32 prefill and decode logits differ")
            check(r["top1_equal_rows"] >= SERVE_BATCH - 1,
                  f"moe_serve: prefill and decode top-1 agree on "
                  f"{r['top1_equal_rows']} of {SERVE_BATCH} rows")
        del m, p
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_vlm_serve() -> dict:
    """Cell K: the full-width phi-3-vision-4.2b backbone in bf16: a
    ``VLM_SEQ``-position prefill at batch 1 of 256 seeded stub patch
    embeddings and 3,840 text tokens under "pallas" (flash at D 96, 32/32
    heads, 32 launches a prefill) against "blockwise", then
    ``AFTER_PREFILL_STEPS`` decode steps from it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, text_len

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = get_config(VLM_ARCH)
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(6)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (PREFILL_BATCH, text_len(cfg, VLM_SEQ)),
        generator=gen, device=dev, dtype=torch.int32),
        "frontend_embeds": torch.randn(
            (PREFILL_BATCH, cfg.n_frontend_tokens, cfg.d_model),
            generator=gen, device=dev).to(torch.bfloat16)}
    logits, cache, launches = prefill_cell("vlm_serve", cfg, model, params,
                                           batch)
    decode_after_prefill("vlm_serve", model, params, logits, cache,
                         AFTER_PREFILL_STEPS)
    del logits, cache, batch, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_qwen2_7b_serve() -> dict:
    """Cell L: ``serve_cell`` on the full-width qwen2-7b: the 32k prefill
    (flash at D 128, 28/4 heads, 28 launches), decode at pos 32767 at
    batch ``DENSE_7B_DECODE_BATCH`` (a 30.1 GB bf16 cache beside 15.2 GB of
    weights; cell D's batch of 128 would need 240 GB), the serve loop and
    prefill against decode in bf16 and f32."""
    return serve_cell(DENSE_7B_ARCH, "qwen2_7b_serve",
                      DENSE_7B_DECODE_BATCH)


def _family_run(arch: str, device: str, init_np):
    """Reduced ``arch`` in f32: loss and aux loss under "blockwise" (the
    training impl), a prefill under "pallas" and ``FAMILY_PARITY_STEPS``
    teacher-forced decode steps, from the same params and seeded inputs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import to_torch
    from repro_torch.models import attention, build_model, text_len

    cfg = get_config(arch).reduced()
    model = build_model(cfg, dtype=torch.float32, device=device)
    params = to_torch(init_np, dtype=torch.float32, device=device)
    rng = np.random.default_rng(11)
    n = text_len(cfg, FAMILY_PARITY_SEQ)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, n)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (2, n)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["frontend_embeds"] = rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    with torch.no_grad():
        total, m = model.loss_fn(params, b)
    attention.set_attention_impl("pallas")
    try:
        logits, cache = model.prefill(
            params, {k: v for k, v in b.items() if k != "labels"})
    finally:
        attention.set_attention_impl("blockwise")
    dec = model.init_cache(2, FAMILY_PARITY_STEPS)
    steps = []
    for pos in range(FAMILY_PARITY_STEPS):
        lg, dec = model.decode_step(params, dec,
                                    b["tokens"][:, pos:pos + 1], pos)
        steps.append(lg.cpu())
    return {"total": float(total), "loss": float(m["loss"]),
            "aux_loss": float(m["aux_loss"]), "logits": logits.cpu(),
            "cache_k": cache["layers"]["k"].cpu(),
            "decode": torch.stack(steps)}


def phase_reduced_family_parity() -> None:
    """The reduced qwen2-7b, phi-3-vision (with patch embeddings) and
    granite-moe in f32, card against CPU from the same params: loss and aux
    loss within rtol 1e-4, prefill logits and cache and 4 decode steps'
    logits within atol 1e-4 / rtol 1e-4 (f32 sums in other orders, as
    ``reduced_serve_parity``); the card's prefill launches the flash kernel
    once a layer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import to_numpy
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    for arch in FAMILY_ARCHS:
        cfg = get_config(arch).reduced()
        init = to_numpy(build_model(cfg, dtype=torch.float32, device="cpu")
                        .init(torch.Generator().manual_seed(0)))
        before = ops.flash_attention_op.launches
        card = _family_run(arch, "cuda", init)
        check(ops.flash_attention_op.launches == before + cfg.n_layers,
              f"{arch}: the card's prefill did not launch the flash kernel "
              "once a layer")
        cpu = _family_run(arch, "cpu", init)
        errs = {k: abs(card[k] - cpu[k]) for k in ("total", "loss",
                                                   "aux_loss")}
        for k in ("logits", "cache_k", "decode"):
            errs[k] = float((card[k] - cpu[k]).abs().max())
        emit({"phase": "reduced_family_parity", "arch": arch,
              "moe": cfg.moe is not None, "frontend": cfg.frontend,
              "loss_card": card["loss"], "aux_loss_card": card["aux_loss"],
              "max_abs_err": errs})
        for k in ("total", "loss", "aux_loss"):
            check(errs[k] <= 1e-4 * abs(cpu[k]) + 1e-6,
                  f"{arch} {k}: card {card[k]} vs CPU {cpu[k]}")
        for k in ("logits", "cache_k", "decode"):
            check(torch.allclose(card[k], cpu[k], rtol=1e-4, atol=1e-4),
                  f"{arch} {k}: card and CPU differ by {errs[k]}")
        check((card["aux_loss"] > 0) == (cfg.moe is not None),
              f"{arch}: aux loss {card['aux_loss']}")


# --------------------------------------------------------------------------- #
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
    unfused_launches = phase_unfused_receive()
    phase_reduced_parity()
    launches = phase_main_path()
    phase_reduced_step_parity()
    phase_reduced_tier_parity()
    step_launches = phase_mlfabric_step()
    tier_launches_ = phase_tiers()
    phase_reduced_serve_parity()
    serve_launches = phase_serve()
    train_launches = phase_train()
    pod_launches = phase_pod_async()
    elastic_launches = phase_elastic()
    phase_reduced_ps_parity()
    phase_mlfabric_ranks()
    phase_reduced_family_parity()
    scenario_launches = phase_scenario(rows)
    moe_train_launches = phase_moe_train()
    moe_serve_launches = phase_moe_serve()
    vlm_launches = phase_vlm_serve()
    dense_7b_launches = phase_qwen2_7b_serve()
    import torch.distributed as dist
    dist.destroy_process_group()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    by_path = {"main_path": launches, "mlfabric_step": step_launches,
               "tiers": tier_launches_, "serve": serve_launches,
               "unfused_receive": unfused_launches, "train": train_launches,
               "pod_async": pod_launches, "elastic": elastic_launches,
               "scenario": scenario_launches, "moe_train": moe_train_launches,
               "moe_serve": moe_serve_launches, "vlm_serve": vlm_launches,
               "qwen2_7b_serve": dense_7b_launches}
    total = {k: sum(p.get(k, 0) for p in by_path.values()) for k in KERNELS}
    for k, n in total.items():
        check(n > 0, f"{k} was not launched on the main paths")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "launches_by_path": by_path})
    emit({"kernels": [{key: {**rows[k], "launches": total[k]}[key]
                       for key in keys} for k in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
