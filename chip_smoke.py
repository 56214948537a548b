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
8. ``dryrun`` (cell U): ``python -m repro_torch.launch.dryrun
   --save-hlo`` on one production cell, qwen2-0.5b ``train_4k`` on 16x16
   (rank 0 of a fake 256-rank world, fake tensors on the card), in a
   subprocess: ``ok``, its per-rank FLOPs, bytes, collective bytes and
   peak, and its trace seconds, its FLOPs a rank held within
   ``DRYRUN_FLOPS_RATIO`` of the reference's (``DRYRUN_REF_FLOPS``: the
   reference's dry-run, written here as a constant), its peak a rank
   below 80 GB, and its op listing's totals equal to its FLOPs and bytes
   a rank; before it, in the same subprocess, the softplus probe
   (``softplus_probe``: DTensor's decomposition search left uncounted
   under this card's torch, the peak held to ``PROBE_PEAK_RATIO`` of the
   local block), and after it the predictions of cell R's auto step's
   peak a rank and of cell S2's steps' on fake 4-rank worlds of their
   meshes (``sharded_prediction``, ``family_predictions``); beside it,
   ``DRYRUN_CELLS`` in two more subprocesses: ``DRYRUN_LONG`` (jamba's
   ``train_4k`` peak against the reference's) and the others
   (whisper-tiny, stablelm-1.6b, deepseek-v2's ``train_4k`` FLOPs and
   granite-moe's ``prefill_32k`` peak against the reference's).  It is
   started after the kernels' lines (``unfused_receive``) and read just
   before cell R (it traces on three of the host's CPU cores beside the
   card phases, which time the card, not the host).
   ``examples``: the five tensor twins of ``examples_torch/``
   (``async_vs_sync``, ``bounded_replication``, ``failover``,
   ``lda_topic_model``, ``serve_decode``) with their fast flags, each in
   a subprocess on the card, started and read beside cell U: each exits
   0 and prints; its output, seconds and launches are printed.  Here,
   before ``mlfabric_step``,
   the same analysis (``launch/op_analysis.py``) on this process's
   ``(pod=1, data=1)`` mesh predicts the peaks of cell T's two steps and
   of cell B's plain ``mlfabric_step``, printed before they run.
9. ``mlfabric_step``: the in-graph MLfabric step
   (``launch.steps.build_step(..., grad_path="mlfabric")``) on the
   full-width Qwen2-0.5B in bf16 at seq 4096, global batch 2, in three
   configurations of 1 warm-up and 3 timed steps each; finite losses,
   kernel launches equal to buckets x steps (x chunks), and agreement with
   the "auto" step; the plain configuration's first-step peak within
   ``PEAK_PRED_TOL`` of the dry-run's prediction.
10. ``tiers_setup`` and ``tiers``: ``mlfabric_grad_reduce`` of the
   full-width gradient (one forward and backward, 494,147,456 values, 10
   buckets) with the host, switch, hierarchical, keep_inter (25% transport
   drops) and switch + keep_inter tiers, 1 warm-up and 3 timed reduces
   each: ms per reduce, launches, peak memory and exact checks; then 3
   rounds of one sender's ``ErrorFeedback`` over the embedding bucket.
11. ``kernel`` lines for ``flash_attention`` (in step 3): Qwen2-0.5B's 14/2
   heads of 64 in bf16, causal, timed at (B 2, S 4096) and at the prefill
   shape (B 1, S 32768) beside its plain version, SDPA and its bound
   (both products on the bf16 tensor cores; the earlier bound with p.v
   at the f32 rate and the kernel's own four products beside it);
   checked, untimed, at D 32 f32, 32/32 heads, not causal, a ragged S of
   4000, on [B, S, H, D] views, D 128 f32, D 32 and 128 in bf16, S of 16
   and 48, and D 96 (bf16 ragged and not causal, f32 ragged, S 48).
   Within atol 2e-5 / rtol 1e-5 in f32 and one bf16 ulp in bf16.  Timed
   too, with SDPA and the bound: phi-3-vision's D 96 (32/32 heads, B 1,
   S 4096) in bf16 and f32, qwen2-7b's D 128 (28/4 heads, S 32768),
   jamba's attention layer (32/8 heads of 128, S 32768) and whisper's
   decoder prefill (B 32, S 32768, 6/6 heads of 64); checked, not causal,
   at the reduced whisper's encoder shape (S 16, 4/2 heads of 32).
12. ``reduced_serve_parity``: the reduced qwen2-0.5b and stablelm-1.6b in
   f32 under the "pallas" impl, card against CPU: prefill logits and
   cache, 24 decode steps (teacher-forced, then greedy) with the
   model-dtype and the int8 cache; greedy tokens identical.
13. ``serve``: the full-width Qwen2-0.5B in bf16: a 32k prefill through
   ``build_step(prefill_32k)`` at batch 1 (24 flash launches each) against
   the "blockwise" impl; a ``decode_32k`` step at batch 128 against a
   51.5 GB cache at pos 32767 (written in place); ``launch.serve.serve``
   on 8 requests of 128 tokens, batch 4, 64 new tokens; prefill against
   teacher-forced decode on the first batch, in bf16 and in f32.
14. ``train``: the training CLI (``launch.train``) on the full-width
   Qwen2-0.5B, 4 steps at batch 8 x seq 128 with checkpoints at steps 2
   and 4 and the bounded-divergence replica; the step-4 checkpoint moved
   out, the same command resumes from step 2 and must land on the same
   step-4 params and momentum, bit for bit.  Seconds per step, save and
   restore, the replica's syncs and savings, peak memory.
15. ``pod_async``: ``PodAsyncTrainer(compress=True)`` at full width, 4
   pods of 2 local steps at seq 256 x batch 2, 8 commits: one quantize
   and one dequant_aggregate launch per pod delta, nothing else.
16. ``elastic``: an ``ElasticSession`` with the CLI's step at full width
   and a replica; a ``ServerFail`` promotes it: the replica's step and
   params, its lead as ``lost_updates``, finite losses after.
17. ``reduced_ps_parity``: the reduced qwen2-0.5b in f32 through
   ``PodAsyncTrainer`` (int8 wire and without) and ``SyncTrainer``, card
   against CPU on seeds 0-2: identical schedules, params and losses within
   the limits stated at ``PS_PARITY_LEAF_TOL``; on seed 0 the int8 wire
   done on the host must give the kernels' params bit for bit, and a
   planted round-toward-zero wire must fail the limit.
18. ``mlfabric_ranks``: the same step on a 2-pod x 2-data world of four
   gloo processes sharing the card, reduced model, against the auto step;
   then the three tiers on that world.
19. ``reduced_family_parity``: the reduced qwen2-7b, phi-3-vision (with
   patch embeddings), granite-moe, deepseek-v2 (MLA), jamba (mamba and
   attention, experts on odd layers), rwkv6 and whisper (bf16 stub
   frames) in f32, card against CPU: loss, aux loss, the "pallas"
   prefill's logits and every cache entry and 4 decode steps; the flash
   launches of the reference's dispatch rule (``flash_launches``).
20. ``scenario``: cell A's MLfabric-A under
   ``scenarios.paper_dynamic_cluster(4, horizon=12)`` (a leave, an
   aggregator outage, a congestion wave, a join) with a ``PhaseProfiler``:
   commits in each window, the leaver's late commits, conservation of
   updates, launches per update, the profiler's roofline bytes beside
   ``dequant_aggregate``'s time.
21. ``moe_train``: MLfabric-A on the full-width granite-moe-1b-a400m
   (1.33 B parameters, an f32 router), 8 commits: the int8 wire on the
   whole flat update, finite losses, aux losses above zero.
22. ``moe_serve``: granite's 32k prefill at batch 1 under "pallas" (24
   flash launches a prefill) against "blockwise" with the routing held
   (``RouteHold``), 8 decode steps from it, and prefill against decode at
   a drop-free capacity with the decode's routing held.
23. ``vlm_serve``: phi-3-vision's 4096-position prefill (256 stub patch
   embeddings and 3,840 tokens; flash at D 96, 32 launches) against
   "blockwise", 8 decode steps from it.
24. ``qwen2_7b_serve``: cell D's serve phase on qwen2-7b (28 flash launches
   at D 128 a prefill; decode at pos 32767 at batch 16 on a 30.1 GB cache).
25. ``deepseek_serve`` (cell M): deepseek-v2-236b at its published widths
   (MLA ranks 1536/512 with rope 64, 160 routed and 2 shared experts, top
   6), 4 of 60 layers: a 4,096-token prefill (the blockwise loop, no
   kernel: bit-equal to "blockwise"), ``decode_32k`` at batch 128 on a
   19.3 GB latent cache, prefill against decode (bf16; f32 on one layer).
26. ``jamba_serve`` (cell N): jamba-v0.1-52b, one block of 8 layers (7
   mamba, 1 attention, experts on the 4 odd ones): the 32k prefill (one
   flash launch at D 128, 32/8 heads) against "blockwise" with the
   routing held, ``long_500k`` decode at pos 524287, prefill against
   decode with the recurrent states as the cache.
27. ``rwkv_serve`` (cell O): rwkv6-1.6b whole (24 layers): the 32k
   prefill (no kernel: bit-equal), ``long_500k`` decode beside a step at
   pos 0, the serve loop, prefill against decode.
28. ``whisper_serve`` (cell Q): whisper-tiny at its published widths (4 +
   4 layers, d 384, 6/6 heads of 64, 1,500 stub frames): ``prefill_32k``
   at its own batch of 32 beside seeded bf16 frames (4 flash launches a
   prefill, the decoder's; the encoder and the cross-attention take the
   blockwise loop) against "blockwise", ``decode_32k`` at batch 128 (pos
   32767 and 0; ``cross_kv`` read, never written), the serve loop (a
   prefill a batch under "pallas"), prefill against decode in bf16 and
   f32, and part ``train``: MLfabric-A with cell A's trainer, frames
   seeded by worker and step, the encoder's weights moving.
29. ``rwkv_train`` (cell P): MLfabric-A on the whole rwkv6-1.6b (1.23 B
   parameters), 8 commits: the backward through the WKV chunks.
30. ``sharded`` (cell R): the full-width Qwen2-0.5B tensor-parallel on a
   ``(pod=1, data=2, model=2)`` world of four gloo processes sharing the
   card (DTensor's collectives staged through the host): the auto,
   mlfabric and compressed steps at seq 4096 x batch 2 (the auto step's
   first-step peak a rank within ``SHARDED_PEAK_PRED_TOL`` of cell U's
   prediction), the 32k prefill under "pallas" on ``(1, 1, 4)`` (the 14
   q heads padded to 16, 4 a rank, the 2 KV heads replicated: 24 flash
   launches a rank) and 2 decode steps at batch 16, each against the
   unsharded step on the card; then the reduced model in f32, card
   against CPU; per-rank peaks beside the predicted per-rank param
   bytes.
31. ``sharded_families`` (cell S): on a world of four gloo processes
   sharing the card, first the reduced granite-moe, deepseek-v2, jamba
   (one group, "mamm"), rwkv6 and whisper in f32, card against CPU
   within 1e-4: the auto and MLfabric steps on ``(pod=1, data=2,
   model=2)`` and ``(1, 1, 4)``, the prefill under "pallas", 3 decode
   steps, and int8-cache decode on qwen2-0.5b and granite.  Then at
   full width against the unsharded runs on the card: S1, granite-moe
   whole, auto and MLfabric on ``(1, 2, 2)`` at seq 1,024 x batch 2
   (the MLfabric step launches ``grad_aggregate`` over ``data``); S2,
   one deepseek-v2 layer on ``(1, 1, 4)``: the donated auto step at seq
   1,024 x batch 2 on the unsharded step's routing, each rank's peak
   within ``SHARDED_PEAK_PRED_TOL`` of cell U's prediction (the compressed
   step only where four ranks of it are predicted to fit the card), the
   4,096-token prefill and 3 decode steps at batch 16 on a latent cache
   split over ``model``; S3, rwkv6 at 12 of its 24 layers, the auto step
   on ``(1, 1, 4)``; params held beside ``param_bytes_per_rank``,
   per-rank peaks, seconds per step.
32. ``deepseek_train`` (cell T): one deepseek-v2 layer at its published
   widths (5.02 B parameters with the embedding and head, bf16, seeded)
   trained through the donating call (``StepBundle.donating()``, the
   in-place eq.-2 update) at ``train_4k``'s seq 4096 x batch 2 on a
   ``(pod=1, data=1)`` mesh: the auto step, then the compressed MLfabric
   step (``quantize`` and ``dequant_aggregate`` once a bucket over a
   5.02 G-float flat gradient); each step must be predicted by the
   dry-run at or below ``DS_FIT_BYTES`` before it runs (else its peak
   and what holds it are printed and the run fails); 1 warm-up and 1
   timed step each.  Finite losses, every param
   and history leaf kept in place and moved (a seeded sample of 2^20
   entries a leaf), the peak below 80 GB and within ``PEAK_PRED_TOL`` of
   the prediction, the in-place update bit-equal to
   ``momentum_sgd_update`` on every full-width leaf, and the reduced
   deepseek-v2's donated auto and MLfabric steps card against CPU within
   1e-4.
33. The ``{"kernels": [...]}`` summary (seven kernels), then
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
def nvidia_smi_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"


def phase_device():
    import torch
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi_line(),
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


def stub_frames(cfg, batch: int, rng, dev):
    """``batch`` stub audio frames [batch, n_frames, d_model]: normals from
    the numpy generator ``rng``, in bf16 whatever the model's dtype, as
    ``launch.serve.serve`` draws them."""
    import torch
    return torch.from_numpy(rng.normal(
        size=(batch, cfg.encoder.n_frames, cfg.d_model))).to(
            device=dev, dtype=torch.bfloat16)


def full_width_trainer(dev, callbacks=(), remat: bool = False,
                       arch: str = FULL_ARCH, scenario=None):
    """The main path's trainer: MLfabric-A over the full-width ``arch``
    (Qwen2-0.5B by default) in bf16 from the port's seeded init,
    ``compress=True``, by default without the model's default ``remat``,
    under ``scenario`` if one is given.  An encoder-decoder's batches carry
    stub frames (``stub_frames``) seeded by worker and step.  Returns the
    trainer and a dict of what was set up (``drawn["n"]`` counts the
    batches drawn, one per update computed; ``aux`` the aux loss of each
    update's forward)."""
    import numpy as np
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

    def to_dev(b, seed):
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if cfg.encoder is not None:
            b["frontend_embeds"] = stub_frames(
                cfg, BATCH, np.random.default_rng(seed), dev)
        return b

    def data_fn(worker, t):
        drawn["n"] += 1
        w = int(worker.removeprefix("worker"))
        return to_dev(src.batch(w * 100003 + t, BATCH), (w, t))

    eval_batch = to_dev(src.batch(12345, BATCH), 12345)

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


def phase_mlfabric_step(pred: dict):
    """The in-graph MLfabric step on the full-width Qwen2-0.5B in bf16 at
    train_4k's seq 4096 with global batch 2 (not 256: one card's memory
    and this script's time), ``(pod=1, data=1)`` mesh, remat, 4 MiB
    buckets.  Three configurations of 1 warm-up and ``STEP_TIMED`` timed
    steps each; then one "auto" step from the same params against the
    first mlfabric step.  The plain configuration's first step's peak is
    held against ``pred``, the dry-run's."""
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
        at_start = torch.cuda.memory_allocated(dev)
        zero_launches()
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            p, o, m = step.fn(p, o, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                first_peak = torch.cuda.max_memory_allocated(dev)
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
        against = (peak_against_prediction(f"mlfabric_step {name}",
                                           first_peak, at_start, pred)
                   if name == "mlfabric" else {})
        emit({"phase": "mlfabric_step", "config": name, "arch": cfg.name,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "dtype": "bfloat16", "seq_len": shape.seq_len,
              "global_batch": STEP_BATCH, "mesh": mesh.shape,
              "buckets": n_buckets, "steps": len(batches), "losses": losses,
              "launches": launched, "warmup_s": secs[0], "step_s": timed,
              "s_per_step": s_step,
              "tokens_per_s": STEP_BATCH * shape.seq_len / s_step,
              "max_memory_allocated": peak,
              **{f"first_step_{k}": v for k, v in against.items()}})
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
# slice 8's families (cells M-O), by the same rule, each its own
# (scripts/serve_tolerance.py 6 --arch A).  deepseek-v2 and rwkv6 launch no
# kernel, so their two prefills must be bit-equal.  Prefill against decode:
# deepseek-v2 sound up to 1.95%, a float8 latent 7.2%; rwkv6 sound 2.6%,
# float8 r, k, v 7.4%, the token shift one step late 108%.  jamba (routing
# held): the 32k prefill sound up to 2.48%, float8 scan inputs 15.0%, the
# conv window one step late 149%; prefill against decode sound 5.37%,
# float8 14.2%, the conv 161%.  Its one attention layer in eight hides the
# attention faults in bf16 (the mask one key off, float8 q, k, v, the
# scale 1% off: 1.4-3.0%, as much as the sound readings); in f32 the mask
# (0.49% and up) and float8 (0.26%) pass F32_REL_TOL, and the flash
# kernel's own check at jamba's shape holds the kernel to one bf16 ulp
# whisper-tiny (cell Q, 4 + 4 layers; prefill at batch 32): the 32k
# prefill sound up to 1.09%, the cross-attention made causal 32.7%, the
# frames one step late 112%, the decoder positions one step late 25.4%,
# the causal mask one key off 8.1%; prefill against decode sound 1.03%,
# the same faults 42.1%, 112%, 31.4%, 11.8%.  Float8 q, k, v (1.6% and
# 2.1%) and the scale 1% off (0.9%) hide in bf16 among 8 layers; f32
# sees them (1.6% and 0.11% against F32_REL_TOL)
FAMILY_PREFILL_TOL = {"jamba-v0.1-52b": 5e-2, "whisper-tiny": 2.2e-2}
FAMILY_CACHE_TOL = {"deepseek-v2-236b": 4e-2, "jamba-v0.1-52b": 1.1e-1,
                    "rwkv6-1.6b": 5.2e-2, "whisper-tiny": 2.1e-2}


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
# 4096-position prefill) in both bodies, qwen2-7b's 28/4 heads of 128 at
# 32k, jamba's 32/8 heads of 128 (its attention layer, a GQA group of 4)
# at 32k, and whisper-tiny's decoder prefill (6/6 heads of 64, a group of
# 1) at prefill_32k's own batch of 32.  (B, H, KVH, S, D, dtype, seed)
FLASH_TIMED = {
    "qwen2-0.5b B 2 S 4096": (2, ATTN_HEADS, ATTN_KV_HEADS, 4096, ATTN_D,
                              "bfloat16", 4096),
    "qwen2-0.5b prefill": (PREFILL_BATCH, ATTN_HEADS, ATTN_KV_HEADS, 32768,
                           ATTN_D, "bfloat16", 32768),
    "phi-3-vision D 96 bf16": (1, 32, 32, 4096, 96, "bfloat16", 4192),
    "phi-3-vision D 96 f32": (1, 32, 32, 4096, 96, "float32", 4192),
    "qwen2-7b D 128 bf16": (1, 28, 4, 32768, 128, "bfloat16", 32896),
    "jamba D 128 32/8 bf16": (1, 32, 8, 32768, 128, "bfloat16", 33024),
    "whisper-tiny prefill": (32, 6, 6, 32768, 64, "bfloat16", 32832),
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
                # the reduced whisper's encoder and cross-attention (16
                # frames, 16 tokens): the kernel's only non-causal callers
                "whisper reduced S 16 not causal f32": (
                    2, 4, 2, 16, 32, torch.float32, False, True),
                "whisper reduced S 16 not causal bf16": (
                    2, 4, 2, 16, 32, torch.bfloat16, False, True),
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


# cache entries with a position axis ([stack, B, S, ...]): attention's k
# and v, MLA's latent; the others (mamba's conv and ssm, rwkv's shift, wkv
# and cm_shift) are states, the whole of which a prefill hands on.  An
# encoder-decoder's cache also holds the encoder's keys and values
# (``cross_kv``, [L, B, F, KVH, D] each), which decode reads and never
# writes: ``cache_entries`` names them ``CROSS``
POSITIONAL = ("k", "v", "ckv", "krope")
CROSS = ("cross_k", "cross_v")


def cache_slots(cache) -> list:
    """A cache's layer entries as a list of dicts of stacked tensors: one
    for a homogeneous stack, one a slot for a heterogeneous one."""
    layers = cache["layers"]
    return [layers] if isinstance(layers, dict) else list(layers)


def cache_entries(cache, cache_ref=None):
    """(name, tensor[, the reference's tensor]) for every cache entry, the
    reference's positional ones cut to the positions the first holds; the
    ``cross_kv`` pair as ``CROSS`` where both caches hold it."""
    slots = cache_slots(cache)
    refs = cache_slots(cache_ref) if cache_ref is not None else slots
    for slot, ref in zip(slots, refs):
        for k, t in slot.items():
            if cache_ref is None:
                yield k, t
            else:
                yield k, t, (ref[k][:, :, :t.shape[2]] if k in POSITIONAL
                             else ref[k])
    if "cross_kv" in cache and (cache_ref is None or "cross_kv" in cache_ref):
        for i, k in enumerate(CROSS):
            if cache_ref is None:
                yield k, cache["cross_kv"][i]
            else:
                yield k, cache["cross_kv"][i], cache_ref["cross_kv"][i]


def prefill_rel(logits, cache, logits_ref, cache_ref) -> dict:
    """Largest difference of two prefills' logits and cache entries (k and
    v, or each layer kind's), each over the largest value of the
    second."""
    out = {"logits": _bf16_rel(logits, logits_ref)}
    for k, a, b in cache_entries(cache, cache_ref):
        out[k] = max(out.get(k, 0.0), _bf16_rel(a, b))
    return out


def cache_row_stats(cache, cache_ref, limit: float) -> dict:
    """Per cache row (layer, batch row, position) of each positional
    entry: the largest difference over the largest value of ``cache_ref``
    (over the positions ``cache`` holds); the share of rows above
    ``limit`` and the median and 99th percentile of the rows' readings.
    A sparse-expert model's bf16 paths can route a token to other experts
    (a near tie in the router, or a capacity slot taken by a token before
    it), which moves that token's later rows as a whole: these say how
    many rows moved, where the largest reading says only that one did."""
    import torch
    rows = {}
    for k, a, b in cache_entries(cache, cache_ref):
        if k in POSITIONAL:
            a, b = a.float(), b.float()
            rows.setdefault(k, []).append(
                ((a - b).abs().amax(dim=tuple(range(3, a.dim())))
                 / max(float(b.abs().max()), 1e-30)).flatten())
    out = {}
    for k, r in rows.items():
        r = torch.cat(r)
        out[k] = {"rows_over": float((r > limit).float().mean()),
                  "q50": float(torch.quantile(r, 0.5)),
                  "q99": float(torch.quantile(r, 0.99))}
    return out


def decode_built(model, params, prompts, max_len: int, frames=None):
    """Teacher-forced decode of ``prompts`` from position 0 under
    "blockwise": (the logits at the last prompt position, the cache).  An
    encoder-decoder's cache takes ``cross_kv`` from a prefill of the
    prompts beside ``frames``, as ``launch.serve.serve`` does."""
    from repro_torch.models import attention
    attention.set_attention_impl("blockwise")
    cache = model.init_cache(prompts.shape[0], max_len)
    if frames is not None:
        cache["cross_kv"] = model.prefill(params, {
            "tokens": prompts, "frontend_embeds": frames})[1]["cross_kv"]
    for pos in range(prompts.shape[1]):
        logits, cache = model.decode_step(params, cache,
                                          prompts[:, pos:pos + 1], pos)
    return logits, cache


def prefill_vs_decode(model, params, prompts, logits_dec, cache_dec,
                      row_limit: float = None, frames=None) -> dict:
    """The "pallas" prefill of ``prompts`` (beside ``frames`` for an
    encoder-decoder) against the logits and cache that ``decode_built``
    gave for them: per layer, the largest difference of each cache entry
    (k and v, the latent, the recurrent states after the last prompt
    token, the encoder's ``cross_kv``) over the prefill's largest value,
    and the first layer's of each; the logits' difference;
    the prefill's top-1 margins and the rows whose top-1 agree; with
    ``row_limit``, ``cache_row_stats`` at that limit."""
    from repro_torch.models import attention
    attention.set_attention_impl("pallas")
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frontend_embeds"] = frames
    logits_pre, cache_pre = model.prefill(params, batch)
    attention.set_attention_impl("blockwise")
    rel = {}
    for k, pre, dec in cache_entries(cache_pre, cache_dec):
        rel.setdefault(k, []).extend(_bf16_rel(dec[i], pre[i])
                                     for i in range(pre.shape[0]))
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


def serve_loop(phase: str, cfg, model, params, launches_before: dict):
    """``launch.serve.serve`` on ``SERVE_REQUESTS`` seeded requests of
    ``SERVE_PROMPT`` tokens, batch ``SERVE_BATCH``, ``SERVE_NEW`` new
    tokens each; decode launches no kernel (the counts stay
    ``launches_before``).  An encoder-decoder's ``serve`` prefills each
    batch beside stub frames from the requests' generator; that runs
    under "pallas", so each prefill adds its flash launches
    (``flash_launches``).  Returns (the requests served, the launches)."""
    import numpy as np
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import attention

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, SERVE_PROMPT)
                    .astype(np.int32)) for i in range(SERVE_REQUESTS)]
    max_len = SERVE_PROMPT + SERVE_NEW
    want = dict(launches_before)
    if cfg.encoder is not None:
        attention.set_attention_impl("pallas")
        want["flash_attention"] += flash_launches(cfg, SERVE_PROMPT) * (
            SERVE_REQUESTS // SERVE_BATCH)
    try:
        done, steps, dt = serve(model, params, reqs, SERVE_BATCH, max_len,
                                rng)
    finally:
        attention.set_attention_impl("blockwise")
    launches = ops_launches()
    n_new = sum(len(r.output) for r in done)
    emit({"phase": phase, "part": "serve_loop", "requests": len(done),
          "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
          "max_new": SERVE_NEW, "decode_steps": steps, "seconds": dt,
          "steps_per_s": steps / dt, "generated_tokens": n_new,
          "generated_tokens_per_s": n_new / dt,
          "first_outputs": [r.output[:8] for r in done[:2]]})
    check(steps == SERVE_REQUESTS // SERVE_BATCH * (max_len - 1)
          and n_new == SERVE_REQUESTS * SERVE_NEW, "serve loop counts")
    check(launches == want, f"serve launched {launches}, want {want}")
    return done, launches


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

    done, serve_launches = serve_loop(phase, cfg, model, params,
                                      prefill_launches)
    max_len = SERVE_PROMPT + SERVE_NEW

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
              "batch": SERVE_BATCH, "positions": SERVE_PROMPT, **r})
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
FAMILY_ARCHS = ("qwen2-7b", "phi-3-vision-4.2b", "granite-moe-1b-a400m",
                "deepseek-v2-236b", "jamba-v0.1-52b", "rwkv6-1.6b",
                "whisper-tiny")
SCENARIO_HORIZON = 12.0
MOE_ARCH, FAMILY_COMMITS = "granite-moe-1b-a400m", 8
RWKV_ARCH, WHISPER_ARCH = "rwkv6-1.6b", "whisper-tiny"
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


def family_train(phase: str, arch: str, part: str = None) -> dict:
    """MLfabric-A on the full-width ``arch`` with cell A's settings,
    ``FAMILY_COMMITS`` commits: the int8 wire on the whole flat update, one
    quantize and one dequant_aggregate per update, every loss finite.  A
    config with experts (an f32 router beside bf16 experts) also holds
    each update's aux loss finite and above zero; an encoder-decoder's
    updates carry stub frames, and its encoder's weights must move (the
    gradient reaches them through the cross-attention).  Then
    ``wire_check`` holds both kernels against their plain versions at the
    arch's flat length.  The lines are ``phase``'s (with ``part``, if
    given)."""
    import torch
    from repro_torch.tree import tree_flatten_with_path

    dev = torch.device("cuda", 0)
    tr, setup = full_width_trainer(dev, arch=arch)
    model, cfg = setup["model"], setup["cfg"]
    setup["aux"].clear()
    encoder = ({n: t.clone() for n, t in tree_flatten_with_path(
        tr.server.params["encoder"])[0]} if cfg.encoder is not None else {})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    res = tr.run(until_commits=FAMILY_COMMITS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    computed = setup["drawn"]["n"]
    aux = [float(a) for a in setup["aux"]]
    with torch.no_grad():
        total, m = model.loss_fn(tr.server.params, setup["eval_batch"])
    losses = [l for _, l in res.losses]
    line = {"phase": phase, **({"part": part} if part else {}),
            "arch": cfg.name, "n_layers": cfg.n_layers,
            "params": setup["params"], "flat_len": setup["flat_len"],
            "dtype": "bfloat16", "seq_len": SEQ_LEN, "batch": BATCH,
            "n_workers": 4, "commits": res.commits, "drops": res.drops,
            "updates_computed": computed, "delay_stats": res.delay_stats,
            "loss_before": setup["loss_before"], "eval_losses": losses,
            "final_loss": float(m["loss"])}
    if cfg.moe is not None:
        line.update({
            "n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "router_dtype": str(
                tr.server.params["layers"]["mlp"]["router"].dtype),
            "update_aux_losses": aux, "final_aux_loss": float(m["aux_loss"]),
            # the stack sums its layers' losses: balanced routing reads 1 a
            # layer, all tokens on one expert n_experts
            "aux_loss_per_layer": [a / cfg.n_layers
                                   for a in aux + [float(m["aux_loss"])]]})
    moved = {}
    if cfg.encoder is not None:
        after = dict(tree_flatten_with_path(tr.server.params["encoder"])[0])
        moved = {n: int((after[n] != t).sum()) for n, t in encoder.items()}
        line.update({"encoder_layers": cfg.encoder.n_layers,
                     "frames": cfg.encoder.n_frames,
                     "encoder_elements_moved": moved})
    line.update({"wall_s": wall,
                 "wall_s_per_commit": wall / max(res.commits, 1),
                 "launches": launches, "max_memory_allocated": peak})
    emit(line)
    check(res.commits >= FAMILY_COMMITS, f"{phase}: {res.commits} commits")
    check(bool(losses) and all(math.isfinite(l) for l in losses)
          and math.isfinite(float(total)), f"{phase}: losses {losses}")
    if cfg.moe is not None:
        check(len(aux) == computed and all(
            math.isfinite(a) and a > 0 for a in aux + [float(m["aux_loss"])]),
            f"{phase}: aux losses {aux}")
    # every weight matrix of the encoder ([L, d_in, d_out]) moved; a bias or
    # a norm may round its small steps away in bf16
    check(all(n for name, n in moved.items() if encoder[name].dim() == 3),
          f"{phase}: encoder weights that did not move: {moved}")
    _ties(launches, computed, phase)
    worker, params = tr.workers["worker0"], tr.server.params
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    wire_check(phase, part, worker, params, setup["eval_batch"])
    del worker, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def wire_check(phase: str, part, worker, params, batch) -> None:
    """The wire at the trained arch's own flat length: one update of
    ``worker`` at ``params`` goes through ``flat_compress_roundtrip``, the
    function each update of the run went through, and its quantize and
    dequant_aggregate launches are held bit for bit against
    ``quantize_plain`` and ``dequant_aggregate_plain`` on the same tensors
    (the norm within 1e-5, as the kernel rows hold it).  Its launches
    count on the stand-ins that capture the tensors, one each, and never
    on the path's counts."""
    import torch
    from repro_torch.dist.flatbuf import flat_compress_roundtrip
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_aggregate import dequant_aggregate_plain
    from repro_torch.kernels.quantize import quantize_plain

    seen = {}
    quantize_op, dequant_op = ops.quantize_op, ops.dequant_aggregate_op

    def quantize_seen(x, **kw):
        seen["x"], seen["q"] = x, quantize_op(x, **kw)
        return seen["q"]

    def dequant_seen(q, s, w, **kw):
        seen["args"], seen["kw"] = (q, s, w), kw
        seen["agg"] = dequant_op(q, s, w, **kw)
        return seen["agg"]

    # each op counts on the module's attribute, here the stand-in's own
    # count: these launches stay out of the path's
    quantize_seen.launches = dequant_seen.launches = 0
    update, _ = worker.compute_update(params, batch, version=0, t=1)
    ops.quantize_op, ops.dequant_aggregate_op = quantize_seen, dequant_seen
    try:
        flat_compress_roundtrip(update)
    finally:
        ops.quantize_op, ops.dequant_aggregate_op = quantize_op, dequant_op
    del update
    x, (q_k, s_k) = seen.pop("x"), seen.pop("q")
    q_p, s_p = quantize_plain(x)
    torch.cuda.synchronize()
    q_equal = bool(torch.equal(q_k, q_p)) and bool(torch.equal(s_k, s_p))
    d = x.numel()
    del x, q_p, s_p, q_k, s_k
    agg_k, ssq_k = seen.pop("agg")
    agg_p, ssq_p = dequant_aggregate_plain(*seen.pop("args"), **seen["kw"])
    torch.cuda.synchronize()
    agg_equal = bool(torch.equal(agg_k, agg_p))
    err = float((agg_k - agg_p).abs().max())
    ssq_err = rel_err(ssq_k, ssq_p)
    del agg_k, agg_p
    emit({"phase": phase, **({"part": part} if part else {}),
          "check": "wire", "flat_len": d, "quantize_bit_equal": q_equal,
          "dequant_aggregate_bit_equal": agg_equal,
          "dequant_aggregate_max_abs_err": err, "ssq_rel_err": ssq_err,
          "launches": {"quantize": quantize_seen.launches,
                       "dequant_aggregate": dequant_seen.launches}})
    check(quantize_seen.launches == dequant_seen.launches == 1,
          f"{phase}: the wire check launched {quantize_seen.launches} "
          f"quantize and {dequant_seen.launches} dequant_aggregate")
    check(q_equal, f"{phase}: quantize differs from its plain version at "
                   f"{d} floats")
    check(agg_equal and ssq_err <= 1e-5,
          f"{phase}: dequant_aggregate differs from its plain version at "
          f"{d} floats: max abs err {err}, ssq rel err {ssq_err}")


def phase_moe_train() -> dict:
    """Cell I: ``family_train`` on the full-width granite-moe-1b-a400m (24
    layers of 32 experts, top 8, an f32 router beside bf16 experts)."""
    return family_train("moe_train", MOE_ARCH)


def phase_rwkv_train() -> dict:
    """Cell P: ``family_train`` on the whole rwkv6-1.6b (24 layers,
    1,229,979,648 parameters): the backward through the WKV chunk loop."""
    return family_train("rwkv_train", RWKV_ARCH)


def phase_whisper_train() -> dict:
    """Cell Q's training part: ``family_train`` on the full-width
    whisper-tiny (4 + 4 layers, 1,500 stub frames an example)."""
    return family_train("whisper_serve", WHISPER_ARCH, part="train")


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
    call order (another prefill); ``decode_plan(n_moe)`` turns the
    one-token steps of ``decode_built`` (``n_moe`` router calls each, one
    an expert layer) into the prefill's per-layer calls."""

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

    def decode_plan(self, n_moe: int) -> list:
        """Per expert layer, the recorded one-token steps' choices side by
        side along the sequence: what a prefill of those positions
        calls."""
        import torch
        steps = len(self.calls) // n_moe
        return [torch.cat([self.calls[t * n_moe + layer]
                           for t in range(steps)], dim=1)
                for layer in range(n_moe)]

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


def moe_layers(cfg) -> int:
    """The layers with experts: the router calls of one decode step."""
    return sum(cfg.moe is not None and cfg.moe.is_moe_layer(i)
               for i in range(cfg.n_layers))


def prefill_limit(cfg) -> float:
    """The bf16 limit of ``cfg``'s serving prefill, "pallas" against
    "blockwise": 0 (bit-equal) where no attention layer runs a kernel."""
    if attention_layers(cfg) == 0:
        return 0.0
    if cfg.name in FAMILY_PREFILL_TOL:
        return FAMILY_PREFILL_TOL[cfg.name]
    if cfg.moe is not None:
        return MOE_PREFILL_TOL
    return VLM_PREFILL_TOL if cfg.frontend == "vision" else BF16_PREFILL_TOL


def cache_limit(cfg) -> float:
    """The bf16 limit of ``cfg``'s prefill against the decode-built
    cache."""
    if cfg.name in FAMILY_CACHE_TOL:
        return FAMILY_CACHE_TOL[cfg.name]
    return MOE_CACHE_TOL if cfg.moe is not None else BF16_CACHE_TOL


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


def attention_layers(cfg) -> int:
    """The decoder's layers of kind "a": those that can reach the flash
    kernel."""
    return sum(k == "a" for k in cfg.layer_kinds)


def flash_launches(cfg, seq: int) -> int:
    """The flash kernel's launches in a "pallas" prefill of ``seq``
    positions, by the reference's dispatch rule (``Sq == Skv``, a multiple
    of 16; ``models/attention.py:blockwise_attention``): one a decoder
    layer of kind "a"; an encoder-decoder adds one an encoder layer when
    its frames are a multiple of 16 (whisper's 1,500 are not) and one a
    cross layer when the tokens are as many as the frames."""
    n = attention_layers(cfg) if seq % 16 == 0 else 0
    if cfg.encoder is not None and cfg.encoder.n_frames % 16 == 0:
        n += cfg.encoder.n_layers + cfg.n_layers * (
            seq == cfg.encoder.n_frames)
    return n


def cache_layout(cfg, batch: int, seq: int) -> list:
    """``cache_slots``' shapes of a cache of ``seq`` positions (a
    prefill's or ``init_cache``'s), from the model's own spec."""
    from repro_torch.models import transformer as tf
    gs = cfg.group_size
    n = cfg.n_layers if gs == 1 else cfg.n_groups
    return [{k: (n,) + shape for k, (shape, _) in tf.layer_cache_spec(
        cfg, s, batch, seq).items()} for s in range(gs)]


def prefill_cell(phase: str, cfg, model, params, batch,
                 reduced: dict = None) -> tuple:
    """A prefill of ``batch`` through ``build_step`` under "pallas": 1
    warm-up and ``PREFILL_TIMED`` timed, one flash launch an attention
    layer each and nothing else; then under "blockwise", logits and cache within
    ``prefill_limit`` of the largest value.  For a config with experts
    the "blockwise" run records its routing and, where a kernel runs, one
    more "pallas" prefill replays it (``RouteHold``): that pair is checked, within
    ``MOE_PREFILL_TOL``, and the timed prefill's free-running difference is
    printed beside it, with the share of choices the "blockwise" run
    dropped (``routing_drops``).  A config with no attention layer launches
    nothing, and its two prefills must be bit-equal (``prefill_limit``
    0).  ``reduced`` (the
    cuts of a cell) goes into the printed line.  Returns the "pallas"
    logits and cache and the launches."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.models import attention

    dev = model.device
    reduced = reduced or {}
    n_attn = attention_layers(cfg)
    b, n = batch["tokens"].shape
    seq = n + (batch["frontend_embeds"].shape[1]
               if cfg.frontend == "vision" and "frontend_embeds" in batch
               else 0)
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
        if cfg.moe is not None and n_attn:
            attention.set_attention_impl("pallas")
            hold.replay()
            rel = prefill_rel(*step.fn(params, batch), logits_bw, cache_bw)
            held["routing_held_calls"] = len(hold.calls)
            attention.set_attention_impl("blockwise")
    s_prefill = sum(secs[1:]) / PREFILL_TIMED
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = flash_launches(cfg, seq) * (1 + PREFILL_TIMED)
    frames = ({"encoder_layers": cfg.encoder.n_layers,
               "frames": cfg.encoder.n_frames}
              if cfg.encoder is not None else {})
    emit({"phase": phase, "part": "prefill", "arch": cfg.name,
          "n_layers": cfg.n_layers, **frames,
          "heads": [cfg.n_heads, cfg.n_kv_heads],
          "head_dim": cfg.head_dim if cfg.mla is None else [
              cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
              cfg.mla.v_head_dim],
          "dtype": "bfloat16", "impl": "pallas",
          "layer_pattern": cfg.layer_pattern, "attention_layers": n_attn,
          "flash_launches_per_prefill": flash_launches(cfg, seq),
          **reduced,
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
    check([{k: tuple(t.shape) for k, t in slot.items()}
           for slot in cache_slots(cache)] == cache_layout(cfg, b, seq),
          f"{phase}: cache shape")
    if cfg.encoder is not None:
        check([tuple(t.shape) for t in cache["cross_kv"]] == [(
            cfg.n_layers, b, cfg.encoder.n_frames, cfg.n_kv_heads,
            cfg.head_dim)] * 2, f"{phase}: cross_kv shape")
    limit = prefill_limit(cfg)
    check(all(r <= limit for r in rel.values()),
          f"{phase}: pallas and blockwise prefill differ: {rel}")
    del logits_bw, cache_bw
    return logits, cache, launches


def decode_after_prefill(phase: str, model, params, logits, cache,
                         steps: int, seq: int) -> list:
    """``steps`` greedy decode steps that continue a prefill of ``seq``
    positions: its cache copied into one of ``steps`` more positions (the
    recurrent states whole).  Returns the tokens."""
    import torch
    b = logits.shape[0]
    dec = model.init_cache(b, seq + steps)
    for _, t, d in cache_entries(cache, dec):
        d.copy_(t)
    if "cross_kv" in cache:
        dec["cross_kv"] = cache["cross_kv"]
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
                         AFTER_PREFILL_STEPS, tokens.shape[1])
    del logits, cache, tokens
    gc.collect()
    torch.cuda.empty_cache()

    free = drop_free(cfg)
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
            hold.replay(hold.decode_plan(moe_layers(cfg)))
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
                         AFTER_PREFILL_STEPS, VLM_SEQ)
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


# --------------------------------------------------------------------------- #
# slice 10: the dense decoder tensor-parallel on a model axis (cell R)
# --------------------------------------------------------------------------- #
SHARDED_MESH = ((1, 2, 2), ("pod", "data", "model"))
# the 32k prefill's mesh: qwen2-0.5b's 14 q heads padded to 16 over 4
# ranks, 4 a rank, its 2 KV heads replicated (the padded head split)
SHARDED_PREFILL_MESH = ((1, 1, 4), ("pod", "data", "model"))
# the auto step's measured peak a rank against the dry-run's prediction
# on a fake 4-rank world of the same mesh (``sharded_prediction``)
SHARDED_PEAK_PRED_TOL = 0.05
SHARDED_TRAIN = {"auto": {}, "mlfabric": {"grad_path": "mlfabric"},
                 "compressed": {"grad_path": "mlfabric",
                                "compress_inter": True}}
# timed steps after 1 warm-up, per config, and decode steps: 2 and 3 cut to
# 1 and 2 when cell S joined (the whole script measured 1,010 s of its
# 1,100 s budget, and cell R's host-bound steps spread 15-35% a run)
SHARDED_TIMED = 1
SHARDED_DECODE_BATCH = 16        # decode_32k's batch 128, cut to 16
SHARDED_DECODE_STEPS = 2
SHARDED_CUTS = [
    "train_4k at global batch 2, not 256; 1 warm-up and 1 timed step of "
    "each step (2 before cell S joined)",
    "prefill_32k at batch 1, not 32",
    "decode_32k at batch 16, not 128, 2 steps at its last positions (3 "
    "before cell S joined)"]
SHARDED_BF16_TOL = 3e-2          # cell B's rule: loss and params
SHARDED_REDUCED_SEQ, SHARDED_REDUCED_BATCH = 32, 8
SHARDED_REDUCED_DECODE = 64      # cache positions of the reduced decode


def sharded_cache(cfg, batch: int, seq: int, dev, keep=None):
    """A ``decode_32k``-shaped cache filled as ``serve_cell`` fills one:
    each stacked entry in turn (k then v; MLA's ckv then krope), one
    layer's normals at a time from a generator seeded 6 on the card.
    ``keep(name, layer_tensor)`` cuts what each layer keeps (a rank's
    block); by default the whole cache."""
    import torch
    from repro_torch.models import transformer as tf
    gen = torch.Generator(device=dev).manual_seed(6)
    spec = tf.layer_cache_spec(cfg, 0, batch, seq, torch.bfloat16)
    out = {}
    for name, (shape, dtype) in spec.items():
        layers = []
        for _ in range(cfg.n_layers):
            t = torch.empty(shape, dtype=dtype, device=dev)
            t.normal_(generator=gen)
            layers.append(keep(name, t).clone() if keep else t)
        out[name] = torch.stack(layers)
        del layers
    return {"layers": out}


def sharded_inputs(cfg, dev):
    """The seeded inputs both runs of cell R take: cell B's batches, the
    32k prefill's tokens, and per decode step its tokens and position (the
    last ``SHARDED_DECODE_STEPS`` of ``decode_32k``)."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.data import SyntheticLM
    src = SyntheticLM(cfg.vocab_size, SHAPES["train_4k"].seq_len, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in src.batch(i, STEP_BATCH).items()}
               for i in range(1 + SHARDED_TIMED)]
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size,
                           (PREFILL_BATCH, SHAPES["prefill_32k"].seq_len),
                           generator=gen, device=dev, dtype=torch.int32)
    seq = SHAPES["decode_32k"].seq_len
    steps = [(torch.randint(0, cfg.vocab_size, (SHARDED_DECODE_BATCH, 1),
                            generator=gen, device=dev, dtype=torch.int32),
              seq - SHARDED_DECODE_STEPS + i)
             for i in range(SHARDED_DECODE_STEPS)]
    return batches, prompt, steps


def sharded_shapes():
    from repro_torch.configs import SHAPES
    return {"train": dataclasses.replace(SHAPES["train_4k"],
                                         global_batch=STEP_BATCH),
            "prefill": dataclasses.replace(SHAPES["prefill_32k"],
                                           global_batch=PREFILL_BATCH),
            "decode": dataclasses.replace(SHAPES["decode_32k"],
                                          global_batch=SHARDED_DECODE_BATCH)}


def sharded_reference(out_dir: str) -> dict:
    """Cell R's unsharded runs, on this process's world of one from the
    same seeds: one step of each training config, the 32k prefill under
    "pallas", and the decode steps; written to ``out_dir`` for the ranks
    (host copies)."""
    import torch
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.models import attention
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda", 0)
    cfg, model, params = _full_width_model(dev)
    mesh = make_host_mesh(device=dev)
    batches, prompt, steps = sharded_inputs(cfg, dev)
    shapes = sharded_shapes()
    t0 = time.perf_counter()
    for name, kw in SHARDED_TRAIN.items():
        step = build_step(cfg, shapes["train"], mesh, lr=STEP_LR,
                          gamma=STEP_GAMMA, remat=True, **kw)
        p, _, m = step.fn(params, momentum_sgd_init(params), batches[0])
        torch.save({"loss": float(m["loss"]),
                    "params": [t.cpu() for t in tree_leaves(p)]},
                   f"{out_dir}/{name}.pt")
        del p, m, step
    attention.set_attention_impl("pallas")
    try:
        logits, cache = build_step(cfg, shapes["prefill"], mesh).fn(
            params, {"tokens": prompt})
    finally:
        attention.set_attention_impl("blockwise")
    torch.save({"logits": logits.cpu(),
                "cache": {k: t.cpu() for k, t in cache["layers"].items()}},
               f"{out_dir}/prefill.pt")
    del logits, cache
    cache = sharded_cache(cfg, SHARDED_DECODE_BATCH,
                          shapes["decode"].seq_len, dev)
    step = build_step(cfg, shapes["decode"], mesh)
    out = []
    for tok, pos in steps:
        logits, cache = step.fn(params, cache, tok, pos)
        out.append({"logits": logits.cpu(), "pos": pos,
                    "rows": {k: t[:, :, pos].cpu()
                             for k, t in cache["layers"].items()}})
    torch.save(out, f"{out_dir}/decode.pt")
    del cache, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"reference_s": time.perf_counter() - t0}


def _block_err(local, ref, sl) -> float:
    """Largest difference of a rank's block from the reference's block
    over the reference's largest value (``_bf16_rel``'s measure)."""
    return float((local.float().cpu() - ref[sl].float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


def prefill_heads(r: int) -> list:
    """(q heads, kv heads) of each of the 32k prefill's 24 flash launches
    on the rank at ``model`` coordinate ``r`` of ``SHARDED_PREFILL_MESH``:
    14 q heads padded to 16, 4 a rank, and the kv heads they read."""
    from repro_torch.models.attention import local_heads, local_kv
    heads, kv_of = local_heads(ATTN_HEADS, ATTN_KV_HEADS,
                               SHARDED_PREFILL_MESH[0][2], r)
    return [[len(heads), len(local_kv(kv_of))]] * 24


def sharded_rank(ref_dir: str) -> None:
    """One rank of cell R's world (four gloo processes on the one card,
    DTensor's collectives staged through the host): the full-width
    training configs, the 32k prefill and the decode steps, each against
    the unsharded reference in ``ref_dir``; then the reduced model in f32
    on the card against the same world on the CPU.  Prints one JSON line."""
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import plan_reduce
    from repro_torch.launch import build_step, init_rank, make_mesh
    from repro_torch.models import attention, build_model
    from repro_torch.models import transformer as tf
    from repro_torch.models.api import params_specs
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_flatten, tree_leaves, tree_map

    rank, world, _ = init_rank("gloo", host_staged_collectives=True)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = make_mesh(*SHARDED_MESH, device=dev)
    res = {"rank": rank, "coords": mesh.coords}
    cfg, _, full = _full_width_model(dev)
    specs = shd.param_shardings(cfg, mesh, full)
    res["param_bytes_predicted"] = shd.param_bytes_per_rank(
        cfg, mesh, params_specs(cfg))
    batches, prompt, steps = sharded_inputs(cfg, dev)
    shapes = sharded_shapes()

    def blocks(tree, spec_tree):
        return [(t.to_local(), shd.shard_slices(mesh, s, tuple(t.shape),
                                                mesh.coords))
                for t, s in zip(tree_leaves(tree), tree_leaves(spec_tree))]

    # -- training: auto, mlfabric, compressed -----------------------------
    res["train"] = {}
    for name, kw in SHARDED_TRAIN.items():
        sp = specs if name == "auto" else tree_map(shd.strip_data, specs)
        p = shd.shard_tree(full, mesh, sp)
        if name == "auto":
            res["param_bytes_held"] = sum(t.to_local().numel()
                                          * t.element_size()
                                          for t in tree_leaves(p))
        o = momentum_sgd_init(p)
        step = build_step(cfg, shapes["train"], mesh, lr=STEP_LR,
                          gamma=STEP_GAMMA, remat=True, **kw)
        ref = torch.load(f"{ref_dir}/{name}.pt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        at_start = torch.cuda.memory_allocated(dev)
        zero_launches()
        losses, secs = [], []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            p, o, m = step.fn(p, o, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            if i == 0:
                first_peak = torch.cuda.max_memory_allocated(dev)
                close, worst = True, 0.0
                for (t, sl), r in zip(blocks(p, sp), ref["params"]):
                    a, b_ = t.float().cpu(), r[sl].float()
                    close &= bool(torch.allclose(a, b_, rtol=SHARDED_BF16_TOL,
                                                 atol=SHARDED_BF16_TOL))
                    worst = max(worst, float((a - b_).abs().max()))
                first = {"loss_ref": ref["loss"], "params_close": close,
                         "max_abs_param_diff": worst,
                         "placements_kept": all(
                             tuple(a.placements) == tuple(shd.placements(
                                 mesh, s)) for a, s in zip(
                                 tree_leaves(p), tree_leaves(sp)))}
        res["train"][name] = {
            **first, "losses": losses, "warmup_s": secs[0],
            "allocated_at_start": at_start, "first_step_peak": first_peak,
            "step_s": secs[1:], "s_per_step": sum(secs[1:]) / SHARDED_TIMED,
            "launches": ops_launches(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
        del p, o, step, ref
        gc.collect()
        torch.cuda.empty_cache()

    # -- the 32k prefill under "pallas" on (1, 1, 4): the flash kernel on
    # each rank's 4 padded q heads --
    pmesh = make_mesh(*SHARDED_PREFILL_MESH, device=dev)
    p = shd.shard_tree(full, pmesh, shd.param_shardings(cfg, pmesh, full))
    heads = []
    flash = attention.flash_attention_op

    def recording(q, k, v, **kw):
        heads.append((int(q.shape[1]), int(k.shape[1])))
        return flash(q, k, v, **kw)

    attention.flash_attention_op = recording
    attention.set_attention_impl("pallas")
    step = build_step(cfg, shapes["prefill"], pmesh)
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits, cache = step.fn(p, {"tokens": prompt})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    attention.set_attention_impl("blockwise")
    attention.flash_attention_op = flash
    ref = torch.load(f"{ref_dir}/prefill.pt")
    lspec = shd._fit_spec(pmesh, shd.P(None, "model"), tuple(logits.shape))
    err = {"logits": _block_err(logits.to_local(), ref["logits"],
                                shd.shard_slices(pmesh, lspec,
                                                 tuple(logits.shape),
                                                 pmesh.coords))}
    cspecs = shd.cache_shardings(cfg, pmesh, cache, PREFILL_BATCH)
    for k, t in cache["layers"].items():
        err[k] = _block_err(t.to_local(), ref["cache"][k], shd.shard_slices(
            pmesh, cspecs["layers"][k], tuple(t.shape), pmesh.coords))
    res["prefill"] = {"mesh": SHARDED_PREFILL_MESH, "rel_err": err,
                      "s": secs, "launches": ops_launches(),
                      "flash_heads": heads, "want_heads": prefill_heads(
                          pmesh.coords["model"]),
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated(dev)}
    del logits, cache, ref, step, p
    gc.collect()
    torch.cuda.empty_cache()
    p = shd.shard_tree(full, mesh, specs)
    del full

    # -- decode at decode_32k's positions, batch 16 ------------------------
    seq = shapes["decode"].seq_len
    abstract = tf.init_cache(cfg, SHARDED_DECODE_BATCH, seq, torch.bfloat16,
                             device="meta")
    cspecs = shd.cache_shardings(cfg, mesh, abstract, SHARDED_DECODE_BATCH)
    cache = {"layers": {}}
    local = sharded_cache(
        cfg, SHARDED_DECODE_BATCH, seq, dev,
        keep=lambda name, t: t[shd.shard_slices(
            mesh, shd.P(*tuple(cspecs["layers"][name])[1:]), tuple(t.shape),
            mesh.coords)])
    from torch.distributed.tensor import DTensor
    for k, t in local["layers"].items():
        sp = cspecs["layers"][k]
        cache["layers"][k] = DTensor.from_local(
            t, mesh.device_mesh, shd.placements(mesh, sp), run_check=False)
        check(cache["layers"][k].shape == abstract["layers"][k].shape,
              f"sharded cache {k}: {cache['layers'][k].shape}")
    del local
    ref = torch.load(f"{ref_dir}/decode.pt")
    step = build_step(cfg, shapes["decode"], mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    errs, secs = [], []
    for (tok, pos), r in zip(steps, ref):
        t0 = time.perf_counter()
        logits, cache = step.fn(p, cache, tok, pos)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        lspec = shd._fit_spec(mesh, shd.P(("pod", "data"), "model"),
                              tuple(logits.shape))
        e = {"logits": _block_err(logits.to_local(), r["logits"],
                                  shd.shard_slices(mesh, lspec,
                                                   tuple(logits.shape),
                                                   mesh.coords))}
        for k, t in cache["layers"].items():
            sl = shd.shard_slices(mesh, cspecs["layers"][k], tuple(t.shape),
                                  mesh.coords)
            lo = sl[2].start or 0
            if lo <= pos < lo + t.to_local().shape[2]:
                e[k] = _block_err(t.to_local()[:, :, pos - lo],
                                  r["rows"][k], (slice(None), sl[1]))
        errs.append(e)
    res["decode"] = {"rel_err": errs, "s": secs, "launches": ops_launches(),
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated(dev)}
    del cache, p, ref, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- the reduced model in f32: card against the same world on the CPU --
    rcfg = get_config(FULL_ARCH).reduced()
    shape = dataclasses.replace(get_shape("train_4k"),
                                seq_len=SHARDED_REDUCED_SEQ,
                                global_batch=SHARDED_REDUCED_BATCH)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        rcfg.vocab_size, SHARDED_REDUCED_SEQ, seed=0).batch(
        0, SHARDED_REDUCED_BATCH).items()}
    pshape = dataclasses.replace(get_shape("prefill_32k"),
                                 seq_len=SHARDED_REDUCED_SEQ,
                                 global_batch=4)
    dshape = dataclasses.replace(get_shape("decode_32k"),
                                 seq_len=SHARDED_REDUCED_DECODE,
                                 global_batch=4)
    runs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m_ = mesh if where == "card" else make_mesh(*SHARDED_MESH,
                                                    device="cpu")
        params = build_model(rcfg, dtype=torch.float32, device=d).init(
            torch.Generator().manual_seed(0))
        rspecs = shd.param_shardings(rcfg, m_, params)
        out = {}
        for name, kw in SHARDED_TRAIN.items():
            sp = rspecs if name == "auto" else tree_map(shd.strip_data,
                                                        rspecs)
            dp = shd.shard_tree(params, m_, sp)
            extra = {} if name == "auto" else {"bucket_bytes": 1024}
            with ScaleRecorder() as scales:
                p2, _, met = build_step(rcfg, shape, m_, lr=REDUCED_STEP_LR,
                                        **kw, **extra).fn(
                    dp, momentum_sgd_init(dp), batch)
            out[name] = (float(met["loss"]),
                         [t.full_tensor().cpu() for t in tree_leaves(p2)])
            if scales.calls:
                whole = tree_map(lambda t: t.cpu(), params)
                out["slack"] = [t.cpu() for t in tree_leaves(scales.bound(
                    plan_reduce(whole, bucket_bytes=1024), whole,
                    shd._axis_size(m_, shd.data_axes(m_))))]
        dp = shd.shard_tree(params, m_, rspecs)
        attention.set_attention_impl("pallas")
        zero_launches()
        logits, cache = build_step(rcfg, pshape, m_).fn(
            dp, {"tokens": batch["tokens"][:4]})
        out["prefill_launches"] = ops_launches()["flash_attention"]
        attention.set_attention_impl("blockwise")
        out["prefill"] = [logits.full_tensor().cpu()] + [
            t.full_tensor().cpu() for t in tree_leaves(cache)]
        whole = tf.init_cache(rcfg, 4, SHARDED_REDUCED_DECODE,
                              torch.float32, device=d)
        for k, t in cache["layers"].items():
            whole["layers"][k][:, :, :SHARDED_REDUCED_SEQ] = t.full_tensor()
        dc = shd.shard_tree(whole, m_, shd.cache_shardings(
            rcfg, m_, whole, 4))
        step = build_step(rcfg, dshape, m_)
        out["decode"] = [
            step.fn(dp, dc, batch["labels"][:4, i:i + 1],
                    SHARDED_REDUCED_SEQ + i)[0].full_tensor().cpu()
            for i in range(SHARDED_DECODE_STEPS)]
        runs[where] = out
    red = {}
    for name in SHARDED_TRAIN:
        (lc, pc), (lp, pp) = runs["card"][name], runs["cpu"][name]
        # the f32 rule of the 4-rank world; compressed adds lr x one int8
        # step (the card's scales: the two wires may round a tie apart)
        slack = runs["card"].get("slack") if name == "compressed" else None
        slack = slack or [torch.zeros_like(a) for a in pc]
        red[name] = {"loss_card": lc, "loss_cpu": lp,
                     "loss_ok": abs(lc - lp) <= 1e-5 * abs(lp),
                     "params_ok": all(bool(torch.all(
                         (a - b).abs() <= REDUCED_STEP_LR * e + 1e-6
                         + 1e-4 * b.abs())) for a, b, e in zip(pc, pp, slack)),
                     "max_abs_param_diff": max(float((a - b).abs().max())
                                               for a, b in zip(pc, pp))}
    for name in ("prefill", "decode"):
        diffs = [float((a - b).abs().max()) for a, b in zip(
            runs["card"][name], runs["cpu"][name])]
        red[name] = {"max_abs_diff": max(diffs),
                     "ok": all(bool(torch.allclose(a, b, rtol=1e-4,
                                                   atol=1e-4))
                               for a, b in zip(runs["card"][name],
                                               runs["cpu"][name]))}
    red["prefill"]["flash_launches"] = runs["card"]["prefill_launches"]
    res["reduced"] = red
    print(json.dumps(res), flush=True)


def phase_sharded(pred: dict) -> dict:
    """Cell R: the full-width Qwen2-0.5B tensor-parallel on a ``(pod=1,
    data=2, model=2)`` world of four gloo processes sharing the one card
    (``sharded_rank``), every result against the unsharded step on this
    card from the same params and inputs (``sharded_reference``): the
    auto, mlfabric and compressed steps at seq 4096 and global batch 2
    (loss within ``SHARDED_BF16_TOL`` of the reference's, params within it
    as cell B holds them; the auto step's first-step peak a rank within
    ``SHARDED_PEAK_PRED_TOL`` of ``pred``, the dry-run's prediction), the
    32k prefill under "pallas" on ``(1, 1, 4)`` (24 flash launches a rank,
    each on 4 of the 14 q heads padded to 16 and the KV heads they read;
    logits and cache within ``BF16_PREFILL_TOL`` of the largest value),
    and 2 decode steps
    at batch 16 at the last positions of ``decode_32k`` (logits and the
    written rows within the same).  Then the reduced model in f32, card
    against CPU: loss rtol 1e-5, params rtol 1e-4 / atol 1e-6, prefill
    and decode logits within 1e-4.  One card cannot time tensor
    parallelism (the collectives go through the host): the times are the
    path's cost.  Returns the launches summed over the ranks."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import run_local_world

    gc.collect()
    torch.cuda.empty_cache()
    ref_dir = tempfile.mkdtemp(prefix="sharded_")
    try:
        ref = sharded_reference(ref_dir)
        root = str(Path(__file__).resolve().parent)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(Path(root) / "src"), root]), OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        outs = run_local_world(
            "import sys, chip_smoke; chip_smoke.sharded_rank(sys.argv[4])",
            4, args=(ref_dir,), env=env, timeout_s=900)
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    smi = nvidia_smi_line()
    emit({"phase": "sharded", "reduced": SHARDED_CUTS,
          "world": "pod=1 x data=2 x model=2, gloo, "
          "one card, DTensor collectives staged through the host",
          "nvidia_smi": smi, "world_s": world_s, **ref, "ranks": res})
    totals = dict.fromkeys(KERNELS, 0)
    for r in res:
        who = f"sharded rank {r['rank']}"
        auto = r["train"]["auto"]
        emit({"phase": "sharded", "check": "peak", "rank": r["rank"],
              "nvidia_smi": smi, "prediction_trace_s": pred["trace_s"],
              "predicted_peak_holders": pred["peak_holders"],
              **peak_against_prediction(
                  f"{who} auto", auto["first_step_peak"],
                  auto["allocated_at_start"], pred,
                  tol=SHARDED_PEAK_PRED_TOL)})
        check(r["param_bytes_held"] == r["param_bytes_predicted"],
              f"{who}: holds {r['param_bytes_held']} param bytes, "
              f"param_shardings predicts {r['param_bytes_predicted']}")
        for name, t in r["train"].items():
            check(all(math.isfinite(l) for l in t["losses"]),
                  f"{who} {name}: non-finite loss")
            check(abs(t["losses"][0] - t["loss_ref"])
                  <= SHARDED_BF16_TOL * abs(t["loss_ref"]),
                  f"{who} {name}: loss {t['losses'][0]} vs {t['loss_ref']}")
            check(t["params_close"] and t["placements_kept"],
                  f"{who} {name}: params {t}")
        launched = r["train"]["mlfabric"]["launches"]
        check(launched["grad_aggregate"] > 0,
              f"{who}: grad_aggregate did not run: {launched}")
        launched = r["train"]["compressed"]["launches"]
        check(launched["quantize"] > 0 and launched["dequant_aggregate"] > 0,
              f"{who}: the int8 wire did not run: {launched}")
        pre = r["prefill"]
        check(pre["launches"]["flash_attention"] == 24
              and pre["flash_heads"] == pre["want_heads"]
              and pre["want_heads"][0][0] == -(-ATTN_HEADS
                                               // SHARDED_PREFILL_MESH[0][2]),
              f"{who}: flash on local heads: {pre['launches']} "
              f"{pre['flash_heads']}")
        check(all(v <= BF16_PREFILL_TOL for v in pre["rel_err"].values()),
              f"{who}: prefill {pre['rel_err']}")
        for e in r["decode"]["rel_err"]:
            check(all(v <= BF16_PREFILL_TOL for v in e.values()),
                  f"{who}: decode {e}")
        for name, v in r["reduced"].items():
            check(v.get("ok", True) and v.get("loss_ok", True)
                  and v.get("params_ok", True),
                  f"{who}: reduced card vs CPU {name}: {v}")
        check(r["reduced"]["prefill"]["flash_launches"] == 2,
              f"{who}: reduced prefill flash launches "
              f"{r['reduced']['prefill']}")
        for part in (*r["train"].values(), r["prefill"], r["decode"]):
            for k in KERNELS:
                totals[k] += part["launches"][k]
    return totals


# --------------------------------------------------------------------------- #
# slice 11: the other families on a model axis (cell S)
# --------------------------------------------------------------------------- #
FAMILY_MESHES = {"2x2": ((1, 2, 2), ("pod", "data", "model")),
                 "1x4": ((1, 1, 4), ("pod", "data", "model"))}
# the full-width parts train (1 warm-up and FAMILY_SHARDED_TIMED timed
# steps of each step), S2 serves too; S4 is whisper-tiny at train_4k's
# own seq, 6 heads over 4 ranks: 3 heads and half the queries a rank
# (``attention._attend_split``); S2 (one deepseek-v2 layer) trains through
# the donating call (``donate``: four ranks of its functional step do not
# fit the card) with its first step's routing held to the unsharded
# step's (``hold_routes``: ``RouteHold``)
FAMILY_PARTS = {
    "S1": dict(arch="granite-moe-1b-a400m", layers=None, mesh="2x2",
               train=("auto", "mlfabric")),
    "S2": dict(arch="deepseek-v2-236b", layers=1, mesh="1x4",
               train=("auto", "compressed"), donate=True, hold_routes=True),
    "S3": dict(arch="rwkv6-1.6b", layers=12, mesh="1x4", train=("auto",)),
    "S4": dict(arch="whisper-tiny", layers=None, mesh="1x4",
               train=("auto", "compressed"), seq=4096),
}
FAMILY_TRAIN_PARTS = ("S1", "S2", "S3", "S4")
# the parts whose steps cell U's dry-run predicts on a fake 4-rank world of
# their mesh (``family_predictions``): a step runs only where its four
# ranks' predicted peaks and CUDA contexts fit DS_FIT_BYTES, and each
# rank's first-step peak is held within SHARDED_PEAK_PRED_TOL of it
FAMILY_PREDICTED = ("S2",)
CUDA_CONTEXT_BYTES = 1e9         # an allowance a process, beside its peak
FAMILY_SHARDED_SEQ = 1024        # train_4k's seq 4096, cut to 1,024
FAMILY_SHARDED_TIMED = 1
FAMILY_SHARDED_PREFILL = 4096    # cell M's prefill, at batch 1
FAMILY_DECODE_STEPS = 3
FAMILY_SAMPLE = 1 << 20          # entries of a leaf held against the reference
# the reduced part, card against CPU in f32 (the CPU twins' cases);
# "arch:tag" is a second cut of arch: whisper with 2/2 heads, fewer than
# the 4 ranks (the query split's own case: 1 head and half the queries a
# rank), on (1, 1, 4) only
FAMILY_SHARDED_REDUCED = ("granite-moe-1b-a400m", "deepseek-v2-236b",
                          "jamba-v0.1-52b", "rwkv6-1.6b", "whisper-tiny",
                          "whisper-tiny:2h")
FAMILY_SHARDED_Q8 = ("qwen2-0.5b", "granite-moe-1b-a400m")
FAMILY_REDUCED_CUTS = {"jamba-v0.1-52b": {"n_layers": 4,
                                          "layer_pattern": "mamm"},
                       "whisper-tiny:2h": {"n_heads": 2, "n_kv_heads": 2}}
FAMILY_REDUCED_MESHES = {"whisper-tiny:2h": ("1x4",)}
FAMILY_REDUCED_TOL = 1e-4
FAMILY_SHARDED_CUTS = [
    "S1 granite-moe-1b-a400m whole, S2's one deepseek-v2-236b layer and "
    "S3 rwkv6-1.6b cut to 12 of its 24 layers (the script's time limit), "
    "at train_4k's seq 4,096 x global batch 256 cut to 1,024 x 2; 1 "
    "warm-up and 1 timed step of each step",
    "S2 deepseek-v2-236b: 1 of 60 layers at its published widths (cell "
    "M's); prefill 4,096 tokens at batch 1; decode_32k at batch 16, not "
    "128, 3 steps at its last positions",
    "trained params held against the unsharded step's at a seeded sample "
    "of 2^20 entries a leaf and each leaf's f32 sum",
    "the reduced part: jamba one group of 4 layers, 'mamm'; whisper also "
    "cut to 2/2 heads on (1, 1, 4)",
    "S4 whisper-tiny whole (4 + 4 layers, 1,500 stub frames) at train_4k's "
    "seq 4,096 x global batch 256 cut to 4,096 x 2; 1 warm-up and 1 timed "
    "step of the auto and the compressed MLfabric step",
]


def family_part_config(part: str):
    from repro_torch.configs import get_config
    spec = FAMILY_PARTS[part]
    cfg = get_config(spec["arch"])
    return dataclasses.replace(cfg, n_layers=spec["layers"] or cfg.n_layers)


def family_part_params(part: str, dev):
    """``part``'s config and its bf16 params, seeded 0 on ``dev``."""
    import torch
    from repro_torch.models import build_model
    cfg = family_part_config(part)
    return cfg, build_model(cfg, dtype=torch.bfloat16, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))


def family_shapes(part: str = None):
    """The cells' shapes; ``part``'s training seq (``FAMILY_SHARDED_SEQ``
    unless the part names its own)."""
    from repro_torch.configs import SHAPES
    seq = FAMILY_PARTS.get(part, {}).get("seq", FAMILY_SHARDED_SEQ)
    return {"train": dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                         global_batch=STEP_BATCH),
            "prefill": dataclasses.replace(SHAPES["prefill_32k"],
                                           seq_len=FAMILY_SHARDED_PREFILL,
                                           global_batch=PREFILL_BATCH),
            "decode": dataclasses.replace(SHAPES["decode_32k"],
                                          global_batch=SHARDED_DECODE_BATCH)}


def family_train_batches(cfg, dev, seq: int = FAMILY_SHARDED_SEQ):
    """The warm-up and timed steps' batches; an encoder-decoder's with
    bf16 stub frames drawn from a numpy generator seeded by the step."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM
    src = SyntheticLM(cfg.vocab_size, seq, seed=0)
    out = []
    for i in range(1 + FAMILY_SHARDED_TIMED):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in src.batch(i, STEP_BATCH).items()}
        if cfg.frontend == "audio":
            b["frontend_embeds"] = stub_frames(
                cfg, STEP_BATCH, np.random.default_rng(i), dev)
        out.append(b)
    return out


def family_serve_inputs(cfg, dev):
    """S2's prompt and, per decode step, its tokens and position (the last
    of ``decode_32k``), from a generator seeded 5 on the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size,
                           (PREFILL_BATCH, FAMILY_SHARDED_PREFILL),
                           generator=gen, device=dev, dtype=torch.int32)
    seq = family_shapes()["decode"].seq_len
    steps = [(torch.randint(0, cfg.vocab_size, (SHARDED_DECODE_BATCH, 1),
                            generator=gen, device=dev, dtype=torch.int32),
              seq - FAMILY_DECODE_STEPS + i)
             for i in range(FAMILY_DECODE_STEPS)]
    return prompt, steps


def leaf_sample(i: int, shape) -> "torch.Tensor":
    """Flat indices of leaf ``i``'s seeded sample: all of a leaf of at
    most ``FAMILY_SAMPLE`` entries, else that many drawn seeded ``i``."""
    import torch
    n = math.prod(shape)
    if n <= FAMILY_SAMPLE:
        return torch.arange(n)
    return torch.randint(0, n, (FAMILY_SAMPLE,),
                         generator=torch.Generator().manual_seed(i))


def sample_leaves(tree) -> list:
    """Each leaf's sampled entries (f32, host), f32 sum and sum of
    absolute values."""
    from repro_torch.tree import tree_leaves
    out = []
    for i, t in enumerate(tree_leaves(tree)):
        idx = leaf_sample(i, tuple(t.shape)).to(t.device)
        out.append({"values": t.reshape(-1)[idx].float().cpu(),
                    "sum": float(t.float().sum()),
                    "abs_sum": float(t.float().abs().sum())})
    return out


def zero_grad_leaves(cfg) -> tuple:
    """Names of the leaves whose gradient is zero in exact arithmetic: the
    key bias where no rope turns it by position (whisper's), which adds
    the same ``q . bk`` to every score of a query, and the softmax is
    invariant to that.  After a step they hold rounding noise."""
    return ("bk",) if cfg.qkv_bias and not cfg.rope else ()


def compare_sample(tree, specs, mesh, ref: list, tol: float,
                   zero_grad: tuple = ()) -> dict:
    """A sharded tree against ``sample_leaves`` of the reference's: each
    rank compares the sampled entries its blocks hold (within rtol and
    atol ``tol``), and every leaf's f32 sum (a collective) within ``tol``
    of the reference's sum of absolute values, but the leaves named in
    ``zero_grad`` (``zero_grad_leaves``), whose sums are rounding noise
    on both sides (counted in ``sums_skipped``)."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.tree import tree_flatten_with_path, tree_leaves
    close, worst, sums, held, skipped = True, 0.0, 0.0, 0, 0
    names = [p.split("/")[-1] for p, _ in tree_flatten_with_path(tree)[0]]
    for i, (t, s, r) in enumerate(zip(tree_leaves(tree), tree_leaves(specs),
                                      ref)):
        shape = tuple(t.shape)
        idx = leaf_sample(i, shape)
        inside = torch.ones(idx.shape, dtype=torch.bool)
        local = []
        for c, sl, n in zip(torch.unravel_index(idx, shape),
                            shd.shard_slices(mesh, s, shape, mesh.coords),
                            shape):
            lo, hi = sl.start or 0, n if sl.stop is None else sl.stop
            inside &= (c >= lo) & (c < hi)
            local.append(c - lo)
        block = t.to_local()
        got = block[tuple(c[inside].to(block.device) for c in local)]
        got, want = got.float().cpu(), r["values"][inside]
        held += int(inside.sum())
        if got.numel():
            close &= bool(torch.allclose(got, want, rtol=tol, atol=tol))
            worst = max(worst, float((got - want).abs().max()))
        total = float(torch.sum(t.float()).full_tensor())
        if names[i] in zero_grad:
            skipped += 1
            continue
        sums = max(sums, abs(total - r["sum"]) / r["abs_sum"])
    return {"sample_close": close, "sample_max_abs_diff": worst,
            "sample_held": held, "sum_rel_err": sums,
            "sums_close": sums <= tol, "sums_skipped": skipped}


def sharded_families_reference(out_dir: str, plan: dict) -> dict:
    """Cell S's unsharded runs on this process's world of one, from the
    ranks' seeds: the steps ``plan`` names a part (the MLfabric step with
    ``overlap_chunks=2``, each of the two rows its own loss and aux loss,
    as the two data ranks take them; a ``donate`` part's through its
    donating call, from fresh params each; a ``hold_routes`` part's
    routing recorded), S2's prefill and decode; written to ``out_dir``
    for the ranks."""
    import torch
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.optim import momentum_sgd_init

    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(device=dev)
    shapes = family_shapes()
    t0 = time.perf_counter()
    for part in FAMILY_TRAIN_PARTS:
        spec = FAMILY_PARTS[part]
        cfg, params = family_part_params(part, dev)
        shape = family_shapes(part)["train"]
        batches = family_train_batches(cfg, dev, shape.seq_len)
        for i, name in enumerate(plan[part]):
            kw = dict(SHARDED_TRAIN[name])
            if name == "mlfabric":
                kw["overlap_chunks"] = STEP_BATCH
            step = build_step(cfg, shape, mesh, lr=STEP_LR,
                              gamma=STEP_GAMMA, remat=True, **kw)
            if spec.get("donate") and i:    # the last step took them
                del params
                gc.collect()
                torch.cuda.empty_cache()
                cfg, params = family_part_params(part, dev)
            run = step.donating() if spec.get("donate") else step.fn
            with RouteHold() as hold:
                p, _, m = run(params, momentum_sgd_init(params), batches[0])
            torch.save({"loss": float(m["loss"]),
                        "sample": sample_leaves(p),
                        "routes": ([c.cpu() for c in hold.calls]
                                   if spec.get("hold_routes") else None)},
                       f"{out_dir}/{part}_{name}.pt")
            del p, m, step
        del params, batches
        gc.collect()
        torch.cuda.empty_cache()
    cfg, params = family_part_params("S2", dev)
    prompt, steps = family_serve_inputs(cfg, dev)
    with RouteHold() as hold:
        logits, cache = build_step(cfg, shapes["prefill"], mesh).fn(
            params, {"tokens": prompt})
        torch.save({"logits": logits.cpu(),
                    "cache": {k: t.cpu() for k, t in cache["layers"].items()},
                    "routes": [c.cpu() for c in hold.calls]},
                   f"{out_dir}/S2_prefill.pt")
        del logits, cache
        cache = sharded_cache(cfg, SHARDED_DECODE_BATCH,
                              shapes["decode"].seq_len, dev)
        step = build_step(cfg, shapes["decode"], mesh)
        out = []
        for tok, pos in steps:
            hold.record()
            logits, cache = step.fn(params, cache, tok, pos)
            out.append({"logits": logits.cpu(), "pos": pos,
                        "rows": {k: t[:, :, pos].cpu()
                                 for k, t in cache["layers"].items()},
                        "routes": [c.cpu() for c in hold.calls]})
    torch.save(out, f"{out_dir}/S2_decode.pt")
    del cache, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"reference_s": time.perf_counter() - t0}


def _one_rank_at_a_time(fn):
    """``fn()`` on each rank in turn, a barrier between: a full-width
    init holds its whole model (and an f32 draw of its largest leaf) on
    the card, once, not four times at once."""
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = fn()
        dist.barrier()
    return out


def _sharded_part(part: str, mesh, variants) -> tuple:
    """``part``'s config, params laid out for each of ``variants`` ("auto":
    ``param_shardings``; "mlfabric": stripped of the batch axes), their
    specs, and the predicted bytes a rank holds."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.models.api import params_specs
    from repro_torch.tree import tree_map

    def init():
        cfg, full = family_part_params(part, mesh.device)
        specs = shd.param_shardings(cfg, mesh, full)
        out = {}
        for v in variants:
            sp = specs if v == "auto" else tree_map(shd.strip_data, specs)
            out[v] = (shd.shard_tree(full, mesh, sp), sp)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        return cfg, out

    cfg, out = _one_rank_at_a_time(init)
    return cfg, out, shd.param_bytes_per_rank(cfg, mesh, params_specs(cfg))


def _held_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree))


def family_sharded_train(ref_dir: str, part: str, mesh, names) -> dict:
    """A part's steps ``names`` in a rank: each step from the same params,
    1 warm-up and ``FAMILY_SHARDED_TIMED`` timed steps, the first against
    the reference's sample (a ``donate`` part's through the donating call;
    a ``hold_routes`` part's first step taking the reference's routing,
    the later ones their own)."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import build_step
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_leaves

    dev = mesh.device
    spec = FAMILY_PARTS[part]
    cfg, trees, predicted = _sharded_part(part, mesh, names)
    first_tree = trees[names[0]][0]
    res = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "param_bytes_predicted": predicted,
           "param_bytes_held": _held_bytes(first_tree)}
    del first_tree
    shape = family_shapes(part)["train"]
    res["seq_len"] = shape.seq_len
    batches = family_train_batches(cfg, dev, shape.seq_len)
    for name in names:
        p, sp = trees.pop(name)
        o = momentum_sgd_init(p)
        step = build_step(cfg, shape, mesh, lr=STEP_LR,
                          gamma=STEP_GAMMA, remat=True, **SHARDED_TRAIN[name])
        run = step.donating() if spec.get("donate") else step.fn
        ref = torch.load(f"{ref_dir}/{part}_{name}.pt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        at_start = torch.cuda.memory_allocated(dev)
        zero_launches()
        losses, secs = [], []
        with RouteHold() as hold:
            if spec.get("hold_routes"):
                hold.replay([c.to(dev) for c in ref["routes"]])
            for i, b in enumerate(batches):
                t0 = time.perf_counter()
                p, o, m = run(p, o, b)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
                if i == 0:
                    first_peak = torch.cuda.max_memory_allocated(dev)
                    held = not hold.plan   # every recorded call taken
                    hold.record()          # later steps route freely
                    first = compare_sample(p, sp, mesh, ref["sample"],
                                           SHARDED_BF16_TOL,
                                           zero_grad_leaves(cfg))
                    first["placements_kept"] = all(
                        tuple(a.placements) == tuple(shd.placements(mesh, s))
                        for a, s in zip(tree_leaves(p), tree_leaves(sp)))
        res[name] = {**first, "loss_ref": ref["loss"], "losses": losses,
                     "routes_held": bool(spec.get("hold_routes")),
                     "routes_all_replayed": held,
                     "warmup_s": secs[0], "step_s": secs[1:],
                     "s_per_step": sum(secs[1:]) / FAMILY_SHARDED_TIMED,
                     "launches": ops_launches(),
                     "allocated_at_start": at_start,
                     "first_step_peak": first_peak,
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated(dev)}
        del p, o, step, run, ref
        gc.collect()
        torch.cuda.empty_cache()
    return res


def family_sharded_serve(ref_dir: str, mesh) -> dict:
    """S2 in a rank: the prefill, then the decode steps on a latent cache
    whose sequence is split over ``model``, each against the reference's
    block (``_block_err``)."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import build_step
    from repro_torch.models import transformer as tf

    dev = mesh.device
    cfg, trees, predicted = _sharded_part("S2", mesh, ("auto",))
    p = trees["auto"][0]
    res = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "param_bytes_predicted": predicted,
           "param_bytes_held": _held_bytes(p)}
    shapes = family_shapes()
    prompt, steps = family_serve_inputs(cfg, dev)
    step = build_step(cfg, shapes["prefill"], mesh)
    ref = torch.load(f"{ref_dir}/S2_prefill.pt")
    # the reference's choices of experts (RouteHold: two bf16 paths route
    # near ties apart)
    with RouteHold() as hold:
        hold.replay([c.to(dev) for c in ref["routes"]])
        zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        logits, cache = step.fn(p, {"tokens": prompt})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lspec = shd._fit_spec(mesh, shd.P(None, "model"),
                              tuple(logits.shape))
        err = {"logits": _block_err(logits.to_local(), ref["logits"],
                                    shd.shard_slices(mesh, lspec,
                                                     tuple(logits.shape),
                                                     mesh.coords))}
        cspecs = shd.cache_shardings(cfg, mesh, cache, PREFILL_BATCH)
        for k, t in cache["layers"].items():
            err[k] = _block_err(t.to_local(), ref["cache"][k],
                                shd.shard_slices(mesh, cspecs["layers"][k],
                                                 tuple(t.shape), mesh.coords))
        res["prefill"] = {"rel_err": err, "s": secs,
                          "launches": ops_launches(),
                          "max_memory_allocated":
                              torch.cuda.max_memory_allocated(dev)}
        del logits, cache, ref, step
        gc.collect()
        torch.cuda.empty_cache()

        seq = shapes["decode"].seq_len
        abstract = tf.init_cache(cfg, SHARDED_DECODE_BATCH, seq,
                                 torch.bfloat16, device="meta")
        cspecs = shd.cache_shardings(cfg, mesh, abstract,
                                     SHARDED_DECODE_BATCH)
        local = sharded_cache(
            cfg, SHARDED_DECODE_BATCH, seq, dev,
            keep=lambda name, t: t[shd.shard_slices(
                mesh, shd.P(*tuple(cspecs["layers"][name])[1:]),
                tuple(t.shape), mesh.coords)])
        cache = {"layers": {k: DTensor.from_local(
            t, mesh.device_mesh, shd.placements(mesh, cspecs["layers"][k]),
            run_check=False) for k, t in local["layers"].items()}}
        del local
        res["cache_bytes_held"] = _held_bytes(cache)
        ref = torch.load(f"{ref_dir}/S2_decode.pt")
        step = build_step(cfg, shapes["decode"], mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        errs, secs = [], []
        for (tok, pos), r in zip(steps, ref):
            hold.replay([c.to(dev) for c in r["routes"]])
            t0 = time.perf_counter()
            logits, cache = step.fn(p, cache, tok, pos)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            lspec = shd._fit_spec(mesh, shd.P(("pod", "data"), "model"),
                                  tuple(logits.shape))
            e = {"logits": _block_err(logits.to_local(), r["logits"],
                                      shd.shard_slices(mesh, lspec,
                                                       tuple(logits.shape),
                                                       mesh.coords))}
            for k, t in cache["layers"].items():
                sl = shd.shard_slices(mesh, cspecs["layers"][k],
                                      tuple(t.shape), mesh.coords)
                lo = sl[2].start or 0
                if lo <= pos < lo + t.to_local().shape[2]:
                    e[k] = _block_err(t.to_local()[:, :, pos - lo],
                                      r["rows"][k], (slice(None), sl[1]))
            errs.append(e)
    res["decode"] = {"rel_err": errs, "s": secs, "launches": ops_launches(),
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated(dev)}
    del cache, p, trees, ref, step
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _reduced_family_runs(arch: str, mesh) -> dict:
    """The CPU twins' cases of reduced ``arch`` in f32 on ``mesh`` (the
    card's or the CPU's): the auto and MLfabric steps, the prefill of 4
    rows under "pallas" and 3 decode steps after it, or 3 int8-cache
    decode steps from a seeded cache; every result gathered whole on the
    host."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import build_step
    from repro_torch.models import attention, build_model
    from repro_torch.models import transformer as tf
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                                  tree_map, tree_unflatten)

    seq, rows, cache_len = SHARDED_REDUCED_SEQ, 4, SHARDED_REDUCED_DECODE
    cfg = dataclasses.replace(get_config(arch.split(":")[0]).reduced(),
                              **FAMILY_REDUCED_CUTS.get(arch, {}))
    params = build_model(cfg, dtype=torch.float32, device=mesh.device).init(
        torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg.vocab_size, seq, seed=0).batch(0, SHARDED_REDUCED_BATCH).items()}
    if cfg.frontend == "audio":
        batch["frontend_embeds"] = torch.from_numpy(
            np.random.default_rng(1).standard_normal(
                (SHARDED_REDUCED_BATCH, cfg.encoder.n_frames, cfg.d_model)
            ).astype(np.float32))
    specs = shd.param_shardings(cfg, mesh, params)
    whole = lambda tree: [t.full_tensor().cpu() for t in tree_leaves(tree)]
    out = {}
    dec_shape = dataclasses.replace(get_shape("decode_32k"),
                                    seq_len=cache_len, global_batch=rows)
    if arch in FAMILY_SHARDED_REDUCED:
        shape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                    global_batch=SHARDED_REDUCED_BATCH)
        for name in ("auto", "mlfabric"):
            sp = specs if name == "auto" else tree_map(shd.strip_data, specs)
            dp = shd.shard_tree(params, mesh, sp)
            p2, _, met = build_step(cfg, shape, mesh, lr=REDUCED_STEP_LR,
                                    **SHARDED_TRAIN[name]).fn(
                dp, momentum_sgd_init(dp), batch)
            out[name] = [torch.tensor([float(met["loss"]),
                                       float(met["aux_loss"])])] + whole(p2)
        dp = shd.shard_tree(params, mesh, specs)
        pb = {k: v[:rows] for k, v in batch.items() if k != "labels"}
        attention.set_attention_impl("pallas")
        zero_launches()
        try:
            logits, cache = build_step(cfg, dataclasses.replace(
                get_shape("prefill_32k"), seq_len=seq, global_batch=rows),
                mesh).fn(dp, pb)
        finally:
            attention.set_attention_impl("blockwise")
        out["flash_launches"] = ops_launches()["flash_attention"]
        out["prefill"] = [logits.full_tensor().cpu()] + whole(cache)
        named, cdef = tree_flatten_with_path(cache["layers"])
        full = dict(cache, layers=tree_unflatten(cdef, [
            torch.cat([t.full_tensor(), t.full_tensor().new_zeros(
                t.shape[:2] + (cache_len - seq,) + t.shape[3:])], dim=2)
            if path.split("/")[-1] in POSITIONAL else t.full_tensor()
            for path, t in named]))
        if "cross_kv" in cache:
            full["cross_kv"] = tuple(t.full_tensor() for t in
                                     cache["cross_kv"])
        out["decode"] = _reduced_decode(cfg, mesh, dp, full, batch, dec_shape)
    if arch in FAMILY_SHARDED_Q8:
        rng = np.random.default_rng(2)
        full = tf.init_cache(cfg, rows, cache_len, torch.float32,
                             kv_int8=True, device=mesh.device)
        for k, t in full["layers"].items():
            part = t[:, :, :seq]
            part.copy_(torch.from_numpy(
                rng.uniform(1e-3, 2e-2, part.shape).astype(np.float32)
                if k.endswith("_s") else
                rng.integers(-127, 128, part.shape).astype(np.int8)))
        out["decode_q8"] = _reduced_decode(
            cfg, mesh, shd.shard_tree(params, mesh, specs), full, batch,
            dec_shape)
    return out


def _reduced_decode(cfg, mesh, params, full, batch, shape) -> list:
    """3 decode steps from ``full`` laid out by ``cache_shardings``: each
    step's logits and the cache after them, whole on the host."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import build_step
    from repro_torch.tree import tree_leaves
    dc = shd.shard_tree(full, mesh, shd.cache_shardings(
        cfg, mesh, full, shape.global_batch))
    step = build_step(cfg, shape, mesh)
    out = []
    for i in range(FAMILY_DECODE_STEPS):
        logits, dc = step.fn(params, dc, batch["labels"][
            :shape.global_batch, i:i + 1], SHARDED_REDUCED_SEQ + i)
        out.append(logits.full_tensor().cpu())
    return out + [t.full_tensor().cpu() for t in tree_leaves(dc["layers"])]


def family_sharded_reduced(meshes: dict, cpu_meshes: dict) -> dict:
    """The reduced part: each family's runs on each mesh, card against the
    same world on the CPU within ``FAMILY_REDUCED_TOL`` (atol and rtol;
    an int8 payload within one step)."""
    import torch
    out = {}
    for arch in dict.fromkeys(FAMILY_SHARDED_REDUCED + FAMILY_SHARDED_Q8):
        for mname in FAMILY_REDUCED_MESHES.get(arch, FAMILY_MESHES):
            card = _reduced_family_runs(arch, meshes[mname])
            cpu = _reduced_family_runs(arch, cpu_meshes[mname])
            res = {}
            for k, a in card.items():
                if k == "flash_launches":
                    res[k] = a
                    continue
                b = cpu[k]
                ok = len(a) == len(b) and all(
                    x.shape == y.shape and (
                        float((x.float() - y.float()).abs().max()) <= 1
                        if x.dtype == torch.int8 else
                        bool(torch.allclose(x, y, rtol=FAMILY_REDUCED_TOL,
                                            atol=FAMILY_REDUCED_TOL)))
                    for x, y in zip(a, b))
                res[k] = {"ok": ok, "max_abs_diff": max(
                    float((x.float() - y.float()).abs().max())
                    for x, y in zip(a, b))}
            out[f"{arch}/{mname}"] = res
    return out


def sharded_family_rank(ref_dir: str) -> None:
    """One rank of cell S's world (four gloo processes on the one card,
    DTensor's collectives staged through the host): the reduced part
    first, then S1-S4 against the unsharded runs in ``ref_dir`` (the steps
    its ``plan.json`` names a part).  Prints one JSON line."""
    import torch
    from repro_torch.launch import init_rank, make_mesh

    rank, _, _ = init_rank("gloo", host_staged_collectives=True)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    meshes = {k: make_mesh(*m, device=dev) for k, m in FAMILY_MESHES.items()}
    cpu_meshes = {k: make_mesh(*m, device="cpu")
                  for k, m in FAMILY_MESHES.items()}
    with open(f"{ref_dir}/plan.json") as f:
        plan = json.load(f)
    res = {"rank": rank}
    t0 = time.perf_counter()
    res["reduced_families"] = family_sharded_reduced(meshes, cpu_meshes)
    res["reduced_s"] = time.perf_counter() - t0
    for part in FAMILY_PARTS:
        t0 = time.perf_counter()
        mesh = meshes[FAMILY_PARTS[part]["mesh"]]
        res[part] = {}
        if part == "S2":
            res[part] = family_sharded_serve(ref_dir, mesh)
        if plan.get(part):
            res[part]["train"] = family_sharded_train(ref_dir, part, mesh,
                                                      plan[part])
        res[part]["s"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)


def family_train_plan(preds: dict) -> tuple:
    """The steps each part trains: all of its own, but a
    ``FAMILY_PREDICTED`` part's step whose four ranks' predicted peaks
    (``preds``, cell U's) and CUDA contexts, beside this process's
    context, do not fit ``DS_FIT_BYTES``; and those left out, each with
    its prediction."""
    plan, left = {}, {}
    for part in FAMILY_TRAIN_PARTS:
        plan[part] = []
        for name in FAMILY_PARTS[part]["train"]:
            pred = preds.get(f"{part}/{name}")
            need = (None if pred is None else
                    4 * (pred["peak_bytes"] + CUDA_CONTEXT_BYTES)
                    + CUDA_CONTEXT_BYTES)
            if need is not None and need > DS_FIT_BYTES:
                left[f"{part}/{name}"] = {
                    "predicted_peak_a_rank": pred["peak_bytes"],
                    "predicted_card_bytes": need,
                    "fit_bytes": DS_FIT_BYTES}
            else:
                plan[part].append(name)
    return plan, left


def phase_sharded_families(preds: dict) -> dict:
    """Cell S: granite-moe, deepseek-v2, jamba, rwkv6 and whisper on a
    ``model`` axis, on a world of four gloo processes sharing the one card
    (``sharded_family_rank``).  First the reduced families in f32, card
    against CPU within ``FAMILY_REDUCED_TOL``: the auto and MLfabric steps
    on ``(pod=1, data=2, model=2)`` and ``(1, 1, 4)``, the prefill under
    "pallas", 3 decode steps, and int8-cache decode on qwen2-0.5b and
    granite.  Then at full width, each against the unsharded run on this
    card from the same params and inputs (``sharded_families_reference``):
    S1, granite-moe whole, auto and MLfabric on ``(1, 2, 2)`` at seq 1,024
    x batch 2 (loss and sampled params within ``SHARDED_BF16_TOL``; the
    MLfabric step reduces over ``data``, launching ``grad_aggregate``);
    S2, one deepseek-v2 layer on ``(1, 1, 4)``: the donated auto step at
    seq 1,024 x batch 2, its first step on the unsharded step's routing
    (each rank's first-step peak within ``SHARDED_PEAK_PRED_TOL`` of
    ``preds``, cell U's prediction; the compressed step only where
    ``family_train_plan`` fits it on the card), then the 4,096-token
    prefill and 3 decode steps at batch 16 on a latent cache split over
    ``model`` (logits and written rows within ``BF16_PREFILL_TOL`` of the
    largest value); S3, rwkv6 at 12 of 24 layers, the auto step on ``(1,
    1, 4)``; S4,
    whisper-tiny whole, the auto and the compressed MLfabric step on ``(1,
    1, 4)`` at seq 4,096 x batch 2 (its 6 heads over 4 ranks: the query
    split at full width; the compressed step launches ``quantize`` and
    ``dequant_aggregate`` at whisper's flat length).  Returns the launches
    of S1-S4 summed over the ranks."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import run_local_world

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    plan, left = family_train_plan(preds)
    ref_dir = tempfile.mkdtemp(prefix="sharded_families_")
    try:
        with open(f"{ref_dir}/plan.json", "w") as f:
            json.dump(plan, f)
        ref = sharded_families_reference(ref_dir, plan)
        root = str(Path(__file__).resolve().parent)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(Path(root) / "src"), root]), OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        outs = run_local_world(
            "import sys, chip_smoke; "
            "chip_smoke.sharded_family_rank(sys.argv[4])",
            4, args=(ref_dir,), env=env, timeout_s=900)
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    smi = nvidia_smi_line()
    emit({"phase": "sharded_families", "cell": "S",
          "world": "4 gloo processes on one card, DTensor collectives "
          "staged through the host", "meshes": FAMILY_MESHES,
          "nvidia_smi": smi, "reduced": FAMILY_SHARDED_CUTS,
          "limits": {"train_bf16": SHARDED_BF16_TOL,
                     "serve_bf16": BF16_PREFILL_TOL,
                     "reduced_f32": FAMILY_REDUCED_TOL,
                     "peak_vs_prediction": SHARDED_PEAK_PRED_TOL},
          "trained": plan, "not_run": left,
          "world_s": world_s, "phase_s": time.perf_counter() - t_phase,
          **ref, "ranks": res})
    return sharded_families_checks(res, plan, preds, smi)


def sharded_families_checks(res: list, plan: dict, preds: dict,
                            smi: str) -> dict:
    """Cell S's checks on the ranks' results (the steps of ``plan``; a
    ``FAMILY_PREDICTED`` part's first-step peaks against ``preds``, each
    printed); returns the launches of S1-S4 summed over the ranks."""
    totals = dict.fromkeys(KERNELS, 0)
    for r in res:
        who = f"sharded_families rank {r['rank']}"
        for key, runs in r["reduced_families"].items():
            for k, v in runs.items():
                check(k == "flash_launches" or v["ok"],
                      f"{who} reduced {key} {k}: card vs CPU {v}")
            if not key.startswith("deepseek") and \
                    not key.startswith("rwkv") and "flash_launches" in runs:
                check(runs["flash_launches"] > 0,
                      f"{who} reduced {key}: the prefill launched no flash")
        for part in FAMILY_PARTS:
            for v in (([r[part]] if part == "S2" else [])
                      + ([r[part]["train"]] if plan.get(part) else [])):
                check(v["param_bytes_held"] == v["param_bytes_predicted"],
                      f"{who} {part}: holds {v['param_bytes_held']} param "
                      f"bytes, param_shardings predicts "
                      f"{v['param_bytes_predicted']}")
        for part in FAMILY_TRAIN_PARTS:
            for name in plan[part]:
                t = r[part]["train"][name]
                check(all(math.isfinite(l) for l in t["losses"]),
                      f"{who} {part} {name}: non-finite loss")
                check(abs(t["losses"][0] - t["loss_ref"])
                      <= SHARDED_BF16_TOL * abs(t["loss_ref"]),
                      f"{who} {part} {name}: loss {t['losses'][0]} vs "
                      f"{t['loss_ref']}")
                check(t["sample_close"] and t["sums_close"]
                      and t["placements_kept"] and t["sample_held"] > 0
                      and t["routes_all_replayed"],
                      f"{who} {part} {name}: params {t}")
                pred = preds.get(f"{part}/{name}")
                if pred is not None:
                    emit({"phase": "sharded_families", "check": "peak",
                          "part": part, "step": name, "rank": r["rank"],
                          "nvidia_smi": smi,
                          "prediction_trace_s": pred["trace_s"],
                          "predicted_peak_holders": pred["peak_holders"],
                          "s_per_step": t["s_per_step"],
                          **peak_against_prediction(
                              f"{who} {part} {name}", t["first_step_peak"],
                              t["allocated_at_start"], pred,
                              tol=SHARDED_PEAK_PRED_TOL)})
                for k in KERNELS:
                    totals[k] += t["launches"][k]
        launched = r["S1"]["train"]["mlfabric"]["launches"]
        check(launched["grad_aggregate"] > 0,
              f"{who}: S1's MLfabric step launched no grad_aggregate: "
              f"{launched}")
        launched = r["S4"]["train"]["compressed"]["launches"]
        check(launched["quantize"] > 0 and launched["dequant_aggregate"] > 0,
              f"{who}: S4's compressed step launched no wire kernel: "
              f"{launched}")
        s2 = r["S2"]
        check(all(v <= BF16_PREFILL_TOL for v in s2["prefill"]["rel_err"]
                  .values()), f"{who}: S2 prefill {s2['prefill']}")
        for e in s2["decode"]["rel_err"]:
            check(all(v <= BF16_PREFILL_TOL for v in e.values()),
                  f"{who}: S2 decode {e}")
        for k in KERNELS:
            totals[k] += s2["prefill"]["launches"][k] + \
                s2["decode"]["launches"][k]
    return totals


# --------------------------------------------------------------------------- #
# slice 8: DeepSeek-V2's latent attention, the Jamba hybrid and RWKV6 served
# at their published widths (cells M, N, O)
# --------------------------------------------------------------------------- #
# per cell: the phase, the layers run (of 60, 32, 24 and 4 published),
# the prefill's tokens and batch, the decode shape and batch, the layers
# of the f32 prefill-against-decode check, and whether the serve loop runs
SERVE_CELLS = {
    "deepseek-v2-236b": dict(phase="deepseek_serve", layers=4, prefill=4096,
                             prefill_batch=PREFILL_BATCH, decode="decode_32k",
                             batch=128, f32_layers=1, serve_loop=False),
    "jamba-v0.1-52b": dict(phase="jamba_serve", layers=8, prefill=32768,
                           prefill_batch=PREFILL_BATCH, decode="long_500k",
                           batch=1, f32_layers=8, serve_loop=False),
    "rwkv6-1.6b": dict(phase="rwkv_serve", layers=24, prefill=32768,
                       prefill_batch=PREFILL_BATCH, decode="long_500k",
                       batch=1, f32_layers=24, serve_loop=True),
    # slice 9: prefill_32k at its own global batch of 32
    "whisper-tiny": dict(phase="whisper_serve", layers=4, prefill=32768,
                         prefill_batch=32, decode="decode_32k", batch=128,
                         f32_layers=4, serve_loop=True),
}
# each cell's cuts of scale, printed in its lines
SERVE_CELL_CUTS = {
    "deepseek-v2-236b": [
        "depth 4 of 60 layers: the model is 477 GB in bf16, 4 layers 31.8 GB",
        "prefill 4,096 tokens at batch 1, not prefill_32k's 32,768 at 32: "
        "the blockwise MLA path builds [H, S, kv_block] f32 scores, 8.6 GB "
        "a block at 128 heads and 32k, beside 32 GB of weights",
        "prefill against decode in f32 on one full-width layer, after the "
        "bf16 params are freed: the f32 copy of 4 layers is 64 GB"],
    "jamba-v0.1-52b": [
        "depth 8 of 32 layers: one Jamba block (7 mamba, 1 attention, 4 "
        "MoE layers), 25.5 GB of the model's 104 GB",
        "prefill_32k at batch 1, not 32",
        "prefill against decode in f32 on the same block from the same "
        "seed, after the bf16 params are freed (51 GB)"],
    "rwkv6-1.6b": ["prefill_32k at batch 1, not 32"],
    "whisper-tiny": [
        "prefill_32k and decode_32k run 32,768 decoder positions, past the "
        "published 448-token text context: the sinusoidal decoder "
        "positions have no limit, and these are the repo's shapes for "
        "every arch (configs/shapes.py)"],
}


def serve_cell_config(arch: str, layers: int = None):
    """``arch``'s published config cut to ``layers`` (default: its
    cell's depth)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers or
                               SERVE_CELLS[arch]["layers"])


def drop_free(cfg):
    """``cfg`` with a capacity factor of its experts' count, which drops
    no choice: a prefill chunk and a one-token step then route alike."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def expert_bytes(params) -> int:
    """Bytes of one expert of one layer (its gate, up and down)."""
    layers = params["layers"]
    for slot in ([layers] if isinstance(layers, dict) else layers):
        if "router" in slot["mlp"]:
            return sum(slot["mlp"][k][0, 0].numel()
                       * slot["mlp"][k].element_size()
                       for k in ("w_gate", "w_up", "w_down"))
    return 0


def family_decode(phase: str, cfg, model, params, shape, gen,
                  reduced: dict) -> None:
    """One decode step of ``shape`` (``decode_32k`` or ``long_500k``) at
    its last position, against a cache of its length filled from a seeded
    generator (the recurrent states too, and an encoder-decoder's
    ``cross_kv`` of its frames): 1 warm-up, which records the routing, and
    ``DECODE_TIMED`` timed, then ``DECODE_TIMED`` at position 0.  Every
    cache tensor is written in place: the position's rows and the states
    change, their storage does not; ``cross_kv`` keeps its storage and its
    bits.  Bound: the cache and the params read once at the memory rate,
    of the experts only those the step's tokens reach."""
    import torch
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.tree import tree_leaves

    dev = model.device
    step = build_step(cfg, shape, make_host_mesh(device=dev))
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    if cfg.encoder is not None:         # what a prefill would hand on
        cache["cross_kv"] = tuple(torch.empty(
            (cfg.n_layers, shape.global_batch, cfg.encoder.n_frames,
             cfg.n_kv_heads, cfg.head_dim), dtype=params["embeds"][
                 "embed"].dtype, device=dev) for _ in CROSS)
    for t in tree_leaves(cache):
        t.normal_(generator=gen)
    cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    tok = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1),
                        generator=gen, device=dev, dtype=torch.int32)
    pos = shape.seq_len - 1
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    before = [t[:, :, pos].clone() if k in POSITIONAL else t.clone()
              for k, t in cache_entries(cache)]
    launches0 = ops_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with RouteHold() as hold:
        t0 = time.perf_counter()
        logits, cache = step.fn(params, cache, tok, pos)
        torch.cuda.synchronize()
        secs = [time.perf_counter() - t0]
    reached = [int(torch.unique(idx).numel()) for idx in hold.calls]
    for p in [pos] * DECODE_TIMED + [0] * DECODE_TIMED:
        t0 = time.perf_counter()
        logits, cache = step.fn(params, cache, tok, p)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    ms_last = sum(secs[1:1 + DECODE_TIMED]) / DECODE_TIMED * 1e3
    ms_first = sum(secs[1 + DECODE_TIMED:]) / DECODE_TIMED * 1e3
    unreached = sum(cfg.moe.n_experts - r for r in reached) * \
        expert_bytes(params) if cfg.moe is not None else 0
    bound = (cache_bytes + param_bytes - unreached) / HBM_BYTES_PER_S * 1e3
    emit({"phase": phase, "part": "decode", "shape": shape.name,
          "n_layers": cfg.n_layers, **reduced, "seq_len": shape.seq_len,
          "batch": shape.global_batch, "pos": pos, "cache_bytes": cache_bytes,
          "param_bytes": param_bytes, "experts_reached": reached,
          "unreached_expert_bytes": unreached, "warmup_ms": secs[0] * 1e3,
          "step_ms": [x * 1e3 for x in secs[1:1 + DECODE_TIMED]],
          "ms_per_step": ms_last,
          "step_ms_pos0": [x * 1e3 for x in secs[1 + DECODE_TIMED:]],
          "ms_per_step_pos0": ms_first, "bound_ms": bound,
          "bound_share": bound / ms_last,
          "tokens_per_s": shape.global_batch / ms_last * 1e3,
          "max_memory_allocated": peak})
    check([t.data_ptr() for t in tree_leaves(cache)] == ptrs,
          f"{phase}: decode did not write its cache in place")
    after = [(k, t[:, :, pos] if k in POSITIONAL else t)
             for k, t in cache_entries(cache)]
    check(all(torch.equal(a, b) == (k in CROSS)
              for b, (k, a) in zip(before, after)),
          f"{phase}: a cache entry was not written, or cross_kv was")
    check(bool(torch.isfinite(logits).all()) and logits.shape
          == (shape.global_batch, cfg.padded_vocab), f"{phase}: decode logits")
    check(ops_launches() == launches0, f"{phase}: decode launched kernels")


def phase_family_serve(arch: str) -> dict:
    """Cells M, N, O and Q: ``arch`` at its published widths in bf16 (the
    depth of ``SERVE_CELLS``), seeded random weights.

    * prefill: ``prefill_cell`` of the cell's tokens (whisper: at batch 32
      beside seeded bf16 stub frames) under "pallas" (jamba: one flash
      launch a prefill, its attention layer; whisper: one a decoder layer,
      its encoder's 1,500 frames and the cross-attention take the
      blockwise loop; deepseek-v2's MLA takes the blockwise loop, dk !=
      dv, and rwkv6 has no attention: no launch, and the "blockwise"
      prefill bit-equal), then ``AFTER_PREFILL_STEPS`` decode steps from
      it;
    * decode: ``family_decode`` at the cell's decode shape;
    * rwkv6 and whisper: the serve loop, as cell D's (whisper's prefills
      each batch beside its frames, under "pallas");
    * prefill against teacher-forced decode (the recurrent states after the
      prompt count as the cache; whisper's ``cross_kv`` from a prefill of
      the same frames), bf16 within ``cache_limit``, f32 within
      ``F32_REL_TOL`` with top-1 equal on 3 of 4 rows; a config with
      experts at a drop-free capacity with the decode's routing held, as
      ``moe_serve``.  The f32 check runs on ``f32_layers`` full-width
      layers after the bf16 params are freed.

    Returns the launches of the timed prefills and the serve loop (zeroed
    before them; decode launches nothing)."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import build_model

    cell = SERVE_CELLS[arch]
    phase = cell["phase"]
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = serve_cell_config(arch)
    reduced = {"layers_published": get_config(arch).n_layers,
               "reduced": SERVE_CELL_CUTS[arch]}
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (cell["prefill_batch"], cell["prefill"]),
        generator=gen, device=dev, dtype=torch.int32)}
    if cfg.encoder is not None:
        batch["frontend_embeds"] = stub_frames(
            cfg, cell["prefill_batch"], np.random.default_rng(5), dev)
    logits, cache, launches = prefill_cell(phase, cfg, model, params, batch,
                                           reduced)
    decode_after_prefill(phase, model, params, logits, cache,
                         AFTER_PREFILL_STEPS, cell["prefill"])
    del logits, cache, batch
    gc.collect()
    torch.cuda.empty_cache()

    shape = dataclasses.replace(SHAPES[cell["decode"]],
                                global_batch=cell["batch"])
    family_decode(phase, cfg, model, params, shape, gen, reduced)
    gc.collect()
    torch.cuda.empty_cache()
    if cell["serve_loop"]:
        _, launches = serve_loop(phase, cfg, model, params, ops_launches())

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    ).to(dev)
    # an encoder-decoder's stub frames, bf16 whatever the model's dtype, as
    # serve() draws them
    frames = None if cfg.encoder is None else stub_frames(
        cfg, SERVE_BATCH, rng, dev)
    for dtype in (torch.bfloat16, torch.float32):
        c = cfg
        if dtype == torch.float32:
            del params, model
            gc.collect()
            torch.cuda.empty_cache()
            c = serve_cell_config(arch, cell["f32_layers"])
        m = build_model(drop_free(c), dtype=dtype, device=dev)
        p = params if dtype == torch.bfloat16 else m.init(
            torch.Generator(device=dev).manual_seed(0))
        limit = cache_limit(cfg) if dtype == torch.bfloat16 else F32_REL_TOL
        with RouteHold() as hold:
            dec = decode_built(m, p, prompts, SERVE_PROMPT + SERVE_NEW,
                               frames)
            if c.moe is not None:
                hold.replay(hold.decode_plan(moe_layers(c)))
            r = prefill_vs_decode(m, p, prompts, *dec, row_limit=limit,
                                  frames=frames)
        name = str(dtype).removeprefix("torch.")
        emit({"phase": phase, "part": "prefill_vs_decode", "dtype": name,
              "n_layers": c.n_layers, **reduced, "limit": limit,
              "routing": "held" if c.moe is not None else None,
              "batch": SERVE_BATCH, "positions": SERVE_PROMPT, **r})
        check(all(v <= limit for v in r["cache_rel_err_max"].values()),
              f"{phase} {name}: prefill and decode caches differ: {r}")
        if dtype == torch.float32:
            check(r["logits_rel_err"] <= F32_REL_TOL,
                  f"{phase}: f32 prefill and decode logits differ")
            check(r["top1_equal_rows"] >= SERVE_BATCH - 1,
                  f"{phase}: prefill and decode top-1 agree on "
                  f"{r['top1_equal_rows']} of {SERVE_BATCH} rows")
        del m, p, dec
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _family_run(arch: str, device: str, init_np):
    """Reduced ``arch`` in f32: loss and aux loss under "blockwise" (the
    training impl), a prefill under "pallas" and ``FAMILY_PARITY_STEPS``
    teacher-forced decode steps, from the same params and seeded inputs
    (whisper's stub frames in bf16, as ``serve`` passes them, its decode
    against the prefill's ``cross_kv``)."""
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
    if cfg.frontend == "audio":
        b["frontend_embeds"] = rng.standard_normal(
            (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    if cfg.frontend == "audio":
        b["frontend_embeds"] = b["frontend_embeds"].to(torch.bfloat16)
    with torch.no_grad():
        total, m = model.loss_fn(params, b)
    attention.set_attention_impl("pallas")
    try:
        logits, cache = model.prefill(
            params, {k: v for k, v in b.items() if k != "labels"})
    finally:
        attention.set_attention_impl("blockwise")
    dec = model.init_cache(2, FAMILY_PARITY_STEPS)
    if cfg.encoder is not None:
        dec["cross_kv"] = cache["cross_kv"]
    steps = []
    for pos in range(FAMILY_PARITY_STEPS):
        lg, dec = model.decode_step(params, dec,
                                    b["tokens"][:, pos:pos + 1], pos)
        steps.append(lg.cpu())
    return {"total": float(total), "loss": float(m["loss"]),
            "aux_loss": float(m["aux_loss"]), "logits": logits.cpu(),
            "cache": [t.cpu() for _, t in cache_entries(cache)],
            "decode": torch.stack(steps)}


def phase_reduced_family_parity() -> None:
    """The reduced qwen2-7b, phi-3-vision (with patch embeddings),
    granite-moe, deepseek-v2 (MLA), jamba (the hybrid, 16 layers), rwkv6
    and whisper (2 + 2 layers, 16 bf16 stub frames) in f32, card against
    CPU from the same params: loss and aux loss within rtol 1e-4, prefill
    logits, every cache entry (whisper's ``cross_kv`` too) and 4 decode
    steps' logits within atol 1e-4 / rtol 1e-4 (f32 sums in other orders,
    as ``reduced_serve_parity``); the card's prefill launches the flash
    kernel by ``flash_launches`` (once a layer of kind "a"; jamba: 2 of
    16; deepseek and rwkv6: none; whisper: its 2 decoder layers and, at
    16 frames, its 2 encoder layers, not causal)."""
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
        flash = ops.flash_attention_op.launches - before
        want = flash_launches(cfg, FAMILY_PARITY_SEQ)
        check(flash == want, f"{arch}: the card's prefill launched the flash "
                             f"kernel {flash} times, want {want}")
        cpu = _family_run(arch, "cpu", init)
        errs = {k: abs(card[k] - cpu[k]) for k in ("total", "loss",
                                                   "aux_loss")}
        for k in ("logits", "decode"):
            errs[k] = float((card[k] - cpu[k]).abs().max())
        errs["cache"] = max(float((a - b).abs().max())
                            for a, b in zip(card["cache"], cpu["cache"]))
        emit({"phase": "reduced_family_parity", "arch": arch,
              "layer_pattern": cfg.layer_pattern, "n_layers": cfg.n_layers,
              "moe": cfg.moe is not None, "frontend": cfg.frontend,
              "flash_launches": flash, "cache_entries": len(card["cache"]),
              "loss_card": card["loss"], "aux_loss_card": card["aux_loss"],
              "max_abs_err": errs})
        for k in ("total", "loss", "aux_loss"):
            check(errs[k] <= 1e-4 * abs(cpu[k]) + 1e-6,
                  f"{arch} {k}: card {card[k]} vs CPU {cpu[k]}")
        pairs = [("logits", card["logits"], cpu["logits"]),
                 ("decode", card["decode"], cpu["decode"]),
                 *(("cache", a, b) for a, b in zip(card["cache"],
                                                   cpu["cache"]))]
        for k, a, b in pairs:
            check(a.shape == b.shape
                  and torch.allclose(a, b, rtol=1e-4, atol=1e-4),
                  f"{arch} {k}: card and CPU differ by {errs[k]}")
        check((card["aux_loss"] > 0) == (cfg.moe is not None),
              f"{arch}: aux loss {card['aux_loss']}")


# --------------------------------------------------------------------------- #
# --------------------------------------------------------------------------- #
# slice 12: the dry-run (cell U) and deepseek-v2's one-layer training
# through the donating call (cell T)
# --------------------------------------------------------------------------- #
DRYRUN_CELL = ("qwen2-0.5b", "train_4k")     # cell U, on 16x16
DRYRUN_TIMEOUT_S = 400
# the reference's numbers for cell U (the card host has no JAX):
# ``PYTHONPATH=src python -m repro.launch.dryrun --arch qwen2-0.5b --shape
# train_4k`` on the 16x16 mesh of 256 forced CPU devices (jax 0.9.0), its
# ``flops_per_device`` and ``memory.peak_bytes``
DRYRUN_REF_FLOPS = 20711045332992.0
DRYRUN_REF_PEAK = 5329617256
# the port recomputes each loss chunk's logits in the backward, and
# splits the heads that do not divide the model axis with the queries
# (qwen2-0.5b's 14 over 16: 1.054x in all); 1.2x of the reference's
# FLOPs a rank allows both
DRYRUN_FLOPS_RATIO = 1.2
# cell U's further cells, traced beside the first:
# whisper-tiny's (6 heads over 16 ranks: 3 heads and an eighth of the
# queries a rank, ``attention._attend_split``) held within
# DRYRUN_FLOPS_RATIO of the reference's FLOPs a rank, and stablelm-1.6b's
# 32k prefill (its cache laid out a layer at a time, one all-to-all a
# leaf) within DRYRUN_PEAK_RATIO of the reference's peak a rank;
# deepseek-v2's train_4k (the router on each rank's own tokens, the q
# latent's gradient on each rank's block of its columns) within its own
# ``flops_ratio``, and granite-moe's 32k prefill (the experts' one-hots of
# a rank's own groups and experts) within DRYRUN_PEAK_RATIO, and
# jamba's train_4k (its mamba layers' ``softplus_backward`` finds its
# sharding through DTensor's decomposition search, which op_analysis
# leaves uncounted: 252.69 GB a rank when it was counted) within
# DRYRUN_PEAK_RATIO; the reference's numbers from its dry-run as
# DRYRUN_REF_FLOPS's
DRYRUN_CELLS = {
    ("whisper-tiny", "train_4k"): {"flops": 1851360313344.0},
    ("whisper-tiny", "prefill_32k"): {"flops": 946953756672.0},
    ("stablelm-1.6b", "prefill_32k"): {"peak": 1936736848},
    ("deepseek-v2-236b", "train_4k"): {"flops": 1149148027944960.0,
                                       "flops_ratio": 1.05},
    ("granite-moe-1b-a400m", "prefill_32k"): {"peak": 650155048},
    ("jamba-v0.1-52b", "train_4k"): {"peak": 53441842080},
}
DRYRUN_PEAK_RATIO = 2.0
# the longest of DRYRUN_CELLS (193 s of one core of an H100 host's CPU,
# torch 2.11), traced in a subprocess of its own, the others in another
DRYRUN_LONG = ("jamba-v0.1-52b", "train_4k")
# cell U's softplus probe: one DTensor ``F.softplus(x.float())`` forward
# and backward over PROBE_RANKS fake ranks, each holding a bf16 block of
# PROBE_LOCAL; its peak at most PROBE_PEAK_RATIO times that block's bytes
# and no op above the block in f32 (6.88 GB, 205x, when the search was
# counted)
PROBE_RANKS, PROBE_LOCAL = 16, (64, 1024, 256)
PROBE_PEAK_RATIO = 16
DS_ARCH, DS_LAYERS = "deepseek-v2-236b", 1   # cell T: cell S2's part
DS_BATCH = 2                     # train_4k's global batch 256, cut to 2
DS_FIT_BYTES = 76e9              # each step must be predicted at or below
CARD_BYTES = 80e9
# the measured peak of a step against the dry-run's prediction (its
# argument bytes swapped for all the process held at the step's start):
# on an H100 80GB HBM3 at 700 W the peaks read up to +0.26% (cell B: 34
# MB, about cuBLAS's workspace, which the trace does not see) and under
# +0.01% (cell T); 2% is eight times the largest reading
PEAK_PRED_TOL = 0.02
DS_REDUCED_SEQ = 32
DS_TRAIN_CUTS = [
    "deepseek-v2-236b: 1 of 60 layers at its published widths (cell S2's "
    "part; 5.02 B parameters with the embedding and head)",
    "train_4k's seq 4,096 x global batch 256 cut to 4,096 x 2",
    "1 warm-up and 1 timed step of each step",
]


def ds_train_setup():
    from repro_torch.configs import get_config, get_shape
    cfg = dataclasses.replace(get_config(DS_ARCH), n_layers=DS_LAYERS)
    return cfg, dataclasses.replace(get_shape("train_4k"),
                                    global_batch=DS_BATCH)


DS_STEPS = {"auto": dict(grad_path="auto"),
            "mlfabric": dict(grad_path="mlfabric", compress_inter=True)}


def step_predictions(dev) -> dict:
    """The dry-run's analysis (``launch/op_analysis.py`` on fake tensors on
    the card) of cell T's two donated steps, of its auto step without
    donation (the peak donation saves; not run), and of cell B's plain
    ``mlfabric_step`` (its ``fn``), on this process's ``(pod=1, data=1)``
    mesh, each printed."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.launch.dryrun import analyze_step

    mesh = make_host_mesh(device=dev)
    ds_cfg, ds_shape = ds_train_setup()
    b_shape = dataclasses.replace(get_shape("train_4k"),
                                  global_batch=STEP_BATCH)
    cells = {f"deepseek_train/{k}": (ds_cfg, ds_shape, kw, True)
             for k, kw in DS_STEPS.items()}
    cells["deepseek_train/auto_functional"] = (ds_cfg, ds_shape,
                                               DS_STEPS["auto"], False)
    cells["mlfabric_step/mlfabric"] = (get_config(FULL_ARCH), b_shape,
                                       dict(grad_path="mlfabric"), False)
    out = {}
    for name, (cfg, shape, kw, donate) in cells.items():
        bundle = build_step(cfg, shape, mesh, lr=STEP_LR, gamma=STEP_GAMMA,
                            remat=True, **kw)
        r = analyze_step(bundle, cfg, shape, mesh, kw["grad_path"],
                         donate=donate)
        out[name] = r
        emit({"phase": "dryrun", "prediction": name, "arch": cfg.name,
              "n_layers": cfg.n_layers, "seq_len": shape.seq_len,
              "global_batch": shape.global_batch, "donated": donate,
              "peak_bytes": r["peak_bytes"],
              "argument_bytes": r["argument_bytes"],
              "peak_holders": r["peak_holders"], "flops": r["flops"],
              "bytes": r["bytes"], "launches": r["launches"],
              "trace_s": r["trace_s"]})
    return out


def sharded_prediction(out_dir: str) -> None:
    """The dry-run's prediction of cell R's auto step (``analyze_step`` of
    its ``fn``, as ``sharded_rank`` calls it) as rank 0 of a fake world of
    four ranks on ``SHARDED_MESH``, written to ``out_dir``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build_step, make_mesh
    from repro_torch.launch.dryrun import analyze_step, fake_world, \
        trace_device
    fake_world(4)
    mesh = make_mesh(*SHARDED_MESH, device=trace_device())
    cfg, shape = get_config(FULL_ARCH), sharded_shapes()["train"]
    bundle = build_step(cfg, shape, mesh, lr=STEP_LR, gamma=STEP_GAMMA,
                        remat=True, **SHARDED_TRAIN["auto"])
    r = analyze_step(bundle, cfg, shape, mesh, "auto", donate=False)
    with open(os.path.join(out_dir, "sharded_auto.json"), "w") as f:
        json.dump(r, f)


def family_predictions(out_dir: str) -> None:
    """The dry-run's predictions of the steps of ``FAMILY_PREDICTED``'s
    parts (``analyze_step`` of each step's ``fn``, as
    ``family_sharded_train`` calls it) as rank 0 of a fake world of four
    ranks on the part's mesh, each written to ``out_dir``."""
    from repro_torch.launch import build_step, make_mesh
    from repro_torch.launch.dryrun import analyze_step, fake_world, \
        trace_device
    fake_world(4)
    for part in FAMILY_PREDICTED:
        spec = FAMILY_PARTS[part]
        mesh = make_mesh(*FAMILY_MESHES[spec["mesh"]], device=trace_device())
        cfg, shape = family_part_config(part), family_shapes(part)["train"]
        for name in spec["train"]:
            kw = SHARDED_TRAIN[name]
            bundle = build_step(cfg, shape, mesh, lr=STEP_LR,
                                gamma=STEP_GAMMA, remat=True, **kw)
            r = analyze_step(bundle, cfg, shape, mesh,
                             kw.get("grad_path", "auto"),
                             donate=spec.get("donate", False))
            with open(os.path.join(out_dir, f"{part}_{name}.json"),
                      "w") as f:
                json.dump(r, f)


def softplus_probe(out_dir: str) -> None:
    """Cell U's softplus probe (see ``PROBE_RANKS``) as rank 0 of a fake
    world, traced under ``OpAnalysis`` on this card's torch: its peak and
    holders, and how this torch finds ``softplus_backward``'s sharding
    (no rule of its own; the decomposition search, a ``staticmethod`` in
    torch 2.11), written to ``out_dir``."""
    import torch
    import torch.nn.functional as F
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._decompositions import \
        DecompShardingStrategy
    from repro_torch.launch.dryrun import fake_world, trace_device
    from repro_torch.launch.op_analysis import OpAnalysis

    fake_world(PROBE_RANKS)
    dev = trace_device()
    mesh = init_device_mesh(dev.type, (PROBE_RANKS,))
    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.softplus_backward.default
    rules = (prop.op_strategy_funcs, prop.op_to_rules,
             prop.op_single_dim_strategy_funcs)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        local = torch.empty(PROBE_LOCAL, dtype=torch.bfloat16, device=dev,
                            requires_grad=True)
        x = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
        oa = OpAnalysis()
        oa.track(x)
        with oa:
            F.softplus(x.float()).sum().backward()
    with open(os.path.join(out_dir, "softplus_probe.json"), "w") as f:
        json.dump({"torch": torch.__version__, "trace_device": str(dev),
                   "softplus_backward_has_rule": any(op in r for r in rules),
                   "propagate_strategy": type(DecompShardingStrategy.__dict__[
                       "propagate_strategy"]).__name__,
                   "local_bytes": local.numel() * local.element_size(),
                   "peak_bytes": oa.peak_bytes,
                   "peak_holders": oa.peak_holders,
                   "trace_s": time.perf_counter() - t0}, f)


def dryrun_cells(out_dir: str, long: bool) -> None:
    """``DRYRUN_CELLS`` through ``dryrun.run_cell`` on 16x16, each written
    to ``out_dir``: ``DRYRUN_LONG`` alone, or all the others."""
    from repro_torch.launch import dryrun
    for arch, shape in DRYRUN_CELLS:
        if ((arch, shape) == DRYRUN_LONG) == long:
            dryrun.run_cell(arch, shape, out_dir=out_dir)


def start_dryrun() -> tuple:
    """Cell U, started: the softplus probe, the dry-run CLI on one
    production cell with ``--save-hlo``, then the predictions of cell R's
    auto step (``sharded_prediction``) and of cell S's
    ``FAMILY_PREDICTED`` steps (``family_predictions``) in one subprocess,
    and beside it ``DRYRUN_LONG`` and the other ``DRYRUN_CELLS`` in one
    each (this card's torch, each on one of the host's CPU cores while
    the card runs other phases, which report no time); returns the
    running cell for ``finish_dryrun``.  The subprocesses are killed at
    exit if the script stops before they end."""
    import atexit
    import tempfile

    arch, shape = DRYRUN_CELL
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), str(root)]), OMP_NUM_THREADS="1")
    code = ("import sys, chip_smoke\n"
            "from repro_torch.launch import dryrun\n"
            "arch, shape, out = sys.argv[1:4]\n"
            "chip_smoke.softplus_probe(out)\n"
            "sys.argv = ['dryrun', '--arch', arch, '--shape', shape,"
            " '--out', out, '--save-hlo']\n"
            "rc = dryrun.main()\n"
            "chip_smoke.sharded_prediction(out)\n"
            "chip_smoke.family_predictions(out)\n"
            "sys.exit(rc)\n")
    cells = ("import sys, chip_smoke\n"
             "chip_smoke.dryrun_cells(sys.argv[3], long={})\n")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", c, arch, shape, out_dir], cwd=str(root),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in (code, cells.format(False), cells.format(True))]
    for p in procs:
        atexit.register(lambda p=p: p.poll() is None and p.kill())
    return procs, out_dir, t0


# the tensor twins of ``examples/`` and their fast flags (those of
# ``tests/test_examples_smoke.py``), run on the card
EXAMPLES = {
    "async_vs_sync.py": ["--quick"],
    "bounded_replication.py": [],
    "failover.py": [],
    "lda_topic_model.py": ["--quick"],
    "serve_decode.py": ["--batch", "1", "--prompt-len", "8",
                        "--new-tokens", "4"],
}
EXAMPLES_TIMEOUT_S = 600
# a twin run as its user runs it, then the port's kernel launches in its
# process printed on a last line
_EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "from repro_torch.kernels import ops\n"
    "print('LAUNCHES ' + json.dumps({k: getattr(ops, k + '_op').launches "
    "for k in %r}))\n" % (KERNELS,))


def start_examples() -> dict:
    """The ``examples`` phase, started: each tensor twin of
    ``examples_torch/`` in a subprocess of its own on the card, all at
    once (beside the parity phases, which report no time)."""
    import atexit
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for name, args in EXAMPLES.items():
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-c", _EXAMPLE_RUNNER,
             str(root / "examples_torch" / name), *args, "--device", "cuda"],
            cwd=str(root), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for _, p in procs.values():
        atexit.register(lambda p=p: p.poll() is None and p.kill())
    return procs


def finish_examples(procs: dict) -> dict:
    """The ``examples`` phase's results: each twin exits 0 and prints; its
    output, seconds and launches are printed.  Returns the launches."""
    totals = dict.fromkeys(KERNELS, 0)
    for name, (t0, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        lines = stdout.strip().splitlines()
        launches = (json.loads(lines[-1].split(" ", 1)[1])
                    if lines and lines[-1].startswith("LAUNCHES ") else {})
        emit({"phase": "examples", "example": name, "args": EXAMPLES[name],
              "exit": proc.returncode, "s_to_finish":
                  time.perf_counter() - t0, "launches": launches,
              "output": lines[:-1]})
        check(proc.returncode == 0,
              f"examples_torch/{name}: exit {proc.returncode}: "
              f"{stderr[-2000:]}")
        check(len(lines) > 1, f"examples_torch/{name} printed nothing")
        for k in KERNELS:
            totals[k] += launches.get(k, 0)
    return totals


def finish_dryrun(cell: tuple) -> dict:
    """Cell U's result: read, printed and checked (its FLOPs a rank within
    ``DRYRUN_FLOPS_RATIO`` of the reference's, its peak a rank below the
    card; ``DRYRUN_CELLS`` within their bounds); returns the predictions:
    cell R's auto step (``"sharded/auto"``) and each step of a
    ``FAMILY_PREDICTED`` part (``"{part}/{step}"``)."""
    import shutil
    import torch
    from repro_torch.launch.op_analysis import read_op_listing

    procs, out_dir, t0 = cell
    arch, shape = DRYRUN_CELL
    outs = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        check(proc.returncode == 0,
              f"dryrun {arch} {shape}: exit {proc.returncode}: "
              f"{stderr[-2000:]}")
        outs.append(stdout)
    wall = time.perf_counter() - t0
    stdout = outs[0]
    with open(os.path.join(out_dir, f"{arch}__{shape}__16-16.json")) as f:
        res = json.load(f)
    with open(os.path.join(out_dir, f"{arch}__{shape}__16-16.ops.txt")) as f:
        listing = read_op_listing(f.read())
    with open(os.path.join(out_dir, "softplus_probe.json")) as f:
        probe = json.load(f)
    with open(os.path.join(out_dir, "sharded_auto.json")) as f:
        pred = json.load(f)
    preds = {"sharded/auto": pred}
    for part in FAMILY_PREDICTED:
        for name in FAMILY_PARTS[part]["train"]:
            with open(os.path.join(out_dir, f"{part}_{name}.json")) as f:
                preds[f"{part}/{name}"] = json.load(f)
    cells = {}
    for a, sh in DRYRUN_CELLS:
        with open(os.path.join(out_dir, f"{a}__{sh}__16-16.json")) as f:
            cells[a, sh] = json.load(f)
    shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "dryrun", "cell": "U", "arch": arch, "shape": shape,
          "torch": torch.__version__, "line": stdout.strip().splitlines()[-1],
          **{k: res[k] for k in (
              "mesh", "n_devices", "status", "trace_s", "trace_device",
              "flops_per_device", "bytes_per_device",
              "collective_bytes_per_device", "collective_by_kind",
              "memory", "t_compute", "t_memory", "t_collective",
              "bottleneck")},
          "reference_flops_per_device": DRYRUN_REF_FLOPS,
          "reference_peak_bytes": DRYRUN_REF_PEAK,
          "flops_vs_reference": res["flops_per_device"] / DRYRUN_REF_FLOPS,
          "peak_vs_reference": res["memory"]["peak_bytes"] / DRYRUN_REF_PEAK,
          "wall_s_to_finish": wall})
    emit({"phase": "dryrun", "prediction": "sharded/auto",
          "mesh": SHARDED_MESH, "peak_bytes": pred["peak_bytes"],
          "argument_bytes": pred["argument_bytes"],
          "peak_holders": pred["peak_holders"], "flops": pred["flops"],
          "trace_s": pred["trace_s"]})
    for key, p in preds.items():
        if key == "sharded/auto":
            continue
        part = key.split("/")[0]
        emit({"phase": "dryrun", "prediction": key,
              "mesh": FAMILY_MESHES[FAMILY_PARTS[part]["mesh"]],
              "donated": bool(FAMILY_PARTS[part].get("donate")),
              "peak_bytes": p["peak_bytes"],
              "argument_bytes": p["argument_bytes"],
              "peak_holders": p["peak_holders"], "flops": p["flops"],
              "launches": p["launches"], "trace_s": p["trace_s"]})
    check(res["status"] == "ok" and res["n_devices"] == 256,
          f"dryrun {arch} {shape}: {res['status']}")
    check(res["trace_device"].startswith("cuda"),
          f"dryrun traced on {res['trace_device']}, not the card")
    check(res["flops_per_device"] > 0 and res["memory"]["peak_bytes"] > 0
          and res["collective_bytes_per_device"] > 0,
          f"dryrun {arch} {shape}: empty counts")
    check(res["flops_per_device"] <= DRYRUN_FLOPS_RATIO * DRYRUN_REF_FLOPS,
          f"dryrun {arch} {shape}: {res['flops_per_device']} FLOPs a rank "
          f"against the reference's {DRYRUN_REF_FLOPS}")
    check(res["memory"]["peak_bytes"] < CARD_BYTES,
          f"dryrun {arch} {shape}: peak {res['memory']['peak_bytes']} a rank")
    rows = sorted(listing["rows"].items(), key=lambda kv: -kv[1][1])
    emit({"phase": "dryrun", "cell": "U", "op_listing": f"{arch}__{shape}",
          "keys": len(rows), "total": listing["total"],
          "flops_per_device": res["flops_per_device"],
          "bytes_per_device": res["bytes_per_device"],
          "top_flops": [[k, *v] for k, v in rows[:3]]})
    check(listing["total"] is not None
          and listing["total"]["flops"] == res["flops_per_device"]
          and listing["total"]["bytes"] == res["bytes_per_device"],
          f"dryrun {arch} {shape}: the op listing's totals "
          f"{listing['total']} against {res['flops_per_device']} FLOPs and "
          f"{res['bytes_per_device']} bytes")
    emit({"phase": "dryrun", "cell": "U", "probe": "softplus",
          "ranks": PROBE_RANKS, "local": PROBE_LOCAL, **probe,
          "peak_vs_local": probe["peak_bytes"] / probe["local_bytes"]})
    check(probe["trace_device"].startswith("cuda"),
          f"softplus probe traced on {probe['trace_device']}")
    check(probe["peak_bytes"] <= PROBE_PEAK_RATIO * probe["local_bytes"]
          and max(probe["peak_holders"].values())
          <= 2 * probe["local_bytes"],
          f"softplus probe: peak {probe['peak_bytes']} against "
          f"{PROBE_PEAK_RATIO}x {probe['local_bytes']}, holders "
          f"{probe['peak_holders']}")
    for (a, sh), r in cells.items():
        ref = DRYRUN_CELLS[a, sh]
        m = r.get("memory", {})
        emit({"phase": "dryrun", "cell": "U", "arch": a, "shape": sh,
              **{k: r.get(k) for k in ("mesh", "status", "trace_s",
                                       "trace_device", "flops_per_device",
                                       "collective_by_kind")},
              "peak_bytes": m.get("peak_bytes"),
              "peak_holders": m.get("peak_holders"),
              "scope_peaks": m.get("scope_peaks"),
              "reference": ref,
              "flops_vs_reference": (r["flops_per_device"] / ref["flops"]
                                     if "flops" in ref else None),
              "peak_vs_reference": (m["peak_bytes"] / ref["peak"]
                                    if "peak" in ref else None)})
        check(r["status"] == "ok" and r["trace_device"].startswith("cuda"),
              f"dryrun {a} {sh}: {r['status']} on {r.get('trace_device')}")
        if "flops" in ref:
            ratio = ref.get("flops_ratio", DRYRUN_FLOPS_RATIO)
            check(r["flops_per_device"] <= ratio * ref["flops"],
                  f"dryrun {a} {sh}: {r['flops_per_device']} FLOPs a rank "
                  f"against the reference's {ref['flops']} (limit "
                  f"{ratio}x)")
        if "peak" in ref:
            check(m["peak_bytes"] <= DRYRUN_PEAK_RATIO * ref["peak"],
                  f"dryrun {a} {sh}: peak {m['peak_bytes']} a rank against "
                  f"the reference's {ref['peak']}")
    return preds


def peak_against_prediction(what: str, peak: int, at_start: int,
                            pred: dict, tol: float = PEAK_PRED_TOL) -> dict:
    """The prediction with its argument bytes swapped for all the process
    held when the step started, and the measured peak's error against
    it; checked within ``tol`` and below the card."""
    want = pred["peak_bytes"] - pred["argument_bytes"] + at_start
    err = (peak - want) / want
    check(peak < CARD_BYTES, f"{what}: peak {peak} bytes")
    check(abs(err) <= tol,
          f"{what}: peak {peak} against the dry-run's {want} "
          f"({err:+.3f}, limit {tol})")
    return {"max_memory_allocated": peak, "allocated_at_start": at_start,
            "predicted_peak": want, "peak_vs_prediction": err}


def _samples(tree) -> list:
    """Each leaf's seeded sample (``leaf_sample``) on the host."""
    from repro_torch.tree import tree_leaves
    return [t.reshape(-1)[leaf_sample(i, tuple(t.shape)).to(t.device)]
            .float().cpu() for i, t in enumerate(tree_leaves(tree))]


def inplace_bits(params, history, dev) -> dict:
    """``momentum_sgd_update_`` against ``momentum_sgd_update`` on every
    full-width leaf, one leaf at a time (copies of the leaf and its
    history, a seeded bf16 gradient): equal bit for bit."""
    import torch
    from repro_torch.optim import (MomentumState, momentum_sgd_update,
                                   momentum_sgd_update_)
    from repro_torch.tree import tree_leaves
    gen = torch.Generator(device=dev).manual_seed(7)
    equal, n = True, 0
    for p, h in zip(tree_leaves(params), tree_leaves(history)):
        g = torch.randn(p.shape, generator=gen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        want_p, want_s = momentum_sgd_update(
            {"x": p}, {"x": g}, MomentumState({"x": h}), lr=STEP_LR,
            gamma=STEP_GAMMA)
        pc, hc = p.clone(), h.clone()
        momentum_sgd_update_({"x": pc}, {"x": g}, MomentumState({"x": hc}),
                             lr=STEP_LR, gamma=STEP_GAMMA)
        equal &= bool(torch.equal(pc, want_p["x"])
                      and torch.equal(hc, want_s.history["x"]))
        n += p.numel()
        del g, want_p, want_s, pc, hc
    return {"leaves_equal": equal, "elements": n}


def _reduced_ds_donated(device: str, init_np) -> dict:
    """The reduced deepseek-v2 in f32: one donated auto step and one
    donated MLfabric step (uncompressed: card and CPU may round an f32
    gradient to different int8 steps) from the same params and batch."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.interop import to_torch
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_leaves

    cfg = get_config(DS_ARCH).reduced()
    shape = dataclasses.replace(get_shape("train_4k"),
                                seq_len=DS_REDUCED_SEQ, global_batch=2)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, DS_REDUCED_SEQ)).astype(np.int32)).to(device)
        for k in ("tokens", "labels")}
    mesh = make_host_mesh(device=device)
    out = {}
    for name, kw in (("auto", {}), ("mlfabric", {"grad_path": "mlfabric"})):
        params = to_torch(init_np, dtype=torch.float32, device=device)
        opt = momentum_sgd_init(params)
        step = build_step(cfg, shape, mesh, lr=REDUCED_STEP_LR, **kw)
        p, o, m = step.donating()(params, opt, batch)
        out[name] = {"loss": float(m["loss"]),
                     "aux_loss": float(m["aux_loss"]),
                     "leaves": [t.cpu() for t in tree_leaves((p, o))]}
    return out


def phase_deepseek_train(preds: dict) -> dict:
    """Cell T (see the module docstring); returns its launches."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.collectives import plan_reduce
    from repro_torch.interop import to_numpy
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import momentum_sgd_init
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg, shape = ds_train_setup()
    t0 = time.perf_counter()
    params = build_model(cfg, dtype=torch.bfloat16, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    opt = momentum_sgd_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mesh = make_host_mesh(device=dev)
    src = SyntheticLM(cfg.vocab_size, shape.seq_len, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in src.batch(i, DS_BATCH).items()}
               for i in range(2)]
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_buckets = len(plan_reduce(params, bucket_bytes=4 * 2 ** 20).buckets)
    ptrs = [t.data_ptr() for t in tree_leaves((params, opt))]
    emit({"phase": "deepseek_train", "part": "setup", "arch": cfg.name,
          "n_layers": cfg.n_layers, "params": n_params,
          "param_bytes": sum(t.numel() * t.element_size()
                             for t in tree_leaves(params)),
          "seq_len": shape.seq_len, "global_batch": DS_BATCH,
          "mesh": mesh.shape, "buckets": n_buckets, "init_s": init_s,
          "predicted_peak_functional":
              preds["deepseek_train/auto_functional"]["peak_bytes"],
          "reduced": DS_TRAIN_CUTS})
    totals = dict.fromkeys(KERNELS, 0)
    for name, kw in DS_STEPS.items():
        pred = preds[f"deepseek_train/{name}"]
        fits = pred["peak_bytes"] <= DS_FIT_BYTES
        if not fits:
            # the dry-run's peak and what holds it, line by line
            for op, nbytes in pred["peak_holders"].items():
                emit({"phase": "deepseek_train", "step": name,
                      "not_run": "predicted peak above DS_FIT_BYTES",
                      "predicted_peak": pred["peak_bytes"],
                      "held_by": op, "bytes": nbytes})
        check(fits, f"deepseek_train {name}: predicted peak "
                    f"{pred['peak_bytes']} above DS_FIT_BYTES")
        step = build_step(cfg, shape, mesh, lr=STEP_LR, gamma=STEP_GAMMA,
                          remat=True, **kw).donating()
        h_before = _samples(opt.history)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        at_start = torch.cuda.memory_allocated(dev)
        zero_launches()
        losses, secs, peaks = [], [], []
        for b in batches:
            p_before = _samples(params)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated(dev))
        launched = ops_launches()
        for k in totals:
            totals[k] += launched[k]
        kept = [t.data_ptr() for t in tree_leaves((params, opt))] == ptrs
        # every history leaf moves, and every param leaf took its last
        # update in place: p = (p_before + h) in f32, rounded to its dtype
        # (a bf16 norm scale near 1 may round back to itself)
        h_after = _samples(opt.history)
        moved = [bool(torch.any(a != b_)) for a, b_ in zip(h_after, h_before)]
        applied = [torch.equal(pa, (pb + h).to(t.dtype).float())
                   for pa, pb, h, t in zip(_samples(params), p_before,
                                           h_after, tree_leaves(params))]
        p_moved = sum(bool(torch.any(pa != pb)) for pa, pb in zip(
            _samples(params), p_before))
        want = dict.fromkeys(KERNELS, 0)
        if kw.get("compress_inter"):
            want.update(quantize=n_buckets * len(batches),
                        dequant_aggregate=n_buckets * len(batches))
        peak = peak_against_prediction(f"deepseek_train {name}", peaks[0],
                                       at_start, pred)
        emit({"phase": "deepseek_train", "step": name, "donated": True,
              "losses": losses, "warmup_s": secs[0], "step_s": secs[1:],
              "s_per_step": secs[-1],
              "tokens_per_s": DS_BATCH * shape.seq_len / secs[-1],
              "launches": launched, "storage_kept": kept,
              "history_leaves_moved": sum(moved), "leaves": len(moved),
              "param_leaves_moved_last_step": p_moved,
              "updates_applied": sum(applied),
              "max_memory_allocated_both": max(peaks), **peak})
        check(all(math.isfinite(l) for l in losses),
              f"deepseek_train {name}: non-finite loss {losses}")
        check(kept, f"deepseek_train {name}: a donated leaf moved storage")
        check(all(moved), f"deepseek_train {name}: "
                          f"{moved.count(False)} history leaves did not move")
        check(all(applied), f"deepseek_train {name}: {applied.count(False)}"
                            " param leaves did not take their update")
        check(launched == want,
              f"deepseek_train {name}: launched {launched}, want {want}")
        check(max(peaks) < CARD_BYTES,
              f"deepseek_train {name}: peak {max(peaks)}")
        del step, m
    bits = inplace_bits(params, opt.history, dev)
    emit({"phase": "deepseek_train", "part": "inplace_bits", **bits})
    check(bits["leaves_equal"], "the in-place update differs from "
                                "momentum_sgd_update at full width")
    del params, opt, batches
    gc.collect()
    torch.cuda.empty_cache()
    # the reduced model, card against CPU (phase_reduced_family_parity's
    # rule)
    from repro_torch.configs import get_config
    init = to_numpy(build_model(get_config(DS_ARCH).reduced(),
                                dtype=torch.float32, device="cpu")
                    .init(torch.Generator().manual_seed(0)))
    card = _reduced_ds_donated("cuda", init)
    cpu = _reduced_ds_donated("cpu", init)
    for name in card:
        errs = {k: abs(card[name][k] - cpu[name][k])
                for k in ("loss", "aux_loss")}
        errs["leaves"] = max(float((a - b).abs().max()) for a, b in zip(
            card[name]["leaves"], cpu[name]["leaves"]))
        emit({"phase": "deepseek_train", "part": "reduced", "step": name,
              "loss_card": card[name]["loss"], "max_abs_err": errs})
        for k in ("loss", "aux_loss"):
            check(errs[k] <= 1e-4 * abs(cpu[name][k]) + 1e-6,
                  f"reduced deepseek {name} {k}: card {card[name][k]} vs "
                  f"CPU {cpu[name][k]}")
        for a, b in zip(card[name]["leaves"], cpu[name]["leaves"]):
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
                  f"reduced deepseek {name}: card and CPU differ by "
                  f"{errs['leaves']}")
    emit({"phase": "deepseek_train", "part": "done",
          "seconds": time.perf_counter() - t_phase})
    return totals


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
    # cell U traces on the host's CPU from here until cell R reads it
    dryrun_cell = start_dryrun()
    phase_reduced_parity()
    launches = phase_main_path()
    phase_reduced_step_parity()
    phase_reduced_tier_parity()
    preds = step_predictions(torch.device("cuda", 0))
    step_launches = phase_mlfabric_step(preds["mlfabric_step/mlfabric"])
    tier_launches_ = phase_tiers()
    phase_reduced_serve_parity()
    serve_launches = phase_serve()
    train_launches = phase_train()
    pod_launches = phase_pod_async()
    elastic_launches = phase_elastic()
    examples = start_examples()
    phase_reduced_ps_parity()
    phase_mlfabric_ranks()
    phase_reduced_family_parity()
    examples_launches = finish_examples(examples)
    scenario_launches = phase_scenario(rows)
    moe_train_launches = phase_moe_train()
    moe_serve_launches = phase_moe_serve()
    vlm_launches = phase_vlm_serve()
    dense_7b_launches = phase_qwen2_7b_serve()
    family_launches = {SERVE_CELLS[a]["phase"]: phase_family_serve(a)
                       for a in SERVE_CELLS}
    family_launches["whisper_train"] = phase_whisper_train()
    family_launches["rwkv_train"] = phase_rwkv_train()
    dryrun_preds = finish_dryrun(dryrun_cell)
    family_launches["sharded"] = phase_sharded(dryrun_preds["sharded/auto"])
    family_launches["sharded_families"] = phase_sharded_families(dryrun_preds)
    family_launches["deepseek_train"] = phase_deepseek_train(preds)
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
               "qwen2_7b_serve": dense_7b_launches,
               "examples": examples_launches, **family_launches}
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
