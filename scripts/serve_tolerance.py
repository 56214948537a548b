#!/usr/bin/env python3
"""The readings behind the bf16 limits of ``chip_smoke.py``'s ``serve``
phase, on one card.

    python3 scripts/serve_tolerance.py [N_SEEDS]

Two checks of that phase hold one bf16 path through the full-width
Qwen2-0.5B (24 layers, random weights) against another:

* ``prefill_32k``: the 32k prefill (batch 1) under "pallas" against the
  same prefill under "blockwise": logits, k and v, each as its largest
  difference over its largest value (``chip_smoke.prefill_rel``);
* ``prefill_vs_decode``: the "pallas" prefill of 4 prompts of 128 tokens
  against the cache that teacher-forced decode builds for them: k and v,
  the largest such share over the 24 layers (``chip_smoke.
  prefill_vs_decode``), read in bf16 and in f32.

For seeds 0 .. N_SEEDS - 1 (default 6; params from ``model.init`` at seed
s, prompts from ``numpy.random.default_rng(s)`` and the 32k tokens from a
card generator at seed 5 + s, so seed 0 is the ``serve`` phase's own
input) it prints one JSON line per reading: the sound path, and the same
path with one fault planted at run time in the prefill's attention (the
code under test is not changed):

* ``leak_next``: every query also sees the next key, the causal mask off by
  one: the flash kernel on inputs one row longer (q's first row repeated in
  front, k's and v's last row behind), the first output row dropped;
* ``fp8_qkv``: q, k and v rounded through float8 e4m3 before the kernel,
  a lower-precision control;
* ``scale_1pct``: the softmax scale 1% too large.

The last line sums up each check and dtype: the largest sound reading of
the gated quantity (the largest of logits, k and v for ``prefill_32k``; of
k and v for ``prefill_vs_decode``) and each fault's smallest.  Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_SEEDS = 6


def faults():
    """{name: replacement of ``flash_attention_op`` in the attention
    module}, each calling the real op."""
    import torch
    from repro_torch.kernels.ops import flash_attention_op

    def leak_next(q, k, v, **kw):
        q1 = torch.cat([q[:, :, :1], q], 2)
        k1, v1 = (torch.cat([t, t[:, :, -1:]], 2) for t in (k, v))
        return flash_attention_op(q1, k1, v1, **kw)[:, :, 1:]

    def fp8_qkv(q, k, v, **kw):
        q, k, v = (t.clamp(-448, 448).to(torch.float8_e4m3fn).to(t.dtype)
                   for t in (q, k, v))
        return flash_attention_op(q, k, v, **kw)

    def scale_1pct(q, k, v, *, scale, **kw):
        return flash_attention_op(q, k, v, scale=scale * 1.01, **kw)

    return {"sound": flash_attention_op, "leak_next": leak_next,
            "fp8_qkv": fp8_qkv, "scale_1pct": scale_1pct}


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed
    if not torch.cuda.is_available():
        print("serve_tolerance: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.models import attention, build_model
    from repro_torch.tree import tree_map

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else N_SEEDS
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    cfg = get_config(cs.FULL_ARCH)
    mesh = make_host_mesh(device=dev)
    shape = dataclasses.replace(SHAPES["prefill_32k"],
                                global_batch=cs.PREFILL_BATCH)
    prefill = build_step(cfg, shape, mesh)
    max_len = cs.SERVE_PROMPT + cs.SERVE_NEW
    planted = faults()
    gated = {}                      # (check, dtype, fault) -> readings

    def record(check, dtype, fault, seed, value, reading):
        gated.setdefault((check, dtype, fault), []).append(value)
        cs.emit({"part": "reading", "check": check, "dtype": dtype,
                 "fault": fault, "seed": seed, "gated": value, **reading})

    models = {torch.bfloat16: build_model(cfg, dtype=torch.bfloat16,
                                          device=dev),
              torch.float32: build_model(cfg, dtype=torch.float32,
                                         device=dev)}
    with torch.no_grad():
        for seed in range(n_seeds):
            params = models[torch.bfloat16].init(
                torch.Generator(device=dev).manual_seed(seed))
            # the 32k prefill, bf16
            tokens = torch.randint(
                0, cfg.vocab_size, (cs.PREFILL_BATCH, shape.seq_len),
                generator=torch.Generator(device=dev).manual_seed(5 + seed),
                device=dev, dtype=torch.int32)
            attention.set_attention_impl("blockwise")
            ref = prefill.fn(params, {"tokens": tokens})
            attention.set_attention_impl("pallas")
            for fault, op in planted.items():
                attention.flash_attention_op = op
                rel = cs.prefill_rel(*prefill.fn(params, {"tokens": tokens}),
                                     *ref)
                attention.flash_attention_op = planted["sound"]
                record("prefill_32k", "bfloat16", fault, seed,
                       max(rel.values()), {"rel_err": rel})
            attention.set_attention_impl("blockwise")
            del ref, tokens
            # the prefill against the decode-built cache, bf16 and f32
            rng = np.random.default_rng(seed)
            prompts = torch.from_numpy(np.stack([
                rng.integers(0, cfg.vocab_size, cs.SERVE_PROMPT)
                .astype(np.int32) for _ in range(cs.SERVE_BATCH)])).to(dev)
            for dtype, m in models.items():
                p = tree_map(lambda t: t.to(dtype), params)
                dec = cs.decode_built(m, p, prompts, max_len)
                for fault, op in planted.items():
                    attention.flash_attention_op = op
                    r = cs.prefill_vs_decode(m, p, prompts, *dec)
                    attention.flash_attention_op = planted["sound"]
                    record("prefill_vs_decode",
                           str(dtype).removeprefix("torch."), fault, seed,
                           max(r["cache_rel_err_max"].values()), r)
                del p, dec
            del params
            torch.cuda.empty_cache()
    summary = {}
    for (check, dtype, fault), vals in gated.items():
        s = summary.setdefault(f"{check} {dtype}", {})
        if fault == "sound":
            s["sound_max"] = max(vals)
        else:
            s[f"{fault}_min"] = min(vals)
    cs.emit({"part": "summary", "seeds": n_seeds, "gated": summary,
             "limits": {"prefill_32k bfloat16": cs.BF16_PREFILL_TOL,
                        "prefill_vs_decode bfloat16": cs.BF16_CACHE_TOL,
                        "prefill_vs_decode float32": cs.F32_REL_TOL}})
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
