#!/usr/bin/env python3
"""The readings behind the bf16 limits of ``chip_smoke.py``'s ``serve``
phase, on one card.

    python3 scripts/serve_tolerance.py [N_SEEDS] [--arch ARCH]

Two checks of that phase hold one bf16 path through the full-width
Qwen2-0.5B (24 layers, random weights; ``--arch`` names another config,
as ``moe_serve`` runs granite-moe-1b-a400m and ``qwen2_7b_serve`` qwen2-7b)
against another:

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

Each reading also holds ``chip_smoke.cache_row_stats`` of k and v at the
check's limit: the share of cache rows (layer, position) above it and the
rows' median and 99th percentile.  For a config with experts the
prefill-vs-decode check runs at a drop-free capacity factor, and each run
replays the routing of the run it is compared with
(``chip_smoke.RouteHold``), as ``moe_serve`` does; ``--free-routing``
lets every run route afresh.

For a config with a vision prefix the prefill is ``vlm_serve``'s own
instead (``prefill_4k``: ``chip_smoke.VLM_SEQ`` positions, seeded stub
patch embeddings first, the text tokens and the embeddings from one card
generator at seed 6 + s), and the prefill-vs-decode check, which that
phase does not run, is left out.

The last line sums up each check and dtype: the largest sound reading of
the gated quantity (the largest of logits, k and v for ``prefill_32k``; of
k and v for ``prefill_vs_decode``) and each fault's smallest, and the same
for the largest share of rows over the limit.  Needs a CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
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
    from repro_torch.models import attention, build_model, text_len
    from repro_torch.tree import tree_map

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_seeds", type=int, nargs="?", default=N_SEEDS)
    ap.add_argument("--arch", default=cs.FULL_ARCH)
    ap.add_argument("--free-routing", action="store_true",
                    help="with experts, let every run route afresh instead "
                         "of replaying the reference run's routing")
    args = ap.parse_args()
    n_seeds = args.n_seeds
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    cfg = get_config(args.arch)
    # prefill against decode at a drop-free capacity, as moe_serve runs it
    cfg_dec = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    mesh = make_host_mesh(device=dev)
    vision = cfg.frontend == "vision"
    shape = dataclasses.replace(SHAPES["prefill_32k"],
                                global_batch=cs.PREFILL_BATCH)
    if vision:
        shape = dataclasses.replace(shape, seq_len=cs.VLM_SEQ)
    prefill = build_step(cfg, shape, mesh)
    check_pre = f"prefill_{shape.seq_len // 1024}k"
    limit_pre = cs.prefill_limit(cfg)
    max_len = cs.SERVE_PROMPT + cs.SERVE_NEW
    planted = faults()
    gated = {}                      # (check, dtype, fault) -> readings
    shares = {}                     # the same -> largest share of rows

    def record(check, dtype, fault, seed, value, reading, rows):
        gated.setdefault((check, dtype, fault), []).append(value)
        shares.setdefault((check, dtype, fault), []).append(
            max(r["rows_over"] for r in rows.values()))
        cs.emit({"part": "reading", "arch": cfg.name, "routing":
                 "held" if held else "free", "check": check,
                 "dtype": dtype, "fault": fault, "seed": seed,
                 "gated": value, **reading, "rows": rows})

    models = {torch.bfloat16: build_model(cfg_dec, dtype=torch.bfloat16,
                                          device=dev),
              torch.float32: build_model(cfg_dec, dtype=torch.float32,
                                         device=dev)}
    # --free-routing: a config with experts routes each run afresh
    held = cfg.moe is not None and not args.free_routing
    with torch.no_grad(), cs.RouteHold() as hold:
        for seed in range(n_seeds):
            params = models[torch.bfloat16].init(
                torch.Generator(device=dev).manual_seed(seed))
            # the serving phase's prefill, bf16
            if vision:
                gen = torch.Generator(device=dev).manual_seed(6 + seed)
                batch = {"tokens": torch.randint(
                    0, cfg.vocab_size,
                    (cs.PREFILL_BATCH, text_len(cfg, shape.seq_len)),
                    generator=gen, device=dev, dtype=torch.int32),
                    "frontend_embeds": torch.randn(
                        (cs.PREFILL_BATCH, cfg.n_frontend_tokens,
                         cfg.d_model), generator=gen, device=dev
                    ).to(torch.bfloat16)}
            else:
                batch = {"tokens": torch.randint(
                    0, cfg.vocab_size, (cs.PREFILL_BATCH, shape.seq_len),
                    generator=torch.Generator(device=dev).manual_seed(
                        5 + seed), device=dev, dtype=torch.int32)}
            attention.set_attention_impl("blockwise")
            hold.record()
            ref = prefill.fn(params, batch)
            calls = hold.calls
            attention.set_attention_impl("pallas")
            for fault, op in planted.items():
                attention.flash_attention_op = op
                if held:
                    hold.replay(calls)
                out = prefill.fn(params, batch)
                attention.flash_attention_op = planted["sound"]
                rel = cs.prefill_rel(*out, *ref)
                rows = cs.cache_row_stats(out[1], ref[1], limit_pre)
                del out
                record(check_pre, "bfloat16", fault, seed,
                       max(rel.values()), {"rel_err": rel}, rows)
            attention.set_attention_impl("blockwise")
            del ref, batch
            if vision:
                del params
                torch.cuda.empty_cache()
                continue
            # the prefill against the decode-built cache, bf16 and f32
            rng = np.random.default_rng(seed)
            prompts = torch.from_numpy(np.stack([
                rng.integers(0, cfg.vocab_size, cs.SERVE_PROMPT)
                .astype(np.int32) for _ in range(cs.SERVE_BATCH)])).to(dev)
            for dtype, m in models.items():
                # an f32 router stays f32 in the bf16 model
                p = tree_map(lambda t: t if t.dtype == torch.float32
                             else t.to(dtype), params)
                hold.record()
                dec = cs.decode_built(m, p, prompts, max_len)
                plan = hold.decode_plan(cfg.n_layers) if held else None
                limit = ((cs.BF16_CACHE_TOL if cfg.moe is None
                          else cs.MOE_CACHE_TOL)
                         if dtype == torch.bfloat16 else cs.F32_REL_TOL)
                for fault, op in planted.items():
                    attention.flash_attention_op = op
                    if held:
                        hold.replay(plan)
                    r = cs.prefill_vs_decode(m, p, prompts, *dec,
                                             row_limit=limit)
                    attention.flash_attention_op = planted["sound"]
                    rows = r.pop("rows")
                    record("prefill_vs_decode",
                           str(dtype).removeprefix("torch."), fault, seed,
                           max(r["cache_rel_err_max"].values()), r, rows)
                del p, dec
            del params
            torch.cuda.empty_cache()
    summary, row_summary = {}, {}
    for into, readings in ((summary, gated), (row_summary, shares)):
        for (check, dtype, fault), vals in readings.items():
            s = into.setdefault(f"{check} {dtype}", {})
            if fault == "sound":
                s["sound_max"] = max(vals)
            else:
                s[f"{fault}_min"] = min(vals)
    cs.emit({"part": "summary", "arch": cfg.name, "seeds": n_seeds,
             "routing": "held" if held else "free",
             "gated": summary, "rows_over_limit": row_summary,
             "limits": {f"{check_pre} bfloat16": limit_pre,
                        "prefill_vs_decode bfloat16": cs.BF16_CACHE_TOL
                        if cfg.moe is None else cs.MOE_CACHE_TOL,
                        "prefill_vs_decode float32": cs.F32_REL_TOL}})
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
