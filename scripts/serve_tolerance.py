#!/usr/bin/env python3
"""The readings behind the bf16 limits of ``chip_smoke.py``'s ``serve``
phase, on one card.

    python3 scripts/serve_tolerance.py [N_SEEDS] [--arch ARCH]

Two checks of that phase hold one bf16 path through the full-width
Qwen2-0.5B (24 layers, random weights; ``--arch`` names another config,
as ``moe_serve`` runs granite-moe-1b-a400m, ``qwen2_7b_serve`` qwen2-7b
and cells M-O and Q deepseek-v2-236b, jamba-v0.1-52b, rwkv6-1.6b and
whisper-tiny at their cells' depth, prefill length and batch and f32
depth, ``chip_smoke.SERVE_CELLS``) against another:

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

Layers with no attention mask get faults of their own, planted the same
way in the prefill only (``chip_smoke.py``'s cells M-O):

* ``conv_late`` (mamba): the causal conv's window one step late, each
  output reading the inputs one position earlier;
* ``fp8_scan`` (mamba): the scan's inputs x, B and C rounded through
  float8 e4m3 (the decays dt and A left alone);
* ``shift_late`` (rwkv): the token shift one step late, x[t-2] for
  x[t-1], in the time and the channel mix;
* ``fp8_wkv`` (rwkv): r, k and v rounded through float8 before the WKV
  chunks (the decays left alone);
* ``fp8_ckv`` (MLA): the latent ckv rounded through float8, in the
  attention and in the cache.

An encoder-decoder (``--arch whisper-tiny``, cell Q) gets three of its
own, planted the same way:

* ``cross_causal``: the cross-attention under a causal mask, token t
  seeing frames 0..t only;
* ``frames_late``: the encoder's frames shifted one step late, frame f
  where f + 1 belongs;
* ``positions_late``: the decoder's sinusoidal positions one step late,
  token t at position t - 1.

Its prefill is cell Q's, ``prefill_32k`` at batch 32 beside bf16 stub
frames (``chip_smoke.stub_frames``) from a numpy generator seeded
5 + seed, and its prefill against decode draws frames from the prompts'
generator, as ``serve`` does.

A config without an attention layer launches no kernel: its "pallas" and
"blockwise" prefills run the same code, so only the prefill-vs-decode
check is read.

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
import contextlib
import dataclasses
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_SEEDS = 6


def fp8(t):
    """``t`` rounded through float8 e4m3 and back."""
    import torch
    return t.clamp(-448, 448).to(torch.float8_e4m3fn).to(t.dtype)


def faults(cfg):
    """{name: (module, attribute, replacement)} of the faults that apply
    to ``cfg``'s layer kinds, each replacement calling the real function;
    ``sound`` replaces nothing."""
    import torch
    from repro_torch.kernels.ops import flash_attention_op
    from repro_torch.models import attention, encdec, mamba, rwkv

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

    conv, scan = mamba._causal_conv, mamba.mamba_scan
    shift, wkv, latent = rwkv._token_shift, rwkv._wkv_chunk, \
        attention._mla_latent

    def conv_late(x, w, b, history):
        return conv(torch.cat([history[:, -1:].to(x.dtype), x[:, :-1]], 1),
                    w, b, torch.cat([torch.zeros_like(history[:, :1]),
                                     history[:, :-1]], 1))

    def fp8_scan(x_in, dt, a_log, b_ssm, c_ssm, *args, **kw):
        return scan(fp8(x_in), dt, a_log, fp8(b_ssm), fp8(c_ssm), *args,
                    **kw)

    def fp8_wkv(r, k, v, *args):
        return wkv(fp8(r), fp8(k), fp8(v), *args)

    def fp8_ckv(*args):
        ckv, krope = latent(*args)
        return fp8(ckv), krope

    kinds = set(cfg.layer_kinds)
    out = {"sound": None}
    if "a" in kinds:
        out.update((name, (attention, "flash_attention_op", fn)) for name, fn
                   in (("leak_next", leak_next), ("fp8_qkv", fp8_qkv),
                       ("scale_1pct", scale_1pct)))
    if "m" in kinds:
        out.update(conv_late=(mamba, "_causal_conv", conv_late),
                   fp8_scan=(mamba, "mamba_scan", fp8_scan))
    if "r" in kinds:
        out.update(shift_late=(rwkv, "_token_shift",
                               lambda x, prev: shift(shift(x, prev), prev)),
                   fp8_wkv=(rwkv, "_wkv_chunk", fp8_wkv))
    if "l" in kinds:
        out["fp8_ckv"] = (attention, "_mla_latent", fp8_ckv)
    if cfg.encoder is not None:
        blockwise, encode = attention.blockwise_attention, encdec.encode
        positions, n_frames = encdec.sinusoidal_positions, \
            cfg.encoder.n_frames

        def cross_causal(q, k, v, *, causal, **kw):
            # the cross-attention is the call whose keys are the frames
            return blockwise(q, k, v, causal=causal or k.shape[1] !=
                             q.shape[1], **kw)

        def frames_late(params, frames, c):
            return encode(params, torch.cat([frames[:, :1], frames[:, :-1]],
                                            1), c)

        def positions_late(n, d, *, start=0, **kw):
            if n == n_frames and start == 0:          # the encoder's table
                return positions(n, d, **kw)
            late = positions(n, d, start=max(start - 1, 0), **kw)
            return late if start else torch.cat([late[:1], late[:-1]])

        out.update(cross_causal=(attention, "blockwise_attention",
                                 cross_causal),
                   frames_late=(encdec, "encode", frames_late),
                   positions_late=(encdec, "sinusoidal_positions",
                                   positions_late))
    return out


@contextlib.contextmanager
def planted(fault):
    """``fault`` (``faults``' value) in place while the block runs."""
    if fault is None:
        yield
        return
    module, name, fn = fault
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


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
    cell = cs.SERVE_CELLS.get(args.arch)
    cfg = cs.serve_cell_config(args.arch) if cell else get_config(args.arch)
    # prefill against decode at a drop-free capacity, as moe_serve runs it;
    # a cell's f32 model at its own depth, from the seed (bf16 freed first)
    cfg_dec = cs.drop_free(cfg)
    cfg_f32 = cs.drop_free(cs.serve_cell_config(
        args.arch, cell["f32_layers"])) if cell else cfg_dec
    mesh = make_host_mesh(device=dev)
    vision = cfg.frontend == "vision"
    shape = dataclasses.replace(SHAPES["prefill_32k"],
                                global_batch=cs.PREFILL_BATCH)
    if vision:
        shape = dataclasses.replace(shape, seq_len=cs.VLM_SEQ)
    if cell:
        shape = dataclasses.replace(shape, seq_len=cell["prefill"],
                                    global_batch=cell["prefill_batch"])
    prefill = build_step(cfg, shape, mesh)
    # with no attention layer the two prefills run the same code
    read_prefill = cs.attention_layers(cfg) > 0
    check_pre = f"prefill_{shape.seq_len // 1024}k"
    limit_pre = cs.prefill_limit(cfg)
    limit_bf16 = cs.cache_limit(cfg)
    max_len = cs.SERVE_PROMPT + cs.SERVE_NEW
    planted_faults = faults(cfg)
    gated = {}                      # (check, dtype, fault) -> readings
    shares = {}                     # the same -> largest share of rows

    def record(check, dtype, fault, seed, value, reading, rows):
        gated.setdefault((check, dtype, fault), []).append(value)
        shares.setdefault((check, dtype, fault), []).append(
            max((r["rows_over"] for r in rows.values()), default=0.0))
        cs.emit({"part": "reading", "arch": cfg.name, "routing":
                 "held" if held else "free", "check": check,
                 "dtype": dtype, "fault": fault, "seed": seed,
                 "gated": value, **reading, "rows": rows})

    models = {torch.bfloat16: build_model(cfg_dec, dtype=torch.bfloat16,
                                          device=dev),
              torch.float32: build_model(cfg_f32, dtype=torch.float32,
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
                gen = torch.Generator(device=dev).manual_seed(5 + seed)
                batch = {"tokens": torch.randint(
                    0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
                    generator=gen, device=dev, dtype=torch.int32)}
                if cfg.encoder is not None:
                    batch["frontend_embeds"] = cs.stub_frames(
                        cfg, shape.global_batch,
                        np.random.default_rng(5 + seed), dev)
            attention.set_attention_impl("blockwise")
            hold.record()
            ref = prefill.fn(params, batch) if read_prefill else None
            calls = hold.calls
            attention.set_attention_impl("pallas")
            for fault, op in planted_faults.items():
                if not read_prefill:
                    break
                if held:
                    hold.replay(calls)
                with planted(op):
                    out = prefill.fn(params, batch)
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
            frames = None if cfg.encoder is None else cs.stub_frames(
                cfg, cs.SERVE_BATCH, rng, dev)
            for dtype, m in models.items():
                if cell and dtype == torch.float32:
                    # the cell's f32 check: its own depth, from the seed
                    del params
                    gc.collect()
                    torch.cuda.empty_cache()
                    params = p = m.init(
                        torch.Generator(device=dev).manual_seed(seed))
                else:
                    # an f32 router stays f32 in the bf16 model
                    p = tree_map(lambda t: t if t.dtype == torch.float32
                                 else t.to(dtype), params)
                hold.record()
                dec = cs.decode_built(m, p, prompts, max_len, frames)
                plan = hold.decode_plan(cs.moe_layers(m.config)) \
                    if held else None
                limit = (limit_bf16 if dtype == torch.bfloat16
                         else cs.F32_REL_TOL)
                for fault, op in planted_faults.items():
                    if held:
                        hold.replay(plan)
                    with planted(op):
                        r = cs.prefill_vs_decode(m, p, prompts, *dec,
                                                 row_limit=limit,
                                                 frames=frames)
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
                        "prefill_vs_decode bfloat16": limit_bf16,
                        "prefill_vs_decode float32": cs.F32_REL_TOL}})
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
