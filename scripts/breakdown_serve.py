#!/usr/bin/env python3
"""Where a full-width prefill and a decode step spend their time, on one
card.

    python3 scripts/breakdown_serve.py [TRACE_PATH]
    python3 scripts/breakdown_serve.py --arch ARCH [TRACE_PATH]

Builds the serving steps of ``chip_smoke.py``'s ``serve`` phase (full-width
Qwen2-0.5B in bf16 from a seeded init; ``prefill_32k`` at seq 32768 with
batch 1 under the "pallas" impl, so attention is the CUDA flash kernel;
``decode_32k`` at batch 128 against a 32768-position cache filled from a
seeded generator, at pos 32767) and prints one JSON line per part:

1. ``layers``: for the prefill and the decode step, the model's pieces
   summed over the 24 layers, each timed on the host clock between two
   ``torch.cuda.synchronize()`` calls (embedding; per layer the norms, the
   q/k/v projections with RoPE, attention, the output projection, the MLP,
   and for decode the in-place cache write; the final norm and the
   unembedding), median of 3 after one warm-up, beside the whole step
   through ``StepBundle.fn``.
2. ``profile``: one prefill and one decode step under ``torch.profiler``
   after a warm-up: wall time, summed device time and busy share, the
   flash kernel's device time and share, and the top kernels.  The Chrome
   trace of the prefill goes to ``TRACE_PATH`` (default
   ``build/serve_prefill_trace.json.gz``).

With ``--arch`` one of ``chip_smoke.SERVE_CELLS`` (deepseek-v2-236b,
jamba-v0.1-52b, rwkv6-1.6b) it profiles that cell instead, as
``phase_family_serve`` builds it (its depth, its prefill length at batch
1, its decode shape and batch at the last position): the ``profile``
lines only, each with the count of kernels the step launched.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ITERS = 4


def synced(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dev_us(e) -> float:
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else getattr(e, "self_cuda_time_total", 0)


def prefill_pieces(params, tokens, cfg):
    """One prefill, piece by piece: {piece: seconds summed over layers}."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as ly
    from repro_torch.models.transformer import _unbind_layers
    t = defaultdict(float)

    def span(name, fn):
        out, dt = synced(fn)
        t[name] += dt
        return out

    with torch.no_grad():
        h = span("embed", lambda: ly.embed_tokens(params["embeds"], tokens))
        s = h.shape[1]
        pos = torch.arange(s, device=h.device)

        def qkv_rope(p, hn):
            q, k, v = attn._qkv(p["mix"], hn, cfg)
            return (ly.apply_rope(q, pos, cfg.rope_theta),
                    ly.apply_rope(k, pos, cfg.rope_theta), v)

        for p in _unbind_layers(params["layers"], cfg.n_layers):
            hn = span("norm", lambda: ly.apply_norm(cfg.norm, p["norm1"], h))
            q, k, v = span("qkv_rope", lambda: qkv_rope(p, hn))
            o = span("attention", lambda: attn.blockwise_attention(
                q, k, v, causal=True))
            h = span("wo_residual", lambda: h + o.reshape(
                *o.shape[:2], -1) @ p["mix"]["wo"])
            hn = span("norm", lambda: ly.apply_norm(cfg.norm, p["norm2"], h))
            h = span("mlp_residual", lambda: h + ly.apply_mlp(p["mlp"], hn,
                                                            act=cfg.act))
        span("final_norm_unembed", lambda: ly.unembed(
            params["embeds"], ly.apply_norm(cfg.norm, params["final_norm"],
                                            h)[:, -1]))
    return t


def decode_pieces(params, cache, tokens, pos, cfg):
    """One decode step, piece by piece (the cache written in place)."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as ly
    from repro_torch.models.transformer import _unbind_layers
    t = defaultdict(float)

    def span(name, fn):
        out, dt = synced(fn)
        t[name] += dt
        return out

    with torch.no_grad():
        h = span("embed", lambda: ly.embed_tokens(params["embeds"], tokens))
        layers = _unbind_layers(params["layers"], cfg.n_layers)
        caches = _unbind_layers(cache["layers"], cfg.n_layers)

        def qkv_rope(p, hn):
            q, k, v = attn._qkv(p["mix"], hn, cfg)
            return (*attn._rope_at(q, k, pos, cfg), v)

        def write(c, k, v):
            c["k"][:, pos] = k[:, 0]
            c["v"][:, pos] = v[:, 0]

        for p, c in zip(layers, caches):
            hn = span("norm", lambda: ly.apply_norm(cfg.norm, p["norm1"], h))
            q, k, v = span("qkv_rope", lambda: qkv_rope(p, hn))
            span("cache_write", lambda: write(c, k, v))
            o = span("attention", lambda: attn.decode_attention(
                q[:, 0], c["k"], c["v"], pos + 1))
            h = span("wo_residual", lambda: h + o.reshape(
                h.shape[0], 1, -1) @ p["mix"]["wo"])
            hn = span("norm", lambda: ly.apply_norm(cfg.norm, p["norm2"], h))
            h = span("mlp_residual", lambda: h + ly.apply_mlp(p["mlp"], hn,
                                                            act=cfg.act))
        span("final_norm_unembed", lambda: ly.unembed(
            params["embeds"], ly.apply_norm(cfg.norm, params["final_norm"],
                                            h)[:, -1]))
    return t


def profiled(fn, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile
    synced(fn)                                               # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    events.sort(key=dev_us, reverse=True)
    total_us = sum(dev_us(e) for e in events)
    flash = [e for e in events if "flash_kernel" in e.key]
    flash_ms = sum(dev_us(e) for e in flash) * 1e-3
    return prof, {"wall_s": wall, "device_s": total_us * 1e-6,
                  "device_busy_share": total_us * 1e-6 / wall,
                  "kernel_launches": sum(e.count for e in events),
                  "flash_kernel": {"calls": sum(e.count for e in flash),
                                   "device_ms": flash_ms,
                                   "share_of_wall": flash_ms * 1e-3 / wall},
                  "top": [{"name": e.key[:100], "calls": e.count,
                           "device_ms": dev_us(e) * 1e-3}
                          for e in events[:12]]}


def profile_cell(arch: str, trace_path: Path, dev) -> int:
    """``profiled`` on one prefill and one decode step of ``arch``'s serve
    cell; the prefill's Chrome trace goes to ``trace_path``."""
    import torch
    import torch.distributed
    import chip_smoke as cs
    from repro_torch.configs import SHAPES
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.models import attention, build_model
    from repro_torch.tree import tree_leaves

    cell = cs.SERVE_CELLS[arch]
    cfg = cs.serve_cell_config(arch)
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    mesh = make_host_mesh(device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    attention.set_attention_impl("pallas")
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=cell["prefill"],
                                global_batch=cs.PREFILL_BATCH)
    prefill = build_step(cfg, shape, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (cs.PREFILL_BATCH,
                                               shape.seq_len),
                           generator=gen, device=dev, dtype=torch.int32)
    prof, res = profiled(lambda: prefill.fn(params, {"tokens": tokens}), dev)
    prof.export_chrome_trace(str(trace_path))
    cs.emit({"part": "profile", "arch": arch, "n_layers": cfg.n_layers,
             "step": "prefill", "seq_len": shape.seq_len, **res})
    del prefill, tokens, prof
    torch.cuda.empty_cache()

    shape = dataclasses.replace(SHAPES[cell["decode"]],
                                global_batch=cell["batch"])
    decode = build_step(cfg, shape, mesh)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    for t in tree_leaves(cache):
        t.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1),
                        generator=gen, device=dev, dtype=torch.int32)
    pos = shape.seq_len - 1
    _, res = profiled(lambda: decode.fn(params, cache, tok, pos), dev)
    cs.emit({"part": "profile", "arch": arch, "n_layers": cfg.n_layers,
             "step": "decode", "shape": shape.name,
             "batch": shape.global_batch, "pos": pos, **res})
    attention.set_attention_impl("blockwise")
    torch.distributed.destroy_process_group()
    return 0


def main() -> int:
    import torch
    import torch.distributed
    if not torch.cuda.is_available():
        print("breakdown_serve: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import build_step, make_host_mesh
    from repro_torch.models import attention, build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    args = sys.argv[1:]
    arch = None
    if args[:1] == ["--arch"]:
        arch, args = args[1], args[2:]
    trace_path = Path(args[0]) if args else \
        ROOT / "build" / "serve_prefill_trace.json.gz"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    cs.phase_device()
    cs.phase_build()     # so no step below pays for nvcc
    if arch is not None:
        return profile_cell(arch, trace_path, dev)

    cfg = get_config(cs.FULL_ARCH)
    model = build_model(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    mesh = make_host_mesh(device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    attention.set_attention_impl("pallas")

    # prefill -----------------------------------------------------------------
    shape = dataclasses.replace(SHAPES["prefill_32k"],
                                global_batch=cs.PREFILL_BATCH)
    prefill = build_step(cfg, shape, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (cs.PREFILL_BATCH,
                                               shape.seq_len),
                           generator=gen, device=dev, dtype=torch.int32)
    pieces, whole = [], []
    for _ in range(ITERS):
        pieces.append(prefill_pieces(params, tokens, cfg))
        whole.append(synced(lambda: prefill.fn(params,
                                               {"tokens": tokens}))[1])
    cs.emit({"part": "layers", "step": "prefill", "seq_len": shape.seq_len,
             "batch": cs.PREFILL_BATCH,
             "median_s": {k: statistics.median(p[k] for p in pieces[1:])
                          for k in pieces[0]},
             "pieces_sum_s": statistics.median(sum(p.values())
                                               for p in pieces[1:]),
             "step_s": statistics.median(whole[1:]),
             "first_step_s": whole[0]})
    prof, res = profiled(lambda: prefill.fn(params, {"tokens": tokens}), dev)
    prof.export_chrome_trace(str(trace_path))
    cs.emit({"part": "profile", "step": "prefill", **res})
    del prefill, tokens, prof
    torch.cuda.empty_cache()

    # decode ------------------------------------------------------------------
    shape = SHAPES["decode_32k"]
    decode = build_step(cfg, shape, mesh)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    for t in cache["layers"].values():
        for layer in t:
            layer.normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1),
                        generator=gen, device=dev, dtype=torch.int32)
    pos = shape.seq_len - 1
    pieces, whole = [], []
    for _ in range(ITERS):
        pieces.append(decode_pieces(params, cache, tok, pos, cfg))
        whole.append(synced(lambda: decode.fn(params, cache, tok, pos))[1])
    cs.emit({"part": "layers", "step": "decode", "seq_len": shape.seq_len,
             "batch": shape.global_batch, "pos": pos,
             "median_s": {k: statistics.median(p[k] for p in pieces[1:])
                          for k in pieces[0]},
             "pieces_sum_s": statistics.median(sum(p.values())
                                               for p in pieces[1:]),
             "step_s": statistics.median(whole[1:]),
             "first_step_s": whole[0]})
    _, res = profiled(lambda: decode.fn(params, cache, tok, pos), dev)
    cs.emit({"part": "profile", "step": "decode", **res})
    attention.set_attention_impl("blockwise")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
