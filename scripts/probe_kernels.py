"""Probes behind the design of the two redesigned kernels, on one card.

    python3 scripts/probe_kernels.py [--first-scatter PATH]

Builds ``scripts/probe_kernels.cu`` (which includes the flash kernel's
source) and prints one JSON line per reading:

* ``sass``: the HGMMA, LDGSTS and UTMALDG instructions in the built flash
  library (``cuobjdump -sass``).
* ``layout``: the bf16 body's ``wgmma`` pieces alone at D 32/64/96/128,
  q.k^T and p.v (p split in three bf16 terms) against f64.
* ``accumulate``: one tile's p.v summed 1, 64 and 512 times, through the
  tensor cores' accumulator (mode 0) and as a fresh accumulator a tile
  added on the CUDA cores (mode 1): error against f64, signed mean and
  largest, over the column's absolute sum.
* ``flash_variant``: at (B 1, S 32768) and (B 2, S 4096), 14/2 heads, D 64,
  causal, on [B, S, H, D] views, three seeds each held to ``attn_check``'s
  rule (|out - ref| <= 1e-6 + 2^-7 |ref|) and timed on the first: the
  kernel itself, the body with p split in 2 or 3 terms, and the kernel
  with its registers cut for 1 to 4 CTAs an SM.
* ``d96_blocks``: the D 96 body (phi-3-vision's 32/32 heads, B 1, S 4096,
  causal, [B, S, H, D] views) with its registers cut for 1, 2 and 3 CTAs
  an SM: registers a thread, spilled bytes, three seeds held to
  ``attn_check``'s rule, and the time on the first.
* ``scatter``: ``scatter_aggregate`` on the random top-k of ``chip_smoke.py``
  and on the top-k of gradient-like buckets (nonzero on 512 rows of 896,
  so the tied zeros come as one run of columns), N = 1 and 4, against the
  plain version; with ``--first-scatter`` also the first version built from
  that source (its C interface: six pointers, n, k, d_out, stream).

``--probes layout,d96_blocks`` runs a subset (default: all, in the order
above).  Needs a CUDA card and nvcc; imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROBES = ("sass", "layout", "accumulate", "flash_variant", "d96_blocks",
          "scatter")
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvcc_lib(src: Path, name: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    out = ROOT / "build" / "probe" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {src}:\n{r.stdout}\n{r.stderr}")
    return ctypes.CDLL(str(out))


def attn_inputs(b, h, kvh, s, d, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, s, n, d), generator=g, device="cuda")
            .bfloat16().transpose(1, 2) for n in (h, kvh, kvh)]


def attn_rule(out, ref) -> dict:
    diff = (out.float() - ref.float()).abs()
    lim = 1e-6 + 2 ** -7 * ref.float().abs()
    return {"ok": bool((diff <= lim).all()), "bad": int((diff > lim).sum()),
            "worst_over_limit": float((diff / lim).max())}


def probe_layout(lib) -> None:
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    for d in (32, 64, 96, 128):
        q, k, v = (torch.randn(64, d, generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        p = torch.rand(64, 64, generator=g, device="cuda")
        s_out = torch.full((64, 64), float("nan"), device="cuda")
        o_out = torch.full((64, d), float("nan"), device="cuda")
        rc = lib.probe_layout(d, q.data_ptr(), k.data_ptr(), p.data_ptr(),
                              v.data_ptr(), s_out.data_ptr(),
                              o_out.data_ptr())
        emit({"probe": "layout", "D": d, "rc": rc,
              "qk_max_abs_err": float((s_out.double() - q.double()
                                       @ k.double().T).abs().max()),
              "pv_max_abs_err": float((o_out.double() - p.double()
                                       @ v.double()).abs().max())})


def probe_accumulate(lib) -> None:
    import torch
    g = torch.Generator(device="cuda").manual_seed(1)
    v = torch.randn(64, 64, generator=g, device="cuda").bfloat16()
    p = torch.rand(64, 64, generator=g, device="cuda")
    one = p.double() @ v.double()
    absum = p.double() @ v.double().abs()
    for tiles in (1, 64, 512):
        for mode in (0, 1):
            out = torch.zeros(64, 64, device="cuda")
            rc = lib.probe_accumulate(p.data_ptr(), v.data_ptr(),
                                      out.data_ptr(), tiles, mode)
            rel = (out.double() - one * tiles) / (absum * tiles)
            emit({"probe": "accumulate", "tiles": tiles,
                  "mode": "tensor cores" if mode == 0 else "fresh a tile",
                  "rc": rc, "mean_signed_err_over_absum": float(rel.mean()),
                  "max_err_over_absum": float(rel.abs().max())})


def probe_flash_variants(lib) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ops import flash_attention_op

    def variant(var, q, k, v):
        b, h, sq, d = q.shape
        out = torch.empty_like(q)
        shape = (ctypes.c_int64 * 6)(b, h, k.shape[1], sq, k.shape[2], d)
        strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(),
                                        *v.stride(), *out.stride())

        def call():
            rc = lib.probe_variant(var, q.data_ptr(), k.data_ptr(),
                                   v.data_ptr(), out.data_ptr(),
                                   ctypes.addressof(shape),
                                   ctypes.addressof(strides), d ** -0.5, 1)
            if rc:
                raise RuntimeError(f"variant {var}: cudaError {rc}")
            return out
        return call

    names = {"kernel": None, "split 3": 3, "split 2": 2, "1 CTA/SM": 11,
             "2 CTAs/SM": 12, "3 CTAs/SM": 13, "4 CTAs/SM": 14}
    with torch.no_grad():
        for b, s in ((1, 32768), (2, 4096)):
            seeds = (s, s + 1, s + 2)
            refs = {}
            for seed in seeds:
                refs[seed] = flash_attention_plain(
                    *attn_inputs(b, 14, 2, s, 64, seed))
            for name, var in names.items():
                rec = {"probe": "flash_variant", "variant": name, "B": b,
                       "S": s}
                for seed in seeds:
                    q, k, v = attn_inputs(b, 14, 2, s, 64, seed)
                    fn = ((lambda: flash_attention_op(q, k, v))
                          if var is None else variant(var, q, k, v))
                    rec[f"seed {seed}"] = attn_rule(fn(), refs[seed])
                    if seed == s:
                        rec["ms"] = cs.cuda_ms(fn, iters=5 if s > 4096
                                               else 20, warmup=2)
                emit(rec)


def probe_d96_blocks(lib) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention_plain

    b, h, s, d = 1, 32, 4096, 96
    seeds = (s, s + 1, s + 2)
    with torch.no_grad():
        refs = {seed: flash_attention_plain(*attn_inputs(b, h, h, s, d, seed))
                for seed in seeds}
        for ctas, var in ((1, 21), (2, 22), (3, 23)):
            regs = (ctypes.c_int * 2)()
            rc = lib.probe_d96_regs(var, regs)
            rec = {"probe": "d96_blocks", "ctas_per_sm": ctas, "rc": rc,
                   "registers": regs[0], "spill_bytes": regs[1]}
            for seed in seeds:
                q, k, v = attn_inputs(b, h, h, s, d, seed)
                out = torch.empty_like(q)
                shape = (ctypes.c_int64 * 6)(b, h, h, s, s, d)
                strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(),
                                                *v.stride(), *out.stride())

                def call():
                    err = lib.probe_variant(var, q.data_ptr(), k.data_ptr(),
                                            v.data_ptr(), out.data_ptr(),
                                            ctypes.addressof(shape),
                                            ctypes.addressof(strides),
                                            d ** -0.5, 1)
                    if err:
                        raise RuntimeError(f"variant {var}: cudaError {err}")
                    return out
                rec[f"seed {seed}"] = attn_rule(call(), refs[seed])
                if seed == s:
                    rec["ms"] = cs.cuda_ms(call, iters=20, warmup=2)
            emit(rec)


def sparse_chunks(gen, n, k, d, kind):
    import torch
    from repro_torch.dist.flatbuf import topk_sparsify
    idx = torch.empty((n, k), dtype=torch.int32, device="cuda")
    for i in range(n):
        if kind == "random":
            x = torch.randn(d, generator=gen, device="cuda")
        else:
            x = torch.zeros(d, device="cuda")
            rows = torch.randint(0, d // 896, (512,), generator=gen,
                                 device="cuda")
            cols = (rows[:, None] * 896
                    + torch.arange(896, device="cuda")).ravel()
            x[cols] = torch.randn(cols.numel(), generator=gen, device="cuda")
        idx[i] = topk_sparsify(x, k)[0]
    idx[torch.rand((n, k), generator=gen, device="cuda") < 0.25] = -1
    q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
    return idx, q, s, torch.ones(n, device="cuda")


def probe_scatter(first) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.ops import scatter_aggregate_op
    from repro_torch.kernels.scatter_aggregate import scatter_aggregate_plain

    def first_call(idx, q, s, w, d):
        agg = torch.empty(d, device="cuda")
        part = torch.empty(-(-d // 1024), device="cuda")
        rc = first.repro_scatter_aggregate(
            idx.data_ptr(), q.data_ptr(), s.data_ptr(), w.data_ptr(),
            agg.data_ptr(), part.data_ptr(), idx.shape[0], idx.shape[1], d,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"first scatter: cudaError {rc}")
        return agg

    gen = torch.Generator(device="cuda").manual_seed(3)
    for kind, d in (("random", cs.EMBED_D), ("gradient-like", cs.EMBED_D),
                    ("gradient-like", 49_414_758)):
        for n in (1, 4):
            args = sparse_chunks(gen, n, int(round(0.1 * d)), d, kind)
            agg, _ = scatter_aggregate_op(*args, d_out=d)
            ref, _ = scatter_aggregate_plain(*args, d_out=d)
            rec = {"probe": "scatter", "kind": kind, "N": n, "d_out": d,
                   "equal": bool(torch.equal(agg, ref))}
            del agg, ref
            rec["ms"] = cs.cuda_ms(
                lambda: scatter_aggregate_op(*args, d_out=d), iters=10)
            if first is not None:
                rec["first_version_ms"] = cs.cuda_ms(
                    lambda: first_call(*args, d), iters=10)
            emit(rec)


def probe_sass() -> None:
    """What the built flash library holds, by ``cuobjdump -sass``: the
    tensor-core products (HGMMA), cp.async copies (LDGSTS) and TMA loads
    (UTMALDG)."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    found = re.findall(r"\b(HGMMA\.[0-9x]+\.\w+\.\w+|LDGSTS|UTMALDG)\b",
                       sass)
    emit({"probe": "sass", "library": "flash_attention",
          "counts": {k: found.count(k) for k in sorted(set(found))}})


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first-scatter", type=Path, default=None,
                    help="scatter_aggregate.cu of the first version")
    ap.add_argument("--probes", default=",".join(PROBES),
                    help="comma-separated subset of " + ", ".join(PROBES))
    args = ap.parse_args(argv)
    probes = args.probes.split(",")
    unknown = set(probes) - set(PROBES)
    if unknown:
        ap.error(f"unknown probes {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from repro_torch.kernels import build
    build.build(["flash_attention", "scatter_aggregate"])
    lib = nvcc_lib(ROOT / "scripts" / "probe_kernels.cu", "probe_kernels")
    lib.probe_layout.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
    lib.probe_accumulate.argtypes = [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * 2
    lib.probe_variant.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + \
        [ctypes.c_float, ctypes.c_int]
    lib.probe_d96_regs.argtypes = [ctypes.c_int, ctypes.c_void_p]
    first = None
    if args.first_scatter is not None:
        first = nvcc_lib(args.first_scatter, "first_scatter")
        first.repro_scatter_aggregate.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    run = {"sass": probe_sass, "layout": lambda: probe_layout(lib),
           "accumulate": lambda: probe_accumulate(lib),
           "flash_variant": lambda: probe_flash_variants(lib),
           "d96_blocks": lambda: probe_d96_blocks(lib),
           "scatter": lambda: probe_scatter(first)}
    for name in PROBES:
        if name in probes:
            run[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
