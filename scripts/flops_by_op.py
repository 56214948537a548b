"""Split one dry-run cell's FLOPs a rank by op, the port's beside the
reference's, to place a gap between the two.

The port's side traces the cell as ``repro_torch.launch.dryrun
--save-hlo`` does (on 16x16, one rank of a fake world) and reads each
op's FLOPs by its operands' dtypes and shapes from the cell's op listing.
The reference's side reads the post-SPMD HLO text its dry-run writes
(``python -m repro.launch.dryrun --arch A --shape S --save-hlo``) and adds
up each ``dot`` by its output and operand shapes, times the trip counts of
the loops around it, as ``repro/launch/hlo_analysis.py`` counts them.
This script parses that text itself and imports no JAX.

Usage:
    PYTHONPATH=src python scripts/flops_by_op.py --arch deepseek-v2-236b \\
        --shape train_4k [--hlo runs/dryrun/A__S__16-16.hlo.txt] [--top 40]
    PYTHONPATH=src python scripts/flops_by_op.py --arch qwen2-0.5b \\
        --shape prefill_32k --reduced --set n_heads=14 n_kv_heads=2 \\
        d_head=32 d_model=512 d_ff=1024 vocab_size=4096 --impl pallas
    PYTHONPATH=src python scripts/flops_by_op.py --arch deepseek-v2-236b \\
        --shape train_4k --reduced --set n_heads=16 n_kv_heads=16 \\
        d_model=512 vocab_size=4096 moe.n_experts=16 \\
        mla.kv_lora_rank=64 mla.q_lora_rank=256

``--reduced`` and ``--set`` trace a cut of the config (the reduced one,
then the given fields), as ``tests/test_torch_dryrun.py`` cuts it; a
dotted field sets a sub-config's (``moe.n_experts=16``,
``mla.q_lora_rank=256``).  ``--impl`` picks the attention impl.

Prints ``port`` lines (FLOPs, op, operand dtypes and shapes, calls),
``reference`` lines (FLOPs, output, operand shapes, executions) and each
side's total.
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

_HEADER = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->")
_DEF = re.compile(
    r"^%?([\w.\-]+)\s*=\s*(\(?)([a-z]+[0-9]*[a-z0-9]*)\[([0-9,]*)\]")
_PARAM = re.compile(r"([\w.\-]+):\s*([a-z]+[0-9]*[a-z0-9]*)\[([0-9,]*)\]")
_OPERAND = re.compile(r"%([\w.\-]+)")
_TRIP = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLEE = re.compile(r"(?:body=|to_apply=|calls=|condition=)%?([\w.\-]+)")
_CONTRACT = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")


def _dims(s: str) -> Tuple[int, ...]:
    return tuple(int(d) for d in s.split(",") if d)


def cut_config(cfg, cut: Dict[str, int]):
    """``cfg`` with the fields of ``cut`` replaced; a dotted name
    (``moe.n_experts``) replaces a field of that sub-config."""
    import dataclasses

    top, sub = {}, {}
    for k, v in (cut or {}).items():
        if "." in k:
            name, field = k.split(".", 1)
            sub.setdefault(name, {})[field] = v
        else:
            top[k] = v
    for name, fields in sub.items():
        top[name] = dataclasses.replace(getattr(cfg, name), **fields)
    return dataclasses.replace(cfg, **top)


def port_flops(arch: str, shape: str, *, reduced: bool = False,
               cut: Dict[str, int] = None, impl: str = "blockwise"
               ) -> Tuple[float, Counter]:
    """(total, FLOPs by "op operands x count") of the port's cell."""
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import read_op_listing
    from repro_torch.models import attention

    cfg = dryrun.get_config(arch)
    cfg = cut_config(cfg.reduced() if reduced else cfg, cut)
    dryrun.get_config = lambda name: cfg
    attention.set_attention_impl(impl)
    try:
        with tempfile.TemporaryDirectory() as out:
            res = dryrun.run_cell(arch, shape, out_dir=out, save_hlo=True)
            tag = f"{arch}__{shape}__{res['mesh'].replace('x', '-')}"
            rows = read_op_listing(
                Path(out, tag + ".ops.txt").read_text())["rows"]
    finally:
        attention.set_attention_impl("blockwise")
    by = Counter({f"{key} x{n}": f for key, (n, f, _) in rows.items() if f})
    return res["flops_per_device"], by


def reference_flops(hlo: str) -> Tuple[float, Counter]:
    """(total, FLOPs by "out lhs rhs x executions") of every ``dot`` in the
    reference's HLO text, each times the trip counts around it."""
    shapes: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    calls: Dict[str, List[Tuple[str, int]]] = {}
    dots: List[Tuple[str, str]] = []
    comp, entry = None, None
    for raw in hlo.splitlines():
        h = _HEADER.match(raw)
        if h and raw.rstrip().endswith("{"):
            comp = h.group(2)
            entry = comp if h.group(1) else entry
            shapes[comp] = {n: _dims(d) for n, _, d in _PARAM.findall(
                h.group(3))}
            calls[comp] = []
            continue
        line = raw.strip()
        d = _DEF.match(line) if comp else None
        if d is None:
            continue
        if not d.group(2):
            shapes[comp][d.group(1)] = _dims(d.group(4))
        if re.search(r"\bdot\(", line):
            dots.append((comp, line))
        trip = 1
        if " while(" in line:
            m = _TRIP.search(line)
            trip = int(m.group(1)) if m else 1
        elif not ("fusion(" in line or " call(" in line
                  or "to_apply=" in line or "conditional(" in line):
            continue
        calls[comp] += [(c, trip) for c in _CALLEE.findall(line)]
    runs = Counter()

    def visit(name: str, n: int, depth: int = 0) -> None:
        if name in calls and depth <= 64:
            runs[name] += n
            for callee, trip in calls[name]:
                visit(callee, n * trip, depth + 1)

    visit(entry or next(iter(calls)), 1)
    by = Counter()
    for comp, line in dots:
        d = _DEF.match(line)
        ops = _OPERAND.findall(line.split("dot(", 1)[1].split(")", 1)[0])
        lhs = shapes[comp].get(ops[0], ())
        rhs = shapes[comp].get(ops[1], ()) if len(ops) > 1 else ()
        k = 1
        c = _CONTRACT.search(line)
        for i in (_dims(c.group(1)) if c else ()):
            k *= lhs[i] if i < len(lhs) else 1
        n = 1
        for x in _dims(d.group(4)):
            n *= x
        by[f"out{_dims(d.group(4))} lhs{lhs} rhs{rhs} "
           f"x{runs[comp]}"] += 2.0 * n * k * runs[comp]
    return sum(by.values()), by


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--hlo", help="the reference's HLO text of the cell")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--set", nargs="*", default=[], metavar="FIELD=INT")
    ap.add_argument("--impl", default="blockwise",
                    choices=("blockwise", "pallas"))
    args = ap.parse_args()
    cut = {k: int(v) for k, v in (kv.split("=") for kv in args.set)}
    sides = [("port", port_flops(args.arch, args.shape,
                                 reduced=args.reduced, cut=cut,
                                 impl=args.impl))]
    if args.hlo:
        sides.append(("reference", reference_flops(Path(args.hlo)
                                                   .read_text())))
    for name, (total, by) in sides:
        print(f"{name} total {total:.4e}")
        for key, v in by.most_common(args.top):
            print(f"{name} {v:.4e} {key}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
