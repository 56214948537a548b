"""The program's own spans in a traced window: the ``mlfabric.*`` ranges that
``repro_torch.obs.region`` opens while the profiler records, read from the
Chrome trace the harness exported, and the window's idle time split over
them.

Each instant of the window at which no device operation runs goes to the
innermost program span open at that instant on any thread, the one that
started last (``Summary.idle_gaps``' rule, applied over each whole idle
stretch instead of at its start).  A span's kind is its name up to the
first space (the program writes its args after it).  The kinds are grouped
by layer in ``LAYERS``; an instant under ``mlfabric.step`` with no child
open is the step's own glue between its layers (``"step"``), and an
instant under no program span is the harness's (``None``).  With no
program span in the window (a program without them) everything here reads
nothing.

    python3 portbench/spans.py portbench_out/CELL.trace.json

prints a trace's split by kind and layer, the device time launched inside
each kind, the wire launches that lie outside ``bucket`` and ``wire``
spans, and the longest idle stretches with the host's operator and CUDA
runtime calls inside them.
"""

from __future__ import annotations

import bisect
import heapq
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

PREFIX = "mlfabric."
LAYERS = {
    "model": ("fwd_bwd", "forward", "backward", "attention", "moe"),
    "exchange": ("pack", "reduce", "bucket", "unpack", "wire", "sync",
                 "update"),
    "control": ("run", "plan", "compute", "data", "commit"),
}
LAYER_OF = {k: layer for layer, kinds in LAYERS.items() for k in kinds}
LAYER_OF["step"] = "step"
WIRE_KERNELS = ("quantize", "dequant_aggregate")

# where the harness writes its traces (``harness.OUT``)
OUT = Path(__file__).resolve().parent.parent / "portbench_out"


class Span(NamedTuple):
    kind: str            # "attention" for "mlfabric.attention layer=3"
    name: str
    start: float         # seconds on the trace's clock
    end: float
    tid: int


# a user annotation as the profiler's Chrome export writes it, its keys in
# this order (a trace written otherwise is read by ``json`` instead)
_ANNOTATION = re.compile(
    r'"ph": "X",\s*"cat": "user_annotation",\s*'
    r'"name": "((?:mlfabric\.|portbench\.)[^"]*)",\s*"pid": [^,]+,\s*'
    r'"tid": ([^,]+),\s*"ts": ([-+.\deE]+),\s*"dur": ([-+.\deE]+)')


def _span(name: str, ts: float, dur: float, tid) -> Span:
    return Span(name[len(PREFIX):].split(" ", 1)[0], name, ts, ts + dur,
                tid)


def scan(path: Path):
    """``read(path)`` without parsing the whole file: the user
    annotations picked out of its text (a traced window of MLfabric-A
    exports about 1 GB).  None where the text holds no window in the
    export's layout."""
    window, spans = None, []
    for m in _ANNOTATION.finditer(Path(path).read_text()):
        name, tid = m.group(1), m.group(2).strip().strip('"')
        ts, dur = float(m.group(3)) * 1e-6, float(m.group(4)) * 1e-6
        if name.startswith(PREFIX):
            spans.append(_span(name, ts, dur,
                               int(tid) if tid.isdigit() else tid))
        elif name == "portbench.window" and window is None:
            window = (ts, ts + dur)
    return None if window is None else (window, spans)


def read(path: Path, host: bool = False):
    """(the ``portbench.window`` interval, the program's spans, and with
    ``host`` the host's operator and CUDA runtime calls as (name, start,
    end))."""
    events = json.loads(Path(path).read_text())
    events = events.get("traceEvents", events)
    window, spans, calls = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        if cat == "user_annotation":
            if name.startswith(PREFIX):
                spans.append(_span(name, ts, dur, e.get("tid")))
            elif name == "portbench.window" and window is None:
                window = (ts, ts + dur)
        elif host and cat in ("cuda_runtime", "cpu_op"):
            calls.append((name, ts, ts + dur))
    return window, spans, calls


_read: Dict[tuple, tuple] = {}       # (path, mtime, size) -> (window, spans)
_split: Dict[tuple, Dict[str, float]] = {}


def _spans_of(ctx):
    """(the cache key, the spans) of the trace whose window is
    ``ctx.trace``'s: the newest exported trace under ``OUT`` with that
    window, or None."""
    paths = sorted(OUT.glob("*.trace.json"),
                   key=lambda p: -p.stat().st_mtime)
    for path in paths:
        st = path.stat()
        key = (str(path), st.st_mtime_ns, st.st_size)
        if key not in _read:
            _read[key] = scan(path) or read(path)[:2]
        window, spans = _read[key]
        if window == ctx.trace.window:
            return key, spans
    return None


def of(ctx) -> Optional[List[Span]]:
    """The program's spans in the traced window of ``ctx`` (None where no
    exported trace has that window, or where it holds no program span)."""
    got = _spans_of(ctx)
    return (got[1] or None) if got else None


def _idle(summary) -> List[Tuple[float, float]]:
    """The window's stretches in which no device operation runs."""
    a, b = summary.window
    out, end = [], a
    for s, e in sorted((max(s, a), min(s + d, b))
                       for _, s, d, _ in summary.in_window()):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if b > end:
        out.append((end, b))
    return out


def _innermost(spans: List[Span]
               ) -> List[Tuple[float, float, Optional[Span]]]:
    """The time line cut where any span starts or ends, each piece with the
    span open there that started last (the shorter of two that started
    together), or None."""
    events = sorted([(s.end, 0, i) for i, s in enumerate(spans)]
                    + [(s.start, 1, i) for i, s in enumerate(spans)])
    heap: List[Tuple[float, float, int]] = []
    ended = set()
    pieces, t_prev = [], None
    for t, starts, i in events:
        while heap and heap[0][2] in ended:
            heapq.heappop(heap)
        if t_prev is not None and t > t_prev:
            pieces.append((t_prev, t, spans[heap[0][2]] if heap else None))
        t_prev = t
        if starts:
            heapq.heappush(heap, (-spans[i].start, spans[i].end, i))
        else:
            ended.add(i)
    return pieces


def idle_by_span(summary, spans: List[Span]
                 ) -> List[Tuple[float, float, Optional[Span]]]:
    """The window's idle stretches, cut where the innermost span changes,
    each piece with its innermost span (None: the harness's)."""
    idle = _idle(summary)
    pieces = _innermost(spans)
    if not pieces:
        return [(a, b, None) for a, b in idle]
    lo, hi = summary.window
    pieces = ([(min(lo, pieces[0][0]), pieces[0][0], None)] + pieces
              + [(pieces[-1][1], max(hi, pieces[-1][1]), None)])
    starts = [p[0] for p in pieces]
    out = []
    for a, b in idle:
        i = bisect.bisect_right(starts, a) - 1
        while i < len(pieces) and pieces[i][0] < b:
            s, e, span = pieces[i]
            if e > a:
                out.append((max(s, a), min(e, b), span))
            i += 1
    return out


def idle_split(summary, spans: List[Span]) -> Dict[str, float]:
    """Idle seconds of the window by span kind, by layer (``model``,
    ``exchange``, ``control``, ``step``) and ``"unnamed"``, and their sum,
    ``"idle"``."""
    out: Dict[str, float] = {"idle": 0.0, "unnamed": 0.0,
                             **{k: 0.0 for k in LAYERS}, "step": 0.0}
    for a, b, span in idle_by_span(summary, spans):
        out["idle"] += b - a
        if span is None:
            out["unnamed"] += b - a
            continue
        kind = "kind." + span.kind
        out[kind] = out.get(kind, 0.0) + b - a
        out[LAYER_OF.get(span.kind, "unnamed")] += b - a
    return out


def idle_ms(ctx, layer: str, per: int) -> Optional[float]:
    """Idle milliseconds of ``layer`` over ``per`` updates (None without
    program spans or updates)."""
    got = _spans_of(ctx)
    if got is None or not got[1] or not per:
        return None
    key, spans = got
    if key not in _split:
        _split[key] = idle_split(ctx.trace, spans)
    return 1e3 * _split[key][layer] / per


def launched_s(summary, spans: List[Span], kinds) -> Optional[float]:
    """Device seconds of the operations launched inside any span of
    ``kinds`` (on any thread)."""
    merged: List[List[float]] = []
    for s in sorted((s.start, s.end) for s in spans if s.kind in kinds):
        if merged and s[0] <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s[1])
        else:
            merged.append(list(s))
    starts = [m[0] for m in merged]
    total, hits = 0.0, 0
    for _, s, d, launch in summary.in_window():
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= merged[i][1]:
            total += d
            hits += 1
    return total if hits else None


def wire_outside(summary, spans: List[Span]) -> Tuple[int, int]:
    """(wire kernel launches, those launched outside every ``bucket`` and
    ``wire`` span)."""
    pat = re.compile(r"(^|[^a-z_])(%s)_kernel\b" % "|".join(WIRE_KERNELS))
    inside = sorted((s.start, s.end) for s in spans
                    if s.kind in ("bucket", "wire"))
    starts = [s for s, _ in inside]
    n = out = 0
    for name, _, _, launch in summary.in_window():
        if not pat.search(name):
            continue
        n += 1
        i = bisect.bisect_right(starts, launch) - 1 if launch else -1
        if i < 0 or launch > inside[i][1]:
            out += 1
    return n, out


def main(argv=None) -> int:
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from portbench.trace import read_chrome
    for path in argv if argv is not None else sys.argv[1:]:
        summary = read_chrome(Path(path))
        window, spans, calls = read(Path(path), host=True)
        a, b = summary.window
        n_fb = sum(1 for s in spans if s.kind == "fwd_bwd"
                   and a <= s.start and s.end <= b)
        print(f"== {path}: window {summary.window_s:.4f} s, "
              f"{len(spans)} program spans, {n_fb} fwd_bwd")
        if not spans:
            continue
        split = idle_split(summary, spans)
        idle = summary.window_s - summary.busy_s()
        named = sum(split[k] for k in LAYERS)
        print(f"idle {idle:.6f} s ({100 * idle / summary.window_s:.3f}%); "
              f"split sum {split['idle']:.6f}; model+exchange+control "
              f"{named:.6f} + step {split['step']:.6f} + unnamed "
              f"{split['unnamed']:.6f}")
        for k, v in sorted(split.items(), key=lambda kv: -kv[1]):
            print(f"  {k:<20} {1e3 * v:12.3f} ms")
        ref = summary.range_device_s("portbench.fwd_bwd")
        mine = launched_s(summary, spans, ("fwd_bwd",))
        print(f"device s launched in mlfabric.fwd_bwd {mine!r}, in "
              f"portbench.fwd_bwd {ref!r}"
              + (f" (ratio {mine / ref:.6f})" if mine and ref else ""))
        for kind in sorted({s.kind for s in spans}):
            got = launched_s(summary, spans, (kind,))
            print(f"  launched in {kind:<10} {got!r}")
        n, out = wire_outside(summary, spans)
        print(f"wire launches {n}, outside bucket/wire spans {out}")
        pieces = idle_by_span(summary, spans)
        longest = sorted(pieces, key=lambda p: p[0] - p[1])[:10]
        for a, b, span in longest:
            inside = {}
            for name, s, e in calls:
                if s < b and e > a:
                    inside[name] = inside.get(name, 0.0) + \
                        min(e, b) - max(s, a)
            top = sorted(inside.items(), key=lambda kv: -kv[1])[:4]
            print(f"  gap {1e3 * (b - a):9.3f} ms at +{a - window[0]:.3f} s"
                  f" in {span.name if span else 'harness'}: "
                  + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in top))
        by_call: Dict[str, float] = {}
        starts = [a for a, _, _ in pieces]
        for name, s, e in calls:
            i = max(bisect.bisect_right(starts, s) - 1, 0)
            while i < len(pieces) and pieces[i][0] < e:
                a, b, _ = pieces[i]
                if b > s:
                    by_call[name] = by_call.get(name, 0.0) + \
                        min(e, b) - max(s, a)
                i += 1
        print("host calls overlapping idle time (ms): " + ", ".join(
            f"{k} {1e3 * v:.3f}" for k, v in
            sorted(by_call.items(), key=lambda kv: -kv[1])[:8]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
