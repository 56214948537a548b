"""The traced window: ``torch.profiler`` on the host and the card, reduced
to what the per-layer readers read.

The trace is exported as Chrome JSON under ``portbench_out/`` in the
checkout (one file a cell, written again by each traced run) and read
back: device operations (kernels, copies, fills) with their device
intervals and, through the correlation id, the host time their launch was
issued at; and the benchmark's ``portbench.*`` ranges on the host.  A
device operation belongs to a range when its launch was issued inside the
range on the host, on any thread (autograd's backward runs on its own).
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Summary:
    """One traced window, in seconds on the trace's clock."""

    window: Tuple[float, float]
    # (name, start, duration, launch issued at on the host, or None)
    ops: List[Tuple[str, float, float, Optional[float]]]
    ranges: Dict[str, List[Tuple[float, float]]]
    wire: List[Dict] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self):
        a, b = self.window
        return [o for o in self.ops if o[1] < b and o[1] + o[2] > a]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        a, b = self.window
        spans = sorted((max(s, a), min(s + d, b)) for _, s, d, _ in
                       self.in_window())
        busy, end = 0.0, a
        for s, e in spans:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def range_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the operations launched inside any ``name``
        range (None where no operation was)."""
        spans = sorted(self.ranges.get(name, []))
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total, hits = 0.0, 0
        for _, s, d, launch in self.in_window():
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= spans[i][1]:
                total += d
                hits += 1
        return total if hits else None

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` longest stretches of the window with no device
        operation, each named by the innermost ``portbench.*`` range open on
        the host where it starts ("host" where none is)."""
        a, b = self.window
        spans = sorted((s, s + d) for _, s, d, _ in self.in_window())
        gaps, end = [], a
        for s, e in spans:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if b > end:
            gaps.append((end, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            inner = [(rs, name) for name, rr in self.ranges.items()
                     if name != "portbench.window"
                     for rs, re in rr if rs <= s <= re]
            out.append((max(inner)[1] if inner else "host", e - s))
        return out

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        tot: Dict[str, float] = {}
        a, b = self.window
        for name, s, d, _ in self.in_window():
            tot[name] = tot.get(name, 0.0) + min(s + d, b) - max(s, a)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def read_chrome(path: Path) -> Summary:
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    launch: Dict[int, float] = {}
    ops, ranges = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        ts, dur = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        if cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launch[args["correlation"]] = ts
        elif cat in DEVICE_CATS:
            ops.append((e["name"], ts, dur, args.get("correlation")))
        elif cat == "user_annotation" and e["name"].startswith("portbench."):
            ranges.setdefault(e["name"], []).append((ts, ts + dur))
    ops = [(n, s, d, launch.get(c)) for n, s, d, c in ops]
    w = ranges.get("portbench.window")
    if not w:
        raise RuntimeError("the trace holds no portbench.window range")
    return Summary(window=w[0], ops=ops, ranges=ranges)
