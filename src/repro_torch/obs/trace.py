"""Structured span/event tracer with a Chrome ``trace_event`` exporter, and
the program's own spans on the profiler's clock.

The simulator and the trainer harness record *what happened when* as spans
(``span``: a named interval on a track) and instants (``instant``: a point
event).  Tracks are named after hosts ("worker3", "server") or subsystems
("scheduler"); time is **simulated seconds** for the simulator and
wall-clock seconds for real-tensor code — the tracer does not care, it
only requires one monotonic axis per trace.

``to_chrome()`` serializes the buffer into the Chrome ``trace_event`` JSON
format (the ``{"traceEvents": [...]}`` object form), which loads directly
in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``: one row per
track, transfer/aggregate/commit/failover spans laid out on the simulated
timeline — who sent what, over which link, aggregated where, delayed why.

Overlapping spans on one track are automatically split into sub-lanes
(greedy interval packing), because Chrome "complete" events on a single
thread row only render correctly when they nest.

``NullTracer`` is the zero-overhead mode: every method is a no-op, so the
simulator can call ``tracer.span(...)`` unconditionally (pinned by the
golden-trace test: instrumented and uninstrumented runs are identical).

``region(name, **args)`` is the other way a span is opened: a
``torch.profiler.record_function`` range, opened only while a
``torch.profiler`` records on the calling thread.  The profiler stamps these
ranges and the device's kernels, copies and fills on one clock and keeps
them in memory until it exports its trace; with no profiler running a
region costs one C-level check.  The program's spans are named
``mlfabric.*``.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

_US = 1e6        # seconds -> trace microseconds
_LANE_EPS = 1e-12


@dataclass
class TraceEvent:
    """One recorded event, pre-serialization (times in seconds)."""

    name: str
    cat: str
    track: str
    ts: float
    dur: Optional[float] = None          # None -> instant event
    args: Dict[str, Any] = field(default_factory=dict)
    counter: bool = False                # True -> Chrome "C" counter sample


class Tracer:
    """Buffering tracer; records in order, exports on demand."""

    enabled = True

    def __init__(self, *, process_name: str = "mlfabric"):
        self.process_name = process_name
        self.events: List[TraceEvent] = []

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #
    def span(self, name: str, *, cat: str, track: str, ts: float,
             dur: float, args: Optional[Dict[str, Any]] = None) -> None:
        """A named interval ``[ts, ts+dur]`` on ``track``."""
        self.events.append(TraceEvent(name, cat, track, ts, max(dur, 0.0),
                                      dict(args or {})))

    def instant(self, name: str, *, cat: str, track: str, ts: float,
                args: Optional[Dict[str, Any]] = None) -> None:
        """A point event at ``ts`` on ``track``."""
        self.events.append(TraceEvent(name, cat, track, ts, None,
                                      dict(args or {})))

    def counter(self, name: str, *, track: str, ts: float,
                value: Any, cat: str = "counter") -> None:
        """A counter sample, exported as a Chrome ``"C"`` event.

        Perfetto renders consecutive samples of one ``name`` as a step
        function under the spans — the attribution engine uses this for
        per-link reserved-bandwidth tracks (DESIGN.md §14).  ``value`` is
        a number or a ``{series: number}`` dict for stacked series.
        """
        vals = dict(value) if isinstance(value, dict) else \
            {"value": float(value)}
        self.events.append(TraceEvent(name, cat, track, ts, None, vals,
                                      counter=True))

    def clear(self) -> None:
        self.events.clear()

    # ------------------------------------------------------------------ #
    # queries (tests / reports)
    # ------------------------------------------------------------------ #
    def by_cat(self, cat: str) -> List[TraceEvent]:
        return [e for e in self.events if e.cat == cat]

    def categories(self) -> List[str]:
        return sorted({e.cat for e in self.events})

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #
    def _lane_of(self, track: str, ts: float, t_end: Optional[float],
                 lanes: Dict[str, List[float]]) -> int:
        """First sub-lane of ``track`` that is free at ``ts`` (greedy
        interval packing keeps overlapping spans on separate rows)."""
        ends = lanes.setdefault(track, [])
        for i, end in enumerate(ends):
            if end <= ts + _LANE_EPS:
                ends[i] = t_end if t_end is not None else end
                return i
        ends.append(t_end if t_end is not None else 0.0)
        return len(ends) - 1

    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome ``trace_event`` object form (JSON-serializable)."""
        out: List[Dict[str, Any]] = []
        tids: Dict[Tuple[str, int], int] = {}
        lanes: Dict[str, List[float]] = {}

        def tid_for(track: str, lane: int) -> int:
            key = (track, lane)
            if key not in tids:
                tids[key] = len(tids)
            return tids[key]

        # Stable sort by start time: Perfetto accepts any order, but a
        # monotonic file diffs cleanly (the golden-trace test relies on
        # byte-stable output for a seeded run).
        for ev in sorted(self.events, key=lambda e: e.ts):
            if ev.counter:
                # counters get a dedicated tid per track, outside the
                # span sub-lane packing (they are points, not intervals)
                out.append({
                    "name": ev.name, "cat": ev.cat,
                    "ts": round(ev.ts * _US, 3),
                    "pid": 0, "tid": tid_for(f"{ev.track} [counters]", 0),
                    "ph": "C", "args": ev.args,
                })
                continue
            t_end = None if ev.dur is None else ev.ts + ev.dur
            lane = self._lane_of(ev.track, ev.ts, t_end, lanes)
            rec: Dict[str, Any] = {
                "name": ev.name, "cat": ev.cat,
                "ts": round(ev.ts * _US, 3),
                "pid": 0, "tid": tid_for(ev.track, lane),
            }
            if ev.dur is None:
                rec["ph"] = "i"
                rec["s"] = "t"
            else:
                rec["ph"] = "X"
                rec["dur"] = round(ev.dur * _US, 3)
            if ev.args:
                rec["args"] = ev.args
            out.append(rec)

        meta: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": self.process_name}}]
        for (track, lane), tid in sorted(tids.items(), key=lambda kv: kv[1]):
            label = track if lane == 0 else f"{track} #{lane + 1}"
            meta.append({"ph": "M", "name": "thread_name", "pid": 0,
                         "tid": tid, "args": {"name": label}})
            meta.append({"ph": "M", "name": "thread_sort_index", "pid": 0,
                         "tid": tid, "args": {"sort_index": tid}})
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1, sort_keys=True)
            f.write("\n")


class NullTracer(Tracer):
    """Zero-overhead tracer: recording methods do nothing."""

    enabled = False

    def __init__(self):
        super().__init__()

    def span(self, name: str, *, cat: str, track: str, ts: float,
             dur: float, args: Optional[Dict[str, Any]] = None) -> None:
        pass

    def instant(self, name: str, *, cat: str, track: str, ts: float,
                args: Optional[Dict[str, Any]] = None) -> None:
        pass

    def counter(self, name: str, *, track: str, ts: float,
                value: Any, cat: str = "counter") -> None:
        pass


#: Shared no-op tracer (the default everywhere).
NULL_TRACER = NullTracer()


def validate_chrome_trace(obj: Any) -> List[str]:
    """Structural validation of a Chrome ``trace_event`` object.

    Returns a list of problems (empty = valid).  Checks the subset of the
    format this repo emits — enough to guarantee Perfetto loads it.
    """
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["not an object with a traceEvents list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "b", "e", "C"):
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"{where}: missing integer {key}")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"{where}: missing numeric ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"{where}: complete event without dur")
        if not isinstance(ev.get("name"), str):
            problems.append(f"{where}: missing name")
    return problems


# --------------------------------------------------------------------------- #
# spans on the profiler's clock
# --------------------------------------------------------------------------- #
#: Whether a ``torch.profiler`` records on the calling thread (autograd's
#: threads inherit the caller's profiler state).
recording = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()


def region(name: str, **args: Any):
    """A span named ``name`` while a profiler records, else one shared no-op
    context.  The profiler's Chrome export drops a range's argument string,
    so ``args`` follow the name, ``"mlfabric.commit uid=3 worker=worker1"``:
    readers take the span's kind as the name up to its first space."""
    if not recording():
        return _OFF
    if args:
        name = " ".join([name] + [f"{k}={v}" for k, v in args.items()])
    return torch.profiler.record_function(name)
