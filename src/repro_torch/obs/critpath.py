"""Critical-path attribution: *why* did each commit take as long as it did?

The telemetry plane (DESIGN.md §10) records what happened when; this
module explains the delay.  A :class:`CritPathCollector` rides along the
simulator's enactment path and records, per update uid, the causal legs
between "gradient ready" and "server commit":

* ``ready(uid, t)``       — compute finished, update enters the queue;
* ``planned(t, uids)``    — the SJF/MLfabric plan admitted the uid;
* ``principal(uid, ...)`` — the update's own wire transfer (direct to the
  server, member->aggregator, or member->switch), with the transport
  tier's repaired completion time and the per-segment binding-link
  attribution that :meth:`NetworkState.reserve` computes when its
  ``attribution`` flag is on;
* ``hop(uid, ...)``       — a downstream aggregation hop the commit waits
  on (host aggregate drain, switch drain, hierarchical hop 2);
* ``hold(uid, t)``        — the replication plan held the commit until
  the replica caught up (§5.3 bounded staleness);
* ``commit(rec)``         — the server applied the update; assembles the
  :class:`CommitPath`.

``commit`` decomposes time-to-commit into the phase taxonomy ``PHASES``
by a telescoping walk over the recorded timestamps, each clamped to
``[t_ready, t_commit]`` and forced monotone — so the phase durations sum
to ``t_commit - t_ready`` *exactly*, by construction (property-tested).

The module deliberately imports nothing from ``repro.core`` (core imports
obs); transfers are duck-typed (``.uid .src .dst .profile .bottlenecks``).
``NULL_COLLECTOR`` is the shared no-op so the simulator can call the
recording methods unconditionally — with no :class:`CritPathCallback`
attached, runs (and the pinned golden traces) are untouched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: The phase taxonomy (DESIGN.md §14).  Order matters: it is the causal
#: order along a commit's path, and reports render shares in this order.
PHASES = (
    "queue",              # compute done -> admitted by a plan
    "xmit_wait",          # admitted -> first byte of the principal leg
    "xmit",               # principal wire transfer (link-attributed)
    "retransmit",         # transport-tier repair rounds / backoff
    "agg_wait",           # waiting on sibling members at an aggregation gate
    "drain_wait",         # gate open -> first byte of the drain/agg hop
    "drain",              # aggregate / switch-drain transfer (link-attributed)
    "replication_hold",   # commit held for the replica frontier (§5.3)
    "apply",              # residual: server-side apply / epoch bookkeeping
)

#: Phases that are wire time — the "transmission share" of a report.
WIRE_PHASES = ("xmit", "drain")

#: Phases spent in or waiting on the network (wire time plus the waits
#: caused by link contention and repair) — the "network share".
NETWORK_PHASES = ("xmit_wait", "xmit", "retransmit", "drain_wait", "drain")


def dominant_bottleneck(transfer: Any) -> Optional[str]:
    """The link that bound this transfer for the longest total time."""
    segs = getattr(transfer, "bottlenecks", None)
    if not segs:
        return None
    acc: Dict[str, float] = {}
    for t0, t1, label in segs:
        acc[label] = acc.get(label, 0.0) + (t1 - t0)
    return max(acc, key=lambda k: acc[k])


@dataclass
class _Leg:
    """One recorded wire leg (principal or aggregation hop)."""

    kind: str
    t_start: float
    t_end: float
    t_done: float                        # after transport repair rounds
    segments: Optional[List[Tuple[float, float, str]]]
    hop: int = 0                         # 0 = principal
    gate: float = 0.0                    # hops: when the group was ready
    ready: Optional[float] = None        # hops: post-drain member clamp


@dataclass
class CommitPath:
    """Per-commit critical-path decomposition (the engine's output row)."""

    uid: int
    worker: Optional[str]
    t_ready: float
    t_commit: float
    phases: Dict[str, float]
    link_seconds: Dict[str, float]
    kind: str
    hops: int

    @property
    def total(self) -> float:
        return self.t_commit - self.t_ready

    @property
    def dominant_phase(self) -> str:
        return max(PHASES, key=lambda p: self.phases.get(p, 0.0))

    @property
    def dominant_link(self) -> Optional[str]:
        if not self.link_seconds:
            return None
        return max(self.link_seconds, key=lambda k: self.link_seconds[k])

    def identity_error(self) -> float:
        """|sum(phases) - total|; zero by construction, property-tested."""
        return abs(sum(self.phases.values()) - self.total)


class CritPathCollector:
    """Accumulates causal legs per uid and assembles :class:`CommitPath`\\ s.

    ``link_busy`` additionally accumulates every reserved transfer's
    ``(t0, t1, rate)`` chunks per link (deduped by transfer uid — an
    aggregate transfer is shared by all its members), feeding the
    per-link utilization counter tracks and the contended-links table.
    """

    enabled = True

    def __init__(self):
        self._ready: Dict[int, float] = {}
        self._planned: Dict[int, float] = {}
        self._principal: Dict[int, _Leg] = {}
        self._hops: Dict[int, List[_Leg]] = {}
        self._hold: Dict[int, float] = {}
        self._seen_transfers: set = set()
        self.link_busy: Dict[str, List[Tuple[float, float, float]]] = {}
        self.paths: List[CommitPath] = []
        self.untracked = 0               # commits with no recorded legs

    # ------------------------------------------------------------------ #
    # recording (called from the simulator's enactment path)
    # ------------------------------------------------------------------ #
    def ready(self, uid: int, t: float) -> None:
        # setdefault: a rerouted/re-enacted update keeps its original
        # compute-finish time — the honest start of its critical path
        self._ready.setdefault(uid, t)

    def planned(self, t: float, uids: Sequence[int]) -> None:
        for uid in uids:
            self._planned.setdefault(uid, t)

    def principal(self, uid: int, kind: str, transfer: Any, t_done: float,
                  chain: Sequence[Any] = ()) -> None:
        """The update's own wire transfer.  Resets any stale downstream
        hops from an earlier, cancelled enactment (reroute path)."""
        self._principal[uid] = _Leg(
            kind, transfer.t_start, transfer.t_end, t_done,
            getattr(transfer, "bottlenecks", None))
        self._hops.pop(uid, None)
        self._record_busy(transfer)
        for tr in chain:
            self._record_busy(tr)

    def hop(self, uid: int, hop: int, gate: float, transfer: Any,
            t_done: float, chain: Sequence[Any] = (),
            ready: Optional[float] = None) -> None:
        """A downstream aggregation hop this uid's commit waits on."""
        self._hops.setdefault(uid, []).append(_Leg(
            "hop", transfer.t_start, transfer.t_end, t_done,
            getattr(transfer, "bottlenecks", None),
            hop=hop, gate=gate, ready=ready))
        self._record_busy(transfer)
        for tr in chain:
            self._record_busy(tr)

    def hold(self, uid: int, t_release: float) -> None:
        self._hold[uid] = max(self._hold.get(uid, 0.0), t_release)

    def _record_busy(self, transfer: Any) -> None:
        uid = getattr(transfer, "uid", None)
        if uid in self._seen_transfers:
            return
        self._seen_transfers.add(uid)
        src = getattr(transfer, "src", None)
        dst = getattr(transfer, "dst", None)
        chunks = getattr(getattr(transfer, "profile", None), "chunks", None)
        if not chunks or src == dst:
            return
        for label in (f"{src}:up", f"{dst}:down"):
            busy = self.link_busy.setdefault(label, [])
            busy.extend(chunks)

    # ------------------------------------------------------------------ #
    # assembly
    # ------------------------------------------------------------------ #
    def commit(self, rec: Any) -> Optional[CommitPath]:
        """Assemble the :class:`CommitPath` for a commit record.

        ``rec`` needs ``.uid`` and ``.time`` (``.worker`` optional).
        Returns ``None`` (and counts the commit as untracked) when no
        causal legs were recorded — baselines and real-tensor trainers
        degrade to commit-latency-only reports.
        """
        uid = getattr(rec, "uid", None)
        t_commit = getattr(rec, "time", None)
        if uid is None or t_commit is None:
            self.untracked += 1
            return None
        t_ready = self._ready.pop(uid, None)
        leg = self._principal.pop(uid, None)
        hops = sorted(self._hops.pop(uid, []), key=lambda h: h.hop)
        t_hold = self._hold.pop(uid, None)
        t_plan = self._planned.pop(uid, None)
        if t_ready is None or leg is None:
            self.untracked += 1
            return None

        # the causal point sequence: (phase that ENDS at this timestamp)
        points: List[Tuple[str, float]] = [
            ("queue", t_plan if t_plan is not None else t_ready),
            ("xmit_wait", leg.t_start),
            ("xmit", leg.t_end),
            ("retransmit", leg.t_done),
        ]
        for h in hops:
            points.append(("agg_wait", h.gate))
            points.append(("drain_wait", h.t_start))
            points.append(("drain", h.t_end))
            points.append(("retransmit", h.t_done))
            if h.ready is not None:
                # pure-switch clamp: commit waits for the slowest member
                # stream even after the drain lands
                points.append(("agg_wait", h.ready))
        if t_hold is not None:
            points.append(("replication_hold", t_hold))

        # telescoping walk: clamp every point into [t_ready, t_commit]
        # and force monotonicity, so the shares sum EXACTLY to total
        phases = dict.fromkeys(PHASES, 0.0)
        prev = t_ready
        for name, ts in points:
            if ts > t_commit:
                ts = t_commit
            if ts > prev:
                phases[name] += ts - prev
                prev = ts
        phases["apply"] += t_commit - prev

        link_seconds: Dict[str, float] = {}

        def credit(segs, lo: float, hi: float) -> None:
            for t0, t1, label in segs or ():
                d = min(t1, hi) - max(t0, lo)
                if d > 0:
                    link_seconds[label] = link_seconds.get(label, 0.0) + d

        credit(leg.segments, leg.t_start, min(leg.t_end, t_commit))
        for h in hops:
            credit(h.segments, h.t_start, min(h.t_end, t_commit))

        path = CommitPath(uid=uid, worker=getattr(rec, "worker", None),
                          t_ready=t_ready, t_commit=t_commit, phases=phases,
                          link_seconds=link_seconds, kind=leg.kind,
                          hops=len(hops))
        self.paths.append(path)
        return path

    # ------------------------------------------------------------------ #
    # aggregate views (consumed by repro.obs.report)
    # ------------------------------------------------------------------ #
    def phase_totals(self) -> Dict[str, float]:
        tot = dict.fromkeys(PHASES, 0.0)
        for p in self.paths:
            for name, v in p.phases.items():
                tot[name] += v
        return tot

    def link_totals(self) -> Dict[str, float]:
        """Per-link *critical-path* seconds (binding-link attribution)."""
        tot: Dict[str, float] = {}
        for p in self.paths:
            for label, v in p.link_seconds.items():
                tot[label] = tot.get(label, 0.0) + v
        return tot

    def link_byte_seconds(self) -> Dict[str, float]:
        """Per-link reserved byte volume (contention, not blame)."""
        out: Dict[str, float] = {}
        for label, chunks in self.link_busy.items():
            out[label] = sum((t1 - t0) * r for t0, t1, r in chunks)
        return out

    def link_rate_track(self, label: str) -> List[Tuple[float, float]]:
        """``(t, reserved_rate)`` step samples for one link's counter track."""
        events: List[Tuple[float, float]] = []
        for t0, t1, r in self.link_busy.get(label, ()):
            if t1 > t0 and r > 0:
                events.append((t0, r))
                events.append((t1, -r))
        events.sort()
        track: List[Tuple[float, float]] = []
        rate = 0.0
        i, n = 0, len(events)
        while i < n:
            t = events[i][0]
            while i < n and events[i][0] == t:
                rate += events[i][1]
                i += 1
            track.append((t, max(rate, 0.0)))
        return track


class _NullCollector(CritPathCollector):
    """Shared no-op: recording costs one attribute lookup + no-op call."""

    enabled = False

    def ready(self, uid, t):
        pass

    def planned(self, t, uids):
        pass

    def principal(self, uid, kind, transfer, t_done, chain=()):
        pass

    def hop(self, uid, hop, gate, transfer, t_done, chain=(), ready=None):
        pass

    def hold(self, uid, t_release):
        pass

    def commit(self, rec):
        return None


#: The default collector everywhere a real one is not attached.
NULL_COLLECTOR = _NullCollector()


def find_collector(hooks: Any) -> CritPathCollector:
    """The collector of the first :class:`CritPathCallback` on a bus
    (``NULL_COLLECTOR`` if none) — how ``ClusterSim`` discovers it."""
    find = getattr(hooks, "find", None)
    if find is not None:
        cb = find("critpath_collector")
        return cb.critpath_collector if cb is not None else NULL_COLLECTOR
    for cb in getattr(hooks, "callbacks", ()):
        col = getattr(cb, "critpath_collector", None)
        if col is not None:
            return col
    return NULL_COLLECTOR


class CritPathCallback:
    """Harness callback: attach to any trainer's :class:`HookBus` to get a
    :class:`BottleneckReport` at ``on_run_end`` for free.

    ``ClusterSim`` detects the callback at construction, switches its
    actual network into attribution mode, and streams causal legs into
    :attr:`collector`; sources that record nothing (baselines,
    real-tensor trainers) degrade to commit-count-only reports.  With
    ``counters=True`` the top-``top_k`` contended links are also emitted
    as Chrome ``"C"`` counter tracks into the source's tracer.
    """

    def __init__(self, name: str = "run", *, top_k: int = 5,
                 counters: bool = True):
        self.name = name
        self.top_k = top_k
        self.counters = counters
        self.collector = CritPathCollector()
        self.report = None               # set at on_run_end

    # marker attribute used by find_collector
    @property
    def critpath_collector(self) -> CritPathCollector:
        return self.collector

    # -- TrainerCallback interface (unused hooks are no-ops) ----------- #
    def on_run_start(self, source: Any) -> None:
        net = getattr(source, "net_actual", None)
        if net is not None:
            net.attribution = True

    def on_batch_start(self, source: Any, step: int,
                       info: Optional[Dict[str, Any]] = None) -> None:
        pass

    def on_batch_end(self, source: Any, step: int,
                     info: Optional[Dict[str, Any]] = None) -> None:
        pass

    def on_commit(self, source: Any, record: Any) -> None:
        self.collector.commit(record)

    def on_event(self, source: Any, t: float, event: Any) -> None:
        pass

    def on_failover(self, source: Any, t: float,
                    info: Optional[Dict[str, Any]] = None) -> None:
        pass

    def on_replica_promote(self, source: Any, t: float, gap: int) -> None:
        pass

    def on_run_end(self, source: Any, result: Any = None) -> None:
        from .report import build_report
        self.report = build_report(self.collector, name=self.name,
                                   top_k=self.top_k)
        if self.counters:
            self._emit_counter_tracks(getattr(source, "trace", None))

    # ------------------------------------------------------------------ #
    def _emit_counter_tracks(self, tracer: Any) -> None:
        if tracer is None or not getattr(tracer, "enabled", False):
            return
        by_volume = self.collector.link_byte_seconds()
        top = sorted(by_volume, key=lambda k: -by_volume[k])[:self.top_k]
        for label in top:
            for t, rate in self.collector.link_rate_track(label):
                tracer.counter(f"reserved_gbps {label}", track=label,
                               ts=t, value=rate * 8e-9, cat="bandwidth")
