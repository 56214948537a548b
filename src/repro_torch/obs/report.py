"""Bottleneck reports: render and diff critical-path runs.

:func:`build_report` folds a :class:`~repro.obs.critpath.CritPathCollector`
into a :class:`BottleneckReport` — phase shares, time-to-commit
percentiles, and the top-k contended links ranked by *critical-path*
seconds (how long each link was the binding bottleneck of some commit's
path, which is blame) alongside reserved gigabytes (which is volume).

:func:`compare_reports` diffs two reports and flags phase-share
regressions — "transmission share went from 12% to 61%" is the
one-line answer to "why did this run get slower?".

:func:`roofline_attribution` is the single-device analogue shared with
``launch/dryrun.py``: the same dominant-term convention over the
roofline phases (compute / memory / collective) instead of the wire
phases, so dryrun's ``result["bottleneck"]`` speaks the same dialect.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .critpath import CritPathCollector, NETWORK_PHASES, PHASES, WIRE_PHASES
from .metrics import Histogram

#: Roofline phase names shared with ``launch/dryrun.py``.
ROOFLINE_TERMS = ("compute", "memory", "collective")


def dominant_term(terms: Dict[str, float]) -> str:
    """The largest term's name (first wins on ties, insertion order)."""
    return max(terms, key=lambda k: terms[k])


def roofline_attribution(t_compute: float, t_memory: float,
                         t_collective: float) -> Dict[str, Any]:
    """Single-device roofline decomposition (dryrun's bottleneck dialect)."""
    terms = {"compute": float(t_compute), "memory": float(t_memory),
             "collective": float(t_collective)}
    total = sum(terms.values())
    share = {k: (v / total if total > 0 else 0.0) for k, v in terms.items()}
    return {"terms": terms, "share": share,
            "bottleneck": dominant_term(terms)}


@dataclass
class BottleneckReport:
    """Aggregate critical-path attribution for one run."""

    name: str
    n_commits: int                       # all commits seen (incl. untracked)
    n_attributed: int                    # commits with a full decomposition
    phase_seconds: Dict[str, float]
    phase_share: Dict[str, float]
    top_links: List[Dict[str, float]]    # [{"link","crit_seconds","gbytes"}]
    latency: Dict[str, float]            # count/mean/p50/p99/max of TTC
    meta: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------ #
    @property
    def dominant_phase(self) -> str:
        return dominant_term({p: self.phase_seconds.get(p, 0.0)
                              for p in PHASES})

    @property
    def dominant_link(self) -> Optional[str]:
        return self.top_links[0]["link"] if self.top_links else None

    @property
    def transmission_share(self) -> float:
        return sum(self.phase_share.get(p, 0.0) for p in WIRE_PHASES)

    @property
    def wire_seconds(self) -> float:
        """Absolute wire time on the critical path (xmit + drain)."""
        return sum(self.phase_seconds.get(p, 0.0) for p in WIRE_PHASES)

    @property
    def network_share(self) -> float:
        """Share spent in or waiting on the network — the answer to
        "is the network the bottleneck of this run?"."""
        return sum(self.phase_share.get(p, 0.0) for p in NETWORK_PHASES)

    # ------------------------------------------------------------------ #
    def render(self) -> str:
        """Terminal table: the answer to "why was this run slow?"."""
        lines = [f"BottleneckReport[{self.name}]  "
                 f"commits={self.n_commits} (attributed {self.n_attributed})"]
        lat = self.latency
        if lat.get("count"):
            lines.append(
                "  time-to-commit  mean {mean:.3f}s  p50 {p50:.3f}s  "
                "p99 {p99:.3f}s  max {max:.3f}s".format(**lat))
        total = sum(self.phase_seconds.values())
        if total > 0:
            lines.append("  phase shares (of summed critical-path time):")
            for p in PHASES:
                s = self.phase_seconds.get(p, 0.0)
                if s <= 0:
                    continue
                lines.append(f"    {p:<17} {100.0 * s / total:5.1f}%  "
                             f"{s:9.3f}s")
            lines.append(f"    {'transmission':<17} "
                         f"{100.0 * self.transmission_share:5.1f}%  "
                         "(xmit + drain)")
            lines.append(f"    {'network':<17} "
                         f"{100.0 * self.network_share:5.1f}%  "
                         "(wire + waits on it)")
        if self.top_links:
            lines.append("  top contended links "
                         "(binding-bottleneck seconds / reserved GB):")
            for row in self.top_links:
                lines.append(f"    {row['link']:<17} "
                             f"{row['crit_seconds']:9.3f}s  "
                             f"{row['gbytes']:9.2f} GB")
        return "\n".join(lines)


def build_report(collector: CritPathCollector, *, name: str = "run",
                 top_k: int = 5,
                 meta: Optional[Dict[str, Any]] = None) -> BottleneckReport:
    """Fold a collector into a :class:`BottleneckReport`."""
    phase_seconds = collector.phase_totals()
    total = sum(phase_seconds.values())
    phase_share = {p: (v / total if total > 0 else 0.0)
                   for p, v in phase_seconds.items()}

    crit = collector.link_totals()
    volume = collector.link_byte_seconds()
    links = sorted(set(crit) | set(volume),
                   key=lambda k: (-crit.get(k, 0.0), -volume.get(k, 0.0), k))
    top_links = [{"link": lk,
                  "crit_seconds": crit.get(lk, 0.0),
                  "gbytes": volume.get(lk, 0.0) / 1e9}
                 for lk in links[:top_k]]

    h = Histogram("ttc")
    for p in collector.paths:
        h.observe(p.total)
    latency = {"count": float(h.count), "mean": h.mean, "p50": h.p50,
               "p99": h.p99, "max": h.max if h.count else 0.0}

    return BottleneckReport(
        name=name,
        n_commits=len(collector.paths) + collector.untracked,
        n_attributed=len(collector.paths),
        phase_seconds=phase_seconds, phase_share=phase_share,
        top_links=top_links, latency=latency, meta=dict(meta or {}))


# --------------------------------------------------------------------------- #
# run comparison
# --------------------------------------------------------------------------- #
def compare_reports(a: BottleneckReport, b: BottleneckReport, *,
                    share_threshold: float = 0.05) -> Dict[str, Any]:
    """Diff two reports; flag phases whose share of ``b`` grew by more
    than ``share_threshold`` (absolute) over ``a``."""
    delta_share = {p: b.phase_share.get(p, 0.0) - a.phase_share.get(p, 0.0)
                   for p in PHASES}
    regressions = [p for p in PHASES if delta_share[p] > share_threshold]
    return {
        "a": a.name, "b": b.name,
        "phase_share_delta": delta_share,
        "transmission_share_delta":
            b.transmission_share - a.transmission_share,
        "network_share_delta": b.network_share - a.network_share,
        "wire_seconds_ratio":
            (b.wire_seconds / a.wire_seconds if a.wire_seconds > 0
             else float("inf") if b.wire_seconds > 0 else 1.0),
        "latency_delta": {k: b.latency.get(k, 0.0) - a.latency.get(k, 0.0)
                          for k in ("mean", "p50", "p99", "max")},
        "dominant_phase": {"a": a.dominant_phase, "b": b.dominant_phase},
        "dominant_link": {"a": a.dominant_link, "b": b.dominant_link},
        "regressions": regressions,
        "share_threshold": share_threshold,
    }


def render_comparison(cmp: Dict[str, Any]) -> str:
    lines = [f"Comparing {cmp['a']} -> {cmp['b']} "
             f"(share regression threshold "
             f"{100.0 * cmp['share_threshold']:.0f}%)"]
    for p in PHASES:
        d = cmp["phase_share_delta"].get(p, 0.0)
        if abs(d) < 1e-9:
            continue
        flag = "  << REGRESSION" if p in cmp["regressions"] else ""
        lines.append(f"  {p:<17} {100.0 * d:+6.1f}%{flag}")
    lines.append(f"  {'transmission':<17} "
                 f"{100.0 * cmp['transmission_share_delta']:+6.1f}%")
    ld = cmp["latency_delta"]
    lines.append("  time-to-commit  mean {mean:+.3f}s  p50 {p50:+.3f}s  "
                 "p99 {p99:+.3f}s".format(**ld))
    lines.append(f"  dominant phase: {cmp['dominant_phase']['a']} -> "
                 f"{cmp['dominant_phase']['b']}; dominant link: "
                 f"{cmp['dominant_link']['a']} -> "
                 f"{cmp['dominant_link']['b']}")
    if not cmp["regressions"]:
        lines.append("  no phase-share regressions")
    return "\n".join(lines)
