"""Profiler callback for the trainer harness (DESIGN.md §10).

``PhaseProfiler`` plugs into any :class:`repro.core.harness.HookBus` and
captures, per phase, **wall-clock** time spent in the host process — the
measurement the simulator cannot give (its clock is simulated).  Phases
come from two sources:

* harness hooks: every ``on_batch_start``/``on_batch_end`` pair becomes a
  ``batch`` phase sample; commits/events/failovers are counted;
* explicit probes: ``with profiler.phase("plan"): ...`` around any block.

``summary()`` folds in two modeled quantities so one report answers both
"where did the time go" and "what does the hardware model say":

* the aggregator HBM-traffic roofline (``repro.obs.roofline``), evaluated
  at the profiled fan-in/size when provided;
* planner latency vs batch size U (:func:`measure_planner_latency`) — the
  BENCH entry ROADMAP item 2 asks for, so planner regressions are visible
  in every PR.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

from .metrics import MetricsRegistry
from .roofline import aggregator_hbm_traffic


class PhaseProfiler:
    """Wall-clock per-phase profiler; harness callback + manual probes."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._batch_t0: Dict[int, float] = {}   # id(source) -> perf_counter

    # -- explicit probes ------------------------------------------------ #
    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        with self.registry.timer(f"phase/{name}").time():
            yield

    # -- harness hooks --------------------------------------------------- #
    def on_run_start(self, source: Any) -> None:
        self.registry.gauge("runs").set(self.registry.gauge("runs").value + 1)

    def on_batch_start(self, source: Any, step: int,
                       info: Optional[dict] = None) -> None:
        self._batch_t0[id(source)] = time.perf_counter()

    def on_batch_end(self, source: Any, step: int,
                     metrics: Optional[dict] = None) -> None:
        t0 = self._batch_t0.pop(id(source), None)
        if t0 is not None:
            self.registry.timer("phase/batch").observe(
                time.perf_counter() - t0)

    def on_commit(self, source: Any, record: Any) -> None:
        self.registry.counter("commits").inc()

    def on_event(self, source: Any, t: float, event: Any) -> None:
        self.registry.counter("events").inc()

    def on_failover(self, source: Any, t: float,
                    info: Optional[dict] = None) -> None:
        self.registry.counter("failovers").inc()

    def on_replica_promote(self, source: Any, t: float, gap: int) -> None:
        self.registry.counter("promotions").inc()

    def on_run_end(self, source: Any, result: Any = None) -> None:
        # a sim-backed run carries planning wall-clock in its result
        wall = getattr(result, "scheduler_wall_time", None)
        if wall is not None:
            self.registry.timer("phase/plan").observe(wall)

    # -- report ---------------------------------------------------------- #
    def summary(self, *, roofline_n: Optional[int] = None,
                roofline_d: Optional[int] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {"metrics": self.registry.snapshot()}
        if roofline_n is not None and roofline_d is not None:
            out["roofline"] = aggregator_hbm_traffic(roofline_n, roofline_d)
        return out


def measure_planner_latency(u_values: Sequence[int], *,
                            n_aggregators: int = 8,
                            update_mb: float = 100.0,
                            planner: str = "incremental",
                            repeats: int = 3,
                            seed: int = 1) -> List[Dict[str, float]]:
    """Best-of-``repeats`` wall-clock of one Alg. 3 planning pass per batch
    size in ``u_values`` (ROADMAP item 2: planner cost must grow
    ~O(changes), so this curve is the regression alarm)."""
    import random as _random

    from ..core.aggregation import aggregate_updates
    from ..core.network import NetworkState, gbps, mb
    from ..core.ordering import Update

    rows: List[Dict[str, float]] = []
    for u in u_values:
        best = float("inf")
        for _ in range(repeats):
            rng = _random.Random(seed)
            net = NetworkState([f"w{i}" for i in range(u)] + ["s"] +
                               [f"a{i}" for i in range(n_aggregators)],
                               gbps(10))
            ups = [Update(uid=i, worker=f"w{i}", size=mb(update_mb),
                          version=0, t_avail=rng.uniform(0, 0.05))
                   for i in range(u)]
            t0 = time.perf_counter()
            aggregate_updates(ups, net, "s",
                              [f"a{i}" for i in range(n_aggregators)],
                              objective="makespan", planner=planner)
            best = min(best, time.perf_counter() - t0)
        rows.append({"u": float(u), "latency_s": best,
                     "latency_per_u_us": best / u * 1e6})
    return rows
