"""Shared trainer harness: one hook bus, one step loop (DESIGN.md §10).

Every training loop in this repo — ``AsyncTrainer``, ``PodAsyncTrainer``,
``SyncTrainer``, ``StaleSyncSim``, ``ElasticSession``, and ``ClusterSim``
itself — emits its lifecycle through a :class:`HookBus` instead of
hand-rolling metrics and callbacks per loop (ROADMAP item 5).  A feature
that needs to observe training (profiler, bench recorder, divergence
tracer, eval logger) is written ONCE as a :class:`TrainerCallback` and
plugs into all of them.

Hook points (all observation-only — a callback must never mutate the
training decision it observes):

* ``on_run_start(source)`` / ``on_run_end(source, result)``
* ``on_batch_start(source, step, info)`` / ``on_batch_end(source, step,
  metrics)`` — one scheduler batch (sim) or one optimization step (loop
  trainers);
* ``on_commit(source, record)`` — an update applied at the server;
* ``on_event(source, t, event)`` — a scenario event was enacted;
* ``on_failover(source, t, info)`` — the primary died;
* ``on_replica_promote(source, t, gap)`` — a replica became primary.

The bus also carries the telemetry backends: a
:class:`~repro.obs.metrics.MetricsRegistry` and a
:class:`~repro.obs.trace.Tracer`.  Both default to the shared no-op
instances, so an un-configured bus costs one no-op call per hook fire
(the golden-trace test pins that instrumented == uninstrumented).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from ..obs.metrics import MetricsRegistry, NULL_REGISTRY
from ..obs.trace import NULL_TRACER, Tracer

HOOKS = ("on_run_start", "on_batch_start", "on_batch_end", "on_commit",
         "on_event", "on_failover", "on_replica_promote", "on_run_end")


class TrainerCallback:
    """No-op base class; override the hooks you care about.

    Duck-typed: any object with matching method names works (the
    ``PhaseProfiler`` in ``repro.obs`` does not inherit from this).
    """

    def on_run_start(self, source: Any) -> None: ...

    def on_batch_start(self, source: Any, step: int,
                       info: Optional[dict] = None) -> None: ...

    def on_batch_end(self, source: Any, step: int,
                     metrics: Optional[dict] = None) -> None: ...

    def on_commit(self, source: Any, record: Any) -> None: ...

    def on_event(self, source: Any, t: float, event: Any) -> None: ...

    def on_failover(self, source: Any, t: float,
                    info: Optional[dict] = None) -> None: ...

    def on_replica_promote(self, source: Any, t: float, gap: int) -> None: ...

    def on_run_end(self, source: Any, result: Any = None) -> None: ...


class HookBus:
    """Fans hook firings out to callbacks and counts them in the registry.

    ``metrics``/``tracer`` default to the shared no-op backends; pass real
    ones to record.  Callbacks missing a hook method are skipped (duck
    typing), and every fire bumps ``hooks/<name>`` so "did the harness
    actually drive this trainer" is answerable from the registry alone.
    """

    def __init__(self, callbacks: Sequence[Any] = (), *,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.callbacks: List[Any] = list(callbacks)
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def add(self, callback: Any) -> None:
        self.callbacks.append(callback)

    def find(self, attr: str) -> Optional[Any]:
        """First callback exposing a non-None ``attr`` (marker-attribute
        discovery — how ``ClusterSim`` locates the critical-path
        attribution collector, DESIGN.md §14)."""
        for cb in self.callbacks:
            if getattr(cb, attr, None) is not None:
                return cb
        return None

    # ------------------------------------------------------------------ #
    def fire(self, hook: str, source: Any, *args: Any) -> None:
        self.metrics.counter(f"hooks/{hook}").inc()
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(source, *args)

    # typed conveniences (greppable call sites) ------------------------- #
    def on_run_start(self, source: Any) -> None:
        self.fire("on_run_start", source)

    def on_batch_start(self, source: Any, step: int,
                       info: Optional[dict] = None) -> None:
        self.fire("on_batch_start", source, step, info)

    def on_batch_end(self, source: Any, step: int,
                     metrics: Optional[dict] = None) -> None:
        self.fire("on_batch_end", source, step, metrics)

    def on_commit(self, source: Any, record: Any) -> None:
        self.fire("on_commit", source, record)

    def on_event(self, source: Any, t: float, event: Any) -> None:
        self.fire("on_event", source, t, event)

    def on_failover(self, source: Any, t: float,
                    info: Optional[dict] = None) -> None:
        self.fire("on_failover", source, t, info)

    def on_replica_promote(self, source: Any, t: float, gap: int) -> None:
        self.fire("on_replica_promote", source, t, gap)

    def on_run_end(self, source: Any, result: Any = None) -> None:
        self.fire("on_run_end", source, result)


#: Shared do-nothing bus (no callbacks, null backends).
NULL_BUS = HookBus()


def make_bus(callbacks: Sequence[Any] = (), *,
             metrics: Optional[MetricsRegistry] = None,
             tracer: Optional[Tracer] = None) -> HookBus:
    """A bus, reusing :data:`NULL_BUS` when nothing is attached (keeps the
    default path allocation-free across many short-lived trainers)."""
    if not callbacks and metrics is None and tracer is None:
        return NULL_BUS
    return HookBus(callbacks, metrics=metrics, tracer=tracer)


class StepLoop:
    """The one step loop: drive ``step_fn`` over items with hooks around
    each step.

    ``step_fn(step_idx, item)`` returns this step's metrics (any value;
    a dict is passed to ``on_batch_end`` as-is, anything else is wrapped
    under ``{"result": ...}``).  The loop-style trainers (``SyncTrainer``,
    ``StaleSyncSim``, ``ElasticSession``) all run on this; the
    event-driven ones (``ClusterSim``-backed) fire the same hooks from
    their event handlers instead.
    """

    def __init__(self, step_fn: Callable[[int, Any], Any], *,
                 bus: Optional[HookBus] = None, source: Any = None):
        self.step_fn = step_fn
        self.bus = bus if bus is not None else NULL_BUS
        self.source = source if source is not None else self
        self.steps_done = 0

    def run(self, items: Iterable[Any], *,
            fire_run_hooks: bool = True) -> Any:
        if fire_run_hooks:
            self.bus.on_run_start(self.source)
        out: Any = None
        for item in items:
            step = self.steps_done
            self.bus.on_batch_start(self.source, step)
            out = self.step_fn(step, item)
            self.bus.on_batch_end(
                self.source, step,
                out if isinstance(out, dict) or out is None
                else {"result": out})
            self.steps_done += 1
        if fire_run_hooks:
            self.bus.on_run_end(self.source, out)
        return out
