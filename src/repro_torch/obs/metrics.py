"""Metrics registry: counters, gauges, histograms, timers (DESIGN.md §10).

One registry instance is one namespace of named instruments.  Producers
never hold raw numbers in ad-hoc attributes; they grab an instrument once
(``reg.counter("scenario/drops")``) and bump it.  Consumers read the same
instrument back or snapshot the whole registry (``reg.snapshot()``).

Two modes:

* **recording** (``MetricsRegistry()``) — instruments accumulate.
* **no-op** (``MetricsRegistry.disabled()`` / ``NULL_REGISTRY``) — every
  instrument lookup returns a shared null instrument whose methods do
  nothing.  Hot loops can therefore be instrumented unconditionally; with
  telemetry off the cost is one attribute call on a do-nothing method
  (the golden-trace test pins that a fully instrumented ``ClusterSim``
  run is bit-identical to an uninstrumented one).

Scoped contexts prefix instrument names, so a subsystem can namespace its
emissions without threading strings everywhere::

    with reg.scope("worker3"):
        reg.counter("commits").inc()        # -> "worker3/commits"
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Iterator, List, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotonically increasing count (events, bytes, drops)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0

    def inc(self, amount: Number = 1) -> None:
        self.value += amount

    def snapshot(self) -> Number:
        return self.value


class Gauge:
    """Last-write-wins value (a frontier, a rate, a recovery time)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, initial: Number = 0.0):
        self.name = name
        self.value: Number = initial

    def set(self, value: Number) -> None:
        self.value = value

    def snapshot(self) -> Number:
        return self.value


class Histogram:
    """Streaming distribution: count/sum/min/max/moments plus exact
    quantiles.  Samples are retained (runs observe at most a few thousand
    values per instrument), so ``quantile`` is exact — numpy's ``linear``
    interpolation method — rather than sketched."""

    __slots__ = ("name", "count", "total", "sq_total", "min", "max",
                 "_samples", "_sorted")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.sq_total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: List[float] = []
        self._sorted: Optional[List[float]] = None

    def observe(self, value: Number) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.sq_total += v * v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._samples.append(v)
        self._sorted = None

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        if not self.count:
            return 0.0
        var = self.sq_total / self.count - self.mean ** 2
        return math.sqrt(max(var, 0.0))

    def quantile(self, q: float) -> float:
        """Exact ``q``-quantile (numpy ``quantile(..., method="linear")``)."""
        if not self._samples:
            return 0.0
        xs = self._sorted
        if xs is None:
            xs = self._sorted = sorted(self._samples)
        if q <= 0.0:
            return xs[0]
        if q >= 1.0:
            return xs[-1]
        pos = q * (len(xs) - 1)
        lo = int(pos)
        frac = pos - lo
        if lo + 1 >= len(xs):
            return xs[lo]
        return xs[lo] + (xs[lo + 1] - xs[lo]) * frac

    @property
    def p50(self) -> float:
        return self.quantile(0.5)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean, "std": self.std,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "total": self.total,
                "p50": self.p50, "p99": self.p99}


class Timer(Histogram):
    """Histogram of wall-clock durations with a context-manager probe."""

    __slots__ = ()

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)


class _NullInstrument:
    """Shared do-nothing instrument for disabled registries."""

    __slots__ = ()
    name = "<null>"
    value = 0
    count = 0
    mean = 0.0
    std = 0.0
    min = 0.0
    max = 0.0
    total = 0.0
    p50 = 0.0
    p99 = 0.0

    def inc(self, amount: Number = 1) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0

    def set(self, value: Number) -> None:
        pass

    def observe(self, value: Number) -> None:
        pass

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        yield

    def snapshot(self) -> Number:
        return 0


_NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Name -> instrument map with lazy creation and scoped prefixes."""

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._instruments: Dict[str, object] = {}
        self._prefix: List[str] = []

    # ------------------------------------------------------------------ #
    @classmethod
    def disabled(cls) -> "MetricsRegistry":
        return cls(enabled=False)

    # ------------------------------------------------------------------ #
    def _get(self, name: str, factory):
        if not self.enabled:
            return _NULL_INSTRUMENT
        if self._prefix:
            name = "/".join(self._prefix) + "/" + name
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = factory(name)
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, *, initial: Number = 0.0) -> Gauge:
        return self._get(name, lambda n: Gauge(n, initial))

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def scope(self, prefix: str) -> Iterator["MetricsRegistry"]:
        """Prefix every instrument name created inside the block."""
        self._prefix.append(prefix)
        try:
            yield self
        finally:
            self._prefix.pop()

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, object]:
        """Plain-data view of every instrument (for BENCH records/tests)."""
        return {name: inst.snapshot()
                for name, inst in sorted(self._instruments.items())}

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments


#: Shared no-op registry: instrument anything, pay (almost) nothing.
NULL_REGISTRY = MetricsRegistry.disabled()
