"""``repro_torch.obs`` — the telemetry plane the control plane emits through.

A copy of the reference's metrics registry, span tracer, phase profiler,
aggregator roofline model, critical-path collector and bottleneck report,
and the program's own spans and counters on the profiler's clock
(``region``, ``RUNTIME``).  Everything here is observation only: attaching
or detaching it never changes a simulation result, a plan, or a gradient.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      NULL_REGISTRY, RUNTIME, Timer)
from .trace import (NULL_TRACER, NullTracer, TraceEvent, Tracer, recording,
                    region, validate_chrome_trace)
from .profiler import PhaseProfiler, measure_planner_latency
from .roofline import aggregator_hbm_traffic
from .critpath import (NETWORK_PHASES, NULL_COLLECTOR, PHASES, WIRE_PHASES,
                       CommitPath, CritPathCallback, CritPathCollector,
                       dominant_bottleneck, find_collector)
from .report import (BottleneckReport, build_report, compare_reports,
                     dominant_term, render_comparison, roofline_attribution)

__all__ = [
    "Counter", "Gauge", "Histogram", "Timer", "MetricsRegistry",
    "NULL_REGISTRY", "RUNTIME",
    "Tracer", "NullTracer", "NULL_TRACER", "TraceEvent",
    "validate_chrome_trace", "recording", "region",
    "PhaseProfiler", "measure_planner_latency", "aggregator_hbm_traffic",
    "PHASES", "WIRE_PHASES", "NETWORK_PHASES", "CommitPath",
    "CritPathCollector", "CritPathCallback", "NULL_COLLECTOR",
    "dominant_bottleneck", "find_collector",
    "BottleneckReport", "build_report", "compare_reports", "dominant_term",
    "render_comparison", "roofline_attribution",
]
