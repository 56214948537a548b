"""``repro_torch.obs`` — the telemetry plane the control plane emits through.

A copy of the reference's metrics registry, span tracer, critical-path
collector and bottleneck report (the parts ``repro_torch.core`` pulls in).
Everything here is observation only: attaching or detaching it never
changes a simulation result, a plan, or a gradient.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      NULL_REGISTRY, Timer)
from .trace import (NULL_TRACER, NullTracer, TraceEvent, Tracer,
                    validate_chrome_trace)
from .critpath import (NETWORK_PHASES, NULL_COLLECTOR, PHASES, WIRE_PHASES,
                       CommitPath, CritPathCallback, CritPathCollector,
                       dominant_bottleneck, find_collector)
from .report import (BottleneckReport, build_report, compare_reports,
                     dominant_term, load_report, render_comparison,
                     roofline_attribution, write_report)

__all__ = [
    "Counter", "Gauge", "Histogram", "Timer", "MetricsRegistry",
    "NULL_REGISTRY",
    "Tracer", "NullTracer", "NULL_TRACER", "TraceEvent",
    "validate_chrome_trace",
    "PHASES", "WIRE_PHASES", "NETWORK_PHASES", "CommitPath",
    "CritPathCollector", "CritPathCallback", "NULL_COLLECTOR",
    "dominant_bottleneck", "find_collector",
    "BottleneckReport", "build_report", "compare_reports", "dominant_term",
    "load_report", "render_comparison", "roofline_attribution",
    "write_report",
]
