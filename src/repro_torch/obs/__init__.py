"""``repro_torch.obs`` — the telemetry plane the control plane emits through.

A copy of the reference's metrics registry, span tracer, phase profiler,
aggregator roofline model, BENCH schema, critical-path collector and
bottleneck report.  Everything here is observation only: attaching or
detaching it never changes a simulation result, a plan, or a gradient.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      NULL_REGISTRY, Timer)
from .trace import (NULL_TRACER, NullTracer, TraceEvent, Tracer,
                    validate_chrome_trace)
from .profiler import PhaseProfiler, measure_planner_latency
from .roofline import aggregator_hbm_traffic
from .bench_schema import (SCHEMA_VERSION, bench_record, git_sha, sanitize,
                           validate_bench_record, write_bench_record)
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
    "PhaseProfiler", "measure_planner_latency", "aggregator_hbm_traffic",
    "SCHEMA_VERSION", "bench_record", "git_sha", "sanitize",
    "validate_bench_record", "write_bench_record",
    "PHASES", "WIRE_PHASES", "NETWORK_PHASES", "CommitPath",
    "CritPathCollector", "CritPathCallback", "NULL_COLLECTOR",
    "dominant_bottleneck", "find_collector",
    "BottleneckReport", "build_report", "compare_reports", "dominant_term",
    "load_report", "render_comparison", "roofline_attribution",
    "write_report",
]
