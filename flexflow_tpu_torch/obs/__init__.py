"""Serving observability for the port: telemetry, metrics, calibration,
the step profiler, plan health, and the JSONL reports.

Copies of the JAX package's ``flexflow_tpu/obs`` modules (host-side
Python; the profiler's cost card reads :mod:`..serve.cost`), traffic-trace
capture and replay (:mod:`.replay`) among them.  The
serving stack (``RequestManager``, ``SpecInferManager``,
``InferenceManager``, ``LLM.compile``) is instrumented behind one
:class:`Telemetry` handle and one :class:`StepProfiler`; neither reads a
device value, so serve outputs are bit-identical with them on or off.
See the README's port section, "Observability".
"""

from .calibration import (
    DEFAULT_STORE_PATH,
    CalibrationLedger,
    CalibrationStore,
    StoreConfig,
)
from .drift import (
    DriftDetector,
    WorkloadProfile,
    drift_score,
    psi,
)
from .memory import (
    KV_OCCUPANCY_HIST,
    MEMORY_GAUGES,
    MemoryLedger,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile,
)
from .plan_health import PlanHealthConfig, PlanHealthMonitor, health_score
from .profiler import (
    COMPONENTS,
    NULL_PROFILER,
    TIME_COMPONENT_FIELDS,
    WORK_COUNTERS,
    NullStepProfiler,
    PlanCostCard,
    StepProfiler,
    plan_cost_card,
    profiler_or_null,
)
from .replay import (
    TRACE_VERSION,
    ReplayHarness,
    TrafficTrace,
    TrafficTraceRecorder,
    VirtualClock,
)
from .report import (
    memory_section,
    summarize_events,
    summarize_jsonl,
    time_budget_section,
    under_load_summary,
    validate_jsonl,
)
from .telemetry import (
    NULL_TELEMETRY,
    NullTelemetry,
    Telemetry,
    telemetry_or_null,
)
from .trace import TraceRecorder

__all__ = [
    "Telemetry",
    "NullTelemetry",
    "NULL_TELEMETRY",
    "telemetry_or_null",
    "TraceRecorder",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "percentile",
    "CalibrationLedger",
    "CalibrationStore",
    "StoreConfig",
    "DEFAULT_STORE_PATH",
    "WorkloadProfile",
    "DriftDetector",
    "drift_score",
    "psi",
    "PlanHealthConfig",
    "PlanHealthMonitor",
    "health_score",
    "MemoryLedger",
    "MEMORY_GAUGES",
    "KV_OCCUPANCY_HIST",
    "memory_section",
    "summarize_events",
    "summarize_jsonl",
    "time_budget_section",
    "under_load_summary",
    "validate_jsonl",
    "StepProfiler",
    "NullStepProfiler",
    "NULL_PROFILER",
    "profiler_or_null",
    "PlanCostCard",
    "plan_cost_card",
    "COMPONENTS",
    "TIME_COMPONENT_FIELDS",
    "WORK_COUNTERS",
    "TrafficTraceRecorder",
    "TrafficTrace",
    "ReplayHarness",
    "VirtualClock",
    "TRACE_VERSION",
]
