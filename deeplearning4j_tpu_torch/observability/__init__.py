"""Observability: request tracing, the unified metrics registry, SLO
burn rates, threshold alerts and the flight recorder (counterpart of
``deeplearning4j_tpu/observability``).

- ``tracing``          nested spans -> JSONL / Chrome trace, and the
                       request-scoped ``RequestContext`` (W3C
                       ``traceparent``, deterministic head sampling,
                       the per-request phase ledger)
- ``registry``         process-wide counters / gauges / histograms
                       with Prometheus text and OpenMetrics exposition
- ``slo``              multi-window burn-rate SLOs over the registry
- ``alerts``           declarative threshold rules feeding /healthz
- ``flight_recorder``  bounded event ring -> post-mortem bundle on a
                       serving worker crash or ``dump()``
- ``fleetobs``         the fleet collector (merged ``/metrics``, fleet
                       SLOs, stitched traces, incident bundles) and
                       the ``/debug/bundle`` payload of one server
- ``compile_watch``    CUDA graph captures and replays (serving and
                       training), and the post-warmup
                       ``zero_compile_scope`` contract
- ``health``           the training-health monitor over the fused
                       health vector each step builds on the device
- ``step_profile``     data wait / dispatch / device fence a step, MFU

All of it is host code apart from ``health.fused_health``, which runs
inside the training step: nothing else here reads a device tensor
(the monitor and the profiler read the values the step hands them).
"""

from deeplearning4j_tpu_torch.observability.alerts import (
    AlertManager, AlertRule,
)
from deeplearning4j_tpu_torch.observability.flight_recorder import (
    FlightRecorder,
)
from deeplearning4j_tpu_torch.observability.registry import (
    REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
)
from deeplearning4j_tpu_torch.observability.slo import (
    SLO, BurnWindow, SLOMonitor,
)
from deeplearning4j_tpu_torch.observability.tracing import (
    RequestContext, Sampler, Tracer, current_context, get_tracer,
    trace,
)

__all__ = [
    "AlertManager", "AlertRule", "FlightRecorder", "REGISTRY",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
    "get_tracer", "trace", "RequestContext", "Sampler",
    "current_context", "SLO", "BurnWindow", "SLOMonitor",
]
