"""repro_torch.obs — stdlib-only observability for the port's serving stack:
a copy of src/repro/obs (the JAX package's), module for module, with the
same metric names, trace format and event schema, so each package's
validators and parsers accept the other's output.

Five pieces (docs/observability.md):

  * :mod:`repro_torch.obs.registry` — labeled counters / gauges /
    histograms with Prometheus text exposition (``/metrics``), plus OpenMetrics
    exposition with trace-id exemplars.
  * :mod:`repro_torch.obs.tracing` — Chrome-trace / Perfetto span collector
    (``--trace-out trace.json``).
  * :mod:`repro_torch.obs.drift` — live measured-vs-modeled per-stage drift
    against ``sim/analytical`` predictions.
  * :mod:`repro_torch.obs.events` — crash-safe structured event log: one
    JSONL record per request lifecycle edge
    (``python -m repro_torch.obs.logquery`` is the reader).
  * :mod:`repro_torch.obs.slo` — SLO tiers: per-class deadlines and
    violation accounting keyed by each request's ``slo_class``.

:class:`~repro_torch.obs.serving.ServingObs` bundles them behind the hooks
the engine / router / frontend call.
"""
from repro_torch.obs.drift import (DriftMonitor, HOST_DRIFT_BAND,
                                   modeled_tick_stages)
from repro_torch.obs.events import (EVENT_TYPES, EventLog, SCHEMA_VERSION,
                                    read_events, validate_events)
from repro_torch.obs.registry import (CONTENT_TYPE, Counter, Gauge,
                                      Histogram, LATENCY_BUCKETS,
                                      OPENMETRICS_CONTENT_TYPE, Registry,
                                      exp_buckets, parse_exposition,
                                      validate_histogram)
from repro_torch.obs.serving import ServingObs, frontend_metrics
from repro_torch.obs.slo import (DEFAULT_CLASS, SLOClass, VIOLATION_KINDS,
                                 default_classes, resolve_classes)
from repro_torch.obs.tracing import TraceCollector, now_us, validate_trace

__all__ = [
    "CONTENT_TYPE", "Counter", "DEFAULT_CLASS", "DriftMonitor",
    "EVENT_TYPES", "EventLog", "Gauge", "Histogram", "HOST_DRIFT_BAND",
    "LATENCY_BUCKETS", "OPENMETRICS_CONTENT_TYPE", "Registry",
    "SCHEMA_VERSION", "SLOClass", "ServingObs", "TraceCollector",
    "VIOLATION_KINDS", "default_classes", "exp_buckets",
    "frontend_metrics", "modeled_tick_stages", "now_us",
    "parse_exposition", "read_events", "resolve_classes",
    "validate_events", "validate_histogram", "validate_trace",
]
