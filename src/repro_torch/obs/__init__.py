"""Telemetry of the port: metrics registry, span tracer, kernel profiling.

The port's copies of the reference's stdlib-only ``obs/metrics.py`` and
``obs/trace.py``, and ``obs/profile.py``, the kernel profiling tier whose
:func:`run_microbench` is the measurement half of the calibration tier.
The reference's ``events``, ``log`` and ``recorder`` are not ported yet.
"""
from repro_torch.obs import profile
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    StatCounters,
    exemplars_enabled,
    registry,
)
from repro_torch.obs.profile import (
    MeasurementRecord,
    record_measurements,
    run_microbench,
    take_measurements,
)
from repro_torch.obs.trace import Span, Tracer, chrome_trace, span, tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "StatCounters",
    "registry",
    "exemplars_enabled",
    "DEFAULT_BUCKETS",
    "Span",
    "Tracer",
    "tracer",
    "span",
    "chrome_trace",
    "profile",
    "MeasurementRecord",
    "run_microbench",
    "record_measurements",
    "take_measurements",
]
