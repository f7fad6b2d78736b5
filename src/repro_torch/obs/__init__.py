"""Telemetry of the port: metrics registry, span tracer, progress bus,
flight recorder, kernel profiling.

The port's copies of the reference's stdlib-only ``obs/metrics.py``,
``obs/trace.py``, ``obs/events.py`` (the per-job progress bus the
portfolio publishes one event per job per wave to) and
``obs/recorder.py`` (the per-job decision timelines fed the same
payloads) and ``obs/log.py`` (the ``CIM_TUNER_LOG`` logger hierarchy,
rooted at ``repro_torch``), and ``obs/profile.py``, the kernel profiling
tier whose :func:`run_microbench` is the measurement half of the
calibration tier.
"""
from repro_torch.obs import profile
from repro_torch.obs.events import ProgressBus, progress_bus
from repro_torch.obs.log import configure_logging, get_logger
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
from repro_torch.obs.recorder import (
    TIMELINE_SCHEMA,
    FlightRecorder,
    flight_recorder,
    regret_curve,
    render_timeline,
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
    "FlightRecorder",
    "flight_recorder",
    "render_timeline",
    "regret_curve",
    "TIMELINE_SCHEMA",
    "profile",
    "MeasurementRecord",
    "run_microbench",
    "record_measurements",
    "take_measurements",
    "configure_logging",
    "get_logger",
    "ProgressBus",
    "progress_bus",
]
