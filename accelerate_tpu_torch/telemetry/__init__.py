"""Telemetry of the port (mirrors ``accelerate_tpu/telemetry/``): the twin
registry (:mod:`.twins`), request trace spans (:mod:`.spans`), the
training timeline (:mod:`.timeline`) and the SLO monitors (:mod:`.slo`: P²
streaming quantiles against warn / trip thresholds, Prometheus text), all
host-side and invisible to tokens and loss.
"""

from .slo import SLOMonitor, SLOStatus, StreamingQuantile, prometheus_text
from .spans import RequestTracer, SpanRecorder, VirtualClock, validate_chrome_trace
from .timeline import TrainTimeline
from .twins import STANDARD_TWINS, Twin, TwinRegistry, twin_registry

__all__ = [
    "STANDARD_TWINS",
    "RequestTracer",
    "SLOMonitor",
    "SLOStatus",
    "SpanRecorder",
    "StreamingQuantile",
    "TrainTimeline",
    "Twin",
    "TwinRegistry",
    "VirtualClock",
    "prometheus_text",
    "twin_registry",
    "validate_chrome_trace",
]
