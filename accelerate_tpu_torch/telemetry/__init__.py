"""Telemetry of the port (mirrors ``accelerate_tpu/telemetry/``): the twin
registry (:mod:`.twins`) and request trace spans (:mod:`.spans`), both
host-side and invisible to tokens.  The SLO monitors (``slo.py``) and the
training timeline (``timeline.py``) are ROADMAP items A11d and A14.
"""

from .spans import RequestTracer, SpanRecorder, VirtualClock, validate_chrome_trace
from .twins import STANDARD_TWINS, Twin, TwinRegistry, twin_registry

__all__ = [
    "STANDARD_TWINS",
    "RequestTracer",
    "SpanRecorder",
    "Twin",
    "TwinRegistry",
    "VirtualClock",
    "twin_registry",
    "validate_chrome_trace",
]
