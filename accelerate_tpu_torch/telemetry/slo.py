"""SLO monitors: streaming quantiles + thresholded warn/trip callbacks
(mirrors ``accelerate_tpu/telemetry/slo.py``: ``StreamingQuantile`` :37,
``SLOStatus`` :118, ``SLOMonitor`` :129, ``prometheus_text`` :252; the
port keeps its own copy, standard library only).

:class:`StreamingQuantile` is the P-square (P²) estimator (Jain &
Chlamtac 1985): five markers per tracked quantile, O(1) memory and O(1)
per observation.  It is exact for n <= 5 (the small-n regime sorts the
stored markers) and within ~5 % relative error at p50 / ~10 % at p99 on
unimodal traffic-shaped distributions at n >= 500; adversarial multimodal
streams can do worse, so monitor thresholds should carry margin.

:class:`SLOMonitor` holds one estimator pair (p50/p99) per metric
(``token_latency_s``, ``ttft_s``, ``step_time_s``, ``goodput_frac``)
against configurable thresholds with two escalation levels, **warn** and
**trip**, each a counted callback; the monitor itself never raises from
the hot path.  Callbacks fire on the *transition* into breach (re-armed
when the quantile recovers), so a sustained breach is one event, and
``on_recover`` fires on the way back to ``ok`` — the degradation ladder's
relax signal (``ServingEngine.attach_slo``).

:func:`prometheus_text` renders the twin registry and monitors in the
Prometheus text exposition format.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

# metrics where LOWER is worse (breach = quantile < threshold)
_LOWER_IS_BAD = frozenset({"goodput_frac"})


class StreamingQuantile:
    """P² streaming estimator of one quantile ``q`` in ``(0, 1)``.

    Keeps 5 markers; :meth:`value` is exact while ``n <= 5`` (documented
    small-n contract) and the P² parabolic interpolation after that.
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.n = 0
        self._heights: list[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._desired = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        self._inc = [0.0, q / 2.0, q, (1 + q) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if len(self._heights) < 5:
            self._heights.append(x)
            self._heights.sort()
            return
        h, pos = self._heights, self._pos
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._desired[i] += self._inc[i]
        # adjust the three interior markers by +-1 toward their desired
        # positions, parabolic (P²) height interpolation, linear fallback
        for i in (1, 2, 3):
            d = self._desired[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
               (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                step = 1.0 if d >= 1.0 else -1.0
                cand = self._parabolic(i, step)
                if h[i - 1] < cand < h[i + 1]:
                    h[i] = cand
                else:
                    h[i] = self._linear(i, step)
                pos[i] += step

    def _parabolic(self, i: int, d: float) -> float:
        h, pos = self._heights, self._pos
        return h[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i]) / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1]) / (pos[i] - pos[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        h, pos = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])

    def value(self) -> float:
        """The current estimate (0.0 before any observation)."""
        if self.n == 0:
            return 0.0
        if self.n <= 5:
            # exact small-n quantile (linear interpolation, numpy
            # convention) over the sorted stored samples
            h = sorted(self._heights)
            idx = self.q * (len(h) - 1)
            lo = int(idx)
            hi = min(lo + 1, len(h) - 1)
            return h[lo] + (idx - lo) * (h[hi] - h[lo])
        return self._heights[2]


@dataclasses.dataclass
class SLOStatus:
    """One metric's current standing."""

    metric: str
    n: int
    p50: float
    p99: float
    status: str           # "ok" | "warn" | "trip" | "idle"
    threshold_quantile: Optional[str] = None  # which quantile breached


class SLOMonitor:
    """Streaming p50/p99 per metric + warn/trip thresholds.

    ``thresholds``: ``{metric: {"p99_warn": x, "p99_trip": y,
    "p50_warn": ..., "p50_trip": ...}}`` — any subset of keys; metrics in
    :data:`_LOWER_IS_BAD` (``goodput_frac``) breach when the quantile falls
    BELOW the threshold, everything else when it rises above.  Metrics are
    auto-created on first :meth:`observe`, thresholded or not, so the
    quantile table is always queryable.

    >>> mon = SLOMonitor({"ttft_s": {"p99_trip": 0.5}},
    ...                  on_trip=lambda m, q, v: engine.ladder.escalate())

    ``on_recover`` fires on the transition back to ``ok`` from any breach
    level — the degradation ladder's relax signal
    (``ServingEngine.attach_slo`` wires trip → escalate, recover → relax).
    """

    DEFAULT_METRICS = ("token_latency_s", "ttft_s", "step_time_s",
                       "goodput_frac")

    def __init__(self, thresholds: Optional[dict] = None,
                 on_warn: Optional[Callable] = None,
                 on_trip: Optional[Callable] = None,
                 on_recover: Optional[Callable] = None):
        self.thresholds = dict(thresholds or {})
        self.on_warn = on_warn
        self.on_trip = on_trip
        self.on_recover = on_recover
        self._est: dict[str, dict[str, StreamingQuantile]] = {}
        self._state: dict[str, str] = {}   # metric -> "ok"|"warn"|"trip"
        self.warn_count = 0
        self.trip_count = 0
        for metric in self.thresholds:
            self._ensure(metric)

    def _ensure(self, metric: str) -> dict:
        if metric not in self._est:
            self._est[metric] = {"p50": StreamingQuantile(0.50),
                                 "p99": StreamingQuantile(0.99)}
            self._state[metric] = "ok"
        return self._est[metric]

    def observe(self, metric: str, value: float) -> None:
        est = self._ensure(metric)
        est["p50"].observe(value)
        est["p99"].observe(value)
        self._check(metric)

    def observe_many(self, metric: str, values) -> None:
        for v in values:
            self.observe(metric, v)

    def _breached(self, metric: str, quantile: str, level: str) -> bool:
        thr = self.thresholds.get(metric, {}).get(f"{quantile}_{level}")
        if thr is None:
            return False
        cur = self._est[metric][quantile].value()
        if metric in _LOWER_IS_BAD:
            return cur < thr
        return cur > thr

    def _check(self, metric: str) -> None:
        if metric not in self.thresholds:
            return
        level = "ok"
        which = None
        for q in ("p50", "p99"):
            if self._breached(metric, q, "trip"):
                level, which = "trip", q
                break
            if level == "ok" and self._breached(metric, q, "warn"):
                level, which = "warn", q
        prev = self._state[metric]
        if level != prev:
            self._state[metric] = level
            # fire on the transition INTO (or up through) a breach level,
            # and on the transition back OUT (the ladder's relax signal)
            if level == "trip":
                self.trip_count += 1
                if self.on_trip is not None:
                    self.on_trip(metric, which, self._est[metric][which].value())
            elif level == "warn" and prev == "ok":
                self.warn_count += 1
                if self.on_warn is not None:
                    self.on_warn(metric, which, self._est[metric][which].value())
            elif level == "ok" and self.on_recover is not None:
                self.on_recover(metric, None, 0.0)

    # -- queries ------------------------------------------------------------

    def status(self, metric: str) -> SLOStatus:
        est = self._ensure(metric)
        return SLOStatus(
            metric=metric, n=est["p50"].n,
            p50=est["p50"].value(), p99=est["p99"].value(),
            status="idle" if est["p50"].n == 0 else self._state[metric],
        )

    def report(self) -> dict:
        """``{metric: {n, p50, p99, status}}`` for every tracked metric,
        plus the escalation counters."""
        out = {
            m: {
                "n": s.n, "p50": round(s.p50, 6), "p99": round(s.p99, 6),
                "status": s.status,
            }
            for m, s in ((m, self.status(m)) for m in sorted(self._est))
        }
        out["_counters"] = {"warns": self.warn_count, "trips": self.trip_count}
        return out

    def flat_metrics(self, prefix: str = "slo") -> dict:
        """Flat ``{"slo/<metric>/<q>": value}`` rows for a metrics sink."""
        out = {}
        for m in sorted(self._est):
            s = self.status(m)
            out[f"{prefix}/{m}/p50"] = round(s.p50, 6)
            out[f"{prefix}/{m}/p99"] = round(s.p99, 6)
            out[f"{prefix}/{m}/n"] = s.n
        return out


def prometheus_text(registry=None, monitors: dict | None = None,
                    extra_gauges: dict | None = None) -> str:
    """Prometheus text exposition of the twin registry + SLO monitors.

    ``registry`` defaults to the process-global
    :func:`~accelerate_tpu_torch.telemetry.twins.twin_registry`; ``monitors`` is
    ``{job_label: SLOMonitor}``; ``extra_gauges`` is flat ``{name: value}``.
    Serve the returned text at ``/metrics`` (any WSGI one-liner) and any
    Prometheus scraper ingests the same numbers the serving report carries.
    """
    from .twins import twin_registry

    if registry is None:
        registry = twin_registry()
    lines: list[str] = []
    rows = registry.drift_report()
    if rows:
        for side in ("predicted", "measured", "rel_err"):
            lines.append(f"# TYPE accelerate_twin_{side} gauge")
            for name, row in rows.items():
                lines.append(
                    f'accelerate_twin_{side}{{twin="{name}"}} {row[side]}'
                )
    if monitors:
        lines.append("# TYPE accelerate_slo_quantile gauge")
        for job, mon in monitors.items():
            rep = mon.report()
            for metric, row in rep.items():
                if metric.startswith("_"):
                    continue
                for q in ("p50", "p99"):
                    lines.append(
                        f'accelerate_slo_quantile{{job="{job}",'
                        f'metric="{metric}",q="{q}"}} {row[q]}'
                    )
        lines.append("# TYPE accelerate_slo_events_total counter")
        for job, mon in monitors.items():
            lines.append(
                f'accelerate_slo_events_total{{job="{job}",level="warn"}} '
                f"{mon.warn_count}"
            )
            lines.append(
                f'accelerate_slo_events_total{{job="{job}",level="trip"}} '
                f"{mon.trip_count}"
            )
    for name, value in (extra_gauges or {}).items():
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")
    return "\n".join(lines) + ("\n" if lines else "")
