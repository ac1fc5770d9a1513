"""The training step's timeline: where each step's wall clock went
(mirrors ``accelerate_tpu/telemetry/timeline.py``).

Phase spans at hook points the training stack already owns, all on the
host, adding no device sync:

- ``data_wait``: the prepared data loader blocking on its inner iterable;
- ``h2d_staging``: a batch's placement on the card;
- ``step_dispatch``: the prepared train step's call.  PyTorch launches
  asynchronously, so this is the host's time issuing the step's work,
  not the card's compute;
- ``guard_sync``: the NaN guard's one host read of the step's finiteness
  flag, nested inside ``step_dispatch`` (exclusive time below);
- ``checkpoint_drain``: waiting on an in-flight async checkpoint.

It shares :class:`~.spans.SpanRecorder` (bounded ring, injectable clock,
Chrome-trace / JSONL export, its own ``overhead_s``).  ``summary()`` is
the per-phase count / total / mean; the accelerator feeds the step cadence
to an :class:`~.slo.SLOMonitor` when one is armed.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

from .spans import SpanRecorder

PHASES = ("data_wait", "h2d_staging", "step_dispatch", "guard_sync",
          "checkpoint_drain")


class TrainTimeline:
    """Phase timing of the prepared train loop (host-side only)."""

    def __init__(self, capacity: int = 4096,
                 clock: Optional[Callable[[], float]] = None):
        self.recorder = SpanRecorder(capacity=capacity, clock=clock)
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._stack: list[list[float]] = []  # per-open-phase child-time accum

    @property
    def enabled(self) -> bool:
        return self.recorder.enabled

    @contextmanager
    def phase(self, name: str, **args):
        """Record one phase span on the ``train`` track.  Aggregates are
        kept outside the ring so ``summary()`` survives ring wrap; totals
        are EXCLUSIVE time — a phase nested inside another (the prefetch
        path runs ``h2d_staging`` inside ``data_wait``'s blocking ``next``)
        attributes its duration to itself only, so phase totals never sum
        past the wall clock.  The exported spans keep the full (inclusive)
        durations — nesting renders naturally in Perfetto."""
        rec = self.recorder
        if not rec.enabled:
            yield
            return
        frame = [0.0]
        self._stack.append(frame)
        start = rec.clock()
        try:
            yield
        finally:
            end = rec.clock()
            self._stack.pop()
            dur = end - start
            rec.complete(name, "train", start, end, cat="train", **args)
            if self._stack:
                self._stack[-1][0] += dur
            self._totals[name] = self._totals.get(name, 0.0) \
                + max(0.0, dur - frame[0])
            self._counts[name] = self._counts.get(name, 0) + 1

    def summary(self) -> dict:
        """``{phase: {count, total_s, mean_s}}`` over the whole run —
        exclusive time (see :meth:`phase`); ring wrap does not lose
        aggregate time, only old span detail."""
        out = {}
        for name in sorted(self._totals):
            n = self._counts[name]
            total = self._totals[name]
            out[name] = {
                "count": n,
                "total_s": round(total, 6),
                "mean_s": round(total / n, 6) if n else 0.0,
            }
        return out

    def overhead_frac(self, wall_s: float) -> float:
        return self.recorder.overhead_frac(wall_s)

    def to_chrome_trace(self) -> dict:
        return self.recorder.to_chrome_trace()

    def write_chrome_trace(self, path) -> None:
        self.recorder.write_chrome_trace(path)

    def write_jsonl(self, path) -> None:
        self.recorder.write_jsonl(path)

    def clear(self) -> None:
        self.recorder.clear()
        self._totals.clear()
        self._counts.clear()
        self._stack.clear()
