"""Step-scheduled profiling on ``torch.profiler`` (mirrors
``accelerate_tpu/utils/profiler.py``: ``_Schedule`` :37, ``TPUProfiler``
:62), the engine behind ``Accelerator.profile``.

- The **trace window** is a ``torch.profiler.profile`` (CPU activity, and
  CUDA's when there is a card) around exactly the ``active`` steps of each
  wait / warmup / active cycle; the warmup steps run untraced, as in JAX.
  At the window's end its Chrome trace is written to
  ``<dir>/trace.json`` (cycle 0 writes into ``output_trace_dir`` itself,
  cycle ``i > 0`` into ``<dir>/cycle_<i>``) and ``on_trace_ready(dir)``
  runs.
- ``profile_memory``: the card's allocator counters
  (``utils/memory.get_device_memory_stats``) at the window's edges: bytes
  in use, their change over the window, the peak and the card's limit.
- ``with_flops``: the profiler counts the FLOPs of the matmuls and
  convolutions it sees (``with_flops=True``); each traced window's sum is
  added to ``summary['flops']``, as is each
  :meth:`CUDAProfiler.flops_estimate` (which profiles one call on its own,
  outside a traced window).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch

from .memory import get_device_memory_stats


@dataclass
class _Schedule:
    """Position arithmetic of the wait / warmup / active / repeat cycle."""

    wait: int
    warmup: int
    active: int
    repeat: int  # 0 = cycle forever

    @property
    def cycle_len(self) -> int:
        return max(1, self.wait + self.warmup + self.active)

    def locate(self, step: int) -> tuple[int, str]:
        """(cycle index, phase) of a global step; phase in {'wait',
        'warmup', 'active', 'done'}."""
        cycle, pos = divmod(step, self.cycle_len)
        if self.repeat and cycle >= self.repeat:
            return cycle, "done"
        if pos < self.wait:
            return cycle, "wait"
        if pos < self.wait + self.warmup:
            return cycle, "warmup"
        return cycle, "active"


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(trace_dir: str, *, with_flops: bool = False):
    """Make ``trace_dir`` (so a path that cannot be written fails before
    the traced steps run, as ``jax.profiler.start_trace`` does) and open a
    ``torch.profiler.profile`` window; returns it."""
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities(), with_flops=with_flops)
    prof.__enter__()
    return prof


def stop_trace(prof, trace_dir: str) -> None:
    """Close the window (the card's queued work is waited for first, so
    its kernels land in the trace) and write ``<trace_dir>/trace.json``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _window_flops(prof) -> float:
    return float(sum(getattr(e, "flops", 0) or 0 for e in prof.key_averages()))


class CUDAProfiler:
    """Yielded by ``Accelerator.profile``; call :meth:`step` once per
    training step (``torch.profiler.profile.step()``'s role).  Without
    ``step()`` calls, or with a ``ProfileKwargs`` that declares no
    schedule, the whole ``with`` block is one window."""

    def __init__(self, handler):
        self._handler = handler
        self._no_schedule = not handler.has_schedule()
        self._schedule = _Schedule(wait=handler.wait, warmup=handler.warmup,
                                   active=max(1, handler.active or 1), repeat=handler.repeat)
        self.step_num = 0
        self._tracing_cycle: Optional[int] = None
        self._prof = None
        self._last_prof = None
        self._mem_at_start: Optional[dict] = None
        self.summary: dict[str, Any] = {"traced_steps": [], "cycles": 0}
        if handler.with_flops:
            self.summary["flops"] = 0.0
        self._stepped = False

    def _cycle_dir(self, cycle: int) -> Optional[str]:
        base = self._handler.output_trace_dir
        if base is None:
            return None
        return base if cycle == 0 else os.path.join(base, f"cycle_{cycle}")

    def _open_window(self, cycle: int) -> None:
        trace_dir = self._cycle_dir(cycle)
        if trace_dir is not None:
            self._prof = start_trace(trace_dir, with_flops=self._handler.with_flops)
        if self._handler.profile_memory:
            self._mem_at_start = get_device_memory_stats()
        self._tracing_cycle = cycle

    def _close_window(self) -> None:
        cycle, self._tracing_cycle = self._tracing_cycle, None
        trace_dir = self._cycle_dir(cycle)
        if self._prof is not None:
            prof, self._prof = self._prof, None
            stop_trace(prof, trace_dir)
            self._last_prof = prof
            if self._handler.with_flops:
                self.summary["flops"] += _window_flops(prof)
        if self._handler.profile_memory:
            end = get_device_memory_stats()
            start = self._mem_at_start or {}
            self.summary["memory"] = {
                "bytes_in_use": end["bytes_in_use"],
                "bytes_delta": end["bytes_in_use"] - start.get("bytes_in_use", 0),
                "peak_bytes_in_use": end["peak_bytes_in_use"],
                "bytes_limit": end["bytes_limit"],
            }
        self.summary["cycles"] += 1
        if self._handler.on_trace_ready is not None and trace_dir is not None:
            self._handler.on_trace_ready(trace_dir)

    def step(self) -> None:
        """Advance the schedule by one training step, opening or closing
        the window at the phase edges."""
        self._stepped = True
        in_active = self._tracing_cycle is not None
        if in_active:
            self.summary["traced_steps"].append(self.step_num)
        self.step_num += 1
        if self._no_schedule:
            return
        cycle, phase = self._schedule.locate(self.step_num)
        if in_active and (phase != "active" or cycle != self._tracing_cycle):
            self._close_window()
            in_active = False
        if not in_active and phase == "active":
            self._open_window(cycle)

    def key_averages(self):
        """The last closed window's ``torch.profiler`` table
        (``key_averages()``: per-op counts, CPU and device times, FLOPs).
        Call after the window has closed."""
        if self._last_prof is None:
            raise ValueError("key_averages needs a closed trace window (output_trace_dir "
                             "set, and a window that ran)")
        return self._last_prof.key_averages()

    def flops_estimate(self, fn, *args, **kwargs) -> float:
        """FLOPs of one call of ``fn`` at these arguments, as
        ``torch.profiler`` counts them (matmuls and convolutions); added to
        ``summary['flops']`` when ``with_flops`` is set.  Not inside an
        open trace window: torch runs one profiler at a time."""
        if self._prof is not None:
            raise ValueError("flops_estimate runs its own profiler: call it outside the "
                             "traced window")
        with torch.profiler.profile(activities=_activities(), with_flops=True) as prof:
            fn(*args, **kwargs)
        flops = _window_flops(prof)
        if "flops" in self.summary:
            self.summary["flops"] += flops
        return flops

    def _enter(self):
        cycle, phase = self._schedule.locate(0)
        if phase == "active":
            self._open_window(cycle)
        return self

    def _exit(self):
        if self._tracing_cycle is not None:
            if not self._stepped:
                self.summary["traced_steps"].append(self.step_num)
            self._close_window()
