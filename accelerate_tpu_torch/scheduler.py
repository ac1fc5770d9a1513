"""Learning-rate schedule wrapper (mirrors ``accelerate_tpu/scheduler.py``,
``AcceleratedScheduler`` :25).

A schedule is a plain callable ``step -> lr``.  As optax's schedules are
functions of the optimizer's own update count, a prepared schedule drives
the update itself: before each optimizer update the prepared train step
writes ``schedule(count)`` (``count`` = the updates made so far) into the
optimizer state's ``hyperparams["lr"]``, the f32 0-d tensor the
stochastic-rounding recipes read their learning rate from.  This wrapper
keeps the reference's counting for code that reads the learning rate or
steps the scheduler itself:

- steps count only when the optimizer stepped (an accumulation boundary),
  unless the schedule is stepped independently of the optimizer;
- ``split_batches=False`` advances ``num_processes`` steps per call (one
  process here).
"""

from __future__ import annotations

from typing import Callable, Optional

from .state import GradientState


class AcceleratedScheduler:
    """Wraps a schedule callable ``step -> lr``."""

    def __init__(self, schedule: Callable[[int], float], optimizer=None,
                 step_with_optimizer: bool = True, split_batches: bool = False,
                 gradient_state: Optional[GradientState] = None, num_processes: int = 1):
        if not callable(schedule):
            raise TypeError(f"AcceleratedScheduler expects a schedule callable, got {type(schedule)}")
        self.schedule = schedule
        self.optimizer = optimizer
        self.step_with_optimizer = step_with_optimizer
        self.split_batches = split_batches
        self.gradient_state = gradient_state or GradientState()
        self.num_processes = num_processes
        self._step_count = 0

    def step(self, *args, **kwargs):
        if not self.step_with_optimizer:
            self._step_count += 1
            return
        if not self.gradient_state.sync_gradients and self.gradient_state.adjust_scheduler:
            # mid-accumulation: the schedule holds
            return
        self._step_count += 1 if self.split_batches else self.num_processes

    def get_last_lr(self):
        return [float(self.schedule(max(self._step_count - 1, 0)))]

    def get_lr(self):
        return [float(self.schedule(self._step_count))]

    def state_dict(self):
        return {"step_count": self._step_count}

    def load_state_dict(self, state_dict):
        self._step_count = state_dict.get("step_count", 0)

    def __repr__(self):
        return f"AcceleratedScheduler(schedule={self.schedule}, step={self._step_count})"
