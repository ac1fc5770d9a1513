"""Goodput accounting: how much of the wall clock became training progress
(the port's own copy of ``accelerate_tpu/resilience/goodput.py``, which
imports no JAX; the counters equal the JAX package's for the same events).

"Goodput" (CheckFreq's framing) is the fraction of run time that produced
*retained* training steps — what's left after subtracting steps replayed
because the newest checkpoint predated the crash, steps skipped by the NaN
guard, restart overheads, and checkpoint stalls.  Like the streaming
overlap accounting (``ops/streaming.py`` ``StreamStats`` /
``offload_transfer_accounting``), it comes in a **measured** and a
**predicted** flavor:

- :class:`GoodputTracker` — the measured twin, owned by every
  ``Accelerator`` (``accelerator.goodput``): step/skip/restart/retry
  counters fed by the step wrapper, the guard, ``maybe_resume`` and the
  retry sites (zeros / 1.0 when the run was clean).
- :func:`goodput_accounting` — the predicted model: first-order CheckFreq
  arithmetic over step time, checkpoint cadence/cost, and a Poisson
  preemption rate, for sizing checkpoint intervals before burning chips.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class GoodputTracker:
    """Measured resilience counters for one process's run.

    ``steps`` counts *executed* prepared-step calls (replays included);
    ``steps_recomputed`` is the replayed share a resume reports (known when
    the resume point and the prior progress are both known — the fault
    matrix tests and the dryrun leg pass it explicitly); ``time_lost_s``
    accumulates restart/drain overheads.  ``goodput_frac`` multiplies the
    step-retention fraction by the time-retention fraction — 1.0 for a
    clean run, degrading with every skip, replay, and restart.
    """

    steps: int = 0
    nan_skips: int = 0
    restarts: int = 0
    preemptions: int = 0
    steps_recomputed: int = 0
    time_lost_s: float = 0.0
    io_retries: int = 0
    transfer_retries: int = 0
    started_at: float = dataclasses.field(default_factory=time.monotonic)

    # -- feeders (step wrapper / guard / resume / retry sites) --------------

    def record_step(self) -> None:
        self.steps += 1

    def record_nan_skip(self, n: int = 1) -> None:
        self.nan_skips += n

    def record_preemption(self) -> None:
        self.preemptions += 1

    def record_restart(self, steps_recomputed: int = 0, time_lost_s: float = 0.0) -> None:
        self.restarts += 1
        self.steps_recomputed += int(steps_recomputed)
        self.time_lost_s += float(time_lost_s)

    def record_retry(self, site: str, attempt: int, exc: BaseException) -> None:
        """``with_retries`` ``on_retry`` adapter: checkpoint sites count as
        I/O retries, everything else as transfer retries."""
        if "checkpoint" in site:
            self.io_retries += 1
        else:
            self.transfer_retries += 1

    # -- persistence (save_accelerator_state rides this through METADATA) ---

    _PERSISTED = ("steps", "nan_skips", "restarts", "preemptions",
                  "steps_recomputed", "time_lost_s", "io_retries",
                  "transfer_retries")

    def state_dict(self) -> dict:
        """Counters only — ``started_at`` stays per-incarnation on purpose:
        ``goodput_frac``'s time fraction measures THIS process's wall clock,
        while the step/skip/restart counters span the whole run across
        restarts (so ``goodput.goodput_frac`` reflects the replayed work a
        preemption cost, not just the post-resume slice)."""
        return {k: getattr(self, k) for k in self._PERSISTED}

    def load_state_dict(self, sd: dict) -> None:
        for k in self._PERSISTED:
            if k in sd:
                setattr(self, k, type(getattr(self, k))(sd[k]))

    # -- reductions ---------------------------------------------------------

    def goodput_frac(self) -> float:
        elapsed = max(time.monotonic() - self.started_at, 1e-9)
        if self.steps > 0:
            wasted = min(self.steps, self.nan_skips + self.steps_recomputed)
            step_frac = (self.steps - wasted) / self.steps
        else:
            step_frac = 1.0
        time_frac = max(0.0, 1.0 - self.time_lost_s / elapsed)
        return max(0.0, min(1.0, step_frac * time_frac))

    def report(self) -> dict:
        """The JSON-able digest (``kind: "measured"`` — the
        predicted counterpart is :func:`goodput_accounting`).  Also records
        the MEASURED side of the ``goodput.goodput_frac`` twin
        (telemetry/twins.py)."""
        from ..telemetry import twin_registry

        twin_registry().record_measured(
            "goodput.goodput_frac", self.goodput_frac(),
            source="resilience/goodput.GoodputTracker",
        )
        return {
            "steps": self.steps,
            "nan_skips": self.nan_skips,
            "restarts": self.restarts,
            "preemptions": self.preemptions,
            "steps_recomputed": self.steps_recomputed,
            "time_lost_s": round(self.time_lost_s, 3),
            "io_retries": self.io_retries,
            "transfer_retries": self.transfer_retries,
            "goodput_frac": round(self.goodput_frac(), 4),
            "kind": "measured",
        }


def goodput_accounting(
    step_time_s: float,
    ckpt_interval_steps: int,
    *,
    save_overhead_s: float = 0.0,
    preemption_rate_per_hour: float = 0.0,
    restart_overhead_s: float = 60.0,
) -> dict:
    """Predicted goodput of periodic-checkpoint training under a Poisson
    preemption process (CheckFreq's first-order model).

    Per preemption the run loses on average half a checkpoint interval of
    steps (uniform arrival within the interval) plus the restart overhead;
    checkpointing itself taxes every interval by ``save_overhead_s`` (≈0
    for async saves — the snapshot is the only synchronous part).  The
    returned ``goodput_frac`` is what survives both taxes; sweeping
    ``ckpt_interval_steps`` against a provider's measured preemption rate
    finds the CheckFreq-optimal cadence without burning a single chip-hour.
    """
    if step_time_s <= 0 or ckpt_interval_steps <= 0:
        raise ValueError("step_time_s and ckpt_interval_steps must be positive")
    interval_s = step_time_s * ckpt_interval_steps
    ckpt_overhead_frac = save_overhead_s / interval_s
    rate_per_s = preemption_rate_per_hour / 3600.0
    lost_s_per_preemption = interval_s / 2.0 + restart_overhead_s
    lost_frac = min(1.0, rate_per_s * lost_s_per_preemption)
    goodput = max(0.0, (1.0 - lost_frac) / (1.0 + ckpt_overhead_frac))
    from ..telemetry import twin_registry

    twin_registry().record_predicted(
        "goodput.goodput_frac", goodput,
        source="resilience/goodput.goodput_accounting",
    )
    return {
        "step_time_s": step_time_s,
        "ckpt_interval_steps": ckpt_interval_steps,
        "ckpt_overhead_frac": round(ckpt_overhead_frac, 4),
        "lost_frac_per_preemption_window": round(lost_frac, 4),
        "goodput_frac": round(goodput, 4),
        "kind": "predicted",
    }
