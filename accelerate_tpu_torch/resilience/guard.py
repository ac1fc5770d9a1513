"""NaN/Inf step guard: skip the update, keep the state, count the damage
(mirrors ``accelerate_tpu/resilience/guard.py``).

When the loss or the global gradient norm of a step is non-finite, the
prepared train step drops the update: params, the optimizer's tensors and
its ``count`` stay bitwise what they were, and the skip counters advance.
The JAX step selects between the new and the old state inside its jitted
program (``select_tree``); the port's optimizer ``count`` is a host int
that keys the stochastic-rounding salts, so the port fetches the
finiteness flag (with the consecutive counter) in one host read per
guarded step and does not run the update at all.  With the guard off the
step reads nothing back.

The counters ride the ``TrainState`` (``guard_state``, two int32 0-d
tensors on the device) so they survive checkpoint and resume; the host
abort (``max_consecutive_nan_skips``) turns a persistent divergence into a
loud :class:`NanGuardAbort` instead of an endless skip loop.
"""

from __future__ import annotations

import torch

# metric keys the guarded step adds
GUARD_METRIC_KEYS = ("nan_skipped", "nan_skips", "consecutive_nan_skips")


class NanGuardAbort(RuntimeError):
    """Raised by the step wrapper after K consecutive non-finite steps.

    The params and optimizer state were held at their last finite values
    the whole time, so the newest checkpoint is clean."""


def init_guard_state(device=None) -> dict:
    """Fresh skip counters (a ``TrainState.guard_state`` value)."""
    return {
        "nan_skips": torch.zeros((), dtype=torch.int32, device=device),
        "consecutive_nan_skips": torch.zeros((), dtype=torch.int32, device=device),
    }


def step_finite(loss: torch.Tensor, gnorm: torch.Tensor) -> torch.Tensor:
    """The step's finiteness flag, a device bool: the loss and the global
    gradient norm (one NaN or Inf anywhere in the gradients makes the norm
    non-finite)."""
    return torch.isfinite(loss) & torch.isfinite(gnorm)


def update_guard_counters(guard_state: dict, finite: bool) -> dict:
    """The counters after one step whose finiteness the host has read: total
    skips accumulate, the consecutive counter resets on a finite step."""
    if finite:
        return {"nan_skips": guard_state["nan_skips"],
                "consecutive_nan_skips": torch.zeros_like(guard_state["consecutive_nan_skips"])}
    return {"nan_skips": guard_state["nan_skips"] + 1,
            "consecutive_nan_skips": guard_state["consecutive_nan_skips"] + 1}


def guard_metrics(metrics: dict, finite: bool, new_guard_state: dict) -> dict:
    """Attach the guard's keys to the step metrics (device tensors)."""
    device = new_guard_state["nan_skips"].device
    metrics["nan_skipped"] = torch.tensor(not finite, device=device)
    metrics["nan_skips"] = new_guard_state["nan_skips"]
    metrics["consecutive_nan_skips"] = new_guard_state["consecutive_nan_skips"]
    return metrics


def check_abort(consecutive: int, threshold: int) -> None:
    """Host-side abort check.  ``threshold`` <= 0 disables the abort — the
    counters keep accumulating either way."""
    if threshold and threshold > 0 and consecutive >= threshold:
        raise NanGuardAbort(
            f"{consecutive} consecutive non-finite steps (threshold "
            f"{threshold}): params/opt-state were held at their last finite "
            "values; inspect the data pipeline / loss scaling and resume "
            "from the newest checkpoint"
        )
