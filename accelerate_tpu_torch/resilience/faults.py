"""Deterministic fault injection (mirrors ``accelerate_tpu/resilience/
faults.py``: ``FaultEvent`` :153, ``FaultPlan`` :183, the hook points
:297-343).

A seeded, fully deterministic fault plan delivered through fixed hook
points in the real hot paths: the production code calls :func:`fault_point`
itself, and with no plan installed the hook is one ``None`` check.
Occurrence counting is per site and 1-based: ``FaultEvent("preempt",
at=4, site="serve_step")`` fires on the 4th engine tick, every time.
``FaultPlan.from_seed`` draws a random-but-reproducible plan from numpy's
``default_rng``, so a seed gives the JAX package's plan, spec for spec.

The port's hook sites:

========================  =====================================================
site                      kinds
========================  =====================================================
``step``                  ``preempt`` (a real ``SIGTERM`` through the installed
                          :class:`~.preemption.PreemptionHandler`) and
                          ``nan_grad`` (the incoming batch is NaN-poisoned by
                          :func:`poison_batch`, so the non-finite gradients
                          flow through the real loss and backward into the
                          NaN guard), ``straggler`` (a host stall of
                          :data:`STRAGGLER_STALL_S`) and ``rank_loss``
                          (:class:`RankLostError` from the prepared step)
``peer_snapshot``         ``partial_ckpt`` — the newest stored peer-snapshot
                          copy is torn (``resilience/peer_ckpt.py``), which
                          recovery's crc gate must skip
``transfer``              ``transfer`` — the data loader's host-to-device
                          staging (and ``LayerPrefetcher``'s) fails, inside
                          the bounded-retry wrapper
``checkpoint_io``         ``transfer`` — a checkpoint write or read fails,
                          inside its retry wrapper
``post_save``             ``corrupt_ckpt`` — the just-published checkpoint has
                          one file truncated or bit-flipped
                          (:func:`corrupt_checkpoint`), which the verified
                          load must catch
``serve_step``            ``preempt`` (drain the serving engine at a tick
                          boundary), ``prefix`` (flush the prefix index),
                          ``cancel`` (the oldest live request cancels) and
                          ``deadline`` (every live request expires; the
                          degradation ladder escalates one stage)
``verify_step``           ``preempt`` — drain mid-speculative-verify, before
                          the pass dispatches
``fleet_route``           ``replica_kill`` — the fleet router drains a
                          replica and re-routes its pending work
``adapter_transfer``      ``transfer`` — the adapter pool's host-to-device
                          staging fails, inside the bounded-retry wrapper
``adapter_memmap``        ``transfer`` — the cold-tier read fails, inside its
                          own retry wrapper
========================  =====================================================

The plan keeps every kind of the JAX package, so a plan's spec crosses
between the two, and the payloads pick the same file and the same bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..logging import get_logger
from .retry import TransientIOError

logger = get_logger(__name__)

FAULT_KINDS = ("preempt", "nan_grad", "transfer", "corrupt_ckpt", "cancel",
               "deadline", "prefix", "replica_kill", "rank_loss", "straggler",
               "partial_ckpt")

# default hook site per kind (a transfer event may override its site to
# "checkpoint_io"/"adapter_transfer"/"adapter_memmap" to target checkpoint
# I/O or the serving hot-swap path instead of the training streaming path;
# a preempt event may override its site to "serve_step"/"verify_step" to
# drain the serving engine instead of SIGTERM-ing the trainer)
KIND_DEFAULT_SITE = {
    "preempt": "step",
    "nan_grad": "step",
    "transfer": "transfer",
    "corrupt_ckpt": "post_save",
    "cancel": "serve_step",
    "deadline": "serve_step",
    # cache-invalidation storm: the serving engine flushes its prefix index
    # (every index hold drops; live slots keep their shared refcounts) —
    # future admissions miss, tokens stay bitwise (the prefix interplay leg
    # of the chaos soak pins it)
    "prefix": "serve_step",
    # fleet-replica loss: the router's per-tick hook drains the victim and
    # re-routes its pending work to the surviving replicas (exactly once)
    "replica_kill": "fleet_route",
    # training-rank loss: the prepared step raises RankLostError at the
    # boundary; the harness routes the gang through the recovery ladder
    # (peer RAM -> verified disk -> fresh, resilience/peer_ckpt.py)
    "rank_loss": "step",
    # deterministic host-side stall on this rank's step: skews the boundary
    # arrival times the agreed preemption stop must reduce over
    "straggler": "step",
    # torn peer-snapshot stream: the receiver's stored copy of the wave is
    # corrupted; the crc gate skips it on restore
    "partial_ckpt": "peer_snapshot",
}

CORRUPTION_MODES = ("truncate", "bitflip")


class InjectedTransferError(TransientIOError):
    """The fault plan's transient transfer failure (retryable by design)."""


class RankLostError(RuntimeError):
    """An injected ``rank_loss`` fault: this rank's training state is gone.

    Raised by the prepared step at the boundary the plan names, and not
    retryable: the caller routes the gang through the recovery ladder
    (:meth:`~accelerate_tpu_torch.Accelerator.recover`): the lost rank's
    newest snapshot lives in its buddy's host RAM, and the whole gang rolls
    back to the newest wave every rank can restore."""


# the deterministic host stall a ``straggler`` fault injects (seconds):
# long enough to skew the ranks' arrival at a step boundary, short enough
# for a test
STRAGGLER_STALL_S = 0.25


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``at`` is the 1-based occurrence index of the hook site this event arms;
    ``count`` extends it over consecutive occurrences (a ``transfer`` event
    with ``count=2`` fails two attempts in a row — one past the default
    retry budget's first re-attempt, still within the bounded budget);
    ``mode`` selects the corruption flavor for ``corrupt_ckpt``.
    """

    kind: str
    at: int = 1
    count: int = 1
    mode: str = "truncate"
    site: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; options: {FAULT_KINDS}")
        if self.at < 1 or self.count < 1:
            raise ValueError(f"at/count must be >= 1 (got at={self.at}, count={self.count})")
        if self.kind == "corrupt_ckpt" and self.mode not in CORRUPTION_MODES:
            raise ValueError(f"unknown corruption mode {self.mode!r}; options: {CORRUPTION_MODES}")
        if not self.site:
            object.__setattr__(self, "site", KIND_DEFAULT_SITE[self.kind])

    def covers(self, occurrence: int) -> bool:
        return self.at <= occurrence < self.at + self.count


class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent`\\ s.

    Install with :func:`install_fault_plan` / the :func:`fault_plan` context
    manager, or ship it to a subprocess as JSON through the
    ``ACCELERATE_FAULT_PLAN`` environment variable (:meth:`from_env` reads
    it).  ``fired`` records every delivered event — the test-side audit
    trail.
    """

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0):
        self.events = tuple(events)
        self.seed = int(seed)
        self._occurrences: dict[str, int] = defaultdict(int)
        self.fired: list[tuple[str, int, FaultEvent]] = []

    def fire(self, site: str) -> tuple[FaultEvent, ...]:
        """Advance ``site``'s occurrence counter and return the events armed
        for this occurrence (usually empty)."""
        self._occurrences[site] += 1
        occ = self._occurrences[site]
        hits = tuple(e for e in self.events if e.site == site and e.covers(occ))
        for e in hits:
            self.fired.append((site, occ, e))
            logger.warning("fault injection: %s fires at %s occurrence %d", e.kind, site, occ)
        return hits

    def occurrences(self, site: str) -> int:
        return self._occurrences[site]

    # -- construction --------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: dict) -> "FaultPlan":
        """Build from the JSON shape ``{"seed": 0, "events": [{"kind": ...,
        "at": ..., "count": ..., "mode": ..., "site": ...}, ...]}``."""
        events = [
            FaultEvent(
                kind=d["kind"], at=int(d.get("at", 1)), count=int(d.get("count", 1)),
                mode=d.get("mode", "truncate"), site=d.get("site", ""),
            )
            for d in spec.get("events", [])
        ]
        return cls(events, seed=int(spec.get("seed", 0)))

    @classmethod
    def from_env(cls, var: str = "ACCELERATE_FAULT_PLAN") -> Optional["FaultPlan"]:
        raw = os.environ.get(var)
        if not raw:
            return None
        return cls.from_spec(json.loads(raw))

    @classmethod
    def from_seed(
        cls, seed: int, n_steps: int, *,
        p_preempt: float = 0.0, p_nan: float = 0.0,
        p_transfer: float = 0.0, p_corrupt: float = 0.0,
        p_cancel: float = 0.0, p_deadline: float = 0.0,
        serving: bool = False,
    ) -> "FaultPlan":
        """A random-but-reproducible plan: each step draws each enabled fault
        kind independently at its probability.  Same seed → same plan,
        always — the soak-test entry point.

        ``serving=True`` targets the serving sites: ``preempt`` lands at
        ``serve_step`` (the chaos-replay drain-and-restart loop absorbs it,
        so later events stay armed), ``transfer`` at ``adapter_transfer``,
        and the ``cancel``/``deadline`` storms draw at their probabilities
        (their default site is already ``serve_step``)."""
        rng = np.random.default_rng(seed)
        events = []
        for step in range(1, n_steps + 1):
            if p_preempt and rng.random() < p_preempt:
                events.append(FaultEvent(
                    "preempt", at=step,
                    site="serve_step" if serving else "",
                ))
                if not serving:
                    break  # a training preemption ends the process; a
                    # serving drain restarts — later events stay armed
            if p_nan and rng.random() < p_nan:
                events.append(FaultEvent("nan_grad", at=step))
            if p_transfer and rng.random() < p_transfer:
                events.append(FaultEvent(
                    "transfer", at=step,
                    site="adapter_transfer" if serving else "",
                ))
            if p_corrupt and rng.random() < p_corrupt:
                events.append(FaultEvent("corrupt_ckpt", at=step,
                                         mode=CORRUPTION_MODES[int(rng.integers(2))]))
            if p_cancel and rng.random() < p_cancel:
                events.append(FaultEvent("cancel", at=step))
            if p_deadline and rng.random() < p_deadline:
                events.append(FaultEvent("deadline", at=step))
        return cls(events, seed=seed)

    def to_spec(self) -> dict:
        return {
            "seed": self.seed,
            "events": [dataclasses.asdict(e) for e in self.events],
        }

    def __repr__(self):
        return f"FaultPlan(seed={self.seed}, events={list(self.events)!r})"


# ---------------------------------------------------------------------------
# the ambient plan + hook points (what the production code calls)
# ---------------------------------------------------------------------------


_ACTIVE_PLAN: Optional[FaultPlan] = None


def install_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the process-wide active plan (``None`` disarms);
    returns the previous plan so callers can restore it."""
    global _ACTIVE_PLAN
    previous = _ACTIVE_PLAN
    _ACTIVE_PLAN = plan
    return previous


def active_fault_plan() -> Optional[FaultPlan]:
    return _ACTIVE_PLAN


@contextlib.contextmanager
def fault_plan(plan: Optional[FaultPlan]):
    """Scope a plan to a ``with`` block (tests; restores the previous plan)."""
    previous = install_fault_plan(plan)
    try:
        yield plan
    finally:
        install_fault_plan(previous)


def fault_point(site: str) -> tuple[FaultEvent, ...]:
    """The hook the real hot paths call.  With no plan installed this is one
    global-read + ``None`` check — cheap enough for per-step/per-batch
    placement."""
    if _ACTIVE_PLAN is None:
        return ()
    return _ACTIVE_PLAN.fire(site)


def maybe_fail_transfer(site: str = "transfer") -> None:
    """Raise :class:`InjectedTransferError` when the plan arms a ``transfer``
    fault for this occurrence of ``site`` — called at the top of each
    host-transfer attempt, *inside* the retry wrapper, so every injected
    failure exercises the real backoff path."""
    for e in fault_point(site):
        if e.kind == "transfer":
            raise InjectedTransferError(
                f"injected transient transfer failure at {site} "
                f"(occurrence {_ACTIVE_PLAN.occurrences(site)})"
            )


# ---------------------------------------------------------------------------
# fault payloads
# ---------------------------------------------------------------------------


def poison_batch(batch):
    """NaN-fill every floating leaf of ``batch`` (tensors and numpy arrays in
    nested dicts, lists and tuples); integer leaves — token ids, masks —
    pass through untouched.

    This is how ``nan_grad`` faults enter the step: the poisoned batch flows
    through the real loss and backward into the guard, so the skip is
    tested against genuine non-finite gradients."""
    if isinstance(batch, torch.Tensor):
        return torch.full_like(batch, float("nan")) if batch.is_floating_point() else batch
    if isinstance(batch, np.ndarray):
        return np.full_like(batch, np.nan) if np.issubdtype(batch.dtype, np.inexact) else batch
    if isinstance(batch, dict):
        return type(batch)((k, poison_batch(v)) for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return type(batch)(poison_batch(v) for v in batch)
    return batch


def corrupt_checkpoint(ckpt_dir, mode: str = "truncate", seed: int = 0) -> str:
    """Deterministically corrupt one data file of a written checkpoint —
    the torn-write (``truncate``) / bit-rot (``bitflip``) simulation that
    ``checkpointing.verify_checkpoint`` must catch.  Prefers a train-state
    file; the choice and the flipped byte are drawn from
    ``default_rng(seed)`` over the sorted candidates, as in the JAX
    package.  Returns the corrupted file's path."""
    from ..utils.constants import CHECKPOINT_MANIFEST_NAME, TRAIN_STATE_DIR

    if mode not in CORRUPTION_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}; options: {CORRUPTION_MODES}")
    root = Path(ckpt_dir)
    files = sorted(
        p for p in root.rglob("*")
        if p.is_file() and p.name != CHECKPOINT_MANIFEST_NAME and p.stat().st_size > 0
    )
    if not files:
        raise FileNotFoundError(f"no corruptible files under {root}")
    shard_files = [p for p in files if TRAIN_STATE_DIR in p.parts]
    candidates = shard_files or files
    rng = np.random.default_rng(seed)
    target = candidates[int(rng.integers(len(candidates)))]
    size = target.stat().st_size
    if mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(size // 2)
    else:  # bitflip: one byte, in place (a checkpoint file may be gigabytes)
        pos = int(rng.integers(size))
        with open(target, "r+b") as f:
            f.seek(pos)
            byte = f.read(1)[0]
            f.seek(pos)
            f.write(bytes([byte ^ 0xFF]))
    logger.warning("fault injection: corrupted %s (%s)", target, mode)
    return str(target)
