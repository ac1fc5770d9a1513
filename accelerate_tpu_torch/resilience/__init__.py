"""Resilience of the port (mirrors ``accelerate_tpu/resilience/``): the
bounded retry of host I/O (:mod:`.retry`), the deterministic fault plans
and their payloads (:mod:`.faults`), graceful preemption
(:mod:`.preemption`), the NaN guard (:mod:`.guard`) and goodput accounting
(:mod:`.goodput`).  The peer snapshots and the recovery ladder need ranks:
ROADMAP item A13.
"""

from .faults import (
    CORRUPTION_MODES,
    FAULT_KINDS,
    FaultEvent,
    FaultPlan,
    InjectedTransferError,
    RankLostError,
    active_fault_plan,
    corrupt_checkpoint,
    fault_plan,
    fault_point,
    install_fault_plan,
    maybe_fail_transfer,
    poison_batch,
)
from .goodput import GoodputTracker, goodput_accounting
from .guard import NanGuardAbort, init_guard_state
from .preemption import RESUME_EXIT_CODE, PreemptionHandler
from .retry import DEFAULT_POLICY, RetryPolicy, TransientIOError, with_retries

__all__ = [
    "CORRUPTION_MODES",
    "DEFAULT_POLICY",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "GoodputTracker",
    "InjectedTransferError",
    "NanGuardAbort",
    "PreemptionHandler",
    "RESUME_EXIT_CODE",
    "RankLostError",
    "RetryPolicy",
    "TransientIOError",
    "active_fault_plan",
    "corrupt_checkpoint",
    "fault_plan",
    "fault_point",
    "goodput_accounting",
    "init_guard_state",
    "install_fault_plan",
    "maybe_fail_transfer",
    "poison_batch",
    "with_retries",
]
