"""Resilience of the port (mirrors ``accelerate_tpu/resilience/``): the
bounded retry of host I/O (:mod:`.retry`) and the deterministic fault plans
(:mod:`.faults`).  Preemption, the NaN guard, goodput and the recovery
ladder are ROADMAP item A14.
"""

from .faults import (
    FaultEvent,
    FaultPlan,
    InjectedTransferError,
    RankLostError,
    active_fault_plan,
    fault_plan,
    fault_point,
    install_fault_plan,
    maybe_fail_transfer,
)
from .retry import DEFAULT_POLICY, RetryPolicy, TransientIOError, with_retries

__all__ = [
    "DEFAULT_POLICY",
    "FaultEvent",
    "FaultPlan",
    "InjectedTransferError",
    "RankLostError",
    "RetryPolicy",
    "TransientIOError",
    "active_fault_plan",
    "fault_plan",
    "fault_point",
    "install_fault_plan",
    "maybe_fail_transfer",
    "with_retries",
]
