"""Resilience of the port (mirrors ``accelerate_tpu/resilience/``): the
bounded retry of host I/O (:mod:`.retry`), the deterministic fault plans
and their payloads (:mod:`.faults`), graceful preemption
(:mod:`.preemption`), the NaN guard (:mod:`.guard`), goodput accounting
(:mod:`.goodput`) and the buddy-rank host-RAM snapshots of the recovery
ladder (:mod:`.peer_ckpt`).
"""

from .faults import (
    CORRUPTION_MODES,
    FAULT_KINDS,
    STRAGGLER_STALL_S,
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
from .peer_ckpt import (
    HostSnapshot,
    PeerSchemaError,
    PeerSnapshotCorruptError,
    PeerSnapshotter,
    capture_host_snapshot,
    check_snapshot_schemas,
    peer_ckpt_accounting,
    restore_host_snapshot,
    snapshot_schema,
)
from .preemption import RESUME_EXIT_CODE, PreemptionHandler
from .retry import DEFAULT_POLICY, RetryPolicy, TransientIOError, with_retries

__all__ = [
    "CORRUPTION_MODES",
    "DEFAULT_POLICY",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "GoodputTracker",
    "HostSnapshot",
    "InjectedTransferError",
    "NanGuardAbort",
    "PeerSchemaError",
    "PeerSnapshotCorruptError",
    "PeerSnapshotter",
    "PreemptionHandler",
    "RESUME_EXIT_CODE",
    "RankLostError",
    "RetryPolicy",
    "STRAGGLER_STALL_S",
    "TransientIOError",
    "active_fault_plan",
    "capture_host_snapshot",
    "check_snapshot_schemas",
    "corrupt_checkpoint",
    "fault_plan",
    "fault_point",
    "goodput_accounting",
    "init_guard_state",
    "install_fault_plan",
    "maybe_fail_transfer",
    "peer_ckpt_accounting",
    "poison_batch",
    "restore_host_snapshot",
    "snapshot_schema",
    "with_retries",
]
