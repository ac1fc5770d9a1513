"""Test helpers of the port (the twin of ``accelerate_tpu/test_utils/``):
``gang.run_gang`` launches a gloo world of CPU processes running a worker
function of ``test_utils/scripts``."""

from pathlib import Path


def train_fabric_script_path() -> Path:
    """Path to the two-process training chaos harness (the agreed
    preemption stop at mismatched boundaries, rank-loss recovery through
    the peer-RAM and disk ladder, torn peer snapshots): a ``run_gang``
    worker, ``train_fabric:fabric``."""
    return Path(__file__).parent / "scripts" / "train_fabric.py"


def fleet_fabric_script_path() -> Path:
    """Path to the two-process disaggregated serving fabric (the prefill
    role on rank 0 streams KV pages to the decode role on rank 1 across the
    process boundary, then the fleet-router smoke): a ``run_gang`` worker,
    ``fleet_fabric:fabric``."""
    return Path(__file__).parent / "scripts" / "fleet_fabric.py"
