"""Two-process training chaos harness: the recovery ladder under real faults
(mirrors ``accelerate_tpu/test_utils/scripts/train_fabric.py``).

A gang worker (``test_utils/gang.run_gang``, a gloo world of 2 CPU
processes, mesh ``dcn 2``, NO_SHARD, so the hierarchical step runs) that
drives a tiny deterministic MLP through three stories; rank 0 returns the
verdicts:

``chaos`` (three passes against a clean reference pass):
  A. ``rank_loss`` at step 7 with peer snapshots every 2 steps and a disk
     checkpoint at step 4: recovery takes the **peer-RAM** rung (wave 6,
     held in the buddy's host RAM), replays no step, and the losses go on
     bitwise equal to the uninterrupted run's.
  B. ``partial_ckpt`` tears the wave-6 peer copies, then ``rank_loss`` at
     7: the crc gate drops the torn wave and the gang agrees on wave 4
     (still peer, still bitwise).
  C. ``rank_loss`` at 3 with peer snapshots disarmed: the ladder falls
     through to the newest **verified disk** checkpoint (step 2), bitwise.

``preempt``: a ``straggler`` stall on rank 0 and a real SIGTERM on rank 1 at
the same step, the most mismatched arrival at the boundary: the agreed stop
drains both ranks at one step and writes ONE emergency checkpoint; both
processes exit with the resume code (75) and return nothing.

``resume``: a new gang over the ``preempt`` project: the resume point, the
continued losses and the uninterrupted reference's (the caller holds them
bitwise).

The JAX harness's ``compiles_*`` fields have no eager meaning and are not
ported.  Run it as ``run_gang("accelerate_tpu_torch.test_utils.scripts.
train_fabric:fabric", 2, gang_dir, mode=..., project_dir=...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .data_parallel_checks import sgd


def _loss(p, b):
    h = torch.relu(b["x"] @ p["w1"])
    return torch.mean(((h @ p["w2"])[:, 0] - b["y"]) ** 2)


def _build(work: str, peer_every: int):
    from ...accelerator import Accelerator
    from ...parallelism_config import ParallelismConfig
    from ...resilience.peer_ckpt import capture_host_snapshot, restore_host_snapshot
    from ...utils.dataclasses import (
        FullyShardedDataParallelPlugin,
        ProjectConfiguration,
        ResiliencePlugin,
    )

    acc = Accelerator(
        cpu=True,
        parallelism_config=ParallelismConfig(dcn_size=2, dp_shard_size=-1),
        fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD"),
        resilience_plugin=ResiliencePlugin(handle_preemption=True, nan_guard=False,
                                           peer_snapshot_every=peer_every),
        project_config=ProjectConfiguration(project_dir=work, automatic_checkpoint_naming=True),
    )
    rng = np.random.default_rng(0)
    params = {"w1": torch.from_numpy((rng.normal(size=(8, 16)) * 0.3).astype(np.float32)),
              "w2": torch.from_numpy((rng.normal(size=(16, 1)) * 0.3).astype(np.float32))}
    state0 = acc.create_train_state(params, sgd(0.05))
    # each pass starts from the same state: a host copy of it, restored
    init_snap = capture_host_snapshot(state0)

    def fresh_state():
        return restore_host_snapshot(init_snap, state0)

    return acc, fresh_state, acc.prepare_train_step(_loss)


def _batches(acc, steps: int) -> list:
    """The deterministic global stream, each rank's rows of it."""
    from ...data_loader import shard_global_batch

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    out = []
    for _ in range(steps):
        x = rng.normal(size=(16, 8)).astype(np.float32)
        b = {"x": torch.from_numpy(x), "y": torch.from_numpy((x @ w_true).astype(np.float32))}
        spec = acc.parallelism_config.batch_spec(seq_axis=None, ndim=2)
        out.append(shard_global_batch(b, acc.mesh, spec))
    return out


def _install(events) -> None:
    from ...resilience.faults import FaultPlan, install_fault_plan

    install_fault_plan(FaultPlan(events) if events else None)


def _chaos(acc, fresh_state, step, batches, peer_every: int) -> dict:
    from ...resilience import RankLostError
    from ...resilience.faults import FaultEvent
    from ...resilience.peer_ckpt import peer_ckpt_accounting

    victim = 1 if acc.num_processes > 1 else 0
    # the reference pass: uninterrupted, snapshots armed
    state = fresh_state()
    ref = []
    for b in batches:
        state, m = step(state, b)
        ref.append(m["loss"].item())
    predicted = peer_ckpt_accounting(state)["snapshot_bytes"]
    measured = acc.peer_snapshotter.local[-1].nbytes

    def run_pass(plan, disk_save_at, peer_armed=True):
        """A faulted pass: the plan on BOTH ranks (the gang notices a lost
        rank together), recovery on RankLostError, the rest of the stream."""
        acc.peer_snapshotter.reset()
        acc.resilience_plugin.peer_snapshot_every = peer_every if peer_armed else 0
        acc.step_count = 0
        _install(plan)
        state = fresh_state()
        losses, report, prefix, i = [], None, 0, 0
        while i < len(batches):
            try:
                out_state, m = step(state, batches[i])
            except RankLostError:
                prefix = len(losses)
                state, report = acc.recover(train_state=state,
                                            lost_local=acc.process_index == victim,
                                            load_sampler_states=False)
                assert state is not None, "recovery fell through to fresh"
                i = acc.step_count
                continue
            state = out_state
            losses.append(m["loss"].item())
            i += 1
            if disk_save_at is not None and i == disk_save_at:
                acc.save_state(train_state=state)
        _install(None)
        assert report is not None, "the fault plan never fired"
        expect = ref[:prefix] + ref[report["restored_step"]:]
        return {"restore_path": report["restore_path"],
                "restored_step": report["restored_step"],
                "steps_recomputed": report["steps_recomputed"],
                "peer_snapshot_bytes": report["peer_snapshot_bytes"],
                "parity": losses == expect}

    a = run_pass([FaultEvent("rank_loss", at=7)], disk_save_at=4)
    b = run_pass([FaultEvent("partial_ckpt", at=3), FaultEvent("rank_loss", at=7)],
                 disk_save_at=None)
    c = run_pass([FaultEvent("rank_loss", at=3)], disk_save_at=2, peer_armed=False)
    acc.resilience_plugin.peer_snapshot_every = peer_every
    return {"mode": "chaos", "ref_losses": ref, "predicted_bytes": predicted,
            "measured_bytes": measured, "pass_a": a, "pass_b": b, "pass_c": c,
            "disk_step_a": 4, "num_processes": acc.num_processes,
            "goodput": acc.goodput.state_dict()}


def _preempt(acc, fresh_state, step, batches, preempt_at: int) -> dict:
    from ...resilience.faults import FaultEvent

    # rank 0 stalls, rank 1 gets a real SIGTERM: the agreed stop drains both
    _install([FaultEvent("straggler" if acc.process_index == 0 else "preempt", at=preempt_at)])
    state = fresh_state()
    for b in batches:
        state, _ = step(state, b)
    # not reached in a world of several processes: the agreed stop exits 75
    return {"mode": "preempt", "completed": acc.step_count,
            "num_processes": acc.num_processes}


def _resume(acc, fresh_state, step, batches) -> dict:
    state = fresh_state()
    restored = acc.maybe_resume(train_state=state, load_sampler_states=False)
    if restored is not None:
        state = restored
    start = acc.step_count
    losses = []
    for b in batches[start:]:
        state, m = step(state, b)
        losses.append(m["loss"].item())
    restarts = acc.goodput.restarts
    # the uninterrupted reference trajectory
    acc.resilience_plugin.peer_snapshot_every = 0
    acc.step_count = 0
    ref_state = fresh_state()
    ref = []
    for b in batches:
        ref_state, m = step(ref_state, b)
        ref.append(m["loss"].item())
    return {"mode": "resume", "start": start, "losses": losses, "ref_losses": ref,
            "goodput_restarts": restarts, "num_processes": acc.num_processes}


def fabric(rank: int, world: int, mode: str, project_dir: str, steps: int = 8,
           peer_every: int = 2, preempt_at: int = 5) -> dict:
    acc, fresh_state, step = _build(project_dir, peer_every)
    batches = _batches(acc, steps)
    try:
        if mode == "chaos":
            return _chaos(acc, fresh_state, step, batches, peer_every)
        if mode == "preempt":
            return _preempt(acc, fresh_state, step, batches, preempt_at)
        if mode == "resume":
            return _resume(acc, fresh_state, step, batches)
        raise ValueError(f"unknown train_fabric mode {mode!r}")
    finally:
        acc.uninstall_preemption_handler()


def peer_gates(rank: int, world: int) -> dict:
    """The snapshotter's two arm-time gates on a world of 2: a FULL_SHARD
    state (each rank a range of every leaf) and templates that differ
    between the ranks each raise ``PeerSchemaError`` on every rank."""
    from ...accelerator import Accelerator
    from ...parallelism_config import ParallelismConfig
    from ...resilience.peer_ckpt import PeerSchemaError, PeerSnapshotter
    from ...utils.dataclasses import FullyShardedDataParallelPlugin, ResiliencePlugin

    out = {}
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(dp_shard_size=world),
                      fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD",
                                                                 min_weight_size=0),
                      resilience_plugin=ResiliencePlugin(peer_snapshot_every=1))
    state = acc.create_train_state({"w": torch.ones(16, 256)}, sgd(0.1))
    step = acc.prepare_train_step(lambda p, b: (p["w"] * b["x"]).sum())
    try:
        step(state, {"x": torch.ones(16, 256)})
        out["full_shard"] = ""
    except PeerSchemaError as e:
        out["full_shard"] = str(e)
    template = {"w": torch.zeros(3 + rank)}
    try:
        PeerSnapshotter(template, 1)
        out["templates"] = ""
    except PeerSchemaError as e:
        out["templates"] = str(e)
    return out
