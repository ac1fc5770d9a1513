"""The port's buddy-rank host-RAM snapshots and the recovery ladder
(``accelerate_tpu_torch/resilience/peer_ckpt.py``, ``Accelerator.recover``)
against the JAX package's.

In one process: the schema's byte price equals JAX's on the same shapes;
JAX ``tests/test_resilience.py``'s crc gate (a torn wave skipped) and the
ladder peer -> disk -> fresh with its goodput counts; a snapshot stays as
it was while the step updates the state in place.  On gloo gangs of 2: the
arm-time gates (a FULL_SHARD state, templates that differ) raise on every
rank; the two-process chaos harness (``test_utils/scripts/train_fabric``:
a ``dcn 2`` mesh, rank loss at step 7 recovered from the buddy's RAM, a
torn wave dropped for the one before, the disk rung with snapshots
disarmed, each continuing bitwise); and the agreed preemption: a straggler
on rank 0 and a SIGTERM on rank 1 at step 5 exit 75 on both with one
checkpoint, whose resume continues bitwise.
"""

import shutil
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.resilience import peer_ckpt as jpc
from accelerate_tpu_torch import (
    Accelerator, DataLoaderConfiguration, LlamaConfig, LlamaForCausalLM,
    ProjectConfiguration, ResiliencePlugin, make_llama_loss_fn,
)
from accelerate_tpu_torch.checkpointing import list_checkpoints
from accelerate_tpu_torch.resilience import (
    FaultEvent, FaultPlan, install_fault_plan,
)
from accelerate_tpu_torch.resilience import peer_ckpt as tpc
from accelerate_tpu_torch.telemetry import twin_registry
from accelerate_tpu_torch.test_utils.gang import run_gang

FABRIC = "accelerate_tpu_torch.test_utils.scripts.train_fabric"


@pytest.fixture(autouse=True)
def _disarm():
    yield
    install_fault_plan(None)


class Rows(torch.utils.data.Dataset):
    def __init__(self, n=16, seq=16, vocab=256, seed=0):
        self.tokens = np.random.default_rng(seed).integers(0, vocab, (n, seq))

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        t = torch.from_numpy(self.tokens[i])
        return {"input_ids": t, "labels": t}


def _setup(tmp_path, plugin=None):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu", seed=0)
    acc = Accelerator(cpu=True, resilience_plugin=plugin,
                      project_config=ProjectConfiguration(project_dir=str(tmp_path),
                                                          automatic_checkpoint_naming=True),
                      dataloader_config=DataLoaderConfiguration(use_seedable_sampler=True))
    dl = acc.prepare(torch.utils.data.DataLoader(Rows(), batch_size=4, shuffle=True))
    state = acc.create_train_state(model, "lion-sr")
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=2))
    return acc, dl, state, step


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_schema_and_accounting_equal_jax_byte_price(dtype):
    shapes = {"a": (3, 4), "b": (7,), "c": (), "d": (2, 3, 5)}
    ours = {k: torch.zeros(s, dtype=getattr(torch, dtype)) for k, s in shapes.items()}
    ref = {k: jnp.zeros(s, dtype=dtype) for k, s in shapes.items()}
    ts, js = tpc.snapshot_schema(ours), jpc.snapshot_schema(ref)
    assert ts["snapshot_bytes"] == js["snapshot_bytes"]
    assert len(ts["leaves"]) == len(js["leaves"])
    assert tpc.peer_ckpt_accounting(ours) == jpc.peer_ckpt_accounting(ref)


def test_host_snapshot_roundtrip_and_schema_gate(tmp_path):
    """JAX ``test_host_snapshot_roundtrip_and_schema_gate``: a captured wave
    verifies, its bytes are the schema's price (predicted = measured), it
    restores the params and the generator bitwise, and a state of another
    shape fails the schema check."""
    acc, dl, state, step = _setup(tmp_path)
    state, _ = step(state, next(iter(dl)))
    snap = tpc.capture_host_snapshot(state, step=1)
    assert snap.verify()
    assert snap.nbytes == tpc.snapshot_schema(state)["snapshot_bytes"]
    assert tpc.peer_ckpt_accounting(state)["snapshot_bytes"] == snap.nbytes
    want = {n: _bytes_of(p) for n, p in state.params.items()}
    rng_state = state.rng.get_state().clone()
    mu = [m.clone() for m in state.opt_state.mu]
    state, _ = step(state, next(iter(dl)))
    restored = tpc.restore_host_snapshot(snap, state)
    assert {n: _bytes_of(p) for n, p in restored.params.items()} == want
    assert torch.equal(restored.rng.get_state(), rng_state)
    assert all(torch.equal(a, b) for a, b in zip(restored.opt_state.mu, mu))
    assert restored.opt_state.count == 1 and restored.step == 1
    other = acc.create_train_state({"a": torch.zeros(3)}, "adamw")
    with pytest.raises(tpc.PeerSchemaError):
        tpc.check_snapshot_schemas(tpc.snapshot_schema(state), tpc.snapshot_schema(other))


def test_snapshot_unchanged_after_two_more_steps(tmp_path):
    """The step updates params and optimizer state in place; on the CPU a
    host view would be the live tensor.  A wave is a copy: two more steps
    leave it bitwise as captured, and it still verifies."""
    acc, dl, state, step = _setup(tmp_path)
    it = iter(dl)
    state, _ = step(state, next(it))
    snap = tpc.capture_host_snapshot(state, step=1)
    before = {k: _bytes_of(v) for k, v in snap.leaves.items()}
    live = {n: _bytes_of(p) for n, p in state.params.items()}
    for _ in range(2):
        state, _ = step(state, next(it))
    assert {n: _bytes_of(p) for n, p in state.params.items()} != live
    assert {k: _bytes_of(v) for k, v in snap.leaves.items()} == before
    assert snap.verify()


def test_peer_snapshotter_crc_gate_and_recover_single_process(tmp_path):
    """JAX ``test_peer_snapshotter_crc_gate_and_recover_single_process``: a
    ``partial_ckpt`` tears the newest wave, which fails its crc, and
    recovery restores the wave before."""
    acc, dl, state, step = _setup(tmp_path)
    it = iter(dl)
    snapper = tpc.PeerSnapshotter(state, 1)
    state, _ = step(state, next(it))
    snapper.maybe_snapshot(state, 1)
    assert snapper.newest_restorable_step() == 1
    want = {n: _bytes_of(p) for n, p in state.params.items()}
    install_fault_plan(FaultPlan([FaultEvent("partial_ckpt", at=1)]))
    state2, _ = step(state, next(it))
    snapper.maybe_snapshot(state2, 2)
    assert not snapper.local[-1].verify() and snapper.newest_restorable_step() == 1
    got, agreed = snapper.recover(state2)
    assert agreed == 1
    assert {n: _bytes_of(p) for n, p in got.params.items()} == want


def test_accelerator_recover_ladder_single_process(tmp_path):
    """JAX ``test_accelerator_recover_ladder_single_process``: peer RAM
    (newest, fewest steps replayed), verified disk, fresh start, with the
    report and the goodput counts."""
    reg = twin_registry()
    reg.reset()
    acc, dl, state, step = _setup(tmp_path, ResiliencePlugin(peer_snapshot_every=2))
    it = iter(dl)
    for _ in range(3):
        state, _ = step(state, next(it))
        if acc.step_count == 1:
            acc.save_state(train_state=state)          # disk at step 1
    assert acc.peer_snapshotter.newest_restorable_step() == 2
    assert reg.get("recovery.peer_snapshot_bytes").measured == \
        acc.peer_snapshotter.schema["snapshot_bytes"]

    restored, report = acc.recover(train_state=state, load_sampler_states=False)
    assert report["restore_path"] == "peer"
    assert report["restored_step"] == 2 and acc.step_count == 2
    assert report["peer_snapshot_bytes"] > 0 and restored.step == 2

    acc.peer_snapshotter.forget_local()                # this rank's RAM gone
    restored, report = acc.recover(train_state=state, load_sampler_states=False)
    assert report["restore_path"] == "disk"
    assert report["restored_step"] == 1 and acc.step_count == 1
    assert report["steps_recomputed"] == 1             # step 2 replayed

    acc.peer_snapshotter.reset()
    shutil.rmtree(Path(tmp_path) / "checkpoints")
    restored, report = acc.recover(train_state=state, load_sampler_states=False)
    assert report["restore_path"] == "fresh"
    assert restored is None and acc.step_count == 0
    # the peer rung counted a restart; the disk rung restored the saved
    # counters (restarts 0) before counting its own; fresh adds one
    assert acc.goodput.restarts == 2
    assert reg.get("recovery.restore_time_s").measured is not None
    reg.reset()


def test_gates_raise_on_every_rank(tmp_path):
    """Gate 1: a FULL_SHARD state's leaves are ranges, which no buddy can
    give back whole; gate 2: templates that differ between the ranks."""
    out = run_gang(f"{FABRIC}:peer_gates", 2, tmp_path, timeout=90)
    for r in out:
        assert "whole on every rank" in r["full_shard"]
        assert "schema hash differs" in r["templates"]


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    d = tmp_path_factory.mktemp("fabric_chaos")
    return run_gang(f"{FABRIC}:fabric", 2, d / "gang", timeout=150, mode="chaos",
                    project_dir=str(d / "project"))[0]


def test_fabric_chaos_rank_loss_recovers_from_the_buddy(chaos):
    """Pass A: the lost rank's wave 6 comes back from its buddy's RAM, no
    step replayed, the losses bitwise the uninterrupted run's."""
    a = chaos["pass_a"]
    assert a["restore_path"] == "peer" and a["restored_step"] == 6
    assert a["steps_recomputed"] == 0 and a["parity"]
    # the disk rung (step 4) would have replayed more
    assert a["restored_step"] > chaos["disk_step_a"]
    assert chaos["num_processes"] == 2


def test_fabric_chaos_torn_wave_falls_back_one_wave(chaos):
    b = chaos["pass_b"]
    assert b["restore_path"] == "peer" and b["restored_step"] == 4
    assert b["steps_recomputed"] == 2 and b["parity"]


def test_fabric_chaos_disk_rung_without_snapshots(chaos):
    c = chaos["pass_c"]
    assert c["restore_path"] == "disk" and c["restored_step"] == 2
    assert c["peer_snapshot_bytes"] == 0 and c["parity"]


def test_fabric_snapshot_bytes_predicted_equal_measured(chaos):
    assert chaos["predicted_bytes"] == chaos["measured_bytes"] > 0
    assert chaos["pass_a"]["peer_snapshot_bytes"] == chaos["predicted_bytes"]
    assert all(np.isfinite(chaos["ref_losses"]))


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    d = tmp_path_factory.mktemp("fabric_preempt")
    t0 = time.perf_counter()
    codes = run_gang(f"{FABRIC}:fabric", 2, d / "gang1", timeout=150, exit_code=75,
                     mode="preempt", project_dir=str(d / "project"))
    wall = time.perf_counter() - t0
    resumed = run_gang(f"{FABRIC}:fabric", 2, d / "gang2", timeout=150, mode="resume",
                       project_dir=str(d / "project"))
    return {"codes": codes, "wall": wall, "project": d / "project", "resumed": resumed}


def test_fabric_preempt_exits_75_with_one_checkpoint(preempted):
    """A straggler on rank 0 and a SIGTERM on rank 1 at step 5: the agreed
    stop drains both ranks at one step (exit 75) and writes ONE emergency
    checkpoint at step 5, with the preemption counted and each rank's RNG
    streams."""
    import json

    assert preempted["codes"] == [None, None]        # both exited 75
    ckpts = list_checkpoints(str(preempted["project"]))
    assert len(ckpts) == 1
    ckpt = Path(ckpts[0])
    meta = json.loads((ckpt / "accelerate_metadata.json").read_text())
    assert meta["step_count"] == 5 and meta["num_processes"] == 2
    assert meta["goodput"]["preemptions"] == 1
    assert sorted(p.name for p in ckpt.glob("random_states_*.pkl")) == [
        "random_states_0.pkl", "random_states_1.pkl"]


def test_fabric_resume_continues_bitwise(preempted):
    for r in preempted["resumed"]:
        assert r["start"] == 5
        assert r["losses"] == r["ref_losses"][5:]
        assert r["goodput_restarts"] == 1
