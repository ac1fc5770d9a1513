"""The port's training resilience held against the JAX package's
(``tests/test_resilience.py``'s matrix, single process): preemption →
emergency checkpoint → exit 75 → a fresh process resumes bit-exact; a
corrupt newest checkpoint → the verified fallback; a NaN batch → the step
skipped with params, optimizer tensors and ``count`` bitwise unchanged and
the counters carried through a resume; transient transfer and checkpoint
I/O failures → bounded retries, identical results.  Cross-framework pins:
the fault plans, ``poison_batch``, the goodput counters and the predicted
model, the ``AcceleratedScheduler`` counts and the plugins' env defaults
equal the JAX package's.  And the port imports nothing of JAX."""

import ast
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerate_tpu import resilience as jres
from accelerate_tpu import scheduler as jsched
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import (
    Accelerator, DataLoaderConfiguration, GradientAccumulationPlugin, LlamaConfig,
    LlamaForCausalLM, ProjectConfiguration, ResiliencePlugin, make_llama_loss_fn,
)
from accelerate_tpu_torch.checkpointing import (
    CheckpointCorruptError, _presumed_valid_for_gc, list_checkpoints, verify_checkpoint,
    write_checkpoint_manifest,
)
from accelerate_tpu_torch.resilience import (
    CORRUPTION_MODES, RESUME_EXIT_CODE, FaultEvent, FaultPlan, GoodputTracker,
    InjectedTransferError, NanGuardAbort, PreemptionHandler, RetryPolicy, corrupt_checkpoint,
    fault_plan, goodput_accounting, install_fault_plan, poison_batch, with_retries,
)
from accelerate_tpu_torch.scheduler import AcceleratedScheduler
from accelerate_tpu_torch.state import GradientState

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _disarm():
    yield
    install_fault_plan(None)


class Rows(torch.utils.data.Dataset):
    """Token rows from a numpy seed; a float ``weight`` of 1 rides each row
    so a ``nan_grad`` fault has a leaf to poison."""

    def __init__(self, n=16, seq=16, vocab=256, seed=0):
        self.tokens = np.random.default_rng(seed).integers(0, vocab, (n, seq))

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        t = torch.from_numpy(self.tokens[i])
        return {"input_ids": t, "labels": t, "row": torch.tensor(i),
                "weight": torch.ones((), dtype=torch.float32)}


def _setup(tmp_path, plugin=None, total_limit=None, seed=0, recipe="lion-sr"):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu", seed=seed)
    acc = Accelerator(cpu=True, resilience_plugin=plugin,
                      project_config=ProjectConfiguration(
                          project_dir=str(tmp_path), automatic_checkpoint_naming=True,
                          total_limit=total_limit),
                      dataloader_config=DataLoaderConfiguration(use_seedable_sampler=True))
    dl = acc.prepare(torch.utils.data.DataLoader(Rows(), batch_size=4, shuffle=True))
    state = acc.create_train_state(model, recipe)
    base = make_llama_loss_fn(model, fused_vocab_chunks=2)
    step = acc.prepare_train_step(lambda p, b: base(p, b) * b["weight"].mean())
    return acc, dl, state, step


def _template(acc, seed=7, recipe="lion-sr"):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu", seed=seed)
    return acc.create_train_state(model, recipe)


def _digest(state) -> dict:
    return {"params": {n: p.clone() for n, p in state.params.items()},
            "mu": [m.clone() for m in state.opt_state.mu], "count": state.opt_state.count}


def _same(a, b) -> bool:
    return (a["count"] == b["count"]
            and all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
            and all(torch.equal(x, y) for x, y in zip(a["mu"], b["mu"])))


# -- (a) SIGTERM → emergency checkpoint → a fresh process resumes bit-exact --

_TRAIN = textwrap.dedent('''
    import hashlib, json, random, sys
    import numpy as np, torch
    from accelerate_tpu_torch import (Accelerator, DataLoaderConfiguration, LlamaConfig,
        LlamaForCausalLM, ProjectConfiguration, ResiliencePlugin, make_llama_loss_fn)
    from accelerate_tpu_torch.utils.random import set_seed

    class Rows(torch.utils.data.Dataset):   # the test module's Rows
        tokens = np.random.default_rng(0).integers(0, 256, (16, 16))

        def __len__(self):
            return len(self.tokens)

        def __getitem__(self, i):
            t = torch.from_numpy(self.tokens[i])
            return {"input_ids": t, "labels": t, "row": torch.tensor(i),
                    "weight": torch.ones((), dtype=torch.float32)}

    project_dir, result_file = sys.argv[1], sys.argv[2]
    set_seed(123)
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu", seed=0)
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=project_dir, automatic_checkpoint_naming=True),
        resilience_plugin=ResiliencePlugin(handle_preemption=True, nan_guard=True),
        dataloader_config=DataLoaderConfiguration(use_seedable_sampler=True))
    dl = acc.prepare(torch.utils.data.DataLoader(Rows(), batch_size=4, shuffle=True))
    state = acc.create_train_state(model, "lion-sr")
    state = acc.maybe_resume(train_state=state) or state
    base = make_llama_loss_fn(model, fused_vocab_chunks=2)
    step = acc.prepare_train_step(lambda p, b: base(p, b) * b["weight"].mean())
    consumed = []
    while acc.step_count < 6:   # an epoch is 4 batches: the run crosses it
        for batch in dl:
            consumed.append(batch["row"].tolist())
            state, _ = step(state, batch)
            if acc.step_count >= 6:
                break
    acc.end_training()
    h = lambda ts: hashlib.sha256(b"".join(
        t.reshape(-1).view(torch.uint8).numpy().tobytes() for t in ts)).hexdigest()
    json.dump({"params": h(state.params.values()), "mu": h(state.opt_state.mu),
               "count": state.opt_state.count, "step": state.step, "step_count": acc.step_count,
               "rng": h([state.rng.get_state()]), "py": random.random(),
               "np": float(np.random.rand()),
               "nan_skips": int(state.guard_state["nan_skips"]),
               "restarts": acc.goodput.restarts, "preemptions": acc.goodput.preemptions,
               "consumed": consumed}, open(result_file, "w"))
''')


def _run(args, plan=None, expect=0):
    env = {k: v for k, v in os.environ.items() if k != "ACCELERATE_FAULT_PLAN"}
    env["PYTHONPATH"] = str(REPO)
    if plan is not None:
        env["ACCELERATE_FAULT_PLAN"] = json.dumps(plan)
    out = subprocess.run([sys.executable, "-c", _TRAIN, *map(str, args)], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == expect, f"exit {out.returncode}\n{out.stderr[-3000:]}"


def test_sigterm_preemption_fresh_process_resume_bit_exact(tmp_path):
    """The twin of JAX's: a SIGTERM during step 3 (the fault plan's real
    signal through the installed handler; a NaN batch at step 2 too), exit
    75 after the emergency checkpoint; a fresh process resumes and finishes
    with the uninterrupted run's params, momentum, count, the state's
    generator, the python and numpy streams and the batch stream, bit for
    bit."""
    res = [tmp_path / f"r{i}.json" for i in range(3)]
    nan = {"kind": "nan_grad", "at": 2}
    _run([tmp_path / "clean", res[0]], plan={"events": [nan]})
    clean = json.loads(res[0].read_text())
    assert clean["step_count"] == 6 and clean["nan_skips"] == 1
    _run([tmp_path / "faulted", res[1]],
         plan={"events": [nan, {"kind": "preempt", "at": 3}]}, expect=RESUME_EXIT_CODE)
    assert not res[1].exists()
    ckpts = list_checkpoints(str(tmp_path / "faulted"))
    assert len(ckpts) == 1 and verify_checkpoint(ckpts[0]) == (True, [])
    _run([tmp_path / "faulted", res[2]])
    resumed = json.loads(res[2].read_text())
    assert (resumed["restarts"], resumed["preemptions"]) == (1, 1)
    # (torch's global generator is not compared: each pass of a torch
    # DataLoader draws its base seed from it, and the resumed process starts
    # one more pass; JAX's twin compares python and numpy alone too)
    for key in ("params", "mu", "count", "step", "rng", "py", "np", "nan_skips"):
        assert resumed[key] == clean[key], key
    assert clean["consumed"][3:] == resumed["consumed"]


def test_preemption_in_process_and_the_code_survives_a_failed_save(tmp_path):
    plugin = ResiliencePlugin(handle_preemption=True, nan_guard=False, io_retries=1,
                              io_backoff_s=0.001)
    acc, dl, state, step = _setup(tmp_path, plugin)
    batch = next(iter(dl))
    try:
        state, _ = step(state, batch)
        acc._preemption.request()
        with pytest.raises(SystemExit) as exc:
            step(state, batch)
        assert exc.value.code == RESUME_EXIT_CODE and acc.goodput.preemptions == 1
        ckpts = list_checkpoints(str(tmp_path))
        assert len(ckpts) == 1 and verify_checkpoint(ckpts[0])[0]
        acc._preemption.clear()
        restored = acc.maybe_resume(train_state=_template(acc))
        assert restored.step == 2 and acc.goodput.restarts == 1
        # every checkpoint-I/O attempt fails past the budget: still 75
        acc._preemption.request()
        with fault_plan(FaultPlan([FaultEvent("transfer", at=1, count=10,
                                              site="checkpoint_io")])):
            with pytest.raises(SystemExit) as exc:
                step(restored, batch)
        assert exc.value.code == RESUME_EXIT_CODE
    finally:
        acc.uninstall_preemption_handler()


def test_preemption_handler_real_signal_and_uninstall_restores():
    previous = signal.getsignal(signal.SIGTERM)
    handler = PreemptionHandler(("SIGTERM",)).install()
    try:
        assert not handler.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.requested
        handler.clear()
        assert not handler.requested
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) is previous


# -- (b) corrupt checkpoints → the verified fallback --------------------------


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_corrupt_latest_falls_back_to_newest_valid(tmp_path, mode, caplog):
    acc, dl, state, step = _setup(tmp_path)
    digests = []
    for batch in dl:
        state, _ = step(state, batch)
        digests.append(_digest(state))
        acc.save_state(train_state=state)
    ckpts = list_checkpoints(str(tmp_path))
    corrupt_checkpoint(ckpts[-1], mode=mode, seed=3)
    assert not verify_checkpoint(ckpts[-1])[0]
    with caplog.at_level("WARNING"):
        restored = acc.load_state(train_state=_template(acc))
    assert any("failed verification" in r.getMessage() for r in caplog.records)
    assert _same(_digest(restored), digests[-2])
    with pytest.raises(CheckpointCorruptError):
        acc.load_state(ckpts[-1], train_state=_template(acc))
    for c in ckpts:
        corrupt_checkpoint(c, mode="truncate", seed=1)
    with pytest.raises(CheckpointCorruptError, match="no valid checkpoint"):
        acc.load_state(train_state=_template(acc))


def test_verify_checkpoint_contract(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    ckpt = Path(acc.save_state(train_state=state))
    assert verify_checkpoint(ckpt) == (True, [])
    (ckpt / "checkpoint_manifest.json").unlink()
    ok, problems = verify_checkpoint(ckpt)
    assert ok and "no manifest" in problems[0]
    write_checkpoint_manifest(ckpt)
    next(p for p in sorted((ckpt / "train_state").rglob("*")) if p.is_file()).unlink()
    ok, problems = verify_checkpoint(ckpt)
    assert not ok and any("missing file" in p for p in problems)
    assert verify_checkpoint(str(ckpt) + ".tmp")[0] is False
    assert verify_checkpoint(tmp_path / "nope")[0] is False


def test_fault_plan_corruption_via_the_post_save_hook(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    with fault_plan(FaultPlan([FaultEvent("corrupt_ckpt", at=1, mode="bitflip")])):
        ckpt = acc.save_state(train_state=state)
    ok, problems = verify_checkpoint(ckpt)
    assert not ok and any("checksum mismatch" in p for p in problems)


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_retention_gc_spares_the_only_valid_fallback(tmp_path, mode):
    acc, dl, state, step = _setup(tmp_path, total_limit=2)
    it = iter(dl)
    state, _ = step(state, next(it))
    acc.save_state(train_state=state)                        # checkpoint_0
    state, _ = step(state, next(it))
    acc.save_state(train_state=state)                        # checkpoint_1
    corrupt_checkpoint(list_checkpoints(str(tmp_path))[-1], mode=mode, seed=0)
    state, _ = step(state, next(it))
    acc.save_state(train_state=state)                        # checkpoint_2
    assert "checkpoint_0" in [os.path.basename(c) for c in list_checkpoints(str(tmp_path))]
    state, _ = step(state, next(it))
    acc.save_state(train_state=state)                        # checkpoint_3
    names = [os.path.basename(c) for c in list_checkpoints(str(tmp_path))]
    assert "checkpoint_0" not in names and "checkpoint_3" in names


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_presumed_valid_for_gc_every_corruption_mode(tmp_path, mode):
    acc, dl, state, step = _setup(tmp_path)
    ckpt = Path(acc.save_state(train_state=state))
    assert _presumed_valid_for_gc(ckpt) is True
    corrupt_checkpoint(ckpt, mode=mode, seed=2)
    assert verify_checkpoint(ckpt)[0] is False
    assert _presumed_valid_for_gc(ckpt) is False
    assert _presumed_valid_for_gc(ckpt) is False


# -- (c) the NaN guard ---------------------------------------------------------


def _guarded(tmp_path, max_consecutive=3, recipe="lion-sr"):
    plugin = ResiliencePlugin(nan_guard=True, max_consecutive_nan_skips=max_consecutive,
                              handle_preemption=False)
    return _setup(tmp_path, plugin, recipe=recipe)


@pytest.mark.parametrize("recipe", ["lion-sr", "adamw"])
def test_nan_guard_skips_with_the_state_bitwise_unchanged(tmp_path, recipe):
    acc, dl, state, step = _guarded(tmp_path, recipe=recipe)
    batch = next(iter(dl))
    with fault_plan(FaultPlan([FaultEvent("nan_grad", at=2)])):
        state, m = step(state, batch)
        assert not bool(m["nan_skipped"])
        before = _digest(state)
        state, m = step(state, batch)
        assert bool(m["nan_skipped"]) and int(m["nan_skips"]) == 1
        assert int(m["consecutive_nan_skips"]) == 1
        assert _same(_digest(state), before) and state.step == 2
        state, m = step(state, batch)
        assert not bool(m["nan_skipped"]) and int(m["consecutive_nan_skips"]) == 0
        assert int(m["nan_skips"]) == 1 and np.isfinite(m["loss"].item())
        assert state.opt_state.count == 2
    assert acc.goodput.nan_skips == 1


def test_nan_guard_abort_and_counts_without_abort(tmp_path):
    acc, dl, state, step = _guarded(tmp_path, max_consecutive=2)
    batch = next(iter(dl))
    with fault_plan(FaultPlan([FaultEvent("nan_grad", at=1, count=3)])):
        state, m = step(state, batch)
        with pytest.raises(NanGuardAbort, match="2 consecutive"):
            step(state, batch)
    acc, dl, state, step = _guarded(tmp_path / "b", max_consecutive=0)
    with fault_plan(FaultPlan([FaultEvent("nan_grad", at=1, count=2)])):
        for _ in range(3):
            state, m = step(state, batch)
    assert acc.goodput.nan_skips == 2 and int(m["nan_skips"]) == 2


def test_nan_guard_counters_survive_a_resume(tmp_path):
    acc, dl, state, step = _guarded(tmp_path)
    with fault_plan(FaultPlan([FaultEvent("nan_grad", at=1)])):
        state, _ = step(state, next(iter(dl)))
    ckpt = acc.save_state(train_state=state)
    restored = acc.load_state(ckpt, train_state=_template(acc))
    assert int(restored.guard_state["nan_skips"]) == 1


def test_guard_off_keeps_the_state_and_reads_nothing_back(tmp_path, monkeypatch):
    """Without the guard the step adds no host read: no ``item``,
    ``tolist`` or truth test of a tensor runs inside it."""
    acc, dl, state, step = _setup(tmp_path)
    assert state.guard_state is None
    batch = next(iter(dl))

    def refuse(*a, **k):
        raise AssertionError("the unguarded step read a tensor back to the host")

    for name in ("item", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    state, m = step(state, batch)
    monkeypatch.undo()
    assert set(m) == {"loss", "grad_norm"}


# -- (d) transient failures → bounded retries, identical results --------------


def test_transfer_retry_training_identical(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    acc.resilience_plugin.io_backoff_s = 0.001
    for batch in dl:
        state, _ = step(state, batch)
    clean = _digest(state)
    acc2, dl2, state2, step2 = _setup(tmp_path / "f")
    with fault_plan(FaultPlan([FaultEvent("transfer", at=3)])):
        for batch in dl2:
            state2, _ = step2(state2, batch)
    assert _same(_digest(state2), clean)


def test_checkpoint_io_retry_and_the_goodput_counter(tmp_path):
    acc, dl, state, step = _setup(tmp_path, ResiliencePlugin(io_backoff_s=0.001))
    with fault_plan(FaultPlan([FaultEvent("transfer", at=1, count=2, site="checkpoint_io")])):
        ckpt = acc.save_state(train_state=state)
    assert verify_checkpoint(ckpt)[0] and acc.goodput.io_retries == 2
    with fault_plan(FaultPlan([FaultEvent("transfer", at=1, site="checkpoint_io")])):
        restored = acc.load_state(ckpt, train_state=_template(acc))
    assert _same(_digest(restored), _digest(state))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        raise InjectedTransferError("always down")

    with pytest.raises(InjectedTransferError):
        with_retries(flaky, policy=RetryPolicy(retries=2, backoff_s=0.001))
    assert calls["n"] == 3


def test_mid_epoch_resume_through_checkpoint_bit_parity(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    reference = [b["row"].tolist() for b in dl]
    acc2, dl2, state2, step2 = _setup(tmp_path)
    it = iter(dl2)
    next(it), next(it)
    ckpt = acc2.save_state(train_state=state2)
    acc3, dl3, state3, step3 = _setup(tmp_path)
    acc3.load_state(ckpt)
    assert [b["row"].tolist() for b in dl3] == reference[2:]


def test_bitwise_resume_in_process_through_the_loader(tmp_path):
    """Six steps straight against three, a save, a fresh accelerator and
    model from another seed, a resume and three more: params, momentum,
    count, generator and losses bitwise."""
    def run(project, stop=None, resume=False, seed=0):
        acc, dl, state, step = _setup(project, seed=seed)
        if resume:
            state = acc.maybe_resume(train_state=state)
        losses = []
        while acc.step_count < 6:
            for batch in dl:
                state, m = step(state, batch)
                losses.append(m["loss"].item())
                if acc.step_count == stop:
                    acc.save_state(train_state=state, async_save=True)
                    return state, losses, acc
                if acc.step_count >= 6:
                    break
        return state, losses, acc

    clean, closs, _ = run(tmp_path / "a")
    _, first, acc = run(tmp_path / "b", stop=3)
    acc.end_training()
    resumed, rest, _ = run(tmp_path / "b", resume=True, seed=4)
    assert first + rest == closs
    assert _same(_digest(resumed), _digest(clean))
    assert torch.equal(resumed.rng.get_state(), clean.rng.get_state())


# -- machinery against the JAX package ----------------------------------------


def test_fault_plans_poison_and_unported_kinds():
    spec = FaultPlan.from_seed(7, 50, p_preempt=0.05, p_nan=0.1, p_transfer=0.1,
                               p_corrupt=0.1).to_spec()
    assert spec == jres.FaultPlan.from_seed(7, 50, p_preempt=0.05, p_nan=0.1, p_transfer=0.1,
                                            p_corrupt=0.1).to_spec()
    batch = {"x": torch.ones(2, 3), "ids": torch.arange(3), "m": [np.ones(2, np.float32)]}
    poisoned = poison_batch(batch)
    assert torch.isnan(poisoned["x"]).all() and torch.equal(poisoned["ids"], batch["ids"])
    ref = jres.poison_batch({"m": [np.ones(2, np.float32)], "i": np.arange(3)})
    assert np.isnan(poisoned["m"][0]).all() and np.isnan(ref["m"][0]).all()
    # the peer snapshots are ported: armed by the first update, not before
    acc = Accelerator(cpu=True, resilience_plugin=ResiliencePlugin(peer_snapshot_every=2))
    assert acc.peer_snapshotter is None


@pytest.mark.parametrize("kind", ["straggler", "rank_loss"])
def test_rank_faults_name_a13(tmp_path, kind):
    """The rank faults of ROADMAP item A13f fire in the step: a straggler
    stalls the step by STRAGGLER_STALL_S, a rank loss raises RankLostError
    before the step counts."""
    import time

    from accelerate_tpu_torch.resilience import STRAGGLER_STALL_S, RankLostError

    acc, dl, state, step = _setup(tmp_path)
    batch = next(iter(dl))
    with fault_plan(FaultPlan([FaultEvent(kind, at=1)])):
        if kind == "rank_loss":
            with pytest.raises(RankLostError, match="injected rank loss at step 1"):
                step(state, batch)
            assert acc.step_count == 0
        else:
            t0 = time.perf_counter()
            step(state, batch)
            assert time.perf_counter() - t0 >= STRAGGLER_STALL_S
            assert acc.step_count == 1
    assert STRAGGLER_STALL_S == jres.faults.STRAGGLER_STALL_S


def test_goodput_counters_and_model_equal_jax(tmp_path):
    port, ref = GoodputTracker(), jres.GoodputTracker()
    for t in (port, ref):
        for _ in range(10):
            t.record_step()
        t.record_nan_skip(2)
        t.record_restart(steps_recomputed=3, time_lost_s=1.5)
        t.record_preemption()
        t.record_retry("checkpoint-save x", 0, OSError())
        t.record_retry("dataloader-h2d", 0, OSError())
    assert port.state_dict() == ref.state_dict()
    assert port.report()["goodput_frac"] == pytest.approx(ref.report()["goodput_frac"], abs=1e-3)
    fresh = GoodputTracker()
    fresh.load_state_dict({"steps": 7})
    assert fresh.steps == 7 and fresh.restarts == 0
    for kw in (dict(save_overhead_s=2.0, preemption_rate_per_hour=1.0),
               dict(save_overhead_s=0.5, preemption_rate_per_hour=20.0)):
        for interval in (20, 100, 500):
            assert goodput_accounting(1.0, interval, **kw) == \
                jres.goodput_accounting(1.0, interval, **kw)
    acc, dl, state, step = _setup(tmp_path)
    acc.goodput.record_nan_skip(3)
    acc.goodput.record_restart(steps_recomputed=2)
    ckpt = acc.save_state(train_state=state)
    acc.goodput.load_state_dict({k: 0 for k in acc.goodput.state_dict()})
    acc.load_state(ckpt)
    assert (acc.goodput.nan_skips, acc.goodput.restarts, acc.goodput.steps_recomputed) == (3, 1, 2)


def test_plugins_and_env_defaults_equal_jax(monkeypatch):
    pairs = [(ResiliencePlugin, jdc.ResiliencePlugin),
             (ProjectConfiguration, jdc.ProjectConfiguration),
             (DataLoaderConfiguration, jdc.DataLoaderConfiguration)]
    for env in ({}, {"ACCELERATE_RESILIENCE": "1"},
                {"ACCELERATE_RESILIENCE": "1", "ACCELERATE_NAN_GUARD": "0"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for port, ref in pairs:
            assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    with pytest.raises(ValueError):
        ResiliencePlugin(max_consecutive_nan_skips=-1)


def test_scheduler_counts_equal_jax_and_the_schedule_drives_the_update(tmp_path):
    """``step`` counts with and without accumulation as JAX's; a prepared
    schedule writes ``schedule(count)`` before each update."""
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    for sync, adjust, with_opt in ((True, True, True), (False, True, True),
                                   (False, False, True), (False, True, False)):
        gs = GradientState(GradientAccumulationPlugin(adjust_scheduler=adjust))
        gs._set_sync_gradients(sync)
        jgs = JaxGradientState(jdc.GradientAccumulationPlugin(adjust_scheduler=adjust))
        jgs._set_sync_gradients(sync)
        port = AcceleratedScheduler(lambda s: 0.1 * s, step_with_optimizer=with_opt,
                                    gradient_state=gs)
        ref = jsched.AcceleratedScheduler(lambda s: 0.1 * s, step_with_optimizer=with_opt)
        for _ in range(3):
            port.step()
            ref.step()
        assert port.state_dict() == ref.state_dict()
        assert port.get_lr() == ref.get_lr() and port.get_last_lr() == ref.get_last_lr()
    JaxGradientState._reset_state()

    seen = []

    def schedule(count):
        seen.append(count)
        return 1e-4

    acc, dl, state, step = _setup(tmp_path)
    acc.prepare_scheduler(schedule)
    for batch in dl:
        state, _ = step(state, batch)
    acc2, dl2, state2, step2 = _setup(tmp_path / "b")
    for batch in dl2:
        state2, _ = step2(state2, batch)
    assert seen == [0, 1, 2, 3]
    assert _same(_digest(state), _digest(state2))   # the recipe's own lr is 1e-4
    acc3, dl3, state3, step3 = _setup(tmp_path / "c")
    acc3.prepare_scheduler(lambda c: 1e-3 * (c + 1))
    for batch in dl3:
        state3, _ = step3(state3, batch)
    assert state3.opt_state.hyperparams["lr"].item() == pytest.approx(4e-3)
    acc4, dl4, state4, step4 = _setup(tmp_path / "d", recipe="adamw")
    acc4.prepare_scheduler(lambda c: 1e-3)
    with pytest.raises(ValueError, match="hyperparams"):
        step4(state4, next(iter(dl4)))


# -- the port imports nothing of JAX ----------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "orbax", "optax", "flax", "accelerate_tpu")


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((REPO / "accelerate_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in _FORBIDDEN]
    assert len(files) > 40 and not bad, bad
