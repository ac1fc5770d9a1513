"""The port's checkpoints (``accelerate_tpu_torch/checkpointing.py``) held
against the JAX package's: the layout, the manifest and
``verify_checkpoint`` cross between the packages (a port-written
checkpoint passes JAX's verify, a port-corrupted one fails it, mode by
mode, and ``corrupt_checkpoint`` picks the same file and bytes);
``save_model`` writes the JAX package's bytes for the same weights and
each package loads the other's.  Within the port: a save / load round trip
is bitwise (params, optimizer tensors, ``count``, hyperparameters, step,
generator states, RNG streams, loader positions, schedulers, custom
objects), an async save holds its own step's values though the next step
updates the params in place, and the retention, naming, staging and
exit-flush rules are the JAX package's."""

import json
import os
import random
import shutil
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import checkpointing as jck
from accelerate_tpu.models import llama as jl
from accelerate_tpu.resilience import faults as jfaults
from accelerate_tpu_torch import (
    Accelerator, LlamaConfig, LlamaForCausalLM, ProjectConfiguration, make_llama_loss_fn,
)
from accelerate_tpu_torch import checkpointing as ck
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.optimizer import AcceleratedOptimizer, make_optimizer
from accelerate_tpu_torch.resilience import CORRUPTION_MODES, corrupt_checkpoint
from accelerate_tpu_torch.utils.constants import CHECKPOINT_MANIFEST_NAME
from accelerate_tpu_torch.utils.random import set_seed

REPO = Path(__file__).resolve().parent.parent


class Rows(torch.utils.data.Dataset):
    def __init__(self, n=16, seq=16, vocab=256):
        self.tokens = np.random.default_rng(0).integers(0, vocab, (n, seq))

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        t = torch.from_numpy(self.tokens[i])
        return {"input_ids": t, "labels": t}


def _setup(tmp_path, recipe="lion-sr", seed=0, total_limit=2, **acc_kw):
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu", seed=seed)
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True, total_limit=total_limit),
        **acc_kw)
    dl = acc.prepare(torch.utils.data.DataLoader(Rows(), batch_size=4))
    state = acc.create_train_state(model, recipe)
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=2))
    return acc, dl, state, step


def _snap(state) -> dict:
    """Everything a restore must give back, as CPU copies."""
    from accelerate_tpu_torch.optimizer import flatten_opt_state

    tensors, meta = flatten_opt_state(state.opt_state)
    return {"params": {n: p.clone() for n, p in state.params.items()},
            "opt": [t.clone() for t in tensors], "fields": meta["fields"],
            "hyper": {k: (v.item() if torch.is_tensor(v) else v)
                      for k, v in meta["hyperparams"].items()},
            "step": state.step, "rng": state.rng.get_state().clone()}


def _assert_same(a: dict, b: dict):
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    assert len(a["opt"]) == len(b["opt"])
    for x, y in zip(a["opt"], b["opt"]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert (a["fields"], a["hyper"], a["step"]) == (b["fields"], b["hyper"], b["step"])
    assert torch.equal(a["rng"], b["rng"])


@pytest.mark.parametrize("recipe", ["lion-sr", "adamw-sr", "lion", "adamw"])
def test_save_load_roundtrip_is_bitwise(tmp_path, recipe):
    acc, dl, state, step = _setup(tmp_path, recipe)
    it = iter(dl)
    for _ in range(2):
        state, _ = step(state, next(it))
    torch.randn(3, generator=state.rng)   # move the state's generator on
    saved = _snap(state)
    ckpt = acc.save_state(train_state=state)
    state, _ = step(state, next(it))      # the params move on in place
    acc2, _, template, _ = _setup(tmp_path, recipe, seed=5)
    restored = acc2.load_state(ckpt, train_state=template)
    _assert_same(saved, _snap(restored))
    assert acc2.step_count == 2
    assert set(os.listdir(Path(ckpt) / "train_state")) == {
        "params.safetensors", "opt_state.safetensors", "state.safetensors"}


def test_automatic_naming_and_retention(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    for _ in range(3):
        acc.save_state(train_state=state)
    assert [os.path.basename(c) for c in ck.list_checkpoints(str(tmp_path))] == \
        ["checkpoint_1", "checkpoint_2"]


def test_async_save_immediate_save_and_retention_race(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    snaps, dirs = [], []
    for batch in dl:
        state, _ = step(state, batch)
        snaps.append(_snap(state))
        dirs.append(acc.save_state(train_state=state, async_save=True))
        if len(dirs) == 3:
            break
    acc.wait_for_checkpoint()
    ckpts = ck.list_checkpoints(str(tmp_path))
    assert [os.path.basename(c) for c in ckpts] == ["checkpoint_1", "checkpoint_2"]
    for i, ckpt in enumerate(ckpts, start=1):
        _, _, template, _ = _setup(tmp_path, seed=9)
        _assert_same(snaps[i], _snap(acc.load_state(ckpt, train_state=template)))


def test_async_save_holds_its_own_step_while_the_next_updates_in_place(tmp_path):
    """The port's step writes the params in place: the async save must have
    snapshotted step N's values before step N+1 runs."""
    acc, dl, state, step = _setup(tmp_path)
    it = iter(dl)
    state, _ = step(state, next(it))
    saved = _snap(state)
    ckpt = acc.save_state(train_state=state, async_save=True)
    assert acc._pending_checkpointer is not None
    state, _ = step(state, next(it))      # N+1 overwrites the same tensors
    assert any(not torch.equal(saved["params"][n], p) for n, p in state.params.items())
    _, _, template, _ = _setup(tmp_path, seed=3)
    restored = acc.load_state(ckpt, train_state=template)   # waits internally
    assert acc._pending_checkpointer is None
    _assert_same(saved, _snap(restored))


def test_end_training_flushes_async_save(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    state, _ = step(state, next(iter(dl)))
    ckpt = acc.save_state(train_state=state, async_save=True)
    first = acc._async_checkpointer
    acc.save_state(train_state=state, async_save=True)
    assert acc._async_checkpointer is first        # one long-lived writer
    acc.end_training()
    assert acc._pending_checkpointer is None and acc._async_checkpointer is None
    assert ck.verify_checkpoint(ckpt)[0]


def test_save_publishes_atomically_and_passes_jax_verify(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    ckpt = acc.save_state(train_state=state)
    assert os.path.exists(os.path.join(ckpt, "checkpoint_manifest.json"))
    assert not list((tmp_path / "checkpoints").glob("*.tmp"))
    assert ck.verify_checkpoint(ckpt) == (True, []) == jck.verify_checkpoint(ckpt)
    ckpt2 = acc.save_state(train_state=state, async_save=True)
    acc.wait_for_checkpoint()
    assert jck.verify_checkpoint(ckpt2) == (True, [])
    # the manifest is the JAX package's for the same files
    manifest = Path(ckpt) / "checkpoint_manifest.json"
    ours = manifest.read_text()
    jck.write_checkpoint_manifest(ckpt)
    assert manifest.read_text() == ours


@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_corruption_picks_jax_file_and_bytes_and_fails_jax_verify(tmp_path, mode):
    acc, dl, state, step = _setup(tmp_path / "run")
    ckpt = Path(acc.save_state(train_state=state))
    twin = tmp_path / "twin"
    shutil.copytree(ckpt, twin)
    for seed in (0, 1, 2, 7):
        a, b = tmp_path / f"port{seed}", tmp_path / f"jax{seed}"
        shutil.copytree(ckpt, a)
        shutil.copytree(ckpt, b)
        pa = corrupt_checkpoint(a, mode=mode, seed=seed)
        pb = jfaults.corrupt_checkpoint(b, mode=mode, seed=seed)
        assert Path(pa).relative_to(a) == Path(pb).relative_to(b)
        assert Path(pa).read_bytes() == Path(pb).read_bytes()
        ok_port, problems = ck.verify_checkpoint(a)
        ok_jax, jproblems = jck.verify_checkpoint(a)
        assert not ok_port and not ok_jax and problems == jproblems


def test_stale_tmp_dir_is_swept_and_numbering_continues(tmp_path):
    acc, dl, state, step = _setup(tmp_path, total_limit=None)
    acc.save_state(train_state=state)
    stale = tmp_path / "checkpoints" / "checkpoint_9.tmp"
    stale.mkdir(parents=True)
    (stale / "garbage.bin").write_bytes(b"\x00" * 16)
    assert all(".tmp" not in c for c in ck.list_checkpoints(str(tmp_path)))
    acc.save_state(train_state=state)
    assert not stale.exists()
    acc2, _, state2, _ = _setup(tmp_path, total_limit=None)   # iteration starts at 0
    assert os.path.basename(acc2.save_state(train_state=state2)) == "checkpoint_2"


def test_rng_streams_roundtrip(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    set_seed(123)
    ckpt = acc.save_state(train_state=state)
    expected = [random.random(), float(np.random.rand()), torch.rand(()).item()]
    set_seed(999)
    acc.load_state(ckpt)
    assert [random.random(), float(np.random.rand()), torch.rand(()).item()] == expected
    import pickle

    with open(Path(ckpt) / "random_states_0.pkl", "rb") as f:
        states = pickle.load(f)
    assert {"python", "numpy", "root_seed", "torch"} <= set(states)


def test_custom_objects_hooks_schedulers_and_loader_position(tmp_path):
    class Counter:
        n = 0

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, sd):
            self.n = sd["n"]

    acc, dl, state, step = _setup(tmp_path)
    counter = Counter()
    acc.register_for_checkpointing(counter)
    with pytest.raises(ValueError):
        acc.register_for_checkpointing(object())
    seen = []
    acc.register_save_state_pre_hook(lambda models, weights, d: seen.append(("save", d)))
    acc.register_load_state_pre_hook(lambda models, weights, d: seen.append(("load", d)))
    sched = acc.prepare_scheduler(lambda s: 1e-3)
    sched.step()
    sched.step()
    counter.n = 7
    it = iter(dl)
    next(it), next(it)
    ckpt = acc.save_state(train_state=state)
    assert json.loads((Path(ckpt) / "sampler_states.json").read_text()) == [
        {"batches_yielded": 2, "iteration": 0}]
    assert json.loads((Path(ckpt) / "scheduler_states.json").read_text()) == [{"step_count": 2}]
    counter.n, sched._step_count = 0, 0
    acc2, dl2, _, _ = _setup(tmp_path)
    acc2.register_for_checkpointing(counter)
    sched2 = acc2.prepare_scheduler(lambda s: 1e-3)
    acc2.load_state(ckpt)
    assert counter.n == 7 and sched2.state_dict() == {"step_count": 2}
    assert len(list(dl2)) == 2    # the restored loader resumes at batch 2
    assert seen[0][0] == "save" and seen[0][1].endswith(".tmp")


def test_load_rejects_a_mismatched_template_and_the_scan_falls_back(tmp_path):
    acc, dl, state, step = _setup(tmp_path, "lion-sr")
    first = acc.save_state(train_state=state)
    acc.save_state(train_state=state)
    shutil.rmtree(Path(ck.list_checkpoints(str(tmp_path))[-1]) / "train_state")
    for c in ck.list_checkpoints(str(tmp_path)):
        (Path(c) / "checkpoint_manifest.json").unlink()   # legacy: unverified
    _, _, template, _ = _setup(tmp_path, "lion-sr", seed=4)
    acc.load_state(train_state=template)
    assert acc.last_restored_checkpoint == first
    _, _, adam, _ = _setup(tmp_path, "adamw", seed=4)
    with pytest.raises(ValueError, match="does not match"):
        acc.load_state(first, train_state=adam)


def test_parse_size_and_wait_for_published_checkpoint(tmp_path):
    assert ck.parse_size("10GB") == jck.parse_size("10GB") == 10 * 2**30
    assert ck.parse_size("512 MB") == 512 * 2**20
    with pytest.raises(ValueError):
        ck.parse_size("ten gigs")
    target = tmp_path / "checkpoint_0"
    with pytest.raises(TimeoutError, match="not visible"):
        ck.wait_for_published_checkpoint(target, timeout_s=0.2, poll_s=0.02)

    def publish():
        time.sleep(0.15)
        target.mkdir()
        (target / CHECKPOINT_MANIFEST_NAME).write_text("{}")

    t = threading.Thread(target=publish)
    t.start()
    ck.wait_for_published_checkpoint(target, timeout_s=5.0, poll_s=0.02)
    t.join(timeout=5)
    assert not t.is_alive()


def test_optimizer_state_dict_roundtrip():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)
    params = [p.detach().to(torch.bfloat16) for p in model.parameters()]
    opt = AcceleratedOptimizer(make_optimizer("adamw-sr"))
    state = opt.init(params)
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i)).to(p.dtype)
             for i, p in enumerate(params)]
    _, state = opt.update(grads, state, params)
    sd = opt.state_dict(state)
    assert sd["fields"] == {"count": 1} and sd["hyperparams"]["seed"] == 0
    fresh = opt.load_state_dict(sd, opt.init(params))
    assert fresh.count == 1
    for a, b in zip(state.mu + state.nu, fresh.mu + fresh.nu):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not match"):
        AcceleratedOptimizer(make_optimizer("lion-sr")).load_state_dict(
            sd, make_optimizer("lion-sr").init(params))


# -- save_model: the JAX package's bytes, both ways ---------------------------


def _jax_params(dtype):
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_hidden_layers=2)
    params = jl.LlamaForCausalLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(lambda x: np.asarray(x.astype(dtype)), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shard", ["10GB", "40KB"])
def test_save_model_is_the_jax_files_and_loads_both_ways(tmp_path, dtype, shard):
    host = _jax_params(jnp.dtype(dtype))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=tdt), device="cpu")
    # bf16 values cross through f32 exactly
    model.load_state_dict(torch_state_from_flax(jax.tree.map(lambda x: x.astype(np.float32),
                                                             host)))
    # as a train state holds them: every leaf in the one dtype, norm scales too
    params = {n: p.detach().to(tdt) for n, p in model.named_parameters()}
    ported = ck.save_model(None, params, str(tmp_path / "port"), max_shard_size=shard)
    jck.save_model(None, host, str(tmp_path / "jax"), max_shard_size=shard)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(ported) >= 1
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # each package loads the other's directory
    tree = jck.load_model_params(str(tmp_path / "port"))
    want = jax.tree_util.tree_leaves_with_path(host)
    got = dict(jax.tree_util.tree_leaves_with_path(tree))
    for path, leaf in want:
        assert np.asarray(got[path]).tobytes() == np.asarray(leaf).tobytes()
    state = ck.load_model_params(str(tmp_path / "jax"))
    for name, p in params.items():
        assert state[name].dtype == p.dtype and torch.equal(state[name], p), name


def test_accelerator_save_model_and_merge_weights(tmp_path):
    acc, dl, state, step = _setup(tmp_path)
    state, _ = step(state, next(iter(dl)))
    files = acc.save_model(state, str(tmp_path / "model"))
    assert [Path(f).name for f in files] == ["model.safetensors"]
    ckpt = acc.save_state(train_state=state)
    merged = ck.merge_weights(ckpt, str(tmp_path / "merged"))
    assert Path(merged).read_bytes() == Path(files[0]).read_bytes()
    loaded = ck.load_model_params(str(tmp_path / "merged"))
    for n, p in state.params.items():
        assert torch.equal(loaded[n], p)


# -- the interpreter-exit flush ---------------------------------------------

_ORPHAN = textwrap.dedent('''
    import sys
    import torch
    from accelerate_tpu_torch import Accelerator, LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration

    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=sys.argv[1], automatic_checkpoint_naming=True))
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    state = acc.create_train_state(model, "lion-sr")
    acc.save_state(train_state=state, async_save=True)
    # falls off the end: no end_training(), no wait_for_checkpoint()
''')


def test_interpreter_exit_never_orphans_async_save(tmp_path):
    out = subprocess.run([sys.executable, "-c", _ORPHAN, str(tmp_path)], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert not list((tmp_path / "checkpoints").glob("*.tmp"))
    ckpts = ck.list_checkpoints(str(tmp_path))
    assert len(ckpts) == 1 and ck.verify_checkpoint(ckpts[0]) == (True, [])
