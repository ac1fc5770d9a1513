"""Checkpoints of a train state sharded or split across ranks
(``accelerate_tpu_torch/checkpointing.py``'s sharded layout) on gloo gangs.

A world of 4 trains the tiny bf16 Llama (or Mixtral under ep) two steps
under FULL_SHARD, SHARD_GRAD_OP, tp 2 x dp 2 and ep 2 x dp 2, with
lion-sr8 and adamw-sr8, and saves: each rank writes only its ranges,
padding never, and the ranks' pieces tile every tensor exactly once.  A
restore onto the same plan continues bitwise with the uninterrupted run.
A world of 2 restores each onto another plan (4 -> 2), and the
one-process checkpoint onto FULL_SHARD (1 -> 2): the restored state is
bitwise the state the target plan holds of the saved whole state (its
params through ``shard_params``, every code and scale), and the next step
from both is bitwise.  One process restores every checkpoint (4 -> 1,
2 -> 1) bitwise the gathered state.  An async save across 2 ranks is
published once, at ``wait_for_checkpoint``, verified, and holds the state
of the save; one left to the interpreter-exit flush is never published.
``merge_weights`` of a sharded checkpoint is ``save_model`` of the
gathered params, byte for byte; the codec's rows refuse another world.
JAX's ``test_elastic_reshard_restore_across_chip_counts`` is held on the
port against JAX's own run.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.checkpointing import (
    _Source,
    assemble_state,
    gathered_state,
    list_checkpoints,
    merge_weights,
    save_model,
    verify_checkpoint,
)
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.optimizer import flatten_opt_state, unflatten_opt_state
from accelerate_tpu_torch.test_utils.gang import run_gang
from accelerate_tpu_torch.test_utils.scripts import sharded_checkpoint_checks as checks
from accelerate_tpu_torch.utils.serialization import _STR_TO_DTYPE

TARGET = "accelerate_tpu_torch.test_utils.scripts.sharded_checkpoint_checks"
KEYS = [f"{label}_{recipe}" for label in checks.SAVE_CASES for recipe in checks.RECIPES]


def _batches() -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, size=(4, 16)).astype(np.int64) for _ in range(3)]


def _whole(holdings: list) -> dict:
    pieces = [{k: (torch.from_numpy(np.ascontiguousarray(f)), r, n) for k, (f, r, n) in h.items()}
              for h in holdings]
    return {k: v.numpy() for k, v in assemble_state(pieces).items()}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded_ckpt")


@pytest.fixture(scope="module")
def saved(root):
    return run_gang(f"{TARGET}:save_gang", 4, root / "gang4", timeout=120,
                    root=str(root / "ckpt"), batches=_batches())


@pytest.fixture(scope="module")
def single(root):
    """A one-process lion-sr8 state after 2 steps, saved whole."""
    acc = Accelerator(cpu=True)
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.bfloat16), device="cpu", seed=3)
    state = acc.create_train_state(model, "lion-sr8")
    step = acc.prepare_train_step(tl.make_llama_loss_fn(model, fused_vocab_chunks=4))
    for ids in _batches()[:2]:
        t = torch.from_numpy(ids)
        state, _ = step(state, {"input_ids": t, "labels": t})
    path = acc.save_state(str(root / "single"), train_state=state)
    return path, {k: f.float().numpy() if f.dtype == torch.bfloat16 else f.numpy()
                  for k, f in assemble_state([gathered_state(state)]).items()}


@pytest.fixture(scope="module")
def wholes(saved, single):
    out = {key: _whole([r[key]["holding"] for r in saved]) for key in KEYS}
    out["single_lion-sr8"] = single[1]
    return out


@pytest.fixture(scope="module")
def restored(root, saved, single, wholes):
    paths = {key: saved[0][key]["path"] for key in KEYS}
    paths["codec_path"] = saved[0]["codec_path"]
    return run_gang(f"{TARGET}:restore_gang", 2, root / "gang2", timeout=120,
                    root=str(root / "ckpt2"), batches=_batches(), saved=paths, whole=wholes,
                    single_path=single[0])


def test_each_rank_writes_only_its_ranges(saved):
    """The pieces the ranks wrote tile every tensor exactly once (a range
    held by several ranks is written by one, padding by none); no shard
    holds the whole state; rank 0 wrote the index."""
    for key in KEYS:
        path = Path(saved[0][key]["path"]) / "train_state"
        src = _Source(path)
        assert src.sharded and src.world == 4
        assert sorted(p.name for p in path.iterdir()) == [
            "index.json", *[f"shard_{r:05d}.safetensors" for r in range(4)],
            "state.safetensors"]
        for tkey, pieces in src.pieces.items():
            runs = np.concatenate([r for _, _, r in pieces])
            length = runs[:, 2].sum()
            whole = (int(np.prod(src.params[tkey[2:]][1])) if tkey.startswith("p/")
                     else src.opt[int(tkey[2:])][1])
            assert length == whole, (key, tkey)
            covered = np.zeros(whole, dtype=int)
            for g, _, n in runs.tolist():
                covered[g:g + n] += 1
            assert (covered == 1).all(), (key, tkey)
        sizes = [(path / f"shard_{r:05d}.safetensors").stat().st_size for r in range(4)]
        if saved[0][key]["sharded"]:
            assert max(sizes) < 0.75 * sum(sizes), (key, sizes)


def test_restore_onto_the_same_plan_continues_bitwise(saved):
    for rank in saved:
        for key in KEYS:
            rep = rank[key]
            assert rep["resumed_bitwise"], key
            assert rep["resumed_loss3"] == rep["loss3"], key


@pytest.mark.parametrize("key", KEYS + ["single_lion-sr8"])
def test_restore_onto_another_world_and_plan_is_the_target_plans_state(restored, wholes, key):
    """4 -> 2 onto another plan (and 1 -> 2): every leaf, code and scale
    bitwise the saved whole state, each rank's tensors bitwise the state
    the target plan holds of it, and the next step from both bitwise."""
    reps = [r[key] for r in restored]
    assert _equal(_whole([r["holding"] for r in reps]), wholes[key])
    for rep in reps:
        assert rep["same_state"], key
        assert rep["next_bitwise"], key
        assert rep["loss"] == rep["ref_loss"] and np.isfinite(rep["loss"])
        assert rep["step"] == 3


def _one_process(path: str, kind: str, recipe: str):
    acc = Accelerator(cpu=True)
    model = checks._model(kind, seed=11)
    template = acc.create_train_state(model, recipe)
    state = acc.load_state(path, train_state=template)
    return acc, model, state


@pytest.mark.parametrize("key", KEYS)
def test_restore_onto_one_process_is_the_gathered_state(saved, wholes, key):
    """4 -> 1: the whole leaves, codes and scales, bitwise; the next step
    from the restored state is bitwise the step from the gathered one."""
    label, recipe = key.rsplit("_", 1)
    kind = checks.SAVE_CASES[label][2]
    acc, model, state = _one_process(saved[0][key]["path"], kind, recipe)
    got = {k: f.float().numpy() if f.dtype == torch.bfloat16 else f.numpy()
           for k, f in assemble_state([gathered_state(state)]).items()}
    assert _equal(got, wholes[key])
    # the gathered state put in place by hand, then a step of each
    _, model2, ref = _one_process(saved[0][key]["path"], kind, recipe)
    with torch.no_grad():
        for n, p in ref.params.items():
            p.copy_(torch.from_numpy(wholes[key][f"p/{n}"]).reshape(p.shape))
    tensors, meta = flatten_opt_state(ref.opt_state)
    ref = ref.replace(opt_state=unflatten_opt_state(
        ref.opt_state, [torch.from_numpy(wholes[key][f"o/{i}"]).to(t.dtype).reshape(t.shape)
                        for i, t in enumerate(tensors)],
        meta["fields"], {k: (v.item() if hasattr(v, "item") else v)
                         for k, v in meta["hyperparams"].items()}))
    ids = torch.from_numpy(_batches()[2])
    state, m = acc.prepare_train_step(checks._loss_fn(kind, model))(
        state, {"input_ids": ids, "labels": ids})
    ref, m_ref = acc.prepare_train_step(checks._loss_fn(kind, model2))(
        ref, {"input_ids": ids, "labels": ids})
    assert m["loss"].item() == m_ref["loss"].item() and np.isfinite(m["loss"].item())
    for n in state.params:
        assert torch.equal(state.params[n], ref.params[n]), n


def test_world_of_two_saves_restore_onto_one_process(restored):
    """2 -> 1 of the synchronous save."""
    out = restored[0]
    _, _, state = _one_process(out["sync2_path"], "llama", "lion-sr8")
    got = {k: f.float().numpy() if f.dtype == torch.bfloat16 else f.numpy()
           for k, f in assemble_state([gathered_state(state)]).items()}
    assert _equal(got, _whole([r["sync2_holding"] for r in restored]))


def test_async_save_across_two_ranks_published_once(restored):
    for out in restored:
        assert out["async_unpublished_before_wait"]
        assert out["async_published"] == [out["async_path"]]
        assert out["async_restored_bitwise"]
    ok, problems = verify_checkpoint(restored[0]["async_path"])
    assert ok and not problems
    assert not list(Path(restored[0]["async_path"]).parent.glob("*.tmp"))


def test_interpreter_exit_flush_never_publishes_across_processes(restored):
    """An async save whose gang exits without a publish point: each rank's
    writer finished, but no rank published it alone."""
    path = Path(restored[0]["exit_path"])
    assert not path.exists()
    staging = path.parent / (path.name + ".tmp")
    assert sorted(p.name for p in (staging / "train_state").iterdir()) == [
        "index.json", "shard_00000.safetensors", "shard_00001.safetensors",
        "state.safetensors"]
    assert list_checkpoints(str(path.parent.parent)) == []


def test_merge_weights_of_a_sharded_checkpoint_is_save_model(saved, wholes, tmp_path):
    for key in ("full_shard_lion-sr8", "tp_adamw-sr8"):
        merged = merge_weights(saved[0][key]["path"], str(tmp_path / key / "merged"))
        src = _Source(Path(saved[0][key]["path"]) / "train_state")
        params = {n: torch.from_numpy(wholes[key][f"p/{n}"]).to(_STR_TO_DTYPE[dtype])
                  .reshape(shape) for n, (dtype, shape) in src.params.items()}
        want = save_model(None, params, str(tmp_path / key / "model"),
                          max_shard_size=f"{2**40}B")[0]
        assert Path(merged).read_bytes() == Path(want).read_bytes()


def test_codec_state_refuses_another_world(restored):
    assert "ranks' rows" in restored[0]["codec_error"]
    assert "this world has 2" in restored[0]["codec_error"]


def _mlp_params() -> dict:
    k1, k2 = jax.random.split(jax.random.key(0))
    return {"b1": np.zeros((32,), np.float32),
            "w1": np.asarray(jax.random.normal(k1, (8, 32))) * 0.3,
            "w2": np.asarray(jax.random.normal(k2, (32, 1))) * 0.3}


def _mlp_batch() -> dict:
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    return {"x": x, "y": (x @ w_true).astype(np.float32)}


def test_elastic_reshard_restore_across_process_counts(tmp_path):
    """JAX ``test_elastic_reshard_restore_across_chip_counts`` on the port:
    a dcn 2 x dp_shard 2 NO_SHARD gang's checkpoint after 3 adam steps
    restores onto a dp_shard 2 gang (a template of other weights) bitwise,
    at step 3 with ``step_count`` 3, then takes a finite step; its params
    are JAX's on the same weights and batch (rtol 1e-5)."""
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import ParallelismConfig as JaxParallelismConfig
    from accelerate_tpu.state import AcceleratorState, GradientState
    from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin, ShardingStrategy

    params, batch = _mlp_params(), _mlp_batch()
    project = str(tmp_path / "project")
    saved = run_gang(f"{TARGET}:elastic_save", 4, tmp_path / "g4", timeout=60, project=project,
                     params=params, batch=batch)
    other = {k: v + 1.0 for k, v in params.items()}
    resumed = run_gang(f"{TARGET}:elastic_restore", 2, tmp_path / "g2", timeout=60,
                       project=project, params=other, batch=batch)
    assert saved[0]["hierarchical"]
    for rep in resumed:
        assert rep["step"] == 3 and rep["step_count"] == 3
        assert _equal(rep["params"], saved[0]["params"])
        assert np.isfinite(rep["loss"])
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = JaxAccelerator(parallelism_config=JaxParallelismConfig(
        dcn_size=2, dp_shard_size=2, devices=tuple(jax.devices()[:4])),
        fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy=ShardingStrategy.NO_SHARD))
    state = acc.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), optax.adam(1e-2))

    def loss_fn(p, b):
        h = jax.nn.relu(b["x"] @ p["w1"] + p["b1"])
        return jnp.mean(((h @ p["w2"])[:, 0] - b["y"]) ** 2)

    step = acc.prepare_train_step(loss_fn)
    for _ in range(3):
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
    for k, v in state.params.items():
        np.testing.assert_allclose(resumed[0]["params"][k], np.asarray(v), rtol=1e-5, atol=1e-6)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
