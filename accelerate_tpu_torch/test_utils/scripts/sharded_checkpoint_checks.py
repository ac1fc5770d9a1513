"""Gang workers of ``tests/test_torch_sharded_checkpoint.py``: train states
sharded or split over the ranks of a gloo world, saved by each rank
(synchronously and asynchronously) and restored onto another world and
plan, in the style of ``hierarchical_checks.py``.

- :func:`save_gang`: for each case (FULL_SHARD, SHARD_GRAD_OP, tp x dp,
  ep x dp; lion-sr8 and adamw-sr8) the tiny bf16 model trains 2 steps,
  ``save_state`` writes the sharded checkpoint, each rank returns its
  holding of the saved state (``checkpointing.gathered_state``), the
  uninterrupted third step, and a restore onto the same world and plan
  whose third step is bitwise the uninterrupted one.
- :func:`restore_gang`: each checkpoint restored onto another world and
  plan, held bitwise to the state the target plan holds of the saved
  whole state (params by ``shard_params``; optimizer tensors sliced the
  same way, padding lanes left as the template's), and the next step from
  both bitwise; plus the 2-rank saves (synchronous, asynchronous, and one
  left to the interpreter-exit flush) and the codec's refusal of another
  world.
- :func:`elastic_save` / :func:`elastic_restore`: JAX's
  ``test_elastic_reshard_restore_across_chip_counts`` on the port.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .data_parallel_checks import _np

# label -> (parallelism config, sharding strategy, model)
SAVE_CASES = {
    "full_shard": (dict(dp_shard_size=4), "FULL_SHARD", "llama"),
    "shard_grad_op": (dict(dp_shard_size=4), "SHARD_GRAD_OP", "llama"),
    "tp": (dict(dp_shard_size=2, tp_size=2), "FULL_SHARD", "llama"),
    "ep": (dict(dp_shard_size=2, ep_size=2), "FULL_SHARD", "mixtral"),
}
# label -> the world-of-2 plan it is restored onto
RESTORE_CASES = {
    "full_shard": (dict(dp_shard_size=2), "FULL_SHARD"),
    "shard_grad_op": (dict(dp_shard_size=2), "NO_SHARD"),
    "tp": (dict(tp_size=2), "FULL_SHARD"),
    "ep": (dict(ep_size=2), "FULL_SHARD"),
}
RECIPES = ("lion-sr8", "adamw-sr8")


def _model(kind: str, seed: int):
    if kind == "mixtral":
        from ...models import mixtral as tm

        return tm.MixtralForCausalLM(tm.MixtralConfig.tiny(dtype=torch.bfloat16), device="cpu",
                                     seed=seed)
    from ...models import llama as tl

    return tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.bfloat16), device="cpu",
                               seed=seed)


def _loss_fn(kind: str, model):
    if kind == "mixtral":
        from ...models.mixtral import make_mixtral_loss_fn

        return make_mixtral_loss_fn(model)
    from ...models.llama import make_llama_loss_fn

    return make_llama_loss_fn(model, fused_vocab_chunks=4)


def _accelerator(cfg: dict, strategy: str, **kw):
    from ...accelerator import Accelerator
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import FullyShardedDataParallelPlugin

    pcfg = ParallelismConfig(**cfg) if cfg is not None else None
    plugin = (FullyShardedDataParallelPlugin(sharding_strategy=strategy, min_weight_size=0)
              if cfg is not None else None)
    return Accelerator(cpu=True, parallelism_config=pcfg, fsdp_plugin=plugin, **kw)


def _setup(cfg, strategy, kind, recipe, seed, **kw):
    """An accelerator, a fresh state of the seeded model and its step."""
    acc = _accelerator(cfg, strategy, **kw)
    model = _model(kind, seed)
    state = acc.create_train_state(model, recipe)
    return acc, state, acc.prepare_train_step(_loss_fn(kind, model))


def _batch(acc, ids: np.ndarray) -> dict:
    from ...data_loader import shard_global_batch

    t = torch.from_numpy(ids).long()
    if acc._dp_plan is None:
        return {"input_ids": t, "labels": t}
    local = shard_global_batch(t, acc.mesh,
                               acc.parallelism_config.batch_spec(seq_axis=None, ndim=2))
    return {"input_ids": local, "labels": local}


def _holding(state, plan) -> dict:
    from ...checkpointing import gathered_state

    return {k: (_np(flat) if flat.dtype == torch.bfloat16 else flat.numpy(), runs, length)
            for k, (flat, runs, length) in gathered_state(state, plan).items()}


def _local(state) -> dict:
    """This rank's params and optimizer tensors as they are stored."""
    from ...optimizer import flatten_opt_state

    out = {f"p/{n}": p.detach().clone() for n, p in state.params.items()}
    out.update({f"o/{i}": t.detach().clone()
                for i, t in enumerate(flatten_opt_state(state.opt_state)[0])})
    return out


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def save_gang(rank: int, world: int, root: str, batches: list, cases=None) -> dict:
    """Every case of :data:`SAVE_CASES` x :data:`RECIPES` on this world:
    2 steps, a synchronous save, the holding of the saved state, the
    uninterrupted third step, and a restore onto the same plan (the
    template from another seed) whose third step is bitwise it."""
    out = {}
    for label in cases or SAVE_CASES:
        cfg, strategy, kind = SAVE_CASES[label]
        for recipe in RECIPES:
            acc, state, step = _setup(cfg, strategy, kind, recipe, seed=3)
            for ids in batches[:2]:
                state, _ = step(state, _batch(acc, ids))
            path = acc.save_state(str(Path(root) / f"{label}_{recipe}"), train_state=state)
            holding = _holding(state, acc._dp_plan)
            state, m = step(state, _batch(acc, batches[2]))
            after = _local(state)
            acc2, template, step2 = _setup(cfg, strategy, kind, recipe, seed=11)
            restored = acc2.load_state(path, train_state=template)
            restored, m2 = step2(restored, _batch(acc2, batches[2]))
            out[f"{label}_{recipe}"] = {
                "path": path, "holding": holding, "loss3": m["loss"].item(),
                "resumed_loss3": m2["loss"].item(),
                "resumed_bitwise": _same(after, _local(restored)),
                "sharded": acc._dp_plan.any_sharded, "tp": acc._dp_plan.tp,
                "ep": acc._dp_plan.ep}
    # a codec state: its rows belong to this world
    from ...utils.dataclasses import GradSyncKwargs

    acc, state, step = _setup(dict(dp_shard_size=world), "NO_SHARD", "llama", "lion-sr8", 3,
                              kwargs_handlers=[GradSyncKwargs(compression="powersgd", rank=2)])
    state, _ = step(state, _batch(acc, batches[0]))
    out["codec_path"] = acc.save_state(str(Path(root) / "codec"), train_state=state)
    return out


def _reference(plan, template, whole: dict) -> dict:
    """The state ``plan`` holds of the whole saved tensors ``whole`` (``{key:
    1-D array}``), built without the checkpoint's runs: params through
    ``shard_params``; each optimizer tensor through ``shard_params`` /
    ``opt_params`` of the whole tensor (a per-block tensor through the
    block index of each of its elements), padding lanes the template's."""
    from ...checkpointing import _layout

    out = {}
    layout = _layout(template, plan)
    params = {n: torch.from_numpy(whole[f"p/{n}"]).to(p.dtype).reshape(
        plan.layouts[n].whole_shape) for n, p in template.params.items()}
    out.update({f"p/{n}": t for n, t in plan.shard_params(params).items()})
    for key, (t, _, length, leaf) in layout.items():
        if not key.startswith("o/"):
            continue
        lay = plan.layouts[leaf]
        elem = length == lay.whole_numel
        index = torch.arange(1, lay.whole_numel + 1, dtype=torch.float64)
        if not elem:
            index = torch.div(index - 1, plan.align, rounding_mode="floor") + 1
        spread = plan.opt_params(plan.shard_params({leaf: index.reshape(lay.whole_shape)}))[0]
        spread = spread.reshape(-1).long()
        src = torch.from_numpy(whole[key]).to(t.dtype)
        if not elem:
            spread = spread[::plan.align][:t.numel()] if spread.numel() > t.numel() else spread
        ref = t.detach().clone().reshape(-1)
        valid = spread > 0
        ref[valid] = src[spread[valid] - 1]
        out[key] = ref.reshape(t.shape)
    return out


def restore_gang(rank: int, world: int, root: str, batches: list, saved: dict,
                 whole: dict, single_path: str) -> dict:
    """Each world-of-4 checkpoint restored onto its :data:`RESTORE_CASES`
    plan: the restored holding, whether it equals the target plan's
    reference state bitwise, and the next step from both (loss, params,
    optimizer tensors); the one-process checkpoint ``single_path`` onto
    FULL_SHARD (1 -> 2); then this world's own saves."""
    out = {}
    targets = {f"{label}_{recipe}": (RESTORE_CASES[label], SAVE_CASES[label][2], recipe)
               for label in RESTORE_CASES for recipe in RECIPES}
    targets["single_lion-sr8"] = (RESTORE_CASES["full_shard"], "llama", "lion-sr8")
    for key, ((cfg, strategy), kind, recipe) in targets.items():
        path = single_path if key.startswith("single") else saved[key]
        acc, template, step = _setup(cfg, strategy, kind, recipe, seed=11)
        restored = acc.load_state(path, train_state=template)
        acc_r, ref, step_r = _setup(cfg, strategy, kind, recipe, seed=13)
        want = _reference(acc_r._dp_plan, ref, whole[key])
        holding = _holding(restored, acc._dp_plan)
        same_state = _same(_local(restored), want)
        # the reference state in place, then one step of each
        ref_state = acc_r.load_state(path, train_state=ref)   # step count, rng
        from ...optimizer import flatten_opt_state, unflatten_opt_state

        with torch.no_grad():
            for n, p in ref_state.params.items():
                p.copy_(want[f"p/{n}"])
        n_opt = len(flatten_opt_state(ref_state.opt_state)[0])
        from ...checkpointing import _Source

        src = _Source(Path(path) / "train_state")
        ref_state = ref_state.replace(opt_state=unflatten_opt_state(
            ref_state.opt_state, [want[f"o/{i}"] for i in range(n_opt)],
            src.opt_meta["fields"], src.opt_meta["hyperparams"]))
        restored, m = step(restored, _batch(acc, batches[2]))
        ref_state, m_r = step_r(ref_state, _batch(acc_r, batches[2]))
        out[key] = {"holding": holding, "same_state": same_state,
                    "loss": m["loss"].item(), "ref_loss": m_r["loss"].item(),
                    "next_bitwise": _same(_local(restored), _local(ref_state)),
                    "step": int(restored.step)}
    out.update(_world_saves(rank, world, root, batches))
    # the codec's rows restore only onto the world that wrote them
    from ...utils.dataclasses import GradSyncKwargs

    acc, template, _ = _setup(dict(dp_shard_size=world), "NO_SHARD", "llama", "lion-sr8", 11,
                              kwargs_handlers=[GradSyncKwargs(compression="powersgd", rank=2)])
    try:
        acc.load_state(saved["codec_path"], train_state=template)
        out["codec_error"] = ""
    except ValueError as e:
        out["codec_error"] = str(e)
    return out


def _world_saves(rank, world, root, batches) -> dict:
    """This world's own saves of a FULL_SHARD lion-sr8 state: synchronous
    (restored in one process by the caller: 2 -> 1); asynchronous, with a
    step updating the params in place under the write, published once at
    ``wait_for_checkpoint`` and holding the state of the save."""
    from ...checkpointing import list_checkpoints
    from ...utils.dataclasses import ProjectConfiguration

    out = {}
    cfg = RESTORE_CASES["full_shard"][0]
    acc, state, step = _setup(cfg, "FULL_SHARD", "llama", "lion-sr8", 3)
    for ids in batches[:2]:
        state, _ = step(state, _batch(acc, ids))
    out["sync2_path"] = acc.save_state(str(Path(root) / "sync2"), train_state=state)
    out["sync2_holding"] = _holding(state, acc._dp_plan)
    project = Path(root) / "async2"
    acc, state, step = _setup(cfg, "FULL_SHARD", "llama", "lion-sr8", 3,
                              project_config=ProjectConfiguration(
                                  project_dir=str(project), automatic_checkpoint_naming=True))
    for ids in batches[:2]:
        state, _ = step(state, _batch(acc, ids))
    want = _local(state)
    path = acc.save_state(train_state=state, async_save=True)
    state, _ = step(state, _batch(acc, batches[2]))   # in place, under the write
    out["async_unpublished_before_wait"] = not Path(path).exists()
    acc.wait_for_checkpoint()
    out["async_path"] = path
    out["async_published"] = list_checkpoints(str(project))
    acc2, template, _ = _setup(cfg, "FULL_SHARD", "llama", "lion-sr8", 11)
    out["async_restored_bitwise"] = _same(_local(acc2.load_state(path, train_state=template)),
                                          want)
    # an async save left to the interpreter-exit flush: never published
    acc3, state, step = _setup(cfg, "FULL_SHARD", "llama", "lion-sr8", 3,
                               project_config=ProjectConfiguration(
                                   project_dir=str(Path(root) / "exit2"),
                                   automatic_checkpoint_naming=True))
    state, _ = step(state, _batch(acc3, batches[0]))
    out["exit_path"] = acc3.save_state(train_state=state, async_save=True)
    return out


# -- JAX's test_elastic_reshard_restore_across_chip_counts ---------------------------------


def _mlp_run(pcfg, params: dict, project: str):
    from ...optimizer import adamw
    from ...utils.dataclasses import FullyShardedDataParallelPlugin, ProjectConfiguration
    from ...accelerator import Accelerator
    from .hierarchical_checks import mlp_loss

    acc = Accelerator(cpu=True, parallelism_config=pcfg,
                      fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD"),
                      project_config=ProjectConfiguration(project_dir=project,
                                                          automatic_checkpoint_naming=True))
    state = acc.create_train_state({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                                   adamw(1e-2, weight_decay=0.0))
    return acc, state, acc.prepare_train_step(mlp_loss)


def _mlp_batch(acc, batch: dict) -> dict:
    from ...data_loader import shard_global_batch

    spec = acc.parallelism_config.batch_spec(seq_axis=None, ndim=2)
    return shard_global_batch({k: torch.from_numpy(v) for k, v in batch.items()}, acc.mesh,
                              lambda x: spec if x.dim() == 2 else spec[:1])


def elastic_save(rank: int, world: int, project: str, params: dict, batch: dict) -> dict:
    """A ``dcn 2 x dp_shard 2`` NO_SHARD world (the hierarchical step): 3
    adam steps on one batch, then a save."""
    from ...parallelism_config import ParallelismConfig

    acc, state, step = _mlp_run(ParallelismConfig(dcn_size=2, dp_shard_size=world // 2),
                                params, project)
    for _ in range(3):
        state, _ = step(state, _mlp_batch(acc, batch))
    acc.save_state(train_state=state)
    return {"params": {k: _np(v).copy() for k, v in state.params.items()},
            "hierarchical": acc.dcn_sync["enabled"]}


def elastic_restore(rank: int, world: int, project: str, params: dict, batch: dict) -> dict:
    """``maybe_resume`` on a ``dp_shard`` world of another size, from a
    template of other weights, then one step."""
    from ...parallelism_config import ParallelismConfig

    acc, state, step = _mlp_run(ParallelismConfig(dp_shard_size=world), params, project)
    restored = acc.maybe_resume(train_state=state)
    out = {"step": int(restored.step), "step_count": acc.step_count,
           "params": {k: _np(v).copy() for k, v in restored.params.items()}}
    restored, m = step(restored, _mlp_batch(acc, batch))
    out["loss"] = m["loss"].item()
    return out
