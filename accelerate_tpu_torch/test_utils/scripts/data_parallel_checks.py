"""Gang worker of ``tests/test_torch_data_parallel.py``: the sharded train
step on each rank of a 4-rank world, and the data feed."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().cpu().numpy()


class _SGDState(NamedTuple):
    count: int


def sgd(lr: float):
    """Plain SGD as a ``GradientTransformation`` (the JAX test's
    ``optax.sgd``)."""
    from ...ops.stochastic_rounding import GradientTransformation

    def init(params):
        return _SGDState(0)

    def update(grads, state, params):
        return [p - lr * g for g, p in zip(grads, params)], _SGDState(state.count + 1)

    return GradientTransformation(init, update)


def _regression(world: int) -> dict:
    """JAX ``test_dp_sharded_matches_baseline``: y = 2x + 3 regressed over
    two epochs of global batches of 16 split over the ranks."""
    from ...accelerator import Accelerator
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import DataLoaderConfiguration

    rng = np.random.default_rng(42)
    x = rng.normal(size=(64,)).astype(np.float32)
    y = (2.0 * x + 3.0 + 0.05 * rng.normal(size=(64,))).astype(np.float32)
    ds = torch.utils.data.TensorDataset(torch.from_numpy(x), torch.from_numpy(y))
    loader = torch.utils.data.DataLoader(ds, batch_size=16, shuffle=False,
                                         collate_fn=lambda rows: {
                                             "x": torch.stack([r[0] for r in rows]),
                                             "y": torch.stack([r[1] for r in rows])})
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(dp_shard_size=world),
                      dataloader_config=DataLoaderConfiguration(split_batches=True))
    dl = acc.prepare(loader)
    state = acc.create_train_state({"a": torch.tensor(0.0), "b": torch.tensor(0.0)}, sgd(0.1))

    def loss_fn(p, batch):
        return torch.mean((p["a"] * batch["x"] + p["b"] - batch["y"]) ** 2)

    step = acc.prepare_train_step(loss_fn)
    rows = []
    for _ in range(2):
        for batch in dl:
            rows.append(_np(batch["x"]))
            state, m = step(state, batch)
    return {"a": float(state.params["a"]), "b": float(state.params["b"]), "rows": rows}


def _llama_run(world, rank, state_path, batches, config, plugin, recipe: str) -> dict:
    """The tiny f32 Llama for ``len(batches)`` steps of ``recipe`` under a
    config: each rank feeds its rows of every global batch."""
    from ...accelerator import Accelerator
    from ...data_loader import shard_global_batch
    from ...models import llama as tl
    from ...models.llama import make_llama_loss_fn
    from ...optimizer import make_optimizer
    from ...parallel.sharding import (
        make_opt_state_sharding_plan,
        make_sharding_plan,
        opt_state_shapes,
        plan_bytes_per_device,
    )

    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32,
                                                    attn_implementation="flash"), device="cpu")
    model.load_state_dict(torch.load(state_path))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    acc = Accelerator(cpu=True, parallelism_config=config, fsdp_plugin=plugin)
    state = acc.create_train_state(model, recipe)
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=4),
                                  max_grad_norm=1.0)
    spec = config.batch_spec(seq_axis=None, ndim=2)
    out = []
    for ids in batches:
        local = shard_global_batch(torch.from_numpy(ids).long(), acc.mesh, spec)
        state, m = step(state, {"input_ids": local, "labels": local})
        out.append((m["loss"].item(), m["grad_norm"].item()))
    # the ZeRO property: what this rank holds against the plans' bytes
    names = list(acc._dp_plan.layouts)
    whole = make_optimizer(recipe).init([full[n] for n in names])
    plan = make_sharding_plan(full, acc.mesh, config, plugin)
    opt_plan = make_opt_state_sharding_plan(opt_state_shapes(whole, names), plan, acc.mesh,
                                            config, plugin)
    opt_leaves = {f"{field}/{n}": (tuple(t.shape), t.dtype)
                  for field, value in zip(whole._fields, whole) if isinstance(value, list)
                  for n, t in zip(names, value)}
    bytes_plan = (plan_bytes_per_device({n: (tuple(p.shape), p.dtype) for n, p in full.items()},
                                        plan, acc.mesh)
                  + plan_bytes_per_device(opt_leaves, opt_plan, acc.mesh))
    return {"trajectory": np.asarray(out),
            "params": {n: _np(p) for n, p in acc.device_params(state.params).items()},
            "local": {n: _np(p) for n, p in state.params.items()},
            "local_bytes": _local_bytes(state),
            "plan_bytes": bytes_plan,
            "layouts": {n: (lay.param_axes, lay.opt_axes, lay.chunk)
                        for n, lay in acc._dp_plan.layouts.items()}}


def _local_bytes(state) -> int:
    """Bytes this rank holds of the params and of the optimizer state's
    per-leaf tensors."""
    n = sum(p.numel() * p.element_size() for p in state.params.values())
    for value in state.opt_state:
        if isinstance(value, list):
            n += sum(t.numel() * t.element_size() for t in value)
    return n


def _sharded_update_bitwise(rank, world, config, plugin, recipes) -> dict:
    """Two updates of each -sr / -sr8 recipe on bf16 tiny-Llama leaves laid
    out by the plan, given the same reduced gradients (rank 0 sends the
    gradients, the others zeros), against the whole-leaf update in this
    process: the gathered params and the optimizer state, bitwise."""
    from ...models import llama as tl
    from ...optimizer import make_optimizer
    from ...parallel import collectives
    from ...parallel.fsdp import DataParallelPlan, parallel_align
    from ...state import AcceleratorState

    acc_state = AcceleratorState(cpu=True, parallelism_config=config)
    mesh = acc_state.mesh
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.bfloat16), device="cpu", seed=3)
    from ...ops.stochastic_rounding import flax_leaf_order

    named = dict(model.named_parameters())
    full = {n: named[n].detach().to(torch.bfloat16).clone() for n in flax_leaf_order(named)}
    rng = np.random.default_rng(7)
    grads = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 1e-2)
              for p in full.values()] for _ in range(2)]
    out = {}
    for recipe in recipes:
        tx = make_optimizer(recipe)
        plan = DataParallelPlan(mesh, config, plugin, full, align=parallel_align(plugin))
        stored = plan.shard_params({n: p.clone() for n, p in full.items()})
        opt = tx.init(plan.opt_params(stored))
        whole = [p.clone() for p in full.values()]
        opt_w = tx.init(whole)
        for gs in grads:
            mine = [g if rank == 0 else torch.zeros_like(g) for g in gs]
            red = plan.reduce_grads(mine)
            new, opt = tx.update(red, opt, plan.opt_params(stored), numels=plan.numels)
            plan.write_back(stored, new)
            new_w, opt_w = tx.update(gs, opt_w, whole)
            for p, x in zip(whole, new_w):
                p.copy_(x)
        gathered = plan.gather_params(stored)
        same_params = all(torch.equal(gathered[n], w) for n, w in zip(full, whole))
        same_state = True
        for mine_f, whole_f in zip(opt, opt_w):
            if not isinstance(mine_f, list):
                continue
            for lay, a, b in zip(plan.layouts.values(), mine_f, whole_f):
                flat = (collectives.gather_flat(a, collectives.group(lay.opt_axes, mesh))
                        if lay.sharded else a.reshape(-1))
                same_state &= torch.equal(flat[:b.numel()], b.reshape(-1))
        out[recipe] = {"params": same_params, "state": same_state}
    out["dim1_leaves"] = [n for n, spec in _port_plan(full, mesh, config, plugin).items()
                          if len(spec) == 2 and spec[1] is not None]
    out["sharded_leaves"] = [n for n, lay in plan.layouts.items() if lay.sharded]
    return out


def _port_plan(full, mesh, config, plugin):
    from ...parallel.sharding import make_sharding_plan

    return make_sharding_plan(full, mesh, config, plugin)


def _feeds(rank, world) -> dict:
    """``gather_for_metrics`` over a padded last batch, and the rows each
    rank reads under ``split_batches`` (with and without cp peers)."""
    from ...accelerator import Accelerator
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import DataLoaderConfiguration

    out = {}
    ds = torch.utils.data.TensorDataset(torch.arange(10.0))
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(dp_shard_size=world))
    dl = acc.prepare(torch.utils.data.DataLoader(ds, batch_size=2))
    out["metrics"] = np.concatenate([_np(acc.gather_for_metrics(b[0])) for b in dl])
    rows = torch.utils.data.TensorDataset(torch.arange(16))
    for label, cfg in (("dp_shard", ParallelismConfig(dp_shard_size=world)),
                       ("cp", ParallelismConfig(cp_size=2, dp_shard_size=world // 2))):
        acc = Accelerator(cpu=True, parallelism_config=cfg,
                          dataloader_config=DataLoaderConfiguration(split_batches=True))
        dl = acc.prepare(torch.utils.data.DataLoader(rows, batch_size=8))
        out[f"rows_{label}"] = [_np(b[0]) for b in dl]
    return out


def dp_checks(rank: int, world: int, state_path: str, batches: list) -> dict:
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import FullyShardedDataParallelPlugin

    out = {"regression": _regression(world), "feeds": _feeds(rank, world)}
    runs = {
        "dp_shard": (ParallelismConfig(dp_shard_size=world),
                     FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD",
                                                    min_weight_size=0)),
        "hsdp": (ParallelismConfig(dp_replicate_size=2, dp_shard_size=world // 2),
                 FullyShardedDataParallelPlugin(sharding_strategy="HYBRID_SHARD",
                                                min_weight_size=0)),
    }
    for label, (cfg, plugin) in runs.items():
        out[label] = _llama_run(world, rank, state_path, batches, cfg, plugin, "adamw")
    for label, cfg, strategy in (
            ("FULL_SHARD", ParallelismConfig(dp_shard_size=world), "FULL_SHARD"),
            ("SHARD_GRAD_OP", ParallelismConfig(dp_shard_size=world), "SHARD_GRAD_OP"),
            ("FULL_SHARD_cp", ParallelismConfig(cp_size=2, dp_shard_size=world // 2),
             "FULL_SHARD")):
        plugin = FullyShardedDataParallelPlugin(sharding_strategy=strategy, min_weight_size=0)
        out[f"bitwise_{label}"] = _sharded_update_bitwise(
            rank, world, cfg, plugin, ("lion-sr", "lion-sr8", "adamw-sr", "adamw-sr8"))
    return out
