"""Gang workers of ``tests/test_torch_expert_parallel.py``: the explicit
expert exchange (``expert_parallel_apply``) on the ep ranks of a gloo
world, the tiny Mixtral's train step with its experts split over ``ep``,
and the sharded -sr / -sr8 updates of the expert slices."""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().float().numpy()


def _apply_case(rank, world, x, g) -> dict:
    """``expert_parallel_apply`` over ``ep`` = the world on this rank's
    capacity block of ``x`` ``[E, C, D]`` (expert e scales by e + 1): the
    output block, the gradient of ``sum(out * g)`` and the global indices
    each rank's experts saw, gathered whole."""
    from ...accelerator import Accelerator
    from ...parallel import collectives as C
    from ...parallel.expert_parallel import expert_parallel_apply
    from ...parallelism_config import ParallelismConfig

    mesh = Accelerator(cpu=True, parallelism_config=ParallelismConfig(ep_size=world)).mesh
    seen = []

    def expert_fn(idx, batch):
        seen.append(idx.clone())
        return batch * (idx.to(batch.dtype) + 1.0)[:, None, None]

    xl = torch.chunk(torch.from_numpy(x), world, dim=1)[rank].contiguous().requires_grad_()
    gl = torch.chunk(torch.from_numpy(g), world, dim=1)[rank]
    out = expert_parallel_apply(mesh, expert_fn, xl)
    (out * gl).sum().backward()
    return {"out": _np(C.all_gather(out.detach().contiguous(), "ep", axis=1, mesh=mesh)),
            "dx": _np(C.all_gather(xl.grad.contiguous(), "ep", axis=1, mesh=mesh)),
            "indices": seen[0].tolist()}


def _ep_train(world, state_path, tokens, config, steps=3) -> dict:
    """The tiny f32 Mixtral for ``steps`` adamw steps (lr 1e-2, clipped at
    1.0) under ``config``, each dp rank on its rows of the batch: the
    losses, grad norms, the local expert shapes and the whole params
    after."""
    from ...accelerator import Accelerator
    from ...data_loader import shard_global_batch
    from ...models import mixtral as tm
    from ...optimizer import make_optimizer

    acc = Accelerator(cpu=True, parallelism_config=config)
    model = tm.MixtralForCausalLM(tm.MixtralConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(torch.load(state_path))
    state = acc.create_train_state(model, make_optimizer("adamw", 1e-2))
    step = acc.prepare_train_step(tm.make_mixtral_loss_fn(model), max_grad_norm=1.0)
    ids = torch.from_numpy(tokens).long()
    local = shard_global_batch(ids, acc.mesh, config.batch_spec(seq_axis=None, ndim=2))
    out = []
    for _ in range(steps):
        state, m = step(state, {"input_ids": local, "labels": local})
        out.append((m["loss"].item(), m["grad_norm"].item()))
    whole = acc.device_params(state.params)
    return {"trajectory": np.asarray(out),
            "local_shapes": {n: tuple(p.shape) for n, p in state.params.items()},
            "params": {n: _np(p) for n, p in whole.items()}}


def ep_checks(rank, world, state_path, tokens, x, g) -> dict:
    """On a world of 4: the exchange over ep 4, the train step under ep 2
    x dp_shard 2 and ep 4, and the -sr / -sr8 expert slices bitwise."""
    from ...parallelism_config import ParallelismConfig
    from .tensor_parallel_checks import _sharded_update_bitwise

    out = {"apply": _apply_case(rank, world, x, g)}
    out["ep2_dp2"] = _ep_train(world, state_path, tokens,
                               ParallelismConfig(dp_shard_size=2, ep_size=2))
    out["ep4"] = _ep_train(world, state_path, tokens, ParallelismConfig(ep_size=4))
    recipes = ("lion-sr", "adamw-sr", "lion-sr8", "adamw-sr8")
    out["bitwise_ep4"] = _sharded_update_bitwise(rank, world, ParallelismConfig(ep_size=4),
                                                 None, recipes, {}, family="mixtral")
    out["bitwise_dp2_ep2"] = _sharded_update_bitwise(
        rank, world, ParallelismConfig(dp_shard_size=2, ep_size=2), None, recipes, {},
        family="mixtral")
    return out
