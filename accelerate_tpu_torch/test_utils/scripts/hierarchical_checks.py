"""Gang workers of ``tests/test_torch_hierarchical.py`` and
``tests/test_torch_powersgd.py``: the Accelerator's hierarchical and
PowerSGD train steps on a gloo world, on the JAX tests' two-layer MLP."""

from __future__ import annotations

import torch

from ...parallel import collectives
from .data_parallel_checks import _np, sgd


def mlp_loss(params, batch):
    """JAX ``_mlp_loss``: a relu MLP's mean squared error."""
    h = torch.relu(batch["x"] @ params["w1"] + params["b1"])
    return torch.mean(((h @ params["w2"])[:, 0] - batch["y"]) ** 2)


def _train(params: dict, batches: list, steps: int, pcfg, plugin=None, handlers=(),
           lr: float = 0.05, record: bool = False):
    """``steps`` steps of sgd over ``batches`` (cycled; each rank its rows of
    each global batch): the accelerator, the state and the losses (with
    ``record``, also the collectives of the first step)."""
    from ...accelerator import Accelerator
    from ...data_loader import shard_global_batch

    acc = Accelerator(cpu=True, parallelism_config=pcfg, fsdp_plugin=plugin,
                      kwargs_handlers=list(handlers))
    state = acc.create_train_state({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                                   sgd(lr))
    step = acc.prepare_train_step(mlp_loss)
    spec = pcfg.batch_spec(seq_axis=None, ndim=2)
    losses, rec = [], None
    for i in range(steps):
        b = batches[i % len(batches)]
        local = shard_global_batch({k: torch.from_numpy(v) for k, v in b.items()}, acc.mesh,
                                   lambda x: spec if x.dim() == 2 else spec[:1])
        if record and i == 0:
            from ...parallel.hierarchical import record_collectives

            with record_collectives() as rec:
                state, m = step(state, local)
        else:
            state, m = step(state, local)
        losses.append(m["loss"].item())
    return acc, state, losses, rec


def _raises(fn) -> str:
    """The message of what ``fn`` raises ('' when it does not)."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def hier_checks(rank: int, world: int, params: dict, batches: list) -> dict:
    """A ``dcn 2 x dp_shard 2`` world: JAX ``tests/test_hierarchical.py``'s
    Accelerator cases."""
    from ...parallel.hierarchical import measure_dcn_bytes
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import FullyShardedDataParallelPlugin, GradSyncKwargs

    def cfg():
        return ParallelismConfig(dcn_size=2, dp_shard_size=world // 2)

    def no_shard():
        return FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD")

    out = {}
    acc, _, out["hier"], _ = _train(params, batches, 12, cfg(), no_shard())
    out["dcn_sync"] = acc.dcn_sync
    _, _, out["hier_again"], _ = _train(params, batches, 12, cfg(), no_shard())
    acc, _, out["flat"], _ = _train(params, batches, 12, cfg(), no_shard(),
                                    [GradSyncKwargs(hierarchical=False)])
    out["flat_dcn_sync"] = acc.dcn_sync
    acc, state, out["dcn_powersgd"], _ = _train(
        params, batches, 60, cfg(), no_shard(),
        [GradSyncKwargs(dcn_compression="powersgd", rank=2)])
    out["dcn_powersgd_sync"] = acc.dcn_sync
    out["dcn_powersgd_qs"] = {n: None if q is None else tuple(q.shape)
                              for n, q in state.comm_state[0].items()}
    out["dcn_powersgd_errs"] = {n: None if e is None else _np(e)
                                for n, e in state.comm_state[1].items()}
    # the step's recorded DCN bytes against the prediction and the flat twin
    for codec, handlers in ((None, []),
                            ("powersgd", [GradSyncKwargs(dcn_compression="powersgd", rank=2)])):
        acc, _, _, rec = _train(params, batches, 1, cfg(), no_shard(), handlers, record=True)
        measured = measure_dcn_bytes(rec, dcn_size=2, rank=rank)
        predicted = acc.dcn_sync_accounting({k: torch.from_numpy(v) for k, v in params.items()})
        out[f"bytes_{codec}"] = {"measured": measured["dcn_bytes"],
                                 "predicted": predicted["dcn_bytes"],
                                 "flat": predicted["dcn_bytes_flat"],
                                 "compression": predicted["compression"],
                                 "rows": measured["collectives"]}
    # the incompatible configurations (JAX test_incompatible_configs_fall_back_or_raise)
    acc, _, losses, _ = _train(params, batches, 3, cfg())   # FULL_SHARD by default
    out["full_shard_sync"], out["full_shard_losses"] = acc.dcn_sync, losses
    out["raise_hierarchical"] = _raises(lambda: _train(
        params, batches, 1, cfg(), handlers=[GradSyncKwargs(hierarchical=True)]))
    out["raise_no_dcn"] = _raises(lambda: _train(
        params, batches, 1, ParallelismConfig(dp_shard_size=world), no_shard(),
        [GradSyncKwargs(dcn_compression="powersgd")]))
    out["raise_topk"] = _raises(lambda: _train(
        params, batches, 1, cfg(), no_shard(), [GradSyncKwargs(dcn_compression="topk")]))
    # the flat DDP codec spans the dcn axis too
    acc, state, out["flat_powersgd"], _ = _train(
        params, batches, 40, cfg(), no_shard(), [GradSyncKwargs(compression="powersgd", rank=2)])
    out["flat_powersgd_sync"] = acc.dcn_sync
    out["flat_powersgd_errs"] = {n: None if e is None else _np(e)
                                 for n, e in state.comm_state[1].items()}
    return out


def powersgd_checks(rank: int, world: int, params: dict, batches: list) -> dict:
    """A data-parallel world of ``world``: JAX ``tests/test_powersgd.py``'s
    Accelerator cases (convergence against dense, per-rank residuals, the
    refused configurations)."""
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import FullyShardedDataParallelPlugin, GradSyncKwargs

    def no_shard():
        return FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD")

    out = {}
    steps = 30 * len(batches)
    _, state, out["powersgd"], _ = _train(params, batches, steps,
                                          ParallelismConfig(dp_shard_size=world), no_shard(),
                                          [GradSyncKwargs(compression="powersgd", rank=2)])
    _, _, out["dense"], _ = _train(params, batches, steps, ParallelismConfig(dp_shard_size=world),
                                   no_shard())
    _, state, _, _ = _train(params, batches, 1, ParallelismConfig(dp_shard_size=world),
                            no_shard(), [GradSyncKwargs(compression="powersgd", rank=2)])
    qs, errs = state.comm_state
    out["q_w1"] = _np(qs["w1"])
    out["err_w1"] = _np(errs["w1"])
    out["err_gathered"] = _np(collectives.all_gather(errs["w1"][None], ("dp_shard",), axis=0))
    # SHARD_GRAD_OP: replicated params, the optimizer on each rank's range
    _, _, out["shard_grad_op"], _ = _train(
        params, batches, 5, ParallelismConfig(dp_shard_size=world),
        FullyShardedDataParallelPlugin(sharding_strategy="SHARD_GRAD_OP", min_weight_size=0),
        [GradSyncKwargs(compression="powersgd", rank=2)])
    # FULL_SHARD declared over a trivial dp_shard axis shards nothing
    _, _, losses, _ = _train(params, batches, 1, ParallelismConfig(dp_replicate_size=world),
                             FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD"),
                             [GradSyncKwargs(compression="powersgd", rank=2)])
    out["declared_full_shard_loss"] = losses[0]
    out["raise_tp"] = _raises(lambda: _train(
        params, batches, 1, ParallelismConfig(dp_shard_size=world // 2, tp_size=2),
        handlers=[GradSyncKwargs(compression="powersgd")]))
    out["raise_full_shard"] = _raises(lambda: _train(
        params, batches, 1, ParallelismConfig(dp_shard_size=world),
        handlers=[GradSyncKwargs(compression="powersgd")]))
    out["raise_hybrid"] = _raises(lambda: _train(
        params, batches, 1, ParallelismConfig(dp_shard_size=world),
        FullyShardedDataParallelPlugin(sharding_strategy="HYBRID_SHARD"),
        [GradSyncKwargs(compression="powersgd")]))
    return out
