"""Gang workers of ``tests/test_torch_hierarchical.py`` and
``tests/test_torch_powersgd.py``: the Accelerator's hierarchical and
PowerSGD train steps on a gloo world, on the JAX tests' two-layer MLP."""

from __future__ import annotations

import numpy as np
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


def masked_ce_loss(params, batch):
    """A token mean over labels, ``-100`` masked: a one-layer tanh model's
    next-token cross entropy (``labels`` shifted by one, as
    ``DataParallelPlan.token_weight`` reads them)."""
    logits = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    logits, labels = logits[:, :-1], batch["labels"][:, 1:]
    valid = labels != -100
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    ce = torch.logsumexp(logits, -1) - picked
    return (ce * valid).sum() / valid.sum().clamp(min=1)


def _recording_sgd(lr: float, seen: list):
    """:func:`sgd` that keeps a copy of every gradient list it is given
    (the step's reduced gradients)."""
    inner = sgd(lr)

    def update(grads, state, params):
        seen.append([g.detach().clone() for g in grads])
        return inner.update(grads, state, params)

    return type(inner)(inner.init, update)


def masked_codec_steps(rank: int, world: int, params: dict, batches: list, qs: dict,
                       kind: str, rank_q: int = 2, lr: float = 0.1) -> dict:
    """``len(batches)`` codec steps of :func:`masked_ce_loss` whose ranks
    hold unequal counts of valid labels: ``kind`` ``"powersgd"`` (the flat
    codec over ``dp_shard = world``), ``"hier"`` (the dense hierarchical
    step on ``dcn 2 x dp_shard world/2``) or ``"hier_powersgd"`` (its DCN
    codec).  ``qs`` are the codec's starting Qs (JAX's, carried over).
    Returns each step's loss, reduced gradients and this rank's
    residuals."""
    from ...accelerator import Accelerator
    from ...data_loader import shard_global_batch
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import FullyShardedDataParallelPlugin, GradSyncKwargs

    if kind == "powersgd":
        pcfg = ParallelismConfig(dp_shard_size=world)
        handlers = [GradSyncKwargs(compression="powersgd", rank=rank_q)]
    else:
        pcfg = ParallelismConfig(dcn_size=2, dp_shard_size=world // 2)
        handlers = ([GradSyncKwargs(dcn_compression="powersgd", rank=rank_q)]
                    if kind == "hier_powersgd" else [])
    acc = Accelerator(cpu=True, parallelism_config=pcfg, kwargs_handlers=handlers,
                      fsdp_plugin=FullyShardedDataParallelPlugin(sharding_strategy="NO_SHARD"))
    seen: list = []
    state = acc.create_train_state({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                                   _recording_sgd(lr, seen))
    if state.comm_state is not None:
        q0, e0 = state.comm_state
        state = state.replace(comm_state=(
            {n: None if q is None else torch.from_numpy(np.array(qs[n])) for n, q in q0.items()},
            e0))
    step = acc.prepare_train_step(masked_ce_loss)
    spec = pcfg.batch_spec(seq_axis=None, ndim=3)
    out = {"losses": [], "grads": [], "errs": [], "dcn_sync": acc.dcn_sync}
    for b in batches:
        local = shard_global_batch({k: torch.from_numpy(v) for k, v in b.items()}, acc.mesh,
                                   lambda x: spec if x.dim() == 3 else spec[:2])
        state, m = step(state, local)
        out["losses"].append(m["loss"].item())
        out["grads"].append(dict(zip(state.params, [_np(g) for g in seen[-1]])))
        if state.comm_state is not None:
            out["errs"].append({n: None if e is None else _np(e)
                                for n, e in state.comm_state[1].items()})
    return out


def masked_codec_checks(rank: int, world: int, params: dict, batches: list,
                        qs: dict) -> dict:
    """:func:`masked_codec_steps` for each kind ``qs`` names (kind ->
    starting Qs)."""
    return {kind: masked_codec_steps(rank, world, params, batches, q, kind)
            for kind, q in qs.items()}
