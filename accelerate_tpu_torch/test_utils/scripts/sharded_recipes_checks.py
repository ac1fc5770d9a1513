"""Gang worker of ``tests/test_torch_sharded_recipes.py``: the sharded
step's memory and precision recipes on each rank of a 4-rank world.

- :func:`unit_checks`: per-unit gathering (``reshard_after_forward``
  ``True`` / ``False``) against the whole-tree step (the same loss without
  its model's units) over several configurations, with the recorded unit
  gathers and a saved-tensor audit;
- :func:`offload_checks`: ZeRO-offload under a plan (monolithic, serial and
  pipelined host updates) against the resident plan step;
- :func:`fp8_checks`: fp8 delayed scaling under dp and tp: the metas on
  every rank and the losses.
"""

from __future__ import annotations

import numpy as np
import torch

RECIPES = ("lion-sr8", "adamw-sr8")


def _np(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _opt_tensors(opt_state) -> list:
    """Every tensor of the optimizer state's per-leaf fields (moments,
    codes, scales), in order."""
    return [t for v in opt_state if isinstance(v, list) for t in v]


def _whole_tree(loss_fn):
    """``loss_fn`` without its model's units: the step gathers the whole
    tree before the forward."""
    return lambda params, batch: loss_fn(params, batch)


def _model(kind: str, state_path, **cfg_kw):
    from ...models import llama as tl
    from ...models import mixtral as tm

    if kind == "mixtral":
        model = tm.MixtralForCausalLM(tm.MixtralConfig.tiny(dtype=torch.float32, **cfg_kw),
                                      device="cpu")
        loss_fn = tm.make_mixtral_loss_fn(model)
    else:
        model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32, **cfg_kw),
                                    device="cpu")
        loss_fn = tl.make_llama_loss_fn(model, fused_vocab_chunks=4)
    if state_path is not None:
        model.load_state_dict(torch.load(state_path))
    return model, loss_fn


def _batches(acc, config, tokens, steps: int, ring: bool) -> list:
    """Each rank's batch of every step: its dp rows of the global batch
    (under the ring, the pre-shifted labels and its zigzag cp shard)."""
    from ...data_loader import shard_global_batch

    ids = torch.from_numpy(tokens).long()
    spec = config.batch_spec(seq_axis=None, ndim=2)
    if not ring:
        local = shard_global_batch(ids, acc.mesh, spec)
        return [{"input_ids": local, "labels": local}] * steps
    shift = torch.roll(ids, -1, dims=1)
    shift[:, -1] = -100
    ids, shift = (shard_global_batch(x, acc.mesh, spec) for x in (ids, shift))
    with acc.maybe_context_parallel(buffers=[ids, shift], buffer_seq_dims=[1, 1]) as (i, s):
        return [{"input_ids": i.clone(), "shift_labels": s.clone()}] * steps


def _run(config, plugin_kw, kind, state_path, tokens, recipe, mode, *, steps=3, ring=False,
         audit=None, mixed_precision="no", **cfg_kw) -> dict:
    """``steps`` steps of ``recipe`` under ``config`` in ``mode`` (``whole``,
    ``True``, ``False``): the trajectory, this rank's params and optimizer
    tensors, the unit gathers recorded in the first step and, with
    ``audit`` (whole leaves by name), the audited saved tensors."""
    from ...accelerator import Accelerator
    from ...parallel.hierarchical import record_collectives
    from ...utils.dataclasses import FullyShardedDataParallelPlugin

    plugin = FullyShardedDataParallelPlugin(
        min_weight_size=0, reshard_after_forward=mode != "False", **plugin_kw)
    acc = Accelerator(cpu=True, parallelism_config=config, fsdp_plugin=plugin,
                      mixed_precision=mixed_precision)
    model, loss_fn = _model(kind, state_path, **cfg_kw)
    state = acc.create_train_state(model, recipe)
    if mode == "whole":
        loss_fn = _whole_tree(loss_fn)
    step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
    batches = _batches(acc, config, tokens, steps, ring)
    traj, recorded, saved_weights = [], None, []
    for i, batch in enumerate(batches):
        hooks = None
        if audit is not None and i == 0:
            def pack(t):
                for name, w in audit.items():
                    for view in (t, t.mT) if t.dim() == 2 else (t,):
                        if view.shape == w.shape and torch.equal(view.detach(), w):
                            saved_weights.append(name)
                return t
            hooks = torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)
        with record_collectives() as rec:
            if hooks is not None:
                with hooks:
                    state, m = step(state, batch)
            else:
                state, m = step(state, batch)
        if recorded is None:
            recorded = sum(1 for r in rec.rows if r["kind"] == "unit_gather")
        traj.append((m["loss"].item(), m["grad_norm"].item()))
    return {"trajectory": traj, "params": dict(state.params),
            "opt": _opt_tensors(state.opt_state), "unit_gathers": recorded,
            "saved_weights": sorted(set(saved_weights)), "acc": acc, "state": state,
            "owned": sorted(_owned(acc, loss_fn))}


def _owned(acc, loss_fn):
    from ...parallel.fsdp import owned_leaves

    units_of = getattr(loss_fn, "fsdp_units", None)
    if units_of is None or acc._dp_plan is None:
        return []
    return owned_leaves(acc._dp_plan, units_of())


def _bitwise(a: dict, b: dict) -> dict:
    return {"trajectory": a["trajectory"] == b["trajectory"],
            "params": all(torch.equal(a["params"][n], p) for n, p in b["params"].items()),
            "opt": len(a["opt"]) == len(b["opt"]) and all(
                torch.equal(x, y) for x, y in zip(a["opt"], b["opt"]))}


# label -> (config kwargs, plugin kwargs, model kind, model config kwargs, ring)
UNIT_CASES = {
    "dp_shard": (dict(dp_shard_size=4), dict(sharding_strategy="FULL_SHARD"), "llama", {},
                 False),
    "hsdp": (dict(dp_replicate_size=2, dp_shard_size=2), dict(sharding_strategy="HYBRID_SHARD"),
             "llama", {}, False),
    "tp": (dict(tp_size=2, dp_shard_size=2), dict(sharding_strategy="FULL_SHARD"), "llama", {},
           False),
    "cp_ring": (dict(cp_size=2, dp_shard_size=2), dict(sharding_strategy="FULL_SHARD"), "llama",
                dict(attn_implementation="ring"), True),
    "remat_full": (dict(dp_shard_size=4), dict(sharding_strategy="FULL_SHARD"), "llama",
                   dict(remat=True, remat_policy="full"), False),
    "remat_dots": (dict(dp_shard_size=4), dict(sharding_strategy="FULL_SHARD"), "llama",
                   dict(remat=True, remat_policy="dots"), False),
    "scan": (dict(dp_shard_size=4), dict(sharding_strategy="FULL_SHARD"), "llama",
             dict(scan_layers=True), False),
    "mixtral_ep": (dict(ep_size=2, dp_shard_size=2), dict(sharding_strategy="FULL_SHARD"),
                   "mixtral", {}, False),
}


def unit_checks(rank: int, world: int, state_path: str, tokens, labels=None) -> dict:
    """Each case of :data:`UNIT_CASES` (``labels``: a subset) in the three
    modes with lion-sr8 (and adamw-sr8 on ``dp_shard``): bitwise
    comparisons against the whole-tree step, the unit gathers each mode
    recorded, and the saved-tensor audit of ``dp_shard``."""
    from ...parallelism_config import ParallelismConfig

    out = {}
    for label in labels or UNIT_CASES:
        cfg_kw, plugin_kw, kind, model_kw, ring = UNIT_CASES[label]
        path = state_path if kind == "llama" and not model_kw.get("scan_layers") else None
        for recipe in (RECIPES if label == "dp_shard" else RECIPES[:1]):
            runs = {}
            for mode in ("whole", "True", "False"):
                audit = None
                if label == "dp_shard" and recipe == RECIPES[0] and mode != "whole":
                    # the whole weights the first step reads
                    audit = {n: p.detach().clone() for n, p in
                             _model(kind, path, **model_kw)[0].named_parameters()
                             if p.dim() == 2}
                runs[mode] = _run(ParallelismConfig(**cfg_kw), plugin_kw, kind, path, tokens,
                                  recipe, mode, ring=ring, audit=audit, **model_kw)
            out[f"{label}/{recipe}"] = {
                "True": _bitwise(runs["True"], runs["whole"]),
                "False": _bitwise(runs["False"], runs["whole"]),
                "gathers": {m: runs[m]["unit_gathers"] for m in runs},
                "saved_weights": {m: runs[m]["saved_weights"] for m in ("True", "False")},
                "owned": runs["True"]["owned"],
                "trajectory": runs["True"]["trajectory"]}
    return out


def jax_step_checks(rank: int, world: int, state_path: str, batches: list) -> dict:
    """The tiny f32 Llama under dp_shard 4, FULL_SHARD, adamw with clipping
    over ``batches`` (each rank its rows), in both modes: the trajectory and
    the whole params, for the JAX dp_shard step and the one-process step."""
    from ...accelerator import Accelerator
    from ...data_loader import shard_global_batch
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import FullyShardedDataParallelPlugin

    out = {}
    for mode in (True, False):
        config = ParallelismConfig(dp_shard_size=world)
        acc = Accelerator(cpu=True, parallelism_config=config,
                          fsdp_plugin=FullyShardedDataParallelPlugin(
                              sharding_strategy="FULL_SHARD", min_weight_size=0,
                              reshard_after_forward=mode))
        model, loss_fn = _model("llama", state_path, attn_implementation="flash")
        state = acc.create_train_state(model, "adamw")
        step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)
        traj = []
        for ids in batches:
            local = shard_global_batch(torch.from_numpy(ids).long(), acc.mesh,
                                       config.batch_spec(seq_axis=None, ndim=2))
            state, m = step(state, {"input_ids": local, "labels": local})
            traj.append((m["loss"].item(), m["grad_norm"].item()))
        out[str(mode)] = {"trajectory": np.asarray(traj),
                          "params": {n: _np(p) for n, p in
                                     acc.device_params(state.params).items()}}
    return out


def _offload_run(config, recipe, offload: bool, *, chunk_gib=None, pipeline=True, clip=1.0,
                 steps=3, state_path=None, tokens=None, ckpt_dir=None) -> dict:
    """``steps`` steps of the tiny bf16 Llama under ``config`` (FULL_SHARD,
    per-unit gathering), resident or offloaded; with ``ckpt_dir`` the state
    saved after the first step and restored onto a fresh offloaded
    template, which takes the remaining steps."""
    from ...accelerator import Accelerator
    from ...models import llama as tl
    from ...ops.streaming import offload_transfer_accounting
    from ...utils.dataclasses import FullyShardedDataParallelPlugin

    plugin = FullyShardedDataParallelPlugin(
        sharding_strategy="FULL_SHARD", min_weight_size=0, cpu_offload=offload,
        host_update_chunk_gib=chunk_gib, host_update_pipeline=pipeline)

    def fresh(seed):
        acc = Accelerator(cpu=True, parallelism_config=config, fsdp_plugin=plugin,
                          mixed_precision="bf16")
        model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.bfloat16), device="cpu",
                                    seed=seed)
        state = acc.create_train_state(model, recipe)
        return acc, state, acc.prepare_train_step(
            tl.make_llama_loss_fn(model, fused_vocab_chunks=4), max_grad_norm=clip)

    acc, state, step = fresh(0)
    batches = _batches(acc, config, tokens, steps, False)
    traj, logs = [], []
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        traj.append((m["loss"].item(), m["grad_norm"].item()))
        logs.append(dict(acc.offload_log))
        if ckpt_dir is not None and i == 0:
            path = acc.save_state(f"{ckpt_dir}/step_1", train_state=state)
            acc, state, step = fresh(1)
            state = acc.load_state(path, train_state=state)
    plan = acc._dp_plan
    n_range = sum(p.numel() for p in state.params.values())
    out = {"trajectory": traj, "params": dict(state.params),
           "opt": _opt_tensors(state.opt_state), "logs": logs}
    if offload:
        out["pinned_on_host"] = all(p.device.type == "cpu" for p in state.params.values()) and \
            all(t.device.type == "cpu" for t in out["opt"])
        out["predicted"] = offload_transfer_accounting(n_range, optimizer=recipe,
                                                       grad_bytes_per_param=4)
        out["range_elements"] = n_range
        out["whole_elements"] = sum(lay.whole_numel for lay in plan.layouts.values())
    return out


def offload_checks(rank: int, world: int, tokens) -> dict:
    """ZeRO-offload under dp_shard 4 with each -sr8 recipe: the monolithic
    step against the resident plan step (with clipping: the host norm over
    the ranks), the chunked pipelined against the chunked serial (without),
    the bytes a rank moved against the accounting of its ranges, the chunk
    groups, and a checkpoint of the offloaded state restored onto a fresh
    offloaded template continuing as the resident steps."""
    import tempfile

    from ...parallelism_config import ParallelismConfig

    config = ParallelismConfig(dp_shard_size=world)
    out = {}
    for recipe in RECIPES:
        resident = _offload_run(config, recipe, False, tokens=tokens)
        mono = _offload_run(config, recipe, True, tokens=tokens)
        serial = _offload_run(config, recipe, True, chunk_gib=1e-6, pipeline=False, clip=None,
                              tokens=tokens)
        piped = _offload_run(config, recipe, True, chunk_gib=1e-6, pipeline=True, clip=None,
                             tokens=tokens)
        with tempfile.TemporaryDirectory() as d:
            # every rank the same directory: rank 0's, broadcast
            from ...ops.operations import broadcast_object_list

            d = broadcast_object_list([d])[0]
            restored = _offload_run(config, recipe, True, tokens=tokens, ckpt_dir=d)
        out[recipe] = {
            "mono_vs_resident": _bitwise(mono, resident),
            "pipelined_vs_serial": _bitwise(piped, serial),
            "restored_vs_resident": _bitwise(restored, resident),
            "chunked_trajectory": piped["trajectory"], "resident_trajectory":
                resident["trajectory"],
            "logs": {"mono": mono["logs"][-1], "pipelined": piped["logs"][-1]},
            "predicted": mono["predicted"], "range_elements": mono["range_elements"],
            "whole_elements": mono["whole_elements"],
            "pinned_on_host": mono["pinned_on_host"] and restored["pinned_on_host"]}
    return out


def fp8_checks(rank: int, world: int, state_path: str, tokens, steps: int = 3) -> dict:
    """fp8 delayed scaling (adamw, clipping) on the tiny f32 Llama under dp
    ``world`` and under tp 2 x dp_shard 2 (ring off): every rank's metas
    after creation and after each step, the whole weights each step's
    metas were taken from, and the losses."""
    from ...accelerator import Accelerator
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import FullyShardedDataParallelPlugin

    out = {}
    for label, config in (("dp", ParallelismConfig(dp_shard_size=world)),
                          ("tp_dp", ParallelismConfig(tp_size=2, dp_shard_size=world // 2))):
        acc = Accelerator(cpu=True, parallelism_config=config, mixed_precision="fp8",
                          fsdp_plugin=FullyShardedDataParallelPlugin(
                              sharding_strategy="FULL_SHARD", min_weight_size=0))
        model, loss_fn = _model("llama", state_path)
        state = acc.create_train_state(model, "adamw")
        step = acc.prepare_train_step(loss_fn, max_grad_norm=1.0)

        def metas(st):
            return {n: (_np(m.amax_history), _np(m.scale)) for n, m in st.fp8_state.items()}

        rec = {"metas": [metas(state)], "weights": [], "losses": []}
        for batch in _batches(acc, config, tokens, steps, False):
            state, m = step(state, batch)
            rec["losses"].append(m["loss"].item())
            rec["metas"].append(metas(state))
            # every rank gathers (a collective); rank 0 reports
            whole = acc.device_params(state.params)
            rec["weights"].append({k: _np(whole[k + ".weight"]) for k in state.fp8_state}
                                  if rank == 0 else None)
        out[label] = rec
    return out
