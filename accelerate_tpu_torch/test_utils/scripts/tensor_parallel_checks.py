"""Gang workers of ``tests/test_torch_{collective_matmul,tensor_parallel,
sequence_parallel}.py``: the ring collective-matmul bodies, tiny-Llama
train steps under tp / sp / dp_shard x tp / sp x tp in each
collective-matmul mode, the sharded -sr / -sr8 updates under tp, Ulysses
attention and the Ulysses boundary on each rank of a gloo world."""

from __future__ import annotations

import numpy as np
import torch

MODES = ("off", "ring", "bidir")


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _mesh_of(config):
    from ...accelerator import Accelerator

    return Accelerator(cpu=True, parallelism_config=config).mesh


# ---------------------------------------------------------------------------
# the ring bodies
# ---------------------------------------------------------------------------


def _ring_bodies(rank, world, cases) -> dict:
    """Each case's column and row bodies (ring, bidir, monolithic) on this
    rank's shards of the global ``x`` / ``w`` (JAX layout ``[K, N]``), the
    outputs and the gradients of ``sum(sin(y) * g)`` gathered whole."""
    from ...ops import collective_matmul as cm
    from ...parallel import collectives as C
    from ...parallelism_config import ParallelismConfig

    mesh = _mesh_of(ParallelismConfig(tp_size=world))
    out = []
    for case in cases:
        x = torch.from_numpy(case["x"]).to(getattr(torch, case["dtype"]))
        w = torch.from_numpy(case["w"]).to(x.dtype)           # [K, N]
        rep = {}
        for kind in ("column", "row"):
            if kind == "column":
                xl = torch.chunk(x, world, dim=1)[rank]           # sequence shard
                wl = torch.chunk(w, world, dim=1)[rank].t()       # [N/p, K]
            else:
                xl = torch.chunk(x, world, dim=2)[rank]           # contraction shard
                wl = torch.chunk(w, world, dim=0)[rank].t()       # [N, K/p]
            for mode in ("ring", "bidir", "monolithic"):
                xg = xl.clone().requires_grad_()
                wg = wl.contiguous().clone().requires_grad_()
                y = cm.make_collective_dense(mesh, "tp", kind, mode)(xg, wg)
                if x.dtype == torch.float32 and case.get("grads", True):
                    gy = torch.from_numpy(case["g_" + kind]).to(y.dtype)
                    gy = (torch.chunk(gy, world, dim=2)[rank] if kind == "column"
                          else torch.chunk(gy, world, dim=1)[rank])
                    (torch.sin(y) * gy).sum().backward()
                    dx = C.all_gather(xg.grad.contiguous(), "tp",
                                      axis=1 if kind == "column" else 2, mesh=mesh)
                    dw = C.all_gather(wg.grad.t().contiguous(), "tp",
                                      axis=1 if kind == "column" else 0, mesh=mesh)
                    rep[f"{kind}_{mode}_dx"] = _np(dx)
                    rep[f"{kind}_{mode}_dw"] = _np(dw)
                whole = C.all_gather(y.detach().contiguous(), "tp",
                                     axis=2 if kind == "column" else 1, mesh=mesh)
                rep[f"{kind}_{mode}"] = _np(whole)
        out.append(rep)
    # the hook on this rank's shards under an ambient tp mesh
    hook = {}
    x = torch.from_numpy(cases[0]["x"])
    w = torch.from_numpy(cases[0]["w"])
    xl = torch.chunk(x, world, dim=1)[rank]
    wl = torch.chunk(w, world, dim=1)[rank].t().contiguous()
    hook["off"] = cm.dense_collective_matmul(xl, wl, "column") is None
    with cm.collective_matmul("ring"):
        y = cm.dense_collective_matmul(xl, wl, "column")
        hook["ring"] = _np(C.all_gather(y.contiguous(), "tp", axis=2, mesh=mesh))
        xr = torch.chunk(x, world, dim=2)[rank]
        wr = torch.chunk(w, world, dim=0)[rank].t().contiguous()
        hook["row_seq_not_dividing"] = cm.dense_collective_matmul(
            xr[:, :-1], wr, "row") is None
        hook["contraction_mismatch"] = cm.dense_collective_matmul(xl, wl[:, :-1],
                                                                  "column") is None
        hook["2d_input"] = cm.dense_collective_matmul(xl[:, 0], wl, "column") is None
        hook["bad_kind"] = cm.dense_collective_matmul(xl, wl, "replicated") is None
    return {"cases": out, "hook": hook}


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


def _train(world, state_path, tokens, config, mode, *, attn="native", kv_heads=2,
           fused=None, loader=False, steps=3, count_all_to_all=False) -> dict:
    """The tiny f32 Llama for ``steps`` steps of adamw (lr 1e-2, clipped at
    1.0) under ``config`` and collective-matmul ``mode``: the losses, grad
    norms and the whole params after.  ``loader``: the batch comes through
    the prepared loader (each dp group's rows, under sp each rank's
    sequence slice with shifted labels); else each rank's rows of the
    global batch."""
    from ...accelerator import Accelerator
    from ...data_loader import shard_global_batch
    from ...models import llama as tl
    from ...optimizer import make_optimizer
    from ...parallel import collectives as C
    from ...utils.dataclasses import FullyShardedDataParallelPlugin

    acc = Accelerator(cpu=True, parallelism_config=config,
                      fsdp_plugin=FullyShardedDataParallelPlugin(collective_matmul=mode))
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, attn_implementation=attn,
                              num_key_value_heads=kv_heads)
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(torch.load(state_path))
    state = acc.create_train_state(model, make_optimizer("adamw", 1e-2))
    step = acc.prepare_train_step(tl.make_llama_loss_fn(model, fused_vocab_chunks=fused),
                                  max_grad_norm=1.0)
    ids = torch.from_numpy(tokens).long()
    if loader:
        dl = acc.prepare(torch.utils.data.DataLoader(
            torch.utils.data.TensorDataset(ids.repeat(steps, 1)), batch_size=ids.shape[0],
            collate_fn=lambda rows: {"input_ids": torch.stack([r[0] for r in rows]),
                                     "labels": torch.stack([r[0] for r in rows])}))
        batches = list(dl)
    else:
        local = shard_global_batch(ids, acc.mesh, config.batch_spec(seq_axis=None, ndim=2))
        batches = [{"input_ids": local, "labels": local}] * steps
    counts = {}
    if count_all_to_all:
        orig = C.all_to_all

        def counted(*a, **k):
            counts["all_to_all"] = counts.get("all_to_all", 0) + 1
            return orig(*a, **k)

        C.all_to_all = counted
    try:
        out = []
        for batch in batches:
            state, m = step(state, batch)
            out.append((m["loss"].item(), m["grad_norm"].item()))
    finally:
        if count_all_to_all:
            C.all_to_all = orig
    whole = acc.device_params(state.params)
    return {"trajectory": np.asarray(out), "batch_keys": sorted(batches[0]),
            "local_shapes": {n: tuple(p.shape) for n, p in state.params.items()},
            "params": {n: _np(p) for n, p in whole.items()}, **counts}


def _boundary(rank, world, state_path, tokens) -> dict:
    """The Ulysses boundary (sp 4, kv 4 heads, mode ring) against the off
    path: 3 step losses each, and the all_to_all calls of one boundary
    forward and of one off forward."""
    from ...accelerator import Accelerator
    from ...models import llama as tl
    from ...ops.collective_matmul import collective_matmul, ulysses_sp_boundary
    from ...parallel import collectives as C
    from ...parallel.sequence_parallel import shard_batch_along_sequence
    from ...parallelism_config import ParallelismConfig

    config = ParallelismConfig(sp_size=world)
    rep = {mode: _train(world, state_path, tokens, config, mode, attn="ulysses", kv_heads=4,
                        loader=True)["trajectory"] for mode in ("off", "ring")}
    acc = Accelerator(cpu=True, parallelism_config=config)
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, attn_implementation="ulysses",
                              num_key_value_heads=4)
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(torch.load(state_path))
    ids = shard_batch_along_sequence(torch.from_numpy(tokens).long(), acc.mesh)
    calls = {}
    orig = C.all_to_all

    def counted(*a, **k):
        calls[mode] = calls.get(mode, 0) + 1
        return orig(*a, **k)

    C.all_to_all = counted
    try:
        for mode in ("off", "ring"):
            calls[mode] = 0
            with collective_matmul(mode), torch.no_grad():
                model(ids)
    finally:
        C.all_to_all = orig
    with collective_matmul("ring"):
        gate = {"on": ulysses_sp_boundary(4, 4, 32), "heads": ulysses_sp_boundary(6, 4, 32),
                "kv_heads": ulysses_sp_boundary(4, 2, 32), "seq": ulysses_sp_boundary(4, 4, 30)}
    gate["off"] = ulysses_sp_boundary(4, 4, 32)
    rep["all_to_all_calls"] = calls
    rep["gate"] = gate
    return rep


# ---------------------------------------------------------------------------
# the sharded -sr / -sr8 updates under tp
# ---------------------------------------------------------------------------


def _global_index(lay, coord: int, local_idx: torch.Tensor) -> torch.Tensor:
    """The whole leaf's flat index of each element of a tp slice's flatten."""
    local = torch.unravel_index(local_idx, lay.shape)
    coords = list(local)
    coords[lay.tp_dim] = coords[lay.tp_dim] + coord * lay.shape[lay.tp_dim]
    stride, flat = 1, torch.zeros_like(local_idx)
    for d in reversed(range(len(lay.whole_shape))):
        flat = flat + coords[d] * stride
        stride *= lay.whole_shape[d]
    return flat


def _sharded_update_bitwise(rank, world, config, plugin, recipes, model_kw,
                            family: str = "llama") -> dict:
    """Two updates of each recipe on bf16 tiny-Llama (``family="mixtral"``:
    tiny-Mixtral) leaves laid out by the tp (ep) plan (model-axis slices,
    their dp ranges, relay leaves) given the same reduced gradients (dp
    coordinate 0 sends its slice of the whole gradients, the others
    zeros), against the whole-leaf update here: params and optimizer
    state, bitwise."""
    from ...models import llama as tl
    from ...ops.stochastic_rounding import flax_leaf_order
    from ...optimizer import make_optimizer
    from ...parallel import collectives as C
    from ...parallel.fsdp import DataParallelPlan, parallel_align
    from ...parallel.sharding import tp_rules_for
    from ...state import AcceleratorState

    mesh = AcceleratorState(cpu=True, parallelism_config=config).mesh
    if family == "mixtral":
        from ...models import mixtral as tm

        model = tm.MixtralForCausalLM(tm.MixtralConfig.tiny(dtype=torch.bfloat16, **model_kw),
                                      device="cpu", seed=3)
    else:
        model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.bfloat16, **model_kw),
                                    device="cpu", seed=3)
    named = dict(model.named_parameters())
    full = {n: named[n].detach().to(torch.bfloat16).clone() for n in flax_leaf_order(named)}
    rng = np.random.default_rng(7)
    grads = [[torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 1e-2)
              for p in full.values()] for _ in range(2)]
    dp_axes = tuple(a for a in ("dp_shard",) if C.axis_size(a, mesh) > 1)
    dp0 = not dp_axes or C.axis_index(dp_axes, mesh) == 0
    out = {}
    plan = None
    for recipe in recipes:
        tx = make_optimizer(recipe)
        plan = DataParallelPlan(mesh, config, plugin, full, align=parallel_align(plugin),
                                tp_rules=tp_rules_for(config))
        stored = plan.shard_params({n: p.clone() for n, p in full.items()})
        opt = tx.init(plan.opt_params(stored))
        whole = [p.clone() for p in full.values()]
        opt_w = tx.init(whole)
        for gs in grads:
            mine = [plan._tp_slice(g, lay) if dp0 else torch.zeros(lay.shape)
                    for g, lay in zip(gs, plan.layouts.values())]
            red = plan.reduce_grads(mine)
            new, opt = tx.update(red, opt, plan.opt_params(stored), numels=plan.numels)
            plan.write_back(stored, new)
            new_w, opt_w = tx.update(gs, opt_w, whole)
            for p, x in zip(whole, new_w):
                p.copy_(x)
        gathered = plan.whole_params(stored)
        same_params = all(torch.equal(gathered[n], w) for n, w in zip(full, whole))
        same_state = True
        for mine_f, whole_f in zip(opt, opt_w):
            if not isinstance(mine_f, list):
                continue
            for lay, a, b in zip(plan.layouts.values(), mine_f, whole_f):
                b = b.reshape(-1)
                if lay.relay or lay.tp_dim is None:
                    flat = (C.gather_flat(a, C.group(lay.opt_axes, mesh)) if lay.sharded
                            else a.reshape(-1))
                    same_state &= torch.equal(flat[:b.numel()], b)
                    continue
                flat = (C.gather_flat(a, C.group(lay.opt_axes, mesh)) if lay.sharded
                        else a.reshape(-1))
                tpc = C.axis_index(lay.model_axis, mesh)
                if b.numel() == lay.whole_numel:      # param-shaped: the slice's elements
                    idx = _global_index(lay, tpc, torch.arange(lay.numel))
                    same_state &= torch.equal(flat[:lay.numel], b[idx])
                else:                                  # per block: the slice's blocks
                    block = lay.whole_numel // b.numel() if b.numel() else 1
                    n_local = -(-lay.numel // block)
                    first = _global_index(lay, tpc, torch.arange(n_local) * block)
                    same_state &= torch.equal(flat[:n_local], b[first // block])
        out[recipe] = {"params": bool(same_params), "state": bool(same_state)}
    out["relay"] = sorted(n for n, lay in plan.layouts.items() if lay.relay)
    out["tp_dim1"] = sorted(n for n, lay in plan.layouts.items()
                            if lay.tp_dim == 1 and not lay.relay)
    out["tp_leaves"] = sorted(n for n, lay in plan.layouts.items() if lay.tp_dim is not None)
    out["model_axes"] = sorted({lay.model_axis for lay in plan.layouts.values()
                                if lay.tp_dim is not None})
    return out


# ---------------------------------------------------------------------------
# Ulysses attention on the gang
# ---------------------------------------------------------------------------


def _ulysses_cases(rank, world, cases) -> list:
    """Each case's output and q / k / v gradients of ``sum(out * g)``,
    gathered whole, with the inputs split over sp (contiguous); a case
    whose heads do not divide reports the error."""
    from ...parallel import collectives as C
    from ...parallel.sequence_parallel import make_ulysses_attention
    from ...parallelism_config import ParallelismConfig

    mesh = _mesh_of(ParallelismConfig(sp_size=world))
    attn = make_ulysses_attention(mesh)
    out = []
    for case in cases:
        local = {k: torch.chunk(torch.from_numpy(case[k]), world, dim=1)[rank].contiguous()
                 for k in ("q", "k", "v", "g")}
        seg = (torch.chunk(torch.from_numpy(case["seg"]), world, dim=1)[rank].contiguous()
               if case.get("seg") is not None else None)
        q, k, v = (local[n].clone().requires_grad_() for n in ("q", "k", "v"))
        try:
            o = attn(q, k, v, causal=case["causal"], segment_ids=seg)
        except ValueError as exc:
            out.append({"error": str(exc)})
            continue
        (o * local["g"]).sum().backward()
        out.append({name: _np(C.all_gather(t.detach().contiguous(), "sp", axis=1, mesh=mesh))
                    for name, t in (("out", o), ("dq", q.grad), ("dk", k.grad),
                                    ("dv", v.grad))})
    return out


def _token_mean(rank, world) -> dict:
    """``cross_rank_token_mean`` over sp: JAX's case (losses 0..31, all
    valid) and a masked one, with the gradient of the local losses."""
    from ...parallel.sequence_parallel import cross_rank_token_mean
    from ...parallelism_config import ParallelismConfig

    mesh = _mesh_of(ParallelismConfig(sp_size=world))
    loss = torch.chunk(torch.arange(32.0).reshape(1, 32), world, dim=1)[rank]
    loss = loss.clone().requires_grad_()
    mask = torch.chunk((torch.arange(32) % 3 != 0).float().reshape(1, 32), world, dim=1)[rank]
    plain = cross_rank_token_mean(loss, torch.ones_like(loss), ("sp",), mesh)
    masked = cross_rank_token_mean(loss, mask, ("sp",), mesh)
    masked.backward()
    return {"plain": plain.item(), "masked": masked.item(), "grad": _np(loss.grad)}


# ---------------------------------------------------------------------------
# the gangs
# ---------------------------------------------------------------------------


def cm_checks(rank: int, world: int, cases: list, state_path: str, tokens) -> dict:
    return {"bodies": _ring_bodies(rank, world, cases),
            "boundary": _boundary(rank, world, state_path, tokens)}


def tp_checks(rank: int, world: int, state_path: str, tokens) -> dict:
    from ...parallelism_config import ParallelismConfig
    from ...utils.dataclasses import FullyShardedDataParallelPlugin

    out = {}
    for label, cfg in (("tp4", ParallelismConfig(tp_size=world)),
                       ("dp2_tp2", ParallelismConfig(dp_shard_size=2, tp_size=world // 2))):
        for mode in MODES:
            out[f"{label}_{mode}"] = _train(world, state_path, tokens, cfg, mode, fused=4)
    recipes = ("lion-sr", "lion-sr8", "adamw-sr", "adamw-sr8")
    plugin = FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD", min_weight_size=0)
    out["bitwise_tp4"] = _sharded_update_bitwise(rank, world, ParallelismConfig(tp_size=world),
                                                 plugin, recipes, {})
    out["bitwise_dp2_tp2"] = _sharded_update_bitwise(
        rank, world, ParallelismConfig(dp_shard_size=2, tp_size=2), plugin, recipes, {})
    out["bitwise_dp2_tp2_wide"] = _sharded_update_bitwise(
        rank, world, ParallelismConfig(dp_shard_size=2, tp_size=2), plugin, recipes,
        {"hidden_size": 256, "intermediate_size": 512})
    return out


def tp_pair_checks(rank: int, world: int, state_path: str, tokens) -> dict:
    from ...parallelism_config import ParallelismConfig

    cfg = ParallelismConfig(tp_size=world)
    # the logits path (all_gather_invariant) besides the vocab-parallel loss
    return {**{f"tp2_{mode}": _train(world, state_path, tokens, cfg, mode, fused=4)
               for mode in MODES},
            "tp2_logits": _train(world, state_path, tokens, cfg, "ring")}


def sp_checks(rank: int, world: int, state_path: str, tokens, cases: list) -> dict:
    from ...parallelism_config import ParallelismConfig

    out = {"attention": _ulysses_cases(rank, world, cases),
           "token_mean": _token_mean(rank, world)}
    for label, cfg in (("sp4", ParallelismConfig(sp_size=world)),
                       ("sp2_tp2", ParallelismConfig(sp_size=2, tp_size=world // 2))):
        for mode in MODES:
            out[f"{label}_{mode}"] = _train(world, state_path, tokens, cfg, mode,
                                            attn="ulysses", fused=4, loader=True)
    return out


def sp_pair_checks(rank: int, world: int, state_path: str, tokens) -> dict:
    from ...parallelism_config import ParallelismConfig

    cfg = ParallelismConfig(sp_size=world)
    return {f"sp2_{mode}": _train(world, state_path, tokens, cfg, mode, attn="ulysses",
                                  loader=True)
            for mode in MODES}
