"""Tensor parallelism: the tiny Llama's Megatron split trained on gloo
worlds of 2 and 4 CPU processes (``accelerate_tpu_torch/test_utils/
gang.py``) under each collective-matmul mode, held against the JAX
package's ``Accelerator`` on as many of its CPU devices and against the
port's single-process step; the plan's tp rules on the port's names; the
sharded -sr / -sr8 updates under tp; and the in-process virtual world the
card runs tp with (``parallel/virtual.py``).

Tolerances: the 3-step losses against JAX's at JAX's own rtol 2e-4
(``tests/test_collective_matmul.py:271``), grad norms at 5e-3 (slice 17's
trajectory tolerance); against the single-process port step at rtol 1e-5
(losses, norms); the params after 3 adamw steps at lr 1e-2 within 1.2e-4
at 99.9 % of each leaf's elements (the bf16 momentum may round one ulp
apart, as in slice 17: a step of ~lr * 2^-8 = 3.9e-5 in each of the 3
steps) and within 3 * lr everywhere (adam's normalised step moves an
element whose gradient is at rounding level by up to lr a step, either
way); the -sr / -sr8 updates bitwise; the virtual
world's loss and re-assembled gradients against the single-process
step's at 1e-5 relative (f32, other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.models import llama as jl
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu.parallelism_config import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu_torch import Accelerator, ParallelismConfig, make_llama_loss_fn
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.ops.collective_matmul import collective_matmul
from accelerate_tpu_torch.optimizer import make_optimizer
from accelerate_tpu_torch.parallel.sharding import (
    TRANSFORMER_TP_RULES,
    make_sharding_plan,
    tp_rules_for,
    tp_shard,
    tp_split_dim,
)
from accelerate_tpu_torch.parallel.virtual import VirtualMesh, module_replica
from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER
from accelerate_tpu_torch.test_utils.gang import run_gang
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

MODES = ("off", "ring", "bidir")
CONFIGS = {"tp2": dict(tp_size=2), "tp4": dict(tp_size=4),
           "dp2_tp2": dict(dp_shard_size=2, tp_size=2)}


def _tokens():
    return np.random.default_rng(3).integers(0, 256, (4, 32)).astype(np.int32)


@pytest.fixture(scope="module")
def host():
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.LlamaForCausalLM(cfg).init(jax.random.key(0), jnp.asarray(_tokens())[:, :8])
    return jax.tree.map(lambda x: np.array(x, copy=True), params)


@pytest.fixture(scope="module")
def state_path(host, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_state")
    torch.save(torch_state_from_flax(host), d / "tiny.pt")
    return d / "tiny.pt"


@pytest.fixture(scope="module")
def gang(state_path, tmp_path_factory):
    """tp 4 and dp_shard 2 x tp 2 on a 4-rank world, tp 2 on a 2-rank one."""
    script = "accelerate_tpu_torch.test_utils.scripts.tensor_parallel_checks"
    four = run_gang(f"{script}:tp_checks", 4, tmp_path_factory.mktemp("tp4"), timeout=240,
                    state_path=str(state_path), tokens=_tokens())
    two = run_gang(f"{script}:tp_pair_checks", 2, tmp_path_factory.mktemp("tp2"), timeout=120,
                   state_path=str(state_path), tokens=_tokens())
    return {"four": four, "two": two}


_JAX: dict = {}


def _jax_trajectory(host, label):
    """JAX's tp step, mode off (its own test holds ring and bidir to off
    at rtol 2e-4): 3 adamw steps at lr 1e-2 clipped at 1.0."""
    if label in _JAX:
        return _JAX[label]
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    try:
        cfg = CONFIGS[label]
        n = int(np.prod(list(cfg.values())))
        acc = JaxAccelerator(parallelism_config=JaxParallelismConfig(
            **cfg, devices=tuple(jax.devices()[:n])))
        model = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
        state = acc.create_train_state(jax.tree.map(jnp.asarray, host),
                                       jax_make_optimizer("adamw", 1e-2), apply_fn=model.apply)
        step = acc.prepare_train_step(jl.make_llama_loss_fn(model), max_grad_norm=1.0)
        ids = jnp.asarray(_tokens())
        out = []
        for _ in range(3):
            state, m = step(state, {"input_ids": ids, "labels": ids})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        _JAX[label] = np.asarray(out)
        return _JAX[label]
    finally:
        JaxAcceleratorState._reset_state(reset_partial_state=True)
        JaxGradientState._reset_state()


def _run(gang, label, mode):
    if label == "tp2":
        return [r[f"tp2_{mode}"] for r in gang["two"]]
    return [r[f"{label}_{mode}"] for r in gang["four"]]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_train_step_losses_match_jax(gang, host, label, mode):
    """Every rank of tp 2, tp 4 (tiny's 2 kv heads of 16 split in halves)
    and dp_shard 2 x tp 2, in each mode, reports JAX's losses over 3
    steps, and its grad norms; the step trains."""
    want = _jax_trajectory(host, label)
    for rep in _run(gang, label, mode):
        got = rep["trajectory"]
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-4)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3)
        assert got[-1, 0] < got[0, 0]


_SINGLE: dict = {}


def _single_process(state_path, fused=4):
    if fused in _SINGLE:
        return _SINGLE[fused]
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(torch.load(state_path))
    acc = Accelerator(cpu=True)
    state = acc.create_train_state(model, make_optimizer("adamw", 1e-2))
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=fused),
                                  max_grad_norm=1.0)
    ids = torch.from_numpy(_tokens()).long()
    out = []
    for _ in range(3):
        state, m = step(state, {"input_ids": ids, "labels": ids})
        out.append((m["loss"].item(), m["grad_norm"].item()))
    _SINGLE[fused] = (np.asarray(out), {n: p.detach().numpy() for n, p in state.params.items()})
    return _SINGLE[fused]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_train_step_matches_single_process(gang, state_path, label, mode):
    """The sharded step is the single-process step: its losses, norms and
    whole params after 3 steps (``device_params`` gathers the slices)."""
    single, params = _single_process(state_path)
    for rep in _run(gang, label, mode):
        np.testing.assert_allclose(rep["trajectory"], single, rtol=1e-5)
        for name, p in rep["params"].items():
            err = np.abs(p - params[name])
            assert err.max() <= 3e-2 and (err <= 1.2e-4).mean() >= 0.999, (name, err.max())


def test_logits_path_matches_fused(gang, state_path):
    """Without the fused loss the head's vocab-sharded logits are gathered
    whole (``all_gather_invariant``): the same trajectory."""
    single, _ = _single_process(state_path)
    for r in gang["two"]:
        np.testing.assert_allclose(r["tp2_logits"]["trajectory"], single, rtol=1e-5)


def test_each_rank_holds_its_tp_slices(gang):
    """q / k / v, gate / up, the embedding and ``lm_head`` hold their rows'
    slice, o_proj and down_proj their columns'; norms are whole."""
    for label, tp in (("tp4", 4), ("dp2_tp2", 2)):
        shapes = gang["four"][0][f"{label}_off"]["local_shapes"]
        p = "model.layers.0."
        assert shapes[p + "self_attn.q_proj.weight"][0] * tp == 64 or label == "dp2_tp2"
        if label == "tp4":
            assert shapes[p + "self_attn.q_proj.weight"] == (16, 64)
            assert shapes[p + "self_attn.k_proj.weight"] == (8, 64)
            assert shapes[p + "self_attn.o_proj.weight"] == (64, 16)
            assert shapes[p + "mlp.gate_proj.weight"] == (32, 64)
            assert shapes[p + "mlp.down_proj.weight"] == (64, 32)
            assert shapes["model.embed_tokens.weight"] == (64, 64)
            assert shapes["lm_head.weight"] == (64, 64)
            assert shapes[p + "input_layernorm.weight"] == (64,)
    for rep in gang["two"]:
        shapes = rep["tp2_off"]["local_shapes"]
        assert shapes["model.layers.1.self_attn.o_proj.weight"] == (64, 32)


@pytest.mark.parametrize("layout", ["tp4", "dp2_tp2", "dp2_tp2_wide"])
def test_sharded_sr_updates_bitwise_whole_leaf_under_tp(gang, layout):
    """Two updates of lion-sr, lion-sr8, adamw-sr and adamw-sr8 on bf16
    leaves laid out by the tp plan equal the whole-leaf updates bit for
    bit, params and state (codes and scales).  At tiny width o_proj /
    down_proj's column slices (16 or 32 wide) are not whole 128-element
    blocks: they update as ranges of the whole flatten (``relay``); at
    hidden 256 their 128-wide slices are, and update in place."""
    for rank in range(4):
        rep = gang["four"][rank][f"bitwise_{layout}"]
        for recipe in ("lion-sr", "lion-sr8", "adamw-sr", "adamw-sr8"):
            assert rep[recipe] == {"params": True, "state": True}, (rank, recipe)
        assert len(rep["tp_leaves"]) == 16
        if layout == "dp2_tp2_wide":
            assert rep["relay"] == [] and len(rep["tp_dim1"]) == 4
        else:
            assert len(rep["relay"]) == 4 and all(
                n.endswith(("o_proj.weight", "down_proj.weight")) for n in rep["relay"])


def test_tp_plan_rules_on_port_names():
    """JAX ``tests/test_accelerator.py:242`` and ``tests/test_models.py:76``
    / :458 on the port's names and layout: q_proj's JAX ``[in, out]``
    kernel splits ``out`` (the port's dimension 0), o_proj's splits ``in``
    (the port's 1); a scanned stack's rule shifts by its leading axis."""
    layout = (MESH_AXIS_ORDER, tuple({"dp_shard": 4, "tp": 2}.get(a, 1)
                                     for a in MESH_AXIS_ORDER))
    pcfg = ParallelismConfig(dp_shard_size=4, tp_size=2)
    rules = tp_rules_for(pcfg)
    assert rules == TRANSFORMER_TP_RULES
    plan = make_sharding_plan({"model.layers.0.self_attn.q_proj.weight": (8, 16),
                               "model.layers.0.self_attn.o_proj.weight": (16, 8)},
                              layout, pcfg, FullyShardedDataParallelPlugin(min_weight_size=0),
                              rules)
    assert plan["model.layers.0.self_attn.q_proj.weight"][0] == "tp"
    assert plan["model.layers.0.self_attn.o_proj.weight"][1] == "tp"
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="meta")
    plan = make_sharding_plan(dict(model.named_parameters()), layout, pcfg, None, rules)
    assert "tp" in plan["model.layers.0.self_attn.q_proj.weight"]
    assert tp_split_dim(plan["model.embed_tokens.weight"]) == 0
    assert tp_split_dim(plan["lm_head.weight"]) == 0
    assert tp_split_dim(plan["model.layers.1.mlp.down_proj.weight"]) == 1
    scan = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(scan_layers=True), device="meta")
    plan = make_sharding_plan(dict(scan.named_parameters()), layout, pcfg, None, rules)
    assert tp_split_dim(plan["model.layers_scan.block.self_attn.q_proj.weight"]) == 1
    assert tp_split_dim(plan["model.layers_scan.block.self_attn.o_proj.weight"]) == 2
    assert tp_rules_for(ParallelismConfig()) == []


def test_accelerator_surface_under_tp():
    """tp and sp no longer raise; neither do pp and ep (their worlds:
    ``test_torch_accelerator_surface.py``), but pp composed with tp names
    A13h;
    ``tp_config`` / ``cp_config`` / ``sp_config`` are kept, ``plan`` picks
    the rules; ``ContextParallelConfig`` checks its rotate method (fp8
    under tp trains: ``test_torch_sharded_recipes.py``);
    ``attn_implementation="ulysses"`` is a config."""
    from accelerate_tpu_torch.utils.dataclasses import (
        ContextParallelConfig,
        SequenceParallelConfig,
        TensorParallelConfig,
    )

    with pytest.raises(NotImplementedError, match="A13h"):
        Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=2, tp_size=2))
    tpc, cpc, spc = TensorParallelConfig(plan="none"), ContextParallelConfig(), \
        SequenceParallelConfig()
    acc = Accelerator(cpu=True, tp_config=tpc, cp_config=cpc, sp_config=spc)
    assert (acc.tp_config, acc.cp_config, acc.sp_config) == (tpc, cpc, spc)
    assert tp_rules_for(ParallelismConfig(tp_size=2), tpc) == []
    with pytest.raises(ValueError, match="rotate"):
        ContextParallelConfig(rotate_method="sideways")
    assert tl.LlamaConfig.tiny(attn_implementation="ulysses").attn_implementation == "ulysses"
    with pytest.raises(ValueError, match="ulysses"):
        tl.LlamaConfig.tiny(attn_implementation="sideways")


def test_virtual_world_matches_single_process():
    """The card's tp: 4 ranks as threads of one process
    (``VirtualMesh.run``), each its own module replica on its tp slices,
    the collectives exchanged in memory with the gang's forward and
    backward, then one backward over the ranks' losses: the loss and the
    re-assembled gradients are the single-process forward's, in each mode,
    tp 4 on tiny's split kv heads included."""
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, attn_implementation="flash")
    model = tl.LlamaForCausalLM(cfg, device="cpu", seed=1)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids = torch.from_numpy(_tokens()).long()
    batch = {"input_ids": ids, "labels": ids}
    ref_p = {n: t.clone().requires_grad_() for n, t in full.items()}
    ref_loss = make_llama_loss_fn(model, fused_vocab_chunks=4)(ref_p, batch)
    ref_loss.backward()
    for tp in (2, 4):
        layout = tuple(tp if a == "tp" else 1 for a in MESH_AXIS_ORDER)
        plan = make_sharding_plan(full, (MESH_AXIS_ORDER, layout), ParallelismConfig(tp_size=tp),
                                  None, TRANSFORMER_TP_RULES)
        for mode in MODES:
            vm = VirtualMesh(MESH_AXIS_ORDER, layout)
            reps = [module_replica(model) for _ in range(tp)]
            shards = [{n: tp_shard(t, tp_split_dim(plan[n]), tp, r).clone().requires_grad_()
                       for n, t in full.items()} for r in range(tp)]

            def rank_loss(r):
                return make_llama_loss_fn(reps[r], fused_vocab_chunks=4)(shards[r], batch)

            with collective_matmul(mode):
                losses = vm.run(rank_loss, ParallelismConfig(tp_size=tp))
            torch.autograd.backward(losses)
            for loss in losses:
                np.testing.assert_allclose(loss.item(), ref_loss.item(), rtol=1e-5)
            for n, t in full.items():
                d = tp_split_dim(plan[n])
                g = (torch.cat([s[n].grad for s in shards], dim=d) if d is not None
                     else shards[0][n].grad)
                scale = ref_p[n].grad.abs().max().item()
                np.testing.assert_allclose(g.numpy(), ref_p[n].grad.numpy(), rtol=0,
                                           atol=1e-5 * scale, err_msg=f"{tp} {mode} {n}")
            assert vm.calls["pmax"] == 1   # the vocab-parallel loss's one max
            if mode != "off":
                assert vm.calls["ppermute"] > 0 and "psum" in vm.calls
