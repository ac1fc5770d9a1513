"""The port's FSDP sharding plan held against the JAX package's
(``parallel/sharding.py``), leaf for leaf and exactly: the parameter plan,
the optimizer state's plan (mirrors upgraded to the joint ``(dp_shard,
cp)`` entry) and ``plan_bytes_per_device``, for ``LlamaConfig.tiny()``
and the 600m serving model's shapes (abstract on both sides), under
dp_shard 2 / 4 / 8, dp_replicate 2 x dp_shard 4 and cp 2 x dp_shard 4,
at ``min_weight_size`` 0 and the default.  A JAX kernel is ``[in, out]``
where the port's weight is ``[out, in]``: the port's spec is JAX's with
the last two entries swapped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu.parallel import sharding as jsh
from accelerate_tpu.parallelism_config import ParallelismConfig as JConfig
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JPlugin
from accelerate_tpu_torch.big_modeling import init_empty_weights
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.ops.stochastic_rounding import flax_leaf_order
from accelerate_tpu_torch.optimizer import make_optimizer
from accelerate_tpu_torch.parallel import sharding as tsh
from accelerate_tpu_torch.parallelism_config import ParallelismConfig
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

MODEL_600M = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                  num_hidden_layers=16, num_attention_heads=16, num_key_value_heads=8,
                  max_position_embeddings=4096)
LAYOUTS = {"dp_shard2": dict(dp_shard_size=2), "dp_shard4": dict(dp_shard_size=4),
           "dp_shard8": dict(dp_shard_size=8),
           "hsdp": dict(dp_replicate_size=2, dp_shard_size=4),
           "cp": dict(cp_size=2, dp_shard_size=4)}


def _entry(e):
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def _norm(spec):
    return [_entry(e) for e in spec]


@pytest.fixture(scope="module", params=["tiny", "600m"])
def shapes(request):
    """(JAX abstract params, the port's meta params) of one model."""
    kw = dict(MODEL_600M) if request.param == "600m" else {}
    jcfg = jl.LlamaConfig.tiny(**kw)
    model = jl.LlamaForCausalLM(jcfg)
    jparams = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8), jnp.int32)))["params"]
    with init_empty_weights():
        port = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32, **kw), device="cpu")
    return jparams, {n: p for n, p in port.named_parameters()}


def _plans(jparams, tparams, layout, min_size):
    n = int(np.prod(list(LAYOUTS[layout].values())))
    jcfg = JConfig(**LAYOUTS[layout], devices=jax.devices()[:n])
    jmesh = jcfg.build_device_mesh()
    cfg = ParallelismConfig(**LAYOUTS[layout])
    mesh = cfg.mesh_layout(n)
    jplugin = JPlugin(min_weight_size=min_size)
    plugin = FullyShardedDataParallelPlugin(min_weight_size=min_size)
    jplan = jsh.make_sharding_plan(jparams, jmesh, jcfg, jplugin)
    plan = tsh.make_sharding_plan(tparams, mesh, cfg, plugin)
    return (jcfg, jmesh, jplugin, jplan), (cfg, mesh, plugin, plan)


def _by_path(tree, is_leaf=None):
    return {jsh.path_str(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=is_leaf)[0]}


def _swapped(spec, path):
    spec = list(spec)
    if path.endswith("/kernel") and len(spec) in (2, 3):
        spec[-1], spec[-2] = spec[-2], spec[-1]
    return spec


@pytest.mark.parametrize("min_size", [0, 2**12])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_param_and_opt_state_plans_equal_jax(shapes, layout, min_size):
    jparams, tparams = shapes
    (jcfg, jmesh, jplugin, jplan), (cfg, mesh, plugin, plan) = _plans(jparams, tparams, layout,
                                                                      min_size)
    jflat = _by_path(jplan, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    assert len(jflat) == len(plan)
    split = 0
    for name, spec in plan.items():
        path = tsh.path_str(name)
        want = _swapped(jflat[path].spec, path) + [None] * (len(spec) - len(jflat[path].spec))
        assert _norm(spec) == _norm(want), (name, spec, jflat[path].spec)
        split += any(e is not None for e in spec)
    assert split > 0
    # the optimizer state: lion-sr's momentum mirrors every parameter
    jstate = jax.eval_shape(jax_make_optimizer("lion-sr").init, jparams)
    jopt = _by_path(jsh.make_opt_state_sharding_plan(jstate, jplan, jmesh, jcfg, jplugin),
                    is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    names = flax_leaf_order(tparams)
    tstate = make_optimizer("lion-sr").init([tparams[n] for n in names])
    opt = tsh.make_opt_state_sharding_plan(tsh.opt_state_shapes(tstate, names), plan, mesh,
                                           cfg, plugin)
    assert _norm(opt["count"]) == _norm(jopt["count"].spec) == []
    for name in names:
        path = tsh.path_str(name)
        want = _swapped(jopt[f"mu/{path}"].spec, path)
        want += [None] * (len(tparams[name].shape) - len(want))
        assert _norm(opt[f"mu/{name}"]) == _norm(want), name
    # the bytes one device holds
    abstract = {n: (tuple(p.shape), p.dtype) for n, p in tparams.items()}
    assert tsh.plan_bytes_per_device(abstract, plan, mesh) == jsh.plan_bytes_per_device(
        jparams, jplan)


def test_fsdp_shards_params_and_opt_state():
    """JAX ``tests/test_accelerator.py:169``: a [64, 4] leaf splits on dim
    0 over dp_shard 8, adam's moments mirror it, [4] and a sub-tile
    [16, 4] leaf replicate."""
    cfg = ParallelismConfig(dp_shard_size=8)
    mesh = cfg.mesh_layout(8)
    plugin = FullyShardedDataParallelPlugin(min_weight_size=0)
    params = {"w": (64, 4), "b": (4,), "tiny": (16, 4)}
    plan = tsh.make_sharding_plan(params, mesh, cfg, plugin)
    assert _norm(plan["w"]) == [("dp_shard",), ()]
    assert _norm(plan["b"]) == [()]
    assert _norm(plan["tiny"]) == [(), ()]
    opt = tsh.make_opt_state_sharding_plan({f"mu/{n}": s for n, s in params.items()}, plan, mesh,
                                           cfg, plugin)
    assert _norm(opt["mu/w"]) == _norm(plan["w"])


def test_cp_params_replicated_moments_joint_sharded():
    """JAX ``tests/test_accelerator.py:224``: under cp 2 x dp_shard 4 the
    params shard over dp_shard only, the moments over the joint axes."""
    cfg = ParallelismConfig(cp_size=2, dp_shard_size=4)
    mesh = cfg.mesh_layout(8)
    plugin = FullyShardedDataParallelPlugin(min_weight_size=0)
    plan = tsh.make_sharding_plan({"w": (64, 128)}, mesh, cfg, plugin)
    assert "cp" not in str(plan["w"]) and "dp_shard" in str(plan["w"])
    opt = tsh.make_opt_state_sharding_plan({"mu/w": (64, 128)}, plan, mesh, cfg, plugin)
    assert "cp" in str(opt["mu/w"]) and "dp_shard" in str(opt["mu/w"])


def test_strategies_and_tp_rules():
    """The strategies' parameter axes (NO_SHARD / SHARD_GRAD_OP replicate,
    cp never), JAX's tp and MoE rule tables as data."""
    from accelerate_tpu.utils.dataclasses import ShardingStrategy as JS

    cfg, jcfg = ParallelismConfig(cp_size=2, dp_shard_size=4), JConfig(cp_size=2,
                                                                       dp_shard_size=4)
    jmesh = jcfg.build_device_mesh(devices=jax.devices())
    for s in ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD", "HYBRID_SHARD"):
        assert tsh.param_fsdp_axes(cfg.mesh_layout(8), cfg, s) == jsh.param_fsdp_axes(
            jmesh, jcfg, JS(s))
        assert tsh.resolve_sharding_strategy(FullyShardedDataParallelPlugin(
            sharding_strategy=s), cfg) == jsh.resolve_sharding_strategy(
            JPlugin(sharding_strategy=s), jcfg)
    assert tsh.resolve_sharding_strategy(None, cfg) == jsh.resolve_sharding_strategy(None, jcfg)
    assert [(p, _norm(s)) for p, s in tsh.TRANSFORMER_TP_RULES] == [
        (p, _norm(s)) for p, s in jsh.TRANSFORMER_TP_RULES]
    from accelerate_tpu.parallel.expert_parallel import get_moe_rules as j_get_moe_rules

    assert [(p, _norm(s)) for p, s in tsh.get_tp_rules("moe")] == [
        (p, _norm(s)) for p, s in j_get_moe_rules()]
