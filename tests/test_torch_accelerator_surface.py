"""The port's one-process ``Accelerator`` surface held against the JAX
package's: ``prepare_eval_step`` (JAX ``tests/test_accelerator.py:458``),
the triggers (:470), ``has_aux`` (ResNet's batch statistics), the
gradient helpers, ``unwrap_model``, ``free_memory``, ``init_params``,
``no_sync``, ``autocast`` (bitwise), ``donate_state``, the kwargs handlers,
the process helpers, the A13 raises, the pp and ep worlds (a gloo gang of
two CPU processes: ``prepare_pipeline`` unwrapped, the batch replicated
over ep, the expert slices) and a name-by-name comparison of the two
classes.

Inputs are seeded numpy; f32 values at 1e-5, bf16 ones bitwise where both
sides round the same products once.
"""

import ast
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu.models.bert import BertConfig as JBertConfig
from accelerate_tpu.models.bert import BertForSequenceClassification as JBert
from accelerate_tpu.models.resnet import ResNet as JResNet
from accelerate_tpu.models.resnet import ResNetConfig as JResNetConfig
from accelerate_tpu.models.resnet import make_resnet_loss_fn as j_resnet_loss
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.utils.dataclasses import AutocastKwargs as JAutocastKwargs
from accelerate_tpu_torch import Accelerator, GradientAccumulationPlugin
from accelerate_tpu_torch import state as tstate
from accelerate_tpu_torch.big_modeling import abstract_init
from accelerate_tpu_torch.models import (
    BertConfig,
    BertForSequenceClassification,
    ResNet,
    ResNetConfig,
    make_resnet_loss_fn,
    torch_state_from_flax_resnet,
)
from accelerate_tpu_torch.models.convert import resnet_batch_stats_from_flax
from accelerate_tpu_torch.ops import precision as tprecision
from accelerate_tpu_torch.utils.dataclasses import (
    AutocastKwargs,
    InitProcessGroupKwargs,
    ProfileKwargs,
)

REPO = Path(__file__).resolve().parents[1]


def _public_methods(path: Path) -> set:
    tree = ast.parse(path.read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "Accelerator")
    return {f.name for f in cls.body if isinstance(f, ast.FunctionDef)
            and not f.name.startswith("_")}


def test_accelerator_surface_covers_jax_but_audits():
    """Name by name: every public method or property of the JAX class is
    the port's but the two with no eager meaning."""
    jax_names = _public_methods(REPO / "accelerate_tpu" / "accelerator.py")
    port_names = _public_methods(REPO / "accelerate_tpu_torch" / "accelerator.py")
    assert jax_names - port_names == {"audit_step", "compile_events"}


A13_CALLS = {
    "gather": lambda a: a.gather(torch.ones(2)),
    "reduce": lambda a: a.reduce(torch.ones(2)),
    "pad_across_processes": lambda a: a.pad_across_processes(torch.ones(2)),
    "split_between_processes": lambda a: a.split_between_processes([1, 2]),
    "dcn_sync": lambda a: a.dcn_sync,
    "dcn_sync_accounting": lambda a: a.dcn_sync_accounting({}),
    "recover": lambda a: a.recover(),
    "peer_snapshotter": lambda a: a.peer_snapshotter,
    "maybe_context_parallel": lambda a: a.maybe_context_parallel([torch.ones(2)]),
    "join_uneven_inputs": lambda a: a.join_uneven_inputs([]),
    "mesh": lambda a: a.mesh,
    "parallelism_config": lambda a: a.parallelism_config,
}
# ported since: the collectives façade, the data / context parallel
# surface and the multi-node data parallelism and recovery surface, each
# held here to its one-process meaning (tests/test_torch_operations.py,
# test_torch_data_parallel.py, test_torch_hierarchical.py and
# test_torch_peer_ckpt.py hold them on gangs of processes)
PORTED = {"gather", "reduce", "pad_across_processes", "split_between_processes",
          "maybe_context_parallel", "join_uneven_inputs", "mesh", "parallelism_config",
          "dcn_sync", "dcn_sync_accounting", "recover", "peer_snapshotter"}


@pytest.mark.parametrize("name", sorted(A13_CALLS))
def test_multi_gpu_surface_raises_naming_a13(name):
    acc = Accelerator(cpu=True)
    if name not in PORTED:
        with pytest.raises(NotImplementedError, match="A13"):
            A13_CALLS[name](acc)
        return
    out = A13_CALLS[name](acc)
    if name in ("gather", "reduce", "pad_across_processes"):
        assert torch.equal(out, torch.ones(2))
    elif name == "split_between_processes":
        with out as value:
            assert value == [1, 2]
    elif name == "maybe_context_parallel":
        with out as value:
            assert len(value) == 1 and torch.equal(value[0], torch.ones(2))
    elif name == "join_uneven_inputs":
        with out as value:
            assert value is None
    elif name in ("dcn_sync", "peer_snapshotter"):
        # nothing resolved before a prepared step, nothing armed before one
        assert out is None
    elif name == "dcn_sync_accounting":
        assert out["dcn_bytes"] == out["dcn_bytes_flat"] == 0 and out["dcn_size"] == 1
    elif name == "recover":
        # no snapshots, no checkpoints: the fresh rung
        restored, report = out
        assert restored is None and report["restore_path"] == "fresh"
    elif name == "mesh":
        # a world of one process: every axis of the JAX package's mesh, size 1
        assert dict(zip(out.mesh_dim_names, out.mesh.shape)) == {
            a: 1 for a in ("dcn", "dp_replicate", "pp", "dp_shard", "cp", "sp", "tp", "ep")}
    else:
        assert out.total_size == 1 and out.dp_shard_size == 1


def test_process_helpers_one_process_meaning():
    acc, jacc = Accelerator(cpu=True), JaxAccelerator()
    for attr in ("num_processes", "process_index", "local_process_index", "is_main_process",
                 "is_local_main_process", "is_last_process"):
        assert getattr(acc, attr) == getattr(jacc, attr), attr
    # one card, one process (the JAX test mesh has 8 devices in one process)
    assert acc.distributed_type == "NO" and str(acc.distributed_type) == "NO"
    assert acc.use_distributed is False
    for deco in ("on_main_process", "on_local_main_process", "on_last_process"):
        assert getattr(acc, deco)(lambda x: x + 1)(1) == getattr(jacc, deco)(lambda x: x + 1)(1)
    assert acc.on_main_process()(lambda: 3)() == 3
    assert acc.on_process(lambda: 5, process_index=0)() == jacc.on_process(
        lambda: 5, process_index=0)()
    assert acc.on_process(lambda: 5, process_index=1)() is None
    ran = []
    with acc.main_process_first():
        ran.append(1)
    with acc.local_main_process_first():
        ran.append(2)
    assert ran == [1, 2]
    acc.wait_for_everyone()
    assert tstate.is_initialized()


def test_print_on_main_process(capsys):
    Accelerator(cpu=True).print("hello", 3)
    assert capsys.readouterr().out == "hello 3\n"


def test_kwargs_handlers_are_stored():
    handlers = [AutocastKwargs(), ProfileKwargs(active=2),
                InitProcessGroupKwargs(coordinator_address="localhost:1234")]
    acc = Accelerator(cpu=True, kwargs_handlers=handlers)
    assert acc.autocast_handler is handlers[0]
    assert acc.profile_kwargs is handlers[1]
    assert acc.init_process_group_kwargs is handlers[2]
    assert Accelerator(cpu=True).profile_kwargs == ProfileKwargs()
    with pytest.raises(TypeError, match="kwargs handler"):
        Accelerator(cpu=True, kwargs_handlers=[object()])
    # knobs the port has no use for fail when set, not silently
    for bad in (dict(enabled=False), dict(cache_enabled=False)):
        with pytest.raises(ValueError, match="autocast cannot be disabled"):
            AutocastKwargs(**bad)
    with pytest.raises(ValueError, match="Perfetto"):
        ProfileKwargs(create_perfetto_link=True)
    # several processes need a rendezvous: no address raises, nothing
    # drops to one process
    with pytest.raises(ValueError, match="coordinator_address"):
        Accelerator(cpu=True, kwargs_handlers=[InitProcessGroupKwargs(num_processes=2)])


def _regression_params():
    return {"a": torch.tensor(0.7), "b": torch.tensor(-1.3)}


@pytest.mark.parametrize("mp", ["no", "bf16"])
def test_eval_step_matches_jax(mp):
    """JAX's test_eval_step with values: the compute cast applied, the
    same outputs (bf16: the same roundings, so bitwise)."""
    x = np.random.default_rng(0).normal(size=(4,)).astype(np.float32)
    jacc = JaxAccelerator(mixed_precision=mp)
    jstate = jacc.create_train_state({"a": jnp.float32(0.7), "b": jnp.float32(-1.3)},
                                      optax.sgd(0.1))
    jout = jacc.prepare_eval_step(lambda p, b: p["a"] * b["x"] + p["b"])(
        jstate.params, {"x": jnp.asarray(x).astype(jacc.policy.compute_dtype)})
    acc = Accelerator(cpu=True, mixed_precision=mp)
    state = acc.create_train_state(_regression_params(), "adamw")
    estep = acc.prepare_eval_step(lambda p, b: p["a"] * b["x"] + p["b"])
    out = estep(state.params, {"x": torch.from_numpy(x).to(acc.policy.compute_dtype)})
    assert out.shape == (4,) and not out.requires_grad
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(jout, np.float32))


def test_eval_step_runs_under_fp8_autocast_with_fp8():
    seen = []

    def eval_fn(params, batch):
        seen.append(tprecision.fp8_enabled())
        return params["a"]

    for mp in ("fp8", "bf16"):
        acc = Accelerator(cpu=True, mixed_precision=mp)
        acc.prepare_eval_step(eval_fn)(_regression_params(), {})
    assert seen == [True, False]


def test_set_and_check_trigger_as_jax():
    acc, jacc = Accelerator(cpu=True), JaxAccelerator()
    for a in (acc, jacc):
        assert not a.check_trigger()
        a.set_trigger()
        assert a.check_trigger()
        assert not a.check_trigger()


def test_gradient_helpers_match_jax():
    rng = np.random.default_rng(1)
    grads = {"w": rng.normal(size=(5, 3)).astype(np.float32) * 3,
             "b": rng.normal(size=(3,)).astype(np.float32)}
    jacc = JaxAccelerator()
    want = jacc.clip_grad_value_(jax.tree.map(jnp.asarray, grads), 0.5)
    acc = Accelerator(cpu=True)
    got = acc.clip_grad_value_({k: torch.from_numpy(v) for k, v in grads.items()}, 0.5)
    for k in grads:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    as_list = acc.clip_grad_value_([torch.from_numpy(grads["w"])], 0.5)
    assert torch.equal(as_list[0], got["w"])
    assert acc.unscale_gradients() is None and jacc.unscale_gradients() is None
    assert isinstance(acc.no_sync(), contextlib.nullcontext)
    with acc.no_sync(torch.nn.Linear(2, 2)):
        pass


def test_unwrap_model_and_free_memory():
    model = torch.nn.Linear(3, 2)
    acc = Accelerator(cpu=True)
    assert acc.unwrap_model(model) is model
    assert acc.unwrap_model(torch.compile(model)) is model
    assert acc.unwrap_model(torch.nn.DataParallel(torch.compile(model))) is model
    acc.prepare(model)
    acc.prepare_optimizer("adamw")
    acc.step_count = 3
    a, b = acc.free_memory(1, 2)
    assert (a, b) == (1, 2)
    assert acc._models == [] and acc._optimizers == [] and acc.step_count == 0
    assert acc.clear() == ()


def test_init_params_materialises_a_meta_model_like_jax():
    """``init_params`` on a model built on ``meta``: every parameter
    materialised on the accelerator's device, leaf for leaf the JAX
    package's ``init_params`` tree (count and shapes)."""
    cfg = dict(dtype=torch.float32)
    model = abstract_init(BertForSequenceClassification, BertConfig.tiny(**cfg), device="cpu")
    assert all(p.device.type == "meta" for p in model.parameters())
    acc = Accelerator(cpu=True)
    params = acc.init_params(model, 0)
    assert all(p.device.type == "cpu" and torch.isfinite(p).all() for p in params.values())
    ids = jnp.zeros((1, 8), jnp.int32)
    jparams = JaxAccelerator().init_params(JBert(JBertConfig.tiny(dtype=jnp.float32)),
                                           jax.random.PRNGKey(0), ids, jnp.ones_like(ids), ids)
    jsizes = sorted(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    assert sorted(p.numel() for p in params.values()) == jsizes
    # a built module is moved, its values kept
    built = torch.nn.Linear(2, 2)
    w = built.weight.detach().clone()
    assert torch.equal(acc.init_params(built)["weight"], w)


def _regression_loss(params, batch):
    return ((params["a"] * batch["x"] + params["b"] - batch["y"]) ** 2).mean()


def _regression_batch():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8,)).astype(np.float32)
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(2 * x + 3)}


def test_autocast_leaves_the_step_bitwise():
    outs = []
    for ctx in (False, True):
        acc = Accelerator(cpu=True, mixed_precision="bf16")
        state = acc.create_train_state(_regression_params(), "adamw")
        step = acc.prepare_train_step(_regression_loss)
        cm = acc.autocast(AutocastKwargs()) if ctx else contextlib.nullcontext()
        with cm:
            state, metrics = step(state, _regression_batch())
        outs.append((metrics["loss"], metrics["grad_norm"], state.params["a"],
                     state.params["b"]))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    with JaxAccelerator().autocast(JAutocastKwargs()):
        pass


def test_donate_state_false_keeps_the_input():
    acc = Accelerator(cpu=True)
    state = acc.create_train_state(_regression_params(), "lion-sr8")
    before = {k: v.clone() for k, v in state.params.items()}
    mu = [t.clone() for t in state.opt_state.mu]
    step = acc.prepare_train_step(_regression_loss, donate_state=False)
    new, _ = step(state, _regression_batch())
    for k in before:
        assert torch.equal(state.params[k], before[k])
        assert not torch.equal(new.params[k], before[k])
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu, mu))
    assert state.step == 0 and new.step == 1
    # the donated default moves the input's params in place
    donated = acc.create_train_state(_regression_params(), "lion-sr8")
    held = donated.params["a"]
    acc.prepare_train_step(_regression_loss)(donated, _regression_batch())
    assert not torch.equal(held, torch.tensor(0.7))


def test_has_aux_simple_and_with_accumulation():
    """JAX's test_train_step_has_aux_simple, and under ``in_step``
    accumulation the last microbatch's aux."""
    def loss_fn(params, batch):
        pred = params["a"] * batch["x"] + params["b"]
        return ((pred - batch["y"]) ** 2).mean(), {"pred_mean": pred.mean(),
                                                   "first": batch["x"][0]}

    acc = Accelerator(cpu=True)
    state = acc.create_train_state(_regression_params(), "adamw")
    state, metrics = acc.prepare_train_step(loss_fn, has_aux=True)(state, _regression_batch())
    assert torch.isfinite(metrics["aux"]["pred_mean"])
    assert not metrics["aux"]["pred_mean"].requires_grad
    acc = Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
        num_steps=4))
    state = acc.create_train_state(_regression_params(), "adamw")
    batch = _regression_batch()
    _, metrics = acc.prepare_train_step(loss_fn, has_aux=True)(state, batch)
    assert torch.equal(metrics["aux"]["first"], batch["x"][6])


def test_has_aux_resnet_batch_stats_match_jax():
    """cv_example's step: ResNet's new running averages come out as
    ``metrics["aux"]``, equal to the JAX step's, and fold back."""
    jmodel = JResNet(JResNetConfig.tiny(dtype=jnp.float32))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), train=False)
    # host copies first: the JAX step donates (deletes) its input state
    variables = jax.tree.map(lambda x: np.array(x, copy=True), variables)
    rng = np.random.default_rng(5)
    images = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (8,))
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    jacc = JaxAccelerator()
    jstate = jacc.create_train_state(jax.tree.map(jnp.asarray, dict(variables)),
                                      optax.sgd(0.1))
    jstep = jacc.prepare_train_step(j_resnet_loss(jmodel), has_aux=True)
    _, jmetrics = jstep(jstate, {"image": jnp.asarray(images), "label": jnp.asarray(labels)})

    model = ResNet(ResNetConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(torch_state_from_flax_resnet(variables))
    acc = Accelerator(cpu=True)
    state = acc.create_train_state(model, "adamw")
    step = acc.prepare_train_step(make_resnet_loss_fn(model), has_aux=True)
    state, metrics = step(state, {"image": torch.from_numpy(images),
                                  "label": torch.from_numpy(labels)})
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-5 * float(
        jmetrics["loss"])
    want = resnet_batch_stats_from_flax(jax.tree.map(np.asarray, jmetrics["aux"]))
    assert set(metrics["aux"]) == set(want)
    for name, s in want.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(metrics["aux"][name][k].numpy(), s[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name}.{k}")
    model.load_batch_stats(metrics["aux"])
    assert torch.equal(model.stem_bn.mean, metrics["aux"]["stem_bn"]["mean"])


def test_pp_and_ep_worlds_build(tmp_path):
    """``ParallelismConfig(pp_size=2)`` and ``(ep_size=2)`` build their
    worlds on two processes: ``unwrap_model(prepare_pipeline(...))`` is the
    model, a stage holds half the layers; under ep the prepared loader
    gives both ranks the same batches (ep counts in
    ``non_data_parallel_size``) and each rank half the experts."""
    from accelerate_tpu_torch.test_utils.gang import run_gang

    reps = run_gang("accelerate_tpu_torch.test_utils.scripts.pipeline_parallel_checks:"
                    "surface_checks", 2, tmp_path, timeout=120)
    for rep in reps:
        assert rep["pp"] == {"sizes": {"pp": 2}, "unwrapped": True, "stage_layers": 1}
        assert rep["ep"]["sizes"] == {"ep": 2} and rep["ep"]["non_data_parallel"] == 2
        assert rep["ep"]["experts"] == (2, 64, 128)
        assert len(rep["ep"]["batches"]) == 2
    for a, b in zip(reps[0]["ep"]["batches"], reps[1]["ep"]["batches"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("axis", ["tp", "cp", "sp"])
def test_pp_composed_with_a_split_names_a13h(axis):
    """pp with tp / cp / sp raises naming A13h, before any world is built;
    so does a pipeline over a mesh with such an axis."""
    from accelerate_tpu_torch import ParallelismConfig, prepare_pipeline
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    with pytest.raises(NotImplementedError, match="A13h"):
        Accelerator(cpu=True, parallelism_config=ParallelismConfig(
            pp_size=2, **{f"{axis}_size": 2}))
    layout = ParallelismConfig(pp_size=2, **{f"{axis}_size": 2}).mesh_layout(4)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="meta")
    with pytest.raises(NotImplementedError, match="A13h"):
        prepare_pipeline(model, mesh=layout)


@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_mixtral_under_a_split_names_a13h(axis):
    """Mixtral under tp (or sp) raises naming A13h in each rank's forward
    (the virtual world's ranks as threads)."""
    from accelerate_tpu_torch import MixtralConfig, MixtralForCausalLM, ParallelismConfig
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh, module_replica
    from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER

    model = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32), device="cpu")
    mesh = VirtualMesh(MESH_AXIS_ORDER, tuple(2 if a == axis else 1 for a in MESH_AXIS_ORDER))
    replicas = [module_replica(model) for _ in range(2)]
    params = {n: p.detach() for n, p in model.named_parameters()}
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="A13h"):
        mesh.run(lambda r: torch.func.functional_call(replicas[r], params, (ids,)),
                 ParallelismConfig(**{f"{axis}_size": 2}))
