"""Expert parallelism held against the JAX package's (mirrors JAX
``tests/test_expert_parallel.py`` :23-:145): the capacity, routing bitwise
JAX's (ties to the lower index, slot-major priority, drops beyond
capacity), the uniform router's aux loss, the dispatch / combine round
trip, ``expert_parallel_apply`` against local compute on an ep gang, the
MoE rule table on the port's names, the tiny Mixtral's train step with its
experts split over ep (ep 2 x dp_shard 2 and ep 4 gangs of 4 CPU
processes, and the card's in-process virtual world) equal to the
single-process step, and the -sr / -sr8 updates of the expert slices
bitwise the whole leaf's.

Tolerances: dispatch masks bitwise; combine weights and the router losses
at 1e-6 (f32, one softmax each side); the exchange at 1e-6; the ep steps'
losses and grad norms against the single-process step at rtol 1e-5 and
the params after 3 adamw steps at lr 1e-2 within 3 * lr (adam moves an
element whose gradient is at rounding level by up to lr a step, as in
``test_torch_tensor_parallel.py``), at 1.2e-4 on 99.9 % of each leaf;
against JAX's ep-sharded trajectory at JAX's own rtol 2e-4 (losses) and
5e-3 (grad norms); the virtual world's loss and re-assembled gradients at
1e-5 relative (f32, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.models import MixtralConfig as JMixtralConfig
from accelerate_tpu.models import MixtralForCausalLM as JMixtral
from accelerate_tpu.models.mixtral import make_mixtral_loss_fn as j_mixtral_loss
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu.parallel import expert_parallel as jep
from accelerate_tpu.parallel.sharding import make_sharding_plan as j_make_sharding_plan
from accelerate_tpu.parallelism_config import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.utils.dataclasses import TensorParallelConfig as JTensorParallelConfig
from accelerate_tpu_torch import Accelerator, ParallelismConfig
from accelerate_tpu_torch.models import mixtral as tm
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.optimizer import make_optimizer
from accelerate_tpu_torch.parallel import expert_parallel as tep
from accelerate_tpu_torch.parallel.sharding import get_tp_rules, make_sharding_plan, path_str
from accelerate_tpu_torch.parallel.virtual import VirtualMesh, module_replica
from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER
from accelerate_tpu_torch.test_utils.gang import run_gang


def _tokens():
    return np.random.default_rng(3).integers(0, 256, (4, 32)).astype(np.int32)


def _route_both(logits, k, cap, normalize=True):
    j = jep.top_k_routing(jnp.asarray(logits), k, cap, normalize_weights=normalize)
    t = tep.top_k_routing(torch.from_numpy(np.asarray(logits, np.float32)), k, cap,
                          normalize_weights=normalize)
    return j, t


def _same_routing(j, t):
    np.testing.assert_array_equal(t.dispatch.numpy(), np.asarray(j.dispatch))
    np.testing.assert_allclose(t.combine.numpy(), np.asarray(j.combine), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.aux_loss.item(), float(j.aux_loss), rtol=1e-6)
    np.testing.assert_allclose(t.z_loss.item(), float(j.z_loss), rtol=1e-6)


@pytest.mark.parametrize("args", [(128, 8, 2, 1.25), (4, 8, 1, 1.0), (1024, 8, 2, 1.0),
                                  (4096, 8, 2, 1.25), (100, 6, 3, 1.5), (7, 4, 2, 0.5)])
def test_expert_capacity_padding(args):
    assert tep.expert_capacity(*args) == jep.expert_capacity(*args)
    assert tep.expert_capacity(*args) % 8 == 0 and tep.expert_capacity(*args) >= 8
    assert tep.expert_capacity(4, 8, 1, 1.0) == 8
    assert tep.expert_capacity(1024, 8, 2, 1.0) == 256


@pytest.mark.parametrize("s,e,k,factor", [(64, 8, 2, 2.0), (64, 8, 2, 0.5), (96, 4, 1, 1.0),
                                          (33, 6, 3, 1.25)])
def test_top_k_routing_bitwise_jax(s, e, k, factor):
    """Random logits: the dispatch masks equal JAX's bitwise; with generous
    capacity every token keeps k slots, normalised weights sum to one and
    no slot holds two tokens (JAX's shapes-and-weights test)."""
    logits = np.random.default_rng(s + e).normal(size=(s, e)).astype(np.float32)
    cap = tep.expert_capacity(s, e, k, factor)
    j, t = _route_both(logits, k, cap)
    _same_routing(j, t)
    assert t.dispatch.shape == (s, e, cap) and t.combine.shape == (s, e, cap)
    assert int(t.dispatch.sum(dim=(1, 2)).max()) <= k
    assert int(t.dispatch.sum(dim=0).max()) <= 1
    if factor >= 2.0:
        assert int(t.dispatch.sum()) == s * k
        np.testing.assert_allclose(t.combine.sum(dim=(1, 2)).numpy(), 1.0, atol=1e-5)


def test_routing_ties_follow_lax_top_k():
    """Equal probabilities pick the lower expert index first (``lax.top_k``),
    and the second choices queue behind every first choice."""
    rng = np.random.default_rng(5)
    logits = np.round(rng.normal(size=(48, 4)), 0).astype(np.float32)   # many ties
    logits[:8] = 0.0                                                     # all four tied
    for cap in (8, 16, 48):
        j, t = _route_both(logits, 2, cap)
        _same_routing(j, t)
    _, idx = tep.top_k_choices(torch.zeros(1, 4), 2)
    assert idx.tolist() == [[0, 1]]


def test_routing_drops_beyond_capacity():
    """Every token wants expert 0 at capacity 8: 8 kept, the rest dropped
    with zero combine weight, bitwise JAX's."""
    s, e = 32, 4
    logits = np.tile(np.asarray([[10.0, 0.0, 0.0, 0.0]], np.float32), (s, 1))
    j, t = _route_both(logits, 1, 8)
    _same_routing(j, t)
    assert int(t.dispatch[:, 0, :].sum()) == 8
    assert int((t.combine.sum(dim=(1, 2)) > 1e-6).sum()) == 8
    assert t.dispatch[:8, 0].any(dim=-1).all() and not t.dispatch[8:].any()


@pytest.mark.parametrize("parts", [2, 4])
def test_routing_of_a_row_range_is_the_whole_routing_sliced(parts):
    """A data-parallel rank's rows (``rows``): the dispatch bitwise and the
    combine exactly the whole routing's rows, under the whole batch's
    capacity and queue (drops included); the losses are the whole
    batch's, and ``loss_logits`` computes them from the tensor it is
    given."""
    s, e, k = 64, 8, 2
    logits = torch.from_numpy(np.random.default_rng(7).normal(size=(s, e)).astype(np.float32))
    cap = tep.expert_capacity(s, e, k, 0.5)
    whole = tep.top_k_routing(logits, k, cap)
    assert int(whole.dispatch.sum()) < s * k                             # some dropped
    n = s // parts
    for r in range(parts):
        rows = slice(r * n, (r + 1) * n)
        part = tep.top_k_routing(logits, k, cap, rows=rows, loss_logits=logits * 1.0)
        assert torch.equal(part.dispatch, whole.dispatch[rows])
        assert torch.equal(part.combine, whole.combine[rows])
        assert torch.equal(part.aux_loss, whole.aux_loss)
        assert torch.equal(part.z_loss, whole.z_loss)
    shifted = tep.top_k_routing(logits, k, cap, loss_logits=logits + 1.0)
    assert torch.equal(shifted.dispatch, whole.dispatch)
    assert not torch.equal(shifted.z_loss, whole.z_loss)


def test_uniform_router_aux_loss_is_one():
    s, e = 1024, 8
    t = tep.top_k_routing(torch.zeros(s, e), 2, tep.expert_capacity(s, e, 2, 2.0))
    np.testing.assert_allclose(t.aux_loss.item(), 1.0, atol=0.05)
    j = jep.top_k_routing(jnp.zeros((s, e)), 2, jep.expert_capacity(s, e, 2, 2.0))
    np.testing.assert_allclose(t.aux_loss.item(), float(j.aux_loss), rtol=1e-6)


def test_dispatch_combine_roundtrip():
    """Top-1 at generous capacity: identity experts give x back, and the
    grouped batches equal JAX's bitwise."""
    rng = np.random.default_rng(1)
    s, e, d = 32, 4, 16
    x = rng.normal(size=(s, d)).astype(np.float32)
    logits = rng.normal(size=(s, e)).astype(np.float32)
    cap = tep.expert_capacity(s, e, 1, 4.0)
    j, t = _route_both(logits, 1, cap)
    grouped = tep.moe_dispatch(torch.from_numpy(x), t)
    np.testing.assert_array_equal(grouped.numpy(), np.asarray(jep.moe_dispatch(jnp.asarray(x), j)))
    np.testing.assert_allclose(tep.moe_combine(grouped, t).numpy(), x, atol=1e-5)


def test_expert_parallel_apply_no_ep_axis():
    layout = ParallelismConfig().mesh_layout(1)
    out = tep.expert_parallel_apply(layout, lambda idx, b: b * 2.0, torch.ones(4, 8, 16))
    assert torch.equal(out, torch.full((4, 8, 16), 2.0))


def test_moe_rules_on_the_port_names():
    """``get_tp_rules("moe")`` is JAX's table as data, and the plan of the
    tiny Mixtral under ep 4 x dp_shard 2 is JAX's leaf for leaf (each
    expert leaf's dimension 0 on ep), in the port's layout."""
    def norm(spec):
        return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)

    assert [(p, norm(s)) for p, s in get_tp_rules("moe")] == [
        (p, norm(s)) for p, s in jep.get_moe_rules()]
    assert get_tp_rules("mixtral") == get_tp_rules("moe")
    cfg = JMixtralConfig.tiny(dtype=jnp.float32)
    params = JMixtral(cfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    jcfg = JaxParallelismConfig(dp_shard_size=2, ep_size=4, devices=tuple(jax.devices()[:8]))
    jplan = j_make_sharding_plan(params, jcfg.build_device_mesh(jax.devices()[:8]), jcfg,
                                 tp_rules=jep.get_moe_rules())
    flat = {".".join(str(getattr(k, "key", k)) for k in path): v.spec
            for path, v in jax.tree_util.tree_flatten_with_path(jplan)[0]}
    model = tm.MixtralForCausalLM(tm.MixtralConfig.tiny(), device="meta")
    pcfg = ParallelismConfig(dp_shard_size=2, ep_size=4)
    plan = make_sharding_plan(dict(model.named_parameters()), pcfg.mesh_layout(8), pcfg, None,
                              get_tp_rules("moe"))
    for name, spec in plan.items():
        jspec = list(norm(flat["params." + path_str(name).replace("/", ".")]))
        jspec += [None] * (len(spec) - len(jspec))
        if path_str(name).endswith("/kernel"):
            jspec[-1], jspec[-2] = jspec[-2], jspec[-1]
        assert norm(spec) == tuple(jspec), name
        if tm.is_expert_leaf(name):
            assert spec[0] == "ep"


@pytest.fixture(scope="module")
def host():
    cfg = JMixtralConfig.tiny(dtype=jnp.float32)
    params = JMixtral(cfg).init(jax.random.key(0), jnp.asarray(_tokens())[:, :8])
    return jax.tree.map(lambda x: np.array(x, copy=True), params)


@pytest.fixture(scope="module")
def state_path(host, tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_state")
    torch.save(torch_state_from_flax(host), d / "tiny_mixtral.pt")
    return d / "tiny_mixtral.pt"


def _apply_inputs():
    rng = np.random.default_rng(2)
    return (rng.normal(size=(8, 16, 32)).astype(np.float32),
            rng.normal(size=(8, 16, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def gang(state_path, tmp_path_factory):
    x, g = _apply_inputs()
    return run_gang("accelerate_tpu_torch.test_utils.scripts.expert_parallel_checks:ep_checks",
                    4, tmp_path_factory.mktemp("ep4"), timeout=240,
                    state_path=str(state_path), tokens=_tokens(), x=x, g=g)


@pytest.fixture(scope="module")
def single(state_path):
    """The port's single-process step: 3 adamw steps at lr 1e-2, clipped."""
    acc = Accelerator(cpu=True)
    model = tm.MixtralForCausalLM(tm.MixtralConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(torch.load(state_path))
    state = acc.create_train_state(model, make_optimizer("adamw", 1e-2))
    step = acc.prepare_train_step(tm.make_mixtral_loss_fn(model), max_grad_norm=1.0)
    ids = torch.from_numpy(_tokens()).long()
    out = []
    for _ in range(3):
        state, m = step(state, {"input_ids": ids, "labels": ids})
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return np.asarray(out), {n: p.detach().numpy().copy() for n, p in state.params.items()}


def test_expert_parallel_apply_matches_local(gang):
    """The two all_to_alls over ep 4 (2 experts a rank): the output and the
    input's gradient equal local compute, each rank's experts get their
    global indices."""
    x, g = _apply_inputs()
    scales = (np.arange(8) + 1.0)[:, None, None]
    for rep in gang:
        np.testing.assert_allclose(rep["apply"]["out"], x * scales, atol=1e-6)
        np.testing.assert_allclose(rep["apply"]["dx"], g * scales, atol=1e-6)
    assert [r["apply"]["indices"] for r in gang] == [[0, 1], [2, 3], [4, 5], [6, 7]]


@pytest.mark.parametrize("label", ["ep2_dp2", "ep4"])
def test_ep_train_step_matches_single_process(gang, single, label):
    """The ep step (experts split over ep, the batch over dp_shard, the
    routing the global batch's) equals the single-process step; every rank
    agrees; each rank holds E / ep experts."""
    traj, params = single
    ep = 2 if label == "ep2_dp2" else 4
    for rep in gang:
        got = rep[label]
        np.testing.assert_allclose(got["trajectory"], traj, rtol=1e-5)
        for n, want in params.items():
            diff = np.abs(got["params"][n] - want)
            assert diff.max() <= 3e-2, n
            assert np.mean(diff <= 1.2e-4) >= 0.999, n
    shapes = gang[0][label]["local_shapes"]
    if label == "ep4":
        assert shapes["model.layers.0.block_sparse_moe.experts.gate_proj"] == (4 // ep, 64, 128)
        assert shapes["model.layers.0.block_sparse_moe.experts.down_proj"] == (4 // ep, 128, 64)
        assert shapes["model.layers.0.block_sparse_moe.gate.weight"] == (4, 64)


def test_ep_train_step_matches_jax(host, gang):
    """JAX's step on ep 4 x dp_shard 2 of its CPU devices (the MoE plan):
    the same losses and grad norms as the port's ep gangs."""
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    try:
        acc = JaxAccelerator(parallelism_config=JaxParallelismConfig(
            dp_shard_size=2, ep_size=4, devices=tuple(jax.devices()[:8])),
            tp_config=JTensorParallelConfig(plan="moe"))
        model = JMixtral(JMixtralConfig.tiny(dtype=jnp.float32))
        state = acc.create_train_state(jax.tree.map(jnp.asarray, host),
                                       jax_make_optimizer("adamw", 1e-2), apply_fn=model.apply)
        step = acc.prepare_train_step(j_mixtral_loss(model), max_grad_norm=1.0)
        ids = jnp.asarray(_tokens())
        want = []
        for _ in range(3):
            state, m = step(state, {"input_ids": ids, "labels": ids})
            want.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        JaxAcceleratorState._reset_state(reset_partial_state=True)
        JaxGradientState._reset_state()
    want = np.asarray(want)
    for label in ("ep2_dp2", "ep4"):
        got = gang[0][label]["trajectory"]
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-4)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3)


@pytest.mark.parametrize("label", ["bitwise_ep4", "bitwise_dp2_ep2"])
def test_sharded_sr_updates_bitwise_under_ep(gang, label):
    """Two -sr / -sr8 updates of the expert slices (a dimension-0 range of
    whole experts, under dp_shard its ranges) equal the whole-leaf update,
    params and optimizer state, on every rank; no expert leaf relays."""
    for rep in gang:
        got = rep[label]
        for recipe in ("lion-sr", "adamw-sr", "lion-sr8", "adamw-sr8"):
            assert got[recipe] == {"params": True, "state": True}, (label, recipe)
        assert got["relay"] == [] and got["model_axes"] == ["ep"]
        assert len(got["tp_leaves"]) == 6 and all(tm.is_expert_leaf(n) for n in got["tp_leaves"])


def test_virtual_ep_world_matches_single_process():
    """The card's ep: 4 ranks as threads (``VirtualMesh.run``), each its
    module replica on its expert slice; one backward over the ranks'
    losses gives the single-process loss and gradients (the replicated
    leaves' whole on every rank, the experts' re-assembled)."""
    cfg = tm.MixtralConfig.tiny(dtype=torch.float32, num_local_experts=8)
    model = tm.MixtralForCausalLM(cfg, device="cpu", seed=2)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids = torch.from_numpy(_tokens()).long()
    batch = {"input_ids": ids, "labels": ids}
    loss_fn = tm.make_mixtral_loss_fn(model)
    ref_p = {n: t.clone().requires_grad_() for n, t in full.items()}
    ref = loss_fn(ref_p, batch)
    ref.backward()
    ep = 4
    layout = tuple(ep if a == "ep" else 1 for a in MESH_AXIS_ORDER)
    mesh = VirtualMesh(MESH_AXIS_ORDER, layout)
    shards = [{n: (t.chunk(ep, dim=0)[r] if tm.is_expert_leaf(n) else t).clone().requires_grad_()
               for n, t in full.items()} for r in range(ep)]
    replicas = [module_replica(model) for _ in range(ep)]
    losses = mesh.run(lambda r: tm.make_mixtral_loss_fn(replicas[r])(shards[r], batch),
                      ParallelismConfig(ep_size=ep))
    torch.autograd.backward(losses)
    assert mesh.calls == {"pbroadcast": 2 * cfg.num_hidden_layers,
                          "psum": cfg.num_hidden_layers}
    for loss in losses:
        np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-6)
    for n, p in ref_p.items():
        if tm.is_expert_leaf(n):
            got = torch.cat([s[n].grad for s in shards], dim=0)
        else:
            got = shards[0][n].grad
            for s in shards[1:]:
                torch.testing.assert_close(s[n].grad, got, rtol=0, atol=0)
        err = (got - p.grad).norm() / p.grad.norm().clamp(min=1e-30)
        assert err.item() <= 1e-5, n
