"""The port's training step held against the JAX package's: the fused
linear + cross-entropy loss, the stochastic-rounding optimizers and the
prepared train step, on the same seeded numpy inputs and the same weights.

Tolerances: the losses and their gradients in f32 to 1e-5 (summation order
only).  The SR hash, the rounding and the lion-sr update are compared
**bitwise**; adamw-sr too, except where XLA's fused f32 ``exp`` in its
bias correction lands an ulp away from the correctly rounded value (at
step 2 and 3 for ``b1 = 0.9``), which moves a few elements' stochastic
roundings by one bf16 step.  The 10-step loss trajectories agree to 1e-3
relative (grad norms 5e-3): the first step matches to 1e-6, then the bf16
optimizer state turns summation-order differences of 1e-7 into bf16
roundings that land the other way — adamw's momentum rounds to nearest,
and lion-sr's stochastic rounding hashes the gradient itself, so a one-ulp
difference in a gradient element redraws that element's rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.accelerator import global_norm as jax_global_norm
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fused_xent as jfx
from accelerate_tpu.ops import stochastic_rounding as jsr
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import (
    Accelerator, GradientAccumulationPlugin, GradSyncKwargs, ResiliencePlugin,
    make_llama_loss_fn, make_optimizer,
)
from accelerate_tpu_torch import state as tstate
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.models.hf_interop import hf_llama_key_map
from accelerate_tpu_torch.ops import fused_xent as tfx
from accelerate_tpu_torch.ops import stochastic_rounding as tsr
from accelerate_tpu_torch.optimizer import AcceleratedOptimizer

TOL = dict(atol=1e-5, rtol=1e-5)


def _tiny_params(layers=2, seed=0):
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_hidden_layers=layers)
    model = jl.LlamaForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return model, params, jax.tree.map(lambda x: np.array(x, copy=True), params)


# -- fused linear + cross-entropy --------------------------------------------


@pytest.mark.parametrize("vocab_major", [True, False])
def test_fused_linear_xent_matches_jax(vocab_major):
    """Vocab 250 over 4 chunks (a padded last chunk), a quarter of the rows
    masked."""
    rng = np.random.default_rng(0)
    n, h, v = 37, 16, 250
    hidden = rng.normal(size=(n, h)).astype(np.float32)
    weight = rng.normal(size=(v, h) if vocab_major else (h, v)).astype(np.float32) * 0.3
    labels = rng.integers(0, v, n).astype(np.int32)
    mask = rng.random(n) > 0.25
    jloss, jgrads = jax.value_and_grad(
        lambda hd, w: jfx.fused_linear_xent(hd, w, jnp.asarray(labels), jnp.asarray(mask), 4,
                                            vocab_major), argnums=(0, 1),
    )(jnp.asarray(hidden), jnp.asarray(weight))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(weight).requires_grad_()
    tloss = tfx.fused_linear_xent(th, tw, torch.from_numpy(labels).long(),
                                  torch.from_numpy(mask), 4, vocab_major)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[0]), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrads[1]), **TOL)


def test_fused_loss_matches_unfused_causal_lm_loss_and_jax():
    """``fused_causal_lm_loss`` on hidden states equals ``causal_lm_loss``
    on the head's logits (the ignore index included), in value and in
    gradient; ``causal_lm_loss`` equals JAX's."""
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(2, 9, 16)).astype(np.float32)
    weight = rng.normal(size=(40, 16)).astype(np.float32) * 0.3       # [V, H]
    labels = rng.integers(0, 40, (2, 9)).astype(np.int64)
    labels[0, 3] = labels[1, 7] = -100
    results = []
    for fused in (True, False):
        th = torch.from_numpy(hidden).requires_grad_()
        tw = torch.from_numpy(weight).requires_grad_()
        if fused:
            loss = tfx.fused_causal_lm_loss(th, tw, torch.from_numpy(labels), vocab_major=True,
                                            num_chunks=3)
        else:
            loss = tl.causal_lm_loss(th @ tw.t(), torch.from_numpy(labels))
        loss.backward()
        results.append((loss.item(), th.grad.numpy(), tw.grad.numpy()))
    for a, b in zip(*results):
        np.testing.assert_allclose(a, b, **TOL)
    want = jl.causal_lm_loss(jnp.asarray(hidden @ weight.T), jnp.asarray(labels.astype(np.int32)))
    np.testing.assert_allclose(results[1][0], float(want), **TOL)


# -- stochastic rounding -----------------------------------------------------


def test_sr_noise_and_rounding_match_jax_bitwise():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(size=4000), [0.0, -0.0, 1e-40, 3.4e38, -2.5]]).astype(np.float32)
    e = rng.normal(size=x.shape).astype(np.float32)
    for salt in (0, 123456789, 0xFFFFFFFF):
        for entropy in (None, e):
            jbits = jsr.sr_noise_bits(jnp.asarray(x), jnp.uint32(salt),
                                      entropy=None if entropy is None else jnp.asarray(entropy))
            tbits = tsr.sr_noise_bits(torch.from_numpy(x), salt,
                                      None if entropy is None else torch.from_numpy(entropy))
            np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits).astype(np.int32))
            jr = jsr.stochastic_round_to_bf16_hashed(
                jnp.asarray(x), jnp.uint32(salt),
                entropy=None if entropy is None else jnp.asarray(entropy))
            tr = tsr.stochastic_round_to_bf16_hashed(
                torch.from_numpy(x), salt, None if entropy is None else torch.from_numpy(entropy))
            np.testing.assert_array_equal(tr.float().numpy(), np.asarray(jr.astype(jnp.float32)))


def _jax_tree(names, arrays):
    tree = {}
    for name in names:
        node = tree
        path = hf_llama_key_map(name).split(".")
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arrays[name]
    return tree


def test_leaf_order_is_flax_flatten_order():
    """Eleven layers: flax flattens ``layers_10`` before ``layers_2``."""
    _, _, host = _tiny_params(layers=11)
    state = torch_state_from_flax(host)
    leaves, _ = jax.tree_util.tree_flatten(host)
    order = tsr.flax_leaf_order(state)
    assert order.index("model.layers.10.mlp.up_proj.weight") < order.index(
        "model.layers.2.mlp.up_proj.weight")
    for leaf, name in zip(leaves, order):
        want = leaf.T if name.endswith("proj.weight") or name == "lm_head.weight" else leaf
        np.testing.assert_array_equal(state[name].numpy(), want)


@pytest.mark.parametrize("kind", ["lion-sr", "adamw-sr"])
def test_sr_optimizers_match_jax_over_three_steps(kind):
    """Equal f32 params, grads and state on a tree of 11 layers' MLP
    weights plus the embedding, head and final norm; three updates."""
    rng = np.random.default_rng(3)
    names = ([f"model.layers.{i}.mlp.up_proj.weight" for i in range(11)]
             + ["model.embed_tokens.weight", "lm_head.weight", "model.norm.weight"])
    shapes = {n: (9, 7) for n in names}
    shapes["model.norm.weight"] = (7,)
    params = {n: rng.normal(size=shapes[n]).astype(np.float32) for n in names}
    order = tsr.flax_leaf_order(names)
    jtx = jax_make_optimizer(kind, 1e-3, weight_decay=0.1, seed=5)
    ttx = make_optimizer(kind, 1e-3, weight_decay=0.1, seed=5)
    jp = jax.tree.map(jnp.asarray, _jax_tree(names, params))
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(params[n].copy()) for n in order]
    tstate_ = ttx.init(tp)
    for step in range(3):
        grads = {n: rng.normal(size=shapes[n]).astype(np.float32) for n in names}
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, _jax_tree(names, grads)),
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tnew, tstate_ = ttx.update([torch.from_numpy(grads[n]) for n in order], tstate_, tp)
        assert all(x.dtype == torch.bfloat16 for x in tnew)
        # JAX's -sr update is the f32 delta new - old, which optax.apply_updates
        # adds to the f32 params: take the port's new leaves the same way
        tp = [(p + (x.float() - p)).to(p.dtype) for p, x in zip(tp, tnew)]
        jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
        got = np.concatenate([p.numpy().ravel() for p in tp])
        want = np.concatenate([x.ravel() for x in jleaves])
        moments = [("mu", jstate.mu, tstate_.mu)]
        if kind == "adamw-sr":
            moments.append(("nu", jstate.nu, tstate_.nu))
        for label, jm, tm in moments:
            for a, b in zip(jax.tree_util.tree_leaves(jm), tm):
                np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32),
                                              err_msg=f"{label} step {step}")
        if kind == "lion-sr" or step == 0:
            np.testing.assert_array_equal(got, want)
        else:
            # XLA's bias correction can sit an ulp off the correctly rounded
            # value: a few elements round the other way, by one bf16 step
            assert (got == want).mean() > 0.97
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


# -- the train step ------------------------------------------------------------


def _jax_trajectory(recipe, accum, clip, chunks, batches):
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    model, params, host = _tiny_params()
    acc = JaxAccelerator(mixed_precision="no", gradient_accumulation_steps=accum)
    state = acc.create_train_state(params, jax_make_optimizer(recipe), apply_fn=model.apply)
    step = acc.prepare_train_step(jl.make_llama_loss_fn(model, fused_vocab_chunks=chunks),
                                  max_grad_norm=clip)
    out = []
    for ids in batches:
        state, m = step(state, {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids)})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return host, np.asarray(out)


def _port_model(host, attn="flash"):
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32, attn_implementation=attn),
                                device="cpu")
    model.load_state_dict(torch_state_from_flax(host))
    return model


def _port_trajectory(model, recipe, accum, clip, chunks, batches, **acc_kw):
    acc = Accelerator(mixed_precision="no", gradient_accumulation_steps=accum, cpu=True, **acc_kw)
    state = acc.create_train_state(model, recipe)
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=chunks),
                                  max_grad_norm=clip)
    out = []
    for ids in batches:
        ids = torch.from_numpy(ids).long()
        state, m = step(state, {"input_ids": ids, "labels": ids})
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return state, np.asarray(out)


@pytest.mark.parametrize("recipe, accum, clip", [("adamw", 2, 1.0), ("lion-sr", 1, None)])
def test_train_step_trajectory_matches_jax(recipe, accum, clip):
    """Ten steps of the tiny f32 model through ``prepare_train_step``: the
    port's flash path (plain on the CPU) and fused CE over 4 vocab chunks
    against the JAX step on its 8 CPU devices (batch 16 divides them)."""
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 256, (16, 32)).astype(np.int32) for _ in range(3)] * 4
    batches = batches[:10]
    host, want = _jax_trajectory(recipe, accum, clip, 4, batches)
    _, got = _port_trajectory(_port_model(host), recipe, accum, clip, 4, batches)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3)
    assert got[-1, 0] < got[0, 0]


def test_in_step_accumulation_equals_one_large_batch():
    """Two microbatches of equal token counts, summed in f32 and halved,
    give the gradient of the whole batch: the params after one adamw step
    agree."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 256, (4, 16))).long()
    _, _, host = _tiny_params()
    finals = []
    for accum in (1, 2):
        model = _port_model(host, attn="native")
        acc = Accelerator(cpu=True, gradient_accumulation_steps=accum)
        state = acc.create_train_state(model, "adamw")
        state, _ = acc.prepare_train_step(make_llama_loss_fn(model))(
            state, {"input_ids": ids, "labels": ids})
        assert state.step == 1
        finals.append([p.clone() for p in state.params.values()])
    for a, b in zip(*finals):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        acc.prepare_train_step(make_llama_loss_fn(model))(
            state, {"input_ids": ids[:3], "labels": ids[:3]})


def test_bf16_grads_and_clip_keep_their_width():
    """``GradSyncKwargs(grad_dtype="bf16")`` differentiates the bf16 copy;
    ``clip_grad_norm_`` matches JAX's global-norm clip."""
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu", seed=1)
    acc = Accelerator(mixed_precision="bf16", cpu=True,
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    state = acc.create_train_state({n: p.detach().bfloat16() for n, p in model.named_parameters()},
                                   "lion-sr")
    seen = []
    loss_fn = make_llama_loss_fn(model, fused_vocab_chunks=2)

    def spy(params, batch):
        seen.extend(p.dtype for p in params.values())
        return loss_fn(params, batch)

    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(0))
    before = [p.clone() for p in state.params.values()]
    state, metrics = acc.prepare_train_step(spy, max_grad_norm=0.5)(
        state, {"input_ids": ids, "labels": ids})
    assert set(seen) == {torch.bfloat16}
    assert all(p.dtype == torch.bfloat16 for p in state.params.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, state.params.values()))
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    grads = [np.random.default_rng(i).normal(size=(3, 4)).astype(np.float32) for i in range(3)]
    clipped, norm = acc.clip_grad_norm_([torch.from_numpy(g) for g in grads], 1.0)
    np.testing.assert_allclose(norm.item(), float(jax_global_norm([jnp.asarray(g) for g in grads])),
                               **TOL)
    np.testing.assert_allclose(clipped[0].numpy(), grads[0] * min(1.0, 1.0 / (norm.item() + 1e-6)),
                               **TOL)


def test_counts_and_plugins_match_jax():
    cfg = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
               num_hidden_layers=16, num_attention_heads=16, num_key_value_heads=8)
    assert tl.flops_per_token(tl.LlamaConfig(**cfg), 2048) == jl.flops_per_token(
        jl.LlamaConfig(**cfg), 2048)
    model, params, host = _tiny_params()
    assert tl.count_params(_port_model(host)) == jl.count_params(params)
    import dataclasses

    for port, ref in ((GradSyncKwargs(), jdc.GradSyncKwargs()),
                      (GradientAccumulationPlugin(), jdc.GradientAccumulationPlugin())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_off_path_options_raise():
    # the memory and precision recipes (A12) build; the multi-GPU ones raise
    assert type(make_optimizer("lion-sr8").init([torch.zeros(4)])).__name__ == "LionSR8State"
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")
    with pytest.raises(TypeError):
        AcceleratedOptimizer(object())
    with pytest.raises(RuntimeError, match="train step"):
        AcceleratedOptimizer(make_optimizer("adamw")).step()
    with pytest.raises(TypeError, match="ParallelismConfig"):
        Accelerator(cpu=True, parallelism_config=object())
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    from accelerate_tpu_torch.ops.collective_matmul import collective_matmul_mode

    # the collective matmul is ported: the plugin installs its mode, a
    # plugin-less Accelerator clears it
    Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(collective_matmul="on"))
    assert collective_matmul_mode() == "ring"
    Accelerator(cpu=True)
    assert collective_matmul_mode() == "off"
    # data, context, tensor, sequence, pipeline and expert parallelism are
    # ported (a pp axis of 2 needs a world of 2); pp composed with tp is not
    with pytest.raises(ValueError, match="available devices"):
        Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=2))
    with pytest.raises(NotImplementedError, match="A13h"):
        Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=2, tp_size=2))
    assert FullyShardedDataParallelPlugin(
        sharding_strategy="SHARD_GRAD_OP").sharding_strategy == "SHARD_GRAD_OP"
    fp16 = Accelerator(cpu=True, mixed_precision="fp16")
    assert fp16.policy.needs_loss_scaling
    assert fp16.create_train_state({"w": torch.zeros(3)}, "adamw").loss_scale is not None
    # accumulation across calls (A7) is ported: the carried accumulator
    carried = Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
        num_steps=2, mode="across_steps"))
    assert carried.gradient_state.plugin.mode == "across_steps"
    # the peer snapshots are ported (A13f): armed by the first update
    assert Accelerator(cpu=True, resilience_plugin=ResiliencePlugin(
        peer_snapshot_every=1)).peer_snapshotter is None
    # each accelerator keeps its own settings: a later construction
    # neither takes an earlier one's nor changes it
    first = Accelerator(cpu=True, mixed_precision="bf16", gradient_accumulation_steps=2)
    second = Accelerator(cpu=True)
    assert (first.mixed_precision, first.gradient_accumulation_steps) == ("bf16", 2)
    assert (second.mixed_precision, second.gradient_accumulation_steps) == ("no", 1)
    assert isinstance(second.state, tstate.AcceleratorState) and second.device.type == "cpu"
    with pytest.raises(ValueError, match="block_size"):
        make_optimizer("lion-sr", block_size=256)
    # PowerSGD is ported (A13e): in a world of one the codec owns the step
    acc = Accelerator(cpu=True, kwargs_handlers=[GradSyncKwargs(compression="powersgd")])
    acc.prepare_train_step(lambda p, b: None)
    assert acc.dcn_sync == {"enabled": False, "dcn_size": 1, "ici_size": 1,
                            "compression": None, "why_not": None}
    with pytest.raises(RuntimeError, match="prepared train step"):
        acc.backward()
    assert tl.LlamaConfig.tiny(remat=True, remat_policy="dots", scan_layers=True).remat
    # the ring (parallel/context_parallel.py) and Ulysses
    # (parallel/sequence_parallel.py) are ported
    from accelerate_tpu_torch.parallel.context_parallel import ring_attention
    from accelerate_tpu_torch.parallel.sequence_parallel import ulysses_attention

    assert tl.get_attention_impl("ring") is ring_attention
    assert tl.get_attention_impl("ulysses") is ulysses_attention
