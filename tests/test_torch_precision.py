"""The port's precision recipes held against the JAX package's: fp16 loss
scaling (``DynamicLossScale`` and the train step's skip), the fp8 matmuls
(current and delayed scaling, the HYBRID e5m2 backward, the metas that ride
the train state) and the stochastic round to bf16.

Tolerances: the loss-scale sequence (scale, counter, finite flags) is
exact against JAX over the same finite / non-finite pattern and over the
same regression run; the saturating fp8 casts, the metas and their scales
are bitwise; an fp8 product and its gradients agree with JAX's to 1e-5
relative of the output's largest value (the same e4m3 / e5m2 codes, f32
sums in another order).  ``stochastic_round_to_bf16`` draws torch noise
where JAX draws ``jax.random`` bits, so it is held by its statistics.  Every
JAX test of ``tests/test_fp8.py`` runs here in torch form but the GL110
jaxpr audit (JAX-only), and the fp16 cases of ``tests/test_accelerator.py``.
"""

import logging
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import fp8 as jfp8
from accelerate_tpu.ops import precision as jprec
from accelerate_tpu.test_utils.training import make_regression_loader
from accelerate_tpu_torch import Accelerator, GradSyncKwargs
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.layers import QuantizableDense
from accelerate_tpu_torch.ops import fp8 as tfp8
from accelerate_tpu_torch.ops import precision as tprec
from accelerate_tpu_torch.ops import stochastic_rounding as tsr
from accelerate_tpu_torch.ops.stochastic_rounding import GradientTransformation
from accelerate_tpu_torch.utils.dataclasses import FP8RecipeKwargs


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


class _SgdState(NamedTuple):
    count: int


def _sgd(lr):
    """Plain SGD as a GradientTransformation (optax.sgd's math)."""
    def update(grads, state, params):
        return ([(p + -lr * g).to(p.dtype) for g, p in zip(grads, params)],
                _SgdState(state.count + 1))

    return GradientTransformation(lambda params: _SgdState(0), update)


# -- fp16 loss scaling ------------------------------------------------------------


def test_loss_scale_sequence_equals_jax():
    pattern = [True] * 5 + [False] + [True] * 7 + [False, False] + [True] * 4
    j = jprec.DynamicLossScale(growth_interval=3)
    t = tprec.DynamicLossScale(growth_interval=3)
    for finite in pattern:
        j = j.update(jnp.bool_(finite))
        t = t.update(torch.tensor(finite))
        assert float(t.scale) == float(j.scale) and int(t.counter) == int(j.counter)
        assert t.scale.dtype == torch.float32 and t.counter.dtype == torch.int32
    grads = [np.random.default_rng(0).normal(size=(5,)).astype(np.float16) * 1000,
             np.random.default_rng(1).normal(size=(3,)).astype(np.float32)]
    ju = j.unscale([jnp.asarray(g) for g in grads])
    tu = t.unscale([torch.from_numpy(g) for g in grads])
    for a, b in zip(ju, tu):
        assert b.dtype == getattr(torch, str(a.dtype))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _regression_batches(epochs=3):
    return [b for _ in range(epochs) for b in make_regression_loader(batch_size=16)]


def _fp16_regression_run(jax_side: bool):
    batches = _regression_batches()
    out = []
    if jax_side:
        import optax

        from accelerate_tpu import Accelerator as JaxAccelerator
        from accelerate_tpu.state import AcceleratorState, GradientState
        from accelerate_tpu.test_utils.training import regression_loss_fn

        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        acc = JaxAccelerator(mixed_precision="fp16")
        state = acc.create_train_state({"a": jnp.zeros(()), "b": jnp.zeros(())}, optax.sgd(0.01))
        step = acc.prepare_train_step(regression_loss_fn)
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            out.append((bool(m["grads_finite"]), float(m["loss_scale"]), float(m["loss"]),
                        float(state.params["a"])))
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        return out
    acc = Accelerator(cpu=True, mixed_precision="fp16")
    state = acc.create_train_state({"a": torch.zeros(()), "b": torch.zeros(())}, _sgd(0.01))
    assert state.loss_scale is not None

    def loss_fn(p, batch):
        return ((p["a"] * batch["x"] + p["b"] - batch["y"]) ** 2).mean()

    step = acc.prepare_train_step(loss_fn)
    for b in batches:
        prev = state.params["a"].clone()
        state, m = step(state, b)
        if not bool(m["grads_finite"]):
            assert torch.equal(state.params["a"], prev)     # the skipped step
        out.append((bool(m["grads_finite"]), float(m["loss_scale"]), float(m["loss"]),
                    float(state.params["a"])))
    return out


def test_fp16_loss_scaling_step_matches_jax():
    """torch-GradScaler semantics as JAX's test: the 2^16 scale overflows
    the f16 gradients at first, backs off, overflowed steps skip; the
    finite flags and the scale sequence are JAX's exactly, the losses and
    the trained weight to 1e-5."""
    got, want = _fp16_regression_run(False), _fp16_regression_run(True)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2:] for g in got], [w[2:] for w in want], rtol=1e-5,
                               atol=1e-6)
    assert any(not g[0] for g in got) and any(g[0] for g in got)
    assert got[-1][1] < 2.0 ** 16 and got[-1][3] != 0.0


def test_grad_dtype_rejects_fp16_scaling():
    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    with pytest.raises(ValueError, match="grad_dtype"):
        acc.prepare_train_step(lambda p, b: p["w"].sum())


def test_fp16_overflow_skips_with_state_bitwise_unchanged():
    """An injected non-finite gradient: params and the optimizer state
    (lion-sr8 codes and scales, its count) bitwise as before, the scale
    halved, the counter reset; with the NaN guard on as well, one skip
    counted."""
    from accelerate_tpu_torch import ResiliencePlugin

    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      resilience_plugin=ResiliencePlugin(nan_guard=True))
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(16, 8, generator=gen).bfloat16()}
    state = acc.create_train_state(params, "lion-sr8")
    step = acc.prepare_train_step(lambda p, b: (b["x"] @ p["w"].float().t()).square().mean()
                                  * b["k"])
    batch = {"x": torch.randn(4, 8, generator=gen), "k": torch.tensor(1.0)}
    state, m = step(state, batch)
    assert bool(m["grads_finite"]) and float(m["loss_scale"]) == 2.0 ** 16
    before = (state.params["w"].clone(), [t.clone() for t in state.opt_state.mu],
              [t.clone() for t in state.opt_state.mu_scale], state.opt_state.count)
    state, m = step(state, {**batch, "k": torch.tensor(float("inf"))})
    assert not bool(m["grads_finite"]) and float(m["loss_scale"]) == 2.0 ** 15
    assert int(state.loss_scale.counter) == 0 and int(m["nan_skips"]) == 1
    assert torch.equal(state.params["w"], before[0]) and state.opt_state.count == before[3]
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu, before[1]))
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu_scale, before[2]))
    state, m = step(state, batch)
    assert bool(m["grads_finite"]) and state.opt_state.count == before[3] + 1


def test_fp16_loss_scale_rides_the_checkpoint(tmp_path):
    acc = Accelerator(cpu=True, mixed_precision="fp16", project_dir=str(tmp_path))
    state = acc.create_train_state({"a": torch.zeros(()), "b": torch.zeros(())}, _sgd(0.01))
    step = acc.prepare_train_step(
        lambda p, b: ((p["a"] * b["x"] + p["b"] - b["y"]) ** 2).mean())
    for b in _regression_batches(1):
        state, _ = step(state, b)
    path = acc.save_state(train_state=state)
    template = acc.create_train_state({"a": torch.zeros(()), "b": torch.zeros(())}, _sgd(0.01))
    restored = acc.load_state(path, train_state=template)
    assert torch.equal(restored.loss_scale.scale, state.loss_scale.scale)
    assert torch.equal(restored.loss_scale.counter, state.loss_scale.counter)


# -- fp8 ------------------------------------------------------------------------


def test_fp8_autocast_flag_nesting():
    assert not tprec.fp8_enabled()
    with tprec.fp8_autocast():
        assert tprec.fp8_enabled()
        with tprec.fp8_autocast(enabled=False):
            assert not tprec.fp8_enabled()
        assert tprec.fp8_enabled()
    assert not tprec.fp8_enabled()


def test_fp8_casts_and_metas_match_jax_bitwise():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 48)) * 3).astype(np.float32)
    for fmax, jdt, tdt in ((jprec.E4M3_MAX, jnp.float8_e4m3fn, torch.float8_e4m3fn),
                           (jprec.E5M2_MAX, jnp.float8_e5m2, torch.float8_e5m2)):
        scale = np.float32(fmax / np.abs(x).max())
        j = jfp8._saturate_cast(jnp.asarray(x), jnp.float32(scale), fmax, jdt)
        t = tprec.saturate_cast(_t(x), torch.tensor(scale), fmax, tdt)
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    jm, tm = jprec.Fp8Meta.init(4), tprec.Fp8Meta.init(4)
    for amax, margin in ((2.0, 0), (0.5, 1), (7.0, 0), (0.0, 2), (3.0, 0)):
        jm = jm.updated(jnp.float32(amax), jprec.E4M3_MAX, margin)
        tm = tm.updated(torch.tensor(amax), tprec.E4M3_MAX, margin)
        np.testing.assert_array_equal(tm.amax_history.numpy(), np.asarray(jm.amax_history))
        assert float(tm.scale) == float(jm.scale)
    jq, jmeta = jprec.quantize_fp8(jnp.asarray(x), jprec.Fp8Meta.init())
    tq, tmeta = tprec.quantize_fp8(_t(x), tprec.Fp8Meta.init())
    np.testing.assert_array_equal(tq.float().numpy(), np.asarray(jq, np.float32))
    assert float(tmeta.scale) == float(jmeta.scale)


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("kind", ["current", "delayed"])
def test_fp8_products_and_grads_match_jax(kind):
    """``fp8_current_scaled_dot`` (bf16 straight-through backward) and
    ``fp8_delayed_dot`` (HYBRID e5m2 backward) on the same f32 operands:
    output, dx and dw against JAX's.  The port's ``w`` is JAX's ``[K, N]``
    kernel given as a weight ``[N, K]``'s ``.t()``, as the layers pass it."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 32)) * 0.2).astype(np.float32)
    g = rng.normal(size=(2, 8, 32)).astype(np.float32)
    jmeta = jprec.Fp8Meta.init(4).updated(jnp.float32(np.abs(w).max()), jprec.E4M3_MAX, 0)
    tmeta = tprec.Fp8Meta.init(4).updated(torch.tensor(np.abs(w).max()), tprec.E4M3_MAX, 0)

    def jf(a, b):
        if kind == "current":
            return jprec.fp8_current_scaled_dot(a, b, preferred_element_type=jnp.float32)
        return jfp8.fp8_delayed_dot(a, b, jmeta, preferred_element_type=jnp.float32)

    jout, jvjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = jvjp(jnp.asarray(g))
    tx = _t(x).requires_grad_()
    weight = _t(w.T).contiguous().requires_grad_()
    if kind == "current":
        tout = tprec.fp8_current_scaled_dot(tx, weight.t(), preferred_element_type=torch.float32)
    else:
        tout = tfp8.fp8_delayed_dot(tx, weight.t(), tmeta, preferred_element_type=torch.float32)
    tout.backward(_t(g))
    _close(tout.detach().numpy(), jout)
    _close(tx.grad.numpy(), jdx)
    _close(weight.grad.t().numpy(), jdw)


def test_fp8_current_scaled_dot_accuracy_and_grads():
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(8, 64))).bfloat16().requires_grad_()
    w = _t(rng.normal(size=(32, 64))).bfloat16().requires_grad_()

    def grads(fn):
        x.grad = w.grad = None
        loss = fn().float().square().mean()
        loss.backward()
        return loss.item(), x.grad.float(), w.grad.float()

    l8, gx8, gw8 = grads(lambda: tprec.fp8_current_scaled_dot(x, w.t()))
    l16, gx16, gw16 = grads(lambda: x @ w.t())
    assert abs(l8 - l16) < 0.1 * l16
    for a, b in ((gx8, gx16), (gw8, gw16)):
        assert (a - b).abs().max() / (b.abs().max() + 1e-6) < 0.15


def test_fp8_dot_delayed_scaling_meta_updates():
    x = torch.ones(4, 16, dtype=torch.bfloat16) * 3.0
    w = torch.ones(16, 8, dtype=torch.bfloat16) * 0.5
    out, (xm, wm) = tprec.fp8_dot(x, w, tprec.Fp8Meta.init(), tprec.Fp8Meta.init())
    assert out.shape == (4, 8)
    assert float(xm.amax_history[0]) == pytest.approx(3.0)
    assert float(wm.amax_history[0]) == pytest.approx(0.5)
    assert float(xm.scale) > 1.0
    torch.testing.assert_close(out.float(), torch.full((4, 8), 24.0))


def test_quantizable_dense_routes_fp8():
    layer = QuantizableDense(64, 32, torch.bfloat16)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(32, 64, generator=torch.Generator().manual_seed(0)) / 8)
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1)).bfloat16()
    ref = layer(x)
    with tprec.fp8_autocast():
        out = layer(x)
        layer.lora_key = "dense"
        with tfp8.merge_fp8_collection(tfp8.init_fp8_state({"dense.weight": layer.weight})):
            delayed = layer(x)
    diff = (out.float() - ref.float()).abs().max().item()
    assert 0 < diff < 0.1 * (ref.float().abs().max().item() + 1e-6)
    # seeded with the weight's current amax, the delayed scale is the
    # current one: the same product
    assert torch.equal(delayed, out)


def test_fp8_hardware_gate_warns_and_falls_back(monkeypatch, caplog):
    assert not tprec.fp8_hardware_supported() or torch.cuda.is_available()
    with caplog.at_level(logging.WARNING, logger="accelerate_tpu_torch.state"):
        acc = Accelerator(cpu=True, mixed_precision="fp8")
    assert acc.mixed_precision == "fp8"
    assert any("no fp8 matmul units" in r.message for r in caplog.records)
    monkeypatch.setenv("ACCELERATE_FP8_FALLBACK_BF16", "true")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="accelerate_tpu_torch.state"):
        acc = Accelerator(cpu=True, mixed_precision="fp8")
    assert acc.mixed_precision == "bf16"
    assert any("falling back to bf16" in r.message for r in caplog.records)


def test_fp8_hardware_probe_capabilities():
    for cap, want in (((8, 0), False), ((8, 6), False), ((8, 9), True), ((9, 0), True),
                      ((10, 0), True)):
        assert tprec._capability_has_fp8(cap) is want, cap


def test_fp8_recipe_kwargs_env_and_validation(monkeypatch):
    from accelerate_tpu import FP8RecipeKwargs as JaxRecipe

    monkeypatch.delenv("ACCELERATE_FP8_AMAX_HISTORY_LEN", raising=False)
    monkeypatch.delenv("ACCELERATE_FP8_MARGIN", raising=False)
    assert FP8RecipeKwargs().amax_history_len == 16 == JaxRecipe().amax_history_len
    monkeypatch.setenv("ACCELERATE_FP8_AMAX_HISTORY_LEN", "32")
    monkeypatch.setenv("ACCELERATE_FP8_MARGIN", "2")
    r = FP8RecipeKwargs()
    assert (r.amax_history_len, r.margin) == (32, 2)
    assert FP8RecipeKwargs(amax_history_len=8).amax_history_len == 8
    # the operands are always the hybrid pairing: no format option to ignore
    with pytest.raises(TypeError):
        FP8RecipeKwargs(fp8_format="E4M3")
    with pytest.raises(ValueError, match="amax_history_len"):
        FP8RecipeKwargs(amax_history_len=0)
    with pytest.raises(ValueError, match="margin"):
        FP8RecipeKwargs(margin=-1)
    with pytest.raises(ValueError, match="amax_compute_algo"):
        FP8RecipeKwargs(amax_compute_algo="mean")


def _tiny_fp8_pair():
    from accelerate_tpu.models import llama as jl
    from accelerate_tpu_torch.models.convert import torch_state_from_flax

    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny())
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return params, model


def test_init_fp8_state_keys_and_amaxes_equal_jax():
    from accelerate_tpu_torch.models.convert import flax_module_to_port_name

    params, model = _tiny_fp8_pair()
    jstate = jfp8.init_fp8_state(params, history_len=4)
    flat = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if k == "w_meta":
                flat["/".join(path)] = v
            else:
                walk(v, path + (k,))

    walk(jstate)
    f32 = {n: p.detach().float() for n, p in model.named_parameters()}
    tstate = tfp8.init_fp8_state(f32, history_len=4)
    assert sorted(tstate) == sorted(flax_module_to_port_name(p) for p in flat)
    for path, meta in flat.items():
        t = tstate[flax_module_to_port_name(path)]
        np.testing.assert_array_equal(t.amax_history.numpy(), np.asarray(meta.amax_history))
        assert float(t.scale) == float(meta.scale)


def test_fp8_state_rides_train_state_and_checkpoints(tmp_path):
    from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration

    acc = Accelerator(cpu=True, mixed_precision="fp8",
                      project_config=ProjectConfiguration(project_dir=str(tmp_path),
                                                          automatic_checkpoint_naming=True),
                      kwargs_handlers=[FP8RecipeKwargs(amax_history_len=4, margin=1)])
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    state = acc.create_train_state(model, "adamw")
    assert state.fp8_state is not None
    hists = [m.amax_history.clone() for m in state.fp8_state.values()]
    assert hists and all(h.shape == (4,) for h in hists)
    assert all(float(h[0]) > 0 for h in hists)
    assert "model.layers.0.self_attn.q_proj" in state.fp8_state and "lm_head" in state.fp8_state
    step = acc.prepare_train_step(tl.make_llama_loss_fn(model), max_grad_norm=1.0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 16)))
    state2, _ = step(state, {"input_ids": ids, "labels": ids})
    for old, new in zip(hists, (m.amax_history for m in state2.fp8_state.values())):
        assert float(new[1]) == float(old[0]) and float(new[0]) > 0
    ckpt = acc.save_state(train_state=state2)
    template = acc.create_train_state(
        tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu", seed=1),
        "adamw")
    restored = acc.load_state(ckpt, train_state=template)
    for name, meta in state2.fp8_state.items():
        assert torch.equal(restored.fp8_state[name].amax_history, meta.amax_history)
        assert torch.equal(restored.fp8_state[name].scale, meta.scale)


def _train_llama(mixed_precision, n_steps=8):
    acc = Accelerator(cpu=True, mixed_precision=mixed_precision)
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu", seed=0)
    state = acc.create_train_state(model, "adamw")
    step = acc.prepare_train_step(tl.make_llama_loss_fn(model), max_grad_norm=1.0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 32)))
    losses = []
    for _ in range(n_steps):
        state, m = step(state, {"input_ids": toks, "labels": toks})
        losses.append(m["loss"].item())
    return losses


def test_fp8_training_tracks_bf16():
    """JAX's terms (``tests/test_fp8.py:261``): each fp8 loss within 5 %
    (+0.05) of the bf16 run's over the same batches, and it learns."""
    bf16, fp8 = _train_llama("bf16"), _train_llama("fp8")
    assert all(np.isfinite(fp8))
    for a, b in zip(fp8, bf16):
        assert abs(a - b) < 0.05 * abs(b) + 0.05, (fp8, bf16)
    assert fp8[-1] < fp8[0]


def test_fp8_fake_quantize_rounds_through_e4m3_with_identity_grad():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    j = jfp8.fp8_fake_quantize(jnp.asarray(x))
    t = _t(x).requires_grad_()
    out = tfp8.fp8_fake_quantize(t)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j))
    out.sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))


def test_stochastic_round_to_bf16_is_unbiased_to_its_two_neighbours():
    """Held by its statistics (JAX draws jax.random bits, the port a
    torch.Generator): each result is one of the two bf16 neighbours, up
    with the probability of the input's position between them."""
    x = torch.full((1 << 16,), 1.0 + 3 * 2 ** -10)    # 3/8 of the way up one bf16 step
    r = tsr.stochastic_round_to_bf16(x, torch.Generator().manual_seed(0)).float()
    hi = 1.0 + 2 ** -7
    assert set(r.unique().tolist()) <= {1.0, hi}
    assert abs((r == hi).float().mean().item() - 0.375) < 0.01
    assert abs(r.mean().item() - x[0].item()) < 1e-4
    again = tsr.stochastic_round_to_bf16(x, torch.Generator().manual_seed(0)).float()
    assert torch.equal(r, again)
    exact = torch.tensor([1.0, -2.5, 0.0])
    assert torch.equal(tsr.stochastic_round_to_bf16(exact).float(), exact)
    # JAX's version lands on the same two neighbours with the same odds
    jr = np.asarray(jprec_sr(x.numpy()), np.float32)
    assert set(np.unique(jr).tolist()) <= {1.0, hi}
    assert abs((jr == hi).mean() - (r == hi).float().mean().item()) < 0.02


def jprec_sr(x):
    from accelerate_tpu.ops.stochastic_rounding import stochastic_round_to_bf16

    return stochastic_round_to_bf16(jnp.asarray(x), jax.random.PRNGKey(0))
