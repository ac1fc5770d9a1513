"""The port's int8 optimizer state (``ops/int8_state.py``) and the -sr8
recipes held against the JAX package's on the same seeded numpy inputs.

Bitwise: the linear int8 map's codes, scales and dequantized values, the
lion-sr8 update (bf16 params, int8 momentum codes, f32 scales) over three
steps, and a save / load round trip.  The log uint8 map goes through
``log`` and ``exp``, whose f32 results on XLA's CPU backend and torch's
sit up to one ulp apart at some inputs: its scales are bitwise, its codes
equal but for the rare element whose code sits within an ulp of a rounding
edge (at most one code, under 1 % of elements), its dequantized values
within 2 ulp.  adamw-sr8 therefore holds its params, codes and scales to
the terms the -sr recipe settled for XLA's bias correction: equal on all
but a few elements, which move by one bf16 step or one code.  Every JAX
test of ``tests/test_int8_state.py`` runs here in torch form but the slow
4000-step freeze test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu.ops import int8_state as jis
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu_torch import Accelerator, make_optimizer
from accelerate_tpu_torch.ops import int8_state as tis
from accelerate_tpu_torch.ops import stochastic_rounding as tsr
from accelerate_tpu_torch.optimizer import OPTIMIZER_RECIPES, reference_recipe
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

SHAPES = [(512,), (8, 64), (100,), (1,), (3, 5), (130,)]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# -- the quantizers against JAX ------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("salt", [None, 0x9E3779B1])
@pytest.mark.parametrize("signed", [True, False])
def test_linear_map_matches_jax_bitwise(shape, salt, signed):
    rng = np.random.default_rng(len(shape) * 1000 + shape[0])
    x = rng.normal(size=shape).astype(np.float32)
    x = x if signed else np.abs(x)
    ent = rng.normal(size=shape).astype(np.float32)
    jc, js = jis.quantize_int8_blockwise(
        jnp.asarray(x), 128, signed=signed, salt=None if salt is None else jnp.uint32(salt),
        entropy=jnp.asarray(ent))
    tc, ts = tis.quantize_int8_blockwise(_t(x), 128, signed=signed, salt=salt, entropy=_t(ent))
    assert tc.dtype == (torch.int8 if signed else torch.uint8) and tc.shape == shape
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tuple(ts.shape) == tis.int8_scale_shape(shape, 128) == jis.int8_scale_shape(shape, 128)
    np.testing.assert_array_equal(tis.dequantize_int8_blockwise(tc, ts, 128).numpy(),
                                  np.asarray(jis.dequantize_int8_blockwise(jc, js, 128)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("salt", [None, 0x85EBCA77])
def test_log_map_matches_jax(shape, salt):
    rng = np.random.default_rng(7 + shape[0])
    x = (np.abs(rng.normal(size=shape)) ** 3).astype(np.float32)
    ent = rng.normal(size=shape).astype(np.float32)
    jc, js = jis.quantize_u8_log_blockwise(
        jnp.asarray(x), 128, salt=None if salt is None else jnp.uint32(salt),
        entropy=jnp.asarray(ent))
    tc, ts = tis.quantize_u8_log_blockwise(_t(x), 128, salt=salt, entropy=_t(ent))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    d = tc.numpy().astype(np.int32) - np.asarray(jc).astype(np.int32)
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 0.01
    # the same codes decode within 2 ulp (exp one ulp apart)
    jd = np.asarray(jis.dequantize_u8_log_blockwise(jc, js, 128))
    td = tis.dequantize_u8_log_blockwise(_t(np.asarray(jc)), ts, 128).numpy()
    np.testing.assert_allclose(td, jd, rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_linear_roundtrip_error_bound(shape):
    """Nearest round trip within half a code step per element."""
    x = _t(np.random.default_rng(0).normal(size=shape).astype(np.float32))
    codes, scales = tis.quantize_int8_blockwise(x, 128)
    assert codes.shape == x.shape and codes.dtype == torch.int8
    assert tuple(scales.shape) == tis.int8_scale_shape(shape, 128)
    err = (tis.dequantize_int8_blockwise(codes, scales, 128) - x).abs().max().item()
    assert err <= 0.5 * scales.max().item() + 1e-7


def test_u8_log_roundtrip_relative_error():
    v = _t((10.0 ** np.random.default_rng(1).uniform(-6, 0, (1024,))).astype(np.float32))
    codes, scales = tis.quantize_u8_log_blockwise(v, 128)
    assert codes.dtype == torch.uint8
    back = tis.dequantize_u8_log_blockwise(codes, scales, 128)
    factor = 2.0 ** (tis.LOG_RANGE_BITS / 255.0 / 2.0) * 1.001
    ratio = (back / v).numpy()
    assert ratio.max() <= factor and ratio.min() >= 1.0 / factor
    assert (back > 0).all()
    z = torch.cat([torch.zeros(64), torch.ones(64)])
    zc, zs = tis.quantize_u8_log_blockwise(z, 128)
    assert tis.dequantize_u8_log_blockwise(zc, zs, 128)[:64].max() <= 2.0 ** -24 * 1.001


def test_int8_sr_requant_is_unbiased():
    x = torch.full((2048,), 0.31337)
    ent = _t(np.random.default_rng(2).normal(size=(2048,)).astype(np.float32))
    acc = 0.0
    for s in range(200):
        c, sc = tis.quantize_int8_blockwise(x, 128, salt=(s * 2654435761) & 0xFFFFFFFF,
                                            entropy=ent)
        acc += tis.dequantize_int8_blockwise(c, sc, 128).mean().item()
    assert abs(acc / 200 - 0.31337) < 3e-4


def test_u8_log_sr_requant_is_unbiased_in_log_space():
    x = torch.full((2048,), 0.0123)
    x[::128] = 1.0
    ent = _t(np.random.default_rng(3).normal(size=(2048,)).astype(np.float32))
    mask = np.ones(2048, bool)
    mask[::128] = False
    acc = 0.0
    for s in range(200):
        c, sc = tis.quantize_u8_log_blockwise(x, 128, salt=(s * 40503) & 0xFFFFFFFF, entropy=ent)
        acc += np.log2(tis.dequantize_u8_log_blockwise(c, sc, 128).numpy()[mask]).mean()
    assert abs(acc / 200 - np.log2(0.0123)) < 0.02


def test_sr8_codes_bounded_and_absmax_stable():
    x = _t(np.random.default_rng(4).normal(size=(512,)).astype(np.float32))
    peak = int(x.abs().argmax())
    for s in range(16):
        c, _ = tis.quantize_int8_blockwise(x, 512, salt=s + 1, entropy=x)
        c = c.int()
        assert c.max() <= 127 and c.min() >= -127 and abs(int(c[peak])) == 127


# -- the -sr8 optimizers --------------------------------------------------------


def _regression(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(256, 16)).astype(np.float32)
    return _t(x), _t(x @ rng.normal(size=(16,)).astype(np.float32))


def _train(tx, w0, x, y, steps=400):
    params = [w0.clone()]
    state = tx.init(params)
    for _ in range(steps):
        w = params[0].float().requires_grad_()
        loss = ((x @ w - y) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [w])
        params, state = tx.update([g], state, params)
    return ((x @ params[0].float() - y) ** 2).mean().item()


def test_lion_sr8_tracks_fp32_lion():
    x, y = _regression(0)
    base = _train(make_optimizer("lion", 3e-3), torch.zeros(16), x, y)
    sr8 = _train(tis.lion_int8_sr(3e-3, b1=0.9, b2=0.99), torch.zeros(16, dtype=torch.bfloat16),
                 x, y)
    assert sr8 < max(4 * base, 5e-3), (sr8, base)


def test_adamw_sr8_tracks_fp32_adamw():
    from accelerate_tpu_torch.optimizer import adamw

    x, y = _regression(1)
    base = _train(adamw(3e-2), torch.zeros(16), x, y)
    sr8 = _train(tis.adamw_int8_sr(3e-2), torch.zeros(16, dtype=torch.bfloat16), x, y)
    assert sr8 < max(4 * base, 5e-3), (sr8, base)


def _jax_tree(names, arrays):
    from accelerate_tpu_torch.models.hf_interop import hf_llama_key_map

    tree = {}
    for name in names:
        node = tree
        path = hf_llama_key_map(name).split(".")
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arrays[name]
    return tree


@pytest.mark.parametrize("kind", ["lion-sr8", "adamw-sr8"])
def test_sr8_optimizers_match_jax_over_three_steps(kind):
    """bf16 params of 11 layers' MLP weights, the embedding, head and norm
    (leaves smaller and larger than a block, one with a partial block);
    three updates at block 32 from the same grads."""
    rng = np.random.default_rng(3)
    names = ([f"model.layers.{i}.mlp.up_proj.weight" for i in range(11)]
             + ["model.embed_tokens.weight", "lm_head.weight", "model.norm.weight"])
    shapes = {n: (9, 7) for n in names}
    shapes["model.norm.weight"] = (7,)
    shapes["lm_head.weight"] = (20, 7)
    params = {n: rng.normal(size=shapes[n]).astype(np.float32) for n in names}
    order = tsr.flax_leaf_order(names)
    jtx = jax_make_optimizer(kind, 1e-3, weight_decay=0.1, block_size=32, seed=5)
    ttx = make_optimizer(kind, 1e-3, weight_decay=0.1, block_size=32, seed=5)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _jax_tree(names, params))
    jstate = jtx.init(jp)
    tp = [_t(params[n]).bfloat16() for n in order]
    tstate = ttx.init(tp)
    for step in range(3):
        grads = {n: rng.normal(size=shapes[n]).astype(np.float32) for n in names}
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, _jax_tree(names, grads)),
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp, tstate = ttx.update([_t(grads[n]) for n in order], tstate, tp)
        assert all(p.dtype == torch.bfloat16 for p in tp)
        got = np.concatenate([p.float().numpy().ravel() for p in tp])
        want = np.concatenate([np.asarray(x, np.float32).ravel()
                               for x in jax.tree_util.tree_leaves(jp)])
        fields = [("mu", jstate.mu, tstate.mu), ("mu_scale", jstate.mu_scale, tstate.mu_scale)]
        if kind == "adamw-sr8":
            fields += [("nu", jstate.nu, tstate.nu), ("nu_scale", jstate.nu_scale,
                                                      tstate.nu_scale)]
        for label, jm, tm in fields:
            a = np.concatenate([np.asarray(x).astype(np.float64).ravel()
                                for x in jax.tree_util.tree_leaves(jm)])
            b = np.concatenate([x.double().numpy().ravel() for x in tm])
            if kind == "lion-sr8":
                np.testing.assert_array_equal(b, a, err_msg=f"{label} step {step}")
            elif label.endswith("scale"):
                np.testing.assert_allclose(b, a, rtol=2 ** -6, err_msg=f"{label} step {step}")
            else:
                assert (a == b).mean() > 0.97 and np.abs(a - b).max() <= 1, (label, step)
        if kind == "lion-sr8":
            np.testing.assert_array_equal(got, want)
        else:
            assert (got == want).mean() > 0.97
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("make_tx", [tis.lion_int8_sr, tis.adamw_int8_sr])
def test_sr8_update_returns_bf16_params_and_int8_state(make_tx):
    """The new leaves are the stochastically rounded bf16 weights
    themselves (the port's update returns them where optax returns the f32
    delta; the delta contract is JAX's own), the state int8 / f32."""
    gen = torch.Generator().manual_seed(11)
    p = [torch.randn(512, generator=gen).bfloat16()]
    g = [torch.randn(512, generator=gen)]
    tx = make_tx(3e-3)
    state = tx.update(g, tx.init(p), p)[1]
    new, state = tx.update(g, state, p)
    assert new[0].dtype == torch.bfloat16 and state.count == 2
    assert state.mu[0].dtype == torch.int8 and state.mu_scale[0].dtype == torch.float32
    if hasattr(state, "nu"):
        assert state.nu[0].dtype == torch.uint8


@pytest.mark.parametrize("make_tx", [tis.lion_int8_sr, tis.adamw_int8_sr])
def test_sr8_update_requires_params(make_tx):
    tx = make_tx()
    state = tx.init([torch.zeros(4, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="params"):
        tx.update([torch.zeros(4)], state)


def test_sr8_update_is_deterministic():
    rng = np.random.default_rng(5)
    p = [_t(rng.normal(size=(256,)).astype(np.float32)).bfloat16()]
    g = [_t(rng.normal(size=(256,)).astype(np.float32))]
    tx = tis.adamw_int8_sr(1e-3)
    u1, s1 = tx.update(g, tx.init(p), p)
    u2, s2 = tx.update(g, tx.init(p), p)
    assert torch.equal(s1.mu[0], s2.mu[0]) and torch.equal(s1.nu[0], s2.nu[0])
    assert torch.equal(u1[0], u2[0])


# -- registry, plugin knob, checkpoint round trip --------------------------------


def test_make_optimizer_registry():
    assert reference_recipe("lion-sr8") == "lion" and reference_recipe("adamw-sr") == "adamw"
    p = [torch.zeros(300, dtype=torch.bfloat16)]
    for name in OPTIMIZER_RECIPES:
        make_optimizer(name).init(p)
    st = make_optimizer("lion-sr8", block_size=64).init(p)
    assert tuple(st.mu_scale[0].shape) == (5,)
    with pytest.raises(ValueError, match="block_size"):
        make_optimizer("lion", block_size=64)
    with pytest.raises(ValueError, match="block_size"):
        make_optimizer("lion-sr8", block_size=0)
    with pytest.raises(ValueError, match="unknown optimizer recipe"):
        make_optimizer("sgd-sr8")


def test_prepare_optimizer_by_name_reads_plugin_block_size():
    acc = Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(
        int8_state_block_size=32))
    st = acc.prepare_optimizer("adamw-sr8").init([torch.zeros(256, dtype=torch.bfloat16)])
    assert tuple(st.mu_scale[0].shape) == (8,)
    assert st.mu[0].dtype == torch.int8 and st.nu[0].dtype == torch.uint8


def test_int8_state_block_size_env_default(monkeypatch):
    from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JaxPlugin

    monkeypatch.delenv("ACCELERATE_INT8_STATE_BLOCK", raising=False)
    assert FullyShardedDataParallelPlugin().int8_state_block_size == 128
    monkeypatch.setenv("ACCELERATE_INT8_STATE_BLOCK", "256")
    assert FullyShardedDataParallelPlugin().int8_state_block_size == 256
    assert FullyShardedDataParallelPlugin(int8_state_block_size=64).int8_state_block_size == 64
    with pytest.raises(ValueError, match="int8_state_block_size"):
        FullyShardedDataParallelPlugin(int8_state_block_size=0)
    # the env contract is JAX's, field by field
    for field in ("cpu_offload", "offload_params", "host_update_pipeline",
                  "int8_state_block_size", "host_update_chunk_gib"):
        assert getattr(FullyShardedDataParallelPlugin(), field) == getattr(JaxPlugin(), field)


@pytest.mark.parametrize("recipe", ["lion-sr8", "adamw-sr8"])
def test_sr8_state_checkpoint_roundtrip_bit_exact(tmp_path, recipe):
    """save_state / load_state return the int8 / uint8 codes and f32
    scales bitwise, under cpu_offload, and the resumed step takes the same
    trajectory."""
    acc = Accelerator(cpu=True, project_dir=str(tmp_path), mixed_precision="bf16",
                      fsdp_plugin=FullyShardedDataParallelPlugin(cpu_offload=True))
    rng = np.random.default_rng(0)

    def leaf(*shape, scale=0.1):
        return (_t(rng.normal(size=shape).astype(np.float32)) * scale).bfloat16()

    params = {"dense.weight": leaf(64, 8), "dense.bias": torch.zeros(64, dtype=torch.bfloat16),
              "out.weight": leaf(1, 64), "out.bias": torch.zeros(1, dtype=torch.bfloat16)}
    state = acc.create_train_state(params, acc.prepare_optimizer(recipe))

    def loss(p, batch):
        h = torch.tanh(batch["x"] @ p["dense.weight"].float().t() + p["dense.bias"].float())
        pred = (h @ p["out.weight"].float().t() + p["out.bias"].float())[..., 0]
        return ((pred - batch["y"]) ** 2).mean()

    step = acc.prepare_train_step(loss)
    batch = {"x": _t(rng.normal(size=(16, 8)).astype(np.float32)),
             "y": _t(rng.normal(size=(16,)).astype(np.float32))}
    for _ in range(3):
        state, _ = step(state, batch)
    path = acc.save_state(train_state=state)
    snap_p = {k: v.clone() for k, v in state.params.items()}
    snap_o = [t.clone() for t in state.opt_state.mu + state.opt_state.mu_scale]
    template = acc.create_train_state({k: torch.zeros_like(v) for k, v in params.items()},
                                      acc.prepare_optimizer(recipe))
    restored = acc.load_state(path, train_state=template)
    for a, b in zip(restored.opt_state.mu + restored.opt_state.mu_scale, snap_o):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k, v in snap_p.items():
        assert torch.equal(restored.params[k], v)
    assert restored.opt_state.mu[0].dtype == torch.int8
    if recipe == "adamw-sr8":
        assert restored.opt_state.nu[0].dtype == torch.uint8
        for a, b in zip(restored.opt_state.nu, state.opt_state.nu):
            assert torch.equal(a, b)
    cont, _ = step(state, batch)
    res, _ = step(restored, batch)
    for k in cont.params:
        assert torch.equal(cont.params[k], res.params[k])
