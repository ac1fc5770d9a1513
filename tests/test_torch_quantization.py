"""The port's weight quantization (``accelerate_tpu_torch/utils/quantization.py``)
held against the JAX package's.

The same seeded f32 weights go to both: int8 codes and scales (``k2d`` and
``flat`` layouts, a padded odd-sized leaf) and nf4's packed codes and
absmaxes must be bitwise equal; ``quantize_params`` must quantize the same
leaves (the port's names are HF's, its weights ``[out, in]``);
``quantized_nbytes`` must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import (
    load_converted_state,
    torch_state_from_flax,
)
from accelerate_tpu_torch.ops import quantized_matmul as tqm
from accelerate_tpu_torch.utils import quantization as tq

INT8 = dict(load_in_8bit=True)
NF4 = dict(load_in_4bit=True)


def _both(cfg_kw, w):
    jqt = jq.quantize(w, jq.QuantizationConfig(**cfg_kw))
    tqt = tq.quantize(torch.from_numpy(w), tq.QuantizationConfig(**cfg_kw))
    return jqt, tqt


def _assert_same(jqt, tqt):
    assert tqt.shape == tuple(jqt.shape)
    assert (tqt.scheme, tqt.block_size, tqt.layout) == (jqt.scheme, jqt.block_size, jqt.layout)
    np.testing.assert_array_equal(tqt.data.numpy(), np.asarray(jqt.data))
    assert tqt.data.numpy().dtype == np.asarray(jqt.data).dtype
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
    assert tqt.scale.dtype == torch.float32


@pytest.mark.parametrize("cfg_kw, shape", [
    (INT8, (256, 1024)),                         # k2d
    (dict(INT8, block_size=256), (384, 512)),    # k2d, a wider block
    (INT8, (100, 300)),                          # flat: 300 % 128 != 0, padded tail
    (INT8, (7, 13, 5)),                          # flat, 3-D, odd-sized (padded)
    (NF4, (64, 256)),
    (dict(NF4, block_size=64), (33, 50)),        # nf4, padded odd-sized leaf
])
def test_codes_and_scales_equal_jax_bitwise(cfg_kw, shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.normal(size=shape) * rng.uniform(0.1, 3.0)).astype(np.float32)
    w.reshape(-1)[:7] = 0.0                       # an all-zero-ish block start
    _assert_same(*_both(cfg_kw, w))


def test_all_zero_block_and_round_half_even_equal_jax():
    """A block of zeros takes absmax 1; values at exact .5 code boundaries
    round half to even on both sides."""
    w = np.zeros((2, 256), np.float32)
    w[0, :128] = np.arange(128, dtype=np.float32) - 63.5   # amax 63.5 -> halves
    w[1, 128:] = 127.0 * (np.arange(128) % 5 - 2) / 2.0
    _assert_same(*_both(INT8, w))


@pytest.mark.parametrize("cfg_kw, shape", [
    (INT8, (256, 512)), (INT8, (100, 300)), (NF4, (64, 256)), (dict(NF4, block_size=64), (33, 50)),
])
def test_dequantize_equals_jax(cfg_kw, shape):
    rng = np.random.default_rng(1)
    w = rng.normal(size=shape).astype(np.float32)
    jqt, tqt = _both(cfg_kw, w)
    want = np.asarray(jq.dequantize(jqt, jnp.float32))
    got = tq.dequantize(tqt, torch.float32)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert tq.dequantize(tqt).dtype == torch.float32
    assert tq.dequantize_tree({"a": tqt, "b": 3})["b"] == 3


def test_should_quantize_follows_jax_rules():
    jcfg, tcfg = jq.QuantizationConfig(**INT8), tq.QuantizationConfig(**INT8)
    cases = [
        ("model.layers.0.self_attn.q_proj.weight", np.zeros((64, 64), np.float32)),
        ("model.embed_tokens.weight", np.zeros((256, 64), np.float32)),
        ("lm_head.weight", np.zeros((256, 64), np.float32)),
        ("model.layers.0.input_layernorm.weight", np.zeros((64,), np.float32)),
        ("small.weight", np.zeros((32, 32), np.float32)),
        ("ints.weight", np.zeros((128, 128), np.int32)),
    ]
    for path, arr in cases:
        want = jcfg.should_quantize(path, arr)
        assert tcfg.should_quantize(path, arr) == want, path
        assert tcfg.should_quantize(path, torch.from_numpy(arr)) == want, path
    with pytest.raises(ValueError):
        tq.QuantizationConfig(load_in_8bit=True, load_in_4bit=True)
    with pytest.raises(ValueError):
        tq.QuantizationConfig()
    assert tcfg.scheme == "int8" and tq.QuantizationConfig(**NF4).scheme == "nf4"


@pytest.fixture(scope="module")
def tiny_params():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, hidden_size=128, intermediate_size=256)
    jmodel = jl.LlamaForCausalLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("cfg_kw", [INT8, NF4])
def test_quantize_params_same_leaves_codes_and_nbytes(tiny_params, cfg_kw):
    """Over the port's state (HF names, ``[out, in]`` weights) the same
    leaves quantize as over the JAX tree, to the same codes and scales,
    and the two byte counts agree."""
    jqp = jax.tree.map(np.asarray, jq.quantize_params(tiny_params, jq.QuantizationConfig(**cfg_kw)))
    tqp = tq.quantize_params(torch_state_from_flax(tiny_params), tq.QuantizationConfig(**cfg_kw))
    carried = torch_state_from_flax(jqp)            # JAX's codes carried across
    quantized = {k for k, v in tqp.items() if tq.is_quantized(v)}
    assert quantized == {k for k, v in carried.items() if tq.is_quantized(v)}
    assert len(quantized) == 2 * 7                  # every dense of both layers
    for name in quantized:
        ref = carried[name]
        got = tqp[name]
        assert got.shape == ref.shape and got.layout == ref.layout, name
        assert torch.equal(got.data, ref.data) and torch.equal(got.scale, ref.scale), name
    assert tq.quantized_nbytes(tqp) == jq.quantized_nbytes(jqp)


def test_quantize_model_in_place_matches_quantize_params(tiny_params):
    state = torch_state_from_flax(tiny_params)
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, hidden_size=128, intermediate_size=256)
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(state)
    qcfg = tq.QuantizationConfig(**INT8)
    tq.quantize_model_(model, qcfg)
    want = tq.quantize_params(state, qcfg)
    layer = model.model.layers[1].mlp.down_proj
    assert layer.weight is None and layer.quantized.shape == (256, 128)
    assert torch.equal(layer.qcodes, want["model.layers.1.mlp.down_proj.weight"].data)
    assert model.lm_head.weight.dtype == torch.float32           # skipped: lm_head
    assert "model.layers.0.self_attn.q_proj.weight" not in dict(model.named_parameters())
    assert tq.quantized_nbytes(model) == tq.quantized_nbytes(want)


def test_load_converted_state_serves_jax_qparams(tiny_params):
    """A JAX quantized tree loads into the port's model and gives JAX's
    logits (f32 activations, JAX's codes)."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, hidden_size=128, intermediate_size=256)
    jqp = jq.quantize_params(tiny_params, jq.QuantizationConfig(**INT8))
    ids = np.asarray([[3, 17, 99, 4, 250, 7, 12, 63]], np.int32)
    want = np.asarray(jl.LlamaForCausalLM(jcfg).apply(jqp, jnp.asarray(ids)))
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, hidden_size=128, intermediate_size=256)
    model = load_converted_state(tl.LlamaForCausalLM(cfg, device="cpu"),
                                 torch_state_from_flax(jax.tree.map(np.asarray, jqp)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    with pytest.raises(KeyError):
        load_converted_state(tl.LlamaForCausalLM(cfg, device="cpu"), {})


def test_int8_forward_at_48_rows_per_dense_departs_by_bf16_input_roundings_only():
    """The int8-weight uncached forward at 3 x 16 tokens (48 rows per
    dense), JAX's codes carried across, every dense call recorded on both
    sides.  Up to the first dense whose bf16-rounded input differs from
    JAX's, every output agrees to 1e-5; that input differs in f32 by last
    bits only (1e-5 of its scale: RMSNorm and attention sum in another
    order), so the difference is a bf16 rounding of the W8A16 input that
    flips, not a module that computes something else.  At every dense, the
    port's op on JAX's own input gives JAX's output to 1e-5.  The flips
    move the logits by less than one bf16 step of their scale."""
    import accelerate_tpu.models.layers as jlayers
    import accelerate_tpu_torch.models.layers as tlayers
    import ml_dtypes

    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, hidden_size=128, intermediate_size=256)
    jmodel = jl.LlamaForCausalLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    qparams = jq.quantize_params(jax.tree.map(np.asarray, params), jq.QuantizationConfig(**INT8))
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, hidden_size=128, intermediate_size=256)
    model = load_converted_state(tl.LlamaForCausalLM(cfg, device="cpu"),
                                 torch_state_from_flax(jax.tree.map(np.asarray, qparams)))
    jcalls, tcalls = [], []
    jop, top = jlayers.quantized_matmul, tlayers.quantized_matmul

    def jrec(x, qt, **kw):
        out = jop(x, qt, **kw)
        jcalls.append((np.asarray(x, np.float32), np.asarray(out, np.float32)))
        return out

    def trec(x, qt, **kw):
        out = top(x, qt, **kw)
        tcalls.append((x.float().numpy().copy(), out.float().numpy().copy(), qt))
        return out

    ids = np.random.default_rng(5).integers(1, 255, (3, 16)).astype(np.int32)
    jlayers.quantized_matmul, tlayers.quantized_matmul = jrec, trec
    try:
        want = np.asarray(jmodel.apply(qparams, jnp.asarray(ids)))
        with torch.no_grad():
            got = model(torch.from_numpy(ids).long()).numpy()
    finally:
        jlayers.quantized_matmul, tlayers.quantized_matmul = jop, top
    assert len(jcalls) == len(tcalls) == 2 * 7
    first_flip = None
    for i, ((jx, jout), (tx, tout, qt)) in enumerate(zip(jcalls, tcalls)):
        assert jx.shape[:-1] == (3, 16)                      # 48 rows per dense
        with torch.no_grad():
            on_jax_input = tqm.quantized_matmul(torch.from_numpy(jx), qt,
                                                out_dtype=torch.float32).numpy()
        np.testing.assert_allclose(on_jax_input, jout, rtol=0, atol=1e-5 * np.abs(jout).max())
        if first_flip is None:
            if np.array_equal(jx.astype(ml_dtypes.bfloat16), tx.astype(ml_dtypes.bfloat16)):
                np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5 * np.abs(jout).max())
            else:
                first_flip = i
                np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-5 * np.abs(jx).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("cfg_kw", [INT8, NF4])
def test_load_and_quantize_model_codes_equal_jax(tiny_params, tmp_path, cfg_kw):
    """A checkpoint streamed into a ``meta`` model and quantized as it
    arrives: the same leaves quantize as in JAX's ``load_and_quantize_model``
    (over its own save of the same weights), to the same codes and scales,
    bitwise; and to ``quantize_model_``'s on the in-process model."""
    from accelerate_tpu.checkpointing import save_model as j_save_model
    from accelerate_tpu_torch.big_modeling import abstract_init
    from accelerate_tpu_torch.utils.serialization import save_safetensors

    j_save_model(None, tiny_params, str(tmp_path / "jax"))
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tiny_params)
    jqp = jq.load_and_quantize_model(abstract, str(tmp_path / "jax"),
                                     jq.QuantizationConfig(**cfg_kw))
    carried = torch_state_from_flax(jax.tree.map(np.asarray, jqp))
    state = torch_state_from_flax(tiny_params)
    save_safetensors(tmp_path / "model.safetensors", state)
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, hidden_size=128, intermediate_size=256)
    model = abstract_init(tl.LlamaForCausalLM, cfg, device="cpu")
    stats = {}
    tq.load_and_quantize_model(model, tmp_path / "model.safetensors",
                               tq.QuantizationConfig(**cfg_kw), device="cpu", stats=stats)
    ref = tq.quantize_model_(load_converted_state(tl.LlamaForCausalLM(cfg, device="cpu"), state),
                             tq.QuantizationConfig(**cfg_kw))
    quantized = {k for k, v in carried.items() if tq.is_quantized(v)}
    assert len(quantized) == 2 * 7
    for name in quantized:
        layer = model.get_submodule(name.rsplit(".", 1)[0])
        got, want = layer.quantized, carried[name]
        assert got is not None and layer.weight is None, name
        assert (got.shape, got.layout, got.scheme) == (want.shape, want.layout, want.scheme), name
        assert torch.equal(got.data, want.data) and torch.equal(got.scale, want.scale), name
        other = ref.get_submodule(name.rsplit(".", 1)[0]).quantized
        assert torch.equal(got.data, other.data) and torch.equal(got.scale, other.scale), name
    for name, t in model.state_dict().items():          # the rest as it was stored
        if name in state:
            assert torch.equal(t, state[name]), name
    assert all(t.device.type == "cpu" for t in model.state_dict().values())
    assert stats["tensors"] == len(state) and stats["quantize_s"] > 0


def test_quantized_apply_equals_jax(tiny_params):
    """The int8 model run on dequantized f32 weights gives JAX's
    ``quantized_apply`` logits; the layers hold their codes again after."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, hidden_size=128, intermediate_size=256)
    jqp = jq.quantize_params(tiny_params, jq.QuantizationConfig(**INT8))
    ids = np.asarray([[3, 17, 99, 4, 250, 7, 12, 63]], np.int32)
    want = np.asarray(jq.quantized_apply(jl.LlamaForCausalLM(jcfg).apply, jnp.float32)(
        jqp, jnp.asarray(ids)))
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, hidden_size=128, intermediate_size=256)
    model = load_converted_state(tl.LlamaForCausalLM(cfg, device="cpu"),
                                 torch_state_from_flax(jax.tree.map(np.asarray, jqp)))
    with torch.no_grad():
        got = tq.quantized_apply(model, torch.float32)(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    layer = model.model.layers[0].mlp.gate_proj
    assert layer.weight is None and layer.quantized is not None
    # the mapping form: QuantizedTensor leaves dequantized before the call
    qt = tq.quantize(torch.ones(4, 128), tq.QuantizationConfig(**INT8, min_size=1))
    out = tq.quantized_apply(lambda p, x: x @ p["w"], torch.float32)({"w": qt}, torch.ones(2, 4))
    assert torch.equal(out, torch.full((2, 128), 4.0))


def test_layerwise_casting_fp8_bits_equal_jax(tiny_params):
    """Matching weights stored as e4m3 with JAX's bits (norms and the
    embedding kept); the model upcasts them in-call through its hooks and
    gives JAX's logits."""
    from accelerate_tpu.ops.precision import layerwise_casting as j_layerwise_casting
    from accelerate_tpu_torch.ops.precision import layerwise_casting

    j_cast, j_wrap = j_layerwise_casting(tiny_params, jnp.float8_e4m3fn, jnp.float32)
    carried = torch_state_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), j_cast))
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, hidden_size=128, intermediate_size=256)
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(torch_state_from_flax(tiny_params))
    layerwise_casting(model, torch.float8_e4m3fn, torch.float32)
    from accelerate_tpu_torch.models.hf_interop import hf_llama_key_map

    flat, _ = jax.tree_util.tree_flatten_with_path(j_cast)
    by_path = {".".join(str(k.key) for k in p): np.asarray(leaf) for p, leaf in flat}
    stored = 0
    for name, t in model.state_dict().items():
        path = hf_llama_key_map(name)
        leaf = by_path[path]
        if leaf.dtype == jnp.float8_e4m3fn:
            stored += 1
            got = t.view(torch.uint8).numpy()
            np.testing.assert_array_equal(got.T if path.endswith(".kernel") else got,
                                          leaf.view(np.uint8))
        else:
            assert t.dtype == torch.float32 and torch.equal(t, carried[name]), name
    assert stored == 2 * 7 + 1            # every dense and the head
    ids = np.asarray([[3, 17, 99, 4, 250, 7, 12, 63]], np.int32)
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32, hidden_size=128,
                                                     intermediate_size=256))
    want = np.asarray(j_wrap(jmodel.apply)(j_cast, jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert model.lm_head.weight.dtype == torch.float8_e4m3fn
    # the mapping form
    cast, wrap = layerwise_casting({"w": torch.ones(2, 2), "norm": torch.ones(2)})
    assert cast["w"].dtype == torch.float8_e4m3fn and cast["norm"].dtype == torch.float32
    assert wrap(lambda p: p["w"].dtype)(cast) == torch.bfloat16

