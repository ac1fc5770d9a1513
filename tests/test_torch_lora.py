"""The port's LoRA ops (``accelerate_tpu_torch/ops/lora.py``, the fused
``fused_bgmv_paged_decode``) and their plumbing (``LoraPlugin``, streaming,
retry, ``OffloadStore``, adapter conversion) held against the JAX package's.

Both sides take the same numpy inputs (``default_rng`` seeds).  The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU; the port's wrappers run their plain versions (CPU
tensors).  Tolerances, each stated where it is used: f32 products that sum
in another order agree to ~1e-6 relative; a bf16 result rounded once from
f32 sums that differ in their last bits may land one bf16 step (2^-8
relative) apart.  Within torch, the batched native route is held bitwise to
the per-row sequential reference, as JAX pins it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.big_modeling import OffloadStore as JaxOffloadStore
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu.ops import lora as jlora
from accelerate_tpu.ops import streaming as jstream
from accelerate_tpu.resilience import retry as jretry
from accelerate_tpu.utils.dataclasses import LoraPlugin as JaxLoraPlugin
from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, LoraPlugin
from accelerate_tpu_torch.big_modeling import OffloadStore
from accelerate_tpu_torch.models.convert import (
    flax_module_to_port_name,
    lora_tree_from_flax,
    torch_state_from_flax,
)
from accelerate_tpu_torch.ops import flash_attention as tfa
from accelerate_tpu_torch.ops import lora as tlora
from accelerate_tpu_torch.ops import streaming as tstream
from accelerate_tpu_torch.resilience import retry as tretry

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_STEP = 2.0 ** -8       # one bf16 rounding step, relative


def _t(a, dtype=None):
    """A JAX (or numpy) array as a CPU tensor, bf16 exactly."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(arr, copy=True))
    return t if dtype is None else t.to(dtype)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _operands(rng, b, t, d, r, o, pool, dtype):
    """x, y (a -0.0 at [0, 0, 0]), stacks with a zero slot 0, mixed ids —
    as JAX ``test_lora_apply_batched_bitwise_equals_sequential`` draws them."""
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    y = rng.normal(size=(b, t, o)).astype(np.float32)
    y[0, 0, 0] = -0.0
    a = rng.normal(size=(pool + 1, d, r)).astype(np.float32)
    bb = rng.normal(size=(pool + 1, r, o)).astype(np.float32)
    a[0] = bb[0] = 0.0
    ids = np.asarray([0, 1, 3, 1, 2, 0] * 3, np.int32)[:b]
    jax_side = [jnp.asarray(v, JDT[dtype]) for v in (x, y, a, bb)] + [jnp.asarray(ids)]
    torch_side = [_t(np.asarray(v)) for v in jax_side[:4]] + [torch.from_numpy(ids)]
    return jax_side, torch_side


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(6, 3, 16, 4, 24, 3), (5, 7, 64, 8, 32, 3),
                                   (4, 1, 48, 4, 40, 3)])
def test_lora_apply_batched_bitwise_equals_sequential(dtype, shape):
    """The batched native route == the per-row sequential reference,
    bitwise, within torch (JAX pins the same, tests/test_lora.py:86); id-0
    rows are the base output, the sign of -0.0 included; 2-D rows too
    (against the sequential reference on the same rows: torch's f32 CPU
    products are not invariant to the window length T)."""
    _, (x, y, a, b, ids) = _operands(np.random.default_rng(0), *shape, dtype)
    out = tlora.lora_apply(x, y, a, b, ids, kernel="native")
    ref = tlora.lora_apply_sequential(x, y, a, b, ids)
    assert torch.equal(out, ref)
    assert torch.equal(out[0], y[0]) and torch.signbit(out[0, 0, 0])
    out2 = tlora.lora_apply(x[:, 0], y[:, 0], a, b, ids, kernel="native")
    assert torch.equal(out2, tlora.lora_apply_sequential(x[:, 0], y[:, 0], a, b, ids))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bgmv_plain_matches_jax_bgmv(dtype):
    """``bgmv_plain`` (kernel #10's plain version) against JAX's ``bgmv``
    in interpret mode (as tests/test_lora.py:114 runs it), mixed ids.
    f32: 2e-5 absolute on deltas of O(1).  bf16: both round an f32 sum once;
    sums in another order may land one bf16 step apart."""
    rng = np.random.default_rng(1)
    s, d, r, o, pool = 5, 32, 4, 48, 3
    x = rng.normal(size=(s, d)).astype(np.float32)
    a = rng.normal(size=(pool + 1, d, r)).astype(np.float32)
    b = rng.normal(size=(pool + 1, r, o)).astype(np.float32)
    a[0] = b[0] = 0.0
    ids = np.asarray([0, 2, 1, 3, 2], np.int32)
    jx, ja, jb = (jnp.asarray(v, JDT[dtype]) for v in (x, a, b))
    want = np.asarray(jlora.bgmv(jx, ja, jb, jnp.asarray(ids)), np.float32)
    got = tlora.bgmv(_t(jx), _t(ja), _t(jb), torch.from_numpy(ids))
    assert got.dtype == TDT[dtype] and got.shape == (s, o)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), want, atol=2e-5)
    else:
        np.testing.assert_allclose(_f32(got), want, rtol=BF16_STEP, atol=1e-6)
    assert not _f32(got)[ids == 0].any()
    assert tlora.bgmv.launches == 0          # CPU tensors: the plain version


@pytest.mark.parametrize("kernel", ["native", "bgmv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_apply_matches_jax(kernel, dtype):
    """``lora_apply`` under ``kernel="native"`` (T 3: the gathered products
    in x's dtype, h rounded) and ``kernel="bgmv"`` (T 1: f32 h and delta)
    against JAX's, mixed ids with id-0 rows.  Id-0 rows are bitwise ``y``
    on both sides, -0.0 included.  f32: 1e-5 relative; bf16: JAX and torch
    round h, the delta and y + delta at the same points, each rounding of
    sums in another order one bf16 step at most apart (4 steps overall)."""
    t = 3 if kernel == "native" else 1
    (jx, jy, ja, jb, jids), (x, y, a, b, ids) = _operands(
        np.random.default_rng(2), 6, t, 16, 4, 24, 3, dtype)
    want = jlora.lora_apply(jx, jy, ja, jb, jids, kernel=kernel)
    got = tlora.lora_apply(x, y, a, b, ids, kernel=kernel)
    assert got.dtype == TDT[dtype]
    rtol = 1e-5 if dtype == "float32" else 4 * BF16_STEP
    scale = np.abs(_f32(want)).max()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=rtol * scale)
    for row in np.flatnonzero(np.asarray(jids) == 0):
        assert torch.equal(got[row], y[row])
        np.testing.assert_array_equal(_f32(got[row]), _f32(want[row]))
    assert torch.signbit(got[0, 0, 0]) and np.signbit(_f32(want)[0, 0, 0])


def test_auto_takes_bgmv_at_t1_on_any_device_and_native_otherwise():
    """The port's ``auto`` (a deliberate delta from JAX, whose ``auto`` takes
    bgmv only on a TPU): T = 1 gives the bgmv route's numbers (f32 h), T > 1
    the native route's."""
    _, (x, y, a, b, ids) = _operands(np.random.default_rng(3), 6, 1, 16, 4, 24, 3, "bfloat16")
    assert torch.equal(tlora.lora_apply(x, y, a, b, ids),
                       tlora.lora_apply(x, y, a, b, ids, kernel="bgmv"))
    _, (x, y, a, b, ids) = _operands(np.random.default_rng(3), 6, 3, 16, 4, 24, 3, "bfloat16")
    assert torch.equal(tlora.lora_apply(x, y, a, b, ids),
                       tlora.lora_apply(x, y, a, b, ids, kernel="native"))
    with tlora.lora_kernel("bgmv"):
        assert tlora.lora_kernel_mode() == "bgmv"
    assert tlora.lora_kernel_mode() == "auto"
    with pytest.raises(ValueError):
        tlora.normalize_lora_kernel("pallas")


def _apply_operands(rng, s, d, r, o, pool):
    """bf16 x, y (with -0.0 and +0.0 on id-0 rows and on an id >= N row),
    stacks with a zero slot 0 and ids mixing 0, -1, 1..pool and pool + 1
    (>= N)."""
    x = torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32)).bfloat16()
    y = torch.from_numpy(rng.normal(size=(s, o)).astype(np.float32)).bfloat16()
    a = torch.from_numpy(rng.normal(size=(pool + 1, d, r)).astype(np.float32) / d ** 0.5)
    b = torch.from_numpy(rng.normal(size=(pool + 1, r, o)).astype(np.float32) / r ** 0.5)
    a[0] = b[0] = 0.0
    ids = torch.from_numpy(np.resize(np.asarray([0, 1, 2, -1, pool, 0, pool + 1, 1], np.int32),
                                     s))
    y[(ids <= 0) | (ids > pool), :2] = torch.tensor([-0.0, 0.0], dtype=torch.bfloat16)
    return x, y, a.bfloat16(), b.bfloat16(), ids


@pytest.mark.parametrize("rank", [1, 4, 8, 16, 33, 64])
def test_bgmv_apply_plain_is_the_composition(rank):
    """#10's fused plain version is bitwise ``where(ids > 0, y +
    bgmv_plain(...), y)``: id-0 (and negative-id) rows are ``y`` bitwise,
    -0.0 included; an id >= N adds a zero delta (-0.0 + 0 = +0.0, the
    composition's own answer); every rank the kernel takes."""
    x, y, a, b, ids = _apply_operands(np.random.default_rng(rank), 8, 48, rank, 40, 3)
    got = tlora.bgmv_apply(x, y, a, b, ids)
    delta = tlora.bgmv_plain(x, a, b, ids)
    want = torch.where((ids > 0)[:, None], y + delta.to(y.dtype), y)
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                       want.view(torch.int16))
    base = ids <= 0
    assert torch.equal(got[base].view(torch.int16), y[base].view(torch.int16))
    assert torch.signbit(got[base][:, 0].float()).all()
    big = ids >= a.shape[0]
    assert not delta[big].any()
    assert torch.equal(got[big].float(), (y[big].float() + 0.0).bfloat16().float())
    assert not torch.signbit(got[big][:, 0].float()).any()
    assert tlora.bgmv_apply.launches == 0 and tlora.bgmv.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bgmv_apply_matches_jax_lora_apply(dtype):
    """The fused wrapper's plain version (the CPU route of ``lora_apply`` at
    T = 1) against JAX's ``lora_apply(kernel="bgmv")`` (its Pallas kernel
    in interpret mode), at the tolerance ``test_lora_apply_matches_jax``
    states; id-0 rows bitwise ``y`` on both sides, -0.0 included."""
    (jx, jy, ja, jb, jids), (x, y, a, b, ids) = _operands(
        np.random.default_rng(12), 6, 1, 16, 4, 24, 3, dtype)
    want = jlora.lora_apply(jx, jy, ja, jb, jids, kernel="bgmv")[:, 0]
    got = tlora.bgmv_apply(x[:, 0], y[:, 0], a, b, ids)
    assert got.dtype == TDT[dtype]
    rtol = 1e-5 if dtype == "float32" else 4 * BF16_STEP
    scale = np.abs(_f32(want)).max()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=rtol * scale)
    for row in np.flatnonzero(np.asarray(jids) == 0):
        assert torch.equal(got[row], y[row, 0])
        np.testing.assert_array_equal(_f32(got[row]), _f32(want[row]))
    assert torch.signbit(got[0, 0]) and np.signbit(_f32(want)[0, 0])


def test_lora_apply_at_t1_is_one_bgmv_apply_call():
    """At T = 1 under bgmv, ``lora_apply`` is one call of ``bgmv_apply``
    (looked up when called, so a stand-in sees it) and nothing else: no
    ``bgmv`` call, no select around it."""
    _, (x, y, a, b, ids) = _operands(np.random.default_rng(4), 6, 1, 16, 4, 24, 3, "bfloat16")
    real, calls = tlora.bgmv_apply, []

    def stand_in(*args):
        calls.append(args)
        return real(*args)

    tlora.bgmv_apply = stand_in
    try:
        out = tlora.lora_apply(x, y, a, b, ids)
        out2 = tlora.lora_apply(x[:, 0], y[:, 0], a, b, ids)
    finally:
        tlora.bgmv_apply = real
    assert len(calls) == 2 and out.shape == y.shape and torch.equal(out[:, 0], out2)
    assert torch.equal(out2, tlora.bgmv_apply_plain(x[:, 0], y[:, 0], a, b, ids))


def test_bgmv_wrappers_check_operands():
    """Shapes are checked on every device; the CUDA-only checks (bf16,
    rank, rows) leave a CPU call to the plain version."""
    x, y, a, b, ids = _apply_operands(np.random.default_rng(7), 4, 16, 4, 8, 2)
    with pytest.raises(ValueError, match="y of shape"):
        tlora.bgmv_apply(x, y[:, :4], a, b, ids)
    with pytest.raises(ValueError, match="ids of shape"):
        tlora.bgmv(x, a, b, ids[:3])
    with pytest.raises(ValueError, match="do not fit"):
        tlora.bgmv_apply(x, y, a[:, :8], b, ids)
    meta = [t.to("meta") for t in (x, y, a, b)]
    with pytest.raises(ValueError, match="unsupported device"):
        tlora.bgmv_apply(*meta, ids.to("meta"))
    assert tlora.bgmv_apply(x.float(), y.float(), a.float(), b.float(), ids).dtype == torch.float32


def _quant_pool(rng, hkv, num_pages, page, d):
    """JAX tests/test_serving.py's emulated int8 write: per-(head, page)
    amax codes."""
    f = rng.normal(size=(hkv, num_pages, page, d)).astype(np.float32)
    amax = np.abs(f).max(axis=(2, 3))
    codes = np.clip(np.rint(f * (127.0 / amax[:, :, None, None])), -127, 127)
    return codes.astype(np.int8), amax.astype(np.float32)


@pytest.mark.parametrize("kv_dtype", [None, "bfloat16", "int8"])
def test_fused_bgmv_paged_decode_plain_matches_jax(kv_dtype):
    """``fused_bgmv_paged_decode`` (plain on the CPU) against JAX's Pallas
    kernel in interpret mode at the shapes of tests/test_serving.py:198, over
    f32 (that test's), bf16 and int8 pages: 1e-5 absolute on outputs of
    O(1) (both widen the pages to f32 and attend with the f32 query).  Also
    the JAX checks: a non-dividing head count and a wrong b_stack raise."""
    rng = np.random.default_rng(1)
    hkv, num_pages, page, d, slots, n, h = 2, 16, 8, 32, 4, 4, 4
    d_in, rank, n_adapters = 48, 4, 3
    if kv_dtype == "int8":
        kp, ks = _quant_pool(rng, hkv, num_pages, page, d)
        vp, vs = _quant_pool(rng, hkv, num_pages, page, d)
    else:
        kp = rng.normal(size=(hkv, num_pages, page, d)).astype(np.float32)
        vp = rng.normal(size=(hkv, num_pages, page, d)).astype(np.float32)
        if kv_dtype == "bfloat16":
            kp, vp = (np.asarray(jnp.asarray(p, jnp.bfloat16)) for p in (kp, vp))
        ks = vs = None
    bt = rng.permutation(num_pages)[: slots * n].reshape(slots, n).astype(np.int32)
    pos = np.asarray([0, 5, 17, 31], np.int32)
    x = rng.normal(size=(slots, d_in)).astype(np.float32)
    q_base = rng.normal(size=(slots, h, d)).astype(np.float32)
    a = rng.normal(size=(n_adapters, d_in, rank)).astype(np.float32) * 0.1
    b = rng.normal(size=(n_adapters, rank, h * d)).astype(np.float32) * 0.1
    a[0] = b[0] = 0.0
    ids = np.asarray([0, 1, 2, 1], np.int32)
    cos, sin = jl.rope_frequencies(d, 64, 10000.0)
    operands = (x, q_base, a, b, ids, cos, sin, kp, vp, bt, pos)
    jkw = {} if ks is None else dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    tkw = {} if ks is None else dict(k_scales=_t(ks), v_scales=_t(vs))
    want = np.asarray(jfa.fused_bgmv_paged_decode(*map(jnp.asarray, operands), **jkw))
    got = tfa.fused_bgmv_paged_decode(*map(_t, operands), **tkw)
    assert got.dtype == torch.float32 and got.shape == (slots, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert tfa.fused_bgmv_paged_decode.launches == tfa.fused_bgmv_paged_decode_quant.launches == 0
    with pytest.raises(ValueError, match="not divisible"):
        tfa.fused_bgmv_paged_decode(*map(_t, (x, q_base[:, :3], a, b[..., :3 * d], ids, cos, sin,
                                              kp, vp, bt, pos)), **tkw)
    with pytest.raises(ValueError, match="b_stack shape"):
        tfa.fused_bgmv_paged_decode(*map(_t, (x, q_base, a, b[..., :-1], ids, cos, sin, kp, vp,
                                              bt, pos)), **tkw)


def test_fused_plain_keeps_q_in_f32_and_clamps_dead_positions():
    """The plain version attends with the f32 query (a bf16 q_base's delta
    is not rounded to bf16 before the page loop) and ropes positions past
    the table at its last row; a position of -1 reads no page."""
    rng = np.random.default_rng(4)
    hkv, num_pages, page, d, h = 1, 4, 4, 8, 2
    kp = _t(rng.normal(size=(hkv, num_pages, page, d)).astype(np.float32)).bfloat16()
    vp = _t(rng.normal(size=(hkv, num_pages, page, d)).astype(np.float32)).bfloat16()
    bt = torch.tensor([[0, 1], [2, 3], [1, 0]], dtype=torch.int32)
    pos = torch.tensor([7, 50, -1], dtype=torch.int32)
    x = _t(rng.normal(size=(3, 6)).astype(np.float32)).bfloat16()
    q_base = _t(rng.normal(size=(3, h, d)).astype(np.float32)).bfloat16()
    a = _t(rng.normal(size=(2, 6, 2)).astype(np.float32)).bfloat16()
    b = _t(rng.normal(size=(2, 2, h * d)).astype(np.float32)).bfloat16()
    a[0] = b[0] = 0
    ids = torch.tensor([1, 1, 0], dtype=torch.int32)
    cos, sin = (torch.from_numpy(t) for t in jl.rope_frequencies(d, 16, 10000.0))
    out = tfa.fused_bgmv_paged_decode(x, q_base, a, b, ids, cos, sin, kp, vp, bt, pos)
    assert out.dtype == torch.bfloat16 and not out[2].any()
    delta = tlora.bgmv_plain(x.float(), a, b, ids).reshape(3, 1, h, d)
    clamped = pos.clamp(0, 15)
    roped = jl.apply_rope(jnp.asarray(delta.numpy()), jnp.asarray(cos.numpy()),
                          jnp.asarray(sin.numpy()), jnp.asarray(clamped.numpy())[:, None])[:, 0]
    q32 = q_base.float() + _t(roped) * (ids != 0).float()[:, None, None]
    ref = tfa.paged_decode_attention_plain(q32, kp, vp, bt, pos).to(torch.bfloat16)
    assert torch.equal(out[:2], ref[:2])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _jax_pool(params, targets=jlora.DEFAULT_LORA_TARGETS, slot=2, key=1, dtype=jnp.float32):
    spec = jlora.lora_spec(params, targets)
    pool = jlora.init_lora_pool(spec, pool_slots=3, rank=4, dtype=dtype)
    ad = jlora.init_adapter_params(jax.random.PRNGKey(key), spec, 4, init_b="normal",
                                   dtype=dtype)
    return jax.tree_util.tree_map(lambda p, a: p.at[slot].set(a), pool, ad)


@pytest.mark.parametrize("targets", [("q_proj", "v_proj"), ("q_proj", "o_proj", "down_proj",
                                                            "lm_head")])
def test_lora_spec_names_map_jax_spec(tiny, targets):
    _, params, tmodel = tiny
    jspec = jlora.lora_spec(params, targets)
    tspec = tlora.lora_spec(tmodel, targets)
    assert {flax_module_to_port_name(k): v for k, v in jspec.items()} == tspec
    with pytest.raises(ValueError, match="no LoRA target"):
        tlora.lora_spec(tmodel, ("nope",))


@pytest.mark.parametrize("targets", [("q_proj", "v_proj"), ("q_proj", "o_proj", "down_proj",
                                                            "lm_head")])
def test_lora_model_mixed_batch_matches_jax(tiny, targets):
    """The uncached forward with a JAX ``lora`` pool carried across: mixed
    ids [0, 2, 0] give JAX's logits (f32, 1e-5 relative); within torch, id-0
    rows are bitwise the base forward and the adapter row bitwise the same
    row of an all-one-id pass (JAX's tests/test_lora.py:135 pin)."""
    jmodel, params, tmodel = tiny
    jpool = _jax_pool(params, targets)
    pool = lora_tree_from_flax(jax.tree.map(np.asarray, jpool))
    ids_in = np.random.default_rng(0).integers(1, 255, (3, 8)).astype(np.int32)
    want = jmodel.apply({**params, "lora": jpool}, jnp.asarray(ids_in),
                        adapter_ids=jnp.asarray([0, 2, 0], jnp.int32))
    x = torch.from_numpy(ids_in)
    with torch.no_grad():
        base = tmodel(x)
        mixed = tmodel(x, adapter_ids=torch.tensor([0, 2, 0]), lora=pool)
        solo = tmodel(x, adapter_ids=torch.tensor([2, 2, 2]), lora=pool)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(mixed[0], base[0]) and torch.equal(mixed[2], base[2])
    assert torch.equal(mixed[1], solo[1]) and not torch.equal(mixed[1], base[1])


def test_adapter_trees_cross_bitwise():
    """A bf16 JAX adapter crosses as bf16 tensors with the same values; the
    names are the port's module names."""
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny())
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    spec = jlora.lora_spec(params)
    ad = jlora.init_adapter_params(jax.random.PRNGKey(7), spec, 4, init_b="normal")
    tree = lora_tree_from_flax(jax.tree.map(np.asarray, ad))
    assert set(tree) == {flax_module_to_port_name(k) for k in spec}
    leaf = tree["model.layers.1.self_attn.v_proj"]["b"]
    assert leaf.dtype == torch.bfloat16 and leaf.shape == (4, 32)
    np.testing.assert_array_equal(
        leaf.float().numpy(), np.asarray(ad["layers_1"]["self_attn"]["v_proj"]["b"], np.float32))


# ---------------------------------------------------------------------------
# plumbing: plugin, pools, accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {},
    {"ACCELERATE_LORA_RANK": "16", "ACCELERATE_LORA_POOL_SLOTS": "7",
     "ACCELERATE_LORA_TARGETS": "q_proj, o_proj", "ACCELERATE_LORA_KERNEL": "bgmv",
     "ACCELERATE_LORA_BYPASS_AGE": "5", "ACCELERATE_LORA_ALPHA": "8",
     "ACCELERATE_LORA_OPTIMIZER": "adamw-sr8"},
])
def test_lora_plugin_matches_jax_fields_defaults_and_env(monkeypatch, env):
    """The JAX plugin's fields, environment defaults and validation
    (tests/test_lora.py:469)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port, ref = LoraPlugin(), JaxLoraPlugin()
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == {k: v for k, v in ref.__dict__.items()}
    assert LoraPlugin(rank=2).rank == 2
    assert LoraPlugin(targets="q_proj,lm_head").targets == ("q_proj", "lm_head")
    for bad in (dict(kernel="mystery"), dict(rank=0), dict(pool_slots=0),
                dict(max_bypass_age=-1), dict(targets=()), dict(alpha=0.0)):
        with pytest.raises(ValueError):
            LoraPlugin(**bad)


def test_pools_adapters_and_accounting_match_jax(tiny):
    _, params, tmodel = tiny
    jspec = jlora.lora_spec(params)
    tspec = tlora.lora_spec(tmodel)
    pool = tlora.init_lora_pool(tspec, 3, 4, torch.bfloat16)
    jpool = lora_tree_from_flax(jax.tree.map(np.asarray, jlora.init_lora_pool(jspec, 3, 4)))
    assert {k: {f: (v.shape, v.dtype) for f, v in fac.items()} for k, fac in pool.items()} == \
        {k: {f: (v.shape, v.dtype) for f, v in fac.items()} for k, fac in jpool.items()}
    assert not any(v.any() for fac in pool.values() for v in fac.values())
    for bad in (dict(pool_slots=0, rank=4), dict(pool_slots=2, rank=0)):
        with pytest.raises(ValueError):
            tlora.init_lora_pool(tspec, **bad)
    gen = torch.Generator().manual_seed(0)
    zeros_b = tlora.init_adapter_params(gen, tspec, 4)
    assert all(not fac["b"].any() and fac["a"].any() for fac in zeros_b.values())
    normal = tlora.init_adapter_params(gen, tspec, 4, init_b="normal", alpha=8.0,
                                       dtype=torch.float32)
    assert all(fac["a"].shape == (tspec[k][0], 4) and fac["b"].shape == (4, tspec[k][1])
               for k, fac in normal.items())
    with pytest.raises(ValueError):
        tlora.init_adapter_params(gen, tspec, 4, init_b="uniform")
    assert tlora.adapter_param_count(tspec, 4) == jlora.adapter_param_count(jspec, 4)
    for optimizer in ("lion-sr8", "adamw", "unknown"):
        assert tlora.adapter_state_accounting(tspec, 4, 10_000, optimizer=optimizer) == \
            jlora.adapter_state_accounting(jspec, 4, 10_000, optimizer=optimizer)


# ---------------------------------------------------------------------------
# streaming, retry, the cold tier
# ---------------------------------------------------------------------------


def test_stream_stats_and_overlap_match_jax():
    for kw in ({}, dict(h2d_bytes=10, fetches=2, prefetch_hits=1, fetch_wait_s=0.5,
                        wall_s=2.0, transfer_retries=3)):
        for serial in (None, 1.0):
            assert tstream.StreamStats(**kw).overlap_report(serial) == \
                jstream.StreamStats(**kw).overlap_report(serial)
    for args in ((0.0, 1.0), (2.0, 1.0), (1.0, 3.0)):
        assert tstream.predicted_overlap(*args) == jstream.predicted_overlap(*args)
    assert tstream.HOST_BYTES_PER_PARAM == jstream.HOST_BYTES_PER_PARAM
    tree = {"a": {"x": np.zeros((3, 4), np.float32)}, "b": torch.zeros(5, dtype=torch.bfloat16)}
    assert tstream.tree_bytes(tree) == 48 + 10
    assert jstream.tree_bytes({"a": {"x": np.zeros((3, 4), np.float32)}}) == 48


def test_layer_prefetcher_matches_jax():
    """The same get / prefetch / invalidate sequence gives JAX's trees,
    fetch order and stats (bytes, fetches, prefetch hits), lookahead
    included; a failing fetch is retried within the policy."""
    def run(cls, stats_cls, put, **kw):
        fetched = []

        def fetch(i):
            fetched.append(i)
            return put({"w": np.full((2, i + 1), i, np.float32)})

        stats = stats_cls()
        pf = cls(fetch, 4, stats=stats, **kw)
        got = [pf.get(0), pf.prefetch(2), pf.prefetch(2), pf.get(2), pf.get(3)]
        pf.invalidate(0)
        got += [pf.get(0)]
        with pytest.raises(IndexError):
            pf.get(4)
        with pytest.raises(IndexError):
            pf.prefetch(-1)
        pf.drop()
        trees = [np.asarray(g["w"]).tolist() if isinstance(g, dict) else g for g in got]
        return trees, fetched, (stats.h2d_bytes, stats.fetches, stats.prefetch_hits)

    for kw in (dict(depth=1), dict(depth=0), dict(depth=2), dict(enabled=False)):
        assert run(tstream.LayerPrefetcher, tstream.StreamStats,
                   lambda t: {k: torch.from_numpy(v) for k, v in t.items()}, **kw) == \
            run(jstream.LayerPrefetcher, jstream.StreamStats, jax.device_put, **kw)
    with pytest.raises(ValueError):
        tstream.LayerPrefetcher(lambda i: {}, 0)
    calls = []

    def flaky(i):
        calls.append(i)
        if len(calls) < 3:
            raise tretry.TransientIOError("blip")
        return {"w": torch.ones(2)}

    stats = tstream.StreamStats()
    pf = tstream.LayerPrefetcher(flaky, 1, depth=0, stats=stats,
                                 retry_policy=tretry.RetryPolicy(retries=3, backoff_s=0.0))
    assert pf.get(0)["w"].sum() == 2 and stats.transfer_retries == 2 and len(calls) == 3


@pytest.mark.parametrize("failures, exc", [(0, None), (2, None), (5, tretry.TransientIOError),
                                           (1, FileNotFoundError), (1, ValueError)])
def test_with_retries_matches_jax(failures, exc):
    """Same failures -> the same result or exception and the same retry
    callbacks as JAX's ``with_retries`` (backoff 0)."""
    def outcome(mod):
        seen, calls = [], [0]
        kind = exc or mod.TransientIOError

        def fn(v):
            calls[0] += 1
            if calls[0] <= failures:
                raise (mod.TransientIOError("blip") if kind is tretry.TransientIOError
                       else kind("fatal"))
            return v * 2

        try:
            res = mod.with_retries(fn, 21, policy=mod.RetryPolicy(retries=3, backoff_s=0.0),
                                   site="s", on_retry=lambda s, a, e: seen.append((s, a)))
        except BaseException as e:  # compared below
            res = type(e).__name__
        return res, seen, calls[0]

    assert outcome(tretry) == outcome(jretry)
    with pytest.raises(ValueError):
        tretry.RetryPolicy(retries=-1)


def test_offload_store_roundtrip_and_jax_format(tmp_path):
    """bf16 tensors store as their bit patterns under "bfloat16": JAX's
    store reads the port's files as ml_dtypes bf16 and the port reads JAX's,
    values bitwise; f32 and int arrays round-trip as they are."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).bfloat16()
    b = rng.normal(size=(4,)).astype(np.float32)
    store = OffloadStore(tmp_path / "port", autoflush=False)
    store.save("adapter_1/x/a", a)
    store.save("adapter_1/x/b", b)
    store.save("ids", np.arange(3, dtype=np.int32))
    store.flush()
    again = OffloadStore(tmp_path / "port")
    assert torch.equal(again.load_tensor("adapter_1/x/a"), a)
    np.testing.assert_array_equal(again.load("adapter_1/x/b"), b)
    assert "ids" in again and set(again.keys()) == {"adapter_1/x/a", "adapter_1/x/b", "ids"}
    jstore = JaxOffloadStore(tmp_path / "port")
    np.testing.assert_array_equal(np.asarray(jstore.load("adapter_1/x/a"), np.float32),
                                  a.float().numpy())
    jwrite = JaxOffloadStore(tmp_path / "jax")
    jwrite.save("w", np.asarray(jnp.asarray(b, jnp.bfloat16)))
    assert torch.equal(OffloadStore(tmp_path / "jax").load_tensor("w"),
                       torch.from_numpy(b).bfloat16())
