"""The port's W8A16 matmul (``accelerate_tpu_torch/ops/quantized_matmul.py``)
held against the JAX package's.

On the CPU the port runs the plain version of the kernel its dispatch picks
(#11 tiled or #12 whole-F, by JAX's rule); the JAX package runs its Pallas
kernels in interpret mode, as its own tests do.  Both get the same seeded
codes (quantized once, in numpy).  Tolerance: f32 out within 1e-5 of
max|ref| (the two differ in summation order only), bf16 out within 1e-2 of
max|ref| (one bf16 rounding of the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import quantized_matmul as jqm
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch.ops import quantized_matmul as tqm
from accelerate_tpu_torch.utils import quantization as tq


@pytest.fixture(autouse=True)
def _zero_counts():
    tqm.reset_launch_counts()
    yield
    assert tqm.quantized_matmul_tiled.launches == 0       # CPU tensors: plain versions
    assert tqm.quantized_matmul_wholef.launches == 0


def _qt(rng, h, f, **cfg_kw):
    w = rng.normal(size=(h, f)).astype(np.float32)
    jqt = jq.quantize(w, jq.QuantizationConfig(load_in_8bit=True, **cfg_kw))
    tqt = tq.quantize(torch.from_numpy(w), tq.QuantizationConfig(load_in_8bit=True, **cfg_kw))
    return jqt, tqt


def _assert_close(got, want):
    rtol = 1e-5 if got.dtype == torch.float32 else 1e-2
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


# (H, F, m, kwargs, expected route): tiled; masked-K tail; whole-F at m = 1
# and 8 with and without a masked tail; the m = 8 / 9 dispatch boundary;
# wholef=False pinning the tiled kernel at decode; an H that is no multiple
# of 8 (zero rows pad it) on both kernels
CASES = [
    (256, 1024, 4, dict(wholef=False), "tiled"),
    (320, 1024, 4, dict(wholef=False), "tiled"),     # no divisor: masked K tail
    (1280, 512, 16, {}, "tiled"),                    # half divisor -> masked tile
    (2048, 1408, 1, {}, "wholef"),
    (1408, 512, 8, {}, "wholef"),                    # whole-F masked tail
    (512, 640, 2, dict(wholef=True), "wholef"),      # 5 q-blocks
    (384, 512, 8, {}, "wholef"),                     # dispatch boundary: m = 8 ...
    (384, 512, 9, {}, "tiled"),                      # ... and m = 9
    (1000, 256, 4, dict(wholef=False), "tiled"),     # H % 128 != 0
    (1001, 256, 16, {}, "tiled"),                    # H % 8 != 0
    (1001, 512, 2, {}, "wholef"),                    # H % 8 != 0
]


@pytest.mark.parametrize("h, f, m, kw, route", CASES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(h, f, m, kw, route, out_dtype):
    rng = np.random.default_rng(h + f + m)
    jqt, tqt = _qt(rng, h, f)
    x = rng.normal(size=(m, h)).astype(np.float32)
    assert tqm._route(m, tqt, kw.get("wholef")) == route
    want = jqm.quantized_matmul(jnp.asarray(x, jnp.bfloat16), jqt, out_dtype=getattr(jnp, out_dtype),
                                interpret=True, **kw)
    got = tqm.quantized_matmul(torch.from_numpy(x).bfloat16(), tqt,
                               out_dtype=getattr(torch, out_dtype), **kw)
    assert got.dtype == getattr(torch, out_dtype)
    _assert_close(got, want)


@pytest.mark.parametrize("h, f", [(1536, 1536), (1536, 768), (1536, 4096), (4096, 1536)])
@pytest.mark.parametrize("m", [48, 512])
def test_quantized_matmul_at_the_600m_shapes_matches_jax(h, f, m):
    """The 600m model's four denses at 48 rows (three 16-token rows) and at
    a 512-token chunk, both on the tiled route: f32 out within 1e-5 of
    max|ref| (summation order only).  The op agrees at 48 rows; the
    model-level delta found there is bf16 input roundings that flip
    (``test_torch_quantization.py``)."""
    rng = np.random.default_rng(h + f + m)
    w = (rng.normal(size=(h, f)) / h ** 0.5).astype(np.float32)
    jqt = jq.quantize(w, jq.QuantizationConfig(load_in_8bit=True))
    tqt = tq.quantize(torch.from_numpy(w), tq.QuantizationConfig(load_in_8bit=True))
    x = rng.normal(size=(m, h)).astype(np.float32)
    assert tqm._route(m, tqt, None) == "tiled"
    want = jqm.quantized_matmul(jnp.asarray(x, jnp.bfloat16), jqt, out_dtype=jnp.float32,
                                interpret=True)
    got = tqm.quantized_matmul(torch.from_numpy(x).bfloat16(), tqt, out_dtype=torch.float32)
    _assert_close(got, want)


def test_leading_dims_and_f32_input():
    """x of any leading shape; an f32 x gives f32 out by default (x is
    rounded to bf16 for the product, as in JAX)."""
    rng = np.random.default_rng(2)
    jqt, tqt = _qt(rng, 256, 1024)
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    want = jqm.quantized_matmul(jnp.asarray(x), jqt, wholef=False, interpret=True)
    got = tqm.quantized_matmul(torch.from_numpy(x), tqt, wholef=False)
    assert got.shape == (2, 3, 1024) and got.dtype == torch.float32
    _assert_close(got, want)


@pytest.mark.parametrize("case", ["nf4", "block_64", "tiny_h"])
def test_fallbacks_match_jax(case):
    rng = np.random.default_rng(4)
    if case == "nf4":
        w = rng.normal(size=(64, 256)).astype(np.float32)
        jqt = jq.quantize(w, jq.QuantizationConfig(load_in_4bit=True))
        tqt = tq.quantize(torch.from_numpy(w), tq.QuantizationConfig(load_in_4bit=True))
    elif case == "block_64":
        jqt, tqt = _qt(rng, 256, 512, block_size=64)
    else:
        jqt, tqt = _qt(rng, 96, 256)
    x = rng.normal(size=(2, tqt.shape[0])).astype(np.float32)
    assert tqm._route(2, tqt, None) == "fallback"
    want = jqm.quantized_matmul(jnp.asarray(x, jnp.bfloat16), jqt, out_dtype=jnp.float32)
    got = tqm.quantized_matmul(torch.from_numpy(x).bfloat16(), tqt, out_dtype=torch.float32)
    # the bf16 matmul rounds its output on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2 * np.abs(want).max())


def test_jax_tile_knobs_are_not_taken():
    """The CUDA kernels use their own tiles: JAX's tile knobs are no
    arguments of the port's ``quantized_matmul``."""
    _, tqt = _qt(np.random.default_rng(6), 256, 512)
    for knob in ("block_m", "block_k", "block_f"):
        with pytest.raises(TypeError, match=knob):
            tqm.quantized_matmul(torch.zeros(4, 256, dtype=torch.bfloat16), tqt, **{knob: 128})


def test_tile_planners_equal_jax():
    for h in (96, 128, 320, 384, 1000, 1280, 1408, 1536, 2048, 4096, 11008):
        for block_k in (128, 200, 256, 512, 1024):
            assert tqm._k_tile(h, block_k) == jqm._k_tile(h, block_k), (h, block_k)
        for f in (256, 640, 768, 1536, 4096, 5632):
            assert tqm._wholef_tiles(h, f) == jqm._wholef_tiles(h, f), (h, f)


def test_split_planners_agree_with_the_kernels_rule():
    """The C entry points recompute each slice's length from the split
    count and refuse a count that does not come back: hold the planners to
    that rule at the 600m shapes and around them.  #11's slices cover H
    exactly, each at least one 64-row K tile, at most 8 of them; its plan
    switches from the decode width (16-row tiles to m 16, 64-row tiles to
    m 64) to the prefill width (128-row tiles) between m 64 and 65, and it
    splits H only while its output tiles fill at most half the SMs (66).
    #12's slices (m <= 8) cover H exactly too, at most 8 of them, each 1 to
    64 K tiles, at least 2 where H has them, over 128-column tiles, about
    one and a half waves of blocks."""
    for m in (1, 4, 8, 9, 16, 17, 37, 48, 64, 65, 100, 512):
        for h in (128, 256, 1000, 1536, 1576, 4096):
            for f in (128, 768, 1536, 4096):
                plan = tqm.tiled_plan(m, h, f)
                k_tiles = -(-h // 64)
                per = -(-k_tiles // plan.splits)
                assert plan.splits >= 1 and -(-k_tiles // per) == plan.splits, (m, h, f)
                assert plan.k_tiles_per_split == per >= 1, (m, h, f)
                slices = [(s * per * 64, min(h, (s + 1) * per * 64)) for s in range(plan.splits)]
                assert slices[0][0] == 0 and slices[-1][1] == h, (m, h, f)
                assert all(a < b for a, b in slices), (m, h, f)
                assert all(b == c for (_, b), (c, _) in zip(slices, slices[1:])), (m, h, f)
                assert plan.block_m == (16 if m <= 16 else 64 if m <= 64 else 128), (m, h, f)
                assert plan.splits <= 8, (m, h, f)
                assert plan.tiles == (f // 128) * -(-m // plan.block_m), (m, h, f)
                if plan.splits > 1:
                    assert plan.tiles <= tqm._NUM_SMS // 2, (m, h, f)
                if m <= 8:
                    wf = tqm.wholef_plan(m, h, f)
                    per = -(-k_tiles // wf.splits)
                    assert wf.splits >= 1 and -(-k_tiles // per) == wf.splits, (m, h, f)
                    assert wf.k_tiles_per_split == per and 1 <= per <= 64, (m, h, f)
                    assert per >= min(2, k_tiles), (m, h, f)
                    assert wf.tiles == f // 128 and wf.splits <= 8, (m, h, f)
                    assert wf.splits == 1 or 2 * wf.tiles * wf.splits <= 3 * tqm._NUM_SMS, \
                        (m, h, f)


@pytest.mark.parametrize("m, h, f, block_m, splits, per", [
    (16, 1536, 4096, 16, 4, 6),       # gate / up at the 16-slot decode step
    (17, 1536, 4096, 64, 4, 6),       # the first 64-row m
    (64, 1536, 4096, 64, 4, 6),       # the last decode-width m
    (65, 1536, 4096, 128, 4, 6),      # the first prefill-width m
    (512, 1536, 4096, 128, 1, 24),    # gate / up at a 512-token chunk: no split
    (512, 4096, 1536, 128, 2, 32),    # down_proj at 512: 48 tiles, two slices
    (512, 1536, 768, 128, 5, 5),      # k / v at 512
    (16, 4096, 1536, 16, 8, 8),       # down_proj at 16: 8 slices at most
    (16, 1576, 768, 16, 7, 4),        # a partial last K tile
])
def test_tiled_plan_at_the_600m_shapes(m, h, f, block_m, splits, per):
    """The plans the 600m serve launches #11 on: one block per SM, H split
    (into at most 8 slices) only while tiles leave SMs idle."""
    plan = tqm.tiled_plan(m, h, f)
    assert (plan.block_m, plan.splits, plan.k_tiles_per_split) == (block_m, splits, per)
    assert plan.tiles * plan.splits <= 132


@pytest.mark.parametrize("h, f, splits, per", [
    (1536, 4096, 6, 4),       # gate / up: 32 column tiles, 192 blocks
    (1536, 1536, 8, 3),       # q / o
    (1536, 768, 8, 3),        # k / v: slices of three K tiles, not of 24 rows
    (4096, 1536, 8, 8),       # down
    (1576, 768, 7, 4),        # a partial last K tile
    (4096, 11008, 2, 32),     # 86 column tiles
    (28672, 8192, 7, 64),     # a slice of at most 64 K tiles
])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_wholef_plan_at_the_600m_shapes(m, h, f, splits, per):
    """The plans #12 runs the 600m model's denses on in ``generate_paged``
    (and two larger ones): one launch of about one and a half waves of
    blocks, at most 8 slices (one cluster a column tile), each of at least
    two and at most 64 K tiles; an H past 8 x 64 K tiles is refused."""
    plan = tqm.wholef_plan(m, h, f)
    assert (plan.splits, plan.k_tiles_per_split, plan.tiles) == (splits, per, f // 128)
    with pytest.raises(ValueError, match="H <= 32768"):
        tqm.wholef_plan(m, 32776, f)


def test_plain_versions_round_like_their_kernels():
    """#11 rounds the dequantized weight to bf16, #12 the scaled x: on the
    same operands the two differ, each by design."""
    rng = np.random.default_rng(5)
    _, tqt = _qt(rng, 256, 512)
    x = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32)).bfloat16()
    tiled = tqm.quantized_matmul_plain(x, tqt.data, tqt.scale, qblock=128, out_dtype=torch.float32)
    wholef = tqm.quantized_matmul_wholef_plain(x, tqt.data, tqt.scale, qblock=128,
                                               out_dtype=torch.float32)
    exact = x.float() @ tq.dequantize(tqt, torch.float32)
    assert not torch.equal(tiled, wholef)
    for out in (tiled, wholef):
        torch.testing.assert_close(out, exact, rtol=0, atol=2e-2 * exact.abs().max().item())


def test_wrappers_raise_off_the_cpu_and_check_operands():
    x = torch.empty(4, 256, dtype=torch.bfloat16, device="meta")
    codes = torch.empty(256, 512, dtype=torch.int8, device="meta")
    scales = torch.empty(4, 256, device="meta")
    for fn in (tqm.quantized_matmul_tiled, tqm.quantized_matmul_wholef):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x, codes, scales, qblock=128)
    xc = torch.zeros(4, 256, dtype=torch.bfloat16)
    cc = torch.zeros(256, 512, dtype=torch.int8)
    sc = torch.zeros(4, 256)
    with pytest.raises(TypeError, match="int8"):
        tqm._check_operands("k", xc, cc.float(), sc, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="do not match"):
        tqm._check_operands("k", xc, cc, sc[:2], 128, torch.bfloat16)
    with pytest.raises(ValueError, match="H % 8"):
        tqm._check_operands("k", xc[:, :252].contiguous(), cc[:252].contiguous(),
                            sc[:, :252].contiguous(), 128, torch.bfloat16)
    with pytest.raises(TypeError, match="writes"):
        tqm._check_operands("k", xc, cc, sc, 128, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        tqm._check_operands("k", xc.t().contiguous().t(), cc, sc, 128, torch.bfloat16)
