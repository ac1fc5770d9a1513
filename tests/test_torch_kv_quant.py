"""The port's quantized KV pages held against the JAX package's.

- ``paged_write_kv_quantized``: codes and scales **bitwise** equal over a
  sequence of writes (a chunk spanning pages, masked lanes, amax growth
  with rescale, an offset-0 reset of a recycled page), int8 and fp8;
- the fp8 cast itself equal to ``ml_dtypes``' bits;
- ``dequantize_kv_pages``, ``paged_gather_kv``, ``init_paged_cache``'s
  layout and the page accounting equal to JAX's;
- the quantized paged plain versions (decode and multitoken, int8 and fp8)
  against JAX's Pallas kernels in interpret mode, at the tolerances
  ``test_torch_paged_attention.py`` uses for the bf16 pages;
- the tiny f32 model's paged prefill + decode through quantized pages,
  port vs JAX, on both attention routes.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu.serving import paged_cache as jpc
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.ops import flash_attention as tfa
from accelerate_tpu_torch.serving import paged_cache as tpc

HKV, P, PAGE, D = 2, 6, 4, 16
JAX_DTYPE = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bits(pages):
    """Bit patterns of a JAX or torch page pool as numpy uint8."""
    if isinstance(pages, torch.Tensor):
        return pages.view(torch.uint8).numpy()
    return np.asarray(pages).view(np.uint8)


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    assert tfa.paged_decode_attention_quant.launches == 0
    assert tfa.paged_multitoken_attention_quant.launches == 0


def test_resolve_kv_dtype_and_pool_layout_equal_jax():
    for knob in (None, "", "bf16", "int8", "fp8"):
        assert tl.resolve_kv_dtype(knob) == jl.resolve_kv_dtype(knob)
    with pytest.raises(ValueError, match="kv_dtype"):
        tl.resolve_kv_dtype("int4")
    cfg, jcfg = tl.LlamaConfig.tiny(), jl.LlamaConfig.tiny()
    for kv_dtype in (None, "int8", "fp8"):
        got = tl.init_paged_cache(cfg, 8, 4, 2, 4, kv_dtype=kv_dtype, device="cpu")
        want = jl.init_paged_cache(jcfg, 8, 4, 2, 4, kv_dtype=kv_dtype)
        assert set(got) == set(want)
        assert set(got["layers"][0]) == set(want["layers"][0])
        for key, arr in got["layers"][0].items():
            ref = want["layers"][0][key]
            assert tuple(arr.shape) == ref.shape, key
            assert str(arr.dtype).split(".")[-1] == str(ref.dtype), key


def test_page_accounting_equals_jax():
    cfg, jcfg = tl.LlamaConfig.tiny(), jl.LlamaConfig.tiny()
    for kv_dtype in ("", "int8", "fp8"):
        for page in (4, 16, 64):
            assert (tpc.kv_page_bytes(cfg, page, 2, kv_dtype)
                    == jpc.kv_page_bytes(jcfg, page, 2, kv_dtype))
        got = tpc.kv_pool_accounting(cfg, 64, 16, 2, kv_dtype)
        want = jpc.kv_pool_accounting(jcfg, 64, 16, 2, kv_dtype)
        for key in ("page_size_tokens", "num_pages", "bytes_per_page", "pool_bytes",
                    "pool_gib", "tokens_capacity", "kv_dtype", "capacity_vs_bf16"):
            assert got.get(key) == want.get(key), (kv_dtype, key)


def test_fp8_cast_equals_ml_dtypes_bits():
    """f32 -> e4m3 rounds to nearest even, as ``ml_dtypes`` and XLA do:
    exact ties, subnormals, the +-448 ends and signed zeros included."""
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    grid = grid[np.isfinite(grid) & (np.abs(grid) <= 448)]
    ordered = np.unique(grid)
    ties = (ordered[:-1] + ordered[1:]) / 2                 # exactly halfway
    rng = np.random.default_rng(0)
    vals = np.concatenate([grid, ties, np.nextafter(ties, np.inf), np.nextafter(ties, -np.inf),
                           rng.uniform(-448, 448, 4000), rng.normal(size=4000) * 1e-2,
                           np.asarray([0.0, -0.0, 448.0, -448.0])]).astype(np.float32)
    want = vals.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = _t(vals).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn)).view(np.uint8),
                                  want)


def _write_sequence(rng):
    """(values [B, T, Hkv, D] f32, page ids [B, T], offsets [B, T], write
    mask [B, T]) for each call: a chunk spanning two pages with padded
    lanes; a decode step whose larger rows grow two pages' amax (rescale)
    beside a dead slot; a chunk growing its amax row by row inside one
    page; the recycling of page 2 (offset 0, small values)."""
    calls = []

    def call(ids, offs, mask, scale):
        ids, offs, mask = (np.asarray(a)[None] if np.ndim(a) == 1 else np.asarray(a)
                           for a in (ids, offs, mask))
        scale = np.asarray(scale, np.float64).reshape(ids.shape)
        vals = rng.normal(size=ids.shape + (HKV, D)) * scale[..., None, None]
        calls.append((vals.astype(np.float32), ids.astype(np.int32), offs.astype(np.int32),
                      mask.astype(bool)))

    call([2, 2, 2, 2, 5, 5, 5, 5], [0, 1, 2, 3, 0, 1, 2, 3],
         [True] * 6 + [False] * 2, np.ones(8))
    call([[5], [4], [3]], [[2], [0], [1]], [[True], [True], [False]], np.asarray([[4.0], [0.5], [9.0]]))
    call([4, 4, 4], [1, 2, 3], [True] * 3, np.asarray([0.25, 1.0, 6.0]))
    call([2, 2], [0, 1], [True, True], np.asarray([0.01, 0.02]))
    return calls


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_paged_write_quantized_bitwise_equal_jax(kv_dtype):
    rng = np.random.default_rng(3)
    j_pages = jnp.zeros((HKV, P, PAGE, D), JAX_DTYPE[kv_dtype])
    j_scales = jnp.zeros((HKV, P), jnp.float32)
    t_pages = torch.zeros(HKV, P, PAGE, D, dtype=tl.KV_QUANT_DTYPES[kv_dtype])
    t_scales = torch.zeros(HKV, P)
    # stale codes in every page, as a recycled pool holds them
    stale = rng.normal(size=(HKV, P, PAGE, D)) * 50
    stale = np.clip(np.round(stale) if kv_dtype == "int8" else stale, -127, 127)
    j_pages = jnp.asarray(stale.astype(np.float32)).astype(JAX_DTYPE[kv_dtype])
    t_pages.view(torch.uint8).copy_(_t(_bits(j_pages)))
    j_write = jax.jit(jl.paged_write_kv_quantized, static_argnums=5)
    for step, (vals, ids, offs, mask) in enumerate(_write_sequence(rng)):
        j_ids = np.where(mask, ids, P)                        # JAX: masked lanes drop
        j_pages, j_scales = j_write(
            j_pages, j_scales, jnp.asarray(vals), jnp.asarray(j_ids), jnp.asarray(offs), kv_dtype)
        lanes = _t(mask.reshape(-1)).nonzero().squeeze(1)
        out = tl.paged_write_kv_quantized(t_pages, t_scales, _t(vals), _t(ids), _t(offs),
                                          kv_dtype, lanes)
        assert out[0] is t_pages and out[1] is t_scales       # in place
        np.testing.assert_array_equal(t_scales.numpy(), np.asarray(j_scales), err_msg=f"call {step}")
        np.testing.assert_array_equal(_bits(t_pages), _bits(j_pages), err_msg=f"call {step}")
    assert (t_scales[:, 2] < 0.1).all()                      # page 2 reopened small
    want = np.asarray(jl.dequantize_kv_pages(j_pages, j_scales, kv_dtype, jnp.float32))
    got = tl.dequantize_kv_pages(t_pages, t_scales, kv_dtype, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    bt = np.asarray([[2, 5], [4, 3]], np.int32)
    jk, jv, jpos = jl.paged_gather_kv(j_pages, j_pages, jnp.asarray(bt), j_scales, j_scales,
                                      kv_dtype, jnp.float32)
    tk, tv, tpos = tl.paged_gather_kv(t_pages, t_pages, _t(bt), t_scales, t_scales,
                                      torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def _quant_pools(rng, kv_dtype, hkv=2, num_pages=16, page=8, d=32):
    """Pages written the way the engine writes them, so the scales are
    real running amaxes: every page filled through the port's own
    quantized write."""
    pools = []
    for _ in range(2):
        pages = torch.zeros(hkv, num_pages, page, d, dtype=tl.KV_QUANT_DTYPES[kv_dtype])
        scales = torch.zeros(hkv, num_pages)
        vals = _t((rng.normal(size=(num_pages, page, hkv, d))
                   * rng.uniform(0.2, 3.0, (num_pages, 1, hkv, 1))).astype(np.float32))
        ids = torch.arange(num_pages)[:, None].expand(num_pages, page)
        offs = torch.arange(page)[None].expand(num_pages, page)
        tl.paged_write_kv_quantized(pages, scales, vals, ids, offs, kv_dtype)
        pools += [pages, scales]
    return pools


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("h, pos", [(4, [0, 5, 17, 31]), (8, [3, 15, 24, 30])])
def test_quant_plain_decode_matches_pallas(kv_dtype, h, pos):
    rng = np.random.default_rng(h)
    kp, ks, vp, vs = _quant_pools(rng, kv_dtype)
    bt = rng.permutation(16)[:16].reshape(4, 4).astype(np.int32)
    q = rng.normal(size=(4, h, 32)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    ref = jfa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(_bits(kp)).view(JAX_DTYPE[kv_dtype]),
        jnp.asarray(_bits(vp)).view(JAX_DTYPE[kv_dtype]), jnp.asarray(bt), jnp.asarray(pos),
        k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy()))
    got = tfa.paged_decode_attention(_t(q), kp, vp, _t(bt), _t(pos), k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("width, pos0", [(4, [0, 5, 17, 28]), (12, [0, 8, 3, 20])])
def test_quant_plain_multitoken_matches_pallas(kv_dtype, width, pos0):
    rng = np.random.default_rng(width)
    kp, ks, vp, vs = _quant_pools(rng, kv_dtype)
    bt = rng.permutation(16).reshape(4, 4).astype(np.int32)
    q = rng.normal(size=(4, width, 4, 32)).astype(np.float32)
    pos = np.asarray(pos0, np.int32)[:, None] + np.arange(width, dtype=np.int32)[None]
    ref = jfa.paged_multitoken_attention(
        jnp.asarray(q), jnp.asarray(_bits(kp)).view(JAX_DTYPE[kv_dtype]),
        jnp.asarray(_bits(vp)).view(JAX_DTYPE[kv_dtype]), jnp.asarray(bt), jnp.asarray(pos),
        k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy()))
    got = tfa.paged_multitoken_attention(_t(q), kp, vp, _t(bt), _t(pos), k_scales=ks,
                                         v_scales=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_quant_wrappers_dispatch_and_check():
    rng = np.random.default_rng(9)
    kp, ks, vp, vs = _quant_pools(rng, "int8")
    bt = _t(rng.permutation(16).reshape(4, 4).astype(np.int32))
    q = _t(rng.normal(size=(4, 4, 32)).astype(np.float32))
    pos = _t(np.asarray([1, 9, 14, 27], np.int32))
    via_public = tfa.paged_decode_attention(q, kp, vp, bt, pos, k_scales=ks, v_scales=vs)
    direct = tfa.paged_decode_attention_quant(q, kp, vp, bt, pos, k_scales=ks, v_scales=vs)
    torch.testing.assert_close(via_public, direct, rtol=0, atol=0)
    with pytest.raises(ValueError, match="both"):
        tfa.paged_decode_attention(q, kp, vp, bt, pos, k_scales=ks)
    qb = q.bfloat16()
    with pytest.raises(TypeError, match="int8"):
        tfa._check_kernel_operands("k", qb, kp.float().bfloat16(), vp, bt, pos, ks, vs)
    with pytest.raises(ValueError, match="float32"):
        tfa._check_kernel_operands("k", qb, kp, vp, bt, pos, ks[:1].contiguous(), vs)
    with pytest.raises(ValueError, match="int8 or float8"):
        tfa._kv_qmax_for(torch.zeros(2, dtype=torch.bfloat16))


@pytest.mark.parametrize("width, heads, kv_heads, page, d, kv_tiles, row_tiles", [
    (512, 16, 8, 64, 96, 32, 16),    # the serve's chunk: a page a tile
    (250, 16, 8, 16, 96, 8, 8),      # generate_paged: four pages a tile
    (77, 8, 8, 64, 128, 32, 2),      # group 1
    (33, 16, 2, 16, 64, 8, 5),       # group 8
    (16, 16, 4, 128, 96, 64, 1),     # group 4, one row tile; pages of 128: two tiles a page
])
def test_prefill_quant_plan_tiles(width, heads, kv_heads, page, d, kv_tiles, row_tiles):
    """Kernels #6 / #7's plan: 64 token-major query rows per block, kv
    tiles of 64 tokens whatever the page size, so a 32-entry table spans
    32 * page / 64 of them."""
    for quantized in (True, False):
        plan = tfa.prefill_plan(width, heads, kv_heads, page, d, 32, quantized=quantized)
        assert (plan["rows"], plan["kv_tile"]) == (64, 64)
        assert plan["kv_tiles"] == kv_tiles == -(-32 * page // 64)
        assert plan["row_tiles"] == row_tiles == -(-width * (heads // kv_heads) // 64)
        assert plan["shared_bytes"] <= 232448


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("page", [24, 48, 100, 8, 32, 128])
def test_prefill_plan_takes_page_size(page, quantized):
    """Every positive page size: a token is found through its own
    block-table entry, so a tile may hold several pages, part of one or
    exactly one."""
    plan = tfa.prefill_plan(16, 16, 8, page, 96, 32, quantized=quantized)
    assert plan["kv_tiles"] == -(-32 * page // 64)
    assert plan["shared_bytes"] <= 232448


@pytest.mark.parametrize("page, d, n, quantized, match", [
    (0, 96, 32, True, "page size"), (16, 80, 32, True, "head dims"),
    (64, 256, 32, True, "head dims"), (16, 128, 20000, True, "shared memory"),
    (0, 96, 32, False, "page size"), (16, 80, 32, False, "head dims"),
    (64, 256, 32, False, "head dims"), (16, 128, 40000, False, "shared memory"),
])
def test_prefill_quant_plan_refuses_what_the_kernel_does_not_take(page, d, n, quantized, match):
    with pytest.raises(ValueError, match=match):
        tfa.prefill_plan(16, 16, 8, page, d, n, quantized=quantized)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("page", [8, 32, 128])
def test_quant_plain_multitoken_matches_pallas_at_page_sizes(kv_dtype, page):
    """The quantized multitoken route against JAX's Pallas kernel (interpret
    mode) over pages of 8, 32 and 128: windows mid-page, one that starts at
    0 and one that lies partly before 0."""
    rng = np.random.default_rng(page)
    n = max(2, 64 // page)
    kp, ks, vp, vs = _quant_pools(rng, kv_dtype, num_pages=4 * n, page=page)
    bt = rng.permutation(4 * n).reshape(4, n).astype(np.int32)
    width = 6
    pos0 = np.asarray([0, page - 3, page * n - width, -3], np.int32)
    q = rng.normal(size=(4, width, 4, 32)).astype(np.float32)
    pos = pos0[:, None] + np.arange(width, dtype=np.int32)[None]
    ref = jfa.paged_multitoken_attention(
        jnp.asarray(q), jnp.asarray(_bits(kp)).view(JAX_DTYPE[kv_dtype]),
        jnp.asarray(_bits(vp)).view(JAX_DTYPE[kv_dtype]), jnp.asarray(bt), jnp.asarray(pos),
        k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy()))
    got = tfa.paged_multitoken_attention(_t(q), kp, vp, _t(bt), _t(pos), k_scales=ks,
                                         v_scales=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def tiny_params():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    return jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


@pytest.mark.parametrize("kv_dtype, attn", [("int8", "native"), ("fp8", "flash")])
def test_paged_prefill_then_decode_through_quantized_pages_matches_jax(tiny_params, kv_dtype,
                                                                       attn):
    """Five tokens prefilled, then three decode steps, through int8 / fp8
    pages: logits within 1e-4 relative of JAX's, scales within 1e-5."""
    params = tiny_params
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32, attn_implementation=attn))
    tmodel = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32, attn_implementation=attn),
                                 device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    ids = np.asarray([[3, 17, 99, 4, 250, 7, 12, 63]], np.int32)
    bt = np.asarray([[6, 1, 4, 3]], np.int32)
    keep = ("k_pages", "v_pages", "k_scales", "v_scales")
    jc = jl.init_paged_cache(jmodel.config, 8, 4, 1, 4, kv_dtype=kv_dtype)
    jlayers = [{**{k: l[k] for k in keep}, "block_tables": jnp.asarray(bt)} for l in jc["layers"]]
    tc = tl.init_paged_cache(tmodel.config, 8, 4, 1, 4, kv_dtype=kv_dtype, device="cpu")
    tlayers = [{**l, "block_tables": _t(bt)} for l in tc["layers"]]
    japply = jax.jit(jmodel.apply)
    for a, b in [(0, 5), (5, 6), (6, 7), (7, 8)]:
        jlg, jlayers = japply(params, jnp.asarray(ids[:, a:b]),
                              positions=jnp.arange(a, b)[None], cache=jlayers,
                              cache_write_mask=jnp.ones((1, b - a), bool))
        jlayers = [{**l, "block_tables": jnp.asarray(bt)} for l in jlayers]
        with torch.no_grad():
            tlg, tlayers = tmodel(_t(ids[:, a:b]).long(), positions=torch.arange(a, b)[None],
                                  cache=tlayers, cache_write_mask=torch.ones(1, b - a, dtype=torch.bool))
        want = np.asarray(jlg)
        np.testing.assert_allclose(tlg.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"tokens {a}:{b}")
    for jl_, tl_ in zip(jlayers, tlayers):
        assert tl_["k_pages"].dtype == tl.KV_QUANT_DTYPES[kv_dtype]
        np.testing.assert_allclose(tl_["k_scales"].numpy(), np.asarray(jl_["k_scales"]), rtol=1e-5)
