"""The port's paged attention (``accelerate_tpu_torch/ops/flash_attention.py``)
held against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
in interpret mode, as the JAX package's own tests run them.  The same
seeded numpy inputs go to both.  The CUDA kernels themselves are held
against the plain versions on the card by ``test_torch_cuda_kernels.py``
and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu_torch.ops import flash_attention as tfa

# the geometry of tests/test_serving.py's paged-kernel tests
HKV, NUM_PAGES, PAGE, D, SLOTS, N, H = 2, 16, 8, 32, 4, 4, 4


def _pools(rng, hkv=HKV, num_pages=NUM_PAGES, page=PAGE, d=D):
    kp = rng.normal(size=(hkv, num_pages, page, d)).astype(np.float32)
    vp = rng.normal(size=(hkv, num_pages, page, d)).astype(np.float32)
    return kp, vp


def _table(rng, slots=SLOTS, n=N, num_pages=NUM_PAGES):
    return rng.permutation(num_pages)[: slots * n].reshape(slots, n).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield


@pytest.mark.parametrize("h, pos", [
    (4, [0, 5, 17, 31]),        # GQA group 2; 31 is the table's last token
    (2, [7, 8, 9, 16]),         # group 1; page edges
    (8, [3, 15, 24, 30]),       # group 4
])
def test_plain_decode_matches_pallas_decode(h, pos):
    rng = np.random.default_rng(0)
    kp, vp = _pools(rng)
    bt = _table(rng)
    q = rng.normal(size=(SLOTS, h, D)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    ref = jfa.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                     jnp.asarray(bt), jnp.asarray(pos))
    got = tfa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    assert got.dtype == torch.float32 and got.shape == (SLOTS, h, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    assert tfa.paged_decode_attention.launches == 0


def test_plain_decode_dead_slot_returns_zeros_like_pallas():
    """A slot whose position lies before 0 visits no page: zeros, as the
    Pallas kernel's page skip gives."""
    rng = np.random.default_rng(1)
    kp, vp = _pools(rng)
    bt = _table(rng)
    q = rng.normal(size=(SLOTS, H, D)).astype(np.float32)
    pos = np.asarray([-1, 3, 12, 20], np.int32)
    ref = jfa.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                     jnp.asarray(bt), jnp.asarray(pos))
    got = tfa.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    assert not got[0].any()


@pytest.mark.parametrize("width, pos0", [
    (4, [0, 5, 17, 28]),        # test_serving.py's verify window; 28+3 = last token
    (4, [8, 16, 1, 24]),        # windows opening on page boundaries
    (12, [0, 8, 3, 20]),        # a window spanning three pages
])
def test_plain_multitoken_matches_pallas_multitoken(width, pos0):
    rng = np.random.default_rng(2)
    kp, vp = _pools(rng)
    bt = _table(rng)
    q = rng.normal(size=(SLOTS, width, H, D)).astype(np.float32)
    pos = (np.asarray(pos0, np.int32)[:, None] + np.arange(width, dtype=np.int32)[None])
    ref = jfa.paged_multitoken_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                         jnp.asarray(bt), jnp.asarray(pos))
    got = tfa.paged_multitoken_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    assert got.shape == (SLOTS, width, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert tfa.paged_multitoken_attention.launches == 0


def test_plain_multitoken_prefill_chunk_matches_pallas():
    """The chunked-prefill shape ``[1, C]``: one slot, a bucket-padded
    chunk whose padded rows run past the block table."""
    rng = np.random.default_rng(3)
    kp, vp = _pools(rng)
    bt = _table(rng, slots=1)
    width, pos0 = 16, 24
    q = rng.normal(size=(1, width, H, D)).astype(np.float32)
    pos = (pos0 + np.arange(width, dtype=np.int32))[None]
    ref = jfa.paged_multitoken_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                         jnp.asarray(bt), jnp.asarray(pos))
    got = tfa.paged_multitoken_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_plain_decode_is_multitoken_at_width_one():
    rng = np.random.default_rng(4)
    kp, vp = _pools(rng)
    bt = _table(rng)
    q = _t(rng.normal(size=(SLOTS, H, D)).astype(np.float32))
    pos = _t(np.asarray([2, 9, 14, 27], np.int32))
    dec = tfa.paged_decode_attention(q, _t(kp), _t(vp), _t(bt), pos)
    multi = tfa.paged_multitoken_attention(q[:, None].contiguous(), _t(kp), _t(vp),
                                           _t(bt), pos[:, None].contiguous())[:, 0]
    torch.testing.assert_close(dec, multi, rtol=0, atol=0)


def test_plain_bf16_operands_return_bf16():
    """The serving path's working type: bf16 in, f32 inside, bf16 out."""
    rng = np.random.default_rng(5)
    kp, vp = _pools(rng)
    bt = _table(rng)
    q = rng.normal(size=(SLOTS, H, D)).astype(np.float32)
    pos = _t(np.asarray([0, 5, 17, 31], np.int32))
    got = tfa.paged_decode_attention(_t(q).bfloat16(), _t(kp).bfloat16(),
                                     _t(vp).bfloat16(), _t(bt), pos)
    assert got.dtype == torch.bfloat16
    ref = tfa.paged_decode_attention(_t(q).bfloat16().float(), _t(kp).bfloat16().float(),
                                     _t(vp).bfloat16().float(), _t(bt), pos)
    # one bf16 rounding of an O(1) output
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=1e-2)


def test_wrappers_raise_on_a_device_without_a_kernel():
    """Only the CPU runs the plain version; any other non-CUDA device
    raises instead of falling back."""
    q = torch.empty(SLOTS, H, D, device="meta")
    kp = torch.empty(HKV, NUM_PAGES, PAGE, D, device="meta")
    bt = torch.empty(SLOTS, N, dtype=torch.int32, device="meta")
    pos = torch.empty(SLOTS, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.paged_decode_attention(q, kp, kp, bt, pos)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.paged_multitoken_attention(q[:, None], kp, kp, bt, pos[:, None])
    assert tfa.paged_decode_attention.launches == 0
    assert tfa.paged_multitoken_attention.launches == 0


@pytest.mark.parametrize("bad, err", [
    ("dtype", TypeError),
    ("head_dim", ValueError),
    ("contiguity", ValueError),
    ("table_dtype", TypeError),
])
def test_kernel_operand_checks_raise(bad, err):
    """What the CUDA kernel does not take is refused before launch."""
    d = 48 if bad == "head_dim" else 64
    dtype = torch.float32 if bad == "dtype" else torch.bfloat16
    q = torch.zeros(SLOTS, H, d, dtype=dtype)
    kp = torch.zeros(HKV, NUM_PAGES, PAGE, d, dtype=torch.bfloat16)
    bt = torch.zeros(SLOTS, N, dtype=torch.int64 if bad == "table_dtype" else torch.int32)
    pos = torch.zeros(SLOTS, dtype=torch.int32)
    if bad == "contiguity":
        q = torch.zeros(SLOTS, d, H, dtype=dtype).transpose(1, 2)
    with pytest.raises(err):
        tfa._check_kernel_operands("paged_decode_attention", q, kp, kp, bt, pos)


def test_geometry_mismatch_raises():
    q = torch.zeros(SLOTS, 3, D)
    kp = torch.zeros(HKV, NUM_PAGES, PAGE, D)
    with pytest.raises(ValueError, match="not divisible"):
        tfa.paged_decode_attention(q, kp, kp, torch.zeros(SLOTS, N, dtype=torch.int32),
                                   torch.zeros(SLOTS, dtype=torch.int32))
