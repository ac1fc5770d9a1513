"""The port's page allocator (``accelerate_tpu_torch/serving/paged_cache.py``)
held to the JAX package's, integer for integer.

The JAX functions drop masked lanes through out-of-bounds scatter ids; the
port filters them with the mask.  On the same seeded inputs, with masked
lanes present, block tables, free stacks, free tops and lengths must come
out exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from accelerate_tpu.serving import paged_cache as jpc
from accelerate_tpu_torch.models.llama import LlamaConfig
from accelerate_tpu_torch.serving import paged_cache as tpc


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(rng, num_pages, n_slots, n_cols, top):
    """A free stack in a shuffled order (as after some traffic) and a block
    table holding stale ids."""
    stack = rng.permutation(num_pages).astype(np.int32)
    bt = rng.integers(0, num_pages, (n_slots, n_cols)).astype(np.int32)
    return bt, stack, np.int32(top)


@pytest.mark.parametrize("seed", range(6))
def test_allocate_equals_jax_on_random_masks(seed):
    rng = np.random.default_rng(seed)
    num_pages, n_slots, n_cols = 32, 6, 5
    bt, stack, top = _state(rng, num_pages, n_slots, n_cols, top=24)
    k = 8
    # distinct (slot, logical page) targets, so the scatter has one writer
    cells = rng.permutation(n_slots * n_cols)[:k]
    slots = (cells // n_cols).astype(np.int32)
    logical = (cells % n_cols).astype(np.int32)
    need = rng.random(k) < 0.5
    need[rng.integers(0, k)] = False          # at least one masked lane
    j_bt, j_top = jpc.allocate(jnp.asarray(bt), jnp.asarray(stack), jnp.asarray(top),
                               jnp.asarray(slots), jnp.asarray(logical), jnp.asarray(need))
    t_bt, t_top = tpc.allocate(_t(bt.copy()), _t(stack), torch.tensor(top),
                               _t(slots), _t(logical), _t(need))
    np.testing.assert_array_equal(t_bt.numpy(), np.asarray(j_bt))
    assert int(t_top) == int(j_top) == top - need.sum()


@pytest.mark.parametrize("seed", range(6))
def test_release_equals_jax_on_random_masks(seed):
    rng = np.random.default_rng(100 + seed)
    num_pages, n_slots, n_cols, page = 40, 6, 5, 4
    bt, stack, top = _state(rng, num_pages, n_slots, n_cols, top=10)
    seq_lens = rng.integers(0, n_cols * page + 1, n_slots).astype(np.int32)
    mask = rng.random(n_slots) < 0.5
    j = jpc.release(jnp.asarray(bt), jnp.asarray(seq_lens), jnp.asarray(stack),
                    jnp.asarray(top), jnp.asarray(mask), page)
    t = tpc.release(_t(bt), _t(seq_lens.copy()), _t(stack.copy()), torch.tensor(top),
                    _t(mask), page)
    for got, want in zip(t, j):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_push_pages_equals_jax_on_random_masks(seed):
    rng = np.random.default_rng(200 + seed)
    num_pages = 24
    stack = rng.permutation(num_pages).astype(np.int32)
    top = np.int32(rng.integers(0, 12))
    pages = rng.integers(0, num_pages, 12).astype(np.int32)
    mask = rng.random(12) < 0.6
    j_stack, j_top = jpc.push_pages(jnp.asarray(stack), jnp.asarray(top),
                                    jnp.asarray(pages), jnp.asarray(mask))
    t_stack, t_top = tpc.push_pages(_t(stack.copy()), torch.tensor(top), _t(pages), _t(mask))
    np.testing.assert_array_equal(t_stack.numpy(), np.asarray(j_stack))
    assert int(t_top) == int(j_top)


def test_allocate_release_sequence_equals_jax():
    """A run of decode-like allocations and releases keeps the two pools'
    integers identical throughout."""
    rng = np.random.default_rng(7)
    num_pages, n_slots, n_cols, page = 20, 4, 5, 2
    j = dict(bt=jnp.zeros((n_slots, n_cols), jnp.int32),
             stack=jnp.arange(num_pages, dtype=jnp.int32),
             top=jnp.asarray(num_pages, jnp.int32),
             lens=jnp.zeros((n_slots,), jnp.int32))
    t = dict(bt=torch.zeros(n_slots, n_cols, dtype=torch.int32),
             stack=torch.arange(num_pages, dtype=torch.int32),
             top=torch.tensor(num_pages, dtype=torch.int32),
             lens=torch.zeros(n_slots, dtype=torch.int32))
    lens = np.zeros(n_slots, np.int32)
    for step in range(30):
        active = rng.random(n_slots) < 0.7
        active &= lens < n_cols * page
        need = active & (lens % page == 0)
        if need.sum() > int(t["top"]):
            active[:] = need[:] = False
        j["bt"], j["top"] = jpc.allocate(j["bt"], j["stack"], j["top"],
                                         jnp.arange(n_slots), jnp.asarray(lens // page),
                                         jnp.asarray(need))
        t["bt"], t["top"] = tpc.allocate(t["bt"], t["stack"], t["top"],
                                         torch.arange(n_slots), _t(lens // page), _t(need))
        lens = lens + active
        j["lens"], t["lens"] = jnp.asarray(lens), _t(lens.copy())
        done = (lens >= n_cols * page) | (rng.random(n_slots) < 0.1)
        j["lens"], j["stack"], j["top"] = jpc.release(j["bt"], j["lens"], j["stack"],
                                                      j["top"], jnp.asarray(done), page)
        t["lens"], t["stack"], t["top"] = tpc.release(t["bt"], t["lens"], t["stack"],
                                                      t["top"], _t(done), page)
        lens = t["lens"].numpy().copy()
        for key in ("bt", "stack", "top", "lens"):
            np.testing.assert_array_equal(np.asarray(t[key]), np.asarray(j[key]),
                                          err_msg=f"{key} at step {step}")


def test_pages_for_and_pool_accounting_equal_jax():
    for tokens in (0, 1, 4, 5, 8, 63, 64, 65):
        assert int(tpc.pages_for(tokens, 4)) == int(jpc.pages_for(tokens, 4))
        assert int(tpc.pages_for(torch.tensor(tokens), 64)) == int(jpc.pages_for(tokens, 64))
    cfg, jcfg = LlamaConfig.tiny(), JaxLlamaConfig.tiny()
    got = tpc.kv_pool_accounting(cfg, num_pages=64, page_size=16)
    want = jpc.kv_pool_accounting(jcfg, num_pages=64, page_size=16)
    for key in ("page_size_tokens", "num_pages", "bytes_per_page", "pool_bytes",
                "pool_gib", "tokens_capacity"):
        assert got[key] == want[key], key
    assert tpc.kv_page_bytes(cfg, 64) == jpc.kv_page_bytes(jcfg, 64)
    with pytest.raises(NotImplementedError):
        tpc.kv_page_bytes(cfg, 64, kv_dtype="int8")
