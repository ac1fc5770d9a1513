"""The split plan of the paged decode kernels #4 / #5
(``accelerate_tpu_torch/ops/flash_attention.py:decode_split_plan``, the
launch plan of ``csrc/paged_decode.cu``) and the algorithm it launches,
held against the JAX package's Pallas decode kernel.

``csrc/paged_decode.cu`` splits each slot's page loop into chunks of the
plan's span, computes each chunk's partial softmax (m, l, acc) and merges
the chunks in chunk order.  The CUDA kernel runs only on the card
(``tests/test_torch_cuda_kernels.py``); here a plain torch helper does the
same split and merge on the CPU, through a workspace and counters of the
plan's shapes indexed as the kernel indexes them, and its result must
equal the plain version and JAX's ``paged_decode_attention`` (in interpret
mode, as the JAX package's own tests run it) on the same seeded numpy
inputs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu_torch import LlamaConfig
from accelerate_tpu_torch.ops import flash_attention as tfa

# LlamaConfig.tiny()'s attention: 4 q heads over 2 kv heads, head dim 16
TINY = LlamaConfig.tiny()
H, HKV = TINY.num_attention_heads, TINY.num_key_value_heads
D = TINY.hidden_size // H


@pytest.mark.parametrize("page, n, span, chunks", [
    (1, 2048, 256, 8),          # 256 pages a chunk
    (16, 128, 16, 8),           # generate_paged's pages
    (64, 32, 4, 8),             # the 600m serve's table
    (128, 16, 2, 8),
    (16, 20, 16, 2),            # a table that ends mid-chunk
    (64, 3, 4, 1),              # a table shorter than one chunk
])
def test_decode_split_plan_spans_and_workspace(page, n, span, chunks):
    plan = tfa.decode_split_plan(16, 16, 8, 96, page, n)
    assert plan["span"] == span and plan["chunks"] == chunks
    assert plan["chunk_tokens"] == span * page == max(page, 256)
    assert plan["rows"] == 2 and plan["row_tiles"] == 1
    assert plan["workspace"] == (16, 8, chunks, 2, 96 + 2)
    assert plan["counters"] == 16 * 8


@pytest.mark.parametrize("heads, kv_heads, rows, row_tiles", [
    (8, 8, 2, 1), (16, 8, 2, 1), (12, 4, 4, 1), (16, 4, 4, 1), (24, 4, 8, 1),
    (64, 8, 8, 1), (32, 2, 8, 2), (24, 2, 8, 2),
])
def test_decode_split_plan_row_tiles(heads, kv_heads, rows, row_tiles):
    """A block holds the GQA group rounded up to 2, 4 or 8 rows; groups
    above 8 take several tiles of 8."""
    plan = tfa.decode_split_plan(3, heads, kv_heads, 64, 16, 40)
    assert (plan["rows"], plan["row_tiles"]) == (rows, row_tiles)
    assert plan["workspace"] == (3, kv_heads * row_tiles, 3, rows, 64 + 2)
    assert plan["counters"] == 3 * kv_heads * row_tiles


def _slot_chunks(pos, plan, page, n):
    """The chunks a slot at ``pos`` uses: its live keys over the span."""
    live = 0 if pos < 0 else min(pos + 1, n * page)
    return -(-live // plan["chunk_tokens"])


@pytest.mark.parametrize("page", [1, 16, 64, 128])
def test_a_slots_chunks_depend_on_its_position_only(page):
    """The split does not depend on the batch: the same span and chunk count
    for one slot and for 64, and a slot's chunks fixed by its position and
    the page size."""
    n = 4096 // page
    alone, batch = (tfa.decode_split_plan(s, 16, 8, 96, page, n) for s in (1, 64))
    for key in ("span", "chunk_tokens", "chunks", "rows", "row_tiles"):
        assert alone[key] == batch[key]
    assert alone["workspace"][1:] == batch["workspace"][1:]
    ct = alone["chunk_tokens"]
    assert [_slot_chunks(p, alone, page, n) for p in (-1, 0, ct - 1, ct, 4095, 9000)] == \
        [0, 1, 1, 2, alone["chunks"], alone["chunks"]]


@pytest.mark.parametrize("bad", [dict(page=0), dict(n=0), dict(heads=6, kv_heads=4)])
def test_decode_split_plan_refuses(bad):
    args = dict(slots=2, heads=4, kv_heads=2, head_dim=64, page=16, n=8) | bad
    with pytest.raises(ValueError):
        tfa.decode_split_plan(args["slots"], args["heads"], args["kv_heads"], args["head_dim"],
                              args["page"], args["n"])


def split_decode(q, k_pages, v_pages, block_tables, positions, plan, *, k_scales=None,
                 v_scales=None, qmax=1.0):
    """What ``csrc/paged_decode.cu`` computes, in f32 torch, in the buffers
    the plan sizes and indexed as the kernel indexes them: block (chunk c,
    kv head x row tile y, slot s) writes its rows' partial (acc[D], m, l)
    to ``work[s, y, c, row]`` (for codes the page scales taken out of the
    products, as the kernel takes them) and counts itself on
    ``counters[s * Y + y]``; the block that brings the count to the slot's
    chunk count merges the chunks in chunk order and sets the counter back
    to 0.  A slot with one chunk writes its output directly, one with no
    live key gives zeros.  Returns the output and the counters."""
    s_slots, h, d = q.shape
    hkv, _, page, _ = k_pages.shape
    group = h // hkv
    n = block_tables.shape[1]
    sm_scale = 1.0 / math.sqrt(d)
    ct, rows = plan["chunk_tokens"], plan["rows"]
    work = torch.full(plan["workspace"], math.nan)          # torch.empty in the wrapper
    counters = torch.zeros(plan["counters"], dtype=torch.int32)
    y_count = plan["workspace"][1]
    out = torch.zeros(s_slots, h, d)
    for s in range(s_slots):
        chunks = _slot_chunks(int(positions[s]), plan, page, n)
        live = min(int(positions[s]) + 1, n * page)
        for y in range(hkv * plan["row_tiles"]):
            kh, r0 = y // plan["row_tiles"], (y % plan["row_tiles"]) * rows
            heads = slice(kh * group + r0, kh * group + min(r0 + rows, group))
            nrows = heads.stop - heads.start
            qg = q[s, heads].float()                                         # [rows, D]
            for c in range(chunks):
                keys = torch.arange(c * ct, min((c + 1) * ct, live))
                pids = block_tables[s, keys // page].long()
                k = k_pages[kh, pids, keys % page].float()                     # [K, D]
                v = v_pages[kh, pids, keys % page].float()
                k_scale = v_scale = torch.ones(len(keys))
                if k_scales is not None:
                    k_scale, v_scale = k_scales[kh, pids] / qmax, v_scales[kh, pids] / qmax
                scores = (qg @ k.T) * (k_scale * sm_scale)                   # [rows, K]
                m = scores.amax(dim=1, keepdim=True)
                p = torch.exp(scores - m)
                l, acc = p.sum(dim=1, keepdim=True), (p * v_scale) @ v
                if chunks == 1:
                    out[s, heads] = acc / l
                    continue
                work[s, y, c, :nrows] = torch.cat([acc, m, l], dim=1)
                counters[s * y_count + y] += 1
                if counters[s * y_count + y] < chunks:
                    continue
                parts = work[s, y, :chunks, :nrows]                          # chunk order
                big_m, acc, l = parts[0, :, d:d + 1], parts[0, :, :d], parts[0, :, d + 1:]
                for part in parts[1:]:
                    m2 = torch.maximum(big_m, part[:, d:d + 1])
                    e_old, e_new = torch.exp(big_m - m2), torch.exp(part[:, d:d + 1] - m2)
                    acc = acc * e_old + e_new * part[:, :d]
                    l = l * e_old + e_new * part[:, d + 1:]
                    big_m = m2
                out[s, heads] = acc / l
                counters[s * y_count + y] = 0
    return out, counters


def _case(rng, page, n, positions, codes, heads=H, kv_heads=HKV):
    slots = len(positions)
    num_pages = slots * n
    bt = rng.permutation(num_pages).reshape(slots, n).astype(np.int32)
    q = rng.normal(size=(slots, heads, D)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    if not codes:
        kp, vp = (rng.normal(size=(kv_heads, num_pages, page, D)).astype(np.float32)
                  for _ in range(2))
        return q, kp, vp, bt, pos, None, None
    kp, vp = (rng.integers(-127, 128, size=(kv_heads, num_pages, page, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.25, 1.0, size=(kv_heads, num_pages)).astype(np.float32)
              for _ in range(2))
    return q, kp, vp, bt, pos, ks, vs


@pytest.mark.parametrize("codes", [False, True])
@pytest.mark.parametrize("page, n", [(16, 48), (100, 6)])
@pytest.mark.parametrize("heads, kv_heads", [(H, HKV), (20, 2)])
def test_split_decode_matches_plain_and_pallas(page, n, codes, heads, kv_heads):
    """On LlamaConfig.tiny()-sized pools (and a GQA group of 10, two row
    tiles of 8): a dead slot, position 0, the last key of the first chunk,
    a last chunk with one live key, a slot deep in the table and one past
    its end; bf16-like f32 pages or int8 codes with per-(kv head, page)
    amaxes.  The chunk partials go through the plan's workspace and
    counters as the kernel indexes them, and every counter ends at 0."""
    plan = tfa.decode_split_plan(6, heads, kv_heads, D, page, n)
    ct = plan["chunk_tokens"]
    assert plan["chunks"] >= 3
    rng = np.random.default_rng(page + n + codes + heads)
    q, kp, vp, bt, pos, ks, vs = _case(rng, page, n, [-1, 0, ct - 1, ct, 2 * ct + 17,
                                                      n * page + 3], codes, heads, kv_heads)
    t = lambda a: None if a is None else torch.from_numpy(a)
    kw = dict(k_scales=t(ks), v_scales=t(vs)) if codes else {}
    got, counters = split_decode(t(q), t(kp), t(vp), t(bt), t(pos), plan, qmax=127.0, **kw)
    assert not counters.any()
    assert torch.isfinite(got).all()
    plain = tfa.paged_decode_attention_plain(t(q), t(kp), t(vp), t(bt), t(pos), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)) if codes else {}
    ref = jfa.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                     jnp.asarray(bt), jnp.asarray(pos), **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert not got[0].any()
