"""The split plan of the paged decode kernels #4 / #5
(``accelerate_tpu_torch/ops/flash_attention.py:decode_split_plan``, the
launch plan of ``csrc/paged_decode.cu``) and the algorithm it launches,
held against the JAX package's Pallas decode kernel; and the same for the
fused LoRA-query decode kernels #8 / #9 (``fused_decode_plan``) against
JAX's ``fused_bgmv_paged_decode``.

``csrc/paged_decode.cu`` splits each slot's page loop into chunks of the
plan's span, computes each chunk's partial softmax (m, l, acc) and merges
the chunks in chunk order.  The CUDA kernel runs only on the card
(``tests/test_torch_cuda_kernels.py``); here a plain torch helper does the
same split and merge on the CPU, through a workspace and counters of the
plan's shapes indexed as the kernel indexes them, and its result must
equal the plain version and JAX's ``paged_decode_attention`` (in interpret
mode, as the JAX package's own tests run it) on the same seeded numpy
inputs.  For #8 / #9 a second helper forms the query as the kernel does:
h = x . A[id] as the cluster's shares of d_in's rows added in rank order,
the delta from B[id], rope, then q split into q_hi + q_lo (bf16, or f16 of
q * 2^-8 for codes), whose two products with k the split page loop adds.
"""

import math

import jax.numpy as jnp
import ml_dtypes
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


def _rows(pages, kh, pids, offs):
    """f32 rows of ``pages`` (e4m3 ones through their bit patterns)."""
    if pages.dtype == torch.float8_e4m3fn:
        return pages.view(torch.uint8)[kh, pids, offs].view(torch.float8_e4m3fn).float()
    return pages[kh, pids, offs].float()


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
    live key gives zeros.  ``q`` may be a tuple of parts (#8 / #9's q_hi,
    q_lo) whose products with k add into the score.  Returns the output and
    the counters."""
    q_parts = q if isinstance(q, tuple) else (q,)
    s_slots, h, d = q_parts[0].shape
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
            qg = [part[s, heads].float() for part in q_parts]              # [rows, D] each
            for c in range(chunks):
                keys = torch.arange(c * ct, min((c + 1) * ct, live))
                pids = block_tables[s, keys // page].long()
                k = _rows(k_pages, kh, pids, keys % page)                      # [K, D]
                v = _rows(v_pages, kh, pids, keys % page)
                k_scale = v_scale = torch.ones(len(keys))
                if k_scales is not None:
                    k_scale, v_scale = k_scales[kh, pids] / qmax, v_scales[kh, pids] / qmax
                scores = sum(part @ k.T for part in qg) * (k_scale * sm_scale)  # [rows, K]
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


# -- #8 / #9: the fused LoRA query on #4 / #5's split -----------------------


@pytest.mark.parametrize("heads, kv_heads, cluster", [
    (16, 8, 8),                 # the 600m model: the 8 kv heads of a (slot, chunk)
    (64, 8, 8), (8, 8, 8),      # groups 8 and 1
    (32, 2, 4),                 # group 16: two row tiles a kv head
    (16, 1, 2),
    (24, 12, 6), (6, 3, 3),     # the largest divisor up to 8
    (22, 11, 1),                # 11 blocks: no cluster to share h in
])
def test_fused_decode_plan_clusters_a_chunks_kv_head_blocks(heads, kv_heads, cluster):
    """#8 / #9 take #4 / #5's split unchanged; their cluster is the
    largest divisor up to 8 of a (slot, chunk)'s kv head x row tile blocks,
    whatever the slots, the page size or the table's chunks."""
    for slots, page, n in ((1, 16, 40), (16, 64, 32), (3, 1, 2500)):
        split = tfa.decode_split_plan(slots, heads, kv_heads, 64, page, n)
        plan = tfa.fused_decode_plan(slots, heads, kv_heads, 64, page, n)
        assert plan == {**split, "cluster": cluster}
        assert (kv_heads * plan["row_tiles"]) % cluster == 0 and cluster <= tfa.FUSED_MAX_CLUSTER


def fused_split_query(x, q_base, a_stack, b_stack, ids, cos, sin, positions, plan, *, codes):
    """#8 / #9's query as ``csrc/paged_decode.cu`` forms it, in f32 torch:
    for a live slot whose id takes a delta, h as the cluster's shares of
    d_in's rows (ceil(d_in / cluster) a block) added in rank order, the
    delta h . B[id], roped split-half at the clamped position and added to
    f32(q_base); then q split into the halves the mma takes, q_hi =
    bf16(q) and q_lo = bf16(q - q_hi), or for codes f16 of q * 2^-8 (and
    2^8 back).  A slot without a delta reads q_base as #4 / #5 do: q_hi its
    q_base as the mma takes it, q_lo 0.  Returns (q_hi, q_lo, q)."""
    slots, h, d = q_base.shape
    d_in = x.shape[1]
    share = -(-d_in // plan["cluster"])
    q = q_base.float().clone()
    delta_rows = torch.zeros(slots, dtype=torch.bool)
    for s in range(slots):
        sid = int(ids[s])
        if not (0 < sid < a_stack.shape[0]) or int(positions[s]) < 0:
            continue
        hsum = torch.zeros(a_stack.shape[2])
        for rank in range(plan["cluster"]):
            lo = min(d_in, rank * share)
            hi = min(d_in, lo + share)
            hsum = hsum + x[s, lo:hi].float() @ a_stack[sid, lo:hi].float()
        delta = (hsum @ b_stack[sid].float()).reshape(h, d)
        p = min(max(int(positions[s]), 0), cos.shape[0] - 1)
        d1, d2 = delta.chunk(2, dim=-1)
        q[s] = q[s] + torch.cat([d1 * cos[p] - d2 * sin[p], d2 * cos[p] + d1 * sin[p]], dim=-1)
        delta_rows[s] = True
    if codes:
        scaled = q / 256.0
        hi = scaled.half().float()
        lo = (scaled - hi).half().float()
        hi, lo = hi * 256.0, lo * 256.0
    else:
        hi = q.bfloat16().float()
        lo = (q - hi).bfloat16().float()
    lo[~delta_rows] = 0.0
    return hi, lo, q


def _fused_case(rng, page, n, kv, positions, heads=H, kv_heads=HKV, d_in=48, rank=4,
                n_adapters=3):
    """Seeded numpy operands of the fused op at LlamaConfig.tiny()'s
    attention: q_base of bf16 values, bf16-like f32 pages or int8 / e4m3
    codes with per-(kv head, page) amaxes, adapters of O(1) deltas (slot 0
    the null adapter), ids mixing 0 and every adapter, a rope table shorter
    than the last position."""
    slots = len(positions)
    q, kp, vp, bt, pos, ks, vs = _case(rng, page, n, positions, kv == "int8", heads, kv_heads)
    q = np.asarray(torch.from_numpy(q).bfloat16().float())
    if kv == "fp8":
        kp, vp = (np.clip(rng.normal(size=(kv_heads, slots * n, page, D)) * 100, -448, 448)
                  .astype(ml_dtypes.float8_e4m3fn) for _ in range(2))
        ks, vs = (rng.uniform(0.25, 1.0, size=(kv_heads, slots * n)).astype(np.float32)
                  for _ in range(2))
    x = rng.normal(size=(slots, d_in)).astype(np.float32)
    a = (rng.normal(size=(n_adapters, d_in, rank)) / np.sqrt(d_in)).astype(np.float32)
    b = (rng.normal(size=(n_adapters, rank, heads * D)) / np.sqrt(rank)).astype(np.float32)
    a[0] = b[0] = 0.0
    ids = np.asarray([(1 + i) % n_adapters for i in range(slots)], np.int32)
    from accelerate_tpu.models import llama as jl

    cos, sin = jl.rope_frequencies(D, max(1, n * page // 2), 10000.0)
    return dict(x=x, q_base=q, a_stack=a, b_stack=b, adapter_ids=ids, cos=cos, sin=sin,
                k_pages=kp, v_pages=vp, block_tables=bt, positions=pos, k_scales=ks,
                v_scales=vs)


def _torch(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("page, n", [(16, 48), (100, 6)])
@pytest.mark.parametrize("heads, kv_heads", [(H, HKV), (20, 2)])
def test_fused_split_decode_matches_plain_and_pallas(kv, page, n, heads, kv_heads):
    """#8 / #9's arithmetic on LlamaConfig.tiny()-sized pools: the query
    from h's rank-order shares and split into q_hi + q_lo, then #4 / #5's
    chunks merged in chunk order through the plan's workspace and counters
    (every counter back at 0), against ``fused_bgmv_paged_decode_plain``
    (its f32 query in one piece) and JAX's ``fused_bgmv_paged_decode`` in
    interpret mode: 1e-4 absolute on outputs of O(1), since q_hi + q_lo
    keeps q to 2^-16 of itself (bf16 halves) or 2^-22 (f16 halves) where
    the plain version's q is exact.  Slots: a dead one, position 0, a
    chunk's last key, a chunk's single key, one deep in the table and one
    past its end (and past the rope table); GQA groups of 2 and of 10 (two
    row tiles of 8, a cluster of 4)."""
    plan = tfa.fused_decode_plan(6, heads, kv_heads, D, page, n)
    ct = plan["chunk_tokens"]
    rng = np.random.default_rng(page + n + len(kv) + heads)
    ops = _fused_case(rng, page, n, kv, [-1, 0, ct - 1, ct, 2 * ct + 17, n * page + 3],
                      heads, kv_heads)
    t = {k: _torch(v) for k, v in ops.items()}
    kw = {} if kv == "bf16" else dict(k_scales=t["k_scales"], v_scales=t["v_scales"])
    q_hi, q_lo, q = fused_split_query(t["x"], t["q_base"], t["a_stack"], t["b_stack"],
                                      t["adapter_ids"], t["cos"], t["sin"], t["positions"], plan,
                                      codes=kv != "bf16")
    assert (q_hi != q).any() and q_lo.any()      # the f32 query is not a bf16 one
    got, counters = split_decode((q_hi, q_lo), t["k_pages"], t["v_pages"], t["block_tables"],
                                 t["positions"], plan, qmax=448.0 if kv == "fp8" else 127.0,
                                 **kw)
    assert not counters.any()
    assert torch.isfinite(got).all() and not got[0].any()
    args = [t[k] for k in ("x", "q_base", "a_stack", "b_stack", "adapter_ids", "cos", "sin",
                           "k_pages", "v_pages", "block_tables", "positions")]
    plain = tfa.fused_bgmv_paged_decode_plain(*args, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4, rtol=0)
    jkw = {} if kv == "bf16" else dict(k_scales=jnp.asarray(ops["k_scales"]),
                                       v_scales=jnp.asarray(ops["v_scales"]))
    ref = jfa.fused_bgmv_paged_decode(*[jnp.asarray(ops[k]) for k in (
        "x", "q_base", "a_stack", "b_stack", "adapter_ids", "cos", "sin", "k_pages", "v_pages",
        "block_tables", "positions")], **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("codes", [False, True])
def test_fused_query_halves_keep_16_bits_and_id0_rows_exact(codes):
    """The kernel header's bound on the split query: |q - q_hi - q_lo| <=
    2^-16 |q| for bf16 halves, <= max(2^-22 |q|, 2^-17) for f16 halves of q
    * 2^-8; one rounding to bf16 is up to 2^-8 |q| off.  A slot with id 0
    keeps q_base (bf16 values) with q_lo 0, as #4 / #5 read it."""
    rng = np.random.default_rng(5)
    plan = tfa.fused_decode_plan(6, H, HKV, D, 16, 48)
    ops = _fused_case(rng, 16, 48, "int8" if codes else "bf16", [3, 40, 100, 200, 300, 500])
    ops["adapter_ids"][[1, 4]] = 0
    t = {k: _torch(v) for k, v in ops.items()}
    q_hi, q_lo, q = fused_split_query(t["x"], t["q_base"], t["a_stack"], t["b_stack"],
                                      t["adapter_ids"], t["cos"], t["sin"], t["positions"], plan,
                                      codes=codes)
    err = (q - q_hi - q_lo).abs()
    bound = (torch.maximum(q.abs() * 2.0 ** -22, torch.full_like(q, 2.0 ** -17)) if codes
             else q.abs() * 2.0 ** -16)
    assert (err <= bound).all()
    assert (q - q.bfloat16().float()).abs().max() > 64 * err.max()
    zero = t["adapter_ids"] == 0
    assert not q_lo[zero].any()
    if not codes:
        assert torch.equal(q_hi[zero], t["q_base"][zero])
