"""The port's hand-written CUDA kernels held against their plain PyTorch
versions, on the card: the paged kernels at the 600m serving model's shapes
(16 q heads over 8 kv heads, pages of 64 tokens, 32 pages per slot), with
bf16, int8 and fp8 pages, the flash kernels up to the 600m training shape
(T 2048, head dim 96), the W8A16 matmuls at the 600m model's four dense
shapes, the LoRA kernels (#10 ``bgmv``, #8 / #9 ``fused_bgmv_paged_decode``)
at the 600m q_proj / v_proj shapes, and the other head dims the kernels are
built for.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance, per row (one token over heads and head dim):
max|out - ref| <= 2e-2 * min(1, max|ref row|), the row's scale floored at
1e-3 * min(1, max|ref|) over the whole output, and over the whole output
max|out - ref| <= 2e-2 * max|ref|.  bf16 operands, f32 accumulation in
both, one bf16 rounding of the kernel's output: 2e-2 on rows of O(1),
scaled down with rows that average a deep window, whose outputs are small.
The flash kernels (#1-#3) are held to the same limits on out, lse, dq, dk
and dv, with the plain version run on the same bf16 operands, at the edges
of their tiles (#1: 128 query rows, 128 keys; #2: 128 query rows, 128 keys,
64 at head dim 128; #3: 128 keys, 64 queries, 32 at head dim 128) and with
T != S; #2 and #3 must give bitwise-equal dq / dk / dv over repeated
launches.  Gradients reach |4| and more, where one bf16 step (0.03125) is
above the row limit: dq / dk / dv may also be off by half a bf16 step of
their |ref| (one rounding), and #1-#3 and their plain versions are each
held to the f64 ground truth of the same operands the same way.  The W8A16 matmuls' rows are output rows
(one token over F), against the plain version in f32; both must give
bitwise-equal outputs on two runs (their H splits add in a fixed order).
#6 and #7 (``paged_prefill.cu``) run every geometry of ``PREFILL_CASES``
over bf16, int8 and fp8 pages, pages of 1 to 128 tokens; #4 and #5
(``paged_decode.cu``) every geometry of ``DECODE_CASES`` (pages of 1 to
128, GQA groups 1 to 16, positions at the edges of the split plan's chunks
and before 0), and must give bitwise-equal outputs over repeated launches,
for a slot alone and the same slot in a batch, on two streams at once and
replayed from a CUDA graph.
#10's rows are output rows against ``bgmv_plain`` (f32 h and delta, one
rounding); its deltas are not O(1), so each element may also be off by
half a bf16 step of its |ref| (at |ref| >= 8 that step is above 2e-2);
its fused entry point ``bgmv_apply`` is held bitwise to the select over
the kernel's own delta, id-0 rows bitwise ``y``;
#12 (``quantized_matmul_wholef``) at every m from 1 to 8, one launch a
call, on two streams at once and replayed from a CUDA graph, as is #11;
#8 / #9 are held to the paged limits against
``fused_bgmv_paged_decode_plain`` and against the composed route (#10, rope,
#4 / #5), which rounds the delta and q to bf16 on the way.
The big-model paths run the kernels on new callers: the layer-streamed
decode of an int8 model tiered over the card, pinned host memory and disk
(#11 at prefill, #12 at decode, each launch held to its plain version, the
tokens ``generate``'s bitwise), its peak device memory (two layers in
flight, not all), beam search with one beam (greedy's tokens), and an
engine from ``load_checkpoint_and_serve`` (the in-process engine's tokens,
bitwise).
#1-#3 also at LoraTrainer's step (T 1024), and a 2-layer LoraTrainer at
the 600m widths whose batched loss equals its sequential schedule.
The memory and precision recipes: #1-#3's f16 instances against their
plain versions (f16's limits: 2e-2 / 8, half an f16 step) and bitwise over
repeats; the -sr8 update in slices on the card bitwise the one-piece one; each fp8
product (``torch._scaled_mm``, e4m3 x e4m3 and e5m2 x e4m3) within 1e-3 of
its row's largest value of the plain version, both f32 (the same codes,
two summation orders); #1 twice a layer under every remat policy with the
plain stack's gradients bitwise; ZeRO-offload's monolithic update bitwise
the resident one and its pipelined chunked update the serial one.
Multi-node data parallelism and the recovery ladder: four ranks' gradients
of a 2-layer Llama at the 600m widths (through #1-#3) synced by the dense
hierarchical schedule on the card against the same sync on the CPU (rtol
1e-5, atol 1e-6), the PowerSGD codec on the card against the CPU within
1e-4 of the reference's largest |value|, and a card train state's host
snapshot restored bitwise after two more steps.
The sharded step's recipes: per-unit gathering over a virtual world of 4 at
the 600m widths (2 layers) bitwise the whole-tree step through #1-#3, and
fp8 under tp 2 x dp_shard 2 with every ``_scaled_mm`` product within 1e-3
of its row's largest value of the plain f32 product.
Tensor-parallel serving: #4 / #5 on a tp rank's heads of the 600m serve
(8 q / 4 kv at tp 2, 4 q / 2 kv at tp 4) against their plain versions and
the one-process launch's rows of the same heads; #10 on a rank's columns
of ``b``; #11 / #12 on a rank's rows of the codes with the matching k2d
scale columns, the ranks' partial products summing to the whole call's;
and a virtual tp 2 engine's every #4 / #6 launch held to its plain version.
"""

import pytest
import torch

from accelerate_tpu_torch.ops import flash_attention as tfa
from accelerate_tpu_torch.ops import lora as tlora
from accelerate_tpu_torch.ops import quantized_matmul as tqm

TOL = 2e-2
ROW_SCALE_FLOOR = 1e-3
HKV, H, PAGE, N, NUM_PAGES = 8, 16, 64, 32, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    tfa.reset_launch_counts()
    tqm.reset_launch_counts()
    tlora.reset_launch_counts()
    return torch.device("cuda")


def _half_ulp_bf16(ref):
    mag = ref.float().abs()
    _, exp = torch.frexp(mag)
    return torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), exp - 9),
                       torch.zeros_like(mag))


def _half_ulp_f16(ref):
    mag = ref.float().abs()
    _, exp = torch.frexp(mag)
    return torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), (exp - 12).clamp(min=-25)),
                       torch.zeros_like(mag))


def _rows_over_limit(out, ref, rounding_slack=False) -> float:
    """The worst row's error over its limit (above), or the whole output's
    over ``tol * max|ref|`` where that is larger; an f16 ``out`` at f16's
    limits: TOL / 8 (an f16 step is 2^-3 of a bf16 step), half an f16 step
    of slack, the floored rows' absolute limit unchanged (rows that cancel
    to ~0 carry the f32 sums' order, the same in either type)."""
    f16 = out.dtype == torch.float16
    tol, row_floor = (TOL / 8, ROW_SCALE_FLOOR * 8) if f16 else (TOL, ROW_SCALE_FLOOR)
    width = out.shape[-2] * out.shape[-1]
    err = (out.float() - ref.float()).abs()
    if rounding_slack:   # one rounding of an output that is not O(1)
        err = (err - (_half_ulp_f16 if f16 else _half_ulp_bf16)(ref)).clamp(min=0)
    diff = err.reshape(-1, width).amax(dim=1)
    scale = ref.float().reshape(-1, width).abs().amax(dim=1)
    floor = row_floor * scale.max().clamp(max=1.0).item()
    limit = tol * scale.clamp(min=max(floor, 1e-30), max=1.0)
    return max((diff / limit).max().item(), (diff.max() / (tol * scale.max())).item())


def _assert_rows_close(out, ref, rounding_slack=False):
    assert torch.isfinite(out).all()
    ratio = _rows_over_limit(out, ref, rounding_slack)
    assert ratio <= 1.0, ratio


def _pools(gen, dev, d):
    kp = torch.randn(HKV, NUM_PAGES, PAGE, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(HKV, NUM_PAGES, PAGE, d, generator=gen, device=dev).bfloat16()
    return kp, vp


DEC_POS = [0, 1, 63, 64, 65, 127, 128, 300, 511, 777, 1023, 1024, 1500, 2000, 2046, 2047]
# #4 / #5's geometries besides the 600m serve's: (page size, pages per
# slot, kv heads, GQA group, head dim); positions from _decode_positions
DECODE_CASES = [
    (1, 600, 2, 2, 64),        # pages of 1: 256 pages a chunk, one bulk copy a token
    (16, 48, 8, 2, 96),        # generate_paged's pages of 16
    (32, 64, 8, 2, 96),        # the quantized serve's pages of 32
    (64, 32, 8, 4, 128),       # group 4
    (100, 9, 4, 4, 128),       # pages of 100: chunks of 2 pages, tiles across pages
    (128, 8, 8, 1, 64),        # pages of 128, group 1
    (128, 8, 2, 8, 128),       # pages of 128 at D 128, group 8
    (24, 30, 4, 3, 96),        # group 3 in a tile of 4 rows, pages of 24
    (16, 40, 1, 16, 64),       # group 16: two row tiles
]


def _decode_positions(page, n):
    """Positions at the split plan's chunk edges (the last key of a chunk,
    a chunk's single live key), before 0, 0, the table's last token and
    past it."""
    ct = tfa.decode_split_plan(1, 2, 1, 64, page, n)["chunk_tokens"]
    end = n * page
    return sorted({-5, -1, 0, 1, ct - 1, ct, ct + 1, 2 * ct - 1, 2 * ct, end // 2 + 3, end - 1,
                   end + 7})


def _decode_operands(gen, dev, case, kv_dtype, pos=None):
    """q, the page pool (and scale keywords), a table of distinct pages and
    the positions (by default ``_decode_positions``) of a ``DECODE_CASES``
    geometry."""
    page, n, hkv, group, d = case
    pos = _decode_positions(page, n) if pos is None else pos
    slots, num_pages = len(pos), len(pos) * n
    if kv_dtype == "bf16":
        kp, vp = _bf16_pool(gen, dev, hkv, num_pages, page, d)
        kw = {}
    else:
        kp, ks, vp, vs = _quant_pool(gen, dev, hkv, num_pages, page, d, kv_dtype)
        kw = dict(k_scales=ks, v_scales=vs)
    bt = torch.randperm(num_pages, generator=gen, device=dev).int().reshape(slots, n)
    q = torch.randn(slots, hkv * group, d, generator=gen, device=dev).bfloat16()
    return q, kp, vp, kw, bt, torch.tensor(pos, dtype=torch.int32, device=dev)


def _check_decode(q, kp, vp, kw, bt, pos):
    out = tfa.paged_decode_attention(q, kp, vp, bt, pos, **kw)
    torch.cuda.synchronize()
    wrapper = tfa.paged_decode_attention_quant if kw else tfa.paged_decode_attention
    assert wrapper.launches == 1
    assert tfa.paged_decode_attention.launches + tfa.paged_decode_attention_quant.launches == 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = tfa.paged_decode_attention_plain(q.float(), kp if kw else kp.float(),
                                           vp if kw else vp.float(), bt, pos, **kw)
    _assert_rows_close(out, ref)
    dead = pos < 0
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


@pytest.mark.cuda
@pytest.mark.parametrize("d, h, case", [(64, 16, None), (96, 16, None), (128, 16, None),
                                        (96, 8, None), (96, 64, None)]
                         + [(None, None, c) for c in DECODE_CASES])
def test_decode_kernel_matches_plain(cuda, d, h, case):
    """#4 at the 600m serve's table (head dims 64 / 96 / 128, groups 1, 2
    and 8) and at every ``DECODE_CASES`` geometry."""
    if case is None:
        gen = torch.Generator(device=cuda).manual_seed(d + h)
        kp, vp = _pools(gen, cuda, d)
        slots = 16
        bt = torch.randint(0, NUM_PAGES, (slots, N), generator=gen, device=cuda,
                           dtype=torch.int32)
        pos = torch.tensor(DEC_POS, dtype=torch.int32, device=cuda)
        q = torch.randn(slots, h, d, generator=gen, device=cuda).bfloat16()
        _check_decode(q, kp, vp, {}, bt, pos)
    else:
        gen = torch.Generator(device=cuda).manual_seed(sum(case))
        _check_decode(*_decode_operands(gen, cuda, case, "bf16"))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("page, n", [(64, 32), (16, 48)])
def test_decode_kernel_is_deterministic_and_slot_independent(cuda, kv_dtype, page, n):
    """#4 / #5: 20 launches on the same operands bitwise equal to the first,
    and each slot alone (a one-slot batch) bitwise equal to its row of the
    16-slot batch, whose other slots take other chunk counts."""
    gen = torch.Generator(device=cuda).manual_seed(page)
    q, kp, vp, kw, bt, pos = _decode_operands(
        gen, cuda, (page, n, HKV, 2, 96), kv_dtype,
        pos=[-1, 0, 1, 63, 64, 255, 256, 257, 300, 511, 512, 600, 700, 766, 767, 800])
    first = tfa.paged_decode_attention(q, kp, vp, bt, pos, **kw)
    runs = [tfa.paged_decode_attention(q, kp, vp, bt, pos, **kw) for _ in range(20)]
    alone = [tfa.paged_decode_attention(q[i:i + 1].contiguous(), kp, vp, bt[i:i + 1].contiguous(),
                                        pos[i:i + 1].contiguous(), **kw)
             for i in range(q.shape[0])]
    torch.cuda.synchronize()
    assert all(torch.equal(run, first) for run in runs)
    for i, out in enumerate(alone):
        assert torch.equal(out[0], first[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_decode_kernel_on_two_streams_and_in_a_cuda_graph(cuda, kv_dtype):
    """#4 / #5 keep merge counters per stream: two streams launching at once
    at one counter size give each call's own output bitwise; a capture on
    a stream with no counters yet refuses, and after one call there the
    replayed graph equals the eager launch bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, kp, vp, kw, bt, pos = _decode_operands(
        gen, cuda, (16, 48, HKV, 2, 96), kv_dtype,
        pos=[-1, 0, 255, 256, 257, 511, 512, 700, 767, 100, 300, 3])
    qs = (q, q.flip(0).contiguous())
    refs = [tfa.paged_decode_attention(x, kp, vp, bt, pos, **kw) for x in qs]
    streams = [torch.cuda.Stream() for _ in qs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for j, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[j].append(tfa.paged_decode_attention(qs[j], kp, vp, bt, pos, **kw))
    torch.cuda.synchronize()
    for j in range(2):
        assert all(torch.equal(out, refs[j]) for out in outs[j]), j

    # a counter size (slot count) that no other call of these tests uses
    k = {"bf16": 11, "int8": 10, "fp8": 9}[kv_dtype]
    q11, bt11, pos11 = q[:k].contiguous(), bt[:k].contiguous(), pos[:k].contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before a CUDA graph capture"):
        with torch.cuda.graph(graph, stream=side):
            tfa.paged_decode_attention(q11, kp, vp, bt11, pos11, **kw)
    with torch.cuda.stream(side):
        eager = tfa.paged_decode_attention(q11, kp, vp, bt11, pos11, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = tfa.paged_decode_attention(q11, kp, vp, bt11, pos11, **kw)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("width, pos0",[(16, 0), (512, 0), (512, 1024), (7, 61), (100, 1948)])
def test_multitoken_kernel_matches_plain(cuda, width, pos0):
    gen = torch.Generator(device=cuda).manual_seed(width + pos0)
    kp, vp = _pools(gen, cuda, 96)
    bt = torch.randint(0, NUM_PAGES, (2, N), generator=gen, device=cuda, dtype=torch.int32)
    pos = (torch.tensor([[pos0], [max(pos0 - 37, 0)]], dtype=torch.int32, device=cuda)
           + torch.arange(width, dtype=torch.int32, device=cuda))
    q = torch.randn(2, width, H, 96, generator=gen, device=cuda).bfloat16()
    out = tfa.paged_multitoken_attention(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert tfa.paged_multitoken_attention.launches == 1
    ref = tfa.paged_multitoken_attention_plain(q.float(), kp.float(), vp.float(), bt, pos)
    _assert_rows_close(out, ref)


@pytest.mark.cuda
def test_kernel_refuses_unbuilt_head_dim(cuda):
    q = torch.zeros(4, 16, 80, dtype=torch.bfloat16, device=cuda)
    kp = torch.zeros(HKV, 8, PAGE, 80, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tfa.paged_decode_attention(q, kp, kp, torch.zeros(4, 2, dtype=torch.int32, device=cuda),
                                   torch.zeros(4, dtype=torch.int32, device=cuda))
    assert tfa.paged_decode_attention.launches == 0


def _flash_inputs(gen, dev, b, t, h, hkv, d, seg, pos, s=None):
    """q / g over ``t`` rows, k / v over ``s`` keys (``t`` by default)."""
    s = t if s is None else s
    q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).bfloat16()
    g = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
    g_lse = torch.randn(b, t, h, generator=gen, device=dev)
    kw = {}
    if seg:
        cuts = torch.sort(torch.randint(0, t, (b, 3), generator=gen, device=dev), dim=1).values
        kw["segment_ids"] = (torch.arange(t, device=dev)[None, :, None] >= cuts[:, None]).sum(-1)
    if pos:
        kw["positions"] = torch.stack([torch.randperm(t, generator=gen, device=dev)
                                       for _ in range(b)]).int()
        if s != t:
            kw["kv_positions"] = torch.stack([torch.randperm(s, generator=gen, device=dev)
                                              for _ in range(b)]).int()
    return q, k, v, g, g_lse, kw


def _flash_fwd_bwd(fn, q, k, v, g, g_lse, causal, kw):
    """out, lse, dq, dk, dv of ``sum(out * g) + sum(lse * g_lse)``."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out, lse = fn(q, k, v, causal=causal, return_lse=True, **kw)
    (out.float() * g.float()).sum().add((lse * g_lse).sum()).backward()
    return out, lse, q.grad, k.grad, v.grad


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, s, h, hkv, d, causal, seg, pos", [
    (2, 256, None, 4, 2, 64, True, False, False),
    (1, 200, None, 16, 8, 96, True, False, False),     # T not a multiple of the 64-row tile
    (2, 128, None, 4, 4, 128, False, False, False),
    (1, 192, None, 4, 2, 96, True, True, False),       # packed segments
    (1, 192, None, 4, 2, 96, True, False, True),       # explicit (shuffled) positions
    (2, 2048, None, 16, 8, 96, True, False, False),    # the 600m training shape at batch 2
    (2, 1024, None, 16, 8, 96, True, False, False),    # LoraTrainer's 600m step at batch 2
    (2, 129, None, 16, 8, 96, True, False, False),     # one row past the forward's 128-row tile
    (1, 2047, None, 16, 8, 96, True, False, False),    # one short of the last 128-key tile
    (2, 320, None, 8, 4, 64, False, False, False),     # D 64, non-causal, a partial key tile
    (2, 300, None, 4, 2, 128, False, False, False),    # D 128, non-causal, a partial key tile
    (2, 384, None, 16, 4, 96, True, True, False),      # GQA group 4 with segments
    # the backward's tiles: #2 128 query rows by 128 keys (64 at D 128), #3
    # 128 keys by 64 queries (32 at D 128); one short of and one past each
    (1, 63, None, 4, 2, 64, True, False, False),
    (1, 65, None, 4, 2, 64, True, False, False),
    (1, 127, None, 4, 2, 64, True, False, False),
    (1, 129, None, 4, 2, 64, True, False, False),
    (1, 63, None, 16, 8, 96, True, False, False),
    (1, 65, None, 16, 8, 96, True, False, False),
    (1, 127, None, 16, 8, 96, True, False, False),
    (1, 257, None, 16, 8, 96, True, False, False),
    (1, 31, None, 4, 2, 128, True, False, False),
    (1, 33, None, 4, 2, 128, True, False, False),
    (1, 65, None, 4, 2, 128, True, False, False),
    (1, 127, None, 4, 2, 128, True, False, False),
    (1, 129, None, 4, 2, 128, True, False, False),
    # GQA groups 1 and 4 with positions
    (2, 192, None, 4, 4, 96, True, False, True),
    (2, 192, None, 16, 4, 96, True, False, True),
    (2, 320, None, 16, 4, 96, True, False, True),
    # T != S (None: S = T), causal by index (a row attends the keys at or
    # before its own index) and not
    (2, 192, 320, 16, 8, 96, True, False, False),
    (2, 320, 192, 16, 8, 96, True, False, False),
    (2, 192, 320, 4, 2, 64, False, False, False),
    (2, 320, 192, 4, 1, 128, False, False, False),
])
def test_flash_kernels_match_plain(cuda, b, t, s, h, hkv, d, causal, seg, pos):
    gen = torch.Generator(device=cuda).manual_seed(t + d + h + 3 * (s or 0))
    q, k, v, g, g_lse, kw = _flash_inputs(gen, cuda, b, t, h, hkv, d, seg, pos, s=s)
    got = _flash_fwd_bwd(tfa.flash_attention, q, k, v, g, g_lse, causal, kw)
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (1, 1, 1)
    want = _flash_fwd_bwd(tfa.flash_attention_plain, q, k, v, g, g_lse, causal, kw)
    for name, x, ref in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert x.dtype == ref.dtype and x.shape == ref.shape, name
        if name == "lse":
            x, ref = x[..., None, None], ref[..., None, None]
        # the gradients reach |4| and more, where the kernel's and the plain
        # version's roundings of nearly the same f32 sum may land one bf16
        # step apart (0.03125 above 4): each is allowed one rounding, as
        # both are within it of the f64 truth (test_flash_grads_against_f64_truth)
        _assert_rows_close(x, ref, rounding_slack=name in ("dq", "dk", "dv"))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_dq", "flash_dkv"])
def test_flash_dkv_is_deterministic(cuda, kernel):
    """#2 and #3 sum in a fixed order (#3's GQA group inside one block, no
    atomics): 20 launches back to back on the same operands agree bitwise
    with the first."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, g, _, _ = _flash_inputs(gen, cuda, 2, 512, 16, 8, 96, False, False)
    out, lse = tfa.flash_fwd(q, k, v, causal=True, sm_scale=96 ** -0.5)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    fn = getattr(tfa, kernel)
    runs = [fn(q, k, v, g, lse, delta, causal=True, sm_scale=96 ** -0.5) for _ in range(20)]
    torch.cuda.synchronize()
    runs = [r if isinstance(r, tuple) else (r,) for r in runs]
    for later in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], later))


@pytest.mark.cuda
def test_flash_kernel_refuses_bad_operands(cuda):
    q = torch.zeros(1, 64, 4, 80, dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(1, 64, 2, 80, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16, device=cuda)
        tfa.flash_attention(x, x[:, :, :2], x[:, :, :2])
    with pytest.raises(TypeError, match="bfloat16"):
        x = torch.zeros(1, 64, 4, 64, device=cuda)
        tfa.flash_attention(x, x, x)
    assert tfa.flash_fwd.launches == 0


@pytest.mark.cuda
def test_engine_serves_through_the_kernels(cuda):
    """A tiny bf16 model at head dim 64 served on the card: every request
    finishes, each kernel launches once per layer of every step."""
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaConfig, LlamaForCausalLM, ServingEngine, ServingPlugin,
        synthesize_trace,
    )

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, seed=0)
    eng = ServingEngine(model, ServingPlugin(num_slots=4, page_size=16, pages_per_slot=4,
                                             num_pages=16, prefill_chunk=32),
                        GenerationConfig(max_new_tokens=16))
    eng.warmup()
    tfa.reset_launch_counts()
    trace = synthesize_trace(0, 6)
    results = eng.run(trace)
    assert sorted(results) == [r.uid for r in trace]
    assert eng.free_page_mirror_in_sync()
    layers = cfg.num_hidden_layers
    assert tfa.paged_decode_attention.launches == eng.metrics["decode_steps"] * layers
    assert tfa.paged_multitoken_attention.launches == eng.metrics["prefill_steps"] * layers


def _quant_pools(gen, dev, d, kv_dtype, num_pages=NUM_PAGES):
    """int8 / e4m3 pages written through the port's own quantized write,
    so the scales are real running amaxes.  Each (page, kv head) draws its
    own scale in [0.25, 1): values stay below 8, where one bf16 rounding of
    an output stays within the row limit, as with the bf16 pools."""
    from accelerate_tpu_torch.models.llama import KV_QUANT_DTYPES, paged_write_kv_quantized

    pools = []
    for _ in range(2):
        pages = torch.zeros(HKV, num_pages, PAGE, d, dtype=KV_QUANT_DTYPES[kv_dtype], device=dev)
        scales = torch.zeros(HKV, num_pages, device=dev)
        vals = (torch.randn(num_pages, PAGE, HKV, d, generator=gen, device=dev)
                * (0.25 + 0.75 * torch.rand(num_pages, 1, HKV, 1, generator=gen,
                                            device=dev))).bfloat16()
        ids = torch.arange(num_pages, device=dev)[:, None].expand(num_pages, PAGE)
        offs = torch.arange(PAGE, device=dev)[None].expand(num_pages, PAGE)
        paged_write_kv_quantized(pages, scales, vals, ids, offs, kv_dtype)
        pools += [pages, scales]
    return pools


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("d, case", [(64, None), (96, None), (128, None)]
                         + [(None, c) for c in DECODE_CASES])
def test_quantized_decode_kernel_matches_plain(cuda, kv_dtype, d, case):
    """#5 at the 600m serve's table (head dims 64 / 96 / 128) and at every
    ``DECODE_CASES`` geometry, over int8 and e4m3 codes."""
    if case is None:
        gen = torch.Generator(device=cuda).manual_seed(d)
        kp, ks, vp, vs = _quant_pools(gen, cuda, d, kv_dtype)
        slots = 16
        bt = torch.randint(0, NUM_PAGES, (slots, N), generator=gen, device=cuda,
                           dtype=torch.int32)
        pos = torch.tensor(DEC_POS, dtype=torch.int32, device=cuda)
        q = torch.randn(slots, H, d, generator=gen, device=cuda).bfloat16()
        _check_decode(q, kp, vp, dict(k_scales=ks, v_scales=vs), bt, pos)
    else:
        gen = torch.Generator(device=cuda).manual_seed(sum(case))
        _check_decode(*_decode_operands(gen, cuda, case, kv_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("width, pos0, d", [(16, 0, 96), (512, 0, 96), (512, 1024, 96),
                                            (100, 1948, 64), (64, 61, 128)])
def test_quantized_multitoken_kernel_matches_plain(cuda, kv_dtype, width, pos0, d):
    gen = torch.Generator(device=cuda).manual_seed(width + pos0)
    kp, ks, vp, vs = _quant_pools(gen, cuda, d, kv_dtype)
    bt = torch.randint(0, NUM_PAGES, (2, N), generator=gen, device=cuda, dtype=torch.int32)
    pos = (torch.tensor([[pos0], [max(pos0 - 37, 0)]], dtype=torch.int32, device=cuda)
           + torch.arange(width, dtype=torch.int32, device=cuda))
    q = torch.randn(2, width, H, d, generator=gen, device=cuda).bfloat16()
    out = tfa.paged_multitoken_attention(q, kp, vp, bt, pos, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert tfa.paged_multitoken_attention_quant.launches == 1
    ref = tfa.paged_multitoken_attention_plain(q.float(), kp, vp, bt, pos, k_scales=ks,
                                               v_scales=vs)
    _assert_rows_close(out, ref)


def _quant_pool(gen, dev, hkv, num_pages, page, d, kv_dtype, extreme=False):
    """``(k_pages, k_scales, v_pages, v_scales)`` at any geometry: values
    written through the port's quantized write, or with ``extreme`` every
    code at +-QMAX (127 / 448) under amaxes in [0.25, 1)."""
    from accelerate_tpu_torch.models.llama import KV_QUANT_DTYPES, paged_write_kv_quantized

    out = []
    for _ in range(2):
        if extreme:
            qmax = 127.0 if kv_dtype == "int8" else 448.0
            sign = torch.randint(0, 2, (hkv, num_pages, page, d), generator=gen, device=dev) * 2 - 1
            pages = (sign * qmax).to(KV_QUANT_DTYPES[kv_dtype])
            scales = 0.25 + 0.75 * torch.rand(hkv, num_pages, generator=gen, device=dev)
        else:
            pages = torch.zeros(hkv, num_pages, page, d, dtype=KV_QUANT_DTYPES[kv_dtype],
                                device=dev)
            scales = torch.zeros(hkv, num_pages, device=dev)
            vals = torch.randn(num_pages, page, hkv, d, generator=gen, device=dev).bfloat16()
            ids = torch.arange(num_pages, device=dev)[:, None].expand(num_pages, page)
            offs = torch.arange(page, device=dev)[None].expand(num_pages, page)
            paged_write_kv_quantized(pages, scales, vals, ids, offs, kv_dtype)
        out += [pages, scales]
    return out


def _bf16_pool(gen, dev, hkv, num_pages, page, d, extreme=False):
    """``(k_pages, v_pages)`` bf16 at any geometry: normal values, or with
    ``extreme`` every value at +-amax for one amax in [0.25, 1) per (kv
    head, page), the values the extreme code pools stand for."""
    out = []
    for _ in range(2):
        if extreme:
            sign = torch.randint(0, 2, (hkv, num_pages, page, d), generator=gen, device=dev) * 2 - 1
            amax = 0.25 + 0.75 * torch.rand(hkv, num_pages, 1, 1, generator=gen, device=dev)
            out.append((sign * amax).bfloat16())
        else:
            out.append(torch.randn(hkv, num_pages, page, d, generator=gen, device=dev).bfloat16())
    return out


# kernels #6 / #7's geometries: (slots, width, first positions, page size,
# pages per slot, kv heads, GQA group, head dim)
PREFILL_CASES = [
    (2, 100, [37, 0], 16, 20, 8, 2, 96),         # pages of 16, pos0 mid-page
    (1, 512, [0], 64, 32, 8, 2, 96),             # the serve's chunk
    (4, 250, [0, 0, 0, 0], 16, 20, 8, 2, 96),    # generate_paged's prompts
    (3, 77, [5, 70, 130], 64, 8, 8, 1, 128),     # group 1, rows no multiple of 64
    (2, 33, [300, 17], 16, 32, 4, 4, 64),        # group 4
    (2, 50, [1000, 3], 16, 80, 2, 8, 64),        # group 8, a long window
    (2, 16, [1024, 2000], 64, 32, 8, 2, 96),     # a short chunk deep in the table
    (2, 8, [-20, -3], 16, 4, 8, 2, 96),          # a window wholly / partly before 0
    (2, 40, [0, 23], 1, 96, 8, 2, 96),           # pages of 1: 64 pages a tile
    (2, 70, [5, 131], 8, 40, 8, 2, 64),          # pages of 8, windows mid-page
    (2, 90, [13, 200], 24, 16, 8, 2, 96),        # pages of 24: no divisor of the tile
    (1, 512, [0], 32, 32, 8, 2, 96),             # the serve's chunk over pages of 32
    (2, 60, [47, 300], 48, 10, 4, 4, 128),       # pages of 48, group 4
    (2, 130, [99, 250], 100, 5, 8, 2, 96),       # pages of 100: tiles inside pages
    (2, 200, [127, 1], 128, 4, 8, 2, 96),        # pages of 128: two tiles a page
    (2, 8, [-40, -1], 100, 3, 8, 2, 64),         # before 0 over pages of 100
]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_tensor_core_multitoken_kernel_geometries(cuda, kv_dtype, extreme, case):
    """#6 (bf16 pages) and #7 (codes) over pages of 1 to 128, GQA groups
    1-8, head dims 64-128, row counts that are no multiple of the 64-row
    tile, several slots, first positions mid-page, values at +-amax (codes
    at +-QMAX), and windows wholly before position 0 (zeros)."""
    slots, width, pos0, page, n, hkv, group, d = case
    gen = torch.Generator(device=cuda).manual_seed(width + page + d)
    num_pages = slots * n
    if kv_dtype == "bf16":
        kp, vp = _bf16_pool(gen, cuda, hkv, num_pages, page, d, extreme)
        kw, wrapper = {}, tfa.paged_multitoken_attention
    else:
        kp, ks, vp, vs = _quant_pool(gen, cuda, hkv, num_pages, page, d, kv_dtype, extreme)
        kw, wrapper = dict(k_scales=ks, v_scales=vs), tfa.paged_multitoken_attention_quant
    bt = torch.randperm(num_pages, generator=gen, device=cuda).int().reshape(slots, n)
    pos = (torch.tensor(pos0, dtype=torch.int32, device=cuda)[:, None]
           + torch.arange(width, dtype=torch.int32, device=cuda)).contiguous()
    q = torch.randn(slots, width, hkv * group, d, generator=gen, device=cuda).bfloat16()
    out = tfa.paged_multitoken_attention(q, kp, vp, bt, pos, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == 1
    assert tfa.paged_multitoken_attention.launches + tfa.paged_multitoken_attention_quant.launches == 1
    ref = tfa.paged_multitoken_attention_plain(q.float(), kp if kw else kp.float(),
                                               vp if kw else vp.float(), bt, pos, **kw)
    _assert_rows_close(out, ref)
    dead = pos[:, -1] < 0
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tensor_core_multitoken_kernel_refuses_what_it_does_not_take(cuda, kv_dtype):
    """Head dims other than 64 / 96 / 128 are refused before any launch;
    every page size is taken."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for d in (80, 256):
        if kv_dtype == "bf16":
            kp, vp = _bf16_pool(gen, cuda, 8, 4, 24, d)
            kw = {}
        else:
            kp, ks, vp, vs = _quant_pool(gen, cuda, 8, 4, 24, d, kv_dtype)
            kw = dict(k_scales=ks, v_scales=vs)
        q = torch.zeros(1, 8, 16, d, dtype=torch.bfloat16, device=cuda)
        bt = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
        pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
        with pytest.raises(ValueError, match="head dims"):
            tfa.paged_multitoken_attention(q, kp, vp, bt, pos, **kw)
    assert tfa.paged_multitoken_attention.launches == 0
    assert tfa.paged_multitoken_attention_quant.launches == 0


def _qweight(gen, dev, h, f):
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize

    w = torch.randn(h, f, generator=gen, device=dev) / h ** 0.5
    return quantize(w, QuantizationConfig(load_in_8bit=True))


# the 600m model's denses (H -> F): q / o, k / v, gate / up, down; and an H
# that is no multiple of the 64-row K tile (the masked tail)
DENSES = [(1536, 1536), (1536, 768), (1536, 4096), (4096, 1536), (1576, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("h, f", DENSES)
@pytest.mark.parametrize("m", [16, 512, 37])
def test_tiled_qmm_kernel_matches_plain(cuda, h, f, m):
    gen = torch.Generator(device=cuda).manual_seed(h + f + m)
    qt = _qweight(gen, cuda, h, f)
    x = torch.randn(m, h, generator=gen, device=cuda).bfloat16()
    out = tqm.quantized_matmul_tiled(x, qt.data, qt.scale, qblock=128, out_dtype=torch.bfloat16)
    again = tqm.quantized_matmul_tiled(x, qt.data, qt.scale, qblock=128,
                                       out_dtype=torch.bfloat16)
    out32 = tqm.quantized_matmul_tiled(x, qt.data, qt.scale, qblock=128,
                                       out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tqm.quantized_matmul_tiled.launches == 3
    assert torch.equal(out, again)
    ref = tqm.quantized_matmul_plain(x, qt.data, qt.scale, qblock=128, out_dtype=torch.float32)
    _assert_rows_close(out[:, None], ref[:, None])
    torch.testing.assert_close(out32, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("h, f", [(1576, 768), (1536, 4096)])
@pytest.mark.parametrize("m", [9, 16, 17, 37, 64, 65, 512])
def test_tiled_qmm_plans_match_plain_and_are_deterministic(cuda, h, f, m):
    """#11 at both tile plans and around their switches (16 / 17, 64 / 65),
    with a partial last K tile (H 1576): one launch a call, f32 sums
    against the plain version, and ten runs bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(h + m)
    qt = _qweight(gen, cuda, h, f)
    x = torch.randn(m, h, generator=gen, device=cuda).bfloat16()
    runs = [tqm.quantized_matmul_tiled(x, qt.data, qt.scale, qblock=128, out_dtype=torch.float32)
            for _ in range(10)]
    torch.cuda.synchronize()
    assert tqm.quantized_matmul_tiled.launches == 10
    out = runs[0]
    assert all(torch.equal(out, again) for again in runs[1:])
    ref = tqm.quantized_matmul_plain(x, qt.data, qt.scale, qblock=128, out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m, h, f", [(16, 1536, 4096), (512, 4096, 1536), (37, 1576, 768)])
def test_tiled_qmm_replays_in_a_cuda_graph(cuda, m, h, f):
    """With H split, #11 counts arrivals in its stream's scratch, which
    every launch leaves at zero: after one eager call on the capture
    stream, a captured launch replayed three times gives the eager output
    bitwise each time, and the counters are back at zero."""
    assert tqm.tiled_plan(m, h, f).splits > 1
    gen = torch.Generator(device=cuda).manual_seed(m)
    qt = _qweight(gen, cuda, h, f)
    x = torch.randn(m, h, generator=gen, device=cuda).bfloat16()
    out, eager = _replayed(lambda: tqm.quantized_matmul_tiled(x, qt.data, qt.scale, qblock=128))
    assert torch.equal(out, eager)
    assert all(int(buf.abs().sum()) == 0 for buf in tqm._COUNTERS.values())


def _replayed(call):
    """``call()`` eagerly on a side stream, then captured there and the
    graph replayed three times, each replay's output compared bitwise with
    the eager one.  Returns (captured output, eager output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = call()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    return out, eager


def _two_streams(calls, repeats=10):
    """Each of ``calls`` once on the current stream, then ``repeats`` times
    on its own stream, the streams launching at once: every launch bitwise
    equal to its call's first."""
    refs = [call() for call in calls]
    streams = [torch.cuda.Stream() for _ in calls]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[] for _ in calls]
    for _ in range(repeats):
        for j, (call, st) in enumerate(zip(calls, streams)):
            with torch.cuda.stream(st):
                outs[j].append(call())
    torch.cuda.synchronize()
    for j, runs in enumerate(outs):
        assert all(torch.equal(out, refs[j]) for out in runs), j


@pytest.mark.cuda
@pytest.mark.parametrize("m, h, f", [(16, 1536, 4096), (37, 1576, 768)])
def test_tiled_qmm_on_two_streams_at_once(cuda, m, h, f):
    """#11's split counters are per stream: two streams launching the same
    plan at once each get their own call's output, bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(m + 1)
    qt = _qweight(gen, cuda, h, f)
    xs = [torch.randn(m, h, generator=gen, device=cuda).bfloat16() for _ in range(2)]
    _two_streams([lambda x=x: tqm.quantized_matmul_tiled(x, qt.data, qt.scale, qblock=128)
                  for x in xs])
    assert all(int(buf.abs().sum()) == 0 for buf in tqm._COUNTERS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("h, f", DENSES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
def test_wholef_qmm_kernel_matches_plain_and_is_deterministic(cuda, h, f, m):
    """#12 at the 600m denses and the masked K tail, every m it takes: one
    launch a call, bitwise repeats, f32 sums against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(h + f + m)
    qt = _qweight(gen, cuda, h, f)
    x = torch.randn(m, h, generator=gen, device=cuda).bfloat16()
    out = tqm.quantized_matmul_wholef(x, qt.data, qt.scale, qblock=128, out_dtype=torch.bfloat16)
    again = tqm.quantized_matmul_wholef(x, qt.data, qt.scale, qblock=128,
                                        out_dtype=torch.bfloat16)
    out32 = tqm.quantized_matmul_wholef(x, qt.data, qt.scale, qblock=128,
                                        out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tqm.quantized_matmul_wholef.launches == 3
    assert torch.equal(out, again)
    ref = tqm.quantized_matmul_wholef_plain(x, qt.data, qt.scale, qblock=128,
                                            out_dtype=torch.float32)
    _assert_rows_close(out[:, None], ref[:, None])
    torch.testing.assert_close(out32, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m, h, f", [(4, 1536, 4096), (8, 1536, 768), (1, 4096, 1536)])
def test_wholef_qmm_in_a_cuda_graph_and_on_two_streams(cuda, m, h, f):
    """#12 splits H and adds the slices inside a thread-block cluster, with
    no scratch: a capture on a fresh stream (no eager call there first)
    replays the eager launch bitwise; two streams launching at once each
    get their own call's output bitwise."""
    assert tqm.wholef_plan(m, h, f).splits > 1
    gen = torch.Generator(device=cuda).manual_seed(m + h)
    qt = _qweight(gen, cuda, h, f)
    xs = [torch.randn(m, h, generator=gen, device=cuda).bfloat16() for _ in range(2)]
    eager = tqm.quantized_matmul_wholef(xs[0], qt.data, qt.scale, qblock=128)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = tqm.quantized_matmul_wholef(xs[0], qt.data, qt.scale, qblock=128)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    _two_streams([lambda x=x: tqm.quantized_matmul_wholef(x, qt.data, qt.scale, qblock=128)
                  for x in xs])


@pytest.mark.cuda
def test_qmm_dispatch_on_the_card(cuda):
    """``quantized_matmul`` takes #12 at m <= 8 and #11 above, as JAX does."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    qt = _qweight(gen, cuda, 1536, 768)
    for m, tiled, wholef in ((4, 0, 1), (9, 1, 1), (16, 2, 1)):
        x = torch.randn(1, m, 1536, generator=gen, device=cuda).bfloat16()
        assert tqm.quantized_matmul(x, qt).shape == (1, m, 768)
        assert (tqm.quantized_matmul_tiled.launches, tqm.quantized_matmul_wholef.launches) \
            == (tiled, wholef)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 16])
def test_qmm_pads_an_h_that_is_no_multiple_of_8(cuda, m):
    """JAX sends an int8 dense with H % 8 != 0 to its kernels; the port
    pads H with zero rows for the kernels' 16-byte rows and agrees with the
    plain version on the unpadded operands."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    qt = _qweight(gen, cuda, 1001, 768)
    x = torch.randn(m, 1001, generator=gen, device=cuda).bfloat16()
    out = tqm.quantized_matmul(x, qt, out_dtype=torch.float32)
    torch.cuda.synchronize()
    wholef = m <= 8
    assert (tqm.quantized_matmul_tiled.launches, tqm.quantized_matmul_wholef.launches) \
        == (int(not wholef), int(wholef))
    plain = tqm.quantized_matmul_wholef_plain if wholef else tqm.quantized_matmul_plain
    ref = plain(x, qt.data, qt.scale, qblock=128, out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
def test_a_routed_stand_in_neither_takes_nor_hides_a_launch(cuda):
    """A stand-in put in a wrapper's module name (as chip_smoke.py's
    checked passes do) needs no counter: the launch counts on the wrapper."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    qt = _qweight(gen, cuda, 1536, 768)
    x = torch.randn(16, 1536, generator=gen, device=cuda).bfloat16()
    real, calls = tqm.quantized_matmul_tiled, []

    def stand_in(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    tqm.quantized_matmul_tiled = stand_in
    try:
        tqm.quantized_matmul(x, qt)
    finally:
        tqm.quantized_matmul_tiled = real
    assert calls == [1] and real.launches == 1


@pytest.mark.cuda
def test_quantized_engine_serves_through_the_kernels(cuda):
    """A tiny bf16 model with int8 weights and int8 pages served on the
    card: every request finishes, and each kernel launches as the main
    path says (#5 per decode step, #7 per prefill step and #11 per dense
    of both, once per layer)."""
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaConfig, LlamaForCausalLM, QuantizationConfig, ServingEngine,
        ServingPlugin, quantize_model_, synthesize_trace,
    )

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                           num_key_value_heads=2, max_position_embeddings=256)
    model = quantize_model_(LlamaForCausalLM(cfg, seed=0), QuantizationConfig(load_in_8bit=True))
    eng = ServingEngine(model, ServingPlugin(num_slots=16, page_size=16, pages_per_slot=4,
                                             num_pages=64, prefill_chunk=32, kv_dtype="int8"),
                        GenerationConfig(max_new_tokens=16))
    eng.warmup()
    tfa.reset_launch_counts()
    tqm.reset_launch_counts()
    trace = synthesize_trace(0, 6)
    results = eng.run(trace)
    assert sorted(results) == [r.uid for r in trace]
    assert eng.free_page_mirror_in_sync()
    layers, m = cfg.num_hidden_layers, eng.metrics
    assert tfa.paged_decode_attention_quant.launches == m["decode_steps"] * layers
    assert tfa.paged_multitoken_attention_quant.launches == m["prefill_steps"] * layers
    assert tfa.paged_decode_attention.launches == tfa.paged_multitoken_attention.launches == 0
    assert tqm.quantized_matmul_tiled.launches == 7 * layers * (m["decode_steps"]
                                                                 + m["prefill_steps"])
    assert tqm.quantized_matmul_wholef.launches == 0


@pytest.mark.cuda
def test_quantized_engine_serves_pages_of_32_under_auto(cuda):
    """int8 pages of 32 tokens, which the kernel once refused, served under
    ``decode_kernel="auto"``: every request finishes through #5 and #7 (no
    gathered native route), and each launches once per layer of every
    step."""
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaConfig, LlamaForCausalLM, ServingEngine, ServingPlugin,
        synthesize_trace,
    )

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, seed=0)
    eng = ServingEngine(model, ServingPlugin(num_slots=8, page_size=32, pages_per_slot=4,
                                             num_pages=32, prefill_chunk=64, kv_dtype="int8",
                                             decode_kernel="auto"),
                        GenerationConfig(max_new_tokens=30))
    eng.warmup()
    tfa.reset_launch_counts()
    # prompts of up to three pages, some in two prefill chunks
    trace = synthesize_trace(0, 8, prompt_len_range=(20, 90), new_tokens_range=(4, 30))
    results = eng.run(trace)
    assert sorted(results) == [r.uid for r in trace]
    assert all(len(results[r.uid]) == r.max_new_tokens for r in trace)
    assert eng.free_page_mirror_in_sync()
    layers, m = cfg.num_hidden_layers, eng.metrics
    assert tfa.paged_decode_attention_quant.launches == m["decode_steps"] * layers > 0
    assert tfa.paged_multitoken_attention_quant.launches == m["prefill_steps"] * layers > 0
    assert tfa.paged_decode_attention.launches == tfa.paged_multitoken_attention.launches == 0


# -- LoRA kernels #10, #8, #9 -------------------------------------------------

LORA_IDS = [0, 1, 2, 1, 3, 0, 4, 4, 2, 0, 1, 3, 3, 4, 0, 2]   # 16 slots, repeats, zeros


def _lora_stacks(gen, dev, d_in, rank, d_out, n_adapters=5):
    """A pool of ``n_adapters`` slots, slot 0 the null adapter, the factors
    scaled as ``init_adapter_params`` draws them (delta of O(1))."""
    a = (torch.randn(n_adapters, d_in, rank, generator=gen, device=dev) / d_in ** 0.5).bfloat16()
    b = (torch.randn(n_adapters, rank, d_out, generator=gen, device=dev) / rank ** 0.5).bfloat16()
    a[0] = 0
    b[0] = 0
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [4, 16, 64])
@pytest.mark.parametrize("d_out", [768, 1536, 1001])
@pytest.mark.parametrize("b_scale", [1.0, 16.0])      # 16: deltas well above 8
def test_bgmv_kernel_matches_plain(cuda, rank, d_out, b_scale):
    gen = torch.Generator(device=cuda).manual_seed(rank + d_out)
    a, b = _lora_stacks(gen, cuda, 1536, rank, d_out)
    b = b * b_scale
    x = torch.randn(16, 1536, generator=gen, device=cuda).bfloat16()
    ids = torch.tensor(LORA_IDS, dtype=torch.int32, device=cuda)
    out = tlora.bgmv(x, a, b, ids)
    again = tlora.bgmv(x, a, b, ids)
    torch.cuda.synchronize()
    assert tlora.bgmv.launches == 2
    assert torch.equal(out, again)
    ref = tlora.bgmv_plain(x.float(), a, b, ids)
    if b_scale > 1:
        assert ref.abs().max() > 8
    _assert_rows_close(out[:, None], ref[:, None], rounding_slack=True)
    assert not out[ids == 0].any()          # id-0 rows: zeros


# (ids, pool slots): slots sharing adapters, each slot its own adapter, ids
# outside [1, N)
APPLY_IDS = [
    (LORA_IDS, 5),
    ([1, 1, 1, 1, 1, 1, 2, 0, 1, 1, 0, 2, 1, 1, 0, 1], 3),
    (list(range(1, 17)), 17),
    ([0, -1, 5, 7, 1, 0, 6, 2, 0, 0, 3, -3, 9, 4, 1, 0], 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("ids, pool", APPLY_IDS)
@pytest.mark.parametrize("rank, d_out", [(16, 1536), (16, 768), (4, 1001), (64, 1536), (33, 768)])
def test_bgmv_apply_kernel_matches_plain(cuda, ids, pool, rank, d_out):
    """#10 with the select folded in, one launch: equal to its plain version
    given the kernel's own delta (which is held to ``bgmv_plain``), id <= 0
    rows ``y`` bitwise (-0.0 included), id >= N rows ``y + 0``; bitwise
    repeats; the delta-only entry point on the same operands."""
    gen = torch.Generator(device=cuda).manual_seed(rank + d_out + pool)
    a, b = _lora_stacks(gen, cuda, 1536, rank, d_out, n_adapters=pool)
    x = torch.randn(16, 1536, generator=gen, device=cuda).bfloat16()
    y = torch.randn(16, d_out, generator=gen, device=cuda).bfloat16()
    y[:, 0] = -0.0
    ids_t = torch.tensor(ids, dtype=torch.int32, device=cuda)
    out = tlora.bgmv_apply(x, y, a, b, ids_t)
    again = tlora.bgmv_apply(x, y, a, b, ids_t)
    delta = tlora.bgmv(x, a, b, ids_t)
    torch.cuda.synchronize()
    assert (tlora.bgmv_apply.launches, tlora.bgmv.launches) == (2, 1)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    _assert_rows_close(delta[:, None], tlora.bgmv_plain(x.float(), a, b, ids_t)[:, None],
                       rounding_slack=True)
    composed = torch.where((ids_t > 0)[:, None], y + delta, y)
    assert torch.equal(out.view(torch.int16), composed.view(torch.int16))
    base = ids_t <= 0
    assert torch.equal(out[base].view(torch.int16), y[base].view(torch.int16))
    outside = (ids_t <= 0) | (ids_t >= pool)
    assert not delta[outside].any()


@pytest.mark.cuda
def test_bgmv_apply_replays_in_a_cuda_graph(cuda):
    """#10's grid is fixed in shape whatever the ids: a captured launch
    replayed gives the eager output bitwise, and new ids written into the
    captured tensor between replays are taken."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    a, b = _lora_stacks(gen, cuda, 1536, 16, 1536)
    x = torch.randn(16, 1536, generator=gen, device=cuda).bfloat16()
    y = torch.randn(16, 1536, generator=gen, device=cuda).bfloat16()
    ids = torch.tensor(LORA_IDS, dtype=torch.int32, device=cuda)
    _replayed(lambda: tlora.bgmv_apply(x, y, a, b, ids))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tlora.bgmv_apply(x, y, a, b, ids)
    ids.copy_(ids.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tlora.bgmv_apply(x, y, a, b, ids))


@pytest.mark.cuda
def test_bgmv_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 64, generator=gen, device=cuda).bfloat16()
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    a, b = _lora_stacks(gen, cuda, 64, 65, 32)
    with pytest.raises(ValueError, match="rank"):
        tlora.bgmv(x, a, b, ids)
    a, b = _lora_stacks(gen, cuda, 64, 8, 32)
    with pytest.raises(TypeError):
        tlora.bgmv(x.float(), a, b, ids)
    y = torch.zeros(4, 32, device=cuda)
    with pytest.raises(TypeError, match="y must be"):
        tlora.bgmv_apply(x, y, a, b, ids)
    assert tlora.bgmv.launches == 0 and tlora.bgmv_apply.launches == 0


# #8 / #9's geometries besides the 600m engine's: (page size, pages per
# slot, kv heads, GQA group, head dim, LoRA rank); positions from
# _decode_positions, a rope table half the slot's capacity (later positions
# clamp to its last row)
FUSED_CASES = [
    (1, 600, 2, 2, 64, 8),        # pages of 1: 3 chunks, a cluster of 3
    (16, 48, 8, 1, 96, 1),        # group 1, rank 1 (lora_h's scalar path)
    (16, 200, 2, 2, 96, 16),      # 13 chunks: clusters of 8, the grid padded to 16
    (64, 32, 8, 2, 96, 64),       # the 600m table at rank 64
    (128, 8, 2, 8, 128, 16),      # pages of 128, group 8
    (16, 40, 1, 16, 64, 8),       # group 16: two row tiles
    (24, 30, 4, 3, 96, 16),       # group 3 in a tile of 4 rows, pages of 24
    (32, 64, 8, 4, 128, 33),      # group 4 at D 128, a rank no multiple of 8
]


def _fused_operands(gen, dev, case, kv_dtype, pos=None, n_adapters=5, ids=None):
    """A ``FUSED_CASES`` geometry's operands as a dict of the op's keyword
    names: ``_decode_operands``' pages, table, positions and q (as q_base),
    x and a pool of ``n_adapters`` (slot 0 null), ids cycling over
    ``LORA_IDS`` (every slot's id a pool slot), and f32 rope tables."""
    from accelerate_tpu_torch.models.llama import rope_frequencies

    page, n, hkv, group, d, rank = case
    q, kp, vp, kw, bt, pos = _decode_operands(gen, dev, case[:5], kv_dtype, pos)
    slots, h = q.shape[:2]
    a, b = _lora_stacks(gen, dev, 1536, rank, h * d, n_adapters=n_adapters)
    ids = [LORA_IDS[i % len(LORA_IDS)] % n_adapters for i in range(slots)] if ids is None else ids
    cos, sin = (torch.from_numpy(t).to(dev) for t in
                rope_frequencies(d, max(1, n * page // 2), 10000.0))
    return dict(x=torch.randn(slots, 1536, generator=gen, device=dev).bfloat16(), q_base=q,
                a_stack=a, b_stack=b, adapter_ids=torch.tensor(ids, dtype=torch.int32, device=dev),
                cos=cos, sin=sin, k_pages=kp, v_pages=vp, block_tables=bt, positions=pos, **kw)


def _fused(ops):
    return tfa.fused_bgmv_paged_decode(**ops)


def _composed(ops):
    """The composed route: #10's bf16 delta, rope, the query rounded to
    bf16, then #4 / #5."""
    from accelerate_tpu_torch.models.llama import apply_rope

    q_base, ids, pos = ops["q_base"], ops["adapter_ids"], ops["positions"]
    slots, h, d = q_base.shape
    delta = tlora.bgmv(ops["x"], ops["a_stack"], ops["b_stack"], ids).reshape(slots, 1, h, d)
    delta = apply_rope(delta.float(), ops["cos"], ops["sin"], pos[:, None])[:, 0]
    q = (q_base.float() + (ids != 0).float()[:, None, None] * delta).bfloat16()
    kw = {k: ops[k] for k in ("k_scales", "v_scales") if k in ops}
    return tfa.paged_decode_attention(q, ops["k_pages"], ops["v_pages"], ops["block_tables"],
                                      pos, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("case", [None] + FUSED_CASES)
def test_fused_bgmv_paged_decode_matches_plain_and_composed(cuda, kv_dtype, case):
    """16 decode slots at the 600m attention geometry (``case`` None): mixed
    adapter ids, a dead slot (position -1: no page is read, zeros),
    positions past the rope table (they clamp to its last row) and page
    edges; and every ``FUSED_CASES`` geometry (pages of 1 to 128, groups 1
    to 16, ranks 1 to 64, a table of 13 chunks) at the split plan's chunk
    edges, before 0 and past the table."""
    from accelerate_tpu_torch.models.llama import rope_frequencies

    if case is None:
        d, rank = 96, 16
        gen = torch.Generator(device=cuda).manual_seed(8)
        if kv_dtype is None:
            kp, vp = _pools(gen, cuda, d)
            kw = {}
        else:
            kp, ks, vp, vs = _quant_pools(gen, cuda, d, kv_dtype)
            kw = dict(k_scales=ks, v_scales=vs)
        pos = torch.tensor([0, 1, 63, 64, 65, 127, 128, 300, 511, 777, 1023, 1024, 1500, 2000,
                            2047, -1], dtype=torch.int32, device=cuda)
        bt = torch.randperm(NUM_PAGES, generator=torch.Generator().manual_seed(1))[:16 * 16]
        bt = torch.cat([bt.reshape(16, 16), bt.reshape(16, 16)], dim=1).to(torch.int32).to(cuda)
        cos, sin = (torch.from_numpy(t).to(cuda) for t in rope_frequencies(d, 1024, 10000.0))
        x = torch.randn(16, 1536, generator=gen, device=cuda).bfloat16()
        q_base = torch.randn(16, H, d, generator=gen, device=cuda).bfloat16()
        a, b = _lora_stacks(gen, cuda, 1536, rank, H * d)
        ids = torch.tensor(LORA_IDS, dtype=torch.int32, device=cuda)
        ops = dict(x=x, q_base=q_base, a_stack=a, b_stack=b, adapter_ids=ids, cos=cos, sin=sin,
                   k_pages=kp, v_pages=vp, block_tables=bt, positions=pos, **kw)
    else:
        gen = torch.Generator(device=cuda).manual_seed(sum(case))
        ops = _fused_operands(gen, cuda, case, kv_dtype or "bf16")
        pos = ops["positions"]
        assert pos.max() >= ops["cos"].shape[0]

    out = _fused(ops)
    torch.cuda.synchronize()
    launched = (tfa.fused_bgmv_paged_decode_quant if "k_scales" in ops
                else tfa.fused_bgmv_paged_decode)
    assert launched.launches == 1
    ref = tfa.fused_bgmv_paged_decode_plain(**ops)
    _assert_rows_close(out, ref)
    dead = pos < 0
    assert dead.any() and not out[dead].any()
    _assert_rows_close(out, _composed(ops))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("case", [(64, 32, HKV, 2, 96, 16), (16, 200, 2, 2, 96, 16)])
def test_fused_decode_is_deterministic_and_slot_independent(cuda, kv_dtype, case):
    """#8 / #9: 20 launches on the same operands bitwise equal to the first
    (h's shares added in rank order, the chunks merged in chunk order), and
    each slot alone bitwise equal to its row of the batch."""
    gen = torch.Generator(device=cuda).manual_seed(case[0] + case[1])
    ops = _fused_operands(gen, cuda, case, kv_dtype)
    first = _fused(ops)
    runs = [_fused(ops) for _ in range(20)]
    per_slot = ("x", "q_base", "adapter_ids", "block_tables", "positions")
    alone = [_fused({k: (v[i:i + 1].contiguous() if k in per_slot else v)
                     for k, v in ops.items()}) for i in range(ops["q_base"].shape[0])]
    torch.cuda.synchronize()
    assert all(torch.equal(run, first) for run in runs)
    for i, out in enumerate(alone):
        assert torch.equal(out[0], first[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_fused_decode_on_two_streams_and_in_a_cuda_graph(cuda, kv_dtype):
    """#8 / #9 keep #4 / #5's merge counters per stream: two streams
    launching at once give each call's own output bitwise; a capture on a
    stream with no counters yet refuses, and one captured after a warm call
    there replays the eager output bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    ops = _fused_operands(gen, cuda, (16, 48, HKV, 2, 96, 16), kv_dtype)
    flipped = {k: (v.flip(0).contiguous() if k in ("x", "q_base", "adapter_ids") else v)
               for k, v in ops.items()}
    _two_streams([lambda: _fused(ops), lambda: _fused(flipped)])
    # a slot count (counter size) that no other call of these tests uses
    k = {"bf16": 7, "int8": 6, "fp8": 5}[kv_dtype]
    few = {key: (v[:k].contiguous() if key in ("x", "q_base", "adapter_ids", "block_tables",
                                               "positions") else v)
           for key, v in ops.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with pytest.raises(RuntimeError, match="before a CUDA graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            _fused(few)
    _replayed(lambda: _fused(few))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("case", [(64, 32, HKV, 2, 96, 16)] + FUSED_CASES)
def test_fused_decode_id0_rows_equal_the_decode_kernel(cuda, kv_dtype, case):
    """An id-0 slot's query is f32(q_base) exactly, and its q_lo rows are
    zero: its rows equal #4's (bf16 pages) or #5's (codes) output on q_base
    bitwise, at every page size and every position of the case."""
    gen = torch.Generator(device=cuda).manual_seed(sum(case) + 1)
    ops = _fused_operands(gen, cuda, case, kv_dtype)
    out = _fused(ops)
    kw = {k: ops[k] for k in ("k_scales", "v_scales") if k in ops}
    base = tfa.paged_decode_attention(ops["q_base"], ops["k_pages"], ops["v_pages"],
                                      ops["block_tables"], ops["positions"], **kw)
    torch.cuda.synchronize()
    zero = ops["adapter_ids"] == 0
    assert zero.any() and (~zero).any()
    assert torch.equal(out[zero], base[zero])


def _split_key_pools(gen, dev, hkv, num_pages, page, d, kv_dtype, scale=48.0):
    """Pages whose every K row is scale * (e_i - e_j) for two random head
    dims i != j (codes: +-QMAX under an amax of ``scale``) and whose V rows
    are written as ``_quant_pool`` / ``_bf16_pool`` write them: a key's
    score is scale * (q_i - q_j) * sm_scale, so a query near 64 in every
    element, whose bf16 rounding moves it by up to 0.25, moves the scores
    by several units."""
    i = torch.randint(0, d, (hkv, num_pages, page, 1), generator=gen, device=dev)
    j = (i + torch.randint(1, d, (hkv, num_pages, page, 1), generator=gen, device=dev)) % d
    unit = torch.zeros(hkv, num_pages, page, d, device=dev)
    unit.scatter_(-1, i, 1.0)
    unit.scatter_(-1, j, -1.0)
    if kv_dtype == "bf16":
        return dict(k_pages=(unit * scale).bfloat16(),
                    v_pages=_bf16_pool(gen, dev, hkv, num_pages, page, d)[1])
    from accelerate_tpu_torch.models.llama import KV_QUANT_DTYPES

    qmax = 127.0 if kv_dtype == "int8" else 448.0
    _, _, vp, vs = _quant_pool(gen, dev, hkv, num_pages, page, d, kv_dtype)
    return dict(k_pages=(unit * qmax).to(KV_QUANT_DTYPES[kv_dtype]), v_pages=vp,
                k_scales=torch.full((hkv, num_pages), scale, device=dev), v_scales=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_fused_decode_keeps_the_f32_query(cuda, kv_dtype):
    """The q-precision case: q_base near 64 and a delta of a few tenths, so
    bf16(q) != q, over keys that weigh differences of q's elements.  The
    kernel's error against the plain version on the f32 query is at most a
    quarter of the distance between the plain version on the f32 query and
    on bf16(q) (what one rounding of q, as the composed route takes it,
    would cost)."""
    page, n, hkv, group, d = 16, 8, 2, 2, 96
    slots, h = 6, 2 * 2
    gen = torch.Generator(device=cuda).manual_seed(31)
    pools = _split_key_pools(gen, cuda, hkv, slots * n, page, d, kv_dtype)
    bt = torch.randperm(slots * n, generator=gen, device=cuda).int().reshape(slots, n)
    pos = torch.tensor([3, 17, 40, 77, 100, 127], dtype=torch.int32, device=cuda)
    a, b = _lora_stacks(gen, cuda, 1536, 16, h * d)
    from accelerate_tpu_torch.models.llama import rope_frequencies

    cos, sin = (torch.from_numpy(t).to(cuda) for t in rope_frequencies(d, 256, 10000.0))
    ops = dict(x=torch.randn(slots, 1536, generator=gen, device=cuda).bfloat16(),
               q_base=(64 + torch.randn(slots, h, d, generator=gen, device=cuda) / 4).bfloat16(),
               a_stack=a, b_stack=b * 0.3,
               adapter_ids=torch.tensor([1, 2, 3, 4, 1, 2], dtype=torch.int32, device=cuda),
               cos=cos, sin=sin, block_tables=bt, positions=pos, **pools)
    out = _fused(ops)
    q = tfa.fused_query_plain(ops["x"], ops["q_base"], ops["a_stack"], ops["b_stack"],
                              ops["adapter_ids"], cos, sin, pos)
    assert (q.bfloat16().float() != q).float().mean() > 0.5
    kw = {k: pools[k] for k in ("k_scales", "v_scales") if k in pools}
    plain = lambda query: tfa.paged_decode_attention_plain(
        query, pools["k_pages"], pools["v_pages"], bt, pos, **kw)
    ref, rounded = plain(q), plain(q.bfloat16().float())
    torch.cuda.synchronize()
    dist = (ref - rounded).abs().max().item()
    err = (out.float() - ref).abs().max().item()
    assert dist > 0.1, dist
    assert err <= dist / 4, (err, dist)
    _assert_rows_close(out, ref)


@pytest.mark.cuda
def test_fused_kernel_refuses_what_it_does_not_take(cuda):
    from accelerate_tpu_torch.models.llama import rope_frequencies

    gen = torch.Generator(device=cuda).manual_seed(9)
    kp, vp = _pools(gen, cuda, 96)
    cos, sin = (torch.from_numpy(t).to(cuda) for t in rope_frequencies(96, 64, 10000.0))
    x = torch.randn(2, 1536, generator=gen, device=cuda).bfloat16()
    q = torch.randn(2, H, 96, generator=gen, device=cuda).bfloat16()
    bt = torch.zeros(2, N, dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda)
    a, b = _lora_stacks(gen, cuda, 1536, 65, H * 96)
    with pytest.raises(ValueError, match="rank"):
        tfa.fused_bgmv_paged_decode(x, q, a, b, ids, cos, sin, kp, vp, bt, pos)
    a, b = _lora_stacks(gen, cuda, 1536, 8, H * 96 - 1)
    with pytest.raises(ValueError, match="b_stack shape"):
        tfa.fused_bgmv_paged_decode(x, q, a, b, ids, cos, sin, kp, vp, bt, pos)
    assert tfa.fused_bgmv_paged_decode.launches == 0


@pytest.mark.cuda
def test_lora_engine_serves_through_the_kernels(cuda):
    """A tiny bf16 model at head dim 64 serving three tenants from a pool of
    two on the card: every request finishes, the pool hot-swaps (this
    trace's host schedule makes two swaps), #10 (``bgmv_apply``, the delta
    and the select in one launch) launches for q_proj and v_proj of every
    layer on every decode step, and every launch of a second serve agrees
    with its plain version on the engine's own operands (the default alpha
    16 over rank 8 gives deltas above 8)."""
    from accelerate_tpu_torch import (
        AdapterStore, GenerationConfig, LlamaConfig, LlamaForCausalLM, LoraPlugin,
        ServingEngine, ServingPlugin, synthesize_trace,
    )

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, seed=0)

    def serve(after_warmup=lambda: None):
        store = AdapterStore(model, LoraPlugin(rank=8, pool_slots=2, kernel="auto"))
        for t in (1, 2, 3):
            store.publish_random(t, torch.Generator().manual_seed(100 + t))
        eng = ServingEngine(model, ServingPlugin(num_slots=4, page_size=16, pages_per_slot=4,
                                                 num_pages=16, prefill_chunk=32),
                            GenerationConfig(max_new_tokens=16), adapters=store)
        eng.warmup()
        tlora.reset_launch_counts()
        after_warmup()
        results = eng.run(synthesize_trace(0, 8, adapters=3))
        return eng, results

    eng, results = serve()
    assert len(results) == 8 and eng.free_page_mirror_in_sync()
    assert eng.adapters.swaps >= 2 and eng.adapters.swap_bytes > 0
    assert tlora.bgmv_apply.launches == 2 * cfg.num_hidden_layers * eng.metrics["decode_steps"]
    assert tlora.bgmv.launches == 0
    real, checked = tlora.bgmv_apply, []

    def held(x, y, a, b, ids):
        out = real(x, y, a, b, ids)
        delta = tlora.bgmv_plain(x.float(), a, b, ids)
        ref = torch.where((ids > 0)[:, None], y.float() + delta, y.float())
        _assert_rows_close(out[:, None], ref[:, None], rounding_slack=True)
        assert torch.equal(out[ids == 0], y[ids == 0])
        checked.append(delta.abs().max().item())
        return out

    tlora.bgmv_apply = held
    try:
        serve(checked.clear)
    finally:
        tlora.bgmv_apply = real
    assert len(checked) == real.launches > 0
    assert max(checked) > 8


# ---------------------------------------------------------------------------
# the shapes of speculative decode and prefix reuse
# ---------------------------------------------------------------------------

# the verify pass of speculative decode at k 4: 16 slots, 5 lanes each (the
# slot's last token and up to 4 drafts), every slot at its own KV length;
# lanes past a slot's draft depth are dead, and near the end of the table
# their positions run past the slot's pages and past the table itself
VERIFY_SEQ = [0, 1, 63, 64, 65, 127, 128, 300, 511, 777, 1023, 1500, 2000, 2043, 2045, 2047]
VERIFY_DEPTH = [4, 0, 1, 4, 2, 3, 4, 0, 4, 1, 2, 3, 4, 4, 2, 0]


def _verify_operands(gen, dev, kv_dtype, width=5, page=PAGE, n=N):
    """q, the pool (and scale keywords), a table and the positions of one
    verify pass.  Each slot owns the distinct pages that hold its live
    lanes; the entries past them hold ids of other slots' pages, as a
    rolled-back page left in the table does.  Returns the live-row mask
    ``[S, width]`` too."""
    from accelerate_tpu_torch.serving.paged_cache import pages_for

    slots = len(VERIFY_SEQ)
    owned = [pages_for(s + d + 1, page) for s, d in zip(VERIFY_SEQ, VERIFY_DEPTH)]
    num_pages = sum(owned) + 8
    if kv_dtype == "bf16":
        kp, vp = _bf16_pool(gen, dev, HKV, num_pages, page, 96)
        kw = {}
    else:
        kp, ks, vp, vs = _quant_pool(gen, dev, HKV, num_pages, page, 96, kv_dtype)
        kw = dict(k_scales=ks, v_scales=vs)
    ids = torch.randperm(num_pages, generator=gen, device=dev).int()
    bt = torch.randint(0, num_pages, (slots, n), generator=gen, device=dev, dtype=torch.int32)
    start = 0
    for s, o in enumerate(owned):
        bt[s, :o] = ids[start:start + o]
        start += o
    lane = torch.arange(width, dtype=torch.int32, device=dev)
    pos = (torch.tensor(VERIFY_SEQ, dtype=torch.int32, device=dev)[:, None] + lane).contiguous()
    live = lane[None] <= torch.tensor(VERIFY_DEPTH, device=dev)[:, None]
    q = torch.randn(slots, width, H, 96, generator=gen, device=dev).bfloat16()
    return q, kp, vp, kw, bt, pos, live, owned


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_multitoken_kernel_at_the_verify_width(cuda, kv_dtype):
    """#6 / #7 at the verify pass's [16, 5]: the live rows agree with the
    plain version; no launch faults on the dead lanes (positions past the
    slot's pages and past the table); the live rows do not depend on what
    the table holds past a slot's pages (other page ids there give the same
    bits); 10 launches are bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, kp, vp, kw, bt, pos, live, owned = _verify_operands(gen, cuda, kv_dtype)
    assert (pos[:, -1] >= N * PAGE).any()
    runs = [tfa.paged_multitoken_attention(q, kp, vp, bt, pos, **kw) for _ in range(10)]
    other = bt.clone()
    for s, o in enumerate(owned):
        other[s, o:] = (other[s, o:] + 1 + s) % kp.shape[1]
    moved = tfa.paged_multitoken_attention(q, kp, vp, other, pos, **kw)
    torch.cuda.synchronize()
    wrapper = tfa.paged_multitoken_attention_quant if kw else tfa.paged_multitoken_attention
    assert wrapper.launches == 11
    out = runs[0]
    assert all(torch.equal(out, r) for r in runs[1:])
    assert torch.equal(out[live], moved[live])
    ref = tfa.paged_multitoken_attention_plain(q.float(), kp if kw else kp.float(),
                                               vp if kw else vp.float(), bt, pos, **kw)
    _assert_rows_close(out[live], ref[live])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("page, shared, width", [(64, 3, 100), (16, 5, 37), (64, 1, 512)])
def test_multitoken_kernel_from_a_page_boundary_over_aliased_pages(cuda, kv_dtype, page,
                                                                   shared, width):
    """A prefix-cache hit: the suffix chunk of slot 1 starts exactly at a
    page boundary, ``shared`` pages in, and its first ``shared`` table
    entries are slot 0's pages.  The output agrees with the plain version
    and is bitwise the output over a table that points at copies of those
    pages."""
    gen = torch.Generator(device=cuda).manual_seed(page + shared + width)
    n = 40 if page == 16 else 16
    num_pages = 3 * n
    if kv_dtype == "bf16":
        kp, vp = _bf16_pool(gen, cuda, HKV, num_pages, page, 96)
        kw = {}
    else:
        kp, ks, vp, vs = _quant_pool(gen, cuda, HKV, num_pages, page, 96, kv_dtype)
        kw = dict(k_scales=ks, v_scales=vs)
    bt = torch.randperm(num_pages, generator=gen, device=cuda).int()[:2 * n].reshape(2, n)
    bt = bt.contiguous()
    bt[1, :shared] = bt[0, :shared]
    pos0 = shared * page
    pos = (torch.tensor([[pos0 + width], [pos0]], dtype=torch.int32, device=cuda)
           + torch.arange(width, dtype=torch.int32, device=cuda)).contiguous()
    q = torch.randn(2, width, H, 96, generator=gen, device=cuda).bfloat16()
    out = tfa.paged_multitoken_attention(q, kp, vp, bt, pos, **kw)
    # the same content in pages of slot 1's own: copies of the shared ones
    free = sorted(set(range(num_pages)) - set(bt.flatten().tolist()))[:shared]
    copied = bt.clone()
    copied[1, :shared] = torch.tensor(free, dtype=torch.int32, device=cuda)
    kp2, vp2 = kp.clone(), vp.clone()
    src = bt[0, :shared].long()
    dst = copied[1, :shared].long()
    kp2[:, dst], vp2[:, dst] = kp[:, src], vp[:, src]
    kw2 = dict(kw)
    if kw:
        kw2 = dict(k_scales=kw["k_scales"].clone(), v_scales=kw["v_scales"].clone())
        for key in kw2:
            kw2[key][:, dst] = kw[key][:, src]
    out2 = tfa.paged_multitoken_attention(q, kp2, vp2, copied, pos, **kw2)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    ref = tfa.paged_multitoken_attention_plain(q.float(), kp if kw else kp.float(),
                                               vp if kw else vp.float(), bt, pos, **kw)
    _assert_rows_close(out, ref)


@pytest.mark.cuda
def test_lora_trainer_step_matches_sequential_on_the_card(cuda):
    """A 2-layer LoraTrainer at the 600m widths on the card: #1-#3 launch
    once a layer a step, the batched loss equals the per-tenant sequential
    schedule (JAX's 1e-2 pin) before and after two steps and so do the
    tenants' gradients after three, a tenant with no
    rows keeps its weights bitwise, and the tenants' state stays in host
    memory."""
    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, LoraPlugin
    from accelerate_tpu_torch.serving import LoraTrainer

    cfg = LlamaConfig(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                      num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
                      max_position_embeddings=4096, attn_implementation="flash")
    trainer = LoraTrainer(LlamaForCausalLM(cfg, device=cuda, seed=0),
                          LoraPlugin(rank=16, pool_slots=4), learning_rate=1e-3)
    for t in range(1, 6):
        trainer.add_adapter(t)
    gen = torch.Generator(device=cuda).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen, device=cuda)
    batch, ids = {"input_ids": toks, "labels": toks}, [1, 0, 2, 1]
    idle = [x.clone() for x in trainer._flat(trainer.adapters[5])]
    for _ in range(3):
        seq = trainer.sequential_loss(batch, ids)
        tfa.reset_launch_counts()
        loss = trainer.step(batch, ids)
        assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (
            2, 2, 2)
        assert abs(loss - seq) <= 1e-2 * abs(seq)
    # at trained adapters each tenant's slice of the batched gradients
    # equals a backward over its rows alone (tenant 1 shares its slot
    # between two rows)
    _, grads = trainer.tenant_grads(batch, ids)
    seq_grads = trainer.sequential_grads(batch, ids)
    assert sorted(seq_grads) == [1, 2]
    for t, tree in seq_grads.items():
        for name, fac in tree.items():
            for f, ref in fac.items():
                err = float((grads[t][name][f] - ref).norm() / ref.norm())
                assert err <= 5e-2, (t, name, f, err)
    assert all(torch.equal(a, b) for a, b in zip(idle, trainer._flat(trainer.adapters[5])))
    assert all(x.device.type == "cpu" and x.is_pinned()
               for x in trainer._flat(trainer.adapters[1]))
    assert trainer.step_log["h2d_bytes"] > 0 and trainer.step_log["d2h_bytes"] > 0


@pytest.mark.cuda
def test_flash_forward_at_the_draft_window(cuda):
    """#1 at a draft model's windowed forward: batch 16, T 32 (a quarter of
    one 128-row tile), 16 q / 8 kv heads, head dim 96, causal."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    q, k, v, _, _, _ = _flash_inputs(gen, cuda, 16, 32, 16, 8, 96, False, False)
    runs = [tfa.flash_attention(q, k, v, causal=True) for _ in range(5)]
    ref = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == 5
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    _assert_rows_close(runs[0], ref)


def _flash_f64(q, k, v, g, g_lse, positions):
    """out, lse, dq, dk, dv of ``sum(out * g) + sum(lse * g_lse)`` in f64
    from the same bf16 operands, causal by position: the ground truth."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    q64, k64, v64 = (x.double().detach().requires_grad_() for x in (q, k, v))
    s = torch.einsum("btkgd,bskd->bkgts", q64.reshape(b, t, hkv, h // hkv, d), k64) / d ** 0.5
    valid = positions[:, :, None] >= positions[:, None, :]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", torch.exp(s - lse[..., None]), v64)
    out = out.reshape(b, t, h, d)
    lse = lse.permute(0, 3, 1, 2).reshape(b, t, h)
    (out * g.double()).sum().add((lse * g_lse.double()).sum()).backward()
    return out, lse, q64.grad, k64.grad, v64.grad


@pytest.mark.cuda
@pytest.mark.parametrize("t", [192, 320])
def test_flash_grads_against_f64_truth(cuda, t):
    """The GQA-4 case with positions of ``test_flash_kernels_match_plain``
    (same operands), #1-#3 and their plain versions each held to the f64
    ground truth of the same bf16 operands: within the row limit plus one
    bf16 rounding of the truth.  Prints both errors per output."""
    import json

    b, h, hkv, d = 2, 16, 4, 96
    gen = torch.Generator(device=cuda).manual_seed(t + d + h)
    q, k, v, g, g_lse, kw = _flash_inputs(gen, cuda, b, t, h, hkv, d, False, True)
    got = _flash_fwd_bwd(tfa.flash_attention, q, k, v, g, g_lse, True, kw)
    plain = _flash_fwd_bwd(tfa.flash_attention_plain, q, k, v, g, g_lse, True, kw)
    truth = _flash_f64(q, k, v, g, g_lse, kw["positions"])
    torch.cuda.synchronize()
    report = {}
    for name, x, p, ref in zip(("out", "lse", "dq", "dk", "dv"), got, plain, truth):
        ref = ref.detach()
        if name == "lse":
            x, p, ref = x[..., None, None], p[..., None, None], ref[..., None, None]
        ek, ep = (x.double() - ref).abs(), (p.double() - ref).abs()
        report[name] = {"kernel_max_abs_err": ek.max().item(), "plain_max_abs_err": ep.max().item(),
                        "max_abs_truth": ref.abs().max().item(),
                        "kernel_vs_plain_max_abs": (x.double() - p.double()).abs().max().item(),
                        "half_bf16_step_at_worst": _half_ulp_bf16(ref.float()).flatten()[
                            ek.flatten().argmax()].item()}
        _assert_rows_close(x, ref.float(), rounding_slack=name != "lse")
        _assert_rows_close(p, ref.float(), rounding_slack=name != "lse")
    print("C2", json.dumps({"t": t, "card": torch.cuda.get_device_name(0), **report}))


def _teacher_forced(model, prompt, tokens):
    """Prompt + tokens[:-1] through the paged path (the prompt as one
    chunk, then one decode step a token), with the paged kernels and with
    their plain versions: both routes' f32 logits, row t predicting token
    t + 1."""
    import accelerate_tpu_torch.models.llama as llama_mod

    seq = list(prompt) + list(tokens[:-1])
    n_pages = -(-len(seq) // 64)
    dev = model.device
    ids = torch.tensor(seq, device=dev)[None]
    pos = torch.arange(len(seq), device=dev)[None]

    def run():
        cache = llama_mod.init_paged_cache(model.config, n_pages, 64, 1, n_pages, device=dev)
        bt = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
        layers = [{**layer, "block_tables": bt} for layer in cache["layers"]]
        out = []
        with torch.inference_mode():
            for a, b in [(0, len(prompt))] + [(t, t + 1) for t in range(len(prompt), len(seq))]:
                logits, layers = model(ids[:, a:b], positions=pos[:, a:b], cache=layers,
                                       cache_write_mask=torch.ones(1, b - a, dtype=torch.bool,
                                                                   device=dev))
                out.append(logits[0])
        return torch.cat(out)

    kernel = run()
    saved = llama_mod.paged_decode_attention, llama_mod.paged_multitoken_attention
    llama_mod.paged_decode_attention = tfa.paged_decode_attention_plain
    llama_mod.paged_multitoken_attention = tfa.paged_multitoken_attention_plain
    try:
        plain = run()
    finally:
        llama_mod.paged_decode_attention, llama_mod.paged_multitoken_attention = saved
    return kernel, plain


@pytest.mark.cuda
def test_speculative_engine_follows_the_token_rule(cuda):
    """A 2-layer model at the 600m widths serves 16 requests greedily and
    speculatively (prompt lookup, k 4: #6 at [16, 5] on every verify pass,
    where greedy decode takes #4).  Each request's tokens equal greedy's,
    or first differ at a near-tie: there the gap between the two tokens'
    logits (greedy's sequence teacher-forced through the kernels) is no
    larger than the largest |logit difference| between the kernels and
    their plain versions at that position."""
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaConfig, LlamaForCausalLM, ServingEngine, ServingPlugin,
        synthesize_trace,
    )
    from accelerate_tpu_torch.serving import verify_serving_invariants

    cfg = LlamaConfig(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                      num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
                      max_position_embeddings=4096, attn_implementation="flash")
    model = LlamaForCausalLM(cfg, seed=0)
    geometry = dict(num_slots=16, page_size=64, pages_per_slot=32, num_pages=256,
                    prefill_chunk=512)
    trace = synthesize_trace(0, 16, vocab_size=32000, mean_interarrival_steps=0.5,
                             prompt_len_range=(64, 512), new_tokens_range=(32, 128))
    gc = GenerationConfig(max_new_tokens=128)
    greedy = ServingEngine(model, ServingPlugin(**geometry), gc).run(trace)
    eng = ServingEngine(model, ServingPlugin(**geometry, speculate="ngram", speculate_k=4), gc)
    spec = eng.run(trace)
    assert eng.metrics["verify_steps"] > 0 and eng.metrics["decode_steps"] == 0
    assert verify_serving_invariants(eng) == []
    for r in trace:
        a, b = greedy[r.uid], spec[r.uid]
        assert len(a) == len(b) == r.max_new_tokens
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        kernel, plain = _teacher_forced(model, r.prompt, a)
        row = r.prompt_len - 1 + i
        gap = (kernel[row, a[i]] - kernel[row, b[i]]).abs().item()
        dlogit = (kernel[row] - plain[row]).abs().max().item()
        print("divergence", r.uid, i, gap, dlogit)
        assert gap <= dlogit, (r.uid, i, gap, dlogit)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_transfer_round_trip_is_bitwise(cuda, kv_dtype):
    """The disaggregated pair's transport on one card: a held slot's pages
    (and, quantized, their scales) gathered on the prefill engine and
    scattered into the decode engine's pool arrive bitwise, the decode
    slot's row and length installed, the free stacks popped by exactly
    the live pages."""
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaConfig, LlamaForCausalLM, Request, ServingEngine, ServingPlugin,
    )
    from accelerate_tpu_torch.serving import PagedKVTransport, pages_for

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=512)
    model = LlamaForCausalLM(cfg, seed=0)
    plugin = ServingPlugin(num_slots=4, page_size=16, pages_per_slot=8, num_pages=32,
                           prefill_chunk=64, kv_dtype=kv_dtype)
    gc = GenerationConfig(max_new_tokens=8)
    src = ServingEngine(model, plugin, gc, hold_finished=True)
    dst = ServingEngine(model, plugin, gc)
    t = PagedKVTransport(src, dst)
    prompt = tuple(range(3, 3 + 57))
    src.add_request(Request(uid=0, prompt=prompt, max_new_tokens=1))
    while not src.held:
        src.step()
    slot = src.held[0]
    n = int(pages_for(len(prompt), 16))
    dst_slot = t.transfer(slot, Request(uid=0, prompt=prompt, max_new_tokens=8),
                          src.results[0][0])
    torch.cuda.synchronize()
    src_row = src.cache["block_tables"][slot, :n].long()
    dst_row = dst.cache["block_tables"][dst_slot, :n].long()
    for sl, dl in zip(src.cache["layers"], dst.cache["layers"]):
        for key in sl:
            a, b = sl[key][:, src_row], dl[key][:, dst_row]
            if a.dtype == torch.float8_e4m3fn:
                a, b = a.view(torch.uint8), b.view(torch.uint8)
            assert torch.equal(a, b), key
    assert int(dst.cache["seq_lens"][dst_slot]) == len(prompt)
    assert int(dst.cache["free_top"]) == 32 - n and dst.sched.free_pages == 32 - n
    assert t.bytes_moved == n * t.schema["page_bytes"]


@pytest.mark.cuda
def test_disaggregated_pair_follows_the_token_rule(cuda):
    """A 2-layer model at the 600m widths served by a prefill -> decode
    pair (#6 on the prefill engine, #4 on the decode engine, the pages
    crossing by the transport) and by one fused engine: each request's
    tokens equal the fused engine's, or first differ at a near-tie; the
    page bytes equal ``transfer_accounting``; the resource contract holds
    on both engines."""
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaConfig, LlamaForCausalLM, ServingEngine, ServingPlugin,
        synthesize_trace,
    )
    from accelerate_tpu_torch.serving import (
        DisaggregatedPair, transfer_accounting, verify_serving_invariants,
    )

    cfg = LlamaConfig(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                      num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
                      max_position_embeddings=4096, attn_implementation="flash")
    model = LlamaForCausalLM(cfg, seed=0)
    plugin = ServingPlugin(num_slots=16, page_size=64, pages_per_slot=32, num_pages=256,
                           prefill_chunk=512)
    trace = synthesize_trace(0, 16, vocab_size=32000, mean_interarrival_steps=0.5,
                             prompt_len_range=(64, 512), new_tokens_range=(32, 128))
    gc = GenerationConfig(max_new_tokens=128)
    fused = ServingEngine(model, plugin, gc).run(trace)
    pair = DisaggregatedPair(model, plugin, gc)
    pair.warmup()
    tfa.reset_launch_counts()
    got = pair.run(trace)
    P, D = pair.prefill_engine, pair.decode_engine
    assert tfa.paged_multitoken_attention.launches == P.metrics["prefill_steps"] * 2 > 0
    assert tfa.paged_decode_attention.launches == D.metrics["decode_steps"] * 2 > 0
    assert pair.report()["page_transfer_bytes"] == \
        transfer_accounting(cfg, trace, 64)["page_transfer_bytes"]
    assert verify_serving_invariants(P) == verify_serving_invariants(D) == []
    for r in trace:
        a, b = fused[r.uid], got[r.uid]
        assert len(a) == len(b) == r.max_new_tokens
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        kernel, plain = _teacher_forced(model, r.prompt, a)
        row = r.prompt_len - 1 + i
        gap = (kernel[row, a[i]] - kernel[row, b[i]]).abs().item()
        dlogit = (kernel[row] - plain[row]).abs().max().item()
        print("divergence", r.uid, i, gap, dlogit)
        assert gap <= dlogit, (r.uid, i, gap, dlogit)


@pytest.mark.cuda
def test_checkpoint_save_resume_and_async_snapshot_on_the_card(cuda, tmp_path):
    """Two layers at the 600m widths, lion-sr on bf16 params through a
    prepared loader (flash #1-#3 on the card): the run twice first (the
    run-to-run check), then a run with an async save after step 1 (step 2
    updates the params in place while it writes) and a save after step 2,
    and a resume in a fresh Accelerator from another init: the async
    checkpoint holds step 1's values, and the resumed run ends where the
    straight run does (bitwise where the two straight runs agree)."""
    import numpy as np

    from accelerate_tpu_torch import (
        Accelerator, DataLoaderConfiguration, GradSyncKwargs, LlamaConfig, LlamaForCausalLM,
        ProjectConfiguration, make_llama_loss_fn,
    )

    cfg = LlamaConfig(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                      num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
                      dtype=torch.bfloat16, attn_implementation="flash")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 256))

    class Rows(torch.utils.data.Dataset):
        def __len__(self):
            return len(tokens)

        def __getitem__(self, i):
            t = torch.from_numpy(tokens[i])
            return {"input_ids": t, "labels": t}

    def run(project, init_seed, save=False, resume=False):
        model = LlamaForCausalLM(cfg, device=cuda, seed=init_seed)
        acc = Accelerator(mixed_precision="bf16", device=cuda,
                          kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")],
                          project_config=ProjectConfiguration(
                              project_dir=str(project), automatic_checkpoint_naming=True),
                          dataloader_config=DataLoaderConfiguration(use_seedable_sampler=True))
        dl = acc.prepare(torch.utils.data.DataLoader(Rows(), batch_size=2, shuffle=True))
        state = acc.create_train_state({n: p.detach() for n, p in model.named_parameters()},
                                       "lion-sr")
        if resume:
            state = acc.maybe_resume(train_state=state)
        step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=4))
        snaps = {}
        for batch in dl:
            state, _ = step(state, batch)
            if save and acc.step_count == 1:
                snaps[1] = [p.clone() for p in state.params.values()]
                snaps["async"] = acc.save_state(train_state=state, async_save=True)
            if save and acc.step_count == 2:
                acc.save_state(train_state=state)
                break
        acc.end_training()
        return acc, state, snaps

    finals = []
    for _ in range(2):
        _, state, _ = run(tmp_path / "clean", 0)
        finals.append([p.clone() for p in state.params.values()] + list(state.opt_state.mu))
    run_to_run = max((a.float() - b.float()).abs().max().item()
                     for a, b in zip(*finals))
    acc, _, snaps = run(tmp_path / "saved", 0, save=True)
    fresh = LlamaForCausalLM(cfg, device=cuda, seed=1)
    template = acc.create_train_state({n: p.detach() for n, p in fresh.named_parameters()},
                                      "lion-sr")
    restored = acc.load_state(snaps["async"], train_state=template)
    for a, b in zip(snaps[1], restored.params.values()):
        assert torch.equal(a, b)
    _, resumed, _ = run(tmp_path / "saved", 1, resume=True)
    got = [p for p in resumed.params.values()] + list(resumed.opt_state.mu)
    worst = max((a.float() - b.float()).abs().max().item() for a, b in zip(finals[0], got))
    assert worst <= run_to_run, (worst, run_to_run)
    assert resumed.opt_state.count == 4
    assert tfa.flash_fwd.launches > 0 and tfa.flash_dq.launches > 0


# -- big-model inference ------------------------------------------------------


def _wide_config(layers: int, dtype=torch.bfloat16):
    from accelerate_tpu_torch import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                       num_hidden_layers=layers, num_attention_heads=16, num_key_value_heads=8,
                       max_position_embeddings=512, dtype=dtype)


@pytest.mark.cuda
def test_streamed_int8_decode_through_the_w8a16_kernels(cuda, tmp_path):
    """Three int8 layers at the 600m widths, one on the card, one in pinned
    host memory, one on disk: the streamed decode launches #11 at prefill
    (m = B * T) and #12 at decode (m = B), every launch of a rerun held to
    its plain version on the same operands; tokens equal ``generate`` on
    the resident model, bitwise, with prefetch on and off."""
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaForCausalLM, QuantizationConfig, StreamStats, dispatch_model,
        generate, generate_streamed, quantize_model_,
    )

    model = quantize_model_(LlamaForCausalLM(_wide_config(3), seed=0),
                            QuantizationConfig(load_in_8bit=True))
    ids = torch.randint(1, 32000, (4, 32), generator=torch.Generator().manual_seed(0))
    gc = GenerationConfig(max_new_tokens=6)
    want = generate(model, ids.to(cuda), gc)
    dispatch_model(model, {"model.layers.1": "cpu", "model.layers.2": "disk"},
                   offload_folder=str(tmp_path))
    assert model.model.layers[1].mlp.up_proj.qcodes.is_pinned()
    tqm.reset_launch_counts()
    stats = StreamStats()
    on = generate_streamed(model, ids, gc, stream_stats=stats)
    layers, dense = 3, 7
    # layers 1 and 2 cross once a forward; layer 0 stays on the card
    streamed = sum(t.numel() * t.element_size() for k, t in model.state_dict().items()
                   if k.startswith(("model.layers.1.", "model.layers.2.")))
    assert stats.h2d_bytes == gc.max_new_tokens * streamed
    assert tqm.quantized_matmul_tiled.launches == dense * layers
    assert tqm.quantized_matmul_wholef.launches == dense * layers * (gc.max_new_tokens - 1)
    assert torch.equal(on, want)
    assert torch.equal(generate_streamed(model, ids, gc, prefetch=False), want)
    real = (tqm.quantized_matmul_tiled, tqm.quantized_matmul_wholef)
    held = []

    def checked(kernel, plain):
        def call(x, codes, scales, *, qblock, out_dtype=None):
            out = kernel(x, codes, scales, qblock=qblock, out_dtype=out_dtype)
            ref = plain(x, codes, scales, qblock=qblock, out_dtype=torch.float32)
            _assert_rows_close(out[:, None], ref[:, None])
            held.append(kernel.__name__)
            return out
        return call

    tqm.quantized_matmul_tiled = checked(real[0], tqm.quantized_matmul_plain)
    tqm.quantized_matmul_wholef = checked(real[1], tqm.quantized_matmul_wholef_plain)
    try:
        generate_streamed(model, ids, gc)
    finally:
        tqm.quantized_matmul_tiled, tqm.quantized_matmul_wholef = real
    assert held.count("quantized_matmul_tiled") == dense * layers
    assert held.count("quantized_matmul_wholef") == dense * layers * (gc.max_new_tokens - 1)


@pytest.mark.cuda
def test_streamed_decode_peak_memory_holds_two_layers(cuda):
    """Six bf16 layers in pinned host memory: the decode's peak device
    memory stays under the embedding, norm and head + (prefetch_depth + 1)
    layers + the KV cache + the f32 logits it captures + 64 MiB, where six
    resident layers would not fit under it; tokens equal ``generate``."""
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaForCausalLM, generate, generate_streamed, place_params_host,
    )
    from accelerate_tpu_torch.big_modeling import compute_module_sizes

    model = LlamaForCausalLM(_wide_config(6), seed=0)
    ids = torch.randint(1, 32000, (4, 64), generator=torch.Generator().manual_seed(1))
    gc = GenerationConfig(max_new_tokens=8)
    want = generate(model, ids.to(cuda), gc)
    sizes = compute_module_sizes(model)
    place_params_host(model)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits = []
    got = generate_streamed(model, ids, gc, capture_logits=logits)
    peak = torch.cuda.max_memory_allocated() - base
    cfg = model.config
    kv = cfg.num_hidden_layers * 2 * 4 * (64 + 8) * cfg.num_key_value_heads * cfg.head_dim * 2
    captured = sum(t.numel() * t.element_size() for t in logits)
    tier = sizes["model.embed_tokens"] + sizes["model.norm"] + sizes["lm_head"]
    bound = tier + 2 * sizes["model.layers.0"] + kv + captured + 64 * 2**20
    assert torch.equal(got, want)
    assert peak <= bound, (peak, bound)
    assert tier + 6 * sizes["model.layers.0"] > bound


@pytest.mark.cuda
def test_beam_search_k1_equals_greedy_on_the_card(cuda):
    from accelerate_tpu_torch import GenerationConfig, LlamaForCausalLM, beam_search, generate

    model = LlamaForCausalLM(_wide_config(2), seed=0)
    ids = torch.randint(1, 32000, (2, 48), generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([48, 30])
    gc = GenerationConfig(max_new_tokens=12)
    greedy = generate(model, ids, gc, prompt_lengths=lens)
    assert torch.equal(beam_search(model, ids, gc, num_beams=1, prompt_lengths=lens), greedy)
    out = beam_search(model, ids, gc, num_beams=4, prompt_lengths=lens)
    assert out.shape == (2, 12) and out.device.type == "cuda"


@pytest.mark.cuda
def test_load_checkpoint_and_serve_equals_the_in_process_engine(cuda, tmp_path):
    """Two layers at the 600m widths written as three HF shards and an
    index, loaded into a meta model by ``load_checkpoint_and_serve``: the
    loaded weights are the in-process ones bitwise, and the engine serves
    their tokens bitwise through #4 / #6."""
    import json

    from accelerate_tpu_torch import (
        GenerationConfig, LlamaForCausalLM, ServingEngine, ServingPlugin, init_empty_weights,
        load_checkpoint_and_serve, synthesize_trace,
    )
    from accelerate_tpu_torch.utils.serialization import save_safetensors

    cfg = _wide_config(2)
    model = LlamaForCausalLM(cfg, seed=0)
    state = model.state_dict()
    names, weight_map = list(state), {}
    for i in range(3):
        fname = f"model-{i + 1:05d}-of-00003.safetensors"
        save_safetensors(tmp_path / fname, {k: state[k] for k in names[i::3]})
        weight_map.update({k: fname for k in names[i::3]})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    with init_empty_weights():
        empty = LlamaForCausalLM(cfg)
    plugin = ServingPlugin(num_slots=4, page_size=64, pages_per_slot=8, num_pages=32,
                           prefill_chunk=256)
    gc = GenerationConfig(max_new_tokens=24)
    engine = load_checkpoint_and_serve(empty, tmp_path, serving_plugin=plugin,
                                       generation_config=gc)
    for k, v in engine.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    trace = synthesize_trace(0, 6, vocab_size=32000, prompt_len_range=(32, 200),
                             new_tokens_range=(8, 24))
    tfa.reset_launch_counts()
    got = engine.run(trace)
    assert tfa.paged_decode_attention.launches > 0
    assert tfa.paged_multitoken_attention.launches > 0
    ref = ServingEngine(model, plugin, gc).run(trace)
    assert got == ref


@pytest.mark.cuda
def test_offload_entry_points_on_the_card(cuda, tmp_path):
    """The big-model entry points off the serve and stream paths, on the
    card at the 600m widths: ``get_max_memory()`` is 0.9 of the free
    memory; ``init_params_leafwise`` draws on the card's generator and pins
    its host layer; ``load_hf_llama`` with ``max_memory`` tiers a file
    over the card, pinned memory and disk, and its streamed tokens are
    ``generate``'s; one layer run through ``AlignDevicesHook`` over
    ``OffloadStore`` memory maps (read into a pinned slot), ``CpuOffloadHook``
    and ``disk_offload`` + ``offloaded_apply`` gives its resident output
    bitwise."""
    import copy

    from accelerate_tpu_torch import (
        AlignDevicesHook, CpuOffloadHook, GenerationConfig, LlamaForCausalLM, abstract_init,
        add_hook_to_module, disk_offload, generate, generate_streamed, get_max_memory,
        init_empty_weights, init_params_leafwise, load_hf_llama,
    )
    from accelerate_tpu_torch.big_modeling import OffloadStore, compute_module_sizes
    from accelerate_tpu_torch.models.llama import LlamaBlock
    from accelerate_tpu_torch.ops.streaming import file_span
    from accelerate_tpu_torch.utils.serialization import save_safetensors

    free, total = torch.cuda.mem_get_info(0)
    budget = get_max_memory()
    assert abs(budget[0] - 0.9 * free) <= 0.01 * total and budget["cpu"] > 0

    cfg = _wide_config(3)
    built = abstract_init(LlamaForCausalLM, cfg)
    init_params_leafwise(built, placement={"model.layers.1": "cpu"})
    assert built.model.layers[1].mlp.up_proj.weight.is_pinned()
    assert built.model.layers[0].mlp.up_proj.weight.device.type == "cuda"
    assert abs(float(built.model.layers[0].mlp.up_proj.weight.float().std()) - 0.02) < 0.002

    model = LlamaForCausalLM(cfg, seed=0)
    save_safetensors(tmp_path / "model.safetensors", model.state_dict())
    sizes = compute_module_sizes(model)
    with init_empty_weights():
        empty = LlamaForCausalLM(cfg)
    tiered, store = load_hf_llama(
        empty, tmp_path / "model.safetensors", offload_folder=str(tmp_path / "off"),
        max_memory={0: sizes[""] - 2 * sizes["model.layers.0"] - sizes["lm_head"],
                    "cpu": sizes["model.layers.0"]})
    layers = tiered.model.layers
    assert layers[0].mlp.up_proj.weight.device.type == "cuda"
    assert layers[1].mlp.up_proj.weight.is_pinned()
    assert file_span(layers[2].mlp.up_proj.weight) is not None
    ids = torch.randint(1, 32000, (2, 32), generator=torch.Generator().manual_seed(4))
    gc = GenerationConfig(max_new_tokens=6)
    assert torch.equal(generate_streamed(tiered, ids, gc), generate(model, ids.to(cuda), gc))

    block = model.model.layers[0]
    x = torch.randn(2, 64, 1536, device=cuda).to(torch.bfloat16)
    args = (x, torch.arange(64, device=cuda).expand(2, -1), model.rope_cos, model.rope_sin)
    with torch.inference_mode():
        ref = block(*args)
        state = {k: v.detach() for k, v in block.state_dict().items()}
        placed, run = disk_offload(dict(state), tmp_path / "layer", apply_fn=block,
                                   execution_device="cuda")
        assert torch.equal(run(placed, *args), ref)
        with init_empty_weights():
            shell = LlamaBlock(cfg)
        hook = AlignDevicesHook("cuda", weights_map={
            k: OffloadStore(tmp_path / "layer").load(k) for k in state})
        add_hook_to_module(shell, hook)
        assert torch.equal(shell(*args), ref) and torch.equal(shell(*args), ref)
        assert hook._staging.buffers[0].is_pinned()
        assert all(p.device.type == "meta" for p in shell.parameters())
        kept = add_hook_to_module(copy.deepcopy(block), CpuOffloadHook("cuda"))
        assert all(p.is_pinned() for p in kept.parameters())
        assert torch.equal(kept(*args), ref)


# -- #1-#3 over f16, the fp8 products, remat and offload on the card ----------


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, h, hkv, d, causal, seg, pos", [
    (2, 256, 4, 2, 64, True, False, False),
    (1, 200, 16, 8, 96, True, False, False),     # T not a multiple of the 64-row tile
    (2, 128, 4, 4, 128, False, False, False),
    (1, 192, 4, 2, 96, True, True, False),       # packed segments
    (1, 192, 4, 2, 96, True, False, True),       # explicit (shuffled) positions
    (2, 2048, 16, 8, 96, True, False, False),    # the 600m training shape at batch 2
    (1, 129, 4, 2, 128, True, False, False),
])
def test_flash_f16_kernels_match_plain(cuda, b, t, h, hkv, d, causal, seg, pos):
    """The f16 instances of #1-#3 against the plain versions on the same
    f16 operands (p and ds rounded to f16 in both)."""
    gen = torch.Generator(device=cuda).manual_seed(t + d + h + 11)
    q, k, v, g, g_lse, kw = _flash_inputs(gen, cuda, b, t, h, hkv, d, seg, pos)
    q, k, v, g = (x.half() for x in (q, k, v, g))
    got = _flash_fwd_bwd(tfa.flash_attention, q, k, v, g, g_lse, causal, kw)
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (1, 1, 1)
    want = _flash_fwd_bwd(tfa.flash_attention_plain, q, k, v, g, g_lse, causal, kw)
    for name, x, ref in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert x.dtype == ref.dtype and x.shape == ref.shape, name
        if name == "lse":
            x, ref = x[..., None, None], ref[..., None, None]
        _assert_rows_close(x, ref, rounding_slack=name in ("dq", "dk", "dv"))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_dq", "flash_dkv"])
def test_flash_f16_backward_is_deterministic(cuda, kernel):
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, g, _, _ = _flash_inputs(gen, cuda, 2, 512, 16, 8, 96, False, False)
    q, k, v, g = (x.half() for x in (q, k, v, g))
    out, lse = tfa.flash_fwd(q, k, v, causal=True, sm_scale=96 ** -0.5)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    fn = getattr(tfa, kernel)
    runs = [fn(q, k, v, g, lse, delta, causal=True, sm_scale=96 ** -0.5) for _ in range(20)]
    torch.cuda.synchronize()
    runs = [r if isinstance(r, tuple) else (r,) for r in runs]
    for later in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], later))


@pytest.mark.cuda
def test_flash_refuses_mixed_dtypes(cuda):
    q = torch.zeros(1, 64, 4, 64, dtype=torch.float16, device=cuda)
    kv = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="float16"):
        tfa.flash_attention(q, kv, kv)
    assert tfa.flash_fwd.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k_in, n_out", [(1536, 1536), (1536, 768), (1536, 4096), (4096, 1536)])
def test_scaled_mm_fp8_matches_plain(cuda, k_in, n_out):
    """Each fp8 product of the dense layers (``torch._scaled_mm``) against
    its plain version on the same codes: forward e4m3 x e4m3, backward dx
    and dw e5m2 x e4m3 (the layouts each operand pair needs)."""
    from accelerate_tpu_torch.ops import precision as prec

    gen = torch.Generator(device=cuda).manual_seed(k_in + n_out)
    m = 512
    x = torch.randn(m, k_in, generator=gen, device=cuda).bfloat16()
    w = (torch.randn(n_out, k_in, generator=gen, device=cuda) / k_in ** 0.5).bfloat16()
    g = torch.randn(m, n_out, generator=gen, device=cuda).bfloat16()
    xs = prec._over(prec.E4M3_MAX, x.float().abs().amax())
    ws = prec._over(prec.E4M3_MAX, w.float().abs().amax())
    gs = prec._over(prec.E5M2_MAX, g.float().abs().amax())
    qx = prec.saturate_cast(x, xs, prec.E4M3_MAX, torch.float8_e4m3fn)
    qw = prec.saturate_cast(w.t(), ws, prec.E4M3_MAX, torch.float8_e4m3fn)
    qg = prec.saturate_cast(g, gs, prec.E5M2_MAX, torch.float8_e5m2)
    prec.fp8_mm.launches = 0
    for a, b, descale in ((qx, qw, xs * ws), (qg, qw.t(), gs * ws), (qg.t(), qx, xs * gs)):
        got = prec.fp8_mm(a, b, descale, torch.float32)
        ref = prec.fp8_mm_plain(a, b, descale, torch.float32)
        # f32 sums of the same fp8 products in two orders: each row within
        # 1e-3 of its largest |value|
        row_err = (got - ref).abs().amax(dim=1)
        assert torch.isfinite(got).all()
        assert (row_err <= 1e-3 * ref.abs().amax(dim=1)).all()
    assert prec.fp8_mm.launches == 3


def _tiny_llama(device, **kw):
    from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256, attn_implementation="flash",
                      dtype=torch.bfloat16, **kw)
    return LlamaForCausalLM(cfg, device=device, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("policy, fwd", [(None, 1), ("full", 2), ("dots", 2), ("offload", 2)])
def test_remat_launch_counts_on_the_card(cuda, policy, fwd):
    """#1 runs again in the backward's recompute under every policy (dots
    saves the products, not the attention); #2 / #3 once a layer; the
    gradients bitwise the plain stack's."""
    ids = torch.randint(0, 512, (2, 128), generator=torch.Generator().manual_seed(0)).to(cuda)
    ref = _tiny_llama(cuda)
    ref(ids, output_hidden=True).float().square().mean().backward()
    model = _tiny_llama(cuda, remat=policy is not None, remat_policy=policy or "full")
    tfa.reset_launch_counts()
    model(ids, output_hidden=True).float().square().mean().backward()
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (
        2 * fwd, 2, 2)
    for (n, a), b in zip(model.named_parameters(), ref.parameters()):
        assert (a.grad is None and b.grad is None) or torch.equal(a.grad, b.grad), n


@pytest.mark.cuda
def test_offload_pipelined_equals_serial_on_the_card(cuda):
    """ZeRO-offload with lion-sr8 on the card: the monolithic host update
    equals the resident one and the pipelined chunked update the serial
    one, bitwise (params, codes, scales); bytes as accounted."""
    from accelerate_tpu_torch import Accelerator, GradSyncKwargs, make_llama_loss_fn
    from accelerate_tpu_torch.ops.streaming import offload_transfer_accounting
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    ids = torch.randint(0, 512, (2, 128), generator=torch.Generator().manual_seed(1)).to(cuda)
    batch = {"input_ids": ids, "labels": ids}
    model = _tiny_llama(cuda)
    start = {n: p.detach().bfloat16().clone() for n, p in model.named_parameters()}
    n_params = sum(p.numel() for p in start.values())
    snaps = {}
    for label, plugin in (
            ("resident", None),
            ("monolithic", FullyShardedDataParallelPlugin(cpu_offload=True)),
            ("serial", FullyShardedDataParallelPlugin(cpu_offload=True,
                                                      host_update_chunk_gib=2e-4,
                                                      host_update_pipeline=False)),
            ("pipelined", FullyShardedDataParallelPlugin(cpu_offload=True,
                                                         host_update_chunk_gib=2e-4,
                                                         host_update_pipeline=True))):
        acc = Accelerator(mixed_precision="bf16", device=cuda, fsdp_plugin=plugin,
                          kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
        state = acc.create_train_state({n: p.clone() for n, p in start.items()}, "lion-sr8")
        step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=2))
        for _ in range(2):
            state, _ = step(state, batch)
            if plugin is not None:
                want = offload_transfer_accounting(n_params, optimizer="lion-sr8")
                assert acc.offload_log["d2h_bytes"] == want["d2h_bytes"]
                assert acc.offload_log["h2d_bytes"] == want["h2d_bytes"]
        if plugin is not None:
            assert all(p.device.type == "cpu" and p.is_pinned() for p in state.params.values())
            assert all(t.is_pinned() for t in state.opt_state.mu)
        snaps[label] = [p.cpu() for p in state.params.values()] + \
            [t.cpu() for t in state.opt_state.mu + state.opt_state.mu_scale]
    for a, b in zip(snaps["monolithic"], snaps["resident"]):
        assert torch.equal(a, b)
    for a, b in zip(snaps["pipelined"], snaps["serial"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["lion-sr8", "adamw-sr8"])
def test_sr8_update_in_slices_is_bitwise_on_the_card(cuda, recipe, monkeypatch):
    """A leaf above ``DEVICE_SLICE`` updates slice by slice on the card:
    params, codes and scales bitwise the one-piece update's over 2 steps
    (a ragged last slice and a leaf below one block included)."""
    from accelerate_tpu_torch.ops import int8_state
    from accelerate_tpu_torch.optimizer import make_optimizer

    gen = torch.Generator(device=cuda).manual_seed(5)
    start = [torch.randn(3, 1000, 77, generator=gen, device=cuda).bfloat16(),
             torch.randn(300, generator=gen, device=cuda).bfloat16(),
             torch.randn(5, generator=gen, device=cuda).bfloat16()]
    grads = [torch.randn(p.shape, generator=gen, device=cuda).bfloat16() for p in start]
    runs = []
    for limit in (1 << 40, 1000):       # one piece; slices of 896 (7 blocks of 128)
        monkeypatch.setattr(int8_state, "DEVICE_SLICE", limit)
        tx = make_optimizer(recipe, 1e-2, weight_decay=0.1)
        params = [p.clone() for p in start]
        state = tx.init(params)
        for _ in range(2):
            params, state = tx.update(grads, state, params)
        runs.append(params + [t for f in state if isinstance(f, list) for t in f])
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(*runs))


# rounds p / ds to bf16 inside the f16 instance, then packs them as f16
_PACK2_BF16_ROUNDED = """
template <bool F16>
__device__ __forceinline__ uint32_t pack2r(float lo, float hi) {
    return pack2<F16>(__bfloat162float(__float2bfloat16_rn(lo)),
                      __bfloat162float(__float2bfloat16_rn(hi)));
}"""


@pytest.mark.cuda
def test_f16_limits_catch_p_and_ds_rounded_to_bf16(cuda, tmp_path, monkeypatch):
    """The f16 limits see the one thing the f16 instances specify: a
    variant of ``flash_attention.cu`` that rounds p and ds to bf16 inside
    its f16 instance (built here from a patched copy of the source) fails
    them on the 600m training shape, where the real instance passes."""
    import shutil

    from accelerate_tpu_torch.ops import _build

    gen = torch.Generator(device=cuda).manual_seed(300)
    q, k, v, g, g_lse, kw = _flash_inputs(gen, cuda, 2, 2048, 16, 8, 96, False, False)
    q, k, v, g = (x.half() for x in (q, k, v, g))
    want = _flash_fwd_bwd(tfa.flash_attention_plain, q, k, v, g, g_lse, True, kw)

    def worst():
        got = _flash_fwd_bwd(tfa.flash_attention, q, k, v, g, g_lse, True, kw)
        return max(_rows_over_limit(x, ref, rounding_slack=name != "out")
                   for name, x, ref in zip(("out", "lse", "dq", "dk", "dv"), got, want)
                   if name != "lse")

    real = worst()
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    cu = src / "flash_attention.cu"
    lines = cu.read_text().split("\n")
    sites = [i for i, line in enumerate(lines)
             if ("pf[" in line or "dsf[" in line) and "pack2<F16>(" in line]
    assert len(sites) == 8      # p in #1 and #3, ds in #2 and #3
    for i in sites:
        lines[i] = lines[i].replace("pack2<F16>(", "pack2r<F16>(")
    cu.write_text("\n".join(lines).replace("using hopper::pack2;",
                                           "using hopper::pack2;" + _PACK2_BF16_ROUNDED, 1))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(_build._LIBS, "flash_attention", None)
    variant = worst()
    assert real <= 1.0 < variant, (real, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_virtual_ring_on_the_kernels(cuda, packed):
    """Context parallelism's ring (cp 4, T 1024, the 600m heads, bf16,
    causal; packed: 3 segments) run rank by rank in one process: 16 launches
    each of #1 / #2 / #3 per pass, with positions and an lse cotangent; out
    / dq / dk / dv held to the same ring on the plain versions, and to one
    unsharded causal call of #1-#3 within one bf16 rounding of |ref| beside
    the row limits (each block's out is rounded to bf16 before the f32
    combine)."""
    from accelerate_tpu_torch.parallel import context_parallel as tcp

    cp, t = 4, 1024
    gen = torch.Generator(device=cuda).manual_seed(31)
    q, g = (torch.randn(1, t, H, 96, generator=gen, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(1, t, HKV, 96, generator=gen, device=cuda).bfloat16() for _ in range(2))
    seg = None
    if packed:
        seg = (torch.arange(t, device=cuda)[None, :, None]
               >= torch.tensor([300, 700], device=cuda)[None, None]).sum(-1).int()

    def ring(plain):
        zq, zk, zv = (tcp.zigzag_shard(x, cp).requires_grad_() for x in (q, k, v))
        out = tcp.virtual_ring_attention(zq, zk, zv, cp, causal=True, plain=plain,
                                         segment_ids=tcp.zigzag_shard(seg, cp)
                                         if seg is not None else None)
        out.backward(tcp.zigzag_shard(g, cp))
        return [tcp.zigzag_unshard(x, cp) for x in (out.detach(), zq.grad, zk.grad, zv.grad)]

    tfa.reset_launch_counts()
    got = ring(plain=False)
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (16,) * 3
    plain = ring(plain=True)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    whole = tfa.flash_attention(qq, kk, vv, causal=True,
                                **({"segment_ids": seg} if seg is not None else {}))
    whole.backward(g)
    for a, b, r in zip(got, plain, (whole.detach(), qq.grad, kk.grad, vv.grad)):
        _assert_rows_close(a, b, rounding_slack=True)
        err = (a.float() - r.float()).abs()
        assert (err <= 2 * _half_ulp_bf16(r) + TOL * r.float().abs().amax()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_virtual_ulysses_on_the_kernels(cuda, packed):
    """Ulysses over a virtual sp 4 world (each rank a thread of one
    process, the all_to_alls in-memory re-layouts) at T 1024 and the 600m
    heads, bf16, causal (packed: 3 segments): 4 launches each of #1 / #2 /
    #3 a pass, each rank's 4 q / 2 kv heads over the whole sequence; out /
    dq / dk / dv held to the same world on the plain versions and to one
    unsharded call of #1-#3 (the same per-head work: within one bf16
    rounding of |ref| beside the row limits)."""
    from accelerate_tpu_torch.parallel.sequence_parallel import make_ulysses_attention
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh
    from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER, ParallelismConfig

    sp, t = 4, 1024
    mesh = VirtualMesh(MESH_AXIS_ORDER, tuple(sp if a == "sp" else 1 for a in MESH_AXIS_ORDER))
    gen = torch.Generator(device=cuda).manual_seed(33)
    q, g = (torch.randn(1, t, H, 96, generator=gen, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(1, t, HKV, 96, generator=gen, device=cuda).bfloat16() for _ in range(2))
    seg = None
    if packed:
        seg = (torch.arange(t, device=cuda)[None, :, None]
               >= torch.tensor([300, 700], device=cuda)[None, None]).sum(-1).int()

    def world(inner):
        attn = make_ulysses_attention(mesh, inner_attn=inner)
        qs, ks, vs = ([c.contiguous().requires_grad_() for c in x.chunk(sp, dim=1)]
                      for x in (q, k, v))
        segs = seg.chunk(sp, dim=1) if seg is not None else [None] * sp
        outs = mesh.run(lambda r: attn(qs[r], ks[r], vs[r], causal=True,
                                       segment_ids=None if segs[r] is None
                                       else segs[r].contiguous()),
                        ParallelismConfig(sp_size=sp))
        torch.autograd.backward(outs, [c.contiguous() for c in g.chunk(sp, dim=1)])
        return [torch.cat(outs, 1).detach()] + [torch.cat([x.grad for x in xs], 1)
                                                for xs in (qs, ks, vs)]

    tfa.reset_launch_counts()
    got = world(None)
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (sp,) * 3
    plain = world(tfa.flash_attention_plain)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    whole = tfa.flash_attention(qq, kk, vv, causal=True,
                                **({"segment_ids": seg} if seg is not None else {}))
    whole.backward(g)
    for a, b, r in zip(got, plain, (whole.detach(), qq.grad, kk.grad, vv.grad)):
        _assert_rows_close(a, b, rounding_slack=True)
        err = (a.float() - r.float()).abs()
        assert (err <= 2 * _half_ulp_bf16(r) + TOL * r.float().abs().amax()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["off", "ring"])
def test_virtual_tp_block_on_the_kernels(cuda, mode):
    """Two layers at the 600m widths (hidden 1536, 16 q / 8 kv heads of
    96, intermediate 4096, vocab 32000), bf16, B 2 x T 256, over a virtual
    tp 4 world: each rank's forward on its slices (#1 at 4 q / 2 kv heads,
    the vocab-parallel fused CE), one backward over the ranks' losses: 8
    launches each of #1-#3; the loss, the grad norm and every re-assembled
    leaf gradient within the batch-2 rule (loss 1e-3, norm 2 %, each leaf
    5 %) of the unsharded step on the kernels and of the unsharded step on
    the plain attention (``native``)."""
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.ops.collective_matmul import collective_matmul
    from accelerate_tpu_torch.parallel.sharding import (
        TRANSFORMER_TP_RULES, make_sharding_plan, tp_shard, tp_split_dim,
    )
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh, module_replica
    from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER, ParallelismConfig

    tp = 4
    cfg = tl.LlamaConfig(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                         num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
                         attn_implementation="flash", dtype=torch.bfloat16)
    model = tl.LlamaForCausalLM(cfg, device=cuda, seed=7)
    params = {n: p.detach() for n, p in model.named_parameters()}
    ids = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(8))
    batch = {"input_ids": ids, "labels": ids}

    def unsharded(impl):
        import dataclasses

        m = tl.LlamaForCausalLM(dataclasses.replace(cfg, attn_implementation=impl),
                                device="meta")
        m.rope_cos, m.rope_sin = model.rope_cos, model.rope_sin
        leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
        loss = tl.make_llama_loss_fn(m, fused_vocab_chunks=4)(leaves, batch).float()
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    layout = tuple(tp if a == "tp" else 1 for a in MESH_AXIS_ORDER)
    plan = make_sharding_plan(params, (MESH_AXIS_ORDER, layout), ParallelismConfig(tp_size=tp),
                              None, TRANSFORMER_TP_RULES)
    names = list(params)
    dims = {n: tp_split_dim(plan[n]) for n in names}
    shards = [{n: tp_shard(params[n], dims[n], tp, r).clone().requires_grad_() for n in names}
              for r in range(tp)]
    replicas = [module_replica(model) for _ in range(tp)]
    mesh = VirtualMesh(MESH_AXIS_ORDER, layout)
    tfa.reset_launch_counts()
    with collective_matmul(mode):
        losses = mesh.run(lambda r: tl.make_llama_loss_fn(replicas[r], fused_vocab_chunks=4)(
            shards[r], batch).float(), ParallelismConfig(tp_size=tp))
    flat = torch.autograd.grad(losses, [s[n] for s in shards for n in names])
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (8,) * 3
    per_rank = [flat[r * len(names):(r + 1) * len(names)] for r in range(tp)]
    grads = [torch.cat([per_rank[r][i] for r in range(tp)], dim=dims[n])
             if dims[n] is not None else per_rank[0][i] for i, n in enumerate(names)]

    for ref_loss, ref_grads in (unsharded("flash"), unsharded("native")):
        _batch2_rule(losses[0], grads, ref_loss, ref_grads, names)


def _batch2_rule(loss, grads, ref_loss, ref_grads, names):
    """Loss 1e-3, grad norm 2 %, each leaf 5 % of the reference step."""
    def norm(gs):
        return torch.sqrt(sum(g.float().square().sum() for g in gs)).item()

    assert abs(loss.item() - ref_loss.item()) <= 1e-3 * abs(ref_loss.item())
    assert abs(norm(grads) - norm(ref_grads)) <= 2e-2 * norm(ref_grads)
    for n, a, b in zip(names, grads, ref_grads):
        rel = (a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)
        assert rel <= 5e-2, (n, rel.item())


@pytest.mark.cuda
def test_virtual_pipeline_on_the_kernels(cuda):
    """Four layers at the 600m widths (hidden 1536, 16 q / 8 kv heads of
    96), bf16, B 4 x T 256 in 4 microbatches of one row, over a virtual pp
    2 world: each layer runs #1 once per microbatch (the bubble runs
    nothing): 16 launches each of #1-#3; the pipelined logits within 2e-2
    of the largest of the unsharded model's on the kernels, the loss and
    the re-assembled gradients within the batch-2 rule of the unsharded
    step on the kernels and on the plain attention; a second pipelined
    step bitwise the first."""
    import dataclasses

    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.pipeline_parallel import prepare_pipeline
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh
    from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER, ParallelismConfig

    pp, mbs = 2, 4
    cfg = tl.LlamaConfig(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                         num_hidden_layers=4, num_attention_heads=16, num_key_value_heads=8,
                         attn_implementation="flash", dtype=torch.bfloat16)
    model = tl.LlamaForCausalLM(cfg, device=cuda, seed=7)
    names = [n for n, _ in model.named_parameters()]
    ids = torch.randint(0, cfg.vocab_size, (4, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(8))
    mesh = VirtualMesh(MESH_AXIS_ORDER, tuple(pp if a == "pp" else 1 for a in MESH_AXIS_ORDER))
    pcfg = ParallelismConfig(pp_size=pp)
    pipes = mesh.run(lambda r: prepare_pipeline(model, num_microbatches=mbs), pcfg)

    def piped():
        def rank(r):
            st = {k: v.detach().requires_grad_() for k, v in pipes[r].stacked.items()}
            rest = {k: v.detach().requires_grad_() for k, v in pipes[r].rest.items()}
            logits = pipes[r](ids, st, rest)
            return tl.causal_lm_loss(logits, ids), logits.detach(), st, rest

        outs = mesh.run(rank, pcfg)
        flat = iter(torch.autograd.grad([o[0] for o in outs], [
            t for o in outs for t in list(o[2].values()) + list(o[3].values())]))
        grads = {}
        for r, o in enumerate(outs):
            for k in o[2]:
                g = next(flat)
                for i in range(g.shape[0]):
                    grads[f"model.layers.{r * g.shape[0] + i}.{k}"] = g[i]
            rest = {k: next(flat) for k in o[3]}
            if r == 0:
                grads.update(rest)
        return outs[0][0], [grads[n] for n in names], outs[0][1]

    def unsharded(impl):
        m = tl.LlamaForCausalLM(dataclasses.replace(cfg, attn_implementation=impl),
                                device="meta")
        m.rope_cos, m.rope_sin = model.rope_cos, model.rope_sin
        leaves = {n: p.detach().clone().requires_grad_() for n, p in model.named_parameters()}
        logits = torch.func.functional_call(m, leaves, (ids,))
        loss = tl.causal_lm_loss(logits, ids)
        return loss, torch.autograd.grad(loss, list(leaves.values())), logits.detach()

    tfa.reset_launch_counts()
    loss, grads, logits = piped()
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (16,) * 3
    again = piped()
    assert torch.equal(again[2], logits) and all(torch.equal(a, b) for a, b in zip(again[1], grads))
    for impl in ("flash", "native"):
        ref_loss, ref_grads, ref_logits = unsharded(impl)
        assert (logits - ref_logits).abs().max() <= TOL * ref_logits.abs().max()
        _batch2_rule(loss, grads, ref_loss, ref_grads, names)


@pytest.mark.cuda
def test_virtual_mixtral_ep_on_the_kernels(cuda):
    """A 2-layer Mixtral at head dim 128, GQA 4 (hidden 1024, 8 q / 2 kv
    heads, 8 experts of intermediate 2048, top 2), bf16, B 2 x T 256:
    #1-#3 at D 128 once a layer; over a virtual ep 4 world (2 experts a
    rank) the loss and the re-assembled gradients within the batch-2 rule
    of the unsharded step on the kernels and on the plain attention, the
    first layer's dispatch bitwise the unsharded forward's, every launch
    held to its plain version, and a second ep step bitwise the first."""
    import dataclasses

    from accelerate_tpu_torch.models import mixtral as tm
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh, module_replica
    from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER, ParallelismConfig

    ep = 4
    cfg = tm.MixtralConfig(vocab_size=32000, hidden_size=1024, intermediate_size=2048,
                           num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
                           num_local_experts=8, attn_implementation="flash",
                           dtype=torch.bfloat16)
    assert cfg.head_dim == 128
    model = tm.MixtralForCausalLM(cfg, device=cuda, seed=3)
    params = {n: p.detach() for n, p in model.named_parameters()}
    names = list(params)
    ids = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(4))
    batch = {"input_ids": ids, "labels": ids}
    routes: list = []
    saved = tm.top_k_routing

    def record(logits, *a, **k):
        out = saved(logits, *a, **k)
        routes.append(out.dispatch)
        return out

    def unsharded(impl):
        m = tm.MixtralForCausalLM(dataclasses.replace(cfg, attn_implementation=impl),
                                  device="meta")
        m.rope_cos, m.rope_sin = model.rope_cos, model.rope_sin
        leaves = {n: p.clone().requires_grad_() for n, p in params.items()}
        loss = tm.make_mixtral_loss_fn(m)(leaves, batch)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    mesh = VirtualMesh(MESH_AXIS_ORDER, tuple(ep if a == "ep" else 1 for a in MESH_AXIS_ORDER))
    replicas = [module_replica(model) for _ in range(ep)]

    def sharded():
        shards = [{n: (p.chunk(ep)[r] if tm.is_expert_leaf(n) else p).detach().requires_grad_()
                   for n, p in params.items()} for r in range(ep)]
        losses = mesh.run(lambda r: tm.make_mixtral_loss_fn(replicas[r])(shards[r], batch),
                          ParallelismConfig(ep_size=ep))
        flat = torch.autograd.grad(losses, [s[n] for s in shards for n in names])
        per = [flat[r * len(names):(r + 1) * len(names)] for r in range(ep)]
        return losses[0], [torch.cat([per[r][i] for r in range(ep)]) if tm.is_expert_leaf(n)
                           else per[0][i] for i, n in enumerate(names)]

    tm.top_k_routing = record
    try:
        ref = unsharded("flash")
        first = routes[0]
        routes.clear()
        tfa.reset_launch_counts()
        loss, grads = sharded()
    finally:
        tm.top_k_routing = saved
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (8,) * 3
    assert torch.equal(routes[0], first)
    again = sharded()
    assert torch.equal(again[0], loss) and all(torch.equal(a, b) for a, b in zip(again[1], grads))
    for ref_loss, ref_grads in (ref, unsharded("native")):
        _batch2_rule(loss, grads, ref_loss, ref_grads, names)
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        plain = getattr(tfa, f"{kernel}_plain")
        orig = getattr(tfa, kernel)
        checked = []

        def held(*a, kernel_fn=orig, plain_fn=plain, **k):
            out = kernel_fn(*a, **k)
            ref_out = plain_fn(*a, **k)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            refs = ref_out if isinstance(ref_out, (tuple, list)) else (ref_out,)
            for o, r in zip(outs, refs):
                o, r = (o[..., None], r[..., None]) if o.dim() == 3 else (o, r)
                err = (o.float() - r.float()).abs()
                assert err.max() <= TOL * r.float().abs().max() + _half_ulp_bf16(r).max()
            checked.append(1)
            return out

        setattr(tfa, kernel, held)
        try:
            sharded()
        finally:
            setattr(tfa, kernel, orig)
        assert len(checked) == 8, kernel


def _rank_grads(cuda, ranks: int = 4):
    """f32 gradients of a 2-layer Llama at the 600m widths (vocab cut to
    2048), bf16, each of ``ranks`` ranks' fwd + bwd through #1-#3 on its
    own row of T 512."""
    from accelerate_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig(vocab_size=2048, hidden_size=1536, intermediate_size=4096,
                         num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
                         attn_implementation="flash", dtype=torch.bfloat16)
    model = tl.LlamaForCausalLM(cfg, device=cuda, seed=11)
    loss_fn = tl.make_llama_loss_fn(model, fused_vocab_chunks=2)
    ids = torch.randint(0, cfg.vocab_size, (ranks, 512), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(12))
    out = []
    for r in range(ranks):
        leaves = {n: p.detach().requires_grad_() for n, p in model.named_parameters()}
        loss = loss_fn(leaves, {"input_ids": ids[r:r + 1], "labels": ids[r:r + 1]})
        out.append({n: g.float() for n, g in
                    zip(leaves, torch.autograd.grad(loss, list(leaves.values())))})
    return out


@pytest.mark.cuda
def test_hierarchical_sync_on_the_card_equals_the_cpu(cuda):
    """The dense hierarchical sync of four ranks' gradients (a virtual dcn 2
    x dp_shard 2 world) on the card against the same sync of the same
    gradients on the CPU, f32 (rtol 1e-5, atol 1e-6), and against their
    mean; #1-#3 launched once a layer a rank."""
    from accelerate_tpu_torch.parallel.hierarchical import hierarchical_sync
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh

    tfa.reset_launch_counts()
    grads = _rank_grads(cuda)
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (8,) * 3

    def sync(gs):
        mesh = VirtualMesh(("dcn", "dp_shard"), (2, 2))
        return mesh.run(lambda r: hierarchical_sync(gs[r], ("dp_shard",), "dcn", mesh=mesh)[0])

    card = sync(grads)
    host = sync([{n: g.cpu() for n, g in gs.items()} for gs in grads])
    for n in grads[0]:
        mean = sum(gs[n].cpu() for gs in grads) / 4
        for r in range(4):
            torch.testing.assert_close(card[r][n].cpu(), host[r][n], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(card[0][n].cpu(), mean, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_powersgd_codec_on_the_card_equals_the_cpu(cuda):
    """The PowerSGD codec over four ranks (a virtual dp_shard 4 world) at rank
    4 on the card against the CPU: the averaged approximation and each
    rank's residual within 1e-4 of the reference's largest |value| (the
    QRs run on different libraries; a flipped column of P leaves both as
    they are)."""
    from accelerate_tpu_torch.parallel.powersgd import compress_decompress, init_powersgd_state
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh

    grads = _rank_grads(cuda)
    qs, errs = init_powersgd_state(grads[0], rank=4, device=cuda)

    def codec(gs, qs, errs):
        mesh = VirtualMesh(("dp_shard",), (4,))
        return mesh.run(lambda r: compress_decompress(gs[r], qs, errs, ("dp_shard",), 4, mesh))

    card = codec(grads, qs, errs)
    to_cpu = lambda tree: {n: t.cpu() if t is not None else None for n, t in tree.items()}
    host = codec([to_cpu(g) for g in grads], to_cpu(qs), to_cpu(errs))
    for r in range(4):
        for i in (0, 2):   # g_hat, residuals
            for n, ref in host[r][i].items():
                if ref is None:
                    continue
                err = (card[r][i][n].cpu() - ref).abs().max().item()
                assert err <= 1e-4 * ref.abs().max().item(), (n, i, err)


@pytest.mark.cuda
def test_peer_snapshot_of_a_card_state_is_bitwise(cuda):
    """A card train state's host snapshot (params, lion-sr momentum and
    count, the CUDA generator) restores bitwise after two more steps
    changed it in place, and verifies."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.resilience.peer_ckpt import (
        capture_host_snapshot, restore_host_snapshot,
    )

    cfg = tl.LlamaConfig(vocab_size=2048, hidden_size=1536, intermediate_size=4096,
                         num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
                         attn_implementation="flash", dtype=torch.bfloat16)
    model = tl.LlamaForCausalLM(cfg, device=cuda, seed=13)
    acc = Accelerator(mixed_precision="bf16", device=cuda)
    state = acc.create_train_state(model, "lion-sr")
    step = acc.prepare_train_step(tl.make_llama_loss_fn(model, fused_vocab_chunks=2))
    ids = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(14))
    batch = {"input_ids": ids, "labels": ids}
    state, _ = step(state, batch)
    snap = capture_host_snapshot(state, step=1)
    want = {n: p.clone() for n, p in state.params.items()}
    mu = [m.clone() for m in state.opt_state.mu]
    rng = state.rng.get_state().clone()
    for _ in range(2):
        state, _ = step(state, batch)
    assert snap.verify()
    restored = restore_host_snapshot(snap, state)
    assert all(torch.equal(restored.params[n], w) for n, w in want.items())
    assert all(torch.equal(a, b) for a, b in zip(restored.opt_state.mu, mu))
    assert restored.opt_state.count == 1 and restored.step == 1
    assert restored.params[next(iter(want))].device.type == "cuda"
    assert torch.equal(restored.rng.get_state(), rng)


@pytest.mark.cuda
def test_sharded_checkpoint_of_a_card_state_over_a_virtual_world_is_bitwise(cuda, tmp_path):
    """A card train state (lion-sr8: bf16 params, int8 codes and per-block
    scales) laid out under FULL_SHARD over a virtual world of 2 (each rank
    restored from the one-process checkpoint), each rank's own shard
    saved from its card tensors, then restored onto one process: every
    param, code and scale bitwise the original state's."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.checkpointing import load_train_state, save_train_state
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.optimizer import flatten_opt_state
    from accelerate_tpu_torch.parallel.fsdp import DataParallelPlan, parallel_align
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh
    from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER, ParallelismConfig
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    cfg = tl.LlamaConfig(vocab_size=2048, hidden_size=1536, intermediate_size=4096,
                         num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
                         attn_implementation="flash", dtype=torch.bfloat16)
    model = tl.LlamaForCausalLM(cfg, device=cuda, seed=13)
    acc = Accelerator(mixed_precision="bf16", device=cuda)
    state = acc.create_train_state(model, "lion-sr8")
    step = acc.prepare_train_step(tl.make_llama_loss_fn(model, fused_vocab_chunks=2))
    ids = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(14))
    state, _ = step(state, {"input_ids": ids, "labels": ids})
    whole_dir, shard_dir = tmp_path / "whole", tmp_path / "sharded"
    save_train_state(whole_dir, state)
    pcfg = ParallelismConfig(dp_shard_size=2)
    plugin = FullyShardedDataParallelPlugin(sharding_strategy="FULL_SHARD")
    mesh = VirtualMesh(MESH_AXIS_ORDER, tuple(2 if a == "dp_shard" else 1
                                              for a in MESH_AXIS_ORDER))

    def rank_save(r):
        plan = DataParallelPlan(mesh, pcfg, plugin, state.params, align=parallel_align(plugin))
        stored = plan.shard_params(state.params)
        template = state.replace(params=stored, opt_state=state.tx.init(plan.opt_params(stored)))
        mine = load_train_state(whole_dir, template, plan)
        return save_train_state(shard_dir, mine, plan), plan.any_sharded

    written = mesh.run(rank_save, pcfg)
    assert all(sharded for _, sharded in written)
    assert {p.name for p in (shard_dir).iterdir()} == {
        "index.json", "shard_00000.safetensors", "shard_00001.safetensors", "state.safetensors"}
    fresh = {n: torch.zeros_like(p) for n, p in state.params.items()}
    template = state.replace(params=fresh, opt_state=state.tx.init(list(fresh.values())),
                             rng=torch.Generator(device=cuda))
    restored = load_train_state(shard_dir, template)
    assert all(torch.equal(restored.params[n], p) for n, p in state.params.items())
    got, want = flatten_opt_state(restored.opt_state)[0], flatten_opt_state(state.opt_state)[0]
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert restored.opt_state.count == state.opt_state.count and restored.step == state.step
    assert restored.params[next(iter(fresh))].device.type == "cuda"


def _recipe_world(cuda, pcfg, start, replicas, mixed_precision="bf16", units=True, **plugin_kw):
    """Every rank of a virtual world of 4 under ``pcfg``: its Accelerator,
    train state over ``start`` (lion-sr8) and prepared step on its module
    replica (``units=False``: the loss without its model's units, so the
    step gathers the whole tree)."""
    from accelerate_tpu_torch import Accelerator, GradSyncKwargs
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh
    from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

    mesh = VirtualMesh(*pcfg.mesh_layout(4))

    def make(r):
        acc = Accelerator(mixed_precision=mixed_precision, device=cuda, parallelism_config=pcfg,
                          fsdp_plugin=FullyShardedDataParallelPlugin(
                              sharding_strategy="FULL_SHARD", **plugin_kw),
                          kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
        state = acc.create_train_state({n: p.clone() for n, p in start.items()}, "lion-sr8")
        loss_fn = tl.make_llama_loss_fn(replicas[r], fused_vocab_chunks=2)
        if not units:
            inner = loss_fn
            loss_fn = lambda p, b: inner(p, b)  # noqa: E731
        return [acc, state, acc.prepare_train_step(loss_fn)]

    return mesh, mesh.run(make, pcfg)


def _recipe_steps(mesh, pcfg, ranks, ids, steps: int) -> list:
    from accelerate_tpu_torch.data_loader import shard_global_batch

    losses = []
    for _ in range(steps):
        def one(r):
            acc, state, step = ranks[r]
            local = shard_global_batch(ids, acc.mesh, pcfg.batch_spec(seq_axis=None, ndim=2))
            ranks[r][1], m = step(state, {"input_ids": local, "labels": local})
            return m["loss"].item()
        losses.append(mesh.run(one, pcfg))
    return losses


def _recipe_start(cuda):
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.virtual import module_replica

    cfg = tl.LlamaConfig(vocab_size=2048, hidden_size=1536, intermediate_size=4096,
                         num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
                         attn_implementation="flash", dtype=torch.bfloat16)
    model = tl.LlamaForCausalLM(cfg, device=cuda, seed=17)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids = torch.randint(0, cfg.vocab_size, (4, 512), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(18))
    return start, [module_replica(model) for _ in range(4)], ids


@pytest.mark.cuda
@pytest.mark.parametrize("reshard", [True, False])
def test_per_unit_gathering_on_the_card_is_the_whole_tree_step(cuda, reshard):
    """A virtual world of 4 on the card, FULL_SHARD, 2 layers at the 600m
    widths: 2 lion-sr8 steps with per-unit gathering are the whole-tree
    step's bitwise (losses, each rank's params, codes and scales), through
    #1-#3 (8 launches each a step: 4 ranks x 2 layers)."""
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    start, replicas, ids = _recipe_start(cuda)
    pcfg = ParallelismConfig(dp_shard_size=4)
    runs = {}
    for units in (True, False):
        mesh, ranks = _recipe_world(cuda, pcfg, start, replicas, units=units,
                                    reshard_after_forward=reshard)
        tfa.reset_launch_counts()
        losses = _recipe_steps(mesh, pcfg, ranks, ids, 2)
        counts = {n: tfa._WRAPPERS[n].launches for n in ("flash_fwd", "flash_dq", "flash_dkv")}
        assert counts == {"flash_fwd": 16, "flash_dq": 16, "flash_dkv": 16}
        runs[units] = (losses, [list(r[1].params.values())
                                + [t for f in r[1].opt_state if isinstance(f, list) for t in f]
                                for r in ranks])
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_fp8_under_tp_and_dp_on_the_card_holds_every_scaled_mm_to_plain(cuda):
    """fp8 delayed scaling over a virtual tp 2 x dp_shard 2 world on the
    card: every ``torch._scaled_mm`` product of a step within 1e-3 of its
    row's largest value of the plain f32 product on the same codes, the
    metas equal on every rank, the losses finite."""
    from accelerate_tpu_torch.ops import fp8 as tfp8
    from accelerate_tpu_torch.ops import precision as prec
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    start, replicas, ids = _recipe_start(cuda)
    pcfg = ParallelismConfig(tp_size=2, dp_shard_size=2)
    mesh, ranks = _recipe_world(cuda, pcfg, start, replicas, mixed_precision="fp8")
    real, seen = prec.fp8_mm, []

    def held(a, b, descale, out_dtype):
        got = real(a, b, descale, torch.float32)
        ref = prec.fp8_mm_plain(a, b, descale, torch.float32)
        seen.append(((got - ref).abs().amax(dim=1)
                     / ref.abs().amax(dim=1).clamp(min=1e-30)).max().item())
        return real(a, b, descale, out_dtype)

    tfp8.fp8_mm = held      # the delayed-scaling products call ops/fp8's name
    try:
        losses = _recipe_steps(mesh, pcfg, ranks, ids, 2)
    finally:
        tfp8.fp8_mm = real
    # 7 denses x 3 products x 2 layers x 4 ranks a step
    assert len(seen) == 2 * 7 * 3 * 2 * 4 and max(seen) <= 1e-3
    assert all(torch.isfinite(torch.tensor(step)).all() for step in losses)
    metas = [r[1].fp8_state for r in ranks]
    assert all(torch.equal(m[k].scale, metas[0][k].scale)
               and torch.equal(m[k].amax_history, metas[0][k].amax_history)
               for m in metas for k in m)


# -- tensor-parallel serving: the kernels on a tp rank's operands ---------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_decode_kernel_at_a_tp_rank_heads(cuda, kv_dtype, tp):
    """#4 / #5 on a tp rank's heads of the 600m serve (16 q / 8 kv heads of
    96: 8 q / 4 kv at tp 2, 4 q / 2 kv at tp 4; ``decode_split_plan``
    splits by the head count): each rank's launch against its plain
    version, and against the one-process launch's rows of the same heads
    within the kernel tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(tp)
    q, kp, vp, kw, bt, pos = _decode_operands(gen, cuda, (PAGE, N, HKV, 2, 96), kv_dtype,
                                              pos=DEC_POS)
    whole = tfa.paged_decode_attention(q, kp, vp, bt, pos, **kw)
    hq, hkv = H // tp, HKV // tp
    for r in range(tp):
        tfa.reset_launch_counts()
        sl = {k: v[r * hkv:(r + 1) * hkv].contiguous() for k, v in kw.items()}
        ops = (q[:, r * hq:(r + 1) * hq].contiguous(), kp[r * hkv:(r + 1) * hkv].contiguous(),
               vp[r * hkv:(r + 1) * hkv].contiguous(), sl, bt, pos)
        _check_decode(*ops)
        out = tfa.paged_decode_attention(ops[0], ops[1], ops[2], bt, pos, **sl)
        _assert_rows_close(out, whole[:, r * hq:(r + 1) * hq])


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_bgmv_apply_on_a_column_slice_of_b(cuda, tp):
    """#10 on a column dense's rank: the rank's columns of ``b`` (q_proj's
    1536 and v_proj's 768 outputs, rank 16), held to its plain version and
    to the whole call's columns within the kernel tolerance, id-0 rows
    ``y`` bitwise."""
    for d_out in (1536, 768):
        tlora.reset_launch_counts()
        gen = torch.Generator(device=cuda).manual_seed(d_out + tp)
        a, b = _lora_stacks(gen, cuda, 1536, 16, d_out)
        x = torch.randn(16, 1536, generator=gen, device=cuda).bfloat16()
        y = torch.randn(16, d_out, generator=gen, device=cuda).bfloat16()
        ids = torch.tensor(LORA_IDS, dtype=torch.int32, device=cuda)
        whole = tlora.bgmv_apply(x, y, a, b, ids)
        n = d_out // tp
        for r in range(tp):
            bs, ys = b[..., r * n:(r + 1) * n].contiguous(), y[:, r * n:(r + 1) * n].contiguous()
            out = tlora.bgmv_apply(x, ys, a, bs, ids)
            delta = tlora.bgmv_plain(x.float(), a, bs, ids)
            ref = torch.where((ids > 0)[:, None], ys.float() + delta, ys.float())
            _assert_rows_close(out[:, None], ref[:, None], rounding_slack=True)
            _assert_rows_close(out[:, None], whole[:, r * n:(r + 1) * n][:, None],
                               rounding_slack=True)
            assert torch.equal(out[ids == 0].view(torch.int16), ys[ids == 0].view(torch.int16))
        torch.cuda.synchronize()
        assert tlora.bgmv_apply.launches == 1 + tp


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("h, f", [(1536, 1536), (4096, 1536)])
def test_qmm_on_a_row_slice_of_the_codes(cuda, tp, h, f):
    """#11 / #12 on a row dense's rank (o_proj, down_proj of the 600m):
    the rank's rows of the codes and the matching columns of the k2d
    scales, each launch held to its plain version; the ranks' partial
    products sum to the whole call's within the kernel tolerance; the
    route picks the kernel the whole call takes."""
    from accelerate_tpu_torch.models.layers import row_slice

    gen = torch.Generator(device=cuda).manual_seed(h + tp)
    qt = _qweight(gen, cuda, h, f)
    for m, wrapper, plain in ((16, tqm.quantized_matmul_tiled, tqm.quantized_matmul_plain),
                              (512, tqm.quantized_matmul_tiled, tqm.quantized_matmul_plain),
                              (4, tqm.quantized_matmul_wholef,
                               tqm.quantized_matmul_wholef_plain)):
        x = torch.randn(m, h, generator=gen, device=cuda).bfloat16()
        whole = tqm.quantized_matmul(x, qt, out_dtype=torch.float32)
        total = torch.zeros_like(whole)
        k = h // tp
        for r in range(tp):
            local = row_slice(qt, tp, r)
            assert tqm._route(m, local, None) == tqm._route(m, qt, None)
            xs = x[:, r * k:(r + 1) * k].contiguous()
            before = wrapper.launches
            out = wrapper(xs, local.data, local.scale, qblock=128, out_dtype=torch.float32)
            assert wrapper.launches == before + 1
            ref = plain(xs, local.data, local.scale, qblock=128, out_dtype=torch.float32)
            _assert_rows_close(out[:, None], ref[:, None])
            total += out
        _assert_rows_close(total[:, None], whole[:, None])


@pytest.mark.cuda
def test_tp2_engine_first_ticks_held_launch_by_launch(cuda):
    """A tiny bf16 model at head dim 64 (4 q / 2 kv heads) served by a
    virtual tp 2 world on the card: every launch of #4 and #6 over each
    rank's pool of one kv head held to its plain version, the serving
    contract on both ranks after every tick, both ranks' event logs and
    block tables equal, and each rank's pool half the one-process pool."""
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaConfig, LlamaForCausalLM, ServingEngine, ServingPlugin,
        synthesize_trace,
    )
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.sharding import bind_tp_slices
    from accelerate_tpu_torch.parallel.virtual import VirtualMesh
    from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER, ParallelismConfig
    from accelerate_tpu_torch.serving import verify_serving_invariants

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=256, attn_implementation="flash")
    model = LlamaForCausalLM(cfg, seed=0)
    plugin = ServingPlugin(num_slots=4, page_size=16, pages_per_slot=4, num_pages=16,
                           prefill_chunk=32)
    mesh = VirtualMesh(MESH_AXIS_ORDER, tuple(2 if a == "tp" else 1 for a in MESH_AXIS_ORDER))
    pcfg = ParallelismConfig(tp_size=2)
    ranks = mesh.run(lambda r: bind_tp_slices(model), pcfg)
    held = {"decode": 0, "prefill": 0}
    real = (tl.paged_decode_attention, tl.paged_multitoken_attention)

    def checked(kind, kernel, plain):
        def call(q, kp, vp, bt, pos, **kw):
            out = kernel(q, kp, vp, bt, pos, **kw)
            ref = plain(q.float(), kp.float(), vp.float(), bt, pos, **kw)
            _assert_rows_close(out.reshape(-1, *out.shape[-2:]), ref.reshape(-1, *ref.shape[-2:]))
            held[kind] += 1
            return out
        return call

    def engine(r):
        eng = ServingEngine(ranks[r], plugin, GenerationConfig(max_new_tokens=12))
        eng.warmup()
        return eng

    engines = mesh.run(engine, pcfg)

    def serve(r):
        eng = engines[r]
        trace = synthesize_trace(0, 6)
        log = []
        pending = sorted(trace, key=lambda q: (q.arrival_step, q.uid))
        while pending or not eng.idle():
            while pending and pending[0].arrival_step <= eng.steps:
                eng.add_request(pending.pop(0))
            eng.step()
            assert verify_serving_invariants(eng) == []
            log.append(eng.cache["block_tables"].cpu().clone())
        return eng, log

    tl.paged_decode_attention = checked("decode", real[0], tfa.paged_decode_attention_plain)
    tl.paged_multitoken_attention = checked("prefill", real[1],
                                            tfa.paged_multitoken_attention_plain)
    try:
        (e0, log0), (e1, log1) = mesh.run(serve, pcfg)
    finally:
        tl.paged_decode_attention, tl.paged_multitoken_attention = real
    layers = cfg.num_hidden_layers
    assert held["decode"] == 2 * layers * e0.metrics["decode_steps"] > 0
    assert held["prefill"] == 2 * layers * e0.metrics["prefill_steps"] > 0
    assert e0.sched.events == e1.sched.events and e0.results == e1.results
    assert all(torch.equal(a, b) for a, b in zip(log0, log1))
    assert e0.kv_heads == e1.kv_heads == 1
    assert e0.cache["layers"][0]["k_pages"].shape[0] == 1
