"""The port's hand-written CUDA kernels held against their plain PyTorch
versions, on the card: the paged kernels at the 600m serving model's shapes
(16 q heads over 8 kv heads, pages of 64 tokens, 32 pages per slot), the
flash kernels up to the 600m training shape (T 2048, head dim 96), and the
other head dims the kernels are built for.

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
and dv, with the plain version run on the same bf16 operands; #3 must give
bitwise-equal dk/dv on two runs.
"""

import pytest
import torch

from accelerate_tpu_torch.ops import flash_attention as tfa

TOL = 2e-2
ROW_SCALE_FLOOR = 1e-3
HKV, H, PAGE, N, NUM_PAGES = 8, 16, 64, 32, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    tfa.reset_launch_counts()
    return torch.device("cuda")


def _assert_rows_close(out, ref):
    width = out.shape[-2] * out.shape[-1]
    diff = (out.float() - ref.float()).reshape(-1, width).abs().amax(dim=1)
    scale = ref.float().reshape(-1, width).abs().amax(dim=1)
    floor = ROW_SCALE_FLOOR * scale.max().clamp(max=1.0).item()
    limit = TOL * scale.clamp(min=max(floor, 1e-30), max=1.0)
    assert torch.isfinite(out).all()
    assert (diff <= limit).all(), (diff / limit).max().item()
    assert diff.max() <= TOL * scale.max(), (diff.max() / scale.max()).item()


def _pools(gen, dev, d):
    kp = torch.randn(HKV, NUM_PAGES, PAGE, d, generator=gen, device=dev).bfloat16()
    vp = torch.randn(HKV, NUM_PAGES, PAGE, d, generator=gen, device=dev).bfloat16()
    return kp, vp


@pytest.mark.cuda
@pytest.mark.parametrize("d, h", [(64, 16), (96, 16), (128, 16), (96, 8), (96, 64)])
def test_decode_kernel_matches_plain(cuda, d, h):
    gen = torch.Generator(device=cuda).manual_seed(d + h)
    kp, vp = _pools(gen, cuda, d)
    slots = 16
    bt = torch.randint(0, NUM_PAGES, (slots, N), generator=gen, device=cuda, dtype=torch.int32)
    pos = torch.tensor([0, 1, 63, 64, 65, 127, 128, 300, 511, 777, 1023, 1024, 1500,
                        2000, 2046, 2047], dtype=torch.int32, device=cuda)
    q = torch.randn(slots, h, d, generator=gen, device=cuda).bfloat16()
    out = tfa.paged_decode_attention(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert tfa.paged_decode_attention.launches == 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = tfa.paged_decode_attention_plain(q.float(), kp.float(), vp.float(), bt, pos)
    _assert_rows_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("width, pos0", [(16, 0), (512, 0), (512, 1024), (7, 61), (100, 1948)])
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


def _flash_inputs(gen, dev, b, t, h, hkv, d, seg, pos):
    q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, t, hkv, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, t, hkv, d, generator=gen, device=dev).bfloat16()
    g = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
    g_lse = torch.randn(b, t, h, generator=gen, device=dev)
    kw = {}
    if seg:
        cuts = torch.sort(torch.randint(0, t, (b, 3), generator=gen, device=dev), dim=1).values
        kw["segment_ids"] = (torch.arange(t, device=dev)[None, :, None] >= cuts[:, None]).sum(-1)
    if pos:
        kw["positions"] = torch.stack([torch.randperm(t, generator=gen, device=dev)
                                       for _ in range(b)]).int()
    return q, k, v, g, g_lse, kw


def _flash_fwd_bwd(fn, q, k, v, g, g_lse, causal, kw):
    """out, lse, dq, dk, dv of ``sum(out * g) + sum(lse * g_lse)``."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out, lse = fn(q, k, v, causal=causal, return_lse=True, **kw)
    (out.float() * g.float()).sum().add((lse * g_lse).sum()).backward()
    return out, lse, q.grad, k.grad, v.grad


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, h, hkv, d, causal, seg, pos", [
    (2, 256, 4, 2, 64, True, False, False),
    (1, 200, 16, 8, 96, True, False, False),     # T not a multiple of the 64-row tile
    (2, 128, 4, 4, 128, False, False, False),
    (1, 192, 4, 2, 96, True, True, False),       # packed segments
    (1, 192, 4, 2, 96, True, False, True),       # explicit (shuffled) positions
    (2, 2048, 16, 8, 96, True, False, False),    # the 600m training shape at batch 2
])
def test_flash_kernels_match_plain(cuda, b, t, h, hkv, d, causal, seg, pos):
    gen = torch.Generator(device=cuda).manual_seed(t + d + h)
    q, k, v, g, g_lse, kw = _flash_inputs(gen, cuda, b, t, h, hkv, d, seg, pos)
    got = _flash_fwd_bwd(tfa.flash_attention, q, k, v, g, g_lse, causal, kw)
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (1, 1, 1)
    want = _flash_fwd_bwd(tfa.flash_attention_plain, q, k, v, g, g_lse, causal, kw)
    for name, x, ref in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert x.dtype == ref.dtype and x.shape == ref.shape, name
        if name == "lse":
            x, ref = x[..., None, None], ref[..., None, None]
        _assert_rows_close(x, ref)


@pytest.mark.cuda
def test_flash_dkv_is_deterministic(cuda):
    """The GQA group sum runs inside one block: two runs agree bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, g, _, _ = _flash_inputs(gen, cuda, 2, 512, 16, 8, 96, False, False)
    out, lse = tfa.flash_fwd(q, k, v, causal=True, sm_scale=96 ** -0.5)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    first = tfa.flash_dkv(q, k, v, g, lse, delta, causal=True, sm_scale=96 ** -0.5)
    second = tfa.flash_dkv(q, k, v, g, lse, delta, causal=True, sm_scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


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
