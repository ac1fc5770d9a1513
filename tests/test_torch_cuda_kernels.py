"""The port's hand-written CUDA kernels held against their plain PyTorch
versions, on the card, at the 600m serving model's shapes (16 q heads over
8 kv heads, pages of 64 tokens, 32 pages per slot) and at the other head
dims the kernels are built for.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance, per query row (one token of one slot, over heads and head dim):
max|out - ref| <= 2e-2 * min(1, max|ref|).  bf16 operands, f32 accumulation
in both, one bf16 rounding of the kernel's output: 2e-2 on rows of O(1),
scaled down with rows that average a deep window, whose outputs are small.
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
    limit = TOL * scale.clamp(min=ROW_SCALE_FLOOR, max=1.0)
    assert torch.isfinite(out).all()
    assert (diff <= limit).all(), (diff / limit).max().item()


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
