"""The port's flash attention (``accelerate_tpu_torch/ops/flash_attention.py``)
held against the JAX package's.

On the CPU, ``flash_attention`` runs the plain versions of kernels #1-#3;
the JAX function runs its Pallas kernels in interpret mode, as
``tests/test_long_context.py`` runs them.  The same seeded numpy inputs go
to both, and the loss ``sum(out * g) + sum(lse * g_lse)`` exercises the
output's and the logsumexp's gradients at once.  Tolerances: f32 1e-5
(summation order only); bf16 2e-2 (both round ``p`` and ``ds`` to bf16
before their products, the JAX kernel relative to its running max, the
plain version relative to the final max, so one bf16 rounding apart).  The
CUDA kernels are held against the plain versions on the card by
``test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import flash_attention as jfa
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield


def _inputs(seed, b, t, h, hkv, d, s=None):
    """q / g / g_lse over ``t`` rows, k / v over ``s`` keys (``t`` by default)."""
    s = t if s is None else s
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, t, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, t, h, d), (b, t, h))]
    seg = np.sort(rng.integers(0, 3, (b, t)), axis=1).astype(np.int32)
    pos = np.stack([rng.permutation(t) for _ in range(b)]).astype(np.int32)
    return arrays, seg, pos


def _jax_flash(q, k, v, g, g_lse, dtype, **kw):
    def loss(q, k, v):
        out, lse = jfa.flash_attention(q, k, v, block_q=128, block_k=128, return_lse=True,
                                       interpret=True, **kw)
        return (jnp.sum(out.astype(jnp.float32) * g) + jnp.sum(lse * g_lse)), (out, lse)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (_, (out, lse)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, lse, *grads)]


def _port_flash(fn, q, k, v, g, g_lse, dtype, **kw):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    out, lse = fn(tq, tk, tv, return_lse=True, **kw)
    (out.float() * torch.from_numpy(g)).sum().add((lse * torch.from_numpy(g_lse)).sum()).backward()
    return [x.detach().float().numpy() for x in (out, lse, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("case", ["causal", "non_causal", "segments", "positions",
                                  "bf16_causal", "kernel_geometry_bf16_causal",
                                  "kernel_geometry_non_causal_s_ne_t"])
def test_plain_flash_matches_jax_flash(case):
    """T = 200 with 128-row tiles (an out-of-bounds tail in the JAX kernel),
    GQA 4/2, nonzero ``g_lse``; and at the CUDA kernels' own head geometry
    (16 q / 8 kv heads, head dim 96) with T 136, past one 128-row tile (S 200
    in the non-causal case): the plain versions are the card's yardstick
    for kernels #1-#3."""
    if case.startswith("kernel_geometry"):
        s = 200 if case.endswith("s_ne_t") else None
        (q, k, v, g, g_lse), seg, pos = _inputs(0, 1, 136, 16, 8, 96, s=s)
    else:
        (q, k, v, g, g_lse), seg, pos = _inputs(0, 2, 200, 4, 2, 32)
    causal = "non_causal" not in case
    jkw, tkw = {"causal": causal}, {"causal": causal}
    if case == "segments":
        jkw["segment_ids"], tkw["segment_ids"] = jnp.asarray(seg), torch.from_numpy(seg)
    if case == "positions":
        jkw["positions"], tkw["positions"] = jnp.asarray(pos), torch.from_numpy(pos)
    bf16 = "bf16" in case
    want = _jax_flash(q, k, v, g, g_lse, jnp.bfloat16 if bf16 else jnp.float32, **jkw)
    got = _port_flash(tfa.flash_attention, q, k, v, g, g_lse,
                      torch.bfloat16 if bf16 else torch.float32, **tkw)
    tol = dict(atol=2e-2, rtol=2e-2) if bf16 else dict(atol=1e-5, rtol=1e-5)
    for name, x, ref in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, ref, err_msg=name, **tol)
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (0, 0, 0)


def test_plain_flash_matches_native_attention():
    """The flash path against the port's ``native_attention`` (repeated K/V,
    f32 softmax), with and without segments, values and gradients."""
    (q, k, v, g, _), seg, _ = _inputs(1, 2, 48, 4, 2, 16)
    for segment_ids in (None, torch.from_numpy(seg)):
        outs = []
        for fn in (tfa.flash_attention, tl.native_attention):
            tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
            out = fn(tq, tk, tv, causal=True, segment_ids=segment_ids)
            (out * torch.from_numpy(g)).sum().backward()
            outs.append([x.detach().numpy() for x in (out, tq.grad, tk.grad, tv.grad)])
        for a, b in zip(*outs):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_kernel_wrappers_run_plain_versions_on_the_cpu():
    """Each kernel wrapper, given CPU tensors, returns its plain version's
    result and counts no launch."""
    (q, k, v, g, _), _, _ = _inputs(2, 1, 40, 4, 2, 16)
    q, k, v, g = (torch.from_numpy(x) for x in (q, k, v, g))
    kw = dict(causal=True, sm_scale=0.25)
    out, lse = tfa.flash_fwd(q, k, v, **kw)
    ref_out, ref_lse = tfa.flash_fwd_plain(q, k, v, **kw)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse) and lse.shape == (1, 4, 40)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    assert torch.equal(tfa.flash_dq(q, k, v, g, lse, delta, **kw),
                       tfa.flash_dq_plain(q, k, v, g, lse, delta, **kw))
    for a, b in zip(tfa.flash_dkv(q, k, v, g, lse, delta, **kw),
                    tfa.flash_dkv_plain(q, k, v, g, lse, delta, **kw)):
        assert torch.equal(a, b)
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == (0, 0, 0)


def test_front_end_raises_like_jax():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    kv6 = torch.zeros(1, 6, 2, 16)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    cases = [
        (dict(k=torch.zeros(1, 8, 3, 16)), "not divisible"),
        (dict(k=kv6, v=kv6, segment_ids=seg), "requires self-attention"),
        (dict(kv_segment_ids=seg), "requires segment_ids"),
        (dict(segment_ids=torch.zeros(1, 7, dtype=torch.int32),
              kv_segment_ids=seg), "segment_ids length"),
        (dict(positions=seg, kv_positions=torch.zeros(1, 7, dtype=torch.int32)),
         "kv_positions length"),
        (dict(block_q=0), "block_q"),
        (dict(block_k=128), "block_k"),
    ]
    for kw, match in cases:
        args = {"k": kv, "v": kv, **kw}
        with pytest.raises(ValueError, match=match):
            tfa.flash_attention(q, args.pop("k"), args.pop("v"), **args)
        if match not in ("block_q", "block_k"):
            jargs = {key: (jnp.asarray(val.numpy()) if torch.is_tensor(val) else val)
                     for key, val in {"k": kv, "v": kv, **kw}.items()}
            with pytest.raises(ValueError, match=match):
                jfa.flash_attention(jnp.asarray(q.numpy()), jargs.pop("k"), jargs.pop("v"),
                                    interpret=True, **jargs)


@pytest.mark.parametrize("segmented", [False, True])
def test_llama_flash_forward_matches_jax_native(segmented):
    """The tiny model's uncached forward through the flash path (plain on
    the CPU) against the JAX model's native attention, with packed segments
    passed through ``LlamaForCausalLM.forward``."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    jmodel = jl.LlamaForCausalLM(jcfg)
    ids = np.random.default_rng(3).integers(0, 256, (2, 24)).astype(np.int32)
    seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]], np.int32), 8, axis=1)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    tmodel = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32,
                                                     attn_implementation="flash"), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    jseg = jnp.asarray(seg) if segmented else None
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids), segment_ids=jseg))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(),
                     segment_ids=torch.from_numpy(seg) if segmented else None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
