"""Context parallelism: the port's zigzag layout and ring attention held
against the JAX package's (``parallel/context_parallel.py``), the ring run
on a 4-rank gloo world (``accelerate_tpu_torch/test_utils/gang.py``)
against JAX's ``make_ring_attention`` on a cp 4 mesh of its CPU devices.

Tolerances: the layouts and positions exactly; the ring's output and
gradients at 1e-5 (f32: the blocks' combine order and the plain flash
blocks against JAX's); the in-process virtual ring against the gang's
ring bitwise in its output and dq (the same blocks combined in the same
order on one thread) and at 1e-6 in dk / dv (each KV shard's gradient is
a sum over the ranks' blocks, added in another order); the cp step's
loss against the single-process step's at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.llama import native_attention as jax_native
from accelerate_tpu.parallel import context_parallel as jcp
from accelerate_tpu.parallelism_config import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu_torch import Accelerator, make_llama_loss_fn
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.parallel import context_parallel as tcp
from accelerate_tpu_torch.test_utils.gang import run_gang

CP = 4
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(rotate, causal, hkv=4, seg=False, seed=0, b=2, t=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    case = {"rotate": rotate, "causal": causal,
            "q": rng.normal(size=(b, t, h, d)).astype(np.float32),
            "k": rng.normal(size=(b, t, hkv, d)).astype(np.float32),
            "v": rng.normal(size=(b, t, hkv, d)).astype(np.float32),
            "g": rng.normal(size=(b, t, h, d)).astype(np.float32), "seg": None}
    if seg:
        case["seg"] = np.repeat([[0] * 10 + [1] * 14 + [2] * 8], b, axis=0).astype(np.int32)
    return case


CASES = ([_case(r, c) for r in ("allgather", "alltoall") for c in (True, False)]
         + [_case("alltoall", True, hkv=2, seed=1),
            _case("allgather", True, hkv=2, seg=True, seed=12),
            _case("alltoall", True, hkv=2, seg=True, seed=12),
            _case("alltoall", False, hkv=2, seg=True, seed=13)])
CASE_IDS = [f"{c['rotate']}-{'causal' if c['causal'] else 'full'}"
            f"{'-gqa' if c['k'].shape[2] != c['q'].shape[2] else ''}"
            f"{'-seg' if c['seg'] is not None else ''}" for c in CASES]


def _tokens():
    return np.random.default_rng(9).integers(0, 256, (4, 32)).astype(np.int32)


@pytest.fixture(scope="module")
def llama_state(tmp_path_factory):
    d = tmp_path_factory.mktemp("cp_llama")
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu", seed=5)
    torch.save(model.state_dict(), d / "tiny.pt")
    return d / "tiny.pt"


@pytest.fixture(scope="module")
def gang(llama_state, tmp_path_factory):
    d = tmp_path_factory.mktemp("cp_gang")
    return run_gang("accelerate_tpu_torch.test_utils.scripts.context_parallel_checks:cp_checks",
                    CP, d, timeout=120, cases=CASES, tokens=_tokens(),
                    llama_state=str(llama_state))


def test_zigzag_layout_and_positions_equal_jax():
    for cp in (1, 2, 4):
        x = np.arange(3 * 8 * cp * 2).reshape(3, 8 * cp * 2)
        want = jcp.zigzag_shard(x, cp)
        np.testing.assert_array_equal(tcp.zigzag_shard(x, cp), want)
        np.testing.assert_array_equal(tcp.zigzag_shard(torch.from_numpy(x), cp).numpy(), want)
        np.testing.assert_array_equal(tcp.zigzag_unshard(want, cp), x)
        np.testing.assert_array_equal(tcp.zigzag_unshard(torch.from_numpy(want), cp).numpy(), x)
        t_local = x.shape[1] // cp
        for rank in range(cp):
            np.testing.assert_array_equal(
                tcp._zigzag_positions(t_local, x.shape[1], rank, cp).numpy(),
                np.asarray(jcp._zigzag_positions(t_local, x.shape[1], rank, cp)))


def test_combine_lse_equals_jax_and_weighs_empty_blocks_zero():
    """JAX's combine from its finite initial lse; a block whose rows saw no
    key (lse near the mask value) adds nothing, whatever its output."""
    rng = np.random.default_rng(3)
    out_a, out_b = (rng.normal(size=(2, 5, 3, 4)).astype(np.float32) for _ in range(2))
    lse_a = rng.normal(size=(2, 5, 3)).astype(np.float32)
    lse_b = np.full((2, 5, 3), -0.7 * np.finfo(np.float32).max + np.log(8), np.float32)
    lse_b[0, 0] = 0.3
    for a, b in (((out_a, lse_a), (out_b, lse_b)),
                 ((np.zeros_like(out_a), np.full_like(lse_a, tcp.NEG_INF)), (out_b, lse_b))):
        jo, jl_ = jcp._combine_lse(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
        to, tl_ = tcp._combine_lse(tuple(map(torch.from_numpy, a)), tuple(map(torch.from_numpy, b)))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    np.testing.assert_array_equal(to.numpy()[1], np.zeros_like(out_a[1]))
    assert tcp.NEG_INF == jcp.NEG_INF


def _jax_ring(case):
    mesh = JaxParallelismConfig(cp_size=CP, devices=jax.devices()[:CP]).build_device_mesh()
    causal = case["causal"]
    attn = jcp.make_ring_attention(mesh, rotate_method=case["rotate"], zigzag=causal,
                                   use_flash=False)
    arrs = {k: case[k] for k in ("q", "k", "v", "g")}
    seg = case["seg"]
    if causal:
        arrs = {k: jcp.zigzag_shard(v, CP) for k, v in arrs.items()}
        seg = jcp.zigzag_shard(seg, CP) if seg is not None else None

    def f(q, k, v):
        out = attn(q, k, v, causal=causal, segment_ids=seg)
        return jnp.sum(out * arrs["g"]), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(arrs[n]) for n in ("q", "k", "v")))
    res = {"out": out, "dq": grads[0], "dk": grads[1], "dv": grads[2]}
    return {k: (jcp.zigzag_unshard(np.asarray(v), CP) if causal else np.asarray(v))
            for k, v in res.items()}


@pytest.mark.parametrize("index", range(len(CASES)), ids=CASE_IDS)
def test_ring_equals_jax_ring_with_gradients(gang, index):
    """JAX ``tests/test_long_context.py:93`` / :109 / :122 / :275 / :291 /
    :314 on the gang: both rotate methods, causal or not, GQA at kv-head
    width, packed segments travelling with K / V; forward and dq / dk / dv
    of a seeded cotangent.  The ring also equals unsharded attention."""
    case = CASES[index]
    want = _jax_ring(case)
    for rank in range(CP):
        got = gang[rank]["cases"][index]
        for name in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(got[name], want[name], **TOL, err_msg=f"{rank} {name}")
    ref = jax_native(jnp.asarray(case["q"]), jnp.asarray(case["k"]), jnp.asarray(case["v"]),
                     causal=case["causal"],
                     segment_ids=None if case["seg"] is None else jnp.asarray(case["seg"]))
    np.testing.assert_allclose(gang[0]["cases"][index]["out"], np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("index", range(len(CASES)), ids=CASE_IDS)
def test_virtual_ring_equals_gang(gang, index):
    """The one-process virtual ring (what the card runs) against the gang's
    ring on the same inputs: output and dq bitwise; dk / dv sum the ranks'
    contributions in another order."""
    rep = gang[0]["cases"][index]["virtual_bitwise"]
    assert rep["out"] and rep["dq"], rep


def test_maybe_context_parallel_equals_jax_buffers(gang):
    """JAX ``tests/test_accelerator.py:532`` / :546: each rank's buffers are
    its contiguous part of the zigzag reorder (JAX's global array's shard);
    without cp they come back as they are."""
    ids = np.arange(2 * 32, dtype=np.int32).reshape(2, 32)
    want = np.split(jcp.zigzag_shard(ids, CP), CP, axis=1)
    for rank in range(CP):
        a, b = gang[rank]["mcp"]
        np.testing.assert_array_equal(a, want[rank])
        np.testing.assert_array_equal(b, want[rank])
        np.testing.assert_array_equal(gang[rank]["mcp_noop"], ids)
        assert gang[rank]["mcp_empty"] == []


def test_cp_step_loss_is_global_token_mean(gang, llama_state):
    """The tiny Llama with ring attention under cp 2 x dp_shard 2 (labels
    pre-shifted, each rank's shard holding a different count of valid
    tokens) reports the single-process step's loss on the same global
    batch, two steps running."""
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32,
                                                    attn_implementation="flash"), device="cpu")
    model.load_state_dict(torch.load(llama_state))
    acc = Accelerator(cpu=True)
    state = acc.create_train_state(model, "adamw")
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=4))
    ids = torch.from_numpy(_tokens()).long()
    shift = torch.roll(ids, -1, dims=1)
    shift[:, -1] = -100
    want = []
    for _ in range(2):
        state, m = step(state, {"input_ids": ids, "shift_labels": shift})
        want.append(m["loss"].item())
    for rank in range(CP):
        np.testing.assert_allclose(gang[rank]["llama"], want, rtol=1e-5)
