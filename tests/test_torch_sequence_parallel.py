"""Ulysses sequence parallelism (``accelerate_tpu_torch/parallel/
sequence_parallel.py``) held against the JAX package's: Ulysses attention
on a 4-rank gloo world (``accelerate_tpu_torch/test_utils/gang.py``)
against JAX's ``make_ulysses_attention`` on an sp 4 mesh of its CPU
devices (``tests/test_long_context.py``'s cases), ``cross_rank_token_mean``,
the sequence-sharded batch, and the tiny Llama with
``attn_implementation="ulysses"`` trained under sp 2, sp 4 and sp 2 x tp 2
in each collective-matmul mode, fed by the prepared loader.

Tolerances: attention outputs and gradients at 1e-5 (f32; the plain
flash blocks against JAX's native attention); the token mean exactly
(JAX's ``pytest.approx``); the 3-step losses at JAX's rtol 2e-4, grad
norms at 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.models import llama as jl
from accelerate_tpu.models.llama import native_attention as jax_native
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu.parallel.sequence_parallel import make_ulysses_attention as jax_ulysses
from accelerate_tpu.parallelism_config import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu_torch import ParallelismConfig
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.parallel import sequence_parallel as tsp
from accelerate_tpu_torch.parallel.virtual import VirtualMesh
from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER
from accelerate_tpu_torch.test_utils.gang import run_gang

MODES = ("off", "ring", "bidir")
SP = 4
CONFIGS = {"sp2": dict(sp_size=2), "sp4": dict(sp_size=4), "sp2_tp2": dict(sp_size=2, tp_size=2)}


def _tokens():
    return np.random.default_rng(3).integers(0, 256, (4, 32)).astype(np.int32)


def _case(causal, h=4, hkv=4, seg=False, seed=0, b=2, t=32, d=8):
    rng = np.random.default_rng(seed)
    case = {"causal": causal,
            "q": rng.normal(size=(b, t, h, d)).astype(np.float32),
            "k": rng.normal(size=(b, t, hkv, d)).astype(np.float32),
            "v": rng.normal(size=(b, t, hkv, d)).astype(np.float32),
            "g": rng.normal(size=(b, t, h, d)).astype(np.float32), "seg": None}
    if seg:
        case["seg"] = np.repeat([[0] * 10 + [1] * 14 + [2] * 8], b, axis=0).astype(np.int32)
    return case


# JAX tests/test_long_context.py:136 (causal, full), :345 (segments),
# :360 (GQA at kv width), :371 (GQA repeated to q width), :146 (3 heads)
CASES = [_case(True), _case(False), _case(True, seg=True, seed=21),
         _case(False, seg=True, seed=21), _case(True, h=8, hkv=4, b=1, seed=22),
         _case(True, h=8, hkv=2, b=1, seed=23), _case(True, h=3, hkv=3, seed=24)]
CASE_IDS = ["causal", "full", "seg-causal", "seg-full", "gqa-kv-width", "gqa-repeated",
            "heads-3"]


@pytest.fixture(scope="module")
def host():
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.LlamaForCausalLM(cfg).init(jax.random.key(0), jnp.asarray(_tokens())[:, :8])
    return jax.tree.map(lambda x: np.array(x, copy=True), params)


@pytest.fixture(scope="module")
def gang(host, tmp_path_factory):
    d = tmp_path_factory.mktemp("sp_state")
    torch.save(torch_state_from_flax(host), d / "tiny.pt")
    script = "accelerate_tpu_torch.test_utils.scripts.tensor_parallel_checks"
    four = run_gang(f"{script}:sp_checks", 4, tmp_path_factory.mktemp("sp4"), timeout=240,
                    state_path=str(d / "tiny.pt"), tokens=_tokens(), cases=CASES)
    two = run_gang(f"{script}:sp_pair_checks", 2, tmp_path_factory.mktemp("sp2"), timeout=120,
                   state_path=str(d / "tiny.pt"), tokens=_tokens())
    return {"four": four, "two": two}


def _jax_attention(case):
    mesh = JaxParallelismConfig(sp_size=SP, devices=jax.devices()[:SP]).build_device_mesh()
    attn = jax_ulysses(mesh)
    spec = NamedSharding(mesh, P(None, "sp", None, None))
    seg = case["seg"]

    def f(q, k, v):
        out = attn(q, k, v, causal=case["causal"], segment_ids=seg)
        return jnp.sum(out * case["g"]), out

    q, k, v = (jax.device_put(jnp.asarray(case[n]), spec) for n in ("q", "k", "v"))
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return {"out": np.asarray(out), "dq": np.asarray(grads[0]), "dk": np.asarray(grads[1]),
            "dv": np.asarray(grads[2])}


@pytest.mark.parametrize("index", range(len(CASES) - 1), ids=CASE_IDS[:-1])
def test_ulysses_attention_equals_jax_with_gradients(gang, index):
    """Each rank's Ulysses attention (two all_to_alls around the plain
    flash blocks; GQA at kv width when sp divides the kv heads, repeated
    otherwise; segment ids gathered) against JAX's on the same inputs,
    forward and the gradients of a seeded cotangent; and against
    unsharded attention."""
    case = CASES[index]
    want = _jax_attention(case)
    for rank in range(SP):
        got = gang["four"][rank]["attention"][index]
        for name in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-5,
                                       err_msg=f"{rank} {name}")
    ref = jax_native(*(jnp.asarray(case[n]) for n in ("q", "k", "v")), causal=case["causal"],
                     segment_ids=None if case["seg"] is None else jnp.asarray(case["seg"]))
    np.testing.assert_allclose(gang["four"][0]["attention"][index]["out"], np.asarray(ref),
                               atol=2e-5)


def test_ulysses_head_divisibility_error(gang):
    """JAX :146: 3 heads over sp 4 raise, naming the divisibility."""
    for rank in range(SP):
        assert "divisible" in gang["four"][rank]["attention"][-1]["error"]


@pytest.mark.parametrize("index", range(len(CASES) - 1), ids=CASE_IDS[:-1])
def test_virtual_ulysses_equals_gang(gang, index):
    """The one-process virtual world (what the card runs: the sp ranks as
    threads in turn, the all_to_alls in-memory re-layouts) against the
    gang on the same inputs: bitwise (the same per-rank blocks)."""
    case = CASES[index]
    vm = VirtualMesh(MESH_AXIS_ORDER, tuple(SP if a == "sp" else 1 for a in MESH_AXIS_ORDER))
    attn = tsp.make_ulysses_attention(vm)
    qs, ks, vs = ([c.contiguous().requires_grad_()
                   for c in torch.from_numpy(case[n]).chunk(SP, dim=1)] for n in ("q", "k", "v"))
    segs = (torch.from_numpy(case["seg"]).chunk(SP, dim=1) if case["seg"] is not None
            else [None] * SP)
    outs = vm.run(lambda r: attn(qs[r], ks[r], vs[r], causal=case["causal"],
                                 segment_ids=segs[r]), ParallelismConfig(sp_size=SP))
    torch.autograd.backward(outs, list(torch.from_numpy(case["g"]).chunk(SP, dim=1)))
    got = gang["four"][0]["attention"][index]
    for name, parts in (("out", [o.detach() for o in outs]), ("dq", [x.grad for x in qs]),
                        ("dk", [x.grad for x in ks]), ("dv", [x.grad for x in vs])):
        np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(), got[name], err_msg=name)
    assert vm.calls["all_to_all"] == 4


def test_cross_rank_token_mean(gang):
    """JAX :167: the mean of 0..31 over sp 4; masked, the sums of the
    masked losses and of the mask over every rank; the local gradient is
    mask / count."""
    loss = np.arange(32.0)
    mask = (np.arange(32) % 3 != 0).astype(np.float64)
    for rank in range(SP):
        rep = gang["four"][rank]["token_mean"]
        assert rep["plain"] == pytest.approx(float(np.mean(loss)))
        assert rep["masked"] == pytest.approx(float((loss * mask).sum() / mask.sum()))
        np.testing.assert_allclose(rep["grad"][0], np.split(mask / mask.sum(), SP)[rank],
                                   rtol=1e-6)


def test_shard_batch_along_sequence_and_positions():
    """Each sp rank's contiguous slice of every [B, T, ...] tensor, labels
    shifted first (``-100`` past the end); 1-d tensors pass; the ranks'
    global positions."""
    ids = torch.arange(2 * 8).reshape(2, 8)
    vm = VirtualMesh(MESH_AXIS_ORDER, tuple(4 if a == "sp" else 1 for a in MESH_AXIS_ORDER))

    def rank_batch(r):
        return (tsp.shard_batch_along_sequence({"input_ids": ids, "labels": ids,
                                                "weight": torch.ones(2)}, vm),
                tsp.shard_positions(2, r))

    out = vm.run(rank_batch, ParallelismConfig(sp_size=4))
    shift = torch.roll(ids, -1, 1)
    shift[:, -1] = -100
    for r, (b, pos) in enumerate(out):
        assert sorted(b) == ["input_ids", "shift_labels", "weight"]
        assert torch.equal(b["input_ids"], ids[:, 2 * r:2 * r + 2])
        assert torch.equal(b["shift_labels"], shift[:, 2 * r:2 * r + 2])
        assert torch.equal(b["weight"], torch.ones(2))
        assert pos.tolist() == [2 * r, 2 * r + 1]
    assert tsp.shard_positions(4, 3).tolist() == [12, 13, 14, 15]


_JAX: dict = {}


def _jax_trajectory(host, label):
    if label in _JAX:
        return _JAX[label]
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    try:
        cfg = CONFIGS[label]
        n = int(np.prod(list(cfg.values())))
        acc = JaxAccelerator(parallelism_config=JaxParallelismConfig(
            **cfg, devices=tuple(jax.devices()[:n])))
        model = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32,
                                                        attn_implementation="ulysses"))
        state = acc.create_train_state(jax.tree.map(jnp.asarray, host),
                                       jax_make_optimizer("adamw", 1e-2), apply_fn=model.apply)
        step = acc.prepare_train_step(jl.make_llama_loss_fn(model), max_grad_norm=1.0)
        ids = jnp.asarray(_tokens())
        out = []
        for _ in range(3):
            state, m = step(state, {"input_ids": ids, "labels": ids})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        _JAX[label] = np.asarray(out)
        return _JAX[label]
    finally:
        JaxAcceleratorState._reset_state(reset_partial_state=True)
        JaxGradientState._reset_state()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_train_step_losses_match_jax(gang, host, label, mode):
    """sp 2, sp 4 (tiny's 2 kv heads repeated to q width) and sp 2 x tp 2
    (sp splits each tp rank's 2 heads) in each mode: every rank reports
    JAX's losses and grad norms over 3 steps.  Under ring / bidir with a
    trivial tp the q / k / v and o_proj ring over sp (the boundary); with
    tp 2 the denses ring over tp and the all_to_alls stay."""
    want = _jax_trajectory(host, label)
    ranks = gang["two"] if label == "sp2" else gang["four"]
    for rep in ranks:
        got = rep[f"{label}_{mode}"]["trajectory"]
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-4)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3)
        assert got[-1, 0] < got[0, 0]


def test_prepared_loader_feeds_the_sequence_slice(gang):
    """Under sp the prepared loader hands each rank its slice with shifted
    labels (JAX's batch spec over sp)."""
    for rep in gang["four"] + gang["two"]:
        for key, run in rep.items():
            if key.startswith("sp"):
                assert run["batch_keys"] == ["input_ids", "shift_labels"], key
