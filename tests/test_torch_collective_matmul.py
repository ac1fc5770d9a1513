"""The ring collective matmul (``accelerate_tpu_torch/ops/collective_matmul.py``)
held against the JAX package's (``ops/collective_matmul.py``): the ring
bodies on a 4-rank gloo world (``accelerate_tpu_torch/test_utils/gang.py``)
against the monolithic bodies, the plain product and JAX's bodies on a
tp 4 mesh of its CPU devices on the same numpy inputs; the knob, the
gates and the hook's ``None`` cases (JAX's tests :159-383, case for case,
on the port's per-rank operands); the overlap accounting; and the
Ulysses boundary, JAX's one red pin on the seed.

Tolerances: f32 rings against the monolithic bodies at 1e-6 (column: the
same rows) and 1e-5 (row: the partial sums added in ring order), against
``x @ w`` and JAX's bodies at 1e-5 (row 1e-4 relative, JAX's own), their
gradients at 1e-4; the integer-valued f32 fixed point bitwise; bf16 at
JAX's 5e-2 / 1e-1; the boundary's losses at JAX's rtol 2e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from shard_map_compat import NO_CHECK, shard_map

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import collective_matmul as jcm
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu.parallelism_config import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch import state as tstate
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.ops import collective_matmul as cm
from accelerate_tpu_torch.parallel.virtual import VirtualMesh
from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER
from accelerate_tpu_torch.test_utils.gang import run_gang
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

WORLD = 4
rng = np.random.default_rng(7)


def _case(dtype="float32", integer=False, k=8):
    if integer:
        x = rng.integers(-8, 9, (2, 16, k)).astype(np.float32)
        w = rng.integers(-8, 9, (k, 24)).astype(np.float32)
    else:
        x = rng.standard_normal((2, 16, k)).astype(np.float32)
        w = rng.standard_normal((k, 24)).astype(np.float32)
    return {"x": x, "w": w, "dtype": dtype, "grads": dtype == "float32" and not integer,
            "g_column": rng.standard_normal((2, 16, 24)).astype(np.float32),
            "g_row": rng.standard_normal((2, 16, 24)).astype(np.float32)}


CASES = [_case(), _case(integer=True), _case("bfloat16", k=32)]


def _tokens():
    return np.random.default_rng(3).integers(0, 256, (4, 32)).astype(np.int32)


@pytest.fixture(scope="module")
def host4():
    """JAX tiny f32 params with 4 kv heads (the boundary's case)."""
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_key_value_heads=4)
    params = jl.LlamaForCausalLM(cfg).init(jax.random.key(0), jnp.asarray(_tokens())[:, :8])
    return jax.tree.map(lambda x: np.array(x, copy=True), params)


@pytest.fixture(scope="module")
def gang(host4, tmp_path_factory):
    d = tmp_path_factory.mktemp("cm_gang")
    torch.save(torch_state_from_flax(host4), d / "tiny4.pt")
    return run_gang("accelerate_tpu_torch.test_utils.scripts.tensor_parallel_checks:cm_checks",
                    WORLD, d, timeout=180, cases=CASES, state_path=str(d / "tiny4.pt"),
                    tokens=_tokens())


# ---------------------------------------------------------------------------
# the ring bodies
# ---------------------------------------------------------------------------


def _jax_bodies(case, kind, mode):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("tp",))
    if mode == "monolithic":
        body = (jcm.all_gather_matmul_monolithic if kind == "column"
                else jcm.matmul_reduce_scatter_monolithic)
        body = functools.partial(body, axis_name="tp")
    else:
        body = (jcm.ring_all_gather_matmul if kind == "column"
                else jcm.ring_matmul_reduce_scatter)
        body = functools.partial(body, axis_name="tp", bidirectional=mode == "bidir")
    specs = ((P(None, "tp", None), P(None, "tp")), P(None, None, "tp")) if kind == "column" \
        else ((P(None, None, "tp"), P("tp", None)), P(None, "tp", None))
    f = shard_map(body, mesh=mesh, in_specs=specs[0], out_specs=specs[1], **NO_CHECK)
    return np.asarray(jax.jit(f)(jnp.asarray(case["x"]), jnp.asarray(case["w"])))


@pytest.mark.parametrize("mode", ["ring", "bidir"])
@pytest.mark.parametrize("kind", ["column", "row"])
def test_ring_bodies_match_monolithic_plain_and_jax(gang, kind, mode):
    """JAX ``tests/test_collective_matmul.py:75`` / :88 on the gang: each
    rank's ring (uni- and bidirectional) against the monolithic body, the
    plain product and JAX's same body on a tp 4 mesh."""
    case = CASES[0]
    want = case["x"] @ case["w"]
    for rank in range(WORLD):
        got = gang[rank]["bodies"]["cases"][0]
        mono = got[f"{kind}_monolithic"]
        tol = 1e-6 if kind == "column" else 1e-5
        np.testing.assert_allclose(got[f"{kind}_{mode}"], mono, rtol=tol, atol=tol)
        np.testing.assert_allclose(got[f"{kind}_{mode}"], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gang[0]["bodies"]["cases"][0][f"{kind}_{mode}"],
                               _jax_bodies(case, kind, mode), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gang[0]["bodies"]["cases"][0][f"{kind}_monolithic"],
                               _jax_bodies(case, kind, "monolithic"), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["ring", "bidir", "monolithic"])
@pytest.mark.parametrize("kind", ["column", "row"])
def test_collective_dense_gradients(gang, kind, mode):
    """JAX :127: the gradients of ``sum(sin(y) * g)`` through the ring
    (autograd through the differentiable permute) equal the plain
    product's and JAX's through its ring."""
    case = CASES[0]
    x, w = torch.from_numpy(case["x"]).requires_grad_(), torch.from_numpy(case["w"])
    w = w.clone().requires_grad_()
    (torch.sin(x @ w) * torch.from_numpy(case[f"g_{kind}"])).sum().backward()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("tp",))
    fn = jcm.make_collective_dense(mesh, "tp", kind, "ring" if mode == "monolithic" else mode)
    gj = jax.grad(lambda a, b: jnp.sum(jnp.sin(fn(a, b)) * case[f"g_{kind}"]),
                  argnums=(0, 1))(jnp.asarray(case["x"]), jnp.asarray(case["w"]))
    for rank in range(WORLD):
        got = gang[rank]["bodies"]["cases"][0]
        np.testing.assert_allclose(got[f"{kind}_{mode}_dx"], x.grad.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got[f"{kind}_{mode}_dw"], w.grad.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got[f"{kind}_{mode}_dx"], np.asarray(gj[0]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got[f"{kind}_{mode}_dw"], np.asarray(gj[1]), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["column", "row"])
def test_unidirectional_ring_exact_f32_fixed_point(gang, kind):
    """JAX :100: integer-valued f32 operands sum exactly in any order, so
    the ring, the bidirectional ring and the monolithic body are bitwise
    ``x @ w``."""
    case = CASES[1]
    want = case["x"] @ case["w"]
    for rank in range(WORLD):
        got = gang[rank]["bodies"]["cases"][1]
        for mode in ("ring", "bidir", "monolithic"):
            np.testing.assert_array_equal(got[f"{kind}_{mode}"], want, err_msg=mode)


def test_ring_bodies_bf16_tolerance(gang):
    """JAX :114: bf16 operands, the ring against the f32 product."""
    case = CASES[2]
    want = case["x"].astype(np.float32) @ case["w"].astype(np.float32)
    x = torch.from_numpy(case["x"]).bfloat16().float().numpy()
    w = torch.from_numpy(case["w"]).bfloat16().float().numpy()
    for rank in range(WORLD):
        for kind in ("column", "row"):
            for mode in ("ring", "bidir"):
                got = gang[rank]["bodies"]["cases"][2][f"{kind}_{mode}"]
                np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-1)
                np.testing.assert_allclose(got, x @ w, rtol=5e-2, atol=1e-1)


# ---------------------------------------------------------------------------
# knob resolution and gating
# ---------------------------------------------------------------------------


@pytest.fixture
def no_override():
    prev = cm.set_collective_matmul(None)
    yield
    cm.set_collective_matmul(prev)


def test_mode_normalization_and_env(monkeypatch, no_override):
    """JAX :159."""
    assert cm.normalize_mode("on") == "ring"
    assert cm.normalize_mode("BIDIRECTIONAL") == "bidir"
    assert cm.normalize_mode("off") == "off"
    with pytest.raises(ValueError):
        cm.normalize_mode("sideways")
    monkeypatch.setenv("ACCELERATE_COLLECTIVE_MATMUL", "on")
    assert cm.collective_matmul_mode() == "ring"
    monkeypatch.delenv("ACCELERATE_COLLECTIVE_MATMUL")
    assert cm.collective_matmul_mode() == "off"
    prev = cm.set_collective_matmul("bidir")
    try:
        assert cm.collective_matmul_mode() == "bidir"
        with cm.collective_matmul("off"):
            assert cm.collective_matmul_mode() == "off"
        assert cm.collective_matmul_mode() == "bidir"
    finally:
        cm.set_collective_matmul(prev)
    for name in ("off", "false", "0", "none", "", "on", "ring", "true", "1", "uni", "bidir",
                 "bidirectional"):
        assert cm.normalize_mode(name) == jcm.normalize_mode(name)


def test_plugin_knob_normalizes_and_installs(monkeypatch, no_override):
    """JAX :179: the plugin reads the env default, normalises, refuses an
    unknown mode, and the Accelerator installs its knob."""
    monkeypatch.setenv("ACCELERATE_COLLECTIVE_MATMUL", "bidir")
    assert FullyShardedDataParallelPlugin().collective_matmul == "bidir"
    monkeypatch.delenv("ACCELERATE_COLLECTIVE_MATMUL")
    plugin = FullyShardedDataParallelPlugin(collective_matmul="on")
    assert plugin.collective_matmul == "ring"
    with pytest.raises(ValueError):
        FullyShardedDataParallelPlugin(collective_matmul="sideways")
    Accelerator(cpu=True, fsdp_plugin=plugin)
    assert cm.collective_matmul_mode() == "ring"


def test_plugin_less_accelerator_clears_stale_override(no_override):
    """JAX :195: an Accelerator built without a plugin clears the mode an
    earlier one installed."""
    Accelerator(cpu=True, fsdp_plugin=FullyShardedDataParallelPlugin(collective_matmul="ring"))
    assert cm.collective_matmul_mode() == "ring"
    Accelerator(cpu=True)
    assert cm.collective_matmul_mode() == "off"


def _layout(**sizes):
    return MESH_AXIS_ORDER, tuple(sizes.get(a, 1) for a in MESH_AXIS_ORDER)


def test_ring_supported_gating():
    """JAX :211 (its old-jax clause dropped: every multi-axis mesh rings)."""
    assert cm.ring_supported(_layout(tp=8), "tp")
    assert not cm.ring_supported(_layout(tp=8), "sp")
    assert not cm.ring_supported(None, "tp")
    assert not cm.ring_supported(_layout(tp=1), "tp")
    assert cm.ring_supported(_layout(dp_shard=4, tp=2), "tp")


def test_dense_hook_cases(gang):
    """JAX :224 on the gang's tp 4 ranks: off is None; ring equals the
    plain product; a row sequence that does not split, a contraction
    mismatch, a 2-D input and an unknown kind are None."""
    case = CASES[0]
    for rank in range(WORLD):
        hook = gang[rank]["bodies"]["hook"]
        assert hook["off"]
        np.testing.assert_allclose(hook["ring"], case["x"] @ case["w"], rtol=1e-5, atol=1e-5)
        for key in ("row_seq_not_dividing", "contraction_mismatch", "2d_input", "bad_kind"):
            assert hook[key], key


def test_dense_hook_without_accelerator_state_is_none(monkeypatch):
    """JAX :242: no ambient mesh, no ring."""
    monkeypatch.setattr(tstate, "_AMBIENT", {"mesh": None, "config": None})
    x, w = torch.randn(2, 16, 16), torch.randn(32, 16)
    with cm.collective_matmul("ring"):
        assert cm.dense_collective_matmul(x, w, "column") is None


def test_ulysses_sp_boundary_gating(gang, monkeypatch):
    """JAX :318 (the gang's sp 4 ranks): off is False; on, heads, kv heads
    and the sequence must divide sp; composed sp x tp keeps the
    all_to_alls."""
    for rank in range(WORLD):
        gate = gang[rank]["boundary"]["gate"]
        assert gate == {"on": True, "heads": False, "kv_heads": False, "seq": False,
                        "off": False}
    monkeypatch.setattr(tstate, "_AMBIENT",
                        {"mesh": VirtualMesh(*_layout(sp=2, tp=2)), "config": None})
    with cm.collective_matmul("ring"):
        assert not cm.ulysses_sp_boundary(4, 4, 32)


# ---------------------------------------------------------------------------
# overlap accounting
# ---------------------------------------------------------------------------


def test_tp_comm_accounting_envelope():
    """JAX :370 with the H100 SXM's defaults (NVLink 4 at 450 GB/s a
    direction, 989 TFLOP/s bf16 dense); the prediction is recorded as a
    twin."""
    from accelerate_tpu_torch.telemetry import twin_registry

    rep = cm.tp_comm_accounting(8 * 2048, 4096, 11008, 4)
    assert rep["kind"] == "predicted"
    assert 0.0 <= rep["tp_overlap_frac"] <= 1.0
    assert rep["steps"] == 3 and rep["ring_size"] == 4
    assert twin_registry().get("tp_comm.overlap_frac") is not None
    bi = cm.tp_comm_accounting(8 * 2048, 4096, 11008, 4, bidirectional=True)
    assert bi["steps"] == 2
    triv = cm.tp_comm_accounting(8 * 2048, 4096, 11008, 1)
    assert triv["steps"] == 0 and triv["tp_overlap_frac"] == 0.0
    starved = cm.tp_comm_accounting(64, 64, 64, 8, link_gbs=1e-3)
    assert starved["tp_overlap_frac"] < 1.0
    # JAX's formula: the same shape on JAX's link and peak gives JAX's answer
    for bidir in (False, True):
        j = jcm.tp_comm_accounting(8 * 2048, 4096, 11008, 4, bidirectional=bidir)
        t = cm.tp_comm_accounting(8 * 2048, 4096, 11008, 4, bidirectional=bidir,
                                  link_gbs=45.0 * 2**30 / 1e9, peak_flops=197e12)
        for key in ("steps", "bytes_per_hop", "tp_overlap_frac"):
            assert t[key] == pytest.approx(j[key], rel=1e-6), key
    assert cm.H100_NVLINK_GBS == 450.0 and cm.H100_BF16_FLOPS == 989e12


def test_stream_stats_ici_fields():
    """JAX :386: the ring's fields join the report only when set, as
    JAX's ``StreamStats`` reports them."""
    from accelerate_tpu.ops.streaming import StreamStats as JaxStreamStats
    from accelerate_tpu_torch.ops.streaming import StreamStats

    for cls in (StreamStats, JaxStreamStats):
        stats = cls()
        rep = stats.overlap_report()
        assert "ici_bytes" not in rep and "tp_overlap_frac" not in rep
        stats.ici_bytes = 1024
        stats.tp_overlap_frac = 0.75
        rep = stats.overlap_report()
        assert rep["ici_bytes"] == 1024 and rep["tp_overlap_frac"] == 0.75
    assert StreamStats(ici_bytes=8, tp_overlap_frac=0.123456).overlap_report() == \
        JaxStreamStats(ici_bytes=8, tp_overlap_frac=0.123456).overlap_report()


# ---------------------------------------------------------------------------
# the Ulysses boundary (JAX's red pin)
# ---------------------------------------------------------------------------


def _jax_ulysses_off(host4):
    from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
    from accelerate_tpu.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        acc = JaxAccelerator(parallelism_config=JaxParallelismConfig(
            sp_size=WORLD, devices=tuple(jax.devices()[:WORLD])))
        model = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(
            dtype=jnp.float32, attn_implementation="ulysses", num_key_value_heads=4))
        state = acc.create_train_state(jax.tree.map(jnp.asarray, host4),
                                       jax_make_optimizer("adamw", 1e-2), apply_fn=model.apply)
        step = acc.prepare_train_step(jl.make_llama_loss_fn(model), max_grad_norm=1.0)
        ids = jnp.asarray(_tokens())
        out = []
        with jcm.collective_matmul("off"):
            for _ in range(3):
                state, m = step(state, {"input_ids": ids, "labels": ids})
                out.append(float(m["loss"]))
        return np.asarray(out)
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()


def test_ulysses_sp_boundary_parity_and_alltoall_elision(gang, host4):
    """JAX :294, red on the seed (its ring path): the port's boundary (sp
    4, 4 kv heads, mode ring: q / k / v ring over sp, o_proj
    ring-scatters) trains as its own off path and as JAX's off path, which
    is green; its forward calls no all_to_all, the off forward 8 (2 layers
    x 4), as JAX asserts on its jaxpr."""
    want = _jax_ulysses_off(host4)
    for rank in range(WORLD):
        rep = gang[rank]["boundary"]
        np.testing.assert_allclose(rep["ring"][:, 0], rep["off"][:, 0], rtol=2e-4)
        np.testing.assert_allclose(rep["off"][:, 0], want, rtol=2e-4)
        np.testing.assert_allclose(rep["ring"][:, 0], want, rtol=2e-4)
        assert rep["all_to_all_calls"] == {"off": 8, "ring": 0}
    assert want[-1] < want[0]
