"""The port's PowerSGD codec (``accelerate_tpu_torch/parallel/powersgd.py``)
and the Accelerator's PowerSGD step against the JAX package's.

The codec runs on a :class:`~accelerate_tpu_torch.parallel.virtual.
VirtualMesh` of 4 ranks beside JAX's ``shard_map`` over 4 CPU devices, fed
the same numpy gradients, JAX's warm-start Qs and residuals: the averaged
approximation and each rank's residual within 1e-5, the new Q equal up to
the sign of each column (a reduced QR may flip a column of P, which flips
Q's and leaves their product as it is).  The Accelerator's step on a world
of one against JAX's on a one-device mesh (JAX's Qs carried over) within
1e-5; on a gloo gang of 2, convergence against the dense step, per-rank
residuals and JAX's refused configurations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from shard_map_compat import NO_CHECK, shard_map

from accelerate_tpu.parallel import powersgd as jps
from accelerate_tpu_torch import Accelerator, GradSyncKwargs, ProjectConfiguration
from accelerate_tpu_torch.parallel import powersgd as tps
from accelerate_tpu_torch.parallel.virtual import VirtualMesh
from accelerate_tpu_torch.test_utils.gang import run_gang
from accelerate_tpu_torch.test_utils.scripts.data_parallel_checks import sgd
from accelerate_tpu_torch.test_utils.scripts.hierarchical_checks import mlp_loss

P = jax.sharding.PartitionSpec
TOL = dict(rtol=1e-5, atol=1e-5)


def _mlp_params(d_in=8, d_h=32) -> dict:
    """JAX ``_mlp_init(key 0)`` as numpy, in the port's (flax) leaf order."""
    k1, k2 = jax.random.split(jax.random.key(0))
    return {"b1": np.zeros((d_h,), np.float32),
            "w1": np.asarray(jax.random.normal(k1, (d_in, d_h))) * 0.3,
            "w2": np.asarray(jax.random.normal(k2, (d_h, 1))) * 0.3}


def _batches(n=8, bs=32, seed=0) -> list:
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(bs, 8)).astype(np.float32)
        y = x @ w_true + 0.01 * rng.normal(size=(bs,)).astype(np.float32)
        out.append({"x": x, "y": y.astype(np.float32)})
    return out


SHAPES = [((64, 64), np.float32), ((64,), np.float32), ((4, 4), np.float32),
          ((8, 8), np.int32), ((8, 16, 33), np.float32), ((1024, 1024), np.float32),
          ((), np.float32), ((3, 200), np.float16)]


@pytest.mark.parametrize("shape,dtype", SHAPES, ids=[f"{s}-{d.__name__}" for s, d in SHAPES])
def test_eligibility_equals_jax(shape, dtype):
    x = np.zeros(shape, dtype)
    for rank in (1, 2, 4):
        assert tps.eligible(torch.from_numpy(x), rank) == jps.eligible(jnp.asarray(x), rank)


@pytest.mark.parametrize("rank", [2, 4])
def test_wire_bytes_report_equals_jax(rank):
    params = {"w": np.zeros((1024, 1024), np.float32), "b": np.zeros((1024,), np.float32),
              "k": np.zeros((8, 16, 33), np.float32), "s": np.zeros((), np.float32)}
    ours = tps.wire_bytes_report({k: torch.from_numpy(v) for k, v in params.items()}, rank)
    assert ours == jps.wire_bytes_report({k: jnp.asarray(v) for k, v in params.items()}, rank)


def test_init_state_shapes_and_warm_start():
    params = {k: torch.from_numpy(v) for k, v in _mlp_params().items()}
    qs, errs = tps.init_powersgd_state(params, rank=2, seed=5)
    assert qs["b1"] is None and errs["b1"] is None and qs["w2"] is None
    assert qs["w1"].shape == (32, 2) and errs["w1"].shape == (8, 32)
    assert not errs["w1"].any()
    # leaf i's Q from a generator seeded seed + i (w1 is leaf 1)
    want = torch.randn((32, 2), generator=torch.Generator().manual_seed(6))
    assert torch.equal(qs["w1"], want)


def _jax_codec(grads, qs, errs, rank):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("dp_shard",))

    def local(g, qs, errs):
        g = jax.tree_util.tree_map(lambda x: x[0], g)
        e = jax.tree_util.tree_map(lambda x: x[0], errs)
        g_hat, nq, ne = jps.compress_decompress(g, qs, e, ("dp_shard",), rank)
        return g_hat, nq, jax.tree_util.tree_map(lambda x: x[None], ne)

    spec = P(("dp_shard",))
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec, P(), spec),
                           out_specs=(P(), P(), spec), **NO_CHECK))
    return jax.tree_util.tree_map(np.asarray, fn(grads, qs, errs))


def _port_codec(grads, qs, errs, rank):
    mesh = VirtualMesh(("dp_shard",), (4,))
    t = {k: torch.from_numpy(np.array(v)) if v is not None else None for k, v in qs.items()}

    def one(r):
        g = {k: torch.from_numpy(v[r]) for k, v in grads.items()}
        e = {k: torch.from_numpy(np.asarray(v)[r]) if v is not None else None
             for k, v in errs.items()}
        return tps.compress_decompress(g, t, e, ("dp_shard",), rank, mesh)

    return mesh.run(one)


def _assert_q_up_to_sign(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    for j in range(ref.shape[1]):
        sign = np.sign(ours[:, j] @ ref[:, j])
        np.testing.assert_allclose(sign * ours[:, j], ref[:, j], **TOL)


def test_codec_matches_jax_shard_map():
    """Four ranks' gradients and residuals through the codec: the average,
    every rank's new residual and the new Q against JAX's ``shard_map``."""
    rng = np.random.default_rng(0)
    grads = {"b": rng.standard_normal((4, 7)).astype(np.float32),
             "w": rng.standard_normal((4, 16, 33)).astype(np.float32)}
    qs, errs = jps.init_powersgd_state({"b": np.zeros((7,), np.float32),
                                        "w": np.zeros((16, 33), np.float32)}, 2, 4)
    errs = {"b": None, "w": 0.1 * rng.standard_normal((4, 16, 33)).astype(np.float32)}
    j_hat, j_q, j_e = _jax_codec(grads, qs, errs, 2)
    outs = _port_codec(grads, qs, errs, 2)
    for r, (g_hat, nq, ne) in enumerate(outs):
        for k in grads:
            np.testing.assert_allclose(g_hat[k].numpy(), j_hat[k], **TOL)
        np.testing.assert_allclose(ne["w"].numpy(), j_e["w"][r], **TOL)
        assert ne["b"] is None and nq["b"] is None
        _assert_q_up_to_sign(nq["w"].numpy(), j_q["w"])
    # the ineligible leaf is the exact mean
    np.testing.assert_allclose(outs[0][0]["b"].numpy(), grads["b"].mean(0), rtol=1e-6)


def test_codec_exact_when_rank_spans_gradient():
    """A rank-1 gradient, the same on every rank, comes back exact with a
    zero residual (JAX ``test_powersgd_exact_when_rank_spans_gradient``)."""
    g = np.outer(np.arange(1.0, 9.0), np.ones(16)).astype(np.float32)
    qs, _ = tps.init_powersgd_state({"w": torch.from_numpy(g)}, rank=2)
    mesh = VirtualMesh(("dp_shard",), (4,))
    outs = mesh.run(lambda r: tps.compress_decompress(
        {"w": torch.from_numpy(g)}, qs, {"w": torch.zeros(8, 16)}, ("dp_shard",), 2, mesh))
    for g_hat, _, ne in outs:
        np.testing.assert_allclose(g_hat["w"].numpy(), g, rtol=1e-4, atol=1e-4)
        assert float(ne["w"].abs().max()) < 1e-4


def test_one_process_step_equals_jax_one_device_mesh():
    """The Accelerator's PowerSGD step in a world of one (the codec still
    compresses) against JAX's on a one-device mesh, JAX's Qs carried over:
    3 steps' losses, the residuals and the params within 1e-5."""
    import optax

    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu import ParallelismConfig as JaxParallelismConfig
    from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
    from accelerate_tpu.state import GradientState as JaxGradientState
    from accelerate_tpu.utils.dataclasses import GradSyncKwargs as JaxGradSyncKwargs

    params = _mlp_params()
    batches = _batches(3)
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    jacc = JaxAccelerator(parallelism_config=JaxParallelismConfig(devices=(jax.devices()[0],)),
                          kwargs_handlers=[JaxGradSyncKwargs(compression="powersgd", rank=2)])
    jstate = jacc.create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                     optax.sgd(0.05))
    q0 = np.asarray(jstate.comm_state[0]["w1"])

    def jax_loss(p, b):
        h = jax.nn.relu(b["x"] @ p["w1"] + p["b1"])
        return jnp.mean(((h @ p["w2"])[:, 0] - b["y"]) ** 2)

    jstep = jacc.prepare_train_step(jax_loss)
    j_losses = []
    for b in batches:
        jstate, m = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b))
        j_losses.append(float(m["loss"]))

    acc = Accelerator(cpu=True, kwargs_handlers=[GradSyncKwargs(compression="powersgd", rank=2)])
    state = acc.create_train_state({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                                   sgd(0.05))
    qs, errs = state.comm_state
    qs["w1"] = torch.from_numpy(q0.copy())
    step = acc.prepare_train_step(mlp_loss)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(m["loss"].item())
    assert acc.dcn_sync["enabled"] is False
    np.testing.assert_allclose(losses, j_losses, **TOL)
    np.testing.assert_allclose(state.comm_state[1]["w1"].numpy(),
                               np.asarray(jstate.comm_state[1]["w1"])[0], **TOL)
    for k in params:
        np.testing.assert_allclose(state.params[k].numpy(), np.asarray(jstate.params[k]), **TOL)
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()


def test_comm_state_rides_the_checkpoint(tmp_path):
    """The codec's Qs and residuals are saved with the train state (the
    residuals stacked [world, ...], JAX's layout) and restored."""
    from accelerate_tpu_torch.utils.serialization import load_safetensors

    acc = Accelerator(cpu=True, kwargs_handlers=[GradSyncKwargs(compression="powersgd", rank=2)],
                      project_config=ProjectConfiguration(project_dir=str(tmp_path)))
    params = _mlp_params()
    state = acc.create_train_state({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                                   sgd(0.05))
    step = acc.prepare_train_step(mlp_loss)
    for b in _batches(2):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    path = acc.save_state(train_state=state)
    saved = load_safetensors(tmp_path / path / "train_state" / "state.safetensors")
    assert saved["comm_state.e.w1"].shape == (1, 8, 32)
    fresh = Accelerator(cpu=True,
                        kwargs_handlers=[GradSyncKwargs(compression="powersgd", rank=2)])
    template = fresh.create_train_state(
        {k: torch.zeros(v.shape) for k, v in params.items()}, sgd(0.05))
    restored = fresh.load_state(path, train_state=template)
    for i in (0, 1):
        for name, t in state.comm_state[i].items():
            got = restored.comm_state[i][name]
            assert (t is None and got is None) or torch.equal(t, got)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("powersgd_gang")
    return run_gang("accelerate_tpu_torch.test_utils.scripts.hierarchical_checks:powersgd_checks",
                    2, d, timeout=150, params=_mlp_params(), batches=_batches())


def test_gang_converges_close_to_dense(gang):
    """JAX ``test_powersgd_converges_close_to_dense`` on 2 ranks."""
    out = gang[0]
    assert out["powersgd"][-1] < 0.05, out["powersgd"][-10:]
    assert out["powersgd"][-1] < max(out["dense"][-1] * 5, 0.05)
    assert gang[1]["powersgd"] == out["powersgd"]


def test_gang_residuals_are_each_ranks_own(gang):
    """JAX ``test_powersgd_state_updates_and_errors_are_per_rank``: the Q
    moved from its warm start (the same on both ranks), each rank keeps its
    own nonzero residual, and they differ."""
    a, b = gang
    warm = tps.warm_start_q(32, 2, 1).numpy()
    assert np.abs(a["q_w1"] - warm).max() > 0
    np.testing.assert_array_equal(a["q_w1"], b["q_w1"])
    assert np.abs(a["err_w1"]).max() > 0
    np.testing.assert_array_equal(a["err_gathered"][1], b["err_w1"])
    assert not np.allclose(a["err_w1"], b["err_w1"])


def test_gang_shard_grad_op_updates_its_ranges_as_no_shard(gang):
    """SHARD_GRAD_OP keeps the params whole (the codec's shape) and updates
    each rank's range of the averaged gradient: the NO_SHARD losses,
    bitwise."""
    assert gang[0]["shard_grad_op"] == gang[0]["powersgd"][:5]


def test_gang_allows_declared_full_shard_with_replicated_params(gang):
    assert np.isfinite(gang[0]["declared_full_shard_loss"])


def test_powersgd_rejects_bad_configs(gang):
    """JAX ``test_powersgd_rejects_bad_configs``: accumulation (a world of
    one), tp, and sharded params under FULL_SHARD and HYBRID_SHARD (the
    gang) raise with JAX's words."""
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2,
                      kwargs_handlers=[GradSyncKwargs(compression="powersgd")])
    with pytest.raises(ValueError, match="accum"):
        acc.prepare_train_step(mlp_loss)
    with pytest.raises(ValueError, match="compression"):
        Accelerator(cpu=True, kwargs_handlers=[GradSyncKwargs(compression="topk")]
                    ).prepare_train_step(mlp_loss)
    out = gang[0]
    assert "ValueError" in out["raise_tp"] and "tp" in out["raise_tp"]
    assert "params-sharded" in out["raise_full_shard"]
    assert "params-sharded" in out["raise_hybrid"]


# -- C3: ranks with unequal counts of valid labels ------------------------------


def masked_params() -> dict:
    rng = np.random.default_rng(3)
    return {"w1": (rng.standard_normal((8, 32)) * 0.3).astype(np.float32),
            "w2": (rng.standard_normal((32, 16)) * 0.3).astype(np.float32)}


def masked_batches(world: int, steps: int = 3, rows: int = 2, t: int = 6) -> list:
    """Global batches whose ranks hold different counts of ``-100`` labels
    (rank ``r``'s rows lose ``(r + step) % t`` of their shifted labels)."""
    rng = np.random.default_rng(5)
    out = []
    for s in range(steps):
        x = rng.standard_normal((world * rows, t, 8)).astype(np.float32)
        labels = rng.integers(0, 16, size=(world * rows, t)).astype(np.int64)
        for r in range(world):
            labels[r * rows:(r + 1) * rows, 1:1 + (r * 2 + s) % t] = -100
        out.append({"x": x, "labels": labels})
    return out


def jax_masked_ce(p, b):
    logits = jnp.tanh(b["x"] @ p["w1"]) @ p["w2"]
    logits, labels = logits[:, :-1], b["labels"][:, 1:]
    valid = labels != -100
    picked = jnp.take_along_axis(logits, jnp.clip(labels, 0)[..., None], -1)[..., 0]
    ce = jax.nn.logsumexp(logits, -1) - picked
    return jnp.sum(ce * valid) / jnp.maximum(jnp.sum(valid), 1)


def jax_masked_codec_steps(params, batches, world: int, kind: str, qs=None, errs=None,
                           lr: float = 0.1) -> dict:
    """JAX's shard_map steps (``_psgd_local`` / ``_hier_grads``): each rank's
    own mean loss and its gradient through the codec, the loss ``pmean``-ed
    (inside the node, then over dcn, for the hierarchical step), then SGD."""
    from accelerate_tpu.parallel import hierarchical as jh

    if kind == "powersgd":
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]), ("dp_shard",))
        spec, axes = P("dp_shard"), ("dp_shard",)
    else:
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]).reshape(2, world // 2),
                                 ("dcn", "dp_shard"))
        spec, axes = P(("dcn", "dp_shard")), ("dcn", "dp_shard")

    def local(p, b, qs, errs):
        loss, grads = jax.value_and_grad(jax_masked_ce)(p, b)
        grads = jax.tree_util.tree_map(lambda g: g.astype(jnp.float32), grads)
        if kind == "hier":
            g_hat, _, _ = jh.hierarchical_sync(grads, ("dp_shard",), "dcn")
            nq, ne = qs, errs
        else:
            e_local = jax.tree_util.tree_map(lambda e: e[0], errs)
            if kind == "powersgd":
                g_hat, nq, ne = jps.compress_decompress(grads, qs, e_local, axes, 2)
            else:
                g_hat, nq, ne = jh.hierarchical_sync(grads, ("dp_shard",), "dcn", qs=qs,
                                                     errs=e_local, rank=2)
            ne = jax.tree_util.tree_map(lambda e: e[None], ne)
        if kind == "powersgd":
            loss = jax.lax.pmean(loss, axes)
        else:
            loss = jax.lax.pmean(jax.lax.pmean(loss, "dp_shard"), "dcn")
        return loss, g_hat, nq, ne

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), spec, P(), spec),
                           out_specs=(P(), P(), P(), spec), **NO_CHECK))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    out = {"losses": [], "grads": [], "errs": []}
    for b in batches:
        loss, g_hat, qs, errs = fn(p, {k: jnp.asarray(v) for k, v in b.items()}, qs, errs)
        p = {k: p[k] - lr * g_hat[k] for k in p}
        out["losses"].append(float(loss))
        out["grads"].append({k: np.asarray(v) for k, v in g_hat.items()})
        if errs is not None:
            out["errs"].append({k: None if v is None else np.asarray(v)
                                for k, v in errs.items()})
    return out


def assert_codec_steps_equal_jax(port: list, ref: dict, tol: dict) -> None:
    """Every rank's losses and reduced gradients, and its own residuals,
    against JAX's, step by step."""
    for rank, got in enumerate(port):
        np.testing.assert_allclose(got["losses"], ref["losses"], **tol)
        for step, (g, want) in enumerate(zip(got["grads"], ref["grads"])):
            for k in want:
                np.testing.assert_allclose(g[k], want[k], err_msg=f"{k} step {step}", **tol)
        for step, (e, want) in enumerate(zip(got["errs"], ref["errs"])):
            for k, w in want.items():
                assert (w is None) == (e[k] is None)
                if w is not None:
                    assert np.abs(w[rank]).max() > 0
                    np.testing.assert_allclose(e[k], w[rank], err_msg=f"{k} step {step}",
                                               **tol)


def test_masked_batches_have_unequal_valid_counts():
    for b in masked_batches(2):
        counts = [(b["labels"][r * 2:(r + 1) * 2, 1:] != -100).sum() for r in range(2)]
        assert counts[0] != counts[1]


def test_gang_codec_steps_on_unequal_valid_counts_equal_jax(tmp_path):
    """C3: the flat codec step on 2 ranks whose batches hold different
    counts of ``-100`` labels, JAX's Qs carried over: losses, reduced
    gradients and each rank's residuals against JAX's ``_psgd_local``
    shard_map over 3 steps, at this file's tolerance."""
    params, batches = masked_params(), masked_batches(2)
    qs, errs = jps.init_powersgd_state(params, 2, 2)
    ref = jax_masked_codec_steps(params, batches, 2, "powersgd", qs, errs)
    port = run_gang("accelerate_tpu_torch.test_utils.scripts.hierarchical_checks:"
                    "masked_codec_checks", 2, tmp_path, timeout=120, params=params,
                    batches=batches,
                    qs={"powersgd": {k: None if v is None else np.asarray(v)
                                     for k, v in qs.items()}})
    assert_codec_steps_equal_jax([r["powersgd"] for r in port], ref, TOL)
