"""The port's hierarchical gradient reduction (``accelerate_tpu_torch/
parallel/hierarchical.py``) and the Accelerator's hierarchical step against
the JAX package's.

The schedule runs on a :class:`~accelerate_tpu_torch.parallel.virtual.
VirtualMesh` of ``dcn 2 x dp_shard 4`` beside JAX's ``shard_map`` over the
8 CPU devices, fed the same numpy gradients: the dense sync equals the flat
mean and JAX's at JAX's tolerance (rtol 1e-5, atol 1e-6); the DCN codec's
output and residuals within 1e-5 of JAX's, its Q up to column sign.  The
accounting dict equals JAX's apart from the link-rate fields (the port
prices the 50 GB/s of an NDR InfiniBand port, JAX a TPU link); the bytes
the recorder sees cross ``dcn`` equal the prediction exactly, which JAX's
own ``test_accounting_twins_agree_exactly_and_order`` asks of its jaxpr
walk.  The Accelerator's step on a gloo gang of ``dcn 2 x dp_shard 2``:
JAX's ``dcn_sync``, the flat step's losses within 1e-5, bitwise over two
runs, the codec's convergence, the recorded DCN bytes below the flat twin
and within 16 bytes of the prediction (the loss's psum over dcn), and
JAX's fall-backs and refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from shard_map_compat import NO_CHECK, shard_map

from accelerate_tpu.parallel import hierarchical as jh
from accelerate_tpu_torch.parallel import hierarchical as th
from accelerate_tpu_torch.parallel.virtual import VirtualMesh
from accelerate_tpu_torch.telemetry import twin_registry
from accelerate_tpu_torch.test_utils.gang import run_gang

P = jax.sharding.PartitionSpec
LINK_FIELDS = ("dcn_s_per_step", "dcn_overlap_frac")


def _grads():
    rng = np.random.default_rng(0)
    return {"b": rng.standard_normal((8, 7)).astype(np.float32),
            "w": rng.standard_normal((8, 16, 33)).astype(np.float32)}


PARAMS = {"b": np.zeros((7,), np.float32), "w": np.zeros((16, 33), np.float32)}


@pytest.mark.parametrize("ici", [1, 2, 4, 8])
def test_slab_geometry_equals_jax(ici):
    for size in (1, 7, 16 * 33, 100, 1024, 4096 + 3, 32000 * 1536):
        assert th.slab_geometry(size, ici) == jh.slab_geometry(size, ici)


@pytest.mark.parametrize("rank", [1, 2, 4])
def test_slab_eligible_equals_jax(rank):
    leaves = [np.zeros(s, d) for s, d in (((64, 64), np.float32), ((4,), np.float32),
                                          ((64, 64), np.int32), ((16, 33), np.float32),
                                          ((), np.float32), ((3, 5), np.float16))]
    for leaf in leaves:
        for ici in (1, 2, 4):
            assert (th.slab_eligible(torch.from_numpy(leaf), ici, rank)
                    == jh.slab_eligible(leaf, ici, rank))
    assert [th.ring_reduce_factor(d) for d in (1, 2, 4, 8)] == \
        [jh.ring_reduce_factor(d) for d in (1, 2, 4, 8)]


def _jax_sync(grads, qs=None, errs=None, rank=2):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dcn", "dp_shard"))
    spec = P(("dcn", "dp_shard"))
    if qs is None:
        def dense(gr):
            out, _, _ = jh.hierarchical_sync(jax.tree_util.tree_map(lambda g: g[0], gr),
                                             ("dp_shard",), "dcn")
            return out

        fn = shard_map(dense, mesh=mesh, in_specs=spec, out_specs=P(), **NO_CHECK)
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(grads))

    def comp(gr, qs, errs):
        out, nq, ne = jh.hierarchical_sync(
            jax.tree_util.tree_map(lambda g: g[0], gr), ("dp_shard",), "dcn", qs=qs,
            errs=jax.tree_util.tree_map(lambda e: e[0], errs), rank=rank)
        return out, nq, jax.tree_util.tree_map(lambda e: e[None], ne)

    fn = shard_map(comp, mesh=mesh, in_specs=(spec, P(), spec), out_specs=(P(), P(), spec),
                   **NO_CHECK)
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(grads, qs, errs))


def _port_sync(grads, qs=None, errs=None, rank=2, record=False):
    mesh = VirtualMesh(("dcn", "dp_shard"), (2, 4))
    tq = ({k: torch.from_numpy(np.array(v)) if v is not None else None for k, v in qs.items()}
          if qs is not None else None)

    def one(r):
        g = {k: torch.from_numpy(v[r]) for k, v in grads.items()}
        e = ({k: torch.from_numpy(np.array(v)[r]) if v is not None else None
              for k, v in errs.items()} if errs is not None else None)
        return th.hierarchical_sync(g, ("dp_shard",), "dcn", qs=tq, errs=e, rank=rank,
                                    mesh=mesh)

    if not record:
        return mesh.run(one)
    with th.record_collectives() as rec:
        out = mesh.run(one)
    return out, rec


def test_dense_sync_equals_flat_mean_and_jax():
    grads = _grads()
    ref = _jax_sync(grads)
    for out, _, _ in _port_sync(grads):
        for k, g in grads.items():
            np.testing.assert_allclose(out[k].numpy(), g.mean(0), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-5, atol=1e-6)


def test_codec_state_shapes_equal_jax():
    """JAX ``test_powersgd_codec_error_feedback_state``'s shapes: each rank
    holds its own ``[rows, cols]`` residual (JAX's row of
    ``[dp_world, rows, cols]``), the bias's slab too small to compress."""
    jq, je = jh.init_dcn_powersgd_state(PARAMS, rank=2, dp_world=8, ici_size=4)
    qs, errs = th.init_dcn_powersgd_state({k: torch.from_numpy(v) for k, v in PARAMS.items()},
                                          rank=2, ici_size=4)
    geo = th.slab_geometry(16 * 33, 4)
    assert qs["w"].shape == jq["w"].shape == (geo["cols"], 2)
    assert errs["w"].shape == je["w"].shape[1:] == (geo["rows"], geo["cols"])
    assert qs["b"] is None and errs["b"] is None and jq["b"] is None


def test_codec_residuals_equal_jax():
    """The compressed DCN hop, JAX's Qs and nonzero residuals given: the
    output and every rank's new residual within 1e-5 of JAX's, the new Q
    up to column sign; the ineligible bias the exact mean."""
    grads = _grads()
    qs, errs = jh.init_dcn_powersgd_state(PARAMS, rank=2, dp_world=8, ici_size=4)
    rng = np.random.default_rng(1)
    errs = {"b": None, "w": 0.1 * rng.standard_normal(np.shape(errs["w"])).astype(np.float32)}
    j_out, j_q, j_e = _jax_sync(grads, qs, errs)
    for r, (out, nq, ne) in enumerate(_port_sync(grads, qs, errs)):
        for k in grads:
            np.testing.assert_allclose(out[k].numpy(), j_out[k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ne["w"].numpy(), j_e["w"][r], rtol=1e-5, atol=1e-5)
        assert float(ne["w"].abs().max()) > 0
        if r == 0:
            # a node's ranks compress different slabs, so their Qs differ:
            # JAX's replicated output reads device 0's
            ref_q = np.asarray(j_q["w"])
            for j in range(ref_q.shape[1]):
                got = nq["w"].numpy()[:, j]
                np.testing.assert_allclose(np.sign(got @ ref_q[:, j]) * got, ref_q[:, j],
                                           rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["b"].numpy(), grads["b"].mean(0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compression", [None, "powersgd"])
@pytest.mark.parametrize("dcn,ici", [(1, 1), (2, 4), (4, 2), (2, 1)])
def test_accounting_equals_jax(compression, dcn, ici):
    params = {"w": np.zeros((16, 33), np.float32), "b": np.zeros((7,), np.float32),
              "e": np.zeros((512, 96), np.float32)}
    ours = th.dcn_comm_accounting({k: torch.from_numpy(v) for k, v in params.items()},
                                  ici_size=ici, dcn_size=dcn, compression=compression, rank=2)
    ref = jh.dcn_comm_accounting(params, ici_size=ici, dcn_size=dcn, compression=compression,
                                 rank=2)
    assert {k: v for k, v in ours.items() if k not in LINK_FIELDS} == \
        {k: v for k, v in ref.items() if k not in LINK_FIELDS}
    # the link rate: 50 GB/s (one NDR InfiniBand port), not a TPU figure
    assert ours["dcn_s_per_step"] == round(ours["dcn_bytes"] / 50e9, 9)
    assert th.DCN_GBS_DEFAULT == 50.0 and not hasattr(th, "DCN_GIBS_DEFAULT")


def test_accounting_twins_agree_exactly_and_order():
    """JAX's red ``test_accounting_twins_agree_exactly_and_order`` held on the
    port: the bytes the recorder sees cross dcn equal the prediction
    exactly, dense and compressed, and compressed < dense < flat."""
    grads = _grads()
    reg = twin_registry()
    reg.reset()
    _, rec = _port_sync(grads, record=True)
    measured = th.measure_dcn_bytes(rec, dcn_size=2)
    assert measured["per_rank"] == {r: measured["dcn_bytes"] for r in range(8)}
    predicted = th.dcn_comm_accounting(PARAMS, ici_size=4, dcn_size=2)
    assert measured["dcn_bytes"] == predicted["dcn_bytes"]
    assert reg.get("dcn_comm.dcn_bytes").rel_err == 0.0

    qs, errs = jh.init_dcn_powersgd_state(PARAMS, rank=2, dp_world=8, ici_size=4)
    _, rec_c = _port_sync(grads, qs, errs, record=True)
    measured_c = th.measure_dcn_bytes(rec_c, dcn_size=2)
    predicted_c = th.dcn_comm_accounting(PARAMS, ici_size=4, dcn_size=2,
                                         compression="powersgd", rank=2)
    assert measured_c["dcn_bytes"] == predicted_c["dcn_bytes"]
    assert measured_c["dcn_bytes"] < measured["dcn_bytes"] < predicted["dcn_bytes_flat"]
    # the recorder is off the path once the block ends
    from accelerate_tpu_torch.parallel import collectives

    assert collectives._RECORDER is None
    reg.reset()


def test_accounting_zeros_clean_without_dcn_axis():
    acct = th.dcn_comm_accounting({"w": torch.zeros(64, 64)}, ici_size=1, dcn_size=1)
    assert acct["dcn_bytes"] == 0 and acct["dcn_bytes_flat"] == 0
    assert acct["dcn_overlap_frac"] == 0.0 and acct["dcn_s_per_step"] == 0.0


# -- the Accelerator's step on a gloo gang of dcn 2 x dp_shard 2 ----------------


def _mlp_params() -> dict:
    """JAX ``_mlp_init(key 0)`` as numpy, in the port's (flax) leaf order."""
    k1, k2 = jax.random.split(jax.random.key(0))
    return {"b1": np.zeros((32,), np.float32),
            "w1": np.asarray(jax.random.normal(k1, (8, 32))) * 0.3,
            "w2": np.asarray(jax.random.normal(k2, (32, 1))) * 0.3}


def _batches(n=4, bs=32, seed=0) -> list:
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(bs, 8)).astype(np.float32)
        out.append({"x": x, "y": (x @ w_true).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("hier_gang")
    return run_gang("accelerate_tpu_torch.test_utils.scripts.hierarchical_checks:hier_checks",
                    4, d, timeout=180, params=_mlp_params(), batches=_batches())


@pytest.fixture(scope="module")
def jax_hier():
    """JAX's hierarchical step on the same dcn 2 x dp_shard 2 layout (4 CPU
    devices): its dcn_sync and 12 losses."""
    import optax

    from accelerate_tpu import Accelerator, ParallelismConfig
    from accelerate_tpu.state import AcceleratorState, GradientState
    from accelerate_tpu.utils.dataclasses import (
        FullyShardedDataParallelPlugin,
        ShardingStrategy,
    )

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(parallelism_config=ParallelismConfig(dcn_size=2, dp_shard_size=2,
                                                           devices=tuple(jax.devices()[:4])),
                      fsdp_plugin=FullyShardedDataParallelPlugin(
                          sharding_strategy=ShardingStrategy.NO_SHARD))
    state = acc.create_train_state(jax.tree_util.tree_map(jnp.asarray, _mlp_params()),
                                   optax.sgd(0.05))

    def loss_fn(p, b):
        h = jax.nn.relu(b["x"] @ p["w1"] + p["b1"])
        return jnp.mean(((h @ p["w2"])[:, 0] - b["y"]) ** 2)

    step = acc.prepare_train_step(loss_fn)
    bs = _batches()
    losses = []
    for i in range(12):
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, bs[i % len(bs)]))
        losses.append(float(m["loss"]))
    out = {"dcn_sync": dict(acc.dcn_sync), "losses": losses}
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    return out


def test_gang_hierarchical_engages_and_dcn_sync_equals_jax(gang, jax_hier):
    assert gang[0]["dcn_sync"] == jax_hier["dcn_sync"] == {
        "enabled": True, "dcn_size": 2, "ici_size": 2, "compression": None, "why_not": None}
    assert all(r["dcn_sync"] == gang[0]["dcn_sync"] for r in gang)


def test_gang_hierarchical_matches_flat_and_is_bitwise(gang):
    """JAX ``test_train_step_hierarchical_engages_and_matches_flat``: the
    flat step's losses within 1e-5, the hierarchical trajectory bitwise
    over two runs and the same on every rank."""
    out = gang[0]
    assert not out["flat_dcn_sync"]["enabled"]
    np.testing.assert_allclose(out["hier"], out["flat"], rtol=1e-5, atol=1e-6)
    assert out["hier"] == out["hier_again"]
    assert all(r["hier"] == out["hier"] for r in gang)


def test_gang_hierarchical_losses_equal_jax(gang, jax_hier):
    np.testing.assert_allclose(gang[0]["hier"], jax_hier["losses"], rtol=1e-5, atol=1e-6)


def test_gang_dcn_powersgd_converges(gang):
    """JAX ``test_train_step_dcn_powersgd_converges``: the codec state rides
    the train state, each rank its own residual."""
    out = gang[0]
    assert out["dcn_powersgd_sync"]["compression"] == "powersgd"
    assert out["dcn_powersgd"][-1] < 0.1, out["dcn_powersgd"][-5:]
    assert any(q is not None for q in out["dcn_powersgd_qs"].values())
    assert not np.array_equal(gang[0]["dcn_powersgd_errs"]["w1"],
                              gang[1]["dcn_powersgd_errs"]["w1"])


@pytest.mark.parametrize("codec", [None, "powersgd"])
def test_gang_step_dcn_bytes_below_flat_twin(gang, codec):
    """JAX's red ``test_train_step_traced_dcn_bytes_below_flat_twin`` held on
    the port: the step's recorded DCN bytes below the flat twin and within
    16 bytes of the prediction (the loss's 4-byte psum over dcn)."""
    for out in gang:
        b = out[f"bytes_{codec}"]
        assert b["compression"] == codec
        assert b["measured"] < b["flat"]
        assert abs(b["measured"] - b["predicted"]) <= 16, b


def test_gang_incompatible_configs_fall_back_or_raise(gang):
    """JAX ``test_incompatible_configs_fall_back_or_raise``."""
    out = gang[0]
    assert not out["full_shard_sync"]["enabled"]
    assert "params sharded" in out["full_shard_sync"]["why_not"]
    assert all(np.isfinite(out["full_shard_losses"]))
    assert "cannot engage" in out["raise_hierarchical"]
    assert "dcn_compression" in out["raise_no_dcn"]
    assert "dcn_compression" in out["raise_topk"]


def test_gang_flat_powersgd_spans_dcn_axis(gang):
    """JAX ``test_flat_powersgd_now_spans_dcn_axis``: the flat codec owns the
    step and converges over the dcn x dp_shard plane."""
    out = gang[0]
    assert not out["flat_powersgd_sync"]["enabled"]
    assert out["flat_powersgd"][-1] < 0.2, out["flat_powersgd"][-5:]
    assert out["flat_powersgd_errs"]["w1"].shape == (8, 32)


def test_gang_hierarchical_steps_on_unequal_valid_counts_equal_jax(tmp_path):
    """C3: the dense hierarchical step and its DCN codec on a dcn 2 x
    dp_shard 2 gang whose ranks hold different counts of ``-100`` labels,
    JAX's Qs carried over: losses (averaged inside the node, then over
    dcn), reduced gradients and each rank's residuals against JAX's
    ``_hier_grads`` shard_map over 3 steps, at this file's codec tolerance."""
    from test_torch_powersgd import (
        assert_codec_steps_equal_jax,
        jax_masked_codec_steps,
        masked_batches,
        masked_params,
    )

    params, batches = masked_params(), masked_batches(4)
    qs, errs = jh.init_dcn_powersgd_state(params, rank=2, dp_world=4, ici_size=2)
    refs = {"hier": jax_masked_codec_steps(params, batches, 4, "hier"),
            "hier_powersgd": jax_masked_codec_steps(params, batches, 4, "hier_powersgd",
                                                    qs, errs)}
    port = run_gang("accelerate_tpu_torch.test_utils.scripts.hierarchical_checks:"
                    "masked_codec_checks", 4, tmp_path, timeout=120, params=params,
                    batches=batches,
                    qs={"hier": None,
                        "hier_powersgd": {k: None if v is None else np.asarray(v)
                                          for k, v in qs.items()}})
    for kind, ref in refs.items():
        runs = [r[kind] for r in port]
        assert runs[0]["dcn_sync"]["enabled"]
        assert_codec_steps_equal_jax(runs, ref, dict(rtol=1e-5, atol=1e-5))
