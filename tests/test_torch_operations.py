"""The port's pytree helpers, mesh collectives, process collectives, RNG
synchronisation and LocalSGD held against the JAX package's
(``ops/operations.py``, ``parallel/collectives.py``, ``utils/random.py``,
``local_sgd.py``).  The one-process cases run both packages here; the mesh
cases run on a 4-rank gloo world (``accelerate_tpu_torch/test_utils/
gang.py``) against JAX's ``shard_map`` on a 4-device mesh of its CPU
devices, exactly (integer-valued f32); the process collectives and
LocalSGD (a 2-rank world) against numpy."""

import warnings
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from accelerate_tpu.ops import operations as jops
from accelerate_tpu.parallel import collectives as jc
from accelerate_tpu.parallelism_config import ParallelismConfig as JConfig
from accelerate_tpu_torch import local_sgd as tlocal
from accelerate_tpu_torch.local_sgd import LocalSGD
from accelerate_tpu_torch.ops import operations as ops
from accelerate_tpu_torch.test_utils.gang import run_gang

N = 4
SCRIPTS = "accelerate_tpu_torch.test_utils.scripts.operations_checks"


# -- one process: both packages ----------------------------------------------


def test_recursively_apply_nested_and_namedtuple():
    data = {"a": np.ones(2), "b": [np.zeros(3), (np.ones(1), "str")]}
    for mod in (ops, jops):
        out = mod.recursively_apply(lambda t: t + 1, data)
        assert out["a"].tolist() == [2.0, 2.0] and out["b"][0].tolist() == [1.0, 1.0, 1.0]
        assert out["b"][1][1] == "str"
    Point = namedtuple("Point", ["x", "y"])
    out = ops.recursively_apply(lambda t: t * 2, Point(torch.ones(2), torch.zeros(2)))
    assert isinstance(out, Point) and out.x.tolist() == [2.0, 2.0]
    with pytest.raises(TypeError):
        ops.recursively_apply(lambda t: t, {"a": "str"}, error_on_other_type=True)


def test_send_to_device_and_skip_keys():
    batch = {"x": np.ones((2, 2)), "y": [torch.zeros(3)], "meta": np.zeros(2)}
    out = ops.send_to_device(batch, "cpu", skip_keys=["meta"])
    assert isinstance(out["x"], torch.Tensor) and out["x"].device.type == "cpu"
    assert isinstance(out["y"][0], torch.Tensor)
    assert isinstance(out["meta"], np.ndarray)
    jout = jops.send_to_device({"x": batch["x"], "meta": batch["meta"]}, jax.devices()[0],
                               skip_keys=["meta"])
    np.testing.assert_array_equal(out["x"].numpy(), np.asarray(jout["x"]))


def test_structure_batch_size_slice_concat_listify():
    data = {"x": np.ones((2, 3), dtype=np.float32)}
    skel, jskel = ops.get_data_structure(data), jops.get_data_structure(data)
    assert skel["x"].shape == jskel["x"].shape == (2, 3)
    out = ops.initialize_tensors(skel)
    assert out["x"].shape == (2, 3) and not out["x"].any()
    for case in ({"a": np.ones((5, 2))}, [np.ones((3,))], {"a": 1}, [torch.ones(7, 1)]):
        assert ops.find_batch_size(case) == jops.find_batch_size(
            jax.tree.map(lambda t: np.asarray(t) if isinstance(t, torch.Tensor) else t, case))
    data = {"a": np.arange(10)}
    sliced = ops.slice_tensors(data, slice(0, 4))
    assert sliced["a"].tolist() == jops.slice_tensors(data, slice(0, 4))["a"].tolist()
    assert ops.concatenate([sliced, sliced])["a"].shape == (8,)
    assert ops.concatenate([{"a": torch.ones(2)}] * 3)["a"].shape == (6,)
    assert ops.listify({"a": torch.arange(3)}) == jops.listify({"a": np.arange(3)})


def test_convert_to_fp32_and_decorator():
    data = {"a": torch.ones(2, dtype=torch.bfloat16), "b": torch.ones(2, dtype=torch.int32)}
    out = ops.convert_to_fp32(data)
    assert out["a"].dtype == torch.float32 and out["b"].dtype == torch.int32
    jout = jops.convert_to_fp32({"a": jnp.ones(2, jnp.bfloat16), "b": np.ones(2, np.int32)})
    assert str(jout["a"].dtype) == "float32" and jout["b"].dtype == np.int32
    fwd = ops.ConvertOutputsToFp32(lambda x: x.to(torch.float16))
    assert fwd(torch.ones(1)).dtype == torch.float32


def test_one_process_collectives_are_identities():
    x = torch.ones((4, 2))
    assert ops.gather(x) is x and jops.gather(np.ones((4, 2))) is not None
    assert ops.gather_object([1, 2]) == jops.gather_object([1, 2]) == [1, 2]
    assert ops.gather_object("a") == jops.gather_object("a") == ["a"]
    assert ops.broadcast(x) is x
    assert ops.reduce({"a": torch.ones(2)}, reduction="sum")["a"].tolist() == \
        jops.reduce({"a": np.ones(2)}, reduction="sum")["a"].tolist()
    assert ops.pad_across_processes(x) is x
    assert ops.broadcast_object_list([3]) == [3]


def test_pad_input_tensors():
    out = ops.pad_input_tensors(torch.arange(10).reshape(10, 1), batch_size=10, num_processes=4)
    want = jops.pad_input_tensors(np.arange(10).reshape(10, 1), batch_size=10, num_processes=4)
    np.testing.assert_array_equal(out.numpy(), want)


# -- the mesh and process collectives on a 4-rank world ----------------------


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return run_gang(f"{SCRIPTS}:collective_checks", N, tmp_path_factory.mktemp("ops_gang"),
                    timeout=120)


@pytest.fixture(scope="module")
def mesh4():
    return JConfig(dp_shard_size=N, devices=jax.devices()[:N]).build_device_mesh()


def _shard_map(mesh, body, in_spec, out_spec, x):
    from shard_map_compat import NO_CHECK, shard_map

    return np.asarray(shard_map(body, mesh=mesh, in_specs=in_spec, out_specs=out_spec,
                                **NO_CHECK)(x))


def _rank_rows(jax_out, rank, rows):
    """Rank ``rank``'s block of a JAX result sharded on dim 0."""
    return jax_out[rank * rows:(rank + 1) * rows]


def test_psum_pmean_pmax_pmin_match_shard_map(gang, mesh4):
    x = jnp.arange(float(N))
    for name, fn in (("psum", jc.psum), ("pmean", jc.pmean), ("pmax", jc.pmax),
                     ("pmin", jc.pmin)):
        want = _shard_map(mesh4, lambda s, fn=fn: fn(s, "dp_shard"), P("dp_shard"),
                          P("dp_shard"), x)
        for rank in range(N):
            np.testing.assert_array_equal(gang[rank][name], _rank_rows(want, rank, 1))
        assert [g["axis_index"] for g in gang] == list(range(N))
        assert {g["axis_size"] for g in gang} == {N}


def test_all_gather_matches_shard_map(gang, mesh4):
    x = jnp.arange(float(N))
    want = _shard_map(mesh4, lambda s: jc.all_gather(s, "dp_shard", axis=0, tiled=True),
                      P("dp_shard"), P(None), x)
    stacked = _shard_map(mesh4, lambda s: jc.all_gather(s, "dp_shard", axis=0, tiled=False),
                         P("dp_shard"), P(None), x)
    for rank in range(N):
        np.testing.assert_array_equal(gang[rank]["all_gather"], want)
        np.testing.assert_array_equal(gang[rank]["all_gather_stacked"], stacked)


@pytest.mark.parametrize("shift", [1, 3, -1, N])
def test_ring_permute_matches_shard_map(gang, mesh4, shift):
    x = jnp.arange(float(N))
    want = _shard_map(mesh4, lambda s: jc.ring_permute(s, "dp_shard", shift=shift),
                      P("dp_shard"), P("dp_shard"), x)
    np.testing.assert_array_equal(want, np.roll(np.arange(float(N)), shift))
    for rank in range(N):
        np.testing.assert_array_equal(gang[rank][f"ring_permute_{shift}"],
                                      _rank_rows(want, rank, 1))
    partial = _shard_map(mesh4, lambda s: jc.ppermute(s, "dp_shard", [(0, 1)]),
                         P("dp_shard"), P("dp_shard"), x)
    for rank in range(N):
        np.testing.assert_array_equal(gang[rank]["ppermute_partial"],
                                      _rank_rows(partial, rank, 1))


def test_reduce_scatter_and_all_to_all_match_shard_map(gang, mesh4):
    ones = jnp.ones((8 * N, 8))
    want = _shard_map(mesh4, lambda s: jc.reduce_scatter(s, "dp_shard", axis=0),
                      P("dp_shard", None), P("dp_shard", None), ones)
    mat = jnp.arange(float(N * N)).reshape(N, N)
    a2a = _shard_map(mesh4, lambda s: jc.all_to_all(s, "dp_shard", split_axis=1, concat_axis=0),
                     P("dp_shard", None), P(None, "dp_shard"), mat)
    rows = want.shape[0] // N
    for rank in range(N):
        np.testing.assert_array_equal(gang[rank]["reduce_scatter"], want[rank * rows:
                                                                         (rank + 1) * rows])
        # rank j holds column block j of JAX's result
        np.testing.assert_array_equal(gang[rank]["all_to_all"], a2a[:, rank:rank + 1])


def test_broadcast_from_matches_shard_map_and_checks_src(gang, mesh4):
    x = jnp.arange(float(N)) * 10.0
    for src in (0, N - 1):
        want = _shard_map(mesh4, lambda s, src=src: jc.broadcast_from(s, "dp_shard", src=src),
                          P("dp_shard"), P("dp_shard"), x)
        for rank in range(N):
            np.testing.assert_array_equal(gang[rank]["broadcast_from"][src],
                                          _rank_rows(want, rank, 1))
    x2d = jnp.arange(4.0 * N).reshape(N, 4) - 7.0
    want = _shard_map(mesh4, lambda s: jc.broadcast_from(s, "dp_shard", src=N // 2),
                      P("dp_shard", None), P("dp_shard", None), x2d)
    flags = jnp.asarray([True, False] * (N // 2))
    bwant = _shard_map(mesh4, lambda s: jc.broadcast_from(s, "dp_shard", src=2),
                       P("dp_shard"), P("dp_shard"), flags)
    for rank in range(N):
        np.testing.assert_array_equal(gang[rank]["broadcast_from_2d"], want[rank:rank + 1])
        dtype, got = gang[rank]["broadcast_from_bool"]
        assert dtype == "torch.bool"
        np.testing.assert_array_equal(got, bwant[rank:rank + 1])
        assert "out of range" in gang[rank]["broadcast_from_range"]
    with pytest.raises(ValueError, match="out of range"):
        _shard_map(mesh4, lambda s: jc.broadcast_from(s, "dp_shard", src=N), P("dp_shard"),
                   P("dp_shard"), x)


def test_process_collectives_match_numpy(gang):
    sizes = np.arange(1, N + 1)
    for rank in range(N):
        g = gang[rank]
        np.testing.assert_array_equal(g["gather"], np.repeat(np.arange(float(N)), 2)[:, None]
                                      * np.ones((1, 3)))
        assert g["gather_object"] == [f"r{r}" for r in range(N) for _ in range(r + 1)]
        assert g["broadcast_object_list"] == ["from1", 1]
        np.testing.assert_array_equal(g["broadcast"], np.full(3, float(N - 1)))
        mine = np.arange(float(rank + 1)) + 1
        pad = np.full(sizes.max(), -1.0)
        pad_end, pad_start = pad.copy(), pad.copy()
        pad_end[:mine.size] = mine
        pad_start[pad.size - mine.size:] = mine
        np.testing.assert_array_equal(g["pad"], pad_end)
        np.testing.assert_array_equal(g["pad_first"], pad_start)
        total = np.sum([[1.0 + r, 2.0 * r] for r in range(N)], axis=0)
        np.testing.assert_array_equal(g["reduce_sum"], total)
        np.testing.assert_array_equal(g["reduce_mean_scaled"], total / N * 0.5)
        np.testing.assert_array_equal(g["reduce_tree"]["a"], [float(sum(range(N)))])
        np.testing.assert_array_equal(g["reduce_tree"]["b"][0], [[sum(range(N)), N]])
        # the façade: split with padding, the trigger summed across ranks
        per = -(-(2 * N + 1) // N)
        want = list(range(2 * N + 1))[rank * per:(rank + 1) * per]
        assert g["split"] == want + [2 * N] * (per - len(want))
        assert g["trigger"] == (True, False)
        assert g["distributed_type"] == "MULTI_HOST"


def test_synchronize_rng_states_makes_next_draws_equal(gang):
    """Each rank seeded apart; after ``synchronize_rng_states`` every rank's
    next python, numpy and torch draws are rank 0's."""
    assert len({g["draws"] for g in gang}) == 1


# -- LocalSGD ------------------------------------------------------------------


class _FakeState:
    def __init__(self, params):
        self.params = params

    def replace(self, params):
        return _FakeState(params)


def test_local_sgd_single_process_noop():
    sgd = LocalSGD(local_sgd_steps=2)
    assert not sgd.enabled
    state = _FakeState({"w": torch.ones(4)})
    assert sgd.step(state) is state


def test_local_sgd_cadence(monkeypatch):
    calls = []

    def fake_reduce(params, reduction="mean"):
        calls.append(reduction)
        return {k: v.clone() for k, v in params.items()}

    sgd = LocalSGD(local_sgd_steps=3)
    sgd.enabled = True
    monkeypatch.setattr(tlocal.ops, "reduce", fake_reduce)
    state = _FakeState({"w": torch.ones(4)})
    for i in range(1, 10):
        state = sgd.step(state)
        assert len(calls) == i // 3
    assert all(c == "mean" for c in calls)
    out = sgd.sync({"a": torch.arange(3.0)})
    np.testing.assert_allclose(out["a"].numpy(), [0, 1, 2])


def test_local_sgd_rejects_bad_steps_and_warns_mid_cadence(monkeypatch):
    with pytest.raises(ValueError, match="local_sgd_steps"):
        LocalSGD(local_sgd_steps=0)
    with LocalSGD(local_sgd_steps=4) as sgd:
        assert sgd.num_steps == 0
    monkeypatch.setattr(tlocal.ops, "reduce", lambda p, reduction="mean": p)
    with pytest.warns(UserWarning, match="LocalSGD exited"):
        with LocalSGD(local_sgd_steps=4) as sgd:
            sgd.enabled = True
            sgd.step({"a": torch.ones(1)})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with LocalSGD(local_sgd_steps=1) as sgd:
            sgd.enabled = True
            sgd.step({"a": torch.ones(1)})


def test_local_sgd_on_two_ranks_averages_at_cadence(tmp_path):
    """Rank r moves its params by (r + 1) * step each step; at every
    second step they become the ranks' numpy mean; the last, unsynced step
    warns."""
    steps, cadence = 5, 2
    reps = run_gang(f"{SCRIPTS}:local_sgd_checks", 2, tmp_path, timeout=120, steps=steps,
                    cadence=cadence)
    start = {"w": np.zeros(3), "b": np.ones(2)}
    per_rank = [dict(start) for _ in range(2)]
    for step in range(1, steps + 1):
        per_rank = [{k: v + (r + 1) * step for k, v in p.items()} for r, p in enumerate(per_rank)]
        if step % cadence == 0:
            mean = {k: (per_rank[0][k] + per_rank[1][k]) / 2 for k in start}
            per_rank = [dict(mean), dict(mean)]
        for r in range(2):
            for k in start:
                np.testing.assert_array_equal(reps[r]["seen"][step - 1][k], per_rank[r][k])
    assert all(rep["enabled"] and rep["warned"] for rep in reps)
