"""``ParallelismConfig`` held against the JAX package's: every case of JAX
``tests/test_parallelism_config.py`` with both packages, exactly (sizes,
dimension names, validation, the environment transport, ``batch_spec``),
the mesh layout against JAX's mesh, and a built ``DeviceMesh`` on a
4-rank gloo world (``accelerate_tpu_torch/test_utils/gang.py``)."""

import os

import jax
import numpy as np
import pytest

from accelerate_tpu.parallelism_config import MESH_AXIS_ORDER as JAX_ORDER
from accelerate_tpu.parallelism_config import ParallelismConfig as JConfig
from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER, ParallelismConfig
from accelerate_tpu_torch.test_utils.gang import run_gang

DEVICES = 8  # the JAX test mesh


def _entry(e):
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def _both(**kw):
    return ParallelismConfig(**kw), JConfig(**kw)


def _layout_equal(kw, n=DEVICES):
    cfg, jcfg = _both(**kw)
    names, shape = cfg.mesh_layout(n)
    mesh = jcfg.build_device_mesh(devices=jax.devices()[:n])
    assert names == tuple(mesh.axis_names) == JAX_ORDER == MESH_AXIS_ORDER
    assert dict(zip(names, shape)) == dict(mesh.shape)
    return cfg, jcfg


def test_default_single():
    cfg, jcfg = _both()
    assert cfg.total_size == jcfg.total_size == 1
    assert cfg.mesh_layout(1)[1] == (1,) * 8


def test_dp_shard_mesh():
    cfg, _ = _layout_equal(dict(dp_shard_size=8))
    assert dict(zip(*cfg.mesh_layout(8)))["dp_shard"] == 8


def test_2d_mesh():
    _layout_equal(dict(dp_shard_size=4, tp_size=2))


def test_hsdp_mesh():
    cfg, jcfg = _layout_equal(dict(dp_replicate_size=2, dp_shard_size=4))
    assert cfg.dp_dim_names == jcfg.dp_dim_names == ("dp_replicate", "dp_shard")


def test_infer_dp_shard():
    cfg, jcfg = _layout_equal(dict(dp_shard_size=-1, tp_size=2))
    assert cfg.dp_shard_size == jcfg.dp_shard_size == 4


@pytest.mark.parametrize("kw", [dict(dp_shard_size=3),
                                dict(cp_size=2, sp_size=2, dp_shard_size=2),
                                dict(dp_shard_size=0), dict(dp_shard_size=-1, tp_size=3)])
def test_invalid_configs_raise_jax_messages(kw):
    cfg, jcfg = _both(**kw)
    with pytest.raises(ValueError) as theirs:
        jcfg._validate(DEVICES)
    with pytest.raises(ValueError) as ours:
        cfg.mesh_layout(DEVICES)
    assert str(ours.value) == str(theirs.value)


def test_joint_dims():
    cfg, jcfg = _both(dp_shard_size=2, cp_size=2, tp_size=2)
    for name in ("dp_shard_cp_dim_names", "dp_cp_dim_names", "fsdp_dim_names", "seq_dim_names",
                 "dp_dim_names", "batch_dim_names", "active_mesh_dims",
                 "non_data_parallel_size", "data_parallel_size", "total_size", "has_dcn"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.fsdp_dim_names == ("dp_shard", "cp")


def test_env_roundtrip():
    cfg, jcfg = _both(dp_replicate_size=2, dp_shard_size=2, tp_size=2)
    assert cfg.to_env() == jcfg.to_env()
    old = dict(os.environ)
    try:
        os.environ.update(cfg.to_env())
        assert ParallelismConfig.from_env() == cfg
        assert vars(JConfig.from_env())["dp_replicate_size"] == 2
    finally:
        os.environ.clear()
        os.environ.update(old)


@pytest.mark.parametrize("kw, args", [(dict(dp_shard_size=4, cp_size=2), (1, 3)),
                                      (dict(dp_shard_size=4, cp_size=2), (None, 2)),
                                      (dict(dp_replicate_size=2, dp_shard_size=4), (1, 2)),
                                      (dict(), (1, 2))])
def test_batch_spec(kw, args):
    cfg, jcfg = _both(**kw)
    ours, theirs = cfg.batch_spec(*args), jcfg.batch_spec(*args)
    assert [_entry(e) for e in ours] == [_entry(e) for e in theirs]


def test_mesh_canonical_order():
    cfg, _ = _layout_equal(dict(dp_shard_size=8))
    assert cfg.mesh_layout(8)[0] == MESH_AXIS_ORDER


def test_dcn_axis_outermost_and_transport():
    cfg, jcfg = _layout_equal(dict(dcn_size=2, dp_shard_size=4))
    assert MESH_AXIS_ORDER[0] == "dcn"
    assert cfg.has_dcn and cfg.data_parallel_size == 8
    for name in ("dp_dim_names", "batch_dim_names", "dp_cp_dim_names", "fsdp_dim_names"):
        assert getattr(cfg, name) == getattr(jcfg, name)
    assert "dcn" not in cfg.fsdp_dim_names
    assert cfg.to_env()["PARALLELISM_CONFIG_DCN_SIZE"] == "2"


def test_dcn_dp_shard_inference_accounts_for_slices():
    cfg, jcfg = _both(dcn_size=2, dp_shard_size=-1)
    cfg._validate(8)
    jcfg._validate(8)
    assert cfg.dp_shard_size == jcfg.dp_shard_size == 4
    assert str(cfg) == str(jcfg)


def test_device_mesh_on_a_gang(tmp_path):
    """``build_device_mesh`` on a 4-rank world: the eight named axes in
    JAX's order and shape, each rank's coordinates its row-major position,
    each dimension's group the ranks that differ only there."""
    reps = run_gang("accelerate_tpu_torch.test_utils.scripts.operations_checks:mesh_checks",
                    4, tmp_path, timeout=120)
    layouts = {"dp_shard": dict(dp_shard_size=4), "hsdp": dict(dp_replicate_size=2,
                                                               dp_shard_size=2),
               "cp": dict(cp_size=2, dp_shard_size=2)}
    for label, kw in layouts.items():
        names, shape = ParallelismConfig(**kw).mesh_layout(4)
        jmesh = JConfig(**kw).build_device_mesh(devices=jax.devices()[:4])
        for rank, rep in enumerate(reps):
            got = rep[label]
            assert got["names"] == names and got["shape"] == shape
            assert dict(zip(names, shape)) == dict(jmesh.shape)
            coords = dict(zip(names, np.unravel_index(rank, shape)))
            assert got["coords"] == {n: int(c) for n, c in coords.items()}
            for axis, ranks in got["groups"].items():
                want = [r for r in range(4)
                        if all(np.unravel_index(r, shape)[i] == coords[n]
                               for i, n in enumerate(names) if n != axis)]
                assert ranks == want, (label, axis)
