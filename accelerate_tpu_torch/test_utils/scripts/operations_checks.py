"""Gang workers of ``tests/test_torch_operations.py`` and
``tests/test_torch_parallelism_config.py``: the mesh collectives, the
process collectives, the RNG synchronisation and LocalSGD on each rank.
Every function returns plain numpy / python values for the test process
to hold against the JAX package's results."""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


def mesh_checks(rank: int, world: int) -> dict:
    """A ``DeviceMesh`` built from configs on this world: names, shape,
    this rank's coordinates and each dimension's group ranks."""
    import torch.distributed as dist

    from ...parallelism_config import ParallelismConfig

    out = {}
    for label, cfg in (("dp_shard", ParallelismConfig(dp_shard_size=world)),
                       ("hsdp", ParallelismConfig(dp_replicate_size=2, dp_shard_size=world // 2)),
                       ("cp", ParallelismConfig(cp_size=2, dp_shard_size=world // 2))):
        mesh = cfg.build_device_mesh("cpu")
        out[label] = {
            "names": tuple(mesh.mesh_dim_names), "shape": tuple(mesh.mesh.shape),
            "coords": {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names},
            "groups": {n: dist.get_process_group_ranks(mesh.get_group(n))
                       for n in cfg.active_mesh_dims},
        }
    return out


def collective_checks(rank: int, world: int) -> dict:
    """JAX ``tests/test_operations.py``'s mesh cases (:117-286) on a
    ``dp_shard`` mesh of this world, each rank holding its shard of the
    global input, and the process collectives."""
    from ...ops import operations as ops
    from ...parallel import collectives as C
    from ...parallelism_config import ParallelismConfig
    from ...state import AcceleratorState

    state = AcceleratorState(cpu=True, parallelism_config=ParallelismConfig(dp_shard_size=world))
    mesh = state.mesh
    n = world
    x = torch.arange(float(n))[rank:rank + 1]                 # shard of arange(n)
    out = {"psum": _np(C.psum(x, "dp_shard")),
           "pmean": _np(C.pmean(x, "dp_shard")),
           "pmax": _np(C.pmax(x, "dp_shard")),
           "pmin": _np(C.pmin(x, ("dp_shard",))),
           "all_gather": _np(C.all_gather(x, "dp_shard", axis=0, tiled=True)),
           "all_gather_stacked": _np(C.all_gather(x, "dp_shard", axis=0, tiled=False)),
           "axis_index": C.axis_index("dp_shard"), "axis_size": C.axis_size("dp_shard")}
    for shift in (1, 3, -1, n):
        out[f"ring_permute_{shift}"] = _np(C.ring_permute(x, "dp_shard", shift=shift))
    out["ppermute_partial"] = _np(C.ppermute(x, "dp_shard", [(0, 1)]))
    rows = 8 * n
    block = torch.ones(rows // n, 8)                           # shard of ones((8n, 8))
    out["reduce_scatter"] = _np(C.reduce_scatter(block, "dp_shard", axis=0))
    mat = torch.arange(float(n * n)).reshape(n, n)[rank:rank + 1]
    out["all_to_all"] = _np(C.all_to_all(mat, "dp_shard", split_axis=1, concat_axis=0))
    x10 = x * 10.0
    out["broadcast_from"] = {src: _np(C.broadcast_from(x10, "dp_shard", src=src))
                             for src in (0, n - 1)}
    x2d = (torch.arange(4.0 * n).reshape(n, 4) - 7.0)[rank:rank + 1]
    out["broadcast_from_2d"] = _np(C.broadcast_from(x2d, "dp_shard", src=n // 2))
    flags = torch.tensor([True, False] * (n // 2))[rank:rank + 1]
    got = C.broadcast_from(flags, "dp_shard", src=2 % n)
    out["broadcast_from_bool"] = (str(got.dtype), _np(got))
    try:
        C.broadcast_from(x, "dp_shard", src=n)
        out["broadcast_from_range"] = None
    except ValueError as e:
        out["broadcast_from_range"] = str(e)

    # the process collectives, against numpy in the test process
    out["gather"] = _np(ops.gather(torch.full((2, 3), float(rank))))
    out["gather_object"] = ops.gather_object([f"r{rank}"] * (rank + 1))
    objs = [f"from{rank}", rank] if rank == 1 else [None, None]
    out["broadcast_object_list"] = ops.broadcast_object_list(objs, from_process=1)
    out["broadcast"] = _np(ops.broadcast(torch.full((3,), float(rank)), from_process=n - 1))
    ragged = torch.arange(float(rank + 1)) + 1
    out["pad"] = _np(ops.pad_across_processes(ragged, dim=0, pad_index=-1))
    out["pad_first"] = _np(ops.pad_across_processes(ragged, dim=0, pad_index=-1,
                                                    pad_first=True))
    val = torch.tensor([1.0 + rank, 2.0 * rank])
    out["reduce_sum"] = _np(ops.reduce(val, reduction="sum"))
    out["reduce_mean_scaled"] = _np(ops.reduce(val, reduction="mean", scale=0.5))
    tree = {"a": torch.tensor([float(rank)]), "b": [torch.tensor([[rank, 1]])]}
    out["reduce_tree"] = {k: (_np(v) if not isinstance(v, list) else [_np(v[0])])
                          for k, v in ops.reduce(tree, reduction="sum").items()}
    # the RNG streams: each rank seeded apart, then rank 0's state everywhere
    import random

    from ...utils.random import set_seed, synchronize_rng_states

    set_seed(1000 + rank)
    synchronize_rng_states(["python", "numpy", "torch"])
    out["draws"] = (random.random(), float(np.random.rand()), float(torch.rand(())))
    # the accelerator's façade at world n
    from ...accelerator import Accelerator

    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(dp_shard_size=n))
    with acc.split_between_processes(list(range(2 * n + 1)), apply_padding=True) as part:
        out["split"] = part
    if rank == n - 1:
        acc.set_trigger()
    out["trigger"] = (acc.check_trigger(), acc.check_trigger())
    out["distributed_type"] = str(acc.distributed_type)
    return out


def local_sgd_checks(rank: int, world: int, steps: int = 5, cadence: int = 2) -> dict:
    """LocalSGD over this world: each rank moves its params by its own
    amount every step; every ``cadence`` steps they are averaged."""
    import warnings

    from ...local_sgd import LocalSGD

    params = {"w": torch.zeros(3), "b": torch.ones(2)}
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with LocalSGD(local_sgd_steps=cadence) as sgd:
            for step in range(1, steps + 1):
                for k, p in params.items():
                    p.add_(float(rank + 1) * step)
                sgd.step(params)
                seen.append({k: _np(v).copy() for k, v in params.items()})
    return {"seen": seen, "enabled": sgd.enabled,
            "warned": any("LocalSGD exited" in str(w.message) for w in caught)}
