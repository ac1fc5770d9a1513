"""A gloo world of CPU processes for the port's multi-rank tests.

:func:`run_gang` starts ``nprocs`` Python processes, each running
``worker(rank, world, **kwargs)`` (``"package.module:function"``) after
the port's ``PartialState(cpu=True)`` has joined the world through the
JAX package's environment contract (``ACCELERATE_COORDINATOR_ADDRESS``
set to a ``file://`` rendezvous under ``workdir``: no TCP port, so
concurrent gangs cannot collide).  Each process runs single-threaded
(``torch.set_num_threads(1)``).  The whole gang has one timeout; a
process that fails or outlives it fails the gang, and every process is
stopped.  Returns each rank's return value, unpickled, in rank order.
``exit_code`` names another code every process must exit with (a
preempted gang's resume code, 75): such a gang returns nothing.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

_BOOT = (
    "import sys, pickle, torch\n"
    "torch.set_num_threads(1)\n"
    "from accelerate_tpu_torch.test_utils.gang import _worker_main\n"
    "_worker_main(sys.argv[1], sys.argv[2], sys.argv[3])\n"
)

REPO = Path(__file__).resolve().parents[2]


def _worker_main(target: str, kwargs_path: str, out_path: str) -> None:
    import importlib

    from ..state import PartialState

    with open(kwargs_path, "rb") as f:
        kwargs = pickle.load(f)
    device = kwargs.get("device", "cpu")
    # a card gang shares one GPU: its world is gloo on the host
    state = (PartialState(cpu=True) if device == "cpu"
             else PartialState(device=device, backend="gloo"))
    module, fn = target.split(":")
    result = getattr(importlib.import_module(module), fn)(state.process_index,
                                                         state.num_processes, **kwargs)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    state.destroy_process_group()


def run_gang(target: str, nprocs: int, workdir, timeout: float = 120.0, exit_code: int = 0,
             device: str = "cpu", **kwargs) -> list:
    """Run ``target`` on a gloo world of ``nprocs`` CPU processes (see the
    module doc); ``kwargs`` must pickle.  Every process must exit with
    ``exit_code``; with another than 0 the result is ``[None] * nprocs``.
    ``device="cuda:0"`` puts every process on that card, their world still
    gloo on the host (``PartialState(backend="gloo")``); the worker then
    gets ``device`` among its keyword arguments."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    if store.exists():
        store.unlink()
    kwargs_path = workdir / "kwargs.pkl"
    with open(kwargs_path, "wb") as f:
        pickle.dump(dict(kwargs, device=device) if device != "cpu" else kwargs, f)
    procs, logs = [], []
    for rank in range(nprocs):
        env = dict(os.environ, ACCELERATE_COORDINATOR_ADDRESS=f"file://{store}",
                   ACCELERATE_NUM_PROCESSES=str(nprocs), ACCELERATE_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=f"{REPO}{os.pathsep}"
                   + os.environ.get("PYTHONPATH", ""))
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(key, None)
        log = open(workdir / f"rank{rank}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _BOOT, target, str(kwargs_path),
             str(workdir / f"out{rank}.pkl")], env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = f"the gang outlived its {timeout:.0f} s timeout"
                break
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, exit_code)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != exit_code]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        tails = "\n".join(f"--- rank {r} ---\n" + (workdir / f"rank{r}.log").read_text()[-4000:]
                          for r in range(nprocs))
        raise RuntimeError(f"{target}: {failed}\n{tails}")
    if exit_code != 0:
        return [None] * nprocs
    out = []
    for rank in range(nprocs):
        with open(workdir / f"out{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
