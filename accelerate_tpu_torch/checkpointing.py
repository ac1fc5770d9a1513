"""Checkpoint / resume (mirrors
``accelerate_tpu/checkpointing.py``).

``save_accelerator_state`` writes the train state and everything that
rides beside it: the RNG streams (python, numpy, the root seed, torch's
CPU generator and every CUDA generator), the data loaders' positions, the
schedulers' counts, the step count and goodput counters, and registered
custom objects; ``ProjectConfiguration(automatic_checkpoint_naming=True)``
names the directories ``checkpoints/checkpoint_<i>`` and ``total_limit``
keeps the newest.

Every checkpoint is **verified and atomic**, as in the JAX package: all
files stage under ``checkpoint_<i>.tmp``, a manifest of per-file sizes and
crc32 checksums (``native.crc32``) is written last, and one ``os.replace``
publishes the directory.  ``load_accelerator_state`` verifies the manifest
and, with no ``input_dir``, falls back to the newest checkpoint that
verifies and restores; retention GC never deletes the only checkpoint a
fallback could still select.  The manifest, the layout names and the
``save_model`` files are the JAX package's, byte for byte.

The train state is the port's own format (orbax imports JAX): under
``train_state/``, three safetensors files written by the native IO engine,
one tensor per leaf — ``params.safetensors`` (params by name),
``opt_state.safetensors`` (the optimizer state's tensors by flatten index,
its ``count`` and hyperparameters in the header's metadata) and
``state.safetensors`` (``step``, the ``TrainState.rng`` generator's state,
``guard_state``, the carried accumulator, the fp16 loss scale, the fp8
metas and the gradient codec's ``comm_state``: every rank's Qs and
residuals stacked ``[world, ...]``, as the JAX package lays the residuals
out, each rank restoring its own row).  The port's step updates the
params in place, so a save first **snapshots** every leaf: a copy to
pinned host memory issued on the current stream, ordered before the next
step's update.  ``async_save=True`` returns after issuing that copy; a
background thread waits for it and writes the files, and the publish runs
at the next save or load, ``wait_for_checkpoint``, or interpreter exit.

In a world of several processes a save is collective.  Rank 0 names the
directory and writes the shared files; every rank writes its own
``random_states_<i>.pkl``.  Under a parallelism config the train state is
written in the **sharded layout**: each rank writes only its own ranges of
the params and the optimizer state (the -sr8 codes with their per-block
scales, momentum) to ``train_state/shard_<rank>.safetensors``, in global
coordinates (runs of the whole leaf's row-major flatten, packed in the
file's metadata; padding lanes are never written), and rank 0 writes
``index.json`` (each leaf's global shape and dtype, the optimizer state's
tensors and their global lengths, the shard files) and ``state.safetensors``
(the replicated extras); a range held by several ranks is written by the
first of them.  No rank gathers the state.  Each rank's carried
accumulator rides its own shard.  Rank 0 publishes once every rank has
written its files (the ranks agree on it first) and every rank confirms
the manifest before the save returns; after ``async_save=True`` each rank
snapshots its own leaves, writes them on its writer thread, and the
publish runs at the next save or load, ``wait_for_checkpoint`` or
``end_training``, on every rank together.  The interpreter-exit flush of a
save across processes only waits for its own writer: one rank alone never
publishes.  Without a parallelism config rank 0 writes the whole leaves.

A restore reads onto any template plan (another process count; FULL_SHARD,
SHARD_GRAD_OP or NO_SHARD; another tp or ep size; one process without a
plan), from either layout: each rank computes the runs its tensors hold
and reads only those, at their file offsets (:class:`_Source`).  The
codec's rows restore only onto the same world, as the carried
accumulators do.  :func:`merge_weights` consolidates either layout.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import pickle
import random
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from . import native
from .logging import get_logger
from .resilience.faults import active_fault_plan, corrupt_checkpoint, fault_point, maybe_fail_transfer
from .resilience.retry import DEFAULT_POLICY, RetryPolicy, with_retries
from .utils.constants import (
    CHECKPOINT_DIR_PATTERN,
    CHECKPOINT_DIR_PREFIX,
    CHECKPOINT_MANIFEST_NAME,
    CHECKPOINT_TMP_SUFFIX,
    CUSTOM_STATES_NAME,
    METADATA_NAME,
    RNG_STATE_NAME,
    SAFE_WEIGHTS_INDEX_NAME,
    SAFE_WEIGHTS_NAME,
    SAFE_WEIGHTS_SHARD_PATTERN,
    SAMPLER_STATES_NAME,
    SCHEDULER_STATES_NAME,
    TRAIN_STATE_DIR,
)
from .utils.serialization import (
    _DTYPE_TO_STR as _DTYPE_NAME,
    load_safetensors,
    safetensors_metadata,
    save_safetensors,
)

logger = get_logger(__name__)

PARAMS_FILE = "params.safetensors"
OPT_STATE_FILE = "opt_state.safetensors"
STATE_FILE = "state.safetensors"
TRAIN_STATE_FORMAT = "accelerate_tpu_torch.train_state.v1"
SHARDED_FORMAT = "accelerate_tpu_torch.train_state.sharded.v1"
INDEX_FILE = "index.json"
SHARD_FILE = "shard_{:05d}.safetensors"


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested checkpoint failed verification (or no valid
    checkpoint survived the auto-resume fallback scan)."""


def _resilience_knobs(accelerator) -> tuple[bool, RetryPolicy]:
    """(verify / manifest enabled, I/O retry policy) from the accelerator's
    ResiliencePlugin; the library defaults where there is none."""
    rp = getattr(accelerator, "resilience_plugin", None)
    if rp is None:
        return True, DEFAULT_POLICY
    return bool(rp.verify_checkpoints), RetryPolicy(retries=rp.io_retries,
                                                    backoff_s=rp.io_backoff_s)


def _io_retry(accelerator, fn, site: str, policy: Optional[RetryPolicy] = None):
    """Checkpoint-I/O retry: the ``checkpoint_io`` fault fires inside each
    attempt, and retries feed the accelerator's goodput counters."""
    goodput = getattr(accelerator, "goodput", None)

    def attempt():
        maybe_fail_transfer("checkpoint_io")
        return fn()

    return with_retries(
        attempt,
        policy=policy if policy is not None else _resilience_knobs(accelerator)[1],
        site=site,
        on_retry=goodput.record_retry if goodput is not None else None,
    )


# ---------------------------------------------------------------------------
# verified atomic checkpoints: manifest + tmp-stage + one os.replace
# ---------------------------------------------------------------------------


def _payload_files(root: Path) -> list[Path]:
    return [p for p in sorted(root.rglob("*"))
            if p.is_file() and p.name != CHECKPOINT_MANIFEST_NAME]


def _crc32_all(paths: list[Path]) -> list[int]:
    """Each file's crc32, the files checksummed on parallel threads (the
    native checksum releases the GIL)."""
    if len(paths) <= 1:
        return [native.file_crc32(p) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(min(8, len(paths))) as pool:
        return list(pool.map(native.file_crc32, paths))


def write_checkpoint_manifest(ckpt_dir) -> str:
    """Record every file's size and crc32 under ``ckpt_dir`` in
    ``checkpoint_manifest.json`` (the JAX package's format).  Written last,
    before the atomic publish, so a manifest's presence asserts that every
    listed byte reached the staging directory."""
    root = Path(ckpt_dir)
    paths = _payload_files(root)
    crcs = _crc32_all(paths)
    files = {p.relative_to(root).as_posix(): {"size": p.stat().st_size, "crc32": f"{c:08x}"}
             for p, c in zip(paths, crcs)}
    out = root / CHECKPOINT_MANIFEST_NAME
    out.write_text(json.dumps({"version": 1, "files": files}, indent=1))
    return str(out)


def verify_checkpoint(ckpt_dir) -> tuple[bool, list[str]]:
    """``(ok, problems)`` for one checkpoint directory: every manifest entry
    is checked for existence, size and crc32.  A directory without a
    manifest passes as valid-but-unverified with a note; a ``*.tmp``
    staging directory or a missing path is invalid."""
    root = Path(ckpt_dir)
    if not root.is_dir():
        return False, ["missing directory"]
    if root.name.endswith(CHECKPOINT_TMP_SUFFIX):
        return False, ["unpublished .tmp staging directory (torn write)"]
    manifest = root / CHECKPOINT_MANIFEST_NAME
    if not manifest.exists():
        return True, ["no manifest (unverified pre-resilience checkpoint)"]
    try:
        payload = json.loads(manifest.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return False, [f"unreadable manifest: {e}"]
    problems, to_check = [], []
    for rel, meta in payload.get("files", {}).items():
        p = root / rel
        if not p.is_file():
            problems.append(f"missing file {rel}")
            continue
        size = p.stat().st_size
        if size != meta.get("size"):
            problems.append(f"size mismatch {rel}: {size} != {meta.get('size')}")
            continue
        to_check.append((rel, p, meta.get("crc32")))
    for (rel, _, want), crc in zip(to_check, _crc32_all([p for _, p, _ in to_check])):
        if f"{crc:08x}" != want:
            problems.append(f"checksum mismatch {rel}")
    return (not problems), problems


# per-directory stat snapshot taken at finalize (and refreshed after a full
# verify): the retention-GC validity scan compares stats (sizes + mtimes,
# no byte reads) and falls back to a full crc32 verify only when a file
# changed under it — the save loop never re-reads what it just wrote
_FINALIZED_SNAPSHOTS: dict = {}


def _file_stats(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(root.rglob("*")) if p.is_file()}


def _presumed_valid_for_gc(ckpt_dir: Path) -> bool:
    """GC's validity oracle: the finalize-time stat snapshot first; any drift
    (or no snapshot) falls back to the full verify, whose positive result is
    then snapshotted."""
    key = str(ckpt_dir)
    snap = _FINALIZED_SNAPSHOTS.get(key)
    if snap is not None:
        try:
            if _file_stats(ckpt_dir) == snap:
                return True
        except OSError:
            pass
    ok = verify_checkpoint(ckpt_dir)[0]
    if ok:
        try:
            _FINALIZED_SNAPSHOTS[key] = _file_stats(ckpt_dir)
        except OSError:  # raced deletion
            _FINALIZED_SNAPSHOTS.pop(key, None)
    else:
        _FINALIZED_SNAPSHOTS.pop(key, None)
    return ok


def _finalize_checkpoint(tmp_dir, final_dir, manifest: bool = True,
                         record: Optional[dict] = None) -> None:
    """Publish a staged checkpoint: the manifest over the complete staging
    directory, then one ``os.replace``.  Then the ``post_save`` fault hook
    (injected corruption after the publish, as bit rot would land).
    ``record`` (a save's entry of ``Accelerator.checkpoint_log``) gets the
    manifest's seconds and the publish time."""
    tmp, final = Path(tmp_dir), Path(final_dir)
    t0 = time.perf_counter()
    if manifest:
        write_checkpoint_manifest(tmp)
    if record is not None:
        record["manifest_s"] = time.perf_counter() - t0
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    if record is not None:
        record["published_at"] = time.perf_counter()
    # snapshot BEFORE the fault hook: injected corruption must read as drift
    # to the GC oracle, as real bit rot would
    _FINALIZED_SNAPSHOTS[str(final)] = _file_stats(final)
    for ev in fault_point("post_save"):
        if ev.kind == "corrupt_ckpt":
            plan = active_fault_plan()
            corrupt_checkpoint(final, mode=ev.mode, seed=plan.seed if plan else 0)


# ---------------------------------------------------------------------------
# async-save lifecycle
# ---------------------------------------------------------------------------


class _AsyncCheckpointer:
    """One background writer thread (the port's AsyncCheckpointer): ``save``
    runs a write job on it, ``wait_until_finished`` waits for the job and
    raises what it raised."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="ckpt-writer")
        self._future = None

    def save(self, job) -> None:
        self._future = self._pool.submit(job)

    def wait_until_finished(self) -> None:
        future, self._future = self._future, None
        if future is not None:
            future.result()

    def close(self) -> None:
        self._pool.shutdown(wait=True)


# strong refs on purpose: a garbage-collected Accelerator must not orphan an
# in-flight write
_LIVE_ASYNC_CKPTRS: set = set()
# ckptr -> (tmp_dir, final_dir, manifest): the publish deferred until that
# checkpointer's write commits
_PENDING_FINALIZES: dict = {}
_atexit_registered = False


def _run_pending_finalize(ckptr) -> None:
    fin = _PENDING_FINALIZES.pop(ckptr, None)
    if fin is not None:
        _finalize_checkpoint(*fin)


def _flush_live_checkpointers_at_exit() -> None:
    while _LIVE_ASYNC_CKPTRS:
        ckptr = _LIVE_ASYNC_CKPTRS.pop()
        try:
            ckptr.wait_until_finished()
            _run_pending_finalize(ckptr)
        except Exception:  # one failed write must not orphan the others
            import traceback

            _PENDING_FINALIZES.pop(ckptr, None)  # leave the .tmp for post-mortem
            traceback.print_exc()
        finally:
            ckptr.close()


def _register_exit_flush() -> None:
    global _atexit_registered
    if _atexit_registered:
        return
    _atexit_registered = True
    register = getattr(threading, "_register_atexit", None)
    if register is not None:
        # plain atexit runs after threading's shutdown has stopped the
        # executors from taking work; threading's own exit hooks run LIFO,
        # so this flush runs while the writer thread can still finish
        register(_flush_live_checkpointers_at_exit)
    else:  # pragma: no cover - a CPython without the private hook
        import atexit

        atexit.register(_flush_live_checkpointers_at_exit)


def _release_async_checkpointer(accelerator, ckptr) -> None:
    _LIVE_ASYNC_CKPTRS.discard(ckptr)
    if getattr(accelerator, "_async_checkpointer", None) is ckptr:
        accelerator._async_checkpointer = None
    ckptr.close()


def wait_for_published_checkpoint(final_dir, verify: bool = True, timeout_s: float = 120.0,
                                  poll_s: float = 0.05) -> None:
    """Block until ``final_dir`` is visible — with its manifest when
    verification is on (the manifest is written last)."""
    target = Path(final_dir) / CHECKPOINT_MANIFEST_NAME if verify else Path(final_dir)
    deadline = time.monotonic() + timeout_s
    while not target.exists():
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"checkpoint publish {final_dir} not visible after "
                f"{timeout_s}s (waiting on {target.name if verify else 'directory'})"
            )
        time.sleep(poll_s)


def _drain(accelerator, ckptr) -> None:
    """Wait for ``ckptr``'s write: the timeline's checkpoint_drain phase,
    and a pause that is not a step (the SLO step cadence starts afresh
    after it)."""
    timeline = getattr(accelerator, "timeline", None)
    if getattr(accelerator, "_slo_prev_step_t", None) is not None:
        accelerator._slo_prev_step_t = None
    with (timeline.phase("checkpoint_drain") if timeline is not None
          else contextlib.nullcontext()):
        ckptr.wait_until_finished()


def _publish_across(accelerator, error, staging, final_dir, verify, record) -> None:
    """The publish of a save across processes, every rank together: the
    ranks agree that each wrote its files (``error``: this rank's failure),
    rank 0 writes the manifest and renames, and every rank confirms the
    manifest is visible before going on.  A failed rank anywhere publishes
    nothing: the ``.tmp`` stays until the next save sweeps it."""
    from .ops.operations import gather_object

    failed = [r for r, bad in enumerate(gather_object(error is not None)) if bad]
    if failed:
        if error is not None:
            raise error
        raise RuntimeError(f"checkpoint {final_dir} not published: rank(s) {failed} failed "
                           "to write their files")
    if accelerator.is_main_process:
        _finalize_checkpoint(staging, final_dir, manifest=verify, record=record)
    accelerator.wait_for_everyone()
    if not accelerator.is_main_process:
        wait_for_published_checkpoint(final_dir, verify=verify)


def wait_for_pending_checkpoint(accelerator) -> None:
    """Block until this process's in-flight ``async_save`` write has
    committed, then publish it.  No-op when nothing is pending.  The next
    ``save_state`` (so retention GC never deletes a directory being
    written), ``load_state`` and the interpreter-exit flush go through
    here.  After a save across processes this is collective (every rank
    calls it at the same point: the next save or load,
    ``wait_for_checkpoint``, ``end_training``), and the interpreter-exit
    flush only waits for this rank's writer: one rank alone never
    publishes."""
    publish = getattr(accelerator, "_pending_publish", None)
    if publish is not None:
        accelerator._pending_publish = None
        ckptr, accelerator._pending_checkpointer = accelerator._pending_checkpointer, None
        error = None
        if ckptr is not None:
            try:
                _drain(accelerator, ckptr)
            except Exception as e:
                _release_async_checkpointer(accelerator, ckptr)
                error = e
        _publish_across(accelerator, error, *publish)
        return
    ckptr = getattr(accelerator, "_pending_checkpointer", None)
    if ckptr is None:
        return
    # clear first: a failed write surfaces once, not at every later save
    accelerator._pending_checkpointer = None
    try:
        _drain(accelerator, ckptr)
    except BaseException:
        # a failed write poisons the checkpointer: release its thread; the
        # .tmp stays for post-mortem and the next save sweeps it
        _PENDING_FINALIZES.pop(ckptr, None)
        _release_async_checkpointer(accelerator, ckptr)
        raise
    _run_pending_finalize(ckptr)


def close_async_checkpointer(accelerator) -> None:
    """Terminal flush: await any pending write, then release the writer
    thread."""
    wait_for_pending_checkpoint(accelerator)
    ckptr = getattr(accelerator, "_async_checkpointer", None)
    if ckptr is not None:
        _release_async_checkpointer(accelerator, ckptr)


# ---------------------------------------------------------------------------
# naming + retention
# ---------------------------------------------------------------------------


def _auto_checkpoint_dir(accelerator, output_dir: Optional[str]):
    pc = accelerator.project_configuration
    if output_dir is not None:
        return Path(output_dir)
    if pc.project_dir is None:
        raise ValueError("Pass output_dir or configure ProjectConfiguration(project_dir=...)")
    base = Path(pc.project_dir) / "checkpoints"
    if not pc.automatic_checkpoint_naming:
        return base
    base.mkdir(parents=True, exist_ok=True)
    # sweep dead staging dirs: the caller drained this process's pending
    # write, so a surviving *.tmp is a torn write of a crashed run
    for stale_tmp in base.glob(f"{CHECKPOINT_DIR_PREFIX}_*{CHECKPOINT_TMP_SUFFIX}"):
        if stale_tmp.is_dir():
            shutil.rmtree(stale_tmp, ignore_errors=True)
    existing = sorted(
        (p for p in base.iterdir() if re.fullmatch(CHECKPOINT_DIR_PATTERN, p.name)),
        key=lambda p: int(p.name.split("_")[1]),
    )
    if pc.total_limit is not None and len(existing) + 1 > pc.total_limit:
        doomed = existing[: len(existing) + 1 - pc.total_limit]
        survivors = existing[len(existing) + 1 - pc.total_limit:]
        # never delete the checkpoint a fallback scan could still select: if
        # no survivor verifies, spare the newest valid doomed one this round
        spare = None
        if not any(_presumed_valid_for_gc(s) for s in reversed(survivors)):
            for d in reversed(doomed):
                if _presumed_valid_for_gc(d):
                    spare = d
                    break
        for stale in doomed:
            if stale == spare:
                logger.warning(
                    "retention GC sparing %s: it is the newest checkpoint "
                    "that verifies (every newer one is corrupt or partial)", stale,
                )
                continue
            shutil.rmtree(stale, ignore_errors=True)
    if existing:
        # a resumed process starts at iteration 0 but inherits the
        # directory: numbering continues past what is on disk
        pc.iteration = max(pc.iteration, int(existing[-1].name.split("_")[1]) + 1)
    out = base / f"{CHECKPOINT_DIR_PREFIX}_{pc.iteration}"
    pc.iteration += 1
    return out


def list_checkpoints(project_dir: str) -> list[str]:
    base = Path(project_dir) / "checkpoints"
    if not base.is_dir():
        return []
    return [str(p) for p in sorted(
        (p for p in base.iterdir() if re.fullmatch(CHECKPOINT_DIR_PATTERN, p.name)),
        key=lambda p: int(p.name.split("_")[1]),
    )]


# ---------------------------------------------------------------------------
# RNG capture
# ---------------------------------------------------------------------------


def _collect_rng_state() -> dict:
    from .utils.random import get_root_seed

    states: dict[str, Any] = {
        "python": random.getstate(),
        "numpy": np.random.get_state(),
        "root_seed": get_root_seed(),
        "torch": torch.get_rng_state(),
    }
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        states["cuda"] = torch.cuda.get_rng_state_all()
    return states


def _restore_rng_state(states: dict):
    from .utils.random import set_seed

    if "root_seed" in states:
        set_seed(states["root_seed"])
    if "python" in states:
        random.setstate(states["python"])
    if "numpy" in states:
        np.random.set_state(states["numpy"])
    if "torch" in states:
        torch.set_rng_state(states["torch"])
    if "cuda" in states and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(states["cuda"])


# ---------------------------------------------------------------------------
# the train state's files
# ---------------------------------------------------------------------------


def _snapshot(tensors: list, buffers: list) -> list:
    """Host copies of ``tensors``: device tensors copy into pinned buffers
    (reused from ``buffers`` where shape and dtype agree) with
    ``non_blocking`` on the current stream, so the copy is ordered before
    any later in-place update; CPU tensors are cloned."""
    out = []
    for i, t in enumerate(tensors):
        t = t.detach()
        if t.device.type == "cpu":
            out.append(t.clone())
            continue
        buf = buffers[i] if i < len(buffers) else None
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if i < len(buffers):
                buffers[i] = buf
            else:
                buffers.append(buf)
        buf.copy_(t, non_blocking=True)
        out.append(buf)
    return out


def _restore_leaf(template: torch.Tensor, loaded: torch.Tensor, what: str) -> torch.Tensor:
    if loaded.dtype != template.dtype or loaded.numel() != template.numel():
        raise ValueError(f"checkpoint {what}: {loaded.dtype} {tuple(loaded.shape)} does not "
                         f"match the template's {template.dtype} {tuple(template.shape)}")
    return loaded.reshape(template.shape)


def _comm_tensors(train_state, world: int) -> dict:
    """The codec state's tensors as saved: every rank's Qs and residuals
    stacked ``[world, ...]`` (gathered over the processes, every rank
    calling this together; the DCN codec's Qs differ between a node's
    ranks, each compressing its own slab)."""
    if train_state.comm_state is None:
        return {}
    from .ops.operations import gather

    out = {}
    for kind, tree in zip("qe", train_state.comm_state):
        for n, t in tree.items():
            if t is not None:
                out[f"comm_state.{kind}.{n}"] = gather(t[None]) if world > 1 else t[None]
    return out


def _extras(train_state, comm: Optional[dict] = None) -> dict:
    """The train state's tensors beside params and optimizer state, by
    their saved names: the guard's counters, the carried accumulator, the
    fp16 loss scale, the fp8 metas and the codec's stacked rows."""
    extra = {}
    if train_state.guard_state is not None:
        extra.update({f"guard_state.{k}": v for k, v in train_state.guard_state.items()})
    if train_state.grad_accum is not None:
        extra.update({f"grad_accum.{i}": g for i, g in enumerate(train_state.grad_accum)})
    if train_state.loss_scale is not None:
        extra.update({"loss_scale.scale": train_state.loss_scale.scale,
                      "loss_scale.counter": train_state.loss_scale.counter})
    for name, meta in (train_state.fp8_state or {}).items():
        extra.update({f"fp8_state.{name}.amax_history": meta.amax_history,
                      f"fp8_state.{name}.scale": meta.scale})
    extra.update(comm or {})
    return extra


def _record_event(tensors: list):
    """A CUDA event after the host copies just issued (None without card
    tensors): the writer waits on it, not on the stream."""
    if any(t.device.type == "cuda" for t in tensors):
        event = torch.cuda.Event()
        event.record()
        return event
    return None


class _TrainStateSnapshot:
    """A train state's leaves copied to the host: what the writer needs,
    with no reference to the live (in-place updated) tensors."""

    def __init__(self, train_state, buffers: list, comm: Optional[dict] = None):
        from .optimizer import flatten_opt_state

        params = train_state.params
        opt_tensors, opt_meta = flatten_opt_state(train_state.opt_state)
        hyper = opt_meta["hyperparams"]
        hyper_tensors = {k: v for k, v in hyper.items() if isinstance(v, torch.Tensor)}
        extra = _extras(train_state, comm)
        live = [*params.values(), *opt_tensors, *hyper_tensors.values(), *extra.values()]
        host = _snapshot(live, buffers)
        self.event = _record_event(live)
        n_p, n_o, n_h = len(params), len(opt_tensors), len(hyper_tensors)
        self.params = dict(zip(params, host[:n_p]))
        self.opt_tensors = {str(i): t for i, t in enumerate(host[n_p:n_p + n_o])}
        self.hyper = dict(hyper)
        self.hyper.update(zip(hyper_tensors, host[n_p + n_o:n_p + n_o + n_h]))
        self.opt_type, self.opt_fields = opt_meta["type"], opt_meta["fields"]
        self.extra = dict(zip(extra, host[n_p + n_o + n_h:]))
        self.step = int(train_state.step)
        self.accum_step = int(train_state.accum_step)
        self.rng = train_state.rng.get_state() if train_state.rng is not None else None

    def _hyper_numbers(self) -> dict:
        return {k: (v.item() if isinstance(v, torch.Tensor) else v) for k, v in self.hyper.items()}

    def _write_state(self, out_dir: Path, extra: dict) -> None:
        state = {"step": torch.tensor(self.step, dtype=torch.int64),
                 "accum_step": torch.tensor(self.accum_step, dtype=torch.int64), **extra}
        if self.rng is not None:
            state["rng"] = self.rng
        save_safetensors(out_dir / STATE_FILE, state, metadata={"format": TRAIN_STATE_FORMAT})

    def write(self, out_dir: Path) -> int:
        """Wait for the host copies, then write the three files; returns
        the bytes written."""
        if self.event is not None:
            self.event.synchronize()
        out_dir.mkdir(parents=True, exist_ok=True)
        save_safetensors(out_dir / PARAMS_FILE, self.params,
                         metadata={"format": TRAIN_STATE_FORMAT})
        save_safetensors(out_dir / OPT_STATE_FILE, self.opt_tensors, metadata={
            "format": TRAIN_STATE_FORMAT, "type": self.opt_type,
            "fields": json.dumps(self.opt_fields), "hyperparams": json.dumps(self._hyper_numbers())})
        self._write_state(out_dir, self.extra)
        return sum((out_dir / f).stat().st_size for f in (PARAMS_FILE, OPT_STATE_FILE, STATE_FILE))


# ---------------------------------------------------------------------------
# the sharded layout: each rank its own ranges
# ---------------------------------------------------------------------------


def _opt_leaves(opt_state, names: list) -> list:
    """The leaf each tensor of ``flatten_opt_state(opt_state)`` belongs to
    (a per-parameter list field), or None (a tensor of its own)."""
    out: list = []
    for value in opt_state:
        if isinstance(value, torch.Tensor):
            out.append(None)
        elif isinstance(value, (list, tuple)):
            out.extend(names if len(value) == len(names) else [None] * len(value))
    return out


def _whole_runs(n: int):
    return np.asarray([[0, 0, n]] if n else [], dtype=np.int64).reshape(-1, 3)


def _block_count(numel: int, block: int) -> int:
    """Per-block tensor length of a run of ``numel`` elements (one block
    spanning a leaf smaller than ``block``, ``ops.int8_state``'s rule)."""
    return -(-numel // max(1, min(block, numel))) if numel else 0


def _layout(train_state, plan) -> dict:
    """Every tensor of the train state's params and optimizer state, as
    this rank holds it: ``{key: (local tensor, runs, global length,
    leaf)}`` with keys ``p/<name>`` and ``o/<flatten index>``.  ``runs``
    place the local flatten in the whole tensor's (``parallel/sharding``'s
    runs); a per-block tensor (-sr8 scales) runs over blocks of
    ``plan.align`` elements.  Without a plan every tensor is whole."""
    from .optimizer import flatten_opt_state

    out = {}
    for name, p in train_state.params.items():
        if plan is None:
            out[f"p/{name}"] = (p, _whole_runs(p.numel()), p.numel(), name)
        else:
            lay = plan.layouts[name]
            out[f"p/{name}"] = (p, plan.param_runs(name), lay.whole_numel, name)
    tensors, _ = flatten_opt_state(train_state.opt_state)
    for i, (t, leaf) in enumerate(zip(tensors, _opt_leaves(train_state.opt_state,
                                                           list(train_state.params)))):
        if plan is None or leaf is None:
            out[f"o/{i}"] = (t, _whole_runs(t.numel()), t.numel(), leaf)
            continue
        lay = plan.layouts[leaf]
        span = lay.chunk if lay.sharded else lay.numel
        if t.numel() == span:
            out[f"o/{i}"] = (t, plan.opt_runs(leaf), lay.whole_numel, leaf)
        elif t.numel() == _block_count(span, plan.align):
            out[f"o/{i}"] = (t, plan.opt_runs(leaf, plan.align),
                             _block_count(lay.whole_numel, plan.align), leaf)
        else:
            raise ValueError(f"optimizer tensor {i} of {leaf}: {t.numel()} elements, neither "
                             f"its range's {span} nor its {plan.align}-element blocks'")
    return out


def _plan_rank(plan) -> tuple[int, int, dict]:
    """``(rank, world, {axis: size})`` of this rank in the plan's mesh (the
    process in a gang, the thread in a virtual world)."""
    from .parallel import collectives

    sizes = collectives.mesh_sizes(plan.mesh)
    names = tuple(a for a in sizes)
    return collectives.axis_index(names, plan.mesh), int(np.prod(list(sizes.values()))), sizes


def _writes(plan, key: str, leaf: Optional[str], first: bool) -> bool:
    if leaf is None:
        return first
    return plan.writes(leaf, opt=key.startswith("o/"))


class _ShardSnapshot(_TrainStateSnapshot):
    """One rank's part of a sharded train state copied to the host: the
    ranges of params and optimizer state it writes (the first of the ranks
    holding them), its own extras (the carried accumulator), and on the
    first rank the index and the replicated extras."""

    def __init__(self, train_state, plan, buffers: list, comm: Optional[dict] = None):
        from .optimizer import flatten_opt_state

        self.rank, self.world, sizes = _plan_rank(plan)
        first = self.rank == 0
        layout = _layout(train_state, plan)
        own = {k: v for k, v in layout.items() if _writes(plan, k, v[3], first)}
        opt_tensors, opt_meta = flatten_opt_state(train_state.opt_state)
        hyper = opt_meta["hyperparams"]
        hyper_tensors = {k: v for k, v in hyper.items() if isinstance(v, torch.Tensor)}
        extra = _extras(train_state, comm)
        local = {k: v for k, v in extra.items() if k.startswith("grad_accum.")}
        shared = {k: v for k, v in extra.items() if k not in local} if first else {}
        live = ([t for t, *_ in own.values()] + list(hyper_tensors.values())
                + list(local.values()) + list(shared.values()))
        host = _snapshot(live, buffers)
        self.event = _record_event(live)
        n_o, n_h, n_l = len(own), len(hyper_tensors), len(local)
        self.pieces = {k: (h.reshape(-1), runs) for (k, (_, runs, _, _)), h
                       in zip(own.items(), host[:n_o])}
        self.hyper = dict(hyper)
        self.hyper.update(zip(hyper_tensors, host[n_o:n_o + n_h]))
        self.local = dict(zip(local, host[n_o + n_h:n_o + n_h + n_l]))
        self.extra = dict(zip(shared, host[n_o + n_h + n_l:]))
        self.opt_type, self.opt_fields = opt_meta["type"], opt_meta["fields"]
        self.step = int(train_state.step)
        self.accum_step = int(train_state.accum_step)
        self.rng = train_state.rng.get_state() if train_state.rng is not None else None
        self.index = {
            "format": SHARDED_FORMAT, "world": self.world, "mesh": sizes, "align": plan.align,
            "params": {n: {"shape": list(plan.layouts[n].whole_shape),
                           "dtype": _DTYPE_NAME[p.dtype]}
                       for n, p in train_state.params.items()},
            "opt_tensors": [{"leaf": leaf, "length": length, "dtype": _DTYPE_NAME[t.dtype]}
                            for k, (t, _, length, leaf) in layout.items() if k.startswith("o/")],
            "shards": [SHARD_FILE.format(r) for r in range(self.world)],
        } if first else None
        self.payload_bytes = sum(int(runs[:, 2].sum()) * h.element_size()
                                 for h, runs in self.pieces.values())

    def write(self, out_dir: Path) -> int:
        """Wait for the host copies, then write this rank's shard file (and
        on the first rank the index and the state file); returns the bytes
        written."""
        from .parallel.sharding import pack_runs

        if self.event is not None:
            self.event.synchronize()
        out_dir.mkdir(parents=True, exist_ok=True)
        tensors, runs_meta = {}, {}
        for key, (flat, runs) in self.pieces.items():
            parts = [flat[l:l + n] for _, l, n in runs.tolist()]
            if not parts:
                # a range of padding only (a leaf smaller than the ranks'
                # ranges): nothing of it lives here
                continue
            tensors[key] = parts[0] if len(parts) == 1 else torch.cat(parts)
            runs_meta[key] = pack_runs(runs)
        tensors.update({f"x/{k}": v for k, v in self.local.items()})
        shard = out_dir / SHARD_FILE.format(self.rank)
        save_safetensors(shard, tensors, metadata={"format": SHARDED_FORMAT, "rank": self.rank,
                                                   "runs": json.dumps(runs_meta)})
        written = shard.stat().st_size
        if self.index is not None:
            index = dict(self.index, opt={"type": self.opt_type, "fields": self.opt_fields,
                                          "hyperparams": self._hyper_numbers()})
            (out_dir / INDEX_FILE).write_text(json.dumps(index))
            self._write_state(out_dir, self.extra)
            written += sum((out_dir / f).stat().st_size for f in (INDEX_FILE, STATE_FILE))
        return written


def save_train_state(out_dir, train_state, plan=None, buffers: Optional[list] = None,
                     comm: Optional[dict] = None) -> int:
    """Write ``train_state`` under ``out_dir`` (a ``train_state/``
    directory) and return the bytes this rank wrote: the three whole-leaf
    files without a plan, else this rank's shard of the sharded layout
    (every rank of the plan's mesh calls this, in a gang or in a virtual
    world's threads).  The checkpoint's manifest and publish are the
    caller's."""
    snap = (_TrainStateSnapshot(train_state, buffers if buffers is not None else [], comm)
            if plan is None else
            _ShardSnapshot(train_state, plan, buffers if buffers is not None else [], comm))
    return snap.write(Path(out_dir))


# ---------------------------------------------------------------------------
# reading a train state onto any template
# ---------------------------------------------------------------------------


class _Source:
    """A saved train state's tensors, each a list of pieces ``(file,
    payload offset of its bytes, runs)`` over the whole tensor, with the
    state's global description: the whole-leaf format (one piece a
    tensor) or the sharded one (the index and every shard's runs)."""

    def __init__(self, in_dir: Path):
        from .parallel.sharding import unpack_runs
        from .utils.serialization import read_safetensors_header

        self.dir = in_dir
        self.pieces: dict = {}
        # params: name -> (dtype name, whole shape); opt: per tensor (dtype
        # name, whole length)
        index_file = in_dir / INDEX_FILE
        self.sharded = index_file.exists()
        if self.sharded:
            index = json.loads(index_file.read_text())
            if index.get("format") != SHARDED_FORMAT:
                raise ValueError(f"{index_file}: format {index.get('format')!r}")
            self.world = int(index["world"])
            self.opt_meta = index["opt"]
            self.params = {n: (d["dtype"], tuple(d["shape"])) for n, d in index["params"].items()}
            self.opt = [(d["dtype"], int(d["length"])) for d in index["opt_tensors"]]
            self.shard_files = [in_dir / f for f in index["shards"]]
            for path in self.shard_files:
                header, base = read_safetensors_header(path)
                runs = json.loads(header.get("__metadata__", {}).get("runs", "{}"))
                for key, packed in runs.items():
                    self.pieces.setdefault(key, []).append(
                        (path, base + header[key]["data_offsets"][0], unpack_runs(packed)))
        else:
            self.world = 1
            meta = safetensors_metadata(in_dir / OPT_STATE_FILE)
            self.opt_meta = {"type": meta.get("type"), "fields": json.loads(meta["fields"]),
                             "hyperparams": json.loads(meta["hyperparams"])}
            self.params, opt = {}, {}
            for fname, prefix in ((PARAMS_FILE, "p/"), (OPT_STATE_FILE, "o/")):
                header, base = read_safetensors_header(in_dir / fname)
                for key, info in header.items():
                    if key == "__metadata__":
                        continue
                    n = int(np.prod(info["shape"]))
                    self.pieces[prefix + key] = [(in_dir / fname,
                                                  base + info["data_offsets"][0], _whole_runs(n))]
                    if prefix == "p/":
                        self.params[key] = (info["dtype"], tuple(info["shape"]))
                    else:
                        opt[int(key)] = (info["dtype"], n)
            self.opt = [opt[i] for i in range(len(opt))]

    def fill(self, key: str, dst: torch.Tensor, runs) -> None:
        """Read the elements ``runs`` name (global start, local start,
        length) of tensor ``key`` into the host tensor ``dst`` (its flatten):
        each overlap of a saved piece with a wanted run is one read at its
        file offset.  Raises unless every wanted element was saved."""
        flat = dst.reshape(-1)
        view = flat.view(torch.uint8).numpy()
        size = flat.element_size()
        want = sorted(runs.tolist())
        need = sum(n for _, _, n in want)
        got = 0
        per_file: dict = {}
        for path, base, src in self.pieces.get(key, []):
            src = sorted(src.tolist())
            i = j = 0
            while i < len(src) and j < len(want):
                sg, sl, sn = src[i]
                wg, wl, wn = want[j]
                lo, hi = max(sg, wg), min(sg + sn, wg + wn)
                if lo < hi:
                    d = (wl + lo - wg) * size
                    per_file.setdefault(path, []).append(
                        (base + (sl + lo - sg) * size, view[d:d + (hi - lo) * size]))
                    got += hi - lo
                if sg + sn <= wg + wn:
                    i += 1
                else:
                    j += 1
        if got != need:
            raise ValueError(f"checkpoint {self.dir}: {key} holds {got} of the {need} elements "
                             "this rank needs")
        for path, segments in per_file.items():
            native.read_file_segments(path, segments)


def _host_like(t: torch.Tensor, pin: bool, init: bool) -> torch.Tensor:
    """A contiguous host tensor of ``t``'s shape and dtype: zeros, or (with
    ``init``) a copy of ``t`` (padding lanes keep the template's values)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    if init:
        out.copy_(t)
    else:
        out.zero_()
    return out


def _read_train_state(in_dir: Path, template, rank: int = 0, world: int = 1, plan=None):
    """The train state of ``in_dir`` over ``template`` (a train state from
    ``create_train_state`` with the same structure), in either layout and
    onto any plan (``plan``: the template's ``DataParallelPlan``, None for
    one process without one): each rank reads only the elements its
    tensors hold, at their file offsets.  The params are copied into the
    template's own tensors (a module, or the stored shards, train in
    place); the rest comes back as new tensors on the template's devices;
    padding lanes keep the template's values.  Process ``rank`` of
    ``world`` takes its own row of the codec residuals, and its own
    carried accumulator from a sharded checkpoint of the same world."""
    from .optimizer import flatten_opt_state, unflatten_opt_state

    pin = torch.cuda.is_available()
    src = _Source(in_dir)
    whole = {n: (plan.layouts[n].whole_shape if plan is not None else tuple(p.shape))
             for n, p in template.params.items()}
    if set(src.params) != set(template.params):
        raise ValueError(f"checkpoint params {sorted(set(src.params) ^ set(template.params))} "
                         "do not match the template's")
    for name, p in template.params.items():
        dtype, shape = src.params[name]
        if dtype != _DTYPE_NAME[p.dtype] or int(np.prod(shape)) != int(np.prod(whole[name])):
            raise ValueError(f"checkpoint {name}: {dtype} {shape} does not match the "
                             f"template's {p.dtype} {whole[name]}")
    if src.opt_meta.get("type") != type(template.opt_state).__name__:
        raise ValueError(f"checkpoint optimizer state {src.opt_meta.get('type')} does not match "
                         f"the template's {type(template.opt_state).__name__}")
    layout = _layout(template, plan)
    n_opt = len(flatten_opt_state(template.opt_state)[0])
    if len(src.opt) != n_opt:
        raise ValueError(f"optimizer state has {len(src.opt)} tensors, the template {n_opt}")
    for i in range(n_opt):
        t, _, length, _ = layout[f"o/{i}"]
        if src.opt[i] != (_DTYPE_NAME[t.dtype], length):
            raise ValueError(f"optimizer state tensor {i}: {src.opt[i]} does not match the "
                             f"template's {(_DTYPE_NAME[t.dtype], length)}")
    staged = {}
    for key, (t, runs, _, _) in layout.items():
        staged[key] = _host_like(t, pin, init=key.startswith("o/"))
        src.fill(key, staged[key], runs)
    opt_state = unflatten_opt_state(template.opt_state,
                                    [staged[f"o/{i}"] for i in range(n_opt)],
                                    src.opt_meta["fields"], src.opt_meta["hyperparams"])
    extra = load_safetensors(in_dir / STATE_FILE)
    if src.sharded and template.grad_accum is not None:
        if src.world != world:
            raise ValueError(f"checkpoint {in_dir} carries the accumulators of {src.world} "
                             f"ranks, this world has {world}")
        extra.update({k[2:]: v for k, v in load_safetensors(src.shard_files[rank]).items()
                      if k.startswith("x/")})
    guard = template.guard_state
    if guard is not None:
        guard = {k: _restore_leaf(v, extra[f"guard_state.{k}"], f"guard_state.{k}")
                 .to(v.device) for k, v in guard.items()}
    accum = template.grad_accum
    if accum is not None:
        accum = [_restore_leaf(g, extra[f"grad_accum.{i}"], f"grad_accum.{i}").to(g.device)
                 for i, g in enumerate(accum)]
    loss_scale = template.loss_scale
    if loss_scale is not None:
        loss_scale = type(loss_scale)(
            _restore_leaf(loss_scale.scale, extra["loss_scale.scale"], "loss_scale.scale")
            .to(loss_scale.scale.device),
            loss_scale.growth_factor, loss_scale.backoff_factor, loss_scale.growth_interval,
            _restore_leaf(loss_scale.counter, extra["loss_scale.counter"], "loss_scale.counter")
            .to(loss_scale.counter.device))
    fp8_state = template.fp8_state
    if fp8_state is not None:
        fp8_state = {name: type(meta)(
            _restore_leaf(meta.amax_history, extra[f"fp8_state.{name}.amax_history"],
                          f"fp8_state.{name}.amax_history").to(meta.amax_history.device),
            _restore_leaf(meta.scale, extra[f"fp8_state.{name}.scale"],
                          f"fp8_state.{name}.scale").to(meta.scale.device))
            for name, meta in fp8_state.items()}
    comm_state = template.comm_state
    if comm_state is not None:
        def row(kind, n, t):
            key = f"comm_state.{kind}.{n}"
            if extra[key].shape[0] != world:
                raise ValueError(f"checkpoint {key} holds {extra[key].shape[0]} ranks' rows, "
                                 f"this world has {world}")
            return _restore_leaf(t, extra[key][rank], key).to(t.device)

        comm_state = tuple({n: row(kind, n, t) if t is not None else None
                            for n, t in tree.items()}
                           for kind, tree in zip("qe", comm_state))
    # every check passed: only now overwrite the template's params in place
    with torch.no_grad():
        for name, p in template.params.items():
            p.copy_(staged[f"p/{name}"].reshape(p.shape), non_blocking=True)
    if template.rng is not None and "rng" in extra:
        template.rng.set_state(extra["rng"])
    return template.replace(step=int(extra["step"]), params=template.params,
                            opt_state=opt_state, guard_state=guard, grad_accum=accum,
                            accum_step=int(extra["accum_step"]), loss_scale=loss_scale,
                            fp8_state=fp8_state, comm_state=comm_state)


def load_train_state(in_dir, template, plan=None):
    """:func:`save_train_state`'s inverse onto ``template`` under ``plan``
    (any plan, or None for one process): each rank of the plan's mesh
    calls this, in a gang or in a virtual world's threads."""
    rank, world = (_plan_rank(plan)[:2] if plan is not None else (0, 1))
    return _read_train_state(Path(in_dir), template, rank, world, plan)


def gathered_state(train_state, plan=None) -> dict:
    """This rank's holding of every param and optimizer tensor, as
    ``{key: (host flatten, runs, whole length)}`` (see :func:`_layout`):
    the pieces that :func:`assemble_state` puts together into whole
    tensors, padding left out."""
    return {k: (t.detach().reshape(-1).to("cpu", copy=True), runs, length)
            for k, (t, runs, length, _) in _layout(train_state, plan).items()}


def assemble_state(holdings: list) -> dict:
    """Whole tensors from every rank's :func:`gathered_state`: ``{key:
    1-D tensor}``; raises where the ranks leave an element unheld."""
    out: dict = {}
    seen: dict = {}
    for holding in holdings:
        for key, (flat, runs, length) in holding.items():
            if key not in out:
                out[key] = torch.zeros(length, dtype=flat.dtype)
                seen[key] = np.zeros(length, dtype=bool)
            for g, l, n in runs.tolist():
                out[key][g:g + n] = flat[l:l + n]
                seen[key][g:g + n] = True
    missing = [k for k, s in seen.items() if not s.all()]
    if missing:
        raise ValueError(f"no rank holds every element of {missing[:4]}")
    return out


# ---------------------------------------------------------------------------
# save / load accelerator state
# ---------------------------------------------------------------------------


def save_accelerator_state(accelerator, output_dir: Optional[str] = None, train_state=None,
                           safe_serialization: bool = True, async_save: bool = False) -> str:
    """Checkpoint the accelerator's state (and ``train_state``) into
    ``output_dir`` or the next automatic directory; returns the published
    directory.  With ``async_save`` the train state's files are written on
    the background thread after its host snapshot, and the directory is
    published when that write has committed."""
    # a previous async save must be on disk before retention GC may delete
    # directories and before a second writer starts
    wait_for_pending_checkpoint(accelerator)
    t0 = time.perf_counter()
    world = accelerator.num_processes
    main = accelerator.is_main_process
    if world > 1:
        # one directory for the gang: rank 0 names it (retention GC and the
        # stale sweep included) and the others take its name
        from .ops.operations import broadcast_object_list

        name = broadcast_object_list(
            [str(_auto_checkpoint_dir(accelerator, output_dir)) if main else None])[0]
        final_dir = Path(name).absolute()
        pc = accelerator.project_configuration
        if not main and output_dir is None and pc.automatic_checkpoint_naming:
            pc.iteration = int(final_dir.name.split("_")[1]) + 1
    else:
        final_dir = Path(_auto_checkpoint_dir(accelerator, output_dir)).absolute()
    # the save's timings: host seconds blocked in this call, the train
    # state's bytes and write seconds, the manifest's seconds (crc32 of
    # every file) and the publish time
    record = accelerator.checkpoint_log[str(final_dir)] = {"async": async_save, "started_at": t0}
    verify, io_policy = _resilience_knobs(accelerator)
    staging = final_dir.parent / (final_dir.name + CHECKPOINT_TMP_SUFFIX)
    if main:
        if staging.exists():
            shutil.rmtree(staging)  # a crashed writer's staging dir: never a checkpoint
        staging.mkdir(parents=True, exist_ok=True)
    accelerator.wait_for_everyone()

    # pre-hooks get the staging dir, so their files ride the manifest
    for hook in accelerator._save_model_state_pre_hooks.values():
        hook(accelerator._models, [], str(staging))

    pending = None
    error = None
    comm = _comm_tensors(train_state, world) if train_state is not None else {}
    # across processes under a plan every rank writes its own ranges; else
    # rank 0 writes the whole leaves
    plan = getattr(accelerator, "_dp_plan", None) if world > 1 else None
    if train_state is not None and (main or plan is not None):
        snap = (_ShardSnapshot(train_state, plan, accelerator._checkpoint_buffers, comm)
                if plan is not None else
                _TrainStateSnapshot(train_state, accelerator._checkpoint_buffers, comm))

        def write():
            t_write = time.perf_counter()
            record["bytes"] = _io_retry(accelerator,
                                        lambda: snap.write(staging / TRAIN_STATE_DIR),
                                        site=f"checkpoint-save {final_dir.name}",
                                        policy=io_policy)
            record["written_at"] = time.perf_counter()
            record["write_s"] = record["written_at"] - t_write

        if async_save:
            ckptr = accelerator._async_checkpointer
            if ckptr is None:
                ckptr = accelerator._async_checkpointer = _AsyncCheckpointer()
            _LIVE_ASYNC_CKPTRS.add(ckptr)
            _register_exit_flush()
            ckptr.save(write)
            pending = ckptr
        elif world > 1:
            # a rank whose write fails still joins the publish's agreement
            try:
                write()
            except Exception as e:
                error = e
        else:
            write()

    with open(staging / RNG_STATE_NAME.format(accelerator.process_index), "wb") as f:
        pickle.dump(_collect_rng_state(), f)
    if main:
        sampler_states = [dl.state_dict() for dl in accelerator._dataloaders
                          if hasattr(dl, "state_dict")]
        (staging / SAMPLER_STATES_NAME).write_text(json.dumps(sampler_states))
        (staging / SCHEDULER_STATES_NAME).write_text(
            json.dumps([s.state_dict() for s in accelerator._schedulers]))
        meta = {
            "step_count": accelerator.step_count,
            "num_processes": accelerator.num_processes,
            "mixed_precision": accelerator.mixed_precision,
            # goodput counters ride the metadata, so goodput_frac spans restarts
            "goodput": accelerator.goodput.state_dict(),
        }
        (staging / METADATA_NAME).write_text(json.dumps(meta))
        for i, obj in enumerate(accelerator._custom_objects):
            with open(staging / CUSTOM_STATES_NAME.format(i), "wb") as f:
                pickle.dump(obj.state_dict(), f)

    if world > 1 and async_save:
        # the publish is collective: at the next save or load,
        # wait_for_checkpoint or end_training, every rank together; never
        # from one rank's interpreter-exit flush
        accelerator._pending_checkpointer = pending
        accelerator._pending_publish = (staging, final_dir, verify, record)
    elif pending is not None:
        _PENDING_FINALIZES[pending] = (staging, final_dir, verify, record)
        accelerator._pending_checkpointer = pending
    elif world > 1:
        _publish_across(accelerator, error, staging, final_dir, verify, record)
    else:
        _finalize_checkpoint(staging, final_dir, manifest=verify, record=record)
    record["blocking_s"] = time.perf_counter() - t0
    return str(final_dir)


def load_accelerator_state(accelerator, input_dir: Optional[str] = None, train_state=None,
                           load_sampler_states: bool = True):
    """Restore from a checkpoint directory; ``train_state`` is a template
    (a fresh ``create_train_state`` of the same structure) and the restored
    train state is returned (None without a template).

    Every candidate is verified against its manifest first.  With
    ``input_dir=None`` the scan walks the checkpoints newest to oldest and
    restores the newest that verifies *and* restores, warning about each it
    passes over; a named ``input_dir`` that fails verification raises
    :class:`CheckpointCorruptError`."""
    wait_for_pending_checkpoint(accelerator)
    verify_enabled, _ = _resilience_knobs(accelerator)
    if input_dir is not None:
        candidates = [Path(input_dir).absolute()]
        if not candidates[0].is_dir():
            raise FileNotFoundError(f"checkpoint dir {candidates[0]} does not exist")
        explicit = True
    else:
        ckpts = list_checkpoints(accelerator.project_dir or ".")
        if not ckpts:
            raise FileNotFoundError("no checkpoints found")
        candidates = [Path(c) for c in reversed(ckpts)]
        explicit = False

    failures: list[str] = []
    for i, cand in enumerate(candidates):
        if verify_enabled:
            ok, problems = verify_checkpoint(cand)
            if not ok:
                msg = f"checkpoint {cand} failed verification: {problems}"
                if explicit:
                    raise CheckpointCorruptError(msg)
                logger.warning("%s — falling back to the previous checkpoint", msg)
                failures.append(msg)
                continue
            for note in problems:  # valid-but-unverified notes
                logger.warning("checkpoint %s: %s", cand, note)
        try:
            restored = _load_checkpoint_dir(accelerator, cand, train_state=train_state,
                                            load_sampler_states=load_sampler_states)
            accelerator.last_restored_checkpoint = str(cand)
            return restored
        except Exception as e:
            # verified but unrestorable (a template that does not match, a
            # torn directory with no manifest): a named dir raises, the scan
            # walks on to the previous candidate
            if explicit or i == len(candidates) - 1:
                raise
            msg = f"checkpoint {cand} failed to restore: {type(e).__name__}: {e}"
            logger.warning("%s — falling back to the previous checkpoint", msg)
            failures.append(msg)
    raise CheckpointCorruptError(
        f"no valid checkpoint found among {[str(c) for c in candidates]}: {failures}")


def _load_checkpoint_dir(accelerator, input_dir: Path, train_state=None,
                         load_sampler_states: bool = True):
    for hook in accelerator._load_model_state_pre_hooks.values():
        hook(accelerator._models, [], str(input_dir))

    restored_state = None
    if train_state is not None:
        plan = getattr(accelerator, "_dp_plan", None)
        restored_state = _io_retry(
            accelerator, lambda: _read_train_state(input_dir / TRAIN_STATE_DIR, train_state,
                                                   accelerator.process_index,
                                                   accelerator.num_processes, plan),
            site=f"checkpoint-restore {input_dir.name}")

    rng_file = input_dir / RNG_STATE_NAME.format(accelerator.process_index)
    if not rng_file.exists():
        rng_file = input_dir / RNG_STATE_NAME.format(0)
    if rng_file.exists():
        with open(rng_file, "rb") as f:
            # a file this program wrote, checked against the manifest above
            _restore_rng_state(pickle.load(f))
    if load_sampler_states and (input_dir / SAMPLER_STATES_NAME).exists():
        sampler_states = json.loads((input_dir / SAMPLER_STATES_NAME).read_text())
        for dl, sd in zip(accelerator._dataloaders, sampler_states):
            if hasattr(dl, "load_state_dict"):
                dl.load_state_dict(sd)
    if (input_dir / SCHEDULER_STATES_NAME).exists():
        sched_states = json.loads((input_dir / SCHEDULER_STATES_NAME).read_text())
        for sched, sd in zip(accelerator._schedulers, sched_states):
            sched.load_state_dict(sd)
    if (input_dir / METADATA_NAME).exists():
        meta = json.loads((input_dir / METADATA_NAME).read_text())
        accelerator.step_count = meta.get("step_count", 0)
        if "goodput" in meta:
            accelerator.goodput.load_state_dict(meta["goodput"])
    for i, obj in enumerate(accelerator._custom_objects):
        f = input_dir / CUSTOM_STATES_NAME.format(i)
        if f.exists():
            with open(f, "rb") as fh:
                obj.load_state_dict(pickle.load(fh))
    return restored_state


# ---------------------------------------------------------------------------
# consolidated model export
# ---------------------------------------------------------------------------


def parse_size(size: str) -> int:
    m = re.fullmatch(r"(\d+)\s*([KMG]?B)", size.strip(), re.IGNORECASE)
    if not m:
        raise ValueError(f"cannot parse size {size!r}")
    mult = {"B": 1, "KB": 2**10, "MB": 2**20, "GB": 2**30}[m.group(2).upper()]
    return int(m.group(1)) * mult


def _named_params(train_state_or_params) -> dict:
    params = getattr(train_state_or_params, "params", train_state_or_params)
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return params


def save_model(accelerator, train_state_or_params, save_directory: str,
               max_shard_size: str = "10GB", safe_serialization: bool = True) -> list[str]:
    """Write the params (a train state's, a module's or a name -> tensor
    dict) as safetensors, sharded by ``max_shard_size`` with an index —
    under the JAX package's flattened flax names (``params.layers_0.
    self_attn.q_proj.kernel``, kernels ``[in, out]``), so the files are the
    JAX package's ``save_model`` files for the same weights, byte for byte.
    ``accelerator`` may be None; a train state sharded by its plan is
    gathered into whole leaves first (every rank calls this together)."""
    from .models.convert import flax_flat_from_torch

    params = _named_params(train_state_or_params)
    if accelerator is not None and getattr(accelerator, "_dp_plan", None) is not None:
        params = accelerator.device_params(params)
    flat = flax_flat_from_torch(params)
    save_dir = Path(save_directory)
    save_dir.mkdir(parents=True, exist_ok=True)
    limit = parse_size(max_shard_size)
    shards: list[dict] = [{}]
    sizes = [0]
    for k, v in flat.items():
        nbytes = v.numel() * v.element_size()
        if sizes[-1] + nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][k] = v
        sizes[-1] += nbytes

    written = []
    if safe_serialization:
        if len(shards) == 1:
            path = save_dir / SAFE_WEIGHTS_NAME
            save_safetensors(path, shards[0])
            written.append(str(path))
        else:
            index = {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
            for i, shard in enumerate(shards):
                name = SAFE_WEIGHTS_SHARD_PATTERN.format(i + 1, len(shards))
                save_safetensors(save_dir / name, shard)
                for k in shard:
                    index["weight_map"][k] = name
                written.append(str(save_dir / name))
            (save_dir / SAFE_WEIGHTS_INDEX_NAME).write_text(json.dumps(index, indent=2))
    else:
        path = save_dir / "model.npz"
        np.savez(path, **{k: v.numpy() for k, v in flat.items()})
        written.append(str(path))
    return written


def load_model_params(save_directory: str) -> dict:
    """The inverse of :func:`save_model` (and a reader of the JAX package's
    ``save_model`` directories): the port's ``state_dict`` — HF names,
    ``[out, in]`` layout, each tensor on the CPU in its stored dtype."""
    from .models.convert import torch_state_from_flax_flat

    save_dir = Path(save_directory)
    flat: dict = {}
    index_file = save_dir / SAFE_WEIGHTS_INDEX_NAME
    if index_file.exists():
        index = json.loads(index_file.read_text())
        for name in sorted(set(index["weight_map"].values())):
            flat.update(load_safetensors(save_dir / name))
    elif (save_dir / SAFE_WEIGHTS_NAME).exists():
        flat = load_safetensors(save_dir / SAFE_WEIGHTS_NAME)
    elif (save_dir / "model.npz").exists():
        flat = {k: torch.from_numpy(v) for k, v in np.load(save_dir / "model.npz").items()}
    else:
        raise FileNotFoundError(f"no model file found under {save_dir}")
    return torch_state_from_flax_flat(flat)


def merge_weights(checkpoint_dir: str, output_dir: str, safe_serialization: bool = True) -> str:
    """Consolidate a train-state checkpoint's params into one
    ``model.safetensors`` in :func:`save_model`'s layout: the whole-leaf
    file as it is, or a sharded checkpoint's ranges read into whole leaves
    through its index."""
    from .utils.serialization import _STR_TO_DTYPE

    src = _Source(Path(checkpoint_dir).absolute() / TRAIN_STATE_DIR)
    params = {}
    for name, (dtype, shape) in src.params.items():
        whole = torch.empty(shape, dtype=_STR_TO_DTYPE[dtype])
        src.fill(f"p/{name}", whole, _whole_runs(whole.numel()))
        params[name] = whole
    return save_model(None, params, output_dir, max_shard_size=f"{2**40}B",
                      safe_serialization=safe_serialization)[0]
