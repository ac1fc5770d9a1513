"""Experiment trackers (mirrors ``accelerate_tpu/tracking.py``).

The same ``GeneralTracker`` contract (``name``,
``requires_logging_directory``, ``store_init_configuration``, ``log``,
``finish``), run on the main process only, and the same backends where
their library is installed (TensorBoard, W&B, CometML, MLflow, Aim,
ClearML, DVCLive, SwanLab, Trackio), each probed by
``utils/imports.py``.  :class:`JSONLTracker` needs no package and is always
available: one JSON object per line, each written whole.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import time
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Optional, Union

from .logging import get_logger
from .state import world
from .utils import imports
from .utils.dataclasses import LoggerType  # noqa: F401  (the names trackers go by)

logger = get_logger(__name__)


def _flatten(d: dict, sep: str = ".", _prefix: str = "") -> dict:
    """``{"opt": {"lr": 0.1}} -> {"opt.lr": 0.1}`` to arbitrary depth — the
    shape hparam/metric backends want."""
    out = {}
    for k, v in d.items():
        key = f"{_prefix}{sep}{k}" if _prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, sep, key))
        else:
            out[key] = v
    return out


def on_main_process(function):
    """Run only on the main process (rank 0 of the process group, or the
    one process) when the tracker asks for it."""

    @functools.wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if getattr(self, "main_process_only", False) and world()[1] != 0:
            return None
        return function(self, *args, **kwargs)

    return execute_on_main_process


class GeneralTracker(ABC):
    """The tracker contract (JAX ``GeneralTracker``)."""

    main_process_only = True

    def __init__(self, _blank: bool = False):
        if not _blank:
            err = []
            for attr in ("name", "requires_logging_directory"):
                if not hasattr(self, attr):
                    err.append(attr)
            if err:
                raise NotImplementedError(f"Tracker must implement: {err}")

    @abstractmethod
    def store_init_configuration(self, values: dict): ...

    @abstractmethod
    def log(self, values: dict, step: Optional[int] = None, **kwargs): ...

    def finish(self):
        pass

    @property
    def tracker(self):
        return getattr(self, "_tracker", None)


class JSONLTracker(GeneralTracker):
    """Metrics log with no dependency: one JSON object per line.  Each
    record is serialised whole, then handed to the OS as one unbuffered
    ``write`` on an append handle (closed at exit), so a killed run's file
    holds only complete lines.  It is also the telemetry sink that is
    always there: ``Accelerator.log(twin_registry().flat_metrics())``."""

    name = "jsonl"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Union[str, os.PathLike] = "."):
        super().__init__()
        self.run_name = run_name
        self.dir = Path(logging_dir or ".") / run_name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "metrics.jsonl"
        # buffering=0: one os-level write per log line (whole-line or
        # nothing under any kill signal for sane line sizes)
        self._fh = open(self.path, "ab", buffering=0)
        atexit.register(self._close)
        self._tracker = self

    def _close(self):
        # drop the atexit entry too: it holds a strong reference to this
        # tracker, and a long-lived service creating per-run trackers must
        # not accumulate dead ones until process exit
        atexit.unregister(self._close)
        fh, self._fh = getattr(self, "_fh", None), None
        if fh is not None and not fh.closed:
            try:
                fh.flush()
                os.fsync(fh.fileno())
            except OSError:
                pass  # close() below still runs; the write already hit the kernel
            fh.close()

    @on_main_process
    def store_init_configuration(self, values: dict):
        (self.dir / "config.json").write_text(json.dumps(values, default=str, indent=2))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        record = {"_step": step, "_time": time.time(), **values}
        line = (json.dumps(record, default=float) + "\n").encode()
        if self._fh is None or self._fh.closed:  # post-finish stragglers
            with open(self.path, "ab", buffering=0) as f:
                f.write(line)
            return
        self._fh.write(line)

    @on_main_process
    def finish(self):
        self._close()


class TensorBoardTracker(GeneralTracker):

    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Union[str, os.PathLike] = ".", **kwargs):
        super().__init__()
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir or ".", run_name)
        self._tracker = tensorboard.SummaryWriter(self.logging_dir, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._tracker.add_hparams(_flatten(values), metric_dict={})
        self._tracker.flush()

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in _flatten(values).items():
            if isinstance(v, (int, float)):
                self._tracker.add_scalar(k, v, global_step=step, **kwargs)
            elif isinstance(v, str):
                self._tracker.add_text(k, v, global_step=step, **kwargs)
        self._tracker.flush()

    @on_main_process
    def finish(self):
        self._tracker.close()


class WandBTracker(GeneralTracker):

    name = "wandb"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import wandb

        self.run_name = run_name
        self._tracker = wandb.init(project=run_name, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self._tracker.log(values, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self._tracker.finish()


class MLflowTracker(GeneralTracker):

    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__()
        import mlflow

        self.run_name = run_name
        mlflow.set_experiment(run_name)
        self._tracker = mlflow.start_run(**kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        for k, v in _flatten(values).items():
            mlflow.log_param(k, v)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import mlflow

        mlflow.log_metrics({k: v for k, v in _flatten(values).items() if isinstance(v, (int, float))}, step=step)

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


class CometMLTracker(GeneralTracker):
    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        from comet_ml import Experiment

        self.run_name = run_name
        self._tracker = Experiment(project_name=run_name, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._tracker.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self._tracker.set_step(step)
        self._tracker.log_metrics(_flatten(values), step=step)

    @on_main_process
    def finish(self):
        self._tracker.end()


class AimTracker(GeneralTracker):
    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Optional[str] = ".", **kwargs):
        super().__init__()
        from aim import Run

        self._tracker = Run(repo=logging_dir, experiment=run_name, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._tracker["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            self._tracker.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self._tracker.close()


class ClearMLTracker(GeneralTracker):
    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        from clearml import Task

        self._tracker = Task.init(project_name=run_name, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._tracker.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        clearml_logger = self._tracker.get_logger()
        for k, v in _flatten(values).items():
            if isinstance(v, (int, float)):
                title, _, series = k.partition("/")
                clearml_logger.report_scalar(title=title, series=series or title, value=v, iteration=step or 0)

    @on_main_process
    def finish(self):
        self._tracker.close()


class DVCLiveTracker(GeneralTracker):
    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: Optional[str] = None, live=None, **kwargs):
        super().__init__()
        from dvclive import Live

        self._tracker = live if live is not None else Live(**kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._tracker.log_params(_flatten(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self._tracker.step = step
        for k, v in _flatten(values).items():
            self._tracker.log_metric(k, v, **kwargs)
        self._tracker.next_step()

    @on_main_process
    def finish(self):
        self._tracker.end()


class SwanLabTracker(GeneralTracker):
    name = "swanlab"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import swanlab

        self._tracker = swanlab.init(project=run_name, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        import swanlab

        swanlab.config.update(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self._tracker.log(values, step=step)

    @on_main_process
    def finish(self):
        self._tracker.finish()


class TrackioTracker(GeneralTracker):
    name = "trackio"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import trackio

        self._tracker = trackio.init(project=run_name, **kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._tracker.config.update(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import trackio

        trackio.log(values)

    @on_main_process
    def finish(self):
        import trackio

        trackio.finish()


LOGGER_TYPE_TO_CLASS = {
    "tensorboard": (TensorBoardTracker, imports.is_tensorboard_available),
    "wandb": (WandBTracker, imports.is_wandb_available),
    "comet_ml": (CometMLTracker, imports.is_comet_ml_available),
    "mlflow": (MLflowTracker, imports.is_mlflow_available),
    "aim": (AimTracker, imports.is_aim_available),
    "clearml": (ClearMLTracker, imports.is_clearml_available),
    "dvclive": (DVCLiveTracker, imports.is_dvclive_available),
    "swanlab": (SwanLabTracker, imports.is_swanlab_available),
    "trackio": (TrackioTracker, imports.is_trackio_available),
    "jsonl": (JSONLTracker, lambda: True),
}


def filter_trackers(log_with, logging_dir=None):
    """The tracker classes named by ``log_with`` whose libraries are
    installed (a missing one is skipped with a warning, an unknown name
    raises); ``"all"`` takes every available one but JSONL."""
    out = []
    for item in log_with if isinstance(log_with, (list, tuple)) else [log_with]:
        if isinstance(item, GeneralTracker):
            out.append(item)
            continue
        name = str(item).lower()
        if name == "all":
            out.extend(cls for n, (cls, avail) in LOGGER_TYPE_TO_CLASS.items() if avail() and n != "jsonl")
            continue
        cls, avail = LOGGER_TYPE_TO_CLASS.get(name, (None, None))
        if cls is None:
            raise ValueError(f"unknown tracker {item!r}; options: {sorted(LOGGER_TYPE_TO_CLASS)}")
        if not avail():
            logger.warning("Tracker %s requested but its library is not installed; skipping", name)
            continue
        out.append(cls)
    return out


def resolve_tracker(item, project_name: str, logging_dir=None, **init_kwargs):
    """One tracker built for ``Accelerator.init_trackers``."""
    if isinstance(item, GeneralTracker):
        return item
    classes = filter_trackers(item, logging_dir)
    if not classes:
        return None
    cls = classes[0]
    if getattr(cls, "requires_logging_directory", False):
        return cls(project_name, logging_dir=logging_dir or ".", **init_kwargs)
    return cls(project_name, **init_kwargs)
