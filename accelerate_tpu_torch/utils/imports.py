"""Availability probes for optional packages (mirrors the tracker probes of
``accelerate_tpu/utils/imports.py``): ``tracking.py`` asks them before it
builds a tracker whose library may be missing.  Cached; nothing is
imported to answer."""

from __future__ import annotations

import importlib.metadata
import importlib.util
from functools import lru_cache


@lru_cache
def _is_package_available(pkg_name: str, metadata_name: str | None = None) -> bool:
    try:
        exists = importlib.util.find_spec(pkg_name) is not None
    except (ImportError, ValueError):   # a parent package missing, or a stand-in module
        exists = False
    if exists and metadata_name is not None:
        try:
            importlib.metadata.version(metadata_name)
        except importlib.metadata.PackageNotFoundError:
            return False
    return exists


def is_tensorboard_available() -> bool:
    return (_is_package_available("tensorboardX") or _is_package_available("tensorboard")
            or _is_package_available("torch.utils.tensorboard"))


def is_wandb_available() -> bool:
    return _is_package_available("wandb")


def is_comet_ml_available() -> bool:
    return _is_package_available("comet_ml")


def is_mlflow_available() -> bool:
    return _is_package_available("mlflow")


def is_aim_available() -> bool:
    return _is_package_available("aim")


def is_clearml_available() -> bool:
    return _is_package_available("clearml")


def is_dvclive_available() -> bool:
    return _is_package_available("dvclive")


def is_swanlab_available() -> bool:
    return _is_package_available("swanlab")


def is_trackio_available() -> bool:
    return _is_package_available("trackio")
