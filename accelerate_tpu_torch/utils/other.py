"""Grab-bag utilities (mirrors ``accelerate_tpu/utils/other.py``).

- :func:`extract_model_from_parallel` (JAX :30): a pipeline's
  :class:`~..parallel.pipeline_parallel.PipelinedModel` unwrapped to the
  user's model, the pipeline's trained tensors copied into it (JAX's
  module holds no tensors; the port's does).
- :func:`save` / :func:`load` (JAX :62 / :85): a tree of tensors to disk,
  on the main process only; safetensors with flat ``a/b/c`` keys, or
  ``torch.save`` (the JAX package's flax msgpack), which keeps the tree.
- :func:`check_os_kernel` (JAX :140): a warning on Linux kernels below
  5.5.

JAX's ``aot_compile`` (:105) and ``compile_regions`` (:118) lower XLA
programs ahead of time; an eager PyTorch step compiles nothing, so they
have no counterpart here.
"""

from __future__ import annotations

import logging
import platform
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)


def extract_model_from_parallel(model: Any, keep_fp32_wrapper: bool = True) -> Any:
    """The user's model inside a pipeline-parallel ``PipelinedModel`` (the
    port's one wrapping container; sharded training keeps the module),
    holding the pipeline's trained tensors (``PipelinedModel.merged_model``:
    a gather over ``pp``, so every rank calls this together); anything else
    as it is."""
    from ..parallel.pipeline_parallel import PipelinedModel

    if isinstance(model, PipelinedModel):
        return model.merged_model()
    return model


def _flatten(obj, prefix: str = "") -> dict:
    """``{"a/b/c": tensor}`` of a tree of dicts, lists and tuples."""
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple)):
        items = enumerate(obj)
    else:
        return {prefix: torch.as_tensor(obj)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def save(obj: Any, path, safe_serialization: bool = True) -> None:
    """Write a tree of tensors to ``path``, on the main process only.
    ``safe_serialization``: safetensors with flat ``a/b/c`` keys; else
    ``torch.save``, which round-trips the tree's structure."""
    from ..state import world

    if world()[1] != 0:
        return
    if not safe_serialization:
        torch.save(obj, str(path))
        return
    from .serialization import save_safetensors

    save_safetensors(str(path), _flatten(obj))


def load(path, target: Optional[Any] = None) -> Any:
    """The inverse of :func:`save`, its format sniffed: a safetensors file
    comes back as the flat ``{key: tensor}`` dict, a ``torch.save`` one as
    its tree (``target`` is accepted for the JAX signature; the file
    carries its own structure)."""
    from .serialization import load_safetensors, read_safetensors_header

    try:
        read_safetensors_header(path)
    except Exception:
        return torch.load(str(path), weights_only=False)
    return load_safetensors(str(path))


def check_os_kernel() -> None:
    """Warn about Linux kernels below 5.5 (host-side loading may hang
    under heavy threading)."""
    info = platform.uname()
    if info.system != "Linux":
        return
    try:
        release = tuple(int(p) for p in info.release.split(".")[:2])
    except ValueError:
        return
    if release < (5, 5):
        logger.warning(
            "Detected Linux kernel %s < 5.5; host-side data loading may hang "
            "under heavy threading. Consider upgrading.", info.release)


__all__ = ["extract_model_from_parallel", "save", "load", "check_os_kernel"]
