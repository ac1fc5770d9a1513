"""Process-aware logging (mirrors ``accelerate_tpu/logging.py``:
``MultiProcessAdapter`` :47, ``get_logger`` :110).

The same call contract as the JAX package's logger —
``logger.info(msg, main_process_only=True)`` / ``in_order=True`` — over a
stdlib logger, in the process group's world: ``main_process_only`` emits on
rank 0 alone, ``in_order`` on every rank in turn between barriers, and
otherwise every rank emits at once (a world of one process emits once).
"""

from __future__ import annotations

import logging
import os

_LEVEL_ENV = "ACCELERATE_LOG_LEVEL"


def _emission_turns(main_process_only: bool, in_order: bool):
    """Yield once per moment this process emits the record (JAX :23)."""
    import torch.distributed as dist

    from .state import world as process_world

    world, rank = process_world()
    if main_process_only:
        if rank == 0:
            yield
        return
    if not in_order or world == 1:
        yield
        return
    for turn in range(world):
        if turn == rank:
            yield
        dist.barrier()


class MultiProcessAdapter:
    """Process-aware façade over a stdlib logger.

    The standard level methods (``debug``/``info``/.../``critical``) take
    the JAX package's two extra keywords, ``main_process_only`` (default
    True) and ``in_order``.
    ``warning_once`` deduplicates by message content per adapter instance.
    """

    def __init__(self, logger: logging.Logger, extra: dict | None = None):
        self.logger = logger
        self.extra = extra or {}
        self._warned: set = set()

    def process(self, msg, kwargs):
        if self.extra:
            kwargs.setdefault("extra", self.extra)
        return msg, kwargs

    def log(self, level, msg, *args, **kwargs):
        env_level = os.environ.get(_LEVEL_ENV)
        if env_level is not None and env_level.lstrip("-").isdigit() and int(env_level) >= 0:
            self.logger.setLevel(int(env_level))
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        kwargs.setdefault("stacklevel", 3)
        if not self.logger.isEnabledFor(level):
            return
        for _ in _emission_turns(main_process_only, in_order):
            out_msg, out_kwargs = self.process(msg, dict(kwargs))
            self.logger.log(level, out_msg, *args, **out_kwargs)

    def debug(self, msg, *args, **kwargs):
        self.log(logging.DEBUG, msg, *args, **kwargs)

    def info(self, msg, *args, **kwargs):
        self.log(logging.INFO, msg, *args, **kwargs)

    def warning(self, msg, *args, **kwargs):
        self.log(logging.WARNING, msg, *args, **kwargs)

    def error(self, msg, *args, **kwargs):
        self.log(logging.ERROR, msg, *args, **kwargs)

    def critical(self, msg, *args, **kwargs):
        self.log(logging.CRITICAL, msg, *args, **kwargs)

    def exception(self, msg, *args, **kwargs):
        kwargs.setdefault("exc_info", True)
        self.log(logging.ERROR, msg, *args, **kwargs)

    def warning_once(self, msg, *args, **kwargs):
        key = (str(msg), args)
        if key not in self._warned:
            self._warned.add(key)
            kwargs.setdefault("stacklevel", 4)  # skip the extra frame
            self.warning(msg, *args, **kwargs)

    def isEnabledFor(self, level) -> bool:
        return self.logger.isEnabledFor(level)

    def setLevel(self, level) -> None:
        self.logger.setLevel(level)


def get_logger(name: str, log_level: str = None) -> MultiProcessAdapter:
    """Named process-aware logger; ``log_level`` (a name such as
    ``"info"`` or a numeric stdlib level) falls back to the
    ``ACCELERATE_LOG_LEVEL`` environment variable."""
    if log_level is None:
        log_level = os.environ.get(_LEVEL_ENV)
    logger = logging.getLogger(name)
    if log_level is not None:
        level = int(log_level) if str(log_level).lstrip("-").isdigit() else str(log_level).upper()
        logger.setLevel(level)
        logger.root.setLevel(level)
    return MultiProcessAdapter(logger)
