"""Bounded retry with exponential backoff for host-side I/O (the port's
own copy of ``accelerate_tpu/resilience/retry.py``, which imports no JAX).

The host-driven transfers it wraps — the adapter pool's cold-tier reads
and host-to-device staging (``ops/streaming.py``'s
:class:`~accelerate_tpu_torch.ops.streaming.LayerPrefetcher`) — fail
transiently in the ways CheckFreq (Mohan et al., FAST'21) catalogs: a
shared-filesystem hiccup, a DMA that times out under host pressure, a
stale NFS handle.  Crashing on the first such blip throws work away; an
unbounded retry loop wedges the run instead.  This is the middle path: a
small, explicit budget of re-attempts with exponential backoff, after
which the original exception propagates.

Fatal filesystem errors (missing paths, permission walls) are never
retried.  The fault plan's ``maybe_fail_transfer`` (``faults.py``) fires
inside each attempt, so an injected failure takes the real backoff path.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class TransientIOError(OSError):
    """A retry-worthy I/O failure, for transfer callables that want to
    signal "try again" explicitly; plain ``OSError``s are also retried
    unless they are in the fatal set below."""


# errors where a retry can only reproduce the same answer more slowly
_FATAL_OS_ERRORS = (
    FileNotFoundError,
    NotADirectoryError,
    IsADirectoryError,
    PermissionError,
    FileExistsError,
)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry budget for one I/O call site.

    ``retries`` is the number of *re*-attempts (0 = fail on first error);
    the sleep before re-attempt ``k`` is
    ``min(backoff_s * multiplier**k, max_backoff_s)``.
    """

    retries: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    retryable: tuple = (OSError, ConnectionError, TimeoutError)

    def __post_init__(self):
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")


DEFAULT_POLICY = RetryPolicy()


def _is_retryable(exc: BaseException, policy: RetryPolicy) -> bool:
    if isinstance(exc, TransientIOError):
        return True
    if isinstance(exc, _FATAL_OS_ERRORS):
        return False
    return isinstance(exc, policy.retryable)


def with_retries(
    fn: Callable,
    *args,
    policy: RetryPolicy = DEFAULT_POLICY,
    site: str = "io",
    on_retry: Optional[Callable[[str, int, BaseException], None]] = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, re-attempting transient failures.

    At most ``policy.retries`` re-attempts with exponential backoff; a
    non-retryable exception propagates immediately, and the last retryable
    one propagates once the budget is spent.  ``on_retry(site, attempt,
    exc)`` fires before each sleep.
    """
    delay = policy.backoff_s
    for attempt in range(policy.retries + 1):
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # re-raised below unless retryable
            if attempt >= policy.retries or not _is_retryable(e, policy):
                raise
            logger.warning(
                "%s: transient failure (attempt %d/%d): %s — retrying in %.3gs",
                site, attempt + 1, policy.retries + 1, e, delay,
            )
            if on_retry is not None:
                on_retry(site, attempt, e)
            time.sleep(delay)
            delay = min(delay * policy.multiplier, policy.max_backoff_s)
