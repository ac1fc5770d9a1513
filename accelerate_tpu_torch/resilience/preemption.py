"""Graceful preemption: SIGTERM → step boundary → emergency checkpoint → 75
(the port's own copy of ``accelerate_tpu/resilience/preemption.py``, which
imports no JAX).

1. the cloud sends ``SIGTERM`` with a short grace window;
2. the handler here only **sets a flag** (the async-signal-safe minimum —
   no allocation, no I/O, no CUDA calls in signal context);
3. the Accelerator's prepared-step wrapper checks the flag **after** the
   step in flight completes — the post-step state is exactly consistent
   with the data loader position and step counters, so the resumed run
   replays nothing and skips nothing;
4. the in-flight async checkpoint (if any) is drained, an **emergency
   checkpoint** of the boundary state is written through the verified
   atomic path, and the process exits with :data:`RESUME_EXIT_CODE`;
5. the supervisor sees the distinct code, re-launches, and
   ``Accelerator.maybe_resume`` picks up the newest *valid* checkpoint.

``RESUME_EXIT_CODE`` is 75 — BSD ``EX_TEMPFAIL``, "transient failure,
re-run me" — distinct from 0 (done) and 1 (crash).  In a world of several
processes the boundary check is agreed across the ranks
(``Accelerator._agreed_preemption``: any rank's flag stops them all at the
same step, so the emergency checkpoint's collectives meet).
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable, Union

from ..logging import get_logger

logger = get_logger(__name__)

# BSD EX_TEMPFAIL: the canonical "re-run me" code, distinct from crash/success
RESUME_EXIT_CODE = 75


def _resolve_signal(sig: Union[str, int]) -> signal.Signals:
    if isinstance(sig, str):
        return getattr(signal, sig)
    return signal.Signals(sig)


class PreemptionHandler:
    """Flag-only signal handler; the step wrapper polls :attr:`requested`.

    ``install()`` swaps the process handlers in (remembering the previous
    ones for :meth:`uninstall`); ``request()`` arms the flag
    programmatically — the fault-injection harness and tests use it (or a
    real ``os.kill(os.getpid(), SIGTERM)``) interchangeably with a genuine
    external preemption notice.
    """

    def __init__(self, signals: Iterable[Union[str, int]] = ("SIGTERM",)):
        self.signals = tuple(_resolve_signal(s) for s in signals)
        self._requested = threading.Event()
        self._previous: dict = {}
        self._installed = False

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            # CPython only allows signal.signal on the main thread; a worker
            # thread (e.g. a notebook executor) degrades to programmatic
            # request() with a loud note rather than crashing construction
            logger.warning(
                "preemption handler not installed: signal handlers can only "
                "be set from the main thread; use handler.request() or rely "
                "on the supervisor's own checkpoint discipline"
            )
            return self
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        logger.debug("preemption handler installed for %s", [s.name for s in self.signals])
        return self

    def _on_signal(self, signum, frame):  # async-signal-safe: flag only
        self._requested.set()

    def request(self) -> None:
        """Arm the stop flag without a signal (tests / fault injection)."""
        self._requested.set()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def clear(self) -> None:
        self._requested.clear()

    def uninstall(self) -> None:
        """Restore the previous handlers (test hygiene)."""
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # non-main thread / exotic prev
                logger.warning("could not restore previous handler for %s", sig)
        self._previous.clear()
        self._installed = False
