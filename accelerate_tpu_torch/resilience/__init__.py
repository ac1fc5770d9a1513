"""Resilience of the port's host I/O (mirrors ``accelerate_tpu/resilience/``).

Only the bounded retry of :mod:`.retry` is ported so far; the
deterministic fault-injection hooks, preemption, the NaN guard and the
goodput accounting are ROADMAP item A14.
"""

from .retry import DEFAULT_POLICY, RetryPolicy, TransientIOError, with_retries

__all__ = ["DEFAULT_POLICY", "RetryPolicy", "TransientIOError", "with_retries"]
