"""Fault-tolerant execution: the retry policies.

A copy of the retry half of ``trino_tpu/ft/``: :class:`Backoff`,
:class:`RetryPolicy` and :func:`is_retryable`, which the query manager
(retry_policy=QUERY) and the client (503 with Retry-After) use. Fault
injection (``ft/injection.py``) belongs to the cluster tier, which this
package does not have yet (ROADMAP item 9c).
"""

from trino_tpu_torch.ft.retry import (
    Backoff,
    RetryPolicy,
    TaskFailure,
    TaskRetriesExhausted,
    is_retryable,
)

__all__ = [
    "Backoff",
    "RetryPolicy",
    "TaskFailure",
    "TaskRetriesExhausted",
    "is_retryable",
]
