"""Fault-tolerant execution: deterministic fault injection + retry policies.

Reference: Trino's later fault-tolerant execution ("Tardigrade",
``core/trino-main/.../execution/scheduler/faulttolerant/``) — retry
policies NONE / TASK / QUERY over materialized (spooled) exchanges — and
the chaos-style ``FailureInjector`` used by its test harness
(``io.trino.execution.FailureInjector``). v356 itself has no mid-query
retry; this subsystem is the cluster-level robustness layer the ROADMAP's
preemptible-slice north star requires.

A copy of ``trino_tpu/ft/__init__.py``.
"""

from trino_tpu_torch.ft.injection import (
    FaultInjector,
    InjectedFault,
    injection_properties,
)
from trino_tpu_torch.ft.retry import (
    Backoff,
    RetryPolicy,
    TaskFailure,
    TaskRetriesExhausted,
    is_retryable,
)

__all__ = [
    "Backoff",
    "FaultInjector",
    "InjectedFault",
    "RetryPolicy",
    "TaskFailure",
    "TaskRetriesExhausted",
    "injection_properties",
    "is_retryable",
]
