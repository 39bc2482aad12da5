"""Retry policies, backoff, and retryable-error classification.

Reference: Trino's ``retry-policy`` session property (NONE / TASK /
QUERY, ``io.trino.execution.RetryPolicy``) plus the standard
exponential-backoff-with-jitter schedule its task retries use
(``faulttolerant/EventDrivenFaultTolerantQueryScheduler``). Jitter here
is *deterministic* (seeded by attempt index) so chaos runs replay with
identical timing decisions.

A copy of ``trino_tpu/ft/retry.py``.
"""

from __future__ import annotations

import random
import socket
import urllib.error
from typing import Optional


class RetryPolicy:
    """String constants (mirrors ``io.trino.execution.RetryPolicy``)."""

    NONE = "NONE"
    TASK = "TASK"
    QUERY = "QUERY"

    @classmethod
    def of(cls, value) -> str:
        v = str(value or cls.NONE).upper()
        if v not in (cls.NONE, cls.TASK, cls.QUERY):
            raise ValueError(f"unknown retry_policy: {value!r}")
        return v

    @classmethod
    def from_session(cls, session) -> str:
        try:
            return cls.of(session.get("retry_policy"))
        except KeyError:
            return cls.NONE


class TaskFailure(Exception):
    """A remote task failed; carries the worker's retryable
    classification so the query-level error is typed correctly."""

    def __init__(self, task_id: str, node_id: str, error: Optional[str],
                 retryable: bool):
        self.task_id = task_id
        self.node_id = node_id
        self.error = error
        self.retryable = retryable
        super().__init__(
            f"task {task_id} failed on {node_id}"
            f" ({'retryable' if retryable else 'fatal'}): {error}"
        )


class TaskRetriesExhausted(TaskFailure):
    """Every allowed attempt of one task failed. Not task-retryable by
    construction (the budget is spent) but QUERY retry may still apply."""

    def __init__(self, task_id: str, node_id: str, error: Optional[str],
                 attempts: int):
        super().__init__(task_id, node_id, error, retryable=False)
        self.attempts = attempts
        self.args = (
            f"task {task_id} failed after {attempts} attempts"
            f" (last on {node_id}): {error}",
        )


class SpeculationConfig:
    """Straggler-detection knobs for hedged task execution.

    A running attempt is flagged once ``elapsed > max(floor_ms,
    multiplier * p99(completed sibling elapsed))``, and only after
    ``min_completed`` siblings of the same stage have finished (the
    quorum keeps the very first finisher from branding everyone else a
    straggler). Only meaningful under ``retry_policy=TASK`` — hedging
    rides the same re-dispatch-over-retained-buffers machinery.
    """

    def __init__(
        self,
        enabled: bool = False,
        floor_ms: float = 500.0,
        multiplier: float = 2.0,
        max_fraction: float = 0.25,
        min_completed: int = 1,
    ):
        self.enabled = bool(enabled)
        self.floor_ms = max(0.0, float(floor_ms))
        self.multiplier = max(1.0, float(multiplier))
        self.max_fraction = max(0.0, float(max_fraction))
        self.min_completed = max(1, int(min_completed))

    @classmethod
    def from_session(cls, session) -> "SpeculationConfig":
        try:
            return cls(
                enabled=bool(session.get("speculation")),
                floor_ms=float(session.get("speculation_floor_ms")),
                multiplier=float(session.get("speculation_multiplier")),
                max_fraction=float(session.get("speculation_max_fraction")),
            )
        except (KeyError, TypeError, ValueError):
            return cls()

    def budget(self, total_tasks: int) -> int:
        """Max concurrent speculative attempts for a query with
        ``total_tasks`` planned tasks (at least 1 when enabled)."""
        if not self.enabled:
            return 0
        return max(1, int(self.max_fraction * max(0, total_tasks)))

    def threshold_ms(self, completed_elapsed_ms) -> Optional[float]:
        """Straggler threshold given completed siblings' elapsed times,
        or None while the quorum is unmet (never hedge blind)."""
        if not self.enabled or len(completed_elapsed_ms) < self.min_completed:
            return None
        from trino_tpu_torch.obs.metrics import percentile

        p99 = percentile(completed_elapsed_ms, 99.0) or 0.0
        return max(self.floor_ms, self.multiplier * p99)


class SpoolConfig:
    """Spooled-exchange knobs — the recovery tier between TASK and QUERY.

    The recovery ladder: a failed *attempt* retries on another node
    (TASK); a straggler gets hedged (speculation); a *dead producer's*
    finished output is served from the spool or, if un-spooled, the
    producer alone is re-executed via lineage (this tier); only when all
    of that is exhausted does the whole statement re-run (QUERY). Spooling
    only engages under ``retry_policy=TASK`` — it extends the retained-
    buffer exchange that policy already materializes.
    """

    def __init__(self, enabled: bool = False, spool_dir: str = "",
                 max_bytes: int = 256 << 20):
        self.enabled = bool(enabled)
        self.spool_dir = str(spool_dir or "")
        self.max_bytes = max(0, int(max_bytes))

    @classmethod
    def from_session(cls, session) -> "SpoolConfig":
        try:
            return cls(
                enabled=bool(session.get("exchange_spooling")),
                spool_dir=str(session.get("spool_dir") or ""),
                max_bytes=int(session.get("spool_max_bytes")),
            )
        except (KeyError, TypeError, ValueError):
            return cls()


class Backoff:
    """Exponential backoff with bounded, deterministic jitter.

    ``delay(attempt)`` for attempt=1,2,3... grows initial * 2^(attempt-1)
    up to ``max_delay``, scaled by a jitter factor in [0.5, 1.0] drawn
    from (seed, attempt) so replays sleep identically.
    """

    def __init__(
        self,
        initial_ms: float = 100.0,
        max_ms: float = 2000.0,
        seed: int = 0,
    ):
        self.initial_ms = max(0.0, float(initial_ms))
        self.max_ms = max(self.initial_ms, float(max_ms))
        self.seed = int(seed)

    @classmethod
    def from_session(cls, session) -> "Backoff":
        try:
            return cls(
                initial_ms=float(session.get("retry_initial_delay_ms")),
                max_ms=float(session.get("retry_max_delay_ms")),
                seed=int(session.get("fault_injection_seed")),
            )
        except KeyError:
            return cls()

    def delay(self, attempt: int) -> float:
        """Seconds to sleep before retry number ``attempt`` (1-based)."""
        if self.initial_ms <= 0:
            return 0.0
        base = min(self.max_ms, self.initial_ms * (2 ** max(0, attempt - 1)))
        jitter = 0.5 + 0.5 * random.Random(f"{self.seed}:backoff:{attempt}").random()
        return base * jitter / 1000.0


def is_retryable(exc: BaseException) -> bool:
    """Classify an exception for the retry policies.

    Retryable: injected faults, network/timeout errors (the request may
    succeed against a different worker or on a later attempt), and
    node-local memory exhaustion (another node may have headroom).
    Fatal: everything deterministic — SQL/semantic errors, capacity-
    retry exhaustion (same data ⇒ same growth path on any node), and
    exhausted task-retry budgets.
    """
    flagged = getattr(exc, "retryable", None)
    if flagged is not None:
        return bool(flagged)
    if isinstance(
        exc,
        (
            urllib.error.URLError,  # includes HTTPError; connection refused
            ConnectionError,
            TimeoutError,
            socket.timeout,
            OSError,
        ),
    ):
        return True
    try:
        from trino_tpu_torch.memory import ExceededMemoryLimitError

        if isinstance(exc, ExceededMemoryLimitError):
            return True
    except ImportError:  # pragma: no cover
        pass
    return False
