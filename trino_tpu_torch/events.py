"""Query event listeners.

Reference: ``event/QueryMonitor.java:92,134,210`` builds
created/completed events → ``eventlistener/EventListenerManager.java`` →
pluggable ``EventListener``s (``spi/eventlistener/``,
``Plugin.getEventListenerFactories`` at ``spi/Plugin.java:80``).

A copy of ``trino_tpu/events.py``. The engine fires the query events;
the stage and task events are the cluster scheduler's, which this
package does not have yet (ROADMAP item 9c), so nothing fires them here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class QueryCreatedEvent:
    query_id: str
    sql: str
    user: str
    create_time: float


@dataclasses.dataclass
class QueryCompletedEvent:
    query_id: str
    sql: str
    user: str
    create_time: float
    end_time: float
    state: str  # FINISHED | FAILED | CANCELED
    output_rows: int = 0
    peak_memory_bytes: int = 0
    error_message: Optional[str] = None
    wall_seconds: float = 0.0
    # classification matching the /v1/query error block (trino_tpu.errors)
    error_code: Optional[int] = None
    error_type: Optional[str] = None


@dataclasses.dataclass
class StageCompletedEvent:
    query_id: str
    stage_id: int
    state: str  # FINISHED | FAILED
    tasks: int = 0
    attempts: int = 0
    elapsed_ms: float = 0.0
    # sibling task elapsed distribution (straggler/speculation signal)
    task_elapsed_p50_ms: Optional[float] = None
    task_elapsed_p99_ms: Optional[float] = None


@dataclasses.dataclass
class TaskCompletedEvent:
    query_id: str
    stage_id: int
    task_id: str
    worker: str
    state: str  # FINISHED | FAILED | CANCELED | CANCELED_SPECULATIVE | ...
    attempt: int = 1
    elapsed_ms: float = 0.0
    rows: int = 0
    error_message: Optional[str] = None
    # a hedged (duplicate) attempt of a detected straggler
    speculative: bool = False


class EventListener:
    """Subclass and override; all hooks optional (spi/eventlistener)."""

    def query_created(self, event: QueryCreatedEvent) -> None:  # noqa: B027
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:  # noqa: B027
        pass

    def stage_completed(self, event: StageCompletedEvent) -> None:  # noqa: B027
        pass

    def task_completed(self, event: TaskCompletedEvent) -> None:  # noqa: B027
        pass


class EventListenerManager:
    def __init__(self):
        self._listeners: list[EventListener] = []

    def add(self, listener: EventListener) -> None:
        self._listeners.append(listener)

    def fire_created(self, event: QueryCreatedEvent) -> None:
        for l in self._listeners:
            try:
                l.query_created(event)
            except Exception:  # noqa: BLE001 — listeners never fail queries
                pass

    def fire_completed(self, event: QueryCompletedEvent) -> None:
        for l in self._listeners:
            try:
                l.query_completed(event)
            except Exception:  # noqa: BLE001
                pass

    def fire_stage_completed(self, event: StageCompletedEvent) -> None:
        for l in self._listeners:
            try:
                l.stage_completed(event)
            except Exception:  # noqa: BLE001
                pass

    def fire_task_completed(self, event: TaskCompletedEvent) -> None:
        for l in self._listeners:
            try:
                l.task_completed(event)
            except Exception:  # noqa: BLE001
                pass
