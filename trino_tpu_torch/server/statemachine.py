"""Listener-based finite state machines for queries.

Reference: ``core/trino-main/src/main/java/io/trino/execution/StateMachine.java``
(generic compare-and-set FSM with listeners) and ``QueryState`` /
``QueryStateMachine.java`` (QUEUED → ... → terminal).

A copy of ``trino_tpu/server/statemachine.py``.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Generic, Optional, TypeVar

S = TypeVar("S")


class StateMachine(Generic[S]):
    """Thread-safe state holder with transition listeners and terminal
    states (mirrors StateMachine.java's setIf/addStateChangeListener)."""

    def __init__(self, name: str, initial: S, terminal: set[S]):
        self.name = name
        self._state = initial
        self._terminal = set(terminal)
        # reentrant: wait_for predicates may call back into get()/is_terminal()
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._listeners: list[Callable[[S], None]] = []

    def get(self) -> S:
        with self._lock:
            return self._state

    def is_terminal(self) -> bool:
        with self._lock:
            return self._state in self._terminal

    def compare_and_set(self, expected: S, new: S) -> bool:
        with self._lock:
            if self._state != expected or self._state in self._terminal:
                return False
            self._state = new
            listeners = list(self._listeners)
            self._cond.notify_all()
        for fn in listeners:
            fn(new)
        return True

    def set(self, new: S) -> bool:
        """Transition unless already terminal. Returns True on change."""
        with self._lock:
            if self._state in self._terminal or self._state == new:
                return False
            self._state = new
            listeners = list(self._listeners)
            self._cond.notify_all()
        for fn in listeners:
            fn(new)
        return True

    def add_listener(self, fn: Callable[[S], None]) -> None:
        with self._lock:
            self._listeners.append(fn)
            current = self._state
        fn(current)

    def remove_listener(self, fn: Callable[[S], None]) -> None:
        """Detach a listener (long-polls must not accumulate forever)."""
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def wait_for(self, predicate: Callable[[S], bool], timeout: float) -> S:
        """Block until predicate(state) or timeout (long-poll support)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while not predicate(self._state):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._state in self._terminal:
                    break
                self._cond.wait(remaining)
            return self._state


class QueryState(str, enum.Enum):
    """Reference: ``execution/QueryState.java``."""

    QUEUED = "QUEUED"
    WAITING_FOR_RESOURCES = "WAITING_FOR_RESOURCES"
    PLANNING = "PLANNING"
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    FINISHING = "FINISHING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


TERMINAL_QUERY_STATES = {QueryState.FINISHED, QueryState.FAILED, QueryState.CANCELED}


def new_query_state_machine(query_id: str) -> StateMachine[QueryState]:
    return StateMachine(query_id, QueryState.QUEUED, TERMINAL_QUERY_STATES)


class TaskState:
    """Worker task states (reference: ``execution/TaskState.java``).

    Plain string constants — worker task state crosses the HTTP boundary
    as JSON, so the wire form IS the state. ``CANCELED_SPECULATIVE``
    marks the loser of a hedged (speculative) attempt pair: cancelled by
    the scheduler because a sibling finished first, not because the
    query failed — terminal and failed-for-consumers, but not an error.
    """

    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELED = "CANCELED"
    CANCELED_SPECULATIVE = "CANCELED_SPECULATIVE"


TERMINAL_TASK_STATES = {
    TaskState.FINISHED,
    TaskState.FAILED,
    TaskState.CANCELED,
    TaskState.CANCELED_SPECULATIVE,
}
