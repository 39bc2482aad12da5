"""Heartbeat failure detection for worker nodes.

Reference: ``core/trino-main/.../failuredetector/HeartbeatFailureDetector.java:78``
— the coordinator periodically pings every discovered service; an
exponentially-decayed failure ratio above a threshold marks the node
failed, and schedulers exclude failed nodes. Recovery is automatic when
pings succeed again. (v356 has no mid-query retry — a lost worker fails
its queries; here ``trino_tpu/ft`` adds TASK/QUERY retry on top, and its
retry placement consults :meth:`HeartbeatFailureDetector.active_nodes`
to steer re-dispatched attempts away from sick workers.)

A copy of ``trino_tpu/server/failuredetector.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

DEFAULT_THRESHOLD = 0.1  # failure-ratio above this marks the node failed
DECAY_SECONDS = 30.0  # exponential decay horizon of the failure ratio


@dataclasses.dataclass
class NodeState:
    node_id: str
    uri: str
    decay_seconds: float = DECAY_SECONDS
    failure_ratio: float = 0.0
    last_update: float = 0.0
    last_seen: Optional[float] = None
    consecutive_failures: int = 0
    # EWMA of successful-ping round-trip latency; None until the first
    # success. Task placement uses it to steer hedges and recovery
    # re-dispatches away from the slowest healthy node.
    latency_ewma_ms: Optional[float] = None

    @property
    def known(self) -> bool:
        """Whether this node has ever been pinged. A registered-but-
        never-pinged node has no evidence either way; it must not be
        reported as healthy on the strength of its initial 0.0 ratio."""
        return self.last_update > 0.0

    def record(self, success: bool, now: float,
               latency_ms: Optional[float] = None) -> None:
        # exponential decay toward the new observation
        # (HeartbeatFailureDetector.Stats.DecayCounter)
        if self.last_update:
            dt = max(0.0, now - self.last_update)
            alpha = 2 ** (-dt / self.decay_seconds)
        else:
            alpha = 0.0
        observation = 0.0 if success else 1.0
        self.failure_ratio = alpha * self.failure_ratio + (1 - alpha) * observation
        self.last_update = now
        if success:
            self.last_seen = now
            self.consecutive_failures = 0
            if latency_ms is not None:
                self.latency_ewma_ms = (
                    latency_ms
                    if self.latency_ewma_ms is None
                    else 0.75 * self.latency_ewma_ms + 0.25 * latency_ms
                )
        else:
            self.consecutive_failures += 1


class HeartbeatFailureDetector:
    """Pings registered nodes with ``ping_fn(uri) -> bool`` on a cadence;
    ``active_nodes()`` is what schedulers consult."""

    def __init__(
        self,
        ping_fn: Callable[[str], bool],
        interval: float = 0.5,
        threshold: float = DEFAULT_THRESHOLD,
        decay_seconds: float = DECAY_SECONDS,
    ):
        self.ping_fn = ping_fn
        self.interval = interval
        self.threshold = threshold
        self.decay_seconds = decay_seconds
        self._nodes: dict[str, NodeState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, node_id: str, uri: str) -> None:
        with self._lock:
            self._nodes[node_id] = NodeState(node_id, uri, self.decay_seconds)

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def start(self) -> "HeartbeatFailureDetector":
        if self._thread is not None and self._thread.is_alive():
            return self  # already running
        # a restarted detector must not inherit the previous stop() — a
        # set event makes the new loop exit before its first ping
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.ping_all()

    def ping_all(self) -> None:
        with self._lock:
            nodes = list(self._nodes.values())
        now = time.time()
        for n in nodes:
            t0 = time.monotonic()
            try:
                ok = bool(self.ping_fn(n.uri))
            except Exception:  # noqa: BLE001 — any ping error is a failure
                ok = False
            n.record(
                ok, now, latency_ms=(time.monotonic() - t0) * 1000.0
            )

    def is_failed(self, node_id: str) -> bool:
        """Positive evidence of failure. A never-pinged node is NOT
        failed (no evidence) — but neither is it active; membership
        freshness (announce timeout) covers it until the first ping."""
        with self._lock:
            n = self._nodes.get(node_id)
        if n is None:
            return True
        return n.known and n.failure_ratio > self.threshold

    def latency_ms(self, node_id: str) -> float:
        """Ping-latency EWMA for placement ranking; 0.0 when unknown (a
        fresh node ranks neutral, preserving round-robin tie-breaks)."""
        with self._lock:
            n = self._nodes.get(node_id)
        if n is None or n.latency_ewma_ms is None:
            return 0.0
        return n.latency_ewma_ms

    def active_nodes(self) -> list[str]:
        """Nodes with positive evidence of health: pinged at least once
        and below the failure threshold. Retry placement uses this —
        never-pinged nodes are unknown, not healthy."""
        with self._lock:
            nodes = list(self._nodes.values())
        return [
            n.node_id
            for n in nodes
            if n.known and n.failure_ratio <= self.threshold
        ]

    def info(self) -> list[dict]:
        with self._lock:
            nodes = list(self._nodes.values())
        return [
            {
                "nodeId": n.node_id,
                "uri": n.uri,
                "failureRatio": round(n.failure_ratio, 4),
                "known": n.known,
                "failed": n.known and n.failure_ratio > self.threshold,
                "lastSeen": n.last_seen,
                "latencyEwmaMs": (
                    round(n.latency_ewma_ms, 3)
                    if n.latency_ewma_ms is not None
                    else None
                ),
            }
            for n in nodes
        ]
