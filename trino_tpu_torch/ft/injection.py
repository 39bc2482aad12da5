"""Deterministic, seed-driven fault injection.

Reference: ``io.trino.execution.FailureInjector`` (the hook Trino's
fault-tolerant-execution tests use to fail tasks at controlled points).
Here every injection *site* gets one pseudo-random draw derived purely
from ``(seed, site)`` — not from call order, wall clock, or process — so
a failing run replays exactly: the same seed and the same site string
always make the same decision, on the coordinator or on any worker.

Site strings deliberately exclude per-run identifiers (query counters,
host:port): a site is ``kind:fragment.partition[:attempt]``-shaped, so a
retried attempt (new attempt suffix) gets a fresh draw while a re-run of
the whole scenario reproduces the original faults bit-for-bit.

A copy of ``trino_tpu/ft/injection.py``: for the same seed and sites the draws equal
the reference's.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Optional

log = logging.getLogger("trino_tpu_torch.ft")

# keep the replay log bounded: chaos runs can draw thousands of sites
MAX_EVENTS = 2048


class InjectedFault(Exception):
    """A fault planted by the injector. Always retryable by definition:
    it models a crash/drop of otherwise-healthy work."""

    retryable = True

    def __init__(self, site: str, draw: float, kind: str):
        self.site = site
        self.draw = draw
        self.kind = kind
        super().__init__(
            f"injected {kind} fault at {site} (draw={draw:.6f})"
        )


class FaultInjector:
    """Seed-keyed fault decisions for task crashes and HTTP chaos.

    ``maybe_*`` methods draw deterministically per site and either return
    (no fault) or raise :class:`InjectedFault` / sleep. Every *injected*
    fault is recorded in :attr:`events` with its site and draw so a
    failure can be replayed from the log alone.
    """

    def __init__(
        self,
        seed: int = 0,
        task_crash_p: float = 0.0,
        http_drop_p: float = 0.0,
        http_delay_ms: float = 0.0,
        salt: Any = 0,
        slow_workers: str = "",
        task_stall_ms: float = 0.0,
        task_slow_factor: float = 1.0,
        worker_exit_node: str = "",
        worker_exit_site: str = "",
        worker_exit_delay_ms: float = 0.0,
    ):
        self.seed = int(seed)
        self.salt = salt  # varies per query attempt under QUERY retry
        self.task_crash_p = float(task_crash_p)
        self.http_drop_p = float(http_drop_p)
        self.http_delay_ms = float(http_delay_ms)
        # worker-death fault: after a task at "task:{worker_exit_site}"
        # finishes on a matching node ("" = any), the worker process
        # os._exit()s — a deterministic stand-in for SIGKILL
        self.worker_exit_node = str(worker_exit_node or "")
        self.worker_exit_site = str(worker_exit_site or "")
        self.worker_exit_delay_ms = max(0.0, float(worker_exit_delay_ms))
        # delay faults: which nodes run slow ("" = all), and how — a fixed
        # pre-execute stall and/or a multiplicative execution slowdown
        self.slow_workers = frozenset(
            w.strip() for w in str(slow_workers or "").split(",") if w.strip()
        )
        self.task_stall_ms = float(task_stall_ms)
        self.task_slow_factor = max(1.0, float(task_slow_factor))
        self.events: list[dict] = []
        self.dropped_events = 0
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    # --- construction -----------------------------------------------------

    @classmethod
    def from_session(cls, session) -> Optional["FaultInjector"]:
        """Injector for a session, or None when no fault is configured
        (the common case: zero overhead on the happy path)."""
        try:
            crash_p = float(session.get("fault_task_crash_p"))
            drop_p = float(session.get("fault_http_drop_p"))
            delay_ms = float(session.get("fault_http_delay_ms"))
            stall_ms = float(session.get("fault_task_stall_ms"))
            slow_factor = float(session.get("fault_task_slow_factor"))
            exit_site = str(session.get("fault_worker_exit_site") or "")
            if (
                crash_p <= 0
                and drop_p <= 0
                and delay_ms <= 0
                and stall_ms <= 0
                and slow_factor <= 1.0
                and not exit_site
            ):
                return None
            return cls(
                seed=int(session.get("fault_injection_seed")),
                task_crash_p=crash_p,
                http_drop_p=drop_p,
                http_delay_ms=delay_ms,
                salt=session.properties.get("fault_attempt_salt", 0),
                slow_workers=str(session.get("fault_slow_workers")),
                task_stall_ms=stall_ms,
                task_slow_factor=slow_factor,
                worker_exit_node=str(
                    session.get("fault_worker_exit_node") or ""
                ),
                worker_exit_site=exit_site,
                worker_exit_delay_ms=float(
                    session.get("fault_worker_exit_delay_ms")
                ),
            )
        except (KeyError, TypeError, ValueError):
            return None

    # --- draws ------------------------------------------------------------

    def draw(self, site: str) -> float:
        """The deterministic uniform draw for a site: a function of
        (seed, salt, site) only. ``random.Random`` seeds strings via
        SHA-512 (version-2 seeding), so the value is stable across
        processes and interpreter restarts."""
        return random.Random(f"{self.seed}/{self.salt}:{site}").random()

    def _record(self, site: str, kind: str, draw: float) -> None:
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            if len(self.events) < MAX_EVENTS:
                self.events.append(
                    {"site": site, "kind": kind, "draw": round(draw, 6)}
                )
            else:
                self.dropped_events += 1
        log.warning("fault injected: kind=%s site=%s draw=%.6f", kind, site, draw)

    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def maybe_crash_task(self, site: str) -> None:
        """Task-loop injection point: raises with ``task_crash_p``."""
        if self.task_crash_p <= 0:
            return
        d = self.draw(site)
        if d < self.task_crash_p:
            self._record(site, "task-crash", d)
            raise InjectedFault(site, d, "task-crash")

    def maybe_drop_http(self, site: str) -> None:
        """HTTP injection point: raises (the request never leaves) with
        ``http_drop_p``, modelling a dropped connection."""
        if self.http_drop_p <= 0:
            return
        d = self.draw(site)
        if d < self.http_drop_p:
            self._record(site, "http-drop", d)
            raise InjectedFault(site, d, "http-drop")

    def delay_http(self, site: str) -> None:
        """Slow-network injection: constant deterministic delay before a
        request (chaos tests shrink the configurable timeouts to turn
        this into timeout coverage)."""
        if self.http_delay_ms <= 0:
            return
        self._record(site, "http-delay", self.http_delay_ms / 1000.0)
        time.sleep(self.http_delay_ms / 1000.0)

    # --- delay faults (straggler manufacturing) ---------------------------

    def is_slow_node(self, node_id: Optional[str]) -> bool:
        """Does a delay fault target this node? An empty ``slow_workers``
        list means every node is slow (single-node chaos convenience)."""
        if self.task_stall_ms <= 0 and self.task_slow_factor <= 1.0:
            return False
        if not self.slow_workers:
            return True
        return node_id is not None and node_id in self.slow_workers

    def stall_task(self, site: str, node_id: Optional[str]) -> None:
        """Fixed pre-execute stall on targeted nodes. Recorded per site so
        chaos runs replay the same wall-clock shape."""
        if self.task_stall_ms <= 0 or not self.is_slow_node(node_id):
            return
        self._record(site, "task-stall", self.task_stall_ms / 1000.0)
        time.sleep(self.task_stall_ms / 1000.0)

    def slow_task(self, site: str, node_id: Optional[str],
                  execute_s: float) -> None:
        """Multiplicative slowdown: the worker measured ``execute_s`` of
        real execution; sleep the remainder so the attempt takes
        ``task_slow_factor`` times as long end to end. Applied *before*
        the result is emitted, so a speculative cancel still aborts the
        output buffer of a genuinely-10x-slow attempt."""
        if self.task_slow_factor <= 1.0 or not self.is_slow_node(node_id):
            return
        extra_s = max(0.0, execute_s) * (self.task_slow_factor - 1.0)
        if extra_s <= 0:
            return
        self._record(site, "task-slow", round(extra_s, 6))
        time.sleep(extra_s)

    def http_site(self, op: str, target: str, attempt: int) -> str:
        """Canonical HTTP site string. ``target`` must already be free of
        per-run identifiers (ports, query counters)."""
        return f"http:{op}:{target}:t{attempt}"

    # --- worker-death faults ----------------------------------------------

    def should_exit_worker(self, site: str, node_id: Optional[str]) -> bool:
        if not self.worker_exit_site:
            return False
        if site != f"task:{self.worker_exit_site}":
            return False
        if self.worker_exit_node and node_id != self.worker_exit_node:
            return False
        return True

    def maybe_exit_worker(self, site: str, node_id: Optional[str]) -> None:
        """Kill this worker process (``os._exit`` — no cleanup, no spool
        flush beyond what already happened) when ``site`` matches the
        configured fault point. Called after a task's terminal-state
        bookkeeping, so the death lands exactly once the fault-site task
        FINISHED; ``worker_exit_delay_ms`` lets the coordinator observe
        that state before the node vanishes. Fires at most once per
        process."""
        if not self.should_exit_worker(site, node_id):
            return
        if _worker_exit_fired.is_set():
            return
        _worker_exit_fired.set()
        self._record(site, "worker-exit", self.worker_exit_delay_ms / 1000.0)
        delay_s = self.worker_exit_delay_ms / 1000.0

        def _die():
            if delay_s > 0:
                time.sleep(delay_s)
            import os

            os._exit(137)  # SIGKILL-grade: skip atexit, flushes, finally

        threading.Thread(target=_die, daemon=True).start()


# process-wide: one injected death per worker process, even across tasks
_worker_exit_fired = threading.Event()


def injection_properties(
    seed: int,
    task_crash_p: float = 0.0,
    http_drop_p: float = 0.0,
    http_delay_ms: float = 0.0,
    slow_workers: str = "",
    task_stall_ms: float = 0.0,
    task_slow_factor: float = 1.0,
    worker_exit_node: str = "",
    worker_exit_site: str = "",
    worker_exit_delay_ms: float = 0.0,
) -> dict:
    """Session-property dict enabling injection (test/CLI convenience)."""
    return {
        "fault_injection_seed": seed,
        "fault_task_crash_p": task_crash_p,
        "fault_http_drop_p": http_drop_p,
        "fault_http_delay_ms": http_delay_ms,
        "fault_slow_workers": slow_workers,
        "fault_task_stall_ms": task_stall_ms,
        "fault_task_slow_factor": task_slow_factor,
        "fault_worker_exit_node": worker_exit_node,
        "fault_worker_exit_site": worker_exit_site,
        "fault_worker_exit_delay_ms": worker_exit_delay_ms,
    }


def task_site(task_id: str) -> str:
    """Injection site for a worker task, stripped of the per-run query
    counter: ``cq7.3.0r1`` -> ``task:3.0r1`` (fragment.partition+attempt),
    so draws replay across runs and differ across retry attempts."""
    parts = task_id.split(".")
    return "task:" + ".".join(parts[-2:]) if len(parts) >= 2 else f"task:{task_id}"
