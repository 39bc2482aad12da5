"""Hierarchical resource groups: admission control and query queueing.

Reference: ``core/trino-main/.../execution/resourcegroups/`` —
``InternalResourceGroup.java`` (hierarchy, hard concurrency + queue caps,
fair/weighted-fair/fifo scheduling), ``InternalResourceGroupManager``,
selector-based group resolution and the file-based configuration format of
``plugin/trino-resource-group-managers``
(``resource_groups.json``: rootGroups + selectors).

Queries queue *before* execution (dispatcher tier, L7). Two admission
styles share one waiter queue:

- ``admit()`` — legacy blocking call: parks the calling thread on an
  Event until a slot frees (DispatchManager → ResourceGroupManager.submit
  with a thread per query).
- ``submit(user, source, ready)`` — event-driven: returns immediately
  with ``(group, admitted_now)``; when queued, the ``ready`` callback
  fires later — outside the manager lock — once a slot frees (or with a
  QueryQueueFullError when the queue wait expires). No thread is parked
  while a query waits, so thousands of queued queries cost thousands of
  waiter objects, not thousands of stacks.

A copy of ``trino_tpu/server/resourcegroups.py``; the device-memory gate
reads the card through ``torch.cuda.mem_get_info``.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Optional


class QueryQueueFullError(Exception):
    """Reference error code QUERY_QUEUE_FULL."""


class _Waiter:
    """One queued admission. Either a blocking Event (``admit()``) or an
    event-driven callback (``submit()``). Queue membership and the
    ``admitted`` flag are guarded by the manager lock; callbacks are
    always invoked OUTSIDE it."""

    __slots__ = ("group", "enq_mono", "deadline", "event", "callback",
                 "admitted", "peak_hbm_hint")

    def __init__(
        self,
        group: "ResourceGroup",
        enq_mono: float,
        deadline: float,
        event: Optional[threading.Event] = None,
        callback: Optional[
            Callable[["ResourceGroup", Optional[Exception]], None]
        ] = None,
        peak_hbm_hint: int = 0,
    ):
        self.group = group
        self.enq_mono = enq_mono  # monotonic: queue-wait SLO accounting
        self.deadline = deadline  # monotonic absolute expiry
        self.event = event
        self.callback = callback
        self.admitted = False
        # observed peak-HBM bytes from the query-history store (0 =
        # unknown): a waiter whose programs won't fit CURRENT device
        # headroom is skipped over — not head-of-line blocking — until
        # memory frees or its queue wait expires
        self.peak_hbm_hint = peak_hbm_hint


@dataclasses.dataclass
class GroupConfig:
    name: str
    max_queued: int = 100
    hard_concurrency_limit: int = 10
    scheduling_weight: int = 1
    scheduling_policy: str = "fair"  # fair | weighted_fair | fifo
    subgroups: list["GroupConfig"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Selector:
    """Maps (user, source) to a group path. ``${USER}`` expands."""

    group: str
    user_pattern: Optional[str] = None
    source_pattern: Optional[str] = None

    def matches(self, user: str, source: str) -> bool:
        if self.user_pattern and not re.fullmatch(self.user_pattern, user or ""):
            return False
        if self.source_pattern and not re.fullmatch(self.source_pattern, source or ""):
            return False
        return True

    def resolve(self, user: str) -> str:
        return self.group.replace("${USER}", user or "unknown")


class ResourceGroup:
    """One node of the hierarchy. Thread-safe via the manager's lock."""

    def __init__(
        self,
        config: GroupConfig,
        parent: Optional["ResourceGroup"],
        lock,
        dynamic: bool = False,
    ):
        self.config = config
        self.parent = parent
        self._lock = lock
        self.dynamic = dynamic  # ${USER}-template subgroup: evicted when idle
        self.running = 0
        self.queue: deque = deque()  # waiting admissions (_Waiter)
        self.children: dict[str, ResourceGroup] = {}
        for sub in config.subgroups:
            self.children[sub.name] = ResourceGroup(sub, self, lock)
        self.total_admitted = 0
        self.total_queued_time = 0.0

    @property
    def full_name(self) -> str:
        if self.parent is None:
            return self.config.name
        return f"{self.parent.full_name}.{self.config.name}"

    def _can_run_locked(self) -> bool:
        g: Optional[ResourceGroup] = self
        while g is not None:
            if g.running >= g.config.hard_concurrency_limit:
                return False
            g = g.parent
        return True

    def _start_locked(self) -> None:
        g: Optional[ResourceGroup] = self
        while g is not None:
            g.running += 1
            g = g.parent
        self.total_admitted += 1

    def _finish_locked(self) -> None:
        g: Optional[ResourceGroup] = self
        while g is not None:
            g.running = max(0, g.running - 1)
            g = g.parent

    def _queued_count_locked(self) -> int:
        n = len(self.queue)
        for c in self.children.values():
            n += c._queued_count_locked()
        return n

    def info(self) -> dict:
        return {
            "id": self.full_name,
            "state": "FULL" if self.running >= self.config.hard_concurrency_limit else "CAN_RUN",
            "runningQueries": self.running,
            "queuedQueries": len(self.queue),
            "hardConcurrencyLimit": self.config.hard_concurrency_limit,
            "maxQueued": self.config.max_queued,
            "schedulingPolicy": self.config.scheduling_policy,
            "totalAdmitted": self.total_admitted,
            "totalQueuedTimeMs": int(self.total_queued_time * 1000),
            "subGroups": [c.info() for c in self.children.values()],
        }


class ResourceGroupManager:
    """Selector resolution + blocking admission (InternalResourceGroupManager).

    ``configure(root_groups, selectors)`` mirrors resource_groups.json.
    Without configuration, a permissive default group applies.
    """

    def __init__(self, max_wait_seconds: float = 60.0):
        self._lock = threading.Lock()
        self.roots: dict[str, ResourceGroup] = {}
        self.selectors: list[Selector] = []
        self.max_wait_seconds = max_wait_seconds
        # Deterministic expiry: a one-shot daemon timer armed for the
        # earliest callback-waiter deadline, so queue-timeout rejection
        # fires on time even when no other query finishes.
        self._reap_timer: Optional[threading.Timer] = None
        self._reap_at = float("inf")
        # the torch device whose free memory gates a waiter's peak hint
        # (the server sets its engine's); None admits
        self.device = None
        self.configure(
            [GroupConfig("global", max_queued=1000, hard_concurrency_limit=100)],
            [Selector(group="global")],
        )

    def configure(self, root_groups: list[GroupConfig], selectors: list[Selector]):
        with self._lock:
            self.roots = {
                g.name: ResourceGroup(g, None, self._lock) for g in root_groups
            }
            self.selectors = list(selectors)

    @classmethod
    def from_config(cls, config: dict) -> "ResourceGroupManager":
        """Build from the JSON shape of resource_groups.json."""

        def group(d: dict) -> GroupConfig:
            return GroupConfig(
                name=d["name"],
                max_queued=d.get("maxQueued", 100),
                hard_concurrency_limit=d.get("hardConcurrencyLimit", 10),
                scheduling_weight=d.get("schedulingWeight", 1),
                scheduling_policy=d.get("schedulingPolicy", "fair"),
                subgroups=[group(s) for s in d.get("subGroups", [])],
            )

        mgr = cls()
        mgr.configure(
            [group(g) for g in config.get("rootGroups", [])],
            [
                Selector(
                    group=s["group"],
                    user_pattern=s.get("user"),
                    source_pattern=s.get("source"),
                )
                for s in config.get("selectors", [])
            ],
        )
        return mgr

    # --- resolution -------------------------------------------------------

    def _resolve(self, user: str, source: str) -> ResourceGroup:
        for sel in self.selectors:
            if sel.matches(user, source):
                path = sel.resolve(user).split(".")
                with self._lock:
                    g = self.roots.get(path[0])
                    if g is None:
                        continue
                    for part in path[1:]:
                        if part not in g.children:
                            # dynamic per-user subgroup (template expansion)
                            g.children[part] = ResourceGroup(
                                GroupConfig(
                                    part,
                                    max_queued=g.config.max_queued,
                                    hard_concurrency_limit=g.config.hard_concurrency_limit,
                                ),
                                g,
                                self._lock,
                                dynamic=True,
                            )
                        g = g.children[part]
                    return g
        raise QueryQueueFullError("no resource group matches this query")

    # --- admission --------------------------------------------------------

    def admit(self, user: str, source: str = "") -> ResourceGroup:
        """Blocks until a slot is available. Raises when the queue is full
        or the wait times out. (Thread-parking path; ``submit()`` is the
        event-driven equivalent.)"""
        from trino_tpu_torch.server.eventloop import assert_not_loop_thread

        assert_not_loop_thread("ResourceGroupManager.admit")
        group = self._resolve(user, source)
        now = time.monotonic()
        with self._lock:
            if group._can_run_locked() and not group.queue:
                group._start_locked()
                self._publish_locked()
                return group
            if len(group.queue) >= group.config.max_queued:
                raise QueryQueueFullError(
                    f"Too many queued queries for '{group.full_name}'"
                )
            waiter = _Waiter(
                group, now, now + self.max_wait_seconds,
                event=threading.Event(),
            )
            group.queue.append(waiter)
            self._publish_locked()
        if not waiter.event.wait(self.max_wait_seconds):
            with self._lock:
                if waiter.admitted:
                    return group  # admitted concurrently with the timeout
                group.queue.remove(waiter)
                self._publish_locked()
            raise QueryQueueFullError(
                f"Query exceeded maximum queue wait for '{group.full_name}'"
            )
        return group

    def submit(
        self,
        user: str,
        source: str = "",
        ready: Optional[
            Callable[[ResourceGroup, Optional[Exception]], None]
        ] = None,
        peak_hbm_hint: int = 0,
    ) -> tuple[ResourceGroup, bool]:
        """Event-driven admission: never parks the calling thread.

        Returns ``(group, True)`` when a slot was free, else enqueues a
        callback waiter and returns ``(group, False)``;
        ``ready(group, None)`` fires once a slot frees, or
        ``ready(group, QueryQueueFullError)`` when the queue wait
        expires. Callbacks run outside the manager lock (on whichever
        thread released the slot). Raises immediately when the queue is
        full or no selector matches. ``peak_hbm_hint`` (observed bytes
        from the query-history store) additionally gates admission on
        live device headroom: a query known to need more HBM than is
        currently free queues instead of failing at compile.
        """
        group = self._resolve(user, source)
        now = time.monotonic()
        timed_out: list[_Waiter] = []
        err: Optional[QueryQueueFullError] = None
        admitted = False
        with self._lock:
            self._collect_expired_locked(timed_out)
            if (
                group._can_run_locked()
                and not group.queue
                and self._hbm_fits(peak_hbm_hint)
            ):
                group._start_locked()
                admitted = True
            elif len(group.queue) >= group.config.max_queued:
                err = QueryQueueFullError(
                    f"Too many queued queries for '{group.full_name}'"
                )
            else:
                group.queue.append(_Waiter(
                    group, now, now + self.max_wait_seconds, callback=ready,
                    peak_hbm_hint=peak_hbm_hint,
                ))
                self._schedule_reap_locked()
            self._publish_locked()
        self._fire_timeouts(timed_out)
        if err is not None:
            raise err
        return group, admitted

    def finish(self, group: ResourceGroup) -> None:
        fired: list[_Waiter] = []
        timed_out: list[_Waiter] = []
        with self._lock:
            group._finish_locked()
            self._collect_expired_locked(timed_out)
            self._wake_next_locked(group, fired)
            self._evict_idle_dynamic_locked(group)
            self._publish_locked()
        for w in fired:
            try:
                w.callback(w.group, None)
            except Exception:  # noqa: BLE001 — a bad callback must not
                pass  # strand other finishers
        self._fire_timeouts(timed_out)

    def abandon(
        self,
        group: ResourceGroup,
        callback: Callable[[ResourceGroup, Optional[Exception]], None],
    ) -> bool:
        """Remove a not-yet-admitted callback waiter (client abandoned the
        query before it got a slot). Returns True if a waiter was removed;
        False means it was already admitted, expired, or never queued."""
        with self._lock:
            for w in list(group.queue):
                if w.callback is callback and not w.admitted:
                    group.queue.remove(w)
                    self._publish_locked()
                    return True
        return False

    def _schedule_reap_locked(self) -> None:
        """Arm (or re-arm) the expiry timer for the earliest callback-waiter
        deadline. Caller holds the manager lock."""
        earliest = float("inf")

        def walk(g: ResourceGroup) -> None:
            nonlocal earliest
            for w in g.queue:
                if w.callback is not None and w.deadline < earliest:
                    earliest = w.deadline
            for c in g.children.values():
                walk(c)

        for root in self.roots.values():
            walk(root)
        if earliest == float("inf"):
            return
        if self._reap_timer is not None and self._reap_at <= earliest + 1e-3:
            return  # already armed early enough
        if self._reap_timer is not None:
            self._reap_timer.cancel()
        delay = max(0.0, earliest - time.monotonic()) + 0.005
        timer = threading.Timer(delay, self._reap_now)
        timer.daemon = True
        timer.start()
        self._reap_timer = timer
        self._reap_at = earliest

    def _reap_now(self) -> None:
        timed_out: list[_Waiter] = []
        with self._lock:
            self._reap_timer = None
            self._reap_at = float("inf")
            self._collect_expired_locked(timed_out)
            self._schedule_reap_locked()
            self._publish_locked()
        self._fire_timeouts(timed_out)

    def _collect_expired_locked(self, out: list) -> None:
        """Remove callback waiters whose deadline passed. The armed reap
        timer (``_schedule_reap_locked``) makes expiry deterministic;
        submit/finish activity still reaps opportunistically so a stale
        timer is never load-bearing. Event waiters time themselves out —
        their parked thread owns removal."""
        now = time.monotonic()

        def walk(g: ResourceGroup) -> None:
            for w in [w for w in g.queue
                      if w.callback is not None and now > w.deadline]:
                g.queue.remove(w)
                out.append(w)
            for c in list(g.children.values()):
                walk(c)

        for root in self.roots.values():
            walk(root)

    def _fire_timeouts(self, waiters: list) -> None:
        for w in waiters:
            try:
                w.callback(w.group, QueryQueueFullError(
                    "Query exceeded maximum queue wait for "
                    f"'{w.group.full_name}'"
                ))
            except Exception:  # noqa: BLE001
                pass

    # --- observability ----------------------------------------------------

    def _publish_locked(self) -> None:
        """Queue-depth and running gauges per group on /v1/metrics."""
        from trino_tpu_torch.obs.metrics import get_registry

        reg = get_registry()

        def walk(g: ResourceGroup) -> None:
            reg.gauge(
                "trino_tpu_resource_group_queued", group=g.full_name
            ).set(len(g.queue))
            reg.gauge(
                "trino_tpu_resource_group_running", group=g.full_name
            ).set(g.running)
            for c in g.children.values():
                walk(c)

        for root in self.roots.values():
            walk(root)

    def summary(self) -> dict:
        """Flat ``{group: {queuedQueries, runningQueries}}`` snapshot —
        the ``system.runtime.queries``-style admission breakdown."""
        out: dict[str, dict] = {}
        with self._lock:

            def walk(g: ResourceGroup) -> None:
                out[g.full_name] = {
                    "queuedQueries": len(g.queue),
                    "runningQueries": g.running,
                }
                for c in g.children.values():
                    walk(c)

            for root in self.roots.values():
                walk(root)
        return out

    def _evict_idle_dynamic_locked(self, group: ResourceGroup) -> None:
        """Drop idle ${USER}-template subgroups so distinct users don't
        grow the tree without bound (reference: disabled-group eviction)."""
        g: Optional[ResourceGroup] = group
        while g is not None and g.parent is not None:
            if g.dynamic and g.running == 0 and not g.queue and not g.children:
                g.parent.children.pop(g.config.name, None)
            g = g.parent

    def _wake_next_locked(
        self, group: ResourceGroup, fired: list
    ) -> None:
        """Wake queued queries anywhere in the hierarchy that can now run.
        fair/fifo: FIFO within a group; weighted_fair: highest
        weight/(running+1) subgroup first (WeightedFairQueue analog)."""
        self._wake_in_subtree_locked(self._root_of(group), fired)

    def _root_of(self, g: ResourceGroup) -> ResourceGroup:
        while g.parent is not None:
            g = g.parent
        return g

    def _wake_in_subtree_locked(
        self, g: ResourceGroup, fired: list
    ) -> None:
        while True:
            picked = self._pick_candidate_locked(g)
            if picked is None:
                return
            candidate, w = picked
            candidate.queue.remove(w)
            candidate._start_locked()
            w.admitted = True
            waited = time.monotonic() - w.enq_mono
            candidate.total_queued_time += waited
            self._observe_wait(candidate, waited)
            if w.event is not None:
                w.event.set()
            else:
                fired.append(w)  # callback: invoked by finish(), unlocked

    def _observe_wait(self, group: ResourceGroup, waited_s: float) -> None:
        from trino_tpu_torch.obs.metrics import get_registry

        get_registry().histogram(
            "trino_tpu_resource_group_queue_wait_ms", group=group.full_name
        ).observe(waited_s * 1000.0)

    def _pick_candidate_locked(
        self, g: ResourceGroup
    ) -> Optional[tuple[ResourceGroup, _Waiter]]:
        """(group, waiter) next in line, honoring HBM hints: within a
        group, the first FIFO waiter whose observed peak-HBM fits current
        device headroom wins — an over-headroom waiter is skipped over
        (never head-of-line blocking) and retried on the next wake; if it
        never fits, the queue-wait expiry reaps it."""
        if not g._can_run_locked():
            return None
        for w in g.queue:
            if self._hbm_fits(w.peak_hbm_hint):
                return g, w
        kids = [c for c in g.children.values() if c._queued_count_locked() > 0]
        if not kids:
            return None
        if g.config.scheduling_policy == "weighted_fair":
            kids.sort(
                key=lambda c: -(c.config.scheduling_weight / (c.running + 1))
            )
        for c in kids:
            found = self._pick_candidate_locked(c)
            if found is not None:
                return found
        return None

    def _hbm_fits(self, peak_hbm_hint: int) -> bool:
        """Does a query with this observed peak footprint fit the device's
        CURRENT free memory (within 90% of the card, as the reference's
        ``hbm_headroom_ok``)? The hint is the fingerprint's observed peak
        from the history store (``querymanager._history_hbm_gate``). Hint
        0 (no history), no device, and a device without memory
        accounting (the CPU) always admit."""
        if not peak_hbm_hint or self.device is None:
            return True
        try:
            import torch

            device = torch.device(self.device)
            if device.type != "cuda":
                return True
            free, total = torch.cuda.mem_get_info(device)
            return (total - free) + int(peak_hbm_hint) <= 0.9 * total
        except Exception:  # noqa: BLE001 — accounting must never wedge
            return True

    def info(self) -> list[dict]:
        with self._lock:
            return [g.info() for g in self.roots.values()]
