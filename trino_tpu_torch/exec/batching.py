"""Cross-query device batching (continuous batching for SQL).

Reference: continuous batching in inference serving (Orca, vLLM) applied
to the program cache. Queries whose plans canonicalize to the same
fingerprint differ only in their hoisted-literal parameter vectors, so K
of them can share one dispatch through the cached (optionally fused)
programs: here K replays of each program's CUDA graph, back to back,
with one host read for the group (``FragmentedExecutor.execute_batched``),
instead of K host round trips.

The :class:`BatchCollector` holds compatible pending queries for a short
window (``batch_window_ms`` session property, flushed early at
``batch_max_size``). The first arrival for a group becomes the *leader*:
it waits out the window on the calling thread, then executes the whole
group while followers block on per-member events. Compatibility =
same program-cache entry (fingerprint + data versions + ACL generation)
AND the same session-property signature — a member with, say, a
different ``batch_capacity`` would trace a different program and must
not share the dispatch.

Correctness contract: a batched run is bit-identical to K sequential
runs (each member replays the same program with its own parameters). Any shape the batched path
cannot carry raises ``BatchUnsupported`` and the group falls back to
sequential per-member execution; a member that fails there fails alone
without poisoning its batchmates.

A copy of ``trino_tpu/exec/batching.py``. The resource-group admission
in front of it is the server's (``server/querymanager.py``); the dispatch
counts by batch size go to the metrics registry
(``trino_tpu_batched_dispatches_total{size}``) and are kept on the
collector too (``dispatches``); each member of a batch of two or more
gets a ``batched_dispatch`` span on its own trace.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

__all__ = ["BatchCollector"]


@dataclasses.dataclass
class _Member:
    """One pending query waiting for its group's dispatch."""

    query_id: str
    session: Any  # this member's own Session (identical signature)
    params: list  # hoisted (value, type) literals for this member
    enq_mono: float  # monotonic enqueue time (batchWaitMs)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    result: Any = None
    error: Optional[BaseException] = None


class _Group:
    """A collecting batch: one leader thread + joined followers."""

    __slots__ = ("entry", "plan", "members", "closed", "full")

    def __init__(self, entry: dict, plan) -> None:
        self.entry = entry  # strong ref: pins id(entry) against reuse
        self.plan = plan  # leader's exec plan (first cached wins)
        self.members: list[_Member] = []
        self.closed = False  # no further joins once set (under lock)
        self.full = threading.Event()  # set at batch_max_size


def _session_signature(session) -> tuple:
    """Hashable view of the session overrides.

    The canonical fingerprint already folds in codegen-relevant
    properties, but non-codegen overrides (capacities, retry policy,
    spill knobs…) still shape execution — only sessions with IDENTICAL
    overrides may share a dispatch.
    """
    return tuple(
        sorted((k, repr(v)) for k, v in session.properties.items())
    )


class BatchCollector:
    """Groups compatible in-flight queries into stacked dispatches."""

    def __init__(self, engine) -> None:
        self._engine = engine
        self._lock = threading.Lock()
        self._groups: dict[tuple, _Group] = {}
        # dispatches by batch size (the reference's
        # trino_tpu_batched_dispatches_total{size})
        self.dispatches: dict[int, int] = {}

    # --- admission --------------------------------------------------------

    def submit(self, entry, plan, session, params, query_id):
        """Join (or open) the batch for this program-cache entry; blocks
        until this member's result is ready. Called on the query's own
        dispatch thread from ``Engine._dispatch_parsed``."""
        window_ms = int(session.get("batch_window_ms"))
        max_size = max(1, int(session.get("batch_max_size")))
        member = _Member(query_id, session, list(params), time.monotonic())
        key = (id(entry), _session_signature(session))
        with self._lock:
            group = self._groups.get(key)
            if group is not None and not group.closed:
                group.members.append(member)
                if len(group.members) >= max_size:
                    group.closed = True
                    del self._groups[key]
                    group.full.set()
                group = None  # follower: just wait below
                leader = False
            else:
                group = _Group(entry, plan)
                group.members.append(member)
                if max_size <= 1:
                    group.closed = True  # degenerate: never collects
                else:
                    self._groups[key] = group
                leader = True
        if leader:
            if not group.closed:
                # hold the window open; a size-triggered flush wakes us
                # early (deterministic for tests: max_size members ==
                # immediate dispatch, no timing dependence)
                group.full.wait(window_ms / 1000.0)
                with self._lock:
                    if not group.closed:
                        group.closed = True
                        if self._groups.get(key) is group:
                            del self._groups[key]
            self._run_group(group)
        member.done.wait()
        if member.error is not None:
            raise member.error
        return member.result

    # --- execution (leader thread only) -----------------------------------

    def _run_group(self, group: _Group) -> None:
        engine = self._engine
        entry = group.entry
        members = group.members
        k = len(members)
        exec_start = time.monotonic()
        try:
            # same discipline as the single-query path: the entry lock
            # serializes executors over the shared program store and
            # capacity objects. Blocking here is fine — followers are
            # parked on their events, not on this lock, and unrelated
            # programs use different entries. Moving execution outside
            # the lock would let a second leader re-collect the same
            # window.
            with entry["lock"]:
                if entry["plan"] is None:
                    entry["plan"] = group.plan
                plan = entry["plan"]
                programs = entry["programs"]
                if k == 1:
                    m = members[0]
                    try:
                        m.result = engine._execute_query_plan(
                            plan, m.session, query_id=m.query_id,
                            programs=programs, params=m.params,
                        )
                    except BaseException as e:  # noqa: BLE001
                        m.error = e
                elif not members[0].params:
                    # no hoisted literals: the K members are the SAME
                    # query — run once, replicate the result
                    self._run_replicated(plan, programs, members, exec_start)
                else:
                    self._run_batched(plan, programs, members, exec_start)
        except BaseException as e:  # noqa: BLE001 — never strand a member
            for m in members:
                if m.result is None and m.error is None:
                    m.error = e
        finally:
            dur_ms = (time.monotonic() - exec_start) * 1000.0
            self._observe(members, dur_ms)
            for m in members:
                m.done.set()

    def _run_replicated(self, plan, programs, members, exec_start) -> None:
        leader = members[0]
        try:
            res = self._engine._execute_query_plan(
                plan, leader.session, query_id=leader.query_id,
                programs=programs, params=leader.params,
            )
        except BaseException as e:  # noqa: BLE001
            # identical queries: the failure IS each member's failure
            for m in members:
                m.error = e
            return
        stats = self._batch_stats(members, exec_start)
        for m, bs in zip(members, stats):
            m.result = dataclasses.replace(res, batch_stats=bs)

    def _run_batched(self, plan, programs, members, exec_start) -> None:
        engine = self._engine
        try:
            results = engine._execute_query_plan_batched(
                plan,
                members[0].session,
                [m.query_id for m in members],
                [m.params for m in members],
                programs=programs,
            )
        except Exception:  # noqa: BLE001 — BatchUnsupported, capacity, …
            # fall back to K sequential runs; a failing member fails
            # alone without poisoning its batchmates
            for m in members:
                try:
                    m.result = engine._execute_query_plan(
                        plan, m.session, query_id=m.query_id,
                        programs=programs, params=m.params,
                    )
                except BaseException as e:  # noqa: BLE001
                    m.error = e
            return
        stats = self._batch_stats(members, exec_start)
        for m, res, bs in zip(members, results, stats):
            m.result = dataclasses.replace(res, batch_stats=bs)

    # --- surfacing --------------------------------------------------------

    def _batch_stats(self, members, exec_start) -> list[dict]:
        # wait = enqueue → dispatch start, NOT including execution: this
        # is the latency the window itself cost the member
        k = len(members)
        return [
            {
                "batchedQueries": k,
                "batchSize": k,
                "batchWaitMs": round((exec_start - m.enq_mono) * 1000.0, 1),
            }
            for m in members
        ]

    def _observe(self, members, dur_ms: float) -> None:
        k = len(members)
        # size-1 groups count too: the mean batch size keeps solo
        # dispatches in its denominator
        with self._lock:
            self.dispatches[k] = self.dispatches.get(k, 0) + 1
        from trino_tpu_torch.obs.metrics import get_registry
        from trino_tpu_torch.obs.trace import get_tracer

        get_registry().counter("trino_tpu_batched_dispatches_total", size=str(k)).inc()
        if k < 2:
            return
        tracer = get_tracer()
        leader_qid = members[0].query_id
        for m in members:
            # one span a member on its own trace: the waterfall shows
            # which queries shared the dispatch
            tracer.record(
                "batched_dispatch", dur_ms,
                attrs={"batchSize": k, "batchLeader": leader_qid},
                trace_id=m.query_id,
            )
