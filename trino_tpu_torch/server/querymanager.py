"""Query management: dispatch, lifecycle, results buffering.

Reference: ``dispatcher/DispatchManager.java:61,148`` (createQuery →
queue → execute), ``execution/SqlQueryManager`` (registry/limits),
``execution/QueryStateMachine.java`` (lifecycle + stats), and
``server/protocol/Query.java:117`` (paged result serving).

Observability: each ManagedQuery owns the query's root span (trace id =
query id) and fires QueryCreated/QueryCompleted events exactly once per
query across EVERY terminal path — normal completion, failure,
client cancel, coordinator kill (CLUSTER_OUT_OF_MEMORY), and
resource-group rejection. Interval math uses ``time.monotonic()``;
epoch timestamps survive only in display fields (createTime/endTime).

A copy of ``trino_tpu/server/querymanager.py``: with the flight journal
(``obs/flight.py``) of each query's lifecycle, the result cache's fast
path ahead of admission, and the history store's admission gate, which
hands a fingerprint's observed peak device bytes to the resource groups'
memory gate (``server/resourcegroups.py``, ``torch.cuda.mem_get_info``).
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import json
import secrets
import threading
import time
import traceback
from typing import Any, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.config import Session
from trino_tpu_torch.engine import Engine, StatementResult
from trino_tpu_torch.obs.trace import get_tracer
from trino_tpu_torch.server.statemachine import (
    QueryState,
    StateMachine,
    new_query_state_machine,
)

_query_counter = itertools.count(1)


def _new_query_id() -> str:
    # reference format: yyyyMMdd_HHmmss_index_coord (QueryIdGenerator)
    ts = time.strftime("%Y%m%d_%H%M%S")
    return f"{ts}_{next(_query_counter):05d}_trino_tpu"


@dataclasses.dataclass
class ErrorInfo:
    """Reference: ``client/.../QueryError.java`` shape."""

    message: str
    error_code: int = 1
    error_name: str = "GENERIC_INTERNAL_ERROR"
    error_type: str = "INTERNAL_ERROR"
    stack: str = ""
    # ft classification: would a retry (different worker / fresh attempt)
    # plausibly succeed? Drives QUERY retry and is surfaced to clients.
    retryable: bool = False

    def to_json(self) -> dict:
        return {
            "message": self.message,
            "errorCode": self.error_code,
            "errorName": self.error_name,
            "errorType": self.error_type,
            "retryable": self.retryable,
            "failureInfo": {"type": self.error_name, "message": self.message,
                            "stack": self.stack.splitlines()},
        }


class ManagedQuery:
    """One query's full lifecycle + buffered results."""

    def __init__(self, sql: str, session: Session, engine: Optional[Engine] = None):
        self.query_id = _new_query_id()
        self.slug = "x" + secrets.token_hex(8)
        self.sql = sql
        self.session = session
        self.state = new_query_state_machine(self.query_id)
        self.result: Optional[StatementResult] = None
        self.error: Optional[ErrorInfo] = None
        self.create_time = time.time()  # epoch: createTime display only
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self._create_mono = time.monotonic()
        self._start_mono_ts: Optional[float] = None
        self._end_mono: Optional[float] = None
        self.last_access = time.monotonic()  # protocol touch; guards history GC
        self._cancelled = threading.Event()
        # set by QueryManager while this query waits un-admitted in a
        # resource-group queue; cancel() invokes it to free the queue slot
        self._admission_abandon: Optional[Any] = None
        # lazy byte-budgeted pager over result.rows (streaming protocol)
        self._pager: Optional["ResultPager"] = None
        self._pager_lock = threading.Lock()
        self.query_attempts = 1  # >1 under retry_policy=QUERY
        self._engine = engine
        self._completed_fired = False
        self._completed_lock = threading.Lock()
        # root span for the whole query (covers queued time); the dispatch
        # thread re-activates it so engine/scheduler spans nest under it
        self.span = get_tracer().start_span(
            "query",
            trace_id=self.query_id,
            attrs={"queryId": self.query_id, "user": session.user},
        )
        # flight recorder (obs/flight.py): crash-safe lifecycle journal.
        # None when flight_dir is unset; every _flight_event() call is
        # non-blocking (a queue put), so cancel() and admission callbacks
        # may journal from loop threads
        from trino_tpu_torch.obs import flight as _flight_mod

        self._flight = _flight_mod.for_session(session)
        self._flight_event(
            "created", query=sql, user=session.user,
            source=getattr(session, "source", None),
        )

    def _flight_event(self, event: str, **payload: Any) -> None:
        if self._flight is not None:
            self._flight.record(self.query_id, event, payload)

    def touch(self) -> None:
        self.last_access = time.monotonic()

    # --- lifecycle --------------------------------------------------------

    def run(self, engine: Engine, release=None) -> None:
        """Execute. ``release`` (the admission-slot release hook) is
        invoked once engine work is done but BEFORE the terminal state
        transition fires client-visible listeners — otherwise a client
        can observe its query complete while the slot still reads as
        running (the caller's finally still covers every early exit)."""
        from trino_tpu_torch.ft.retry import Backoff, RetryPolicy, is_retryable

        if self._cancelled.is_set():
            return
        self.start_time = time.time()
        self._start_mono_ts = time.monotonic()  # queuedMs interval math
        self.state.set(QueryState.PLANNING)
        # retry_policy=QUERY: the whole statement re-runs on a fresh
        # attempt salt (fault_attempt_salt keys the injector's draws, so a
        # deterministic chaos run does not replay the exact same faults on
        # attempt 2). Reference: Trino's QUERY retry policy.
        policy = RetryPolicy.from_session(self.session)
        if policy == RetryPolicy.QUERY:
            try:
                max_attempts = max(1, int(self.session.get("query_retry_attempts")))
            except KeyError:
                max_attempts = 3
        else:
            max_attempts = 1
        backoff = Backoff.from_session(self.session)
        tracer = get_tracer()
        try:
            if self._cancelled.is_set():
                return
            self.state.set(QueryState.RUNNING)
            self._flight_event(
                "running",
                queuedMs=int((self._start_mono_ts - self._create_mono) * 1000),
                maxAttempts=max_attempts,
            )
            attempt = 1
            with tracer.activate(self.span):
                while True:
                    try:
                        if attempt > 1:
                            self.session.properties["fault_attempt_salt"] = attempt
                        self.result = self._call_engine(engine)
                        break
                    except Exception as e:  # noqa: BLE001
                        if (
                            attempt >= max_attempts
                            or self._cancelled.is_set()
                            or not is_retryable(e)
                        ):
                            raise
                        self._flight_event(
                            "retry", attempt=attempt + 1,
                            error=str(e), errorClass=type(e).__name__,
                        )
                        time.sleep(backoff.delay(attempt))
                        attempt += 1
                        self.query_attempts = attempt
            if release is not None:
                release()
            self.state.set(QueryState.FINISHING)
            self.state.set(QueryState.FINISHED)
        except Exception as e:  # noqa: BLE001 — any failure fails the query
            from trino_tpu_torch.errors import classify_error
            from trino_tpu_torch.ft.retry import is_retryable

            code, name, typ = classify_error(e)
            if not (self._cancelled.is_set() and self.state.is_terminal()):
                # a kill or cancel ended the query and wrote its error;
                # the engine call that its cancelled tasks unwound keeps it
                self.error = ErrorInfo(
                    str(e), code, name, typ, traceback.format_exc(),
                    retryable=is_retryable(e),
                )
            if release is not None:
                release()
            self.state.set(QueryState.FAILED)
        finally:
            self.end_time = time.time()
            self._end_mono = time.monotonic()
            self._fire_completed(engine)

    def _call_engine(self, engine: Engine) -> StatementResult:
        """Invoke the engine, pinning this query's id and taking event
        ownership when the engine supports it (test doubles may not)."""
        try:
            params = inspect.signature(engine.execute_statement).parameters
            extended = "fire_events" in params
        except (TypeError, ValueError):  # builtins / exotic callables
            extended = False
        if extended:
            return engine.execute_statement(
                self.sql, self.session,
                query_id=self.query_id, fire_events=False,
            )
        return engine.execute_statement(self.sql, self.session)

    def _fire_completed(self, engine: Optional[Engine] = None) -> None:
        """Fire QueryCompletedEvent exactly once, on whichever terminal
        path got here first, and close the root span."""
        with self._completed_lock:
            if self._completed_fired:
                return
            self._completed_fired = True
        st = self.state.get()
        end = self.end_time or time.time()
        wall = (self._end_mono or time.monotonic()) - self._create_mono
        self.span.finish(
            status="OK" if st == QueryState.FINISHED else "ERROR",
            state=st.value,
        )
        self._flight_completed(st, wall)
        eng = engine or self._engine
        listeners = getattr(eng, "event_listeners", None)
        if listeners is None:
            return
        from trino_tpu_torch.events import QueryCompletedEvent

        listeners.fire_completed(
            QueryCompletedEvent(
                self.query_id, self.sql, self.session.user,
                self.create_time, end, st.value,
                output_rows=len(self.result.rows) if self.result else 0,
                peak_memory_bytes=(
                    self.result.peak_memory_bytes if self.result else 0
                ),
                error_message=self.error.message if self.error else None,
                wall_seconds=wall,
                error_code=self.error.error_code if self.error else None,
                error_type=self.error.error_type if self.error else None,
            )
        )

    def _flight_completed(self, st: "QueryState", wall_s: float) -> None:
        """Journal the terminal post-mortem record: enough that the flight
        journal alone explains how the query ended — state, error
        classification, retry accounting, queryStats, operatorStats, and
        the span tree (when a sink retained it)."""
        if self._flight is None:
            return
        cluster_stats = self.result.cluster_stats if self.result else {}
        elapsed = (self._end_mono or time.monotonic()) - self._create_mono
        err = self.error.to_json() if self.error else None
        if err is not None:
            # classification only: the full stack would bloat the bounded
            # journal without aiding post-mortem triage
            err.pop("failureInfo", None)
        spans = None
        try:
            for sink in getattr(get_tracer(), "_sinks", []):
                spans_for = getattr(sink, "spans_for", None)
                if spans_for is not None:
                    spans = spans_for(self.query_id)
                    break
        except Exception:  # noqa: BLE001
            spans = None
        self._flight_event(
            "completed",
            state=st.value,
            wallMs=int(wall_s * 1000),
            queryAttempts=self.query_attempts,
            taskRetries=cluster_stats.get("task_retries", 0),
            recoveredTasks=cluster_stats.get("recovered_tasks", 0),
            recoveredTaskLevels=cluster_stats.get("recovered_levels", {}),
            spooledBytes=cluster_stats.get("spooled_bytes", 0),
            queryStats=self._query_stats(elapsed, cluster_stats),
            operatorStats=(
                getattr(self.result, "operator_stats", None)
                if self.result else None
            ),
            error=err,
            spans=spans,
        )

    def _cancel_tasks(self) -> None:
        """Cancel the query's worker tasks through the engine's cluster
        scheduler, on a thread of its own: each task's ``DELETE`` is an
        HTTP call, and a kill comes from the announce handler. Without a
        cluster scheduler the query has no remote task."""
        scheduler = getattr(self._engine, "cluster_scheduler", None)
        if scheduler is None:
            return
        threading.Thread(
            target=scheduler.cancel_query, args=(self.query_id,),
            name=f"cancel-tasks-{self.query_id}", daemon=True,
        ).start()

    def cancel(self, message: str = "Query was canceled") -> None:
        self._cancelled.set()
        self._cancel_tasks()
        abandon = self._admission_abandon
        if abandon is not None:
            self._admission_abandon = None
            try:
                abandon()  # free the un-admitted resource-group queue slot
            except Exception:  # noqa: BLE001
                pass
        if self.state.set(QueryState.CANCELED):
            self._flight_event("canceled", message=message)
            self.error = ErrorInfo(message, 1, "USER_CANCELED", "USER_ERROR")
            self.end_time = time.time()
            self._end_mono = time.monotonic()
            self._fire_completed()

    def result_pager(
        self, page_max_bytes: int, max_rows_per_page: int = 4096
    ) -> Optional["ResultPager"]:
        """The query's streaming pager (created lazily, one per query).
        Returns None until the result materializes."""
        if self.result is None:
            return None
        with self._pager_lock:
            if self._pager is None:
                self._pager = ResultPager(
                    self.result.rows, page_max_bytes, max_rows_per_page
                )
            return self._pager

    def kill(self, message: str) -> bool:
        """Administrative kill (cluster memory manager): FAILED with
        CLUSTER_OUT_OF_MEMORY, not user-canceled (reference:
        ``ClusterMemoryManager.java:104`` killQuery). The query's worker
        tasks are cancelled with it."""
        self._cancelled.set()
        self._cancel_tasks()
        if self.state.set(QueryState.FAILED):
            self._flight_event("killed", message=message)
            self.error = ErrorInfo(
                message, 131081, "CLUSTER_OUT_OF_MEMORY",
                "INSUFFICIENT_RESOURCES",
            )
            self.end_time = time.time()
            self._end_mono = time.monotonic()
            self._fire_completed()
            return True
        return False

    # --- info -------------------------------------------------------------

    def info(self) -> dict:
        st = self.state.get()
        elapsed = (self._end_mono or time.monotonic()) - self._create_mono
        cluster_stats = self.result.cluster_stats if self.result else {}
        return {
            "queryId": self.query_id,
            "state": st.value,
            "query": self.sql,
            "user": self.session.user,
            "elapsedTimeMillis": int(elapsed * 1000),
            "createTime": self.create_time,
            "endTime": self.end_time,
            "peakMemoryBytes": self.result.peak_memory_bytes if self.result else 0,
            "updateType": self.result.update_type if self.result else None,
            # ft counters (trino_tpu/ft): retry policy + attempt accounting
            "retryPolicy": cluster_stats.get(
                "retry_policy",
                self.session.properties.get("retry_policy", "NONE"),
            ),
            "queryAttempts": self.query_attempts,
            "taskRetries": cluster_stats.get("task_retries", 0),
            "taskAttempts": cluster_stats.get("task_attempts", {}),
            # hedged execution: duplicates dispatched for detected
            # stragglers, and how many of them finished first
            "speculativeAttempts": cluster_stats.get("speculative_attempts", 0),
            "speculativeWins": cluster_stats.get("speculative_wins", 0),
            # spooled-exchange recovery (trino_tpu/exchange/spool.py):
            # tasks healed after producer death, by tier (task = spool
            # re-point, lineage = producer re-execution, fused = a whole
            # fused unit re-executed atomically). With worker_execution=
            # fused these ride alongside exchangeStats.fusedFragments:
            # spooledBytes counts unit-boundary pages, recoveredTasks
            # counts healed units — fusion and recovery coexist
            "recoveredTasks": cluster_stats.get("recovered_tasks", 0),
            "recoveredTaskLevels": cluster_stats.get("recovered_levels", {}),
            "spooledBytes": cluster_stats.get("spooled_bytes", 0),
            # per-stage rollup (obs): elapsed + sibling task elapsed
            # p50/p99 — the speculative-execution straggler signal
            "queryStats": self._query_stats(elapsed, cluster_stats),
            # skew-aware exchange counters (shuffle rows/bytes, padding
            # ratio, overflow retries, hot/salted keys, capacity provenance)
            "exchangeStats": self.result.exchange_stats if self.result else None,
            # in-program operator telemetry (exec/fragments.py op!
            # channel): per-site row flow, cluster-merged across workers
            "operatorStats": (
                getattr(self.result, "operator_stats", None)
                if self.result else None
            ),
            # columnar ingest tier (trino_tpu/ingest.py): split decode
            # wall, coalesced H2D bytes, device-table-cache hits/misses —
            # a warm repeat scan shows h2d_bytes == 0
            "ingestStats": self.result.ingest_stats if self.result else None,
            "resultCacheStats": (
                self.result.result_cache_stats if self.result else None
            ),
            # cross-query batching (exec/batching.py): which dispatch this
            # query shared and how long it waited; None when it ran alone
            "batchStats": (
                getattr(self.result, "batch_stats", None)
                if self.result else None
            ),
            # device profiler rollup (obs/profiler.py): per-program XLA
            # flops / peak HBM merged across workers, plus query totals
            "deviceStats": self.result.device_stats if self.result else None,
            # compile-time telemetry (cross-query program cache): a warm
            # run shows traceCount == 0 and programCacheHits > 0
            "compileMs": self.result.compile_ms if self.result else 0.0,
            "traceCount": self.result.trace_count if self.result else 0,
            "programCacheHits": (
                self.result.program_cache_hits if self.result else 0
            ),
            "programCacheMisses": (
                self.result.program_cache_misses if self.result else 0
            ),
            "error": self.error.to_json() if self.error else None,
        }

    def _query_stats(self, elapsed_s: float, cluster_stats: dict) -> dict:
        bs = (getattr(self.result, "batch_stats", None)
              if self.result else None) or {}
        ex = (getattr(self.result, "exchange_stats", None)
              if self.result else None) or {}
        rc = (getattr(self.result, "result_cache_stats", None)
              if self.result else None) or {}
        return {
            "elapsedMs": int(elapsed_s * 1000),
            "queuedMs": int(
                ((self._start_mono() or time.monotonic()) - self._create_mono)
                * 1000
            ),
            # cross-query batching: 0/1/absent-wait when the query ran alone
            "batchedQueries": bs.get("batchedQueries", 0),
            "batchSize": bs.get("batchSize", 1),
            "batchWaitMs": bs.get("batchWaitMs", 0.0),
            # query history (obs/history.py): capacity sites seeded from
            # observed truth, and whether a prior run of this fingerprint
            # informed this one
            "historySeeds": ex.get("history_seeds", 0),
            "historyHits": ex.get("history_hits", 0),
            # semantic result cache (trino_tpu/cache): 1 when this query
            # was served from (or incrementally maintained in) the
            # coordinator result cache
            "resultCacheHit": rc.get("resultCacheHit", 0),
            "resultCacheMaintained": rc.get("incrementalMaintenance", 0),
            # SLO sentinel (obs/slo.py): the regression verdict the
            # engine attached at completion (None = within baseline or
            # sentinel off/cold)
            "regression": (
                getattr(self.result, "regression", None)
                if self.result else None
            ),
            "speculativeAttempts": cluster_stats.get("speculative_attempts", 0),
            "speculativeWins": cluster_stats.get("speculative_wins", 0),
            "recoveredTasks": cluster_stats.get("recovered_tasks", 0),
            "spooledBytes": cluster_stats.get("spooled_bytes", 0),
            "stages": cluster_stats.get("stages", []),
        }

    def _start_mono(self) -> Optional[float]:
        if self._start_mono_ts is not None:
            return self._start_mono_ts
        # legacy fallback (test doubles that set start_time directly):
        # approximate from the epoch delta, clamped non-negative — a
        # wall-clock step during the queue wait can skew this path only
        if self.start_time is None:
            return None
        return self._create_mono + max(0.0, self.start_time - self.create_time)


# json.dumps(row, default=str), without a new encoder for every row
_ROW_ENCODER = json.JSONEncoder(default=str)


class ResultPager:
    """Byte-budgeted page server over a query's result rows.

    Reference: ``server/protocol/Query.java`` (targetResultSize paging).
    Pages are cut on demand as the client polls ``nextUri`` — a page ends
    when its JSON-encoded size reaches ``page_max_bytes`` or
    ``max_rows_per_page`` rows, whichever first.  Serving token N acks
    (frees) every buffered page below N, so at most the in-flight page
    plus the just-produced one stay resident: producer backpressure is
    the client's own poll cadence.  Re-requesting the last un-acked token
    is idempotent (HTTP retry safety).
    """

    def __init__(
        self, rows, page_max_bytes: int, max_rows_per_page: int = 4096
    ):
        self._src = iter(rows)
        self._budget_bound = False  # a chunk reached the budget: row by row
        self.total_rows = len(rows)
        self._budget = max(1, int(page_max_bytes))
        self._max_rows = max(1, int(max_rows_per_page))
        self._pages: dict[int, list] = {}
        self._page_bytes: dict[int, int] = {}
        self._next = 0  # next token to produce
        self._exhausted = False
        self.pages_produced = 0
        self.buffered_bytes = 0
        self.peak_buffered_bytes = 0
        self._lock = threading.Lock()

    def page(self, token: int) -> tuple[Optional[list], bool]:
        """Rows for ``token`` (None when past the end) plus whether more
        pages may follow."""
        with self._lock:
            self._ack_below_locked(token)
            while token >= self._next and not self._exhausted:
                self._produce_locked()
            self._ack_below_locked(token)
            rows = self._pages.get(token)
            if rows is None:
                return None, False
            more = (token + 1 < self._next) or not self._exhausted
            return rows, more

    def _ack_below_locked(self, token: int) -> None:
        for t in [t for t in self._pages if t < token]:
            self.buffered_bytes -= self._page_bytes.pop(t)
            del self._pages[t]

    def _produce_locked(self) -> None:
        # a page's bytes: 2 brackets, and each row's JSON and 2 separator
        # bytes. Encoded as one list, a chunk of rows is that less 2: a
        # chunk of ``max_rows`` rows (or the source's last) under the
        # budget is the page the rows one by one would make. Once a chunk
        # reaches the budget, pages are cut row by row, as the reference
        # cuts every page
        if not self._budget_bound:
            rows = list(itertools.islice(self._src, self._max_rows))
            try:
                nbytes = len(_ROW_ENCODER.encode(rows)) + 2
            except (TypeError, ValueError):
                nbytes = self._budget
            if nbytes < self._budget:
                if len(rows) < self._max_rows:
                    self._exhausted = True
                if rows:
                    self._store_locked(rows, nbytes)
                return
            self._budget_bound = True
            self._src = itertools.chain(rows, self._src)
        rows = []
        nbytes = 2  # brackets
        for row in self._src:
            try:
                enc = len(_ROW_ENCODER.encode(row))
            except (TypeError, ValueError):
                enc = 64
            rows.append(row)
            nbytes += enc + 2
            if nbytes >= self._budget or len(rows) >= self._max_rows:
                break
        else:
            self._exhausted = True
        if rows:
            self._store_locked(rows, nbytes)

    def _store_locked(self, rows: list, nbytes: int) -> None:
        self._pages[self._next] = rows
        self._page_bytes[self._next] = nbytes
        self._next += 1
        self.pages_produced += 1
        self.buffered_bytes += nbytes
        self.peak_buffered_bytes = max(
            self.peak_buffered_bytes, self.buffered_bytes
        )


class _DispatchPool:
    """Bounded daemon-thread pool for ADMITTED queries.

    concurrent.futures.ThreadPoolExecutor keeps non-daemon workers that
    pin interpreter exit, so: lazily-spawned daemon threads parked on a
    queue, sentinel shutdown. Only admitted work lands here — admission
    waits live in the resource-group waiter queue, so queued queries
    cost a waiter object each, never a stack.
    """

    def __init__(self, max_workers: int, name: str = "dispatch"):
        import queue

        self._q: "queue.Queue" = queue.Queue()
        self._max = max(1, max_workers)
        self._name = name
        self._threads: list[threading.Thread] = []
        self._idle = 0
        self._unclaimed = 0  # submitted items no worker has taken yet
        self._lock = threading.Lock()
        self._shutdown = False

    def submit(self, fn, *args) -> None:
        with self._lock:
            if self._shutdown:
                raise RuntimeError("dispatch pool is shut down")
            # put_nowait: the queue is unbounded, so this never blocks —
            # and the loop thread submits here, so it must never be able to
            self._q.put_nowait((fn, args))
            self._unclaimed += 1
            # a worker for every item no idle worker will take: counting
            # idle workers alone (the reference's ``self._idle == 0``)
            # leaves items queued behind one idle worker while it wakes,
            # and a batch member it then serves parks for the whole window
            if self._unclaimed > self._idle and len(self._threads) < self._max:
                t = threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"{self._name}-{len(self._threads)}",
                )
                self._threads.append(t)
                t.start()

    def _worker(self) -> None:
        # pool workers block on the queue; running one on an event-loop
        # thread would wedge the reactor
        from trino_tpu_torch.server.eventloop import assert_not_loop_thread

        assert_not_loop_thread("_DispatchPool worker")
        while True:
            with self._lock:
                self._idle += 1
            item = self._q.get()
            with self._lock:
                # one step: between the get and here this worker still
                # counts idle and its item unclaimed, so submit() spawns
                # for any item past the idle workers
                self._idle -= 1
                if item is not None:
                    self._unclaimed -= 1
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — work items own their errors
                pass

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            threads = list(self._threads)
        for _ in threads:
            self._q.put(None)


class QueryManager:
    """Registry + dispatch (DispatchManager + SqlQueryManager).

    Two admission styles:

    - ``resource_groups=`` (the server's path): event-driven. create_query
      submits to the resource-group waiter queue and returns; once a slot
      frees, the query runs on a bounded daemon pool. No thread is parked
      while a query is QUEUED, so queued depth is bounded by the groups'
      ``max_queued`` — not by dispatch threads.
    - ``admit=``/``complete=`` hooks (legacy; test doubles): dedicated
      thread per query, because the hook may BLOCK in admit and must not
      occupy pool workers.
    """

    def __init__(
        self,
        engine: Engine,
        max_concurrent: int = 4,
        admit=None,
        complete=None,
        resource_groups=None,
    ):
        self.engine = engine
        self._queries: dict[str, ManagedQuery] = {}
        self._lock = threading.Lock()
        self._admit = admit  # (query) -> token; may block (queue) or raise
        self._complete = complete  # (query, token) -> None
        self.resource_groups = resource_groups
        # pool at least as wide as a full batch: K batchmates each hold a
        # worker while parked on the batch collector's per-member events
        self._pool = _DispatchPool(max(max_concurrent, 16))
        self.max_history = 100
        self._shutdown = False

    def create_query(self, sql: str, session: Session) -> ManagedQuery:
        q = ManagedQuery(sql, session, engine=self.engine)
        try:
            # session-settable retained-history bound (coordinator memory
            # under sustained traffic); the hardcoded-100 default lives
            # in config.Session.DEFAULTS now
            self.max_history = int(session.get("query_manager_max_history"))
        except (KeyError, TypeError, ValueError):
            pass
        with self._lock:
            if self._shutdown:
                raise RuntimeError("query manager is shut down")
            self._queries[q.query_id] = q
            self._gc_locked()
        listeners = getattr(self.engine, "event_listeners", None)
        if listeners is not None:
            from trino_tpu_torch.events import QueryCreatedEvent

            listeners.fire_created(
                QueryCreatedEvent(
                    q.query_id, sql, session.user, q.create_time
                )
            )
        # the result cache's fast path: a pure hit takes no execution
        # slot, so it bypasses admission (the ACL generation and the
        # user's checks still run inside the probe). Maintenance is not
        # allowed here: a delta merge scans the device and belongs on the
        # dispatch pool through the admitted path, which then refreshes
        # or overwrites the entry
        if self._try_result_cache(q):
            return q
        if self.resource_groups is not None and self._admit is None:
            self._submit_admission(q)
        else:
            threading.Thread(
                target=self._dispatch, args=(q,), daemon=True
            ).start()
        return q

    def _try_result_cache(self, q: ManagedQuery) -> bool:
        """Complete ``q`` from the result cache; False: normal dispatch."""
        probe = getattr(self.engine, "try_cached_result", None)
        if probe is None:
            return False
        try:
            res = probe(q.sql, q.session, allow_maintenance=False)
        except Exception:  # noqa: BLE001 — the probe never fails a query
            return False
        if res is None:
            return False
        q.start_time = time.time()
        q._start_mono_ts = time.monotonic()
        q.state.set(QueryState.PLANNING)
        q.state.set(QueryState.RUNNING)
        q.result = res
        q.state.set(QueryState.FINISHING)
        q.state.set(QueryState.FINISHED)
        q.end_time = time.time()
        q._end_mono = time.monotonic()
        q._fire_completed(self.engine)
        return True

    # --- event-driven admission (resource_groups path) --------------------

    def _submit_admission(self, q: ManagedQuery) -> None:
        def ready(group, err) -> None:
            # fires on whichever thread freed the slot (or reaped the
            # timeout) — hand off immediately, never execute inline
            q._admission_abandon = None
            if err is not None:
                self._reject(q, err)
                return
            q._flight_event(
                "admitted", group=getattr(group, "name", None), queued=True
            )
            try:
                self._pool.submit(self._run_admitted, q, group)
            except RuntimeError:  # pool shut down: give the slot back
                self.resource_groups.finish(group)

        try:
            # the history gate: a fingerprint whose observed peak device
            # bytes cannot fit the card at all is rejected here (classified
            # EXCEEDED_MEMORY_LIMIT) instead of failing in the run; one
            # that fits the card but not its current headroom rides the
            # hint into the waiter queue and waits for memory to free
            peak = self._history_hbm_gate(q)
            group, admitted = self.resource_groups.submit(
                q.session.user, q.session.source, ready,
                peak_hbm_hint=peak,
            )
        except TypeError:
            # resource-group doubles without the hint kwarg
            try:
                group, admitted = self.resource_groups.submit(
                    q.session.user, q.session.source, ready
                )
            except Exception as e:  # noqa: BLE001
                self._reject(q, e)
                return
        except Exception as e:  # noqa: BLE001 — queue full / no selector /
            # an over-memory fingerprint
            self._reject(q, e)
            return
        if admitted:
            q._flight_event(
                "admitted", group=getattr(group, "name", None), queued=False
            )
            self._pool.submit(self._run_admitted, q, group)
        else:
            q._flight_event("queued", group=getattr(group, "name", None))
            # let cancel() free the queue slot if the client abandons the
            # query before a slot opens (resource-group doubles may lack
            # abandon(); getattr keeps them working)
            abandon_fn = getattr(self.resource_groups, "abandon", None)
            if abandon_fn is not None:
                q._admission_abandon = lambda: abandon_fn(group, ready)

    def _history_hbm_gate(self, q: ManagedQuery) -> int:
        """The observed peak device bytes of this query's fingerprint, as
        an admission hint (0 = unknown). Raises HistoryHbmRejected when
        the observed footprint exceeds the card outright: waiting cannot
        help a query that never fits. Best-effort: any other failure of
        the gate admits (history never wedges admission)."""
        from trino_tpu_torch.obs.history import HistoryHbmRejected

        try:
            hist = self.engine.history_store(q.session)
            if hist is None:
                return 0
            fp, _ = self.engine.fingerprint(q.sql, q.session)
            if fp is None:
                return 0
            ent = hist.get(fp, touch=False)
            if ent is None:
                return 0
            peak = int(ent.get("peak_hbm_bytes", 0) or 0)
            if peak <= 0:
                return 0
            from trino_tpu_torch import ingest

            limit = ingest.device_hbm_limit(getattr(self.engine, "device", None))
            if limit and peak > 0.9 * limit:
                raise HistoryHbmRejected(fp, peak, limit)
            return peak
        except HistoryHbmRejected:
            raise
        except Exception:  # noqa: BLE001
            return 0

    def _run_admitted(self, q: ManagedQuery, group) -> None:
        released = threading.Event()

        def release() -> None:
            if not released.is_set():
                released.set()
                self.resource_groups.finish(group)

        try:
            if q.state.get() == QueryState.QUEUED:
                q.run(self.engine, release=release)
        finally:
            release()

    def _reject(self, q: ManagedQuery, e: Exception) -> None:
        from trino_tpu_torch.errors import classify_error

        code, name, typ = classify_error(e)
        if name == "GENERIC_INTERNAL_ERROR":
            # legacy admission failures (queue full, no selector) keep
            # their QUERY_REJECTED surface; classified errors (the
            # history gate's EXCEEDED_MEMORY_LIMIT) pass through
            code, name, typ = 3, "QUERY_REJECTED", "USER_ERROR"
        q._flight_event(
            "rejected", error=str(e), errorName=name, errorType=typ
        )
        q.error = ErrorInfo(str(e), code, name, typ)
        q.state.set(QueryState.FAILED)
        q.end_time = time.time()
        q._end_mono = time.monotonic()
        q._fire_completed(self.engine)

    # --- legacy blocking admission (admit=/complete= hooks) ----------------

    def _dispatch(self, q: ManagedQuery) -> None:
        token = None
        admitted = False
        try:
            if self._admit is not None:
                token = self._admit(q)  # blocks while queued; raises on reject
                admitted = True
            if q.state.get() == QueryState.QUEUED:
                q.run(self.engine)
        except Exception as e:  # noqa: BLE001
            self._reject(q, e)
        finally:
            if admitted and self._complete is not None:
                self._complete(q, token)

    def get(self, query_id: str) -> Optional[ManagedQuery]:
        with self._lock:
            return self._queries.get(query_id)

    def queries(self) -> list[ManagedQuery]:
        with self._lock:
            return list(self._queries.values())

    def state_counts(self) -> dict[str, int]:
        """``system.runtime.queries``-style breakdown: live query count
        per state (QUEUED/RUNNING/FINISHED/…) for /v1/status."""
        out: dict[str, int] = {}
        with self._lock:
            for q in self._queries.values():
                st = q.state.get().value
                out[st] = out.get(st, 0) + 1
        return out

    def cancel(self, query_id: str) -> bool:
        q = self.get(query_id)
        if q is None:
            return False
        q.cancel()
        return True

    def expire_abandoned(self, client_timeout_s: float) -> list[str]:
        """Cancel non-terminal queries whose ``nextUri`` went unpolled for
        ``client_timeout_s`` (abandoned dashboards must not pin resource
        groups). Returns the canceled query ids.

        Reference: Trino ``query.client.timeout`` in SqlQueryManager's
        ``enforceTimeouts``.
        """
        if client_timeout_s <= 0:
            return []
        now = time.monotonic()
        victims = [
            q for q in self.queries()
            if not q.state.is_terminal()
            and now - q.last_access > client_timeout_s
        ]
        out: list[str] = []
        for q in victims:
            q.cancel(
                "Query abandoned: no client poll within "
                f"{client_timeout_s:g}s"
            )
            out.append(q.query_id)
        if out:
            try:
                from trino_tpu_torch.obs.metrics import get_registry

                get_registry().counter(
                    "trino_tpu_queries_abandoned_total"
                ).inc(len(out))
            except Exception:  # noqa: BLE001
                pass
        return out

    def kill(self, query_id: str, message: str) -> bool:
        q = self.get(query_id)
        if q is None:
            return False
        return q.kill(message)

    def _gc_locked(self) -> None:
        try:
            from trino_tpu_torch.obs.metrics import get_registry

            get_registry().gauge("trino_tpu_query_history_retained").set(
                len(self._queries)
            )
        except Exception:  # noqa: BLE001
            pass
        if len(self._queries) <= self.max_history:
            return
        # evict least-recently-ACCESSED terminal queries only: a client may
        # still be paging a finished query's buffered results
        now = time.monotonic()
        done = [
            q
            for q in self._queries.values()
            if q.state.is_terminal() and now - q.last_access > 5.0
        ]
        done.sort(key=lambda q: q.last_access)
        for q in done[: len(self._queries) - self.max_history]:
            self._queries.pop(q.query_id, None)

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            self._shutdown = True
        self._pool.shutdown()
