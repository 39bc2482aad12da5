"""Statement execution engine: the coordinator's analyze/plan/execute core.

Reference: ``execution/SqlQueryExecution.java:373`` (the DQL path), the
``DataDefinitionTask`` family for DDL and utility statements, and
``testing/LocalQueryRunner.java``, which drives the same core in-process.
Counterpart of ``trino_tpu/engine.py``: queries, SET SESSION, SHOW,
EXPLAIN (ANALYZE), CREATE TABLE (AS), INSERT, DELETE, DROP, transactions
and prepared statements, under the reference's access control
(``security.py``) and single-writer transactions (``transaction.py``).
The ``tpch`` and ``tpcds`` catalogs generate their tables
(``connectors/tpch.py``, ``connectors/tpcds.py``); ``memory`` tables are
written by SQL (``connectors/memory.py``); ``blackhole`` discards writes.
The ``system`` catalog (``connectors/system.py``) reads the engine's
runtime state; query events fire through an :class:`EventListenerManager`.
The engine keeps what outlives one query: the program-cache entries (a
distributed SELECT is canonicalized, ``planner/canonicalize.py``, and its
entry, keyed by the canonical fingerprint, the catalogs' data versions
and the access-control generation, holds the first plan object, the
programs and the capacities every run of it grew to), the programs'
shared graph pool (``exec/programs.py``), the batch collector
(``exec/batching.py``), the device table cache (``ingest.py``) and the
memory pool (``memory.py``) that each query's memory context reserves
from.

Each statement's counters go to the metrics registry (``obs/metrics.py``),
which ``system.runtime.metrics`` and the server's ``/v1/metrics`` read; a
server (``server/http.py``) installs its node listing. A statement opens
the ``query`` span (``execute`` under a server's query root) with
``plan`` and ``optimize`` under it (``obs/trace.py``). The repeat tiers
(reference ``:325-470``, ``:612-885``): the query-history stores by
``history_dir`` (``obs/history.py``; a SELECT's fingerprint reads its
entry before the run, to seed capacities, and records what the run
observed after it), the SLO sentinel (``obs/slo.py``) judging each run
against that entry, and the semantic result cache (``cache/``), probed
before the statement is parsed and stored after a SELECT. Not ported:
the cluster scheduler, scaled writers and worker tasks (ROADMAP item 9c).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

import numpy as np

import torch

from trino_tpu_torch import resolve_device
from trino_tpu_torch import types as T
from trino_tpu_torch.analyzer import Analyzer, SemanticError
from trino_tpu_torch.columnar import Batch, Column, Dictionary, as_tensor
from trino_tpu_torch.config import Session
from trino_tpu_torch.connectors.api import CatalogManager, ColumnSchema, TableSchema
from trino_tpu_torch.exec.local import LocalExecutor
from trino_tpu_torch.ingest import DeviceTableCache
from trino_tpu_torch.memory import MemoryPool, QueryMemoryContext, device_pool_bytes
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.sql import parse_statement
from trino_tpu_torch.sql import tree as t


@dataclasses.dataclass
class StatementResult:
    """What a statement produced (protocol-ready, host-side)."""

    rows: list[tuple]
    column_names: list[str]
    column_types: list[T.SqlType]
    update_type: Optional[str] = None  # e.g. "CREATE TABLE", "INSERT"
    update_count: Optional[int] = None
    set_session: dict[str, Any] = dataclasses.field(default_factory=dict)
    peak_memory_bytes: int = 0
    dynamic_filters: int = 0
    # prepared-statement session mutations (ride X-Trino-*-Prepare headers)
    added_prepare: Optional[tuple[str, str]] = None  # (name, sql)
    deallocated_prepare: Optional[str] = None
    # transaction mutations (X-Trino-Started-Transaction-Id / Clear-...)
    started_transaction_id: Optional[str] = None
    cleared_transaction: bool = False
    # the cluster tier's retry and attempt counters (ROADMAP item 9c):
    # empty on one engine, as the reference's are without a cluster
    cluster_stats: dict[str, Any] = dataclasses.field(default_factory=dict)
    # per-exchange counters of a distributed run; None for local runs
    exchange_stats: Optional[dict[str, Any]] = None
    # the program cache (reference: CacheStatsMBean's counters): the
    # capture (on a card) or warm-up (on the CPU) wall of the programs
    # this run made, how many, and the stored programs it replayed
    compile_ms: float = 0.0
    trace_count: int = 0
    program_cache_hits: int = 0
    program_cache_misses: int = 0
    ingest_stats: Optional[dict[str, Any]] = None
    # fragment id -> "streamed" | "materialized" for distributed runs
    fragment_modes: Optional[dict[int, str]] = None
    # spilled operators by kind, partitions and host partitioning seconds
    spill_stats: Optional[dict[str, Any]] = None
    # cross-query batching (exec/batching.py): batchedQueries, batchSize,
    # batchWaitMs of a query that shared its replays; None when alone
    batch_stats: Optional[dict[str, Any]] = None
    # in-program operator row flow: {stable_site: {kind, rows_in,
    # rows_out}}; None when operator_stats is off or nothing ran a program
    operator_stats: Optional[dict[str, Any]] = None
    # the device profiler's rollup (obs/profiler.py): per-program CUDA
    # allocator stats and the query totals (``deviceStats``); None when
    # device_profiling is off or no program ran
    device_stats: Optional[dict[str, Any]] = None
    # the result cache (cache/): resultCacheHit, and incrementalMaintenance
    # with deltaSplits when an entry was maintained; None on real runs
    result_cache_stats: Optional[dict[str, Any]] = None
    # the SLO sentinel's verdict against the fingerprint's history
    # baseline (``queryStats.regression``); None when within it or cold
    regression: Optional[dict[str, Any]] = None


# the reference's table-cache budget, sized for its 16 GiB pool; kept on
# the CPU so that the CPU runs count as the reference's do
CPU_TABLE_CACHE_BYTES = 1 << 30


def table_cache_budget(session: Session, pool: MemoryPool, device) -> int:
    """The device table cache's byte budget: the session's
    ``table_cache_max_bytes`` when it sets one; otherwise a quarter of the
    engine's memory pool on a card (21.25 GB on an H100 80GB, where the
    reference's 1 GiB evicted 234 times over the 64 TPC-DS queries at SF1),
    and the reference's 1 GiB on the CPU."""
    value = session.get("table_cache_max_bytes")
    if value is not None:
        return int(value)
    if torch.device(device).type == "cuda":
        return pool.capacity // 4
    return CPU_TABLE_CACHE_BYTES


class Engine:
    """Catalogs + statement dispatch, on one torch device.

    ``device`` defaults to ``cuda``; without a GPU the engine raises
    unless the caller passes ``device="cpu"``. The memory pool holds the
    card's memory, or the reference's 16 GiB on the CPU."""

    def __init__(self, catalogs: Optional[CatalogManager] = None, device=None):
        self.device = resolve_device(device)
        # the mesh of execution_mode=distributed (parallel/mesh.py): None
        # is a mesh of one shard (reference engine.py:90,108)
        self.mesh = None
        if catalogs is None:
            from trino_tpu_torch.connectors.blackhole import BlackHoleConnector
            from trino_tpu_torch.connectors.memory import MemoryConnector
            from trino_tpu_torch.connectors.tpcds import TpcdsConnector
            from trino_tpu_torch.connectors.tpch import TpchConnector

            catalogs = CatalogManager()
            catalogs.register("tpch", TpchConnector())
            catalogs.register("tpcds", TpcdsConnector())
            catalogs.register("memory", MemoryConnector())
            catalogs.register("blackhole", BlackHoleConnector())
        self.catalogs = catalogs
        # transactions + access control (reference: engine.py:104-109)
        from trino_tpu_torch.security import AccessControlManager
        from trino_tpu_torch.transaction import TransactionManager

        self.transaction_manager = TransactionManager(self.catalogs)
        self.access_control = AccessControlManager()
        # scanned tables kept on the device across queries (session
        # property ``table_cache``)
        self.table_cache = DeviceTableCache()
        self.memory_pool = MemoryPool(device_pool_bytes(self.device))
        self._query_seq = 0
        self._seq_lock = threading.Lock()
        # observability (reference: QueryMonitor -> EventListenerManager;
        # the system catalog's runtime tables)
        from trino_tpu_torch.events import EventListenerManager

        self.event_listeners = EventListenerManager()
        self._recent_queries: "deque[dict]" = deque(maxlen=200)
        # a server installs its live node and task listings and names the
        # engine's node (reference engine.py:120, server/http.py:106)
        self._runtime_nodes_fn = None
        self._runtime_tasks_fn = None
        self.node_id: Optional[str] = None
        from trino_tpu_torch.connectors.system import SystemConnector

        self.catalogs.register("system", SystemConnector(self))
        # program-cache entries by (canonical fingerprint, data versions,
        # access-control generation), least recently used first
        self._query_cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self._query_cache_lock = threading.Lock()
        # every entry's programs: one shared graph memory pool
        from trino_tpu_torch.exec.programs import ProgramPool

        self.program_pool = ProgramPool(self.device)
        # compatible queries (one entry, one session signature) share
        # their replays when the session's batch_window_ms > 0
        from trino_tpu_torch.exec.batching import BatchCollector

        self.batch_collector = BatchCollector(self)
        # query-history stores (obs/history.py) by the session's
        # history_dir ("" = this process's in-memory store), so every
        # query of a dir shares one store and its lock
        self._history_stores: dict[str, Any] = {}
        self._history_lock = threading.Lock()
        # final result sets by (fingerprint, hoisted parameters), checked
        # against data versions and the access-control generation
        from trino_tpu_torch.cache.result_cache import ResultCache

        self.result_cache = ResultCache()

    _QUERY_CACHE_MAX = 64
    # statements whose results depend on evaluation time or randomness
    # never reuse a cached plan; whole lexer identifiers, not substrings
    _UNCACHEABLE_IDENTS = frozenset({
        "random", "rand", "now", "uuid", "current_time", "current_date",
        "current_timestamp", "localtime", "localtimestamp",
    })

    def _sql_cacheable(self, sql: str) -> bool:
        from trino_tpu_torch.sql.lexer import SqlSyntaxError, tokenize

        try:
            tokens = tokenize(sql)
        except SqlSyntaxError:
            return False  # the parser reports the real error, uncached
        return not any(
            tok.kind in ("IDENT", "KW") and tok.text.lower() in self._UNCACHEABLE_IDENTS
            for tok in tokens
        )

    def _query_cache_entry(self, fingerprint: str) -> dict:
        """The program-cache entry of a canonical fingerprint (reference:
        ``trino_tpu/engine.py:200-228``). The key adds what the
        fingerprint cannot see: the catalogs' data versions (dictionaries
        and string truth tables are fixed in a captured program, so new
        data must capture again) and the access-control generation. An
        entry holds the first plan object, the program store (the
        fragmented subplan, the fused units, every ``_Caps`` and every
        program) and a lock; the map keeps the ``_QUERY_CACHE_MAX`` most
        recently used entries."""
        versions = tuple(
            (name, getattr(self.catalogs.get(name), "_version", 0))
            for name in sorted(self.catalogs.names())
        )
        key = (fingerprint, versions, self.access_control.generation)
        with self._query_cache_lock:
            entry = self._query_cache.get(key)
            if entry is None:
                entry = {"plan": None, "programs": {}, "lock": threading.Lock()}
                self._query_cache[key] = entry
                while len(self._query_cache) > self._QUERY_CACHE_MAX:
                    _, old = self._query_cache.popitem(last=False)
                    self._drop_programs(old["programs"])
            else:
                self._query_cache.move_to_end(key)
        return entry

    def drop_query_cache(self, fingerprint: str) -> int:
        """Forget every entry of ``fingerprint`` (its programs and the
        capacities its runs grew to); returns how many went."""
        with self._query_cache_lock:
            keys = [k for k in self._query_cache if k[0] == fingerprint]
            for k in keys:
                self._drop_programs(self._query_cache.pop(k)["programs"])
        return len(keys)

    def _drop_programs(self, programs: dict) -> None:
        from trino_tpu_torch.exec.programs import Program

        for val in programs.values():
            if isinstance(val, Program):
                self.program_pool.forget(val)

    @property
    def mesh_n(self) -> int:
        """Shards of the engine's mesh, folded into every fingerprint."""
        return 1 if self.mesh is None else self.mesh.size

    def fingerprint(self, sql: str, session: Session) -> tuple[Optional[str], list]:
        """Canonical-plan fingerprint and hoisted parameters of a SELECT,
        None for an uncacheable statement (reference ``:892``)."""
        from trino_tpu_torch.planner.canonicalize import canonicalize_plan

        stmt = parse_statement(sql)
        if not isinstance(stmt, t.Query) or not self._sql_cacheable(sql):
            return None, []
        _, params, fp = canonicalize_plan(self.plan(stmt, session), session, self.mesh_n)
        return fp, params

    # --- runtime introspection (the system connector's backends) ----------

    def _next_query_id(self) -> str:
        with self._seq_lock:
            self._query_seq += 1
            return f"q{self._query_seq}"

    def runtime_queries(self) -> list[dict]:
        out = []
        for rec in list(self._recent_queries):
            rec = dict(rec)
            if rec["state"] == "RUNNING":
                rec["elapsedTimeMillis"] = int((time.monotonic() - rec["_start"]) * 1000)
            rec.pop("_start", None)
            out.append(rec)
        return out

    def runtime_nodes(self) -> list[tuple]:
        """The server's live node listing where one installed it, else one
        node: this engine on its device."""
        if self._runtime_nodes_fn is not None:
            return self._runtime_nodes_fn()
        return [("local", "local://", "trino-tpu-0.1", True, "ACTIVE")]

    def runtime_tasks(self) -> list[dict]:
        """The server's task listing where one installed it. Worker tasks
        belong to the cluster tier (ROADMAP item 9c), so a coordinator of
        this package lists none either."""
        if self._runtime_tasks_fn is not None:
            return self._runtime_tasks_fn()
        return []

    def runtime_metrics(self) -> list[tuple]:
        """Live metrics-registry snapshot for ``system.runtime.metrics``
        (reference ``:265``): one row per (name{labels}, kind, value);
        histograms expose their count/sum/p50/p99 as separate rows."""
        from trino_tpu_torch.obs.metrics import get_registry

        snap = get_registry().snapshot()
        rows: list[tuple] = []
        for key, val in sorted(snap.get("counters", {}).items()):
            rows.append((key, "counter", float(val)))
        for key, val in sorted(snap.get("gauges", {}).items()):
            rows.append((key, "gauge", float(val)))
        for key, h in sorted(snap.get("histograms", {}).items()):
            for field in ("count", "sum", "p50", "p99"):
                v = h.get(field)
                if v is not None:
                    rows.append((f"{key}.{field}", "histogram", float(v)))
        return rows

    # --- query history (obs/history.py; reference :325-470) ---------------

    def history_store(self, session: Session):
        """The :class:`QueryHistoryStore` this session resolves to, or
        None when ``query_history`` is off. One store a ``history_dir``
        ("" keeps it in memory, the default)."""
        try:
            if not bool(session.get("query_history")):
                return None
            hdir = str(session.get("history_dir") or "")
            max_entries = int(session.get("history_max_entries"))
            max_bytes = int(session.get("history_max_bytes"))
        except KeyError:
            return None
        import os

        from trino_tpu_torch.obs.history import QueryHistoryStore

        path = os.path.join(hdir, "query_history.json") if hdir else ""
        with self._history_lock:
            store = self._history_stores.get(hdir)
            if store is None:
                store = QueryHistoryStore(
                    path=path, max_entries=max_entries, max_bytes=max_bytes
                )
                self._history_stores[hdir] = store
            return store

    def history_snapshot(self) -> dict:
        """Every history store this engine has resolved: the
        ``GET /v1/history`` body."""
        with self._history_lock:
            stores = sorted(self._history_stores.items())
        return {"stores": [s.snapshot() for _, s in stores]}

    def runtime_history(self) -> list[dict]:
        """Flat per-fingerprint rows for ``system.runtime.history``."""
        with self._history_lock:
            stores = [s for _, s in sorted(self._history_stores.items())]
        rows: list[dict] = []
        for store in stores:
            for fp, ent in store.entries():
                rec = dict(ent)
                rec["fingerprint"] = fp
                rec["path"] = store.path
                rows.append(rec)
        return rows

    @staticmethod
    def _history_record(hist, fp, res, elapsed_ms: float) -> None:
        """Fold one finished query's observed stats into the history
        store. Best-effort: history never fails the query that feeds it."""
        if hist is None or fp is None or res is None:
            return
        try:
            ex = res.exchange_stats if isinstance(res.exchange_stats, dict) else {}
            ds = res.device_stats if isinstance(res.device_stats, dict) else {}
            bs = res.batch_stats if isinstance(res.batch_stats, dict) else {}
            caps: dict[str, dict] = {}
            for val in (ex.get("capacities") or {}).values():
                if not isinstance(val, dict):
                    continue
                site = val.get("site")
                # only restart-stable names persist
                if not isinstance(site, str) or "@" not in site:
                    continue
                caps[site] = {
                    "value": val.get("value"),
                    "provenance": val.get("provenance", ""),
                }
            observed: dict[str, Any] = {
                "elapsed_ms": round(float(elapsed_ms), 3),
                "rows": len(res.rows),
                "overflow_retries": int(ex.get("overflow_retries", 0) or 0),
                "compile_halvings": int(ex.get("compile_halvings", 0) or 0),
                "padding_ratio": float(ex.get("padding_ratio", 0.0) or 0.0),
                "shuffle_rows": int(ex.get("shuffle_rows", 0) or 0),
                "capacities": caps,
            }
            ops: dict[str, dict] = {}
            for site, ent in (ex.get("operators") or {}).items():
                if not isinstance(ent, dict) or "@" not in str(site):
                    continue
                ops[str(site)] = {
                    "kind": str(ent.get("kind", "")),
                    "rows_in": int(ent.get("rows_in", 0) or 0),
                    "rows_out": int(ent.get("rows_out", 0) or 0),
                }
            if ops:
                observed["operators"] = ops
            flops = ds.get("total_flops")
            if isinstance(flops, (int, float)):
                observed["flops"] = float(flops)
            peak = ds.get("peak_hbm_bytes")
            if isinstance(peak, (int, float)) and peak > 0:
                observed["peak_hbm_bytes"] = int(peak)
            if bs.get("batchSize"):
                observed["batch_size"] = int(bs["batchSize"])
            hist.record(fp, observed)
        except Exception:  # noqa: BLE001
            pass

    @staticmethod
    def _sentinel_check(session, fp, res, elapsed_ms: float, hist_entry,
                        query_id=None) -> None:
        """Judge this completion against the fingerprint's pre-run
        history baseline and the session's SLOs (obs/slo.py); the verdict
        rides the result as ``regression``. Best-effort like history."""
        try:
            from trino_tpu_torch.obs.slo import get_sentinel

            verdict = get_sentinel().evaluate(
                session, fp, elapsed_ms, hist_entry, query_id=query_id
            )
            if res is not None and verdict is not None:
                res.regression = verdict
        except Exception:  # noqa: BLE001
            pass

    def runtime_programs(self) -> list[dict]:
        """One row a stored program (reference ``:284``): its entry's
        fingerprint and store counters, and the allocator stats of its
        capture where the profiler took them (``peak_hbm_bytes``; the
        XLA cost columns, flops and bytes accessed, stay None)."""
        from trino_tpu_torch.exec.programs import Program

        with self._query_cache_lock:
            items = [(key[0], entry["programs"]) for key, entry in self._query_cache.items()]
        rows = []
        for fingerprint, programs in items:
            stats = programs.get("__stats__") or {}
            for val in list(programs.values()):
                if not isinstance(val, Program):
                    continue
                ds = val.device_stats or {}
                rows.append({
                    "fingerprint": fingerprint,
                    "program": val.label,
                    "hits": int(stats.get("hits", 0)),
                    "misses": int(stats.get("misses", 0)),
                    "compile_ms": float(stats.get("compile_ms", 0.0)),
                    "flops": ds.get("flops"),
                    "peak_hbm_bytes": ds.get("peak_hbm_bytes"),
                    "bytes_accessed": ds.get("bytes_accessed"),
                })
        return rows

    def execute_statement(self, sql: str, session: Session,
                          query_id: Optional[str] = None,
                          fire_events: bool = True) -> StatementResult:
        """Run one statement (reference ``:463``): a query record for
        ``system.runtime.queries`` and the created and completed events.
        A session inside an explicit transaction has it validated and
        pinned for the statement's duration: an unknown or expired id
        fails (and is cleared from the session), and a live one is not
        idle-expired mid-statement."""
        from trino_tpu_torch.events import QueryCompletedEvent, QueryCreatedEvent
        from trino_tpu_torch.obs.trace import get_tracer

        qid = query_id or self._next_query_id()
        t0 = time.time()
        t0m = time.monotonic()
        if fire_events:
            self.event_listeners.fire_created(QueryCreatedEvent(qid, sql, session.user, t0))
        tracer = get_tracer()
        # the root span when standalone; an "execute" child when a
        # server's ManagedQuery opened the query root on this thread
        span = tracer.start_span(
            "query" if tracer.current() is None else "execute",
            trace_id=qid if tracer.current() is None else None,
            attrs={"queryId": qid, "user": session.user},
        )
        record = {
            "queryId": qid, "state": "RUNNING", "user": session.user,
            "source": session.source, "query": sql, "elapsedTimeMillis": 0,
            "peakMemoryBytes": 0, "outputRows": 0, "_start": t0m,
        }
        self._recent_queries.append(record)
        error: Optional[str] = None
        exc: Optional[BaseException] = None
        res: Optional[StatementResult] = None
        txn_info = None
        try:
            txn_id = session.properties.get("__txn")
            if txn_id:
                try:
                    txn_info = self.transaction_manager.get(txn_id)  # touches
                    txn_info.busy += 1
                except Exception:
                    session.properties.pop("__txn", None)
                    raise
            with tracer.activate(span):
                res = self._execute_statement_inner(sql, session, qid)
            return res
        except Exception as e:  # noqa: BLE001
            error, exc = str(e), e
            raise
        finally:
            if txn_info is not None:
                txn_info.busy -= 1
                txn_info.last_access = time.time()
            wall = time.monotonic() - t0m
            record["state"] = "FINISHED" if error is None else "FAILED"
            record["elapsedTimeMillis"] = int(wall * 1000)
            if res is not None:
                record["peakMemoryBytes"] = res.peak_memory_bytes
                record["outputRows"] = len(res.rows)
            span.finish(
                status="OK" if error is None else "ERROR",
                state=record["state"], rows=record["outputRows"],
            )
            from trino_tpu_torch.obs.metrics import get_registry

            self._record_query_metrics(get_registry(), record, res, wall)
            if fire_events:
                err_code = err_type = None
                if exc is not None:
                    from trino_tpu_torch.errors import classify_error

                    err_code, _, err_type = classify_error(exc)
                self.event_listeners.fire_completed(QueryCompletedEvent(
                    qid, sql, session.user, t0, time.time(), record["state"],
                    output_rows=record["outputRows"],
                    peak_memory_bytes=record["peakMemoryBytes"],
                    error_message=error, wall_seconds=wall,
                    error_code=err_code, error_type=err_type,
                ))

    def _execute_statement_inner(self, sql: str, session: Session,
                                 query_id: Optional[str] = None) -> StatementResult:
        # the result cache's probe before parsing: its SQL-text memo
        # (filled on store, checked against data versions and the
        # access-control generation) serves a repeat text as host rows
        cached = self.try_cached_result(sql, session)
        if cached is not None:
            return cached
        stmt = parse_statement(sql)
        if isinstance(stmt, t.Prepare):
            # keep the statement's SQL text: it must survive the
            # stateless HTTP protocol via X-Trino-Added-Prepare
            m = re.match(r"\s*prepare\s+\S+\s+from\s+(.*)$", sql.strip().rstrip(";"),
                         re.IGNORECASE | re.DOTALL)
            if m:
                stmt = dataclasses.replace(stmt, sql=m.group(1).strip())
        return self._dispatch_parsed(stmt, session, query_id, sql_text=sql)

    # --- the semantic result cache (cache/; reference :612-720) ------------

    def _result_cache_on(self, session: Session) -> bool:
        try:
            if not bool(session.get("result_cache")):
                return False
        except KeyError:
            return False
        # snapshot semantics inside explicit transactions are per-txn
        return "__txn" not in session.properties

    def try_cached_result(self, sql: str, session: Session,
                          allow_maintenance: bool = True) -> Optional[StatementResult]:
        """This statement from the result cache, or None. A pure hit is
        host work only; ``allow_maintenance`` also lets an appended
        entry be merged, which scans the delta on the device and so
        belongs on a dispatch thread (the query manager's admission fast
        path passes False)."""
        if not self._result_cache_on(session):
            return None
        try:
            return self.result_cache.lookup(
                self, sql, session, allow_maintenance=allow_maintenance
            )
        except Exception:  # noqa: BLE001 — the cache never fails a query
            return None

    def _result_cache_begin(self, sql_text: Optional[str], session: Session,
                            plan: P.PlanNode) -> Optional[dict]:
        """The store's pre-execution snapshot: the referenced tables and
        their data versions, taken before the run so that a write landing
        during it leaves the entry stale, never wrong."""
        if sql_text is None or not self._result_cache_on(session):
            return None
        if not self._sql_cacheable(sql_text):
            return None
        try:
            from trino_tpu_torch.cache.result_cache import referenced_tables, versions_snapshot

            tables = referenced_tables(plan)
            if not tables:
                return None  # literal-only results are not worth an entry
            for cat in dict.fromkeys(c for c, _, _ in tables):
                conn = self.catalogs.get(cat)
                if not getattr(conn, "supports_result_caching", True):
                    return None  # live state (system tables): never cached
            versions = versions_snapshot(self.catalogs, tables)
        except Exception:  # noqa: BLE001
            return None
        return {"tables": tables, "versions": versions}

    def _result_cache_store(self, ctx: Optional[dict], sql_text: str, session: Session,
                            plan: P.PlanNode, res: Optional[StatementResult]) -> None:
        if ctx is None or res is None or res.update_type is not None:
            return
        try:
            from trino_tpu_torch.planner.canonicalize import (
                canonicalize_plan,
                classify_maintainability,
            )

            # the (fingerprint, params) pair of the baked plan: two
            # literal variants must never share an entry
            _, params, fp = canonicalize_plan(plan, session, self.mesh_n)
            if fp is None:
                return
            maintain = None
            try:
                if bool(session.get("incremental_maintenance")):
                    maintain = classify_maintainability(plan)
            except KeyError:
                maintain = None
            try:
                max_bytes = int(session.get("result_cache_max_bytes"))
            except KeyError:
                max_bytes = None
            self.result_cache.store(
                sql=sql_text, session=session, fingerprint=fp, params=params,
                tables=ctx["tables"], versions=ctx["versions"],
                acl_generation=self.access_control.generation, res=res,
                maintain=maintain, plan=plan, max_bytes=max_bytes,
            )
        except Exception:  # noqa: BLE001 — the cache never fails a query
            pass

    @staticmethod
    def _record_query_metrics(reg, record: dict, res, wall_s: float) -> None:
        """Fold one statement's counters into the process registry
        (reference ``:566``)."""
        reg.counter("trino_tpu_queries_total", state=record["state"]).inc()
        reg.histogram("trino_tpu_query_elapsed_ms").observe(wall_s * 1000.0)
        reg.counter("trino_tpu_output_rows_total").inc(record["outputRows"])
        if res is None:
            return
        reg.counter("trino_tpu_compile_ms_total").inc(res.compile_ms)
        reg.counter("trino_tpu_trace_count_total").inc(res.trace_count)
        reg.counter("trino_tpu_program_cache_hits_total").inc(res.program_cache_hits)
        reg.counter("trino_tpu_program_cache_misses_total").inc(res.program_cache_misses)
        for key, val in (res.exchange_stats or {}).items():
            # batchedQueries is shared by every member of a batched
            # dispatch; trino_tpu_batched_dispatches_total{size} counts those
            if key == "batchedQueries":
                continue
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                reg.counter(f"trino_tpu_exchange_{key}_total").inc(val)
        for ent in (res.operator_stats or {}).values():
            if isinstance(ent, dict) and ent.get("kind"):
                reg.counter("trino_tpu_operator_rows_total",
                            kind=ent["kind"], io="in").inc(int(ent.get("rows_in", 0) or 0))
                reg.counter("trino_tpu_operator_rows_total",
                            kind=ent["kind"], io="out").inc(int(ent.get("rows_out", 0) or 0))
        ds = res.device_stats or {}
        if isinstance(ds.get("total_flops"), (int, float)):
            reg.counter("trino_tpu_query_flops_total").inc(ds["total_flops"])
        if isinstance(ds.get("peak_hbm_bytes"), (int, float)):
            reg.gauge("trino_tpu_query_peak_hbm_bytes").set(ds["peak_hbm_bytes"])

    def _dispatch_parsed(self, stmt: t.Node, session: Session,
                         query_id: Optional[str] = None,
                         sql_text: Optional[str] = None) -> StatementResult:
        handler = getattr(self, f"_do_{type(stmt).__name__.lower()}", None)
        if handler is not None:
            return handler(stmt, session)
        if isinstance(stmt, t.Query):
            return self._run_query(stmt, session, query_id, sql_text)
        raise SemanticError(f"unsupported statement: {type(stmt).__name__}")

    def _run_query(self, stmt: t.Query, session: Session,
                   query_id: Optional[str], sql_text: Optional[str]) -> StatementResult:
        """A SELECT (reference ``:768-890``): planned every time; in
        distributed mode with the program cache on, canonicalized, so the
        canonical fingerprint (not the text) picks the entry whose
        programs it runs, its hoisted literals riding the parameter
        tensor. A second concurrent run of one entry runs uncached. The
        fingerprint's history entry, read before the run, seeds its
        capacities; the run's observations and the sentinel's verdict
        follow it, and the result cache stores its rows."""
        plan = self.plan(stmt, session)
        # the result cache's store context (tables and their pre-run
        # versions); None when the cache is off or the shape refuses
        rc_ctx = self._result_cache_begin(sql_text, session, plan)
        exec_plan, params, entry, fp = plan, [], None, None
        if (
            sql_text is not None
            and session.get("execution_mode") == "distributed"
            and session.get("fragment_execution")
            and bool(session.get("program_cache"))
            and self._sql_cacheable(sql_text)
        ):
            from trino_tpu_torch.planner.canonicalize import canonicalize_plan

            canonical, params, fp = canonicalize_plan(plan, session, self.mesh_n)
            if fp is not None:
                exec_plan = canonical
                entry = self._query_cache_entry(fp)
            else:
                params = []  # unserializable shape: run baked, uncached
        hist = self.history_store(session) if fp is not None else None
        hist_entry = hist.get(fp) if hist is not None else None

        def finish(res: StatementResult, t0: float) -> StatementResult:
            elapsed_ms = (time.monotonic() - t0) * 1000.0
            self._sentinel_check(session, fp, res, elapsed_ms, hist_entry, query_id=query_id)
            self._history_record(hist, fp, res, elapsed_ms)
            if isinstance(res.exchange_stats, dict):
                # did an earlier run of this fingerprint inform this one?
                # (queryStats.historyHits)
                res.exchange_stats["history_hits"] = 1 if hist_entry is not None else 0
            self._result_cache_store(rc_ctx, sql_text, session, plan, res)
            return res

        if (
            entry is not None
            and int(session.get("batch_window_ms")) > 0
            and "__txn" not in session.properties
        ):
            t0 = time.monotonic()
            return finish(self.batch_collector.submit(
                entry, exec_plan, session, params, query_id or self._next_query_id()
            ), t0)
        # a store and its capacities serve one executor at a time
        if entry is not None and not entry["lock"].acquire(blocking=False):
            entry = None
            exec_plan, params = plan, []
        try:
            programs = None
            if entry is not None:
                if entry["plan"] is None:
                    entry["plan"] = exec_plan
                # the FIRST plan object of the fingerprint: its node
                # identities name the programs and capacity sites
                exec_plan = entry["plan"]
                programs = entry["programs"]
            t0 = time.monotonic()
            return finish(self._execute_query_plan(
                exec_plan, session, query_id=query_id, programs=programs, params=params,
                history=hist_entry,
            ), t0)
        finally:
            if entry is not None:
                entry["lock"].release()

    def plan(self, stmt: t.Node, session: Session) -> P.PlanNode:
        from trino_tpu_torch.obs.trace import get_tracer
        from trino_tpu_torch.planner.optimizer import optimize

        tracer = get_tracer()
        analyzer = Analyzer(self.catalogs, session, self.access_control)
        with tracer.span("plan"):
            plan = analyzer.plan_statement(stmt)
        with tracer.span("optimize"):
            return optimize(plan, session, self.catalogs)

    # === DQL ==============================================================

    def _memory_ctx(self, session: Session, query_id: Optional[str]) -> QueryMemoryContext:
        return QueryMemoryContext(
            self.memory_pool, query_id or self._next_query_id(),
            max_bytes=int(session.get("query_max_memory_bytes")),
        )

    def _result(self, executor, batch: Batch, names, ctx, **extra) -> StatementResult:
        snap = getattr(executor, "exchange_stats_snapshot", None)
        exchange_stats = snap() if callable(snap) else None
        dsnap = getattr(executor, "device_stats_snapshot", None)
        cs = getattr(executor, "compile_stats", None) or {}
        from trino_tpu_torch.exec.programs import allow_sync

        with allow_sync(batch.device):  # the result's read
            rows = batch.to_pylist()
        return StatementResult(
            rows,
            list(names),
            [c.type for c in batch.columns],
            peak_memory_bytes=ctx.peak_bytes,
            dynamic_filters=len(executor.dynamic_filters),
            exchange_stats=exchange_stats,
            compile_ms=round(float(cs.get("compile_ms", 0.0)), 3),
            trace_count=int(cs.get("trace_count", 0)),
            program_cache_hits=int(cs.get("program_cache_hits", 0)),
            program_cache_misses=int(cs.get("program_cache_misses", 0)),
            fragment_modes=dict(getattr(executor, "fragment_modes", {}) or {}) or None,
            ingest_stats=dict(executor.ingest_stats) or None,
            spill_stats=dict(executor.spill_stats) or None,
            operator_stats=(exchange_stats or {}).get("operators"),
            device_stats=dsnap() if callable(dsnap) else None,
            **extra,
        )

    def _execute_query_plan(
        self, plan: P.PlanNode, session: Session, collector=None,
        query_id: Optional[str] = None, programs: Optional[dict] = None,
        params: Optional[list] = None, history: Optional[dict] = None,
    ) -> StatementResult:
        ctx = self._memory_ctx(session, query_id)
        try:
            executor = self._executor(session, ctx, programs=programs, params=params,
                                      history=history)
            executor.stats_collector = collector
            batch, names = executor.execute(plan)
        finally:
            ctx.close()
        return self._result(executor, batch, names, ctx)

    def _execute_query_plan_batched(
        self, plan: P.PlanNode, session: Session, query_ids: list[str],
        param_lists: list[list], programs: Optional[dict] = None,
    ) -> list[StatementResult]:
        """K literal variants of one cached plan as K replays of its
        programs, one host read a program for the group (reference
        ``:1009``); one memory context and executor serve the batch.
        Raises ``BatchUnsupported``, or any execution error, for
        ``exec/batching.py`` to run the members one after the other."""
        from trino_tpu_torch.exec.fragments import BatchUnsupported, FragmentedExecutor

        ctx = self._memory_ctx(session, query_ids[0])
        try:
            executor = self._executor(session, ctx, programs=programs, params=param_lists[0])
            if not isinstance(executor, FragmentedExecutor):
                raise BatchUnsupported("fragment execution disabled")
            batches, names = executor.execute_batched(plan, param_lists)
        finally:
            ctx.close()
        return [self._result(executor, b, names, ctx) for b in batches]

    def _executor(self, session: Session, ctx: Optional[QueryMemoryContext] = None,
                  programs: Optional[dict] = None,
                  params: Optional[list] = None,
                  history: Optional[dict] = None) -> LocalExecutor:
        mode = session.get("execution_mode")
        if mode == "distributed" and session.get("fragment_execution"):
            from trino_tpu_torch.exec.fragments import FragmentedExecutor

            return FragmentedExecutor(
                self.catalogs, session, self.device, mesh=self.mesh,
                programs=programs, params=params,
                # programs are captured only into an entry's store
                pool=self.program_pool if programs is not None else None,
                table_cache=self.table_cache,
                table_cache_bytes=table_cache_budget(
                    session, self.memory_pool, self.device
                ),
                memory_ctx=ctx, history=history,
            )
        if mode not in ("local", "distributed"):
            raise SemanticError(
                f"execution_mode={mode!r} is not yet ported to trino_tpu_torch"
            )
        if mode == "distributed" and self.mesh_n > 1:
            from trino_tpu_torch.parallel.distributed import DistributedExecutor

            return DistributedExecutor(self.catalogs, session, self.device, self.mesh,
                                       memory_ctx=ctx)
        return LocalExecutor(self.catalogs, session, self.device, memory_ctx=ctx)

    # === session control ==================================================

    def _do_setsession(self, stmt: t.SetSession, session: Session) -> StatementResult:
        value = stmt.value
        v: Any = value.value if isinstance(value, t.Literal) else None
        session.set(stmt.name, v)
        return StatementResult(
            [], ["result"], [T.BOOLEAN],
            update_type="SET SESSION", set_session={stmt.name: v},
        )

    def _run_query_rows(self, query: t.Query, session: Session) -> tuple[Batch, list[str]]:
        """A query's rows as one host batch (the input of a write)."""
        plan = self.plan(query, session)
        ctx = self._memory_ctx(session, None)
        try:
            return self._executor(session, ctx).execute(plan)
        finally:
            ctx.close()

    # === metadata / SHOW ==================================================

    def _do_showcatalogs(self, stmt, session) -> StatementResult:
        names = self.access_control.filter_catalogs(
            session.user, self.catalogs.names()
        )
        return StatementResult([(n,) for n in names], ["Catalog"], [T.VARCHAR])

    def _do_showschemas(self, stmt, session) -> StatementResult:
        conn = self.catalogs.get(stmt.catalog or session.catalog)
        return StatementResult(
            [(s,) for s in conn.list_schemas()], ["Schema"], [T.VARCHAR]
        )

    def _do_showtables(self, stmt, session) -> StatementResult:
        parts = list(stmt.schema or ())
        if len(parts) == 2:
            catalog, schema = parts
        elif len(parts) == 1:
            catalog, schema = session.catalog, parts[0]
        else:
            catalog, schema = session.catalog, session.schema
        conn = self.catalogs.get(catalog)
        return StatementResult(
            [(x,) for x in conn.list_tables(schema)], ["Table"], [T.VARCHAR]
        )

    def _do_showcolumns(self, stmt, session) -> StatementResult:
        catalog, schema, table = self._qualify(stmt.table, session)
        ts = self.catalogs.get(catalog).get_table(schema, table)
        if ts is None:
            raise SemanticError(f"table not found: {catalog}.{schema}.{table}")
        rows = [(c.name, str(c.type), "", "") for c in ts.columns]
        return StatementResult(
            rows, ["Column", "Type", "Extra", "Comment"], [T.VARCHAR] * 4
        )

    # === EXPLAIN ==========================================================

    def _do_explain(self, stmt: t.Explain, session: Session) -> StatementResult:
        """EXPLAIN: the fragmented plan (``subplan_text``), as the
        reference prints it. EXPLAIN ANALYZE runs the query and renders the
        plan with each node's wall time, rows and bytes (local runs), the
        fragments' records and capacity sites (distributed runs), then the
        query's peak memory, dynamic filters, output rows and wall time.
        Distributed runs add the operator section: each site's rows in and
        out, read with the programs' flags (``exch@`` sites on N shards,
        with the exchange section). The reference's device-program
        section renders the profiler's allocator stats
        (``render_device_stats``)."""
        from trino_tpu_torch import stats as S

        if getattr(stmt, "analyze", False):
            inner = stmt.statement
            if not isinstance(inner, t.Query):
                raise SemanticError("EXPLAIN ANALYZE supports queries only")
            collector = S.StatsCollector()
            plan = self.plan(inner, session)
            res = self._execute_query_plan(plan, session, collector=collector)
            text = S.render_plan_with_stats(plan, collector)
            if collector.fragments:
                text += "\n\n" + S.render_fragment_stats(collector.fragments)
            if res.device_stats:
                text += "\n\n" + S.render_device_stats(res.device_stats)
            caps = (res.exchange_stats or {}).get("capacities")
            if isinstance(caps, dict) and caps:
                text += "\n\n" + S.render_capacity_stats(caps)
            if "shuffle_rows" in (res.exchange_stats or {}):
                text += "\n\n" + S.render_exchange_stats(res.exchange_stats)
            if res.operator_stats:
                text += "\n\n" + S.render_operator_stats(res.operator_stats)
            wall_ms = collector.total_wall() * 1000
            text += (
                f"\n\npeak memory: {res.peak_memory_bytes} bytes"
                f"\ndynamic filters: {res.dynamic_filters}"
                f"\noutput rows: {len(res.rows)}"
                f"\nwall time: {wall_ms:.1f}ms"
            )
            return StatementResult(
                [(line,) for line in text.splitlines()], ["Query Plan"], [T.VARCHAR]
            )
        from trino_tpu_torch.planner.fragmenter import fragment_plan, subplan_text

        text = subplan_text(fragment_plan(self.plan(stmt.statement, session)))
        return StatementResult(
            [(line,) for line in text.splitlines()], ["Query Plan"], [T.VARCHAR]
        )

    # === DDL / DML ========================================================

    def _insert(self, conn, schema: str, table: str, batch: Batch,
                session: Session) -> int:
        """Rows into a connector. The reference's scaled writers ship
        pages to worker tasks (``_scaled_insert``), which needs the cluster
        (ROADMAP item 9c)."""
        if session.get("scaled_writers"):
            raise SemanticError(
                "scaled_writers is not yet ported to trino_tpu_torch"
            )
        return conn.insert(schema, table, batch)

    def _do_createtableasselect(
        self, stmt: t.CreateTableAsSelect, session: Session
    ) -> StatementResult:
        catalog, schema, table = self._qualify(stmt.name, session)
        self.access_control.check_can_create(session.user, catalog, schema, table)
        conn = self.catalogs.get(catalog)
        self._check_txn_writable(session, conn, catalog)
        batch, names = self._run_query_rows(stmt.query, session)
        cols = tuple(
            ColumnSchema(n.lower(), c.type) for n, c in zip(names, batch.columns)
        )
        with self._write_guard(session):
            conn.create_table(schema, table, TableSchema(table, cols))
            n = self._insert(conn, schema, table, batch, session)
        return StatementResult(
            [], ["rows"], [T.BIGINT], update_type="CREATE TABLE", update_count=n
        )

    def _do_insertinto(self, stmt: t.InsertInto, session: Session) -> StatementResult:
        catalog, schema, table = self._qualify(stmt.name, session)
        self.access_control.check_can_insert(session.user, catalog, schema, table)
        conn = self.catalogs.get(catalog)
        self._check_txn_writable(session, conn, catalog)
        ts = conn.get_table(schema, table)
        if ts is None:
            raise SemanticError(f"table not found: {catalog}.{schema}.{table}")
        with self._write_guard(session):
            return self._do_insert_locked(stmt, session, conn, schema, table, ts)

    def _do_insert_locked(self, stmt, session, conn, schema, table, ts) -> StatementResult:
        batch, _ = self._run_query_rows(stmt.query, session)
        ncols = len(stmt.columns) if stmt.columns else len(ts.columns)
        if len(batch.columns) != ncols:
            raise SemanticError(
                f"INSERT has {len(batch.columns)} columns, expected {ncols}"
            )
        if stmt.columns:
            batch = _to_table_columns(batch, stmt.columns, ts)
        n = self._insert(conn, schema, table, batch, session)
        return StatementResult(
            [], ["rows"], [T.BIGINT], update_type="INSERT", update_count=n
        )

    def _do_droptable(self, stmt: t.DropTable, session: Session) -> StatementResult:
        catalog, schema, table = self._qualify(stmt.name, session)
        self.access_control.check_can_drop(session.user, catalog, schema, table)
        conn = self.catalogs.get(catalog)
        self._check_txn_writable(session, conn, catalog)
        if conn.get_table(schema, table) is not None or not stmt.if_exists:
            with self._write_guard(session):
                conn.drop_table(schema, table)
        return StatementResult([], ["result"], [T.BOOLEAN], update_type="DROP TABLE")

    def _do_createtable(self, stmt: t.CreateTable, session: Session) -> StatementResult:
        catalog, schema, table = self._qualify(stmt.name, session)
        self.access_control.check_can_create(session.user, catalog, schema, table)
        conn = self.catalogs.get(catalog)
        self._check_txn_writable(session, conn, catalog)
        if conn.get_table(schema, table) is not None:
            if stmt.not_exists:
                return StatementResult(
                    [], ["result"], [T.BOOLEAN], update_type="CREATE TABLE"
                )
            raise SemanticError(f"table already exists: {catalog}.{schema}.{table}")
        cols = tuple(
            ColumnSchema(n.lower(), T.parse_type(ty)) for n, ty in stmt.columns
        )
        with self._write_guard(session):
            conn.create_table(schema, table, TableSchema(table, cols))
        return StatementResult([], ["result"], [T.BOOLEAN], update_type="CREATE TABLE")

    def _do_delete(self, stmt: t.Delete, session: Session) -> StatementResult:
        """DELETE removes the rows where the predicate is TRUE; rows where
        it is FALSE or NULL remain. Run as keep-filter, truncate and
        reinsert (connector-neutral), as the reference does."""
        catalog, schema, table = self._qualify(stmt.name, session)
        self.access_control.check_can_insert(session.user, catalog, schema, table)
        conn = self.catalogs.get(catalog)
        self._check_txn_writable(session, conn, catalog)
        if conn.get_table(schema, table) is None:
            raise SemanticError(f"table not found: {catalog}.{schema}.{table}")
        if not hasattr(conn, "truncate"):
            raise SemanticError(f"{conn.name}: DELETE not supported")
        with self._write_guard(session):
            return self._do_delete_locked(stmt, session, conn, catalog, schema, table)

    def _do_delete_locked(self, stmt, session, conn, catalog, schema, table) -> StatementResult:
        before = conn.estimate_rows(schema, table) or 0
        if stmt.where is None:
            conn.truncate(schema, table)
            return StatementResult(
                [], ["rows"], [T.BIGINT], update_type="DELETE", update_count=before
            )
        keep = t.Query(body=t.QuerySpec(
            select_items=(t.SelectItem(t.Star()),),
            from_=t.Table((catalog, schema, table)),
            where=t.BinaryOp(
                "OR", t.UnaryOp("NOT", stmt.where), t.IsNull(stmt.where)
            ),
        ))
        batch, _ = self._run_query_rows(keep, session)
        if hasattr(conn, "replace_data"):
            # durable stores swap data atomically: truncate-then-insert
            # would lose kept rows on a crash between the two steps
            conn.replace_data(schema, table, batch)
        else:
            conn.truncate(schema, table)
            if batch.num_rows:
                conn.insert(schema, table, batch)
        return StatementResult(
            [], ["rows"], [T.BIGINT],
            update_type="DELETE", update_count=before - batch.num_rows,
        )

    def _check_txn_writable(self, session: Session, conn, catalog: str) -> None:
        """Connectors without snapshot/restore cannot take part in explicit
        transactions (reference: 'Catalog only supports writes using
        autocommit')."""
        if session.properties.get("__txn") and not hasattr(conn, "snapshot_state"):
            raise SemanticError(
                f"Catalog '{catalog}' only supports writes using autocommit"
            )

    def _write_guard(self, session: Session):
        """Single-writer enforcement for autocommit writes: inside an
        explicit transaction the session already holds the write lock;
        otherwise the statement holds it."""
        if session.properties.get("__txn"):
            return contextlib.nullcontext()
        self.transaction_manager.expire_idle()
        lock = self.transaction_manager.write_lock

        @contextlib.contextmanager
        def guard():
            if not lock.acquire(timeout=60):
                from trino_tpu_torch.transaction import TransactionError

                raise TransactionError("timed out waiting for the write lock")
            try:
                yield
            finally:
                lock.release()

        return guard()

    # === transactions =====================================================

    def _do_starttransaction(self, stmt, session: Session) -> StatementResult:
        if session.properties.get("__txn"):
            raise SemanticError("transaction already in progress")
        txn_id = self.transaction_manager.begin()
        session.properties["__txn"] = txn_id
        return StatementResult(
            [], ["result"], [T.BOOLEAN], update_type="START TRANSACTION",
            started_transaction_id=txn_id,
        )

    def _do_commit(self, stmt, session: Session) -> StatementResult:
        txn = session.properties.get("__txn")
        if not txn:
            raise SemanticError("no transaction in progress")
        self.transaction_manager.commit(txn)
        session.properties.pop("__txn", None)
        return StatementResult([], ["result"], [T.BOOLEAN], update_type="COMMIT",
                               cleared_transaction=True)

    def _do_rollback(self, stmt, session: Session) -> StatementResult:
        txn = session.properties.get("__txn")
        if not txn:
            raise SemanticError("no transaction in progress")
        self.transaction_manager.rollback(txn)
        session.properties.pop("__txn", None)
        return StatementResult([], ["result"], [T.BOOLEAN], update_type="ROLLBACK",
                               cleared_transaction=True)

    # === prepared statements (reference: Session.preparedStatements) ======

    def _do_prepare(self, stmt: t.Prepare, session: Session) -> StatementResult:
        # the SQL text where the statement came as text (it travels in the
        # protocol's headers); the parsed statement otherwise
        session.prepared[stmt.name.lower()] = stmt.sql or stmt.statement
        return StatementResult(
            [], ["result"], [T.BOOLEAN], update_type="PREPARE",
            added_prepare=(stmt.name.lower(), stmt.sql or ""),
        )

    def _do_execute(self, stmt: t.Execute, session: Session) -> StatementResult:
        inner = session.prepared.get(stmt.name.lower())
        if inner is None:
            raise SemanticError(f"prepared statement not found: {stmt.name}")
        if isinstance(inner, str):
            inner = parse_statement(inner)
        return self._dispatch_parsed(_bind_parameters(inner, stmt.parameters), session)

    def _do_deallocate(self, stmt: t.Deallocate, session: Session) -> StatementResult:
        session.prepared.pop(stmt.name.lower(), None)
        return StatementResult(
            [], ["result"], [T.BOOLEAN], update_type="DEALLOCATE",
            deallocated_prepare=stmt.name.lower(),
        )

    def _qualify(self, name_parts, session: Session) -> tuple[str, str, str]:
        parts = list(name_parts)
        if len(parts) == 1:
            return session.catalog, session.schema, parts[0]
        if len(parts) == 2:
            return session.catalog, parts[0], parts[1]
        return parts[0], parts[1], parts[2]


def _to_table_columns(batch: Batch, names, ts: TableSchema) -> Batch:
    """An INSERT's rows with a column list, in the table's column order:
    the named columns placed, every other column NULL. A NULL string is
    code -1 (the reference fills code 0 over an empty dictionary, which a
    later scan of several parts fails to remap)."""
    by_name = {c.lower(): i for i, c in enumerate(names)}
    n = batch.num_rows
    cols = []
    for cs in ts.columns:
        if cs.name in by_name:
            cols.append(batch.columns[by_name[cs.name]])
        else:
            string = T.is_string(cs.type)
            cols.append(Column(
                cs.type,
                as_tensor(np.full(n, -1 if string else 0, dtype=cs.type.storage_dtype)),
                as_tensor(np.zeros(n, dtype=np.bool_)),
                Dictionary([]) if string else None,
            ))
    return Batch(cols, n, batch.sel)


def _bind_parameters(stmt: t.Node, params: tuple) -> t.Node:
    """Replace the ``?`` placeholders with the EXECUTE ... USING
    expressions."""

    def walk(node):
        if isinstance(node, t.Parameter):
            if node.index >= len(params):
                raise SemanticError(
                    f"no value provided for parameter {node.index + 1}"
                )
            return params[node.index]
        if dataclasses.is_dataclass(node) and isinstance(node, t.Node):
            changes = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if isinstance(v, t.Node):
                    changes[f.name] = walk(v)
                elif isinstance(v, tuple):
                    changes[f.name] = tuple(
                        walk(x) if isinstance(x, t.Node)
                        else (
                            tuple(walk(y) if isinstance(y, t.Node) else y for y in x)
                            if isinstance(x, tuple) else x
                        )
                        for x in v
                    )
            return dataclasses.replace(node, **changes) if changes else node
        return node

    return walk(stmt)
