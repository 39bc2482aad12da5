"""Semantic result cache + incremental aggregate maintenance.

Copy of ``trino_tpu/cache/result_cache.py`` with its imports cut over to
this package. The program cache dedups captures (canonical-plan
fingerprints), the device table cache dedups device data, the history
store dedups sizing; this module dedups the RESULT. Final result sets
are keyed by ``(canonical fingerprint, hoisted-param vector)`` and
validated against per-catalog data versions plus the access-control
generation, under a byte-budget LRU. A warm repeat returns host rows:
it stages nothing, reserves no memory and launches no kernel.

Incremental aggregate maintenance: when a cached entry's only staleness
is an APPEND — detected via part-level :meth:`Connector.data_versions`,
where every old ``(part_id, token)`` pair survived and new ids arrived —
and the plan is aggregation-rooted with exactly-mergeable aggregates
(:func:`trino_tpu_torch.planner.canonicalize.classify_maintainability`),
the cached plan is re-executed over ONLY the appended parts through a
:class:`DeltaPartsConnector` (``LocalExecutor``, ``execution_mode=local``,
on the engine's device) and the fresh partial-aggregate rows are merged
into the cached rows on the host. Everything else invalidates.

Concurrency discipline:

- ``_lock`` guards the entry map/byte budget and is only ever held for
  dict operations — never across connector IO, planning, or execution.
- maintenance serializes per entry under a separate mutex acquired
  WITHOUT ``_lock`` held (lock order is strictly maintenance -> cache);
  it runs on the caller's thread, which for the server is always a
  dispatch-pool worker (the QueryManager admission fast path probes with
  ``allow_maintenance=False``), never the event loop.
- entries are immutable; maintenance publishes a replacement atomically,
  so concurrent readers always observe a consistent snapshot — either
  the pre-append rows or the fully merged rows, never a half-merge.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Optional

from trino_tpu_torch.planner import plan as P


def session_signature(session) -> tuple:
    """The session facets that change what a SQL text means or traces
    into: name resolution context plus every codegen-relevant property
    (same list the plan fingerprint folds in, so the SQL-text memo can
    never alias two sessions onto one fingerprint)."""
    from trino_tpu_torch.planner.canonicalize import _CODEGEN_PROPS

    props = []
    for name in _CODEGEN_PROPS + ("constant_hoisting", "program_cache"):
        try:
            props.append((name, repr(session.get(name))))
        except KeyError:
            continue
    return (session.catalog, session.schema, tuple(props))


def referenced_tables(root: P.PlanNode) -> list[tuple[str, str, str]]:
    """Every (catalog, schema, table) scanned by this plan, sorted."""
    out: list[tuple[str, str, str]] = []
    seen: set[tuple[str, str, str]] = set()
    stack = [root]
    while stack:
        node = stack.pop()
        if isinstance(node, P.TableScan):
            key = (node.catalog, node.schema, node.table)
            if key not in seen:
                seen.add(key)
                out.append(key)
        stack.extend(node.sources)
    return sorted(out)


def versions_snapshot(catalogs, tables) -> tuple:
    """Per-table ``(catalog, schema, table, coarse_token, parts|None)``.
    ``parts`` is the connector's part-level data_versions() enumeration
    when it has one (enables append detection); the coarse data_version()
    token otherwise (any change then invalidates)."""
    out = []
    for cat, schema, table in tables:
        conn = catalogs.get(cat)
        coarse = conn.data_version(schema, table)
        parts = conn.data_versions(schema, table)
        out.append(
            (cat, schema, table, coarse, None if parts is None else tuple(parts))
        )
    return tuple(out)


def _estimate_bytes(rows) -> int:
    """Deterministic host-memory estimate of a result set (drives the
    byte-budget LRU; CPython sizeof-ish constants, exactness irrelevant)."""
    n = 64
    for row in rows:
        n += 56
        for v in row:
            if v is None:
                n += 8
            elif isinstance(v, str):
                n += 49 + len(v)
            elif isinstance(v, (bytes, bytearray)):
                n += 33 + len(v)
            else:
                n += 32
    return n


def merge_aggregate_rows(cached_rows, delta_rows, cols) -> tuple:
    """Merge delta partial-aggregate rows into cached final rows.

    ``cols`` is the per-output-column kind vector from
    ``classify_maintainability``: ``key`` columns identify the group,
    ``sum``/``count``/``min``/``max`` merge by exact row-wise combine
    (None is the sum/min/max identity; count never yields None). Cached
    group order is preserved; new groups append in delta order — row
    order of a GROUP BY without ORDER BY is unspecified, and the cached
    entry serves one stable order.
    """
    key_idx = tuple(i for i, k in enumerate(cols) if k == "key")
    merged: "OrderedDict[tuple, list]" = OrderedDict()
    for row in cached_rows:
        merged[tuple(row[i] for i in key_idx)] = list(row)
    for row in delta_rows:
        k = tuple(row[i] for i in key_idx)
        cur = merged.get(k)
        if cur is None:
            merged[k] = list(row)
            continue
        for i, kind in enumerate(cols):
            if kind == "key":
                continue
            cur[i] = _merge_value(kind, cur[i], row[i])
    return tuple(tuple(r) for r in merged.values())


def _merge_value(kind: str, a, b):
    if kind == "count":
        return (a or 0) + (b or 0)
    if a is None:
        return b
    if b is None:
        return a
    if kind == "sum":
        return a + b
    if kind == "min":
        return a if a <= b else b
    if kind == "max":
        return a if a >= b else b
    raise ValueError(f"unmergeable aggregate kind: {kind}")


class DeltaPartsConnector:
    """Read-only view of one table restricted to named parts — the scan
    source for incremental maintenance.

    Explicit delegation only: inheriting (or ``__getattr__``-forwarding)
    the inner connector would leak full-table shortcuts — ``device_slab``
    staging, ``apply_aggregation_count``, limit pushdown — that silently
    read rows outside the delta. Every pushdown hook answers "no" so the
    executor actually scans exactly the delta splits."""

    supports_result_caching = False
    supports_distributed_writes = False

    def __init__(self, inner, schema: str, table: str, part_ids):
        self._inner = inner
        self._schema = schema
        self._table = table
        self._part_ids = list(part_ids)
        self.name = getattr(inner, "name", "connector")

    # --- metadata (pass-through) -----------------------------------------
    def list_schemas(self):
        return self._inner.list_schemas()

    def list_tables(self, schema):
        return self._inner.list_tables(schema)

    def get_table(self, schema, table):
        return self._inner.get_table(schema, table)

    # --- splits: the delta ------------------------------------------------
    def get_splits(self, schema, table, target_splits, constraint=None):
        if (schema, table) != (self._schema, self._table):
            return self._inner.get_splits(schema, table, target_splits, constraint)
        splits = self._inner.splits_for_parts(schema, table, self._part_ids)
        return self._inner.prune_splits(schema, table, splits, constraint)

    def get_splits_with_hints(
        self, schema, table, target_splits, constraint=None, limit=None, topn=None
    ):
        return self.get_splits(schema, table, target_splits, constraint)

    def prune_splits(self, schema, table, splits, constraint):
        return self._inner.prune_splits(schema, table, splits, constraint)

    def split_stats(self, schema, table, split):
        return self._inner.split_stats(schema, table, split)

    def read_split(self, schema, table, columns, split):
        return self._inner.read_split(schema, table, columns, split)

    def data_version(self, schema, table):
        return self._inner.data_version(schema, table)

    def data_versions(self, schema, table):
        return self._inner.data_versions(schema, table)

    # --- pushdowns: all declined (stats describe the FULL table) ----------
    def apply_limit(self, schema, table, count):
        return False

    def apply_topn(self, schema, table, keys, count):
        return False

    def apply_aggregation_count(self, schema, table):
        return None

    def estimate_rows(self, schema, table):
        return None

    def table_stats(self, schema, table):
        return None


@dataclasses.dataclass(frozen=True)
class ResultCacheEntry:
    """One cached result set. Immutable: maintenance builds a replacement
    and publishes it atomically under the cache lock."""

    fingerprint: str
    params_key: tuple
    sql: str
    rows: tuple  # tuple of row tuples (host-resident final values)
    column_names: tuple
    column_types: tuple
    tables: tuple  # ((catalog, schema, table), ...)
    versions: tuple  # versions_snapshot() taken BEFORE the execution
    acl_generation: int
    nbytes: int
    created: float
    # classify_maintainability() verdict + the baked optimized plan it
    # applies to (re-executed over delta splits); None = invalidate-only
    maintain: Optional[dict] = None
    plan: Any = None
    maintained_count: int = 0


class ResultCache:
    """Byte-budget LRU of final result sets + the SQL-text memo that
    makes the probe parse-free (sub-millisecond hits cannot afford
    parse+plan; the memo maps ``(sql, session signature)`` straight to
    the entry key and is populated at store time)."""

    MEMO_MAX = 4096

    def __init__(self, max_bytes: int = 64 << 20):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, ResultCacheEntry]" = OrderedDict()
        self._entry_hits: dict[tuple, int] = {}
        self._memo: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._maint_locks: dict[tuple, threading.Lock] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.maintained = 0
        self.invalidations = 0

    # --- metrics ----------------------------------------------------------
    @staticmethod
    def _metric_inc(name: str, n: int = 1) -> None:
        try:
            from trino_tpu_torch.obs.metrics import get_registry

            # closed vocabulary: callers pass literal suffixes only
            get_registry().counter(f"trino_tpu_result_cache_{name}").inc(n)
        except Exception:  # noqa: BLE001 — metrics must never fail a query
            pass

    def _metric_bytes(self) -> None:
        try:
            from trino_tpu_torch.obs.metrics import get_registry

            get_registry().gauge("trino_tpu_result_cache_bytes").set(self._bytes)
        except Exception:  # noqa: BLE001
            pass

    # --- probe ------------------------------------------------------------
    def lookup(self, engine, sql: str, session, allow_maintenance: bool = True):
        """A StatementResult served from cache, or None.

        Pure hits are lock-brief and IO-free beyond the per-table version
        fetch. With ``allow_maintenance`` (engine probe on a worker
        thread) an append-stale maintainable entry is merged in place;
        without it (admission fast path) such entries simply miss and the
        admitted execution maintains or overwrites them.
        """
        memo_key = (sql, session_signature(session))
        with self._lock:
            memo = self._memo.get(memo_key)
            if memo is not None:
                self._memo.move_to_end(memo_key)
        if memo is None:
            return None  # unknown text/session: not counted as a miss
        fp, params_key, tables = memo
        from trino_tpu_torch.security import AccessDeniedError

        try:
            for cat, schema, table in tables:
                engine.access_control.check_can_select(
                    session.user, cat, schema, table
                )
        except AccessDeniedError:
            return None  # the full path raises the user-visible error
        key = (fp, params_key)
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            self._miss()
            return None
        if entry.acl_generation != engine.access_control.generation:
            self._drop(key)
            self._miss()
            return None
        status, deltas = self._compare_versions(engine.catalogs, entry)
        if status == "same":
            res = self._serve(key)
            if res is None:
                self._miss()
            return res
        if status == "append" and entry.maintain is not None:
            if not allow_maintenance or not _maintenance_on(session):
                # leave the entry intact: a maintaining caller (or the
                # store after a full re-execution) will refresh it
                self._miss()
                return None
            res = self._maintain(engine, key, session)
            if res is None:
                self._miss()
            return res
        self._drop(key)
        self._miss()
        return None

    def _miss(self) -> None:
        with self._lock:
            self.misses += 1
        self._metric_inc("misses")

    def _serve(self, key, extra: Optional[dict] = None, ingest_stats=None):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            self._entry_hits[key] = self._entry_hits.get(key, 0) + 1
            entry_hits = self._entry_hits[key]
            self.hits += 1
        self._metric_inc("hits")
        from trino_tpu_torch.engine import StatementResult

        stats = {
            "resultCacheHit": 1,
            "entryHits": entry_hits,
            "maintainedCount": entry.maintained_count,
        }
        if extra:
            stats.update(extra)
        return StatementResult(
            rows=list(entry.rows),
            column_names=list(entry.column_names),
            column_types=list(entry.column_types),
            ingest_stats=ingest_stats,
            result_cache_stats=stats,
        )

    def _drop(self, key) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return
            self._bytes -= entry.nbytes
            self._entry_hits.pop(key, None)
            self.invalidations += 1
        self._metric_inc("invalidations")
        self._metric_bytes()

    def _compare_versions(self, catalogs, entry: ResultCacheEntry):
        """("same"|"append"|"changed", {table -> (appended_ids, new_parts)})."""
        from trino_tpu_torch.ingest import parts_delta

        status = "same"
        deltas: dict[tuple, tuple] = {}
        for cat, schema, table, coarse, parts in entry.versions:
            try:
                conn = catalogs.get(cat)
            except KeyError:
                return "changed", {}
            if parts is not None:
                new_parts = conn.data_versions(schema, table)
                if new_parts is None:
                    return "changed", {}
                new_parts = tuple(new_parts)
                if new_parts == parts:
                    continue
                verdict, appended = parts_delta(parts, new_parts)
                if verdict == "same":
                    continue
                if verdict != "append":
                    return "changed", {}
                status = "append"
                deltas[(cat, schema, table)] = (appended, new_parts)
            elif conn.data_version(schema, table) != coarse:
                return "changed", {}
        return status, deltas

    # --- store ------------------------------------------------------------
    def store(
        self,
        *,
        sql: str,
        session,
        fingerprint: str,
        params: list,
        tables,
        versions: tuple,
        acl_generation: int,
        res,
        maintain: Optional[dict],
        plan,
        max_bytes: Optional[int] = None,
    ) -> bool:
        """Insert/replace the entry for this execution (versions are the
        PRE-execution snapshot, so a write racing the execution leaves the
        entry conservatively stale, never wrong)."""
        if max_bytes is not None:
            self.max_bytes = int(max_bytes)
        params_key = tuple((v, repr(t)) for v, t in params)
        rows = tuple(tuple(r) for r in res.rows)
        nbytes = _estimate_bytes(rows)
        if nbytes > self.max_bytes:
            return False  # a single oversized result would evict everything
        entry = ResultCacheEntry(
            fingerprint=fingerprint,
            params_key=params_key,
            sql=sql,
            rows=rows,
            column_names=tuple(res.column_names),
            column_types=tuple(res.column_types),
            tables=tuple(tables),
            versions=versions,
            acl_generation=acl_generation,
            nbytes=nbytes,
            created=time.time(),
            maintain=maintain,
            plan=plan,
        )
        key = (fingerprint, params_key)
        memo_key = (sql, session_signature(session))
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                k, e = self._entries.popitem(last=False)
                self._bytes -= e.nbytes
                self._entry_hits.pop(k, None)
                self._maint_locks.pop(k, None)
                self.evictions += 1
                evicted += 1
            self._memo[memo_key] = (fingerprint, params_key, tuple(tables))
            self._memo.move_to_end(memo_key)
            while len(self._memo) > self.MEMO_MAX:
                self._memo.popitem(last=False)
        if evicted:
            self._metric_inc("evictions", evicted)
        self._metric_bytes()
        return True

    # --- incremental maintenance ------------------------------------------
    def _maint_lock(self, key) -> threading.Lock:
        with self._lock:
            return self._maint_locks.setdefault(key, threading.Lock())

    def _maintain(self, engine, key, session):
        """Merge an append delta into the cached entry and serve it.

        Runs on the calling worker thread; serialized per entry by a
        mutex acquired without the cache lock (order: maintenance ->
        cache, never the reverse). Any surprise — rewrite raced in,
        delta execution failed, a writer appended again mid-merge —
        drops the entry and falls back to full re-execution.
        """
        with self._maint_lock(key):
            with self._lock:
                entry = self._entries.get(key)
            if entry is None:
                return None
            # re-validate under the maintenance lock: another maintainer
            # may have merged while this caller waited
            status, deltas = self._compare_versions(engine.catalogs, entry)
            if status == "same":
                return self._serve(key)
            if status != "append" or entry.maintain is None or entry.plan is None:
                self._drop(key)
                return None
            table_key = tuple(entry.maintain["table"])
            if set(deltas) != {table_key}:
                self._drop(key)
                return None
            appended, new_parts = deltas[table_key]
            try:
                merged, ingest = self._execute_delta(engine, entry, session, appended)
            except Exception:  # noqa: BLE001 — fall back to re-execution
                self._drop(key)
                return None
            cat, schema, table = table_key
            conn = engine.catalogs.get(cat)
            # only publish when the table still reads exactly as the
            # snapshot the merge brought the rows up to (a writer racing
            # the delta scan otherwise makes the merge unanchored)
            check = conn.data_versions(schema, table)
            if check is None or tuple(check) != new_parts:
                self._drop(key)
                return None
            new_versions = tuple(
                v
                if (v[0], v[1], v[2]) != table_key
                else (cat, schema, table, conn.data_version(schema, table), new_parts)
                for v in entry.versions
            )
            replacement = dataclasses.replace(
                entry,
                rows=merged,
                versions=new_versions,
                nbytes=_estimate_bytes(merged),
                maintained_count=entry.maintained_count + 1,
            )
            evicted = 0
            with self._lock:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._bytes -= old.nbytes
                self._entries[key] = replacement
                self._bytes += replacement.nbytes
                self.maintained += 1
                while self._bytes > self.max_bytes and len(self._entries) > 1:
                    k, e = self._entries.popitem(last=False)
                    self._bytes -= e.nbytes
                    self._entry_hits.pop(k, None)
                    self._maint_locks.pop(k, None)
                    self.evictions += 1
                    evicted += 1
            if evicted:
                self._metric_inc("evictions", evicted)
            self._metric_inc("maintained")
            self._metric_bytes()
            return self._serve(
                key,
                extra={
                    "incrementalMaintenance": 1,
                    "deltaSplits": int(ingest.get("splits_decoded", 0)),
                },
                ingest_stats=ingest or None,
            )

    def _execute_delta(self, engine, entry: ResultCacheEntry, session, appended):
        """Execute the entry's baked plan over ONLY the appended parts and
        merge; returns (merged_rows, delta ingest stats)."""
        from trino_tpu_torch.config import Session
        from trino_tpu_torch.connectors.api import CatalogManager
        from trino_tpu_torch.exec.local import LocalExecutor

        cat, schema, table = entry.maintain["table"]
        inner = engine.catalogs.get(cat)
        delta_conn = DeltaPartsConnector(inner, schema, table, appended)
        catalogs = CatalogManager()
        for name in engine.catalogs.names():
            catalogs.register(
                name, delta_conn if name == cat else engine.catalogs.get(name)
            )
        props = dict(session.properties)
        props.pop("__txn", None)
        props["execution_mode"] = "local"
        msession = Session(
            user=session.user,
            catalog=session.catalog,
            schema=session.schema,
            properties=props,
        )
        executor = LocalExecutor(catalogs, msession, engine.device)
        batch, _names = executor.execute(entry.plan)
        delta_rows = batch.to_pylist()
        ingest = dict(executor.ingest_stats)
        merged = merge_aggregate_rows(entry.rows, delta_rows, entry.maintain["cols"])
        return merged, ingest

    # --- introspection (GET /v1/cache) ------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready state (brief lock only: safe to call from the event
        loop, same discipline as /v1/metrics)."""
        now = time.time()
        with self._lock:
            entries = [
                {
                    "fingerprint": e.fingerprint,
                    "query": e.sql.splitlines()[0][:120] if e.sql else "",
                    "rows": len(e.rows),
                    "nbytes": e.nbytes,
                    "hits": self._entry_hits.get(k, 0),
                    "maintainable": e.maintain is not None,
                    "maintainedCount": e.maintained_count,
                    "ageMs": int((now - e.created) * 1000),
                }
                for k, e in self._entries.items()
            ]
            return {
                "entries": entries,
                "totalBytes": self._bytes,
                "maxBytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "maintained": self.maintained,
                "invalidations": self.invalidations,
                "memoSize": len(self._memo),
            }


def _maintenance_on(session) -> bool:
    try:
        return bool(session.get("incremental_maintenance"))
    except KeyError:
        return False
