"""Statement execution engine: the coordinator's analyze/plan/execute core.

Reference: ``execution/SqlQueryExecution.java:373`` (the DQL path) and
``testing/LocalQueryRunner.java``, which drives the same core in-process.
Counterpart of ``trino_tpu/engine.py``: queries and SET SESSION are
ported; other statements (DDL, INSERT, transactions, EXPLAIN, prepared
statements) raise a "not yet ported" error. The ``tpch`` and ``tpcds``
catalogs generate their tables (``connectors/tpch.py``,
``connectors/tpcds.py``); ``memory`` tables are created and loaded
through the memory connector's API (``connectors/memory.py``). The engine
keeps what outlives one query: the capacities earlier runs of a plan grew
to (by plan fingerprint) and the device table cache (``ingest.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Any, Optional

from trino_tpu_torch import resolve_device
from trino_tpu_torch import types as T
from trino_tpu_torch.analyzer import Analyzer, SemanticError
from trino_tpu_torch.config import Session
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.exec.local import LocalExecutor
from trino_tpu_torch.ingest import DeviceTableCache
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
    # per-exchange counters of a distributed run; None for local runs
    exchange_stats: Optional[dict[str, Any]] = None
    # programs traced / compile time: the port runs eagerly, so a query
    # traces nothing and these stay 0
    compile_ms: float = 0.0
    trace_count: int = 0
    program_cache_hits: int = 0
    program_cache_misses: int = 0
    ingest_stats: Optional[dict[str, Any]] = None
    # fragment id -> "streamed" | "materialized" for distributed runs
    fragment_modes: Optional[dict[int, str]] = None


def plan_fingerprint(plan: P.PlanNode) -> str:
    """Identity of an optimized plan: its printed text with the planner's
    symbol counters stripped (``_123`` suffixes), hashed. Two runs of one
    query text share it; plans that differ in shape or in a literal do
    not. Stands in for ``planner/canonicalize.py`` until that is ported."""
    text = re.sub(r"(?:_\d+)+\b", "_#", P.plan_text(plan))
    return hashlib.sha1(text.encode()).hexdigest()


class Engine:
    """Catalogs + statement dispatch, on one torch device.

    ``device`` defaults to ``cuda``; without a GPU the engine raises
    unless the caller passes ``device="cpu"``."""

    def __init__(self, catalogs: Optional[CatalogManager] = None, device=None):
        self.device = resolve_device(device)
        if catalogs is None:
            from trino_tpu_torch.connectors.memory import MemoryConnector
            from trino_tpu_torch.connectors.tpcds import TpcdsConnector
            from trino_tpu_torch.connectors.tpch import TpchConnector

            catalogs = CatalogManager()
            catalogs.register("tpch", TpchConnector())
            catalogs.register("tpcds", TpcdsConnector())
            catalogs.register("memory", MemoryConnector())
        self.catalogs = catalogs
        # capacities grown by earlier runs, by (plan fingerprint, kind,
        # fragment id): a repeat of a plan starts where its last run ended
        self.caps_store: dict = {}
        # scanned tables kept on the device across queries (session
        # property ``table_cache``)
        self.table_cache = DeviceTableCache()

    def execute_statement(self, sql: str, session: Session) -> StatementResult:
        """Run one statement."""
        stmt = parse_statement(sql)
        handler = getattr(self, f"_do_{type(stmt).__name__.lower()}", None)
        if handler is not None:
            return handler(stmt, session)
        if isinstance(stmt, t.Query):
            return self._execute_query_plan(self.plan(stmt, session), session)
        raise SemanticError(
            f"statement {type(stmt).__name__} is not yet ported to trino_tpu_torch"
        )

    def plan(self, stmt: t.Node, session: Session) -> P.PlanNode:
        from trino_tpu_torch.planner.optimizer import optimize

        plan = Analyzer(self.catalogs, session).plan_statement(stmt)
        return optimize(plan, session, self.catalogs)

    # === DQL ==============================================================

    def _execute_query_plan(
        self, plan: P.PlanNode, session: Session
    ) -> StatementResult:
        executor = self._executor(session, plan)
        batch, names = executor.execute(plan)
        return StatementResult(
            batch.to_pylist(),
            names,
            [c.type for c in batch.columns],
            dynamic_filters=len(executor.dynamic_filters),
            exchange_stats=dict(getattr(executor, "exchange_stats", {}) or {})
            or None,
            fragment_modes=dict(getattr(executor, "fragment_modes", {}) or {})
            or None,
            ingest_stats=getattr(executor, "ingest_stats", None),
        )

    def _executor(self, session: Session, plan: P.PlanNode) -> LocalExecutor:
        mode = session.get("execution_mode")
        if mode == "distributed" and session.get("fragment_execution"):
            from trino_tpu_torch.exec.fragments import FragmentedExecutor

            return FragmentedExecutor(
                self.catalogs, session, self.device,
                caps_store=self.caps_store, fingerprint=plan_fingerprint(plan),
                table_cache=self.table_cache,
            )
        if mode not in ("local", "distributed"):
            raise SemanticError(
                f"execution_mode={mode!r} is not yet ported to trino_tpu_torch"
            )
        return LocalExecutor(self.catalogs, session, self.device)

    # === session control ==================================================

    def _do_setsession(self, stmt: t.SetSession, session: Session) -> StatementResult:
        value = stmt.value
        v: Any = value.value if isinstance(value, t.Literal) else None
        session.set(stmt.name, v)
        return StatementResult(
            [], ["result"], [T.BOOLEAN],
            update_type="SET SESSION", set_session={stmt.name: v},
        )
