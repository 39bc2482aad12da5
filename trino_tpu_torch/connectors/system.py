"""System catalog: runtime introspection tables.

Reference: ``core/trino-main/.../connector/system/`` —
``system.runtime.queries`` / ``system.runtime.nodes`` (and
``system.metadata.catalogs``), backed by the coordinator's live state.

A copy of ``trino_tpu/connectors/system.py``: the seven tables with the
reference's schemas. ``runtime.queries``, ``runtime.nodes`` (one node,
the engine's device, or the server's node listing), ``runtime.metrics``
(the metrics registry, ``obs/metrics.py``), ``runtime.programs`` (the
program cache, ``exec/programs.py``, with the profiler's allocator
stats), ``runtime.history`` (the engine's history stores,
``obs/history.py``) and ``metadata.catalogs`` read the engine;
``runtime.tasks`` reads worker tasks, which this package does not keep
yet (ROADMAP item 9c), and has no rows.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, batch_from_numpy
from trino_tpu_torch.connectors.api import ColumnSchema, Connector, Split, TableSchema

_SCHEMAS: dict[str, list[tuple[str, T.SqlType]]] = {
    ("runtime", "queries"): [
        ("query_id", T.VARCHAR),
        ("state", T.VARCHAR),
        ("user", T.VARCHAR),
        ("source", T.VARCHAR),
        ("query", T.VARCHAR),
        ("elapsed_ms", T.BIGINT),
        ("peak_memory_bytes", T.BIGINT),
        ("output_rows", T.BIGINT),
    ],
    ("runtime", "nodes"): [
        ("node_id", T.VARCHAR),
        ("http_uri", T.VARCHAR),
        ("node_version", T.VARCHAR),
        ("coordinator", T.BOOLEAN),
        ("state", T.VARCHAR),
    ],
    ("runtime", "tasks"): [
        ("task_id", T.VARCHAR),
        ("state", T.VARCHAR),
        ("fragment", T.BIGINT),
        ("elapsed_ms", T.BIGINT),
        ("execution_path", T.VARCHAR),
        ("error", T.VARCHAR),
    ],
    ("runtime", "metrics"): [
        ("name", T.VARCHAR),
        ("kind", T.VARCHAR),
        ("value", T.DOUBLE),
    ],
    ("runtime", "programs"): [
        ("fingerprint", T.VARCHAR),
        ("program", T.VARCHAR),
        ("hits", T.BIGINT),
        ("misses", T.BIGINT),
        ("compile_ms", T.DOUBLE),
        ("flops", T.DOUBLE),
        ("peak_hbm_bytes", T.BIGINT),
        ("bytes_accessed", T.DOUBLE),
    ],
    ("runtime", "history"): [
        ("fingerprint", T.VARCHAR),
        ("count", T.BIGINT),
        ("elapsed_ewma_ms", T.DOUBLE),
        ("elapsed_p50_ms", T.DOUBLE),
        ("elapsed_p90_ms", T.DOUBLE),
        ("rows", T.BIGINT),
        ("overflow_retries", T.BIGINT),
        ("compile_halvings", T.BIGINT),
        ("padding_ratio", T.DOUBLE),
        ("peak_hbm_bytes", T.BIGINT),
        ("flops", T.DOUBLE),
        ("capacity_sites", T.BIGINT),
        ("path", T.VARCHAR),
    ],
    ("metadata", "catalogs"): [
        ("catalog_name", T.VARCHAR),
        ("connector_name", T.VARCHAR),
    ],
}


class SystemConnector(Connector):
    """Bound to an Engine; rows materialize live state at scan time."""

    name = "system"
    # live process state, not versioned data: never result-cacheable
    supports_result_caching = False

    def __init__(self, engine):
        self._engine = engine

    def list_schemas(self):
        return sorted({s for s, _ in _SCHEMAS})

    def list_tables(self, schema):
        return sorted(t for s, t in _SCHEMAS if s == schema)

    def get_table(self, schema, table):
        cols = _SCHEMAS.get((schema, table))
        if cols is None:
            return None
        return TableSchema(
            table, tuple(ColumnSchema(n, ty) for n, ty in cols)
        )

    def get_splits(self, schema, table, target_splits, constraint=None):
        return [Split(table, 0, 1, info=schema)]

    def read_split(self, schema, table, columns: Sequence[str], split):
        schema = split.info or schema
        spec = _SCHEMAS[(schema, table)]
        rows = self._rows(schema, table)
        names, batch = [n for n, _ in spec], _rows_batch(spec, rows)
        idx = {n: i for i, n in enumerate(names)}
        cols = [batch.columns[idx[c]] for c in columns]
        return Batch(cols, batch.num_rows)

    def _rows(self, schema: str, table: str) -> list[tuple]:
        eng = self._engine
        if (schema, table) == ("runtime", "queries"):
            return [
                (
                    q["queryId"], q["state"], q["user"], q.get("source", ""),
                    q["query"], q["elapsedTimeMillis"],
                    q.get("peakMemoryBytes", 0), q.get("outputRows", 0),
                )
                for q in eng.runtime_queries()
            ]
        if (schema, table) == ("runtime", "nodes"):
            return [n for n in eng.runtime_nodes()]
        if (schema, table) == ("runtime", "tasks"):
            return [
                (
                    t["taskId"], str(t["state"]), t.get("fragment"),
                    int(float(t.get("elapsed") or 0.0) * 1000),
                    t.get("executionPath", ""), t.get("error"),
                )
                for t in eng.runtime_tasks()
            ]
        if (schema, table) == ("runtime", "metrics"):
            return list(eng.runtime_metrics())
        if (schema, table) == ("runtime", "programs"):
            return [
                (
                    p["fingerprint"], p["program"], p["hits"], p["misses"],
                    p["compile_ms"], p.get("flops"),
                    p.get("peak_hbm_bytes"), p.get("bytes_accessed"),
                )
                for p in eng.runtime_programs()
            ]
        if (schema, table) == ("runtime", "history"):
            return [
                (
                    h["fingerprint"], h.get("count", 0),
                    h.get("elapsed_ms"), h.get("elapsed_p50_ms"),
                    h.get("elapsed_p90_ms"), h.get("rows"),
                    h.get("overflow_retries", 0),
                    h.get("compile_halvings", 0),
                    h.get("padding_ratio"), h.get("peak_hbm_bytes"),
                    h.get("flops"), len(h.get("capacities") or {}),
                    h.get("path", ""),
                )
                for h in eng.runtime_history()
            ]
        if (schema, table) == ("metadata", "catalogs"):
            return [
                (name, eng.catalogs.get(name).name) for name in eng.catalogs.names()
            ]
        return []


def _rows_batch(spec, rows) -> Batch:
    """A host batch of row-major Python values (None is NULL)."""
    types, arrays, valids = [], [], []
    for j, (_, t) in enumerate(spec):
        vals = [r[j] for r in rows]
        valid = np.array([v is not None for v in vals], dtype=np.bool_)
        fill = "" if T.is_string(t) else 0
        types.append(t)
        arrays.append(np.array(
            [v if v is not None else fill for v in vals],
            dtype=object if T.is_string(t) else t.storage_dtype,
        ))
        valids.append(None if valid.all() else valid)
    return batch_from_numpy(types, arrays, valids)
