"""File connector: durable tables in the native pages format.

Reference tier: the storage-connector family (``plugin/trino-hive`` +
``lib/trino-orc``/``lib/trino-parquet``) — durable columnar files with
per-file statistics for split pruning. Our format is the engine's own
compressed pages wire format (:mod:`trino_tpu_torch.serde`, PagesSerde analog):
one ``<table>/part-N.ttp`` file per inserted batch plus a JSON schema
sidecar, with min/max column stats collected at write time (the moral
equivalent of ORC stripe footers driving
``TupleDomainOrcPredicate``-style pruning).

A copy of ``trino_tpu/connectors/file.py``: part files are byte-equal to
the reference's for the same batches, and DELETE swaps the table's data
through :meth:`FileConnector.replace_data`. A scaled writer's part is
written staged (``insert_part(pending=True)``: ``<part>.pending``, which
no reader lists) and becomes visible when the coordinator commits it
(:meth:`FileConnector.commit_parts`).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch
from trino_tpu_torch.connectors.api import (
    PENDING_SUFFIX,
    ColumnSchema,
    Connector,
    Split,
    TableSchema,
    commit_staged_parts,
    delete_staged_parts,
)
from trino_tpu_torch.serde import deserialize_batch, serialize_batch

_SCHEMA_FILE = "_schema.json"
_STATS_FILE = "_stats.json"


def _retry_fnf(fn, attempts: int = 50, delay: float = 0.01):
    """Retry around replace_data's brief rename window: a concurrent DELETE
    swaps the table dir with two renames; readers landing in between see
    FileNotFoundError transiently, not table loss."""
    import time

    for i in range(attempts):
        try:
            return fn()
        except FileNotFoundError:
            if i == attempts - 1:
                raise
            time.sleep(delay)


class FileConnector(Connector):
    name = "file"
    # part-file writes land on a shared filesystem, so writer
    # tasks on any node append safely (scaled-writer eligible)
    supports_distributed_writes = True

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # stats cache keyed by (schema, table) -> (mtime, parsed)
        self._stats_cache: dict[tuple[str, str], tuple[float, dict]] = {}

    # --- layout helpers ---------------------------------------------------

    def _table_dir(self, schema: str, table: str) -> str:
        return os.path.join(self.root, schema, table)

    def _in_swap_window(self, d: str) -> bool:
        """True while replace_data is between its two renames (the table dir
        is transiently absent but its staging/trash twin exists)."""
        return os.path.isdir(d + ".staging") or os.path.isdir(d + ".trash")

    def _await_swap(self, d: str, attempts: int = 200, delay: float = 0.01) -> None:
        import time

        for _ in range(attempts):
            if os.path.isdir(d) or not self._in_swap_window(d):
                return
            time.sleep(delay)

    @staticmethod
    def _parts_in(d: str) -> list[str]:
        if not os.path.isdir(d):
            return []
        return sorted(f for f in os.listdir(d) if f.endswith(".ttp"))

    def _parts(self, schema: str, table: str) -> list[str]:
        d = self._table_dir(schema, table)
        if not os.path.isdir(d):
            # a query planning mid-swap must not silently see an empty table
            self._await_swap(d)
        return self._parts_in(d)

    # --- metadata ---------------------------------------------------------

    def list_schemas(self):
        if not os.path.isdir(self.root):
            return ["default"]
        return sorted(
            {d for d in os.listdir(self.root)
             if os.path.isdir(os.path.join(self.root, d))} | {"default"}
        )

    def list_tables(self, schema):
        d = os.path.join(self.root, schema)
        if not os.path.isdir(d):
            return []
        return sorted(
            t for t in os.listdir(d)
            if os.path.exists(os.path.join(d, t, _SCHEMA_FILE))
        )

    def get_table(self, schema, table) -> Optional[TableSchema]:
        d = self._table_dir(schema, table)
        path = os.path.join(d, _SCHEMA_FILE)
        if not os.path.exists(path):
            self._await_swap(d)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            spec = json.load(f)
        return TableSchema(
            table,
            tuple(ColumnSchema(c["name"], T.parse_type(c["type"])) for c in spec["columns"]),
        )

    # --- DDL / write path --------------------------------------------------

    def create_table(self, schema, table, schema_def: TableSchema):
        d = self._table_dir(schema, table)
        if os.path.exists(os.path.join(d, _SCHEMA_FILE)):
            raise ValueError(f"table already exists: {schema}.{table}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, _SCHEMA_FILE), "w") as f:
            json.dump(
                {"columns": [{"name": c.name, "type": str(c.type)} for c in schema_def.columns]},
                f,
            )

    def insert(self, schema, table, batch: Batch) -> int:
        return self.insert_part(schema, table, batch)[0]

    def insert_part(self, schema, table, batch: Batch,
                    pending: bool = False) -> tuple[int, str]:
        """Insert returning (rows, part-file name) so scaled-writer
        coordinators can roll back committed parts when a sibling writer
        fails (reference: TableWriterOperator fragment IDs +
        TableFinishOperator commit). ``pending`` writes the part staged,
        invisible until :meth:`commit_parts`."""
        ts = self.get_table(schema, table)
        if ts is None:
            raise KeyError(f"table not found: {schema}.{table}")
        d = self._table_dir(schema, table)
        rows, part = self._write_part_into(d, ts, batch, pending=pending)
        return rows, part

    def commit_parts(self, schema, table, parts) -> None:
        """Make staged parts visible (the scaled writers' commit)."""
        commit_staged_parts(self._table_dir(schema, table), parts)

    def delete_parts(self, schema, table, parts) -> None:
        """Best-effort removal of named part files, committed or staged
        (+ their stats entries) — the scaled-INSERT abort path."""
        d = self._table_dir(schema, table)
        delete_staged_parts(d, parts)
        stats_path = os.path.join(d, _STATS_FILE)
        try:
            with open(stats_path) as f:
                all_stats = json.load(f)
            for part in parts:
                all_stats.pop(part, None)
            tmp = f"{stats_path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(all_stats, f)
            os.replace(tmp, stats_path)
        except OSError:
            pass

    def _write_part_into(self, d: str, ts: TableSchema, batch: Batch,
                         pending: bool = False) -> tuple[int, str]:
        """Write one part file + stats into an explicit directory (used by
        both the live-table insert path and replace_data staging); a
        ``pending`` part is written under its staged name."""
        import uuid

        compacted = batch.compact()
        # node-unique names: concurrent scaled-writer tasks must not collide
        part = f"part-{len(self._parts_in(d)):05d}-{uuid.uuid4().hex[:8]}.ttp"
        path = os.path.join(d, part + (PENDING_SUFFIX if pending else ""))
        with open(path, "wb") as f:
            f.write(serialize_batch(compacted))
        # per-file column stats (the ORC stripe-footer analog)
        from trino_tpu_torch.connectors.api import batch_column_stats

        stats = {
            name: list(vals)
            for name, vals in batch_column_stats(ts.columns, compacted).items()
        }
        stats_path = os.path.join(d, _STATS_FILE)
        all_stats = {}
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                all_stats = json.load(f)
        all_stats[part] = {"rows": compacted.num_rows, "columns": stats}
        # unique tmp per writer: scaled-writer tasks on several nodes swap
        # concurrently; a lost stats entry only disables pruning for that
        # part (split_stats -> None), never correctness
        tmp = f"{stats_path}.tmp{os.getpid()}-{uuid.uuid4().hex[:6]}"
        with open(tmp, "w") as f:  # atomic swap: a crash never truncates
            json.dump(all_stats, f)
        os.replace(tmp, stats_path)
        return compacted.num_rows, part

    def truncate(self, schema, table):
        d = self._table_dir(schema, table)
        for p in self._parts(schema, table):
            os.remove(os.path.join(d, p))
        sp = os.path.join(d, _STATS_FILE)
        if os.path.exists(sp):
            os.remove(sp)
        self._stats_cache.pop((schema, table), None)

    def replace_data(self, schema, table, batch: Batch) -> None:
        """Atomically replace the table's data (DELETE's keep-set swap):
        stage a full new table directory, then rename into place — a crash
        leaves either the old or the new data, never neither."""
        import shutil

        ts = self.get_table(schema, table)
        if ts is None:
            raise KeyError(f"table not found: {schema}.{table}")
        d = self._table_dir(schema, table)
        staging = d + ".staging"
        trash = d + ".trash"
        for tmp in (staging, trash):
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
        os.makedirs(staging)
        shutil.copy(os.path.join(d, _SCHEMA_FILE), os.path.join(staging, _SCHEMA_FILE))
        if batch.num_rows:
            self._write_part_into(staging, ts, batch)
        os.rename(d, trash)
        os.rename(staging, d)
        shutil.rmtree(trash)
        self._stats_cache.pop((schema, table), None)

    def drop_table(self, schema, table):
        import shutil

        d = self._table_dir(schema, table)
        if os.path.isdir(d):
            shutil.rmtree(d)

    # --- splits + scan -----------------------------------------------------

    def _file_stats(self, schema: str, table: str) -> dict:
        path = os.path.join(self._table_dir(schema, table), _STATS_FILE)
        if not os.path.exists(path):
            return {}
        mtime = os.path.getmtime(path)
        cached = self._stats_cache.get((schema, table))
        if cached is not None and cached[0] == mtime:
            return cached[1]
        with open(path) as f:
            parsed = json.load(f)
        self._stats_cache[(schema, table)] = (mtime, parsed)
        return parsed

    def estimate_rows(self, schema, table):
        if self.get_table(schema, table) is None:
            return None
        return sum(
            s.get("rows", 0) for s in self._file_stats(schema, table).values()
        )

    def get_splits(self, schema, table, target_splits, constraint=None):
        parts = self._parts(schema, table)
        splits = [
            Split(table, i, max(len(parts), 1), info=p)
            for i, p in enumerate(parts)
        ]
        return self.prune_splits(schema, table, splits, constraint)

    def data_version(self, schema, table):
        # part-file list + mtimes (device-table-cache key): appends and
        # rewrites both change it
        d = self._table_dir(schema, table)
        out = []
        for p in self._parts(schema, table):
            try:
                out.append((p, os.path.getmtime(os.path.join(d, p))))
            except OSError:
                out.append((p, 0.0))
        return tuple(out)

    def data_versions(self, schema, table):
        # part files are written once under uuid names (id = filename):
        # an append adds names, a rewrite swaps/mutates them — exactly the
        # data_versions() contract, with mtime_ns+size as the part token
        # (data_version()'s float mtime is a whole-table digest and too
        # coarse to tell the two apart)
        if self.get_table(schema, table) is None:
            return None
        d = self._table_dir(schema, table)
        out = []
        for p in self._parts(schema, table):
            try:
                st = os.stat(os.path.join(d, p))
                out.append((p, (st.st_mtime_ns, st.st_size)))
            except OSError:
                out.append((p, None))
        return out

    def splits_for_parts(self, schema, table, part_ids):
        want = set(part_ids)
        chosen = [p for p in self._parts(schema, table) if p in want]
        return [
            Split(table, i, max(len(chosen), 1), info=p)
            for i, p in enumerate(chosen)
        ]

    def split_stats(self, schema, table, split):
        entry = self._file_stats(schema, table).get(split.info)
        if entry is None:
            return None
        return {
            col: (mn, mx, bool(hn))
            for col, (mn, mx, hn) in entry.get("columns", {}).items()
        }

    def read_split(self, schema, table, columns: Sequence[str], split) -> Batch:
        ts = self.get_table(schema, table)
        d = self._table_dir(schema, table)

        def _read() -> bytes:
            with open(os.path.join(d, split.info), "rb") as f:
                return f.read()

        batch = deserialize_batch(_retry_fnf(_read))
        name_to_idx = {c.name: i for i, c in enumerate(ts.columns)}
        cols = [batch.columns[name_to_idx[c]] for c in columns]
        return Batch(cols, batch.num_rows)
