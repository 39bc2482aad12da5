"""Parquet connector: directory-of-files tables (the hive-style layout).

Reference: ``plugin/trino-hive`` selecting ``lib/trino-parquet`` readers
(``HivePageSourceProvider``); splits are (file, row-group) pairs and
row-group statistics drive TupleDomain split pruning
(``TupleDomainParquetPredicate``). Layout: ``<root>/<schema>/<table>/*.parquet``;
schema is read from the first file's footer.

Writes (CTAS/INSERT) produce one parquet file per insert via the
from-scratch writer in :mod:`trino_tpu_torch.formats.parquet`.

A copy of ``trino_tpu/connectors/parquet.py`` with the same split layout
and statistics. A split reads the file's footer (cached by path and
mtime) and its row group's column chunks only; the reference reads the
whole file for each row group.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

from trino_tpu_torch.columnar import Batch
from trino_tpu_torch.connectors.api import ColumnSchema, Connector, Split, TableSchema
from trino_tpu_torch.formats import parquet as PQ


class ParquetConnector(Connector):
    name = "parquet"
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # (path, mtime) -> FileMeta; footers are small and hot
        self._meta_cache: dict[tuple[str, float], PQ.FileMeta] = {}
        self._write_lock = threading.Lock()

    # --- layout -----------------------------------------------------------

    def _table_dir(self, schema: str, table: str) -> str:
        return os.path.join(self.root, schema, table)

    def _files(self, schema: str, table: str) -> list[str]:
        d = self._table_dir(schema, table)
        if not os.path.isdir(d):
            return []
        return sorted(
            os.path.join(d, f) for f in os.listdir(d) if f.endswith(".parquet")
        )

    def _meta(self, path: str) -> PQ.FileMeta:
        mtime = os.path.getmtime(path)
        key = (path, mtime)
        meta = self._meta_cache.get(key)
        if meta is None:
            with open(path, "rb") as f:
                meta = PQ.read_file_footer(f)
            self._meta_cache[key] = meta
        return meta

    # --- metadata ---------------------------------------------------------

    def list_schemas(self) -> list[str]:
        if not os.path.isdir(self.root):
            return ["default"]
        return sorted(
            {
                d
                for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d))
            }
            | {"default"}
        )

    def list_tables(self, schema: str) -> list[str]:
        d = os.path.join(self.root, schema)
        if not os.path.isdir(d):
            return []
        return sorted(
            t
            for t in os.listdir(d)
            if os.path.isdir(os.path.join(d, t))
        )

    def get_table(self, schema: str, table: str) -> Optional[TableSchema]:
        files = self._files(schema, table)
        if not files:
            return None
        meta = self._meta(files[0])
        return TableSchema(
            table,
            tuple(
                ColumnSchema(c.name, c.sql_type()) for c in meta.schema
            ),
        )

    # --- splits: one per (file, row group) --------------------------------

    def get_splits(self, schema, table, target_splits, constraint=None):
        pairs = []
        for path in self._files(schema, table):
            meta = self._meta(path)
            for rg in range(len(meta.row_groups)):
                pairs.append((path, rg))
        splits = [
            Split(table, i, len(pairs), info=pair)
            for i, pair in enumerate(pairs)
        ]
        return self.prune_splits(schema, table, splits, constraint)

    def split_stats(self, schema, table, split):
        path, rg = split.info
        return PQ.row_group_stats(self._meta(path), rg)

    def read_split(
        self, schema, table, columns: Sequence[str], split
    ) -> Batch:
        path, rg = split.info
        meta = self._meta(path)
        with open(path, "rb") as f:
            return PQ.read_row_group(f, meta, rg, list(columns))

    def estimate_rows(self, schema, table) -> Optional[int]:
        files = self._files(schema, table)
        if not files:
            return None
        return sum(self._meta(p).num_rows for p in files)

    def data_version(self, schema, table):
        # part-file list + mtimes: INSERT appends a file, overwrites bump
        # mtime — either changes the device-table-cache key
        return tuple(
            (os.path.basename(p), os.path.getmtime(p))
            for p in self._files(schema, table)
        )

    def data_versions(self, schema, table):
        # one immutable uuid-named file per insert (id = basename, token =
        # mtime_ns+size): appends add pairs, rewrites change them — unlike
        # data_version()'s whole-table digest, a result cache can tell
        # which happened and maintain instead of invalidating
        if self.get_table(schema, table) is None:
            return None
        out = []
        for p in self._files(schema, table):
            try:
                st = os.stat(p)
                out.append((os.path.basename(p), (st.st_mtime_ns, st.st_size)))
            except OSError:
                out.append((os.path.basename(p), None))
        return out

    def splits_for_parts(self, schema, table, part_ids):
        want = set(part_ids)
        pairs = []
        for path in self._files(schema, table):
            if os.path.basename(path) not in want:
                continue
            meta = self._meta(path)
            for rg in range(len(meta.row_groups)):
                pairs.append((path, rg))
        return [
            Split(table, i, max(len(pairs), 1), info=pair)
            for i, pair in enumerate(pairs)
        ]


    # --- writes -----------------------------------------------------------

    def create_table(self, schema, table, schema_def: TableSchema) -> None:
        d = self._table_dir(schema, table)
        if os.path.isdir(d) and self._files(schema, table):
            raise ValueError(f"table already exists: {schema}.{table}")
        os.makedirs(d, exist_ok=True)
        self._pending_schema = schema_def  # first insert writes the footer

    def insert(self, schema, table, batch: Batch) -> int:
        d = self._table_dir(schema, table)
        if not os.path.isdir(d):
            raise KeyError(f"table not found: {schema}.{table}")
        ts = self.get_table(schema, table)
        names = (
            [c.name for c in ts.columns]
            if ts is not None
            else [c.name for c in getattr(self, "_pending_schema").columns]
        )
        with self._write_lock:
            import uuid

            # node-unique part names: concurrent writer tasks on several
            # nodes append without coordination (scaled writers)
            n = len(self._files(schema, table))
            path = os.path.join(
                d, f"part-{n:05d}-{uuid.uuid4().hex[:8]}.parquet"
            )
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                PQ.write_parquet(f, names, [batch])
            os.replace(tmp, path)
        return batch.compact().num_rows

    def drop_table(self, schema, table) -> None:
        import shutil

        d = self._table_dir(schema, table)
        if os.path.isdir(d):
            shutil.rmtree(d)
