"""ORC connector: directory-of-files tables (hive-style layout).

Reference: ``plugin/trino-hive`` selecting ``lib/trino-orc`` readers and
writers (``OrcReader.java:66,251``, ``OrcWriter.java``); splits are
(file, stripe) pairs and stripe statistics drive TupleDomain split
pruning (``TupleDomainOrcPredicate.java:74``). Layout:
``<root>/<schema>/<table>/*.orc``; the table schema is read from the
first file's footer. Writes (CTAS/INSERT) produce one ORC file per
insert via the from-scratch writer in :mod:`trino_tpu_torch.formats.orc`.

A copy of ``trino_tpu/connectors/orc.py``: the same split layout and
stripe statistics.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

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
from trino_tpu_torch.formats import orc as ORC


class OrcConnector(Connector):
    name = "orc"
    # part-file writes land on a shared filesystem, so writer tasks on
    # any node append safely (scaled-writer eligible)
    supports_distributed_writes = True
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._file_cache: dict[tuple[str, float], ORC.OrcFile] = {}

    # --- layout -----------------------------------------------------------

    def _table_dir(self, schema: str, table: str) -> str:
        return os.path.join(self.root, schema, table)

    def _files(self, schema: str, table: str) -> list[str]:
        d = self._table_dir(schema, table)
        if not os.path.isdir(d):
            return []
        return sorted(
            os.path.join(d, f) for f in os.listdir(d) if f.endswith(".orc")
        )

    def _file(self, path: str) -> ORC.OrcFile:
        mtime = os.path.getmtime(path)
        key = (path, mtime)
        f = self._file_cache.get(key)
        if f is None:
            with open(path, "rb") as fh:
                f = ORC.OrcFile(fh.read())
            self._file_cache[key] = f
        return f

    # --- metadata ---------------------------------------------------------

    def list_schemas(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d
            for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )

    def list_tables(self, schema: str) -> list[str]:
        d = os.path.join(self.root, schema)
        if not os.path.isdir(d):
            return []
        return sorted(
            t for t in os.listdir(d) if os.path.isdir(os.path.join(d, t))
        )

    def get_table(self, schema: str, table: str) -> Optional[TableSchema]:
        files = self._files(schema, table)
        if not files:
            return None
        f = self._file(files[0])
        cols = []
        for name, type_id in zip(f.column_names, f.column_type_ids):
            cols.append(ColumnSchema(name, f.types[type_id].sql_type()))
        return TableSchema(table, tuple(cols))

    # --- splits: one per (file, stripe) -----------------------------------

    def get_splits(self, schema, table, target_splits, constraint=None):
        pairs = []
        for path in self._files(schema, table):
            f = self._file(path)
            for si in range(len(f.stripes)):
                pairs.append((path, si))
        splits = [
            Split(table, i, len(pairs), info=pair)
            for i, pair in enumerate(pairs)
        ]
        return self.prune_splits(schema, table, splits, constraint)

    def split_stats(self, schema, table, split):
        """Stripe column stats -> (min, max, has_null) per column name for
        the split pruner (reference TupleDomainOrcPredicate)."""
        path, si = split.info
        f = self._file(path)
        stats = f.stripe_stats(si)
        if not stats:
            return None
        out = {}
        for name, type_id in zip(f.column_names, f.column_type_ids):
            s = stats.get(type_id)
            if s is None or s.min_value is None:
                continue
            mn, mx = s.min_value, s.max_value
            t = f.types[type_id]
            if t.kind == ORC.KIND_DECIMAL and isinstance(mn, str):
                import decimal

                # exact: float64 loses digits past ~15 significant figures
                # (and the default Decimal context rounds past 28), which
                # could prune a split that still contains matches
                scale = t.scale
                with decimal.localcontext() as ctx:
                    ctx.prec = 60
                    mn = int(decimal.Decimal(mn).scaleb(scale).to_integral_value())
                    mx = int(decimal.Decimal(mx).scaleb(scale).to_integral_value())
            out[name] = (mn, mx, s.has_null)
        return out or None

    def read_split(
        self, schema, table, columns: Sequence[str], split
    ) -> Batch:
        path, si = split.info
        f = self._file(path)
        cols = f.read_stripe(f.stripes[si], set(columns))
        out = [cols[c] for c in columns]
        n = f.stripes[si].num_rows
        return Batch(out, n)

    def estimate_rows(self, schema, table) -> Optional[int]:
        files = self._files(schema, table)
        if not files:
            return None
        return sum(self._file(p).num_rows for p in files)

    def data_version(self, schema, table):
        # file list + mtimes key the device table cache: INSERT appends a
        # file, so warm cached scans miss instead of serving stale rows
        return tuple(
            (os.path.basename(p), os.path.getmtime(p))
            for p in self._files(schema, table)
        )

    def data_versions(self, schema, table):
        # one immutable uuid-named file per insert (id = basename, token =
        # mtime_ns+size): part-level pairs let a result cache classify a
        # change as append (maintain) vs rewrite (invalidate), which the
        # whole-table data_version() digest cannot
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
            f = self._file(path)
            for si in range(len(f.stripes)):
                pairs.append((path, si))
        return [
            Split(table, i, max(len(pairs), 1), info=pair)
            for i, pair in enumerate(pairs)
        ]


    # --- writes: one ORC file per insert ----------------------------------

    def create_table(self, schema, table, schema_def: TableSchema) -> None:
        d = self._table_dir(schema, table)
        if os.path.isdir(d) and self._files(schema, table):
            raise ValueError(f"table already exists: {schema}.{table}")
        os.makedirs(d, exist_ok=True)
        self._pending_schema = schema_def  # first insert writes the file

    def insert(self, schema, table, batch: Batch) -> int:
        return self.insert_part(schema, table, batch)[0]

    def insert_part(self, schema, table, batch: Batch,
                    pending: bool = False) -> tuple[int, str]:
        """Insert returning (rows, part-file name); ``pending`` writes
        the part staged (``<part>.pending``, which no reader lists) until
        :meth:`commit_parts` (scaled writers)."""
        import threading

        d = self._table_dir(schema, table)
        if not os.path.isdir(d):
            raise KeyError(f"table not found: {schema}.{table}")
        lock = getattr(self, "_write_lock", None)
        if lock is None:
            lock = self._write_lock = threading.Lock()
        ts = self.get_table(schema, table)
        names = (
            [c.name for c in ts.columns]
            if ts is not None
            else [c.name for c in getattr(self, "_pending_schema").columns]
        )
        with lock:
            import uuid

            # node-unique part names: concurrent writer tasks on several
            # nodes append without coordination (scaled writers)
            n = len(self._files(schema, table))
            path = os.path.join(
                d, f"part-{n:05d}-{uuid.uuid4().hex[:8]}.orc"
            )
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                ORC.write_orc(f, names, [batch])
            os.replace(tmp, path + (PENDING_SUFFIX if pending else ""))
        return batch.compact().num_rows, os.path.basename(path)

    def commit_parts(self, schema, table, parts) -> None:
        """A scaled write's staged parts become visible."""
        commit_staged_parts(self._table_dir(schema, table), parts)

    def delete_parts(self, schema, table, parts) -> None:
        """A failed scaled write's parts go, committed or staged."""
        delete_staged_parts(self._table_dir(schema, table), parts)

    def drop_table(self, schema, table) -> None:
        import shutil

        d = self._table_dir(schema, table)
        if os.path.isdir(d):
            shutil.rmtree(d)
