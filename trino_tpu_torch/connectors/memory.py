"""In-memory connector (reference: ``plugin/trino-memory``,
``MemoryPagesStore.java:41``): create, insert, scan, and the write
surface of the reference's connector (drop, truncate, the transaction
snapshot and restore).

Where the reference keeps pages pinned in worker JVM memory, this
connector can additionally stage a table into device memory
(:meth:`device_slab`), so repeated scans read device-resident slabs with
zero host->device traffic."""

from __future__ import annotations

from typing import Sequence

from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.connectors.api import Connector, Split, TableSchema


def _slice_rows(b: Batch, lo: int, hi: int) -> Batch:
    """Row-range view [lo, hi) of a stored batch (host-side slicing; row
    slices on axis 0 cover wide-decimal 2-D lanes too)."""
    cols = [
        Column(
            c.type,
            c.data[lo:hi],
            None if c.valid is None else c.valid[lo:hi],
            c.dictionary,
        )
        for c in b.columns
    ]
    return Batch(cols, hi - lo, None if b.sel is None else b.sel[lo:hi])


class MemoryConnector(Connector):
    name = "memory"

    def __init__(self):
        self._tables: dict[tuple[str, str], TableSchema] = {}
        self._data: dict[tuple[str, str], list[Batch]] = {}
        self._stats: dict[tuple[str, str], dict[int, dict]] = {}
        self._version = 0  # bumped on any mutation; keys the device cache
        self._device: dict[tuple, tuple] = {}

    def list_schemas(self):
        return sorted({s for s, _ in self._tables} | {"default"})

    def list_tables(self, schema):
        return sorted(t for s, t in self._tables if s == schema)

    def get_table(self, schema, table):
        return self._tables.get((schema, table))

    def create_table(self, schema, table, schema_def):
        if (schema, table) in self._tables:
            raise ValueError(f"table already exists: {schema}.{table}")
        self._tables[(schema, table)] = schema_def
        self._data[(schema, table)] = []

    def insert(self, schema, table, batch):
        if (schema, table) not in self._tables:
            raise KeyError(f"table not found: {schema}.{table}")
        compacted = batch.compact()
        self._data[(schema, table)].append(compacted)
        self._stats.pop((schema, table), None)
        self._invalidate()
        return compacted.num_rows

    def _invalidate(self):
        """Every mutation: a new data version (the device table cache's
        key) and no staged device slab survives."""
        self._version += 1
        self._device.clear()

    # --- transaction snapshot support (see trino_tpu_torch.transaction) ---

    def snapshot_state(self):
        return (
            dict(self._tables),
            {k: list(v) for k, v in self._data.items()},
        )

    def restore_state(self, snap):
        tables, data = snap
        self._tables = dict(tables)
        self._data = {k: list(v) for k, v in data.items()}
        self._stats.clear()
        self._invalidate()

    def truncate(self, schema, table):
        if (schema, table) not in self._tables:
            raise KeyError(f"table not found: {schema}.{table}")
        self._data[(schema, table)] = []
        self._stats.pop((schema, table), None)
        self._invalidate()

    def drop_table(self, schema, table):
        self._tables.pop((schema, table), None)
        self._data.pop((schema, table), None)
        self._stats.pop((schema, table), None)
        self._invalidate()

    def device_slab(self, schema, table, columns: Sequence[str], cap: int,
                    max_bytes: int, device):
        """Stage the table's requested columns onto ``device`` as ONE slab
        padded to a multiple of ``cap`` rows. Returns (slab_batch,
        num_rows) or None when the table exceeds ``max_bytes``.

        Cached per (columns, device, version): repeated queries pay zero
        host->device transfer — device memory is this connector's page
        store."""
        parts = self._data.get((schema, table))
        if parts is None:
            return None
        key = (schema, table, tuple(columns), str(device), self._version)
        hit = self._device.get(key)
        if hit is not None and hit[0].capacity % cap == 0:
            return hit
        total_rows = sum(b.num_rows for b in parts)
        if total_rows == 0:
            return None
        ts = self._tables[(schema, table)]
        name_to_idx = {c.name: i for i, c in enumerate(ts.columns)}
        from trino_tpu_torch.connectors.api import (
            slab_bytes_estimate,
            stage_device_slab,
        )

        nbytes = slab_bytes_estimate(
            [ts.columns[name_to_idx[c]].type for c in columns],
            total_rows, cap,
        )
        if nbytes > max_bytes:
            return None

        staged = stage_device_slab(
            [
                Batch(
                    [b.columns[name_to_idx[c]] for c in columns],
                    b.num_rows,
                    b.sel,
                )
                for b in parts
            ],
            cap,
            device,
        )
        self._device[key] = staged
        return staged

    def estimate_rows(self, schema, table):
        parts = self._data.get((schema, table))
        if parts is None:
            return None
        return sum(b.num_rows for b in parts)

    # --- optimizer pushdown (ConnectorMetadata.applyLimit/applyAggregation)
    def apply_limit(self, schema, table, count):
        return True  # scans stop pulling stored parts once covered

    def apply_aggregation_count(self, schema, table):
        return self.estimate_rows(schema, table)  # stored parts: exact

    def get_splits(self, schema, table, target_splits, constraint=None):
        parts = self._data.get((schema, table), [])
        if not parts:
            return self.prune_splits(
                schema, table, [Split(table, 0, 1)], constraint
            )
        # subdivide large stored batches into row ranges so a table built
        # from one big INSERT still fans out across target_splits workers
        # (without this, a 2M-row single-part table lands on one shard and
        # every other shard pads to its full capacity)
        total = sum(b.num_rows for b in parts)
        chunk = max(4096, -(-total // max(1, target_splits)))
        ranges: list[tuple[int, int, int]] = []
        for i, b in enumerate(parts):
            lo = 0
            while True:
                hi = min(b.num_rows, lo + chunk)
                ranges.append((i, lo, hi))
                lo = hi
                if lo >= b.num_rows:
                    break
        splits = [
            Split(table, j, len(ranges), info=r)
            for j, r in enumerate(ranges)
        ]
        return self.prune_splits(schema, table, splits, constraint)

    @staticmethod
    def _split_range(split, parts):
        """(part_index, row_lo, row_hi) for a split; legacy splits without
        ``info`` cover their whole stored batch. Accepts a list too: the
        cluster wire round-trips ``info`` through JSON."""
        if isinstance(split.info, (tuple, list)) and len(split.info) == 3:
            part, lo, hi = split.info
            return int(part), int(lo), int(hi)
        i = split.index
        return i, 0, parts[i].num_rows if i < len(parts) else 0

    def split_stats(self, schema, table, split):
        """Per-split (stored-batch row range) min/max over numeric/date
        columns, computed lazily and cached (reference:
        MemoryMetadata#getTableStatistics)."""
        parts = self._data.get((schema, table))
        if not parts:
            return None
        part, lo, hi = self._split_range(split, parts)
        if part >= len(parts):
            return None
        cache = self._stats.setdefault((schema, table), {})
        key = (part, lo, hi)
        if key not in cache:
            from trino_tpu_torch.connectors.api import batch_column_stats

            ts = self._tables[(schema, table)]
            b = parts[part]
            if (lo, hi) != (0, b.num_rows):
                b = _slice_rows(b, lo, hi)
            cache[key] = batch_column_stats(ts.columns, b)
        return cache[key]

    def read_split(self, schema, table, columns: Sequence[str], split):
        ts = self._tables[(schema, table)]
        parts = self._data[(schema, table)]
        name_to_idx = {c.name: i for i, c in enumerate(ts.columns)}
        if not parts:
            import numpy as np

            from trino_tpu_torch.columnar import Column, as_tensor

            cols = [
                Column(ts.columns[name_to_idx[c]].type,
                       as_tensor(np.zeros(0, dtype=ts.columns[name_to_idx[c]].type.storage_dtype)))
                for c in columns
            ]
            return Batch(cols, 0)
        part, lo, hi = self._split_range(split, parts)
        b = parts[part]
        if (lo, hi) != (0, b.num_rows):
            b = _slice_rows(b, lo, hi)
        cols = [b.columns[name_to_idx[c]] for c in columns]
        return Batch(cols, b.num_rows, b.sel)
