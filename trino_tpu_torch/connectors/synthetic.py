"""Synthetic table connector: columns computed from the row index.

Reference analog: the tpch connector's generated tables
(``plugin/trino-tpch/.../TpchRecordSet.java``) — data comes from a
deterministic generator, not storage. The generator is written against
an array namespace: the streaming executor evaluates it with ``torch`` on
the engine's device for each chunk (``device_generator``), so the scan
never crosses from the host, and billion-row runs are not bound by the
host-to-device copy.

The host path (``read_split``) evaluates the same arithmetic with NumPy,
so the interpreter and the streamed engine agree bit for bit. A copy of
``trino_tpu/connectors/synthetic.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

import torch

from trino_tpu_torch.columnar import Batch, Column, host_column, torch_dtype
from trino_tpu_torch.connectors.api import Connector, Split, TableSchema


@dataclasses.dataclass
class SyntheticTable:
    schema_def: TableSchema
    num_rows: int
    # gen(xp, idx) -> dict column name -> array; ``xp`` is numpy or torch
    # and ``idx`` the absolute row indices (int64)
    gen: Callable


class SyntheticConnector(Connector):
    name = "synthetic"

    def __init__(self, split_rows: int = 1 << 22):
        self.split_rows = split_rows
        self._tables: dict[tuple[str, str], SyntheticTable] = {}
        self._version = 0  # keys the engine's plan/program cache

    def add_table(self, schema: str, table: str, schema_def: TableSchema,
                  num_rows: int, gen: Callable) -> None:
        self._tables[(schema, table)] = SyntheticTable(schema_def, num_rows, gen)
        self._version += 1  # replaced generators must not serve cached plans

    # --- metadata --------------------------------------------------------

    def list_schemas(self):
        return sorted({s for s, _ in self._tables} | {"default"})

    def list_tables(self, schema):
        return sorted(t for s, t in self._tables if s == schema)

    def get_table(self, schema, table):
        t = self._tables.get((schema, table))
        return t.schema_def if t else None

    def estimate_rows(self, schema, table):
        t = self._tables.get((schema, table))
        return t.num_rows if t else None

    # --- host path (interpreter / multi-device streaming) ----------------

    def get_splits(self, schema, table, target_splits, constraint=None):
        t = self._tables[(schema, table)]
        n = max(1, min(
            max(target_splits, 1),
            (t.num_rows + self.split_rows - 1) // max(1, self.split_rows),
        ))
        return [Split(table, i, n) for i in range(n)]

    def read_split(self, schema, table, columns: Sequence[str], split):
        t = self._tables[(schema, table)]
        per = (t.num_rows + split.total - 1) // split.total
        lo = split.index * per
        hi = min(lo + per, t.num_rows)
        idx = np.arange(lo, hi, dtype=np.int64)
        vals = t.gen(np, idx)
        name_to_type = {c.name: c.type for c in t.schema_def.columns}
        cols = [host_column(name_to_type[c], np.asarray(vals[c])) for c in columns]
        return Batch(cols, hi - lo)

    # --- device path (the streaming executor generates chunks) ------------

    def device_generator(self, schema, table, columns: Sequence[str], device=None):
        """(make_chunk, num_rows): ``make_chunk(off, cap)`` evaluates the
        generator with ``torch`` on ``device`` over rows [off, off + cap)
        and returns the chunk's Columns, made on the device."""
        t = self._tables.get((schema, table))
        if t is None:
            return None
        name_to_type = {c.name: c.type for c in t.schema_def.columns}

        def make_chunk(off: int, cap: int):
            idx = torch.arange(off, off + cap, dtype=torch.int64, device=device)
            vals = t.gen(torch, idx)
            return [
                Column(
                    name_to_type[c],
                    vals[c].to(torch_dtype(name_to_type[c].storage_dtype)),
                )
                for c in columns
            ]

        return make_chunk, t.num_rows
