"""Blackhole connector (reference: ``plugin/trino-blackhole``): accepts all
writes, discards data; scans return zero rows. For write-path perf tests.
The port's copy of ``trino_tpu/connectors/blackhole.py``."""

from __future__ import annotations

import numpy as np

from trino_tpu_torch.columnar import Batch, Column, as_tensor
from trino_tpu_torch.connectors.api import Connector, Split, TableSchema


class BlackHoleConnector(Connector):
    name = "blackhole"

    def __init__(self):
        self._tables: dict[tuple[str, str], TableSchema] = {}

    def list_schemas(self):
        return ["default"]

    def list_tables(self, schema):
        return sorted(t for s, t in self._tables if s == schema)

    def get_table(self, schema, table):
        return self._tables.get((schema, table))

    def create_table(self, schema, table, schema_def):
        self._tables[(schema, table)] = schema_def

    def insert(self, schema, table, batch):
        return batch.count_rows()

    def drop_table(self, schema, table):
        self._tables.pop((schema, table), None)

    def get_splits(self, schema, table, target_splits, constraint=None):
        return [Split(table, 0, 1)]

    def read_split(self, schema, table, columns, split):
        ts = self._tables[(schema, table)]
        types = {c.name: c.type for c in ts.columns}
        cols = [
            Column(types[c], as_tensor(np.zeros(0, dtype=types[c].storage_dtype)))
            for c in columns
        ]
        return Batch(cols, 0)
