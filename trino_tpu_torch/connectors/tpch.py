"""TPC-H connector: deterministic on-the-fly columnar data generation.

Reference: ``plugin/trino-tpch`` (``TpchMetadata.java``,
``TpchSplitManager.java``): data is generated per split, no storage
involved. Counterpart of ``trino_tpu/connectors/tpch.py`` over the port's
own copy of the numpy generator (``connectors/dbgen.py``): the same
schemas, statistics, splits and values, as host batches of CPU tensors.

Comment columns slice the text pool that the port's native loader builds
(``dbgen.text_pool``). Generated splits are kept in a host cache and, as
in the reference, on disk (``connectors/diskcache.py``, the port's own
directory), so a fresh process reads back what an earlier one generated.

Schemas: tiny (SF 0.01), sf1, sf10, sf100 (and sf<k> parsed generically).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.civil import days_from_civil
from trino_tpu_torch.columnar import Batch, Column, Dictionary, as_tensor
from trino_tpu_torch.connectors.api import (
    ColumnSchema,
    Connector,
    DeviceColumnStore,
    Split,
    TableSchema,
)
from trino_tpu_torch.connectors.diskcache import DbgenDiskCache

DEC = T.decimal(12, 2)

_SCHEMAS = {
    "region": [
        ("r_regionkey", T.BIGINT),
        ("r_name", T.VARCHAR),
        ("r_comment", T.VARCHAR),
    ],
    "nation": [
        ("n_nationkey", T.BIGINT),
        ("n_name", T.VARCHAR),
        ("n_regionkey", T.BIGINT),
        ("n_comment", T.VARCHAR),
    ],
    "supplier": [
        ("s_suppkey", T.BIGINT),
        ("s_name", T.VARCHAR),
        ("s_address", T.VARCHAR),
        ("s_nationkey", T.BIGINT),
        ("s_phone", T.VARCHAR),
        ("s_acctbal", DEC),
        ("s_comment", T.VARCHAR),
    ],
    "customer": [
        ("c_custkey", T.BIGINT),
        ("c_name", T.VARCHAR),
        ("c_address", T.VARCHAR),
        ("c_nationkey", T.BIGINT),
        ("c_phone", T.VARCHAR),
        ("c_acctbal", DEC),
        ("c_mktsegment", T.VARCHAR),
        ("c_comment", T.VARCHAR),
    ],
    "part": [
        ("p_partkey", T.BIGINT),
        ("p_name", T.VARCHAR),
        ("p_mfgr", T.VARCHAR),
        ("p_brand", T.VARCHAR),
        ("p_type", T.VARCHAR),
        ("p_size", T.BIGINT),
        ("p_container", T.VARCHAR),
        ("p_retailprice", DEC),
        ("p_comment", T.VARCHAR),
    ],
    "partsupp": [
        ("ps_partkey", T.BIGINT),
        ("ps_suppkey", T.BIGINT),
        ("ps_availqty", T.BIGINT),
        ("ps_supplycost", DEC),
        ("ps_comment", T.VARCHAR),
    ],
    "orders": [
        ("o_orderkey", T.BIGINT),
        ("o_custkey", T.BIGINT),
        ("o_orderstatus", T.VARCHAR),
        ("o_totalprice", DEC),
        ("o_orderdate", T.DATE),
        ("o_orderpriority", T.VARCHAR),
        ("o_clerk", T.VARCHAR),
        ("o_shippriority", T.BIGINT),
        ("o_comment", T.VARCHAR),
    ],
    "lineitem": [
        ("l_orderkey", T.BIGINT),
        ("l_partkey", T.BIGINT),
        ("l_suppkey", T.BIGINT),
        ("l_linenumber", T.BIGINT),
        ("l_quantity", DEC),
        ("l_extendedprice", DEC),
        ("l_discount", DEC),
        ("l_tax", DEC),
        ("l_returnflag", T.VARCHAR),
        ("l_linestatus", T.VARCHAR),
        ("l_shipdate", T.DATE),
        ("l_commitdate", T.DATE),
        ("l_receiptdate", T.DATE),
        ("l_shipinstruct", T.VARCHAR),
        ("l_shipmode", T.VARCHAR),
        ("l_comment", T.VARCHAR),
    ],
}


_EPOCH_START = days_from_civil(1992, 1, 1)
_EPOCH_END = days_from_civil(1998, 8, 2)



def scale_factor(schema: str) -> float:
    if schema == "tiny":
        return 0.01
    if schema.startswith("sf"):
        return float(schema[2:].replace("_", "."))
    raise KeyError(f"unknown tpch schema: {schema}")


def _counts(sf: float) -> dict[str, int]:
    # single source of truth: dbgen.counts (rounding must match the key
    # domains the generator draws from, or joins silently drop rows)
    from trino_tpu_torch.connectors.dbgen import counts

    out = dict(counts(sf))
    out["lineitem"] = None  # derived from orders (avg ~4 lines per order)
    return out


def _nbytes(batch: Batch) -> int:
    return sum(
        c.data.numel() * c.data.element_size()
        + (0 if c.valid is None else c.valid.numel())
        for c in batch.columns
    )


class TpchConnector(Connector):
    name = "tpch"

    def __init__(self, split_rows: int = 1 << 20, cache_bytes: int = 2 << 30):
        self.split_rows = split_rows
        self._dict_cache: dict[str, Dictionary] = {}
        # generated splits are deterministic: cache them so repeated
        # queries measure the engine, not the generator. Least recently
        # read entries go first, so a workload whose column sets outgrow
        # the limit keeps the splits its current queries read
        self._batch_cache: OrderedDict[tuple, Batch] = OrderedDict()
        self._batch_cache_bytes = 0
        self._batch_cache_limit = cache_bytes
        # ...and the same batches on disk, shared across processes
        # (connectors/diskcache.py)
        self._disk_cache = DbgenDiskCache()
        # staged device columns (see device_slab); read_split serves a
        # split of columns staged already from them (staged_splits counts)
        self._device_cols = DeviceColumnStore()
        self.staged_splits = 0

    def disk_cache_stats(self) -> dict:
        """Hits and misses of the disk cache of generated splits."""
        return self._disk_cache.stats()

    # --- metadata --------------------------------------------------------
    def list_schemas(self):
        return ["tiny", "sf1", "sf10", "sf100"]

    def list_tables(self, schema):
        scale_factor(schema)
        return sorted(_SCHEMAS)

    def get_table(self, schema, table):
        try:
            scale_factor(schema)
        except KeyError:
            return None
        if table not in _SCHEMAS:
            return None
        return TableSchema(
            table, tuple(ColumnSchema(n, t) for n, t in _SCHEMAS[table])
        )

    def estimate_rows(self, schema, table):
        sf = scale_factor(schema)
        c = _counts(sf)
        if table == "lineitem":
            return c["orders"] * 4
        return c[table]

    # --- optimizer pushdown (ConnectorMetadata.applyLimit/applyAggregation)
    def apply_limit(self, schema, table, count):
        # scans stop generating splits once the row budget is covered
        return True

    def apply_aggregation_count(self, schema, table):
        """dbgen row counts are closed-form exact for every table except
        lineitem (whose per-order cardinality is drawn from the stream)."""
        if table == "lineitem":
            return None
        sf = scale_factor(schema)
        return _counts(sf).get(table)

    def table_stats(self, schema, table):
        """Column statistics derived from the generator's known value
        domains (reference: ``plugin/trino-tpch/.../statistics/`` — the
        reference likewise ships precomputed stats for the CBO)."""
        from trino_tpu_torch.connectors.api import ColumnStats, TableStats
        from trino_tpu_torch.connectors import dbgen as G

        sf = scale_factor(schema)
        c = _counts(sf)
        rows = float(self.estimate_rows(schema, table))
        key = self._KEY_COLUMNS.get(table)
        cols: dict[str, ColumnStats] = {}
        if key is not None:
            base = "orders" if table == "lineitem" else table
            nkeys = c[base]
            lo = 0 if table in self._ZERO_BASED_KEYS else 1
            if table in ("orders", "lineitem"):
                from trino_tpu_torch.connectors.dbgen import make_order_key

                hi_key = int(make_order_key(np.asarray([nkeys]))[0])
                cols[key] = ColumnStats(float(nkeys), 0.0, 1, hi_key)
            else:
                cols[key] = ColumnStats(float(nkeys), 0.0, lo, lo + nkeys - 1)
        fks = {
            "nation": [("n_regionkey", "region", 0)],
            "supplier": [("s_nationkey", "nation", 0)],
            "customer": [("c_nationkey", "nation", 0)],
            "orders": [("o_custkey", "customer", 1)],
            "partsupp": [("ps_partkey", "part", 1), ("ps_suppkey", "supplier", 1)],
            "lineitem": [("l_partkey", "part", 1), ("l_suppkey", "supplier", 1)],
        }
        for col, ref, lo in fks.get(table, []):
            n = c[ref]
            cols[col] = ColumnStats(float(n), 0.0, lo, lo + n - 1)
        low_card = {
            "o_orderstatus": 3, "o_orderpriority": 5, "o_shippriority": 1,
            "l_returnflag": 3, "l_linestatus": 2,
            "l_shipmode": len(G.MODES.values),
            "l_shipinstruct": len(G.INSTRUCTIONS.values),
            "c_mktsegment": len(G.SEGMENTS.values), "n_name": 25, "r_name": 5,
            "p_brand": 25, "p_type": len(G.TYPES.values),
            "p_container": len(G.CONTAINERS.values), "p_size": 50,
        }
        dates = {
            "o_orderdate": (_EPOCH_START, _EPOCH_END),
            "l_shipdate": (_EPOCH_START, _EPOCH_END + 121),
            "l_commitdate": (_EPOCH_START, _EPOCH_END + 121),
            "l_receiptdate": (_EPOCH_START, _EPOCH_END + 151),
        }
        for name, _ty in _SCHEMAS[table]:
            if name in cols:
                continue
            if name in low_card:
                cols[name] = ColumnStats(float(low_card[name]), 0.0)
            elif name in dates:
                lo_d, hi_d = dates[name]
                cols[name] = ColumnStats(
                    float(min(rows, hi_d - lo_d + 1)), 0.0, lo_d, hi_d
                )
        return TableStats(row_count=rows, columns=cols)

    # --- splits ----------------------------------------------------------
    def get_splits(self, schema, table, target_splits, constraint=None):
        rows = self.estimate_rows(schema, table)
        n = max(1, min(target_splits, (rows + self.split_rows - 1) // self.split_rows))
        splits = [Split(table, i, n) for i in range(n)]
        return self.prune_splits(schema, table, splits, constraint)

    # primary keys are sequential per split -> exact min/max stats, so a
    # key-range constraint (incl. dynamic filters) prunes whole splits
    # (reference: TpchSplitManager + stripe-stat pruning semantics)
    _KEY_COLUMNS = {"orders": "o_orderkey", "lineitem": "l_orderkey",
                    "customer": "c_custkey", "part": "p_partkey",
                    "supplier": "s_suppkey", "nation": "n_nationkey",
                    "region": "r_regionkey"}

    # nation/region generate 0-based keys (np.arange(lo, hi)); the rest are
    # 1-based (np.arange(lo + 1, hi + 1))
    _ZERO_BASED_KEYS = {"nation", "region"}

    def split_stats(self, schema, table, split):
        key = self._KEY_COLUMNS.get(table)
        if key is None:
            return None
        sf = scale_factor(schema)
        base = "orders" if table == "lineitem" else table
        total_rows = _counts(sf)[base]
        lo, hi = self._range(total_rows, split.index, split.total)
        if hi <= lo:
            return {key: (None, None, False)}
        if table in ("orders", "lineitem"):
            # sparse but monotone order keys (dbgen mk_sparse)
            from trino_tpu_torch.connectors.dbgen import make_order_key

            return {
                key: (
                    int(make_order_key(np.asarray([lo + 1]))[0]),
                    int(make_order_key(np.asarray([hi]))[0]),
                    False,
                )
            }
        if table in self._ZERO_BASED_KEYS:
            return {key: (lo, hi - 1, False)}
        return {key: (lo + 1, hi, False)}

    # --- data generation -------------------------------------------------
    def device_slab(self, schema, table, columns, cap: int, max_bytes: int,
                    device):
        """Stage a generated table's columns onto ``device`` (device memory
        is this connector's page store). Returns (slab_batch, num_rows),
        or None when the columns exceed ``max_bytes``; the caller then
        streams host chunks.

        Each column is staged once per device and kept
        (``DeviceColumnStore``). Quantum padding lets every power-of-two
        chunk size up to it slice the slab (``connectors/api.py``)."""
        sf = scale_factor(schema)  # validates the schema name
        rows = self.estimate_rows(schema, table)
        by_name = {c.name: c for c in self.get_table(schema, table).columns}

        def generate(missing):
            n_splits = max(1, (rows + self.split_rows - 1) // self.split_rows)
            gen = getattr(self, f"_gen_{table}")
            parts = []
            for i in range(n_splits):
                # generate directly: staging bypasses the host split cache
                # so it never evicts hot host entries
                cols = gen(sf, i, n_splits, columns=set(missing))
                out = [cols[c] for c in missing]
                parts.append(Batch(out, out[0].data.shape[0]))
            return parts

        return self._device_cols.slab(
            schema, table, columns, [by_name[c].type for c in columns], rows,
            cap, max_bytes, device, generate,
        )

    def read_split(self, schema, table, columns, split):
        key = (schema, table, tuple(columns), split.index, split.total)
        hit = self._batch_cache.get(key)
        if hit is not None:
            self._batch_cache.move_to_end(key)
            return hit
        staged = self._staged_split(schema, table, columns, split)
        if staged is not None:
            return staged
        disk_key = ("tpch",) + key
        batch = self._disk_cache.get(disk_key)
        if batch is not None:
            batch = self._reintern(columns, batch)
        else:
            sf = scale_factor(schema)
            gen = getattr(self, f"_gen_{table}")
            cols = gen(sf, split.index, split.total, columns=set(columns))
            out = [cols[c] for c in columns]
            batch = Batch(out, out[0].data.shape[0] if out else 0)
            self._disk_cache.put(disk_key, batch)
        nbytes = _nbytes(batch)
        if nbytes <= self._batch_cache_limit:
            while self._batch_cache_bytes + nbytes > self._batch_cache_limit:
                _, old = self._batch_cache.popitem(last=False)
                self._batch_cache_bytes -= _nbytes(old)
            self._batch_cache[key] = batch
            self._batch_cache_bytes += nbytes
        return batch

    def _staged_split(self, schema, table, columns, split) -> Optional[Batch]:
        """The split's rows of columns a ``device_slab`` staged already,
        in one device-to-host copy (``ingest.buffers_to_host``), with the
        staged dictionaries; None when the device holds not all of them.
        Generating them again costs seconds a split (TPC-H SF1 lineitem:
        tens of seconds). A lineitem split's rows are found by its order
        keys in the staged ``l_orderkey`` (ascending, as generated), the
        other tables' by their row ranges. Neither cache is involved: the
        host split cache and the disk cache count what they serve."""
        if not columns:
            return None
        want = list(columns) + (["l_orderkey"] if table == "lineitem" else [])
        found = self._device_cols.staged(schema, table, want)
        if found is None:
            return None
        import torch

        from trino_tpu_torch.ingest import buffers_to_host

        cols, num_rows = found
        sf = scale_factor(schema)
        counts = _counts(sf)
        if table == "lineitem":
            from trino_tpu_torch.connectors.dbgen import make_order_key

            lo, hi = self._range(counts["orders"], split.index, split.total)
            if hi <= lo:
                return None
            keys = cols[-1].data[:num_rows]
            bounds = torch.as_tensor(
                make_order_key(np.asarray([lo + 1, hi])).astype(np.int64) + [0, 1],
                device=keys.device,
            )
            from trino_tpu_torch.exec.programs import allow_sync

            with allow_sync(keys.device):  # the split's two row bounds
                rlo, rhi = torch.searchsorted(keys, bounds.to(keys.dtype)).tolist()
            cols = cols[: len(columns)]
        else:
            if table == "partsupp":
                lo, hi = self._range(counts["part"], split.index, split.total)
                lo, hi = 4 * lo, 4 * hi
            else:
                lo, hi = self._range(counts.get(table, num_rows), split.index, split.total)
            rlo, rhi = lo, min(hi, num_rows)
        if rhi <= rlo:
            return None
        parts = []
        for c in cols:
            parts.append(c.data[rlo:rhi])
            if c.valid is not None:
                parts.append(c.valid[rlo:rhi])
        from trino_tpu_torch.exec.programs import allow_sync

        with allow_sync(parts[0].device):
            host = iter(buffers_to_host(parts))
        self.staged_splits += 1
        out = []
        for c in cols:
            data = next(host)
            out.append(Column(c.type, data, None if c.valid is None else next(host),
                              c.dictionary))
        return Batch(out, rhi - rlo)

    def _reintern(self, columns, batch: Batch) -> Batch:
        """Swap disk-loaded dictionaries for the connector's shared
        instances where the values match: distribution-valued columns
        (l_shipmode, c_mktsegment, ...) would otherwise get one Dictionary
        object per split, inflating dictionary merges downstream."""
        from trino_tpu_torch.connectors import dbgen as G

        cols = []
        for name, col in zip(columns, batch.columns):
            if (
                col.dictionary is not None
                and name in G.DIST_VALUES
                and list(col.dictionary.values) == list(G.DIST_VALUES[name])
            ):
                col = Column(col.type, col.data, col.valid,
                             self._strings(name, G.DIST_VALUES[name]))
            cols.append(col)
        return Batch(cols, batch.num_rows)

    # Each generator returns {column_name: Column} for this split's rows.
    def _range(self, total_rows: int, index: int, total: int) -> tuple[int, int]:
        per = (total_rows + total - 1) // total
        lo = index * per
        hi = min(total_rows, lo + per)
        return lo, hi

    def _strings(self, name: str, values: list[str]) -> Dictionary:
        """One shared dictionary per distribution-valued column, so every
        split's codes mean the same strings."""
        key = f"{name}:{len(values)}"
        if key not in self._dict_cache:
            self._dict_cache[key] = Dictionary(values)
        return self._dict_cache[key]

    _DEC_COLUMNS = {
        "s_acctbal", "c_acctbal", "p_retailprice", "ps_supplycost",
        "o_totalprice", "l_quantity", "l_extendedprice", "l_discount",
        "l_tax",
    }
    _DATE_COLUMNS = {"o_orderdate", "l_shipdate", "l_commitdate", "l_receiptdate"}

    def _to_batch_dict(self, raw: dict) -> dict:
        from trino_tpu_torch.connectors import dbgen as G

        out = {}
        for name, data in raw.items():
            if name.startswith("_"):
                continue
            if name in G.DIST_VALUES:
                d = self._strings(name, G.DIST_VALUES[name])
                out[name] = Column(
                    T.VARCHAR, as_tensor(np.asarray(data, dtype=np.int32)), None, d
                )
            elif isinstance(data, list):  # per-split strings
                d, codes = Dictionary.from_strings(data)
                out[name] = Column(T.VARCHAR, as_tensor(codes), None, d)
            elif name in self._DEC_COLUMNS:
                out[name] = Column(DEC, as_tensor(np.asarray(data, dtype=np.int64)))
            elif name in self._DATE_COLUMNS:
                days = _EPOCH_START + np.asarray(data, dtype=np.int64)
                out[name] = Column(T.DATE, as_tensor(days.astype(np.int32)))
            else:
                out[name] = Column(T.BIGINT, as_tensor(np.asarray(data, dtype=np.int64)))
        return out

    def _gen_region(self, sf, index, total, columns=None):
        from trino_tpu_torch.connectors import dbgen as G

        lo, hi = self._range(5, index, total)
        return self._to_batch_dict(G.gen_region(lo, hi - lo))

    def _gen_nation(self, sf, index, total, columns=None):
        from trino_tpu_torch.connectors import dbgen as G

        lo, hi = self._range(25, index, total)
        return self._to_batch_dict(G.gen_nation(lo, hi - lo))

    def _gen_supplier(self, sf, index, total, columns=None):
        from trino_tpu_torch.connectors import dbgen as G

        lo, hi = self._range(_counts(sf)["supplier"], index, total)
        return self._to_batch_dict(G.gen_supplier(sf, lo, hi - lo, want=columns))

    def _gen_customer(self, sf, index, total, columns=None):
        from trino_tpu_torch.connectors import dbgen as G

        lo, hi = self._range(_counts(sf)["customer"], index, total)
        return self._to_batch_dict(G.gen_customer(sf, lo, hi - lo, want=columns))

    def _gen_part(self, sf, index, total, columns=None):
        from trino_tpu_torch.connectors import dbgen as G

        lo, hi = self._range(_counts(sf)["part"], index, total)
        return self._to_batch_dict(G.gen_part(sf, lo, hi - lo, want=columns))

    def _gen_partsupp(self, sf, index, total, columns=None):
        from trino_tpu_torch.connectors import dbgen as G

        # split over parts (4 partsupp rows per part)
        lo, hi = self._range(_counts(sf)["part"], index, total)
        return self._to_batch_dict(G.gen_partsupp(sf, lo, hi - lo, want=columns))

    def _gen_orders(self, sf, index, total, columns=None):
        from trino_tpu_torch.connectors import dbgen as G

        lo, hi = self._range(_counts(sf)["orders"], index, total)
        return self._to_batch_dict(G.gen_orders(sf, lo, hi - lo, want=columns))

    def _gen_lineitem(self, sf, index, total, columns=None):
        from trino_tpu_torch.connectors import dbgen as G

        lo, hi = self._range(_counts(sf)["orders"], index, total)
        raw = G.gen_lineitem(sf, lo, hi - lo, want=columns)
        if columns is None or "l_comment" in columns:
            raw["l_comment"] = G.lineitem_comments(
                lo, hi - lo, raw["_line_flat"]
            )
        else:
            raw.pop("l_comment", None)
        return self._to_batch_dict(raw)
