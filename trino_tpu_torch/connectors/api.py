"""Connector SPI.

Reference interfaces: ``spi/connector/Connector.java:28-90`` (metadata,
split manager, page source provider), ``spi/connector/ConnectorSplitManager.java:23``,
``spi/connector/ConnectorPageSource.java:47``.

A connector reads a (table, split, columns) triple into one host
:class:`Batch` of CPU tensors; the executor moves it to its device. Splits are the unit of scan parallelism (reference §2.6 item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch
from trino_tpu_torch.predicate import TupleDomain


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Per-column statistics (reference: ``spi/statistics/ColumnStatistics``)."""

    distinct_count: Optional[float] = None
    null_fraction: Optional[float] = None
    min_value: Any = None
    max_value: Any = None


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Reference: ``spi/statistics/TableStatistics`` — drives the CBO."""

    row_count: Optional[float] = None
    columns: dict[str, ColumnStats] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    type: T.SqlType


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: tuple[ColumnSchema, ...]

    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def column(self, name: str) -> ColumnSchema | None:
        for c in self.columns:
            if c.name == name:
                return c
        return None


@dataclasses.dataclass(frozen=True)
class Split:
    """Opaque unit of scan work (reference: ``spi/connector/ConnectorSplit``)."""

    table: str
    index: int
    total: int
    info: Any = None


# a scaled writer's staged part: ``<part>.pending`` until committed
PENDING_SUFFIX = ".pending"


def commit_staged_parts(directory: str, parts) -> None:
    """Make a scaled write's staged parts visible: one rename each; a
    part already committed stays as it is."""
    import os

    for part in parts:
        staged = os.path.join(directory, str(part) + PENDING_SUFFIX)
        if part and os.path.exists(staged):
            os.replace(staged, os.path.join(directory, part))


def delete_staged_parts(directory: str, parts) -> None:
    """Best-effort removal of named parts, committed or staged (the
    scaled write's abort)."""
    import os

    for part in parts:
        if not part:
            continue
        for name in (part, part + PENDING_SUFFIX):
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


class Connector:
    name: str = "connector"
    # False for connectors whose reads reflect live process state rather
    # than versioned table data (system tables): the result cache
    # (trino_tpu_torch/cache) refuses queries touching them
    supports_result_caching: bool = True
    # True where writer tasks on any node can append a table's parts and
    # the coordinator can commit or drop them (scaled writers)
    supports_distributed_writes: bool = False

    # --- metadata --------------------------------------------------------
    def get_table(self, schema: str, table: str) -> Optional[TableSchema]:
        raise NotImplementedError

    # --- optimizer pushdown hooks ----------------------------------------
    # Reference: ``spi/connector/ConnectorMetadata.java`` applyLimit
    # (:1064), applyTopN (:1090), applyAggregation (:932); applyFilter's
    # analog is the constraint/prune_splits path below.

    def apply_limit(self, schema: str, table: str, count: int) -> bool:
        """True if the connector will honor a read-at-most-``count`` hint
        on its scans (guarantee-free: the engine still enforces LIMIT)."""
        return False

    def apply_topn(
        self, schema: str, table: str, keys: list, count: int
    ) -> bool:
        """True ONLY if this connector's ``get_splits_with_hints`` orders
        scans by ``keys`` ([(column, ascending)]) well enough that the
        first ``count`` rows read contain the true top-N — the engine
        stops reading splits at the limit when this returns True (the
        TopN node above still sorts/cuts what was read)."""
        return False

    def get_splits_with_hints(
        self,
        schema: str,
        table: str,
        target_splits: int,
        constraint=None,
        limit: Optional[int] = None,
        topn: Optional[list] = None,
    ) -> list["Split"]:
        """Split enumeration with the optimizer's pushed limit/topn hints.

        Default ignores the hints (safe: the engine only trusts them when
        the connector's apply_limit/apply_topn accepted). Connectors that
        accept override this to cap or order their splits."""
        return self.get_splits(schema, table, target_splits, constraint)

    def apply_aggregation_count(self, schema: str, table: str):
        """Exact total row count, or None when the connector cannot answer
        without scanning. ONLY return a value that is exactly correct —
        the optimizer replaces a global count(*) with it."""
        return None

    # --- splits + data ---------------------------------------------------
    def get_splits(
        self,
        schema: str,
        table: str,
        target_splits: int,
        constraint: Optional[TupleDomain] = None,
    ) -> list[Split]:
        return self.prune_splits(schema, table, [Split(table, 0, 1)], constraint)

    def prune_splits(
        self,
        schema: str,
        table: str,
        splits: list[Split],
        constraint: Optional[TupleDomain],
    ) -> list[Split]:
        """Drop splits whose min/max stats cannot satisfy ``constraint``
        (reference: stripe/row-group pruning,
        ``lib/trino-orc/.../TupleDomainOrcPredicate.java:74,92``)."""
        if constraint is None or constraint.is_all():
            return splits
        if constraint.is_none():
            return []
        out = []
        for s in splits:
            stats = self.split_stats(schema, table, s)
            if stats is None or constraint.overlaps_stats(stats):
                out.append(s)
        return out

    def split_stats(
        self, schema: str, table: str, split: Split
    ) -> Optional[dict[str, tuple[Any, Any, bool]]]:
        """column -> (min, max, has_null) for this split, or None if unknown."""
        return None

    def read_split(
        self, schema: str, table: str, columns: Sequence[str], split: Split
    ) -> Batch:
        raise NotImplementedError

    def data_version(self, schema: str, table: str) -> Any:
        """A token that changes whenever the table's data changes; keys
        the device table cache (``ingest.py``), so a write makes cached
        device columns unreachable. Mutable connectors bump
        ``_version``."""
        return getattr(self, "_version", 0)

    def data_versions(self, schema: str, table: str) -> Optional[list]:
        """Part-level version enumeration: ordered ``(part_id, token)``
        pairs, one per immutable storage part, or None when the connector
        cannot enumerate parts (the result cache then falls back to the
        coarse :meth:`data_version` token, where any change invalidates).

        Contract: a part's token never changes while its id is live; an
        APPEND adds new ids and leaves every old pair intact; any other
        mutation (rewrite, delete, truncate) removes or changes at least
        one old pair. This is what lets the result cache tell "maintain
        incrementally over the new parts" from "invalidate"."""
        return None

    def splits_for_parts(self, schema: str, table, part_ids) -> list["Split"]:
        """Splits covering exactly the parts named by ``part_ids`` (ids
        from :meth:`data_versions`): the delta scan of incremental
        aggregate maintenance. Required when data_versions is implemented."""
        raise NotImplementedError(f"{self.name}: part-level splits not supported")

    # --- optional stats (drives join distribution / sizing) -------------
    def estimate_rows(self, schema: str, table: str) -> Optional[int]:
        return None

    def table_stats(self, schema: str, table: str) -> Optional[TableStats]:
        """Reference: ``ConnectorMetadata.getTableStatistics`` — CBO input."""
        rows = self.estimate_rows(schema, table)
        return TableStats(row_count=rows) if rows is not None else None

    # --- optional write path --------------------------------------------
    def create_table(self, schema: str, table: str, schema_def: TableSchema) -> None:
        raise NotImplementedError(f"{self.name}: CREATE TABLE not supported")

    def insert(self, schema: str, table: str, batch: Batch) -> int:
        raise NotImplementedError(f"{self.name}: INSERT not supported")


class CatalogManager:
    """Catalog name -> connector instance (reference:
    ``metadata/MetadataManager.java:184`` catalog routing)."""

    def __init__(self):
        self._catalogs: dict[str, Connector] = {}

    def register(self, name: str, connector: Connector) -> None:
        self._catalogs[name] = connector

    def get(self, name: str) -> Connector:
        if name not in self._catalogs:
            raise KeyError(f"catalog not found: {name}")
        return self._catalogs[name]

    def names(self) -> list[str]:
        return sorted(self._catalogs)


# staging quantum: slabs are padded to a multiple of this row count, so
# any power-of-two chunk size up to the quantum can slice them evenly —
# one staged copy serves every chunk-size setting
SLAB_PAD_QUANTUM = 1 << 22


def slab_padded_rows(rows: int, cap: int) -> int:
    """Rows a staged slab actually allocates (quantum padding)."""
    quantum = max(cap, SLAB_PAD_QUANTUM)
    return ((rows + quantum - 1) // quantum) * quantum


def slab_bytes_estimate(types: Sequence, rows: int, cap: int) -> int:
    """Bytes needed to stage ``rows`` of these column types on the device —
    measured at the PADDED allocation (wide DECIMALs store (n, 2) int64
    lanes; +1 byte/row validity), so admission bounds reflect reality."""
    import numpy as np

    padded = slab_padded_rows(rows, cap)
    nbytes = 0
    for t in types:
        width = np.dtype(t.storage_dtype).itemsize
        if getattr(t, "wide", False):
            width *= 2
        nbytes += padded * (width + 1)
    return nbytes


def stage_device_slab(host_batches: Sequence[Batch], cap: int, device):
    """Stage host batches onto ``device`` as ONE slab padded to a multiple
    of ``cap`` rows (and of :data:`SLAB_PAD_QUANTUM`), so any power-of-two
    chunk size up to the quantum slices it without clamping. Per-part
    dictionaries are unified during the concat. Returns
    (slab_batch, num_rows).

    Shared by connectors whose data can live device-resident (memory
    pages): device memory plays the role the reference's worker heap
    plays for pinned pages."""
    from trino_tpu_torch.columnar import Column, concat_batches, pad_batch

    host = concat_batches(list(host_batches))
    total_rows = host.num_rows
    padded = pad_batch(host, slab_padded_rows(total_rows, cap))
    cols = [
        Column(
            c.type,
            c.data.to(device),
            None if c.valid is None else c.valid.to(device),
            c.dictionary,
        )
        for c in padded.columns
    ]
    return Batch(cols, padded.capacity), total_rows


class DeviceColumnStore:
    """A generating connector's columns staged on a device, one per
    (schema, table, column, device) and kept across queries: a query that
    reads some of an earlier query's columns generates and copies only the
    missing ones. Device memory is the connector's page store; the tpch
    and tpcds connectors' ``device_slab`` stage through it."""

    def __init__(self):
        self._cols: dict[tuple, tuple] = {}

    def slab(self, schema, table, columns: Sequence[str], types: Sequence,
             rows: int, cap: int, max_bytes: int, device, generate):
        """(slab_batch, num_rows) of ``columns``, or None when they would
        take more than ``max_bytes`` staged. ``generate(missing)`` returns
        the host batches, in split order, of the columns not yet staged at
        a capacity that ``cap`` divides."""
        if not rows or not columns:
            return None
        if slab_bytes_estimate(types, rows, cap) > max_bytes:
            return None

        def key(c):
            return (schema, table, c, str(device))

        missing = []
        for c in columns:
            hit = self._cols.get(key(c))
            if hit is None or hit[0].capacity % cap:
                missing.append(c)
        if missing:
            slab, num_rows = stage_device_slab(generate(missing), cap, device)
            for c, col in zip(missing, slab.columns):
                self._cols[key(c)] = (col, num_rows)
        staged = [self._cols[key(c)] for c in columns]
        cols = [col for col, _ in staged]
        return Batch(cols, cols[0].capacity, placement=device), staged[0][1]

    def staged(self, schema, table, columns: Sequence[str]):
        """``(columns, num_rows)`` of ``columns`` where one device holds
        them all already, else None: what an earlier ``slab`` staged."""
        devices = {k[3] for k in self._cols if k[:2] == (schema, table)}
        for dev in sorted(devices):
            hits = [self._cols.get((schema, table, c, dev)) for c in columns]
            if columns and all(h is not None for h in hits) \
                    and len({n for _, n in hits}) == 1:
                return [col for col, _ in hits], hits[0][1]
        return None


def batch_column_stats(columns, batch) -> dict:
    """Per-column (min, max, has_null) for a compacted batch — shared by
    stats-collecting connectors (the stripe-footer computation)."""
    out: dict[str, tuple] = {}
    for cs, col in zip(columns, batch.columns):
        if T.is_string(cs.type) or batch.num_rows == 0:
            continue
        data, valid = col.to_numpy()
        data = data[: batch.num_rows]
        valid = valid[: batch.num_rows]
        live = data[valid]
        has_null = bool((~valid).any())
        if live.size:
            out[cs.name] = (live.min().item(), live.max().item(), has_null)
        else:
            out[cs.name] = (None, None, has_null)
    return out


def register_catalog_spec(manager: CatalogManager, spec: str) -> None:
    """Register a connector from a ``name=kind[:arg]`` spec string
    (reference: ``trino_tpu/connectors/api.py::register_catalog_spec``,
    the ``etc/catalog/*.properties`` analog), with the reference's kinds:
    ``memory``, ``blackhole``, ``file:<dir>``, ``parquet:<dir>``,
    ``orc:<dir>`` and ``tpch``."""
    name, _, rest = spec.partition("=")
    kind, _, arg = rest.partition(":")
    name, kind = name.strip(), kind.strip()
    if kind == "memory":
        from trino_tpu_torch.connectors.memory import MemoryConnector

        manager.register(name, MemoryConnector())
    elif kind == "blackhole":
        from trino_tpu_torch.connectors.blackhole import BlackHoleConnector

        manager.register(name, BlackHoleConnector())
    elif kind == "file":
        from trino_tpu_torch.connectors.file import FileConnector

        manager.register(name, FileConnector(arg))
    elif kind == "parquet":
        from trino_tpu_torch.connectors.parquet import ParquetConnector

        manager.register(name, ParquetConnector(arg))
    elif kind == "orc":
        from trino_tpu_torch.connectors.orc import OrcConnector

        manager.register(name, OrcConnector(arg))
    elif kind == "tpch":
        from trino_tpu_torch.connectors.tpch import TpchConnector

        # ``tpch:<rows>``: rows a split (a cluster's tests split tiny
        # tables over several tasks); any other argument is ignored, as
        # the reference ignores it
        split_rows = int(arg) if arg and arg.isdigit() else None
        manager.register(name, TpchConnector() if split_rows is None
                         else TpchConnector(split_rows=split_rows))
    else:
        raise ValueError(f"unknown catalog kind in spec: {spec!r}")
