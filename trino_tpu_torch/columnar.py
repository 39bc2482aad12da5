"""Columnar batch model on torch tensors: the analog of Trino's Page/Block.

Reference: ``core/trino-spi/src/main/java/io/trino/spi/Page.java:53-85``.

- A :class:`Column` is a fixed-width tensor plus an optional validity
  mask. Strings carry a host-side :class:`Dictionary` (int32 codes in the
  tensor).
- A :class:`Batch` is a list of equal-capacity columns plus a *selection*
  mask. Filters AND into the selection instead of compacting; compaction
  happens on the host at output boundaries.

Connectors keep host batches (CPU tensors); executors move them onto the
engine's device. :func:`batch_from_numpy` is the one way numpy column data
enters the engine, so a table loads identically into this engine and the
JAX reference.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T


def torch_dtype(np_dtype) -> torch.dtype:
    """torch dtype for a numpy storage dtype (``SqlType.storage_dtype``)."""
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def as_tensor(x, device=None) -> torch.Tensor:
    """numpy array / tensor -> tensor on ``device`` (no copy when it is
    already there)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x if device is None else x.to(device)


class Dictionary:
    """Host-side string dictionary. Code i <-> string values[i].

    Codes are dense int32; a NULL string has code -1."""

    __slots__ = ("values", "_index", "_ranks", "__weakref__")

    def __init__(self, values: Sequence[str]):
        self.values: list[str] = list(values)
        self._index: dict[str, int] | None = None
        # (length, ranks, order) of the last ranking: values only ever
        # append (``absorb``), so an unchanged length means unchanged ranks
        self._ranks: tuple | None = None

    def __len__(self) -> int:
        return len(self.values)

    def decode(self, code: int) -> str | None:
        if code < 0:
            return None
        return self.values[code]

    def index(self) -> dict[str, int]:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index

    def encode(self, value: str) -> int:
        """Code for value, or -1 if absent (useful for predicates)."""
        return self.index().get(value, -1)

    def ranks(self) -> np.ndarray:
        """rank[code] gives the lexicographic rank of each dictionary entry."""
        return self._ranking()[0]

    def order(self) -> np.ndarray:
        """order[rank] gives the code of each rank (the inverse of
        :meth:`ranks`)."""
        return self._ranking()[1]

    def _ranking(self) -> tuple[np.ndarray, np.ndarray]:
        n = len(self.values)
        if self._ranks is None or self._ranks[0] != n:
            values = np.empty(n, dtype=object)
            values[:] = self.values  # tuples (pool values) stay elements
            order = np.argsort(values, kind="stable")
            ranks = np.empty(n, dtype=np.int64)
            ranks[order] = np.arange(n, dtype=np.int64)
            self._ranks = (n, ranks, order)
        return self._ranks[1], self._ranks[2]

    @staticmethod
    def from_strings(strings: Iterable[str]) -> tuple["Dictionary", np.ndarray]:
        """Build a dictionary and the int32 code array for a string
        sequence (first-occurrence order), through the native hash table
        (``native.dict_encode``), as the reference does."""
        from trino_tpu_torch.native import dict_encode

        strings = strings if isinstance(strings, list) else list(strings)
        codes, values = dict_encode(strings)
        return Dictionary(values), codes

    def absorb(self, other: "Dictionary") -> tuple[np.ndarray | None, bool]:
        """Merge ``other``'s values into *this* dictionary in place
        (append-only: existing codes stay valid).

        Returns (remap, grew): ``remap[other_code] -> my code`` (None when
        the dictionaries already agree code for code), and whether new
        values were appended."""
        if other is self:
            return None, False
        index = self.index()
        remap = np.empty(len(other.values), dtype=np.int32)
        grew = False
        identical = len(other.values) <= len(self.values)
        for i, v in enumerate(other.values):
            code = index.get(v)
            if code is None:
                code = len(self.values)
                self.values.append(v)
                index[v] = code
                grew = True
                identical = False
            elif code != i:
                identical = False
            remap[i] = code
        return (None if identical else remap), grew

    def merged(self, other: "Dictionary") -> tuple["Dictionary", np.ndarray]:
        """Merge other into a new dictionary; returns (merged, remap) where
        remap[old_other_code] = new code."""
        values = list(self.values)
        index = dict(self.index())
        remap = np.empty(len(other.values), dtype=np.int32)
        for i, v in enumerate(other.values):
            code = index.get(v)
            if code is None:
                code = len(values)
                index[v] = code
                values.append(v)
            remap[i] = code
        d = Dictionary(values)
        d._index = index
        return d, remap


@dataclasses.dataclass
class Column:
    """One column: tensor data + optional validity + optional dictionary."""

    type: T.SqlType
    data: torch.Tensor
    valid: torch.Tensor | None = None  # None = all valid
    dictionary: Dictionary | None = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(
                self.data.shape[0], dtype=torch.bool, device=self.data.device
            )
        return self.valid

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        data = self.data.cpu().numpy()
        valid = (
            np.ones(data.shape[0], dtype=np.bool_)
            if self.valid is None
            else self.valid.cpu().numpy()
        )
        return data, valid

    def to(self, device) -> "Column":
        return Column(
            self.type,
            self.data.to(device),
            None if self.valid is None else self.valid.to(device),
            self.dictionary,
        )

    def take(self, idx: torch.Tensor) -> "Column":
        """Rows ``idx`` on the column's device."""
        valid = None if self.valid is None else self.valid[idx]
        return Column(self.type, self.data[idx], valid, self.dictionary)


@dataclasses.dataclass
class Batch:
    """A batch of rows: equal-capacity columns + selection mask + row count.

    ``num_rows`` is the count of *physical* rows (leading); rows past it are
    padding. ``sel`` (optional, shape (capacity,)) marks rows surviving
    filters. Logical rows = first num_rows AND sel. A batch with no
    columns and no selection (a scan that reads no column) keeps the
    device it was made on or moved to in ``placement``.

    ``shards`` > 1 marks a batch sharded over a mesh of that many shards
    (``parallel/mesh.py``): its rows are shard-major, shard ``s`` holding
    rows ``[s * cap, (s + 1) * cap)`` of ``cap = capacity // shards``, the
    reference's row-sharded global array (``_is_sharded``,
    ``trino_tpu/parallel/distributed.py:859``).
    """

    columns: list[Column]
    num_rows: int
    sel: torch.Tensor | None = None
    placement: torch.device | None = None
    shards: int = 1

    @property
    def capacity(self) -> int:
        if self.columns:
            return self.columns[0].capacity
        if self.sel is not None:
            return int(self.sel.shape[0])
        return self.num_rows

    @property
    def device(self) -> torch.device:
        if self.columns:
            return self.columns[0].data.device
        if self.sel is not None:
            return self.sel.device
        return torch.device(self.placement or "cpu")

    @property
    def width(self) -> int:
        return len(self.columns)

    def count_rows(self) -> int:
        """Number of selected rows (one host read)."""
        return int(self.selection_mask().sum())

    def selection_mask(self) -> torch.Tensor:
        """Full boolean mask over capacity combining num_rows and sel."""
        base = torch.arange(self.capacity, device=self.device) < self.num_rows
        if self.sel is not None:
            base = base & self.sel
        return base

    def to(self, device) -> "Batch":
        return Batch(
            [c.to(device) for c in self.columns],
            self.num_rows,
            None if self.sel is None else self.sel.to(device),
            torch.device(device),
        )

    def take(self, idx: torch.Tensor) -> "Batch":
        """The rows ``idx`` (all selected) on the batch's device."""
        return Batch(
            [c.take(idx) for c in self.columns], int(idx.shape[0]), None,
            self.device,
        )

    def to_host(self) -> "Batch":
        """Copy every tensor to the host."""
        return self.to("cpu")

    def compact(self) -> "Batch":
        """Materialize selection: gather surviving rows to the front (host)."""
        if self.sel is None and all(
            c.capacity == self.num_rows for c in self.columns
        ):
            return self.to("cpu")
        b = self.to_host()
        idx = torch.nonzero(b.selection_mask()).reshape(-1)
        cols = []
        for c in b.columns:
            valid = c.valid_mask()[idx]
            cols.append(
                Column(
                    c.type,
                    c.data[idx],
                    None if bool(valid.all()) else valid,
                    c.dictionary,
                )
            )
        return Batch(cols, int(idx.shape[0]), None)

    def to_pylist(self) -> list[tuple]:
        """Rows as Python tuples (client output/testing): each value is
        its type's ``to_python``, a column at a time where that is a plain
        conversion (:func:`python_values`)."""
        b = self.compact()
        n = b.num_rows
        out_cols = []
        for c in b.columns:
            data, valid = c.to_numpy()
            col = python_values(c.type, data[:n], valid[:n])
            if col is None:
                col = [
                    c.type.to_python(data[i], c.dictionary) if valid[i] else None
                    for i in range(n)
                ]
            out_cols.append(col)
        return list(zip(*out_cols)) if out_cols else [() for _ in range(n)]


def python_values(t: T.SqlType, data: np.ndarray, valid: np.ndarray) -> Optional[list]:
    """The values of a host column as its type's ``to_python`` gives
    them (None where ``valid`` is false), converted a column at a time for
    the types where that is a plain conversion: BOOLEAN, the integers,
    REAL and DOUBLE (``tolist``), a narrow DECIMAL (its unscaled ints
    divided as ``to_python`` divides them) and DATE (each distinct day
    converted once); None for the other types."""
    kind = type(t)
    if kind in (T.BooleanType, T.IntegerLikeType, T.RealType, T.DoubleType):
        values = data.tolist()
    elif kind is T.DecimalType and data.ndim == 1:
        from decimal import Decimal

        unscale = 10**t.scale
        values = ([Decimal(v) / unscale for v in data.tolist()] if t.scale
                  else [Decimal(v) for v in data.tolist()])
    elif kind is T.DateType:
        days, inverse = np.unique(np.where(valid, data, 0), return_inverse=True)
        text = [t.to_python(d) for d in days]
        values = [text[i] for i in inverse.reshape(-1).tolist()]
    else:
        return None
    if valid.all():
        return values
    return [v if ok else None for v, ok in zip(values, valid.tolist())]


def host_column(
    t: T.SqlType,
    data: np.ndarray,
    valid: np.ndarray | None = None,
    dictionary: Dictionary | None = None,
) -> Column:
    """A host column from decoded numpy data (codes when ``dictionary`` is
    given), cast to the type's storage dtype: how the file formats' and
    the pages serde's numpy columns enter the engine."""
    data = np.ascontiguousarray(np.asarray(data).astype(t.storage_dtype, copy=False))
    return Column(
        t, as_tensor(data),
        None if valid is None else as_tensor(np.asarray(valid, np.bool_)),
        dictionary,
    )


def batch_from_numpy(
    types: Sequence[T.SqlType],
    arrays: Sequence[np.ndarray],
    valids: Sequence[np.ndarray | None] | None = None,
) -> Batch:
    """Host Batch from numpy column data, one array (and optional validity
    mask) per column. The arrays are cast to each type's storage dtype;
    string columns take Python strings and are dictionary-encoded."""
    valids = valids or [None] * len(arrays)
    cols = []
    n = len(arrays[0]) if arrays else 0
    for t, a, v in zip(types, arrays, valids):
        a = np.asarray(a)
        if len(a) != n:
            raise ValueError("batch_from_numpy: columns differ in length")
        dictionary = None
        if T.is_string(t):
            dictionary, a = Dictionary.from_strings([str(s) for s in a])
        cols.append(host_column(t, a, v, dictionary))
    return Batch(cols, n, None)


def concat_batches(batches: Sequence[Batch]) -> Batch:
    """Host-side concatenation (compacting). Used at stage boundaries."""
    if not batches:
        raise ValueError("concat of zero batches")
    batches = [b.compact() for b in batches]
    nonempty = [b for b in batches if b.num_rows > 0]
    batches = nonempty or batches[:1]
    if len(batches) == 1:
        return batches[0]
    cols = []
    for j in range(batches[0].width):
        parts = [b.columns[j] for b in batches]
        t = parts[0].type
        dictionary = None
        datas = []
        if T.is_string(t):
            dictionary = parts[0].dictionary or Dictionary([])
            for p in parts:
                data = p.data
                if p.dictionary is not None and p.dictionary is not dictionary:
                    dictionary, remap = dictionary.merged(p.dictionary)
                    data = remap_codes(data, remap)
                datas.append(data)
        else:
            datas = [p.data for p in parts]
        data = torch.cat(datas)
        valid = torch.cat([p.valid_mask() for p in parts])
        cols.append(
            Column(t, data, None if bool(valid.all()) else valid, dictionary)
        )
    return Batch(cols, sum(b.num_rows for b in batches), None)


def remap_codes(codes: torch.Tensor, remap: np.ndarray) -> torch.Tensor:
    """Dictionary codes through ``remap`` (old code -> new code); a NULL
    code (-1) stays -1, also when the old dictionary is empty."""
    table = as_tensor(np.append(remap, -1).astype(np.int64), codes.device)
    idx = torch.where(codes >= 0, codes.long(), len(remap))
    return table[idx].to(torch.int32)


def pad_batch(batch: Batch, capacity: int) -> Batch:
    """Pad physical rows up to capacity with zero rows (not selected)."""
    b = batch
    if b.capacity == capacity:
        return b
    if b.capacity > capacity:
        raise ValueError(f"batch capacity {b.capacity} > target {capacity}")
    pad = capacity - b.capacity
    cols = []
    for c in b.columns:
        data = torch.cat(
            [c.data, c.data.new_zeros((pad,) + tuple(c.data.shape[1:]))]
        )
        valid = None
        if c.valid is not None:
            valid = torch.cat([c.valid, c.valid.new_zeros(pad)])
        cols.append(Column(c.type, data, valid, c.dictionary))
    sel = batch.sel
    if sel is not None:
        sel = torch.cat([sel, sel.new_zeros(pad)])
    return Batch(cols, b.num_rows, sel)


def bucket_capacity(n: int, minimum: int = 1024) -> int:
    """Round up to a power of two (shape bucketing)."""
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap
