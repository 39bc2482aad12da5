"""Parquet reader/writer built from scratch (no external libraries).

Reference: ``lib/trino-parquet`` — a from-scratch reader with row-group
pruning and dictionary/RLE decoding (``parquet/reader/ParquetReader.java:65``,
``nextBatch:161``, ``parquet/predicate/``). Matching that design here:

- Thrift *compact protocol* decoding/encoding for the footer and page
  headers (the only wire metadata format Parquet uses).
- Hot byte work in C++ (``trino_tpu_torch/csrc/columnar.cpp``): snappy
  codec, RLE/bit-packed hybrid runs (definition levels + dictionary
  indices); NumPy handles PLAIN fixed-width ranges zero-copy.
- Row-group ``Statistics`` surface as (min, max, has_null) for TupleDomain
  pruning — the same shape the file connector's stripe stats use.

Supported surface (flat schemas): BOOLEAN, INT32, INT64, FLOAT, DOUBLE,
BYTE_ARRAY (UTF8 -> dictionary varchar), DATE, TIMESTAMP micros, DECIMAL
over INT32/INT64; PLAIN + RLE/PLAIN dictionary encodings; UNCOMPRESSED,
SNAPPY and GZIP codecs; optional (nullable) and required fields.

A copy of ``trino_tpu/formats/parquet.py``: columns decode into NumPy and
enter the engine as host tensors (``columnar.host_column``). Unlike the
reference, which hands the whole file to the decoder for each row group,
:func:`read_row_group` reads the footer and the byte ranges of one row
group's column chunks only; the rows are the same.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Any, BinaryIO, Optional

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, Dictionary, host_column
from trino_tpu_torch.native import (
    parquet_rle_decode,
    parquet_rle_encode,
    snappy_compress,
    snappy_decompress,
)

MAGIC = b"PAR1"

# parquet physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FLBA = range(8)
# encodings
ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE, ENC_RLE_DICT = 0, 2, 3, 8
# codecs
CODEC_UNCOMPRESSED, CODEC_SNAPPY, CODEC_GZIP = 0, 1, 2
# converted types
CT_UTF8, CT_DECIMAL, CT_DATE = 0, 5, 6
CT_TIMESTAMP_MILLIS, CT_TIMESTAMP_MICROS = 9, 10
# page types
PAGE_DATA, PAGE_DICT = 0, 2


# === thrift compact protocol ================================================


class _TReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def zigzag(self) -> int:
        u = self.varint()
        return (u >> 1) ^ -(u & 1)

    def read_binary(self) -> bytes:
        n = self.varint()
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def skip(self, ttype: int) -> None:
        if ttype in (1, 2):
            return
        if ttype == 3:
            self.pos += 1
        elif ttype in (4, 5, 6):
            self.varint()
        elif ttype == 7:
            self.pos += 8
        elif ttype == 8:
            self.read_binary()
        elif ttype in (9, 10):
            size, etype = self.list_header()
            for _ in range(size):
                self.skip(etype)
        elif ttype == 12:
            self.skip_struct()
        else:
            raise ValueError(f"cannot skip thrift type {ttype}")

    def skip_struct(self) -> None:
        for _fid, ftype in self.fields():
            self.skip(ftype)

    def fields(self):
        """Yield (field_id, type) until STOP; caller must consume values."""
        fid = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            if b == 0:
                return
            delta = b >> 4
            ftype = b & 0x0F
            fid = fid + delta if delta else self.zigzag()
            yield fid, ftype

    def list_header(self) -> tuple[int, int]:
        b = self.data[self.pos]
        self.pos += 1
        size = b >> 4
        etype = b & 0x0F
        if size == 15:
            size = self.varint()
        return size, etype


class _TWriter:
    def __init__(self):
        self.out = bytearray()
        self._last_fid = [0]

    def varint(self, v: int) -> None:
        while v >= 0x80:
            self.out.append((v & 0x7F) | 0x80)
            v >>= 7
        self.out.append(v)

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def field(self, fid: int, ftype: int) -> None:
        delta = fid - self._last_fid[-1]
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ftype)
        else:
            self.out.append(ftype)
            self.zigzag(fid)
        self._last_fid[-1] = fid

    def i32(self, fid: int, v: int) -> None:
        self.field(fid, 5)
        self.zigzag(v)

    def i64(self, fid: int, v: int) -> None:
        self.field(fid, 6)
        self.zigzag(v)

    def binary(self, fid: int, v: bytes) -> None:
        self.field(fid, 8)
        self.varint(len(v))
        self.out += v

    def begin_struct(self, fid: Optional[int] = None) -> None:
        if fid is not None:
            self.field(fid, 12)
        self._last_fid.append(0)

    def end_struct(self) -> None:
        self.out.append(0)
        self._last_fid.pop()

    def list_begin(self, fid: int, etype: int, size: int) -> None:
        self.field(fid, 9)
        if size < 15:
            self.out.append((size << 4) | etype)
        else:
            self.out.append((15 << 4) | etype)
            self.varint(size)


# === metadata model =========================================================


@dataclasses.dataclass
class ParquetColumn:
    name: str
    physical: int
    converted: Optional[int] = None
    optional: bool = True
    scale: int = 0
    precision: int = 0

    def sql_type(self) -> T.SqlType:
        if self.converted == CT_DECIMAL:
            return T.decimal(self.precision or 18, self.scale)
        if self.converted == CT_DATE:
            return T.DATE
        if self.converted in (CT_TIMESTAMP_MILLIS, CT_TIMESTAMP_MICROS):
            return T.TIMESTAMP
        if self.physical == BOOLEAN:
            return T.BOOLEAN
        if self.physical == INT32:
            return T.INTEGER
        if self.physical == INT64:
            return T.BIGINT
        if self.physical == FLOAT:
            return T.REAL
        if self.physical == DOUBLE:
            return T.DOUBLE
        if self.physical == BYTE_ARRAY:
            return T.VARCHAR
        raise ValueError(f"unsupported parquet type {self.physical}")


@dataclasses.dataclass
class ColumnChunkMeta:
    column: ParquetColumn
    codec: int
    num_values: int
    data_page_offset: int
    dictionary_page_offset: Optional[int]
    total_compressed_size: int
    stats_min: Optional[bytes] = None
    stats_max: Optional[bytes] = None
    null_count: Optional[int] = None


@dataclasses.dataclass
class RowGroupMeta:
    num_rows: int
    columns: list[ColumnChunkMeta]


@dataclasses.dataclass
class FileMeta:
    num_rows: int
    schema: list[ParquetColumn]
    row_groups: list[RowGroupMeta]


def _parse_schema_element(r: _TReader) -> dict:
    out: dict[str, Any] = {}
    for fid, ftype in r.fields():
        if fid == 1:
            out["type"] = r.zigzag()
        elif fid == 2:
            out["type_length"] = r.zigzag()
        elif fid == 3:
            out["repetition"] = r.zigzag()
        elif fid == 4:
            out["name"] = r.read_binary().decode()
        elif fid == 5:
            out["num_children"] = r.zigzag()
        elif fid == 6:
            out["converted"] = r.zigzag()
        elif fid == 7:
            out["scale"] = r.zigzag()
        elif fid == 8:
            out["precision"] = r.zigzag()
        else:
            r.skip(ftype)
    return out


def _parse_statistics(r: _TReader) -> dict:
    out: dict[str, Any] = {}
    for fid, ftype in r.fields():
        if fid == 1:
            out.setdefault("max", r.read_binary())
        elif fid == 2:
            out.setdefault("min", r.read_binary())
        elif fid == 3:
            out["null_count"] = r.zigzag()
        elif fid == 5:
            out["max"] = r.read_binary()
        elif fid == 6:
            out["min"] = r.read_binary()
        else:
            r.skip(ftype)
    return out


def _parse_column_meta(r: _TReader, schema_by_name: dict) -> ColumnChunkMeta:
    vals: dict[str, Any] = {}
    for fid, ftype in r.fields():
        if fid == 3:
            size, _ = r.list_header()
            parts = [r.read_binary().decode() for _ in range(size)]
            vals["path"] = parts[-1] if parts else ""
        elif fid == 4:
            vals["codec"] = r.zigzag()
        elif fid == 5:
            vals["num_values"] = r.zigzag()
        elif fid == 9:
            vals["data_page_offset"] = r.zigzag()
        elif fid == 11:
            vals["dictionary_page_offset"] = r.zigzag()
        elif fid == 7:
            vals["total_compressed_size"] = r.zigzag()
        elif fid == 12:
            vals["stats"] = _parse_statistics(r)
        elif fid == 2:
            size, etype = r.list_header()
            for _ in range(size):
                r.skip(etype)
        else:
            r.skip(ftype)
    col = schema_by_name[vals["path"]]
    stats = vals.get("stats", {})
    return ColumnChunkMeta(
        column=col,
        codec=vals.get("codec", 0),
        num_values=vals.get("num_values", 0),
        data_page_offset=vals.get("data_page_offset", 0),
        dictionary_page_offset=vals.get("dictionary_page_offset"),
        total_compressed_size=vals.get("total_compressed_size", 0),
        stats_min=stats.get("min"),
        stats_max=stats.get("max"),
        null_count=stats.get("null_count"),
    )


def read_footer(data: bytes) -> FileMeta:
    if data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ValueError("not a parquet file (bad magic)")
    (meta_len,) = struct.unpack("<I", data[-8:-4])
    r = _TReader(data, len(data) - 8 - meta_len)
    num_rows = 0
    schema: list[ParquetColumn] = []
    row_groups: list[RowGroupMeta] = []
    for fid, ftype in r.fields():
        if fid == 2:  # schema
            size, _ = r.list_header()
            raw = [_parse_schema_element(r) for _ in range(size)]
            for el in raw[1:]:  # raw[0] is the root group
                if "type" not in el:
                    raise ValueError("nested parquet schemas not supported")
                schema.append(
                    ParquetColumn(
                        name=el["name"].lower(),
                        physical=el["type"],
                        converted=el.get("converted"),
                        optional=el.get("repetition", 1) == 1,
                        scale=el.get("scale", 0),
                        precision=el.get("precision", 0),
                    )
                )
        elif fid == 3:
            num_rows = r.zigzag()
        elif fid == 4:  # row groups
            by_name = {c.name: c for c in schema}
            size, _ = r.list_header()
            for _ in range(size):
                rg_rows = 0
                rg_cols: list[ColumnChunkMeta] = []
                for rfid, rftype in r.fields():
                    if rfid == 1:
                        csize, _ = r.list_header()
                        for _ in range(csize):
                            for cfid, cftype in r.fields():
                                if cfid == 3:
                                    rg_cols.append(_parse_column_meta(r, by_name))
                                else:
                                    r.skip(cftype)
                    elif rfid == 3:
                        rg_rows = r.zigzag()
                    else:
                        r.skip(rftype)
                row_groups.append(RowGroupMeta(rg_rows, rg_cols))
        else:
            r.skip(ftype)
    return FileMeta(num_rows, schema, row_groups)


# === page decode ============================================================


def _decompress(codec: int, data: bytes, uncompressed: int) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return data
    if codec == CODEC_SNAPPY:
        return snappy_decompress(data, uncompressed)
    if codec == CODEC_GZIP:
        return zlib.decompress(data, 31)
    raise ValueError(f"unsupported parquet codec {codec}")


def _parse_page_header(r: _TReader) -> dict:
    out: dict[str, Any] = {"stats": None}
    for fid, ftype in r.fields():
        if fid == 1:
            out["type"] = r.zigzag()
        elif fid == 2:
            out["uncompressed"] = r.zigzag()
        elif fid == 3:
            out["compressed"] = r.zigzag()
        elif fid == 5:  # DataPageHeader
            dp: dict[str, Any] = {}
            for dfid, dftype in r.fields():
                if dfid == 1:
                    dp["num_values"] = r.zigzag()
                elif dfid == 2:
                    dp["encoding"] = r.zigzag()
                else:
                    r.skip(dftype)
            out["data"] = dp
        elif fid == 7:  # DictionaryPageHeader
            dh: dict[str, Any] = {}
            for dfid, dftype in r.fields():
                if dfid == 1:
                    dh["num_values"] = r.zigzag()
                elif dfid == 2:
                    dh["encoding"] = r.zigzag()
                else:
                    r.skip(dftype)
            out["dict"] = dh
        else:
            r.skip(ftype)
    return out


def _plain_values(col: ParquetColumn, body: bytes, n: int):
    if col.physical == INT32:
        return np.frombuffer(body, dtype="<i4", count=n)
    if col.physical == INT64:
        return np.frombuffer(body, dtype="<i8", count=n)
    if col.physical == FLOAT:
        return np.frombuffer(body, dtype="<f4", count=n)
    if col.physical == DOUBLE:
        return np.frombuffer(body, dtype="<f8", count=n)
    if col.physical == BOOLEAN:
        bits = np.unpackbits(
            np.frombuffer(body, dtype=np.uint8), bitorder="little"
        )
        return bits[:n].astype(np.bool_)
    if col.physical == BYTE_ARRAY:
        out = []
        pos = 0
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", body, pos)
            pos += 4
            out.append(body[pos : pos + ln].decode("utf-8", "surrogatepass"))
            pos += ln
        return out
    raise ValueError(f"unsupported PLAIN physical type {col.physical}")


def chunk_start(chunk: ColumnChunkMeta) -> int:
    """File offset of a column chunk's first page."""
    return (
        chunk.dictionary_page_offset
        if chunk.dictionary_page_offset is not None
        else chunk.data_page_offset
    )


def read_column_chunk(data: bytes, chunk: ColumnChunkMeta, base: int = 0):
    """Decode one column chunk -> (values ndarray-or-strlist, valid ndarray).
    ``data`` holds the file's bytes from offset ``base`` on."""
    col = chunk.column
    r = _TReader(data, chunk_start(chunk) - base)
    dictionary = None
    values_parts: list = []
    valid_parts: list[np.ndarray] = []
    remaining = chunk.num_values
    while remaining > 0:
        header = _parse_page_header(r)
        body = data[r.pos : r.pos + header["compressed"]]
        r.pos += header["compressed"]
        body = _decompress(chunk.codec, body, header["uncompressed"])
        if header["type"] == PAGE_DICT:
            dh = header["dict"]
            dictionary = _plain_values(col, body, dh["num_values"])
            continue
        if header["type"] != PAGE_DATA:
            raise ValueError(f"unsupported page type {header['type']}")
        dp = header["data"]
        n = dp["num_values"]
        pos = 0
        if col.optional:
            (dl_len,) = struct.unpack_from("<I", body, pos)
            pos += 4
            def_levels = parquet_rle_decode(body[pos : pos + dl_len], 1, n)
            pos += dl_len
            valid = def_levels.astype(np.bool_)
        else:
            valid = np.ones(n, dtype=np.bool_)
        n_present = int(valid.sum())
        enc = dp["encoding"]
        if enc in (ENC_PLAIN_DICT, ENC_RLE_DICT):
            if dictionary is None:
                raise ValueError("dictionary-encoded page without dictionary")
            bit_width = body[pos]
            pos += 1
            idx = parquet_rle_decode(body[pos:], bit_width, n_present)
            if isinstance(dictionary, list):
                present = [dictionary[i] for i in idx]
            else:
                present = dictionary[idx]
        elif enc == ENC_PLAIN:
            present = _plain_values(col, body[pos:], n_present)
        else:
            raise ValueError(f"unsupported data encoding {enc}")
        # scatter present values into n slots
        if isinstance(present, list) and n_present == n:
            values_parts.append(present)
        elif isinstance(present, list):
            vals: list = [""] * n
            j = 0
            for i in range(n):
                if valid[i]:
                    vals[i] = present[j]
                    j += 1
            values_parts.append(vals)
        else:
            full = np.zeros(n, dtype=present.dtype)
            full[valid] = present
            values_parts.append(full)
        valid_parts.append(valid)
        remaining -= n
    valid = np.concatenate(valid_parts) if valid_parts else np.zeros(0, bool)
    if values_parts and isinstance(values_parts[0], list):
        values: Any = [v for part in values_parts for v in part]
    else:
        values = (
            np.concatenate(values_parts)
            if values_parts
            else np.zeros(0, dtype=np.int64)
        )
    return values, valid


def _to_column(col: ParquetColumn, values, valid: np.ndarray) -> Column:
    t = col.sql_type()
    v = None if valid.all() else valid
    if isinstance(values, list):  # strings
        d, codes = Dictionary.from_strings(values)
        codes = np.where(valid, codes, -1).astype(np.int32)
        return host_column(t, codes, v, d)
    if isinstance(t, T.TimestampType) and col.converted == CT_TIMESTAMP_MILLIS:
        values = values.astype(np.int64) * 1000
    return host_column(t, values, v)


def read_batch(
    data: bytes, meta: FileMeta, row_group: int, columns: list[str]
) -> Batch:
    rg = meta.row_groups[row_group]
    by_name = {c.column.name: c for c in rg.columns}
    cols = []
    for name in columns:
        chunk = by_name[name.lower()]
        values, valid = read_column_chunk(data, chunk)
        cols.append(_to_column(chunk.column, values, valid))
    return Batch(cols, rg.num_rows)


def read_file_footer(f: BinaryIO) -> FileMeta:
    """The footer of an open Parquet file, reading its tail only."""
    f.seek(0)
    head = f.read(4)
    f.seek(-8, 2)
    tail8 = f.read(8)
    if head != MAGIC or tail8[4:] != MAGIC:
        raise ValueError("not a parquet file (bad magic)")
    (meta_len,) = struct.unpack("<I", tail8[:4])
    f.seek(-8 - meta_len, 2)
    return read_footer(MAGIC + f.read(meta_len + 8))


def read_row_group(
    f: BinaryIO, meta: FileMeta, row_group: int, columns: list[str]
) -> Batch:
    """:func:`read_batch` of one row group, reading the byte range of each
    wanted column chunk from the open file ``f`` and nothing else."""
    rg = meta.row_groups[row_group]
    by_name = {c.column.name: c for c in rg.columns}
    cols = []
    for name in columns:
        chunk = by_name[name.lower()]
        start = chunk_start(chunk)
        f.seek(start)
        values, valid = read_column_chunk(
            f.read(chunk.total_compressed_size), chunk, base=start
        )
        cols.append(_to_column(chunk.column, values, valid))
    return Batch(cols, rg.num_rows)


def _decode_stat(col: ParquetColumn, raw: Optional[bytes]):
    """Statistics min/max raw bytes -> engine storage scalar."""
    if raw is None:
        return None
    t = col.sql_type()
    if col.physical == INT32:
        v = struct.unpack("<i", raw)[0]
    elif col.physical == INT64:
        v = struct.unpack("<q", raw)[0]
    elif col.physical == FLOAT:
        v = struct.unpack("<f", raw)[0]
    elif col.physical == DOUBLE:
        v = struct.unpack("<d", raw)[0]
    elif col.physical == BYTE_ARRAY:
        return raw.decode("utf-8", "surrogatepass")
    elif col.physical == BOOLEAN:
        v = bool(raw[0])
    else:
        return None
    if isinstance(t, T.TimestampType) and col.converted == CT_TIMESTAMP_MILLIS:
        v = v * 1000
    return v


def row_group_stats(meta: FileMeta, row_group: int) -> dict:
    """Per-column (min, max, has_null) — TupleDomain pruning input
    (reference: TupleDomainParquetPredicate over row-group statistics)."""
    out = {}
    rg = meta.row_groups[row_group]
    for chunk in rg.columns:
        mn = _decode_stat(chunk.column, chunk.stats_min)
        mx = _decode_stat(chunk.column, chunk.stats_max)
        if mn is None and mx is None:
            continue
        has_null = bool(chunk.null_count) if chunk.null_count is not None else True
        out[chunk.column.name] = (mn, mx, has_null)
    return out


# === writer =================================================================


def _sql_to_parquet(t: T.SqlType) -> tuple[int, Optional[int], int, int]:
    """(physical, converted, scale, precision)."""
    if isinstance(t, T.BooleanType):
        return BOOLEAN, None, 0, 0
    if isinstance(t, T.IntegerLikeType):
        return (INT32, None, 0, 0) if t.bits <= 32 else (INT64, None, 0, 0)
    if isinstance(t, T.RealType):
        return FLOAT, None, 0, 0
    if isinstance(t, T.DoubleType):
        return DOUBLE, None, 0, 0
    if isinstance(t, T.DecimalType):
        return INT64, CT_DECIMAL, t.scale, t.precision
    if isinstance(t, T.DateType):
        return INT32, CT_DATE, 0, 0
    if isinstance(t, T.TimestampType):
        return INT64, CT_TIMESTAMP_MICROS, 0, 0
    if T.is_string(t):
        return BYTE_ARRAY, CT_UTF8, 0, 0
    raise ValueError(f"cannot write {t} to parquet")


def _encode_plain(col: Column, valid: np.ndarray) -> tuple[bytes, Any, Any]:
    """(body, min_raw, max_raw) for present values in PLAIN encoding."""
    t = col.type
    if T.is_string(t):
        # each dictionary value is encoded once; the rows pick theirs
        codes = np.asarray(col.data)[valid]
        used = np.unique(codes)
        enc = {
            int(c): (col.dictionary.decode(int(c)) or "").encode(
                "utf-8", "surrogatepass"
            )
            for c in used
        }
        framed = {c: struct.pack("<I", len(e)) + e for c, e in enc.items()}
        body = b"".join([framed[c] for c in codes.tolist()])
        mn = min(enc.values()) if enc else None
        mx = max(enc.values()) if enc else None
        return body, mn, mx
    data = np.asarray(col.data)[valid]
    if isinstance(t, T.BooleanType):
        body = np.packbits(data.astype(np.uint8), bitorder="little").tobytes()
        mn = struct.pack("<B", int(data.min())) if data.size else None
        mx = struct.pack("<B", int(data.max())) if data.size else None
        return body, mn, mx
    phys, _, _, _ = _sql_to_parquet(t)
    np_t = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[phys]
    arr = data.astype(np_t)
    body = arr.tobytes()
    if arr.size:
        mn = arr.min().tobytes()
        mx = arr.max().tobytes()
    else:
        mn = mx = None
    return body, mn, mx


def write_parquet(
    f: BinaryIO,
    names: list[str],
    batches: list[Batch],
    codec: int = CODEC_SNAPPY,
) -> None:
    """One row group per batch, PLAIN pages, v1 data pages + statistics."""
    f.write(MAGIC)
    offset = 4
    col_types = [c.type for c in batches[0].columns] if batches else []
    rg_metas = []
    for batch in batches:
        batch = batch.compact()
        chunk_metas = []
        for name, col in zip(names, batch.columns):
            _, valid_np = col.to_numpy()
            valid = valid_np
            body, mn, mx = _encode_plain(col, valid)
            n = batch.num_rows
            # optional def levels (4-byte length + RLE runs)
            dl = parquet_rle_encode(valid.astype(np.int32), 1)
            page_body = struct.pack("<I", len(dl)) + dl + body
            compressed = (
                snappy_compress(page_body)
                if codec == CODEC_SNAPPY
                else page_body
            )
            hw = _TWriter()
            hw.begin_struct()
            hw.i32(1, PAGE_DATA)
            hw.i32(2, len(page_body))
            hw.i32(3, len(compressed))
            hw.begin_struct(5)  # DataPageHeader
            hw.i32(1, n)
            hw.i32(2, ENC_PLAIN)
            hw.i32(3, ENC_RLE)
            hw.i32(4, ENC_RLE)
            hw.end_struct()
            hw.end_struct()
            header_bytes = bytes(hw.out)
            page_offset = offset
            f.write(header_bytes)
            f.write(compressed)
            offset += len(header_bytes) + len(compressed)
            null_count = int((~valid).sum())
            chunk_metas.append(
                (name, col.type, n, page_offset,
                 len(header_bytes) + len(compressed), mn, mx, null_count)
            )
        rg_metas.append((batch.num_rows, chunk_metas))

    # footer
    w = _TWriter()
    w.begin_struct()
    w.i32(1, 1)  # version
    # schema: root + leaves
    w.list_begin(2, 12, 1 + len(names))
    w.begin_struct()  # root
    w.binary(4, b"schema")
    w.i32(5, len(names))
    w.end_struct()
    for name, t in zip(names, col_types):
        phys, conv, scale, precision = _sql_to_parquet(t)
        w.begin_struct()
        w.i32(1, phys)
        w.i32(3, 1)  # OPTIONAL
        w.binary(4, name.encode())
        if conv is not None:
            w.i32(6, conv)
        if conv == CT_DECIMAL:
            w.i32(7, scale)
            w.i32(8, precision)
        w.end_struct()
    total_rows = sum(nr for nr, _ in rg_metas)
    w.i64(3, total_rows)
    w.list_begin(4, 12, len(rg_metas))
    for nr, chunk_metas in rg_metas:
        w.begin_struct()  # RowGroup
        w.list_begin(1, 12, len(chunk_metas))
        total_bytes = 0
        for name, t, n, page_offset, nbytes, mn, mx, null_count in chunk_metas:
            total_bytes += nbytes
            phys, conv, scale, precision = _sql_to_parquet(t)
            w.begin_struct()  # ColumnChunk
            w.i64(2, page_offset)  # file_offset
            w.begin_struct(3)  # ColumnMetaData
            w.i32(1, phys)
            w.list_begin(2, 5, 1)
            w.zigzag(ENC_PLAIN)
            w.list_begin(3, 8, 1)
            w.varint(len(name.encode()))
            w.out += name.encode()
            w.i32(4, codec)
            w.i64(5, n)
            w.i64(6, nbytes)
            w.i64(7, nbytes)
            w.i64(9, page_offset)
            w.begin_struct(12)  # Statistics
            w.i64(3, null_count)
            if mx is not None:
                w.binary(5, mx)
            if mn is not None:
                w.binary(6, mn)
            w.end_struct()
            w.end_struct()
            w.end_struct()
        w.i64(2, total_bytes)
        w.i64(3, nr)
        w.end_struct()
    w.binary(6, b"trino-tpu parquet writer")
    w.end_struct()
    meta_bytes = bytes(w.out)
    f.write(meta_bytes)
    f.write(struct.pack("<I", len(meta_bytes)))
    f.write(MAGIC)
