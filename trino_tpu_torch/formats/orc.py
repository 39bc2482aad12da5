"""From-scratch ORC reader + writer feeding device-ready numpy columns.

Reference: ``lib/trino-orc`` (``orc/OrcReader.java:66,251`` tail/footer
parsing, ``OrcRecordReader.java:376`` stripe iteration,
``TupleDomainOrcPredicate.java:74`` stats pruning) — reimplemented from
the public ORC v1 specification, not translated: the hot decoders
(RLEv1/RLEv2, bit-unpack, byte-RLE) vectorize into numpy and the column
assembly produces the engine's null-mask/dictionary columnar layout
directly.

Format essentials (ORC spec):
- file tail: ...stripes | metadata | footer | postscript | ps_length(1B)
- protobuf messages throughout (hand-rolled tag/varint parser below)
- every compressed region is framed in chunks with a 3-byte header
  ``(length << 1) | is_original`` (little-endian)
- integers use RLEv1 (runs + literals of varints) or RLEv2 (SHORT_REPEAT
  / DIRECT / PATCHED_BASE / DELTA sub-encodings, bit-packed)
- nulls ride PRESENT streams (bit-per-value, byte-RLE framed)
- strings are DIRECT (bytes + lengths) or DICTIONARY (codes + dict)

A copy of ``trino_tpu/formats/orc.py``: the columns decode into NumPy
and enter the engine as host tensors (``columnar.host_column``). Verified
against the reference and pyarrow in both directions
(tests/test_torch_formats.py): none/zlib/snappy compression, all engine
scalar types (wide DECIMAL(38) included), null patterns, multi-stripe
files and stripe statistics.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, Dictionary, host_column

# --- minimal protobuf ------------------------------------------------------


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _proto(buf: bytes) -> dict[int, list]:
    """Parse one protobuf message into {field: [values]}; length-delimited
    values stay bytes, varints stay ints."""
    out: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _varint(buf, pos)
        elif wire == 1:
            v = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            v = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            v = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def _first(msg: dict, field: int, default=None):
    vals = msg.get(field)
    return vals[0] if vals else default


def _uints(msg: dict, field: int) -> list[int]:
    """Repeated uint field: entries may be plain varints or PACKED bytes."""
    out: list[int] = []
    for v in msg.get(field, []):
        if isinstance(v, int):
            out.append(v)
        else:
            pos = 0
            while pos < len(v):
                u, pos = _varint(v, pos)
                out.append(u)
    return out


def _zigzag_int(u: int) -> int:
    """Zigzag-decode one unsigned Python int (exact for any u < 2**64)."""
    return (u >> 1) ^ -(u & 1)


def _zigzag_u64(u: np.ndarray) -> np.ndarray:
    """Zigzag-decode a uint64 array into int64 (bit-exact: the xor runs in
    unsigned space; going through int64 first would overflow for values
    >= 2**63 and arithmetic-shift already-negative lanes)."""
    one = np.uint64(1)
    return ((u >> one) ^ (np.uint64(0) - (u & one))).view(np.int64)


# --- compression framing ---------------------------------------------------

COMPRESSION_NONE = 0
COMPRESSION_ZLIB = 1
COMPRESSION_SNAPPY = 2
COMPRESSION_ZSTD = 5


def _decompress(data: bytes, kind: int) -> bytes:
    if kind == COMPRESSION_NONE:
        return data
    out = bytearray()
    pos = 0
    while pos + 3 <= len(data):
        header = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
        pos += 3
        length = header >> 1
        original = header & 1
        chunk = data[pos : pos + length]
        pos += length
        if original:
            out.extend(chunk)
        elif kind == COMPRESSION_ZLIB:
            out.extend(zlib.decompress(chunk, -15))  # raw deflate
        elif kind == COMPRESSION_SNAPPY:
            from trino_tpu_torch.native import snappy_decompress

            # snappy block: leading varint = uncompressed length
            ulen, p = _varint(chunk, 0)
            out.extend(snappy_decompress(chunk, ulen))
        elif kind == COMPRESSION_ZSTD:
            raise ValueError("zstd-compressed ORC is not supported")
        else:
            raise ValueError(f"unknown ORC compression kind {kind}")
    return bytes(out)


# --- integer decoders ------------------------------------------------------


def _read_varints(buf: bytes, count: int, pos: int = 0):
    out = np.empty(count, dtype=np.uint64)
    for i in range(count):
        v, pos = _varint(buf, pos)
        out[i] = v & 0xFFFFFFFFFFFFFFFF
    return out, pos


def _rle_v1(buf: bytes, count: int, signed: bool) -> np.ndarray:
    from trino_tpu_torch import native

    fast = native.orc_rle1(buf, count, signed)
    if fast is not None:
        return fast
    out = np.empty(count, dtype=np.int64)
    pos = 0
    filled = 0
    while filled < count:
        ctrl = buf[pos]
        pos += 1
        if ctrl < 128:  # run
            run = ctrl + 3
            delta = buf[pos]
            delta = delta - 256 if delta >= 128 else delta
            pos += 1
            base, pos = _varint(buf, pos)
            base = _zigzag_int(base) if signed else base
            out[filled : filled + run] = base + delta * np.arange(run)
            filled += run
        else:  # literals
            lit = 256 - ctrl
            vals, pos = _read_varints(buf, lit, pos)
            v = _zigzag_u64(vals) if signed else vals.astype(np.int64)
            out[filled : filled + lit] = v
            filled += lit
    return out


_RLE2_WIDTHS = [
    1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64,
    72, 80, 88, 96, 104, 112, 120, 128,
]  # 5-bit code -> bits (codes 0..4 are 1,2,4,8,16? spec: deprecated map)


def _fbw(code: int) -> int:
    """Decode the 5-bit "fixed bit width" code (ORC spec table)."""
    if code <= 23:
        return code + 1
    return {24: 26, 25: 28, 26: 30, 27: 32, 28: 40, 29: 48, 30: 56, 31: 64}[code]


_FIXED_WIDTHS = list(range(1, 25)) + [26, 28, 30, 32, 40, 48, 56, 64]


def _closest_fixed_bits(n: int) -> int:
    """Round up to the nearest encodable width (patch entries pack at
    closestFixedBits(gapWidth + patchWidth))."""
    for w in _FIXED_WIDTHS:
        if w >= n:
            return w
    return 64


def _unpack_bits(buf: bytes, count: int, width: int, pos: int):
    """Big-endian bit-unpack `count` values of `width` bits."""
    nbits = count * width
    nbytes = (nbits + 7) // 8
    raw = np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=pos)
    bits = np.unpackbits(raw)[: count * width].reshape(count, width)
    weights = (1 << np.arange(width - 1, -1, -1, dtype=np.uint64))
    vals = (bits.astype(np.uint64) * weights).sum(axis=1)
    return vals, pos + nbytes


def _rle_v2(buf: bytes, count: int, signed: bool) -> np.ndarray:
    from trino_tpu_torch import native

    fast = native.orc_rle2(buf, count, signed)
    if fast is not None:
        return fast
    out = np.empty(count, dtype=np.int64)
    pos = 0
    filled = 0
    while filled < count:
        first = buf[pos]
        enc = first >> 6
        if enc == 0:  # SHORT_REPEAT
            width = ((first >> 3) & 0x7) + 1
            repeat = (first & 0x7) + 3
            pos += 1
            val = int.from_bytes(buf[pos : pos + width], "big")
            pos += width
            if signed:
                val = _zigzag_int(val)
            out[filled : filled + repeat] = val
            filled += repeat
        elif enc == 1:  # DIRECT
            width = _fbw((first >> 1) & 0x1F)
            length = ((first & 1) << 8 | buf[pos + 1]) + 1
            pos += 2
            vals, pos = _unpack_bits(buf, length, width, pos)
            v = _zigzag_u64(vals.astype(np.uint64)) if signed else vals.astype(np.int64)
            out[filled : filled + length] = v
            filled += length
        elif enc == 3:  # DELTA
            width_code = (first >> 1) & 0x1F
            width = 0 if width_code == 0 else _fbw(width_code)
            length = ((first & 1) << 8 | buf[pos + 1]) + 1
            pos += 2
            base, pos = _varint(buf, pos)
            base = _zigzag_int(base) if signed else base
            delta0, pos = _varint(buf, pos)
            delta0 = _zigzag_int(delta0)
            seq = np.empty(length, dtype=np.int64)
            seq[0] = base
            if length > 1:
                if width == 0:
                    deltas = np.full(length - 1, delta0, dtype=np.int64)
                else:
                    rest, pos = _unpack_bits(buf, length - 2, width, pos)
                    deltas = np.empty(length - 1, dtype=np.int64)
                    deltas[0] = delta0
                    sign = 1 if delta0 >= 0 else -1
                    deltas[1:] = sign * rest.astype(np.int64)
                seq[1:] = base + np.cumsum(deltas)
            out[filled : filled + length] = seq
            filled += length
        else:  # PATCHED_BASE
            width = _fbw((first >> 1) & 0x1F)
            length = ((first & 1) << 8 | buf[pos + 1]) + 1
            third, fourth = buf[pos + 2], buf[pos + 3]
            base_width = ((third >> 5) & 0x7) + 1
            patch_width = _fbw(third & 0x1F)
            patch_gap_width = ((fourth >> 5) & 0x7) + 1
            patch_count = fourth & 0x1F
            pos += 4
            base_raw = int.from_bytes(buf[pos : pos + base_width], "big")
            pos += base_width
            msb = 1 << (base_width * 8 - 1)
            base = -(base_raw & ~msb) if base_raw & msb else base_raw
            vals, pos = _unpack_bits(buf, length, width, pos)
            patch_bits = _closest_fixed_bits(patch_width + patch_gap_width)
            patches, pos = _unpack_bits(buf, patch_count, patch_bits, pos)
            vals = vals.astype(np.int64)
            idx = 0
            for p in patches:
                gap = int(p) >> patch_width
                patch = int(p) & ((1 << patch_width) - 1)
                idx += gap
                vals[idx] |= patch << width
            out[filled : filled + length] = base + vals
            filled += length
    return out


def _byte_rle(buf: bytes, count: int) -> np.ndarray:
    from trino_tpu_torch import native

    fast = native.orc_byte_rle(buf, count)
    if fast is not None:
        return fast
    out = np.empty(count, dtype=np.uint8)
    pos = 0
    filled = 0
    while filled < count:
        ctrl = buf[pos]
        pos += 1
        if ctrl < 128:
            run = ctrl + 3
            out[filled : filled + run] = buf[pos]
            pos += 1
            filled += run
        else:
            lit = 256 - ctrl
            out[filled : filled + lit] = np.frombuffer(
                buf, dtype=np.uint8, count=lit, offset=pos
            )
            pos += lit
            filled += lit
    return out


def _bool_rle(buf: bytes, count: int) -> np.ndarray:
    nbytes = (count + 7) // 8
    b = _byte_rle(buf, nbytes)
    return np.unpackbits(b)[:count].astype(bool)


def _decimal_varints_wide(
    buf: bytes, count: int, target_scale: int, scales: np.ndarray
) -> np.ndarray:
    """Decimal DATA for precision > 18: unbounded zigzag varints decoded in
    Python ints, rescaled to the declared scale, split into (hi, lo)
    two's-complement int64 lanes (the engine's wide storage)."""
    from trino_tpu_torch.ops.decimal128 import int_to_pair

    out = np.empty((count, 2), dtype=np.int64)
    pos = 0
    for i in range(count):
        u, pos = _varint(buf, pos)
        v = (u >> 1) ^ -(u & 1)
        diff = target_scale - int(scales[i])
        if diff > 0:
            v *= 10**diff
        elif diff < 0:
            v //= 10**-diff
        hi, lo = int_to_pair(v)
        out[i, 0] = hi
        out[i, 1] = lo
    return out


def _decimal_varints(buf: bytes, count: int) -> np.ndarray:
    """Decimal DATA: unbounded zigzag varints (values beyond int64 raise —
    wide decimal ORC columns arrive via the (hi, lo) path)."""
    from trino_tpu_torch import native

    fast = native.orc_decimal64(buf, count)
    if fast is not None:
        return fast
    out = np.empty(count, dtype=np.int64)
    pos = 0
    for i in range(count):
        v, pos = _varint(buf, pos)
        out[i] = _zigzag_int(v & 0xFFFFFFFFFFFFFFFF)
    return out


# --- schema ---------------------------------------------------------------

KIND_BOOLEAN = 0
KIND_BYTE = 1
KIND_SHORT = 2
KIND_INT = 3
KIND_LONG = 4
KIND_FLOAT = 5
KIND_DOUBLE = 6
KIND_STRING = 7
KIND_BINARY = 8
KIND_TIMESTAMP = 9
KIND_LIST = 10
KIND_MAP = 11
KIND_STRUCT = 12
KIND_UNION = 13
KIND_DECIMAL = 14
KIND_DATE = 15
KIND_VARCHAR = 16
KIND_CHAR = 17

STREAM_PRESENT = 0
STREAM_DATA = 1
STREAM_LENGTH = 2
STREAM_DICTIONARY_DATA = 3
STREAM_SECONDARY = 5
STREAM_ROW_INDEX = 6

ENC_DIRECT = 0
ENC_DICTIONARY = 1
ENC_DIRECT_V2 = 2
ENC_DICTIONARY_V2 = 3


@dataclasses.dataclass
class OrcType:
    kind: int
    subtypes: list[int]
    field_names: list[str]
    precision: int = 0
    scale: int = 0

    def sql_type(self):
        if self.kind in (KIND_BOOLEAN,):
            return T.BOOLEAN
        if self.kind in (KIND_BYTE, KIND_SHORT, KIND_INT, KIND_LONG):
            return T.BIGINT
        if self.kind in (KIND_FLOAT, KIND_DOUBLE):
            return T.DOUBLE
        if self.kind in (KIND_STRING, KIND_VARCHAR, KIND_CHAR):
            return T.VARCHAR
        if self.kind == KIND_DATE:
            return T.DATE
        if self.kind == KIND_DECIMAL:
            return T.decimal(self.precision or 38, self.scale)
        raise ValueError(f"unsupported ORC type kind {self.kind}")


@dataclasses.dataclass
class StripeInfo:
    offset: int
    index_length: int
    data_length: int
    footer_length: int
    num_rows: int


@dataclasses.dataclass
class ColumnStats:
    num_values: Optional[int]
    has_null: bool
    min_value: Optional[object]
    max_value: Optional[object]


class OrcFile:
    """Parsed tail + stripe directory of one ORC file."""

    MAGIC = b"ORC"

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 16:
            raise ValueError("not an ORC file (too short)")
        ps_len = data[-1]
        ps = _proto(data[-1 - ps_len : -1])
        self.compression = _first(ps, 2, 0)
        footer_len = _first(ps, 1, 0)
        meta_len = _first(ps, 5, 0)
        magic = _first(ps, 8000, b"")
        if magic != self.MAGIC and not data.startswith(self.MAGIC):
            raise ValueError("not an ORC file (missing magic)")
        tail = len(data) - 1 - ps_len
        footer = _proto(_decompress(data[tail - footer_len : tail], self.compression))
        meta_buf = data[tail - footer_len - meta_len : tail - footer_len]
        self.metadata = (
            _proto(_decompress(meta_buf, self.compression)) if meta_len else {}
        )
        self.num_rows = _first(footer, 6, 0)
        self.types: list[OrcType] = []
        for tbytes in footer.get(4, []):
            m = _proto(tbytes)
            self.types.append(
                OrcType(
                    kind=_first(m, 1, 0),
                    subtypes=_uints(m, 2),
                    field_names=[v.decode() for v in m.get(3, [])],
                    precision=_first(m, 5, 0),
                    scale=_first(m, 6, 0),
                )
            )
        self.stripes: list[StripeInfo] = []
        for sbytes in footer.get(3, []):
            m = _proto(sbytes)
            self.stripes.append(
                StripeInfo(
                    offset=_first(m, 1, 0),
                    index_length=_first(m, 2, 0),
                    data_length=_first(m, 3, 0),
                    footer_length=_first(m, 4, 0),
                    num_rows=_first(m, 5, 0),
                )
            )
        # column order: root struct's children
        root = self.types[0]
        if root.kind != KIND_STRUCT:
            raise ValueError("ORC root type must be a struct")
        self.column_names = root.field_names
        self.column_type_ids = root.subtypes

    # --- statistics ------------------------------------------------------

    def stripe_stats(self, stripe_index: int) -> dict[int, ColumnStats]:
        """Per-type-id stats for one stripe (Metadata.stripeStats)."""
        entries = self.metadata.get(1, [])
        if stripe_index >= len(entries):
            return {}
        per_col = _proto(entries[stripe_index]).get(1, [])
        out = {}
        for type_id, cbytes in enumerate(per_col):
            out[type_id] = _parse_col_stats(
                cbytes, self.types[type_id] if type_id < len(self.types) else None
            )
        return out

    # --- stripe reading --------------------------------------------------

    def read_stripe(
        self, stripe: StripeInfo, want: Optional[set[str]] = None
    ) -> dict[str, Column]:
        sf_off = stripe.offset + stripe.index_length + stripe.data_length
        sfooter = _proto(
            _decompress(
                self.data[sf_off : sf_off + stripe.footer_length],
                self.compression,
            )
        )
        streams = []
        pos = stripe.offset
        for sbytes in sfooter.get(1, []):
            m = _proto(sbytes)
            kind = _first(m, 1, 0)
            column = _first(m, 2, 0)
            length = _first(m, 3, 0)
            streams.append((kind, column, pos, length))
            pos += length
        encodings = [
            (_first(_proto(e), 1, 0), _first(_proto(e), 2, 0))
            for e in sfooter.get(2, [])
        ]

        def stream(col_id: int, kind: int) -> Optional[bytes]:
            for k, c, off, ln in streams:
                if c == col_id and k == kind:
                    return _decompress(
                        self.data[off : off + ln], self.compression
                    )
            return None

        out: dict[str, Column] = {}
        for name, type_id in zip(self.column_names, self.column_type_ids):
            if want is not None and name not in want:
                continue
            out[name] = self._read_column(
                type_id, stripe.num_rows, stream, encodings
            )
        return out

    def _read_column(self, type_id, num_rows, stream, encodings) -> Column:
        t = self.types[type_id]
        enc = encodings[type_id][0] if type_id < len(encodings) else ENC_DIRECT
        present = stream(type_id, STREAM_PRESENT)
        if present is not None:
            valid = _bool_rle(present, num_rows)
            n_present = int(valid.sum())
        else:
            valid = None
            n_present = num_rows

        def expand(vals: np.ndarray, fill=0) -> np.ndarray:
            if valid is None:
                return vals
            out = np.full(num_rows, fill, dtype=vals.dtype)
            out[valid] = vals
            return out

        data = stream(type_id, STREAM_DATA)
        v2 = enc in (ENC_DIRECT_V2, ENC_DICTIONARY_V2)
        rle = _rle_v2 if v2 else _rle_v1

        if t.kind in (KIND_SHORT, KIND_INT, KIND_LONG):
            vals = rle(data, n_present, signed=True)
            return host_column(T.BIGINT, expand(vals), valid)
        if t.kind == KIND_DATE:
            vals = rle(data, n_present, signed=True)
            return host_column(T.DATE, expand(vals).astype(np.int32), valid)
        if t.kind == KIND_BYTE:
            vals = _byte_rle(data, n_present).astype(np.int8).astype(np.int64)
            return host_column(T.BIGINT, expand(vals), valid)
        if t.kind == KIND_BOOLEAN:
            vals = _bool_rle(data, n_present)
            return host_column(T.BOOLEAN, expand(vals), valid)
        if t.kind in (KIND_FLOAT, KIND_DOUBLE):
            width = 4 if t.kind == KIND_FLOAT else 8
            dt = np.float32 if t.kind == KIND_FLOAT else np.float64
            vals = np.frombuffer(data, dtype=np.dtype(dt).newbyteorder("<"),
                                 count=n_present).astype(np.float64)
            return host_column(T.DOUBLE, expand(vals), valid)
        if t.kind == KIND_DECIMAL:
            secondary = stream(type_id, STREAM_SECONDARY)
            scales = rle(secondary, n_present, signed=True)
            target = t.scale
            if (t.precision or 38) > 18:
                # wide path: unbounded varints -> (hi, lo) int64 lanes
                pairs = _decimal_varints_wide(data, n_present, target, scales)
                if valid is None:
                    return host_column(t.sql_type(), pairs, None)
                out_pairs = np.zeros((num_rows, 2), dtype=np.int64)
                out_pairs[valid] = pairs
                return host_column(t.sql_type(), out_pairs, valid)
            vals = _decimal_varints(data, n_present)
            diff = target - scales
            # normalize to declared scale (writers emit per-value scales)
            vals = np.where(
                diff >= 0,
                vals * (10 ** np.clip(diff, 0, None)),
                vals // (10 ** np.clip(-diff, 0, None)),
            )
            return host_column(t.sql_type(), expand(vals), valid)
        if t.kind in (KIND_STRING, KIND_VARCHAR, KIND_CHAR):
            if enc in (ENC_DICTIONARY, ENC_DICTIONARY_V2):
                codes = rle(data, n_present, signed=False)
                dict_data = stream(type_id, STREAM_DICTIONARY_DATA) or b""
                lengths = rle(
                    stream(type_id, STREAM_LENGTH), encodings[type_id][1],
                    signed=False,
                )
                offs = np.concatenate([[0], np.cumsum(lengths)])
                values = [
                    dict_data[offs[i] : offs[i + 1]].decode("utf-8")
                    for i in range(len(lengths))
                ]
                d = Dictionary(values)
                out_codes = expand(codes.astype(np.int32), fill=-1)
                return host_column(T.VARCHAR, out_codes, valid, d)
            lengths = rle(stream(type_id, STREAM_LENGTH), n_present, signed=False)
            offs = np.concatenate([[0], np.cumsum(lengths)])
            strings = [
                data[offs[i] : offs[i + 1]].decode("utf-8")
                for i in range(n_present)
            ]
            d, codes = Dictionary.from_strings(strings)
            return host_column(T.VARCHAR, expand(codes, fill=-1), valid, d)
        raise ValueError(f"unsupported ORC column kind {t.kind}")


def _parse_col_stats(cbytes: bytes, t: Optional[OrcType]) -> ColumnStats:
    m = _proto(cbytes)
    num = _first(m, 1)
    has_null = bool(_first(m, 10, 0))
    mn = mx = None
    if 2 in m:  # integers
        s = _proto(m[2][0])
        mn = _signed_varint(_first(s, 1))
        mx = _signed_varint(_first(s, 2))
    elif 7 in m:  # date
        s = _proto(m[7][0])
        mn = _signed_varint(_first(s, 1))
        mx = _signed_varint(_first(s, 2))
    elif 4 in m:  # string
        s = _proto(m[4][0])
        mn = _first(s, 1)
        mx = _first(s, 2)
        mn = mn.decode() if mn is not None else None
        mx = mx.decode() if mx is not None else None
    elif 3 in m:  # double
        s = _proto(m[3][0])
        mn = _f64(_first(s, 1))
        mx = _f64(_first(s, 2))
    elif 6 in m:  # decimal (strings)
        s = _proto(m[6][0])
        mn = _first(s, 1)
        mx = _first(s, 2)
        mn = mn.decode() if mn is not None else None
        mx = mx.decode() if mx is not None else None
    return ColumnStats(num, has_null, mn, mx)


def _signed_varint(v):
    """sint64 fields arrive zigzag-encoded by protobuf."""
    if v is None:
        return None
    return _zigzag_int(v & 0xFFFFFFFFFFFFFFFF)


def _f64(v):
    if v is None:
        return None
    return float(np.frombuffer(v, dtype="<f8")[0])


def read_orc(path: str, columns: Optional[list[str]] = None) -> Batch:
    """Read a whole ORC file into one Batch (column subset optional)."""
    from trino_tpu_torch.columnar import concat_batches

    with open(path, "rb") as f:
        data = f.read()
    f = OrcFile(data)
    want = set(columns) if columns is not None else None
    names = [
        n for n in f.column_names if want is None or n in want
    ]
    batches = []
    for stripe in f.stripes:
        cols = f.read_stripe(stripe, want)
        batches.append(
            Batch([cols[n] for n in names], stripe.num_rows)
        )
    if not batches:
        return Batch([], 0)
    return concat_batches(batches) if len(batches) > 1 else batches[0]

# ===========================================================================
# Writer
# ===========================================================================
#
# Mirrors the reader above from the other side of the ORC v1 spec
# (reference: ``lib/trino-orc/src/main/java/io/trino/orc/OrcWriter.java``,
# stream layout ``OrcWriter.java`` bufferStripeData / writeStripe — rebuilt
# from the public specification, not translated). One stripe per input
# batch; integer/date/decimal-scale streams use RLEv2 (SHORT_REPEAT for
# short constant runs, DELTA for long ones, DIRECT for everything else),
# strings use sorted DICTIONARY_V2, decimals use unbounded zigzag varints
# (wide (hi, lo) columns included), nulls ride byte-RLE PRESENT bitmaps.
# File- and stripe-level column statistics are emitted so our own
# stripe-stats pruning works on files we wrote.


class _PW:
    """Protobuf writer (mirror of _proto above)."""

    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int):
        """64-bit varint (field tags, lengths, counts)."""
        v &= 0xFFFFFFFFFFFFFFFF
        self.varint_unbounded(v)

    def varint_unbounded(self, v: int):
        """Unbounded varint (ORC decimal unscaled values exceed 64 bits)."""
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def uint(self, field: int, v: int):
        self.varint((field << 3) | 0)
        self.varint(v)

    def sint(self, field: int, v: int):
        self.uint(field, (v << 1) ^ (v >> 63) if v >= -(1 << 63) else (v << 1) ^ -1)

    def f64(self, field: int, x: float):
        import struct as _s

        self.varint((field << 3) | 1)
        self.out += _s.pack("<d", x)

    def bytes_(self, field: int, b: bytes):
        self.varint((field << 3) | 2)
        self.varint(len(b))
        self.out += b

    def msg(self, field: int, pw: "_PW"):
        self.bytes_(field, bytes(pw.out))


def _zigzag_encode_np(v: np.ndarray) -> np.ndarray:
    """int64 -> zigzag uint64 (unsigned space, exact)."""
    u = v.astype(np.int64).view(np.uint64)
    one = np.uint64(1)
    return (u << one) ^ (np.uint64(0) - (u >> np.uint64(63)))


def _varints_bytes(u: np.ndarray) -> bytes:
    """Encode a uint64 array as concatenated LEB128 varints (vectorized)."""
    from trino_tpu_torch import native

    fast = native.orc_varint_encode(u)
    if fast is not None:
        return fast
    out = bytearray()
    for x in u.tolist():
        x &= 0xFFFFFFFFFFFFFFFF
        while True:
            b = x & 0x7F
            x >>= 7
            if x:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


_WIDTH_CODES = {w: (w - 1) for w in range(1, 25)}
_WIDTH_CODES.update({26: 24, 28: 25, 30: 26, 32: 27, 40: 28, 48: 29, 56: 30, 64: 31})


def _pack_bits_be(u: np.ndarray, width: int) -> bytes:
    """Big-endian bitpack of uint64 values at `width` bits each."""
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    bits = ((u[:, None] >> shifts) & np.uint64(1)).astype(np.uint8).reshape(-1)
    return np.packbits(bits).tobytes()


def _emit_direct(out: bytearray, u: np.ndarray):
    """One DIRECT chunk (<=512 zigzagged/unsigned values)."""
    maxv = int(u.max()) if u.size else 0
    width = _closest_fixed_bits(max(maxv.bit_length(), 1))
    code = _WIDTH_CODES[width]
    ln = len(u) - 1
    out.append(0x40 | (code << 1) | (ln >> 8))
    out.append(ln & 0xFF)
    out += _pack_bits_be(u, width)


def _emit_constant_run(out: bytearray, value: int, run: int, signed: bool):
    """Constant run as SHORT_REPEAT (3..10) or DELTA with delta 0 (<=512)."""
    uval = ((value << 1) ^ (value >> 63)) & 0xFFFFFFFFFFFFFFFF if signed else value
    while run > 0:
        if 3 <= run <= 10:
            width = max((uval.bit_length() + 7) // 8, 1)
            out.append(((width - 1) << 3) | (run - 3))
            out += uval.to_bytes(width, "big")
            return
        take = min(run, 512)
        if take < 3:  # trailing 1-2 values: emit as DIRECT
            _emit_direct(out, np.full(take, uval, dtype=np.uint64))
            return
        ln = take - 1
        out.append(0xC0 | (ln >> 8))  # DELTA, width code 0
        out.append(ln & 0xFF)
        pw = _PW()
        if signed:
            pw.varint(((value << 1) ^ (value >> 63)) & 0xFFFFFFFFFFFFFFFF)
        else:
            pw.varint(value)
        pw.varint(0)  # delta0 = 0 (zigzag of 0)
        out += pw.out
        run -= take


def _rle_v2_encode(vals: np.ndarray, signed: bool) -> bytes:
    """RLEv2 encode int64 values (greedy runs + DIRECT literals)."""
    v = np.asarray(vals, dtype=np.int64)
    n = len(v)
    if n == 0:
        return b""
    from trino_tpu_torch import native

    fast = native.orc_rle2_encode(v, signed)
    if fast is not None:
        return fast
    u = _zigzag_encode_np(v) if signed else v.view(np.uint64)
    # maximal equal-value runs
    starts = np.concatenate([[0], np.flatnonzero(np.diff(v) != 0) + 1])
    lens = np.diff(np.concatenate([starts, [n]]))
    big = np.flatnonzero(lens >= 6)  # runs worth a run-encoding
    out = bytearray()
    pos = 0
    for ri in big:
        s, ln = int(starts[ri]), int(lens[ri])
        for c0 in range(pos, s, 512):  # flush literals before the run
            _emit_direct(out, u[c0 : min(c0 + 512, s)])
        _emit_constant_run(out, int(v[s]), ln, signed)
        pos = s + ln
    for c0 in range(pos, n, 512):
        _emit_direct(out, u[c0 : min(c0 + 512, n)])
    return bytes(out)


def _byte_rle_encode(b: np.ndarray) -> bytes:
    """Byte-RLE encode (runs of 3..130, literals of 1..128)."""
    b = np.asarray(b, dtype=np.uint8)
    n = len(b)
    if n == 0:
        return b""
    from trino_tpu_torch import native

    fast = native.orc_byte_rle_encode(b)
    if fast is not None:
        return fast
    starts = np.concatenate([[0], np.flatnonzero(np.diff(b) != 0) + 1])
    lens = np.diff(np.concatenate([starts, [n]]))
    out = bytearray()
    lit_start = 0

    def flush_literals(upto: int):
        nonlocal lit_start
        p = lit_start
        while p < upto:
            take = min(128, upto - p)
            out.append(256 - take)
            out.extend(b[p : p + take].tobytes())
            p += take
        lit_start = upto

    for s, ln in zip(starts.tolist(), lens.tolist()):
        if ln >= 3:
            flush_literals(s)
            rem = ln
            while rem > 0:
                take = min(rem, 130)
                if rem - take in (1, 2):
                    take -= 3 - (rem - take)  # leave >=3 (or 0) for next pass
                out.append(take - 3)
                out.append(int(b[s]))
                rem -= take
            lit_start = s + ln
    flush_literals(n)
    return bytes(out)


def _bool_rle_encode(mask: np.ndarray) -> bytes:
    packed = np.packbits(np.asarray(mask, dtype=np.uint8))  # big-endian bits
    return _byte_rle_encode(packed)


def _compress_stream(data: bytes, kind: int, block: int = 262144) -> bytes:
    if kind == COMPRESSION_NONE:
        return data
    out = bytearray()
    for p in range(0, len(data), block) or [0]:
        chunk = data[p : p + block]
        if kind == COMPRESSION_ZLIB:
            comp = zlib.compress(chunk, 6)[2:-4]  # raw deflate
        elif kind == COMPRESSION_SNAPPY:
            from trino_tpu_torch.native import snappy_compress

            pw = _PW()
            pw.varint(len(chunk))
            comp = bytes(pw.out) + snappy_compress(chunk)
        else:
            raise ValueError(f"unsupported ORC write compression {kind}")
        if len(comp) >= len(chunk):
            header = (len(chunk) << 1) | 1
            out += header.to_bytes(3, "little")
            out += chunk
        else:
            header = len(comp) << 1
            out += header.to_bytes(3, "little")
            out += comp
    if not data:
        return b""
    return bytes(out)


def _orc_kind(t: T.SqlType) -> int:
    if isinstance(t, T.BooleanType):
        return KIND_BOOLEAN
    if isinstance(t, T.IntegerLikeType):
        return KIND_INT if t.bits == 32 else KIND_LONG
    if isinstance(t, T.RealType):
        return KIND_FLOAT
    if isinstance(t, T.DoubleType):
        return KIND_DOUBLE
    if T.is_string(t):
        return KIND_STRING
    if isinstance(t, T.DateType):
        return KIND_DATE
    if isinstance(t, T.DecimalType):
        return KIND_DECIMAL
    raise ValueError(f"cannot write type {t} to ORC")


class _ColStats:
    """Accumulates numberOfValues/hasNull/min/max for one column."""

    def __init__(self, t: T.SqlType):
        self.t = t
        self.n = 0
        self.has_null = False
        self.mn = None
        self.mx = None

    def update(self, mn, mx, count, has_null):
        self.n += count
        self.has_null |= has_null
        if mn is not None and (self.mn is None or mn < self.mn):
            self.mn = mn
        if mx is not None and (self.mx is None or mx > self.mx):
            self.mx = mx

    def proto(self) -> "_PW":
        pw = _PW()
        pw.uint(1, self.n)
        t, mn, mx = self.t, self.mn, self.mx
        if mn is not None:
            sub = _PW()
            if isinstance(t, T.IntegerLikeType):
                sub.sint(1, int(mn))
                sub.sint(2, int(mx))
                pw.msg(2, sub)
            elif isinstance(t, (T.DoubleType, T.RealType)):
                sub.f64(1, float(mn))
                sub.f64(2, float(mx))
                pw.msg(3, sub)
            elif T.is_string(t):
                sub.bytes_(1, mn.encode("utf-8"))
                sub.bytes_(2, mx.encode("utf-8"))
                pw.msg(4, sub)
            elif isinstance(t, T.DecimalType):
                from decimal import Decimal

                q = Decimal(1).scaleb(-t.scale)
                sub.bytes_(1, str(Decimal(int(mn)).scaleb(-t.scale).quantize(q)).encode())
                sub.bytes_(2, str(Decimal(int(mx)).scaleb(-t.scale).quantize(q)).encode())
                pw.msg(6, sub)
            elif isinstance(t, T.DateType):
                sub.sint(1, int(mn))
                sub.sint(2, int(mx))
                pw.msg(7, sub)
        if self.has_null:
            pw.uint(10, 1)
        return pw


def _encode_column(
    col: Column, kind: int, compression: int
) -> tuple[list[tuple[int, bytes]], tuple[int, int], tuple, int]:
    """Encode one column -> ([(stream_kind, bytes)], (encoding, dict_size),
    (min, max, count, has_null), n_present)."""
    t = col.type
    data, valid = col.to_numpy()
    all_valid = bool(valid.all())
    streams: list[tuple[int, bytes]] = []
    if not all_valid:
        streams.append((STREAM_PRESENT, _bool_rle_encode(valid)))
    enc = (ENC_DIRECT_V2, 0)
    mn = mx = None
    has_null = not all_valid

    if T.is_string(t):
        # gather present strings, sort a dictionary, remap codes
        # sorted dictionary of the present strings, codes remapped onto it
        # (each dictionary value is decoded once)
        codes = data[valid]
        d = col.dictionary
        used, inverse = np.unique(codes, return_inverse=True)
        used_vals = [d.decode(int(c)) or "" for c in used]
        uniq = sorted(set(used_vals))
        index = {s: i for i, s in enumerate(uniq)}
        rank = np.asarray([index[v] for v in used_vals], dtype=np.int64)
        remapped = rank[inverse.reshape(-1)] if len(codes) else np.zeros(0, np.int64)
        present = uniq if len(codes) else []
        dict_bytes = b"".join(s.encode("utf-8") for s in uniq)
        lengths = np.asarray([len(s.encode("utf-8")) for s in uniq], dtype=np.int64)
        streams.append((STREAM_DATA, _rle_v2_encode(remapped, signed=False)))
        streams.append((STREAM_DICTIONARY_DATA, dict_bytes))
        streams.append((STREAM_LENGTH, _rle_v2_encode(lengths, signed=False)))
        enc = (ENC_DICTIONARY_V2, len(uniq))
        if present:
            mn, mx = min(present), max(present)
    elif isinstance(t, T.BooleanType):
        streams.append((STREAM_DATA, _bool_rle_encode(data[valid].astype(bool))))
        pv = data[valid]
        if pv.size:
            mn, mx = bool(pv.min()), bool(pv.max())
        enc = (ENC_DIRECT, 0)
    elif isinstance(t, (T.DoubleType, T.RealType)):
        pv = data[valid]
        if isinstance(t, T.RealType):
            streams.append((STREAM_DATA, pv.astype("<f4").tobytes()))
        else:
            streams.append((STREAM_DATA, pv.astype("<f8").tobytes()))
        finite = pv[~np.isnan(pv)] if pv.dtype.kind == "f" else pv
        if finite.size:
            mn, mx = float(finite.min()), float(finite.max())
        enc = (ENC_DIRECT, 0)
    elif isinstance(t, T.DecimalType):
        if data.ndim == 2:  # wide (hi, lo)
            from trino_tpu_torch.ops.decimal128 import pair_to_int

            ints = [pair_to_int(int(h), int(l)) for h, l in data[valid]]
            pw = _PW()
            for x in ints:
                pw.varint_unbounded((x << 1) ^ (x >> 127))  # zigzag, >64-bit
            dec_bytes = bytes(pw.out)
        else:
            pv = data[valid].astype(np.int64)
            ints = [int(x) for x in pv]
            dec_bytes = _varints_bytes(_zigzag_encode_np(pv))
        streams.append((STREAM_DATA, dec_bytes))
        scales = np.full(len(ints), t.scale, dtype=np.int64)
        streams.append((STREAM_SECONDARY, _rle_v2_encode(scales, signed=True)))
        if ints:
            mn, mx = min(ints), max(ints)
    elif isinstance(t, T.DateType) or isinstance(t, T.IntegerLikeType):
        pv = data[valid].astype(np.int64)
        streams.append((STREAM_DATA, _rle_v2_encode(pv, signed=True)))
        if pv.size:
            mn, mx = int(pv.min()), int(pv.max())
    else:
        raise ValueError(f"cannot write type {t} to ORC")

    n_present = int(valid.sum())
    streams = [(k, _compress_stream(b, compression)) for k, b in streams]
    return streams, enc, (mn, mx, n_present, has_null), n_present


def write_orc(
    f,
    names: list[str],
    batches: list["Batch"],
    compression: int = COMPRESSION_ZLIB,
) -> None:
    """Write batches as an ORC file: one stripe per batch.

    The inverse of :class:`OrcFile`; stream layout per the ORC v1 spec,
    verified against pyarrow's reader (tests/test_torch_formats.py)."""
    f.write(b"ORC")
    offset = 3
    col_types = [c.type for c in batches[0].columns] if batches else []
    kinds = [_orc_kind(t) for t in col_types]
    file_stats = [_ColStats(t) for t in col_types]
    root_stats_rows = 0
    stripe_infos: list[tuple[int, int, int, int, int]] = []
    stripe_stat_msgs: list[_PW] = []

    for batch in batches:
        batch = batch.compact()
        nrows = batch.num_rows
        root_stats_rows += nrows
        all_streams: list[tuple[int, int, bytes]] = []  # (kind, column_id, data)
        encodings: list[tuple[int, int]] = [(ENC_DIRECT, 0)]  # root
        per_col_stats: list[_ColStats] = []
        for ci, (col, kind) in enumerate(zip(batch.columns, kinds)):
            streams, enc, stat, _np_ = _encode_column(col, kind, compression)
            for sk, sb in streams:
                all_streams.append((sk, ci + 1, sb))
            encodings.append(enc)
            cs = _ColStats(col.type)
            cs.update(stat[0], stat[1], stat[2], stat[3])
            per_col_stats.append(cs)
            file_stats[ci].update(stat[0], stat[1], stat[2], stat[3])
        data_len = sum(len(sb) for _, _, sb in all_streams)
        # stripe footer
        sf = _PW()
        for sk, cid, sb in all_streams:
            sub = _PW()
            sub.uint(1, sk)
            sub.uint(2, cid)
            sub.uint(3, len(sb))
            sf.msg(1, sub)
        for ek, dsz in encodings:
            sub = _PW()
            sub.uint(1, ek)
            if dsz:
                sub.uint(2, dsz)
            sf.msg(2, sub)
        sf_bytes = _compress_stream(bytes(sf.out), compression)
        stripe_offset = offset
        for _, _, sb in all_streams:
            f.write(sb)
        f.write(sf_bytes)
        offset += data_len + len(sf_bytes)
        stripe_infos.append((stripe_offset, 0, data_len, len(sf_bytes), nrows))
        # stripe statistics entry (root column 0 + data columns)
        ss = _PW()
        root = _PW()
        root.uint(1, nrows)
        ss.msg(1, root)
        for cs in per_col_stats:
            ss.msg(1, cs.proto())
        stripe_stat_msgs.append(ss)

    # metadata (stripe stats)
    meta = _PW()
    for ss in stripe_stat_msgs:
        meta.msg(1, ss)
    meta_bytes = _compress_stream(bytes(meta.out), compression)

    # footer
    ft = _PW()
    ft.uint(1, 3)  # headerLength ("ORC")
    ft.uint(2, offset)  # contentLength
    for so, il, dl, fl, nr in stripe_infos:
        sub = _PW()
        sub.uint(1, so)
        sub.uint(2, il)
        sub.uint(3, dl)
        sub.uint(4, fl)
        sub.uint(5, nr)
        ft.msg(3, sub)
    root_t = _PW()
    root_t.uint(1, KIND_STRUCT)
    for i in range(len(names)):
        root_t.uint(2, i + 1)
    for nme in names:
        root_t.bytes_(3, nme.encode("utf-8"))
    ft.msg(4, root_t)
    for t, kind in zip(col_types, kinds):
        sub = _PW()
        sub.uint(1, kind)
        if isinstance(t, T.DecimalType):
            sub.uint(5, t.precision)
            sub.uint(6, t.scale)
        ft.msg(4, sub)
    ft.uint(6, root_stats_rows)
    # file-level column statistics (field 7): root then columns
    root_cs = _PW()
    root_cs.uint(1, root_stats_rows)
    ft.msg(7, root_cs)
    for cs in file_stats:
        ft.msg(7, cs.proto())
    ft.uint(8, 0)  # rowIndexStride = 0 (no row indexes)
    footer_bytes = _compress_stream(bytes(ft.out), compression)

    f.write(meta_bytes)
    f.write(footer_bytes)

    ps = _PW()
    ps.uint(1, len(footer_bytes))
    ps.uint(2, compression)
    if compression != COMPRESSION_NONE:
        ps.uint(3, 262144)
    ps.uint(4, 0)
    ps.uint(4, 12)
    ps.uint(5, len(meta_bytes))
    ps.uint(6, 1)  # writerVersion
    ps.bytes_(8000, b"ORC")
    ps_bytes = bytes(ps.out)
    f.write(ps_bytes)
    f.write(bytes([len(ps_bytes)]))
