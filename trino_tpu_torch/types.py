"""SQL type system mapped onto TPU-friendly storage dtypes.

Reference: ``core/trino-spi/src/main/java/io/trino/spi/type/`` (40+ types).
We cover the engine-relevant core: BOOLEAN, the integer ladder, REAL, DOUBLE,
DECIMAL(p,s), VARCHAR/CHAR, DATE, TIMESTAMP, plus UNKNOWN (the NULL type).

Storage design (TPU-first, not a port):
- Every type has a fixed-width device representation. Strings are
  dictionary-encoded int32 codes over a host-side dictionary (Trino's
  ``DictionaryBlock`` is an optimization; here it is the *primary* string
  representation since TPUs need fixed-width lanes).
- DECIMAL(p<=18,s) is an int64 scaled integer (exact arithmetic; reference
  semantics: ``spi/type/UnscaledDecimal128Arithmetic.java``). p>18 is
  unsupported in v1 (TPC-H/TPC-DS fit in 18 digits).
- DATE is int32 days since 1970-01-01; TIMESTAMP int64 microseconds.
"""

from __future__ import annotations

import dataclasses
from functools import total_ordering

import numpy as np


@dataclasses.dataclass(frozen=True)
class SqlType:
    """Base for all SQL types. Frozen + hashable so types are usable as keys."""

    name: str

    @property
    def storage_dtype(self) -> np.dtype:
        raise NotImplementedError

    def __str__(self) -> str:
        return self.name

    # display helpers -----------------------------------------------------
    def to_python(self, storage_value, dictionary=None):
        """Convert one storage scalar to a Python value for client output."""
        return storage_value


@dataclasses.dataclass(frozen=True)
class BooleanType(SqlType):
    name: str = "boolean"

    @property
    def storage_dtype(self):
        return np.dtype(np.bool_)

    def to_python(self, v, dictionary=None):
        return bool(v)


@dataclasses.dataclass(frozen=True)
class IntegerLikeType(SqlType):
    bits: int = 64

    @property
    def storage_dtype(self):
        return np.dtype({8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}[self.bits])

    def to_python(self, v, dictionary=None):
        return int(v)


@dataclasses.dataclass(frozen=True)
class RealType(SqlType):
    name: str = "real"

    @property
    def storage_dtype(self):
        return np.dtype(np.float32)

    def to_python(self, v, dictionary=None):
        return float(v)


@dataclasses.dataclass(frozen=True)
class DoubleType(SqlType):
    name: str = "double"

    @property
    def storage_dtype(self):
        return np.dtype(np.float64)

    def to_python(self, v, dictionary=None):
        return float(v)


@dataclasses.dataclass(frozen=True)
class DecimalType(SqlType):
    """DECIMAL(precision, scale) as a scaled integer.

    Storage: int64 for any precision whose *values* fit (narrow storage);
    columns whose values exceed int64 — SUM accumulations over big data —
    use *wide* storage: an (n, 2) int64 array of (hi, lo) two's-complement
    128-bit lanes (``trino_tpu.ops.decimal128``, reference semantics
    ``spi/type/UnscaledDecimal128Arithmetic.java``). ``p <= 38`` as in the
    reference; a column's representation is visible from its data shape.
    """

    precision: int = 18
    scale: int = 0
    name: str = ""

    def __post_init__(self):
        if self.precision > 38:
            raise NotImplementedError("DECIMAL precision > 38 is invalid")
        object.__setattr__(self, "name", f"decimal({self.precision},{self.scale})")

    @property
    def wide(self) -> bool:
        """True when values may exceed int64 (needs 128-bit lanes)."""
        return self.precision > 18

    @property
    def storage_dtype(self):
        return np.dtype(np.int64)

    @property
    def unscale(self) -> int:
        return 10**self.scale

    def to_python(self, v, dictionary=None):
        from decimal import Decimal

        if np.ndim(v) == 1:  # wide storage scalar: (hi, lo) lanes
            from trino_tpu_torch.ops.decimal128 import pair_to_int

            iv = pair_to_int(int(v[0]), int(v[1]))
        else:
            iv = int(v)
        return Decimal(iv) / (10**self.scale) if self.scale else Decimal(iv)


@dataclasses.dataclass(frozen=True)
class VarcharType(SqlType):
    """VARCHAR(n): dictionary-encoded int32 codes. n is advisory."""

    length: int | None = None
    name: str = ""

    def __post_init__(self):
        object.__setattr__(
            self, "name", "varchar" if self.length is None else f"varchar({self.length})"
        )

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)

    def to_python(self, v, dictionary=None):
        if dictionary is None:
            raise ValueError("varchar column without dictionary")
        return dictionary.decode(int(v))


@dataclasses.dataclass(frozen=True)
class CharType(SqlType):
    length: int = 1
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "name", f"char({self.length})")

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)

    def to_python(self, v, dictionary=None):
        if dictionary is None:
            raise ValueError("char column without dictionary")
        return dictionary.decode(int(v))


@dataclasses.dataclass(frozen=True)
class DateType(SqlType):
    name: str = "date"

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)

    def to_python(self, v, dictionary=None):
        import datetime

        return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))).isoformat()


@dataclasses.dataclass(frozen=True)
class TimestampType(SqlType):
    name: str = "timestamp"

    @property
    def storage_dtype(self):
        return np.dtype(np.int64)

    def to_python(self, v, dictionary=None):
        import datetime

        return (
            datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(v))
        ).isoformat(sep=" ")


@dataclasses.dataclass(frozen=True)
class ArrayType(SqlType):
    """ARRAY(element). TPU-first storage mirrors varchar: int32 codes into
    a host-side pool of distinct array VALUES (python tuples). Equality,
    grouping and joining work on codes; cardinality/element_at become
    per-code lookup tables; UNNEST expands host-side at the (inherently
    row-count-changing) operator boundary.
    Reference: ``spi/block/ArrayBlock.java`` (offsets + values block)."""

    element: SqlType = None  # type: ignore[assignment]
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "name", f"array({self.element})")

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)

    def to_python(self, v, dictionary=None):
        if dictionary is None:
            raise ValueError("array column without value pool")
        tup = dictionary.decode(int(v))
        if tup is None:
            return None
        return [
            None
            if e is None
            else (e if isinstance(e, str) else self.element.to_python(e, None))
            for e in tup
        ]


@dataclasses.dataclass(frozen=True)
class MapType(SqlType):
    """MAP(key, value). Pool-coded like ARRAY: int32 codes into a host
    pool of distinct map VALUES, each a tuple of (key, value) pairs in
    insertion order. Equality/grouping/joining work on codes.
    Reference: ``spi/block/MapBlock.java`` (offsets + key/value blocks)."""

    key: SqlType = None  # type: ignore[assignment]
    value: SqlType = None  # type: ignore[assignment]
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "name", f"map({self.key}, {self.value})")

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)

    def to_python(self, v, dictionary=None):
        if dictionary is None:
            raise ValueError("map column without value pool")
        pairs = dictionary.decode(int(v))
        if pairs is None:
            return None
        out = {}
        for k, val in pairs:
            kk = k if isinstance(k, str) else self.key.to_python(k, None)
            vv = (
                None
                if val is None
                else (val if isinstance(val, str) else self.value.to_python(val, None))
            )
            out[kk] = vv
        return out


@dataclasses.dataclass(frozen=True)
class RowType(SqlType):
    """ROW(f0, f1, ...). Pool-coded: int32 codes into a host pool of
    distinct row VALUES (tuples of field storage scalars).
    Reference: ``spi/block/RowBlock.java`` (parallel field blocks)."""

    fields: tuple = ()  # tuple[(name or None, SqlType), ...]
    name: str = ""

    def __post_init__(self):
        inner = ", ".join(
            f"{n} {t}" if n else str(t) for n, t in self.fields
        )
        object.__setattr__(self, "name", f"row({inner})")

    @property
    def storage_dtype(self):
        return np.dtype(np.int32)

    def to_python(self, v, dictionary=None):
        if dictionary is None:
            raise ValueError("row column without value pool")
        tup = dictionary.decode(int(v))
        if tup is None:
            return None
        out = []
        for (fname, ft), e in zip(self.fields, tup):
            out.append(
                None
                if e is None
                else (e if isinstance(e, str) else ft.to_python(e, None))
            )
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class UnknownType(SqlType):
    """The type of a bare NULL literal (reference: ``spi/type/UnknownType``)."""

    name: str = "unknown"

    @property
    def storage_dtype(self):
        return np.dtype(np.bool_)


BOOLEAN = BooleanType()
TINYINT = IntegerLikeType("tinyint", 8)
SMALLINT = IntegerLikeType("smallint", 16)
INTEGER = IntegerLikeType("integer", 32)
BIGINT = IntegerLikeType("bigint", 64)
REAL = RealType()
DOUBLE = DoubleType()
DATE = DateType()
TIMESTAMP = TimestampType()
UNKNOWN = UnknownType()
VARCHAR = VarcharType()


def decimal(precision: int, scale: int) -> DecimalType:
    return DecimalType(precision=precision, scale=scale)


def varchar(length: int | None = None) -> VarcharType:
    return VarcharType(length=length)


def char(length: int) -> CharType:
    return CharType(length=length)


def is_integer(t: SqlType) -> bool:
    return isinstance(t, IntegerLikeType)


def is_numeric(t: SqlType) -> bool:
    return isinstance(t, (IntegerLikeType, RealType, DoubleType, DecimalType))


def is_string(t: SqlType) -> bool:
    return isinstance(t, (VarcharType, CharType))


def is_orderable(t: SqlType) -> bool:
    return is_numeric(t) or is_string(t) or isinstance(t, (DateType, TimestampType, BooleanType))


_INT_ORDER = {"tinyint": 0, "smallint": 1, "integer": 2, "bigint": 3}


def common_super_type(a: SqlType, b: SqlType) -> SqlType | None:
    """Implicit coercion lattice (reference: ``type/TypeCoercion.java``)."""
    if a == b:
        return a
    if isinstance(a, UnknownType):
        return b
    if isinstance(b, UnknownType):
        return a
    if is_integer(a) and is_integer(b):
        return a if _INT_ORDER[a.name] >= _INT_ORDER[b.name] else b
    # integer + decimal -> decimal wide enough to hold the integer
    if is_integer(a) and isinstance(b, DecimalType):
        return DecimalType(precision=18, scale=b.scale)
    if isinstance(a, DecimalType) and is_integer(b):
        return DecimalType(precision=18, scale=a.scale)
    if isinstance(a, DecimalType) and isinstance(b, DecimalType):
        scale = max(a.scale, b.scale)
        return DecimalType(precision=18, scale=scale)
    # anything numeric + double/real -> double
    numeric = (IntegerLikeType, DecimalType, RealType, DoubleType)
    if isinstance(a, numeric) and isinstance(b, numeric):
        if DOUBLE in (a, b) or (isinstance(a, RealType) or isinstance(b, RealType)):
            if isinstance(a, RealType) and isinstance(b, RealType):
                return REAL
            return DOUBLE
    if is_string(a) and is_string(b):
        return VARCHAR
    if isinstance(a, DateType) and isinstance(b, TimestampType):
        return TIMESTAMP
    if isinstance(a, TimestampType) and isinstance(b, DateType):
        return TIMESTAMP
    return None


def parse_type(text: str) -> SqlType:
    """Parse a type name as it appears in SQL (CAST target, DDL)."""
    t = text.strip().lower()
    simple = {
        "boolean": BOOLEAN,
        "tinyint": TINYINT,
        "smallint": SMALLINT,
        "integer": INTEGER,
        "int": INTEGER,
        "bigint": BIGINT,
        "real": REAL,
        "double": DOUBLE,
        "date": DATE,
        "timestamp": TIMESTAMP,
        "varchar": VARCHAR,
        "unknown": UNKNOWN,  # NULL-typed fields inside row(...) on the wire
    }
    if t in simple:
        return simple[t]
    if t.startswith("decimal"):
        inner = t[t.index("(") + 1 : t.index(")")]
        p, s = ([int(x) for x in inner.split(",")] + [0])[:2]
        return decimal(p, s)
    if t.startswith("varchar"):
        inner = t[t.index("(") + 1 : t.index(")")]
        return varchar(int(inner))
    if t.startswith("char"):
        inner = t[t.index("(") + 1 : t.index(")")]
        return char(int(inner))
    if t.startswith("array(") and t.endswith(")"):
        return ArrayType(element=parse_type(t[6:-1]))
    if t.startswith("map(") and t.endswith(")"):
        k, v = _split_top(t[4:-1])
        return MapType(key=parse_type(k), value=parse_type(v))
    if t.startswith("row(") and t.endswith(")"):
        fields = []
        for part in _split_all_top(t[4:-1]):
            part = part.strip()
            bits = part.split(" ", 1)
            if len(bits) == 2 and not bits[0].endswith(","):
                try:
                    fields.append((bits[0], parse_type(bits[1])))
                    continue
                except ValueError:
                    pass
            fields.append((None, parse_type(part)))
        return RowType(fields=tuple(fields))
    raise ValueError(f"cannot parse type: {text!r}")


def _split_all_top(s: str) -> list[str]:
    """Split on commas at paren depth 0."""
    out, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(s[start:i])
            start = i + 1
    out.append(s[start:])
    return out


def _split_top(s: str) -> tuple[str, str]:
    parts = _split_all_top(s)
    if len(parts) != 2:
        raise ValueError(f"expected two type arguments in {s!r}")
    return parts[0], parts[1]
