"""Expression compiler: RowExpr IR -> torch ops with SQL NULL semantics.

The analog of Trino's bytecode codegen tier
(``core/trino-main/src/main/java/io/trino/sql/gen/ExpressionCompiler.java:56``):
the IR is evaluated over a batch's column tensors, eagerly, on the
batch's device. Every expression evaluates to a pair ``(data, valid)`` of
tensors (SQL three-valued logic).

This is the subset of ``trino_tpu/compiler.py`` the ported query path
needs: column references; numeric, DECIMAL, DATE and VARCHAR literals
(DECIMAL literals past int64 as wide (n, 2) lanes); comparisons across
numeric types, DECIMAL scales and widths, and of DATEs; ``+ - * / %``,
negation, ``abs``, ``floor``/``ceil``, ``round``, ``greatest``/``least``,
with DECIMAL rescaling and 128-bit lanes (``ops/decimal128.py``); casts
among DECIMAL, the integers and DOUBLE; AND/OR/NOT (Kleene logic), IS
NULL, IF, COALESCE, IN and BETWEEN, over wide operands too; the date
functions (``year``/``month``/``day``, ``extract``'s fields,
``date_trunc``); and the string half, dictionary first:
VARCHAR comparisons and ``IN`` (a column against a literal through the
column's dictionary, two columns through a unified one), ``LIKE``,
``length``/``strpos``/``starts_with``/``regexp_like``/``codepoint``, each
computed once per dictionary value on the host and gathered on the
device. String->string functions are lowered before evaluation
(:func:`trino_tpu_torch.strings.lower_string_calls`); math, bitwise and
hash functions (``checksum``'s ``hash64``), ``width_bucket``, NULLIF,
month arithmetic on dates, and the ARRAY/MAP/ROW accessors over
pool-coded values (``cardinality``, ``element_at``, ``contains``,
``map[k]``, ``row(...)[i]``: a per-code table computed on the host,
gathered on the device). The forms the reference refuses (a non-literal
LIKE or regexp pattern, string argument, ``round`` digits or
``date_trunc`` unit; a DECIMAL(38) downscale; DECIMAL(38) * DECIMAL(38))
are refused with the reference's error class. Any other expression raises
:class:`NotImplementedError` naming it.

Reference semantics kept: integer ``+ - *`` raise on overflow instead of
wrapping (Trino's "integer overflow"); division by zero gives NULL (the
reference's documented deviation); DECIMAL division and downscaling
round half up; comparisons of mixed numeric types run in their common
super type.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Column, Dictionary, as_tensor, torch_dtype
from trino_tpu_torch.ir import (
    Call,
    Constant,
    HoistedConstant,
    InputRef,
    RowExpr,
    SpecialForm,
)
from trino_tpu_torch.ops import decimal128 as D128

Pair = tuple[torch.Tensor, torch.Tensor]  # (data, valid)

_US_PER_DAY = 86_400_000_000


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to trino_tpu_torch")


def _numeric(t: T.SqlType) -> bool:
    return isinstance(
        t, (T.IntegerLikeType, T.DoubleType, T.RealType, T.BooleanType)
    )


def _is_wide(data) -> bool:
    """Wide DECIMAL storage: (n, 2) int64 (hi, lo) lanes."""
    return getattr(data, "ndim", 1) == 2


def _dec_scale(t: T.SqlType) -> int:
    return t.scale if isinstance(t, T.DecimalType) else 0


def _is_float(t: T.SqlType) -> bool:
    return isinstance(t, (T.DoubleType, T.RealType))


def _as_pair128(data, scale: int, target_scale: int):
    """Any decimal storage -> (hi, lo) lanes rescaled up to target_scale."""
    if _is_wide(data):
        hi, lo = data[:, 0], data[:, 1]
    else:
        hi, lo = D128.widen_i64(data.to(torch.int64))
    if target_scale > scale:
        hi, lo = D128.rescale_up_wide(hi, lo, target_scale - scale)
    elif target_scale < scale:
        raise NotImplementedError("DECIMAL(38) downscale")  # as the reference
    return hi, lo


def _widen_storage(data):
    """Any decimal storage -> wide (n, 2) lanes."""
    if _is_wide(data):
        return data
    return torch.stack(D128.widen_i64(data.to(torch.int64)), dim=1)


def _where_pair(mask, x, y):
    """torch.where that follows wide (n, 2) operands (mask stays (n,))."""
    if _is_wide(x) or _is_wide(y):
        return torch.where(mask[:, None], _widen_storage(x), _widen_storage(y))
    return torch.where(mask, x, y.to(x.dtype))


def div_by_number(x: torch.Tensor, divisor) -> torch.Tensor:
    """``x / divisor`` rounded once, as IEEE division does: on a CUDA
    tensor torch divides by a Python number as a product with its
    reciprocal (two roundings, one unit in the last place off the CPU's
    result at times), so the divisor goes in as a tensor."""
    return x / torch.full_like(x, divisor)


def _wide_to_double(data, scale: int):
    lo = data[:, 1].to(torch.float64)
    lo_u = lo + torch.where(data[:, 1] < 0, 2.0**64, 0.0)
    return div_by_number(data[:, 0].to(torch.float64) * 2.0**64 + lo_u, 10**scale)


def _narrow_checked(data, what: str):
    """Wide storage -> int64, raising if any value does not fit."""
    if not _is_wide(data):
        return data.to(torch.int64)
    hi, lo = data[:, 0], data[:, 1]
    if not bool((hi == (lo >> 63)).all()):
        raise ArithmeticError(f"{what}: DECIMAL value exceeds 18 digits")
    return lo


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _rescale(data, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    # scale down with round-half-up (Trino semantics)
    f = 10 ** (from_scale - to_scale)
    half = f // 2
    return torch.where(
        data >= 0, _floordiv(data + half, f), -_floordiv(-data + half, f)
    )


def _round_half_up(data):
    """Trino rounds doubles half away from zero (torch.round is half to
    even)."""
    return torch.sign(data) * torch.floor(torch.abs(data) + 0.5)


def _trunc_div(a, b):
    """Integer division truncating toward zero, as Trino's."""
    q = _floordiv(torch.abs(a), torch.abs(b))
    return torch.where((a >= 0) == (b >= 0), q, -q)


def param_tensor(params, device) -> torch.Tensor | None:
    """A canonical plan's hoisted literals, ``[(value, type), ...]``, as
    one int64 tensor on ``device`` (floating values by their float64
    bits), built once a query run: one host-to-device copy, from pinned
    memory on a card. None when there are none."""
    if not params:
        return None
    words = []
    for v, t in params:
        if torch_dtype(t.storage_dtype).is_floating_point:
            words.append(torch.tensor([float(v)], dtype=torch.float64).view(torch.int64))
        else:
            words.append(torch.tensor([int(v)], dtype=torch.int64))
    host = torch.cat(words)
    device = torch.device(device)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def param_value(params: torch.Tensor, index: int, t: T.SqlType) -> torch.Tensor:
    """Element ``index`` of a parameter tensor as a 0-d tensor of the
    storage dtype of ``t``: equal to what ``torch.full`` would bake."""
    dt = torch_dtype(t.storage_dtype)
    w = params[index : index + 1]
    if dt.is_floating_point:
        return w.view(torch.float64).to(dt)[0]
    return w.to(dt)[0]


class ExprCompiler:
    """Evaluates a RowExpr tree over a batch's columns."""

    def __init__(self, columns: Sequence[Column], device,
                 string_dictionary: Dictionary | None = None,
                 params: torch.Tensor | None = None):
        self.columns = list(columns)
        self.n = self.columns[0].capacity if self.columns else 1
        self.device = torch.device(device)
        # unified dictionary context: when set, string literals encode
        # against it (the executor remaps the referenced string columns
        # into it first, see exec.local.unify_strings)
        self.string_dictionary = string_dictionary
        # the query's parameter tensor (:func:`param_tensor`): a
        # HoistedConstant reads its element on the device, so literal
        # variants share one captured program (reference:
        # trino_tpu/compiler.py:222-250)
        self.params = params

    # -- entry points -----------------------------------------------------
    def evaluate(self, expr: RowExpr) -> Pair:
        return self._eval(expr)

    def predicate_mask(self, expr: RowExpr) -> torch.Tensor:
        """NULL -> false, per SQL WHERE semantics."""
        data, valid = self._eval(expr)
        return data & valid

    # -- dispatch ---------------------------------------------------------
    def _ones(self) -> torch.Tensor:
        return torch.ones(self.n, dtype=torch.bool, device=self.device)

    def _eval(self, expr: RowExpr) -> Pair:
        if isinstance(expr, InputRef):
            c = self.columns[expr.channel]
            return c.data, c.valid_mask()
        if isinstance(expr, HoistedConstant):
            if self.params is not None:
                data = param_value(self.params, expr.index, expr.type)
                return data.expand(self.n), self._ones()
            if expr.value is None:
                # only reachable by executing a serde round-tripped
                # canonical plan without its parameter tensor
                raise ValueError(
                    f"hoisted constant param[{expr.index}] evaluated "
                    "without a parameter tensor"
                )
            # no parameter tensor: bake the kept value
        if isinstance(expr, Constant):
            if T.is_string(expr.type) and expr.value is not None:
                if self.string_dictionary is None:
                    # string literals are evaluable inside comparisons and
                    # LIKE (the column's dictionary) or under a unified
                    # dictionary (string-valued projections)
                    raise NotImplementedError(
                        "string literal outside a comparison context"
                    )
                code = self.string_dictionary.encode(expr.value)
                data = torch.full((self.n,), code, dtype=torch.int32, device=self.device)
                return data, self._ones()
            return self._constant(expr.type, expr.value)
        if isinstance(expr, SpecialForm):
            return self._special(expr)
        if isinstance(expr, Call):
            return self._call(expr)
        raise TypeError(f"unknown IR node {expr!r}")

    def _table(self, values, dtype) -> torch.Tensor:
        """A host-computed per-code lookup table on the device."""
        return torch.tensor(values, dtype=dtype, device=self.device)

    def _arg_dictionary(self, e: RowExpr) -> Dictionary | None:
        if isinstance(e, InputRef):
            return self.columns[e.channel].dictionary
        return None

    def _constant(self, t: T.SqlType, value) -> Pair:
        if value is None:
            dt = torch_dtype(t.storage_dtype)
            return (
                torch.zeros(self.n, dtype=dt, device=self.device),
                torch.zeros(self.n, dtype=torch.bool, device=self.device),
            )
        if isinstance(t, T.DecimalType) and abs(int(value)) >= 1 << 63:
            # literal beyond int64: wide (n, 2) lanes
            hi, lo = D128.int_to_pair(int(value))
            data = torch.tensor([hi, lo], dtype=torch.int64, device=self.device)
            return data.expand(self.n, 2).clone(), self._ones()
        if not (_numeric(t) or isinstance(t, (T.DecimalType, T.DateType, T.TimestampType))):
            raise _not_ported(f"a {t.name} literal")
        data = torch.full(
            (self.n,), value, dtype=torch_dtype(t.storage_dtype),
            device=self.device,
        )
        return data, self._ones()

    # -- special forms ----------------------------------------------------
    def _special(self, expr: SpecialForm) -> Pair:
        form = expr.form
        if form == "and":
            acc = None
            for a in expr.args:
                p = self._eval(a)
                acc = p if acc is None else _kleene_and(acc, p)
            return acc
        if form == "or":
            acc = None
            for a in expr.args:
                p = self._eval(a)
                acc = p if acc is None else _kleene_or(acc, p)
            return acc
        if form == "not":
            d, v = self._eval(expr.args[0])
            return ~d, v
        if form == "is_null":
            _, v = self._eval(expr.args[0])
            return ~v, torch.ones_like(v)
        if form == "if":
            cond, then, other = (self._eval(a) for a in expr.args)
            take_then = cond[0] & cond[1]
            data = _where_pair(take_then, then[0], other[0])
            valid = torch.where(take_then, then[1], other[1])
            return data, valid
        if form == "coalesce":
            data, valid = self._eval(expr.args[0])
            for a in expr.args[1:]:
                d2, v2 = self._eval(a)
                data = _where_pair(valid, data, d2)
                valid = valid | v2
            return data, valid
        if form == "in":
            needle = expr.args[0]
            acc: Pair | None = None
            for candidate in expr.args[1:]:
                eq = self._compare(
                    Call(type=T.BOOLEAN, name="eq", args=(needle, candidate))
                )
                acc = eq if acc is None else _kleene_or(acc, eq)
            return acc
        if form == "between":
            val, lo, hi = expr.args
            ge = self._compare(Call(type=T.BOOLEAN, name="ge", args=(val, lo)))
            le = self._compare(Call(type=T.BOOLEAN, name="le", args=(val, hi)))
            return _kleene_and(ge, le)
        if form == "null_if":
            return self._null_if(expr)
        raise _not_ported(f"special form {form!r}")

    def _null_if(self, expr: SpecialForm) -> Pair:
        """NULLIF(a, b): ``a``, NULL where it equals ``b``; DECIMAL operands
        compare at their common scale, in 128-bit lanes when either is
        wide (reference: the ``null_if`` form)."""
        a, b = self._eval(expr.args[0]), self._eval(expr.args[1])
        sa = _dec_scale(expr.args[0].type)
        sb = _dec_scale(expr.args[1].type)
        s = max(sa, sb)
        if _is_wide(a[0]) or _is_wide(b[0]):
            same = D128.compare128(
                *_as_pair128(a[0], sa, s), *_as_pair128(b[0], sb, s)
            ) == 0
        elif sa != sb:
            same = _rescale(a[0].to(torch.int64), sa, s) == _rescale(
                b[0].to(torch.int64), sb, s
            )
        else:
            same = a[0] == b[0]
        return a[0], a[1] & ~(same & a[1] & b[1])

    # -- calls ------------------------------------------------------------
    def _call(self, expr: Call) -> Pair:
        name = expr.name
        if name in ("add", "subtract", "multiply", "divide", "modulus"):
            return self._arith(expr)
        if name in ("eq", "ne", "lt", "le", "gt", "ge"):
            return self._compare(expr)
        if name == "negate":
            d, v = self._eval(expr.args[0])
            if _is_wide(d):
                return torch.stack(D128.neg128(d[:, 0], d[:, 1]), dim=1), v
            return -d, v
        if name == "cast":
            return self._cast(expr)
        if name == "abs":
            d, v = self._eval(expr.args[0])
            if _is_wide(d):
                hi, lo = D128.neg128(d[:, 0], d[:, 1])
                neg = (d[:, 0] < 0)[:, None]
                return torch.where(neg, torch.stack([hi, lo], dim=1), d), v
            return torch.abs(d), v
        if name in ("year", "month", "day"):
            return self._extract(expr)
        if name == "date_add_days":
            d, v = self._eval(expr.args[0])
            delta, dv = self._eval(expr.args[1])
            return d + delta.to(d.dtype), v & dv
        if name == "date_add_months":
            # the day clamps to the target month's last day (Jan 31 + 1
            # month = Feb 28/29), as the reference does
            d, v = self._eval(expr.args[0])
            months, mv = self._eval(expr.args[1])
            y, m, dd = _civil_from_days(d.to(torch.int32))
            total = y * 12 + (m - 1) + months.to(torch.int32)
            y2 = _floordiv(total, 12)
            m2 = torch.remainder(total, 12) + 1
            dd2 = torch.minimum(dd, _days_in_month_vec(y2, m2))
            return _days_from_civil_vec(y2, m2, dd2).to(d.dtype), v & mv
        if name == "date_diff_days":
            a, av = self._eval(expr.args[0])
            b, bv = self._eval(expr.args[1])
            return b.to(torch.int64) - a.to(torch.int64), av & bv
        if name in ("day_of_week", "day_of_year", "week", "quarter",
                    "last_day_of_month"):
            return self._date_field(expr)
        if name == "date_trunc":
            return self._date_trunc(expr)
        if name == "like":
            return self._like(expr)
        if name in ("length", "strpos", "starts_with", "regexp_like",
                    "codepoint"):
            return self._string_table(expr)
        if name in ("floor", "ceil"):
            d, v = self._eval(expr.args[0])
            t = expr.args[0].type
            if isinstance(t, T.DecimalType):
                f = t.unscale
                q = _floordiv(d, f) if name == "floor" else -_floordiv(-d, f)
                return q * f, v
            return (torch.floor if name == "floor" else torch.ceil)(d), v
        if name == "round":
            return self._round(expr)
        if name in _UNARY_MATH:
            d, v = self._eval(expr.args[0])
            return _UNARY_MATH[name](d), v
        if name in ("power", "atan2"):
            a, av = self._eval(expr.args[0])
            b, bv = self._eval(expr.args[1])
            fn = torch.pow if name == "power" else torch.atan2
            return fn(a, b), av & bv
        if name == "sign":
            d, v = self._eval(expr.args[0])
            return torch.sign(d), v
        if name == "truncate":
            d, v = self._eval(expr.args[0])
            return torch.trunc(d), v
        if name.startswith("bitwise_"):
            return self._bitwise(expr)
        if name == "hash64":
            return self._hash64(expr)
        if name == "str_hash64":
            return self._str_hash64(expr)
        if name == "width_bucket":
            return self._width_bucket(expr)
        if name in ("cardinality", "element_at", "array_contains"):
            return self._array_table(expr)
        if name in ("map_cardinality", "map_element_at", "row_field"):
            return self._map_row_table(expr)
        if name in ("greatest", "least"):
            # SQL: NULL if any argument is NULL
            pairs = [self._eval(a) for a in expr.args]
            fn = torch.maximum if name == "greatest" else torch.minimum
            out, valid = pairs[0]
            for d, v in pairs[1:]:
                out = fn(out, d.to(out.dtype))
                valid = valid & v
            return out, valid
        raise _not_ported(f"function {name!r} over {expr.type.name}")

    # -- dates --------------------------------------------------------------
    @staticmethod
    def _days(d, st: T.SqlType):
        if isinstance(st, T.TimestampType):
            return _floordiv(d, _US_PER_DAY).to(torch.int32)
        return d.to(torch.int32)

    def _extract(self, expr: Call) -> Pair:
        d, v = self._eval(expr.args[0])
        y, m, dd = _civil_from_days(self._days(d, expr.args[0].type))
        out = {"year": y, "month": m, "day": dd}[expr.name]
        return out.to(torch.int64), v

    def _date_field(self, expr: Call) -> Pair:
        d, v = self._eval(expr.args[0])
        days = self._days(d, expr.args[0].type)
        name = expr.name
        if name == "day_of_week":
            # ISO: Monday=1..Sunday=7 (1970-01-01 was a Thursday)
            return (torch.remainder(days + 3, 7) + 1).to(torch.int64), v
        y, m, dd = _civil_from_days(days)
        if name == "quarter":
            return (_floordiv(m - 1, 3) + 1).to(torch.int64), v
        if name == "last_day_of_month":
            last = _days_from_civil_vec(y, m, _days_in_month_vec(y, m))
            return last.to(torch.int32), v
        jan1 = _days_from_civil_vec(y, torch.ones_like(m), torch.ones_like(dd))
        doy = (days - jan1 + 1).to(torch.int64)
        if name == "day_of_year":
            return doy, v
        # ISO 8601 week number
        dow = torch.remainder(days + 3, 7) + 1  # Monday=1
        w = _floordiv(doy - dow + 10, 7)
        # w == 0: the previous year's last week (52 or 53)
        prev_y = y - 1
        prev_len = torch.where(_is_leap(prev_y), 366, 365)
        prev_jan1_dow = torch.remainder(jan1 - prev_len + 3, 7) + 1
        prev_has53 = (prev_jan1_dow == 4) | (_is_leap(prev_y) & (prev_jan1_dow == 3))
        w0 = torch.where(prev_has53, 53, 52)
        # w == 53: only when this year has 53 ISO weeks
        jan1_dow = torch.remainder(jan1 + 3, 7) + 1
        has53 = (jan1_dow == 4) | (_is_leap(y) & (jan1_dow == 3))
        w = torch.where(w == 0, w0, w)
        w = torch.where((w == 53) & ~has53, 1, w)
        return w.to(torch.int64), v

    def _date_trunc(self, expr: Call) -> Pair:
        unit_e = expr.args[0]
        if not isinstance(unit_e, Constant):
            raise NotImplementedError("date_trunc unit must be a literal")
        unit = str(unit_e.value).lower()
        d, v = self._eval(expr.args[1])
        if isinstance(expr.args[1].type, T.TimestampType):
            us_per = {"second": 10**6, "minute": 60 * 10**6,
                      "hour": 3600 * 10**6, "day": _US_PER_DAY}
            if unit in us_per:
                p = us_per[unit]
                return _floordiv(d, p) * p, v
            days = _floordiv(d, _US_PER_DAY).to(torch.int32)
            return _trunc_days(days, unit).to(torch.int64) * _US_PER_DAY, v
        days = d.to(torch.int32)
        if unit == "day":
            return days, v
        return _trunc_days(days, unit), v

    # -- bit and hash functions ---------------------------------------------
    def _bitwise(self, expr: Call) -> Pair:
        """Bitwise functions over int64 two's complement; shifts by 64 or
        more give 0 (logical) or the sign fill (arithmetic), as in the
        reference."""
        name = expr.name
        if name == "bitwise_not":
            d, v = self._eval(expr.args[0])
            return ~d.to(torch.int64), v
        a, av = self._eval(expr.args[0])
        b, bv = self._eval(expr.args[1])
        a, b = a.to(torch.int64), b.to(torch.int64)
        if name == "bitwise_and":
            r = a & b
        elif name == "bitwise_or":
            r = a | b
        elif name == "bitwise_xor":
            r = a ^ b
        elif name == "bitwise_left_shift":
            r = torch.where(b >= 64, 0, a << (b & 63))
        elif name == "bitwise_right_shift":
            r = torch.where(b >= 64, 0, _srl_vec(a, b & 63))
        elif name == "bitwise_right_shift_arithmetic":
            r = torch.where(b >= 64, a >> 63, a >> (b & 63))
        else:
            raise _not_ported(f"function {name!r}")
        return r, av & bv

    def _hash64(self, expr: Call) -> Pair:
        """The checksum's per-value hash: an avalanche finalizer over the
        value's int64 lanes (both lanes of a wide DECIMAL; a double's
        mantissa and exponent); NULL hashes to a fixed constant."""
        d, v = self._eval(expr.args[0])
        if _is_wide(d):
            out = _avalanche64(d[:, 0]) ^ _avalanche64(d[:, 1] ^ _HASH_LANE_SALT)
        elif _is_float(expr.args[0].type):
            m, e = torch.frexp(d.to(torch.float64))
            im = (m * (2.0**53)).to(torch.int64)
            out = _avalanche64(im ^ (e.to(torch.int64) << 53))
        else:
            out = _avalanche64(d.to(torch.int64))
        null = torch.full_like(out, _HASH_NULL)
        return torch.where(v, out, null), torch.ones_like(v)

    def _str_hash64(self, expr: Call) -> Pair:
        """Content hash of a dictionary string column: blake2b of each
        dictionary value on the host, gathered by code."""
        import hashlib

        col_e = expr.args[0]
        d, v = self._eval(col_e)
        dictionary = self._arg_dictionary(col_e)
        if dictionary is None:
            raise ValueError("str_hash64 on a string column without a dictionary")
        table = [
            int.from_bytes(
                hashlib.blake2b(s.encode("utf-8", "surrogatepass"),
                                digest_size=8).digest(),
                "little", signed=True,
            )
            for s in dictionary.values
        ] + [0]
        out = self._gather(self._table(table, torch.int64), d)
        null = torch.full_like(out, _HASH_NULL)
        return torch.where(v, out, null), torch.ones_like(v)

    def _width_bucket(self, expr: Call) -> Pair:
        x, xv = self._eval(expr.args[0])
        lo, lov = self._eval(expr.args[1])
        hi, hiv = self._eval(expr.args[2])
        nb, nbv = self._eval(expr.args[3])
        nb = nb.to(torch.int64)
        valid = xv & lov & hiv & nbv
        if bool((valid & (hi == lo)).any()):
            raise ArithmeticError("width_bucket bounds cannot be equal")
        span = torch.where(hi == lo, torch.ones_like(hi - lo), hi - lo)
        raw = (torch.floor((x - lo) / span * nb.to(torch.float64)) + 1).to(torch.int64)
        asc = torch.where(x < lo, 0, torch.where(x >= hi, nb + 1, raw))
        # descending bounds (bound1 > bound2)
        desc = torch.where(x > lo, 0, torch.where(x <= hi, nb + 1, raw))
        return torch.where(lo <= hi, asc, desc), valid

    # -- ARRAY / MAP / ROW (pool-coded values) ----------------------------------
    def _pool_values(self, et: T.SqlType, vals, d, v) -> Pair:
        """Per-pool-code element values -> a (data, valid) pair of type
        ``et``, one gather each."""
        if T.is_string(et):
            # the reference refuses string elements here too (UNNEST
            # covers that shape)
            raise NotImplementedError("element_at over ARRAY(varchar) — use UNNEST")
        present = self._table([x is not None for x in vals] + [False], torch.bool)
        table = torch.tensor(
            np.asarray([x if x is not None else 0 for x in vals] + [0],
                       dtype=et.storage_dtype),
            device=self.device,
        )
        return self._gather(table, d), v & self._gather(present, d)

    def _array_table(self, expr: Call) -> Pair:
        """cardinality / element_at / contains over pool-coded arrays: a
        per-code table computed on the host, gathered on the device
        (reference: ``_array_table``)."""
        d, v, pool = self._pool_for_arg(expr)
        entries = pool.values
        name = expr.name
        if name == "cardinality":
            return self._pool_length_table(entries, d, v)
        arg = expr.args[1]
        if name == "element_at":
            if not isinstance(arg, Constant) or arg.value is None:
                raise NotImplementedError("element_at index must be a literal")
            i = int(arg.value)
            vals = []
            for e in entries:
                j = i - 1 if i > 0 else len(e) + i
                vals.append(e[j] if 0 <= j < len(e) else None)
            return self._pool_values(expr.type, vals, d, v)
        if not isinstance(arg, Constant) or arg.value is None:
            raise NotImplementedError("contains value must be a literal")
        table = self._table([arg.value in e for e in entries] + [False], torch.bool)
        return self._gather(table, d), v

    def _map_row_table(self, expr: Call) -> Pair:
        """map cardinality, map subscript and ROW field access over
        pool-coded values (reference: ``_map_row_table``)."""
        d, v, pool = self._pool_for_arg(expr)
        entries = pool.values
        name = expr.name
        if name == "map_cardinality":
            return self._pool_length_table(entries, d, v)
        arg = expr.args[1]
        if name == "map_element_at":
            if not isinstance(arg, Constant) or arg.value is None:
                raise NotImplementedError("map subscript key must be a literal")
            vals = [dict(e).get(arg.value) for e in entries]
            return self._pool_values(expr.type, vals, d, v)
        i = int(arg.value)  # row_field: a 1-based literal index
        vals = [e[i - 1] if 0 < i <= len(e) else None for e in entries]
        return self._pool_values(expr.type, vals, d, v)

    def _round(self, expr: Call) -> Pair:
        d, v = self._eval(expr.args[0])
        st = expr.args[0].type
        nd = 0
        if len(expr.args) > 1:
            if not isinstance(expr.args[1], Constant):
                # the reference asserts a literal here
                raise AssertionError("round digits must be a literal")
            nd = int(expr.args[1].value)
        if isinstance(st, T.DecimalType):
            if nd >= st.scale:
                return d, v
            scaled = _rescale(d.to(torch.int64), st.scale, nd)
            return _rescale(scaled, nd, st.scale), v
        if nd == 0:
            return _round_half_up(d), v
        f = 10.0**nd
        return div_by_number(_round_half_up(d * f), f), v

    # -- strings (dictionary first) -----------------------------------------
    def _gather(self, table: torch.Tensor, codes) -> torch.Tensor:
        """table[code] per row; a NULL code (-1) reads entry 0."""
        return table[codes.clamp(min=0).long()]

    def _pool_for_arg(self, expr: Call):
        """(codes, valid, dictionary) of a call's first argument: a
        dictionary-coded column (strings, or ARRAY/MAP/ROW values coded
        into a pool of tuples), or a literal as a one-value dictionary."""
        col_e = expr.args[0]
        if isinstance(col_e, Constant):
            empty = "" if T.is_string(col_e.type) else ()
            pool = Dictionary([col_e.value if col_e.value is not None else empty])
            d = torch.zeros(self.n, dtype=torch.int32, device=self.device)
            v = torch.full((self.n,), col_e.value is not None, device=self.device)
            return d, v, pool
        d, v = self._eval(col_e)
        pool = self._arg_dictionary(col_e)
        if pool is None:
            raise ValueError(f"{expr.name} on a string column without a dictionary")
        return d, v, pool

    def _pool_length_table(self, entries, d, v) -> Pair:
        table = self._table([len(e) for e in entries] + [0], torch.int64)
        return self._gather(table, d), v

    def _string_table(self, expr: Call) -> Pair:
        """String -> numeric scalar through a per-code lookup table
        computed on the host, one gather on the device."""
        d, v, dictionary = self._pool_for_arg(expr)
        name = expr.name
        values = dictionary.values
        if name == "length":
            return self._pool_length_table(values, d, v)
        if name == "codepoint":
            table = [ord(s[0]) if s else 0 for s in values] + [0]
        elif name == "regexp_like":
            pat_e = expr.args[1]
            if not isinstance(pat_e, Constant) or pat_e.value is None:
                raise NotImplementedError("regexp pattern must be a literal")
            rx = re.compile(str(pat_e.value))
            table = [rx.search(s) is not None for s in values] + [False]
        else:
            lit_e = expr.args[1]
            if not isinstance(lit_e, Constant) or lit_e.value is None:
                raise NotImplementedError(f"{name} argument must be a literal")
            lit = str(lit_e.value)
            if name == "strpos":
                table = [s.find(lit) + 1 for s in values] + [0]
            else:  # starts_with
                table = [s.startswith(lit) for s in values] + [False]
        if isinstance(table[-1], bool):
            t = self._table(table, torch.bool)
            return self._gather(t, d) & (d >= 0), v
        return self._gather(self._table(table, torch.int64), d), v

    def _like(self, expr: Call) -> Pair:
        col_e, pat_e = expr.args
        if not isinstance(pat_e, Constant):
            raise NotImplementedError("LIKE pattern must be a literal")
        dictionary = self._arg_dictionary(col_e)
        if dictionary is None:
            raise ValueError("LIKE on a string column without a dictionary")
        d, v = self._eval(col_e)
        regex = _like_to_regex(pat_e.value)
        table = self._table(
            [regex.fullmatch(s) is not None for s in dictionary.values] + [False],
            torch.bool,
        )
        return self._gather(table, d) & (d >= 0), v

    def _string_compare(self, expr: Call) -> Pair:
        a_e, b_e = expr.args
        # column vs literal: the literal through the column's dictionary
        col_e, lit_e, flipped = a_e, b_e, False
        if isinstance(a_e, Constant):
            col_e, lit_e, flipped = b_e, a_e, True
        d, v = self._eval(col_e)
        dictionary = self._arg_dictionary(col_e)
        name = expr.name
        if isinstance(lit_e, Constant):
            if dictionary is None:
                raise ValueError("string column without a dictionary")
            lit = lit_e.value
            if flipped:
                name = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(name, name)
            if name in ("eq", "ne"):
                code = dictionary.encode(lit)
                if code < 0:  # absent: never equal
                    res = torch.full_like(v, name == "ne")
                else:
                    res = (d == code) if name == "eq" else (d != code)
                return res, v
            # ordered compare: a per-code truth table
            py_op = {"lt": lambda x: x < lit, "le": lambda x: x <= lit,
                     "gt": lambda x: x > lit, "ge": lambda x: x >= lit}[name]
            table = self._table(
                [bool(py_op(s)) for s in dictionary.values] + [False], torch.bool
            )
            return self._gather(table, d) & (d >= 0), v
        # column vs column
        o_e = a_e if flipped else b_e
        od, ov = self._eval(o_e)
        d2 = self._arg_dictionary(o_e)
        valid = v & ov
        if dictionary is None or d2 is None:
            raise _not_ported("a string comparison without dictionaries")
        if dictionary is d2:
            if name in ("eq", "ne"):
                return _cmp_op(name, d, od), valid
            ranks = as_tensor(dictionary.ranks(), self.device)
            return _cmp_op(name, self._gather(ranks, d), self._gather(ranks, od)), valid
        if name in ("eq", "ne"):
            # this column's codes remapped into the other's code space; a
            # NULL code reads the -2 sentinel, which equals no code
            remap = self._table(
                [d2.encode(s) for s in dictionary.values] + [-2], torch.int64
            )
            idx = torch.where(d >= 0, d.long(), len(dictionary.values))
            return _cmp_op(name, remap[idx], od.to(torch.int64)), valid
        # ordered: through the merged dictionary's rank space
        md, remap_b = d2.merged(dictionary)
        mranks = md.ranks()
        rb = as_tensor(np.append(mranks[: len(d2.values)], 0), self.device)
        ra = as_tensor(np.append(mranks[remap_b], 0), self.device)
        return _cmp_op(name, self._gather(ra, d), self._gather(rb, od)), valid

    def _arith(self, expr: Call) -> Pair:
        a_t, b_t = expr.args[0].type, expr.args[1].type
        rt = expr.type
        name = expr.name
        if not all(
            _numeric(x) or isinstance(x, T.DecimalType) for x in (rt, a_t, b_t)
        ):
            raise _not_ported(f"{name} over {rt.name}")
        a, b = self._eval(expr.args[0]), self._eval(expr.args[1])
        valid = a[1] & b[1]
        if isinstance(rt, T.DecimalType) and (
            rt.wide or _is_wide(a[0]) or _is_wide(b[0])
        ):
            return self._arith_wide(expr, a, b, valid)
        if isinstance(rt, T.DecimalType):
            rs = rt.scale
            sa, sb = _dec_scale(a_t), _dec_scale(b_t)
            ad, bd = a[0].to(torch.int64), b[0].to(torch.int64)
            if name == "add":
                return _rescale(ad, sa, rs) + _rescale(bd, sb, rs), valid
            if name == "subtract":
                return _rescale(ad, sa, rs) - _rescale(bd, sb, rs), valid
            if name == "multiply":
                return _rescale(ad * bd, sa + sb, rs), valid
            return self._arith_narrow_decimal(name, ad, bd, valid, sa, sb, rs)
        ad = _cast_numeric(a[0], a_t, rt)
        bd = _cast_numeric(b[0], b_t, rt)
        if T.is_integer(rt) and name in ("add", "subtract", "multiply"):
            # compute in int64 and range-check: the reference raises
            # "integer overflow" instead of wrapping
            a64, b64 = ad.to(torch.int64), bd.to(torch.int64)
            r64 = {"add": torch.add, "subtract": torch.sub,
                   "multiply": torch.mul}[name](a64, b64)
            _check_int_overflow(name, rt, a64, b64, r64, valid)
            return r64.to(torch_dtype(rt.storage_dtype)), valid
        if name == "add":
            return ad + bd, valid
        if name == "subtract":
            return ad - bd, valid
        if name == "multiply":
            return ad * bd, valid
        nonzero = bd != 0
        if name == "divide":
            if not ad.is_floating_point():
                bz = torch.where(nonzero, bd, torch.ones_like(bd))
                return _trunc_div(ad, bz).to(ad.dtype), valid & nonzero
            bz = torch.where(nonzero, bd, torch.ones_like(bd))
            return ad / bz, valid & nonzero
        # modulus: fmod truncates toward zero (sign of the dividend) = MOD
        bz = torch.where(nonzero, bd, torch.ones_like(bd))
        return torch.fmod(ad, bz), valid & nonzero

    def _arith_wide(self, expr: Call, a: Pair, b: Pair, valid) -> Pair:
        """DECIMAL arithmetic in 128-bit (hi, lo) lanes (reference:
        UnscaledDecimal128Arithmetic add/multiply/divideRoundUp). Modulus
        of wide values narrows when the operands fit int64 and raises
        otherwise."""
        rt = expr.type
        sa, sb = _dec_scale(expr.args[0].type), _dec_scale(expr.args[1].type)
        name = expr.name
        if name == "multiply":
            # result scale == sa + sb: no rescale
            aw, bw = _is_wide(a[0]), _is_wide(b[0])
            if not aw and not bw:
                hi, lo = D128.mul_i64_to_i128(
                    a[0].to(torch.int64), b[0].to(torch.int64)
                )
            elif aw and not bw:
                hi, lo = D128.mul128_by_i64(
                    a[0][:, 0], a[0][:, 1], b[0].to(torch.int64)
                )
            elif bw and not aw:
                hi, lo = D128.mul128_by_i64(
                    b[0][:, 0], b[0][:, 1], a[0].to(torch.int64)
                )
            else:
                raise NotImplementedError("DECIMAL(38) * DECIMAL(38)")  # as the reference
            return torch.stack([hi, lo], dim=1), valid
        if name in ("add", "subtract"):
            ahi, alo = _as_pair128(a[0], sa, rt.scale)
            bhi, blo = _as_pair128(b[0], sb, rt.scale)
            if name == "subtract":
                bhi, blo = D128.neg128(bhi, blo)
            return torch.stack(D128.add128(ahi, alo, bhi, blo), dim=1), valid
        if name == "divide":
            shift = rt.scale - sa + sb
            ahi, alo = _as_pair128(a[0], 0, 0)
            bhi, blo = _as_pair128(b[0], 0, 0)
            if shift < 0:
                bhi, blo = D128.rescale_up_wide(bhi, blo, -shift)
                shift = 0
            qhi, qlo, ok = D128.div128_round(ahi, alo, bhi, blo, shift)
            valid = valid & ok
            if rt.wide:
                return torch.stack([qhi, qlo], dim=1), valid
            return qlo, valid
        ad = _narrow_checked(a[0], "decimal modulus")
        bd = _narrow_checked(b[0], "decimal modulus")
        return self._arith_narrow_decimal(name, ad, bd, valid, sa, sb, rt.scale)

    def _arith_narrow_decimal(self, name, ad, bd, valid, sa, sb, rs):
        """int64 DECIMAL divide/modulus, shared by the narrow path and the
        narrowed wide modulus."""
        nonzero = bd != 0
        if name == "divide":
            # result scale rs: q = round(a * 10^(rs - sa + sb) / b)
            shift = rs - sa + sb
            num = ad * (10 ** max(shift, 0))
            den = torch.where(nonzero, bd, torch.ones_like(bd))
            if shift < 0:
                den = den * (10 ** (-shift))
            half = _floordiv(torch.abs(den), 2)
            q = _floordiv(torch.abs(num) + half, torch.abs(den))
            q = torch.where((num >= 0) == (den > 0), q, -q)
            return q, valid & nonzero
        # MOD: operands aligned to a common scale, truncating division
        # (the result keeps the dividend's sign)
        s = max(sa, sb)
        an, bn = _rescale(ad, sa, s), _rescale(bd, sb, s)
        nz = bn != 0
        bz = torch.where(nz, bn, torch.ones_like(bn))
        r = an - _trunc_div(an, bz) * bz
        return _rescale(r, s, rs), valid & nz

    def _compare(self, expr: Call) -> Pair:
        a_e, b_e = expr.args
        a_t, b_t = a_e.type, b_e.type
        if T.is_string(a_t) or T.is_string(b_t):
            return self._string_compare(expr)
        ok_t = (T.DecimalType, T.DateType, T.TimestampType)
        if not all(_numeric(x) or isinstance(x, ok_t) for x in (a_t, b_t)):
            raise _not_ported(f"comparison of {a_t.name} with {b_t.name}")
        a, b = self._eval(a_e), self._eval(b_e)
        valid = a[1] & b[1]
        sa, sb = _dec_scale(a_t), _dec_scale(b_t)
        if _is_wide(a[0]) or _is_wide(b[0]):
            if _is_float(a_t) or _is_float(b_t):
                # mixed wide DECIMAL / float: compare as doubles
                ad = _wide_to_double(a[0], sa) if _is_wide(a[0]) else a[0]
                bd = _wide_to_double(b[0], sb) if _is_wide(b[0]) else b[0]
                return _cmp_op(expr.name, ad, bd), valid
            s = max(sa, sb)
            sign = D128.compare128(
                *_as_pair128(a[0], sa, s), *_as_pair128(b[0], sb, s)
            )
            return _cmp_op(expr.name, sign, torch.zeros_like(sign)), valid
        if isinstance(a_t, T.DecimalType) or isinstance(b_t, T.DecimalType):
            if _is_float(a_t) or _is_float(b_t):
                ad = _cast_numeric(a[0], a_t, T.DOUBLE)
                bd = _cast_numeric(b[0], b_t, T.DOUBLE)
                return _cmp_op(expr.name, ad, bd), valid
            s = max(sa, sb)
            ad = _rescale(a[0].to(torch.int64), sa, s)
            bd = _rescale(b[0].to(torch.int64), sb, s)
            return _cmp_op(expr.name, ad, bd), valid
        ct = T.common_super_type(a_t, b_t) or a_t
        ad = _cast_numeric(a[0], a_t, ct)
        bd = _cast_numeric(b[0], b_t, ct)
        return _cmp_op(expr.name, ad, bd), valid

    def _cast(self, expr: Call) -> Pair:
        src = expr.args[0]
        st, rt = src.type, expr.type
        d, v = self._eval(src)
        if st == rt:
            return d, v
        if _is_wide(d):
            if _is_float(rt) and isinstance(st, T.DecimalType):
                return _wide_to_double(d, st.scale).to(torch_dtype(rt.storage_dtype)), v
            if isinstance(rt, T.DecimalType) and isinstance(st, T.DecimalType):
                if rt.wide and rt.scale >= st.scale:
                    # wide -> wide upscale stays in (hi, lo) lanes
                    return torch.stack(_as_pair128(d, st.scale, rt.scale), dim=1), v
                if st.scale - rt.scale <= 18:
                    # HALF_UP rescale by exact long division; values that
                    # do not fit a narrow target become NULL
                    hi, lo = d[:, 0], d[:, 1]
                    shift = rt.scale - st.scale
                    if shift >= 0:
                        hi, lo = D128.rescale_up_wide(hi, lo, shift)
                    else:
                        dhi, dlo = D128.widen_i64(
                            torch.full_like(lo, 10 ** (-shift))
                        )
                        hi, lo, _ = D128.div128_round(hi, lo, dhi, dlo, 0)
                    if rt.wide:
                        return torch.stack([hi, lo], dim=1), v
                    return lo, v & (hi == (lo >> 63))
            # other casts narrow (exact when values fit int64)
            d = _narrow_checked(d, f"cast {st} -> {rt}")
        if isinstance(rt, T.DecimalType):
            if isinstance(st, T.DecimalType):
                if rt.wide and rt.scale >= st.scale:
                    return torch.stack(_as_pair128(d, st.scale, rt.scale), dim=1), v
                return _rescale(d.to(torch.int64), st.scale, rt.scale), v
            if T.is_integer(st):
                return d.to(torch.int64) * rt.unscale, v
            if _is_float(st):
                scaled = d.to(torch.float64) * rt.unscale
                return _round_half_up(scaled).to(torch.int64), v
        if _is_float(rt):
            if isinstance(st, T.DecimalType):
                out = div_by_number(d.to(torch.float64), st.unscale)
                return out.to(torch_dtype(rt.storage_dtype)), v
            if _numeric(st):
                return d.to(torch_dtype(rt.storage_dtype)), v
        if T.is_integer(rt):
            dt = torch_dtype(rt.storage_dtype)
            if isinstance(st, T.DecimalType):
                return _rescale(d.to(torch.int64), st.scale, 0).to(dt), v
            if _is_float(st):
                return _round_half_up(d).to(dt), v
            if _numeric(st):
                return d.to(dt), v
        if isinstance(rt, T.BooleanType) and _numeric(st):
            return d.to(torch.bool), v
        if isinstance(rt, T.TimestampType) and isinstance(st, T.DateType):
            return d.to(torch.int64) * _US_PER_DAY, v
        if isinstance(rt, T.DateType) and isinstance(st, T.TimestampType):
            return _floordiv(d, _US_PER_DAY).to(torch.int32), v
        raise _not_ported(f"cast {st.name} -> {rt.name}")


# the reference's constants, as it writes them (shifted by 2^63)
_HASH_LANE_SALT = 0x5851F42D4C957F2D - 2**63
_HASH_NULL = 0x9E3779B97F4A7C15 - 2**63
# its uint64 multipliers, as the int64s with the same bits
_AVALANCHE_M1 = 0xFF51AFD7ED558CCD - 2**64
_AVALANCHE_M2 = 0xC4CEB9FE1A85EC53 - 2**64


def _srl_vec(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 lanes by per-row 0 <= k < 64 (torch
    has no uint64 shift; int64 arithmetic wraps as uint64 does)."""
    kk = torch.clamp(k, min=1)
    mask = (torch.ones_like(x) << (64 - kk)) - 1
    return torch.where(k == 0, x, (x >> kk) & mask)


def _avalanche64(x: torch.Tensor) -> torch.Tensor:
    """The xxhash64/murmur3 finalizer over int64 lanes, as uint64."""
    x = x.to(torch.int64)
    x = x ^ D128._srl(x, 33)
    x = x * _AVALANCHE_M1
    x = x ^ D128._srl(x, 33)
    x = x * _AVALANCHE_M2
    return x ^ D128._srl(x, 33)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


# double-valued math (the analyzer coerces the argument to DOUBLE)
_UNARY_MATH = {
    "ln": torch.log, "log2": torch.log2, "log10": torch.log10,
    "exp": torch.exp, "sqrt": torch.sqrt, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "cbrt": _cbrt,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
}


def _check_int_overflow(name, rt, a64, b64, r64, valid):
    """Raise on integer overflow like the reference."""
    if rt.bits < 64:
        info = torch.iinfo(torch_dtype(rt.storage_dtype))
        bad = valid & ((r64 < info.min) | (r64 > info.max))
    elif name == "multiply":
        bad = valid & D128.mul_i64_overflows(a64, b64)
    else:
        same_sign = (a64 >= 0) == ((b64 >= 0) if name == "add" else (b64 < 0))
        bad = valid & same_sign & ((r64 >= 0) != (a64 >= 0))
    from trino_tpu_torch.exec.programs import defer_error

    if not defer_error(f"{rt.name} overflow", bad.any()) and bool(bad.any()):
        raise ArithmeticError(f"{rt.name} overflow")


def _cmp_op(name: str, a, b):
    return {
        "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
        "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    }[name](a, b)


def _cast_numeric(data, from_t: T.SqlType, to_t: T.SqlType):
    if from_t == to_t:
        return data
    if isinstance(from_t, T.DecimalType):
        if _is_float(to_t):
            dt = torch_dtype(to_t.storage_dtype)
            if _is_wide(data):
                return _wide_to_double(data, from_t.scale).to(dt)
            return div_by_number(data.to(torch.float64), from_t.unscale).to(dt)
        return data  # decimal handled by the caller
    if isinstance(from_t, T.DateType) and isinstance(to_t, T.TimestampType):
        return data.to(torch.int64) * _US_PER_DAY
    return data.to(torch_dtype(to_t.storage_dtype))


def _kleene_and(a: Pair, b: Pair) -> Pair:
    av = torch.where(a[1], a[0], True)
    bv = torch.where(b[1], b[0], True)
    value = av & bv
    valid = (a[1] & b[1]) | (a[1] & ~a[0]) | (b[1] & ~b[0])
    return value, valid


def _kleene_or(a: Pair, b: Pair) -> Pair:
    av = torch.where(a[1], a[0], False)
    bv = torch.where(b[1], b[0], False)
    value = av | bv
    valid = (a[1] & b[1]) | (a[1] & a[0]) | (b[1] & b[0])
    return value, valid


def _civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day), Hinnant's algorithm in
    int32 (the vector form of ``civil.civil_from_days``)."""
    z = days + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(
        doe - _floordiv(doe, 1460) + _floordiv(doe, 36524) - _floordiv(doe, 146096),
        365,
    )
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(y.dtype)
    return y, m, d


def _is_leap(y: torch.Tensor) -> torch.Tensor:
    return ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)


def _days_in_month_vec(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    lengths = torch.tensor(
        [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
        dtype=torch.int32, device=m.device,
    )
    base = lengths[(m - 1).long()]
    return torch.where((m == 2) & _is_leap(y), 29, base)


def _days_from_civil_vec(y, m, d) -> torch.Tensor:
    """Inverse of :func:`_civil_from_days` (Hinnant), elementwise."""
    y = y - (m <= 2).to(y.dtype)
    era = _floordiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    doy = _floordiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _trunc_days(days: torch.Tensor, unit: str) -> torch.Tensor:
    y, m, dd = _civil_from_days(days)
    if unit == "year":
        m = torch.ones_like(m)
        dd = torch.ones_like(dd)
    elif unit == "quarter":
        m = _floordiv(m - 1, 3) * 3 + 1
        dd = torch.ones_like(dd)
    elif unit == "month":
        dd = torch.ones_like(dd)
    elif unit == "week":
        # ISO: back to Monday (1970-01-01 was a Thursday)
        return days - torch.remainder(days + 3, 7)
    else:
        raise _not_ported(f"date_trunc unit {unit!r}")
    return _days_from_civil_vec(y, m, dd)


def _like_to_regex(pattern: str) -> re.Pattern:
    """SQL LIKE -> a Python regex (``%`` any run, ``_`` one character).
    The reference's analyzer drops a LIKE's ESCAPE clause, and so does the
    port's copy; parity keeps that."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out), re.DOTALL)
