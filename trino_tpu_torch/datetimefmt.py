"""Datetime formatting: format_datetime (Joda patterns) and date_format
(MySQL patterns).

Reference: ``operator/scalar/DateTimeFunctions.java`` (formatDatetime with
Joda ``DateTimeFormatter``; dateFormat with the MySQL ``%``-pattern set).

Dates and timestamps are integer storage on the device; the rendering
happens on the host over the *unique* values only (O(distinct), the cost
model of the dictionary string transforms) and yields a dictionary-encoded
varchar column on the column's device. The port's copy of
``trino_tpu/datetimefmt.py``.
"""

from __future__ import annotations

import datetime
import re

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Column, Dictionary, as_tensor

_JODA_MAP = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MMMM", "%B"), ("MMM", "%b"),
    ("MM", "%m"), ("M", "%-m"), ("dd", "%d"), ("d", "%-d"),
    ("EEEE", "%A"), ("EEE", "%a"), ("HH", "%H"), ("H", "%-H"),
    ("hh", "%I"), ("mm", "%M"), ("m", "%-M"), ("ss", "%S"), ("s", "%-S"),
    ("a", "%p"), ("DDD", "%j"),
]

_MYSQL_MAP = {
    "%Y": "%Y", "%y": "%y", "%M": "%B", "%b": "%b", "%m": "%m",
    "%c": "%-m", "%d": "%d", "%e": "%-d", "%H": "%H", "%k": "%-H",
    "%h": "%I", "%i": "%M", "%s": "%S", "%S": "%S", "%W": "%A",
    "%a": "%a", "%j": "%j", "%p": "%p", "%T": "%H:%M:%S", "%%": "%%",
}


def _joda_to_strftime(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        if pattern[i] == "'":
            j = pattern.find("'", i + 1)
            if j < 0:
                out.append(pattern[i + 1 :])
                break
            out.append(pattern[i + 1 : j].replace("%", "%%"))
            i = j + 1
            continue
        for tok, rep in _JODA_MAP:
            if pattern.startswith(tok, i):
                out.append(rep)
                i += len(tok)
                break
        else:
            out.append(pattern[i].replace("%", "%%"))
            i += 1
    return "".join(out)


def _mysql_to_strftime(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        if pattern[i] == "%" and i + 1 < len(pattern):
            tok = pattern[i : i + 2]
            out.append(_MYSQL_MAP.get(tok, tok))
            i += 2
        else:
            out.append(pattern[i].replace("%", "%%"))
            i += 1
    return "".join(out)


def _strftime(dt: datetime.datetime, fmt: str) -> str:
    # "%-m"-style (no zero pad) is GNU-only; emulate portably
    def repl(m):
        val = {
            "m": dt.month, "d": dt.day, "H": dt.hour, "M": dt.minute,
            "S": dt.second,
        }[m.group(1)]
        return str(val)

    fmt = re.sub(r"%-([mdHMS])", repl, fmt)
    return dt.strftime(fmt)


def lower_datetime_format_calls(expr, columns):
    """Rewrite format_datetime/date_format Calls (at any nesting depth)
    into InputRefs to synthetic rendered columns (appended to ``columns``,
    mutated) — the same shape as strings.lower_string_calls, so nested
    uses like upper(format_datetime(..)) and WHERE predicates work."""
    from trino_tpu_torch.compiler import ExprCompiler
    from trino_tpu_torch.ir import Call, SpecialForm, input_ref

    def walk(e):
        if isinstance(e, Call):
            args = tuple(walk(a) for a in e.args)
            e = Call(type=e.type, name=e.name, args=args)
            if e.name in ("format_datetime", "date_format"):
                device = columns[0].data.device if columns else "cpu"
                data, valid = ExprCompiler(columns, device).evaluate(e.args[0])
                col = format_datetime_column(
                    data.cpu().numpy(),
                    valid.cpu().numpy(),
                    e.args[0].type,
                    str(e.args[1].value),
                    "joda" if e.name == "format_datetime" else "mysql",
                ).to(device)
                columns.append(col)
                return input_ref(len(columns) - 1, T.VARCHAR)
            return e
        if isinstance(e, SpecialForm):
            return SpecialForm(
                type=e.type, form=e.form, args=tuple(walk(a) for a in e.args)
            )
        return e

    try:
        return walk(expr)
    finally:
        # ``walk`` reaches itself and ``columns`` through its cell: a cycle
        # that would keep every column of the call alive until the cyclic
        # collector runs (see strings.lower_string_calls)
        del walk


def format_datetime_column(
    data: np.ndarray,
    valid: np.ndarray,
    src_type: T.SqlType,
    pattern: str,
    dialect: str,
) -> Column:
    """Render a DATE/TIMESTAMP column to a dictionary varchar column."""
    fmt = (
        _joda_to_strftime(pattern)
        if dialect == "joda"
        else _mysql_to_strftime(pattern)
    )
    uniq, inverse = np.unique(np.asarray(data), return_inverse=True)
    epoch = datetime.datetime(1970, 1, 1)
    values = []
    for u in uniq:
        if isinstance(src_type, T.DateType):
            dt = epoch + datetime.timedelta(days=int(u))
        else:
            dt = epoch + datetime.timedelta(microseconds=int(u))
        values.append(_strftime(dt, fmt))
    d, codes0 = Dictionary.from_strings(values)
    codes = np.asarray(codes0)[inverse].astype(np.int32)
    v = np.asarray(valid)
    codes = np.where(v, codes, -1).astype(np.int32)
    return Column(
        T.VARCHAR, as_tensor(codes), None if v.all() else as_tensor(v), d
    )
