"""String function lowering: dictionary-transform execution.

Reference: ``operator/scalar/StringFunctions.java:71-86`` (upper/lower/trim/
substr/replace/concat/strpos/...). The port's copy of
``trino_tpu/strings.py``.

VARCHAR columns are dictionary-encoded (int32 codes in a tensor + a host
dictionary, see :mod:`trino_tpu_torch.columnar`). A string->string scalar
function therefore maps the *dictionary values* on the host (O(|dict|)
Python work) and keeps the code tensor; only when two values collapse into
one (``upper('a') == upper('A')``) are the codes remapped, by one gather on
the column's device. String->numeric functions (length, strpos,
starts_with) become per-code lookup tables gathered on the device
(:mod:`trino_tpu_torch.compiler`).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Column, Dictionary, as_tensor
from trino_tpu_torch.ir import Call, Constant, InputRef, RowExpr, SpecialForm, input_ref

_CROSS_DICT_CAP = 1 << 18


def _substr(s: str, start: int, length: Optional[int] = None) -> str:
    # Trino SUBSTR semantics: 1-based; negative counts from the end; 0 -> ''
    if start == 0:
        return ""
    if start > 0:
        out = s[start - 1 :]
    else:
        out = s[start:] if -start <= len(s) else ""
    if length is not None:
        out = out[: max(length, 0)]
    return out


def _replace(s: str, search: str, repl: str) -> str:
    if search == "":
        return s  # Trino: empty search returns the string unchanged
    return s.replace(search, repl)


def _lpad(s: str, size: int, pad: str) -> str:
    if size <= len(s):
        return s[:size]
    fill = (pad * ((size - len(s)) // max(len(pad), 1) + 1))[: size - len(s)]
    return fill + s


def _rpad(s: str, size: int, pad: str) -> str:
    if size <= len(s):
        return s[:size]
    fill = (pad * ((size - len(s)) // max(len(pad), 1) + 1))[: size - len(s)]
    return s + fill


def _split_part(s: str, delim: str, index: int) -> str:
    if delim == "":
        return ""
    parts = s.split(delim)
    return parts[index - 1] if 1 <= index <= len(parts) else ""


def _repeat(s: str, k: int) -> str:
    return s * int(k)


def _unary_fn(name: str) -> Callable[[str], str]:
    return {
        "upper": str.upper,
        "lower": str.lower,
        "trim": str.strip,
        "ltrim": str.lstrip,
        "rtrim": str.rstrip,
        "reverse": lambda s: s[::-1],
    }[name]


STRING_TRANSFORMS = {
    "upper", "lower", "trim", "ltrim", "rtrim", "reverse",
    "substr", "replace", "lpad", "rpad", "split_part", "concat", "repeat",
    "regexp_replace", "regexp_extract",
    "json_extract_scalar", "json_extract",
}


_JSON_SEGMENT = __import__("re").compile(
    r"\.(?P<key>[A-Za-z_][A-Za-z0-9_]*)|\[(?P<idx>\d+)\]|\[\"(?P<qkey>[^\"]+)\"\]"
)


def _json_path_get(doc, path: str):
    """Walk a $.a.b[1] JSON path. Returns (found, value). The path must
    parse completely — garbage segments yield not-found, never a parent
    value."""
    if not path.startswith("$"):
        return False, None
    cur = doc
    pos = 1
    while pos < len(path):
        m = _JSON_SEGMENT.match(path, pos)
        if m is None:
            return False, None  # invalid path segment
        pos = m.end()
        key = m.group("key") or m.group("qkey")
        if key is not None:
            if not isinstance(cur, dict) or key not in cur:
                return False, None
            cur = cur[key]
        else:
            i = int(m.group("idx"))
            if not isinstance(cur, list) or i >= len(cur):
                return False, None
            cur = cur[i]
    return True, cur


def _const_args(args) -> list:
    out = []
    for a in args:
        if not isinstance(a, Constant) or a.value is None:
            raise NotImplementedError(
                "string function arguments beyond the first must be literals"
            )
        v = a.value
        if isinstance(a.type, T.DecimalType):
            v = v // a.type.unscale
        out.append(v)
    return out


def transformed_column(base: Column, new_values: list[Optional[str]]) -> Column:
    """Column with same rows but transformed dictionary values. Duplicate
    values after transformation (upper('a')==upper('A')) are deduplicated
    with a device-side code remap so group-by/join-by-code stays correct.
    A ``None`` dictionary value (e.g. regexp_extract no-match) maps its
    rows to NULL (code -1, valid cleared)."""
    has_null = any(v is None for v in new_values)
    if not has_null and len(set(new_values)) == len(new_values):
        return Column(T.VARCHAR, base.data, base.valid, Dictionary(new_values))
    uniq: list[str] = []
    index: dict[str, int] = {}
    remap = np.empty(len(new_values), dtype=np.int32)
    for i, v in enumerate(new_values):
        if v is None:
            remap[i] = -1
            continue
        code = index.get(v)
        if code is None:
            code = len(uniq)
            index[v] = code
            uniq.append(v)
        remap[i] = code
    r = as_tensor(remap, base.data.device)
    codes = torch.where(
        base.data >= 0, r[base.data.clamp(min=0).long()], -1
    ).to(torch.int32)
    valid = base.valid_mask() & (codes >= 0) if has_null else base.valid
    d = Dictionary(uniq)
    d._index = index
    return Column(T.VARCHAR, codes, valid, d)


def lower_string_calls(expr: RowExpr, columns: list[Column]) -> RowExpr:
    """Rewrite string->string Calls into InputRefs to synthetic
    dictionary-transformed columns (appended to ``columns``, mutated).
    Bottom-up, so ``upper(trim(x))`` chains compose on the host."""

    def add_column(col: Column) -> InputRef:
        columns.append(col)
        return input_ref(len(columns) - 1, T.VARCHAR)

    def walk(e: RowExpr) -> RowExpr:
        if isinstance(e, Call):
            args = tuple(walk(a) for a in e.args)
            e = Call(type=e.type, name=e.name, args=args)
            if e.name in STRING_TRANSFORMS and T.is_string(e.type):
                return lower_one(e)
            return e
        if isinstance(e, SpecialForm):
            return SpecialForm(
                type=e.type, form=e.form, args=tuple(walk(a) for a in e.args)
            )
        return e

    def lower_one(e: Call) -> RowExpr:
        name = e.name
        if name == "concat":
            return lower_concat(e)
        base = e.args[0]
        if isinstance(base, Constant):
            # constant folding on the host
            if base.value is None:
                return Constant(type=T.VARCHAR, value=None)
            v = str(base.value)
            rest = _const_args(e.args[1:])
            return Constant(type=T.VARCHAR, value=_apply(name, v, rest))
        if not isinstance(base, InputRef):
            raise NotImplementedError(f"{name} over non-column expression")
        col = columns[base.channel]
        d = col.dictionary or Dictionary([])
        rest = _const_args(e.args[1:])
        new_values = [_apply(name, v, rest) for v in d.values]
        return add_column(transformed_column(col, new_values))

    def _coalesce_to_ref(a: RowExpr) -> RowExpr:
        """COALESCE(string_col, 'const') -> synthetic column with the
        constant folded into the dictionary (nulls remapped to its code)."""
        if not (
            isinstance(a, SpecialForm)
            and a.form == "coalesce"
            and len(a.args) == 2
            and isinstance(a.args[0], InputRef)
            and isinstance(a.args[1], Constant)
            and a.args[1].value is not None
        ):
            return a
        col = columns[a.args[0].channel]
        d = col.dictionary or Dictionary([])
        fill = str(a.args[1].value)
        values = list(d.values)
        try:
            fill_code = values.index(fill)
        except ValueError:
            fill_code = len(values)
            values = values + [fill]
        valid = col.valid_mask() & (col.data >= 0)
        codes = torch.where(valid, col.data.clamp(min=0), fill_code).to(
            torch.int32
        )
        return add_column(Column(T.VARCHAR, codes, None, Dictionary(values)))

    def lower_concat(e: Call) -> RowExpr:
        parts = []  # "const" str | ("ref", channel)
        channels: list[int] = []
        any_null_const = False
        for a in e.args:
            a = _coalesce_to_ref(a)
            if isinstance(a, Constant):
                if a.value is None:
                    any_null_const = True
                parts.append(str(a.value) if a.value is not None else "")
            elif isinstance(a, InputRef):
                parts.append(("ref", a.channel))
                if a.channel not in channels:
                    channels.append(a.channel)
            else:
                raise NotImplementedError("concat over complex expression")
        if any_null_const:
            return Constant(type=T.VARCHAR, value=None)
        if not channels:
            return Constant(type=T.VARCHAR, value="".join(parts))
        if len(channels) == 1:
            ch = channels[0]
            col = columns[ch]
            d = col.dictionary or Dictionary([])
            new_values = [
                "".join(p if isinstance(p, str) else v for p in parts)
                for v in d.values
            ]
            return add_column(transformed_column(col, new_values))
        if len(channels) == 2:
            ca, cb = columns[channels[0]], columns[channels[1]]
            da = ca.dictionary or Dictionary([])
            db = cb.dictionary or Dictionary([])
            if max(len(da), 1) * max(len(db), 1) > _CROSS_DICT_CAP:
                # big cross (name x name): materialize per ROW instead of
                # per dictionary pair — O(rows) host work, bounded output
                codes_a = ca.data.cpu().numpy()
                codes_b = cb.data.cpu().numpy()
                valid = (ca.valid_mask() & cb.valid_mask()).cpu().numpy() & (
                    codes_a >= 0
                ) & (codes_b >= 0)
                row_strings = []
                for i in range(len(codes_a)):
                    if not valid[i]:
                        row_strings.append("")
                        continue
                    va = da.decode(int(codes_a[i])) or ""
                    vb = db.decode(int(codes_b[i])) or ""
                    row_strings.append(
                        "".join(
                            p
                            if isinstance(p, str)
                            else (va if p[1] == channels[0] else vb)
                            for p in parts
                        )
                    )
                d, codes = Dictionary.from_strings(row_strings)
                codes = np.where(valid, codes, -1).astype(np.int32)
                dev = ca.data.device
                return add_column(Column(T.VARCHAR, as_tensor(codes, dev),
                                         as_tensor(valid, dev), d))
            values = []
            for va in da.values:
                for vb in db.values:
                    values.append(
                        "".join(
                            p
                            if isinstance(p, str)
                            else (va if p[1] == channels[0] else vb)
                            for p in parts
                        )
                    )
            nb = max(len(db), 1)
            codes = ca.data.clamp(min=0) * nb + cb.data.clamp(min=0)
            valid = ca.valid_mask() & cb.valid_mask() & (ca.data >= 0) & (cb.data >= 0)
            return add_column(
                Column(T.VARCHAR, codes.to(torch.int32), valid, Dictionary(values))
            )
        raise NotImplementedError("concat over >2 distinct string columns")

    def _apply(name: str, v: str, rest: list) -> str:
        if name in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse"):
            return _unary_fn(name)(v)
        if name == "substr":
            return _substr(v, int(rest[0]), int(rest[1]) if len(rest) > 1 else None)
        if name == "replace":
            return _replace(v, str(rest[0]), str(rest[1]) if len(rest) > 1 else "")
        if name == "lpad":
            return _lpad(v, int(rest[0]), str(rest[1]) if len(rest) > 1 else " ")
        if name == "rpad":
            return _rpad(v, int(rest[0]), str(rest[1]) if len(rest) > 1 else " ")
        if name == "split_part":
            return _split_part(v, str(rest[0]), int(rest[1]))
        if name == "repeat":
            return _repeat(v, int(rest[0]))
        if name == "regexp_replace":
            import re as _re

            repl = str(rest[1]) if len(rest) > 1 else ""
            # Trino replacement uses $N group refs; Python uses \\N.
            # Escape literal backslashes, convert $N, leave lone $ literal.
            py_repl = repl.replace("\\", "\\\\")
            py_repl = _re.sub(r"\$(\d+)", r"\\\1", py_repl)
            return _re.sub(str(rest[0]), py_repl, v)
        if name in ("json_extract_scalar", "json_extract"):
            import json as _json

            try:
                doc = _json.loads(v)
            except ValueError:
                return None
            found, out = _json_path_get(doc, str(rest[0]))
            if not found:
                return None
            if name == "json_extract":
                return _json.dumps(out, separators=(",", ":"))
            # scalar: NULL for objects/arrays (reference semantics)
            if isinstance(out, (dict, list)):
                return None
            if out is None:
                return None
            if isinstance(out, bool):
                return "true" if out else "false"
            return str(out)
        if name == "regexp_extract":
            import re as _re

            # Reference semantics: NULL on no match and for a
            # non-participating group (not empty string).
            m = _re.search(str(rest[0]), v)
            if m is None:
                return None
            group = int(rest[1]) if len(rest) > 1 else 0
            return m.group(group)
        raise AssertionError(name)

    return walk(expr)
