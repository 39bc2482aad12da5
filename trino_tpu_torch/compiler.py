"""Expression compiler: RowExpr IR -> torch ops with SQL NULL semantics.

The analog of Trino's bytecode codegen tier
(``core/trino-main/src/main/java/io/trino/sql/gen/ExpressionCompiler.java:56``):
the IR is evaluated over a batch's column tensors, eagerly, on the
batch's device. Every expression evaluates to a pair ``(data, valid)`` of
tensors (SQL three-valued logic).

This is the subset of ``trino_tpu/compiler.py`` the ported query path
needs: column references, literals, comparisons, ``+ - *`` and negation
on numeric types, numeric casts, AND/OR/NOT (Kleene logic), IS NULL,
IF, COALESCE, IN and BETWEEN. Any other expression raises
:class:`NotImplementedError` naming it.

Reference semantics kept: integer ``+ - *`` raise on overflow instead of
wrapping (Trino's "integer overflow"); comparisons of mixed numeric types
run in their common super type.
"""

from __future__ import annotations

from typing import Sequence

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Column, torch_dtype
from trino_tpu_torch.ir import (
    Call,
    Constant,
    InputRef,
    RowExpr,
    SpecialForm,
)

Pair = tuple[torch.Tensor, torch.Tensor]  # (data, valid)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to trino_tpu_torch")


def _numeric(t: T.SqlType) -> bool:
    return isinstance(
        t, (T.IntegerLikeType, T.DoubleType, T.RealType, T.BooleanType)
    )


class ExprCompiler:
    """Evaluates a RowExpr tree over a batch's columns."""

    def __init__(self, columns: Sequence[Column], device):
        self.columns = list(columns)
        self.n = self.columns[0].capacity if self.columns else 1
        self.device = torch.device(device)

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
        if isinstance(expr, Constant):
            return self._constant(expr.type, expr.value)
        if isinstance(expr, SpecialForm):
            return self._special(expr)
        if isinstance(expr, Call):
            return self._call(expr)
        raise TypeError(f"unknown IR node {expr!r}")

    def _constant(self, t: T.SqlType, value) -> Pair:
        if value is None:
            dt = torch_dtype(t.storage_dtype)
            return (
                torch.zeros(self.n, dtype=dt, device=self.device),
                torch.zeros(self.n, dtype=torch.bool, device=self.device),
            )
        if not _numeric(t):
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
            data = torch.where(take_then, then[0], other[0].to(then[0].dtype))
            valid = torch.where(take_then, then[1], other[1])
            return data, valid
        if form == "coalesce":
            data, valid = self._eval(expr.args[0])
            for a in expr.args[1:]:
                d2, v2 = self._eval(a)
                data = torch.where(valid, data, d2.to(data.dtype))
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
        raise _not_ported(f"special form {form!r}")

    # -- calls ------------------------------------------------------------
    def _call(self, expr: Call) -> Pair:
        name = expr.name
        if name in ("add", "subtract", "multiply"):
            return self._arith(expr)
        if name in ("eq", "ne", "lt", "le", "gt", "ge"):
            return self._compare(expr)
        if name == "negate" and _numeric(expr.type):
            d, v = self._eval(expr.args[0])
            return -d, v
        if name == "cast" and _numeric(expr.type) and _numeric(expr.args[0].type):
            d, v = self._eval(expr.args[0])
            return _cast_numeric(d, expr.args[0].type, expr.type), v
        raise _not_ported(f"function {name!r} over {expr.type.name}")

    def _arith(self, expr: Call) -> Pair:
        a_t, b_t = expr.args[0].type, expr.args[1].type
        rt = expr.type
        if not (_numeric(rt) and _numeric(a_t) and _numeric(b_t)):
            raise _not_ported(f"{expr.name} over {rt.name}")
        a, b = self._eval(expr.args[0]), self._eval(expr.args[1])
        valid = a[1] & b[1]
        ad = _cast_numeric(a[0], a_t, rt)
        bd = _cast_numeric(b[0], b_t, rt)
        if T.is_integer(rt):
            # compute in int64 and range-check: the reference raises
            # "integer overflow" instead of wrapping
            a64, b64 = ad.to(torch.int64), bd.to(torch.int64)
            r64 = {"add": torch.add, "subtract": torch.sub,
                   "multiply": torch.mul}[expr.name](a64, b64)
            _check_int_overflow(expr.name, rt, a64, b64, r64, valid)
            return r64.to(torch_dtype(rt.storage_dtype)), valid
        op = {"add": torch.add, "subtract": torch.sub, "multiply": torch.mul}
        return op[expr.name](ad, bd), valid

    def _compare(self, expr: Call) -> Pair:
        a_e, b_e = expr.args
        a_t, b_t = a_e.type, b_e.type
        if not (_numeric(a_t) and _numeric(b_t)):
            raise _not_ported(f"comparison of {a_t.name} with {b_t.name}")
        a, b = self._eval(a_e), self._eval(b_e)
        ct = T.common_super_type(a_t, b_t) or a_t
        ad = _cast_numeric(a[0], a_t, ct)
        bd = _cast_numeric(b[0], b_t, ct)
        return _cmp_op(expr.name, ad, bd), a[1] & b[1]


def _check_int_overflow(name, rt, a64, b64, r64, valid):
    """Raise on integer overflow like the reference."""
    if rt.bits < 64:
        info = torch.iinfo(torch_dtype(rt.storage_dtype))
        bad = valid & ((r64 < info.min) | (r64 > info.max))
    elif name == "multiply":
        # the product wrapped iff dividing it back misses the operand;
        # b = -1 is checked apart (MIN / -1 itself overflows)
        plain = (b64 != 0) & (b64 != -1)
        safe_b = torch.where(plain, b64, torch.ones_like(b64))
        wrapped = plain & (torch.div(r64, safe_b, rounding_mode="trunc") != a64)
        wrapped |= (b64 == -1) & (a64 == torch.iinfo(torch.int64).min)
        bad = valid & wrapped
    else:
        same_sign = (a64 >= 0) == ((b64 >= 0) if name == "add" else (b64 < 0))
        bad = valid & same_sign & ((r64 >= 0) != (a64 >= 0))
    if bool(bad.any()):
        raise ArithmeticError(f"{rt.name} overflow")


def _cmp_op(name: str, a, b):
    return {
        "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
        "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    }[name](a, b)


def _cast_numeric(data, from_t: T.SqlType, to_t: T.SqlType):
    if from_t == to_t:
        return data
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
