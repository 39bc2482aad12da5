"""Expression compiler: RowExpr IR -> torch ops with SQL NULL semantics.

The analog of Trino's bytecode codegen tier
(``core/trino-main/src/main/java/io/trino/sql/gen/ExpressionCompiler.java:56``):
the IR is evaluated over a batch's column tensors, eagerly, on the
batch's device. Every expression evaluates to a pair ``(data, valid)`` of
tensors (SQL three-valued logic).

This is the subset of ``trino_tpu/compiler.py`` the ported query path
needs: column references; numeric, DECIMAL and DATE literals (DECIMAL
literals past int64 as wide (n, 2) lanes); comparisons across numeric
types, DECIMAL scales and widths, and of DATEs; ``+ - * / %`` and
negation, with DECIMAL rescaling and 128-bit lanes
(``ops/decimal128.py``); casts among DECIMAL, the integers and DOUBLE;
AND/OR/NOT (Kleene logic), IS NULL, IF, COALESCE, IN and BETWEEN, over
wide operands too. Any other expression (VARCHAR functions and
comparisons, LIKE, ``extract``) raises :class:`NotImplementedError`
naming it.

Reference semantics kept: integer ``+ - *`` raise on overflow instead of
wrapping (Trino's "integer overflow"); division by zero gives NULL (the
reference's documented deviation); DECIMAL division and downscaling
round half up; comparisons of mixed numeric types run in their common
super type.
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
        raise _not_ported("a DECIMAL(38) downscale")
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


def _wide_to_double(data, scale: int):
    lo = data[:, 1].to(torch.float64)
    lo_u = lo + torch.where(data[:, 1] < 0, 2.0**64, 0.0)
    return (data[:, 0].to(torch.float64) * 2.0**64 + lo_u) / (10**scale)


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
        raise _not_ported(f"special form {form!r}")

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
        if name == "date_add_days":
            d, v = self._eval(expr.args[0])
            delta, dv = self._eval(expr.args[1])
            return d + delta.to(d.dtype), v & dv
        raise _not_ported(f"function {name!r} over {expr.type.name}")

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
                raise _not_ported("DECIMAL(38) * DECIMAL(38)")
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
                out = d.to(torch.float64) / st.unscale
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
    if isinstance(from_t, T.DecimalType):
        if _is_float(to_t):
            dt = torch_dtype(to_t.storage_dtype)
            if _is_wide(data):
                return _wide_to_double(data, from_t.scale).to(dt)
            return (data.to(torch.float64) / from_t.unscale).to(dt)
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
