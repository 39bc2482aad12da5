"""Scalar expression IR — the input language of the TPU kernel compiler.

Reference: Trino lowers AST expressions to ``RowExpression`` with exactly six
node kinds (``core/trino-main/src/main/java/io/trino/sql/relational/RowExpression.java:18``,
``CallExpression.java:26``, ``ConstantExpression.java:22``,
``InputReferenceExpression.java:23``, ``VariableReferenceExpression.java:22``,
``LambdaDefinitionExpression.java:27``, ``SpecialForm.java:31``). We mirror
that shape: channel-positional inputs, resolved calls, and short-circuit
special forms. Where Trino generates JVM bytecode from this IR
(``sql/gen/ExpressionCompiler.java:56``), we trace it into jnp ops and let
XLA fuse (see :mod:`trino_tpu.compiler`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from trino_tpu_torch import types as T


@dataclasses.dataclass(frozen=True)
class RowExpr:
    type: T.SqlType


@dataclasses.dataclass(frozen=True)
class InputRef(RowExpr):
    """Reference to input channel (column index) — already columnar."""

    channel: int = 0

    def __repr__(self):
        return f"#{self.channel}:{self.type}"


@dataclasses.dataclass(frozen=True)
class Constant(RowExpr):
    """Literal; value is a Python scalar in *storage* representation
    (e.g. scaled int for decimals, days-since-epoch int for dates,
    raw string for varchar — encoded per-dictionary at compile time).
    None means typed NULL."""

    value: Any = None

    def __repr__(self):
        return f"lit({self.value}:{self.type})"


@dataclasses.dataclass(frozen=True)
class HoistedConstant(Constant):
    """A Constant lifted out of a cached plan into the query's ordered
    parameter vector (:mod:`trino_tpu.planner.canonicalize`). Mirrors how
    the reference binds constants as fields of generated classes so one
    compiled expression serves every literal (``sql/gen/
    ExpressionCompiler.java:94`` CacheKey over canonical RowExpressions).

    ``value`` keeps the planning-time literal so eager/interpreter paths
    (which bake constants) still work; a compiler given a parameter
    vector reads ``params[index]`` instead, letting literal variants of
    the same plan shape share one traced program. Serde intentionally
    drops ``value`` so variants serialize — and fingerprint — identically.
    """

    index: int = 0

    def __repr__(self):
        return f"param[{self.index}]({self.value}:{self.type})"


@dataclasses.dataclass(frozen=True)
class Variable(RowExpr):
    """Named symbol reference (resolved to a channel by the physical
    planner). Mirrors ``VariableReferenceExpression.java:22``."""

    name: str = ""

    def __repr__(self):
        return f"${self.name}:{self.type}"


@dataclasses.dataclass(frozen=True)
class Call(RowExpr):
    """Resolved scalar function call. ``name`` indexes the function catalog
    (:mod:`trino_tpu.functions`)."""

    name: str = ""
    args: tuple[RowExpr, ...] = ()

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class SpecialForm(RowExpr):
    """Short-circuit forms: AND, OR, IF, COALESCE, IN, BETWEEN, IS_NULL,
    NULL_IF, SWITCH (searched CASE is desugared to nested IF)."""

    form: str = ""
    args: tuple[RowExpr, ...] = ()

    def __repr__(self):
        return f"{self.form}[{', '.join(map(repr, self.args))}]"


def input_ref(channel: int, type_: T.SqlType) -> InputRef:
    return InputRef(type=type_, channel=channel)


def variable(name: str, type_: T.SqlType) -> Variable:
    return Variable(type=type_, name=name)


def const(value: Any, type_: T.SqlType) -> Constant:
    return Constant(type=type_, value=value)


def call(name: str, type_: T.SqlType, *args: RowExpr) -> Call:
    return Call(type=type_, name=name, args=tuple(args))


def special(form: str, type_: T.SqlType, *args: RowExpr) -> SpecialForm:
    return SpecialForm(type=type_, form=form, args=tuple(args))


def referenced_channels(expr: RowExpr) -> set[int]:
    out: set[int] = set()

    def walk(e: RowExpr):
        if isinstance(e, InputRef):
            out.add(e.channel)
        elif isinstance(e, (Call, SpecialForm)):
            for a in e.args:
                walk(a)

    walk(expr)
    return out


def referenced_variables(expr: RowExpr) -> set[str]:
    out: set[str] = set()

    def walk(e: RowExpr):
        if isinstance(e, Variable):
            out.add(e.name)
        elif isinstance(e, (Call, SpecialForm)):
            for a in e.args:
                walk(a)

    walk(expr)
    return out


def transform(expr: RowExpr, fn) -> RowExpr:
    """Bottom-up rewrite: fn is applied to every node after its children."""

    def walk(e: RowExpr) -> RowExpr:
        if isinstance(e, Call):
            e = Call(type=e.type, name=e.name, args=tuple(walk(a) for a in e.args))
        elif isinstance(e, SpecialForm):
            e = SpecialForm(
                type=e.type, form=e.form, args=tuple(walk(a) for a in e.args)
            )
        return fn(e)

    return walk(expr)


def remap_channels(expr: RowExpr, mapping: dict[int, int]) -> RowExpr:
    """Rewrite input channels (used when pruning/reordering columns)."""

    def fn(e: RowExpr) -> RowExpr:
        if isinstance(e, InputRef):
            return InputRef(type=e.type, channel=mapping[e.channel])
        return e

    return transform(expr, fn)


def bind_variables(expr: RowExpr, channels: dict[str, int]) -> RowExpr:
    """Replace Variables with channel InputRefs (physical planning)."""

    def fn(e: RowExpr) -> RowExpr:
        if isinstance(e, Variable):
            return InputRef(type=e.type, channel=channels[e.name])
        return e

    return transform(expr, fn)
