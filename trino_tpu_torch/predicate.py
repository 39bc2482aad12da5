"""TupleDomain predicate algebra.

Reference: ``core/trino-spi/src/main/java/io/trino/spi/predicate/`` —
``Domain.java``, ``Range.java``, ``SortedRangeSet.java``, ``TupleDomain.java``,
translated from/to expressions by
``core/trino-main/src/main/java/io/trino/sql/planner/DomainTranslator.java``.

This algebra is shared by three engine features (as in the reference):
  1. scan pruning — skip splits whose min/max stats cannot satisfy the domain
     (``lib/trino-orc/.../TupleDomainOrcPredicate.java:74``);
  2. connector filter pushdown (``ConnectorMetadata.applyFilter``,
     ``iterative/rule/PushPredicateIntoTableScan.java``);
  3. dynamic filtering — build-side key domains shipped to probe-side scans
     (``server/DynamicFilterService.java:95``).

Values are Python scalars in *storage* representation (scaled ints for
decimals, day-ints for dates, raw ``str`` for varchar — comparable), so the
algebra is device-free: it runs on the coordinator/host, never inside jit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Sequence

from trino_tpu_torch import types as T
from trino_tpu_torch.ir import Call, Constant, RowExpr, SpecialForm, Variable, special


_NEG_INF = object()
_POS_INF = object()


def _lt(a: Any, b: Any) -> bool:
    if a is _NEG_INF or b is _POS_INF:
        return True
    if a is _POS_INF or b is _NEG_INF:
        return False
    return a < b


def _le(a: Any, b: Any) -> bool:
    return not _lt(b, a)


@dataclasses.dataclass(frozen=True)
class Range:
    """[low, high] interval with open/closed bounds; None bound = unbounded.

    Mirrors ``spi/predicate/Range.java`` (Marker low/high).
    """

    low: Any = None  # None = -inf
    low_inclusive: bool = False
    high: Any = None  # None = +inf
    high_inclusive: bool = False

    @staticmethod
    def all() -> "Range":
        return Range()

    @staticmethod
    def equal(value: Any) -> "Range":
        return Range(value, True, value, True)

    @staticmethod
    def greater_than(value: Any) -> "Range":
        return Range(low=value, low_inclusive=False)

    @staticmethod
    def greater_or_equal(value: Any) -> "Range":
        return Range(low=value, low_inclusive=True)

    @staticmethod
    def less_than(value: Any) -> "Range":
        return Range(high=value, high_inclusive=False)

    @staticmethod
    def less_or_equal(value: Any) -> "Range":
        return Range(high=value, high_inclusive=True)

    def _lo(self):
        return _NEG_INF if self.low is None else self.low

    def _hi(self):
        return _POS_INF if self.high is None else self.high

    @property
    def is_single_value(self) -> bool:
        return (
            self.low is not None
            and self.low == self.high
            and self.low_inclusive
            and self.high_inclusive
        )

    def is_empty(self) -> bool:
        lo, hi = self._lo(), self._hi()
        if _lt(hi, lo):
            return True
        if lo is not _NEG_INF and lo == hi and not (self.low_inclusive and self.high_inclusive):
            return True
        return False

    def contains_value(self, v: Any) -> bool:
        lo, hi = self._lo(), self._hi()
        if _lt(v, lo) or _lt(hi, v):
            return False
        if v == lo and not self.low_inclusive and lo is not _NEG_INF:
            return False
        if v == hi and not self.high_inclusive and hi is not _POS_INF:
            return False
        return True

    def overlaps(self, other: "Range") -> bool:
        return not self.intersect(other).is_empty()

    def intersect(self, other: "Range") -> "Range":
        # max of lows
        if _lt(self._lo(), other._lo()):
            low, low_inc = other.low, other.low_inclusive
        elif _lt(other._lo(), self._lo()):
            low, low_inc = self.low, self.low_inclusive
        else:
            low = self.low
            low_inc = self.low_inclusive and other.low_inclusive
        # min of highs
        if _lt(self._hi(), other._hi()):
            high, high_inc = self.high, self.high_inclusive
        elif _lt(other._hi(), self._hi()):
            high, high_inc = other.high, other.high_inclusive
        else:
            high = self.high
            high_inc = self.high_inclusive and other.high_inclusive
        return Range(low, low_inc, high, high_inc)

    def _adjacent(self, other: "Range") -> bool:
        """True if self ∪ other is a single contiguous range."""
        if self.overlaps(other):
            return True
        # self.high touches other.low or vice versa
        for a, b in ((self, other), (other, self)):
            if a.high is not None and b.low is not None and a.high == b.low:
                if a.high_inclusive or b.low_inclusive:
                    return True
        return False

    def span(self, other: "Range") -> "Range":
        if _lt(self._lo(), other._lo()):
            low, low_inc = self.low, self.low_inclusive
        elif _lt(other._lo(), self._lo()):
            low, low_inc = other.low, other.low_inclusive
        else:
            low = self.low
            low_inc = self.low_inclusive or other.low_inclusive
        if _lt(other._hi(), self._hi()):
            high, high_inc = self.high, self.high_inclusive
        elif _lt(self._hi(), other._hi()):
            high, high_inc = other.high, other.high_inclusive
        else:
            high = self.high
            high_inc = self.high_inclusive or other.high_inclusive
        return Range(low, low_inc, high, high_inc)


@dataclasses.dataclass(frozen=True)
class ValueSet:
    """Union of disjoint sorted ranges (``SortedRangeSet.java``), or ALL.

    ``ranges`` is normalized: sorted by low bound, non-overlapping,
    non-adjacent, none empty.
    """

    ranges: tuple[Range, ...] = ()
    is_all: bool = False

    @staticmethod
    def all() -> "ValueSet":
        return ValueSet(is_all=True)

    @staticmethod
    def none() -> "ValueSet":
        return ValueSet(())

    @staticmethod
    def of_values(values: Iterable[Any]) -> "ValueSet":
        return ValueSet.of_ranges([Range.equal(v) for v in values])

    @staticmethod
    def of_ranges(ranges: Sequence[Range]) -> "ValueSet":
        rs = [r for r in ranges if not r.is_empty()]
        if not rs:
            return ValueSet.none()
        rs.sort(key=lambda r: (0 if r.low is None else 1, r.low if r.low is not None else 0, not r.low_inclusive))
        merged: list[Range] = [rs[0]]
        for r in rs[1:]:
            if merged[-1]._adjacent(r):
                merged[-1] = merged[-1].span(r)
            else:
                merged.append(r)
        return ValueSet(tuple(merged))

    def is_none(self) -> bool:
        return not self.is_all and not self.ranges

    @property
    def is_single_value(self) -> bool:
        return len(self.ranges) == 1 and self.ranges[0].is_single_value

    def discrete_values(self) -> Optional[list[Any]]:
        """Values if the set is a finite list of points, else None."""
        if self.is_all:
            return None
        vals = []
        for r in self.ranges:
            if not r.is_single_value:
                return None
            vals.append(r.low)
        return vals

    def contains_value(self, v: Any) -> bool:
        if self.is_all:
            return True
        return any(r.contains_value(v) for r in self.ranges)

    def intersect(self, other: "ValueSet") -> "ValueSet":
        if self.is_all:
            return other
        if other.is_all:
            return self
        out = []
        for a in self.ranges:
            for b in other.ranges:
                c = a.intersect(b)
                if not c.is_empty():
                    out.append(c)
        return ValueSet.of_ranges(out)

    def union(self, other: "ValueSet") -> "ValueSet":
        if self.is_all or other.is_all:
            return ValueSet.all()
        return ValueSet.of_ranges(list(self.ranges) + list(other.ranges))

    def overlaps(self, other: "ValueSet") -> bool:
        return not self.intersect(other).is_none()

    def span(self) -> Optional[Range]:
        if self.is_all or not self.ranges:
            return None
        out = self.ranges[0]
        for r in self.ranges[1:]:
            out = out.span(r)
        return out


@dataclasses.dataclass(frozen=True)
class Domain:
    """ValueSet + null admissibility (``spi/predicate/Domain.java``)."""

    values: ValueSet
    null_allowed: bool = False
    type: Optional[T.SqlType] = None

    @staticmethod
    def all(type_: Optional[T.SqlType] = None) -> "Domain":
        return Domain(ValueSet.all(), True, type_)

    @staticmethod
    def none(type_: Optional[T.SqlType] = None) -> "Domain":
        return Domain(ValueSet.none(), False, type_)

    @staticmethod
    def only_null(type_: Optional[T.SqlType] = None) -> "Domain":
        return Domain(ValueSet.none(), True, type_)

    @staticmethod
    def not_null(type_: Optional[T.SqlType] = None) -> "Domain":
        return Domain(ValueSet.all(), False, type_)

    @staticmethod
    def single_value(v: Any, type_: Optional[T.SqlType] = None) -> "Domain":
        return Domain(ValueSet.of_values([v]), False, type_)

    @staticmethod
    def of_values(vs: Iterable[Any], type_: Optional[T.SqlType] = None) -> "Domain":
        return Domain(ValueSet.of_values(vs), False, type_)

    def is_all(self) -> bool:
        return self.values.is_all and self.null_allowed

    def is_none(self) -> bool:
        return self.values.is_none() and not self.null_allowed

    def intersect(self, other: "Domain") -> "Domain":
        return Domain(
            self.values.intersect(other.values),
            self.null_allowed and other.null_allowed,
            self.type or other.type,
        )

    def union(self, other: "Domain") -> "Domain":
        return Domain(
            self.values.union(other.values),
            self.null_allowed or other.null_allowed,
            self.type or other.type,
        )

    def contains(self, v: Any) -> bool:
        if v is None:
            return self.null_allowed
        return self.values.contains_value(v)

    def overlaps_stats(self, min_v: Any, max_v: Any, has_null: bool = False) -> bool:
        """Can any value in [min_v, max_v] (± null) satisfy this domain?
        The split/stripe pruning test (``TupleDomainOrcPredicate.java:92``)."""
        if self.is_none():
            return False
        if has_null and self.null_allowed:
            return True
        if min_v is None or max_v is None:  # no stats -> cannot prune
            return True
        stats = ValueSet.of_ranges([Range(min_v, True, max_v, True)])
        return self.values.overlaps(stats)


@dataclasses.dataclass(frozen=True)
class TupleDomain:
    """Conjunction of per-column Domains; ``domains is None`` = NONE
    (contradiction). Mirrors ``spi/predicate/TupleDomain.java``."""

    domains: Optional[dict[str, Domain]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.domains is not None:
            # normalize: drop ALL domains; collapse to NONE on any none()
            d = {k: v for k, v in self.domains.items() if not v.is_all()}
            if any(v.is_none() for v in d.values()):
                object.__setattr__(self, "domains", None)
            else:
                object.__setattr__(self, "domains", d)

    @staticmethod
    def all() -> "TupleDomain":
        return TupleDomain({})

    @staticmethod
    def none() -> "TupleDomain":
        return TupleDomain(None)

    def is_all(self) -> bool:
        return self.domains is not None and not self.domains

    def is_none(self) -> bool:
        return self.domains is None

    def domain(self, column: str) -> Domain:
        if self.domains is None:
            return Domain.none()
        return self.domains.get(column, Domain.all())

    def intersect(self, other: "TupleDomain") -> "TupleDomain":
        if self.is_none() or other.is_none():
            return TupleDomain.none()
        out = dict(self.domains)
        for k, v in other.domains.items():
            out[k] = out[k].intersect(v) if k in out else v
        return TupleDomain(out)

    def column_wise_union(self, other: "TupleDomain") -> "TupleDomain":
        """Loose union: per-column union for columns in BOTH (others drop to
        ALL). Sound over-approximation (``TupleDomain.columnWiseUnion``)."""
        if self.is_none():
            return other
        if other.is_none():
            return self
        out = {}
        for k in set(self.domains) & set(other.domains):
            out[k] = self.domains[k].union(other.domains[k])
        return TupleDomain(out)

    def overlaps_stats(self, stats: dict[str, tuple[Any, Any, bool]]) -> bool:
        """stats: column -> (min, max, has_null). Missing column = no stats."""
        if self.is_none():
            return False
        for col, dom in self.domains.items():
            if col in stats:
                mn, mx, hn = stats[col]
                if not dom.overlaps_stats(mn, mx, hn):
                    return False
        return True


# === expression <-> domain translation =====================================
# Reference: sql/planner/DomainTranslator.java (fromPredicate / toPredicate)

_COMPARISONS = {"eq", "ne", "lt", "le", "gt", "ge"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}


@dataclasses.dataclass
class ExtractionResult:
    """Mirrors DomainTranslator.ExtractionResult: the extracted TupleDomain
    plus the conjuncts it could NOT express (to keep as a residual filter)."""

    tuple_domain: TupleDomain
    remaining: list[RowExpr]


def extract_tuple_domain(conjuncts: Sequence[RowExpr]) -> ExtractionResult:
    td = TupleDomain.all()
    remaining: list[RowExpr] = []
    for c in conjuncts:
        sub = _extract_one(c)
        if sub is None:
            remaining.append(c)
        else:
            td = td.intersect(sub)
    return ExtractionResult(td, remaining)


def _as_var_const(e: RowExpr) -> Optional[tuple[Variable, Any, str]]:
    """Match  var OP const  or  const OP var  -> (var, value, op)."""
    if not (isinstance(e, Call) and e.name in _COMPARISONS and len(e.args) == 2):
        return None
    a, b = e.args
    if isinstance(a, Variable) and isinstance(b, Constant):
        return (a, b.value, e.name)
    if isinstance(a, Constant) and isinstance(b, Variable):
        return (b, a.value, _FLIP[e.name])
    return None


def _extract_one(e: RowExpr) -> Optional[TupleDomain]:
    # comparisons
    m = _as_var_const(e)
    if m is not None:
        var, value, op = m
        if value is None:
            return TupleDomain.none()  # x <op> NULL is never true
        if op == "eq":
            dom = Domain(ValueSet.of_values([value]), False, var.type)
        elif op == "ne":
            dom = Domain(
                ValueSet.of_ranges([Range.less_than(value), Range.greater_than(value)]),
                False,
                var.type,
            )
        elif op == "lt":
            dom = Domain(ValueSet.of_ranges([Range.less_than(value)]), False, var.type)
        elif op == "le":
            dom = Domain(ValueSet.of_ranges([Range.less_or_equal(value)]), False, var.type)
        elif op == "gt":
            dom = Domain(ValueSet.of_ranges([Range.greater_than(value)]), False, var.type)
        else:  # ge
            dom = Domain(ValueSet.of_ranges([Range.greater_or_equal(value)]), False, var.type)
        return TupleDomain({var.name: dom})

    if isinstance(e, SpecialForm):
        if e.form == "is_null" and len(e.args) == 1 and isinstance(e.args[0], Variable):
            v = e.args[0]
            return TupleDomain({v.name: Domain.only_null(v.type)})
        if e.form == "not" and len(e.args) == 1:
            inner = e.args[0]
            if (
                isinstance(inner, SpecialForm)
                and inner.form == "is_null"
                and len(inner.args) == 1
                and isinstance(inner.args[0], Variable)
            ):
                v = inner.args[0]
                return TupleDomain({v.name: Domain.not_null(v.type)})
            return None
        if e.form == "in" and e.args and isinstance(e.args[0], Variable):
            v = e.args[0]
            vals = []
            for a in e.args[1:]:
                if not isinstance(a, Constant):
                    return None
                if a.value is None:
                    continue  # NULL in the list can't make IN true for extraction
                vals.append(a.value)
            if not vals:
                return TupleDomain.none()
            return TupleDomain({v.name: Domain.of_values(vals, v.type)})
        if e.form == "between" and len(e.args) == 3 and isinstance(e.args[0], Variable):
            v, lo, hi = e.args
            if isinstance(lo, Constant) and isinstance(hi, Constant):
                if lo.value is None or hi.value is None:
                    return TupleDomain.none()
                return TupleDomain(
                    {v.name: Domain(
                        ValueSet.of_ranges([Range(lo.value, True, hi.value, True)]),
                        False,
                        v.type,
                    )}
                )
            return None
        if e.form == "and":
            out = TupleDomain.all()
            for a in e.args:
                sub = _extract_one(a)
                if sub is None:
                    return None
                out = out.intersect(sub)
            return out
        if e.form == "or":
            # OR of single-column constraints -> column-wise union only when
            # every branch constrains exactly the same one column (sound).
            subs = []
            for a in e.args:
                sub = _extract_one(a)
                if sub is None or sub.is_none() or sub.is_all() or len(sub.domains) != 1:
                    return None
                subs.append(sub)
            cols = {next(iter(s.domains)) for s in subs}
            if len(cols) != 1:
                return None
            out = subs[0]
            for s in subs[1:]:
                out = out.column_wise_union(s)
            return out
    return None


def to_row_expr(td: TupleDomain, types: dict[str, T.SqlType]) -> Optional[RowExpr]:
    """TupleDomain -> predicate expression (DomainTranslator.toPredicate).
    Returns None for ALL; a FALSE constant for NONE."""
    if td.is_all():
        return None
    if td.is_none():
        return Constant(type=T.BOOLEAN, value=False)
    conj: list[RowExpr] = []
    for col, dom in td.domains.items():
        ty = dom.type or types.get(col, T.BIGINT)
        var = Variable(type=ty, name=col)
        conj.append(_domain_to_expr(var, dom))
    out = conj[0]
    for c in conj[1:]:
        out = special("and", T.BOOLEAN, out, c)
    return out


def _domain_to_expr(var: Variable, dom: Domain) -> RowExpr:
    def cmp(op: str, v: Any) -> RowExpr:
        return Call(type=T.BOOLEAN, name=op, args=(var, Constant(type=var.type, value=v)))

    null_test = special("is_null", T.BOOLEAN, var)
    if dom.values.is_none():
        return null_test if dom.null_allowed else Constant(type=T.BOOLEAN, value=False)
    if dom.values.is_all:
        if dom.null_allowed:
            return Constant(type=T.BOOLEAN, value=True)
        return special("not", T.BOOLEAN, null_test)

    discrete = dom.values.discrete_values()
    if discrete is not None and len(discrete) > 1:
        value_expr: RowExpr = special(
            "in", T.BOOLEAN, var, *[Constant(type=var.type, value=v) for v in discrete]
        )
    else:
        parts: list[RowExpr] = []
        for r in dom.values.ranges:
            if r.is_single_value:
                parts.append(cmp("eq", r.low))
                continue
            sub: list[RowExpr] = []
            if r.low is not None:
                sub.append(cmp("ge" if r.low_inclusive else "gt", r.low))
            if r.high is not None:
                sub.append(cmp("le" if r.high_inclusive else "lt", r.high))
            if not sub:
                parts.append(Constant(type=T.BOOLEAN, value=True))
            else:
                e = sub[0]
                for s in sub[1:]:
                    e = special("and", T.BOOLEAN, e, s)
                parts.append(e)
        value_expr = parts[0]
        for p in parts[1:]:
            value_expr = special("or", T.BOOLEAN, value_expr, p)
    if dom.null_allowed:
        return special("or", T.BOOLEAN, value_expr, null_test)
    return value_expr
