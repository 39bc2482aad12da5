"""Plan statistics + cost estimation (the CBO substrate).

Reference: ``core/trino-main/src/main/java/io/trino/cost/`` —
``StatsCalculator``, ``FilterStatsCalculator`` (UNKNOWN_FILTER_COEFFICIENT
0.9), ``JoinStatsRule`` (equi-join NDV formula), ``AggregationStatsRule``,
``CostCalculatorUsingExchanges``. Estimates flow bottom-up: connector
``TableStats`` at scans, per-node derivation above.

Estimates are host-side floats — never device data. ``None`` means unknown
(propagated, like Trino's ``Estimate.unknown()``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.ir import Call, Constant, RowExpr, SpecialForm, Variable
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.optimizer import _conjuncts
from trino_tpu_torch.predicate import Domain, TupleDomain, extract_tuple_domain

UNKNOWN_FILTER_COEFFICIENT = 0.9  # cost/FilterStatsCalculator.java


@dataclasses.dataclass
class SymbolStats:
    """Reference: ``cost/SymbolStatsEstimate``."""

    ndv: Optional[float] = None
    null_fraction: float = 0.0
    min_value: Any = None
    max_value: Any = None


@dataclasses.dataclass
class PlanStats:
    """Reference: ``cost/PlanNodeStatsEstimate``."""

    row_count: Optional[float] = None
    symbols: dict[str, SymbolStats] = dataclasses.field(default_factory=dict)

    def symbol(self, name: str) -> SymbolStats:
        return self.symbols.get(name, SymbolStats())

    def scaled(self, factor: float) -> "PlanStats":
        rc = None if self.row_count is None else self.row_count * factor
        syms = {
            k: SymbolStats(
                None if v.ndv is None else min(v.ndv, rc) if rc is not None else v.ndv,
                v.null_fraction,
                v.min_value,
                v.max_value,
            )
            for k, v in self.symbols.items()
        }
        return PlanStats(rc, syms)


class StatsCalculator:
    """Bottom-up recursive estimation, memoized per plan node identity."""

    def __init__(self, catalogs):
        self.catalogs = catalogs
        # memo keeps the node reference alive: id() alone could be reused
        # by a new node after the original is garbage-collected
        self._memo: dict[int, tuple[P.PlanNode, PlanStats]] = {}

    def stats(self, node: P.PlanNode) -> PlanStats:
        key = id(node)
        if key not in self._memo:
            method = getattr(self, f"_stats_{type(node).__name__.lower()}", None)
            self._memo[key] = (
                node,
                method(node) if method is not None else self._stats_default(node),
            )
        return self._memo[key][1]

    def _stats_default(self, node: P.PlanNode) -> PlanStats:
        srcs = node.sources
        if len(srcs) == 1:
            return self.stats(srcs[0])
        return PlanStats()

    # === leaves ===========================================================

    def _stats_tablescan(self, node: P.TableScan) -> PlanStats:
        try:
            connector = self.catalogs.get(node.catalog)
        except KeyError:
            return PlanStats()
        ts = connector.table_stats(node.schema, node.table)
        if ts is None or ts.row_count is None:
            return PlanStats()
        out = PlanStats(float(ts.row_count))
        for sym, col in zip(node.symbols, node.column_names):
            cs = ts.columns.get(col)
            if cs is not None:
                out.symbols[sym.name] = SymbolStats(
                    cs.distinct_count,
                    cs.null_fraction or 0.0,
                    cs.min_value,
                    cs.max_value,
                )
        if node.constraint is not None and not node.constraint.is_all():
            col_to_sym = {c: s.name for s, c in zip(node.symbols, node.column_names)}
            sel = 1.0
            if node.constraint.is_none():
                return out.scaled(0.0)
            for col, dom in node.constraint.domains.items():
                sname = col_to_sym.get(col)
                ss = out.symbols.get(sname) if sname else None
                sel *= _domain_selectivity(dom, ss)
            out = out.scaled(sel)
        return out

    def _stats_values(self, node: P.Values) -> PlanStats:
        return PlanStats(float(len(node.rows)))

    # === unary ============================================================

    def _stats_filter(self, node: P.Filter) -> PlanStats:
        src = self.stats(node.source)
        if src.row_count is None:
            return src
        res = extract_tuple_domain(_conjuncts(node.predicate))
        sel = 1.0
        for _ in res.remaining:
            sel *= UNKNOWN_FILTER_COEFFICIENT
        # domains already pushed into the scan's constraint were applied by
        # _stats_tablescan — don't double-count them here
        applied_below: set[str] = set()
        if (
            isinstance(node.source, P.TableScan)
            and node.source.constraint is not None
            and not node.source.constraint.is_none()
        ):
            col_to_sym = {
                c: s.name
                for s, c in zip(node.source.symbols, node.source.column_names)
            }
            for col in node.source.constraint.domains:
                if col in col_to_sym:
                    applied_below.add(col_to_sym[col])
        out_symbols = dict(src.symbols)
        if not res.tuple_domain.is_none():
            for name, dom in (res.tuple_domain.domains or {}).items():
                if name in applied_below:
                    continue
                ss = src.symbols.get(name)
                sel *= _domain_selectivity(dom, ss)
                # narrow the symbol's range to the domain span
                span = None if dom.values.is_all else dom.values.span()
                if span is not None:
                    prev = out_symbols.get(name, SymbolStats())
                    out_symbols[name] = SymbolStats(
                        prev.ndv, 0.0,
                        span.low if span.low is not None else prev.min_value,
                        span.high if span.high is not None else prev.max_value,
                    )
        else:
            sel = 0.0
        out = PlanStats(src.row_count, out_symbols).scaled(sel)
        return out

    def _stats_project(self, node: P.Project) -> PlanStats:
        src = self.stats(node.source)
        out = PlanStats(src.row_count)
        for sym, expr in node.assignments:
            if isinstance(expr, Variable):
                if expr.name in src.symbols:
                    out.symbols[sym.name] = src.symbols[expr.name]
        return out

    def _stats_aggregate(self, node: P.Aggregate) -> PlanStats:
        src = self.stats(node.source)
        if not node.group_keys:
            return PlanStats(1.0)
        if src.row_count is None:
            return PlanStats()
        ndv_product = 1.0
        known = True
        for k in node.group_keys:
            ss = src.symbols.get(k.name)
            if ss is None or ss.ndv is None:
                known = False
                break
            ndv_product *= max(ss.ndv, 1.0)
        if not known:
            # AggregationStatsRule falls back: group count unknown -> damp
            rows = max(1.0, src.row_count * 0.1)
        else:
            rows = min(src.row_count, ndv_product)
        out = PlanStats(rows)
        for k in node.group_keys:
            if k.name in src.symbols:
                out.symbols[k.name] = src.symbols[k.name]
        return out

    def _stats_distinct(self, node) -> PlanStats:
        src = self.stats(node.source)
        if src.row_count is None:
            return src
        return PlanStats(max(1.0, src.row_count * 0.1), dict(src.symbols))

    def _stats_limit(self, node: P.Limit) -> PlanStats:
        src = self.stats(node.source)
        if src.row_count is None:
            return PlanStats(float(node.count))
        return PlanStats(min(float(node.count), src.row_count), dict(src.symbols))

    def _stats_topn(self, node: P.TopN) -> PlanStats:
        src = self.stats(node.source)
        if src.row_count is None:
            return PlanStats(float(node.count))
        return PlanStats(min(float(node.count), src.row_count), dict(src.symbols))

    # === join =============================================================

    def _stats_join(self, node: P.Join) -> PlanStats:
        left = self.stats(node.left)
        right = self.stats(node.right)
        if left.row_count is None or right.row_count is None:
            return PlanStats()
        symbols = dict(left.symbols)
        symbols.update(right.symbols)
        if node.join_type in ("SEMI", "ANTI"):
            return PlanStats(max(1.0, left.row_count * 0.5), dict(left.symbols))
        if node.join_type == "CROSS" or not node.criteria:
            rows = left.row_count * right.row_count
            return PlanStats(rows, symbols)
        # JoinStatsRule: rows = L * R / prod(max(ndv_l, ndv_r)) over clauses
        rows = left.row_count * right.row_count
        for lk, rk in node.criteria:
            lndv = (left.symbols.get(lk.name) or SymbolStats()).ndv
            rndv = (right.symbols.get(rk.name) or SymbolStats()).ndv
            if lndv is None and rndv is None:
                # unknown key NDVs: assume PK-FK with the smaller side as PK
                denom = min(left.row_count, right.row_count)
            else:
                denom = max(lndv or 1.0, rndv or 1.0)
            rows /= max(denom, 1.0)
        if node.filter is not None:
            rows *= UNKNOWN_FILTER_COEFFICIENT
        if node.join_type == "LEFT":
            rows = max(rows, left.row_count)
        elif node.join_type == "RIGHT":
            rows = max(rows, right.row_count)
        elif node.join_type == "FULL":
            rows = max(rows, left.row_count, right.row_count)
        return PlanStats(rows, symbols)

    def _stats_setop(self, node: P.SetOp) -> PlanStats:
        parts = [self.stats(i) for i in node.inputs]
        if any(p.row_count is None for p in parts):
            return PlanStats()
        if node.op == "union":
            rows = sum(p.row_count for p in parts)
            if node.distinct:
                rows *= 0.5
        elif node.op == "intersect":
            rows = min(p.row_count for p in parts) * 0.5
        else:  # except
            rows = parts[0].row_count * 0.5
        return PlanStats(max(rows, 0.0))


def _domain_selectivity(dom: Domain, ss: Optional[SymbolStats]) -> float:
    """Fraction of rows satisfying ``dom`` (FilterStatsCalculator shapes)."""
    if dom.is_none():
        return 0.0
    if dom.is_all():
        return 1.0
    null_frac = ss.null_fraction if ss is not None else 0.0
    if dom.values.is_none():  # IS NULL only
        return null_frac if dom.null_allowed else 0.0
    if dom.values.is_all:  # IS NOT NULL
        return 1.0 - (0.0 if dom.null_allowed else null_frac)

    discrete = dom.values.discrete_values()
    if discrete is not None:
        if ss is not None and ss.ndv:
            return min(1.0, len(discrete) / ss.ndv)
        return min(1.0, 0.1 * len(discrete))
    # range: fraction of [min, max] covered
    if (
        ss is not None
        and ss.min_value is not None
        and ss.max_value is not None
        and _is_num(ss.min_value)
        and ss.max_value != ss.min_value
    ):
        width = float(ss.max_value) - float(ss.min_value)
        covered = 0.0
        for r in dom.values.ranges:
            lo = float(r.low) if r.low is not None and _is_num(r.low) else float(ss.min_value)
            hi = float(r.high) if r.high is not None and _is_num(r.high) else float(ss.max_value)
            lo = max(lo, float(ss.min_value))
            hi = min(hi, float(ss.max_value))
            covered += max(0.0, hi - lo)
        return max(0.0, min(1.0, covered / width))
    return 0.25  # unknown-range comparison default


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class FragmentStatsCalculator(StatsCalculator):
    """Stats over one plan *fragment*: ``RemoteSource`` leaves resolve to
    the producer fragment's root estimate instead of the unknown default,
    so exchange/join/agg capacity seeding (``exec/fragments.py``) sees
    realistic cardinalities on the consumer side of every cut."""

    def __init__(self, catalogs, remote_stats: dict):
        super().__init__(catalogs)
        self._remote = remote_stats

    def _stats_remotesource(self, node) -> PlanStats:
        src = self._remote.get(node.fragment_id)
        if src is None or src.row_count is None:
            return PlanStats()
        # the cut preserves symbol names across the exchange, so per-symbol
        # stats (join-key NDVs) survive by name; unmatched names just drop
        syms = {
            s.name: src.symbols[s.name]
            for s in node.symbols
            if s.name in src.symbols
        }
        return PlanStats(src.row_count, syms)


def fragment_output_stats(sub, catalogs) -> dict:
    """Root-row estimates per fragment id for a fragmented plan, computed
    bottom-up over the fragment tree (children first, so every
    ``RemoteSource`` resolves against its producer's estimate)."""
    out: dict = {}

    def walk(sp) -> None:
        for child in sp.children:
            walk(child)
        out[sp.fragment.id] = FragmentStatsCalculator(catalogs, out).stats(
            sp.fragment.root
        )

    walk(sub)
    return out
