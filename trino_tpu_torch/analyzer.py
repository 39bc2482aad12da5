"""Semantic analysis + logical planning: AST -> typed logical plan.

Reference: ``core/trino-main/src/main/java/io/trino/sql/analyzer/``
(``Analyzer.java:44``, ``StatementAnalyzer.java:284``,
``ExpressionAnalyzer.java``) and ``sql/planner/QueryPlanner.java:139`` /
``RelationPlanner.java``. Trino splits analysis (side-tables) from planning;
we fuse them: one pass resolves names/types and emits plan nodes whose
expressions are RowExpr trees over Symbols.

Typing rules implemented (Trino semantics, DECIMAL capped at precision 18):
- integer literal -> bigint; '1.2' -> decimal(2,1); string -> varchar
- decimal add/sub: s=max(s1,s2); mul: s=s1+s2; div: s=max(s1,s2) (Trino
  keeps max scale and rounds half-up); anything with double -> double
- sum(decimal(p,s)) -> decimal(18,s)  [Trino: (38,s)]
- avg(decimal(p,s)) -> decimal(p,s); avg(int) -> double; count -> bigint
- date +/- interval day -> date; +/- interval month/year -> calendar add
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from trino_tpu_torch import types as T
from trino_tpu_torch.civil import days_from_civil
from trino_tpu_torch.config import Session
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.ir import (
    Call,
    Constant,
    RowExpr,
    SpecialForm,
    Variable,
    call,
    const,
    referenced_variables,
    special,
    variable,
)
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.sql import tree as t


class SemanticError(Exception):
    pass


@dataclasses.dataclass
class Field:
    name: Optional[str]  # None for anonymous expressions
    qualifier: Optional[str]
    symbol: P.Symbol


class Scope:
    def __init__(self, fields: list[Field], parent: Optional["Scope"] = None):
        self.fields = fields
        self.parent = parent

    def resolve(self, parts: tuple[str, ...]) -> P.Symbol:
        name = parts[-1].lower()
        qualifier = parts[-2].lower() if len(parts) > 1 else None
        matches = [
            f
            for f in self.fields
            if f.name == name and (qualifier is None or f.qualifier == qualifier)
        ]
        if len(matches) == 1:
            return matches[0].symbol
        if len(matches) > 1:
            raise SemanticError(f"ambiguous column: {'.'.join(parts)}")
        if len(parts) == 1:
            # normalized identifiers carry unique symbol names directly
            sym_matches = [f for f in self.fields if f.symbol.name == parts[0]]
            if len(sym_matches) == 1:
                return sym_matches[0].symbol
        if self.parent is not None:
            return self.parent.resolve(parts)
        raise SemanticError(f"column not found: {'.'.join(parts)}")

    def try_resolve(self, parts: tuple[str, ...]) -> Optional[P.Symbol]:
        try:
            return self.resolve(parts)
        except SemanticError:
            return None


@dataclasses.dataclass
class RelationPlan:
    node: P.PlanNode
    scope: Scope


class Analyzer:
    def __init__(
        self,
        catalogs: CatalogManager,
        session: Session,
        access_control=None,
    ):
        self.catalogs = catalogs
        self.session = session
        self.access_control = access_control
        self.ctes: dict[str, RelationPlan] = {}

    # ==== entry =========================================================
    def plan_statement(self, stmt: t.Node) -> P.PlanNode:
        if isinstance(stmt, t.Query):
            rp, names = self.plan_query(stmt)
            return P.Output(rp.node, names, rp.node.output_symbols)
        raise SemanticError(f"unsupported statement: {type(stmt).__name__}")

    # ==== queries =======================================================
    def plan_query(
        self, q: t.Query, outer: Optional[Scope] = None
    ) -> tuple[RelationPlan, list[str]]:
        """``outer`` is the enclosing query's scope: set only for expression
        subqueries, enabling correlated column references (reference:
        StatementAnalyzer's Scope.parent chain)."""
        saved_ctes = dict(self.ctes)
        try:
            for wq in q.with_queries:
                rp, names = self.plan_query(wq.query)
                if wq.column_aliases:
                    names = list(wq.column_aliases)
                fields = [
                    Field(n.lower(), wq.name.lower(), s)
                    for n, s in zip(names, rp.node.output_symbols)
                ]
                self.ctes[wq.name.lower()] = RelationPlan(rp.node, Scope(fields))
            rp, names = self._plan_query_body(
                q.body, q.order_by, q.limit, q.offset, outer
            )
            return rp, names
        finally:
            self.ctes = saved_ctes

    def _plan_query_body(
        self,
        body: t.Node,
        order_by: tuple[t.SortItem, ...],
        limit: Optional[int],
        offset: int,
        outer: Optional[Scope] = None,
    ) -> tuple[RelationPlan, list[str]]:
        if isinstance(body, t.QuerySpec):
            return self._plan_query_spec(body, order_by, limit, offset, outer)
        if isinstance(body, t.SetOperation):
            rp, names = self._plan_set_operation(body)
            rp = self._apply_order_limit(rp, names, order_by, limit, offset)
            return rp, names
        if isinstance(body, t.Values):
            rp, names = self._plan_values(body)
            rp = self._apply_order_limit(rp, names, order_by, limit, offset)
            return rp, names
        if isinstance(body, t.Query):
            return self.plan_query(body)
        raise SemanticError(f"unsupported query body: {type(body).__name__}")

    def _apply_order_limit(self, rp, names, order_by, limit, offset):
        if order_by:
            scope = Scope(
                [Field(n.lower(), None, s) for n, s in zip(names, rp.node.output_symbols)]
            )
            orderings = []
            for si in order_by:
                e = self._rewrite(si.expression, scope)
                if not isinstance(e, Variable):
                    raise SemanticError("ORDER BY over set op must reference columns")
                sym = P.Symbol(e.name, e.type)
                orderings.append(self._ordering(sym, si))
            node = P.Sort(rp.node, orderings)
            rp = RelationPlan(node, rp.scope)
        if limit is not None or offset:
            rp = RelationPlan(P.Limit(rp.node, limit, offset), rp.scope)
        return rp

    def _ordering(self, sym: P.Symbol, si: t.SortItem) -> P.Ordering:
        nulls_first = si.nulls_first
        if nulls_first is None:
            nulls_first = not si.ascending  # Trino: NULLS LAST for ASC, FIRST for DESC
        return P.Ordering(sym, si.ascending, nulls_first)

    def _plan_values(self, v: t.Values) -> tuple[RelationPlan, list[str]]:
        rows = []
        col_types: list[T.SqlType] = []
        for row in v.rows:
            vals = []
            for j, e in enumerate(row):
                ex = self._rewrite(e, Scope([]))
                ex = _fold(ex)
                if not isinstance(ex, Constant):
                    raise SemanticError("VALUES entries must be constant")
                vals.append(ex)
                if j >= len(col_types):
                    col_types.append(ex.type)
                else:
                    ct = T.common_super_type(col_types[j], ex.type)
                    if ct is None:
                        raise SemanticError("incompatible VALUES column types")
                    col_types[j] = ct
            rows.append(vals)
        symbols = [
            P.Symbol(P.fresh_name(f"col{j}"), ct) for j, ct in enumerate(col_types)
        ]
        storage_rows = []
        for row in rows:
            srow = []
            for cexpr, ct in zip(row, col_types):
                srow.append(_coerce_constant_value(cexpr, ct))
            storage_rows.append(srow)
        names = [f"_col{j}" for j in range(len(col_types))]
        node = P.Values(symbols, storage_rows)
        fields = [Field(None, None, s) for s in symbols]
        return RelationPlan(node, Scope(fields)), names

    def _plan_set_operation(self, op: t.SetOperation) -> tuple[RelationPlan, list[str]]:
        left_rp, left_names = self._plan_query_body(op.left, (), None, 0)
        right_rp, _ = self._plan_query_body(op.right, (), None, 0)
        lsyms = left_rp.node.output_symbols
        rsyms = right_rp.node.output_symbols
        if len(lsyms) != len(rsyms):
            raise SemanticError("set operation column count mismatch")
        out_syms = []
        for a, b in zip(lsyms, rsyms):
            ct = T.common_super_type(a.type, b.type)
            if ct is None:
                raise SemanticError(f"set operation type mismatch: {a.type} vs {b.type}")
            out_syms.append(P.Symbol(P.fresh_name(a.name), ct))
        node = P.SetOp(op.op, op.distinct, [left_rp.node, right_rp.node], out_syms)
        fields = [
            Field(n.lower(), None, s) for n, s in zip(left_names, out_syms)
        ]
        return RelationPlan(node, Scope(fields)), left_names

    # ==== SELECT core ===================================================
    def _plan_query_spec(
        self,
        spec: t.QuerySpec,
        order_by: tuple[t.SortItem, ...],
        limit: Optional[int],
        offset: int,
        outer: Optional[Scope] = None,
    ) -> tuple[RelationPlan, list[str]]:
        # FROM
        if spec.from_ is not None:
            rp = self._plan_relation(spec.from_)
        else:
            sym = P.Symbol(P.fresh_name("dual"), T.BIGINT)
            rp = RelationPlan(P.Values([sym], [[0]]), Scope([]))
        if outer is not None:
            # chain to the enclosing scope: unresolved names become
            # correlated references to outer symbols
            rp = RelationPlan(rp.node, Scope(rp.scope.fields, outer))
        # WHERE
        if spec.where is not None:
            pred, rp = self._rewrite_with_subqueries(spec.where, rp)
            pred = _fold(pred)
            rp = RelationPlan(P.Filter(rp.node, pred), rp.scope)

        # expand stars, gather select expressions
        select_entries: list[tuple[t.Node, Optional[str]]] = []
        for item in spec.select_items:
            if isinstance(item.expression, t.Star):
                q = item.expression.qualifier
                for f in rp.scope.fields:
                    if f.name is None:
                        continue
                    if q is not None and f.qualifier != q.lower():
                        continue
                    select_entries.append(
                        (t.Identifier((f.qualifier, f.name) if f.qualifier else (f.name,)), f.name)
                    )
            else:
                alias = item.alias
                if alias is None and isinstance(item.expression, t.Identifier):
                    alias = item.expression.parts[-1]
                select_entries.append(
                    (self._normalize(item.expression, rp.scope), alias)
                )

        has_aggs = any(
            _contains_aggregate(e) for e, _ in select_entries
        ) or (spec.having is not None and _contains_aggregate(spec.having)) or bool(
            spec.group_by
        )

        if has_aggs:
            return self._plan_aggregation(
                spec, rp, select_entries, order_by, limit, offset
            )

        # window functions (no aggregation): plan Window nodes over the input
        window_calls: list[t.FunctionCall] = []
        for e, _ in select_entries:
            _collect_windows(e, window_calls)
        for si in order_by:
            _collect_windows(self._normalize(si.expression, rp.scope), window_calls)
        win_repl: dict[t.Node, P.Symbol] = {}
        if window_calls:
            wnode, win_repl = self._plan_windows(
                rp.node, window_calls, lambda ast: self._rewrite(ast, rp.scope)
            )
            rp = RelationPlan(wnode, rp.scope)

        # plain projection
        out_syms: list[P.Symbol] = []
        assignments: list[tuple[P.Symbol, RowExpr]] = []
        names: list[str] = []
        for e_ast, alias in select_entries:
            ex, rp = self._rewrite_with_subqueries(e_ast, rp, win_repl or None)
            ex = _fold(ex)
            name = (alias or "_col").lower()
            sym = P.Symbol(P.fresh_name(name), ex.type)
            assignments.append((sym, ex))
            out_syms.append(sym)
            names.append(alias.lower() if alias else f"_col{len(names)}")

        # ORDER BY may reference hidden input columns: keep them through sort
        sort_items = []
        extra_syms: list[P.Symbol] = []
        if order_by:
            select_scope = Scope(
                [Field(n, None, s) for (n, s) in zip(names, out_syms)],
            )
            for si in order_by:
                # alias resolution first (raw form), then structural match
                # against normalized select expressions
                sym = self._resolve_sort_symbol(
                    si, select_scope, rp.scope, select_entries, out_syms
                )
                if sym is None:
                    si = dataclasses.replace(
                        si, expression=self._normalize(si.expression, rp.scope)
                    )
                    sym = self._resolve_sort_symbol(
                        si, select_scope, rp.scope, select_entries, out_syms
                    )
                if sym is None:
                    ex = self._rewrite(
                        si.expression, rp.scope, replacements=win_repl or None
                    )
                    ex = _fold(ex)
                    sym = P.Symbol(P.fresh_name("sortkey"), ex.type)
                    assignments.append((sym, ex))
                    extra_syms.append(sym)
                sort_items.append(self._ordering(sym, si))

        node: P.PlanNode = P.Project(rp.node, assignments)
        if spec.distinct:
            if extra_syms:
                raise SemanticError(
                    "ORDER BY expression must appear in select list with DISTINCT"
                )
            node = P.Distinct(node)
        if sort_items:
            if limit is not None and offset == 0:
                node = P.TopN(node, limit, sort_items)
                limit = None
            else:
                node = P.Sort(node, sort_items)
        if extra_syms:
            node = P.Project(
                node, [(s, variable(s.name, s.type)) for s in out_syms]
            )
        if limit is not None or offset:
            node = P.Limit(node, limit, offset)
        fields = [Field(n, None, s) for n, s in zip(names, out_syms)]
        return RelationPlan(node, Scope(fields)), names

    def _resolve_sort_symbol(
        self, si, select_scope, input_scope, select_entries, out_syms
    ) -> Optional[P.Symbol]:
        e = si.expression
        if isinstance(e, t.Literal) and e.kind == "integer":
            idx = int(e.value) - 1
            if not (0 <= idx < len(out_syms)):
                raise SemanticError(f"ORDER BY ordinal {e.value} out of range")
            return out_syms[idx]
        if isinstance(e, t.Identifier):
            sym = select_scope.try_resolve(e.parts)
            if sym is not None:
                return sym
        # structural match against select expressions
        for (se, _), sym in zip(select_entries, out_syms):
            if se == e:
                return sym
        return None

    # ==== aggregation ===================================================
    def _plan_aggregation(
        self, spec, rp, select_entries, order_by, limit, offset
    ) -> tuple[RelationPlan, list[str]]:
        input_scope = rp.scope
        # resolve group keys (ordinals or expressions), normalized for
        # structural matching against (already-normalized) select entries
        # GROUPING SETS / ROLLUP / CUBE: the cross product of all grouping
        # elements' sets (SQL semantics); plain expressions are singleton
        # elements. grouping_sets is None for ordinary GROUP BY.
        def resolve_one(g: t.Node) -> t.Node:
            if isinstance(g, t.Literal) and g.kind == "integer":
                idx = int(g.value) - 1
                if not (0 <= idx < len(select_entries)):
                    raise SemanticError(f"GROUP BY ordinal {g.value} out of range")
                return select_entries[idx][0]
            return self._normalize(g, input_scope)

        grouping_sets: Optional[list[list[t.Node]]] = None
        if any(isinstance(g, t.GroupingSets) for g in spec.group_by):
            combos: list[list[t.Node]] = [[]]
            for g in spec.group_by:
                if isinstance(g, t.GroupingSets):
                    combos = [
                        prefix + [resolve_one(x) for x in s]
                        for prefix in combos
                        for s in g.sets
                    ]
                else:
                    resolved = resolve_one(g)
                    combos = [prefix + [resolved] for prefix in combos]
            grouping_sets = combos
            group_asts = []
            for s in combos:
                for x in s:
                    if x not in group_asts:
                        group_asts.append(x)
        else:
            group_asts = [resolve_one(g) for g in spec.group_by]

        having_ast = (
            self._normalize(spec.having, input_scope)
            if spec.having is not None
            else None
        )
        # keep raw sort expressions: ORDER BY <alias> must resolve against
        # the SELECT outputs even when an input column shares the name
        # (normalization would rewrite it to the input symbol)
        raw_order_by = order_by
        order_by = tuple(
            dataclasses.replace(
                si, expression=self._normalize(si.expression, input_scope)
            )
            for si in order_by
        )

        # collect aggregate calls from select + having + order_by
        agg_asts: list[t.FunctionCall] = []
        for e, _ in select_entries:
            _collect_aggregates(e, agg_asts)
        if having_ast is not None:
            _collect_aggregates(having_ast, agg_asts)
        for si in order_by:
            _collect_aggregates(si.expression, agg_asts)

        # pre-projection: group key exprs + agg argument exprs
        pre_assignments: list[tuple[P.Symbol, RowExpr]] = []
        key_symbols: list[P.Symbol] = []
        key_map: dict[t.Node, P.Symbol] = {}
        for g_ast in group_asts:
            if g_ast in key_map:
                continue
            ex = self._rewrite(g_ast, input_scope)
            ex = _fold(ex)
            sym = P.Symbol(P.fresh_name("gk"), ex.type)
            pre_assignments.append((sym, ex))
            key_symbols.append(sym)
            key_map[g_ast] = sym

        aggs: list[tuple[P.Symbol, P.AggFunction]] = []
        agg_map: dict[t.Node, P.Symbol] = {}
        # derived aggregates (stddev/variance/bool_and/...) compose simple
        # aggregates plus a post-projection expression (reference: the
        # input/combine/output decomposition of AccumulatorCompiler states)
        derived_exprs: list[tuple[P.Symbol, RowExpr]] = []

        def add_agg(kind, arg_expr, result_type, distinct=False, filt=None):
            sym_in = None
            if arg_expr is not None:
                sym_in = P.Symbol(P.fresh_name("aggarg"), arg_expr.type)
                pre_assignments.append((sym_in, arg_expr))
            out = P.Symbol(P.fresh_name(kind), result_type)
            aggs.append(
                (out, P.AggFunction(
                    kind,
                    variable(sym_in.name, sym_in.type) if sym_in else None,
                    result_type, distinct, filt,
                ))
            )
            return out

        for fc in agg_asts:
            if fc in agg_map:
                continue
            kind = fc.name
            if kind not in AGGREGATE_NAMES:
                raise SemanticError(f"unsupported aggregate: {kind}")
            # FILTER clause applies to every decomposed sub-aggregate
            # (the plain sum/count/avg/min/max path handles fc.filter itself)
            fc_filter = None
            if fc.filter is not None and (
                kind in _DERIVED_AGGS
                or kind in ("approx_distinct", "arbitrary", "any_value")
            ):
                f_ex = _fold(self._rewrite(fc.filter, input_scope))
                sym_f = P.Symbol(P.fresh_name("aggfilter"), T.BOOLEAN)
                pre_assignments.append((sym_f, f_ex))
                fc_filter = variable(sym_f.name, T.BOOLEAN)
            if kind in _DERIVED_AGGS:
                if fc.distinct:
                    raise SemanticError(f"{kind}(DISTINCT ...) is not supported")
                derived = self._plan_derived_aggregate(
                    fc, input_scope, add_agg, fc_filter
                )
                dsym = P.Symbol(P.fresh_name(kind), derived.type)
                derived_exprs.append((dsym, derived))
                agg_map[fc] = dsym
                continue
            if kind == "count_if":
                cond = _fold(self._rewrite(fc.args[0], input_scope))
                if fc.filter is not None:
                    # count_if(x) FILTER (WHERE f) counts rows where both hold
                    f_ex = _fold(self._rewrite(fc.filter, input_scope))
                    cond = special("and", T.BOOLEAN, cond, f_ex)
                sym_f = P.Symbol(P.fresh_name("aggfilter"), T.BOOLEAN)
                pre_assignments.append((sym_f, cond))
                out_sym = P.Symbol(P.fresh_name("count_if"), T.BIGINT)
                aggs.append(
                    (out_sym, P.AggFunction(
                        "count_star", None, T.BIGINT, False,
                        variable(sym_f.name, T.BOOLEAN),
                    ))
                )
                agg_map[fc] = out_sym
                continue
            if kind == "approx_distinct":
                # exact distinct count (HLL sketch: future work; documented)
                arg = _fold(self._rewrite(fc.args[0], input_scope))
                agg_map[fc] = add_agg(
                    "count", arg, T.BIGINT, distinct=True, filt=fc_filter
                )
                continue
            if kind in ("arbitrary", "any_value"):
                if fc.distinct:
                    raise SemanticError(f"{kind}(DISTINCT ...) is not supported")
                arg = _fold(self._rewrite(fc.args[0], input_scope))
                agg_map[fc] = add_agg("min", arg, arg.type, filt=fc_filter)
                continue
            if kind == "array_agg":
                if fc.distinct:
                    raise SemanticError("array_agg(DISTINCT ...) is not supported")
                arg = _fold(self._rewrite(fc.args[0], input_scope))
                agg_map[fc] = add_agg(
                    "array_agg", arg, T.ArrayType(element=arg.type),
                    filt=fc_filter,
                )
                continue
            if kind == "count" and len(fc.args) == 1 and isinstance(fc.args[0], t.Star):
                arg_expr = None
                result_type: T.SqlType = T.BIGINT
                kind = "count_star"
                arg_sym_expr = None
            else:
                arg = self._rewrite(fc.args[0], input_scope)
                arg = _fold(arg)
                if kind == "count":
                    result_type = T.BIGINT
                elif kind == "sum":
                    if isinstance(arg.type, T.DecimalType):
                        # reference: sum(decimal(p,s)) -> decimal(38,s)
                        # (DecimalSumAggregation); values beyond int64 use
                        # 128-bit limb accumulation (ops/decimal128.py)
                        result_type = T.decimal(38, arg.type.scale)
                    elif T.is_integer(arg.type):
                        result_type = T.BIGINT
                    else:
                        result_type = arg.type
                elif kind == "avg":
                    if isinstance(arg.type, T.DecimalType):
                        result_type = arg.type
                    else:
                        result_type = T.DOUBLE
                else:  # min/max
                    result_type = arg.type
                sym_in = P.Symbol(P.fresh_name("aggarg"), arg.type)
                pre_assignments.append((sym_in, arg))
                arg_sym_expr = variable(sym_in.name, sym_in.type)
            filt = None
            if fc.filter is not None:
                f_ex = self._rewrite(fc.filter, input_scope)
                sym_f = P.Symbol(P.fresh_name("aggfilter"), T.BOOLEAN)
                pre_assignments.append((sym_f, _fold(f_ex)))
                filt = variable(sym_f.name, T.BOOLEAN)
            out_sym = P.Symbol(P.fresh_name(fc.name), result_type)
            aggs.append(
                (out_sym, P.AggFunction(kind, arg_sym_expr, result_type, fc.distinct, filt))
            )
            agg_map[fc] = out_sym

        # count(*)-only aggregations have no inputs to project; feed the
        # source directly (a zero-column projection would lose row counts)
        pre_project = (
            P.Project(rp.node, pre_assignments) if pre_assignments else rp.node
        )
        if grouping_sets is not None:
            # GroupIdNode: replicate rows per set, null absent keys, add gid
            groups = [
                [key_map[ast] for ast in s] for s in grouping_sets
            ]
            gid = P.Symbol(P.fresh_name("groupid"), T.BIGINT)
            pre_project = P.GroupId(pre_project, groups, list(key_symbols), gid)
            agg_keys = key_symbols + [gid]
        else:
            agg_keys = key_symbols
        agg_node = P.Aggregate(pre_project, agg_keys, aggs, step="single")
        if derived_exprs:
            passthrough = [
                (s, variable(s.name, s.type)) for s in agg_node.output_symbols
            ]
            agg_node = P.Project(agg_node, passthrough + derived_exprs)

        # post-agg scope: group-by ASTs and agg ASTs -> symbols
        post_replacements: dict[t.Node, P.Symbol] = {}
        post_replacements.update(key_map)
        post_replacements.update(agg_map)

        def rewrite_post(e_ast: t.Node) -> RowExpr:
            return self._rewrite(
                e_ast, Scope([]), replacements=post_replacements
            )

        node: P.PlanNode = agg_node
        if having_ast is not None:
            # HAVING may contain (uncorrelated) subqueries — TPC-H Q11
            rp_h = RelationPlan(node, Scope([]))
            pred, rp_h = self._rewrite_with_subqueries(
                having_ast, rp_h, post_replacements or None
            )
            node = P.Filter(rp_h.node, _fold(pred))

        # windows over aggregation results (rank() OVER (ORDER BY sum(x)))
        window_calls: list[t.FunctionCall] = []
        for e, _ in select_entries:
            _collect_windows(e, window_calls)
        for si in order_by:
            _collect_windows(si.expression, window_calls)
        if window_calls:
            node, win_repl = self._plan_windows(node, window_calls, rewrite_post)
            post_replacements.update(win_repl)

        out_syms: list[P.Symbol] = []
        assignments = []
        names = []
        # select entries may contain (uncorrelated) subqueries: join them
        # onto the post-aggregation relation
        rp_post = RelationPlan(node, Scope([]))
        for e_ast, alias in select_entries:
            ex, rp_post = self._rewrite_with_subqueries(
                e_ast, rp_post, post_replacements or None
            )
            ex = _fold(ex)
            name = (alias or "_col").lower()
            sym = P.Symbol(P.fresh_name(name), ex.type)
            assignments.append((sym, ex))
            out_syms.append(sym)
            names.append(alias.lower() if alias else f"_col{len(names)}")
        node = rp_post.node
        sort_items = []
        extra_syms: list[P.Symbol] = []
        if order_by:
            select_scope = Scope([Field(n, None, s) for n, s in zip(names, out_syms)])
            for raw_si, si in zip(raw_order_by, order_by):
                # alias/ordinal resolution uses the RAW form (the output
                # alias wins over a same-named input column, SQL semantics)
                sym = self._resolve_sort_symbol(
                    raw_si, select_scope, None, select_entries, out_syms
                )
                if sym is None:
                    sym = self._resolve_sort_symbol(
                        si, select_scope, None, select_entries, out_syms
                    )
                if sym is None:
                    ex = _fold(rewrite_post(si.expression))
                    sym = P.Symbol(P.fresh_name("sortkey"), ex.type)
                    assignments.append((sym, ex))
                    extra_syms.append(sym)
                sort_items.append(self._ordering(sym, si))
        node = P.Project(node, assignments)
        if spec.distinct:
            node = P.Distinct(node)
        if sort_items:
            if limit is not None and offset == 0:
                node = P.TopN(node, limit, sort_items)
                limit = None
            else:
                node = P.Sort(node, sort_items)
        if extra_syms:
            node = P.Project(node, [(s, variable(s.name, s.type)) for s in out_syms])
        if limit is not None or offset:
            node = P.Limit(node, limit, offset)
        fields = [Field(n, None, s) for n, s in zip(names, out_syms)]
        return RelationPlan(node, Scope(fields)), names

    # ==== relations =====================================================
    def _plan_relation(self, rel: t.Node) -> RelationPlan:
        if isinstance(rel, t.Table):
            return self._plan_table(rel)
        if isinstance(rel, t.AliasedRelation):
            inner = self._plan_relation(rel.relation)
            alias = rel.alias.lower()
            fields = []
            for i, f in enumerate(inner.scope.fields):
                name = (
                    rel.column_aliases[i].lower()
                    if i < len(rel.column_aliases)
                    else f.name
                )
                fields.append(Field(name, alias, f.symbol))
            return RelationPlan(inner.node, Scope(fields))
        if isinstance(rel, t.SubqueryRelation):
            rp, names = self.plan_query(rel.query)
            fields = [
                Field(n.lower(), None, s)
                for n, s in zip(names, rp.node.output_symbols)
            ]
            return RelationPlan(rp.node, Scope(fields))
        if isinstance(rel, t.Join):
            return self._plan_join(rel)
        if isinstance(rel, t.Unnest):
            # bare FROM UNNEST(array): expand over a one-row dual
            dual = P.Values([P.Symbol(P.fresh_name("dual"), T.BIGINT)], [[0]])
            return self._plan_unnest(
                RelationPlan(dual, Scope([])), rel, None, ()
            )
        raise SemanticError(f"unsupported relation: {type(rel).__name__}")

    def _plan_unnest(
        self,
        left: RelationPlan,
        rel: t.Unnest,
        alias: Optional[str],
        col_aliases: tuple[str, ...],
    ) -> RelationPlan:
        """Plan UNNEST (reference: UnnestOperator.java:39; RelationPlanner
        handles CROSS JOIN UNNEST laterally)."""
        array_exprs = []
        element_symbols = []
        for i, e_ast in enumerate(rel.expressions):
            ex = _fold(self._rewrite(e_ast, left.scope))
            if not isinstance(ex.type, T.ArrayType):
                raise SemanticError("UNNEST argument must be an ARRAY")
            array_exprs.append(ex)
            name = (
                col_aliases[i].lower()
                if i < len(col_aliases)
                else P.fresh_name("unnest")
            )
            element_symbols.append(
                P.Symbol(P.fresh_name(name), ex.type.element)
            )
        ordinality = None
        if rel.with_ordinality:
            oname = (
                col_aliases[len(rel.expressions)].lower()
                if len(col_aliases) > len(rel.expressions)
                else "ordinality"
            )
            ordinality = P.Symbol(P.fresh_name(oname), T.BIGINT)
        node = P.Unnest(left.node, array_exprs, element_symbols, ordinality)
        fields = list(left.scope.fields)
        for i, s in enumerate(element_symbols):
            fname = (
                col_aliases[i].lower()
                if i < len(col_aliases)
                else (alias if len(element_symbols) == 1 and alias else None)
            )
            fields.append(Field(fname, alias, s))
        if ordinality is not None:
            oname = (
                col_aliases[len(rel.expressions)].lower()
                if len(col_aliases) > len(rel.expressions)
                else "ordinality"
            )
            fields.append(Field(oname, alias, ordinality))
        return RelationPlan(node, Scope(fields))

    def _plan_table(self, rel: t.Table) -> RelationPlan:
        parts = tuple(p.lower() for p in rel.name)
        if len(parts) == 1 and parts[0] in self.ctes:
            cte = self.ctes[parts[0]]
            # re-instantiate per reference: sharing one plan (and its
            # symbols) across references turns cross-reference predicates
            # like t1.k = t2.k into tautologies over a single symbol
            node, mapping = P.instantiate(cte.node)
            fields = [
                dataclasses.replace(
                    f, symbol=mapping.get(f.symbol.name, f.symbol)
                )
                for f in cte.scope.fields
            ]
            return RelationPlan(node, Scope(fields))
        if len(parts) == 3:
            catalog, schema, table = parts
        elif len(parts) == 2:
            catalog = self.session.catalog
            schema, table = parts
        elif len(parts) == 1:
            catalog = self.session.catalog
            schema = self.session.schema
            table = parts[0]
        else:
            raise SemanticError(f"invalid table name: {'.'.join(parts)}")
        if catalog is None or schema is None:
            raise SemanticError("no default catalog/schema set")
        connector = self.catalogs.get(catalog)
        ts = connector.get_table(schema, table)
        if ts is None:
            raise SemanticError(f"table not found: {catalog}.{schema}.{table}")
        if self.access_control is not None:
            self.access_control.check_can_select(
                self.session.user, catalog, schema, table
            )
        symbols = [
            P.Symbol(P.fresh_name(c.name), c.type) for c in ts.columns
        ]
        node = P.TableScan(catalog, schema, table, symbols, ts.column_names())
        fields = [
            Field(c.name.lower(), table, s) for c, s in zip(ts.columns, symbols)
        ]
        return RelationPlan(node, Scope(fields))

    def _plan_join(self, rel: t.Join) -> RelationPlan:
        left = self._plan_relation(rel.left)
        # CROSS JOIN UNNEST(expr): the unnest references the LEFT relation
        # (lateral semantics) — plan an Unnest node instead of a join
        unnest_ast, u_alias, u_cols = _unwrap_unnest(rel.right)
        if unnest_ast is not None and rel.join_type == "CROSS":
            return self._plan_unnest(left, unnest_ast, u_alias, u_cols)
        right = self._plan_relation(rel.right)
        combined_scope = Scope(left.scope.fields + right.scope.fields)
        if rel.join_type == "CROSS":
            node = P.Join("CROSS", left.node, right.node, [])
            return RelationPlan(node, combined_scope)
        criteria: list[tuple[P.Symbol, P.Symbol]] = []
        residual: list[RowExpr] = []
        left_extra: list[tuple[P.Symbol, RowExpr]] = []
        right_extra: list[tuple[P.Symbol, RowExpr]] = []
        if rel.using:
            for col in rel.using:
                ls = left.scope.resolve((col,))
                rs = right.scope.resolve((col,))
                criteria.append((ls, rs))
        elif rel.criteria is not None:
            conjuncts = _split_conjuncts(rel.criteria)
            left_names = {f.symbol.name for f in left.scope.fields}
            right_names = {f.symbol.name for f in right.scope.fields}
            for c in conjuncts:
                eq = self._as_equi_criterion(c, combined_scope, left_names, right_names)
                if eq is not None:
                    criteria.append(eq)
                    continue
                # complex equi-criterion: each side references one relation
                # only -> project the expression onto that side
                # (Trino: ExtractCommonPredicatesExpressionRewriter +
                # EqualityInference in PredicatePushDown)
                if isinstance(c, t.BinaryOp) and c.op == "=":
                    le = _fold(self._rewrite(c.left, combined_scope))
                    re_ = _fold(self._rewrite(c.right, combined_scope))
                    le, re_ = _coerce_pair(le, re_)
                    lrefs = referenced_variables(le)
                    rrefs = referenced_variables(re_)
                    sides = None
                    if lrefs <= left_names and rrefs <= right_names:
                        sides = (le, re_)
                    elif lrefs <= right_names and rrefs <= left_names:
                        sides = (re_, le)
                    if sides is not None and lrefs and rrefs:
                        lex, rex = sides
                        if isinstance(lex, Variable):
                            lsym = P.Symbol(lex.name, lex.type)
                        else:
                            lsym = P.Symbol(P.fresh_name("jk"), lex.type)
                            left_extra.append((lsym, lex))
                        if isinstance(rex, Variable):
                            rsym = P.Symbol(rex.name, rex.type)
                        else:
                            rsym = P.Symbol(P.fresh_name("jk"), rex.type)
                            right_extra.append((rsym, rex))
                        criteria.append((lsym, rsym))
                        continue
                residual.append(_fold(self._rewrite(c, combined_scope)))
        lnode, rnode = left.node, right.node
        if left_extra:
            lnode = P.Project(
                lnode,
                [(s, variable(s.name, s.type)) for s in lnode.output_symbols]
                + left_extra,
            )
        if right_extra:
            rnode = P.Project(
                rnode,
                [(s, variable(s.name, s.type)) for s in rnode.output_symbols]
                + right_extra,
            )
        filt = None
        if residual:
            filt = residual[0]
            for r in residual[1:]:
                filt = special("and", T.BOOLEAN, filt, r)
        node = P.Join(rel.join_type, lnode, rnode, criteria, filter=filt)
        return RelationPlan(node, combined_scope)

    def _as_equi_criterion(self, c, scope, left_names, right_names):
        if not (isinstance(c, t.BinaryOp) and c.op == "="):
            return None
        a = self._try_symbol(c.left, scope)
        b = self._try_symbol(c.right, scope)
        if a is None or b is None:
            return None
        if a.name in left_names and b.name in right_names:
            return (a, b)
        if b.name in left_names and a.name in right_names:
            return (b, a)
        return None

    def _try_symbol(self, e: t.Node, scope: Scope) -> Optional[P.Symbol]:
        if isinstance(e, t.Identifier):
            sym = scope.try_resolve(e.parts)
            return sym
        return None

    # ==== window functions ==============================================
    _RANKING_WINDOW = (
        "row_number", "rank", "dense_rank", "ntile", "percent_rank", "cume_dist"
    )
    _VALUE_WINDOW = ("lead", "lag", "first_value", "last_value", "nth_value")
    _AGG_WINDOW = ("sum", "count", "avg", "min", "max")

    def _plan_windows(self, node: P.PlanNode, window_calls, rewrite_fn):
        """Plan window functions over ``node``. One :class:`P.Window` per
        distinct (PARTITION BY, ORDER BY, frame) spec, mirroring Trino's
        ``WindowOperator`` grouping (``sql/planner/QueryPlanner.java``'s
        window planning). ``rewrite_fn`` rewrites argument ASTs in the
        enclosing context (input scope or post-aggregation replacements).
        Returns (new_node, {window_call_ast: output_symbol})."""
        replacements: dict[t.Node, P.Symbol] = {}
        groups: dict[tuple, list[t.FunctionCall]] = {}
        for fc in window_calls:
            if fc in replacements:
                continue
            key = (fc.window.partition_by, fc.window.order_by, fc.window.frame)
            groups.setdefault(key, [])
            if fc not in groups[key]:
                groups[key].append(fc)

        for (pb, ob, frame), fcs in groups.items():
            pre: list[tuple[P.Symbol, RowExpr]] = []

            def proj(ex: RowExpr) -> P.Symbol:
                if isinstance(ex, Variable):
                    return P.Symbol(ex.name, ex.type)
                sym = P.Symbol(P.fresh_name("w"), ex.type)
                pre.append((sym, ex))
                return sym

            part_syms = [proj(_fold(rewrite_fn(p))) for p in pb]
            orderings = [
                self._ordering(proj(_fold(rewrite_fn(si.expression))), si)
                for si in ob
            ]
            if frame is not None:
                ftype, fstart, fend = frame
                ok = (fstart, fend) in (
                    ("UNBOUNDED PRECEDING", "CURRENT ROW"),
                    ("UNBOUNDED PRECEDING", "UNBOUNDED FOLLOWING"),
                )
                bounded = (
                    ftype == "ROWS"
                    and fend == "CURRENT ROW"
                    and fstart.endswith(" PRECEDING")
                    and fstart.split()[0].isdigit()
                )
                if bounded and int(fstart.split()[0]) > 256:
                    raise SemanticError("ROWS frame wider than 256 unsupported")
                if not ok and not bounded:
                    raise SemanticError(f"unsupported window frame: {frame}")
            functions: list[tuple[P.Symbol, P.WindowFunction]] = []
            for fc in fcs:
                kind = fc.name
                if fc.distinct:
                    raise SemanticError("DISTINCT in window aggregates unsupported")
                arg_expr = None
                offset = 1
                default = None
                if kind in self._RANKING_WINDOW:
                    result_type: T.SqlType = (
                        T.DOUBLE if kind in ("percent_rank", "cume_dist") else T.BIGINT
                    )
                    if kind == "ntile":
                        if len(fc.args) != 1:
                            raise SemanticError("ntile takes one argument")
                        k = _fold(rewrite_fn(fc.args[0]))
                        if not isinstance(k, Constant) or k.value is None:
                            raise SemanticError("ntile argument must be constant")
                        offset = int(k.value)
                        if offset <= 0:
                            raise SemanticError("NTILE n must be positive")
                    elif fc.args:
                        raise SemanticError(f"{kind} takes no arguments")
                    if not ob and kind != "ntile":
                        pass  # permitted; order within partition unspecified
                elif kind in self._VALUE_WINDOW:
                    arg = _fold(rewrite_fn(fc.args[0]))
                    result_type = arg.type
                    arg_expr = variable(proj(arg).name, arg.type)
                    if kind == "nth_value":
                        if len(fc.args) != 2:
                            raise SemanticError("nth_value takes two arguments")
                        k = _fold(rewrite_fn(fc.args[1]))
                        if not isinstance(k, Constant) or not k.value or int(k.value) < 1:
                            raise SemanticError("nth_value offset must be a positive constant")
                        offset = int(k.value)
                    if kind in ("lead", "lag"):
                        if len(fc.args) >= 2:
                            off = _fold(rewrite_fn(fc.args[1]))
                            if not isinstance(off, Constant) or off.value is None:
                                raise SemanticError(f"{kind} offset must be constant")
                            offset = int(off.value)
                        if len(fc.args) >= 3:
                            d = _coerce_to(_fold(rewrite_fn(fc.args[2])), arg.type)
                            if isinstance(d, Constant):
                                default = d
                            else:
                                default = variable(proj(d).name, d.type)
                elif kind in self._AGG_WINDOW:
                    if len(fc.args) == 1 and isinstance(fc.args[0], t.Star):
                        kind = "count_star"
                        result_type = T.BIGINT
                    else:
                        arg = _fold(rewrite_fn(fc.args[0]))
                        if kind == "count":
                            result_type = T.BIGINT
                        elif kind == "sum":
                            if isinstance(arg.type, T.DecimalType):
                                result_type = T.decimal(18, arg.type.scale)
                            elif T.is_integer(arg.type):
                                result_type = T.BIGINT
                            else:
                                result_type = arg.type
                        elif kind == "avg":
                            result_type = (
                                arg.type
                                if isinstance(arg.type, T.DecimalType)
                                else T.DOUBLE
                            )
                        else:
                            result_type = arg.type
                        if kind == "avg" and not isinstance(
                            arg.type, T.DecimalType
                        ):
                            arg = _coerce_to(arg, T.DOUBLE)
                        arg_expr = variable(proj(arg).name, arg.type)
                else:
                    raise SemanticError(f"unknown window function: {kind}")
                out_sym = P.Symbol(P.fresh_name(kind), result_type)
                functions.append(
                    (out_sym, P.WindowFunction(kind, arg_expr, result_type, offset, default))
                )
                replacements[fc] = out_sym
            if pre:
                node = P.Project(
                    node,
                    [(s, variable(s.name, s.type)) for s in node.output_symbols]
                    + pre,
                )
            node = P.Window(node, part_syms, orderings, functions, frame)
        return node, replacements

    def _plan_derived_aggregate(
        self, fc: t.FunctionCall, input_scope, add_agg, fc_filter=None
    ) -> RowExpr:
        """stddev/variance family and boolean aggregates composed from
        sum/count/min/max plus a post-aggregation expression. ``fc_filter``
        (the FILTER clause) applies to every sub-aggregate."""
        kind = fc.name
        arg = _fold(self._rewrite(fc.args[0], input_scope))
        if kind == "checksum":
            # order-insensitive: wrapping SUM of per-row 64-bit hashes.
            # (reference 'checksum' XORs hashes into a varbinary; BIGINT
            # output is a documented deviation). Strings hash by CONTENT
            # (str_hash64 dictionary table), not by code assignment.
            hash_fn = "str_hash64" if T.is_string(arg.type) else "hash64"
            hashed = call(hash_fn, T.BIGINT, arg)
            s = add_agg("sum", hashed, T.BIGINT, filt=fc_filter)
            # NULL only for EMPTY groups (all-NULL groups hash the NULLs)
            rows = add_agg("count_star", None, T.BIGINT, filt=fc_filter)
            return special(
                "if", T.BIGINT,
                call(
                    "gt", T.BOOLEAN,
                    variable(rows.name, T.BIGINT),
                    const(0, T.BIGINT),
                ),
                variable(s.name, T.BIGINT),
                Constant(type=T.BIGINT, value=None),
            )
        if kind in ("corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept"):
            # two-argument moments family composed from sums (reference:
            # CentralMomentsAggregation / CorrelationAggregation states)
            y = _coerce_to(arg, T.DOUBLE)
            x = _coerce_to(
                _fold(self._rewrite(fc.args[1], input_scope)), T.DOUBLE
            )
            both = call(
                "multiply", T.DOUBLE,
                special("if", T.DOUBLE, special("not", T.BOOLEAN, special("is_null", T.BOOLEAN, x)), y, Constant(type=T.DOUBLE, value=None)),
                const(1.0, T.DOUBLE),
            )
            xboth = call(
                "multiply", T.DOUBLE,
                special("if", T.DOUBLE, special("not", T.BOOLEAN, special("is_null", T.BOOLEAN, y)), x, Constant(type=T.DOUBLE, value=None)),
                const(1.0, T.DOUBLE),
            )
            sy = variable(add_agg("sum", both, T.DOUBLE, filt=fc_filter).name, T.DOUBLE)
            sx = variable(add_agg("sum", xboth, T.DOUBLE, filt=fc_filter).name, T.DOUBLE)
            sxy = variable(
                add_agg("sum", call("multiply", T.DOUBLE, x, y), T.DOUBLE, filt=fc_filter).name,
                T.DOUBLE,
            )
            sxx = variable(
                add_agg("sum", call("multiply", T.DOUBLE, xboth, xboth), T.DOUBLE, filt=fc_filter).name,
                T.DOUBLE,
            )
            syy = variable(
                add_agg("sum", call("multiply", T.DOUBLE, both, both), T.DOUBLE, filt=fc_filter).name,
                T.DOUBLE,
            )
            n = _coerce_to(
                variable(
                    add_agg("count", call("multiply", T.DOUBLE, x, y), T.BIGINT, filt=fc_filter).name,
                    T.BIGINT,
                ),
                T.DOUBLE,
            )
            cov_n = call(
                "subtract", T.DOUBLE,
                call("multiply", T.DOUBLE, n, sxy),
                call("multiply", T.DOUBLE, sx, sy),
            )
            var_x_n = call(
                "subtract", T.DOUBLE,
                call("multiply", T.DOUBLE, n, sxx),
                call("multiply", T.DOUBLE, sx, sx),
            )
            var_y_n = call(
                "subtract", T.DOUBLE,
                call("multiply", T.DOUBLE, n, syy),
                call("multiply", T.DOUBLE, sy, sy),
            )
            if kind == "covar_pop":
                expr = call(
                    "divide", T.DOUBLE, cov_n,
                    call("multiply", T.DOUBLE, n, n),
                )
                min_n = 0.0
            elif kind == "covar_samp":
                expr = call(
                    "divide", T.DOUBLE, cov_n,
                    call("multiply", T.DOUBLE, n,
                         call("subtract", T.DOUBLE, n, const(1.0, T.DOUBLE))),
                )
                min_n = 1.0
            elif kind == "regr_slope":
                expr = call("divide", T.DOUBLE, cov_n, var_x_n)
                min_n = 1.0
            elif kind == "regr_intercept":
                slope = call("divide", T.DOUBLE, cov_n, var_x_n)
                expr = call(
                    "divide", T.DOUBLE,
                    call("subtract", T.DOUBLE, sy,
                         call("multiply", T.DOUBLE, slope, sx)),
                    n,
                )
                min_n = 1.0
            else:  # corr
                expr = call(
                    "divide", T.DOUBLE, cov_n,
                    call(
                        "sqrt", T.DOUBLE,
                        call("multiply", T.DOUBLE, var_x_n, var_y_n),
                    ),
                )
                min_n = 1.0
            return special(
                "if", T.DOUBLE,
                call("gt", T.BOOLEAN, n, const(min_n, T.DOUBLE)),
                expr,
                Constant(type=T.DOUBLE, value=None),
            )
        if kind in ("bool_and", "every", "bool_or"):
            # NULL inputs are IGNORED by aggregates: map TRUE->1, FALSE->0,
            # NULL->NULL (the nested IF keeps NULL invalid, so min/max skip it)
            as_int = special(
                "if", T.BIGINT, arg, const(1, T.BIGINT),
                special(
                    "if", T.BIGINT, special("not", T.BOOLEAN, arg),
                    const(0, T.BIGINT), Constant(type=T.BIGINT, value=None),
                ),
            )
            agg_kind = "min" if kind in ("bool_and", "every") else "max"
            s = add_agg(agg_kind, as_int, T.BIGINT, filt=fc_filter)
            return call("eq", T.BOOLEAN, variable(s.name, T.BIGINT), const(1, T.BIGINT))
        # variance family over doubles
        xd = _coerce_to(arg, T.DOUBLE)
        s_sum = add_agg("sum", xd, T.DOUBLE, filt=fc_filter)
        s_sq = add_agg(
            "sum", call("multiply", T.DOUBLE, xd, xd), T.DOUBLE, filt=fc_filter
        )
        s_cnt = add_agg("count", xd, T.BIGINT, filt=fc_filter)
        n = _coerce_to(variable(s_cnt.name, T.BIGINT), T.DOUBLE)
        sum_v = variable(s_sum.name, T.DOUBLE)
        sq_v = variable(s_sq.name, T.DOUBLE)
        # m2 = sum(x^2) - sum(x)^2 / n
        m2 = call(
            "subtract", T.DOUBLE, sq_v,
            call("divide", T.DOUBLE, call("multiply", T.DOUBLE, sum_v, sum_v), n),
        )
        pop = kind in ("var_pop", "stddev_pop")
        denom = (
            n if pop else call("subtract", T.DOUBLE, n, const(1.0, T.DOUBLE))
        )
        var_expr = call("divide", T.DOUBLE, m2, denom)
        # NULL when n == 0 (pop) or n <= 1 (samp), per reference semantics
        min_n = const(0.0 if pop else 1.0, T.DOUBLE)
        guarded = special(
            "if", T.DOUBLE,
            call("gt", T.BOOLEAN, n, min_n),
            var_expr,
            Constant(type=T.DOUBLE, value=None),
        )
        if kind in ("stddev", "stddev_samp", "stddev_pop"):
            return call("sqrt", T.DOUBLE, guarded)
        return guarded

    # ==== decorrelation =================================================
    # (_conjuncts_of lives at module scope below)

    def _produced_symbols(self, node: P.PlanNode) -> set[str]:
        out: set[str] = set()

        def walk(n: P.PlanNode):
            for s in n.output_symbols:
                out.add(s.name)
            for src in n.sources:
                walk(src)

        walk(node)
        return out

    def _decorrelate(self, node: P.PlanNode, produced: set[str], ctx: dict):
        """Strip Filter conjuncts referencing symbols outside ``produced``
        (correlated references to the enclosing query) and hoist them to the
        top, adding pass-through projections so inner symbols the conjuncts
        need stay visible. A correlated filter below a global Aggregate
        turns its inner equality symbols into group keys (classic
        decorrelation; ``ctx['grouped']`` records it so the caller joins
        LEFT and fixes COUNT-over-empty). Reference: the effect of Trino's
        TransformCorrelated* rule family (iterative/rule/).

        Returns (new_node, corr_conjuncts: list[RowExpr])."""
        if isinstance(node, P.Filter):
            src, corr = self._decorrelate(node.source, produced, ctx)
            keep: list[RowExpr] = []
            for c in _conjuncts_of(node.predicate):
                if referenced_variables(c) - produced:
                    corr = corr + [c]
                else:
                    keep.append(c)
            if keep:
                pred = keep[0]
                for k in keep[1:]:
                    pred = special("and", T.BOOLEAN, pred, k)
                return P.Filter(src, pred), corr
            return src, corr

        if isinstance(node, P.Project):
            src, corr = self._decorrelate(node.source, produced, ctx)
            if not corr:
                return P.Project(src, node.assignments), corr
            # pass through inner symbols the hoisted conjuncts reference
            available = {s.name: s for s in src.output_symbols}
            have = {s.name for s, _ in node.assignments}
            extra = []
            for c in corr:
                for r in referenced_variables(c):
                    if r in produced and r not in have and r in available:
                        sym = available[r]
                        extra.append((sym, variable(sym.name, sym.type)))
                        have.add(r)
            return P.Project(src, list(node.assignments) + extra), corr

        if isinstance(node, P.Join):
            lsrc, lcorr = self._decorrelate(node.left, produced, ctx)
            rsrc, rcorr = self._decorrelate(node.right, produced, ctx)
            out = P.Join(
                node.join_type, lsrc, rsrc, node.criteria, node.filter,
                node.distribution, node.mark_symbol,
            )
            return out, lcorr + rcorr

        if isinstance(node, P.Aggregate):
            src, corr = self._decorrelate(node.source, produced, ctx)
            if not corr:
                return P.Aggregate(src, node.group_keys, node.aggregates, node.step), corr
            if node.group_keys:
                raise SemanticError(
                    "correlated subquery with GROUP BY is not supported"
                )
            # global agg over correlated filter: group by the inner symbols
            # of the correlated EQUALITIES. Non-equality correlated
            # predicates cannot be hoisted above the aggregate (they would
            # filter after aggregation, changing its input) — reject.
            available = {s.name: s for s in src.output_symbols}
            keys: list[P.Symbol] = []
            for c in corr:
                is_eq = (
                    isinstance(c, Call)
                    and c.name == "eq"
                    and len(c.args) == 2
                    and all(isinstance(a, Variable) for a in c.args)
                )
                if not is_eq:
                    raise SemanticError(
                        "correlated aggregate subquery supports only "
                        "equality correlation predicates"
                    )
                for r in referenced_variables(c):
                    if r in produced:
                        if r not in available:
                            raise SemanticError(
                                "correlated reference not available for decorrelation"
                            )
                        if available[r] not in keys:
                            keys.append(available[r])
            ctx["grouped"] = True
            ctx["agg_kinds"] = {
                s.name: fn.kind for s, fn in node.aggregates
            }
            return P.Aggregate(src, keys, node.aggregates, node.step), corr

        if isinstance(node, P.Sort):
            src, corr = self._decorrelate(node.source, produced, ctx)
            return P.Sort(src, node.order_by), corr

        # correlation below cardinality-changing nodes cannot be hoisted
        has_corr_below = self._has_correlated_filter(node, produced)
        if has_corr_below:
            raise SemanticError(
                f"correlated subquery through {type(node).__name__} is not supported"
            )
        return node, []

    def _has_correlated_filter(self, node: P.PlanNode, produced: set[str]) -> bool:
        if isinstance(node, P.Filter):
            for c in _conjuncts_of(node.predicate):
                if referenced_variables(c) - produced:
                    return True
        return any(self._has_correlated_filter(s, produced) for s in node.sources)

    def _trace_agg_kind(self, node: P.PlanNode, name: str, ctx: dict) -> Optional[str]:
        """Follow identity projections from ``name`` down to an Aggregate
        output and return its aggregate kind (for COUNT-coalesce fixes)."""
        kinds = ctx.get("agg_kinds", {})
        while True:
            if name in kinds:
                return kinds[name]
            if isinstance(node, P.Project):
                nxt = None
                for s, e in node.assignments:
                    if s.name == name and isinstance(e, Variable):
                        nxt = e.name
                        break
                if nxt is None:
                    return None
                name = nxt
                node = node.source
                continue
            if isinstance(node, (P.Filter, P.Sort)):
                node = node.source
                continue
            return kinds.get(name)

    def _split_correlation(
        self, corr: list[RowExpr], outer_syms: dict, inner_syms: dict
    ):
        """Split hoisted conjuncts into equi-join criteria (outer, inner)
        and residual filter conjuncts."""
        criteria: list[tuple[P.Symbol, P.Symbol]] = []
        residual: list[RowExpr] = []
        for c in corr:
            pair = None
            if isinstance(c, Call) and c.name == "eq" and len(c.args) == 2:
                a, b = c.args
                if isinstance(a, Variable) and isinstance(b, Variable):
                    if a.name in outer_syms and b.name in inner_syms:
                        pair = (outer_syms[a.name], inner_syms[b.name])
                    elif b.name in outer_syms and a.name in inner_syms:
                        pair = (outer_syms[b.name], inner_syms[a.name])
            if pair is not None:
                criteria.append(pair)
            else:
                residual.append(c)
        return criteria, residual

    # ==== subqueries in expressions =====================================
    def _rewrite_with_subqueries(
        self, e: t.Node, rp: RelationPlan, replacements=None
    ):
        """Rewrite an expression, planning any subqueries into the relation:
        - uncorrelated scalar subquery -> CROSS join of single-row subplan
        - [NOT] IN (subquery) / EXISTS -> SEMI/ANTI join with mark symbol
        Returns (RowExpr, updated RelationPlan)."""
        state = {"rp": rp}

        def combine(conj: list[RowExpr]) -> Optional[RowExpr]:
            if not conj:
                return None
            out = conj[0]
            for c in conj[1:]:
                out = special("and", T.BOOLEAN, out, c)
            return out

        def plan_sub(query: t.Query):
            """Plan a subquery allowing correlated outer references; returns
            (decorrelated plan, criteria, residual filter, ctx). ctx carries
            'n_columns': the subquery's own column count (decorrelation may
            append pass-through columns after it)."""
            cur = state["rp"]
            sub_rp, _ = self.plan_query(query, outer=cur.scope)
            produced = self._produced_symbols(sub_rp.node)
            ctx: dict = {"n_columns": len(sub_rp.node.output_symbols)}
            new_sub, corr = self._decorrelate(sub_rp.node, produced, ctx)
            outer_syms = {s.name: s for s in cur.node.output_symbols}
            inner_syms = {s.name: s for s in new_sub.output_symbols}
            criteria, residual = self._split_correlation(corr, outer_syms, inner_syms)
            for c in residual:
                bad = referenced_variables(c) - set(outer_syms) - set(inner_syms)
                if bad:
                    raise SemanticError(
                        f"correlated reference not resolvable: {sorted(bad)}"
                    )
            return new_sub, criteria, residual, ctx

        def handle(node: t.Node) -> Optional[RowExpr]:
            if isinstance(node, t.ScalarSubquery):
                new_sub, criteria, residual, ctx = plan_sub(node.query)
                if ctx["n_columns"] != 1:
                    raise SemanticError("scalar subquery must return one column")
                # scalar output = the subquery's first (only) select column
                out_sym = new_sub.output_symbols[0]
                cur = state["rp"]
                if not criteria and not residual:
                    join = P.Join(
                        "CROSS", cur.node, new_sub, [], single_row=True
                    )
                    state["rp"] = RelationPlan(join, cur.scope)
                    return variable(out_sym.name, out_sym.type)
                # correlated scalar: LEFT join on the correlation keys;
                # >1 match per outer row is a runtime error
                join = P.Join(
                    "LEFT", cur.node, new_sub, criteria,
                    combine(residual), None, None, single_row=True,
                )
                state["rp"] = RelationPlan(join, cur.scope)
                result = variable(out_sym.name, out_sym.type)
                kind = self._trace_agg_kind(new_sub, out_sym.name, ctx)
                if ctx.get("grouped") and kind in ("count", "count_star"):
                    # COUNT over an empty correlated group is 0, but the
                    # LEFT join yields NULL for unmatched outer rows
                    result = special(
                        "coalesce", out_sym.type, result,
                        const(0, out_sym.type),
                    )
                return result
            if isinstance(node, (t.InSubquery, t.Exists)):
                cur = state["rp"]
                if isinstance(node, t.InSubquery):
                    new_sub, criteria, residual, _ctx = plan_sub(node.query)
                    if _ctx["n_columns"] != 1:
                        raise SemanticError("IN subquery must return one column")
                    syms = new_sub.output_symbols
                    value = self._rewrite(node.value, cur.scope)
                    cur = state["rp"]
                    if not isinstance(value, Variable):
                        vsym = P.Symbol(P.fresh_name("inval"), value.type)
                        proj = P.Project(
                            cur.node,
                            [
                                (s, variable(s.name, s.type))
                                for s in cur.node.output_symbols
                            ]
                            + [(vsym, value)],
                        )
                        cur = RelationPlan(proj, cur.scope)
                        value = variable(vsym.name, vsym.type)
                    mark = P.Symbol(P.fresh_name("in_mark"), T.BOOLEAN)
                    jt = "ANTI" if node.negated else "SEMI"
                    join = P.Join(
                        jt,
                        cur.node,
                        new_sub,
                        [(P.Symbol(value.name, value.type), syms[0])] + criteria,
                        combine(residual),
                        mark_symbol=mark,
                    )
                    state["rp"] = RelationPlan(join, cur.scope)
                    return variable(mark.name, T.BOOLEAN)
                # EXISTS (correlated or not): SEMI/ANTI join on correlation
                new_sub, criteria, residual, _ctx = plan_sub(node.query)
                cur = state["rp"]
                mark = P.Symbol(P.fresh_name("exists_mark"), T.BOOLEAN)
                join = P.Join(
                    "SEMI" if not node.negated else "ANTI",
                    cur.node,
                    new_sub,
                    criteria,
                    combine(residual),
                    mark_symbol=mark,
                    null_aware=False,  # EXISTS is two-valued
                )
                state["rp"] = RelationPlan(join, cur.scope)
                return variable(mark.name, T.BOOLEAN)
            return None

        ex = self._rewrite(
            e,
            rp.scope,
            replacements=replacements,
            subquery_handler=handle,
            scope_getter=lambda: state["rp"].scope,
        )
        return ex, state["rp"]

    # ==== AST normalization =============================================
    def _normalize(self, e: t.Node, scope: Scope) -> t.Node:
        """Canonicalize an AST expression for structural matching: every
        resolvable Identifier becomes Identifier((symbol_name,)) so that
        'X' vs 'x' vs 't.x' compare equal (name resolution is
        case-insensitive; structural dataclass equality is not). Subquery
        bodies are left untouched (their identifiers resolve in inner
        scopes)."""
        if isinstance(e, t.Identifier):
            sym = scope.try_resolve(e.parts)
            if sym is not None:
                return t.Identifier((sym.name,))
            return t.Identifier(tuple(p.lower() for p in e.parts))
        if isinstance(e, (t.ScalarSubquery, t.InSubquery, t.Exists, t.Query)):
            return e
        if dataclasses.is_dataclass(e) and isinstance(e, t.Node):
            changes = {}
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, t.Node):
                    changes[f.name] = self._normalize(v, scope)
                elif isinstance(v, tuple):
                    new_items = tuple(
                        self._normalize(item, scope)
                        if isinstance(item, t.Node)
                        else (
                            tuple(
                                self._normalize(sub, scope)
                                if isinstance(sub, t.Node)
                                else sub
                                for sub in item
                            )
                            if isinstance(item, tuple)
                            else item
                        )
                        for item in v
                    )
                    changes[f.name] = new_items
            if changes:
                return dataclasses.replace(e, **changes)
        return e

    # ==== expression rewriting ==========================================
    def _rewrite(
        self,
        e: t.Node,
        scope: Scope,
        replacements: Optional[dict[t.Node, P.Symbol]] = None,
        subquery_handler=None,
        scope_getter=None,
    ) -> RowExpr:
        def rw(node: t.Node) -> RowExpr:
            if replacements is not None and node in replacements:
                s = replacements[node]
                return variable(s.name, s.type)
            if subquery_handler is not None:
                out = subquery_handler(node)
                if out is not None:
                    return out
            cur_scope = scope_getter() if scope_getter is not None else scope
            return self._rewrite_node(node, cur_scope, rw)

        return rw(e)

    def _rewrite_node(self, e: t.Node, scope: Scope, rw) -> RowExpr:
        if isinstance(e, t.Identifier):
            sym = scope.resolve(e.parts)
            return variable(sym.name, sym.type)
        if isinstance(e, t.Literal):
            return _literal(e)
        if isinstance(e, t.ArrayLiteral):
            # constant element lists fold into an ARRAY Constant whose value
            # is a tuple of STORAGE scalars (None = NULL element)
            items = [_fold(rw(it)) for it in e.items]
            et: T.SqlType = T.UNKNOWN
            for it in items:
                et = T.common_super_type(et, it.type) or et
            if isinstance(et, T.UnknownType):
                et = T.BIGINT
            coerced = [_fold(_coerce_to(it, et)) for it in items]
            if not all(isinstance(it, Constant) for it in coerced):
                raise SemanticError(
                    "ARRAY constructor elements must be constant (v1)"
                )
            return Constant(
                type=T.ArrayType(element=et),
                value=tuple(it.value for it in coerced),
            )
        if isinstance(e, t.Subscript):
            base = rw(e.base)
            idx = _fold(rw(e.index))
            bt = base.type
            if isinstance(bt, T.ArrayType):
                return call(
                    "element_at", bt.element, base, _coerce_to(idx, T.BIGINT)
                )
            if isinstance(bt, T.MapType):
                return call(
                    "map_element_at", bt.value, base, _coerce_to(idx, bt.key)
                )
            if isinstance(bt, T.RowType):
                if not isinstance(idx, Constant) or idx.value is None:
                    raise SemanticError("ROW subscript must be a constant")
                i = int(idx.value)
                if not 1 <= i <= len(bt.fields):
                    raise SemanticError(
                        f"ROW subscript {i} out of range 1..{len(bt.fields)}"
                    )
                return call(
                    "row_field", bt.fields[i - 1][1], base,
                    Constant(type=T.BIGINT, value=i),
                )
            raise SemanticError(
                f"subscript requires ARRAY, MAP, or ROW (got {bt})"
            )
        if isinstance(e, t.IntervalLiteral):
            return Constant(type=T.UNKNOWN, value=e)  # consumed by date arith
        if isinstance(e, t.UnaryOp):
            operand = rw(e.operand)
            if e.op == "NOT":
                return special("not", T.BOOLEAN, operand)
            if e.op == "-":
                return call("negate", operand.type, operand)
            return operand
        if isinstance(e, t.BinaryOp):
            return self._binary(e, rw)
        if isinstance(e, t.IsNull):
            inner = special("is_null", T.BOOLEAN, rw(e.operand))
            return special("not", T.BOOLEAN, inner) if e.negated else inner
        if isinstance(e, t.Between):
            v, lo, hi = rw(e.value), rw(e.low), rw(e.high)
            v, lo = _coerce_pair(v, lo)
            v, hi = _coerce_pair(v, hi)
            out = special("between", T.BOOLEAN, v, lo, hi)
            return special("not", T.BOOLEAN, out) if e.negated else out
        if isinstance(e, t.InList):
            v = rw(e.value)
            items = []
            for item in e.items:
                iv = rw(item)
                _, iv = _coerce_pair(v, iv)
                items.append(iv)
            out = special("in", T.BOOLEAN, v, *items)
            return special("not", T.BOOLEAN, out) if e.negated else out
        if isinstance(e, t.Like):
            v = rw(e.value)
            p = rw(e.pattern)
            if not isinstance(p, Constant):
                raise SemanticError("LIKE pattern must be constant")
            out = call("like", T.BOOLEAN, v, p)
            return special("not", T.BOOLEAN, out) if e.negated else out
        if isinstance(e, t.Cast):
            operand = rw(e.operand)
            target = T.parse_type(e.target)
            if isinstance(operand, Constant) and operand.type == T.UNKNOWN:
                return Constant(type=target, value=None)
            if isinstance(operand, Constant) and T.is_string(target):
                v = operand.value
                if v is None:
                    return Constant(type=target, value=None)
                if isinstance(operand.type, T.DecimalType):
                    from decimal import Decimal as _D

                    # scaleb keeps the declared scale: 1.50 -> '1.50'
                    s = str(_D(v).scaleb(-operand.type.scale))
                elif isinstance(operand.type, T.BooleanType):
                    s = "true" if v else "false"
                else:
                    s = str(v)
                return Constant(type=target, value=s)
            if isinstance(operand, Constant) and T.is_string(operand.type):
                if e.safe:
                    # TRY_CAST: invalid conversion yields NULL, not an error
                    # (ArithmeticError covers decimal.InvalidOperation)
                    try:
                        return _cast_string_constant(operand, target)
                    except (ValueError, ArithmeticError, SemanticError):
                        return Constant(type=target, value=None)
                return _cast_string_constant(operand, target)
            return call("cast", target, operand)
        if isinstance(e, t.Extract):
            operand = rw(e.operand)
            field = {"dow": "day_of_week", "doy": "day_of_year",
                     "day_of_week": "day_of_week", "day_of_year": "day_of_year",
                     "week": "week", "quarter": "quarter"}.get(e.field, e.field)
            if field not in ("year", "month", "day", "day_of_week",
                             "day_of_year", "week", "quarter"):
                raise SemanticError(f"EXTRACT({e.field}) unsupported")
            return call(field, T.BIGINT, operand)
        if isinstance(e, t.Case):
            return self._case(e, rw)
        if isinstance(e, t.FunctionCall):
            return self._function(e, rw)
        if isinstance(e, t.QuantifiedComparison):
            return rw(_expand_quantified(e))
        if isinstance(e, t.ScalarSubquery):
            raise SemanticError("scalar subquery not allowed in this context")
        if isinstance(e, (t.InSubquery, t.Exists)):
            raise SemanticError("subquery predicate not allowed in this context")
        raise SemanticError(f"unsupported expression: {type(e).__name__}")

    def _case(self, e: t.Case, rw) -> RowExpr:
        whens = []
        result_type: Optional[T.SqlType] = None
        results = []
        for cond_ast, res_ast in e.whens:
            res = rw(res_ast)
            results.append(res)
            result_type = (
                res.type
                if result_type is None
                else (T.common_super_type(result_type, res.type) or result_type)
            )
        default = rw(e.default) if e.default is not None else None
        if default is not None:
            result_type = T.common_super_type(result_type, default.type) or result_type
        if e.operand is not None:
            op = rw(e.operand)
            conds = [
                _make_comparison("eq", op, rw(c_ast)) for c_ast, _ in e.whens
            ]
        else:
            conds = [rw(c_ast) for c_ast, _ in e.whens]
        out = (
            _coerce_to(default, result_type)
            if default is not None
            else Constant(type=result_type, value=None)
        )
        for cond, res in reversed(list(zip(conds, results))):
            out = special("if", result_type, cond, _coerce_to(res, result_type), out)
        return out

    def _function(self, e: t.FunctionCall, rw) -> RowExpr:
        if e.window is not None:
            raise SemanticError("window functions not yet supported in this context")
        name = e.name
        if name in ("sum", "count", "avg", "min", "max"):
            raise SemanticError(f"aggregate {name} not allowed here")
        args = [rw(a) for a in e.args]
        if name == "coalesce":
            rt = args[0].type
            for a in args[1:]:
                rt = T.common_super_type(rt, a.type) or rt
            return special(
                "coalesce", rt, *[_coerce_to(a, rt) for a in args]
            )
        if name == "nullif":
            a, b = _coerce_pair(args[0], args[1])
            return special("null_if", a.type, a, b)
        if name == "abs":
            return call("abs", args[0].type, args[0])
        if name == "sqrt":
            return call("sqrt", T.DOUBLE, _coerce_to(args[0], T.DOUBLE))
        if name in ("floor", "ceil", "ceiling"):
            n = "ceil" if name == "ceiling" else name
            return call(n, args[0].type, args[0])
        if name == "round":
            return call("round", args[0].type, *args)
        if name in ("year", "month", "day"):
            return call(name, T.BIGINT, args[0])
        if name == "mod":
            a, b = _coerce_pair(args[0], args[1])
            return call("modulus", a.type, a, b)
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
            return call(
                name, T.BIGINT,
                _coerce_to(args[0], T.BIGINT), _coerce_to(args[1], T.BIGINT),
            )
        if name == "bitwise_not":
            return call(name, T.BIGINT, _coerce_to(args[0], T.BIGINT))
        if name in ("bitwise_left_shift", "bitwise_right_shift",
                    "bitwise_right_shift_arithmetic", "shiftleft", "shiftright"):
            canon = {
                "shiftleft": "bitwise_left_shift",
                "shiftright": "bitwise_right_shift",
            }.get(name, name)
            return call(
                canon, T.BIGINT,
                _coerce_to(args[0], T.BIGINT), _coerce_to(args[1], T.BIGINT),
            )
        if name == "hash64":
            return call("hash64", T.BIGINT, _coerce_to(args[0], T.BIGINT))
        if name == "width_bucket":
            return call(
                "width_bucket", T.BIGINT,
                _coerce_to(args[0], T.DOUBLE), _coerce_to(args[1], T.DOUBLE),
                _coerce_to(args[2], T.DOUBLE), _coerce_to(args[3], T.BIGINT),
            )
        if name in ("format_datetime", "date_format"):
            if not isinstance(args[1], Constant):
                raise SemanticError(f"{name} pattern must be a literal")
            return call(name, T.VARCHAR, args[0], args[1])
        if name in ("json_extract_scalar", "json_extract"):
            return call(name, T.VARCHAR, *args)
        if name == "cardinality":
            if isinstance(args[0].type, T.MapType):
                return call("map_cardinality", T.BIGINT, args[0])
            if not isinstance(args[0].type, T.ArrayType):
                raise SemanticError(
                    "cardinality requires an ARRAY or MAP argument"
                )
            return call("cardinality", T.BIGINT, args[0])
        if name == "element_at":
            if isinstance(args[0].type, T.MapType):
                mt = args[0].type
                return call(
                    "map_element_at", mt.value, args[0],
                    _coerce_to(args[1], mt.key),
                )
            if not isinstance(args[0].type, T.ArrayType):
                raise SemanticError(
                    "element_at requires an ARRAY or MAP argument"
                )
            return call(
                "element_at", args[0].type.element, args[0],
                _coerce_to(args[1], T.BIGINT),
            )
        if name == "map":
            # MAP(ARRAY[k...], ARRAY[v...]) constructor (constant v1, like
            # the ARRAY constructor) -> pool-coded MAP constant
            if len(args) != 2 or not all(
                isinstance(a, Constant) and isinstance(a.type, T.ArrayType)
                for a in args
            ):
                raise SemanticError(
                    "map() requires two constant ARRAY arguments (v1)"
                )
            karr, varr = args
            if karr.value is None or varr.value is None:
                raise SemanticError("map() arrays must be non-null")
            if len(karr.value) != len(varr.value):
                raise SemanticError("map() key/value arrays differ in length")
            if any(k is None for k in karr.value):
                raise SemanticError("map key cannot be null")
            if len(set(karr.value)) != len(karr.value):
                raise SemanticError("Duplicate map keys are not allowed")
            # canonical key order: equality/grouping compare pool codes, so
            # equal maps must pool identically regardless of build order
            pairs = tuple(sorted(zip(karr.value, varr.value), key=lambda p: p[0]))
            return Constant(
                type=T.MapType(key=karr.type.element, value=varr.type.element),
                value=pairs,
            )
        if name == "map_keys" or name == "map_values":
            # producing a NEW pool column from an expression needs the
            # projection-level pool plumbing; not wired yet
            raise SemanticError(f"{name} is not supported yet")
        if name == "row":
            if not all(isinstance(a, Constant) for a in args):
                raise SemanticError("row() fields must be constant (v1)")
            return Constant(
                type=T.RowType(
                    fields=tuple((None, a.type) for a in args)
                ),
                value=tuple(a.value for a in args),
            )
        if name == "contains":
            if not isinstance(args[0].type, T.ArrayType):
                raise SemanticError("contains requires an ARRAY argument")
            return call(
                "array_contains", T.BOOLEAN, args[0],
                _coerce_to(args[1], args[0].type.element),
            )
        if name == "power" or name == "pow":
            return call(
                "power",
                T.DOUBLE,
                _coerce_to(args[0], T.DOUBLE),
                _coerce_to(args[1], T.DOUBLE),
            )
        if name == "length":
            if isinstance(args[0], Constant):
                v = args[0].value
                return Constant(
                    type=T.BIGINT, value=None if v is None else len(str(v))
                )
            return call("length", T.BIGINT, args[0])
        if name in ("substr", "substring"):
            return call("substr", T.VARCHAR, *args)
        if name in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse"):
            if not T.is_string(args[0].type):
                raise SemanticError(f"{name} requires a string argument")
            return call(name, T.VARCHAR, args[0])
        if name == "replace":
            if len(args) == 2:
                args = args + [const("", T.VARCHAR)]
            return call("replace", T.VARCHAR, *args)
        if name == "concat":
            for a in args:
                if not T.is_string(a.type) and a.type != T.UNKNOWN:
                    raise SemanticError(
                        "concat requires varchar arguments (add a cast)"
                    )
            return call("concat", T.VARCHAR, *args)
        if name in ("lpad", "rpad"):
            return call(name, T.VARCHAR, *args)
        if name == "strpos":
            if isinstance(args[0], Constant) and isinstance(args[1], Constant):
                a, b = args[0].value, args[1].value
                v = None if a is None or b is None else str(a).find(str(b)) + 1
                return Constant(type=T.BIGINT, value=v)
            return call("strpos", T.BIGINT, *args)
        if name == "split_part":
            return call("split_part", T.VARCHAR, *args)
        if name == "starts_with":
            if isinstance(args[0], Constant) and isinstance(args[1], Constant):
                a, b = args[0].value, args[1].value
                v = None if a is None or b is None else str(a).startswith(str(b))
                return Constant(type=T.BOOLEAN, value=v)
            return call("starts_with", T.BOOLEAN, *args)
        if name == "date":
            return call("cast", T.DATE, args[0])
        if name == "date_add":
            unit_c, n_e, d_e = args
            if not isinstance(unit_c, Constant):
                raise SemanticError("date_add unit must be a literal")
            unit = str(unit_c.value).lower().rstrip("s")
            if isinstance(d_e.type, T.TimestampType):
                us = {"second": 10**6, "minute": 60 * 10**6, "hour": 3600 * 10**6,
                      "day": 86_400 * 10**6, "week": 7 * 86_400 * 10**6}
                if unit in us:
                    return call(
                        "add", T.TIMESTAMP, d_e,
                        call("multiply", T.BIGINT, _coerce_to(n_e, T.BIGINT),
                             const(us[unit], T.BIGINT)),
                    )
                raise SemanticError(f"date_add unit {unit} on timestamp unsupported")
            if unit == "day":
                return call("date_add_days", T.DATE, d_e, n_e)
            if unit == "week":
                return call(
                    "date_add_days", T.DATE, d_e,
                    call("multiply", T.BIGINT, _coerce_to(n_e, T.BIGINT), const(7, T.BIGINT)),
                )
            if unit == "month":
                return call("date_add_months", T.DATE, d_e, n_e)
            if unit == "quarter":
                return call(
                    "date_add_months", T.DATE, d_e,
                    call("multiply", T.BIGINT, _coerce_to(n_e, T.BIGINT), const(3, T.BIGINT)),
                )
            if unit == "year":
                return call(
                    "date_add_months", T.DATE, d_e,
                    call("multiply", T.BIGINT, _coerce_to(n_e, T.BIGINT), const(12, T.BIGINT)),
                )
            raise SemanticError(f"date_add unit {unit} unsupported")
        if name == "date_diff":
            unit_c, a_e, b_e = args
            if not isinstance(unit_c, Constant):
                raise SemanticError("date_diff unit must be a literal")
            unit = str(unit_c.value).lower().rstrip("s")
            if isinstance(a_e.type, T.TimestampType) or isinstance(b_e.type, T.TimestampType):
                us = {"second": 10**6, "minute": 60 * 10**6, "hour": 3600 * 10**6,
                      "day": 86_400 * 10**6, "week": 7 * 86_400 * 10**6,
                      "millisecond": 1000}
                if unit in us:
                    diff = call("subtract", T.BIGINT, _coerce_to(b_e, T.TIMESTAMP), _coerce_to(a_e, T.TIMESTAMP))
                    return call(
                        "divide", T.BIGINT, diff, const(us[unit], T.BIGINT)
                    )
                raise SemanticError(f"date_diff unit {unit} on timestamp unsupported")
            day_diff = call("date_diff_days", T.BIGINT, a_e, b_e)
            if unit == "day":
                return day_diff
            if unit == "week":
                return call("divide", T.BIGINT, day_diff, const(7, T.BIGINT))
            if unit in ("month", "quarter", "year"):
                cal = call(
                    "subtract", T.BIGINT,
                    call(
                        "add", T.BIGINT,
                        call("multiply", T.BIGINT, call("year", T.BIGINT, b_e), const(12, T.BIGINT)),
                        call("month", T.BIGINT, b_e),
                    ),
                    call(
                        "add", T.BIGINT,
                        call("multiply", T.BIGINT, call("year", T.BIGINT, a_e), const(12, T.BIGINT)),
                        call("month", T.BIGINT, a_e),
                    ),
                )
                da = call("day", T.BIGINT, a_e)
                db = call("day", T.BIGINT, b_e)
                # truncate toward zero to FULL months elapsed (reference
                # semantics): forward diffs lose 1 when day(b) < day(a),
                # backward diffs gain 1 when day(b) > day(a)
                months = call(
                    "add", T.BIGINT, cal,
                    special(
                        "if", T.BIGINT,
                        special(
                            "and", T.BOOLEAN,
                            call("gt", T.BOOLEAN, cal, const(0, T.BIGINT)),
                            call("lt", T.BOOLEAN, db, da),
                        ),
                        const(-1, T.BIGINT),
                        special(
                            "if", T.BIGINT,
                            special(
                                "and", T.BOOLEAN,
                                call("lt", T.BOOLEAN, cal, const(0, T.BIGINT)),
                                call("gt", T.BOOLEAN, db, da),
                            ),
                            const(1, T.BIGINT),
                            const(0, T.BIGINT),
                        ),
                    ),
                )
                if unit == "month":
                    return months
                if unit == "quarter":
                    return call("divide", T.BIGINT, months, const(3, T.BIGINT))
                return call("divide", T.BIGINT, months, const(12, T.BIGINT))
            raise SemanticError(f"date_diff unit {unit} unsupported")
        if name in ("day_of_week", "dow", "day_of_year", "doy", "week",
                    "week_of_year", "quarter", "last_day_of_month"):
            canon = {"dow": "day_of_week", "doy": "day_of_year",
                     "week_of_year": "week"}.get(name, name)
            rt = T.DATE if canon == "last_day_of_month" else T.BIGINT
            return call(canon, rt, args[0])
        if name == "from_unixtime":
            return call(
                "multiply", T.TIMESTAMP,
                _coerce_to(args[0], T.BIGINT), const(1_000_000, T.BIGINT),
            )
        if name == "concat_ws":
            sep = args[0]
            if not isinstance(sep, Constant):
                raise SemanticError("concat_ws separator must be a literal")
            # KNOWN DEVIATION: the reference SKIPS NULL arguments; this
            # desugar NULL-propagates like concat (see README deviations)
            parts: list[RowExpr] = []
            for i, a in enumerate(args[1:]):
                if i:
                    parts.append(sep)
                parts.append(a)
            return call("concat", T.VARCHAR, *parts)
        if name == "repeat":
            if isinstance(args[0], Constant) and isinstance(args[1], Constant):
                v, k = args[0].value, args[1].value
                return Constant(
                    type=T.VARCHAR,
                    value=None if v is None or k is None else str(v) * int(k),
                )
            return call("repeat", T.VARCHAR, *args)
        if name in _MATH_DOUBLE_FNS:
            return call(name, T.DOUBLE, _coerce_to(args[0], T.DOUBLE))
        if name == "log":
            # log(b, x) = ln(x)/ln(b)
            b = _coerce_to(args[0], T.DOUBLE)
            x = _coerce_to(args[1], T.DOUBLE)
            return call(
                "divide", T.DOUBLE, call("ln", T.DOUBLE, x), call("ln", T.DOUBLE, b)
            )
        if name == "atan2":
            return call(
                "atan2", T.DOUBLE,
                _coerce_to(args[0], T.DOUBLE), _coerce_to(args[1], T.DOUBLE),
            )
        if name == "pi":
            import math

            return Constant(type=T.DOUBLE, value=math.pi)
        if name == "e":
            import math

            return Constant(type=T.DOUBLE, value=math.e)
        if name == "sign":
            return call("sign", args[0].type, args[0])
        if name == "truncate":
            return call("truncate", args[0].type, _coerce_to(args[0], T.DOUBLE))
        if name in ("greatest", "least"):
            rt = args[0].type
            for a in args[1:]:
                rt = T.common_super_type(rt, a.type) or rt
            return call(name, rt, *[_coerce_to(a, rt) for a in args])
        if name == "chr":
            if isinstance(args[0], Constant):
                v = args[0].value
                return Constant(
                    type=T.VARCHAR, value=None if v is None else chr(int(v))
                )
            raise SemanticError("chr over non-constant values not supported")
        if name in ("codepoint", "ascii"):
            if isinstance(args[0], Constant):
                v = args[0].value
                return Constant(
                    type=T.BIGINT,
                    value=None if not v else ord(str(v)[0]),
                )
            return call("codepoint", T.BIGINT, args[0])
        if name == "regexp_like":
            if isinstance(args[0], Constant) and isinstance(args[1], Constant):
                import re as _re

                a, p = args[0].value, args[1].value
                v = (
                    None
                    if a is None or p is None
                    else _re.search(str(p), str(a)) is not None
                )
                return Constant(type=T.BOOLEAN, value=v)
            return call("regexp_like", T.BOOLEAN, *args)
        if name in ("regexp_replace", "regexp_extract"):
            # string->string: lowered host-side over the dictionary
            return call(name, T.VARCHAR, *args)
        if name == "date_trunc":
            if not isinstance(args[0], Constant):
                raise SemanticError("date_trunc unit must be a literal")
            return call("date_trunc", args[1].type, args[0], args[1])
        if name in ("current_date", "now", "current_timestamp", "localtimestamp"):
            import time as _time

            if name == "current_date":
                return Constant(
                    type=T.DATE, value=int(_time.time() // 86400)
                )
            return Constant(
                type=T.TIMESTAMP, value=int(_time.time() * 1_000_000)
            )
        if name == "format":
            # printf-style over constants only in v1
            if all(isinstance(a, Constant) for a in args):
                fmt = str(args[0].value)
                vals = [a.value for a in args[1:]]
                return Constant(type=T.VARCHAR, value=fmt % tuple(vals))
            raise SemanticError("format over non-constant values not supported")
        raise SemanticError(f"unknown function: {name}")

    def _binary(self, e: t.BinaryOp, rw) -> RowExpr:
        op = e.op
        if op in ("AND", "OR"):
            return special(op.lower(), T.BOOLEAN, rw(e.left), rw(e.right))
        left = rw(e.left)
        right = rw(e.right)
        if op in ("=", "<>", "<", "<=", ">", ">="):
            name = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}[op]
            return _make_comparison(name, left, right)
        if op == "||":
            for a in (left, right):
                if not T.is_string(a.type) and a.type != T.UNKNOWN:
                    raise SemanticError(
                        "|| requires varchar operands (add a cast)"
                    )
            return call("concat", T.VARCHAR, left, right)
        # arithmetic, with date/interval special cases
        iv = None
        other = None
        if isinstance(left, Constant) and isinstance(left.value, t.IntervalLiteral):
            iv, other = left.value, right
        elif isinstance(right, Constant) and isinstance(right.value, t.IntervalLiteral):
            iv, other = right.value, left
        if iv is not None:
            sign = 1 if op == "+" else -1
            if isinstance(other.type, (T.DateType, T.TimestampType)):
                return _date_interval(other, iv, sign)
            raise SemanticError("interval arithmetic requires a date/timestamp")
        name = {"+": "add", "-": "subtract", "*": "multiply", "/": "divide", "%": "modulus"}[op]
        rt = _arith_type(name, left.type, right.type)
        return call(name, rt, left, right)


# ==== helpers ==========================================================


def _literal(e: t.Literal) -> Constant:
    if e.kind == "null":
        return Constant(type=T.UNKNOWN, value=None)
    if e.kind == "boolean":
        return const(bool(e.value), T.BOOLEAN)
    if e.kind == "integer":
        # reference: integer literals are INTEGER when they fit 32 bits
        # (keeps decimal precision derivation narrow: INTEGER -> decimal(10,0))
        v = int(e.value)
        return const(v, T.INTEGER if -(2**31) <= v < 2**31 else T.BIGINT)
    if e.kind == "decimal":
        text = str(e.value)
        neg = text.startswith("-")
        digits = text.lstrip("-+")
        if "." in digits:
            whole, frac = digits.split(".")
        else:
            whole, frac = digits, ""
        scale = len(frac)
        precision = max(1, len(whole.lstrip("0")) + scale)
        unscaled = int((whole + frac) or "0") * (-1 if neg else 1)
        return const(unscaled, T.decimal(min(precision, 18), scale))
    if e.kind == "double":
        return const(float(e.value), T.DOUBLE)
    if e.kind == "string":
        return const(str(e.value), T.VARCHAR)
    if e.kind == "date":
        y, m, d = (int(x) for x in str(e.value).split("-"))
        return const(days_from_civil(y, m, d), T.DATE)
    if e.kind == "timestamp":
        import datetime

        s = str(e.value)
        dt = datetime.datetime.fromisoformat(s)
        epoch = datetime.datetime(1970, 1, 1)
        return const(int((dt - epoch).total_seconds() * 1_000_000), T.TIMESTAMP)
    raise SemanticError(f"unknown literal kind {e.kind}")


def _cast_string_constant(c: Constant, target: T.SqlType) -> Constant:
    s = str(c.value)
    if isinstance(target, T.DateType):
        y, m, d = (int(x) for x in s.split("-"))
        return const(days_from_civil(y, m, d), T.DATE)
    if isinstance(target, T.DecimalType):
        from decimal import Decimal

        return const(
            int(Decimal(s).scaleb(target.scale).to_integral_value()), target
        )
    if T.is_integer(target):
        return const(int(s), target)
    if isinstance(target, (T.DoubleType, T.RealType)):
        return const(float(s), target)
    if T.is_string(target):
        return const(s, target)
    raise SemanticError(f"cannot cast string literal to {target}")


def _arith_type(name: str, a: T.SqlType, b: T.SqlType) -> T.SqlType:
    if isinstance(a, (T.DoubleType,)) or isinstance(b, (T.DoubleType,)):
        return T.DOUBLE
    if isinstance(a, T.RealType) or isinstance(b, T.RealType):
        if isinstance(a, T.DecimalType) or isinstance(b, T.DecimalType):
            return T.DOUBLE
        return T.REAL
    da = a if isinstance(a, T.DecimalType) else None
    db = b if isinstance(b, T.DecimalType) else None
    if da or db:
        # integers join decimal arithmetic at their reference precision
        # (TypeCoercion: tinyint->3, smallint->5, integer->10, bigint->19)
        int_prec = {8: 3, 16: 5, 32: 10, 64: 19}
        if da is None:
            da = T.decimal(int_prec.get(getattr(a, "bits", 64), 19), 0)
        if db is None:
            db = T.decimal(int_prec.get(getattr(b, "bits", 64), 19), 0)
        # reference precision derivation (DecimalOperators), capped at 38
        if name in ("add", "subtract"):
            s = max(da.scale, db.scale)
            p = min(38, max(da.precision - da.scale, db.precision - db.scale) + s + 1)
            return T.decimal(p, s)
        if name == "multiply":
            s = da.scale + db.scale
            if s > 38:
                raise SemanticError("decimal multiply scale overflow (>38)")
            p = min(38, da.precision + db.precision)
            return T.decimal(p, s)
        if name in ("divide", "modulus"):
            s = max(da.scale, db.scale)
            p = min(38, da.precision + db.scale + max(0, db.scale - da.scale))
            return T.decimal(p, s)
    if T.is_integer(a) and T.is_integer(b):
        return T.common_super_type(a, b) or T.BIGINT
    if isinstance(a, T.DateType) and isinstance(b, T.DateType) and name == "subtract":
        return T.BIGINT  # date difference in days
    raise SemanticError(f"cannot apply {name} to {a}, {b}")


def _coerce_to(e: RowExpr, target: T.SqlType) -> RowExpr:
    if e.type == target:
        return e
    if isinstance(e, Constant) and e.type == T.UNKNOWN:
        return Constant(type=target, value=None)
    if isinstance(e, Constant) and T.is_string(e.type) and isinstance(target, T.DateType):
        return _cast_string_constant(e, target)
    if T.is_string(e.type) and T.is_string(target):
        return e  # varchar length variants share representation
    return call("cast", target, e)


def _coerce_pair(a: RowExpr, b: RowExpr) -> tuple[RowExpr, RowExpr]:
    if a.type == b.type:
        return a, b
    # date vs string literal: parse the literal
    if isinstance(a.type, T.DateType) and isinstance(b, Constant) and T.is_string(b.type):
        return a, _cast_string_constant(b, T.DATE)
    if isinstance(b.type, T.DateType) and isinstance(a, Constant) and T.is_string(a.type):
        return _cast_string_constant(a, T.DATE), b
    ct = T.common_super_type(a.type, b.type)
    if ct is None:
        raise SemanticError(f"cannot compare {a.type} and {b.type}")
    # decimals: comparisons rescale inside the kernel; avoid materializing casts
    if isinstance(ct, T.DecimalType):
        return a, b
    return _coerce_to(a, ct), _coerce_to(b, ct)


def _make_comparison(name: str, left: RowExpr, right: RowExpr) -> RowExpr:
    left, right = _coerce_pair(left, right)
    return call(name, T.BOOLEAN, left, right)


def _date_interval(operand: RowExpr, iv: t.IntervalLiteral, sign: int) -> RowExpr:
    amount = iv.value * iv.sign * sign
    if iv.unit == "day":
        delta = const(amount, T.BIGINT)
        return call("date_add_days", operand.type, operand, delta)
    if iv.unit in ("month", "year"):
        months = amount * (12 if iv.unit == "year" else 1)
        return call("date_add_months", operand.type, operand, const(months, T.BIGINT))
    raise SemanticError(f"interval unit {iv.unit} unsupported for dates")


def _split_conjuncts(e: t.Node) -> list[t.Node]:
    if isinstance(e, t.BinaryOp) and e.op == "AND":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _contains_aggregate(e: t.Node) -> bool:
    found = []
    _collect_aggregates(e, found)
    return bool(found)


_SUBQUERY_NODES = (t.ScalarSubquery, t.InSubquery, t.Exists, t.Query)


def _collect_windows(e: t.Node, out: list) -> None:
    if isinstance(e, _SUBQUERY_NODES):
        return  # subquery internals have their own scopes
    if isinstance(e, t.FunctionCall) and e.window is not None:
        out.append(e)
        return  # SQL forbids nested window functions
    for f in dataclasses.fields(e) if dataclasses.is_dataclass(e) else []:
        v = getattr(e, f.name)
        if isinstance(v, t.Node):
            _collect_windows(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, t.Node):
                    _collect_windows(item, out)
                elif isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, t.Node):
                            _collect_windows(sub, out)


# names treated as aggregate functions when not windowed
_DERIVED_AGGS = {
    "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop",
    "bool_and", "bool_or", "every",
    "corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept",
    "checksum",
}
AGGREGATE_NAMES = {
    "sum", "count", "avg", "min", "max", "count_if", "approx_distinct",
    "arbitrary", "any_value", "array_agg",
} | _DERIVED_AGGS


def _collect_aggregates(e: t.Node, out: list) -> None:
    if isinstance(e, _SUBQUERY_NODES):
        return  # an aggregate inside a subquery aggregates the SUBQUERY
    if isinstance(e, t.FunctionCall):
        if e.name in AGGREGATE_NAMES and e.window is None:
            out.append(e)
            return
    for f in dataclasses.fields(e) if dataclasses.is_dataclass(e) else []:
        v = getattr(e, f.name)
        if isinstance(v, t.Node):
            _collect_aggregates(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, t.Node):
                    _collect_aggregates(item, out)
                elif isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, t.Node):
                            _collect_aggregates(sub, out)


def _coerce_constant_value(c: Constant, target: T.SqlType):
    if c.value is None:
        return None
    if isinstance(target, T.DecimalType) and isinstance(c.type, T.DecimalType):
        return c.value * 10 ** (target.scale - c.type.scale)
    if isinstance(target, T.DecimalType) and T.is_integer(c.type):
        return c.value * 10**target.scale
    if isinstance(target, (T.DoubleType, T.RealType)) and not isinstance(
        c.type, (T.DoubleType, T.RealType)
    ):
        if isinstance(c.type, T.DecimalType):
            return float(c.value) / c.type.unscale
        return float(c.value)
    return c.value


# ==== constant folding ==================================================


def _fold(e: RowExpr) -> RowExpr:
    """Host-side constant folding for date arithmetic and simple numeric ops
    (pushdown-friendly: `date '1994-01-01' + interval '1' year` becomes a
    plain date Constant)."""
    from trino_tpu_torch.ir import transform

    def fn(node: RowExpr) -> RowExpr:
        if isinstance(node, Call) and all(
            isinstance(a, Constant) for a in node.args
        ):
            return _fold_call(node)
        return node

    return transform(e, fn)


def _fold_call(node: Call) -> RowExpr:
    args = node.args
    vals = [a.value for a in args]
    if any(v is None for v in vals):
        return Constant(type=node.type, value=None)
    try:
        if node.name == "cast":
            return _fold_cast(args[0], node.type) or node
        if node.name == "date_add_days":
            return const(int(vals[0]) + int(vals[1]), node.type)
        if node.name == "date_add_months":
            from trino_tpu_torch.civil import civil_from_days as _civil_from_days
            import numpy as np

            y, m, d = _civil_from_days(np.asarray([int(vals[0])], dtype=np.int64))
            y, m, d = int(y[0]), int(m[0]), int(d[0])
            months_total = (y * 12 + (m - 1)) + int(vals[1])
            y2, m2 = divmod(months_total, 12)
            d2 = min(d, _days_in_month(y2, m2 + 1))
            return const(days_from_civil(y2, m2 + 1, d2), node.type)
        if node.name in ("add", "subtract", "multiply") and not isinstance(
            node.type, T.DecimalType
        ):
            if T.is_integer(node.type):
                a, b = int(vals[0]), int(vals[1])
                r = {"add": a + b, "subtract": a - b, "multiply": a * b}[node.name]
                import numpy as np

                info = np.iinfo(node.type.storage_dtype)
                if not (info.min <= r <= info.max):
                    # reference raises instead of wrapping
                    raise SemanticError(f"{node.type.name} overflow: {r}")
                return const(r, node.type)
            if isinstance(node.type, T.DoubleType):
                fa = _as_float(args[0])
                fb = _as_float(args[1])
                r = {"add": fa + fb, "subtract": fa - fb, "multiply": fa * fb}[node.name]
                return const(r, node.type)
        if node.name in ("add", "subtract", "multiply") and isinstance(
            node.type, T.DecimalType
        ):
            sa = args[0].type.scale if isinstance(args[0].type, T.DecimalType) else 0
            sb = args[1].type.scale if isinstance(args[1].type, T.DecimalType) else 0
            rs = node.type.scale
            a, b = int(vals[0]), int(vals[1])
            if node.name == "multiply":
                raw = a * b  # scale sa+sb
                return const(_rescale_int(raw, sa + sb, rs), node.type)
            av = _rescale_int(a, sa, rs)
            bv = _rescale_int(b, sb, rs)
            return const(av + bv if node.name == "add" else av - bv, node.type)
        if node.name == "negate":
            return const(-vals[0], node.type)
    except Exception:
        return node
    return node


def _fold_cast(src: Constant, target: T.SqlType) -> Optional[Constant]:
    """Fold CAST of a literal (storage-representation conversion)."""
    st = src.type
    v = src.value
    if st == target:
        return src
    if T.is_string(st):
        return _cast_string_constant(src, target)
    if isinstance(target, T.DecimalType):
        if isinstance(st, T.DecimalType):
            return const(_rescale_int(int(v), st.scale, target.scale), target)
        if T.is_integer(st):
            return const(int(v) * target.unscale, target)
        if isinstance(st, (T.DoubleType, T.RealType)):
            from decimal import Decimal

            return const(
                int(Decimal(str(float(v))).scaleb(target.scale).to_integral_value()),
                target,
            )
    if isinstance(target, (T.DoubleType, T.RealType)):
        if isinstance(st, T.DecimalType):
            return const(float(v) / st.unscale, target)
        return const(float(v), target)
    if T.is_integer(target):
        if isinstance(st, T.DecimalType):
            return const(_rescale_int(int(v), st.scale, 0), target)
        if isinstance(st, (T.DoubleType, T.RealType)):
            f = float(v)
            import math

            return const(int(math.floor(abs(f) + 0.5)) * (1 if f >= 0 else -1), target)
        return const(int(v), target)
    if isinstance(target, T.TimestampType) and isinstance(st, T.DateType):
        return const(int(v) * 86_400_000_000, target)
    if isinstance(target, T.DateType) and isinstance(st, T.TimestampType):
        return const(int(v) // 86_400_000_000, target)
    return None


def _as_float(c: Constant) -> float:
    if isinstance(c.type, T.DecimalType):
        return float(c.value) / c.type.unscale
    return float(c.value)


def _rescale_int(v: int, from_s: int, to_s: int) -> int:
    if to_s >= from_s:
        return v * 10 ** (to_s - from_s)
    f = 10 ** (from_s - to_s)
    half = f // 2
    return (v + half) // f if v >= 0 else -((-v + half) // f)


def _days_in_month(y: int, m: int) -> int:
    import calendar

    return calendar.monthrange(y, m)[1]


# shared AND-flattening helper (no OR factoring — decorrelation must see
# filters exactly as written)
from trino_tpu_torch.planner.optimizer import _conjuncts_no_or as _conjuncts_of  # noqa: E402


_MATH_DOUBLE_FNS = {
    "ln", "log2", "log10", "exp", "sin", "cos", "tan", "asin", "acos",
    "atan", "sinh", "cosh", "tanh", "cbrt", "degrees", "radians",
}


def _unwrap_unnest(rel: t.Node):
    """(Unnest ast, alias, column_aliases) if rel is UNNEST (possibly
    aliased), else (None, None, ())."""
    if isinstance(rel, t.Unnest):
        return rel, None, ()
    if isinstance(rel, t.AliasedRelation) and isinstance(rel.relation, t.Unnest):
        return rel.relation, rel.alias.lower(), tuple(
            c.lower() for c in rel.column_aliases
        )
    return None, None, ()


def _expand_quantified(e: "t.QuantifiedComparison") -> t.Node:
    """Rewrite quantified comparisons (reference:
    QuantifiedComparisonExpression handling in SubqueryPlanner):
      = ANY  -> IN;    <> ALL -> NOT IN
      > ANY(S) -> > (SELECT min ...)   > ALL(S) -> > (SELECT max ...)
      < ANY(S) -> < (SELECT max ...)   < ALL(S) -> < (SELECT min ...)
    The min/max forms follow Trino's rewrite; with an empty subquery the
    comparison yields NULL (ANY: falsy — correct; ALL: should be TRUE —
    known deviation, documented)."""
    if e.op == "=" and e.quantifier == "ANY":
        return t.InSubquery(e.value, e.query, negated=False)
    if e.op == "<>" and e.quantifier == "ALL":
        return t.InSubquery(e.value, e.query, negated=True)
    if e.op in ("<", "<=", ">", ">="):
        descending = e.op in (">", ">=")
        agg = (
            ("min" if descending else "max")
            if e.quantifier == "ANY"
            else ("max" if descending else "min")
        )
        sub = t.Query(
            body=t.QuerySpec(
                select_items=(
                    t.SelectItem(
                        t.FunctionCall(agg, (t.Identifier(("__qc",)),))
                    ),
                ),
                distinct=False,
                from_=t.AliasedRelation(
                    t.SubqueryRelation(e.query), "__q", ("__qc",)
                ),
                where=None,
                group_by=(),
                having=None,
            ),
        )
        return t.BinaryOp(e.op, e.value, t.ScalarSubquery(sub))
    raise SemanticError(
        f"quantified comparison {e.op} {e.quantifier} is not supported"
    )
