"""Logical plan optimizer.

Reference: Trino runs ~194 iterative rules plus whole-plan optimizers
(``sql/planner/optimizations/PredicatePushDown.java``,
``iterative/rule/PruneUnreferencedOutputs`` family, ``AddExchanges.java:115``;
sequence in ``PlanOptimizers.java:240``). v1 implements the two rules with
the largest execution impact, as whole-plan recursive passes:

1. predicate pushdown — split conjuncts, inline through projections, push
   to the narrowest subtree (join sides, below sorts, into scan filters)
2. column pruning — scans read only referenced columns; projections and
   aggregations drop dead outputs

Join distribution selection (broadcast vs partitioned) lives in the
fragmenter (parallel/), where the mesh is known.
"""

from __future__ import annotations

import dataclasses

from typing import Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.config import Session
from trino_tpu_torch.ir import (
    Call,
    Constant,
    RowExpr,
    SpecialForm,
    Variable,
    referenced_variables,
    special,
    transform,
    variable,
)
from trino_tpu_torch.planner import plan as P


def optimize(root: P.PlanNode, session: Session, catalogs) -> P.PlanNode:
    from trino_tpu_torch.planner.joins import determine_join_distribution, reorder_joins
    from trino_tpu_torch.planner.sanity import PlanSanityChecker, validation_enabled
    from trino_tpu_torch.planner.stats import StatsCalculator

    from trino_tpu_torch.planner.iterative import run_default

    # Reference: PlanSanityChecker.validateIntermediatePlan after every
    # optimizer stage — a broken rewrite fails fast, typed, at plan time.
    validate = validation_enabled(session)

    def checked(stage: str, node: P.PlanNode) -> P.PlanNode:
        if validate:
            PlanSanityChecker.validate_intermediate(node, stage)
        return node

    root = checked("push_down_predicates", push_down_predicates(root))
    root = checked("push_into_scans", push_into_scans(root))
    # iterative rule tier (Memo + pattern rules): simplification, limit
    # merging/TopN creation, connector applyLimit/applyTopN/applyAggregation
    root = checked("iterative_rules", run_default(root, session, catalogs))
    stats = StatsCalculator(catalogs)
    if session.get("join_reordering_strategy") == "AUTOMATIC":
        root = checked("reorder_joins", reorder_joins(root, stats, session))
    root = checked(
        "determine_join_distribution",
        determine_join_distribution(root, stats, session),
    )
    root = prune_columns(root)
    if validate:
        PlanSanityChecker.validate_final(root, "prune_columns")
    return root


# === predicate -> TupleDomain pushdown into scans ==========================
# Reference: iterative/rule/PushPredicateIntoTableScan.java + DomainTranslator.
# The extracted constraint drives connector split pruning and dynamic-filter
# intersection; the Filter stays in place (constraint is unenforced).


def push_into_scans(node: P.PlanNode) -> P.PlanNode:
    from trino_tpu_torch.predicate import extract_tuple_domain

    if isinstance(node, P.Filter) and isinstance(node.source, P.TableScan):
        scan = node.source
        res = extract_tuple_domain(_conjuncts(node.predicate))
        td = res.tuple_domain
        if not td.is_all():
            # rekey symbol names -> connector column names
            sym_to_col = {
                s.name: c for s, c in zip(scan.symbols, scan.column_names)
            }
            if td.is_none():
                constraint = td
            else:
                from trino_tpu_torch.predicate import TupleDomain

                constraint = TupleDomain(
                    {
                        sym_to_col[k]: v
                        for k, v in td.domains.items()
                        if k in sym_to_col
                    }
                )
            if scan.constraint is not None:
                constraint = scan.constraint.intersect(constraint)
            new_scan = dataclasses.replace(scan, constraint=constraint)
            return P.Filter(new_scan, node.predicate)
        return node
    new_sources = [push_into_scans(s) for s in node.sources]
    if new_sources:
        return _replace_sources(node, new_sources)
    return node


# === predicate pushdown ====================================================


def _conjuncts(e: RowExpr) -> list[RowExpr]:
    if isinstance(e, SpecialForm) and e.form == "and":
        out = []
        for a in e.args:
            out.extend(_conjuncts(a))
        return out
    e = _extract_common_or_conjuncts(e)
    if isinstance(e, SpecialForm) and e.form == "and":
        return _conjuncts(e)
    return [e]


def _extract_common_or_conjuncts(e: RowExpr) -> RowExpr:
    """OR(A∧X, A∧Y) -> A ∧ OR(X, Y): factor conjuncts common to every OR
    branch so they can push down / become join criteria (reference:
    sql/ExpressionUtils.extractCommonPredicates, essential for TPC-H Q19's
    OR-of-conjunction-with-shared-join-key shape)."""
    if not (isinstance(e, SpecialForm) and e.form == "or"):
        return e
    branches = [_conjuncts_no_or(b) for b in _disjuncts(e)]
    common = [c for c in branches[0] if all(c in b for b in branches[1:])]
    if not common:
        return e
    remainders = []
    for b in branches:
        rem = [c for c in b if c not in common]
        if not rem:  # a branch reduced to TRUE: the OR is implied by common
            remainders = None
            break
        remainders.append(_combine_and(rem))
    parts = list(common)
    if remainders is not None:
        parts.append(SpecialForm(type=T.BOOLEAN, form="or", args=tuple(remainders)))
    return _combine_and(parts)


def _disjuncts(e: RowExpr) -> list[RowExpr]:
    if isinstance(e, SpecialForm) and e.form == "or":
        out = []
        for a in e.args:
            out.extend(_disjuncts(a))
        return out
    return [e]


def _conjuncts_no_or(e: RowExpr) -> list[RowExpr]:
    if isinstance(e, SpecialForm) and e.form == "and":
        out = []
        for a in e.args:
            out.extend(_conjuncts_no_or(a))
        return out
    return [e]


def _combine_and(parts: list[RowExpr]) -> RowExpr:
    out = parts[0]
    for p in parts[1:]:
        out = special("and", T.BOOLEAN, out, p)
    return out


def _combine(conjuncts: list[RowExpr]) -> Optional[RowExpr]:
    if not conjuncts:
        return None
    out = conjuncts[0]
    for c in conjuncts[1:]:
        out = special("and", T.BOOLEAN, out, c)
    return out


def _with_filter(node: P.PlanNode, conjuncts: list[RowExpr]) -> P.PlanNode:
    pred = _combine(conjuncts)
    return node if pred is None else P.Filter(node, pred)


def push_down_predicates(node: P.PlanNode, inherited: Optional[list[RowExpr]] = None) -> P.PlanNode:
    """Returns a plan where every pushable conjunct sits as low as possible."""
    pending = list(inherited or [])

    if isinstance(node, P.Filter):
        pending.extend(_conjuncts(node.predicate))
        return push_down_predicates(node.source, pending)

    if isinstance(node, P.Project):
        assign = dict((s.name, e) for s, e in node.assignments)
        pushable, kept = [], []
        for c in pending:
            refs = referenced_variables(c)
            if all(r in assign for r in refs):
                # inline assignment expressions into the conjunct
                def repl(e: RowExpr) -> RowExpr:
                    if isinstance(e, Variable) and e.name in assign:
                        return assign[e.name]
                    return e

                pushable.append(transform(c, repl))
            else:
                kept.append(c)
        src = push_down_predicates(node.source, pushable)
        return _with_filter(
            P.Project(src, node.assignments), kept
        )

    if isinstance(node, P.Join):
        left_names = {s.name for s in node.left.output_symbols}
        right_names = {s.name for s in node.right.output_symbols}
        to_left, to_right, kept = [], [], []
        criteria = list(node.criteria)
        join_type = node.join_type
        for c in pending:
            refs = referenced_variables(c)
            # pushing into a null-extended (outer) side would filter before
            # null-extension and wrongly revive rows: LEFT keeps left-side
            # pushes only, RIGHT right-side only, FULL neither
            if refs and refs <= left_names and join_type in (
                "INNER", "CROSS", "LEFT", "SEMI", "ANTI"
            ):
                to_left.append(c)
            elif refs and refs <= right_names and join_type in (
                "INNER", "CROSS", "RIGHT", "SEMI", "ANTI"
            ):
                to_right.append(c)
            else:
                # equality spanning both sides of an inner/cross join
                # becomes a join criterion (reference: PredicatePushDown
                # turning WHERE equalities into JoinNode criteria)
                eq = _as_criterion(c, left_names, right_names)
                if eq is not None and join_type in ("INNER", "CROSS"):
                    criteria.append(eq)
                    join_type = "INNER"
                else:
                    kept.append(c)
        left = push_down_predicates(node.left, to_left)
        right = push_down_predicates(node.right, to_right)
        out = P.Join(
            join_type, left, right, criteria, node.filter,
            node.distribution, node.mark_symbol, node.null_aware,
            node.single_row,
        )
        return _with_filter(out, kept)

    if isinstance(node, P.Aggregate):
        key_names = {s.name for s in node.group_keys}
        pushable, kept = [], []
        for c in pending:
            refs = referenced_variables(c)
            if refs and refs <= key_names:
                pushable.append(c)
            else:
                kept.append(c)
        src = push_down_predicates(node.source, pushable)
        return _with_filter(
            P.Aggregate(src, node.group_keys, node.aggregates, node.step), kept
        )

    if isinstance(node, P.Sort):
        src = push_down_predicates(node.source, pending)
        return P.Sort(src, node.order_by)

    if isinstance(node, (P.Limit, P.TopN, P.Distinct, P.Window, P.SetOp, P.Output)):
        # do not push through row-count-sensitive nodes; recurse inside
        new_sources = [push_down_predicates(s) for s in node.sources]
        out = _replace_sources(node, new_sources)
        return _with_filter(out, pending)

    if isinstance(node, (P.TableScan, P.Values)):
        return _with_filter(node, pending)

    new_sources = [push_down_predicates(s) for s in node.sources]
    return _with_filter(_replace_sources(node, new_sources), pending)


def _as_criterion(c: RowExpr, left_names: set[str], right_names: set[str]):
    if not (isinstance(c, Call) and c.name == "eq" and len(c.args) == 2):
        return None
    a, b = c.args
    if not (isinstance(a, Variable) and isinstance(b, Variable)):
        return None
    if a.name in left_names and b.name in right_names:
        return (P.Symbol(a.name, a.type), P.Symbol(b.name, b.type))
    if b.name in left_names and a.name in right_names:
        return (P.Symbol(b.name, b.type), P.Symbol(a.name, a.type))
    return None


def _replace_sources(node: P.PlanNode, new_sources: list[P.PlanNode]) -> P.PlanNode:
    return P.replace_sources(node, new_sources)


# === column pruning ========================================================


def prune_columns(node: P.PlanNode, required: Optional[set[str]] = None) -> P.PlanNode:
    if required is None:
        required = {s.name for s in node.output_symbols}

    if isinstance(node, P.Output):
        src = prune_columns(node.source, {s.name for s in node.symbols})
        return P.Output(src, node.column_names, node.symbols)

    if isinstance(node, P.Project):
        kept = [(s, e) for s, e in node.assignments if s.name in required]
        needed = set()
        for _, e in kept:
            needed |= referenced_variables(e)
        src = prune_columns(node.source, needed)
        return P.Project(src, kept)

    if isinstance(node, P.Filter):
        needed = set(required) | referenced_variables(node.predicate)
        src = prune_columns(node.source, needed)
        return P.Filter(src, node.predicate)

    if isinstance(node, P.TableScan):
        keep = [
            (s, c)
            for s, c in zip(node.symbols, node.column_names)
            if s.name in required
        ]
        if not keep:  # keep one column for row counting
            keep = [(node.symbols[0], node.column_names[0])]
        return dataclasses.replace(
            node, symbols=[s for s, _ in keep],
            column_names=[c for _, c in keep],
        )

    if isinstance(node, P.Aggregate):
        aggs = [(s, f) for s, f in node.aggregates if s.name in required]
        needed = {s.name for s in node.group_keys}
        for _, f in aggs:
            if f.argument is not None:
                needed |= referenced_variables(f.argument)
            if f.filter is not None:
                needed |= referenced_variables(f.filter)
        src = prune_columns(node.source, needed)
        return P.Aggregate(src, node.group_keys, aggs, node.step)

    if isinstance(node, P.Join):
        needed = set(required)
        for a, b in node.criteria:
            needed.add(a.name)
            needed.add(b.name)
        if node.filter is not None:
            needed |= referenced_variables(node.filter)
        left_names = {s.name for s in node.left.output_symbols}
        right_names = {s.name for s in node.right.output_symbols}
        left = prune_columns(node.left, needed & left_names)
        right = prune_columns(node.right, needed & right_names)
        return P.Join(
            node.join_type, left, right, node.criteria, node.filter,
            node.distribution, node.mark_symbol, node.null_aware,
            node.single_row,
        )

    if isinstance(node, P.Sort):
        needed = set(required) | {o.symbol.name for o in node.order_by}
        return P.Sort(prune_columns(node.source, needed), node.order_by)

    if isinstance(node, P.TopN):
        needed = set(required) | {o.symbol.name for o in node.order_by}
        return P.TopN(
            prune_columns(node.source, needed), node.count, node.order_by, node.step
        )

    if isinstance(node, P.Limit):
        return P.Limit(prune_columns(node.source, set(required)), node.count, node.offset)

    if isinstance(node, P.GroupId):
        # the aggregate above always needs every grouping key + the gid;
        # the source additionally feeds any required agg inputs
        src_required = (set(required) - {node.gid.name}) | {
            s.name for s in node.all_keys
        }
        src = prune_columns(node.source, src_required)
        return P.GroupId(src, node.groups, node.all_keys, node.gid)

    if isinstance(node, P.Distinct):
        # distinct keys are all output columns — everything is required
        src = prune_columns(node.source, {s.name for s in node.output_symbols})
        return P.Distinct(src)

    if isinstance(node, P.Window):
        needed = set(required) | {s.name for s in node.partition_by}
        needed |= {o.symbol.name for o in node.order_by}
        for _, f in node.functions:
            if f.argument is not None:
                needed |= referenced_variables(f.argument)
            if f.default is not None:
                needed |= referenced_variables(f.default)
        src = prune_columns(node.source, needed - {s.name for s, _ in node.functions})
        return P.Window(src, node.partition_by, node.order_by, node.functions, node.frame)

    if isinstance(node, P.SetOp):
        inputs = []
        for inp in node.inputs:
            inputs.append(prune_columns(inp, {s.name for s in inp.output_symbols}))
        return P.SetOp(node.op, node.distinct, inputs, node.symbols)

    return node
