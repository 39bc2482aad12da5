"""Dynamic filtering: runtime join pruning.

Reference: ``operator/DynamicFilterSourceOperator.java:55`` (build side
collects distinct key domains), ``server/DynamicFilterService.java:95,323``
(merge + push into probe scans), ``spi/connector/DynamicFilter.java``.

The executors materialize the build side before the probe runs
(stage-at-a-time), so the dynamic filter is *exact and synchronous* — no
racing "filter arrived too late" path. The build keys' domain is computed
host-side from the materialized build columns, then pushed into the probe
subtree as (a) an intersected scan ``constraint`` (prunes whole splits via
min/max stats) and (b) a row-level Filter (prunes probe rows before the
join).

Applies to INNER equi-joins only (outer joins preserve probe rows; SEMI
marks may feed arbitrary boolean contexts).

Counterpart of ``trino_tpu/dynfilter.py``: the same domains and the same
plan rewrites; build columns arrive as host numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.predicate import Domain, Range, TupleDomain, ValueSet, to_row_expr
from trino_tpu_torch.planner import plan as P

# discrete-set cap (above this, fall back to [min,max] range — reference:
# dynamic-filtering.small/large-max-distinct-values-per-driver)
MAX_DISCRETE_VALUES = 200


@dataclasses.dataclass
class DynamicFilterStats:
    """One collected filter, for EXPLAIN ANALYZE / observability
    (reference: DynamicFilterService.DynamicFilterDomainStats)."""

    symbol: str
    kind: str  # "discrete" | "range" | "none"
    distinct_values: int
    build_rows: int


def domain_from_build(
    data: np.ndarray, valid: Optional[np.ndarray], type_: T.SqlType
) -> Optional[Domain]:
    """Distinct-value / range domain of a materialized build key column.
    Returns None when the column type is not eligible (strings: probe and
    build dictionaries differ; skip in v1)."""
    if T.is_string(type_) or isinstance(type_, T.BooleanType):
        return None
    if valid is not None:
        data = data[valid]
    if data.size == 0:
        # empty build side: inner join produces nothing — probe prunes to zero
        return Domain.none(type_)
    uniq = np.unique(data)
    if uniq.size <= MAX_DISCRETE_VALUES:
        return Domain.of_values([v.item() for v in uniq], type_)
    return Domain(
        ValueSet.of_ranges([Range(uniq[0].item(), True, uniq[-1].item(), True)]),
        False,
        type_,
    )


def convert_domain(
    domain: Domain, from_type: T.SqlType, to_type: T.SqlType
) -> Optional[Domain]:
    """Convert a domain between storage representations across a coercing
    join criterion (e.g. DECIMAL(3,2) build vs BIGINT probe: storage 500
    vs 5). Returns None when no exact conversion exists (skip the filter)."""
    if from_type == to_type:
        return domain
    def scale_of(t: T.SqlType) -> Optional[int]:
        if isinstance(t, T.DecimalType):
            return t.scale
        if T.is_integer(t):
            return 0
        return None

    sf, st = scale_of(from_type), scale_of(to_type)
    if sf is None or st is None:
        # float/date/string cross-type: storage values are not portable
        if type(from_type) is type(to_type):
            return domain
        return None
    if sf == st:
        return domain
    if domain.values.is_all or domain.values.is_none():
        return Domain(domain.values, domain.null_allowed, to_type)
    out_ranges = []
    if st > sf:
        f = 10 ** (st - sf)
        for r in domain.values.ranges:
            out_ranges.append(
                Range(
                    None if r.low is None else r.low * f, r.low_inclusive,
                    None if r.high is None else r.high * f, r.high_inclusive,
                )
            )
    else:
        f = 10 ** (sf - st)
        for r in domain.values.ranges:
            if r.is_single_value:
                if r.low % f == 0:
                    out_ranges.append(Range.equal(r.low // f))
                continue  # value has fractional digits: matches no probe row
            lo = None if r.low is None else -(-r.low // f)  # ceil
            hi = None if r.high is None else r.high // f  # floor
            out_ranges.append(Range(lo, True, hi, True))
    return Domain(ValueSet.of_ranges(out_ranges), domain.null_allowed, to_type)


def push_probe_domain(
    node: P.PlanNode, symbol: P.Symbol, domain: Domain
) -> P.PlanNode:
    """Push ``symbol in domain`` as deep into the probe plan as is sound,
    intersecting scan constraints at the bottom (the runtime analog of
    PushPredicateIntoTableScan for dynamic filters)."""
    name = symbol.name

    if isinstance(node, P.TableScan):
        if name in {s.name for s in node.symbols}:
            sym_to_col = {s.name: c for s, c in zip(node.symbols, node.column_names)}
            extra = TupleDomain({sym_to_col[name]: domain})
            constraint = (
                extra if node.constraint is None else node.constraint.intersect(extra)
            )
            scan = P.TableScan(
                node.catalog, node.schema, node.table, node.symbols,
                node.column_names, node.pushed_predicate, constraint,
            )
            return _filter_above(scan, symbol, domain)
        return node

    if isinstance(node, P.Filter):
        return P.Filter(push_probe_domain(node.source, symbol, domain), node.predicate)

    if isinstance(node, P.Project):
        for s, e in node.assignments:
            if s.name == name:
                from trino_tpu_torch.ir import Variable

                if isinstance(e, Variable):
                    inner = P.Symbol(e.name, e.type)
                    return P.Project(
                        push_probe_domain(node.source, inner, domain),
                        node.assignments,
                    )
                return _filter_above(node, symbol, domain)
        return node

    if isinstance(node, P.Join):
        left_names = {s.name for s in node.left.output_symbols}
        right_names = {s.name for s in node.right.output_symbols}
        # descend only into row-preserved sides (INNER both; LEFT left;
        # RIGHT right) — filtering a null-extended side below its join
        # would differ from filtering above
        if name in left_names and node.join_type in ("INNER", "LEFT", "SEMI", "ANTI", "CROSS"):
            return _replace_join_sides(
                node, push_probe_domain(node.left, symbol, domain), node.right
            )
        if name in right_names and node.join_type in ("INNER", "RIGHT", "CROSS"):
            return _replace_join_sides(
                node, node.left, push_probe_domain(node.right, symbol, domain)
            )
        if name in right_names and node.join_type in ("LEFT", "FULL"):
            # null-extended side: a NOT-NULL domain filter above the outer
            # join would drop the very rows the join exists to keep
            return node
        if name in left_names and node.join_type in ("RIGHT", "FULL"):
            return node
        return _filter_above(node, symbol, domain)

    if isinstance(node, P.Aggregate):
        if any(k.name == name for k in node.group_keys):
            return P.Aggregate(
                push_probe_domain(node.source, symbol, domain),
                node.group_keys, node.aggregates, node.step,
            )
        return node

    if isinstance(node, (P.Sort, P.Limit, P.TopN, P.Distinct, P.Window, P.SetOp)):
        # row-count-sensitive or multi-input: filter above, don't descend
        if name in {s.name for s in node.output_symbols}:
            return _filter_above(node, symbol, domain)
        return node

    if name in {s.name for s in node.output_symbols}:
        return _filter_above(node, symbol, domain)
    return node


def _filter_above(node: P.PlanNode, symbol: P.Symbol, domain: Domain) -> P.PlanNode:
    pred = to_row_expr(TupleDomain({symbol.name: domain}), {symbol.name: symbol.type})
    if pred is None:
        return node
    return P.Filter(node, pred)


def _replace_join_sides(node: P.Join, left: P.PlanNode, right: P.PlanNode) -> P.Join:
    return P.Join(
        node.join_type, left, right, node.criteria, node.filter,
        node.distribution, node.mark_symbol, node.null_aware,
        node.single_row,
    )


def collect_and_push(
    plan_node: P.PlanNode,
    probe_sym: P.Symbol,
    build_sym: P.Symbol,
    data: np.ndarray,
    valid: Optional[np.ndarray],
    build_rows: int,
    stats_out: Optional[list],
) -> P.PlanNode:
    """Shared per-criteria DF core used by the interpreter join and the
    fragment-level paths: build domain -> coerce to the probe type ->
    record stats -> push into the probe plan."""
    data = np.asarray(data)
    if data.ndim != 1:
        return plan_node  # wide-decimal (hi, lo) lanes: no host domain
    domain = domain_from_build(data, valid, build_sym.type)
    if domain is None or domain.is_all():
        return plan_node
    domain = convert_domain(domain, build_sym.type, probe_sym.type)
    if domain is None or domain.is_all():
        return plan_node
    if stats_out is not None:
        dv = domain.values.discrete_values()
        stats_out.append(
            DynamicFilterStats(
                probe_sym.name,
                "none" if domain.is_none() else (
                    "discrete" if dv is not None else "range"
                ),
                len(dv) if dv else 0,
                build_rows,
            )
        )
    return push_probe_domain(plan_node, probe_sym, domain)


def fragment_dynamic_filters(
    root: P.PlanNode,
    build_lookup,
    session,
    stats_out: Optional[list] = None,
) -> P.PlanNode:
    """Fragment-level dynamic filtering for fused/cluster execution.

    For every INNER equi-join in this fragment whose build side is a
    RemoteSource with a COMPLETED upstream result, compute the build
    keys' domains and push them into the probe subtree (scan constraints
    + row filters) before the fragment's inputs materialize. Sound for
    hash-partitioned builds too: probe rows of a task are co-partitioned
    with its build rows, so the task-local domain covers exactly the
    task-local probe rows.

    ``build_lookup(fragment_id)`` returns ``(get_column, n_rows)`` where
    ``get_column(name)`` lazily materializes ``(data, valid)`` host
    arrays for one build column (or None), or None when the upstream
    result is unavailable (e.g. sharded across hosts).

    Reference: ``server/DynamicFilterService.java:95,323`` — here the
    stage-at-a-time schedule makes the filter exact and synchronous.
    """
    if not session.get("enable_dynamic_filtering"):
        return root
    max_rows = int(session.get("dynamic_filtering_max_build_rows"))
    new_root = root
    for node in P.walk_plan(root):
        if (
            not isinstance(node, P.Join)
            or node.join_type != "INNER"
            or not node.criteria
            or not isinstance(node.right, P.RemoteSource)
        ):
            continue
        looked = build_lookup(node.right.fragment_id)
        if looked is None:
            continue
        get_column, n_rows = looked
        if n_rows > max_rows:
            continue
        for probe_sym, build_sym in node.criteria:
            pair = get_column(build_sym.name)
            if pair is None:
                continue
            data, valid = pair
            new_root = collect_and_push(
                new_root, probe_sym, build_sym, data, valid,
                int(n_rows), stats_out,
            )
    return new_root
