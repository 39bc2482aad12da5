"""Cost-based join optimization.

Reference: ``core/trino-main/src/main/java/io/trino/sql/planner/iterative/rule/``
— ``ReorderJoins.java`` (DP over the flattened inner-join graph, bounded by
``optimizer.max-reordered-joins``) and ``DetermineJoinDistributionType.java``
(broadcast vs partitioned by build-side size). Estimates come from
:mod:`trino_tpu.planner.stats`.

TPU note: "replicated" build sides become an ``all_gather`` over the mesh
(cheap on ICI for small tables); "partitioned" becomes two ``all_to_all``
hash repartitions. The threshold knob is rows-based
(``broadcast_join_threshold_rows``) since HBM, not heap, is the budget.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.config import Session
from trino_tpu_torch.ir import RowExpr, special
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.optimizer import _conjuncts, _replace_sources
from trino_tpu_torch.planner.stats import PlanStats, StatsCalculator, SymbolStats

MAX_REORDERED_JOINS = 8  # reference default 9 (optimizer.max-reordered-joins)


# === DetermineJoinDistributionType =========================================


def determine_join_distribution(
    node: P.PlanNode, stats: StatsCalculator, session: Session
) -> P.PlanNode:
    if isinstance(node, P.Join):
        left = determine_join_distribution(node.left, stats, session)
        right = determine_join_distribution(node.right, stats, session)
        dist = node.distribution
        if dist is None:
            forced = session.get("join_distribution_type")
            if forced == "BROADCAST":
                dist = "replicated"
            elif forced == "PARTITIONED":
                dist = "partitioned"
            else:
                build = stats.stats(node.right)
                threshold = session.get("broadcast_join_threshold_rows")
                if build.row_count is not None:
                    dist = (
                        "replicated"
                        if build.row_count <= threshold
                        else "partitioned"
                    )
            # RIGHT/FULL outer joins must see every build row exactly once
            # per output — replicating the build side would duplicate
            # unmatched build rows across shards (DetermineJoinDistributionType
            # has the same mustPartition rule)
            if node.join_type in ("RIGHT", "FULL"):
                dist = "partitioned"
        return P.Join(
            node.join_type, left, right, node.criteria, node.filter,
            dist, node.mark_symbol, node.null_aware, node.single_row,
        )
    new_sources = [determine_join_distribution(s, stats, session) for s in node.sources]
    if new_sources:
        return _replace_sources(node, new_sources)
    return node


# === ReorderJoins ==========================================================


@dataclasses.dataclass
class _JoinGraph:
    """Flattened maximal inner-join region (ReorderJoins' MultiJoinNode)."""

    leaves: list[P.PlanNode]
    edges: list[tuple[P.Symbol, P.Symbol]]  # equality criteria
    filters: list[RowExpr]  # residual non-equi conjuncts


def reorder_joins(
    node: P.PlanNode, stats: StatsCalculator, session: Session
) -> P.PlanNode:
    if isinstance(node, P.Join) and _flattenable(node):
        graph = _flatten(node)
        graph.leaves = [reorder_joins(l, stats, session) for l in graph.leaves]
        if len(graph.leaves) > 2:
            rebuilt = _order_graph(graph, stats)
            if rebuilt is not None:
                return rebuilt
            # ordering bailed (no estimates / degenerate criteria): rebuild
            # left-deep in syntactic order from the already-recursed leaves
            return _syntactic_rebuild(graph)
        # 2 leaves (node.filter, if any, stays on the node): pick build side
        return _orient_binary(_replace_sources(node, graph.leaves), stats)
    new_sources = [reorder_joins(s, stats, session) for s in node.sources]
    if new_sources:
        return _replace_sources(node, new_sources)
    return node


def _syntactic_rebuild(graph: _JoinGraph) -> P.PlanNode:
    """Left-deep join over leaves in original order, consuming each equality
    edge at the first point both sides are available (inner joins commute)."""
    edges = list(graph.edges)
    acc = graph.leaves[0]
    acc_syms = {s.name for s in acc.output_symbols}
    for leaf in graph.leaves[1:]:
        leaf_syms = {s.name for s in leaf.output_symbols}
        criteria, rest = [], []
        for a, b in edges:
            if a.name in acc_syms and b.name in leaf_syms:
                criteria.append((a, b))
            elif b.name in acc_syms and a.name in leaf_syms:
                criteria.append((b, a))
            else:
                rest.append((a, b))
        edges = rest
        join_type = "INNER" if criteria else "CROSS"
        acc = P.Join(join_type, acc, leaf, criteria, None, None, None)
        acc_syms |= leaf_syms
    return _attach_filters(acc, graph.filters)


def _flattenable(j: P.Join) -> bool:
    # CROSS joins from comma-list FROM flatten too: the reorderer then
    # connects their relations through the real equality edges instead of
    # materializing the syntactic cross product (ReorderJoins.java does
    # the same via MultiJoinNode over INNER+CROSS)
    return (
        j.join_type in ("INNER", "CROSS")
        and j.mark_symbol is None
        and not j.single_row
    )


def _flatten(node: P.PlanNode) -> _JoinGraph:
    if isinstance(node, P.Join) and _flattenable(node):
        left = _flatten(node.left)
        right = _flatten(node.right)
        filters = left.filters + right.filters
        if node.filter is not None:
            filters.extend(_conjuncts(node.filter))
        return _JoinGraph(
            left.leaves + right.leaves,
            left.edges + right.edges + list(node.criteria),
            filters,
        )
    return _JoinGraph([node], [], [])


def _order_graph(graph: _JoinGraph, stats: StatsCalculator) -> Optional[P.PlanNode]:
    n = len(graph.leaves)
    if n > MAX_REORDERED_JOINS:
        return _greedy_order(graph, stats)

    leaf_stats = [stats.stats(l) for l in graph.leaves]
    if any(s.row_count is None for s in leaf_stats):
        return None  # no estimates -> keep syntactic order

    leaf_syms = [{s.name for s in l.output_symbols} for l in graph.leaves]

    def owner(symbol: P.Symbol) -> int:
        for i, syms in enumerate(leaf_syms):
            if symbol.name in syms:
                return i
        return -1

    # edge list as (leaf_i, leaf_j, sym_i, sym_j)
    edges = []
    for a, b in graph.edges:
        ia, ib = owner(a), owner(b)
        if ia < 0 or ib < 0 or ia == ib:
            return None  # degenerate criterion; bail to syntactic order
        edges.append((ia, ib, a, b))

    def ndv(leaf: int, sym: P.Symbol) -> Optional[float]:
        ss = leaf_stats[leaf].symbols.get(sym.name)
        return ss.ndv if ss else None

    def subset_rows(mask: int) -> float:
        rows = 1.0
        for i in range(n):
            if mask >> i & 1:
                rows *= max(leaf_stats[i].row_count, 1.0)
        for ia, ib, a, b in edges:
            if mask >> ia & 1 and mask >> ib & 1:
                la, lb = ndv(ia, a), ndv(ib, b)
                if la is None and lb is None:
                    denom = min(leaf_stats[ia].row_count, leaf_stats[ib].row_count)
                else:
                    denom = max(la or 1.0, lb or 1.0)
                rows /= max(denom, 1.0)
        return rows

    rows_memo = {}

    def rows_of(mask: int) -> float:
        if mask not in rows_memo:
            rows_memo[mask] = subset_rows(mask)
        return rows_memo[mask]

    def connected(mask_a: int, mask_b: int) -> bool:
        for ia, ib, _, _ in edges:
            if (mask_a >> ia & 1 and mask_b >> ib & 1) or (
                mask_a >> ib & 1 and mask_b >> ia & 1
            ):
                return True
        return False

    # DP over subsets: best[mask] = (cost, left_mask) — cost counts the
    # intermediate rows produced building this subset (classic DPsize).
    best: dict[int, tuple[float, Optional[int]]] = {}
    for i in range(n):
        best[1 << i] = (0.0, None)
    full = (1 << n) - 1
    for mask in range(1, full + 1):
        if mask in best or bin(mask).count("1") < 2:
            continue
        best_cost, best_split = float("inf"), None
        sub = (mask - 1) & mask
        while sub:
            other = mask ^ sub
            if sub < other:  # each unordered partition once
                if sub in best and other in best and connected(sub, other):
                    cost = best[sub][0] + best[other][0] + rows_of(mask)
                    if cost < best_cost:
                        best_cost, best_split = cost, sub
            sub = (sub - 1) & mask
        if best_split is not None:
            best[mask] = (best_cost, best_split)
    if full not in best:
        # join graph is disconnected: fall back to greedy (introduces
        # cross joins between components, smallest first)
        return _greedy_order(graph, stats)

    def build(mask: int) -> tuple[P.PlanNode, set[str]]:
        split = best[mask][1]
        if split is None:
            i = mask.bit_length() - 1
            return graph.leaves[i], set(leaf_syms[i])
        a_mask, b_mask = split, mask ^ split
        # larger side probes (left), smaller side builds (right)
        if rows_of(a_mask) < rows_of(b_mask):
            a_mask, b_mask = b_mask, a_mask
        left, lsyms = build(a_mask)
        right, rsyms = build(b_mask)
        criteria = []
        for ia, ib, a, b in edges:
            in_left = a_mask >> ia & 1
            in_right = b_mask >> ib & 1
            if in_left and in_right:
                criteria.append((a, b))
            elif (a_mask >> ib & 1) and (b_mask >> ia & 1):
                criteria.append((b, a))
        join_type = "INNER" if criteria else "CROSS"
        return (
            P.Join(join_type, left, right, criteria, None, None, None),
            lsyms | rsyms,
        )

    out, _ = build(full)
    return _attach_filters(out, graph.filters)


def _greedy_order(graph: _JoinGraph, stats: StatsCalculator) -> Optional[P.PlanNode]:
    """Greedy smallest-intermediate-first (used beyond the DP bound and for
    disconnected graphs)."""
    n = len(graph.leaves)
    leaf_stats = [stats.stats(l) for l in graph.leaves]
    if any(s.row_count is None for s in leaf_stats):
        return None
    leaf_syms = [{s.name for s in l.output_symbols} for l in graph.leaves]

    @dataclasses.dataclass
    class Part:
        node: P.PlanNode
        syms: set[str]
        rows: float
        stats: PlanStats

    parts = [
        Part(l, set(sy), max(st.row_count, 1.0), st)
        for l, sy, st in zip(graph.leaves, leaf_syms, leaf_stats)
    ]
    edges = list(graph.edges)

    def edge_between(a: Part, b: Part):
        crit = []
        rest = []
        for la, lb in edges:
            if la.name in a.syms and lb.name in b.syms:
                crit.append((la, lb))
            elif lb.name in a.syms and la.name in b.syms:
                crit.append((lb, la))
            else:
                rest.append((la, lb))
        return crit, rest

    def est_join_rows(a: Part, b: Part, crit) -> float:
        rows = a.rows * b.rows
        for la, lb in crit:
            sa = a.stats.symbols.get(la.name) or SymbolStats()
            sb = b.stats.symbols.get(lb.name) or SymbolStats()
            if sa.ndv is None and sb.ndv is None:
                denom = min(a.rows, b.rows)
            else:
                denom = max(sa.ndv or 1.0, sb.ndv or 1.0)
            rows /= max(denom, 1.0)
        return rows

    while len(parts) > 1:
        best = None
        for i, j in itertools.combinations(range(len(parts)), 2):
            crit, _ = edge_between(parts[i], parts[j])
            rows = est_join_rows(parts[i], parts[j], crit)
            has_edge = bool(crit)
            key = (not has_edge, rows)  # prefer connected pairs, then size
            if best is None or key < best[0]:
                best = (key, i, j, crit, rows)
        _, i, j, crit, rows = best
        a, b = parts[i], parts[j]
        if a.rows < b.rows:
            a, b = b, a
            crit = [(rb, la) for la, rb in crit]
        _, edges = edge_between(a, b)
        join_type = "INNER" if crit else "CROSS"
        node = P.Join(join_type, a.node, b.node, crit, None, None, None)
        merged_stats = PlanStats(rows, {**a.stats.symbols, **b.stats.symbols})
        merged = Part(node, a.syms | b.syms, max(rows, 1.0), merged_stats)
        parts = [p for k, p in enumerate(parts) if k not in (i, j)] + [merged]
    return _attach_filters(parts[0].node, graph.filters)


def _attach_filters(node: P.PlanNode, filters: list[RowExpr]) -> P.PlanNode:
    if not filters:
        return node
    pred = filters[0]
    for f in filters[1:]:
        pred = special("and", T.BOOLEAN, pred, f)
    return P.Filter(node, pred)


def _orient_binary(node: P.PlanNode, stats: StatsCalculator) -> P.PlanNode:
    """For a 2-leaf inner join: make the smaller side the build (right).
    Mirrors ReorderJoins' side-flip for the trivial case."""
    if not (isinstance(node, P.Join) and node.join_type == "INNER" and node.criteria):
        return node
    ls, rs = stats.stats(node.left), stats.stats(node.right)
    if ls.row_count is None or rs.row_count is None:
        return node
    if ls.row_count < rs.row_count:
        return P.Join(
            "INNER", node.right, node.left,
            [(b, a) for a, b in node.criteria],
            node.filter, node.distribution, None,
        )
    return node


