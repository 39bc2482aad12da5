"""Logical plan nodes.

Reference: ``core/trino-main/src/main/java/io/trino/sql/planner/plan/``
(TableScanNode, FilterNode, ProjectNode, AggregationNode, JoinNode,
SortNode, TopNNode, LimitNode, ExchangeNode, OutputNode, ValuesNode, …).

Every node exposes ``output_symbols`` — a list of :class:`Symbol` (name +
type). Expressions inside nodes are RowExpr trees over ``Variable``
references to those symbols; the physical planner binds them to channels.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional, Sequence

from trino_tpu_torch import types as T
from trino_tpu_torch.ir import RowExpr
from trino_tpu_torch.ops.sort import SortKey

_counter = itertools.count()


def fresh_name(base: str) -> str:
    return f"{base}_{next(_counter)}"


@dataclasses.dataclass(frozen=True)
class Symbol:
    name: str
    type: T.SqlType

    def __repr__(self):
        return f"{self.name}:{self.type}"


@dataclasses.dataclass(frozen=True)
class Ordering:
    symbol: Symbol
    ascending: bool = True
    nulls_first: bool = False

    def sort_key(self) -> SortKey:
        return SortKey(ascending=self.ascending, nulls_first=self.nulls_first)


class PlanNode:
    @property
    def output_symbols(self) -> list[Symbol]:
        raise NotImplementedError

    @property
    def sources(self) -> list["PlanNode"]:
        return []


@dataclasses.dataclass
class TableScan(PlanNode):
    """Scan of a connector table.

    ``table`` is a connector-specific handle; ``assignments`` maps each
    output symbol to the connector column name.
    Reference: ``plan/TableScanNode.java``.
    """

    catalog: str
    schema: str
    table: str
    symbols: list[Symbol]
    column_names: list[str]
    # predicate pushed into the connector (reference: TupleDomain pushdown)
    pushed_predicate: Optional[RowExpr] = None
    # extracted TupleDomain over *column names*, for split pruning and
    # connector applyFilter (reference: PushPredicateIntoTableScan.java);
    # advisory — the enclosing Filter still applies the full predicate
    constraint: Optional[Any] = None
    # connector applyLimit / applyTopN hints (reference:
    # ConnectorMetadata.java:1064,1090); guarantee-free — the Limit/TopN
    # node above still enforces, the scan just reads less
    limit: Optional[int] = None
    topn: Optional[list] = None  # [(column_name, ascending)]

    @property
    def output_symbols(self):
        return self.symbols


@dataclasses.dataclass
class Values(PlanNode):
    symbols: list[Symbol]
    rows: list[list[Any]]  # storage-representation python values

    @property
    def output_symbols(self):
        return self.symbols


@dataclasses.dataclass
class Filter(PlanNode):
    source: PlanNode
    predicate: RowExpr

    @property
    def output_symbols(self):
        return self.source.output_symbols

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class Project(PlanNode):
    source: PlanNode
    assignments: list[tuple[Symbol, RowExpr]]

    @property
    def output_symbols(self):
        return [s for s, _ in self.assignments]

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass(frozen=True)
class AggFunction:
    """One aggregate: kind in ops.aggregation.AGG_KINDS, argument expression
    (None for count(*)), marks distinct/filter (reference:
    ``plan/AggregationNode.Aggregation``)."""

    kind: str
    argument: Optional[RowExpr]
    result_type: T.SqlType
    distinct: bool = False
    filter: Optional[RowExpr] = None


@dataclasses.dataclass
class Aggregate(PlanNode):
    """Group-by aggregation. step: 'single' | 'partial' | 'final'.

    For the partial/final split (the reference's AccumulatorState shipping,
    ``spi/function/AccumulatorStateSerializer.java``), ``acc_symbols`` names
    the accumulator columns on the wire between the two steps: one
    ``(value, count)`` pair per aggregate (count carries NULL semantics and
    avg denominators; for count/count_star the value IS the count and the
    second symbol is None). A partial node *outputs* them; the matching
    final node *consumes* them."""

    source: PlanNode
    group_keys: list[Symbol]
    aggregates: list[tuple[Symbol, AggFunction]]
    step: str = "single"
    acc_symbols: Optional[list[tuple[Symbol, Optional[Symbol]]]] = None

    @property
    def output_symbols(self):
        if self.step == "partial" and self.acc_symbols is not None:
            out = list(self.group_keys)
            for v, c in self.acc_symbols:
                out.append(v)
                if c is not None:
                    out.append(c)
            return out
        return self.group_keys + [s for s, _ in self.aggregates]

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class Join(PlanNode):
    """Equi-join. criteria is a list of (left_symbol, right_symbol) pairs;
    ``filter`` is an extra non-equi condition over both sides' symbols.
    distribution: None (undecided) | 'partitioned' | 'replicated'.
    Reference: ``plan/JoinNode.java``."""

    join_type: str  # INNER | LEFT | RIGHT | FULL | CROSS | SEMI | ANTI
    left: PlanNode
    right: PlanNode
    criteria: list[tuple[Symbol, Symbol]]
    filter: Optional[RowExpr] = None
    distribution: Optional[str] = None
    # for SEMI/ANTI: the output mark symbol replaces right outputs
    mark_symbol: Optional[Symbol] = None
    # SEMI/ANTI mark semantics: True = 3-valued IN (NULL keys/build-NULLs
    # yield NULL marks); False = 2-valued EXISTS (TRUE/FALSE only)
    null_aware: bool = True
    # scalar-subquery join: error if a probe row matches >1 build row
    # (reference: EnforceSingleRowNode)
    single_row: bool = False

    @property
    def output_symbols(self):
        if self.join_type in ("SEMI", "ANTI"):
            return self.left.output_symbols + (
                [self.mark_symbol] if self.mark_symbol else []
            )
        return self.left.output_symbols + self.right.output_symbols

    @property
    def sources(self):
        return [self.left, self.right]


@dataclasses.dataclass
class GroupId(PlanNode):
    """Replicates input rows once per grouping set, nulling the key columns
    absent from each set and emitting a group-id column.
    Reference: ``plan/GroupIdNode.java`` + ``operator/GroupIdOperator.java``."""

    source: PlanNode
    groups: list[list[Symbol]]  # key subset per grouping set
    all_keys: list[Symbol]
    gid: Symbol

    @property
    def output_symbols(self):
        return self.source.output_symbols + [self.gid]

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class Sort(PlanNode):
    source: PlanNode
    order_by: list[Ordering]

    @property
    def output_symbols(self):
        return self.source.output_symbols

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class TopN(PlanNode):
    source: PlanNode
    count: int
    order_by: list[Ordering]
    step: str = "single"  # single | partial | final

    @property
    def output_symbols(self):
        return self.source.output_symbols

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class Limit(PlanNode):
    source: PlanNode
    count: Optional[int]
    offset: int = 0

    @property
    def output_symbols(self):
        return self.source.output_symbols

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class Distinct(PlanNode):
    source: PlanNode

    @property
    def output_symbols(self):
        return self.source.output_symbols

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class SetOp(PlanNode):
    op: str  # UNION | INTERSECT | EXCEPT
    distinct: bool
    inputs: list[PlanNode]
    symbols: list[Symbol]
    # per-input mapping: input.output_symbols[i] feeds symbols[i]

    @property
    def output_symbols(self):
        return self.symbols

    @property
    def sources(self):
        return self.inputs


@dataclasses.dataclass(frozen=True)
class WindowFunction:
    kind: str  # rank, row_number, dense_rank, sum, avg, min, max, count, lead, lag
    argument: Optional[RowExpr]
    result_type: T.SqlType
    offset: int = 1  # for lead/lag
    default: Optional[RowExpr] = None


@dataclasses.dataclass
class Window(PlanNode):
    source: PlanNode
    partition_by: list[Symbol]
    order_by: list[Ordering]
    functions: list[tuple[Symbol, WindowFunction]]
    frame: Optional[tuple[str, str, str]] = None

    @property
    def output_symbols(self):
        return self.source.output_symbols + [s for s, _ in self.functions]

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class Output(PlanNode):
    """Root node fixing column names/order for the client.
    Reference: ``plan/OutputNode.java``."""

    source: PlanNode
    column_names: list[str]
    symbols: list[Symbol]

    @property
    def output_symbols(self):
        return self.symbols

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class Unnest(PlanNode):
    """Expand array values into rows (reference:
    ``operator/unnest/UnnestOperator.java:39``). Each source row is
    replicated once per element of each unnested array (arrays zipped
    positionally when several are given, NULL-padded to the longest);
    ``ordinality`` adds a 1-based position column."""

    source: PlanNode
    array_exprs: list[RowExpr]  # over source symbols, ARRAY-typed
    element_symbols: list[Symbol]
    ordinality: Optional[Symbol] = None

    @property
    def output_symbols(self):
        out = self.source.output_symbols + self.element_symbols
        if self.ordinality is not None:
            out = out + [self.ordinality]
        return out

    @property
    def sources(self):
        return [self.source]


@dataclasses.dataclass
class RemoteSource(PlanNode):
    """Leaf standing in for another fragment's output
    (reference: ``plan/RemoteSourceNode.java``). ``exchange_type`` records
    how the feeding fragment's rows arrive: 'hash' (co-partitioned by
    ``keys`` over the mesh), 'broadcast' (replicated), 'single' (gathered),
    or 'source' (left in the producer's scan partitioning)."""

    fragment_id: int
    symbols: list[Symbol]
    exchange_type: str = "single"
    keys: list[Symbol] = dataclasses.field(default_factory=list)

    @property
    def output_symbols(self):
        return self.symbols


@dataclasses.dataclass
class Exchange(PlanNode):
    """Repartitioning boundary (reference: ``plan/ExchangeNode.java``).

    scope: 'remote' (cross-shard collective) | 'local' (within shard —
    usually elided on TPU, XLA handles intra-chip parallelism).
    partitioning: 'hash' (keys), 'broadcast', 'single', 'round_robin'.
    """

    source: PlanNode
    partitioning: str
    keys: list[Symbol] = dataclasses.field(default_factory=list)
    scope: str = "remote"

    @property
    def output_symbols(self):
        return self.source.output_symbols

    @property
    def sources(self):
        return [self.source]


def walk_plan(node: PlanNode):
    yield node
    for s in node.sources:
        yield from walk_plan(s)


def node_label(node: PlanNode) -> str:
    """One-line description of a node (PlanPrinter's node header)."""
    name = type(node).__name__
    detail = ""
    if isinstance(node, TableScan):
        detail = f" {node.catalog}.{node.schema}.{node.table}"
    elif isinstance(node, Filter):
        detail = f" predicate={node.predicate!r}"
    elif isinstance(node, Aggregate):
        detail = f" keys={[s.name for s in node.group_keys]} step={node.step}"
    elif isinstance(node, Join):
        detail = (
            f" {node.join_type}"
            f" criteria={[(a.name, b.name) for a, b in node.criteria]}"
            + (f" dist={node.distribution}" if node.distribution else "")
        )
    elif isinstance(node, (TopN,)):
        detail = f" n={node.count}"
    elif isinstance(node, Limit):
        detail = f" n={node.count}"
    elif isinstance(node, Exchange):
        detail = f" {node.scope}/{node.partitioning} keys={[s.name for s in node.keys]}"
    elif isinstance(node, RemoteSource):
        detail = (
            f" fragment={node.fragment_id} {node.exchange_type}"
            + (f" keys={[s.name for s in node.keys]}" if node.keys else "")
        )
    elif isinstance(node, Output):
        detail = f" columns={node.column_names}"
    return f"{name}{detail} -> {[s.name for s in node.output_symbols][:8]}"


def plan_text(node: PlanNode, indent: int = 0) -> str:
    """EXPLAIN-style tree rendering (reference: planprinter/PlanPrinter.java)."""
    pad = "  " * indent
    lines = [f"{pad}{node_label(node)}"]
    for s in node.sources:
        lines.append(plan_text(s, indent + 1))
    return "\n".join(lines)


def replace_sources(node: PlanNode, new_sources: list["PlanNode"]) -> PlanNode:
    """Shallow-copy ``node`` with its child nodes swapped (used by the
    Memo's group-reference rewrites and the whole-plan passes)."""
    import copy

    out = copy.copy(node)
    if isinstance(node, Join):
        out.left, out.right = new_sources
    elif isinstance(node, SetOp):
        out.inputs = list(new_sources)
    elif hasattr(node, "source") and new_sources:
        out.source = new_sources[0]
    return out


# === CTE re-instantiation ===================================================


def instantiate(node: PlanNode) -> tuple[PlanNode, dict[str, Symbol]]:
    """Deep-copy a plan subtree, renaming every Symbol to a fresh name.

    Each WITH-query reference must own distinct symbols: sharing the plan
    object between two references makes a correlation like
    ``t1.k = t2.k`` degenerate into a tautology over one symbol (the
    reference inlines named queries per reference for the same reason —
    ``StatementAnalyzer.java`` named-query analysis). Returns the clone
    plus the old-name -> new-Symbol mapping so callers can re-point their
    scopes.
    """
    from trino_tpu_torch import ir

    mapping: dict[str, Symbol] = {}
    node_cache: dict[int, PlanNode] = {}

    def map_symbol(s: Symbol) -> Symbol:
        got = mapping.get(s.name)
        if got is None:
            got = Symbol(fresh_name(s.name.rsplit("_", 1)[0] or s.name), s.type)
            mapping[s.name] = got
        return got

    def map_expr(e):
        def repl(x):
            if isinstance(x, ir.Variable):
                # every Variable in a CTE body is produced inside it, so
                # mapping-on-first-sight is safe regardless of field order
                return ir.Variable(
                    type=x.type, name=map_symbol(Symbol(x.name, x.type)).name
                )
            return x

        return ir.transform(e, repl)

    def map_value(v):
        if isinstance(v, PlanNode):
            return clone(v)
        if isinstance(v, Symbol):
            return map_symbol(v)
        if isinstance(v, Ordering):
            return dataclasses.replace(v, symbol=map_symbol(v.symbol))
        if isinstance(v, ir.RowExpr):
            return map_expr(v)
        if isinstance(v, (AggFunction, WindowFunction)):
            kw = {}
            for f in dataclasses.fields(v):
                kw[f.name] = map_value(getattr(v, f.name))
            return type(v)(**kw)
        if isinstance(v, list):
            return [map_value(x) for x in v]
        if isinstance(v, tuple):
            return tuple(map_value(x) for x in v)
        if isinstance(v, dict):
            return {map_value(k): map_value(x) for k, x in v.items()}
        return v

    def clone(n: PlanNode) -> PlanNode:
        got = node_cache.get(id(n))
        if got is not None:
            return got
        kw = {}
        for f in dataclasses.fields(n):
            val = getattr(n, f.name)
            # sources first so symbol mappings exist before expressions
            kw[f.name] = map_value(val) if isinstance(val, PlanNode) else val
        for f in dataclasses.fields(n):
            val = getattr(n, f.name)
            if not isinstance(val, PlanNode):
                kw[f.name] = map_value(val)
        out = type(n)(**kw)
        node_cache[id(n)] = out
        return out

    return clone(node), mapping
