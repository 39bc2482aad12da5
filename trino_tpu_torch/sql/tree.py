"""SQL AST nodes.

Reference: ``core/trino-parser/src/main/java/io/trino/sql/tree/`` (197 node
classes). We keep a compact set covering the TPC-H/TPC-DS query surface plus
the utility statements the engine needs (EXPLAIN, SHOW, SET SESSION).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Node:
    pass


# --- expressions -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Identifier(Node):
    parts: tuple[str, ...]  # possibly qualified: (table, column) or (column,)

    def __str__(self):
        return ".".join(self.parts)


@dataclasses.dataclass(frozen=True)
class Literal(Node):
    value: Any  # python value; None for NULL
    kind: str  # 'null'|'boolean'|'integer'|'decimal'|'double'|'string'|'date'|'timestamp'|'interval'


@dataclasses.dataclass(frozen=True)
class IntervalLiteral(Node):
    value: int
    unit: str  # 'year'|'month'|'day'|'hour'|'minute'|'second'
    sign: int = 1


@dataclasses.dataclass(frozen=True)
class Star(Node):
    qualifier: Optional[str] = None  # t.* has qualifier 't'


@dataclasses.dataclass(frozen=True)
class UnaryOp(Node):
    op: str  # '-' | '+' | 'NOT'
    operand: Node


@dataclasses.dataclass(frozen=True)
class BinaryOp(Node):
    op: str  # arithmetic: + - * / % || ; comparison: = <> < <= > >= ; logical: AND OR
    left: Node
    right: Node


@dataclasses.dataclass(frozen=True)
class IsNull(Node):
    operand: Node
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Between(Node):
    value: Node
    low: Node
    high: Node
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InList(Node):
    value: Node
    items: tuple[Node, ...]
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class QuantifiedComparison(Node):
    """value OP ANY|ALL (query) — reference: tree/QuantifiedComparisonExpression."""

    op: str = "="
    quantifier: str = "ANY"  # ANY | ALL (SOME == ANY)
    value: Optional[Node] = None
    query: Optional["Query"] = None


@dataclasses.dataclass(frozen=True)
class GroupingSets(Node):
    """GROUP BY GROUPING SETS / ROLLUP / CUBE — reference: tree/GroupingSets."""

    kind: str = "GROUPING SETS"  # GROUPING SETS | ROLLUP | CUBE
    sets: tuple[tuple[Node, ...], ...] = ()


@dataclasses.dataclass(frozen=True)
class InSubquery(Node):
    value: Node
    query: "Query"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Exists(Node):
    query: "Query"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class ScalarSubquery(Node):
    query: "Query"


@dataclasses.dataclass(frozen=True)
class Like(Node):
    value: Node
    pattern: Node
    escape: Optional[Node] = None
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class FunctionCall(Node):
    name: str
    args: tuple[Node, ...]
    distinct: bool = False
    window: Optional["WindowSpec"] = None
    filter: Optional[Node] = None


@dataclasses.dataclass(frozen=True)
class WindowSpec(Node):
    partition_by: tuple[Node, ...] = ()
    order_by: tuple["SortItem", ...] = ()
    frame: Optional[tuple[str, str, str]] = None  # (type, start, end)


@dataclasses.dataclass(frozen=True)
class Cast(Node):
    operand: Node
    target: str  # type text, parsed by types.parse_type
    safe: bool = False  # TRY_CAST


@dataclasses.dataclass(frozen=True)
class Extract(Node):
    field: str  # YEAR/MONTH/DAY/...
    operand: Node


@dataclasses.dataclass(frozen=True)
class Case(Node):
    operand: Optional[Node]  # simple CASE has operand; searched has None
    whens: tuple[tuple[Node, Node], ...]
    default: Optional[Node]


# --- relations -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Table(Node):
    name: tuple[str, ...]  # catalog.schema.table, any suffix length


@dataclasses.dataclass(frozen=True)
class AliasedRelation(Node):
    relation: Node
    alias: str
    column_aliases: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Join(Node):
    join_type: str  # INNER | LEFT | RIGHT | FULL | CROSS
    left: Node
    right: Node
    criteria: Optional[Node] = None  # ON expression
    using: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SubqueryRelation(Node):
    query: "Query"


@dataclasses.dataclass(frozen=True)
class Values(Node):
    rows: tuple[tuple[Node, ...], ...]


@dataclasses.dataclass(frozen=True)
class Unnest(Node):
    expressions: tuple[Node, ...]
    with_ordinality: bool = False


@dataclasses.dataclass(frozen=True)
class ArrayLiteral(Node):
    items: tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class Subscript(Node):
    """``base[index]`` — ARRAY element, MAP value, or ROW field access."""

    base: Node
    index: Node


# --- query structure -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SelectItem(Node):
    expression: Node  # or Star
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SortItem(Node):
    expression: Node
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = type default (Trino: last for asc)


@dataclasses.dataclass(frozen=True)
class QuerySpec(Node):
    select_items: tuple[SelectItem, ...]
    distinct: bool = False
    from_: Optional[Node] = None
    where: Optional[Node] = None
    group_by: tuple[Node, ...] = ()
    having: Optional[Node] = None


@dataclasses.dataclass(frozen=True)
class SetOperation(Node):
    op: str  # UNION | EXCEPT | INTERSECT
    distinct: bool  # True unless ALL
    left: Node  # QuerySpec | SetOperation
    right: Node


@dataclasses.dataclass(frozen=True)
class WithQuery(Node):
    name: str
    query: "Query"
    column_aliases: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Query(Node):
    body: Node  # QuerySpec | SetOperation | Values
    with_queries: tuple[WithQuery, ...] = ()
    order_by: tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


# --- statements ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Explain(Node):
    statement: Node
    analyze: bool = False


@dataclasses.dataclass(frozen=True)
class SetSession(Node):
    name: str
    value: Node


@dataclasses.dataclass(frozen=True)
class ShowTables(Node):
    schema: Optional[tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class ShowSchemas(Node):
    catalog: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ShowCatalogs(Node):
    pass


@dataclasses.dataclass(frozen=True)
class ShowColumns(Node):
    table: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class CreateTableAsSelect(Node):
    name: tuple[str, ...] = ()
    query: Optional[Query] = None


@dataclasses.dataclass(frozen=True)
class InsertInto(Node):
    name: tuple[str, ...] = ()
    columns: tuple[str, ...] = ()
    query: Optional[Query] = None


@dataclasses.dataclass(frozen=True)
class CreateTable(Node):
    """CREATE TABLE name (col type, ...) — reference: tree/CreateTable."""

    name: tuple[str, ...] = ()
    columns: tuple[tuple[str, str], ...] = ()  # (name, type text)
    not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class Delete(Node):
    name: tuple[str, ...] = ()
    where: Optional[Node] = None


@dataclasses.dataclass(frozen=True)
class Prepare(Node):
    name: str = ""
    statement: Optional[Node] = None
    sql: str = ""


@dataclasses.dataclass(frozen=True)
class Execute(Node):
    name: str = ""
    parameters: tuple[Node, ...] = ()


@dataclasses.dataclass(frozen=True)
class Deallocate(Node):
    name: str = ""


@dataclasses.dataclass(frozen=True)
class Parameter(Node):
    """A ? placeholder in a prepared statement."""

    index: int = 0


@dataclasses.dataclass(frozen=True)
class StartTransaction(Node):
    pass


@dataclasses.dataclass(frozen=True)
class Commit(Node):
    pass


@dataclasses.dataclass(frozen=True)
class Rollback(Node):
    pass


@dataclasses.dataclass(frozen=True)
class DropTable(Node):
    name: tuple[str, ...] = ()
    if_exists: bool = False
