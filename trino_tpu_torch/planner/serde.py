"""Plan / expression JSON serialization — the TaskUpdateRequest wire format.

A copy of ``trino_tpu/planner/serde.py`` on the port's IR and plan nodes:
the JSON of a plan equals the reference's for the same plan, so the
canonical fingerprints (``planner/canonicalize.py``) equal it too.

Reference: Trino ships each fragment to workers as JSON inside
``TaskUpdateRequest`` (``server/TaskResource.java:127`` — body carries the
serialized ``PlanFragment`` plus split assignments); Jackson serializers
live on the plan-node classes themselves. Here: explicit to/from-JSON for
the 6-kind RowExpr IR, plan nodes, and PlanFragment.

Notes:
- types round-trip through ``str(type)`` / ``T.parse_type``
- scan ``constraint``/``pushed_predicate`` are advisory (the enclosing
  Filter re-applies the full predicate) and do not cross the wire; split
  pruning already happened on the coordinator during scheduling
"""

from __future__ import annotations

from decimal import Decimal
from typing import Any

from trino_tpu_torch import types as T
from trino_tpu_torch.ir import (
    Call,
    Constant,
    HoistedConstant,
    InputRef,
    RowExpr,
    SpecialForm,
    Variable,
)
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import Partitioning, PlanFragment


# === expressions ============================================================


def expr_to_json(e: RowExpr | None) -> Any:
    if e is None:
        return None
    t = str(e.type)
    if isinstance(e, InputRef):
        return {"k": "input", "t": t, "channel": e.channel}
    if isinstance(e, HoistedConstant):
        # canonical by construction: the literal lives in the query's
        # parameter vector, not the plan, so literal variants serialize —
        # and fingerprint — identically (planner/canonicalize.py)
        return {"k": "hoisted", "t": t, "index": e.index}
    if isinstance(e, Constant):
        v = e.value
        if isinstance(v, Decimal):
            v = {"$decimal": str(v)}
        return {"k": "const", "t": t, "value": v}
    if isinstance(e, Variable):
        return {"k": "var", "t": t, "name": e.name}
    if isinstance(e, Call):
        return {
            "k": "call",
            "t": t,
            "name": e.name,
            "args": [expr_to_json(a) for a in e.args],
        }
    if isinstance(e, SpecialForm):
        return {
            "k": "special",
            "t": t,
            "form": e.form,
            "args": [expr_to_json(a) for a in e.args],
        }
    raise TypeError(f"unserializable expression {type(e).__name__}")


def expr_from_json(d: Any) -> RowExpr | None:
    if d is None:
        return None
    t = T.parse_type(d["t"])
    k = d["k"]
    if k == "input":
        return InputRef(type=t, channel=d["channel"])
    if k == "hoisted":
        # the value is deliberately absent; execution must supply a
        # parameter vector (interpreter paths re-bake from it too)
        return HoistedConstant(type=t, value=None, index=d["index"])
    if k == "const":
        v = d["value"]
        if isinstance(v, dict) and "$decimal" in v:
            v = Decimal(v["$decimal"])
        return Constant(type=t, value=v)
    if k == "var":
        return Variable(type=t, name=d["name"])
    if k == "call":
        return Call(
            type=t, name=d["name"], args=tuple(expr_from_json(a) for a in d["args"])
        )
    if k == "special":
        return SpecialForm(
            type=t, form=d["form"], args=tuple(expr_from_json(a) for a in d["args"])
        )
    raise TypeError(f"unknown expression kind {k!r}")


# === symbols / orderings ====================================================


def _sym(s: P.Symbol) -> dict:
    return {"n": s.name, "t": str(s.type)}


def _sym_from(d: dict) -> P.Symbol:
    return P.Symbol(d["n"], T.parse_type(d["t"]))


def _ord(o: P.Ordering) -> dict:
    return {"s": _sym(o.symbol), "asc": o.ascending, "nf": o.nulls_first}


def _ord_from(d: dict) -> P.Ordering:
    return P.Ordering(_sym_from(d["s"]), d["asc"], d["nf"])


# === plan nodes =============================================================


def node_to_json(node: P.PlanNode) -> dict:
    if isinstance(node, P.TableScan):
        return {
            "k": "tablescan",
            "catalog": node.catalog,
            "schema": node.schema,
            "table": node.table,
            "symbols": [_sym(s) for s in node.symbols],
            "columns": list(node.column_names),
            "limit": node.limit,
            "topn": node.topn,
        }
    if isinstance(node, P.RemoteSource):
        return {
            "k": "remotesource",
            "fragment": node.fragment_id,
            "symbols": [_sym(s) for s in node.symbols],
            "exchange": node.exchange_type,
            "keys": [_sym(s) for s in node.keys],
        }
    if isinstance(node, P.Values):
        rows = [
            [
                {"$decimal": str(v)} if isinstance(v, Decimal) else v
                for v in row
            ]
            for row in node.rows
        ]
        return {
            "k": "values",
            "symbols": [_sym(s) for s in node.symbols],
            "rows": rows,
        }
    if isinstance(node, P.Filter):
        return {
            "k": "filter",
            "source": node_to_json(node.source),
            "predicate": expr_to_json(node.predicate),
        }
    if isinstance(node, P.Project):
        return {
            "k": "project",
            "source": node_to_json(node.source),
            "assignments": [
                [_sym(s), expr_to_json(e)] for s, e in node.assignments
            ],
        }
    if isinstance(node, P.Aggregate):
        return {
            "k": "aggregate",
            "source": node_to_json(node.source),
            "keys": [_sym(s) for s in node.group_keys],
            "aggs": [
                {
                    "s": _sym(s),
                    "kind": fn.kind,
                    "arg": expr_to_json(fn.argument),
                    "rt": str(fn.result_type),
                    "distinct": fn.distinct,
                    "filter": expr_to_json(fn.filter),
                }
                for s, fn in node.aggregates
            ],
            "step": node.step,
            "acc": [
                [_sym(v), _sym(c) if c is not None else None]
                for v, c in node.acc_symbols
            ]
            if node.acc_symbols is not None
            else None,
        }
    if isinstance(node, P.Join):
        return {
            "k": "join",
            "type": node.join_type,
            "left": node_to_json(node.left),
            "right": node_to_json(node.right),
            "criteria": [[_sym(a), _sym(b)] for a, b in node.criteria],
            "filter": expr_to_json(node.filter),
            "distribution": node.distribution,
            "mark": _sym(node.mark_symbol) if node.mark_symbol else None,
            "null_aware": node.null_aware,
            "single_row": node.single_row,
        }
    if isinstance(node, P.GroupId):
        return {
            "k": "groupid",
            "source": node_to_json(node.source),
            "groups": [[_sym(s) for s in g] for g in node.groups],
            "all_keys": [_sym(s) for s in node.all_keys],
            "gid": _sym(node.gid),
        }
    if isinstance(node, P.Sort):
        return {
            "k": "sort",
            "source": node_to_json(node.source),
            "order": [_ord(o) for o in node.order_by],
        }
    if isinstance(node, P.TopN):
        return {
            "k": "topn",
            "source": node_to_json(node.source),
            "count": node.count,
            "order": [_ord(o) for o in node.order_by],
            "step": node.step,
        }
    if isinstance(node, P.Limit):
        return {
            "k": "limit",
            "source": node_to_json(node.source),
            "count": node.count,
            "offset": node.offset,
        }
    if isinstance(node, P.Distinct):
        return {"k": "distinct", "source": node_to_json(node.source)}
    if isinstance(node, P.SetOp):
        return {
            "k": "setop",
            "op": node.op,
            "distinct": node.distinct,
            "inputs": [node_to_json(s) for s in node.inputs],
            "symbols": [_sym(s) for s in node.symbols],
        }
    if isinstance(node, P.Window):
        return {
            "k": "window",
            "source": node_to_json(node.source),
            "partition": [_sym(s) for s in node.partition_by],
            "order": [_ord(o) for o in node.order_by],
            "functions": [
                {
                    "s": _sym(s),
                    "kind": fn.kind,
                    "arg": expr_to_json(fn.argument),
                    "rt": str(fn.result_type),
                    "offset": fn.offset,
                    "default": expr_to_json(fn.default),
                }
                for s, fn in node.functions
            ],
            "frame": list(node.frame) if node.frame else None,
        }
    if isinstance(node, P.Output):
        return {
            "k": "output",
            "source": node_to_json(node.source),
            "names": list(node.column_names),
            "symbols": [_sym(s) for s in node.symbols],
        }
    if isinstance(node, P.Exchange):
        return {
            "k": "exchange",
            "source": node_to_json(node.source),
            "partitioning": node.partitioning,
            "keys": [_sym(s) for s in node.keys],
            "scope": node.scope,
        }
    raise TypeError(f"unserializable plan node {type(node).__name__}")


def node_from_json(d: dict) -> P.PlanNode:
    k = d["k"]
    if k == "tablescan":
        return P.TableScan(
            d["catalog"],
            d["schema"],
            d["table"],
            [_sym_from(s) for s in d["symbols"]],
            list(d["columns"]),
            limit=d.get("limit"),
            topn=d.get("topn"),
        )
    if k == "remotesource":
        return P.RemoteSource(
            d["fragment"],
            [_sym_from(s) for s in d["symbols"]],
            d["exchange"],
            [_sym_from(s) for s in d["keys"]],
        )
    if k == "values":
        rows = [
            [
                Decimal(v["$decimal"]) if isinstance(v, dict) and "$decimal" in v else v
                for v in row
            ]
            for row in d["rows"]
        ]
        return P.Values([_sym_from(s) for s in d["symbols"]], rows)
    if k == "filter":
        return P.Filter(node_from_json(d["source"]), expr_from_json(d["predicate"]))
    if k == "project":
        return P.Project(
            node_from_json(d["source"]),
            [(_sym_from(s), expr_from_json(e)) for s, e in d["assignments"]],
        )
    if k == "aggregate":
        aggs = [
            (
                _sym_from(a["s"]),
                P.AggFunction(
                    a["kind"],
                    expr_from_json(a["arg"]),
                    T.parse_type(a["rt"]),
                    a["distinct"],
                    expr_from_json(a["filter"]),
                ),
            )
            for a in d["aggs"]
        ]
        acc = None
        if d.get("acc") is not None:
            acc = [
                (_sym_from(v), _sym_from(c) if c is not None else None)
                for v, c in d["acc"]
            ]
        return P.Aggregate(
            node_from_json(d["source"]),
            [_sym_from(s) for s in d["keys"]],
            aggs,
            d["step"],
            acc,
        )
    if k == "join":
        return P.Join(
            d["type"],
            node_from_json(d["left"]),
            node_from_json(d["right"]),
            [(_sym_from(a), _sym_from(b)) for a, b in d["criteria"]],
            expr_from_json(d["filter"]),
            d["distribution"],
            _sym_from(d["mark"]) if d["mark"] else None,
            d["null_aware"],
            d["single_row"],
        )
    if k == "groupid":
        return P.GroupId(
            node_from_json(d["source"]),
            [[_sym_from(s) for s in g] for g in d["groups"]],
            [_sym_from(s) for s in d["all_keys"]],
            _sym_from(d["gid"]),
        )
    if k == "sort":
        return P.Sort(node_from_json(d["source"]), [_ord_from(o) for o in d["order"]])
    if k == "topn":
        return P.TopN(
            node_from_json(d["source"]),
            d["count"],
            [_ord_from(o) for o in d["order"]],
            d["step"],
        )
    if k == "limit":
        return P.Limit(node_from_json(d["source"]), d["count"], d["offset"])
    if k == "distinct":
        return P.Distinct(node_from_json(d["source"]))
    if k == "setop":
        return P.SetOp(
            d["op"],
            d["distinct"],
            [node_from_json(s) for s in d["inputs"]],
            [_sym_from(s) for s in d["symbols"]],
        )
    if k == "window":
        fns = [
            (
                _sym_from(f["s"]),
                P.WindowFunction(
                    f["kind"],
                    expr_from_json(f["arg"]),
                    T.parse_type(f["rt"]),
                    f["offset"],
                    expr_from_json(f["default"]),
                ),
            )
            for f in d["functions"]
        ]
        return P.Window(
            node_from_json(d["source"]),
            [_sym_from(s) for s in d["partition"]],
            [_ord_from(o) for o in d["order"]],
            fns,
            tuple(d["frame"]) if d["frame"] else None,
        )
    if k == "output":
        return P.Output(
            node_from_json(d["source"]),
            list(d["names"]),
            [_sym_from(s) for s in d["symbols"]],
        )
    if k == "exchange":
        return P.Exchange(
            node_from_json(d["source"]),
            d["partitioning"],
            [_sym_from(s) for s in d["keys"]],
            d["scope"],
        )
    raise TypeError(f"unknown plan node kind {k!r}")


# === fragments ==============================================================


def fragment_to_json(f: PlanFragment) -> dict:
    return {
        "id": f.id,
        "root": node_to_json(f.root),
        "partitioning": {"kind": f.partitioning.kind, "keys": list(f.partitioning.keys)},
        "output_exchange": f.output_exchange,
        "output_keys": [_sym(s) for s in f.output_keys],
    }


def fragment_from_json(d: dict, validate: bool = False) -> PlanFragment:
    frag = PlanFragment(
        d["id"],
        node_from_json(d["root"]),
        Partitioning(d["partitioning"]["kind"], tuple(d["partitioning"]["keys"])),
        d["output_exchange"],
        [_sym_from(s) for s in d["output_keys"]],
    )
    if validate:
        # worker-side trust boundary: a fragment off the wire gets the same
        # sanity battery as the coordinator-side plan before it executes
        from trino_tpu_torch.planner.sanity import PlanSanityChecker

        PlanSanityChecker.validate_deserialized(frag)
    return frag
