"""Plan canonicalization + fingerprinting for the cross-query program cache.

Reference: Trino keys its generated-code caches on *canonicalized*
``RowExpression``s with constants bound as fields of the generated class
(``sql/gen/ExpressionCompiler.java:56,94`` — a Guava cache over the
expression shape), so ``x < 24`` and ``x < 25`` share one compiled class.
Here: non-structural ``Constant``s in the optimized plan are hoisted into
an ordered parameter vector (each becomes a
:class:`~trino_tpu_torch.ir.HoistedConstant` carrying its position), and
the fingerprint is a sha256 over the canonical plan serde plus everything
else that shapes a captured program — mesh size, codegen-relevant
session properties, parameter count. Two SQL texts whose optimized plans
differ only in hoisted literals fingerprint identically and share
programs (``exec/programs.py``: one CUDA graph a fragment or fused unit);
the literals ride in one typed device tensor a query, which each replay
copies into the graph's parameter buffer (``exec/fragments.py``).

A copy of ``trino_tpu/planner/canonicalize.py``: for the same plan and
session the fingerprint and the parameter list equal the reference's.

What stays baked (structural — changing it changes the traced program):

- LIMIT / TopN counts, partition counts, decimal scales (shape/dtype)
- string literals: they become dictionary truth tables at trace time
- wide DECIMAL literals (|v| >= 2**63): they add hi/lo lanes (rank change)
- arguments that must be concrete at trace time (LIKE patterns,
  ``round`` digits, ``date_trunc`` units, IN-list strings …) — excluded
  automatically because only the whitelisted arithmetic/comparison
  positions below ever hoist
- ``Values`` rows, aggregate arguments, window frame defaults

Runtime *capacities* are deliberately NOT part of the fingerprint: they
live in the per-entry ``_Caps`` signature that keys each program under
the fingerprint entry (bucketed via ``bucket_capacity`` on growth so the
overflow ladder lands on few distinct shapes — see
``exec/fragments.py::_retry_traced``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.config import Session
from trino_tpu_torch.ir import Call, Constant, HoistedConstant, RowExpr, SpecialForm
from trino_tpu_torch.planner import plan as P

# positions where a numeric literal compiles to a plain broadcast lane:
# direct args of these calls (and the desugared members of IN/BETWEEN).
# Everything else — function args the kernels need concrete, string
# comparisons routed through dictionary truth tables — stays baked.
_HOIST_CALLS = frozenset(
    {"eq", "ne", "lt", "le", "gt", "ge",
     "add", "subtract", "multiply", "divide", "modulus"}
)
_HOIST_FORMS = frozenset({"in", "between"})

# session properties that change what a fragment traces into (capacity
# defaults, execution strategy, lowering decisions). Anything NOT listed
# here must not affect codegen, or same-fingerprint queries would want
# different programs. ``device_profiling`` is deliberately absent: it
# observes the SAME program from outside, so toggling it must keep the
# fingerprint stable. The list is the reference's, so that fingerprints
# equal across the two packages. Same for ``batch_window_ms``/``batch_max_size``: they decide whether queries
# WAIT to share a dispatch (exec/batching.py), not what any of them
# traces — cross-query batching groups by cache entry, so the window
# knobs must not split the fingerprint those groups key on.
_CODEGEN_PROPS = (
    "batch_capacity",
    "broadcast_join_threshold_rows",
    # the dense-join knobs pick which join kernel a fragment traces (and
    # whether spill-sized inputs stay on the compiled path), so sort- and
    # dense-strategy runs of one plan must not share a fingerprint
    "dense_join",
    "dynamic_filtering_max_build_rows",
    "enable_dynamic_filtering",
    "execution_mode",
    "fragment_execution",
    "fusion_max_fragments",
    "join_distribution_type",
    "join_reordering_strategy",
    "join_strategy",
    "matmul_join_max_domain",
    # operator telemetry mints extra traced reductions (op! counters), so
    # on/off runs of one plan compile different programs — unlike
    # device_profiling, which observes the SAME program from outside
    "operator_stats",
    # fusion regroups fragments into multi-fragment programs, and the
    # grouping itself is cached per entry (__fusedunits__), so fused and
    # unfused runs of the same plan must not share a fingerprint
    "pipeline_fusion",
    # history seeding changes starting capacities, and capacities live on
    # the shared cache entry (_Caps per program key) — same reason
    # stats_capacity_seeding is listed. history_dir/history_max_entries
    # stay OUT: they pick where/how much truth is kept, not what a
    # fragment traces into.
    "query_history",
    "skew_handling",
    "skew_hot_k",
    "skew_hot_threshold_frac",
    "spill_enabled",
    "spill_partitions",
    "spill_threshold_rows",
    "stats_capacity_seeding",
    "stream_chunk_rows",
    "stream_device_cache_bytes",
    "stream_device_chunk_rows",
    "stream_group_budget",
    "stream_scan_threshold_rows",
    "task_concurrency",
    "tpu_enabled",
    "worker_execution",
)


def _eligible(c: RowExpr) -> bool:
    """Can this literal move to the parameter vector without changing the
    traced program's shape or concreteness requirements?"""
    if type(c) is not Constant:  # exact: never re-hoist a HoistedConstant
        return False
    if c.value is None:  # NULL handling branches on concreteness
        return False
    if T.is_string(c.type):  # becomes a dictionary truth table
        return False
    if not isinstance(c.value, (int, float)):
        return False
    if isinstance(c.value, int) and abs(c.value) >= 1 << 63:
        return False  # wide decimal: extra hi/lo lanes (rank change)
    return True


def _hoist_expr(e: RowExpr, params: list, hoistable: bool) -> RowExpr:
    """Depth-first rewrite; ``hoistable`` marks positions whose literals
    the compiler lowers to plain broadcast lanes. Parameter order is the
    visit order, which is a pure function of the plan shape — two plans
    with equal shape assign equal indices."""
    if isinstance(e, Call):
        ok = e.name in _HOIST_CALLS and not any(
            T.is_string(a.type) for a in e.args
        )
        args = tuple(_hoist_expr(a, params, ok) for a in e.args)
        return e if args == e.args else Call(type=e.type, name=e.name, args=args)
    if isinstance(e, SpecialForm):
        ok = e.form in _HOIST_FORMS and not any(
            T.is_string(a.type) for a in e.args
        )
        # args[0] is the tested value; members/bounds desugar to eq/ge/le
        args = tuple(
            _hoist_expr(a, params, ok and i > 0) for i, a in enumerate(e.args)
        )
        return (
            e if args == e.args
            else SpecialForm(type=e.type, form=e.form, args=args)
        )
    if hoistable and _eligible(e):
        idx = len(params)
        params.append((e.value, e.type))
        return HoistedConstant(type=e.type, value=e.value, index=idx)
    return e


def _rewrite_node(node: P.PlanNode, params: list) -> P.PlanNode:
    """Top-down: hoist this node's expressions, then recurse into sources.
    Only Filter predicates, Project assignments and Join filters hoist —
    every other expression position needs concrete values (Values rows,
    aggregate masks, window defaults, scan pushdowns)."""
    changes: dict[str, Any] = {}
    if isinstance(node, P.Filter):
        p2 = _hoist_expr(node.predicate, params, False)
        if p2 is not node.predicate:
            changes["predicate"] = p2
    elif isinstance(node, P.Project):
        new = [(s, _hoist_expr(e, params, False)) for s, e in node.assignments]
        if any(e2 is not e for (_, e2), (_, e) in zip(new, node.assignments)):
            changes["assignments"] = new
    elif isinstance(node, P.Join) and node.filter is not None:
        f2 = _hoist_expr(node.filter, params, False)
        if f2 is not node.filter:
            changes["filter"] = f2

    if isinstance(node, P.Join):
        left = _rewrite_node(node.left, params)
        right = _rewrite_node(node.right, params)
        if left is not node.left:
            changes["left"] = left
        if right is not node.right:
            changes["right"] = right
    elif isinstance(node, P.SetOp):
        new_inputs = [_rewrite_node(s, params) for s in node.inputs]
        if any(a is not b for a, b in zip(new_inputs, node.inputs)):
            changes["inputs"] = new_inputs
    elif getattr(node, "source", None) is not None:
        src = _rewrite_node(node.source, params)
        if src is not node.source:
            changes["source"] = src
    return dataclasses.replace(node, **changes) if changes else node


def _strip_scan_constraints(node: P.PlanNode) -> P.PlanNode:
    """Drop advisory scan pushdowns from a parameterized plan.

    ``push_into_scans`` baked this query's literals into
    ``TableScan.constraint`` (split pruning) and ``pushed_predicate``;
    replaying them for a different literal could wrongly prune splits.
    Both are advisory — the enclosing Filter still applies the full
    (now parameterized) predicate — so correctness survives, only the
    pruning shortcut is lost. ``limit``/``topn`` hints are structural
    (never hoisted) and stay.
    """
    if isinstance(node, P.TableScan):
        if node.constraint is not None or node.pushed_predicate is not None:
            return dataclasses.replace(
                node, constraint=None, pushed_predicate=None
            )
        return node
    if isinstance(node, P.Join):
        return dataclasses.replace(
            node,
            left=_strip_scan_constraints(node.left),
            right=_strip_scan_constraints(node.right),
        )
    if isinstance(node, P.SetOp):
        return dataclasses.replace(
            node, inputs=[_strip_scan_constraints(s) for s in node.inputs]
        )
    if getattr(node, "source", None) is not None:
        return dataclasses.replace(
            node, source=_strip_scan_constraints(node.source)
        )
    return node


def _bind_expr(e: RowExpr, values: list) -> RowExpr:
    if isinstance(e, HoistedConstant):
        return Constant(type=e.type, value=values[e.index])
    if isinstance(e, Call):
        args = tuple(_bind_expr(a, values) for a in e.args)
        return e if args == e.args else Call(type=e.type, name=e.name, args=args)
    if isinstance(e, SpecialForm):
        args = tuple(_bind_expr(a, values) for a in e.args)
        return (
            e if args == e.args
            else SpecialForm(type=e.type, form=e.form, args=args)
        )
    return e


def _bind_node(node: P.PlanNode, values: list) -> P.PlanNode:
    """Mirror of ``_rewrite_node``'s positions, replacing each
    ``HoistedConstant`` with a plain ``Constant`` carrying this query's
    literal."""
    changes: dict[str, Any] = {}
    if isinstance(node, P.Filter):
        p2 = _bind_expr(node.predicate, values)
        if p2 is not node.predicate:
            changes["predicate"] = p2
    elif isinstance(node, P.Project):
        new = [(s, _bind_expr(e, values)) for s, e in node.assignments]
        if any(e2 is not e for (_, e2), (_, e) in zip(new, node.assignments)):
            changes["assignments"] = new
    elif isinstance(node, P.Join) and node.filter is not None:
        f2 = _bind_expr(node.filter, values)
        if f2 is not node.filter:
            changes["filter"] = f2

    if isinstance(node, P.Join):
        left = _bind_node(node.left, values)
        right = _bind_node(node.right, values)
        if left is not node.left:
            changes["left"] = left
        if right is not node.right:
            changes["right"] = right
    elif isinstance(node, P.SetOp):
        new_inputs = [_bind_node(s, values) for s in node.inputs]
        if any(a is not b for a, b in zip(new_inputs, node.inputs)):
            changes["inputs"] = new_inputs
    elif getattr(node, "source", None) is not None:
        src = _bind_node(node.source, values)
        if src is not node.source:
            changes["source"] = src
    return dataclasses.replace(node, **changes) if changes else node


def bind_params(plan: P.PlanNode, params: list) -> P.PlanNode:
    """Re-bake a canonical plan's hoisted literals as plain Constants.

    The inverse of hoisting, for executors that cannot carry a parameter
    vector: the cluster scheduler ships fragments over the wire and the
    canonical serde intentionally drops ``HoistedConstant`` values, so a
    cluster (or batched-then-sequential-fallback) run of a cached plan
    must bind THIS query's ``params`` back in before fragmentation.
    ``params`` is the ordered ``(value, type)`` list ``canonicalize_plan``
    returned — for a batch member, its own vector, not the leader's."""
    if not params:
        return plan
    return _bind_node(plan, [v for v, _ in params])


def _alpha_rename(obj: Any, names: dict) -> Any:
    """Positionally rename symbols in the serialized plan (``count_16`` →
    ``s3``). The planner allocates symbol names off a process-global
    counter, so two structurally identical plans planned at different
    times carry different names; first-visit order is a pure function of
    the plan shape, so equal shapes map to equal canonical names. Only
    ``"n"`` values (symbol serde) and ``"name"`` values of ``var`` exprs
    rename — ``call`` names are function names and stay."""
    if isinstance(obj, list):
        return [_alpha_rename(x, names) for x in obj]
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "n" or (k == "name" and obj.get("k") == "var"):
                if v not in names:
                    names[v] = f"s{len(names)}"
                out[k] = names[v]
            else:
                out[k] = _alpha_rename(v, names)
        return out
    return obj


def plan_fingerprint(
    root: P.PlanNode, session: Session, mesh_devices: int = 1, nparams: int = 0
) -> Optional[str]:
    """Stable sha256 over the canonical plan serde + codegen context.

    Returns None when the plan contains nodes the canonical serde cannot
    express (e.g. Unnest) — those statements simply run uncached.
    """
    from trino_tpu_torch.planner.serde import node_to_json

    try:
        doc = _alpha_rename(node_to_json(root), {})
        props = {}
        for name in _CODEGEN_PROPS:
            try:
                props[name] = repr(session.get(name))
            except KeyError:
                continue
        payload = json.dumps(
            {
                "plan": doc,
                "mesh": int(mesh_devices),
                "props": props,
                "nparams": int(nparams),
            },
            sort_keys=True,
            separators=(",", ":"),
            default=str,
        )
    except Exception:  # noqa: BLE001 — unserializable plan: run uncached
        return None
    return hashlib.sha256(payload.encode()).hexdigest()


def canonicalize_plan(
    plan: P.PlanNode, session: Session, mesh_devices: int = 1
) -> tuple[P.PlanNode, list, Optional[str]]:
    """Hoist non-structural literals and fingerprint the optimized plan.

    Returns ``(canonical_plan, params, fingerprint)`` where ``params`` is
    the ordered list of ``(value, type)`` hoisted literals and
    ``fingerprint`` is None for uncacheable shapes. With
    ``constant_hoisting`` off the plan is returned untouched (every
    literal variation then fingerprints — and compiles — separately).
    """
    params: list = []
    root = plan
    if bool(session.get("constant_hoisting")):
        root = _rewrite_node(plan, params)
        if params:
            root = _strip_scan_constraints(root)
    fp = plan_fingerprint(root, session, mesh_devices, nparams=len(params))
    return root, params, fp


# aggregate kinds whose partial state merges exactly by row-wise combine
# of final values: sum/min/max combine with themselves, count combines by
# addition. avg is OUT (final value loses the count weight); distinct and
# filtered aggregates are OUT (their state is not the output value).
_MAINTAINABLE_AGGS = frozenset({"sum", "count", "count_star", "min", "max"})


def _sum_merges_exactly(t) -> bool:
    # float sums are order-dependent: cached + delta would differ in the
    # last ulp from a cold re-execution, breaking bit-identity. Integer
    # and decimal sums are exact under any association.
    return T.is_integer(t) or isinstance(t, T.DecimalType)


def classify_maintainability(root: P.PlanNode) -> Optional[dict]:
    """Can this plan's cached result be maintained incrementally on
    append? Yes only for the shape ``Output <- Aggregate(single) <-
    (Filter|Project)* <- TableScan`` where every aggregate merges exactly
    (:data:`_MAINTAINABLE_AGGS`, exact-sum types) and every group key is
    visible in the output (hidden keys could merge distinct output rows).

    Returns ``{"table": (catalog, schema, table), "cols": (kind, ...)}``
    with one kind per output column — ``"key"``, ``"sum"``, ``"count"``,
    ``"min"`` or ``"max"`` — or None for non-maintainable shapes (joins,
    sorts, limits, avg, distinct, filtered aggregates, multi-scan plans),
    which fall back to plain invalidation.
    """
    if not isinstance(root, P.Output):
        return None
    from trino_tpu_torch.ir import Variable

    # the planner renames aggregate symbols to output names through pure
    # identity Projects (sum_4 -> s); follow each output symbol down the
    # rename chain to the symbol the Aggregate actually produces. Any
    # computed assignment (sum(v) + 1) makes that column non-maintainable.
    rename: dict[str, Optional[str]] = {s.name: s.name for s in root.symbols}
    node = root.source
    while isinstance(node, P.Project):
        sub: dict[str, Optional[str]] = {}
        for sym, expr in node.assignments:
            sub[sym.name] = expr.name if isinstance(expr, Variable) else None
        rename = {
            out: (sub.get(cur) if cur is not None else None)
            for out, cur in rename.items()
        }
        node = node.source
    agg = node
    if not isinstance(agg, P.Aggregate) or agg.step != "single":
        return None
    by_symbol: dict[str, str] = {}
    for s in agg.group_keys:
        by_symbol[s.name] = "key"
    for s, fn in agg.aggregates:
        if fn.kind not in _MAINTAINABLE_AGGS:
            return None
        if fn.distinct or fn.filter is not None:
            return None
        if fn.kind == "sum" and not _sum_merges_exactly(fn.result_type):
            return None
        by_symbol[s.name] = "count" if fn.kind in ("count", "count_star") else fn.kind
    cols = []
    for s in root.symbols:
        src_name = rename.get(s.name)
        kind = by_symbol.get(src_name) if src_name is not None else None
        if kind is None:  # output column that is neither key nor aggregate
            return None
        cols.append(kind)
    visible = {rename[s.name] for s in root.symbols}
    if any(s.name not in visible for s in agg.group_keys):
        return None
    node = agg.source
    while isinstance(node, (P.Filter, P.Project)):
        node = node.source
    if not isinstance(node, P.TableScan):
        return None
    return {
        "table": (node.catalog, node.schema, node.table),
        "cols": tuple(cols),
    }
