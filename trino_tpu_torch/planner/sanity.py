"""Plan sanity checkers: typed validation after every optimizer stage.

Reference: ``io.trino.sql.planner.sanity/`` — ``PlanSanityChecker`` runs a
battery of checkers (``TypeValidator``, ``ValidateDependenciesChecker``,
``NoDuplicatePlanNodeIdsChecker``, ``ValidateAggregationsWithDefaultValues``,
…) after each optimizer stage and before execution, so a broken rewrite
fails fast with a typed error instead of a wrong answer at runtime.

Here the battery is:

- ``ValidateDependenciesChecker`` — every symbol a node consumes must be
  produced by its sources (the reference checker of the same name).
- ``TypeValidator`` — bottom-up type propagation: every ``Variable``
  reference must carry the producing symbol's type; node-level typing
  rules (boolean predicates, Project assignment types, comparable join
  criteria) must hold.
- ``NoDuplicatePlanNodesChecker`` — no plan-node *object* may appear at
  two positions in the tree. Our nodes have no ids; aliasing a subtree is
  the analog of the reference's duplicated-plan-node-id bug (the exact
  hazard ``planner/plan.py`` ``instantiate()`` exists to prevent).
- ``AggregationChecker`` — aggregation well-formedness: group keys come
  from the source, aggregate kinds are known, input dtypes are valid for
  the function, partial/final accumulator symbols are consistent.
- ``Decimal128Checker`` — DECIMAL precision/scale invariants for the
  ``ops/decimal128.py`` lowerings: 0 <= scale <= precision <= 38 and the
  reference scale-derivation rules for decimal arithmetic.
- ``ExchangeConsistencyChecker`` — Exchange/RemoteSource shape rules in
  whole plans, plus cross-fragment agreement (``validate_fragments``):
  every RemoteSource must match its feeding fragment's output exchange
  kind, hash keys, and column list.

Entry points mirror the reference's ``validateIntermediatePlan`` /
``validateFinalPlan`` (+ a fragment-tree variant):
``PlanSanityChecker.validate_intermediate`` runs after each optimizer
stage, ``validate_final`` after the last one, ``validate_fragments`` after
fragmentation, and ``validate_deserialized`` on the worker after a
fragment comes off the wire (``planner/serde.py``). All are gated by the
``plan_validation`` session property (on by default).
"""

from __future__ import annotations

from typing import Iterator, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.ir import Call, Constant, RowExpr, SpecialForm, Variable
from trino_tpu_torch.ops.aggregation import AGG_KINDS
from trino_tpu_torch.planner import plan as P


class PlanValidationError(Exception):
    """A sanity checker rejected a plan.

    Carries the checker's name and the path of node-type names from the
    plan root to the offending node, so the failure points at the broken
    rewrite rather than at a wrong answer downstream.
    """

    def __init__(self, checker: str, message: str, path: str = "", stage: str = ""):
        self.checker = checker
        self.message = message
        self.path = path
        self.stage = stage
        loc = f" at {path}" if path else ""
        st = f" (after {stage})" if stage else ""
        super().__init__(f"[{checker}]{st}{loc}: {message}")


def validation_enabled(session) -> bool:
    if session is None:
        return True
    try:
        return bool(session.get("plan_validation"))
    except KeyError:
        return True


# === tree walking with paths ================================================


def _children(node: P.PlanNode) -> list[tuple[str, P.PlanNode]]:
    """(slot label, child) pairs — labels make error paths readable."""
    if isinstance(node, P.Join):
        return [("left", node.left), ("right", node.right)]
    if isinstance(node, P.SetOp):
        return [(f"inputs[{i}]", c) for i, c in enumerate(node.inputs)]
    return [("source", s) for s in node.sources]


def _walk(node: P.PlanNode, path: tuple[str, ...] = ()) -> Iterator[tuple[P.PlanNode, tuple[str, ...]]]:
    here = path + (type(node).__name__,)
    yield node, here
    for label, child in _children(node):
        yield from _walk(child, here)


def _fmt_path(path: tuple[str, ...]) -> str:
    return ">".join(path)


def _exprs_of(node: P.PlanNode) -> list[RowExpr]:
    """Every RowExpr the node evaluates (not its children's)."""
    out: list[RowExpr] = []
    if isinstance(node, P.Filter):
        out.append(node.predicate)
    elif isinstance(node, P.Project):
        out.extend(e for _, e in node.assignments)
    elif isinstance(node, P.Aggregate):
        if node.step != "final":
            for _, fn in node.aggregates:
                if fn.argument is not None:
                    out.append(fn.argument)
                if fn.filter is not None:
                    out.append(fn.filter)
    elif isinstance(node, P.Join):
        if node.filter is not None:
            out.append(node.filter)
    elif isinstance(node, P.Window):
        for _, fn in node.functions:
            if fn.argument is not None:
                out.append(fn.argument)
            if fn.default is not None:
                out.append(fn.default)
    elif isinstance(node, P.Unnest):
        out.extend(node.array_exprs)
    elif isinstance(node, P.TableScan):
        if node.pushed_predicate is not None:
            out.append(node.pushed_predicate)
    return out


def _walk_expr(e: RowExpr) -> Iterator[RowExpr]:
    yield e
    if isinstance(e, (Call, SpecialForm)):
        for a in e.args:
            yield from _walk_expr(a)


def _source_symbols(node: P.PlanNode) -> dict[str, T.SqlType]:
    env: dict[str, T.SqlType] = {}
    for s in node.sources:
        for sym in s.output_symbols:
            env[sym.name] = sym.type
    return env


# === checkers ===============================================================


class Checker:
    name = "Checker"

    def check(self, root: P.PlanNode) -> None:
        raise NotImplementedError

    def fail(self, message: str, path: tuple[str, ...] = ()) -> None:
        raise PlanValidationError(self.name, message, _fmt_path(path))


class ValidateDependenciesChecker(Checker):
    """Every symbol a node consumes is produced by its sources.

    Reference: ``sanity/ValidateDependenciesChecker.java``.
    """

    name = "ValidateDependenciesChecker"

    def check(self, root: P.PlanNode) -> None:
        for node, path in _walk(root):
            produced = set(_source_symbols(node))
            for needed, what in self._consumed(node):
                if needed not in produced:
                    self.fail(
                        f"{what} references symbol '{needed}' not produced "
                        f"by the node's sources (available: {sorted(produced)[:12]})",
                        path,
                    )
            self._check_scoped(node, path)

    def _consumed(self, node: P.PlanNode) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []

        def refs(e: Optional[RowExpr], what: str) -> None:
            if e is None:
                return
            for sub in _walk_expr(e):
                if isinstance(sub, Variable):
                    out.append((sub.name, what))

        if isinstance(node, P.Filter):
            refs(node.predicate, "filter predicate")
        elif isinstance(node, P.Project):
            for s, e in node.assignments:
                refs(e, f"projection '{s.name}'")
        elif isinstance(node, P.Aggregate):
            for k in node.group_keys:
                out.append((k.name, "group-by key"))
            if node.step == "final" and node.acc_symbols is not None:
                # a final step consumes the partial's accumulator columns
                # off the exchange, not the original aggregate inputs
                for v, c in node.acc_symbols:
                    out.append((v.name, "accumulator value"))
                    if c is not None:
                        out.append((c.name, "accumulator count"))
            else:
                for s, fn in node.aggregates:
                    refs(fn.argument, f"aggregate '{s.name}' argument")
                    refs(fn.filter, f"aggregate '{s.name}' filter")
        elif isinstance(node, P.Sort):
            for o in node.order_by:
                out.append((o.symbol.name, "sort key"))
        elif isinstance(node, P.TopN):
            for o in node.order_by:
                out.append((o.symbol.name, "topn key"))
        elif isinstance(node, P.Window):
            for s in node.partition_by:
                out.append((s.name, "window partition key"))
            for o in node.order_by:
                out.append((o.symbol.name, "window order key"))
            for s, fn in node.functions:
                refs(fn.argument, f"window function '{s.name}' argument")
                refs(fn.default, f"window function '{s.name}' default")
        elif isinstance(node, P.Output):
            for s in node.symbols:
                out.append((s.name, "output column"))
        elif isinstance(node, P.GroupId):
            for s in node.all_keys:
                out.append((s.name, "grouping key"))
            for g in node.groups:
                for s in g:
                    out.append((s.name, "grouping-set key"))
        elif isinstance(node, P.Exchange):
            for s in node.keys:
                out.append((s.name, "exchange hash key"))
        elif isinstance(node, P.Unnest):
            for e in node.array_exprs:
                refs(e, "unnest array expression")
        return out

    def _check_scoped(self, node: P.PlanNode, path: tuple[str, ...]) -> None:
        """Join criteria/filter must split across the correct sides."""
        if isinstance(node, P.Join):
            left = {s.name for s in node.left.output_symbols}
            right = {s.name for s in node.right.output_symbols}
            for a, b in node.criteria:
                if a.name not in left:
                    self.fail(
                        f"join criterion left symbol '{a.name}' not produced "
                        f"by the left side", path,
                    )
                if b.name not in right:
                    self.fail(
                        f"join criterion right symbol '{b.name}' not produced "
                        f"by the right side", path,
                    )
        if isinstance(node, P.SetOp):
            for i, inp in enumerate(node.inputs):
                if len(inp.output_symbols) != len(node.symbols):
                    self.fail(
                        f"set-op input {i} produces {len(inp.output_symbols)} "
                        f"columns, node declares {len(node.symbols)}", path,
                    )


class TypeValidator(Checker):
    """Recompute types bottom-up and diff against declarations.

    Reference: ``sanity/TypeValidator.java``.
    """

    name = "TypeValidator"

    def check(self, root: P.PlanNode) -> None:
        for node, path in _walk(root):
            env = _source_symbols(node)
            for e in _exprs_of(node):
                for sub in _walk_expr(e):
                    if isinstance(sub, Variable) and sub.name in env:
                        if sub.type != env[sub.name]:
                            self.fail(
                                f"variable '{sub.name}' declared {sub.type} "
                                f"but its producer outputs {env[sub.name]}",
                                path,
                            )
            self._check_node(node, env, path)

    def _check_node(self, node: P.PlanNode, env, path) -> None:
        def boolean(e: Optional[RowExpr], what: str) -> None:
            if e is not None and e.type not in (T.BOOLEAN, T.UNKNOWN):
                self.fail(f"{what} has type {e.type}, expected boolean", path)

        if isinstance(node, P.Filter):
            boolean(node.predicate, "filter predicate")
        elif isinstance(node, P.Join):
            boolean(node.filter, "join filter")
            for a, b in node.criteria:
                if T.common_super_type(a.type, b.type) is None:
                    self.fail(
                        f"join criterion ({a.name}, {b.name}) compares "
                        f"incomparable types {a.type} and {b.type}", path,
                    )
        elif isinstance(node, P.Project):
            for s, e in node.assignments:
                if s.type != e.type:
                    self.fail(
                        f"projection '{s.name}' declares {s.type} but its "
                        f"expression evaluates to {e.type}", path,
                    )
        elif isinstance(node, P.Output):
            if len(node.column_names) != len(node.symbols):
                self.fail(
                    f"{len(node.column_names)} column names for "
                    f"{len(node.symbols)} symbols", path,
                )
        elif isinstance(node, P.TableScan):
            if len(node.symbols) != len(node.column_names):
                self.fail(
                    f"{len(node.symbols)} symbols for "
                    f"{len(node.column_names)} connector columns", path,
                )
        elif isinstance(node, P.Values):
            for row in node.rows:
                if len(row) != len(node.symbols):
                    self.fail(
                        f"values row has {len(row)} fields, node declares "
                        f"{len(node.symbols)} symbols", path,
                    )
        elif isinstance(node, P.Sort) or isinstance(node, P.TopN):
            for o in node.order_by:
                if not T.is_orderable(o.symbol.type) and not isinstance(
                    o.symbol.type, T.UnknownType
                ):
                    self.fail(
                        f"sort key '{o.symbol.name}' of type {o.symbol.type} "
                        f"is not orderable", path,
                    )


class NoDuplicatePlanNodesChecker(Checker):
    """No plan-node object may appear at two positions in the tree.

    Reference: ``sanity/NoDuplicatePlanNodeIdsChecker.java``. Our nodes
    carry no ids, so identity stands in: the same object reachable through
    two parents means a rewrite aliased a subtree instead of cloning it
    (``instantiate()``), which breaks per-reference symbol ownership.
    """

    name = "NoDuplicatePlanNodesChecker"

    def check(self, root: P.PlanNode) -> None:
        seen: dict[int, str] = {}
        for node, path in _walk(root):
            key = id(node)
            if key in seen:
                self.fail(
                    f"plan node {type(node).__name__} appears twice "
                    f"(also at {seen[key]}) — a rewrite aliased a subtree "
                    f"instead of cloning it", path,
                )
            seen[key] = _fmt_path(path)


class AggregationChecker(Checker):
    """Aggregation well-formedness (reference:
    ``sanity/ValidateAggregationsWithDefaultValues.java`` and the
    AggregationNode constructor invariants)."""

    name = "AggregationChecker"

    _NUMERIC_ONLY = ("sum", "avg")
    _KNOWN = tuple(AGG_KINDS) + ("array_agg",)

    def check(self, root: P.PlanNode) -> None:
        for node, path in _walk(root):
            if not isinstance(node, P.Aggregate):
                continue
            produced = set(_source_symbols(node))
            for k in node.group_keys:
                if k.name not in produced:
                    self.fail(
                        f"group-by key '{k.name}' not produced by the "
                        f"aggregation source", path,
                    )
            if node.step not in ("single", "partial", "final"):
                self.fail(f"unknown aggregation step '{node.step}'", path)
            for s, fn in node.aggregates:
                if fn.kind not in self._KNOWN:
                    self.fail(
                        f"aggregate '{s.name}' has unknown kind "
                        f"'{fn.kind}' (known: {self._KNOWN})", path,
                    )
                if fn.kind in ("count", "count_star") and fn.result_type != T.BIGINT:
                    self.fail(
                        f"aggregate '{s.name}' ({fn.kind}) must produce "
                        f"bigint, declares {fn.result_type}", path,
                    )
                arg_t = fn.argument.type if fn.argument is not None else None
                if fn.kind in self._NUMERIC_ONLY and arg_t is not None:
                    if not T.is_numeric(arg_t) and not isinstance(arg_t, T.UnknownType):
                        self.fail(
                            f"aggregate '{s.name}' ({fn.kind}) over "
                            f"non-numeric input type {arg_t}", path,
                        )
                if fn.kind in ("min", "max") and arg_t is not None:
                    if not T.is_orderable(arg_t) and not isinstance(
                        arg_t, (T.UnknownType, T.ArrayType, T.MapType, T.RowType)
                    ):
                        self.fail(
                            f"aggregate '{s.name}' ({fn.kind}) over "
                            f"non-orderable input type {arg_t}", path,
                        )
                if fn.filter is not None and fn.filter.type not in (
                    T.BOOLEAN, T.UNKNOWN
                ):
                    self.fail(
                        f"aggregate '{s.name}' filter has type "
                        f"{fn.filter.type}, expected boolean", path,
                    )
            if node.step in ("partial", "final") and node.acc_symbols is not None:
                if len(node.acc_symbols) != len(node.aggregates):
                    self.fail(
                        f"{len(node.acc_symbols)} accumulator pairs for "
                        f"{len(node.aggregates)} aggregates", path,
                    )
                for (s, fn), (v, c) in zip(node.aggregates, node.acc_symbols):
                    if fn.kind in ("count", "count_star") and c is not None:
                        self.fail(
                            f"count accumulator for '{s.name}' must not "
                            f"carry a separate count column", path,
                        )


class Decimal128Checker(Checker):
    """DECIMAL precision/scale invariants for the decimal128 lowerings.

    The engine stores DECIMAL(p<=18) as int64 scaled integers and p>18 as
    (hi, lo) int64 limb pairs (``ops/decimal128.py``); both require
    0 <= scale <= precision <= 38. Arithmetic results must follow the
    reference scale derivation (``DecimalOperators``): add/sub take
    max(s1, s2), multiply takes s1+s2, divide/modulus take max(s1, s2) —
    a rewrite that drops a rescale produces silently shifted values.
    """

    name = "Decimal128Checker"

    def check(self, root: P.PlanNode) -> None:
        for node, path in _walk(root):
            for sym in node.output_symbols:
                self._check_type(sym.type, f"symbol '{sym.name}'", path)
            for e in _exprs_of(node):
                for sub in _walk_expr(e):
                    self._check_type(sub.type, "expression", path)
                    if isinstance(sub, Constant):
                        self._check_constant(sub, path)
                    if isinstance(sub, Call):
                        self._check_arith(sub, path)

    def _check_type(self, t: T.SqlType, what: str, path) -> None:
        if not isinstance(t, T.DecimalType):
            return
        if not (0 <= t.scale <= t.precision <= 38):
            self.fail(
                f"{what} has invalid decimal({t.precision},{t.scale}): "
                f"requires 0 <= scale <= precision <= 38", path,
            )

    def _check_constant(self, c: Constant, path) -> None:
        t = c.type
        if not isinstance(t, T.DecimalType) or c.value is None:
            return
        if not isinstance(c.value, int):
            self.fail(
                f"decimal constant stores {type(c.value).__name__}, "
                f"expected an unscaled int", path,
            )
        elif abs(c.value) >= 10 ** t.precision:
            self.fail(
                f"decimal constant {c.value} exceeds {t.precision} digits "
                f"declared by {t}", path,
            )

    def _check_arith(self, call: Call, path) -> None:
        if call.name not in ("add", "subtract", "multiply", "divide", "modulus"):
            return
        if len(call.args) != 2 or not isinstance(call.type, T.DecimalType):
            return
        scales = []
        for a in call.args:
            if isinstance(a.type, T.DecimalType):
                scales.append(a.type.scale)
            elif T.is_integer(a.type):
                scales.append(0)
            else:
                return  # double/real operands produce double, not decimal
        if call.name == "multiply":
            want = scales[0] + scales[1]
        else:
            want = max(scales)
        if call.type.scale != want:
            self.fail(
                f"decimal {call.name} over scales {scales} must produce "
                f"scale {want}, declares {call.type}", path,
            )


class ExchangeConsistencyChecker(Checker):
    """Exchange/RemoteSource shape rules inside one plan tree."""

    name = "ExchangeConsistencyChecker"

    _PARTITIONINGS = ("hash", "broadcast", "single", "round_robin")

    def check(self, root: P.PlanNode) -> None:
        for node, path in _walk(root):
            if isinstance(node, P.Exchange):
                if node.partitioning not in self._PARTITIONINGS:
                    self.fail(
                        f"unknown exchange partitioning "
                        f"'{node.partitioning}'", path,
                    )
                if node.partitioning == "hash" and not node.keys:
                    self.fail("hash exchange with no hash keys", path)
                if node.partitioning != "hash" and node.keys:
                    self.fail(
                        f"{node.partitioning} exchange must not carry "
                        f"hash keys", path,
                    )
            if isinstance(node, P.RemoteSource):
                if node.exchange_type not in (
                    "hash", "broadcast", "single", "source"
                ):
                    self.fail(
                        f"unknown remote-source exchange type "
                        f"'{node.exchange_type}'", path,
                    )
                if node.exchange_type == "hash" and not node.keys:
                    self.fail("hash remote source with no hash keys", path)


# === fragment-tree validation ===============================================


def _validate_fragment_tree(subplan) -> None:
    """Cross-fragment agreement: RemoteSource ↔ feeding fragment.

    Reference intent: a fragment boundary is a contract — the consumer's
    RemoteSource and the producer's output exchange must agree on exchange
    kind, hash keys, and column list, or rows land on the wrong shard (or
    in the wrong columns) at runtime.
    """
    checker = ExchangeConsistencyChecker()
    fragments = {}
    for frag in subplan.all_fragments():
        if frag.id in fragments:
            raise PlanValidationError(
                checker.name, f"duplicate fragment id {frag.id}"
            )
        fragments[frag.id] = frag
    for frag in subplan.all_fragments():
        for node, path in _walk(frag.root):
            if not isinstance(node, P.RemoteSource):
                continue
            where = (f"Fragment {frag.id}",) + path
            child = fragments.get(node.fragment_id)
            if child is None:
                raise PlanValidationError(
                    checker.name,
                    f"remote source references unknown fragment "
                    f"{node.fragment_id}", _fmt_path(where),
                )
            if child.output_exchange != node.exchange_type:
                raise PlanValidationError(
                    checker.name,
                    f"remote source expects '{node.exchange_type}' rows but "
                    f"fragment {child.id} ships "
                    f"'{child.output_exchange}'", _fmt_path(where),
                )
            want_keys = [s.name for s in node.keys]
            have_keys = [s.name for s in child.output_keys]
            if want_keys != have_keys:
                raise PlanValidationError(
                    checker.name,
                    f"remote source hash keys {want_keys} disagree with "
                    f"fragment {child.id} output keys {have_keys}",
                    _fmt_path(where),
                )
            want_cols = [s.name for s in node.symbols]
            have_cols = [s.name for s in child.root.output_symbols]
            if want_cols != have_cols:
                raise PlanValidationError(
                    checker.name,
                    f"remote source columns {want_cols[:8]} disagree with "
                    f"fragment {child.id} output columns {have_cols[:8]}",
                    _fmt_path(where),
                )


# === entry points ===========================================================


class PlanSanityChecker:
    """The checker battery (reference: ``sanity/PlanSanityChecker.java``)."""

    INTERMEDIATE: tuple[Checker, ...] = (
        ValidateDependenciesChecker(),
        NoDuplicatePlanNodesChecker(),
        TypeValidator(),
        AggregationChecker(),
        Decimal128Checker(),
    )
    FINAL: tuple[Checker, ...] = INTERMEDIATE + (ExchangeConsistencyChecker(),)

    @classmethod
    def _run(cls, checkers, plan: P.PlanNode, stage: str) -> None:
        for checker in checkers:
            try:
                checker.check(plan)
            except PlanValidationError as e:
                if stage and not e.stage:
                    raise PlanValidationError(
                        e.checker, e.message, e.path, stage
                    ) from None
                raise

    @classmethod
    def validate_intermediate(cls, plan: P.PlanNode, stage: str = "") -> None:
        """Run after each optimizer stage (reference:
        validateIntermediatePlan)."""
        cls._run(cls.INTERMEDIATE, plan, stage)

    @classmethod
    def validate_final(cls, plan: P.PlanNode, stage: str = "optimizer") -> None:
        """Run on the fully optimized plan before fragmentation/execution."""
        cls._run(cls.FINAL, plan, stage)

    @classmethod
    def validate_fragments(cls, subplan) -> None:
        """Run on the fragment tree after ``fragment_plan``."""
        _validate_fragment_tree(subplan)
        for frag in subplan.all_fragments():
            cls._run(cls.FINAL, frag.root, f"fragmentation (fragment {frag.id})")

    @classmethod
    def validate_deserialized(cls, fragment) -> None:
        """Worker-side: one fragment straight off the wire
        (``planner/serde.py`` / TaskUpdateRequest). Cross-fragment checks
        need the whole tree, so only node-local checkers run here."""
        cls._run(cls.FINAL, fragment.root, f"deserialization (fragment {fragment.id})")
