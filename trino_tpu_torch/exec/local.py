"""Single-device execution of a logical plan (LocalQueryRunner tier).

Reference: ``core/trino-main/src/main/java/io/trino/testing/LocalQueryRunner.java:631``
— full parse->plan->execute in one process, no RPC. Each plan node is
evaluated to a :class:`Batch` on the executor's device plus a symbol
layout; operator-at-a-time, eagerly.

The subset of ``trino_tpu/exec/local.py`` this engine runs today:
TableScan, Values, Filter, Project (string-valued expressions over a
unified dictionary), Aggregate (single, partial and final steps; DISTINCT
aggregates), Join (INNER, LEFT with or without a non-equi ON
filter, RIGHT as a flipped LEFT, FULL OUTER on equality criteria, SEMI
and ANTI through the sort tier of ``ops/join.py``, with dynamic
filtering; scalar-subquery joins, CROSS joins; DECIMAL(38) keys), Window
(``ops/window.py``), Distinct, SetOp (UNION, INTERSECT and EXCEPT,
DISTINCT or ALL), Sort, TopN, Limit and Output, wide (n, 2)
DECIMAL columns included. String->string functions are lowered onto
dictionary-transformed columns first (``strings.py``). Any other plan
node raises :class:`ExecutionError` naming it; so do FILTER aggregates,
min/max over VARCHAR, floating-point join keys and the spill join.
Gathers stay on the executor's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import (
    Batch,
    Column,
    Dictionary,
    as_tensor,
    bucket_capacity,
    concat_batches,
    torch_dtype,
)
from trino_tpu_torch.compiler import ExprCompiler, div_by_number
from trino_tpu_torch.config import Session
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.ir import Call, Constant, InputRef, RowExpr, SpecialForm, bind_variables
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops.aggregation import (
    AggSpec,
    distinct_first_mask,
    global_aggregate,
    group_aggregate,
)
from trino_tpu_torch.ops.sort import sort_indices
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.strings import lower_string_calls

SCALAR_ROWS_ERROR = "Scalar sub-query has returned multiple rows"


class ExecutionError(Exception):
    pass


def sum_spec_for(fn: P.AggFunction, data) -> AggSpec:
    """Pick the accumulation kind for a sum/avg: exact 128-bit limb
    accumulation when the input is wide (n, 2) storage (``sum128w``) or
    the declared result a wide DECIMAL (``sum128``), the kind itself
    otherwise (reference: UnscaledDecimal128Arithmetic accumulation)."""
    from trino_tpu_torch.ops.decimal128 import is_wide_data

    if fn.kind in ("sum", "avg"):
        if data is not None and is_wide_data(data):
            return AggSpec("sum128w")
        rt = fn.result_type
        if isinstance(rt, T.DecimalType) and rt.wide:
            return AggSpec("sum128")
    return AggSpec(fn.kind)


def _limbs_to_wide(val):
    """Limb sums (n, 3|5) -> wide (n, 2) (hi, lo) values; others as they
    are."""
    if val.ndim == 2 and val.shape[1] in (3, 5):
        from trino_tpu_torch.ops.decimal128 import limb_sums_to_pair

        return torch.stack(limb_sums_to_pair(val), dim=1)
    return val


@dataclasses.dataclass
class Result:
    """A materialized intermediate: batch + symbol layout."""

    batch: Batch
    layout: dict[str, int]  # symbol name -> channel

    def column(self, symbol: P.Symbol) -> Column:
        return self.batch.columns[self.layout[symbol.name]]

    def pair(self, symbol: P.Symbol):
        c = self.column(symbol)
        return c.data, c.valid_mask()

    def opt_pair(self, symbol: P.Symbol):
        """(data, valid-or-None): kernels skip null handling for None."""
        c = self.column(symbol)
        return c.data, c.valid


def agg_inputs_for(node: P.Aggregate, res: Result):
    """Per aggregate: its (data, valid-or-None) input (None for count(*))
    and its accumulation spec. A DISTINCT count/sum/avg keeps the first
    row of each (group keys, value) combination only. FILTER clauses and
    string min/max are not ported yet."""
    agg_inputs, specs = [], []
    for _, fn in node.aggregates:
        if fn.filter is not None:
            raise ExecutionError(
                "FILTER aggregates are not yet ported to trino_tpu_torch"
            )
        if fn.kind == "count_star":
            agg_inputs.append(None)
            specs.append(AggSpec("count_star"))
            continue
        c = res.column(P.Symbol(fn.argument.name, fn.argument.type))
        if c.dictionary is not None and fn.kind != "count":
            raise ExecutionError(
                f"{fn.kind} over VARCHAR is not yet ported to trino_tpu_torch"
            )
        valid = c.valid
        if fn.distinct and fn.kind in ("count", "sum", "avg"):
            sel = res.batch.selection_mask()
            vmask = c.valid_mask()
            keys = [res.pair(k) for k in node.group_keys]
            valid = vmask & distinct_first_mask(keys, (c.data, vmask), sel & vmask)
        agg_inputs.append((c.data, valid))
        specs.append(sum_spec_for(fn, c.data))
    return agg_inputs, specs


def finalize_aggs(node: P.Aggregate, results) -> list[Column]:
    """Per aggregate, its output column from (value, count) results: avg
    division (DECIMAL averages round half up, wide ones through
    ``div128_round``), NULL on an empty group, limb sums resolved into
    wide (hi, lo) values."""
    from trino_tpu_torch.ops import decimal128 as D128

    cols = []
    for (_, fn), raw in zip(node.aggregates, results):
        t = fn.result_type
        dt = torch_dtype(t.storage_dtype)
        if fn.kind in ("count", "count_star"):
            cols.append(Column(t, raw.reshape(-1).to(torch.int64)))
            continue
        ssum, cnt = raw
        cnt = cnt.reshape(-1)
        valid = cnt > 0
        ssum = _limbs_to_wide(ssum)
        if ssum.ndim == 2:
            if fn.kind == "avg":
                qhi, qlo, _ = D128.div128_round(
                    ssum[:, 0], ssum[:, 1],
                    *D128.widen_i64(torch.clamp(cnt, min=1)), 0,
                )
                wide_t = isinstance(t, T.DecimalType) and t.wide
                data = torch.stack([qhi, qlo], dim=1) if wide_t else qlo.to(dt)
            else:  # sum, or a wide min/max passing through
                data = ssum
            cols.append(Column(t, data, valid))
            continue
        ssum = ssum.reshape(-1)
        if fn.kind == "avg":
            safe = torch.clamp(cnt, min=1)
            if isinstance(t, T.DecimalType):
                # round half up at result scale
                data = torch.where(
                    ssum >= 0,
                    torch.div(ssum + safe // 2, safe, rounding_mode="floor"),
                    -torch.div(-ssum + safe // 2, safe, rounding_mode="floor"),
                )
            else:
                data = ssum.to(torch.float64) / safe.to(torch.float64)
        else:
            data = ssum
        cols.append(Column(t, data.to(dt), valid))
    return cols


def _not_ported(what: str) -> ExecutionError:
    return ExecutionError(f"{what} is not yet ported to trino_tpu_torch")


def check_join_ported(node: P.Join) -> None:
    """Raise for the join shapes this engine does not run yet; a FULL
    join with a non-equi ON filter raises as in the reference."""
    if node.join_type not in ("INNER", "LEFT", "FULL", "CROSS"):
        raise _not_ported(f"{node.join_type} JOIN")
    if node.join_type != "CROSS" and not node.criteria:
        raise _not_ported("a join without equality criteria")
    if node.join_type == "FULL" and node.filter is not None:
        raise ExecutionError("FULL OUTER JOIN with a non-equi ON filter")


def append_unmatched_build(node: P.Join, out: Result, right: Result,
                           unmatched: torch.Tensor) -> Result:
    """A FULL join's output: the probe's rows, then every build row in
    ``unmatched`` (a mask over the build capacity) with NULL probe
    columns, the way ``LookupJoinOperator`` replays unvisited build
    positions (``LookupJoinOperator.java:71``). Fixed shapes: the build
    rows are appended whole and ``unmatched`` selects them."""
    n_left = len(node.left.output_symbols)
    add_n = right.batch.capacity
    cols = []
    for j, c in enumerate(out.batch.columns):
        if j < n_left:  # probe columns: NULL
            add = c.data.new_zeros((add_n,) + tuple(c.data.shape[1:]))
            addv = torch.zeros(add_n, dtype=torch.bool, device=c.data.device)
        else:  # build columns: the build rows themselves
            rc = right.column(node.right.output_symbols[j - n_left])
            add, addv = rc.data.to(c.data.dtype), rc.valid_mask()
        cols.append(Column(
            c.type, torch.cat([c.data, add]),
            torch.cat([c.valid_mask(), addv]), c.dictionary,
        ))
    keep = torch.cat([out.batch.selection_mask(), unmatched])
    return Result(Batch(cols, keep.shape[0], keep), out.layout)


def bound_filter_mask(expr: RowExpr, columns: list[Column], device) -> torch.Tensor:
    """A bound predicate's mask over ``columns``, string calls lowered
    first (the lowering appends columns to a copy)."""
    work = list(columns)
    expr = lower_string_calls(expr, work)
    return ExprCompiler(work, device=device).predicate_mask(expr)


def unify_strings(expr: RowExpr, columns: list[Column]):
    """A unified dictionary over every string column and literal that
    ``expr`` references: returns (the columns with those string columns
    remapped into it, the dictionary). Reference:
    ``trino_tpu/exec/local.py::_unify_strings``."""
    channels: list[int] = []
    literals: list[str] = []

    def walk(e: RowExpr):
        if isinstance(e, InputRef) and T.is_string(e.type):
            channels.append(e.channel)
        elif isinstance(e, Constant) and T.is_string(e.type) and e.value is not None:
            literals.append(str(e.value))
        elif isinstance(e, (Call, SpecialForm)):
            for a in e.args:
                walk(a)

    walk(expr)
    union = Dictionary([])
    remaps = {}
    for ch in dict.fromkeys(channels):
        union, remaps[ch] = union.merged(columns[ch].dictionary or Dictionary([]))
    if literals:
        union, _ = union.merged(Dictionary(list(dict.fromkeys(literals))))
    new_cols = list(columns)
    for ch, remap in remaps.items():
        c = new_cols[ch]
        r = as_tensor(remap, c.data.device)
        codes = torch.where(c.data >= 0, r[c.data.clamp(min=0).long()], -1)
        new_cols[ch] = Column(c.type, codes.to(torch.int32), c.valid, union)
    return new_cols, union


def flipped_right_join(node: P.Join) -> P.Join:
    """RIGHT JOIN as the LEFT JOIN with the sides swapped (the Output
    node fixes the column order)."""
    return P.Join(
        "LEFT", node.right, node.left, [(b, a) for a, b in node.criteria],
        node.filter,
    )


def join_output(node: P.Join, left: Result, right: Result, out_cols,
                out_capacity: int, out_sel) -> Result:
    """Join output batch: probe columns, then build columns, from the flat
    (data, valid) list ``out_cols``."""
    cols: list[Column] = []
    layout: dict[str, int] = {}
    i = 0
    for side_node, side in ((node.left, left), (node.right, right)):
        for s in side_node.output_symbols:
            d = side.column(s).dictionary
            cols.append(Column(s.type, out_cols[i], out_cols[i + 1], d))
            layout[s.name] = len(cols) - 1
            i += 2
    return Result(Batch(cols, out_capacity, out_sel), layout)


def mark_column(node: P.Join, left: Result, matched, lkeys, bv, bsel):
    """The SEMI/ANTI mark over the probe rows, with three-valued IN:
    matched -> TRUE/FALSE; empty build -> FALSE/TRUE; otherwise a NULL
    probe key, or no match while the build has a NULL key, is NULL.
    EXISTS (not null-aware) is strictly TRUE/FALSE."""
    cap = left.batch.capacity
    valid = torch.ones(cap, dtype=torch.bool, device=matched.device)
    if node.null_aware:
        pv = valid
        for _, kv in lkeys:
            pv = pv & kv
        any_null_build = ((~bv) & bsel).any()
        valid = torch.where(bsel.any(), matched | (pv & ~any_null_build), valid)
    value = matched if node.join_type == "SEMI" else ~matched
    return Column(T.BOOLEAN, value, valid)


def with_mark(node: P.Join, left: Result, mark: Column) -> Result:
    cols = list(left.batch.columns) + [mark]
    layout = dict(left.layout)
    layout[node.mark_symbol.name] = len(cols) - 1
    return Result(
        Batch(cols, left.batch.num_rows, left.batch.sel, left.batch.device),
        layout,
    )


class LocalExecutor:
    def __init__(self, catalogs: CatalogManager, session: Session, device):
        self.catalogs = catalogs
        self.session = session
        self.device = torch.device(device)
        # dynamic filters collected while executing (dynfilter.py)
        self.dynamic_filters: list = []

    # === entry ==========================================================
    def execute(self, node: P.PlanNode) -> tuple[Batch, list[str]]:
        if isinstance(node, P.Output):
            res = self._exec(node.source)
            cols = [res.column(s) for s in node.symbols]
            out = Batch(
                cols, res.batch.num_rows, res.batch.sel, res.batch.device
            ).compact()
            return out, node.column_names
        res = self._exec(node)
        return res.batch.compact(), [s.name for s in node.output_symbols]

    # === dispatch =======================================================
    def _exec(self, node: P.PlanNode) -> Result:
        method = getattr(self, f"_exec_{type(node).__name__.lower()}", None)
        if method is None:
            raise ExecutionError(
                f"plan node {type(node).__name__} is not yet ported to trino_tpu_torch"
            )
        return method(node)

    def _bind(self, expr: RowExpr, layout: dict[str, int]) -> RowExpr:
        return bind_variables(expr, layout)

    @staticmethod
    def _nonempty(res: Result) -> Result:
        """Kernels reject 0-capacity arrays; represent an empty relation as
        one unselected padding row."""
        b = res.batch
        if b.capacity > 0:
            return res
        cols = [
            Column(
                c.type, c.data.new_zeros((1,) + tuple(c.data.shape[1:])),
                torch.zeros(1, dtype=torch.bool, device=c.data.device),
                c.dictionary,
            )
            for c in b.columns
        ]
        sel = torch.zeros(1, dtype=torch.bool, device=b.device)
        return Result(Batch(cols, 1, sel), res.layout)

    # === leaf nodes =====================================================
    def _scan_splits(self, node: P.TableScan):
        return self.catalogs.get(node.catalog).get_splits_with_hints(
            node.schema, node.table, 64, node.constraint,
            limit=node.limit, topn=node.topn,
        )

    def _exec_tablescan(self, node: P.TableScan, splits=None) -> Result:
        connector = self.catalogs.get(node.catalog)
        if splits is None:
            splits = self._scan_splits(node)
        layout = {s.name: i for i, s in enumerate(node.symbols)}
        batches = []
        rows_read = 0
        for s in splits:
            b = connector.read_split(node.schema, node.table, node.column_names, s)
            batches.append(b)
            rows_read += b.num_rows
            # connector applyLimit hint: stop pulling splits once the
            # pushed row budget is covered (the Limit node still enforces)
            if node.limit is not None and rows_read >= node.limit:
                break
        if not batches:
            batches = [
                connector.read_split(
                    node.schema, node.table, node.column_names,
                    connector.get_splits(node.schema, node.table, 1)[0],
                )
            ]
        batch = concat_batches(batches) if len(batches) > 1 else batches[0]
        return Result(batch.to(self.device), layout)

    # === row-preserving nodes ==========================================
    def _exec_filter(self, node: P.Filter) -> Result:
        res = self._exec(node.source)
        expr = self._bind(node.predicate, res.layout)
        mask = bound_filter_mask(expr, res.batch.columns, self.device)
        sel = mask if res.batch.sel is None else (mask & res.batch.sel)
        return Result(
            Batch(res.batch.columns, res.batch.num_rows, sel, res.batch.device),
            res.layout,
        )

    def _exec_project(self, node: P.Project) -> Result:
        res = self._exec(node.source)
        work_cols = list(res.batch.columns)
        cols: list[Column] = []
        n = res.batch.capacity
        for sym, expr in node.assignments:
            bound = lower_string_calls(self._bind(expr, res.layout), work_cols)
            if isinstance(bound, InputRef):
                cols.append(work_cols[bound.channel])
                continue
            if isinstance(sym.type, (T.ArrayType, T.MapType, T.RowType)):
                raise ExecutionError(
                    f"computed {sym.type.name} expressions are not yet "
                    "ported to trino_tpu_torch"
                )
            if T.is_string(sym.type):
                if isinstance(bound, Constant):
                    if bound.value is None:
                        codes = torch.full((n,), -1, dtype=torch.int32, device=self.device)
                        valid = torch.zeros(n, dtype=torch.bool, device=self.device)
                        cols.append(Column(sym.type, codes, valid, Dictionary([])))
                    else:
                        codes = torch.zeros(n, dtype=torch.int32, device=self.device)
                        cols.append(
                            Column(sym.type, codes, None, Dictionary([str(bound.value)]))
                        )
                    continue
                # a string-valued expression (CASE, COALESCE, ...): codes in
                # a dictionary unified over what it references
                new_cols, union = unify_strings(bound, work_cols)
                data, valid = ExprCompiler(
                    new_cols, device=self.device, string_dictionary=union
                ).evaluate(bound)
                cols.append(Column(sym.type, data.to(torch.int32), valid, union))
                continue
            data, valid = ExprCompiler(work_cols, device=self.device).evaluate(bound)
            cols.append(
                Column(sym.type, data.to(torch_dtype(sym.type.storage_dtype)), valid)
            )
        layout = {s.name: i for i, (s, _) in enumerate(node.assignments)}
        return Result(
            Batch(cols, res.batch.num_rows, res.batch.sel, res.batch.device),
            layout,
        )

    def _exec_limit(self, node: P.Limit) -> Result:
        res = self._exec(node.source)
        idx = torch.nonzero(res.batch.selection_mask()).reshape(-1)
        lo = min(node.offset, idx.shape[0])
        hi = idx.shape[0] if node.count is None else min(idx.shape[0], lo + node.count)
        return Result(res.batch.take(idx[lo:hi]), res.layout)

    # === sorting ========================================================
    def _sort_operands(self, res: Result, order_by):
        key_pairs, keys, ranks = [], [], []
        for o in order_by:
            c = res.column(o.symbol)
            key_pairs.append((c.data, c.valid_mask()))
            keys.append(o.sort_key())
            ranks.append(c.dictionary.ranks() if c.dictionary is not None else None)
        return key_pairs, keys, ranks

    def _sorted_result(self, res: Result, order_by, keep) -> Result:
        """The selected rows in ORDER BY order, the first ``keep`` of them
        when given."""
        sel = res.batch.selection_mask()
        key_pairs, keys, ranks = self._sort_operands(res, order_by)
        perm = sort_indices(key_pairs, keys, sel, ranks)
        n_valid = int(sel.sum())
        take = n_valid if keep is None else min(keep, n_valid)
        return Result(res.batch.take(perm[:take]), res.layout)

    def _exec_sort(self, node: P.Sort) -> Result:
        return self._sorted_result(self._exec(node.source), node.order_by, None)

    def _exec_topn(self, node: P.TopN) -> Result:
        return self._sorted_result(self._exec(node.source), node.order_by, node.count)

    # === joins ==========================================================
    def _exec_join(self, node: P.Join) -> Result:
        if node.join_type in ("SEMI", "ANTI"):
            return self._exec_semi_join(node)
        if node.join_type == "RIGHT":
            return self._exec_join(flipped_right_join(node))
        check_join_ported(node)
        if node.join_type == "CROSS":
            return self._exec_cross_join(node)
        right = self._exec(node.right)  # build first: enables dynamic filter
        left = self._exec(self._apply_dynamic_filters(node, right))  # probe
        if (
            node.join_type != "FULL"  # the reference's FULL join never spills
            and self.session.get("spill_enabled")
            and left.batch.count_rows() + right.batch.count_rows()
            > int(self.session.get("spill_threshold_rows"))
        ):
            raise _not_ported("the partitioned (spill) join")
        return self._join_result(node, left, right)

    def _apply_dynamic_filters(self, node: P.Join, build: Result) -> P.PlanNode:
        """Collect build-side key domains and push them into the probe plan
        (reference: DynamicFilterSourceOperator -> DynamicFilterService ->
        probe scans; here synchronous since the build is materialized)."""
        from trino_tpu_torch.dynfilter import collect_and_push

        left_plan = node.left
        if node.join_type != "INNER" or not self.session.get(
            "enable_dynamic_filtering"
        ):
            return left_plan
        sel = build.batch.selection_mask()
        build_rows = int(sel.sum())
        if build_rows > int(self.session.get("dynamic_filtering_max_build_rows")):
            return left_plan
        for lsym, rsym in node.criteria:
            col = build.column(rsym)
            left_plan = collect_and_push(
                left_plan, lsym, rsym, col.data.cpu().numpy(),
                (col.valid_mask() & sel).cpu().numpy(), build_rows,
                self.dynamic_filters,
            )
        return left_plan

    def _probe_sorted(self, lkeys, rkeys, left: Result, right: Result,
                      join_type: str, est: int):
        """Sort-tier probe into ``bucket_capacity(est)`` output slots, grown
        until no match drops; returns (probe_pos, build_pos, out_sel,
        out_capacity) after the exactness pass."""
        bh, bv = J.hash_keys(rkeys)
        ph, pv = J.hash_keys(lkeys)
        sbk, sbi, bcount = J.build_side(bh, bv, right.batch.selection_mask())
        probe_sel = left.batch.selection_mask()
        out_capacity = bucket_capacity(est)
        while True:
            ppos, bpos, osel, total, ovf = J.probe_join(
                sbk, sbi, bcount, ph, pv, probe_sel, out_capacity, join_type
            )
            if not bool(ovf):
                break
            out_capacity = bucket_capacity(int(total))
        osel = J.verify_equal(lkeys, rkeys, ppos, bpos, osel)
        return ppos, bpos, osel, out_capacity

    def _join_result(self, node: P.Join, left: Result, right: Result) -> Result:
        left = self._nonempty(left)
        right = self._nonempty(right)
        lkeys, rkeys = self._join_keys(left, right, node.criteria)
        est = max(1024, 2 * left.batch.count_rows(), right.batch.count_rows())
        ppos, bpos, osel, out_capacity = self._probe_sorted(
            lkeys, rkeys, left, right,
            "left" if node.join_type in ("LEFT", "FULL") else "inner", est,
        )
        is_outer = bpos == J.MISSING
        pidx = ppos.long()
        if node.single_row:
            # a scalar subquery: each probe row may match one row at most
            # (reference: EnforceSingleRowNode)
            hits = torch.bincount(pidx[osel & ~is_outer], minlength=1)
            if int(hits.max()) > 1:
                raise ExecutionError(SCALAR_ROWS_ERROR)
        bidx = torch.where(is_outer, 0, bpos).long()
        out_cols = []
        for s in node.left.output_symbols:
            c = left.column(s)
            out_cols += [c.data[pidx], c.valid_mask()[pidx]]
        for s in node.right.output_symbols:
            c = right.column(s)
            out_cols += [c.data[bidx], c.valid_mask()[bidx] & ~is_outer]
        out = join_output(node, left, right, out_cols, out_capacity, osel)
        if node.join_type == "FULL":
            bcap = right.batch.capacity
            matched = torch.zeros(bcap + 1, dtype=torch.bool, device=osel.device)
            matched[torch.where(osel & ~is_outer, bidx, bcap)] = True
            unmatched = right.batch.selection_mask() & ~matched[:bcap]
            return append_unmatched_build(node, out, right, unmatched)
        if node.filter is None:
            return out
        expr = self._bind(node.filter, out.layout)
        mask = bound_filter_mask(expr, out.batch.columns, self.device)
        if node.join_type != "LEFT":
            return Result(
                Batch(out.batch.columns, out_capacity, mask & osel), out.layout
            )
        return self._left_filtered(node, left, out, mask, osel, is_outer, pidx)

    def _left_filtered(self, node, left, out, mask, osel, is_outer, pidx) -> Result:
        """A LEFT JOIN's ON filter applies to the matches, not to the
        probe rows: a probe row whose matches all fail it appears once,
        null-extended (the probe padded only rows with no raw match)."""
        sel = mask & osel
        keep = sel | (osel & is_outer)
        probe_n = left.batch.capacity
        raw = torch.zeros(probe_n + 1, dtype=torch.bool, device=mask.device)
        raw[torch.where(osel & ~is_outer, pidx, probe_n)] = True
        kept = torch.zeros(probe_n + 1, dtype=torch.bool, device=mask.device)
        kept[torch.where(sel & ~is_outer, pidx, probe_n)] = True
        need_outer = torch.nonzero(raw[:probe_n] & ~kept[:probe_n]).reshape(-1)
        cols = out.batch.columns
        if need_outer.numel():
            n_left = len(node.left.output_symbols)
            grown = []
            for j, c in enumerate(cols):
                if j < n_left:  # probe columns: the rows themselves
                    lc = left.column(node.left.output_symbols[j])
                    add, addv = lc.data[need_outer], lc.valid_mask()[need_outer]
                else:  # build columns: NULL
                    add = c.data.new_zeros((need_outer.numel(),) + tuple(c.data.shape[1:]))
                    addv = torch.zeros(need_outer.numel(), dtype=torch.bool, device=c.data.device)
                grown.append(Column(
                    c.type, torch.cat([c.data, add]),
                    torch.cat([c.valid_mask(), addv]), c.dictionary,
                ))
            cols = grown
            keep = torch.cat([keep, torch.ones_like(need_outer, dtype=torch.bool)])
        return Result(Batch(cols, keep.shape[0], keep), out.layout)

    def _join_keys(self, left: Result, right: Result, criteria):
        """Per criterion, int64 (data, valid) key pairs for both sides:
        dictionary codes remapped to one dictionary, DECIMAL scales
        aligned, DECIMAL(38) keys as two lanes (hi, lo)."""
        from trino_tpu_torch.ops import decimal128 as D128

        lkeys, rkeys = [], []
        for ls, rs in criteria:
            lc = left.column(ls)
            rc = right.column(rs)
            if isinstance(ls.type, (T.DoubleType, T.RealType)) or isinstance(
                rs.type, (T.DoubleType, T.RealType)
            ):
                raise _not_ported("a join on floating-point keys")
            ls_scale = ls.type.scale if isinstance(ls.type, T.DecimalType) else 0
            rs_scale = rs.type.scale if isinstance(rs.type, T.DecimalType) else 0
            lv, rv = lc.valid_mask(), rc.valid_mask()
            if lc.data.ndim == 2 or rc.data.ndim == 2:
                sc = max(ls_scale, rs_scale)

                def lanes(col, scale):
                    if col.data.ndim == 2:
                        hi, lo = col.data[:, 0], col.data[:, 1]
                    else:
                        hi, lo = D128.widen_i64(col.data.to(torch.int64))
                    if sc > scale:
                        hi, lo = D128.rescale_up_wide(hi, lo, sc - scale)
                    return hi, lo

                lhi, llo = lanes(lc, ls_scale)
                rhi, rlo = lanes(rc, rs_scale)
                lkeys += [(lhi, lv), (llo, lv)]
                rkeys += [(rhi, rv), (rlo, rv)]
                continue
            ld, rd = lc.data, rc.data
            if lc.dictionary is not None or rc.dictionary is not None:
                if lc.dictionary is not rc.dictionary:
                    _, remap = lc.dictionary.merged(rc.dictionary)
                    remap_t = torch.from_numpy(remap).to(rd.device)
                    rd = torch.where(
                        rd >= 0, remap_t[torch.clamp(rd, min=0).long()], -1
                    )
            ld, rd = ld.to(torch.int64), rd.to(torch.int64)
            if ls_scale != rs_scale:
                # align scales: equal values must compare equal
                sc = max(ls_scale, rs_scale)
                ld = ld * (10 ** (sc - ls_scale))
                rd = rd * (10 ** (sc - rs_scale))
            lkeys.append((ld, lv))
            rkeys.append((rd, rv))
        return lkeys, rkeys

    def _exec_semi_join(self, node: P.Join) -> Result:
        left = self._nonempty(self._exec(node.left))
        right = self._nonempty(self._exec(node.right))
        cap = left.batch.capacity
        if not node.criteria:
            if node.filter is not None:
                raise _not_ported("a correlated EXISTS without equality criteria")
            # uncorrelated EXISTS: is the build side non-empty?
            nonempty = right.batch.selection_mask().any()
            mark = nonempty if node.join_type == "SEMI" else ~nonempty
            return with_mark(node, left, Column(T.BOOLEAN, mark.expand(cap).clone()))
        lkeys, rkeys = self._join_keys(left, right, node.criteria)
        ppos, bpos, osel, _ = self._probe_sorted(
            lkeys, rkeys, left, right, "inner",
            max(1024, 2 * left.batch.count_rows()),
        )
        pidx = ppos.long()
        if node.filter is not None:
            # residual correlated condition over (probe row, build row)
            # pairs: drop the matches that fail it
            bidx = torch.where(bpos == J.MISSING, 0, bpos).long()
            fcols: list[Column] = []
            flayout: dict[str, int] = {}
            for side_node, side, idx in (
                (node.left, left, pidx), (node.right, right, bidx)
            ):
                for s in side_node.output_symbols:
                    fcols.append(side.column(s).take(idx))
                    flayout[s.name] = len(fcols) - 1
            fexpr = self._bind(node.filter, flayout)
            osel = osel & bound_filter_mask(fexpr, fcols, self.device)
        matched = torch.zeros(cap + 1, dtype=torch.bool, device=osel.device)
        matched[torch.where(osel, pidx, cap)] = True
        _, bv = J.hash_keys(rkeys)
        mark = mark_column(
            node, left, matched[:cap], lkeys, bv, right.batch.selection_mask()
        )
        return with_mark(node, left, mark)

    def _exec_cross_join(self, node: P.Join) -> Result:
        """Every probe row with every build row. A scalar subquery
        (``single_row``) raises on more than one build row and gives one
        all-NULL row for none (reference: EnforceSingleRowNode)."""
        left = self._exec(node.left)
        right = self._exec(node.right)
        lb = left.batch.compact().to(self.device)
        rb = right.batch.compact().to(self.device)
        nl, nr = lb.num_rows, rb.num_rows
        if node.single_row and nr > 1:
            raise ExecutionError(SCALAR_ROWS_ERROR)
        if node.single_row and nr == 0:
            rb = Batch(
                [
                    Column(
                        c.type, c.data.new_zeros((1,) + tuple(c.data.shape[1:])),
                        torch.zeros(1, dtype=torch.bool, device=self.device),
                        c.dictionary,
                    )
                    for c in rb.columns
                ],
                1,
            )
            nr = 1
        if nl * nr > (1 << 24):
            raise ExecutionError("cross join too large")
        li = torch.arange(nl, device=self.device).repeat_interleave(nr)
        ri = torch.arange(nr, device=self.device).repeat(nl)
        cols: list[Column] = []
        layout: dict[str, int] = {}
        for side_node, side, b, idx in (
            (node.left, left, lb, li), (node.right, right, rb, ri)
        ):
            for s in side_node.output_symbols:
                c = b.columns[side.layout[s.name]]
                valid = c.valid_mask()[idx]
                cols.append(Column(
                    c.type, c.data[idx], None if bool(valid.all()) else valid,
                    c.dictionary,
                ))
                layout[s.name] = len(cols) - 1
        return Result(Batch(cols, nl * nr), layout)

    # === values, windows, distinct and set operations ===================
    def _exec_values(self, node: P.Values) -> Result:
        n = len(node.rows)
        cols = []
        for j, sym in enumerate(node.symbols):
            t = sym.type
            vals = [row[j] for row in node.rows]
            valid = torch.tensor([v is not None for v in vals], dtype=torch.bool)
            if T.is_string(t):
                d, codes = Dictionary([]), torch.zeros(0, dtype=torch.int32)
                if n:
                    d, codes = Dictionary.from_strings(
                        [v if v is not None else "" for v in vals]
                    )
                data = torch.where(valid, as_tensor(codes), -1).to(torch.int32)
            else:
                data = torch.tensor(
                    [v if v is not None else 0 for v in vals],
                    dtype=torch_dtype(t.storage_dtype),
                )
            cols.append(Column(
                t, data.to(self.device),
                None if bool(valid.all()) else valid.to(self.device),
                d if T.is_string(t) else None,
            ))
        return Result(
            Batch(cols, n, None, self.device),
            {s.name: i for i, s in enumerate(node.symbols)},
        )

    def _exec_window(self, node: P.Window) -> Result:
        """Window functions over one (partition, order, frame) spec
        (reference: ``_exec_window``/``_window_result``). The reference's
        spill path for large partitioned inputs computes the same values
        per hash partition; here the input is computed whole."""
        from trino_tpu_torch.compiler import _narrow_checked
        from trino_tpu_torch.ops.window import WindowFn, WindowSpecKernel, compute_windows

        res = self._exec(node.source)
        b = res.batch
        sel = b.selection_mask()
        part_pairs, part_ranks = [], []
        for s in node.partition_by:
            c = res.column(s)
            part_pairs.append((c.data, c.valid_mask()))
            part_ranks.append(c.dictionary.ranks() if c.dictionary else None)
        order_pairs, order_specs, order_ranks = [], [], []
        for o in node.order_by:
            c = res.column(o.symbol)
            order_pairs.append((c.data, c.valid_mask()))
            order_specs.append(o.sort_key())
            order_ranks.append(c.dictionary.ranks() if c.dictionary else None)

        # frame selection (SQL defaults; ranking functions ignore it)
        preceding = 0
        if not node.order_by:
            kframe = "partition"
        elif node.frame is None:
            kframe = "running_range"
        else:
            ftype, fstart, fend = node.frame
            if fend == "UNBOUNDED FOLLOWING":
                kframe = "partition"
            elif (ftype == "ROWS" and fstart.endswith(" PRECEDING")
                  and fstart.split()[0].isdigit()):
                kframe = "rows_preceding"
                preceding = int(fstart.split()[0])
            elif ftype == "ROWS":
                kframe = "running_rows"
            else:
                kframe = "running_range"

        fns, args, defaults, out_dicts, minmax_dicts = [], [], [], [], []
        n = b.capacity
        for _, wf in node.functions:
            fns.append(WindowFn(wf.kind, wf.offset, wf.default is not None))
            out_dict = mm_dict = None
            if wf.argument is None:
                args.append(None)
                defaults.append(None)
            else:
                c = res.column(P.Symbol(wf.argument.name, wf.argument.type))
                data, valid = c.data, c.valid_mask()
                if data.ndim == 2:
                    # window scans run in int64 lanes: narrow at run time
                    # (raises if a wide value exceeds 18 digits)
                    data = _narrow_checked(data, "window over DECIMAL(38)")
                if c.dictionary is not None and wf.kind in ("min", "max"):
                    data = rank_codes(c.dictionary, data)
                    mm_dict = c.dictionary
                elif c.dictionary is not None:
                    out_dict = c.dictionary
                args.append((data, valid))
                d = None
                if wf.default is not None:
                    if isinstance(wf.default, Constant):
                        if wf.default.value is None:
                            d = (torch.zeros_like(data), torch.zeros(n, dtype=torch.bool, device=data.device))
                        else:
                            value = wf.default.value
                            if out_dict is not None:
                                code = out_dict.encode(str(value))
                                if code < 0:
                                    out_dict = Dictionary(out_dict.values + [str(value)])
                                    code = len(out_dict.values) - 1
                                value = code
                            d = (torch.full_like(data, value), torch.ones(n, dtype=torch.bool, device=data.device))
                    else:
                        dc = res.column(P.Symbol(wf.default.name, wf.default.type))
                        d = (dc.data, dc.valid_mask())
                defaults.append(d)
            out_dicts.append(out_dict)
            minmax_dicts.append(mm_dict)

        results = compute_windows(
            part_pairs, part_ranks, order_pairs, order_specs, order_ranks,
            sel, fns, args, defaults, WindowSpecKernel(kframe, preceding),
        )
        cols = list(b.columns)
        layout = dict(res.layout)
        for (sym, _), (data, valid), odict, mmdict in zip(
            node.functions, results, out_dicts, minmax_dicts
        ):
            if mmdict is not None:  # min/max over strings: ranks back to codes
                order = as_tensor(
                    np.argsort(mmdict.ranks(), kind="stable"), data.device
                )
                codes = order[torch.clamp(data, 0, max(len(order) - 1, 0)).long()]
                col = Column(sym.type, codes.to(torch.int32), valid, mmdict)
            elif odict is not None:
                col = Column(sym.type, data.to(torch.int32), valid, odict)
            else:
                col = Column(sym.type, data.to(torch_dtype(sym.type.storage_dtype)), valid)
            cols.append(col)
            layout[sym.name] = len(cols) - 1
        return Result(Batch(cols, b.num_rows, b.sel, b.device), layout)

    def _exec_distinct(self, node: P.Distinct) -> Result:
        return self._distinct(self._exec(node.source), node.output_symbols)

    def _distinct(self, res: Result, syms) -> Result:
        """The distinct rows of ``syms`` (NULLs equal), through the
        grouping sort of ``group_aggregate`` with no aggregates."""
        res = self._nonempty(res)
        keys = [res.pair(s) for s in syms]
        sel = res.batch.selection_mask()
        max_groups = max(1 << 12, bucket_capacity(res.batch.capacity))
        (kd, kv), _, ng, overflow = group_aggregate(keys, sel, [], [], max_groups)
        if bool(overflow):
            raise ExecutionError("distinct cardinality exceeded capacity")
        ng = int(ng)
        cols = []
        for i, s in enumerate(syms):
            valid = kv[i][:ng]
            cols.append(Column(
                s.type, kd[i][:ng].to(res.column(s).data.dtype),
                None if bool(valid.all()) else valid, res.column(s).dictionary,
            ))
        return Result(
            Batch(cols, ng, None, self.device), {s.name: i for i, s in enumerate(syms)}
        )

    def _exec_setop(self, node: P.SetOp) -> Result:
        """UNION [ALL], INTERSECT [ALL] and EXCEPT [ALL]: every input's
        columns in the set operation's symbol order, coerced to its
        output types; string columns share one dictionary."""
        parts = []
        for inp in node.inputs:
            r = self._exec(inp)
            b = compact_on_device(r.batch)
            cols = [
                cast_column(b.columns[r.layout[s.name]], out.type)
                for s, out in zip(inp.output_symbols, node.symbols)
            ]
            parts.append(Batch(cols, b.num_rows, None, b.device))
        layout = {s.name: i for i, s in enumerate(node.symbols)}
        if node.op == "UNION":
            res = Result(concat_on_device(parts), layout)
            return self._distinct(res, node.symbols) if node.distinct else res
        if node.op in ("INTERSECT", "EXCEPT"):
            return self._exec_setop_membership(node, parts)
        raise _not_ported(f"set operation {node.op}")

    def _exec_setop_membership(self, node: P.SetOp, parts: list[Batch]) -> Result:
        """INTERSECT / EXCEPT over the first two inputs, NULLs equal. One
        grouping sort over both inputs' rows (the left's first, so a
        group's left rows lead it in their own order) gives each left
        row its group and its rank among the group's left rows.
        DISTINCT keeps a group's first left row when the right has
        [none of] the group; ALL keeps the first min(l, r) left rows
        (INTERSECT) or all but the first r (EXCEPT). Survivors keep the
        left's row order, as the reference's host loop gives them."""
        from trino_tpu_torch.ops import keypack as KP

        both = concat_on_device(parts[:2], keep_empty=True)
        nl = parts[0].num_rows
        n = both.num_rows
        dev = both.device
        keys = [(c.data, c.valid_mask()) for c in both.columns]
        sel = torch.ones(n, dtype=torch.bool, device=dev)
        s_lanes, perm, _ = KP.grouping_sort(keys, sel)
        first = torch.zeros(n, dtype=torch.bool, device=dev)
        if n:
            first[0] = True
        for lane in s_lanes:
            first[1:] |= lane[1:] != lane[:-1]
        gid_sorted = torch.cumsum(first.to(torch.int64), 0) - 1
        is_right = perm >= nl
        r_count = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        r_count.index_add_(0, gid_sorted, is_right.to(torch.int64))
        pos = torch.arange(n, dtype=torch.int64, device=dev)
        rank = pos - _last_flag(first, pos)
        r_in_group = r_count[gid_sorted]
        if node.distinct:
            keep = first & (r_in_group > 0 if node.op == "INTERSECT" else r_in_group == 0)
        elif node.op == "INTERSECT":
            keep = rank < r_in_group
        else:
            keep = rank >= r_in_group
        keep &= ~is_right
        left_keep = torch.zeros(n, dtype=torch.bool, device=dev)
        left_keep[perm] = keep
        idx = torch.nonzero(left_keep[:nl]).reshape(-1)
        out = both.take(idx)
        return Result(out, {s.name: i for i, s in enumerate(node.symbols)})

    # === aggregation ===================================================
    def _exec_aggregate(self, node: P.Aggregate) -> Result:
        res = self._exec(node.source)
        if node.step == "partial":
            return self._aggregate_partial(node, res)
        if node.step == "final":
            return self._aggregate_final(node, res)
        return self._aggregate_single(node, res)

    def _grouped(self, keys, sel, inputs, specs):
        """group_aggregate with the capacity grown until no group drops."""
        max_groups = 1 << 12
        while True:
            (kd, kv), raw, ng, overflow = group_aggregate(
                keys, sel, inputs, specs, max_groups
            )
            if not bool(overflow):
                return (kd, kv), raw, int(ng)
            # the overflowed pass counted the groups exactly
            max_groups = bucket_capacity(int(ng))
            if max_groups > (1 << 28):
                raise ExecutionError("group-by cardinality too large")

    def _key_columns(self, node, res, kd, kv, ng) -> list[Column]:
        cols = []
        for i, k in enumerate(node.group_keys):
            valid = kv[i][:ng]
            cols.append(
                Column(
                    k.type,
                    kd[i][:ng].to(torch_dtype(k.type.storage_dtype)),
                    None if bool(valid.all()) else valid,
                    res.column(k).dictionary,
                )
            )
        return cols

    def _aggregate_single(self, node: P.Aggregate, res: Result) -> Result:
        sel = res.batch.selection_mask()
        agg_inputs, specs = agg_inputs_for(node, res)
        layout = {s.name: i for i, s in enumerate(node.output_symbols)}
        if not node.group_keys:
            raw = global_aggregate(sel, agg_inputs, specs)
            return Result(Batch(finalize_aggs(node, raw), 1), layout)
        keys = [res.opt_pair(k) for k in node.group_keys]
        (kd, kv), raw, ng = self._grouped(keys, sel, agg_inputs, specs)
        raw = [
            r[:ng] if not isinstance(r, tuple) else (r[0][:ng], r[1][:ng])
            for r in raw
        ]
        cols = self._key_columns(node, res, kd, kv, ng)
        cols.extend(finalize_aggs(node, raw))
        return Result(Batch(cols, ng), layout)

    def _aggregate_partial(self, node: P.Aggregate, res: Result) -> Result:
        """PARTIAL step: emit accumulator columns (value, count) per agg —
        the wire representation between fragments."""
        sel = res.batch.selection_mask()
        agg_inputs, specs = agg_inputs_for(node, res)
        if not node.group_keys:
            raw = [
                r.reshape(1) if not isinstance(r, tuple)
                else (r[0].reshape((1,) + tuple(r[0].shape[1:])), r[1].reshape(1))
                for r in global_aggregate(sel, agg_inputs, specs)
            ]
            cols, layout = acc_columns(node, raw, 0)
            return Result(Batch(cols, 1), layout)
        keys = [res.opt_pair(k) for k in node.group_keys]
        (kd, kv), raw, ng = self._grouped(keys, sel, agg_inputs, specs)
        raw = [
            r[:ng] if not isinstance(r, tuple) else (r[0][:ng], r[1][:ng])
            for r in raw
        ]
        cols = self._key_columns(node, res, kd, kv, ng)
        layout = {k.name: i for i, k in enumerate(node.group_keys)}
        acc_cols, acc_layout = acc_columns(node, raw, len(cols))
        layout.update(acc_layout)
        return Result(Batch(cols + acc_cols, ng), layout)

    def _aggregate_final(self, node: P.Aggregate, res: Result) -> Result:
        """FINAL step: combine accumulator rows shipped from partials
        (reference: AggregationNode FINAL + the combine function)."""
        sel = res.batch.selection_mask()
        combine_inputs: list = []
        combine_specs: list[AggSpec] = []
        for (vsym, csym), (_, fn) in zip(node.acc_symbols, node.aggregates):
            vcol = res.column(vsym)
            if fn.kind in ("count", "count_star"):
                combine_inputs.append((vcol.data, vcol.valid))
                combine_specs.append(AggSpec("sum"))
                continue
            ccol = res.column(csym)
            combine_inputs.append((vcol.data, ccol.data > 0))
            if fn.kind in ("sum", "avg"):
                wide = vcol.data.ndim == 2
                combine_specs.append(AggSpec("sum128w" if wide else "sum"))
            else:
                combine_specs.append(AggSpec(fn.kind))
            combine_inputs.append((ccol.data, ccol.valid))
            combine_specs.append(AggSpec("sum"))

        def fold(raw):
            out, j = [], 0
            for _, fn in node.aggregates:
                val = lambda x: x[0] if isinstance(x, tuple) else x  # noqa: E731
                if fn.kind in ("count", "count_star"):
                    out.append(val(raw[j]))
                    j += 1
                else:
                    out.append((val(raw[j]), val(raw[j + 1])))
                    j += 2
            return out

        layout = {s.name: i for i, s in enumerate(node.output_symbols)}
        if not node.group_keys:
            raw = fold(global_aggregate(sel, combine_inputs, combine_specs))
            return Result(Batch(finalize_aggs(node, raw), 1), layout)
        keys = [res.opt_pair(k) for k in node.group_keys]
        (kd, kv), raw, ng = self._grouped(keys, sel, combine_inputs, combine_specs)
        raw = [r[0][:ng] if isinstance(r, tuple) else r[:ng] for r in raw]
        cols = self._key_columns(node, res, kd, kv, ng)
        cols.extend(finalize_aggs(node, fold(raw)))
        return Result(Batch(cols, ng), layout)


def rank_codes(dictionary, data):
    """Dictionary codes -> lexicographic ranks; safe on an empty
    dictionary (padding rows of an empty relation have no real codes)."""
    if dictionary is None or len(dictionary) == 0:
        return torch.zeros(data.shape, dtype=torch.int64, device=data.device)
    r = as_tensor(dictionary.ranks(), data.device)
    return r[torch.clamp(data, min=0).long()]


def _last_flag(flag: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """For each i, the largest j <= i with flag[j]."""
    return torch.cummax(torch.where(flag, pos, 0), 0).values


def compact_on_device(batch: Batch) -> Batch:
    """The selected rows of ``batch``, gathered to the front on its own
    device (``Batch.compact`` goes through the host)."""
    if batch.sel is None and all(c.capacity == batch.num_rows for c in batch.columns):
        return batch
    idx = torch.nonzero(batch.selection_mask()).reshape(-1)
    return Batch([c.take(idx) for c in batch.columns], int(idx.shape[0]), None, batch.device)


def concat_on_device(batches, keep_empty: bool = False) -> Batch:
    """Row concatenation of compacted batches of one layout on their
    device: string columns are remapped into one merged dictionary (the
    first batch's codes stay), and a column that is wide (n, 2) in any
    batch is widened in all. Empty batches are dropped unless
    ``keep_empty`` (row positions must then match the inputs')."""
    from trino_tpu_torch.ops import decimal128 as D128

    live = list(batches) if keep_empty else [b for b in batches if b.num_rows > 0]
    if not live:
        return batches[0]
    if len(live) == 1:
        return live[0]
    cols = []
    for j in range(live[0].width):
        parts = [b.columns[j] for b in live]
        t = parts[0].type
        dictionary = None
        datas = [p.data for p in parts]
        if any(p.dictionary is not None for p in parts):
            dictionary = parts[0].dictionary or Dictionary([])
            for k, p in enumerate(parts):
                if p.dictionary is not None and p.dictionary is not dictionary:
                    dictionary, remap = dictionary.merged(p.dictionary)
                    r = as_tensor(remap, p.data.device)
                    datas[k] = torch.where(
                        p.data >= 0, r[p.data.clamp(min=0).long()], -1
                    ).to(torch.int32)
        elif any(d.ndim == 2 for d in datas):
            datas = [
                d if d.ndim == 2 else torch.stack(D128.widen_i64(d.to(torch.int64)), dim=1)
                for d in datas
            ]
        valid = torch.cat([p.valid_mask() for p in parts])
        cols.append(Column(
            t, torch.cat(datas), None if bool(valid.all()) else valid, dictionary
        ))
    return Batch(cols, sum(b.num_rows for b in live), None, live[0].device)


def cast_column(c: Column, to_t: T.SqlType) -> Column:
    """A set operation input's column coerced to the output type
    (reference: ``_host_cast``): DECIMAL rescaled up, integers scaled
    into a DECIMAL, numbers converted to DOUBLE/REAL, integer widths
    changed; strings keep their dictionary."""
    from trino_tpu_torch.ops import decimal128 as D128

    from_t = c.type
    if from_t == to_t:
        return c
    data = c.data
    if T.is_string(from_t) and T.is_string(to_t):
        pass
    elif isinstance(to_t, T.DecimalType) and (
        isinstance(from_t, T.DecimalType) or T.is_integer(from_t)
    ):
        k = to_t.scale - (from_t.scale if isinstance(from_t, T.DecimalType) else 0)
        if data.ndim == 2:
            hi, lo = D128.rescale_up_wide(data[:, 0], data[:, 1], k) if k else (data[:, 0], data[:, 1])
            data = torch.stack([hi, lo], dim=1)
        else:
            data = data.to(torch.int64) * (10 ** k)
    elif isinstance(to_t, (T.DoubleType, T.RealType)):
        dt = torch_dtype(to_t.storage_dtype)
        if isinstance(from_t, T.DecimalType):
            if data.ndim == 2:
                raise _not_ported("a DECIMAL(38) set operation input cast to DOUBLE")
            data = div_by_number(data.to(torch.float64), from_t.unscale).to(dt)
        else:
            data = data.to(dt)
    elif data.ndim == 1 and not isinstance(from_t, T.DecimalType):
        data = data.to(torch_dtype(to_t.storage_dtype))
    else:
        raise _not_ported(f"a set operation cast from {from_t} to {to_t}")
    return Column(to_t, data, c.valid, c.dictionary)


def acc_columns(node: P.Aggregate, raw, offset: int):
    """Accumulator columns of a partial aggregate: per aggregate its value
    and (except count kinds) its row count; layout channels start at
    ``offset``."""
    cols: list[Column] = []
    layout: dict[str, int] = {}
    for (vsym, csym), (_, fn), r in zip(node.acc_symbols, node.aggregates, raw):
        if fn.kind in ("count", "count_star"):
            cols.append(Column(T.BIGINT, r.to(torch.int64)))
            layout[vsym.name] = offset + len(cols) - 1
            continue
        val, cnt = r
        # the value keeps its accumulation dtype (an avg of BIGINT sums
        # in int64 under a DOUBLE-typed accumulator), as in the reference;
        # limb sums travel as wide (hi, lo) values
        cols.append(Column(vsym.type, _limbs_to_wide(val)))
        layout[vsym.name] = offset + len(cols) - 1
        cols.append(Column(T.BIGINT, cnt.to(torch.int64)))
        layout[csym.name] = offset + len(cols) - 1
    return cols, layout
