"""Single-device execution of a logical plan (LocalQueryRunner tier).

Reference: ``core/trino-main/src/main/java/io/trino/testing/LocalQueryRunner.java:631``
— full parse->plan->execute in one process, no RPC. Each plan node is
evaluated to a :class:`Batch` on the executor's device plus a symbol
layout; operator-at-a-time, eagerly.

The subset of ``trino_tpu/exec/local.py`` this engine runs today:
TableScan, Filter, Project, Aggregate (single, partial and final steps),
Join (INNER, LEFT, RIGHT as a flipped LEFT, SEMI and ANTI, through the
sort tier of ``ops/join.py``, with dynamic filtering), Sort, TopN, Limit
and Output, wide (n, 2) DECIMAL columns included. Any other plan node
raises :class:`ExecutionError` naming it; so do FULL and CROSS joins,
scalar-subquery joins, LEFT joins with an ON filter, the spill join, and
join keys that are DECIMAL(38) or floating point. Gathers stay on the
executor's device.
"""

from __future__ import annotations

import dataclasses

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import (
    Batch,
    Column,
    bucket_capacity,
    concat_batches,
    torch_dtype,
)
from trino_tpu_torch.compiler import ExprCompiler
from trino_tpu_torch.config import Session
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.ir import InputRef, RowExpr, bind_variables
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops.aggregation import (
    AggSpec,
    global_aggregate,
    group_aggregate,
)
from trino_tpu_torch.ops.sort import sort_indices
from trino_tpu_torch.planner import plan as P


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
    and its accumulation spec. DISTINCT, FILTER and string min/max are not
    ported yet."""
    agg_inputs, specs = [], []
    for _, fn in node.aggregates:
        if fn.distinct or fn.filter is not None:
            raise ExecutionError(
                "DISTINCT / FILTER aggregates are not yet ported to trino_tpu_torch"
            )
        if fn.kind == "count_star":
            agg_inputs.append(None)
            specs.append(AggSpec("count_star"))
            continue
        c = res.column(P.Symbol(fn.argument.name, fn.argument.type))
        if c.dictionary is not None:
            raise ExecutionError(
                f"{fn.kind} over VARCHAR is not yet ported to trino_tpu_torch"
            )
        agg_inputs.append((c.data, c.valid))
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
    """Raise for the join shapes this engine does not run yet."""
    if node.join_type not in ("INNER", "LEFT"):
        raise _not_ported(f"{node.join_type} JOIN")
    if not node.criteria:
        raise _not_ported("a join without equality criteria")
    if node.single_row:
        raise _not_ported("a scalar-subquery join")
    if node.join_type == "LEFT" and node.filter is not None:
        raise _not_ported("a LEFT JOIN with a non-equi ON filter")


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
    def _exec_tablescan(self, node: P.TableScan) -> Result:
        connector = self.catalogs.get(node.catalog)
        splits = connector.get_splits_with_hints(
            node.schema, node.table, 64, node.constraint,
            limit=node.limit, topn=node.topn,
        )
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
        mask = ExprCompiler(res.batch.columns, device=self.device).predicate_mask(expr)
        sel = mask if res.batch.sel is None else (mask & res.batch.sel)
        return Result(
            Batch(res.batch.columns, res.batch.num_rows, sel, res.batch.device),
            res.layout,
        )

    def _exec_project(self, node: P.Project) -> Result:
        res = self._exec(node.source)
        work_cols = list(res.batch.columns)
        cols: list[Column] = []
        for sym, expr in node.assignments:
            bound = self._bind(expr, res.layout)
            if isinstance(bound, InputRef):
                cols.append(work_cols[bound.channel])
                continue
            if T.is_string(sym.type) or isinstance(
                sym.type, (T.ArrayType, T.MapType, T.RowType)
            ):
                raise ExecutionError(
                    f"computed {sym.type.name} expressions are not yet "
                    "ported to trino_tpu_torch"
                )
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
        right = self._exec(node.right)  # build first: enables dynamic filter
        left = self._exec(self._apply_dynamic_filters(node, right))  # probe
        if (
            self.session.get("spill_enabled")
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
            "left" if node.join_type == "LEFT" else "inner", est,
        )
        is_outer = bpos == J.MISSING
        pidx = ppos.long()
        bidx = torch.where(is_outer, 0, bpos).long()
        out_cols = []
        for s in node.left.output_symbols:
            c = left.column(s)
            out_cols += [c.data[pidx], c.valid_mask()[pidx]]
        for s in node.right.output_symbols:
            c = right.column(s)
            out_cols += [c.data[bidx], c.valid_mask()[bidx] & ~is_outer]
        out = join_output(node, left, right, out_cols, out_capacity, osel)
        if node.filter is not None:  # INNER only (check_join_ported)
            expr = self._bind(node.filter, out.layout)
            mask = ExprCompiler(out.batch.columns, device=self.device).predicate_mask(expr)
            out = Result(
                Batch(out.batch.columns, out_capacity, mask & osel), out.layout
            )
        return out

    def _join_keys(self, left: Result, right: Result, criteria):
        """Per criterion, int64 (data, valid) key pairs for both sides:
        dictionary codes remapped to one dictionary, DECIMAL scales
        aligned."""
        lkeys, rkeys = [], []
        for ls, rs in criteria:
            lc = left.column(ls)
            rc = right.column(rs)
            if lc.data.ndim == 2 or rc.data.ndim == 2:
                raise _not_ported("a join on DECIMAL(38) keys")
            if isinstance(ls.type, (T.DoubleType, T.RealType)) or isinstance(
                rs.type, (T.DoubleType, T.RealType)
            ):
                raise _not_ported("a join on floating-point keys")
            ld, lv = lc.data, lc.valid_mask()
            rd, rv = rc.data, rc.valid_mask()
            if lc.dictionary is not None or rc.dictionary is not None:
                if lc.dictionary is not rc.dictionary:
                    _, remap = lc.dictionary.merged(rc.dictionary)
                    remap_t = torch.from_numpy(remap).to(rd.device)
                    rd = torch.where(
                        rd >= 0, remap_t[torch.clamp(rd, min=0).long()], -1
                    )
            ls_scale = ls.type.scale if isinstance(ls.type, T.DecimalType) else 0
            rs_scale = rs.type.scale if isinstance(rs.type, T.DecimalType) else 0
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
            osel = osel & ExprCompiler(fcols, device=self.device).predicate_mask(fexpr)
        matched = torch.zeros(cap + 1, dtype=torch.bool, device=osel.device)
        matched[torch.where(osel, pidx, cap)] = True
        _, bv = J.hash_keys(rkeys)
        mark = mark_column(
            node, left, matched[:cap], lkeys, bv, right.batch.selection_mask()
        )
        return with_mark(node, left, mark)

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
