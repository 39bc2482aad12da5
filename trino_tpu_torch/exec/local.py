"""Single-device execution of a logical plan (LocalQueryRunner tier).

Reference: ``core/trino-main/src/main/java/io/trino/testing/LocalQueryRunner.java:631``
— full parse->plan->execute in one process, no RPC. Each plan node is
evaluated to a :class:`Batch` on the executor's device plus a symbol
layout; operator-at-a-time, eagerly.

The subset of ``trino_tpu/exec/local.py`` this engine runs today:
TableScan, Filter, Project, Aggregate (single, partial and final steps)
and Output. Any other plan node raises :class:`ExecutionError` naming it.
"""

from __future__ import annotations

import dataclasses

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, concat_batches, torch_dtype
from trino_tpu_torch.compiler import ExprCompiler
from trino_tpu_torch.config import Session
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.ir import InputRef, RowExpr, bind_variables
from trino_tpu_torch.ops.aggregation import (
    AggSpec,
    global_aggregate,
    group_aggregate,
)
from trino_tpu_torch.planner import plan as P


class ExecutionError(Exception):
    pass


def sum_spec_for(fn: P.AggFunction, data) -> AggSpec:
    """Pick the accumulation kind for an aggregate: the exact 128-bit
    accumulators for wide DECIMAL sums (not ported yet), the kind itself
    otherwise."""
    from trino_tpu_torch.ops.decimal128 import is_wide_data

    if fn.kind in ("sum", "avg"):
        if data is not None and is_wide_data(data):
            return AggSpec("sum128w")
        rt = fn.result_type
        if isinstance(rt, T.DecimalType) and rt.wide:
            return AggSpec("sum128")
    return AggSpec(fn.kind)


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


def finalize_aggs(node: P.Aggregate, results, valid_rows=None) -> list[Column]:
    """Per aggregate, its output column from (value, count) results: avg
    division, NULL on an empty group. ``valid_rows`` masks dead rows."""
    cols = []
    for (_, fn), raw in zip(node.aggregates, results):
        t = fn.result_type
        dt = torch_dtype(t.storage_dtype)
        if fn.kind in ("count", "count_star"):
            cols.append(Column(t, raw.reshape(-1).to(torch.int64)))
            continue
        ssum, cnt = raw
        ssum, cnt = ssum.reshape(-1), cnt.reshape(-1)
        valid = cnt > 0
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


class LocalExecutor:
    def __init__(self, catalogs: CatalogManager, session: Session, device):
        self.catalogs = catalogs
        self.session = session
        self.device = torch.device(device)

    # === entry ==========================================================
    def execute(self, node: P.PlanNode) -> tuple[Batch, list[str]]:
        if isinstance(node, P.Output):
            res = self._exec(node.source)
            cols = [res.column(s) for s in node.symbols]
            out = Batch(cols, res.batch.num_rows, res.batch.sel).compact()
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
            Batch(res.batch.columns, res.batch.num_rows, sel), res.layout
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
        return Result(Batch(cols, res.batch.num_rows, res.batch.sel), layout)

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
            max_groups <<= 2
            if max_groups > (1 << 26):
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
                else (r[0].reshape(1), r[1].reshape(1))
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
            combine_specs.append(
                AggSpec("sum" if fn.kind in ("sum", "avg") else fn.kind)
            )
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
        # in int64 under a DOUBLE-typed accumulator), as in the reference
        cols.append(Column(vsym.type, val))
        layout[vsym.name] = offset + len(cols) - 1
        cols.append(Column(T.BIGINT, cnt.to(torch.int64)))
        layout[csym.name] = offset + len(cols) - 1
    return cols, layout
