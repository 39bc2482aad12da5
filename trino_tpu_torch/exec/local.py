"""Single-device execution of a logical plan (LocalQueryRunner tier).

Reference: ``core/trino-main/src/main/java/io/trino/testing/LocalQueryRunner.java:631``
— full parse->plan->execute in one process, no RPC. Each plan node is
evaluated to a :class:`Batch` on the executor's device plus a symbol
layout; operator-at-a-time, eagerly.

Every node of ``trino_tpu/exec/local.py``: TableScan, Values, Filter,
Project (string-valued expressions over a unified dictionary;
ARRAY/MAP/ROW literals as pool codes), Aggregate (single, partial and
final steps; DISTINCT aggregates; FILTER clauses folded into the inputs'
valid masks; min/max over VARCHAR by dictionary rank; ``array_agg`` into
pool-coded tuples), GroupId (GROUPING SETS, ROLLUP, CUBE), Unnest (WITH
ORDINALITY, several arrays), Join (INNER, LEFT with or without a non-equi ON
filter, RIGHT as a flipped LEFT, FULL OUTER on equality criteria, SEMI
and ANTI through the sort tier of ``ops/join.py``, with dynamic
filtering; scalar-subquery joins, CROSS joins; DECIMAL(38) keys), Window
(``ops/window.py``), Distinct, SetOp (UNION, INTERSECT and EXCEPT,
DISTINCT or ALL), Sort, TopN, Limit and Output, wide (n, 2)
DECIMAL columns included. String->string functions are lowered onto
dictionary-transformed columns first (``strings.py``), and
``format_datetime``/``date_format`` onto rendered columns
(``datetimefmt.py``). Joins on DOUBLE and REAL keys match on the
float64 bit pattern. Past ``spill_threshold_rows`` a join, a GROUP BY, a
sort (TopN included) and a partitioned window run partition by partition
(``spill.py``), and each node's output is reserved in the query's memory
context (``memory.py``). Gathers stay on the executor's device.
"""

from __future__ import annotations

import dataclasses
import time

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
    remap_codes,
    torch_dtype,
)
from trino_tpu_torch.compiler import ExprCompiler, div_by_number
from trino_tpu_torch.config import Session
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.datetimefmt import lower_datetime_format_calls
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
from trino_tpu_torch.spill import (
    host_assignments,
    pad_to_one_unselected,
    partitioned_run,
    slice_rows,
)
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
    and its accumulation spec, and per aggregate the dictionary of a
    VARCHAR min/max (else None). A FILTER clause folds into the input's
    valid mask (``count(*) FILTER`` counts the mask), as the reference's
    ``_prepare_partial_inputs`` does, so the partial step applies it once
    and the final step never sees it. VARCHAR min/max run over the
    dictionary's lexicographic ranks (:func:`rank_codes`); the caller maps
    the winning rank back to a code. A DISTINCT count/sum/avg keeps the
    first row of each (group keys, value) combination only."""
    agg_inputs, specs, string_dicts = [], [], []
    for _, fn in node.aggregates:
        fmask = None
        if fn.filter is not None:
            fc = res.column(P.Symbol(fn.filter.name, T.BOOLEAN))
            fmask = fc.data.to(torch.bool) & fc.valid_mask()
        string_dicts.append(None)
        if fn.kind == "count_star":
            if fmask is None:
                agg_inputs.append(None)
                specs.append(AggSpec("count_star"))
            else:
                ones = torch.ones(fmask.shape[0], dtype=torch.int64, device=fmask.device)
                agg_inputs.append((ones, fmask))
                specs.append(AggSpec("count"))
            continue
        if fn.kind == "array_agg":
            raise ExecutionError("array_agg runs through the host collector")
        c = res.column(P.Symbol(fn.argument.name, fn.argument.type))
        data, valid = c.data, c.valid
        if c.dictionary is not None and fn.kind in ("min", "max"):
            data = rank_codes(c.dictionary, data)
            string_dicts[-1] = c.dictionary
        elif c.dictionary is not None and fn.kind != "count":
            raise ExecutionError(
                f"{fn.kind} over {fn.argument.type.name} is not yet ported to trino_tpu_torch"
            )
        if fmask is not None:
            valid = fmask if valid is None else valid & fmask
        if fn.distinct and fn.kind in ("count", "sum", "avg"):
            sel = res.batch.selection_mask()
            vmask = c.valid_mask() if valid is None else valid
            keys = [res.pair(k) for k in node.group_keys]
            valid = vmask & distinct_first_mask(keys, (data, vmask), sel & vmask)
        agg_inputs.append((data, valid))
        specs.append(sum_spec_for(fn, data))
    return agg_inputs, specs, string_dicts


def codes_of_ranks(dictionary, ranks: torch.Tensor) -> torch.Tensor:
    """Lexicographic ranks of ``dictionary`` -> its int32 codes (the
    inverse of :func:`rank_codes`)."""
    if dictionary is None or len(dictionary) == 0:
        return torch.full(ranks.shape, -1, dtype=torch.int32, device=ranks.device)
    order = as_tensor(dictionary.order(), ranks.device)
    idx = ranks.to(torch.int64).clamp(0, len(dictionary) - 1)
    return order[idx].to(torch.int32)


def finalize_aggs(node: P.Aggregate, results, string_dicts=None) -> list[Column]:
    """Per aggregate, its output column from (value, count) results: avg
    division (DECIMAL averages round half up, wide ones through
    ``div128_round``), NULL on an empty group, limb sums resolved into
    wide (hi, lo) values, and a VARCHAR min/max rank mapped back to its
    dictionary code."""
    from trino_tpu_torch.ops import decimal128 as D128

    string_dicts = string_dicts or [None] * len(node.aggregates)
    cols = []
    for (_, fn), raw, sdict in zip(node.aggregates, results, string_dicts):
        t = fn.result_type
        dt = torch_dtype(t.storage_dtype)
        if fn.kind in ("count", "count_star"):
            cols.append(Column(t, raw.reshape(-1).to(torch.int64)))
            continue
        ssum, cnt = raw
        cnt = cnt.reshape(-1)
        valid = cnt > 0
        if sdict is not None:
            codes = torch.where(valid, codes_of_ranks(sdict, ssum.reshape(-1)), -1)
            cols.append(Column(t, codes.to(torch.int32), valid, sdict))
            continue
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
    expr = lower_string_calls(lower_datetime_format_calls(expr, work), work)
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
        new_cols[ch] = Column(c.type, remap_codes(c.data, remap), c.valid, union)
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
    def __init__(self, catalogs: CatalogManager, session: Session, device,
                 memory_ctx=None):
        self.catalogs = catalogs
        self.session = session
        self.device = torch.device(device)
        # dynamic filters collected while executing (dynfilter.py)
        self.dynamic_filters: list = []
        # the query's memory context (memory.py): each node's output is
        # reserved, its children's freed once it has materialized
        self.memory_ctx = memory_ctx
        self._reservations: dict[int, int] = {}
        # spilled operators by kind, their partitions and host seconds
        self.spill_stats: dict = {}
        # EXPLAIN ANALYZE's per-node records (stats.StatsCollector), or None
        self.stats_collector = None
        # the query's ingest accounting (ingest.py): split decode, the
        # host-to-device copies of its scans, the table cache
        self.ingest_stats: dict = {}

    def _read_splits(self, connector, schema, table, columns, splits):
        """Decode splits through the ingest tier: double-buffered (a
        background thread decodes split k+1 while the caller consumes
        split k) under ``ingest_prefetch``, with the codecs that
        ``native_decode`` selects (reference: ``exec/local.py:112-132``)."""
        from trino_tpu_torch.ingest import SplitPrefetcher

        yield from SplitPrefetcher(
            lambda s: connector.read_split(schema, table, columns, s),
            splits,
            enabled=bool(self.session.get("ingest_prefetch")),
            stats=self.ingest_stats,
            native=bool(self.session.get("native_decode")),
        )

    def _to_device(self, batch: Batch) -> Batch:
        """A scan's host batch on the engine's device: one pinned copy
        under ``coalesced_h2d`` from ``coalesce_min_bytes`` on, else one
        copy a buffer (``ingest.to_device``)."""
        from trino_tpu_torch import native
        from trino_tpu_torch.ingest import to_device

        with native.decode_mode(bool(self.session.get("native_decode"))):
            return to_device(
                batch, self.device,
                coalesced=bool(self.session.get("coalesced_h2d")),
                min_bytes=int(self.session.get("coalesce_min_bytes")),
                stats=self.ingest_stats,
            )

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
        if self.stats_collector is not None:
            from trino_tpu_torch.memory import batch_nbytes

            t0 = time.perf_counter()
            res = method(node)
            rows = int(res.batch.count_rows())  # a device sync: exact timing
            self.stats_collector.record(
                node, time.perf_counter() - t0, rows, batch_nbytes(res.batch)
            )
        else:
            res = method(node)
        if self.memory_ctx is not None:
            from trino_tpu_torch.memory import batch_nbytes

            nbytes = batch_nbytes(res.batch)
            self.memory_ctx.reserve(nbytes, what=type(node).__name__)
            self._reservations[id(node)] = nbytes
            # the children's intermediates are dead once this node has
            # materialized
            for s in node.sources:
                self.memory_ctx.free(self._reservations.pop(id(s), 0))
        return res

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
        reader = self._read_splits(
            connector, node.schema, node.table, node.column_names, splits
        )
        for b in reader:
            batches.append(b)
            rows_read += b.num_rows
            # connector applyLimit hint: stop pulling splits once the
            # pushed row budget is covered (the Limit node still enforces)
            if node.limit is not None and rows_read >= node.limit:
                break
        reader.close()  # stops the decode thread after a limit
        if not batches:
            batches = [
                connector.read_split(
                    node.schema, node.table, node.column_names,
                    connector.get_splits(node.schema, node.table, 1)[0],
                )
            ]
        batch = concat_batches(batches) if len(batches) > 1 else batches[0]
        return Result(self._to_device(batch), layout)

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
            bound = lower_datetime_format_calls(self._bind(expr, res.layout), work_cols)
            bound = lower_string_calls(bound, work_cols)
            if isinstance(bound, InputRef):
                cols.append(work_cols[bound.channel])
                continue
            if isinstance(sym.type, (T.ArrayType, T.MapType, T.RowType)):
                if not isinstance(bound, Constant):
                    # the reference refuses these too
                    raise ExecutionError(
                        "computed ARRAY/MAP/ROW expressions are not supported yet"
                    )
                # a literal value: one pool entry, every row coded 0
                live = bound.value is not None
                codes = torch.full((n,), 0 if live else -1, dtype=torch.int32,
                                   device=self.device)
                valid = None if live else torch.zeros(n, dtype=torch.bool, device=self.device)
                cols.append(Column(
                    sym.type, codes, valid, Dictionary([bound.value] if live else [])
                ))
                continue
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
        res = self._exec(node.source)
        if self._should_spill_sort(res, node.order_by):
            return self._spill_sort(res, node.order_by, None)
        return self._sorted_result(res, node.order_by, None)

    def _exec_topn(self, node: P.TopN) -> Result:
        res = self._exec(node.source)
        if self._should_spill_sort(res, node.order_by):
            return self._spill_sort(res, node.order_by, node.count)
        return self._sorted_result(res, node.order_by, node.count)

    def _should_spill(self, rows) -> bool:
        """Spill an operator of ``rows()`` input rows? Only the interpreter
        of a query spills (the executor that holds its memory context; the
        fragment tracer runs at fixed capacities and never spills, as the
        reference's traced fragments do not), and ``rows`` (a host read
        for a row count) is called only then."""
        return (
            self.memory_ctx is not None
            and bool(self.session.get("spill_enabled"))
            and rows() > int(self.session.get("spill_threshold_rows"))
        )

    def _spilled(self, kind: str) -> dict:
        """Count one spilled operator of ``kind``; the stats dict that
        ``spill.partitioned_run`` adds partitions and host seconds to."""
        ops = self.spill_stats.setdefault("operators", {})
        ops[kind] = ops.get(kind, 0) + 1
        return self.spill_stats

    def _should_spill_sort(self, res: Result, order_by) -> bool:
        if not order_by or not self._should_spill(lambda: res.batch.capacity):
            return False
        # a wide-DECIMAL (two-lane) leading key has no scalar range domain
        return res.column(order_by[0].symbol).data.ndim == 1

    def _spill_sort(self, res: Result, order_by, keep) -> Result:
        """Bounded-memory external sort (reference: ``_spill_sort``,
        ``OrderByOperator``/``TopNOperator`` revocation): range-partition
        the rows on the host by a sample of the leading key, sort each
        range on the device, concatenate the ranges in order. Rows with
        equal leading keys share a range, so later keys still order them;
        NULLs form a range of their own at the end the ordering puts
        them."""
        stats = self._spilled("sort")
        t0 = time.perf_counter()
        b = res.batch
        o0 = order_by[0]
        c0 = res.column(o0.symbol)
        data, valid = c0.to_numpy()
        if c0.dictionary is not None:
            ranks = np.asarray(c0.dictionary.ranks())
            data = ranks[np.clip(data, 0, max(len(ranks) - 1, 0))]
        sel = b.selection_mask().cpu().numpy()
        n_part = max(2, int(self.session.get("spill_partitions")))
        live = sel & valid
        vals = data[live]
        if vals.size == 0:
            return self._sorted_result(res, order_by, keep)
        sample = np.sort(vals[:: max(1, vals.size // 65536)])
        bounds = sample[np.linspace(0, sample.size - 1, n_part + 1)[1:-1].astype(np.int64)]
        part = np.searchsorted(np.unique(bounds), data, side="right")
        n_ranges = int(part.max(initial=0)) + 1
        null_rows = np.nonzero(sel & ~valid)[0]
        # the ranges in output order: ascending or descending, NULLs at
        # the end the ordering puts them
        order = list(range(n_ranges) if o0.ascending else range(n_ranges - 1, -1, -1))
        buckets = ["null", *order] if o0.nulls_first else [*order, "null"]
        ranges = [
            null_rows if bk == "null" else np.nonzero(live & (part == bk))[0]
            for bk in buckets
        ]
        stats["partitions"] = stats.get("partitions", 0) + len(buckets)
        stats["host_partition_s"] = stats.get("host_partition_s", 0.0) + (
            time.perf_counter() - t0
        )
        pieces: list[Batch] = []
        total = 0
        for rows in ranges:
            if rows.size == 0:
                continue
            sub = Result(slice_rows(b, rows), dict(res.layout))
            piece = self._sorted_result(sub, order_by, keep).batch
            pieces.append(piece)
            total += piece.num_rows
            if keep is not None and total >= keep:
                break
        out = concat_on_device(pieces)
        if keep is not None and out.num_rows > keep:
            out = out.take(torch.arange(keep, device=out.device))
        return Result(out, dict(res.layout))

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
        left_plan = self._apply_dynamic_filters(node, right)
        left = self._exec(left_plan)  # probe
        if left_plan is not node.left and id(left_plan) in self._reservations:
            # the parent frees what its children reserved by node.sources
            self._reservations[id(node.left)] = self._reservations.pop(id(left_plan))
        # a FULL join never spills: the partitioned join drops the
        # partitions without probe rows, and their build rows with them
        if node.join_type != "FULL" and self._should_spill(
            lambda: left.batch.count_rows() + right.batch.count_rows()
        ):
            return self._spill_join(node, left, right)
        return self._join_result(node, left, right)

    def _spill_join(self, node: P.Join, left: Result, right: Result) -> Result:
        """Partitioned join (reference: ``_spill_join``,
        HashBuilderOperator spill states + GenericPartitioningSpiller):
        both sides hash-partitioned on their join keys, each partition
        joined on its own, the outputs concatenated. A partition without
        probe rows gives nothing, for INNER and LEFT joins alike."""
        lkeys, rkeys = self._join_keys(left, right, node.criteria)
        ph, _ = J.hash_keys(lkeys)
        bh, _ = J.hash_keys(rkeys)

        def run(subs, p):
            if subs[0].num_rows == 0:
                return None
            rb = subs[1] if subs[1].num_rows > 0 else pad_to_one_unselected(subs[1])
            out = self._join_result(
                node, Result(subs[0], dict(left.layout)), Result(rb, dict(right.layout))
            )
            return compact_on_device(out.batch)

        parts = partitioned_run(
            [(left.batch, ph), (right.batch, bh)],
            int(self.session.get("spill_partitions")), run, self._spilled("join"),
        )
        sides = ((node.left, left), (node.right, right))
        layout = {s.name: i for i, s in enumerate(
            s for side_node, _ in sides for s in side_node.output_symbols
        )}
        if parts:
            return Result(concat_on_device(parts), layout)
        cols = [
            Column(c.type, c.data[:0], c.valid_mask()[:0], c.dictionary)
            for side_node, side in sides
            for c in (side.column(s) for s in side_node.output_symbols)
        ]
        return Result(Batch(cols, 0, None, self.device), layout)

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

    def _join_keys(self, left: Result, right: Result, criteria,
                   remap_probe: bool = False):
        """Per criterion, int64 (data, valid) key pairs for both sides:
        dictionary codes remapped to one dictionary, DECIMAL scales
        aligned, DECIMAL(38) keys as two lanes (hi, lo), DOUBLE and REAL
        keys (and a number joined to one) as float64 bit patterns
        (``f64_key``). NULL keys never match: their valid lane is false."""
        from trino_tpu_torch.ops import decimal128 as D128

        lkeys, rkeys = [], []
        for ls, rs in criteria:
            lc = left.column(ls)
            rc = right.column(rs)
            l_float = isinstance(ls.type, (T.DoubleType, T.RealType))
            r_float = isinstance(rs.type, (T.DoubleType, T.RealType))
            ls_scale = ls.type.scale if isinstance(ls.type, T.DecimalType) else 0
            rs_scale = rs.type.scale if isinstance(rs.type, T.DecimalType) else 0
            lv, rv = lc.valid_mask(), rc.valid_mask()
            if l_float or r_float:
                if lc.data.ndim == 2 or rc.data.ndim == 2:
                    raise ExecutionError("join between DECIMAL(38) and floating point")
                # a number against a DOUBLE compares in double space, keyed
                # on the float64 bit pattern (exact per-value equality)
                lkeys.append((f64_key(lc.data, ls_scale), lv))
                rkeys.append((f64_key(rc.data, rs_scale), rv))
                continue
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
                    # one side's codes remapped onto the other's dictionary
                    # (the probe's when a build is shared across chunks)
                    keep, other = (rc, lc) if remap_probe else (lc, rc)
                    _, remap = keep.dictionary.merged(other.dictionary)
                    remap_t = torch.from_numpy(remap).to(other.data.device)
                    codes = torch.where(
                        other.data >= 0,
                        remap_t[torch.clamp(other.data, min=0).long()], -1,
                    )
                    if remap_probe:
                        ld = codes
                    else:
                        rd = codes
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
        (reference: ``_exec_window``/``_window_result``); a partitioned
        input past ``spill_threshold_rows`` is computed per hash partition
        of its PARTITION BY keys (``_spill_window``)."""
        res = self._exec(node.source)
        if node.partition_by and self._should_spill(lambda: res.batch.capacity):
            return self._spill_window(node, res)
        return self._window_result(node, res)

    def _spill_window(self, node: P.Window, res: Result) -> Result:
        """Partitioned windows (reference: ``_spill_window``, the
        WindowOperator's revocation): rows hash-partitioned on the
        PARTITION BY keys, whose frames never cross them, so each spill
        partition computes exact values; the values scatter back to their
        rows. A wide (two-lane) output, or one whose dictionary differs
        between spill partitions, is computed whole instead."""
        b = res.batch
        stats = self._spilled("window")
        n_part = int(self.session.get("spill_partitions"))
        kh = spill_hash([res.pair(s) for s in node.partition_by])
        t0 = time.perf_counter()
        assign = host_assignments([(b, kh)], n_part)[0]
        stats["partitions"] = stats.get("partitions", 0) + n_part
        n_fns = len(node.functions)
        out_data: list = [None] * n_fns
        out_valid = [torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
                     for _ in range(n_fns)]
        protos: list = [None] * n_fns
        host_s = time.perf_counter() - t0
        for p in range(n_part):
            t0 = time.perf_counter()
            rows = np.nonzero(assign == p)[0]
            host_s += time.perf_counter() - t0
            if rows.size == 0:
                continue
            sub = self._window_result(node, Result(slice_rows(b, rows), dict(res.layout)))
            idx = torch.from_numpy(rows).to(b.device)
            for j in range(n_fns):
                col = sub.batch.columns[b.width + j]
                if col.data.ndim != 1:
                    return self._window_result(node, res)
                if out_data[j] is None:
                    out_data[j] = torch.zeros(b.capacity, dtype=col.data.dtype, device=b.device)
                    protos[j] = col
                elif col.dictionary is not protos[j].dictionary or col.data.dtype != out_data[j].dtype:
                    return self._window_result(node, res)
                out_data[j][idx] = col.data
                out_valid[j][idx] = col.valid_mask()
        stats["host_partition_s"] = stats.get("host_partition_s", 0.0) + host_s
        cols = list(b.columns)
        layout = dict(res.layout)
        for j, (sym, _) in enumerate(node.functions):
            if protos[j] is None:  # no selected rows at all
                data = torch.zeros(b.capacity, dtype=torch_dtype(sym.type.storage_dtype),
                                   device=b.device)
                cols.append(Column(sym.type, data, out_valid[j]))
            else:
                cols.append(Column(sym.type, out_data[j], out_valid[j], protos[j].dictionary))
            layout[sym.name] = len(cols) - 1
        return Result(Batch(cols, b.num_rows, b.sel, b.device), layout)

    def _window_result(self, node: P.Window, res: Result) -> Result:
        from trino_tpu_torch.compiler import _narrow_checked
        from trino_tpu_torch.ops.window import WindowFn, WindowSpecKernel, compute_windows

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

    # === grouping sets and UNNEST =======================================
    def _exec_groupid(self, node: P.GroupId) -> Result:
        """GROUPING SETS / ROLLUP / CUBE (reference: ``_exec_groupid``,
        the GroupIdOperator): the input once per grouping set, with the
        keys absent from the set NULL, and the set's index appended as the
        group-id column. Copies stay on the device."""
        res = self._exec(node.source)
        base = compact_on_device(res.batch)
        n = base.num_rows
        all_keys = {s.name for s in node.all_keys}
        dead = torch.zeros(n, dtype=torch.bool, device=base.device)
        parts = []
        for gidx, group in enumerate(node.groups):
            present = {s.name for s in group}
            cols = []
            for s in node.source.output_symbols:
                c = base.columns[res.layout[s.name]]
                if s.name in all_keys and s.name not in present:
                    c = Column(c.type, c.data, dead, c.dictionary)
                cols.append(c)
            cols.append(Column(
                T.BIGINT, torch.full((n,), gidx, dtype=torch.int64, device=base.device)
            ))
            parts.append(Batch(cols, n, None, base.device))
        layout = {s.name: i for i, s in enumerate(node.source.output_symbols)}
        layout[node.gid.name] = len(node.source.output_symbols)
        return Result(concat_on_device(parts, keep_empty=True), layout)

    def _exec_unnest(self, node: P.Unnest) -> Result:
        """Arrays expanded into rows (reference: ``_exec_unnest``, the
        UnnestOperator), the same rows in the same order, built with
        tensor ops: each row's length gathered from its pool by code, the
        source rows repeated (``repeat_interleave``) and each element
        gathered from the pool's flattened elements. Several arrays zip,
        the shorter padded with NULLs; WITH ORDINALITY numbers the
        elements from 1."""
        res = self._exec(node.source)
        b = compact_on_device(res.batch)
        n, dev = b.num_rows, b.device
        sources = []  # (codes, valid, pool) per array expression
        for expr in node.array_exprs:
            bound = self._bind(expr, res.layout)
            if isinstance(bound, Constant):
                live = bound.value is not None
                sources.append((
                    torch.zeros(n, dtype=torch.int32, device=dev),
                    torch.full((n,), live, dtype=torch.bool, device=dev),
                    Dictionary([bound.value if live else ()]),
                ))
            elif isinstance(bound, InputRef):
                c = b.columns[bound.channel]
                if c.dictionary is None:
                    raise ExecutionError("UNNEST argument has no array pool")
                sources.append((c.data, c.valid_mask(), c.dictionary))
            else:
                raise ExecutionError("UNNEST argument has no array pool")
        lengths = torch.zeros(n, dtype=torch.int64, device=dev)
        for codes, valid, pool in sources:
            table = as_tensor(
                np.asarray([len(e) for e in pool.values] + [0], dtype=np.int64), dev
            )
            ln = torch.where(valid, table[codes.clamp(min=0).long()], 0)
            lengths = torch.maximum(lengths, ln)
        row_idx = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
        total = int(row_idx.shape[0])
        starts = torch.cumsum(lengths, 0) - lengths
        pos = torch.arange(total, device=dev) - starts[row_idx]
        cols: list[Column] = []
        layout: dict[str, int] = {}
        for s in node.source.output_symbols:
            cols.append(b.columns[res.layout[s.name]].take(row_idx))
            layout[s.name] = len(cols) - 1
        for sym, (codes, valid, pool) in zip(node.element_symbols, sources):
            cols.append(_unnest_elements(sym.type, pool, codes[row_idx],
                                         valid[row_idx], pos))
            layout[sym.name] = len(cols) - 1
        if node.ordinality is not None:
            cols.append(Column(T.BIGINT, pos + 1))
            layout[node.ordinality.name] = len(cols) - 1
        return Result(Batch(cols, total, None, dev), layout)

    def _aggregate_with_array_agg(self, node: P.Aggregate, res: Result) -> Result:
        """``array_agg`` (reference: ``_aggregate_with_array_agg``): the
        other aggregates run as usual; each group's values, NULLs kept, in
        input row order, become one tuple of a pool, and the column holds
        pool codes (an empty group gives NULL). Rows find their group on
        the device (``torch.unique`` over the key lanes of the groups and
        the rows together); the tuples are built on the host."""
        others = [(s, fn) for s, fn in node.aggregates if fn.kind != "array_agg"]
        base = P.Aggregate(node.source, node.group_keys, others, node.step)
        out = self._aggregate_single(base, res, allow_spill=False)
        out_b = compact_on_device(out.batch)
        ng = out_b.num_rows if node.group_keys else 1
        sel = res.batch.selection_mask()
        if node.group_keys:
            glanes = _key_lanes([
                (out_b.columns[out.layout[k.name]].data,
                 out_b.columns[out.layout[k.name]].valid_mask())
                for k in node.group_keys
            ])
            rlanes = _key_lanes([res.pair(k) for k in node.group_keys])
            _, inv = torch.unique(
                torch.cat([glanes, rlanes]), dim=0, return_inverse=True
            )
            group_ids, row_ids = inv[:ng], inv[ng:]
            n_ids = int(inv.max()) + 1 if inv.numel() else 1
        else:
            group_ids = torch.zeros(1, dtype=torch.int64, device=sel.device)
            row_ids = torch.zeros(sel.shape[0], dtype=torch.int64, device=sel.device)
            n_ids = 1
        cols = list(out_b.columns)
        layout = dict(out.layout)
        for sym, fn in node.aggregates:
            if fn.kind != "array_agg":
                continue
            c = res.column(P.Symbol(fn.argument.name, fn.argument.type))
            mask = sel
            if fn.filter is not None:
                fc = res.column(P.Symbol(fn.filter.name, T.BOOLEAN))
                mask = mask & fc.data.to(torch.bool) & fc.valid_mask()
            idx = torch.nonzero(mask).reshape(-1)
            gids = row_ids[idx]
            order = torch.sort(gids, stable=True).indices
            idx, gids = idx[order], gids[order]
            values = _host_values(c, idx)
            counts = np.bincount(gids.cpu().numpy(), minlength=n_ids)
            bounds = np.concatenate([[0], np.cumsum(counts)])
            pool_index: dict = {}
            pool_vals: list = []
            codes = np.full(ng, -1, dtype=np.int32)
            for gi, g in enumerate(group_ids.cpu().tolist()):
                tup = tuple(values[bounds[g]:bounds[g + 1]])
                if not tup:
                    continue
                code = pool_index.setdefault(tup, len(pool_vals))
                if code == len(pool_vals):
                    pool_vals.append(tup)
                codes[gi] = code
            live = codes >= 0
            cols.append(Column(
                sym.type, as_tensor(codes, self.device),
                None if live.all() else as_tensor(live, self.device),
                Dictionary(pool_vals),
            ))
            layout[sym.name] = len(cols) - 1
        ordered = [cols[layout[s.name]] for s in node.output_symbols]
        return Result(
            Batch(ordered, ng, None, self.device),
            {s.name: i for i, s in enumerate(node.output_symbols)},
        )

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

    def _aggregate_single(self, node: P.Aggregate, res: Result,
                          allow_spill: bool = True) -> Result:
        if allow_spill and node.group_keys and self._should_spill(res.batch.count_rows):
            return self._spill_aggregate(node, res)
        if any(fn.kind == "array_agg" for _, fn in node.aggregates):
            return self._aggregate_with_array_agg(node, res)
        sel = res.batch.selection_mask()
        agg_inputs, specs, sdicts = agg_inputs_for(node, res)
        layout = {s.name: i for i, s in enumerate(node.output_symbols)}
        if not node.group_keys:
            raw = global_aggregate(sel, agg_inputs, specs)
            return Result(Batch(finalize_aggs(node, raw, sdicts), 1), layout)
        keys = [res.opt_pair(k) for k in node.group_keys]
        (kd, kv), raw, ng = self._grouped(keys, sel, agg_inputs, specs)
        raw = [
            r[:ng] if not isinstance(r, tuple) else (r[0][:ng], r[1][:ng])
            for r in raw
        ]
        cols = self._key_columns(node, res, kd, kv, ng)
        cols.extend(finalize_aggs(node, raw, sdicts))
        return Result(Batch(cols, ng), layout)

    def _spill_aggregate(self, node: P.Aggregate, res: Result) -> Result:
        """Partitioned GROUP BY (reference: ``_spill_aggregate``, the
        HashAggregationOperator's revocable state): rows hash-partitioned
        by their group keys, each partition aggregated on its own; the
        partitions' key sets are disjoint, so their groups concatenate."""
        kh = spill_hash([res.pair(k) for k in node.group_keys])

        def run(subs, p):
            if subs[0].num_rows == 0:
                return None
            out = self._aggregate_single(node, Result(subs[0], dict(res.layout)), False)
            return compact_on_device(out.batch)

        parts = partitioned_run(
            [(res.batch, kh)], int(self.session.get("spill_partitions")), run,
            self._spilled("aggregate"),
        )
        layout = {s.name: i for i, s in enumerate(node.output_symbols)}
        if not parts:
            cols = [
                Column(
                    s.type,
                    torch.zeros((0, 2) if isinstance(s.type, T.DecimalType) and s.type.wide else 0,
                                dtype=torch_dtype(s.type.storage_dtype), device=self.device),
                    None,
                    (res.column(s).dictionary if s.name in res.layout else Dictionary([]))
                    if T.is_string(s.type) else None,
                )
                for s in node.output_symbols
            ]
            return Result(Batch(cols, 0, None, self.device), layout)
        return Result(concat_on_device(parts), layout)

    def _aggregate_partial(self, node: P.Aggregate, res: Result) -> Result:
        """PARTIAL step: emit accumulator columns (value, count) per agg —
        the wire representation between fragments."""
        sel = res.batch.selection_mask()
        agg_inputs, specs, sdicts = agg_inputs_for(node, res)
        if not node.group_keys:
            raw = [
                r.reshape(1) if not isinstance(r, tuple)
                else (r[0].reshape((1,) + tuple(r[0].shape[1:])), r[1].reshape(1))
                for r in global_aggregate(sel, agg_inputs, specs)
            ]
            cols, layout = acc_columns(node, raw, 0, sdicts)
            return Result(Batch(cols, 1), layout)
        keys = [res.opt_pair(k) for k in node.group_keys]
        (kd, kv), raw, ng = self._grouped(keys, sel, agg_inputs, specs)
        raw = [
            r[:ng] if not isinstance(r, tuple) else (r[0][:ng], r[1][:ng])
            for r in raw
        ]
        cols = self._key_columns(node, res, kd, kv, ng)
        layout = {k.name: i for i, k in enumerate(node.group_keys)}
        acc_cols, acc_layout = acc_columns(node, raw, len(cols), sdicts)
        layout.update(acc_layout)
        return Result(Batch(cols + acc_cols, ng), layout)

    def _aggregate_final(self, node: P.Aggregate, res: Result) -> Result:
        """FINAL step: combine accumulator rows shipped from partials
        (reference: AggregationNode FINAL + the combine function)."""
        sel = res.batch.selection_mask()
        combine_inputs: list = []
        combine_specs: list[AggSpec] = []
        sdicts: list = []
        for (vsym, csym), (_, fn) in zip(node.acc_symbols, node.aggregates):
            vcol = res.column(vsym)
            sdicts.append(None)
            if fn.kind in ("count", "count_star"):
                combine_inputs.append((vcol.data, vcol.valid))
                combine_specs.append(AggSpec("sum"))
                continue
            ccol = res.column(csym)
            if vcol.dictionary is not None and fn.kind in ("min", "max"):
                # codes -> ranks in the (merged) dictionary of the
                # partials' rows before the order-based combine
                sdicts[-1] = vcol.dictionary
                combine_inputs.append((
                    rank_codes(vcol.dictionary, vcol.data),
                    (ccol.data > 0) & (vcol.data >= 0),
                ))
                combine_specs.append(AggSpec(fn.kind))
                combine_inputs.append((ccol.data, ccol.valid))
                combine_specs.append(AggSpec("sum"))
                continue
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
            return Result(Batch(finalize_aggs(node, raw, sdicts), 1), layout)
        keys = [res.opt_pair(k) for k in node.group_keys]
        (kd, kv), raw, ng = self._grouped(keys, sel, combine_inputs, combine_specs)
        raw = [r[0][:ng] if isinstance(r, tuple) else r[:ng] for r in raw]
        cols = self._key_columns(node, res, kd, kv, ng)
        cols.extend(finalize_aggs(node, fold(raw), sdicts))
        return Result(Batch(cols, ng), layout)


def _key_lanes(pairs) -> torch.Tensor:
    """(rows, lanes) int64 equality lanes of key columns: each value with
    NULLs zeroed (a wide value as two lanes, a float by its bits), then
    its valid flag."""
    lanes = []
    for data, valid in pairs:
        if data.ndim == 2:
            parts = [data[:, 0], data[:, 1]]
        elif data.is_floating_point():
            parts = [f64_key(data)]
        else:
            parts = [data.to(torch.int64)]
        lanes += [torch.where(valid, p, 0) for p in parts]
        lanes.append(valid.to(torch.int64))
    return torch.stack(lanes, dim=1)


def _host_values(c: Column, idx: torch.Tensor) -> list:
    """Rows ``idx`` of a column as Python storage values (strings
    decoded, NULL as None): the element values of a pool tuple."""
    data = c.data[idx].cpu().numpy()
    valid = c.valid_mask()[idx].cpu().numpy()
    if data.ndim == 2:
        raise _not_ported("array_agg over DECIMAL(38)")
    if c.dictionary is not None:
        pool = np.asarray(c.dictionary.values + [None], dtype=object)
        vals = pool[np.where(valid, data, len(c.dictionary.values))].tolist()
    else:
        vals = data.tolist()
    return [v if ok else None for v, ok in zip(vals, valid.tolist())]


def _unnest_elements(et: T.SqlType, pool: Dictionary, codes, valid, pos) -> Column:
    """The ``pos``-th element of each row's array (NULL past its end):
    the pool's elements flattened on the host, gathered by
    ``offset[code] + pos`` on the device."""
    dev = codes.device
    if isinstance(et, (T.ArrayType, T.MapType, T.RowType)):
        raise _not_ported(f"UNNEST of {et.name} elements")
    flat = [x for e in pool.values for x in e]
    lens = np.asarray([len(e) for e in pool.values] + [0], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    present = np.asarray([x is not None for x in flat] + [False], dtype=np.bool_)
    dictionary = None
    if T.is_string(et):
        dictionary, table = Dictionary.from_strings(
            [x if x is not None else "" for x in flat]
        )
        table = np.append(table, 0).astype(np.int32)
    else:
        table = np.asarray([x if x is not None else 0 for x in flat] + [0],
                           dtype=et.storage_dtype)
    ci = codes.clamp(min=0).long()
    inside = valid & (pos < as_tensor(lens, dev)[ci])
    at = torch.where(inside, as_tensor(offsets, dev)[ci] + pos, len(flat))
    data = as_tensor(table, dev)[at]
    ok = inside & as_tensor(present, dev)[at]
    return Column(et, data, None if bool(ok.all()) else ok, dictionary)


def f64_key(data: torch.Tensor, scale: int = 0) -> torch.Tensor:
    """Exact int64 equality key of a number as a float64 (reference:
    ``_f64_key``): DECIMAL values unscaled first, +0 and -0 made one,
    then the float64's bits. The reference recombines two int32 halves
    (an x64 bitcast workaround of its TPU stack); a view of the float64
    as int64 gives the same bits."""
    x = data.to(torch.float64)
    if scale:
        x = div_by_number(x, 10**scale)
    x = torch.where(x == 0, torch.zeros_like(x), x)
    return x.contiguous().view(torch.int64)


def spill_hash(pairs) -> torch.Tensor:
    """The int64 hash that partitions rows for spilling: ``J.hash_keys``
    over the key columns with NULL keys' data zeroed (so every NULL key
    lands in one partition and one group) and wide (hi, lo) keys as two
    lanes."""
    lanes = []
    for data, valid in pairs:
        if data.ndim == 2:
            lanes += [(torch.where(valid, data[:, 0], 0), valid),
                      (torch.where(valid, data[:, 1], 0), valid)]
        else:
            lanes.append((torch.where(valid, data, torch.zeros_like(data)), valid))
    return J.hash_keys(lanes)[0]


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
                    datas[k] = remap_codes(p.data, remap)
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


def acc_columns(node: P.Aggregate, raw, offset: int, string_dicts=None):
    """Accumulator columns of a partial aggregate: per aggregate its value
    and (except count kinds) its row count; layout channels start at
    ``offset``. A VARCHAR min/max travels as a dictionary code with its
    dictionary attached (ranks mean nothing to another dictionary), NULL
    for an empty group."""
    string_dicts = string_dicts or [None] * len(node.aggregates)
    cols: list[Column] = []
    layout: dict[str, int] = {}
    for (vsym, csym), (_, fn), r, sdict in zip(
        node.acc_symbols, node.aggregates, raw, string_dicts
    ):
        if fn.kind in ("count", "count_star"):
            cols.append(Column(T.BIGINT, r.to(torch.int64)))
            layout[vsym.name] = offset + len(cols) - 1
            continue
        val, cnt = r
        if sdict is not None:
            live = cnt.reshape(-1) > 0
            codes = torch.where(live, codes_of_ranks(sdict, val.reshape(-1)), -1)
            cols.append(Column(vsym.type, codes.to(torch.int32), live, sdict))
            layout[vsym.name] = offset + len(cols) - 1
            cols.append(Column(T.BIGINT, cnt.to(torch.int64)))
            layout[csym.name] = offset + len(cols) - 1
            continue
        # the value keeps its accumulation dtype (an avg of BIGINT sums
        # in int64 under a DOUBLE-typed accumulator), as in the reference;
        # limb sums travel as wide (hi, lo) values
        cols.append(Column(vsym.type, _limbs_to_wide(val)))
        layout[vsym.name] = offset + len(cols) - 1
        cols.append(Column(T.BIGINT, cnt.to(torch.int64)))
        layout[csym.name] = offset + len(cols) - 1
    return cols, layout
