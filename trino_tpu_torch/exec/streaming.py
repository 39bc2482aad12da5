"""Streaming scan aggregation over a device-resident table.

Reference: Trino drives scans through the operator pipeline in bounded
pages (``operator/Driver.java:355-392``). ``trino_tpu/exec/streaming.py``
compiles a scan->filter->project->aggregate fragment into one step
program over device chunks; its fast path, ``_try_dense``, sends a
small-domain integer GROUP BY through the dense group-by kernel.

This port carries that fast path: the connector stages the whole table on
the engine's device once (``device_slab``), filters and projections run
over the resident slab, the bin program maps group keys to dense bins and
``ops/dense_groupby.py`` totals every (bin, limb lane) in one kernel
launch. Differences from the reference:

- no platform gate: the dense path is taken whenever the shape is
  eligible; a CUDA slab launches the kernel, a CPU slab runs its plain
  version, so the CPU tests walk the same path;
- key/value statistics are computed per query (never cached under an
  object id that a later table may reuse), and their sentinels use the
  key dtype's own bounds;
- an ineligible shape returns None and the fragment runs materialized
  (the sort-based chunk loop is not ported yet).
"""

from __future__ import annotations

from typing import Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, bucket_capacity, torch_dtype
from trino_tpu_torch.exec.local import Result
from trino_tpu_torch.planner import plan as P

# largest dense key domain and accumulator matrix the dense path takes
# (the reference's limits, kept so both engines route the same shapes)
_MAX_BINS = 8192
_MAX_M = 4096


def streamable_chain(frag_root: P.PlanNode):
    """Detect a streamable fragment:
    Output?→Aggregate→(Filter|Project|Join)*→TableScan along the PROBE
    (left) spine. Returns (agg_node, probe_scan, build_roots) or None;
    ``build_roots`` lists build-side subtree roots, outermost first."""
    node = frag_root
    if isinstance(node, P.Output):
        node = node.source
    if not isinstance(node, P.Aggregate):
        return None
    agg = node
    if agg.step == "final":
        return None
    if any(fn.distinct for _, fn in agg.aggregates):
        return None
    for _, fn in agg.aggregates:
        if fn.kind not in ("sum", "count", "count_star", "min", "max", "avg"):
            return None
    node = agg.source
    build_roots: list[P.PlanNode] = []
    while True:
        if isinstance(node, (P.Filter, P.Project)):
            node = node.source
            continue
        if isinstance(node, P.Join):
            if node.join_type not in ("INNER", "LEFT", "SEMI", "ANTI"):
                return None
            if not node.criteria:
                return None
            build_roots.append(node.right)
            node = node.left
            continue
        break
    if not isinstance(node, P.TableScan):
        return None
    return agg, node, build_roots


class StreamingAggregator:
    """Runs one streamable fragment over the connector's device slab."""

    def __init__(self, executor, frag, agg_node, scan_node):
        self.executor = executor
        self.frag = frag
        self.agg = agg_node
        self.scan = scan_node
        self.nkeys = len(agg_node.group_keys)

    def run(self) -> Optional[Result]:
        return self._run_device_slab()

    # === device-resident slab source =====================================

    def _run_device_slab(self) -> Optional[Result]:
        """Stage the table on the executor's device (the connector keeps
        the slab across queries) and run the dense path over it. None when
        the connector cannot stage the table or the shape is ineligible."""
        connector = self.executor.catalogs.get(self.scan.catalog)
        stage = getattr(connector, "device_slab", None)
        if stage is None:
            return None
        cap = bucket_capacity(
            max(1, int(self.executor.session.get("stream_device_chunk_rows")))
        )
        limit = int(self.executor.session.get("stream_device_cache_bytes"))
        staged = stage(
            self.scan.schema, self.scan.table, self.scan.column_names,
            cap, limit, device=self.executor.device,
        )
        if staged is None:
            return None
        slab, num_rows = staged
        return self._try_dense(slab, num_rows)

    def _try_dense(self, slab: Batch, num_rows: int) -> Optional[Result]:
        """Dense-domain fast path: when the group keys span a small
        integer domain (from data min/max — the ``BigintGroupByHash``
        precondition) and every aggregate is a null-free sum/count, the
        whole slab runs through ONE dense group-by kernel launch
        (ops/dense_groupby.py). Returns None when ineligible."""
        from trino_tpu_torch.exec.fragments import FusedUnsupported
        from trino_tpu_torch.ops import dense_groupby as DG

        agg = self.agg
        if agg.step != "partial" or not self.nkeys:
            return None
        cap = slab.capacity
        if cap < (1 << 15) or cap & (cap - 1):
            return None
        dev = slab.device
        live0 = torch.arange(cap, device=dev) < num_rows
        batch = Batch(slab.columns, cap, live0)
        try:
            tracer = self._tracer_for(batch)
            agg_inputs, specs, keys, key_dicts, sel = self._chunk_prep(tracer)
        except FusedUnsupported:
            return None
        for spec in specs:
            if spec.kind not in ("sum", "avg", "count", "count_star", "sum128"):
                return None
        for pair in agg_inputs:
            if pair is None:
                continue
            data, valid = pair
            if valid is not None or data.ndim != 1:
                return None
            if data.is_floating_point() or data.dtype == torch.bool:
                return None
        for kd, kv in keys:
            if kv is not None or kd.ndim != 1:
                return None
            if kd.is_floating_point() or kd.dtype == torch.bool:
                return None
        distinct_vals: list = []
        for pair in agg_inputs:
            if pair is not None and not any(pair[0] is d for d in distinct_vals):
                distinct_vals.append(pair[0])
        # key domain and value ranges from data min/max: ONE host pull per
        # query; unselected rows take the dtype's own extreme as sentinel
        mins, maxs = [], []
        for kd, _ in keys:
            info = torch.iinfo(kd.dtype)
            mins.append(torch.where(sel, kd, info.max).min().to(torch.int64))
            maxs.append(torch.where(sel, kd, info.min).max().to(torch.int64))
        for d in distinct_vals:
            mins.append(torch.where(sel, d, 0).min().to(torch.int64))
            maxs.append(torch.where(sel, d, 0).max().to(torch.int64))
        lo_list, hi_list = torch.stack(
            [torch.stack(mins), torch.stack(maxs)]
        ).cpu().tolist()
        nk = len(keys)
        kmins, kmaxs = lo_list[:nk], hi_list[:nk]
        vmins, vmaxs = lo_list[nk:], hi_list[nk:]
        if any(mx < mn for mn, mx in zip(kmins, kmaxs)):
            return None  # zero selected rows: the materialized path answers
        ranges = [int(mx - mn) + 1 for mn, mx in zip(kmins, kmaxs)]
        g_raw = 1
        for r in ranges:
            g_raw *= r
            if g_raw > _MAX_BINS:
                return None
        G = max(128, ((g_raw + 127) // 128) * 128)
        # lane plan from value ranges; a column consumed by any sum128
        # spec gets the exact 128-bit pair output REGARDLESS of sign
        pair_cols: set = set()
        for spec, pair in zip(specs, agg_inputs):
            if spec.kind == "sum128" and pair is not None:
                for ci, d in enumerate(distinct_vals):
                    if pair[0] is d:
                        pair_cols.add(ci)
        cols, pair128 = [], []
        for ci, (mn, mx) in enumerate(zip(vmins, vmaxs)):
            nonneg = mn >= 0
            bits = max(int(mx).bit_length(), 1) if nonneg else 64
            cols.append(DG.DenseCol(nonneg=nonneg, bits=bits))
            pair128.append(ci in pair_cols)
        plan = DG.DensePlan(G=G, cols=tuple(cols), pair128=tuple(pair128))
        if plan.m > _MAX_M:
            return None
        # row-major key offsets -> one int32 bin per row, G for dead rows
        strides = []
        acc = 1
        for r in reversed(ranges):
            strides.append(acc)
            acc *= r
        strides.reverse()
        bins = torch.zeros(cap, dtype=torch.int32, device=dev)
        for (kd, _), mn, st in zip(keys, kmins, strides):
            bins += (kd - mn).to(torch.int32) * st
        bins = torch.where(sel, bins, G).to(torch.int32)
        lt = DG.dense_groupby_device(
            plan, bins, [v.to(torch.int64).contiguous() for v in distinct_vals]
        )
        key_vals, col_sums, counts = DG.reconstruct_device(
            plan, lt,
            torch.tensor(kmins, dtype=torch.int64, device=dev),
            torch.tensor(strides, dtype=torch.int64, device=dev),
            torch.tensor(ranges, dtype=torch.int64, device=dev),
        )
        return self._dense_finish(
            plan, key_dicts, specs, agg_inputs,
            distinct_vals, key_vals, col_sums, counts,
        )

    def _dense_finish(self, plan, key_dicts, specs, agg_inputs,
                      distinct_vals, key_vals, col_sums, counts) -> Result:
        """Build the partial-accumulator Result (the wire format of the
        partial aggregate: keys, then per aggregate its value and count)
        from the reconstructed sums: G rows, live where a bin has rows."""
        agg = self.agg
        G = plan.G
        live = counts > 0
        cols: list[Column] = []
        layout: dict[str, int] = {}
        for i, ksym in enumerate(agg.group_keys):
            cols.append(
                Column(
                    ksym.type,
                    key_vals[i].to(torch_dtype(ksym.type.storage_dtype)),
                    live,
                    key_dicts[i],
                )
            )
            layout[ksym.name] = len(cols) - 1

        def col_index(pair):
            for ci, d in enumerate(distinct_vals):
                if pair[0] is d:
                    return ci
            raise KeyError

        for (vsym, csym), spec, pair in zip(agg.acc_symbols, specs, agg_inputs):
            if spec.kind in ("count", "count_star"):
                cols.append(Column(T.BIGINT, counts, None))
                layout[vsym.name] = len(cols) - 1
                continue
            val = col_sums[col_index(pair)]
            if spec.kind != "sum128":
                if val.ndim == 2:
                    # column shared with a sum128 spec: the pair's lo
                    # limb IS the modular int64 sum
                    val = val[:, 1]
                val = val.to(torch_dtype(vsym.type.storage_dtype))
            cols.append(Column(vsym.type, val))
            layout[vsym.name] = len(cols) - 1
            cols.append(Column(T.BIGINT, counts, None))
            layout[csym.name] = len(cols) - 1
        return Result(Batch(cols, G, live), layout)

    # === fragment evaluation over the slab ================================

    def _tracer_for(self, chunk: Batch):
        from trino_tpu_torch.exec.fragments import _FragmentTracer

        key = f"scan{id(self.scan)}"
        return _FragmentTracer(
            self.executor,
            {key: chunk},
            {key: {s.name: i for i, s in enumerate(self.scan.symbols)}},
        )

    def _chunk_prep(self, tracer):
        res = tracer._exec(self.agg.source)
        sel = res.batch.selection_mask()
        agg_inputs, specs = tracer._agg_inputs(self.agg, res)
        keys = [res.opt_pair(k) for k in self.agg.group_keys]
        key_dicts = [res.column(k).dictionary for k in self.agg.group_keys]
        return agg_inputs, specs, keys, key_dicts, sel
