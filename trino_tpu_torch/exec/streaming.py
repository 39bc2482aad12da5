"""Streaming scan aggregation: bounded chunks through one step with
carried accumulator state.

Reference: Trino drives scans through the operator pipeline in bounded
pages (``operator/Driver.java:355-392``). ``trino_tpu/exec/streaming.py``
compiles a scan->filter->project->aggregate fragment into one step
program

    state' = step(state, chunk)

run over chunks of the table; this port runs the same step eagerly, as
PyTorch ops on the engine's device:

- the connector stages the table on the device once (``device_slab``)
  and each chunk is a view ``column[off:off + cap]`` of the slab with a
  live mask from the row count; the loop runs over live rows only. With
  ``stream_device_chunk_rows`` unset the chunk is the whole slab when the
  fragment's estimated working set fits the device's free memory, so a
  fragment that fits pays the step's per-chunk host work once;
- a table the device slab refuses streams host chunks: splits read one
  after another, string codes remapped onto one running dictionary per
  column (``_canonicalize_dicts``), each piece padded to the chunk
  capacity and copied to the device;
- a chunk is aggregated into at most G groups (``group_aggregate``) and
  merged with the carried groups; DECIMAL(38) sums carry their 32-bit
  limb lanes, which add independently, so carries resolve once at the
  end. The overflow flag stays on the device and is read once per run;
  a fired flag raises :class:`StreamOverflow` and the caller grows G.

Before any of that, ``_try_dense`` sends a small-domain integer GROUP BY
over a power-of-two slab through the dense group-by kernel (K1). Unlike
the reference it has no platform gate (a CUDA slab launches the kernel, a
CPU slab runs its plain version, so the CPU tests walk the same path),
and its key statistics are computed per query, with sentinels from the
key dtype's own bounds.

Joins on the probe spine (INNER, LEFT, SEMI, ANTI) run inside the step:
their build sides are materialized once before the chunks, each join
builds its table once per attempt and probes it with every chunk at a
fixed output capacity (see :class:`StreamingAggregator`).

A connector that generates its rows (the synthetic connector's
``device_generator``) streams chunks made on the device, after the slab
and before host chunks. Not ported: the reference's compile-failure chunk
halving (an XLA workaround).

On a mesh of N > 1 shards the stream takes one chunk a shard, as the
reference does (``trino_tpu/exec/streaming.py:204-250``): a step is N
parts, each padded to one per-shard capacity, shard-major in one chunk of
N x cap rows; the state holds G groups a shard (N x G rows); each shard
steps over its own part and carried groups; the stream's output is N x G
rows (N without group keys) for the fragment's output exchange. The
reference streams host chunks there (its slab path takes a mesh of one,
``:311``); the port cuts a staged slab into N views a step in the host
stream's shape instead, so no row goes through the host. The generated
chunks and the dense path (K1) serve a mesh of one.
"""

from __future__ import annotations

from typing import Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import (
    Batch,
    Column,
    bucket_capacity,
    remap_codes,
    torch_dtype,
)
from trino_tpu_torch.exec.local import (
    Result,
    _limbs_to_wide,
    codes_of_ranks,
    finalize_aggs,
    rank_codes,
)
from trino_tpu_torch.ops.aggregation import AggSpec, global_aggregate, group_aggregate
from trino_tpu_torch.planner import plan as P

# largest dense key domain and accumulator matrix the dense path takes
# (the reference's limits, kept so both engines route the same shapes)
_MAX_BINS = 8192
_MAX_M = 4096


def slab_stage_rows(session) -> int:
    """The chunk rows a device slab is staged for: the session's
    ``stream_device_chunk_rows``, or the staging quantum when it is unset
    (the chunk is then chosen from the device's free memory)."""
    from trino_tpu_torch.connectors.api import SLAB_PAD_QUANTUM

    rows = session.get("stream_device_chunk_rows")
    return bucket_capacity(max(1, int(rows))) if rows else SLAB_PAD_QUANTUM


class StreamOverflow(Exception):
    """A capacity overflowed mid-stream; retry with grown caps.

    ``needed`` holds, per fired join site, the most matches one chunk
    needed; ``fresh`` the sites this attempt sized first, which the next
    attempt sizes again (an overflowed site upstream may have cut the
    rows they were sized from short)."""

    def __init__(self, names, needed=None, fresh=()):
        super().__init__(f"stream capacity overflow: {names}")
        self.names = names
        self.needed = dict(needed or {})
        self.fresh = set(fresh)


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
    """Runs one streamable fragment as a chunk loop with carried state.

    Joins on the probe spine stream too (reference: ``_prebuild``,
    build-once ``HashBuilderOperator``, probe-streamed
    ``LookupJoinOperator``): the build sides (``build_roots``, over
    ``build_inputs``) are materialized once per attempt, each join builds
    its table once (``_FragmentTracer.builds``, one K2 launch a dense
    site), and every probe chunk flows through join→aggregate. A join
    site's output capacity per chunk is fixed: sized from the first
    chunk's matches, then kept. The overflow flags of the joins, of the
    build sides and of the group budget stay on the device and are read
    once, at the stream's end."""

    def __init__(self, executor, frag, agg_node, scan_node, caps,
                 build_roots=(), build_inputs=None, build_layouts=None):
        self.executor = executor
        # the mesh: on N > 1 shards a step streams one part a shard
        self.mesh = getattr(executor, "mesh", None)
        self.n = int(getattr(executor, "n_shards", 1))
        self.frag = frag
        self.agg = agg_node
        self.scan = scan_node
        self.caps = caps
        self.build_roots = list(build_roots)
        self.build_inputs = build_inputs or {}
        self.build_layouts = build_layouts or {}
        self.nkeys = len(agg_node.group_keys)
        self.site = f"agg@{frag.id}"
        self.G = caps.get(
            self.site, int(executor.session.get("stream_group_budget"))
        )
        self._sized_before = set(caps.vals)
        # the build sides' results by root, and the joins' builds by node
        self._prememo: dict = {}
        self.builds: dict = {}
        # overflow flags and match counts over every run of the attempt
        self._flags: dict[str, torch.Tensor] = {}
        self._needed: dict[str, torch.Tensor] = {}
        self.chunks = 0
        # the rows a shard's part holds in every step (the chunk capacity
        # on a mesh of one)
        self.shard_cap = 0
        # one running dictionary per string column of the host chunk
        # stream (see _canonicalize_dicts)
        self._running_dicts: Optional[list] = None

    def _prebuild(self) -> None:
        """Materialize the build sides of the probe-spine joins once,
        device resident for the whole stream; their overflow flags join
        the stream's deferred check."""
        from trino_tpu_torch.exec.fragments import _FragmentTracer

        if not self.build_roots:
            return
        tracer = _FragmentTracer(
            self.executor, self.build_inputs, self.build_layouts, self.caps,
            self.frag.id, self.frag.root,
        )
        for root in self.build_roots:
            self._prememo[id(root)] = tracer._exec(root)
        self._absorb(tracer)

    def _absorb(self, tracer) -> None:
        """Fold one run's overflow flags (OR) and match counts (max) into
        the attempt's, on the device."""
        for name, flag in tracer.overflows:
            flag = flag.reshape(()).to(torch.bool)
            prev = self._flags.get(name)
            self._flags[name] = flag if prev is None else prev | flag
        for name, total in tracer.needed.items():
            total = total.reshape(()).to(torch.int64)
            prev = self._needed.get(name)
            self._needed[name] = total if prev is None else torch.maximum(prev, total)

    @property
    def device(self):
        return self.executor.device

    # === chunk loop ======================================================

    def run(self) -> Result:
        """Stream the fragment: the device slab when the connector stages
        the table, chunks the connector generates on the device next, host
        chunks otherwise. Raises :class:`StreamOverflow` when the group
        budget or a join's capacity overflowed. On N > 1 shards a step is
        one part a shard, of host chunks or of the slab in their shape
        (:meth:`_slab_shard_chunks`), and only a partial aggregate streams:
        its N per-shard states are what the output exchange takes."""
        from trino_tpu_torch.exec.fragments import FusedUnsupported

        if self.n > 1 and self.agg.step != "partial":
            raise FusedUnsupported("a single-step aggregate streams on one shard")
        self._prebuild()
        res = self._run_device_slab()
        if res is not None:
            return res
        if self.n == 1:
            res = self._run_generated()
            if res is not None:
                return res
        chunk_rows = int(self.executor.session.get("stream_chunk_rows"))
        return self._run_chunks(self._chunks(chunk_rows))

    def _run_chunks(self, chunks) -> Result:
        state = meta = None
        for chunk in chunks:
            tracer = self._tracer_for(chunk)
            prep = self._chunk_prep(tracer)
            self._absorb(tracer)
            self.chunks += 1
            if meta is None:
                meta = self._collect_meta(prep)
                state = self._init_state(meta)
            state = self._step(state, prep, meta)
        if meta is None:
            from trino_tpu_torch.exec.fragments import FusedUnsupported

            raise FusedUnsupported("streaming scan with zero splits")
        self._check_overflow(state)
        return self._finish(state, meta)

    def _check_overflow(self, state) -> None:
        """One host read per attempt: the carried group-budget flag, the
        joins' flags and their largest per-chunk match counts."""
        names = [self.site] + list(self._flags)
        counted = list(self._needed)
        read = torch.stack(
            [state["overflow"].reshape(()).to(torch.int64)]
            + [self._flags[n].to(torch.int64) for n in names[1:]]
            + [self._needed[n] for n in counted]
        ).cpu().tolist()
        fired = [n for n, f in zip(names, read) if f]
        if fired:
            raise StreamOverflow(
                fired, dict(zip(counted, read[len(names):])),
                set(self.caps.vals) - self._sized_before,
            )

    # === device-resident slab source =====================================

    def _run_device_slab(self) -> Optional[Result]:
        """Stage the table on the executor's device (the connector keeps
        it across queries), try the dense path, then run the sort-based
        step over views of the slab, over the live rows only. None when
        the connector cannot stage the table."""
        connector = self.executor.catalogs.get(self.scan.catalog)
        stage = getattr(connector, "device_slab", None)
        if stage is None:
            return None
        session = self.executor.session
        cap = slab_stage_rows(session)
        staged = stage(
            self.scan.schema, self.scan.table, self.scan.column_names, cap,
            int(session.get("stream_device_cache_bytes")), device=self.device,
        )
        if staged is None:
            return None
        slab, num_rows = staged
        if self.n > 1:
            return self._run_chunks(self._slab_shard_chunks(slab, num_rows))
        dense = None if self.build_roots else self._try_dense(slab, num_rows)
        if dense is not None:
            return dense
        if session.get("stream_device_chunk_rows"):
            cap = min(cap, slab.capacity)
        else:
            cap = self._fitting_chunk_rows(slab, num_rows)
        self.shard_cap = cap
        return self._run_chunks(self._slab_chunks(slab, num_rows, cap))

    # === connector-generated device chunks ================================

    def _run_generated(self) -> Optional[Result]:
        """Chunks a connector generates on the device (the synthetic
        connector's ``device_generator``): no row crosses from the host.
        Such a table has no slab, so the dense path is not tried, as in the
        reference (``trino_tpu/exec/streaming.py:340``). None when the
        connector generates no chunks."""
        connector = self.executor.catalogs.get(self.scan.catalog)
        gen = getattr(connector, "device_generator", None)
        if gen is None:
            return None
        spec = gen(self.scan.schema, self.scan.table, self.scan.column_names,
                   device=self.device)
        if spec is None:
            return None
        make_chunk, num_rows = spec
        if num_rows <= 0:
            return None
        if self.executor.session.get("stream_device_chunk_rows"):
            cap = slab_stage_rows(self.executor.session)
        else:
            probe = Batch(make_chunk(0, 1), 1)
            cap = self._fitting_chunk_rows(probe, num_rows)
        self.shard_cap = cap

        stats = self.executor.ingest_stats

        def chunks():
            pos = torch.arange(cap, device=self.device)
            for off in range(0, num_rows, cap):
                stats["device_chunks"] = stats.get("device_chunks", 0) + 1
                yield Batch(make_chunk(off, cap), cap, pos < num_rows - off)

        return self._run_chunks(chunks())

    def _fitting_chunk_rows(self, slab: Batch, num_rows: int) -> int:
        """Rows a slab chunk holds when the session leaves
        ``stream_device_chunk_rows`` unset: the slab's ``num_rows`` live
        rows in one chunk when the fragment's working set fits half the
        device's free memory, else the largest power of two that fits,
        within [2^16, the staging quantum] so that it divides the slab
        (padded to a multiple of the quantum). The working set is estimated
        at 8x the bytes a row of the scanned columns takes (filters, the
        grouping sorts and gathers), plus 64 bytes a row for each join on
        the spine (its hashes, match ranges and output gathers)."""
        from trino_tpu_torch.connectors.api import SLAB_PAD_QUANTUM
        from trino_tpu_torch.memory import device_free_bytes

        row_bytes = sum(
            c.data[:1].numel() * c.data.element_size() + 1 for c in slab.columns
        )
        per_row = 8 * row_bytes + 64 * len(self.build_roots)
        ctx = self.executor.memory_ctx
        free = device_free_bytes(self.device, None if ctx is None else ctx.pool)
        rows = free // (2 * per_row)
        if rows >= num_rows:
            return max(1, num_rows)
        return max(1 << 16, min(SLAB_PAD_QUANTUM, 1 << max(0, rows.bit_length() - 1)))

    def _slab_chunks(self, slab: Batch, num_rows: int, cap: int):
        """Chunk i: views of rows [i*cap, (i+1)*cap) of every slab column,
        live where the row is below ``num_rows``."""
        pos = torch.arange(cap, device=self.device)
        for off in range(0, max(num_rows, 1), cap):
            cols = [
                Column(
                    c.type,
                    c.data[off : off + cap],
                    None if c.valid is None else c.valid[off : off + cap],
                    c.dictionary,
                )
                for c in slab.columns
            ]
            yield Batch(cols, cap, pos < num_rows - off)

    def _slab_shard_chunks(self, slab: Batch, num_rows: int):
        """On N > 1 shards, the staged slab in the shape of the host stream
        (:meth:`_host_parts`): the connector's splits for the same target
        set the per-shard capacity (a split's mean rows, at most
        ``stream_chunk_rows``), N parts a step, and dead rows past the
        table's end pad a short last step. The parts are cut from the
        slab's rows in order, not at split boundaries, so a step's N parts
        are one view of N x cap slab rows (shard-major), copied only where
        the last step runs past the slab. Nothing goes through the host."""
        chunk_rows = int(self.executor.session.get("stream_chunk_rows"))
        n = self.n
        connector = self.executor.catalogs.get(self.scan.catalog)
        est = connector.estimate_rows(self.scan.schema, self.scan.table)
        target = max(n, ((est or 0) + chunk_rows - 1) // chunk_rows)
        splits = max(1, len(connector.get_splits(
            self.scan.schema, self.scan.table, target_splits=target)))
        cap = bucket_capacity(max(1, min(-(-num_rows // splits), chunk_rows)))
        self.shard_cap = cap
        width = n * cap
        pos = torch.arange(width, device=self.device)

        def rows(x, off):
            view = x[off : off + width]
            if view.shape[0] == width:
                return view
            return torch.cat([view, view.new_zeros((width - view.shape[0],) + tuple(x.shape[1:]))])

        for off in range(0, max(num_rows, 1), width):
            cols = [
                Column(c.type, rows(c.data, off),
                       None if c.valid is None else rows(c.valid, off), c.dictionary)
                for c in slab.columns
            ]
            yield Batch(cols, width, pos < num_rows - off, self.device, shards=n)

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
        if getattr(self.executor, "n_shards", 1) > 1:
            return None  # a mesh of one only (reference streaming.py:311)
        cap = slab.capacity
        if cap < (1 << 15) or cap & (cap - 1):
            return None
        dev = slab.device
        live0 = torch.arange(cap, device=dev) < num_rows
        batch = Batch(slab.columns, cap, live0)
        try:
            tracer = self._tracer_for(batch)
            agg_inputs, specs, keys, key_dicts, sel, _ = self._chunk_prep(tracer)
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

    # === host chunk source ===============================================

    def _canonicalize_dicts(self, b: Batch) -> Batch:
        """Remap every string column of a split batch onto the stream's
        running dictionary (one object per column, grown append-only by
        ``Dictionary.absorb``): per-split dictionaries give the same
        string different codes, so carried group keys would otherwise
        compare garbage across chunks."""
        if not any(c.dictionary is not None for c in b.columns):
            return b
        if self._running_dicts is None:
            self._running_dicts = [None] * b.width
        cols = list(b.columns)
        for j, c in enumerate(cols):
            if c.dictionary is None:
                continue
            running = self._running_dicts[j]
            if running is None:
                self._running_dicts[j] = c.dictionary
                continue
            remap, _ = running.absorb(c.dictionary)
            data = c.data
            if remap is not None:
                data = remap_codes(data, remap)
            cols[j] = Column(c.type, data, c.valid, running)
        return Batch(cols, b.num_rows, b.sel)

    def _host_parts(self, chunk_rows: int):
        """The host parts of the table's splits, decoded through the ingest
        tier (``_read_splits``): lists of N parts a step (one a shard), each
        at most ``cap`` rows, a per-shard capacity decided from the first
        split; a short last step is filled with empty parts. Yields
        ``(parts, cap)`` (reference ``_chunks``, ``:204-250``)."""
        connector = self.executor.catalogs.get(self.scan.catalog)
        est = connector.estimate_rows(self.scan.schema, self.scan.table)
        target = max(self.n, ((est or 0) + chunk_rows - 1) // chunk_rows)
        splits = connector.get_splits(
            self.scan.schema, self.scan.table, target_splits=target,
            constraint=self.scan.constraint,
        )
        if not splits:
            return
        cap = proto = None
        pending: list[Batch] = []
        # double-buffered decode: the next split decodes on a background
        # thread while the device steps over the current chunk
        for b in self.executor._read_splits(
            connector, self.scan.schema, self.scan.table,
            self.scan.column_names, splits,
        ):
            b = self._canonicalize_dicts(b)
            if cap is None:
                cap = bucket_capacity(max(1, min(b.num_rows, chunk_rows)))
                proto = b
            lo = 0
            while True:
                hi = min(lo + cap, b.num_rows)
                pending.append(_slice_rows(b, lo, hi) if b.num_rows else b)
                if len(pending) == self.n:
                    yield pending, cap
                    pending = []
                lo = hi
                if lo >= b.num_rows:
                    break
        if pending:
            pending += [_empty_like(proto)] * (self.n - len(pending))
            yield pending, cap

    def _chunks(self, chunk_rows: int):
        """Device chunks of the host parts (:meth:`_host_parts`): each
        step's parts padded to the per-shard capacity, shard-major in one
        batch of N x cap rows (its selection marks the parts' live rows),
        copied to the device in one transfer."""
        for parts, cap in self._host_parts(chunk_rows):
            self.shard_cap = cap
            padded = [_pad_batch(p, cap) for p in parts]
            if self.n == 1:
                yield self.executor._to_device(padded[0])
                continue
            cols = []
            for j, c in enumerate(padded[0].columns):
                valids = [p.columns[j].valid for p in padded]
                valid = None if all(v is None for v in valids) else torch.cat(
                    [torch.ones(cap, dtype=torch.bool) if v is None else v for v in valids]
                )
                cols.append(Column(c.type, torch.cat([p.columns[j].data for p in padded]),
                                   valid, c.dictionary))
            moved = self.executor._to_device(
                Batch(cols, self.n * cap, torch.cat([p.sel for p in padded]))
            )
            yield Batch(moved.columns, moved.num_rows, moved.sel, self.device,
                        shards=self.n)

    # === the step ========================================================

    def _tracer_for(self, chunk: Batch):
        from trino_tpu_torch.exec.fragments import _FragmentTracer

        key = f"scan{id(self.scan)}"
        tracer = _FragmentTracer(
            self.executor,
            {key: chunk},
            {key: {s.name: i for i, s in enumerate(self.scan.symbols)}},
            self.caps, self.frag.id, self.frag.root,
            builds=self.builds if self.build_roots else None,
        )
        # the build sides are already materialized: every chunk's joins
        # read them instead of executing the build subtrees again
        tracer._memo.update(self._prememo)
        return tracer

    def _chunk_prep(self, tracer):
        from trino_tpu_torch.parallel import mesh as M

        res = tracer._exec(self.agg.source)
        if self.n > 1:
            # shard-major over the N shards, whatever the spine's last
            # operator left (an interpreted join compacts its rows)
            res = Result(M.as_sharded(res.batch, self.n), res.layout)
        sel = res.batch.selection_mask()
        agg_inputs, specs, string_dicts = tracer._agg_inputs(self.agg, res)
        keys = [res.opt_pair(k) for k in self.agg.group_keys]
        key_dicts = [res.column(k).dictionary for k in self.agg.group_keys]
        return agg_inputs, specs, keys, key_dicts, sel, string_dicts

    def _collect_meta(self, prep) -> dict:
        """Static metadata of the step, from the first chunk: specs, the
        width and dtype of each accumulator, and the key columns' dtypes,
        widths and dictionaries."""
        agg_inputs, specs, keys, key_dicts, _, string_dicts = prep
        widths, dtypes = [], []
        for spec, pair in zip(specs, agg_inputs):
            if spec.kind == "sum128":
                widths.append(3)
            elif spec.kind == "sum128w":
                widths.append(5)
            elif spec.kind in ("min", "max") and pair[0].ndim == 2:
                widths.append(2)  # wide min/max: (hi, lo)
            else:
                widths.append(1)
            if pair is None or spec.kind == "count" or widths[-1] > 1:
                dtypes.append(torch.int64)
            elif pair[0].dtype == torch.bool:
                dtypes.append(torch.int64)
            elif pair[0].is_floating_point():
                dtypes.append(pair[0].dtype)
            else:
                dtypes.append(torch.int64)
        return {
            "specs": specs,
            "combine": [
                s.kind if s.kind in ("min", "max") else "sum" for s in specs
            ],
            "widths": widths,
            "dtypes": dtypes,
            "key_dicts": key_dicts,
            # VARCHAR min/max: the dictionary the carried codes refer to
            "string_dicts": list(string_dicts),
            "key_shapes": [(kd.dtype, tuple(kd.shape[1:])) for kd, _ in keys],
        }

    def _init_state(self, meta: dict) -> dict:
        """The carried state: G group rows a shard (N x G, shard-major, as
        ``parallel/mesh.py`` lays out a sharded column), one row a shard
        without group keys."""
        rows = self.n * (self.G if self.nkeys else 1)
        dev = self.device

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        state: dict = {"overflow": zeros((), torch.bool)}
        if self.nkeys:
            state["key_data"] = [
                zeros((rows,) + tail, dt) for dt, tail in meta["key_shapes"]
            ]
            state["key_valid"] = [zeros(rows, torch.bool) for _ in range(self.nkeys)]
            state["live"] = zeros(rows, torch.bool)
        state["values"] = [
            zeros((rows,) if w == 1 else (rows, w), dt)
            for w, dt in zip(meta["widths"], meta["dtypes"])
        ]
        state["counts"] = [zeros(rows, torch.int64) for _ in meta["specs"]]
        return state

    def _step(self, state, prep, meta) -> dict:
        """One step: each shard folds its rows of the chunk into its own
        carried state, a grouped one in one pass over all shards
        (:meth:`_step_grouped`), a global one under ``smap``; a shard's
        group-budget overflow sets the flag (the reference's ``pmax``)."""
        from trino_tpu_torch.parallel import mesh as M

        agg_inputs, _, keys, _, sel, chunk_dicts = prep
        carried = {k: v for k, v in state.items() if k != "overflow"}
        if self.nkeys:
            out, ovf = self._step_grouped(carried, keys, sel, agg_inputs, meta, chunk_dicts)
        elif self.n == 1:
            out, ovf = self._step_global(carried, sel, agg_inputs, meta, chunk_dicts)
        else:
            out, ovf = M.smap(
                lambda c, s, a: self._step_global(c, s, a, meta, chunk_dicts),
                self.mesh, [carried, sel, agg_inputs],
            )
            ovf = ovf.any()
        out["overflow"] = state["overflow"] | ovf
        return out

    @staticmethod
    def _string_ranks(meta, j, chunk, state_codes, chunk_ranks):
        """A VARCHAR min/max lane in one rank space: the carried codes and
        the chunk's ranks (of the chunk's own dictionary) as ranks of the
        carried dictionary, merged with the chunk's first when it is
        another object (a string the projection computed per chunk). The
        running dictionary of a host stream only grows, and ranks are
        taken on it at every step, never carried."""
        carried = meta["string_dicts"][j]
        codes = codes_of_ranks(chunk, chunk_ranks).to(torch.int64)
        if chunk is not carried:
            carried, remap = carried.merged(chunk)
            meta["string_dicts"][j] = carried
            codes = remap_codes(codes, remap)
        return rank_codes(carried, state_codes), rank_codes(carried, codes)

    def _step_grouped(self, state, keys, sel, agg_inputs, meta, chunk_dicts):
        """The chunk rows -> chunk groups, then the carried groups and the
        chunk groups -> at most G groups a shard; returns the new state
        and the overflow flag. On N > 1 shards both group-bys run once over
        all N x G rows with the shard as the leading key, so the groups
        come out shard by shard, each shard's in key order (as a group-by
        a shard gives them), and the merged groups are placed G a shard
        (:func:`_place_by_shard`). Every integer lane that
        merges by addition (the counts, the integer sums, each limb lane)
        travels in one packed (rows, lanes) input; min/max combine over
        the non-empty sides and float sums add, each as its own input."""
        specs, combine = meta["specs"], meta["combine"]
        n, total = self.n, self.n * self.G
        glive = torch.arange(total, device=self.device)
        state_kd, state_kv = list(state["key_data"]), list(state["key_valid"])
        if n > 1:
            rows = sel.shape[0]
            keys = [(torch.arange(rows, device=self.device) // (rows // n), None)] + list(keys)
            state_kd, state_kv = [glive // self.G] + state_kd, [None] + state_kv
        (ckd, ckv), craw, cng, covf = group_aggregate(
            keys, sel, agg_inputs, specs, total
        )
        cvals, ccnts = [], []
        for spec, r in zip(specs, craw):
            if spec.kind in ("count", "count_star"):
                cvals.append(r)
                ccnts.append(r)
            else:
                cvals.append(r[0])
                ccnts.append(r[1])
        packs = [j for j, v in enumerate(state["values"])
                 if combine[j] == "sum" and not v.is_floating_point()]

        def packed(vals, cnts):
            lanes = [vals[j].reshape(total, -1).to(torch.int64) for j in packs]
            lanes += [c.reshape(total, 1).to(torch.int64) for c in cnts]
            if not lanes:  # a GROUP BY without aggregates: keys alone
                lanes = [torch.zeros((total, 1), dtype=torch.int64, device=self.device)]
            return torch.cat(lanes, dim=1)

        minputs = [(torch.cat([packed(state["values"], state["counts"]),
                               packed(cvals, ccnts)]), None)]
        mspecs = [AggSpec("sum")]
        rest = [j for j in range(len(specs)) if j not in packs]
        strings = [j for j in rest if meta["string_dicts"][j] is not None]
        for j in rest:
            sv, cv = state["values"][j], cvals[j].to(state["values"][j].dtype)
            if j in strings:
                sv, cv = self._string_ranks(meta, j, chunk_dicts[j], sv, cv)
            if combine[j] in ("min", "max"):
                nonempty = torch.cat([state["counts"][j] > 0, ccnts[j] > 0])
                minputs.append((torch.cat([sv, cv]), nonempty))
            else:  # a float sum
                minputs.append((torch.cat([sv, cv]), None))
            mspecs.append(AggSpec(combine[j]))
        mkeys = [
            (torch.cat([sk, ck.to(sk.dtype)]), None if sv is None else torch.cat([sv, cv]))
            for sk, ck, sv, cv in zip(state_kd, ckd, state_kv, ckv)
        ]
        msel = torch.cat([state["live"], glive < cng])
        (nkd, nkv), nraw, nng, novf = group_aggregate(
            mkeys, msel, minputs, mspecs, total
        )
        summed = nraw[0][0]
        nvals = [None] * len(specs)
        col = 0
        for j in packs:
            w = meta["widths"][j]
            nvals[j] = summed[:, col] if w == 1 else summed[:, col : col + w]
            col += w
        for j, r in zip(rest, nraw[1:]):
            nvals[j] = r[0]
            if j in strings:
                nvals[j] = codes_of_ranks(meta["string_dicts"][j], r[0]).to(torch.int64)
        out = {
            "key_data": nkd,
            "key_valid": nkv,
            "live": glive < nng,
            "values": nvals,
            "counts": [summed[:, col + j] for j in range(len(specs))],
        }
        if n == 1:
            return out, covf | novf
        return _place_by_shard(out, n, self.G, covf | novf)

    def _step_global(self, state, sel, agg_inputs, meta, chunk_dicts):
        """One shard's step without group keys: its one accumulator row
        and the chunk's totals -> one row (a global aggregate cannot
        overflow)."""
        from trino_tpu_torch.ops.decimal128 import compare128

        specs, combine = meta["specs"], meta["combine"]
        raw = global_aggregate(sel, agg_inputs, specs)
        nvals, ncnts = [], []
        for j, (spec, r) in enumerate(zip(specs, raw)):
            sv, sc = state["values"][j], state["counts"][j]
            if spec.kind in ("count", "count_star"):
                cv = cc = r.to(torch.int64).reshape(1)
            else:
                cv = r[0].reshape(sv.shape).to(sv.dtype)
                cc = r[1].to(torch.int64).reshape(1)
            string = meta["string_dicts"][j] is not None
            if string:
                sv, cv = self._string_ranks(meta, j, chunk_dicts[j], sv, cv)
            if combine[j] in ("min", "max"):
                if sv.ndim == 2:
                    sign = compare128(sv[:, 0], sv[:, 1], cv[:, 0], cv[:, 1])
                    take_c = sign > 0 if combine[j] == "min" else sign < 0
                else:
                    take_c = cv < sv if combine[j] == "min" else cv > sv
                take_c = (sc == 0) | ((cc > 0) & take_c)
                mask = take_c[:, None] if sv.ndim == 2 else take_c
                nv = torch.where(mask, cv, sv)
                if string:
                    nv = codes_of_ranks(meta["string_dicts"][j], nv).to(torch.int64)
            else:
                nv = sv + cv
            nvals.append(nv)
            ncnts.append(sc + cc)
        return {"values": nvals, "counts": ncnts}, torch.zeros(
            (), dtype=torch.bool, device=self.device
        )

    # === result assembly =================================================

    def _finish(self, state, meta) -> Result:
        if self.agg.step == "partial":
            return self._finish_partial(state, meta)
        return self._finish_single(state, meta)

    def _key_columns(self, state, meta) -> list[Column]:
        return [
            Column(
                ksym.type,
                state["key_data"][i].to(torch_dtype(ksym.type.storage_dtype)),
                state["key_valid"][i],
                meta["key_dicts"][i],
            )
            for i, ksym in enumerate(self.agg.group_keys)
        ]

    def _finish_partial(self, state, meta) -> Result:
        """The partial aggregate's accumulator rows: keys, then per
        aggregate its value (limb sums as wide (hi, lo)) and count; G rows
        a shard (N x G, reference ``:1030-1049``), one a shard without
        group keys."""
        agg = self.agg
        cols: list[Column] = []
        layout: dict[str, int] = {}
        if self.nkeys:
            cols = self._key_columns(state, meta)
            layout = {k.name: i for i, k in enumerate(agg.group_keys)}
            live, total = state["live"], self.n * self.G
        else:
            total = self.n
            live = torch.ones(total, dtype=torch.bool, device=self.device)
        for (vsym, csym), spec, v, c, sdict in zip(
            agg.acc_symbols, meta["specs"], state["values"], state["counts"],
            meta["string_dicts"],
        ):
            if spec.kind in ("count", "count_star"):
                cols.append(Column(T.BIGINT, v.reshape(-1)))
                layout[vsym.name] = len(cols) - 1
                continue
            if sdict is not None:  # a VARCHAR min/max: the code travels
                codes = torch.where(c > 0, v, -1).to(torch.int32)
                cols.append(Column(vsym.type, codes, c > 0, sdict))
            else:
                cols.append(Column(vsym.type, _limbs_to_wide(v)))
            layout[vsym.name] = len(cols) - 1
            cols.append(Column(T.BIGINT, c))
            layout[csym.name] = len(cols) - 1
        return Result(Batch(cols, total, live, self.device, shards=self.n), layout)

    def _finish_single(self, state, meta) -> Result:
        agg = self.agg
        sdicts = meta["string_dicts"]
        results = [
            v if spec.kind in ("count", "count_star")
            # a VARCHAR min/max carries codes; finalize takes ranks
            else (v if sd is None else rank_codes(sd, v), c)
            for spec, v, c, sd in zip(
                meta["specs"], state["values"], state["counts"], sdicts
            )
        ]
        layout = {s.name: i for i, s in enumerate(agg.output_symbols)}
        if self.nkeys:
            cols = self._key_columns(state, meta) + finalize_aggs(agg, results, sdicts)
            return Result(Batch(cols, self.G, state["live"]), layout)
        cols = finalize_aggs(agg, results, sdicts)
        return Result(
            Batch(cols, 1, torch.ones(1, dtype=torch.bool, device=self.device)),
            layout,
        )


# === host-side batch helpers ================================================


def _slice_rows(b: Batch, lo: int, hi: int) -> Batch:
    cols = [
        Column(
            c.type, c.data[lo:hi],
            None if c.valid is None else c.valid[lo:hi], c.dictionary,
        )
        for c in b.columns
    ]
    return Batch(cols, hi - lo, None if b.sel is None else b.sel[lo:hi])


def _place_by_shard(groups: dict, n: int, g: int, overflow):
    """Groups of all shards, shard by shard (the shard their leading key
    column), placed G = ``g`` a shard, shard-major: group ``i`` of shard
    ``s`` goes to row ``s * g + i``. Returns the placed state and the
    overflow flag, set where a shard has more than ``g`` groups (its
    groups past ``g`` are dropped)."""
    shard, live = groups["key_data"][0], groups["live"]
    total = n * g
    at = torch.where(live, shard, n)
    per = torch.zeros(n + 1, dtype=torch.int64, device=live.device)
    per = per.scatter_add_(0, at, torch.ones_like(at))[:n]
    starts = torch.cumsum(per, 0) - per
    rank = torch.arange(total, device=live.device) - starts[shard.clamp(0, n - 1)]
    kept = live & (rank < g)
    slot = torch.where(kept, shard * g + rank, total)

    def place(x):
        out = x.new_zeros((total + 1,) + tuple(x.shape[1:]))
        out[slot] = x
        return out[:total]

    placed = {
        "key_data": [place(x) for x in groups["key_data"][1:]],
        "key_valid": [place(x) for x in groups["key_valid"][1:]],
        "live": place(kept),
        "values": [place(x) for x in groups["values"]],
        "counts": [place(x) for x in groups["counts"]],
    }
    return placed, overflow | (per > g).any()


def _empty_like(b: Batch) -> Batch:
    """A part of no rows with ``b``'s columns: the padding of a short last
    step (reference ``_empty_like``)."""
    cols = [
        Column(c.type, c.data[:0], None, c.dictionary) for c in b.columns
    ]
    return Batch(cols, 0)


def _pad_batch(piece: Batch, cap: int) -> Batch:
    """A piece padded with dead rows to exactly ``cap`` rows, its live
    rows in the selection mask, so every chunk has one shape."""
    cols = []
    for c in piece.columns:
        pad = cap - c.data.shape[0]
        data = torch.cat([c.data, c.data.new_zeros((pad,) + tuple(c.data.shape[1:]))])
        valid = c.valid
        if valid is not None:
            valid = torch.cat([valid, valid.new_zeros(pad)])
        cols.append(Column(c.type, data, valid, c.dictionary))
    live = torch.arange(cap) < piece.num_rows
    if piece.sel is not None:
        live[: piece.sel.shape[0]] &= piece.sel
    return Batch(cols, cap, live)
