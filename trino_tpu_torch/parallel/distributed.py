"""The distributed (mesh) executor and its join step.

Counterpart of ``trino_tpu/parallel/distributed.py``: Trino's distributed
execution (stages over workers, ``SqlQueryScheduler.java:538``;
partitioned and broadcast joins, ``DetermineJoinDistributionType.java``;
the partial/final aggregation split). On a mesh of N shards
(``parallel/mesh.py``, all shards on one device):

- scans: splits assigned round-robin to the shards (SOURCE_DISTRIBUTION);
- filter/project: elementwise over the shard-major global columns;
- aggregation: a partial group-by a shard, then the final combine over
  the partials (Trino's combine step);
- joins: broadcast (the build side all-gathered) or partitioned (both
  sides hash-repartitioned, with skew handling), chosen by size, then
  :func:`_sharded_probe`: each shard builds a table from its (replicated
  or co-partitioned) build side and probes its own rows into a fixed
  capacity; the overflow flags are reduced with ``pmax``;
- sort, topN, limit and output: over the gathered global columns
  (SINGLE_DISTRIBUTION).

The join step itself is two functions, :func:`build_join` and
:func:`probe_build`, so that a streamed fragment builds each join's
table once and probes it with every chunk (``exec/streaming.py``); a
materialized join calls one after the other, once a shard.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, bucket_capacity, concat_batches
from trino_tpu_torch.exec.local import (
    ExecutionError,
    LocalExecutor,
    Result,
    agg_inputs_for,
    finalize_aggs,
)
from trino_tpu_torch.ops import dense_join as DJ
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops.aggregation import AggSpec, group_aggregate
from trino_tpu_torch.parallel import exchange as X
from trino_tpu_torch.parallel import mesh as M
from trino_tpu_torch.planner import plan as P


def _pad_side(cols, keys, h, sel):
    """Kernels reject 0-row arrays: an empty relation becomes one
    unselected row."""
    if h.shape[0] > 0:
        return cols, keys, h, sel
    cols = [c.new_zeros((1,) + tuple(c.shape[1:])) for c in cols]
    keys = [k.new_zeros((1,) + tuple(k.shape[1:])) for k in keys]
    return cols, keys, h.new_zeros(1), sel.new_zeros(1)


@dataclasses.dataclass
class JoinBuild:
    """A join's build side, made once and probed by any number of probe
    batches (reference: ``HashBuilderOperator``/``LookupJoinOperator``,
    build once and probe streamed): the padded build payload and key
    columns, their hash and liveness, and the strategy's structure, the
    hash-sorted build for ``sort`` or the open-addressing table (kernel
    K2) for ``dense`` and ``matmul``."""

    cols: list
    key_pairs: list
    bh: torch.Tensor
    strategy: str
    sorted_keys: Optional[torch.Tensor] = None
    sorted_idx: Optional[torch.Tensor] = None
    count: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None
    table_overflow: Optional[torch.Tensor] = None
    kmin: Optional[torch.Tensor] = None


def build_join(build_cols, build_keys, bh, build_sel, nlk, strategy="sort",
               table_cap=None) -> JoinBuild:
    """The build step: ``build_cols`` and ``build_keys`` are flat
    (data, valid) lists of the payload and of the ``nlk`` key columns,
    ``bh`` the keys' hash. ``strategy`` picks the join kernel: ``sort``
    (ops/join.py: the live rows sorted by hash, probed by binary search),
    ``dense`` (ops/dense_join.py: an open-addressing table of
    ``table_cap`` slots, built by kernel K2) or ``matmul`` (the same
    table addressed by identity binning of the single integer key
    column; the caller gates it on ``nlk == 1`` and an integer key
    dtype)."""
    build_cols, build_keys, bh, build_sel = _pad_side(build_cols, build_keys, bh, build_sel)
    key_pairs = [(build_keys[2 * k], build_keys[2 * k + 1]) for k in range(nlk)]
    bv = torch.ones_like(build_sel)
    for _, kv in key_pairs:
        bv = bv & kv
    out = JoinBuild(build_cols, key_pairs, bh, strategy)
    if strategy == "sort":
        out.sorted_keys, out.sorted_idx, out.count = J.build_side(bh, bv, build_sel)
        return out
    if strategy == "matmul":
        out.kmin = torch.where(
            bv & build_sel, key_pairs[0][0].to(torch.int64), 2**63 - 1
        ).min()
        bbase = DJ.slot_base_binned(key_pairs[0][0], out.kmin, table_cap)
    else:
        bbase = DJ.slot_base_hash(bh, table_cap)
    out.table, out.table_overflow = DJ.build_table(bbase, bv, build_sel, table_cap)
    return out


def probe_build(build: JoinBuild, probe_cols, probe_keys, ph, probe_sel,
               per_shard_cap, join_type):
    """The probe step: probe rows against a :class:`JoinBuild`, their
    matches expanded into ``per_shard_cap`` output slots (None: sized to
    the matches, one host read; ``out_sel.shape[0]`` is then the capacity
    chosen), the real keys re-checked and the payloads gathered.
    ``probe_cols``/``probe_keys`` are flat (data, valid) lists like the
    build's.

    Returns ``(out_cols, out_sel, overflow, table_overflow, total)``:
    ``out_cols`` the probe payload then the build payload, flat (data,
    valid); ``table_overflow`` the build's flag, whose ``densejoin``
    capacity site the executor's retry ladder doubles (None for the sort
    strategy); ``total`` the count of matches the output needed, so an
    overflowed output grows to fit them at once."""
    probe_cols, probe_keys, ph, probe_sel = _pad_side(probe_cols, probe_keys, ph, probe_sel)
    pk_pairs = [(probe_keys[2 * k], probe_keys[2 * k + 1])
                for k in range(len(build.key_pairs))]
    pv = torch.ones_like(probe_sel)
    for _, kv in pk_pairs:
        pv = pv & kv
    jt = "left" if join_type == "LEFT" else "inner"
    if build.strategy == "sort":
        ppos, bpos, osel, total, ovf = J.probe_join(
            build.sorted_keys, build.sorted_idx, build.count, ph, pv, probe_sel,
            per_shard_cap, jt,
        )
    else:
        cap = build.table.shape[0]
        if build.strategy == "matmul":
            pbase = DJ.slot_base_binned(pk_pairs[0][0], build.kmin, cap)
        else:
            pbase = DJ.slot_base_hash(ph, cap)
        ppos, bpos, osel, total, ovf = DJ.probe_table(
            build.table, build.bh, pbase, ph, pv, probe_sel, per_shard_cap, jt,
        )
    osel = J.verify_equal(pk_pairs, build.key_pairs, ppos, bpos, osel)
    is_outer = bpos == J.MISSING
    pidx = ppos.long()
    bidx = torch.where(is_outer, 0, bpos).long()
    outs = []
    for k in range(0, len(probe_cols), 2):
        outs.append(probe_cols[k][pidx])
        outs.append(probe_cols[k + 1][pidx])
    for k in range(0, len(build.cols), 2):
        outs.append(build.cols[k][bidx])
        outs.append(build.cols[k + 1][bidx] & ~is_outer)
    return outs, osel, ovf, build.table_overflow, total


def _is_sharded(batch: Batch) -> bool:
    """Rows split over more than one shard (reference :859)."""
    return batch.shards > 1


def _pad_shards(cols, keys, h, sel, n: int):
    """An empty relation as one unselected row a shard (reference
    ``pad_side``): the per-shard kernels take no 0-row operand."""
    if h.shape[0] > 0:
        return cols, keys, h, sel
    cols = [c.new_zeros((n,) + tuple(c.shape[1:])) for c in cols]
    keys = [k.new_zeros((n,) + tuple(k.shape[1:])) for k in keys]
    return cols, keys, h.new_zeros(n), sel.new_zeros(n)


def _sharded_probe(mesh, probe_cols, probe_keys, ph, probe_sel, build_cols, build_keys,
                   bh, build_sel, per_shard_cap, join_type, nlk, build_sharded=False,
                   strategy="sort", table_cap=None, build=None):
    """The per-shard join (reference :883-1041): each shard builds its
    table from the build side (its own slice when ``build_sharded``, the
    whole replicated side otherwise; K2 builds it on the dense and matmul
    tiers, once a shard), probes its own rows and expands the matches
    into ``per_shard_cap`` slots. ``per_shard_cap`` None sizes each shard
    to its matches (one host read a shard) and pads the shards to the
    largest. ``build``, a :class:`JoinBuild` of the whole replicated
    side made once (a streamed chunk's joins), is probed by every shard
    instead; the build arguments are then unused.

    Returns ``(out_cols, out_sel, overflow, table_overflow, total)``:
    global shard-major output columns (probe payload then build payload,
    flat (data, valid)) of ``n * cap`` rows, the flags' ``pmax`` over the
    shards (``table_overflow`` None on the sort tier) and the largest
    shard's match count."""
    n = mesh.size
    probe_cols, probe_keys, ph, probe_sel = _pad_shards(
        list(probe_cols), list(probe_keys), ph, probe_sel, n)
    if build is None:
        build_cols, build_keys, bh, build_sel = _pad_shards(
            list(build_cols), list(build_keys), bh, build_sel, n)

    def local(xs, s, sharded=True):
        return [M.shard_view(x, n)[s] if sharded else x for x in xs]

    shards = []
    for s in range(n):
        b = build if build is not None else build_join(
            local(build_cols, s, build_sharded), local(build_keys, s, build_sharded),
            *local([bh, build_sel], s, build_sharded), nlk, strategy, table_cap,
        )
        shards.append(probe_build(
            b, local(probe_cols, s), local(probe_keys, s), *local([ph, probe_sel], s),
            per_shard_cap, join_type,
        ))
    cap = max(o[1].shape[0] for o in shards)
    outs = []
    for k in range(len(shards[0][0])):
        outs.append(torch.cat([_pad_to(o[0][k], cap) for o in shards]))
    osel = torch.cat([_pad_to(o[1], cap) for o in shards])
    ovf = M.pmax(torch.stack([o[2].reshape(()).to(torch.int32) for o in shards]))
    tovf = None
    if shards[0][3] is not None:
        tovf = M.pmax(torch.stack([o[3].reshape(()).to(torch.int32) for o in shards]))
    total = M.pmax(torch.stack([o[4].reshape(()).to(torch.int64) for o in shards]))
    return outs, osel, ovf, tovf, total


def _pad_to(x: torch.Tensor, cap: int) -> torch.Tensor:
    if x.shape[0] == cap:
        return x
    return torch.cat([x, x.new_zeros((cap - x.shape[0],) + tuple(x.shape[1:]))])


class DistributedExecutor(LocalExecutor):
    """Executes logical plans over a mesh of N shards (reference :40):
    sharded scans, partial/final aggregation and broadcast or partitioned
    joins; every other node runs its local version over the shard-major
    global columns, which is the same relation. ``exchange_stats`` are
    the query's exchange counters (``exchangeStats``)."""

    def __init__(self, catalogs, session, device, mesh: Optional[M.Mesh] = None,
                 memory_ctx=None):
        super().__init__(catalogs, session, device, memory_ctx=memory_ctx)
        self.mesh = mesh if mesh is not None else M.Mesh([self.device])
        if self.mesh.device != self.device:
            raise NotImplementedError(
                f"a mesh on {self.mesh.device} for an engine on {self.device}")
        self.exchange_stats: dict = {
            "exchanges": 0, "shuffle_rows": 0, "padded_shuffle_rows": 0,
            "shuffle_bytes": 0, "hot_keys": 0, "salted_rows": 0,
            "overflow_retries": 0,
        }
        self.table_cache = None
        self._shards: dict[int, int] = {}
        # device profiling (obs/profiler.py): per-program allocator stats
        # by a stable program label; the fragment executor records its
        # captured programs, this interpreter its eager partial
        # aggregates (_profiled_call: their allocator numbers on a card,
        # executions only on the CPU; nothing is compiled)
        self.device_stats: dict[str, dict] = {}
        self._device_profiling = bool(session.get("device_profiling"))

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    # === device profiling (reference :88-124) ============================

    def _record_device_stats(self, label: str, ds: Optional[dict] = None,
                             compile_ms: float = 0.0) -> None:
        """Fold one program execution into the per-query map and set the
        per-program gauge. ``ds`` is the program's captured stats, None
        where nothing was captured."""
        ent = self.device_stats.setdefault(label, {"executions": 0, "compile_ms": 0.0})
        ent["executions"] += 1
        if compile_ms:
            ent["compile_ms"] = round(ent["compile_ms"] + compile_ms, 3)
        for k, v in (ds or {}).items():
            ent[k] = v
        if ds and "peak_hbm_bytes" in ds:
            from trino_tpu_torch.obs.metrics import get_registry

            get_registry().gauge(
                "trino_tpu_program_peak_hbm_bytes", fragment=label
            ).set(ds["peak_hbm_bytes"])

    def _profiled_call(self, label: str, fn, *args):
        """Run one eager step of the interpreter (reference :126-160);
        with ``device_profiling`` on, its execution and the allocator's
        numbers (``obs/profiler.py::profiled_call``: argument, output and
        peak bytes on a card; executions only on the CPU) land in
        ``device_stats[label]``."""
        if not self._device_profiling:
            return fn(*args)
        from trino_tpu_torch.obs.profiler import profiled_call

        result, ds = profiled_call(self.device, fn, *args)
        self._record_device_stats(label, ds)
        return result

    def device_stats_snapshot(self) -> Optional[dict]:
        """The query's device-profiling rollup (``deviceStats``), None
        when no program was recorded."""
        if not self.device_stats:
            return None
        from trino_tpu_torch.obs.profiler import rollup_device_stats

        snap = rollup_device_stats(self.device_stats)
        snap["programs"] = {k: dict(v) for k, v in self.device_stats.items()}
        return snap

    def _exec(self, node: P.PlanNode) -> Result:
        res = super()._exec(node)
        n = self.n_shards
        # row-preserving nodes keep their source's sharding
        if (n > 1 and res.batch.shards == 1 and isinstance(node, (P.Filter, P.Project))
                and self._shards.get(id(node.source)) == n and res.batch.capacity % n == 0):
            res.batch.shards = n
        self._shards[id(node)] = res.batch.shards
        return res

    # === scan: splits round-robin over the shards (reference :163) =========

    def _scan_splits(self, node: P.TableScan):
        if self.n_shards == 1:
            return super()._scan_splits(node)
        return self.catalogs.get(node.catalog).get_splits(
            node.schema, node.table, target_splits=self.n_shards * 4,
            constraint=node.constraint,
        )

    def _exec_tablescan(self, node: P.TableScan, splits=None) -> Result:
        if self.n_shards == 1:
            return super()._exec_tablescan(node, splits)
        return self._sharded_scan(node, splits)

    def _sharded_scan(self, node: P.TableScan, splits=None) -> Result:
        """Splits (``target_splits = n * 4``) assigned to shard ``i mod n``
        in split order, each shard's splits concatenated, the shards
        padded to one capacity (``mesh.shard_batch``) and copied to the
        device in one copy; a scan whose constraint pruned every split is
        one unselected row a shard."""
        connector = self.catalogs.get(node.catalog)
        n = self.n_shards
        layout = {s.name: i for i, s in enumerate(node.symbols)}
        if splits is None:
            splits = self._scan_splits(node)
        if not splits:
            from trino_tpu_torch.columnar import Dictionary, torch_dtype

            cols = []
            for s in node.symbols:
                wide = isinstance(s.type, T.DecimalType) and s.type.wide
                data = torch.zeros((n, 2) if wide else n,
                                   dtype=torch_dtype(s.type.storage_dtype), device=self.device)
                cols.append(Column(s.type, data, None,
                                   Dictionary([]) if T.is_string(s.type) else None))
            sel = torch.zeros(n, dtype=torch.bool, device=self.device)
            return Result(Batch(cols, n, sel, self.device, shards=n), layout)
        from trino_tpu_torch.obs.trace import get_tracer

        t0 = time.perf_counter()
        per_shard: list[list[Batch]] = [[] for _ in range(n)]
        reader = self._read_splits(connector, node.schema, node.table, node.column_names, splits)
        for i, b in enumerate(reader):
            per_shard[i % n].append(b)
        reader.close()
        get_tracer().record(
            "ingest.decode", (time.perf_counter() - t0) * 1000.0,
            attrs={"table": node.table, "splits": len(splits)},
        )
        proto = next(b for bs in per_shard for b in bs)
        parts = []
        for bs in per_shard:
            if bs:
                parts.append(concat_batches(bs) if len(bs) > 1 else bs[0])
            else:
                cols = [Column(c.type, c.data[:0], None, c.dictionary) for c in proto.columns]
                parts.append(Batch(cols, 0, None, proto.device))
        return Result(M.shard_batch(self.mesh, parts, self._to_device), layout)

    # === partial/final aggregation (reference :292-576) ====================

    def _exec_aggregate(self, node: P.Aggregate) -> Result:
        res = self._exec(node.source)
        if not _is_sharded(res.batch) or node.step != "single" or any(
            fn.distinct or fn.kind == "array_agg" for _, fn in node.aggregates
        ):
            # DISTINCT and array_agg need a global view, and a partial or
            # final step of a fragmented plan is already split: the local
            # step over the global columns
            return self._local_aggregate(node, res)
        agg_inputs, specs, sdicts = self._prepare_agg_inputs(node, res)
        if any(s.kind not in ("count", "count_star", "sum", "avg", "min", "max")
               for s in specs) or any(
            isinstance(k.type, T.DecimalType) and k.type.wide for k in node.group_keys
        ):
            # 128-bit limb sums and wide keys: the single step is exact
            return self._local_aggregate(node, res)
        if not node.group_keys:
            return self._global_agg_distributed(node, res, agg_inputs, specs, sdicts)
        keys = [res.opt_pair(k) for k in node.group_keys]
        key_dicts = [res.column(k).dictionary for k in node.group_keys]
        return self._partial_final_agg(node, keys, key_dicts, res.batch.selection_mask(),
                                       agg_inputs, specs, sdicts, 1 << 12)

    def _local_aggregate(self, node: P.Aggregate, res: Result) -> Result:
        if node.step == "partial":
            return self._aggregate_partial(node, res)
        if node.step == "final":
            return self._aggregate_final(node, res)
        return self._aggregate_single(node, res)

    def _prepare_agg_inputs(self, node: P.Aggregate, res: Result):
        """(inputs, specs, string dictionaries) of the partial step
        (reference :425): ``exec/local.py::agg_inputs_for``."""
        return agg_inputs_for(node, res)

    def _partial_final_agg(self, node, keys, key_dicts, sel, agg_inputs, specs, sdicts, G):
        """A partial group-by of ``G`` groups a shard (``G`` x 4 while a
        shard overflows; one host read a pass), then
        :meth:`_final_combine` of the ``n * G`` partial rows."""
        n = self.n_shards
        while True:
            (kd, kv), raw, ng, ovf = self._profiled_call(
                "partial_agg", M.smap,
                lambda k, s, i: group_aggregate(k, s, i, specs, G),
                self.mesh, [keys, sel, agg_inputs],
            )
            if not bool(M.pmax(ovf.to(torch.int32))):
                break
            if G > (1 << 24):
                raise ExecutionError("per-shard group cardinality too large")
            G <<= 2
        live = (torch.arange(G, device=self.device).unsqueeze(0) < ng.unsqueeze(1)).reshape(-1)
        return self._final_combine(node, kd, kv, raw, live, key_dicts, sdicts)

    def _final_combine(self, node, kd, kv, raw, live, key_dicts, sdicts) -> Result:
        """Combine the shards' partial rows (Trino's combine step,
        reference :460): counts sum; sums and averages sum their values
        and counts; min/max take the min/max of the non-empty partials."""
        inputs, cspecs = [], []
        for (_, fn), r in zip(node.aggregates, raw):
            if fn.kind in ("count", "count_star"):
                inputs.append((r.to(torch.int64), None))
                cspecs.append(AggSpec("sum"))
                continue
            v, c = r
            inputs.append((v, c > 0))
            cspecs.append(AggSpec("sum" if fn.kind in ("sum", "avg") else fn.kind))
            inputs.append((c, None))
            cspecs.append(AggSpec("sum"))
        keys = list(zip(kd, kv))
        (fkd, fkv), fres, ng = self._grouped(keys, live, inputs, cspecs)
        results, j = [], 0
        for _, fn in node.aggregates:
            if fn.kind in ("count", "count_star"):
                results.append(fres[j][0][:ng])
                j += 1
            else:
                results.append((fres[j][0][:ng], fres[j + 1][0][:ng]))
                j += 2
        cols = []
        for i, k in enumerate(node.group_keys):
            from trino_tpu_torch.columnar import torch_dtype

            valid = fkv[i][:ng]
            cols.append(Column(k.type, fkd[i][:ng].to(torch_dtype(k.type.storage_dtype)),
                               None if bool(valid.all()) else valid, key_dicts[i]))
        cols.extend(finalize_aggs(node, results, sdicts))
        return Result(Batch(cols, ng, None, self.device),
                      {s.name: i for i, s in enumerate(node.output_symbols)})

    def _global_agg_distributed(self, node, res, agg_inputs, specs, sdicts) -> Result:
        """An aggregate without GROUP BY: a constant key through the grouped
        path (``G`` = 8), then the key dropped; no row anywhere gives the
        one row of empty aggregates (reference :531)."""
        dummy = P.Symbol(P.fresh_name("g0"), T.BIGINT)
        node2 = P.Aggregate(node.source, [dummy], node.aggregates, node.step)
        zero = torch.zeros(res.batch.capacity, dtype=torch.int64, device=self.device)
        out = self._partial_final_agg(node2, [(zero, None)], [None],
                                      res.batch.selection_mask(), agg_inputs, specs, sdicts, 8)
        b = out.batch
        layout = {s.name: i for i, (s, _) in enumerate(node.aggregates)}
        if b.num_rows == 0:
            from trino_tpu_torch.ops.aggregation import global_aggregate

            empty = torch.zeros(1, dtype=torch.bool, device=self.device)
            raw = global_aggregate(empty, [None if p is None else (p[0][:1], p[1] if p[1] is None
                                                                   else p[1][:1])
                                           for p in agg_inputs], specs)
            return Result(Batch(finalize_aggs(node, raw, sdicts), 1, None, self.device), layout)
        return Result(Batch(b.columns[1:], b.num_rows, None, self.device), layout)

    # === joins (reference :577-857) ========================================

    def _exec_join(self, node: P.Join) -> Result:
        if (node.join_type in ("CROSS", "SEMI", "ANTI", "RIGHT", "FULL")
                or (node.join_type == "LEFT" and node.filter is not None)
                or node.single_row or not node.criteria):
            return LocalExecutor._exec_join(self, node)
        right = self._exec(node.right)  # build first: enables dynamic filter
        left = self._exec(self._apply_dynamic_filters(node, right))
        if not (_is_sharded(left.batch) or _is_sharded(right.batch)):
            return self._join_result(node, left, right)
        lkeys, rkeys = self._join_keys(left, right, node.criteria)
        ph, _ = J.hash_keys(lkeys)
        bh, _ = J.hash_keys(rkeys)
        forced = self.session.get("join_distribution_type")
        broadcast = right.batch.count_rows() <= int(self.session.get("broadcast_join_threshold_rows"))
        if forced == "PARTITIONED":
            broadcast = False
        elif forced == "BROADCAST":
            broadcast = True
        if node.distribution == "partitioned":
            broadcast = False
        elif node.distribution == "replicated":
            broadcast = True
        if broadcast:
            return self._broadcast_join(node, left, right, lkeys, rkeys, ph, bh)
        return self._partitioned_join(node, left, right, lkeys, rkeys, ph, bh)

    @staticmethod
    def _flatten(side_node, side: Result, keys, khash):
        arrays, schema = [], []
        for s in side_node.output_symbols:
            c = side.column(s)
            arrays += [c.data, c.valid_mask()]
            schema.append((s, c.dictionary))
        key_arrays = []
        for kd, kv in keys:
            key_arrays += [kd, kv]
        return arrays, key_arrays, schema

    def _probe_loop(self, node, left, right, lschema, rschema, probe, build, per_shard_cap,
                    build_sharded) -> Result:
        """:func:`_sharded_probe` until no shard overflows its output (the
        capacity doubles; one host read a pass), then the join's columns
        and its ON filter."""
        while True:
            outs, osel, ovf, _, _ = _sharded_probe(
                self.mesh, *probe, *build, per_shard_cap, node.join_type, len(probe[1]) // 2,
                build_sharded=build_sharded,
            )
            if not bool(ovf):
                break
            per_shard_cap <<= 1
        cols, layout, i = [], {}, 0
        for s, d in lschema + rschema:
            cols.append(Column(s.type, outs[i], outs[i + 1], d))
            layout[s.name] = len(cols) - 1
            i += 2
        total = outs[0].shape[0]
        result = Result(Batch(cols, total, osel, self.device, shards=self.n_shards), layout)
        if node.filter is not None:
            from trino_tpu_torch.exec.local import bound_filter_mask

            expr = self._bind(node.filter, layout)
            mask = bound_filter_mask(expr, cols, self.device, self.params)
            result = Result(Batch(cols, total, mask & osel, self.device,
                                  shards=self.n_shards), layout)
        return result

    def _broadcast_join(self, node, left, right, lkeys, rkeys, ph, bh) -> Result:
        """The build side all-gathered to every shard, each shard probing
        its own rows (reference :619)."""
        n = self.n_shards
        left = Result(M.as_sharded(left.batch, n), left.layout)
        barr, bkeys, rschema = self._flatten(node.right, right, rkeys, bh)
        rep, bsel = X.broadcast_all(self.mesh, barr + bkeys + [bh], right.batch.selection_mask())
        nb, nk = len(barr), len(bkeys)
        parr, pkeys, lschema = self._flatten(node.left, left, [
            tuple(M.pad_rows_to(x, n, False if x.dtype == torch.bool else 0) for x in kp)
            for kp in lkeys], ph)
        ph = M.pad_rows_to(ph, n)
        probe_rows = left.batch.count_rows()
        per_shard_cap = bucket_capacity(max(1024, (probe_rows * 3) // n))
        probe = (parr, pkeys, ph, left.batch.selection_mask())
        build = (rep[:nb], rep[nb:nb + nk], rep[nb + nk], bsel)
        return self._probe_loop(node, left, right, lschema, rschema, probe, build,
                                per_shard_cap, False)

    def _partitioned_join(self, node, left, right, lkeys, rkeys, ph, bh) -> Result:
        """Both sides repartitioned by the join keys' hash, then a
        shard-local join (reference :694); with ``skew_handling``, INNER and
        LEFT joins take the hybrid exchange."""
        mesh, n = self.mesh, self.n_shards

        def side(res, side_node, keys, khash):
            arrays, key_arrays, schema = self._flatten(side_node, res, keys, khash)
            flat = [M.pad_rows_to(a, n, False if a.dtype == torch.bool else 0)
                    for a in arrays + key_arrays + [khash]]
            return flat, schema, M.pad_rows_to(res.batch.selection_mask(), n, False)

        larrs, lschema, lsel = side(left, node.left, lkeys, ph)
        rarrs, rschema, rsel = side(right, node.right, rkeys, bh)
        hybrid = None
        if node.join_type in ("INNER", "LEFT") and bool(self.session.get("skew_handling")):
            hybrid = self._hybrid_repartition(mesh, larrs, lsel, rarrs, rsel)
        if hybrid is not None:
            lout, lsel2, rout, rsel2 = hybrid
        else:
            # exact buckets: one counting pass beats overflow retries
            lb = bucket_capacity(X.needed_bucket(mesh, larrs[-1], lsel), minimum=8)
            rb = bucket_capacity(X.needed_bucket(mesh, rarrs[-1], rsel), minimum=8)
            lout, lsel2, lovf = X.hash_repartition(mesh, larrs, larrs[-1], lsel, lb)
            rout, rsel2, rovf = X.hash_repartition(mesh, rarrs, rarrs[-1], rsel, rb)
            assert not bool(lovf) and not bool(rovf)
            st = self.exchange_stats
            st["exchanges"] += 2
            st["padded_shuffle_rows"] += n * n * (lb + rb)
            st["shuffle_rows"] += int(lsel.sum()) + int(rsel.sum())
        nl, nr = 2 * len(lschema), 2 * len(rschema)
        probe = (lout[:nl], lout[nl:-1], lout[-1], lsel2)
        build = (rout[:nr], rout[nr:-1], rout[-1], rsel2)
        per_shard_cap = bucket_capacity(
            max(1024, 2 * (left.batch.count_rows() + right.batch.count_rows()) // n))
        return self._probe_loop(node, left, right, lschema, rschema, probe, build,
                                per_shard_cap, True)

    def _hybrid_repartition(self, mesh, larrs, lsel, rarrs, rsel):
        """The skew-aware exchange of a partitioned join (reference :811):
        heavy hitters detected over the probe side's key hashes, hot probe
        rows kept on their shard, the hot build slice replicated, the cold
        rest repartitioned through exactly sized two-tier buckets. None
        when no key is hot."""
        from trino_tpu_torch.ops import skew as SK

        k = max(1, int(self.session.get("skew_hot_k")))
        frac = float(self.session.get("skew_hot_threshold_frac"))
        hh, hv, n_hot, _ = SK.hot_key_hashes(mesh, larrs[-1], lsel, k, frac)
        n_hot = int(n_hot)
        if n_hot == 0:
            return None
        lcold, lhot = X.skew_split_counts(mesh, larrs[-1], lsel, hh, hv)
        rcold, rhot = X.skew_split_counts(mesh, rarrs[-1], rsel, hh, hv)
        lb, rb = bucket_capacity(lcold, minimum=8), bucket_capacity(rcold, minimum=8)
        lhot_cap = bucket_capacity(lhot, minimum=8)
        rhot_cap = bucket_capacity(rhot, minimum=8)
        # cold buckets are exact, so the spill tier is minimal
        lout, lsel2, lflags, lcnt, _ = X.skewed_repartition(
            mesh, larrs, larrs[-1], lsel, lb, 8, hot_mode="local", hot_cap=lhot_cap,
            hot_set=(hh, hv))
        rout, rsel2, rflags, rcnt, _ = X.skewed_repartition(
            mesh, rarrs, rarrs[-1], rsel, rb, 8, hot_mode="replicate", hot_cap=rhot_cap,
            hot_set=(hh, hv))
        words = torch.stack([*lflags, *rflags]).tolist() + torch.stack(
            [lcnt[0], lcnt[1], rcnt[0], rcnt[1]]).tolist()
        assert not any(words[:4])
        n = mesh.size
        st = self.exchange_stats
        st["exchanges"] += 2
        st["hot_keys"] += n_hot
        st["shuffle_rows"] += int(words[4]) + int(words[6])
        st["salted_rows"] += int(words[5]) + int(words[7])
        st["padded_shuffle_rows"] += n * (n * lb + 8) + n * (n * rb + 8 + rhot_cap)
        return lout, lsel2, rout, rsel2

    def exchange_stats_snapshot(self) -> dict:
        st = dict(self.exchange_stats)
        st["padding_ratio"] = round(
            st.get("padded_shuffle_rows", 0) / max(1, st.get("shuffle_rows", 0)), 4)
        return st
