"""Fragmented execution of a distributed plan over a mesh of N shards.

Counterpart of ``trino_tpu/exec/fragments.py``: the plan is cut into
fragments at its exchanges (``planner/fragmenter.py``) and the fragments
run leaves first, each consumer reading its producers' results through
``RemoteSource`` nodes. On a mesh of N > 1 shards (``parallel/mesh.py``,
every shard on the engine's device) the columns are shard-major global
tensors: scans split over the shards, partial and final aggregates,
partial TopN and INNER/LEFT equi-joins run once a shard, and each
fragment's output exchange runs in its program as collectives
(``apply_output_exchange``: hash, with the skew handling of a
partitioned join's two sides, or broadcast); a gather, and every exchange
on a mesh of one, is the identity.

With ``pipeline_fusion`` on, exchange-connected fragments group into
fused units (``fuse_groups``, the reference's grouping); a unit, or a
fragment alone, whose nodes all run as device work at fixed capacities
(``fragment_fusable``) is one program (``exec/programs.py``): on a card a
CUDA graph of its device work, kept across queries in the store of the
query's program-cache entry under its key and capacity signature, and
replayed by later runs and literal variants (the hoisted literals ride a
parameter tensor). A unit's member fragments run back to back and nothing
is read on the host between them; all its overflow flags, match counts
and operator row counters come back in one host read a run. A fired flag
grows its site and the unit runs again (at most 12 times); an
out-of-memory evicts the pool's least recently used programs, then
halves every capacity.

A scan→(filter|project|join)*→aggregate fragment over a large table streams
(``exec/streaming.py``: the dense group-by kernel over the device-resident
slab, else the sort-based chunk step over the slab or host chunks, under
its own overflow retry; the joins on its probe spine build their tables
once and probe them with every chunk). Completed build fragments prune a
fragment's probe scans first (dynamic filtering); its joins run the dense
open-addressing tier (``ops/dense_join.py``, whose build is kernel K2) or
the sort tier, with fixed output capacities.

Nodes the program path does not take (the reference's fused path does
not trace them either) make their fragment run eagerly through
:class:`_FragmentTracer`, with the local executor's version of the node:
CROSS joins other than a scalar subquery, LEFT joins with a non-equi ON
filter, windows, DISTINCT and set operations. FULL OUTER equi-joins
trace: the probe runs as a LEFT join that carries each build row's id,
and the build rows no probe row matched are appended after it.

A join site sizes its output to its matches on its first run (one host
read) and keeps that capacity; an aggregate site first holds its input's
rows, then the groups it counted. Capacities, programs and the device
table cache outlive the query (see :class:`FragmentedExecutor`). With a
query-history entry (``obs/history.py``) a site no run of this entry has
sized starts at the capacity an earlier run of the fingerprint settled
at (provenance ``history``), so a fresh engine skips the first run's
sizing reads and retries. The reference's stats seeding (``_seed_caps``,
planner estimates as floors) is not carried over: first capacities here
come from the data.

Spans (``obs/trace.py``): ``fragment`` (the fragmentation of a new
entry), ``fragment_execute`` and ``fused_execute`` a unit,
``program_compile`` a capture, ``compile_halving`` a halving and
``device_pull`` the result's read. With ``device_profiling`` on, each
captured program's allocator stats (``obs/profiler.py``) are taken once
at its capture and counted on every run (``device_stats_snapshot``).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, bucket_capacity, torch_dtype
from trino_tpu_torch.exec.local import (
    SCALAR_ROWS_ERROR,
    ExecutionError,
    LocalExecutor,
    Result,
    acc_columns,
    agg_inputs_for,
    append_unmatched_build,
    bound_filter_mask,
    check_join_ported,
    finalize_aggs,
    flipped_right_join,
    join_output,
    mark_column,
    rank_codes,
    with_mark,
)
from trino_tpu_torch.obs.metrics import get_registry
from trino_tpu_torch.obs.trace import get_tracer
from trino_tpu_torch.ops.aggregation import AggSpec, group_aggregate
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.parallel.distributed import DistributedExecutor
from trino_tpu_torch.ops.sort import sort_indices
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import (
    FusedFragment,
    PlanFragment,
    SubPlan,
    filtered_broadcast_fids,
    fragment_plan,
    fuse_groups,
)

MAX_ATTEMPTS = 12


class FusedUnsupported(Exception):
    """A fragment shape the streaming path does not take."""


class CapacityRetryExceeded(ExecutionError):
    """Capacity-overflow retry budget exhausted.

    Carries the failing fragment, the final (grown) capacities, and the
    attempt count. ``retryable=False``: capacity growth is a pure function
    of the data, so a rerun replays the same growth path."""

    retryable = False

    def __init__(self, site: str, fragment_id=None,
                 capacities: Optional[dict] = None, attempts: int = 0):
        self.site = site
        self.fragment_id = fragment_id
        self.capacities = dict(capacities or {})
        self.attempts = attempts
        caps_text = (
            ", ".join(f"{k}={v}" for k, v in sorted(self.capacities.items()))
            or "none recorded"
        )
        super().__init__(
            f"{site} capacity retry limit exceeded"
            f" (fragment={fragment_id if fragment_id is not None else '?'},"
            f" attempts={attempts}, final capacities: {caps_text})"
        )


def grow_or_raise(name: str, caps: "_Caps", needed: Optional[int] = None) -> None:
    """Act on one fired flag: capacity sites grow for a rerun (to at
    least ``needed`` slots when the site counted what it needed); ``err!``
    names are data-dependent runtime errors and fail the query."""
    if name.startswith("err!"):
        if name.endswith(" overflow"):
            raise ArithmeticError(name[4:])
        raise ExecutionError(name[4:])
    caps.grow(name, 4 if name.startswith(("agg", "spill", "hot")) else 2)
    if needed is not None and needed > caps.vals[name]:
        caps.vals[name] = bucket_capacity(needed)


def dup_key_rows(keys, sel) -> torch.Tensor:
    """Per row: its full key appears on more than one selected row
    (reference: ``trino_tpu/exec/fragments.py::_dup_key_rows``). One
    grouping sort puts equal keys side by side; a row equal to a sorted
    neighbour is a duplicate; one scatter restores row order."""
    from trino_tpu_torch.ops import keypack as KP

    n = sel.shape[0]
    s_lanes, perm, s_sel = KP.grouping_sort(keys, sel)
    same_prev = torch.zeros(n, dtype=torch.bool, device=sel.device)
    same_prev[1:] = True
    for lane in s_lanes:
        same_prev[1:] &= lane[1:] == lane[:-1]
    same_prev &= s_sel
    same_next = torch.zeros_like(same_prev)
    same_next[:-1] = same_prev[1:]
    out = torch.zeros_like(same_prev)
    out[perm] = (same_prev | same_next) & s_sel
    return out


class _Caps:
    """Capacity knobs of one fragment, grown on overflow (power-of-two
    buckets).

    Sites are named by kind, fragment id and the node's ordinal in the
    fragment (``join@3#0``, ``densejoin@3#0``), so a name survives the
    plan rewrites of dynamic filtering. ``provenance`` records where each
    value came from (``default``, ``seeded``, ``+grown`` after an overflow
    rerun). ``join_strategies`` is the chosen kernel per dense site. A
    ``densejoin`` site that overflows again after a growth has a
    duplicate-key chain longer than the probe window — doubling can never
    place it (same key, same slot sequence) — so its second growth demotes
    it to the sort strategy."""

    def __init__(self):
        self.vals: dict[str, int] = {}
        self.provenance: dict[str, str] = {}
        self._seed_floor: dict[str, tuple[int, str]] = {}
        self.join_strategies: dict[str, str] = {}
        self.grow_counts: dict[str, int] = {}
        self.demoted: set[str] = set()

    def get(self, name: str, default: int) -> int:
        if name not in self.vals:
            floor = self._seed_floor.pop(name, None)
            if floor is not None and floor[0] > default:
                self.vals[name] = floor[0]
                self.provenance[name] = floor[1]
            else:
                self.vals[name] = default
                self.provenance.setdefault(name, "default")
        return self.vals[name]

    def seed(self, name: str, value: int, floor_only: bool = False,
             provenance: str = "seeded") -> None:
        """Install a starting value. ``floor_only`` seeds take effect only
        when above the site's built-in default; floors are first-wins."""
        if name in self.vals:
            return
        if floor_only:
            if name not in self._seed_floor:
                self._seed_floor[name] = (value, provenance)
        else:
            self.vals[name] = value
            self.provenance[name] = provenance

    def seeded(self, name: str):
        """(value, provenance) of a site's installed value or pending seed
        floor, or None."""
        if name in self.vals:
            return self.vals[name], self.provenance.get(name, "default")
        fl = self._seed_floor.get(name)
        return (fl[0], fl[1]) if fl is not None else None

    def grow(self, name: str, factor: int = 2) -> None:
        self.vals[name] = bucket_capacity(self.vals[name] * factor, minimum=1)
        prev = self.provenance.get(name, "default")
        if not prev.endswith("+grown"):
            self.provenance[name] = prev + "+grown"
        self.grow_counts[name] = self.grow_counts.get(name, 0) + 1
        if name.startswith("densejoin") and self.grow_counts[name] >= 2:
            self.demoted.add(name)

    def signature(self) -> tuple:
        """Hashable view of the capacity values and demotions: the part of
        a fragment run's shapes that the plan cannot show."""
        return tuple(sorted(self.vals.items())) + tuple(sorted(self.demoted))


class _FragmentTracer(LocalExecutor):
    """Executes one fragment's node chain over given inputs: table scans
    and remote sources read batches handed in by the caller (keyed
    ``scan{id(node)}`` / ``remote{fragment_id}``) instead of connectors.
    Joins run at the capacities of ``caps`` and append ``(site, flag)``
    overflow pairs to :attr:`overflows` instead of reading the device."""

    def __init__(self, base: LocalExecutor, inputs, input_layouts,
                 caps: Optional[_Caps] = None, fragment_id: int = 0,
                 root: Optional[P.PlanNode] = None,
                 builds: Optional[dict] = None, params=None,
                 skew: Optional[dict] = None):
        super().__init__(base.catalogs, base.session, base.device)
        # the mesh: on N > 1 shards aggregates, partial topN and joins run
        # once a shard over the shard-major columns, and the fragment's
        # output exchange moves rows between the shards
        self.mesh = getattr(base, "mesh", None)
        self.n = 1 if self.mesh is None else self.mesh.size
        # the output exchange's skew role: {"detect": (k, frac)} on a
        # probe side, {"salt": True, "hotset_key": ...} on a build side
        self.skew = skew or {}
        # exchange wire accounting, static per program run
        self.exchange_static: dict[str, int] = {}
        # the hot-key set a detecting exchange found, for its build peer
        self.aux_out: tuple = ()
        self._inputs = inputs
        self._input_layouts = input_layouts
        self._memo: dict[int, Result] = {}
        self.caps = caps if caps is not None else _Caps()
        self.fragment_id = fragment_id
        self.overflows: list[tuple[str, torch.Tensor]] = []
        # output sites' match counts: an overflowed site grows to fit them
        self.needed: dict[str, torch.Tensor] = {}
        # operator row counters (reference: the op! channel): read with
        # the flags, so they cost no host read of their own
        self.counters: list[tuple[str, torch.Tensor]] = []
        self._op_enabled = bool(base.session.get("operator_stats"))
        self._op_rowcounts: dict[int, torch.Tensor] = {}
        # the parameter tensor of the program's inputs, else the query's
        self.params = params if params is not None else base.params
        # per node: its ordinal among the fragment's nodes of its kind
        # (joins, aggregates, scans, filters), which names its sites
        self._ordinals: dict[int, int] = {}
        if root is not None:
            seen: dict[type, int] = {}
            for n in P.walk_plan(root):
                if isinstance(n, (P.Join, P.Aggregate, P.TableScan, P.Filter)):
                    k = seen.get(type(n), 0)
                    self._ordinals[id(n)] = k
                    seen[type(n)] = k + 1
        # join builds by node, shared by the chunk tracers of one stream
        # attempt (exec/streaming.py) so each join builds its table once;
        # None: every join builds its own. Shared builds keep their key
        # codes: a string key's probe codes are remapped onto the build's
        # dictionary, whatever the probe chunk's dictionary holds.
        self.builds = builds

    def _site(self, kind: str, node: P.PlanNode) -> str:
        return f"{kind}@{self.fragment_id}#{self._ordinals.get(id(node), 0)}"

    def _exec(self, node: P.PlanNode) -> Result:
        key = id(node)
        if key not in self._memo:
            self._memo[key] = super()._exec(node)
            self._op_count(node)
        return self._memo[key]

    # --- operator telemetry (reference: _op_rows/_op_count) ---------------

    def _op_rows(self, node: P.PlanNode) -> torch.Tensor:
        """The selected-row count of a memoized node result, once a node."""
        key = id(node)
        r = self._op_rowcounts.get(key)
        if r is None:
            r = self._memo[key].batch.selection_mask().sum().to(torch.int64)
            self._op_rowcounts[key] = r
        return r

    def _op_count(self, node: P.PlanNode) -> None:
        """Rows into and out of an aggregate, join, scan or filter, under
        its restart-stable site (``agg@3#0``), as two counters."""
        if not self._op_enabled:
            return
        if isinstance(node, P.Aggregate):
            kind = {"partial": "partial-agg", "final": "final-agg"}.get(node.step, "agg")
            site = self._site("agg", node)
        elif isinstance(node, P.Join):
            semi = node.join_type in ("SEMI", "ANTI")
            kind = "semijoin" if semi else "join"
            site = self._site("join", node)
        elif isinstance(node, P.TableScan):
            kind, site = "scan", self._site("scan", node)
        elif isinstance(node, P.Filter):
            kind, site = "filter", self._site("filter", node)
        else:
            return
        if id(node) not in self._ordinals:
            return  # a rewrite's node (a flipped RIGHT join)
        sources = [] if isinstance(node, P.TableScan) else list(node.sources)
        if sources and all(id(s) in self._memo for s in sources):
            rows_in = self._op_rows(sources[0])
            for s in sources[1:]:
                rows_in = rows_in + self._op_rows(s)
        else:
            rows_in = self._op_rows(node)
        self.counters.append((f"op!{kind}!in!{site}", rows_in))
        self.counters.append((f"op!{kind}!out!{site}", self._op_rows(node)))

    # --- aggregates: fixed capacities, no host reads -----------------------

    def _exec_aggregate(self, node: P.Aggregate) -> Result:
        """GROUP BY at a fixed group capacity (the ``agg@fid#k`` site):
        groups past it are dropped and the overflow flag set, and the
        counted groups size the rerun (reference: the traced
        ``_agg_partial``/``_agg_final``/``_agg_single``). Output rows past
        the group count are unselected. A global aggregate, an
        ``array_agg`` or a spilled one runs the local step."""
        res = self._exec(node.source)
        array_agg = any(fn.kind == "array_agg" for _, fn in node.aggregates)
        if self.n > 1 and node.step == "partial" and not node.group_keys and not array_agg:
            return self._sharded_global_partial(node, res)
        if not node.group_keys or array_agg:
            return LocalExecutor._exec_aggregate(self, node)
        site = self._site("agg", node)
        if self.n > 1 and node.step in ("partial", "final"):
            return self._sharded_aggregate(node, res, site)
        sel = res.batch.selection_mask()
        if node.step == "final":
            inputs, specs, sdicts, fold = self._final_inputs(node, res)
        else:
            inputs, specs, sdicts = self._agg_inputs(node, res)
            fold = None
        cap = self.caps.get(site, bucket_capacity(min(sel.shape[0], 1 << 12), minimum=1))
        keys = [res.opt_pair(k) for k in node.group_keys]
        (kd, kv), raw, ng, overflow = group_aggregate(keys, sel, inputs, specs, cap)
        self.overflows.append((site, overflow))
        self.needed[site] = ng
        cols = [
            Column(k.type, kd[i].to(torch_dtype(k.type.storage_dtype)), kv[i],
                   res.column(k).dictionary)
            for i, k in enumerate(node.group_keys)
        ]
        if node.step == "partial":
            acc_cols, acc_layout = acc_columns(node, raw, len(cols), sdicts)
            layout = {k.name: i for i, k in enumerate(node.group_keys)}
            layout.update(acc_layout)
            cols += acc_cols
        else:
            if fold is not None:
                raw = fold([r[0] if isinstance(r, tuple) else r for r in raw])
            cols += finalize_aggs(node, raw, sdicts)
            layout = {s.name: i for i, s in enumerate(node.output_symbols)}
        live = torch.arange(cap, device=sel.device) < ng
        return Result(Batch(cols, cap, live, self.device), layout)

    def _sharded_global_partial(self, node: P.Aggregate, res: Result) -> Result:
        """A partial aggregate without GROUP BY on N shards: one row of
        accumulators a shard, ``n`` rows shard-major (the reference's
        partial step runs in the fragment's per-shard body)."""
        from trino_tpu_torch.ops.aggregation import global_aggregate
        from trino_tpu_torch.parallel import mesh as M

        n = self.n
        res = Result(M.as_sharded(res.batch, n), res.layout)
        inputs, specs, sdicts = self._agg_inputs(node, res)

        def one_row(sel, ins):
            return [
                r.reshape(1) if not isinstance(r, tuple)
                else (r[0].reshape((1,) + tuple(r[0].shape[1:])), r[1].reshape(1))
                for r in global_aggregate(sel, ins, specs)
            ]

        raw = M.smap(one_row, self.mesh, [res.batch.selection_mask(), inputs])
        cols, layout = acc_columns(node, raw, 0, sdicts)
        return Result(Batch(cols, n, None, self.device, shards=n), layout)

    def _sharded_aggregate(self, node: P.Aggregate, res: Result, site: str) -> Result:
        """A partial or final GROUP BY on N shards (reference
        ``_agg_partial``/``_agg_final``): each shard groups its own rows at
        the site's per-shard capacity; the output is ``n * cap`` rows,
        shard-major. A final step's rows come from a hash exchange, so
        each shard holds whole groups."""
        from trino_tpu_torch.parallel import mesh as M

        n = self.n
        res = Result(M.as_sharded(res.batch, n), res.layout)
        sel = res.batch.selection_mask()
        if node.step == "final":
            inputs, specs, sdicts, fold = self._final_inputs(node, res)
        else:
            inputs, specs, sdicts = self._agg_inputs(node, res)
            fold = None
        per = res.batch.capacity // n
        cap = self.caps.get(site, bucket_capacity(min(per, 1 << 12), minimum=1))
        keys = [res.opt_pair(k) for k in node.group_keys]
        (kd, kv), raw, ng, overflow = M.smap(
            lambda k, s, i: group_aggregate(k, s, i, specs, cap), self.mesh, [keys, sel, inputs]
        )
        self.overflows.append((site, overflow.any()))
        self.needed[site] = ng.max()
        cols = [
            Column(k.type, kd[i].to(torch_dtype(k.type.storage_dtype)), kv[i],
                   res.column(k).dictionary)
            for i, k in enumerate(node.group_keys)
        ]
        if node.step == "partial":
            acc_cols, acc_layout = acc_columns(node, raw, len(cols), sdicts)
            layout = {k.name: i for i, k in enumerate(node.group_keys)}
            layout.update(acc_layout)
            cols += acc_cols
        else:
            raw = fold([r[0] if isinstance(r, tuple) else r for r in raw])
            cols += finalize_aggs(node, raw, sdicts)
            layout = {s.name: i for i, s in enumerate(node.output_symbols)}
        live = (torch.arange(cap, device=sel.device).unsqueeze(0) < ng.unsqueeze(1)).reshape(-1)
        return Result(Batch(cols, n * cap, live, self.device, shards=n), layout)

    @staticmethod
    def _final_inputs(node: P.Aggregate, res: Result):
        """The FINAL step's combine inputs over the partials' accumulator
        columns and the fold of their results back to (value, count)
        pairs (``LocalExecutor._aggregate_final``'s)."""
        combine_inputs: list = []
        combine_specs: list = []
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
                combine_specs.append(AggSpec("sum128w" if vcol.data.ndim == 2 else "sum"))
            else:
                combine_specs.append(AggSpec(fn.kind))
            combine_inputs.append((ccol.data, ccol.valid))
            combine_specs.append(AggSpec("sum"))

        def fold(raw):
            out, j = [], 0
            for _, fn in node.aggregates:
                if fn.kind in ("count", "count_star"):
                    out.append(raw[j])
                    j += 1
                else:
                    out.append((raw[j], raw[j + 1]))
                    j += 2
            return out

        return combine_inputs, combine_specs, sdicts, fold

    def _exec_tablescan(self, node: P.TableScan) -> Result:
        key = f"scan{id(node)}"
        return Result(self._inputs[key], dict(self._input_layouts[key]))

    def _exec_remotesource(self, node: P.RemoteSource) -> Result:
        key = f"remote{node.fragment_id}"
        batch = self._inputs[key]
        layout = self._input_layouts[key]
        # rename producer symbols -> this node's symbols (same order)
        producer_order = sorted(layout, key=layout.get)
        if len(producer_order) != len(node.symbols):
            raise FusedUnsupported("remote source arity mismatch")
        return Result(
            batch, {s.name: layout[p] for s, p in zip(node.symbols, producer_order)}
        )

    def _exec_output(self, node: P.Output) -> Result:
        res = self._exec(node.source)
        cols = [res.column(s) for s in node.symbols]
        layout = {s.name: i for i, s in enumerate(node.symbols)}
        return Result(
            Batch(cols, res.batch.num_rows, res.batch.sel, res.batch.device),
            layout,
        )

    def _agg_inputs(self, node: P.Aggregate, res: Result):
        """(agg_inputs, specs, string dictionaries) of an aggregate over
        ``res`` (:func:`agg_inputs_for`)."""
        try:
            return agg_inputs_for(node, res)
        except ExecutionError as e:  # an unported aggregate shape
            raise FusedUnsupported(str(e)) from e

    # --- limit / sort / topN: fixed capacities, no host reads ------------

    def _exec_limit(self, node: P.Limit) -> Result:
        res = self._exec(node.source)
        sel = res.batch.selection_mask()
        rank = torch.cumsum(sel.to(torch.int64), 0)
        keep = sel
        if node.offset:
            keep = keep & (rank > node.offset)
        if node.count is not None:
            keep = keep & (rank <= node.offset + node.count)
        return Result(
            Batch(res.batch.columns, res.batch.num_rows, keep, res.batch.device),
            res.layout,
        )

    def _exec_sort(self, node: P.Sort) -> Result:
        return self._traced_sort(self._exec(node.source), node.order_by, None)

    def _exec_topn(self, node: P.TopN) -> Result:
        """TopN: on N shards the partial step (reference: TopNNode PARTIAL,
        ``_partial_topn``) keeps each shard's best ``count`` rows, at most
        the shard's capacity; on a mesh of one its shard is the whole
        input, as is the final step's."""
        res = self._exec(node.source)
        if node.step == "partial" and self.n > 1:
            return self._partial_topn(res, node)
        return self._traced_sort(res, node.order_by, node.count)

    def _partial_topn(self, res: Result, node: P.TopN) -> Result:
        from trino_tpu_torch.parallel import mesh as M

        n = self.n
        b = M.as_sharded(res.batch, n)
        res = Result(b, res.layout)
        per = b.capacity // n
        keep = min(node.count, max(1, per))
        key_pairs, keys, ranks = self._sort_operands(res, node.order_by)
        sel = b.selection_mask()
        perms = []
        for s in range(n):
            lo, hi = s * per, (s + 1) * per
            local = [(d[lo:hi], v[lo:hi]) for d, v in key_pairs]
            perms.append(sort_indices(local, keys, sel[lo:hi], ranks)[:keep] + lo)
        perm = torch.cat(perms)
        cols = [c.take(perm) for c in b.columns]
        return Result(Batch(cols, n * keep, sel[perm], b.device, shards=n), res.layout)

    def _traced_sort(self, res: Result, order_by, keep: Optional[int]) -> Result:
        """All rows in ORDER BY order (selected first), cut to ``keep``."""
        b = res.batch
        key_pairs, keys, ranks = self._sort_operands(res, order_by)
        sel = b.selection_mask()
        perm = sort_indices(key_pairs, keys, sel, ranks)
        if keep is not None:
            perm = perm[: min(keep, b.capacity)]
        cols = [c.take(perm) for c in b.columns]
        return Result(Batch(cols, perm.shape[0], sel[perm], b.device), res.layout)

    # --- joins ------------------------------------------------------------

    def _join_strategy(self, node: P.Join, lkeys) -> str:
        """The join kernel for one Join node: ``sort`` (ops/join.py),
        ``dense`` (the open-addressing table) or ``matmul`` (the same table
        addressed by identity binning of a single integer key). ``auto``
        promotes to matmul only off a history-seeded ``densejoin`` site
        within the domain bound (reference ``:3151-3167``), so a cold run,
        or one with ``query_history`` off, is ``dense``. Demoted sites are
        pinned to sort."""
        if not bool(self.session.get("dense_join")):
            return "sort"
        site = self._site("densejoin", node)
        if site in self.caps.demoted:
            return "sort"
        pref = str(self.session.get("join_strategy") or "auto").lower()
        if pref == "sort":
            return "sort"
        kd = lkeys[0][0]
        matmul_ok = len(lkeys) == 1 and not kd.is_floating_point() and kd.dtype != torch.bool
        if pref == "matmul":
            return "matmul" if matmul_ok else "dense"
        if pref != "dense" and matmul_ok:
            seeded = self.caps.seeded(site)
            bound = int(self.session.get("matmul_join_max_domain"))
            if (
                seeded is not None
                and seeded[1].startswith("history")
                and 0 < seeded[0] <= bound
            ):
                return "matmul"
        return "dense"

    def _exec_join(self, node: P.Join) -> Result:
        from trino_tpu_torch.parallel.distributed import probe_build

        if node.join_type in ("SEMI", "ANTI"):
            return self._exec_semi_join_traced(node)
        if node.join_type == "RIGHT":
            flipped = flipped_right_join(node)
            self._ordinals[id(flipped)] = self._ordinals.get(id(node), 0)
            return self._exec_join(flipped)
        check_join_ported(node)
        if node.join_type == "CROSS":
            if node.single_row:
                return self._exec_scalar_cross_traced(node)
            return self._exec_cross_join(node)
        if node.join_type == "LEFT" and node.filter is not None:
            # the reference interprets such a join (the sort tier)
            return LocalExecutor._exec_join(self, node)
        right = self._exec(node.right)
        left = self._exec(node.left)
        full = node.join_type == "FULL"
        if self.n > 1 and not full and not node.single_row:
            if self.builds is None:
                return self._sharded_join(node, left, right)
            # a streamed chunk on N shards: each shard's probe rows meet the
            # whole build side, built once an attempt
            return self._stream_sharded_join(node, left, right)
        lkeys, rkeys = self._join_keys(
            left, right, node.criteria, remap_probe=self.builds is not None
        )
        ph, _ = J.hash_keys(lkeys)
        probe_cols, probe_keys = [], []
        for s in node.left.output_symbols:
            c = left.column(s)
            probe_cols += [c.data, c.valid_mask()]
        for kd, kv in lkeys:
            probe_keys += [kd, kv]
        join_site = self._site("join", node)
        dense_site = self._site("densejoin", node)
        strategy = self._join_strategy(node, lkeys)
        self.caps.join_strategies[dense_site] = strategy
        build = self._join_build(node, right, rkeys, strategy, dense_site, full)
        # a site's first run sizes its output to the matches (one read)
        cap = self.caps.vals.get(join_site)
        out_cols, out_sel, ovf, _, total = probe_build(
            build, probe_cols, probe_keys, ph, left.batch.selection_mask(),
            cap, "LEFT" if full else node.join_type,
        )
        if cap is None:
            cap = self.caps.get(join_site, out_sel.shape[0])
        self.overflows.append((join_site, ovf))
        self.needed[join_site] = total
        if node.single_row:
            dup_hit = out_cols[-2] & out_cols[-1] & out_sel
            self.overflows.append((f"err!{SCALAR_ROWS_ERROR}", dup_hit.any()))
        if full:
            bsel = right.batch.selection_mask()
            rid, rid_hit = out_cols[-2], out_cols[-1] & out_sel
            out_cols = out_cols[:-2]
            bcap = bsel.shape[0]
            matched = torch.zeros(bcap + 1, dtype=torch.bool, device=bsel.device)
            matched[torch.where(rid_hit, rid, bcap)] = True
            result = join_output(node, left, right, out_cols, cap, out_sel)
            return append_unmatched_build(node, result, right, bsel & ~matched[:bcap])
        result = join_output(node, left, right, out_cols, cap, out_sel)
        if node.filter is not None:  # INNER only: LEFT took the local path
            expr = self._bind(node.filter, result.layout)
            mask = bound_filter_mask(expr, result.batch.columns, self.device, self.params)
            result = Result(
                Batch(result.batch.columns, cap, mask & out_sel), result.layout
            )
        return result

    def _sharded_join(self, node: P.Join, left: Result, right: Result) -> Result:
        """An INNER or LEFT equi-join on N shards (reference ``_exec_join``
        over ``_sharded_probe``): each shard probes its own rows against
        its slice of a hash-exchanged build side, or against the whole
        build side otherwise; the dense and matmul tiers build one K2 table
        a shard. The output site's capacity is per shard; its first run
        sizes it to the largest shard's matches."""
        from trino_tpu_torch.parallel import mesh as M
        from trino_tpu_torch.parallel.distributed import _sharded_probe

        n = self.n
        build_sharded = (
            isinstance(node.right, P.RemoteSource) and node.right.exchange_type == "hash"
        )
        left = Result(M.as_sharded(left.batch, n), left.layout)
        if build_sharded:
            right = Result(M.as_sharded(right.batch, n), right.layout)
        lkeys, rkeys = self._join_keys(left, right, node.criteria)
        ph, _ = J.hash_keys(lkeys)
        bh, _ = J.hash_keys(rkeys)
        probe_cols, probe_keys, build_cols, build_keys = [], [], [], []
        for s in node.left.output_symbols:
            c = left.column(s)
            probe_cols += [c.data, c.valid_mask()]
        for s in node.right.output_symbols:
            c = right.column(s)
            build_cols += [c.data, c.valid_mask()]
        for kd, kv in lkeys:
            probe_keys += [kd, kv]
        for kd, kv in rkeys:
            build_keys += [kd, kv]
        join_site = self._site("join", node)
        dense_site = self._site("densejoin", node)
        strategy = self._join_strategy(node, lkeys)
        self.caps.join_strategies[dense_site] = strategy
        bsel = right.batch.selection_mask()
        table_cap = None
        if strategy != "sort":
            rows = 0
            if dense_site not in self.caps.vals:
                rows = int(M.shard_view(bsel, n).sum(1).max()) if build_sharded \
                    else int(bsel.sum())
            table_cap = self.caps.get(dense_site, bucket_capacity(max(1024, 4 * rows)))
        cap = self.caps.vals.get(join_site)
        out_cols, out_sel, ovf, tovf, total = _sharded_probe(
            self.mesh, probe_cols, probe_keys, ph, left.batch.selection_mask(),
            build_cols, build_keys, bh, bsel, cap, node.join_type, len(rkeys),
            build_sharded=build_sharded, strategy=strategy, table_cap=table_cap,
        )
        if tovf is not None:
            self.overflows.append((dense_site, tovf))
        if cap is None:
            cap = self.caps.get(join_site, out_sel.shape[0] // n)
        self.overflows.append((join_site, ovf))
        self.needed[join_site] = total
        result = join_output(node, left, right, out_cols, n * cap, out_sel)
        mask = out_sel
        if node.filter is not None:
            expr = self._bind(node.filter, result.layout)
            mask = bound_filter_mask(expr, result.batch.columns, self.device, self.params) & out_sel
        return Result(Batch(result.batch.columns, n * cap, mask, self.device, shards=n),
                      result.layout)

    def _stream_sharded_join(self, node: P.Join, left: Result, right: Result) -> Result:
        """An INNER or LEFT join of a streamed chunk on N shards (reference:
        the chunk step's ``_exec_join`` over ``_sharded_probe`` with a
        replicated build): the build side, made once an attempt and shared
        by the chunks (:attr:`builds`), is probed by each shard's rows of
        the chunk at the site's per-shard output capacity; the first chunk
        sizes it to the largest shard's matches, and an overflow grows it
        to the most matches a shard of a chunk needed."""
        from trino_tpu_torch.parallel import mesh as M
        from trino_tpu_torch.parallel.distributed import _sharded_probe

        n = self.n
        left = Result(M.as_sharded(left.batch, n), left.layout)
        lkeys, rkeys = self._join_keys(left, right, node.criteria, remap_probe=True)
        ph, _ = J.hash_keys(lkeys)
        probe_cols, probe_keys = [], []
        for s in node.left.output_symbols:
            c = left.column(s)
            probe_cols += [c.data, c.valid_mask()]
        for kd, kv in lkeys:
            probe_keys += [kd, kv]
        join_site = self._site("join", node)
        dense_site = self._site("densejoin", node)
        strategy = self._join_strategy(node, lkeys)
        self.caps.join_strategies[dense_site] = strategy
        build = self._join_build(node, right, rkeys, strategy, dense_site, False)
        cap = self.caps.vals.get(join_site)
        out_cols, out_sel, ovf, _, total = _sharded_probe(
            self.mesh, probe_cols, probe_keys, ph, left.batch.selection_mask(),
            None, None, None, None, cap, node.join_type, len(rkeys), build=build,
        )
        if cap is None:
            cap = self.caps.get(join_site, out_sel.shape[0] // n)
        self.overflows.append((join_site, ovf))
        self.needed[join_site] = total
        result = join_output(node, left, right, out_cols, n * cap, out_sel)
        mask = out_sel
        if node.filter is not None:  # INNER only: LEFT took the local path
            expr = self._bind(node.filter, result.layout)
            mask = bound_filter_mask(expr, result.batch.columns, self.device, self.params) & out_sel
        return Result(Batch(result.batch.columns, n * cap, mask, self.device, shards=n),
                      result.layout)

    def _join_build(self, node: P.Join, right: Result, rkeys, strategy: str,
                    dense_site: str, full: bool):
        """The build side of one join node (``parallel/distributed.py::
        build_join``): made here, or taken from :attr:`builds` when an
        earlier chunk of the same stream attempt made it. A dense table's
        overflow flag is reported by the run that built it."""
        from trino_tpu_torch.parallel.distributed import build_join

        if self.builds is not None and id(node) in self.builds:
            return self.builds[id(node)]
        bh, _ = J.hash_keys(rkeys)
        build_cols, build_keys = [], []
        for s in node.right.output_symbols:
            c = right.column(s)
            build_cols += [c.data, c.valid_mask()]
        bsel = right.batch.selection_mask()
        if full:
            # the build row ids ride along, so the matched build rows
            # scatter into a mask without a host read
            rid = torch.arange(bsel.shape[0], dtype=torch.int64, device=bsel.device)
            build_cols += [rid, torch.ones_like(bsel)]
        if node.single_row:
            # a correlated scalar subquery: a build key group of more than
            # one row that a probe row joins is an error. The duplicate
            # flag rides along as a synthetic build column, so duplicate
            # groups no probe row joins do not fire.
            dup = dup_key_rows(rkeys, bsel)
            build_cols += [dup, torch.ones_like(dup)]
        for kd, kv in rkeys:
            build_keys += [kd, kv]
        table_cap = None
        if strategy != "sort":
            # table slots: 4x the build rows (load factor <= 0.25: linear
            # probe clusters coalesce past the static window at 0.5)
            table_cap = self.caps.get(dense_site, bucket_capacity(
                max(1024, 4 * self._first_run_rows(dense_site, right))
            ))
        build = build_join(build_cols, build_keys, bh, bsel, len(rkeys), strategy, table_cap)
        if build.table_overflow is not None:
            # graceful overflow: the rerun doubles the table and re-hashes
            self.overflows.append((dense_site, build.table_overflow))
        if self.builds is not None:
            self.builds[id(node)] = build
        return build

    def _first_run_rows(self, site: str, res: Result) -> int:
        """The selected rows of ``res``, read from the device only when
        ``site`` has no capacity yet: a dense table's first capacity comes
        from the build rows that are there, as a join output's comes from
        its matches. Inputs' capacities double along a chain of joins when
        each output is sized from its probe's capacity, as the reference
        sizes them; that took TPC-H Q5 at SF1 to 30.7 GB of device memory
        on an H100. A site's later runs read nothing."""
        if site in self.caps.vals:
            return 0
        return res.batch.count_rows()

    def _exec_scalar_cross_traced(self, node: P.Join) -> Result:
        """An uncorrelated scalar subquery (single-row CROSS): the one
        selected build row broadcasts into every probe row; no row gives
        NULLs, more than one fails the query through the ``err!`` flag
        channel (reference: ``EnforceSingleRowNode``)."""
        right = self._nonempty(self._exec(node.right))
        left = self._exec(node.left)
        rsel = right.batch.selection_mask()
        cnt = rsel.sum()
        self.overflows.append((f"err!{SCALAR_ROWS_ERROR}", cnt > 1))
        # the first selected row, as a 1-element index: a 0-d index
        # tensor is read on the host
        pick = torch.argmax(rsel.to(torch.uint8)).reshape(1)
        has_row = cnt >= 1
        cap = left.batch.capacity
        cols = [left.column(s) for s in node.left.output_symbols]
        for s in node.right.output_symbols:
            c = right.column(s)
            val = c.data[pick][0]
            data = val.expand((cap,) + tuple(val.shape)).contiguous()
            valid = (c.valid_mask()[pick][0] & has_row).expand(cap).contiguous()
            cols.append(Column(s.type, data, valid, c.dictionary))
        layout = {
            s.name: i
            for i, s in enumerate(
                list(node.left.output_symbols) + list(node.right.output_symbols)
            )
        }
        return Result(
            Batch(cols, left.batch.num_rows, left.batch.sel, left.batch.device),
            layout,
        )

    def _exec_semi_join_traced(self, node: P.Join) -> Result:
        """SEMI/ANTI as a membership mark: probe rows carry only their row
        id through the sort-tier probe, and the matches scatter back into a
        boolean mark column (reference: ``HashSemiJoinOperator.java`` —
        mark semantics incl. 3-valued IN). A residual correlated filter
        runs the local executor's version."""
        from trino_tpu_torch.parallel.distributed import build_join, probe_build

        if node.filter is not None:
            return LocalExecutor._exec_semi_join(self, node)
        left = self._exec(node.left)
        right = self._exec(node.right)
        cap = left.batch.capacity
        lsel = left.batch.selection_mask()
        bsel = right.batch.selection_mask()
        if not node.criteria:
            nonempty = bsel.any()
            mark = nonempty if node.join_type == "SEMI" else ~nonempty
            return with_mark(node, left, Column(T.BOOLEAN, mark.expand(cap).clone()))
        lkeys, rkeys = self._join_keys(
            left, right, node.criteria, remap_probe=self.builds is not None
        )
        ph, _ = J.hash_keys(lkeys)
        bv_all = rkeys[0][1]
        for _, kv in rkeys[1:]:
            bv_all = bv_all & kv
        row_ids = torch.arange(cap, dtype=torch.int64, device=lsel.device)
        probe_keys = []
        for kd, kv in lkeys:
            probe_keys += [kd, kv]
        build = None if self.builds is None else self.builds.get(id(node))
        if build is None:
            build_keys = []
            for kd, kv in rkeys:
                build_keys += [kd, kv]
            build = build_join([], build_keys, J.hash_keys(rkeys)[0], bsel, len(rkeys))
            if self.builds is not None:
                self.builds[id(node)] = build
        site = self._site("semi", node)
        out_cols, out_sel, ovf, _, total = probe_build(
            build, [row_ids, torch.ones_like(lsel)], probe_keys, ph, lsel,
            self.caps.vals.get(site), "INNER",
        )
        self.caps.get(site, out_sel.shape[0])
        self.overflows.append((site, ovf))
        self.needed[site] = total
        matched = torch.zeros(cap + 1, dtype=torch.bool, device=lsel.device)
        matched[torch.where(out_sel, out_cols[0], cap)] = True
        return with_mark(
            node, left, mark_column(node, left, matched[:cap], lkeys, bv_all, bsel)
        )

    # --- the output exchange (reference :3436-3560) -------------------------

    def apply_output_exchange(self, frag: PlanFragment, res: Result) -> Result:
        """The fragment's output exchange on N shards: ``broadcast``
        all-gathers the rows to every shard; ``hash`` repartitions them by
        the output keys' hash through the two-tier exchange (a small cold
        bucket a (src, dst) pair and a shared spill tier), with a hot
        region when the fragment has a skew role (``self.skew``: a probe
        side detects the heavy hitters, its build peer salts with them);
        ``single`` and the root leave the global columns as they are. The
        exchange's flags and counters ride the program's words; its wire
        accounting (slots each source ships) is static."""
        if self.n <= 1 or frag.output_exchange in (None, "single"):
            return res
        from trino_tpu_torch.parallel import exchange as X
        from trino_tpu_torch.parallel import mesh as M

        n = self.n
        b = M.as_sharded(res.batch, n)
        res = Result(b, res.layout)
        sel = b.selection_mask()
        # wide DECIMAL columns ship as separate hi/lo lanes
        arrays, schema = [], []
        for c in b.columns:
            if c.data.ndim == 2:
                arrays += [c.data[:, 0], c.data[:, 1], c.valid_mask()]
                schema.append((c.type, c.dictionary, 2))
            else:
                arrays += [c.data, c.valid_mask()]
                schema.append((c.type, c.dictionary, 1))

        def rebuild(out, out_sel):
            cols, i = [], 0
            for t, d, lanes in schema:
                if lanes == 2:
                    cols.append(Column(t, torch.stack([out[i], out[i + 1]], 1), out[i + 2], d))
                    i += 3
                else:
                    cols.append(Column(t, out[i], out[i + 1], d))
                    i += 2
            self._op_exchange(frag, sel, out_sel)
            return Result(Batch(cols, int(out_sel.shape[0]), out_sel, self.device, shards=n),
                          res.layout)

        if frag.output_exchange == "broadcast":
            return rebuild(*X.broadcast_all(self.mesh, arrays, sel))
        khash, _ = J.hash_keys([res.pair(s) for s in frag.output_keys])
        detect = self.skew.get("detect")
        hot_set = None
        if self.skew.get("salt"):
            hs = self._inputs[self.skew.get("hotset_key", "__hotset__")]
            hot_set = (hs.columns[0].data, hs.columns[1].data)
        salted = detect is not None or hot_set is not None
        # cold tier: ~2x the uniform per-(src, dst) share; half that when a
        # hot set routes the heavy mass away from the cold path
        per_pair = b.capacity // (n * n)
        default_bucket = bucket_capacity(max(64, per_pair if salted else 2 * per_pair),
                                         minimum=64)
        fid = frag.id
        bucket = self.caps.get(f"exch@{fid}", default_bucket)
        spill = self.caps.get(f"spill@{fid}", max(64, bucket // 2))
        if detect is not None:
            # hot rows stay on their source shard: the region holds a
            # shard's rows
            hot_mode = "local"
            hot_cap = self.caps.get(f"hot@{fid}", bucket_capacity(max(64, b.capacity // n),
                                                                  minimum=64))
        elif hot_set is not None:
            # the hot slice of a near-unique build side is small
            hot_mode = "replicate"
            hot_cap = self.caps.get(f"hot@{fid}", bucket_capacity(max(64, per_pair), minimum=64))
        else:
            hot_mode, hot_cap = None, 0
        out, out_sel, (sp_ovf, hot_ovf), (sent, hot_rows, hot_keys), hotset = \
            X.skewed_repartition(self.mesh, arrays, khash, sel, bucket, spill,
                                 hot_mode=hot_mode, hot_cap=hot_cap, hot_set=hot_set,
                                 detect=detect)
        self.overflows.append((f"spill@{fid}", sp_ovf))
        if hot_mode is not None:
            self.overflows.append((f"hot@{fid}", hot_ovf))
            self.counters.append((f"salted@{fid}", hot_rows))
        if detect is not None:
            self.aux_out = hotset[:2]
            self.counters.append((f"hotkeys@{fid}", hot_keys))
        self.counters.append((f"sent@{fid}", sent))
        wire_slots = n * bucket + spill + (hot_cap if hot_mode == "replicate" else 0)
        row_bytes = sum(a.element_size() for a in arrays)
        st = self.exchange_static
        st["exchanges"] = st.get("exchanges", 0) + 1
        st["padded_shuffle_rows"] = st.get("padded_shuffle_rows", 0) + n * wire_slots
        st["shuffle_bytes"] = st.get("shuffle_bytes", 0) + n * wire_slots * row_bytes
        return rebuild(out, out_sel)

    def _op_exchange(self, frag: PlanFragment, sel_in, sel_out) -> None:
        """The exchange's leg of the operator counters (``exch@{fid}``):
        rows offered and rows landed (a broadcast lands n copies)."""
        if not self._op_enabled:
            return
        site = f"exch@{frag.id}"
        self.counters.append((f"op!exchange!in!{site}", sel_in.sum(dtype=torch.int64)))
        self.counters.append((f"op!exchange!out!{site}", sel_out.sum(dtype=torch.int64)))


# --- fusability (reference: fragment_fusable) -------------------------------

_FUSABLE_NODES = (
    P.TableScan, P.RemoteSource, P.Filter, P.Project, P.Aggregate, P.Join,
    P.TopN, P.Limit, P.Sort, P.Output, P.Values,
)


def _is_wide_type(t) -> bool:
    return isinstance(t, T.DecimalType) and t.wide


def _expr_blocks_fusion(e) -> bool:
    """Modulus/cast touching wide DECIMAL narrows at runtime with a
    data-dependent check: those fragments run eagerly."""
    from trino_tpu_torch.ir import Call, SpecialForm

    if isinstance(e, Call):
        if e.name == "modulus" and (
            _is_wide_type(e.type) or any(_is_wide_type(a.type) for a in e.args)
        ):
            return True
        if e.name == "cast" and any(_is_wide_type(a.type) for a in e.args):
            st, rt = e.args[0].type, e.type
            traced = (
                isinstance(rt, (T.DoubleType, T.RealType))
                or (
                    isinstance(rt, T.DecimalType)
                    and isinstance(st, T.DecimalType)
                    and (rt.wide and rt.scale >= st.scale or st.scale - rt.scale <= 18)
                )
            )
            if not traced:
                return True
        return any(_expr_blocks_fusion(a) for a in e.args)
    if isinstance(e, SpecialForm):
        return any(_expr_blocks_fusion(a) for a in e.args)
    return False


def fragment_fusable(frag: PlanFragment) -> bool:
    """True when every node of the fragment runs as device work at fixed
    capacities, so the fragment can be one program (a copy of the
    reference's test, so that the two packages' census agree)."""
    for n in P.walk_plan(frag.root):
        if not isinstance(n, _FUSABLE_NODES):
            return False
        if isinstance(n, P.Join):
            if n.join_type in ("SEMI", "ANTI"):
                if n.filter is not None or any(
                    _is_wide_type(a.type) or _is_wide_type(b.type) for a, b in n.criteria
                ):
                    return False
                continue
            if n.join_type == "CROSS" and n.single_row:
                continue
            if (
                n.join_type not in ("INNER", "LEFT")
                or not n.criteria
                or (n.single_row and n.join_type != "LEFT")
                or (n.join_type == "LEFT" and n.filter is not None)
                or any(_is_wide_type(a.type) or _is_wide_type(b.type) for a, b in n.criteria)
            ):
                return False
            if n.filter is not None and _expr_blocks_fusion(n.filter):
                return False
        if isinstance(n, P.Aggregate):
            if any(fn.distinct for _, fn in n.aggregates) and n.step != "single":
                return False
            if any(_is_wide_type(k.type) for k in n.group_keys):
                return False
            for _, fn in n.aggregates:
                if fn.kind not in ("sum", "count", "count_star", "min", "max", "avg"):
                    return False
        if isinstance(n, P.Filter) and _expr_blocks_fusion(n.predicate):
            return False
        if isinstance(n, P.Project) and any(
            _expr_blocks_fusion(e) for _, e in n.assignments
        ):
            return False
    return True


def query_fusable(sub: SubPlan) -> bool:
    return all(fragment_fusable(frag) for frag in sub.all_fragments())


# failures that a smaller program can fix: the card's memory exhausted
_RESOURCE_ERROR_MARKERS = (
    "RESOURCE_EXHAUSTED", "Resource exhausted", "resource exhausted",
    "out of memory", "Out of memory", "OutOfMemoryError",
)


def _is_resource_exhausted(e: BaseException) -> bool:
    """True when a failure should enter the capacity-halving ladder
    (``torch.cuda.OutOfMemoryError`` and its kind) instead of failing the
    query."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = f"{type(e).__name__}: {e}"
    return any(m in msg for m in _RESOURCE_ERROR_MARKERS)


def _shrink_all(caps: _Caps, factor: int = 2, floor: int = 64) -> bool:
    """``_Caps.shrink_all``: halve every capacity still above ``floor``
    (reference ``fragments.py:352``). False when nothing can shrink."""
    changed = False
    for nm, v in list(caps.vals.items()):
        nv = max(floor, bucket_capacity(max(1, v // factor), minimum=1))
        if nv < v:
            caps.vals[nm] = nv
            prev = caps.provenance.get(nm, "default")
            if not prev.endswith("+halved"):
                caps.provenance[nm] = prev + "+halved"
            changed = True
    return changed


_Caps.shrink_all = _shrink_all


class BatchUnsupported(Exception):
    """A plan or input shape the batched replays cannot carry (a streamed
    or eager fragment, an overflow inside the batch): the collector runs
    the members one after the other instead, bit-identically."""


def program_label(program_key) -> str:
    """Stable display label of a program key (reference ``:482``)."""
    if isinstance(program_key, tuple) and len(program_key) >= 2:
        if program_key[0] == "frag":
            return f"frag:{program_key[1]}"
        if program_key[0] == "fused":
            return "fused:" + "+".join(str(i) for i in program_key[1])
    return repr(program_key)


class _Meta:
    """What a program's function fixed when it ran: the output layout,
    the names of the words it returns (flags, match counts, counters) and
    its exchange statics."""

    def __init__(self):
        self.layout: dict = {}
        self.flag_names: list[str] = []
        self.needed_names: list[str] = []
        self.counter_names: list[str] = []
        self.exchange_static: dict = {}

    def capture(self, res: Result, summary) -> None:
        self.layout = dict(res.layout)
        self.flag_names = [nm for nm, _ in summary.overflows]
        self.needed_names = [nm for nm, _ in summary.needed]
        self.counter_names = [nm for nm, _ in summary.counters]
        self.exchange_static = dict(summary.exchange_static)

    @staticmethod
    def words(summary, device) -> torch.Tensor:
        """Every flag, match count and counter as one int64 tensor: the
        program's one host read."""
        parts = (
            [f for _, f in summary.overflows]
            + [t for _, t in summary.needed]
            + [c for _, c in summary.counters]
        )
        if not parts:
            return torch.zeros(0, dtype=torch.int64, device=device)
        return torch.stack([p.reshape(()).to(torch.int64) for p in parts])


class _TracerSummary:
    """The member tracers of a fused unit merged (reference ``:422``):
    flags, match counts and counters concatenate (sites are unique per
    fragment id), statics sum."""

    def __init__(self):
        self.overflows: list = []
        self.needed: list = []
        self.counters: list = []
        self.exchange_static: dict = {}

    def absorb(self, tracer) -> None:
        self.overflows.extend(tracer.overflows)
        self.needed.extend(tracer.needed.items())
        self.counters.extend(tracer.counters)
        for k, v in tracer.exchange_static.items():
            self.exchange_static[k] = self.exchange_static.get(k, 0) + v


class _BatchSummary:
    """The K members' words of one batched program merged (reference
    ``:444``): the members replay one program, so their word lists align;
    a flag fires when any member's does (max), a match count is the
    largest, a counter sums."""

    def __init__(self, meta: _Meta):
        self.nflags = len(meta.flag_names)
        self.nneeded = len(meta.needed_names)

    def merge(self, rows: list[list[int]]) -> list[int]:
        out = []
        for j, col in enumerate(zip(*rows)):
            out.append(max(col) if j < self.nflags + self.nneeded else sum(col))
        return out


def _hotset_batch(hot_set) -> Batch:
    """A hot-key set ``(hashes, valid)`` as a program input."""
    hh, hv = hot_set[0], hot_set[1]
    return Batch([Column(T.BIGINT, hh), Column(T.BOOLEAN, hv)], int(hh.shape[0]), None,
                 hh.device)


def _post_order(sub: SubPlan) -> list[PlanFragment]:
    """Fragments with every producer before its consumers."""
    out: list[PlanFragment] = []
    for child in sub.children:
        out.extend(_post_order(child))
    out.append(sub.fragment)
    return out


def _root_key(root: P.PlanNode, original: P.PlanNode):
    """A fragment root's part of a program key: the cached plan's node by
    identity; a root that dynamic filtering rewrote by its serialized
    form (the pushed domains are constants of the program), so an equal
    rewrite of a later run hits the same program."""
    if root is original:
        return id(root)
    import hashlib
    import json

    from trino_tpu_torch.planner.serde import node_to_json

    try:
        text = json.dumps(node_to_json(root), sort_keys=True, default=str)
    except (TypeError, ValueError):
        return ("unserializable", id(root))
    return hashlib.sha1(text.encode()).hexdigest()


class FragmentedExecutor(DistributedExecutor):
    """Distributed-mode executor: the plan's fragments bottom-up, grouped
    into fused units, each unit one program.

    ``programs`` is the store of the query's program-cache entry
    (``Engine._query_cache_entry``): the fragmented subplan, the fused
    units, each fragment's or unit's ``_Caps`` under ``("caps", ...)``
    and the programs under ``(program_key, caps.signature())``; None
    gives a store of the query's own. ``pool`` (:class:`ProgramPool`)
    captures programs as CUDA graphs; without it nothing is captured and
    every run is eager. ``params`` are the canonical plan's hoisted
    literals ``[(value, type), ...]``, made one device tensor a run.
    ``table_cache`` (a :class:`DeviceTableCache`) keeps scanned tables on
    the device across queries when the session's ``table_cache`` is on,
    within ``table_cache_bytes``."""

    def __init__(self, catalogs, session, device, mesh=None,
                 programs: Optional[dict] = None, params=None, pool=None,
                 table_cache=None, table_cache_bytes: int = 1 << 30,
                 memory_ctx=None, history: Optional[dict] = None):
        super().__init__(catalogs, session, device, mesh, memory_ctx=memory_ctx)
        # the fingerprint's query-history entry (obs/history.py) read
        # before this run, or None: it seeds the capacities of new sites
        self.history = history
        if self.n_shards == 1:
            self.exchange_stats = {"overflow_retries": 0}
        self.exchange_stats["joinStrategy"] = {}
        # hot-key sets of the probe exchanges that ran, by fragment id
        self._hot_sets: dict[int, tuple] = {}
        # fragment id -> "streamed" | "materialized" (one program, a fused
        # unit's member or an eager fragment)
        self.fragment_modes: dict[int, str] = {}
        self.programs: dict = {} if programs is None else programs
        self.pool = pool
        self._param_list = list(params or [])
        # per-query compile telemetry (reference: compile_stats)
        self.compile_stats: dict = {
            "trace_count": 0, "compile_ms": 0.0,
            "program_cache_hits": 0, "program_cache_misses": 0,
        }
        # per-query operator row flow: {stable_site: {kind, rows_in, rows_out}}
        self.operator_stats: dict[str, dict] = {}
        self.table_cache = table_cache
        self.table_cache_bytes = table_cache_bytes

    def _caps(self, *scope) -> _Caps:
        caps = self.programs.setdefault(("caps",) + scope, _Caps())
        if self.history:
            self._seed_history(scope, caps)
        return caps

    # --- query history (reference :677-752) ---------------------------------

    @staticmethod
    def _history_sites(fids, hcaps: dict) -> list[str]:
        """The sites of ``hcaps`` (a history entry's capacities) that
        belong to the fragments ``fids``. The reference maps its runtime
        site names (``agg{id(node)}``) onto restart-stable ones
        (``agg@3#0``); here the tracer names its sites the stable way
        already (``kind@fragment#ordinal``, a stream's ``agg@fragment``),
        so a site belongs to the fragment its name carries."""
        want = {str(f) for f in fids}
        return [site for site in hcaps
                if site.partition("@")[2].partition("#")[0] in want]

    def _seed_history(self, scope: tuple, caps: _Caps) -> None:
        """History-seeded capacities: a site of this scope's fragments
        that no run of the entry has sized yet starts at the capacity an
        earlier run of the fingerprint settled at (provenance
        ``history``). Exact, not a floor as in the reference: this
        package's first capacities are sized from the data (one host read
        a site), and the observed final capacity is what that sizing and
        its retries reach. Best-effort: seeding never fails a query."""
        try:
            hcaps = (self.history or {}).get("capacities") or {}
            if not hcaps:
                return
            fids = scope[1] if scope and scope[0] == "fused" else scope[-1:]
            seeded = 0
            for site in self._history_sites(fids, hcaps):
                ent = hcaps[site]
                if not isinstance(ent, dict) or caps.seeded(site) is not None:
                    continue
                val = bucket_capacity(int(ent.get("value", 0)), minimum=1)
                if val > 0:
                    caps.seed(site, val, provenance="history")
                    seeded += 1
            if seeded:
                get_registry().counter("trino_tpu_history_seeds_total").inc(seeded)
        except Exception:  # noqa: BLE001 — seeding is best-effort
            pass

    # --- scans ------------------------------------------------------------

    def _scan_batch(self, node: P.TableScan) -> Result:
        """A fragment's table scan, through the device table cache when
        the session has it on (reference:
        ``trino_tpu/parallel/distributed.py:200-286``): a hit returns the
        device batch of an earlier scan of the same table version, columns
        and splits; a miss scans and admits the result."""
        connector = self.catalogs.get(node.catalog)
        if self.table_cache is None or not self.session.get("table_cache") or (
            node.limit is not None  # a limit hint stops reading early
        ) or not getattr(connector, "supports_result_caching", True):
            # live state (the system catalog) is read anew every scan
            return self._exec_tablescan(node)
        from trino_tpu_torch.ingest import batch_nbytes, table_cache_key

        splits = self._scan_splits(node)
        key = table_cache_key(
            node.catalog, node.schema, node.table,
            connector.data_version(node.schema, node.table),
            node.column_names, splits, self.device,
        ) + ((("shards", self.n_shards),) if self.n_shards > 1 else ())
        stats = self.ingest_stats
        cached = self.table_cache.lookup(key)
        stats["tableCache"] = self.table_cache.snapshot()
        if cached is not None:
            stats["table_cache_hits"] = stats.get("table_cache_hits", 0) + 1
            return Result(cached, {s.name: i for i, s in enumerate(node.symbols)})
        stats["table_cache_misses"] = stats.get("table_cache_misses", 0) + 1
        res = self._exec_tablescan(node, splits)
        nbytes = batch_nbytes(res.batch)
        admitted = self.table_cache.admit(key, res.batch, nbytes, self.table_cache_bytes)
        if not admitted and nbytes <= self.table_cache_bytes and self.pool is not None \
                and self.pool.on_card:
            # the card lacks headroom: the allocator's free blocks (the
            # warm-ups' and eager runs') go back first
            torch.cuda.empty_cache()
            self.table_cache.admit(key, res.batch, nbytes, self.table_cache_bytes)
        stats["tableCache"] = self.table_cache.snapshot()
        return res

    # --- the query ----------------------------------------------------------

    def execute(self, node: P.PlanNode) -> tuple[Batch, list[str]]:
        from trino_tpu_torch.compiler import param_tensor

        # the fragmentation is cached with the entry: program keys and
        # capacity sites name its nodes
        sub = self.programs.get("__subplan__")
        if sub is None:
            with get_tracer().span("fragment"):
                sub = fragment_plan(node, self.session)
            self.programs["__subplan__"] = sub
        self.params = param_tensor(self._param_list, self.device)
        return self._execute_fragments(sub)

    def _execute_fragments(self, sub: SubPlan) -> tuple[Batch, list[str]]:
        from trino_tpu_torch.ft.injection import FaultInjector

        results: dict[int, Result] = {}
        names_holder: dict[int, list[str]] = {}
        # the chaos hook (ft/injection.py): fragment-level crash sites,
        # deterministic a (seed, fragment id); a fused unit keeps one site
        # a member, so chaos schedules are the same with fusion on or off
        injector = FaultInjector.from_session(self.session)
        for unit in self._fusion_units(sub):
            fused = isinstance(unit, FusedFragment)
            if injector is not None:
                for fid in (unit.fragment_ids if fused else (unit.id,)):
                    injector.maybe_crash_task(f"frag:{fid}")
            if fused:
                results[unit.id] = self._run_fused_unit(unit, results, names_holder)
            else:
                results[unit.id] = self._run_fragment(unit, results, names_holder)
        from trino_tpu_torch.exec.programs import allow_sync

        # the result's read: its selected rows gathered to the host
        self._count("result_reads")
        t_pull = time.perf_counter()
        with allow_sync(self.device):
            out = results[sub.fragment.id].batch.compact()
        self._pulled(t_pull, extras=len(out.columns))
        names = names_holder.get(sub.fragment.id) or [
            s.name for s in sub.fragment.root.output_symbols
        ]
        return out, names

    def exchange_stats_snapshot(self) -> dict:
        """The query's exchange counters, with the join strategy of every
        capacity site of its entry and the operator row flow."""
        st = dict(self.exchange_stats)
        strategies = dict(st.get("joinStrategy") or {})
        for key, val in self.programs.items():
            if isinstance(key, tuple) and key and key[0] == "caps" and isinstance(val, _Caps):
                strategies.update(val.join_strategies)
        st["joinStrategy"] = strategies
        # every site's value, provenance and restart-stable name: what the
        # history store keeps; history_seeds counts the sites whose value
        # came from it (queryStats.historySeeds)
        st["capacities"] = self._capacity_report()
        st["history_seeds"] = sum(
            1 for ent in st["capacities"].values()
            if str(ent["provenance"]).startswith("history")
        )
        if self.n_shards > 1:
            st["padding_ratio"] = round(
                st.get("padded_shuffle_rows", 0) / max(1, st.get("shuffle_rows", 0)), 4)
        if self.operator_stats:
            st["operators"] = {k: dict(v) for k, v in self.operator_stats.items()}
        if self.pool is not None and self.pool.on_card:
            st["program_pool_bytes"] = self.pool.reserved_bytes()
        return st

    def _capacity_report(self) -> dict:
        """Every capacity site of the query's entry: its final value and
        provenance (``default``, ``seeded``, ``+grown``, ``+halved``), the
        reference's ``exchange_stats["capacities"]``."""
        report = {}
        for key, caps in sorted(
            ((k, v) for k, v in self.programs.items()
             if isinstance(k, tuple) and k and k[0] == "caps"),
            key=lambda kv: repr(kv[0]),
        ):
            for name, value in sorted(caps.vals.items()):
                report[name] = {
                    "site": name, "value": value,
                    "provenance": caps.provenance.get(name, "default"),
                }
        return report

    def _count(self, key: str, n: int = 1) -> None:
        self.exchange_stats[key] = self.exchange_stats.get(key, 0) + n

    @staticmethod
    def _pulled(t0: float, **attrs) -> None:
        """The result's read from the device (reference ``:991-999``): its
        span and ``trino_tpu_device_pull_ms``."""
        ms = (time.perf_counter() - t0) * 1000.0
        get_tracer().record("device_pull", ms, attrs=attrs)
        get_registry().histogram("trino_tpu_device_pull_ms").observe(ms)

    def _df_build_lookup(self, results: dict[int, Result]):
        """Dynamic-filter domain accessor over completed fragment results:
        ``build_lookup(fid)`` gives ``(get_column, selected rows)``, where
        ``get_column(name)`` copies one build column and its live mask to
        the host, or None when the fragment has no result (a fused unit's
        interior member). Each copy is a counted host read."""
        from trino_tpu_torch.exec.programs import allow_sync

        def build_lookup(fid):
            res = results.get(fid)
            if res is None:
                return None
            sel = res.batch.selection_mask()
            self._count("host_reads")
            with allow_sync(self.device):
                n = int(sel.sum())

            def get_column(name):
                idx = res.layout.get(name)
                if idx is None:
                    return None
                c = res.batch.columns[idx]
                self._count("host_reads")
                with allow_sync(self.device):
                    return c.data.cpu().numpy(), (c.valid_mask() & sel).cpu().numpy()

            return get_column, n

        return build_lookup

    # --- fused units (reference: _fusion_units, _fusion_blocked) -----------

    def _fusion_units(self, sub: SubPlan) -> list:
        """Bottom-up execution units: :class:`FusedFragment` groups where
        pipeline fusion applies, plain fragments elsewhere; cached in the
        entry's store with the subplan whose fragments they name."""
        units = self.programs.get("__fusedunits__")
        if units is None:
            if bool(self.session.get("pipeline_fusion")):
                blocked = set(self._fusion_blocked(sub))
                if bool(self.session.get("enable_dynamic_filtering")):
                    # a selective broadcast build stays a fragment
                    # boundary: dynamic filtering prunes the probe from
                    # the materialized build, which a fused interior
                    # member never produces
                    blocked |= filtered_broadcast_fids(sub)
                units = fuse_groups(
                    sub,
                    fusable=fragment_fusable,
                    max_fragments=max(1, int(self.session.get("fusion_max_fragments"))),
                    blocked=frozenset(blocked),
                    broadcast_links=bool(self.session.get("dense_join")),
                )
            else:
                units = _post_order(sub)
            self.programs["__fusedunits__"] = units
        return units

    def _graceful_overflow(self) -> bool:
        """True when the dense join tier's graceful overflow is active: a
        spill-sized join input stays on the program path because a table
        overflow re-hashes at doubled capacity in the retry ladder."""
        return bool(self.session.get("dense_join")) and str(
            self.session.get("join_strategy") or "auto"
        ).lower() != "sort"

    def _fusion_blocked(self, sub: SubPlan) -> set:
        """Fragment ids that stay on the per-fragment path: scans big
        enough for the streaming chunk loop, or for the spill fallback."""
        from trino_tpu_torch.exec.streaming import streamable_chain

        blocked: set[int] = set()
        stream_threshold = int(self.session.get("stream_scan_threshold_rows"))
        spill_threshold = (
            int(self.session.get("spill_threshold_rows"))
            if self.session.get("spill_enabled") and not self._graceful_overflow()
            else None
        )
        for frag in sub.all_fragments():
            chain = streamable_chain(frag.root)
            stream_scan = chain[1] if chain is not None else None
            for n in P.walk_plan(frag.root):
                if not isinstance(n, P.TableScan):
                    continue
                est = self.catalogs.get(n.catalog).estimate_rows(n.schema, n.table)
                if est is None:
                    continue
                if n is stream_scan and est > stream_threshold:
                    blocked.add(frag.id)
                if spill_threshold is not None and est > spill_threshold:
                    blocked.add(frag.id)
        return blocked

    def _unit_inputs(self, members, results, names_holder, rewrite: bool = True):
        """The dynamic-filter-rewritten members and the unit's inputs:
        every member's scans, and the results of producers outside the
        unit. Returns ``(members, inputs, layouts, copied)``: ``copied``
        names the inputs a replay copies into static buffers (all but the
        scans, which are read in place)."""
        from trino_tpu_torch.dynfilter import fragment_dynamic_filters

        member_ids = {f.id for f in members}
        lookup = self._df_build_lookup(results)
        out_members = []
        for frag in members:
            root = frag.root
            if rewrite:
                root = fragment_dynamic_filters(
                    frag.root, lookup, self.session, self.dynamic_filters
                )
            out_members.append((frag, root))
        inputs: dict = {}
        layouts: dict = {}
        copied: set = set()
        for frag, root in out_members:
            for n in P.walk_plan(root):
                if isinstance(n, P.TableScan):
                    res = self._scan_batch(n)
                    inputs[f"scan{id(n)}"] = res.batch
                    layouts[f"scan{id(n)}"] = res.layout
                elif isinstance(n, P.RemoteSource) and n.fragment_id not in member_ids:
                    r = results[n.fragment_id]
                    inputs[f"remote{n.fragment_id}"] = r.batch
                    layouts[f"remote{n.fragment_id}"] = r.layout
                    copied.add(f"remote{n.fragment_id}")
                elif isinstance(n, P.Output):
                    names_holder[frag.id] = list(n.column_names)
        return out_members, inputs, layouts, copied

    def _run_fused_unit(self, unit: FusedFragment, results, names_holder) -> Result:
        """A fused unit as one program; ``FusedUnsupported``,
        ``CapacityRetryExceeded`` or an operator that needs the host
        (``NotCapturable``) falls back to its members' per-fragment runs
        (reference ``:1150-1175``), counted in ``fused_fallbacks``."""
        from trino_tpu_torch.exec.programs import NotCapturable

        span = get_tracer().start_span(
            "fused_execute", attrs={"stage": unit.id, "fragments": len(unit.fragments)})
        try:
            with span:
                if ("eager", unit.fragment_ids) in self.programs:
                    raise FusedUnsupported("an earlier run fell back")
                out = self._run_fused_spanned(unit, results, names_holder)
                span.set("mode", "fused-pipeline")
            get_registry().counter("trino_tpu_fused_programs_total").inc()
            return out
        except (FusedUnsupported, CapacityRetryExceeded, NotCapturable) as e:
            if isinstance(e, NotCapturable):
                # remembered with the entry: later runs skip the attempt
                self.programs[("eager", unit.fragment_ids)] = True
            self._count("fused_fallbacks")
            for frag in unit.fragments:
                results[frag.id] = self._run_fragment(frag, results, names_holder)
            return results[unit.id]

    def _run_fused_spanned(self, unit: FusedFragment, results, names_holder) -> Result:
        t0 = time.perf_counter()
        members, inputs, layouts, copied = self._unit_inputs(
            unit.fragments, results, names_holder
        )
        skew = self._root_skew(unit.id, inputs, copied)
        out = self.run_fused_program(members, inputs, layouts, copied, skew)
        self._keep_hot_set(unit.id, out)
        for frag in unit.fragments:
            self.fragment_modes[frag.id] = "materialized"
        self._count("fusedFragments", len(unit.fragments))
        self._record_fragment(unit.id, "fused-pipeline", t0, out,
                              fragments=list(unit.fragment_ids))
        return out

    def _run_fragment(self, frag: PlanFragment, results, names_holder) -> Result:
        """One fragment: the streaming chunk loop when it qualifies, else
        one program when it is fusable (``run_fragment_program``), else
        the eager retry loop over its nodes (``_run_with_retries``); under
        its ``fragment_execute`` span."""
        with get_tracer().span("fragment_execute", attrs={"stage": frag.id}):
            return self._run_fragment_spanned(frag, results, names_holder)

    def _run_fragment_spanned(self, frag: PlanFragment, results, names_holder) -> Result:
        from trino_tpu_torch.exec.programs import NotCapturable, allow_sync

        t0 = time.perf_counter()
        # a fragment that is no program (a streamed chunk loop, an eager
        # fragment) reads the device on the host as it goes: a run
        # checked by programs.checked_syncs lets it, and
        # host_synced_fragments counts it
        tried = self.exchange_stats.get("stream_fallbacks", 0)
        with allow_sync(self.device):
            streamed = self._try_streaming(frag, names_holder, results)
            if streamed is not None and self.n_shards > 1:
                skew_inputs: dict = {}
                skew = self._root_skew(frag.id, skew_inputs, set())
                streamed = self._exchange_eagerly(frag, streamed, skew, skew_inputs)
                self._keep_hot_set(frag.id, streamed)
        if streamed is not None or self.exchange_stats.get("stream_fallbacks", 0) != tried:
            self._count("host_synced_fragments")
        if streamed is not None:
            self.fragment_modes[frag.id] = "streamed"
            self._record_fragment(frag.id, "streamed", t0, streamed)
            return streamed
        [(frag, root)], inputs, layouts, copied = self._unit_inputs(
            [frag], results, names_holder
        )
        self.fragment_modes[frag.id] = "materialized"
        out = None
        skew = self._root_skew(frag.id, inputs, copied)
        if fragment_fusable(frag) and ("eager", frag.id) not in self.programs:
            try:
                out = self.run_fragment_program(frag, root, inputs, layouts, copied, skew)
                self._record_fragment(frag.id, "program", t0, out)
            except NotCapturable:
                # an operator needs the host: the fragment runs eagerly,
                # in this run and the later ones of the entry
                self.programs[("eager", frag.id)] = True
                self._count("program_fallbacks")
        if out is None:
            self._count("host_synced_fragments")
            with allow_sync(self.device):
                out = self._run_with_retries(frag.id, root, inputs, layouts, frag, skew)
            self._record_fragment(frag.id, "materialized", t0, out)
        self._keep_hot_set(frag.id, out)
        return out

    # --- skew roles and hot-key sets (reference :643, :1230-1260) -----------

    def _skew_roles(self) -> dict[int, dict]:
        """Producer fragment id -> skew role for every partitioned
        (hash/hash) INNER or LEFT equi-join on N shards: the probe side's
        exchange detects the heavy hitters over the probe key hashes (the
        fragmenter cuts ``Join.left`` first, so it runs first) and the
        build side's salts with that hot set. SEMI/ANTI and single-row
        joins keep the plain two-tier exchange."""
        roles = self.programs.get("__skewroles__")
        if roles is None:
            roles = {}
            sub = self.programs.get("__subplan__")
            if sub is not None and self.n_shards > 1 and bool(self.session.get("skew_handling")):
                for frag in sub.all_fragments():
                    for node in P.walk_plan(frag.root):
                        if (
                            isinstance(node, P.Join)
                            and node.join_type in ("INNER", "LEFT")
                            and node.criteria
                            and not node.single_row
                            and isinstance(node.left, P.RemoteSource)
                            and node.left.exchange_type == "hash"
                            and isinstance(node.right, P.RemoteSource)
                            and node.right.exchange_type == "hash"
                        ):
                            roles[node.left.fragment_id] = {"role": "probe"}
                            roles[node.right.fragment_id] = {
                                "role": "build", "peer": node.left.fragment_id,
                            }
            self.programs["__skewroles__"] = roles
        return roles

    def _detect(self) -> tuple:
        return (max(1, int(self.session.get("skew_hot_k"))),
                float(self.session.get("skew_hot_threshold_frac")))

    def _root_skew(self, fid: int, inputs: dict, copied: set) -> Optional[dict]:
        """The skew role of a unit's root exchange: a probe detects; a
        build whose probe peer ran gets the peer's hot set as the
        ``__hotset__`` input (copied into a replay, never a constant)."""
        if self.n_shards == 1:
            return None
        role = self._skew_roles().get(fid)
        if role is None:
            return None
        if role["role"] == "probe":
            return {"detect": self._detect()}
        hs = self._hot_sets.get(role["peer"])
        if hs is None:
            return None
        inputs["__hotset__"] = _hotset_batch(hs)
        copied.add("__hotset__")
        return {"salt": True}

    def _keep_hot_set(self, fid: int, res: Result) -> None:
        aux = getattr(res, "aux", ())
        if aux:
            self._hot_sets[fid] = aux

    def _exchange_eagerly(self, frag: PlanFragment, res: Result, skew, inputs) -> Result:
        """A streamed fragment's output exchange, under the overflow
        protocol of its own sites (one host read a run)."""
        from trino_tpu_torch.exec.programs import host_read

        caps = self._caps("exchange", frag.id)
        for _ in range(MAX_ATTEMPTS):
            tracer = _FragmentTracer(self, inputs, {}, caps, frag.id, None, skew=skew)
            out = tracer.apply_output_exchange(frag, res)
            meta, summary = _Meta(), _TracerSummary()
            summary.absorb(tracer)
            meta.capture(out, summary)
            vals = host_read(_Meta.words(summary, self.device), self.exchange_stats)
            if self._settle(meta, vals, caps, set()):
                out.aux = tracer.aux_out
                return out
        raise CapacityRetryExceeded("exchange", fragment_id=frag.id, capacities=caps.vals,
                                    attempts=MAX_ATTEMPTS)

    def _record_fragment(self, fid: int, mode: str, t0: float, res: Result,
                         **extra) -> None:
        """EXPLAIN ANALYZE's record of one fragment (its wall time includes
        a device sync for the output row count); nothing without a
        collector."""
        if self.stats_collector is None:
            return
        self.stats_collector.record_fragment(fid, {
            "mode": mode, "output_rows": res.batch.count_rows(),
            "wall_s": time.perf_counter() - t0, **extra,
        })

    # --- programs (reference: run_fragment_program, run_fused_program) ------

    def run_fragment_program(self, frag: PlanFragment, root: P.PlanNode, inputs,
                             layouts, copied, skew=None) -> Result:
        """One fragment as one program (reference ``:1737``)."""
        caps = self._caps(frag.id)
        key = ("frag", frag.id, _root_key(root, frag.root))
        return self._retry_traced(caps, self._unit_fn([(frag, root)], layouts, caps, skew),
                                  inputs, copied, key)

    def run_fused_program(self, members, inputs, layouts, copied, skew=None) -> Result:
        """A fused unit as one program (reference ``:1802``): the members
        run back to back, each producer's result feeding its consumer's
        RemoteSource on the device, nothing read on the host between
        them."""
        fids = tuple(f.id for f, _ in members)
        caps = self._caps("fused", fids)
        key = ("fused", fids, tuple(_root_key(r, f.root) for f, r in members))
        return self._retry_traced(caps, self._unit_fn(members, layouts, caps, skew),
                                  inputs, copied, key)

    def _unit_fn(self, members, input_layouts, caps, skew=None):
        """``build(meta) -> fn(inputs) -> (result, words)``: the unit's
        device work over its inputs (the program's function). On N shards
        each member's output exchange runs in the program as collectives;
        a partitioned join's probe member hands its hot-key set to its
        build member inside the program, and the root's exchange takes
        ``skew`` (reference ``run_fused_program``, :1802-1935)."""

        from trino_tpu_torch.exec import programs as PR

        roles = self._skew_roles() if self.n_shards > 1 else {}
        member_ids = {f.id for f, _ in members}
        member_skew: dict[int, dict] = {}
        for frag, _ in members[:-1]:
            role = roles.get(frag.id)
            if role is None:
                continue
            if role["role"] == "probe":
                member_skew[frag.id] = {"detect": self._detect()}
            elif role["peer"] in member_ids:
                member_skew[frag.id] = {"salt": True, "peer": role["peer"]}

        def build(meta: _Meta):
            def fn(inp):
                avail = dict(inp)
                layouts = dict(input_layouts)
                combined = _TracerSummary()
                hot_sets: dict[int, tuple] = {}
                res = tracer = None
                for k, (frag, root) in enumerate(members):
                    last = k + 1 == len(members)
                    mskew = skew if last else member_skew.get(frag.id)
                    if not last and mskew is not None and mskew.get("salt"):
                        hs = hot_sets.get(mskew["peer"])
                        mskew = None
                        if hs is not None:
                            key = f"__hotset__{frag.id}"
                            avail[key] = _hotset_batch(hs)
                            mskew = {"salt": True, "hotset_key": key}
                    tracer = _FragmentTracer(
                        self, avail, layouts, caps, frag.id, root,
                        params=inp.get("__params__"), skew=mskew,
                    )
                    res = tracer.apply_output_exchange(frag, tracer._exec(root))
                    combined.absorb(tracer)
                    combined.overflows.extend(PR.take_deferred_errors())
                    if tracer.aux_out:
                        hot_sets[frag.id] = tracer.aux_out
                    if not last:
                        avail[f"remote{frag.id}"] = res.batch
                        layouts[f"remote{frag.id}"] = res.layout
                combined.exchange_static["dispatchRoundTrips"] = 1
                if tracer.aux_out:
                    res.aux = tracer.aux_out
                meta.capture(res, combined)
                return res, _Meta.words(combined, self.device)

            return fn

        return build

    def _program_inputs(self, inputs: dict, params=None) -> dict:
        params = self.params if params is None else params
        if params is None:
            return inputs
        return {**inputs, "__params__": params}

    def _program_key(self, key, inputs: dict, copied: set):
        from trino_tpu_torch.exec.programs import batch_signature

        # scans by position: a rewritten root names its scans anew
        sig = tuple(
            (k if k in copied else "scan", batch_signature(v, k not in copied))
            for k, v in inputs.items() if k != "__params__"
        )
        return key + (sig, None if self.params is None else tuple(self.params.shape))

    def _retry_traced(self, caps: _Caps, build, inputs: dict, copied: set,
                      key) -> Result:
        """Run a program under the capacity-overflow protocol (reference
        ``:1495``). A program stored under ``(key, caps.signature())``
        replays; otherwise its function runs eagerly, all its flags read
        in one host read, each fired site grows and it runs again; the run
        that fires nothing is the warm-up of its capture, stored under
        the signature it settled at. A flag that fires on a replay grows
        its site, and the next attempt captures again. An out-of-memory
        evicts the pool's least recently used programs (half their bytes,
        then all), then halves every capacity (``_Caps.shrink_all``)
        until the program fits. With ``device_profiling`` on, a new
        program's allocator stats are taken over its warm-up and capture,
        and every run counts an execution of its label."""
        from trino_tpu_torch.exec import programs as PR
        from trino_tpu_torch.obs.profiler import PeakWindow, capture_device_stats

        inputs = self._program_inputs(inputs)
        copied = set(copied) | ({"__params__"} if "__params__" in inputs else set())
        pkey = self._program_key(key, inputs, copied)
        store_stats = self.programs.setdefault(
            "__stats__", {"hits": 0, "misses": 0, "trace_count": 0, "compile_ms": 0.0}
        )
        evictions = 0
        for _ in range(MAX_ATTEMPTS):
            prog = self.programs.get((pkey, caps.signature()))
            try:
                if prog is not None:
                    self.compile_stats["program_cache_hits"] += 1
                    store_stats["hits"] += 1
                    if self.pool is not None:
                        self.pool.touch(self.programs, (pkey, caps.signature()))
                    # the inputs under the names the program was made with
                    named = dict(zip(prog.input_keys, inputs.values()))
                    # a program whose graph the budget took is captured
                    # again once its last capture's growth fits; this run
                    # is the warm-up
                    recorder = (PR.ConstantRecorder()
                                if self.pool is not None and self.pool.may_recapture(prog)
                                else None)
                    if recorder is not None:
                        with PR.program_run(), recorder.record():
                            res, words = prog.fn(named)
                    else:
                        res, words = PR.replay(self.pool, prog, named, copied)
                    vals = PR.host_read(words, self.exchange_stats)
                    if self._settle(prog.meta, vals, caps, fresh=()):
                        if recorder is not None:
                            PR.capture(self.pool, prog, named, copied, recorder)
                        if self._device_profiling:
                            self._record_device_stats(prog.label, prog.device_stats)
                        return res
                    continue
                meta = _Meta()
                fn = build(meta)
                sized_before = set(caps.vals)
                recorder = PR.ConstantRecorder()
                t0 = time.perf_counter()
                # the allocator's peak over the warm-up and the capture
                with PeakWindow(self.pool, self._device_profiling) as window:
                    with PR.program_run():
                        if self.pool is not None and self.pool.on_card:
                            with recorder.record():
                                res, words = fn(inputs)
                        else:
                            res, words = fn(inputs)
                    vals = PR.host_read(words, self.exchange_stats)
                    fresh = set(caps.vals) - sized_before
                    if not self._settle(meta, vals, caps, fresh):
                        del res, words
                        continue
                    fitted = self._fit_fresh(meta, vals, caps, fresh)
                    self.compile_stats["program_cache_misses"] += 1
                    store_stats["misses"] += 1
                    prog = PR.Program(pkey, program_label(key), fn, meta)
                    prog.input_keys = list(inputs)
                    if self.pool is not None:
                        PR.capture(self.pool, prog, inputs, copied, recorder)
                        self._store_program(pkey, caps.signature(), prog)
                if self._device_profiling:
                    prog.device_stats = capture_device_stats(prog, window.peak)
                if fitted and self.pool is not None:
                    # the result at the fitted capacities, shaped as every
                    # later run's: its consumers' programs then hold
                    del res, words
                    res, words = PR.replay(self.pool, prog, inputs, copied)
                    PR.host_read(words, self.exchange_stats)
                ms = prog.capture_ms if prog.graph is not None else (
                    (time.perf_counter() - t0) * 1000.0)
                self.compile_stats["trace_count"] += 1
                self.compile_stats["compile_ms"] += ms
                store_stats["trace_count"] += 1
                store_stats["compile_ms"] = round(store_stats["compile_ms"] + ms, 3)
                get_tracer().record("program_compile", ms, attrs={"key": prog.label})
                get_registry().histogram("trino_tpu_program_compile_ms").observe(ms)
                if self._device_profiling:
                    self._record_device_stats(prog.label, prog.device_stats, ms)
                return res
            except (FusedUnsupported, CapacityRetryExceeded, PR.CaptureError):
                raise  # NotCapturable too: the caller runs the fragment eagerly
            except Exception as e:  # noqa: BLE001 — inspect and rethrow
                if not _is_resource_exhausted(e):
                    raise
                # the least recently used half of the stored programs'
                # bytes first, then every program (which releases the
                # pool's segments), then the capacities
                if evictions < 2 and self.pool is not None and self.pool.evict_lru(
                    self.pool.held_bytes() // 2 if evictions == 0 else 0
                ):
                    evictions += 1
                    self._count("program_evictions")
                elif caps.shrink_all():
                    self._count("compile_halvings")
                    get_registry().counter("trino_tpu_compile_halvings_total").inc()
                    get_tracer().record("compile_halving", 0.0,
                                        attrs={"key": program_label(key)})
                else:
                    raise
        raise CapacityRetryExceeded(
            "traced-program", fragment_id=key[1], capacities=caps.vals,
            attempts=MAX_ATTEMPTS,
        )

    def _settle(self, meta: _Meta, vals: list, caps: _Caps, fresh) -> bool:
        """Act on one run's words: True when no flag fired (its counters
        then count); else the fired sites grow (to their counted need),
        the sites first sized in this run from rows an overflowed site
        may have cut short are sized again, and the run is retried."""
        nf, nn = len(meta.flag_names), len(meta.needed_names)
        flags, needed = vals[:nf], dict(zip(meta.needed_names, vals[nf:nf + nn]))
        fired = [nm for nm, f in zip(meta.flag_names, flags) if f]
        if not fired:
            self._accumulate(meta, vals[nf + nn:])
            return True
        for nm in set(fresh) - set(fired):
            caps.vals.pop(nm, None)
        for nm in fired:
            grow_or_raise(nm, caps, needed.get(nm))
        self.exchange_stats["overflow_retries"] += 1
        return False

    @staticmethod
    def _fit_fresh(meta: _Meta, vals: list, caps: _Caps, fresh) -> bool:
        """Aggregate sites first sized in the warm-up at their input's
        capacity shrink to the groups it counted, so the captured program
        holds that many (a literal variant that counts more regrows).
        True when a site shrank."""
        nf, nn = len(meta.flag_names), len(meta.needed_names)
        shrank = False
        for nm, need in zip(meta.needed_names, vals[nf:nf + nn]):
            if nm in fresh and nm.startswith("agg@"):
                fit = bucket_capacity(max(1, int(need)), minimum=1)
                if fit < caps.vals[nm]:
                    caps.vals[nm] = fit
                    shrank = True
        return shrank

    def _accumulate(self, meta: _Meta, counters: list) -> None:
        for k, v in meta.exchange_static.items():
            self._count(k, v)
        for nm, v in zip(meta.counter_names, counters):
            if not nm.startswith("op!"):
                # an exchange's counters (reference _accumulate_exchange)
                key = {"sent": "shuffle_rows", "salted": "salted_rows",
                       "hotkeys": "hot_keys"}[nm.split("@", 1)[0]]
                self._count(key, int(v))
                continue
            _, kind, io, site = nm.split("!", 3)
            ent = self.operator_stats.setdefault(
                site, {"kind": kind, "rows_in": 0, "rows_out": 0}
            )
            ent["rows_in" if io == "in" else "rows_out"] += int(v)

    def _store_program(self, pkey, sig, prog) -> None:
        """Store a program under ``(program_key, capacity signature)``
        (reference ``:593``). A fragment traced against a rewritten root
        (dynamic filtering) or other inputs than the stored one's evicts
        that one: one program a fragment and signature lives on."""
        prefix = pkey[:2]
        for k in [
            k for k in self.programs
            if isinstance(k, tuple) and len(k) == 2 and isinstance(k[0], tuple)
            and k[0][:2] == prefix and k[0] != pkey
        ]:
            old = self.programs.pop(k)
            if self.pool is not None:
                self.pool.forget(old)
        self.programs[(pkey, sig)] = prog
        if self.pool is not None:
            self.pool.touch(self.programs, (pkey, sig))

    # --- cross-query batching (reference: execute_batched, :1936-2367) -----

    def execute_batched(self, node: P.PlanNode, param_lists: list) -> tuple[list[Batch], list[str]]:
        """K literal variants of the plan this executor's entry holds, one
        result a member in submission order: each unit's program replays
        K times back to back, one parameter tensor a member, and the K
        members' words come back in one host read. Dynamic filtering is
        off on this path (a member's builds would prune another's
        probes); the loss is pruning only. Raises
        :class:`BatchUnsupported` for what it cannot carry (a streamed or
        eager fragment, an overflow inside the batch): the collector then
        runs the members one after the other, bit-identically."""
        from trino_tpu_torch.compiler import param_tensor

        if self.stats_collector is not None:
            raise BatchUnsupported("stats collector attached")
        if self.n_shards > 1:
            raise BatchUnsupported("a mesh of several shards")
        if not param_lists or not param_lists[0]:
            raise BatchUnsupported("no hoisted parameters")
        sub = self.programs.get("__subplan__")
        if sub is None:
            sub = fragment_plan(node, self.session)
            self.programs["__subplan__"] = sub
        if not query_fusable(sub):
            raise BatchUnsupported("plan not fusable")
        if self._fusion_blocked(sub):
            raise BatchUnsupported("streaming-sized scan")
        tensors = [param_tensor(pl, self.device) for pl in param_lists]
        self.params = tensors[0]
        self.exchange_stats["batchedQueries"] = len(tensors)
        results: list[dict[int, Result]] = [{} for _ in tensors]
        names_holder: dict[int, list[str]] = {}
        for unit in self._fusion_units(sub):
            frags = unit.fragments if isinstance(unit, FusedFragment) else (unit,)
            members, inputs, layouts, copied = [], [], None, None
            for k in range(len(tensors)):
                members, inp, layouts, copied = self._unit_inputs(
                    frags, results[k], names_holder, rewrite=False
                )
                inputs.append(inp)
            if isinstance(unit, FusedFragment):
                fids = tuple(f.id for f in frags)
                caps = self._caps("fused", fids)
                key = ("fused", fids, tuple(id(f.root) for f in frags))
                self._count("fusedFragments", len(frags))
            else:
                caps = self._caps(unit.id)
                key = ("frag", unit.id, id(unit.root))
            outs = self._replay_batch(
                caps, self._unit_fn(members, layouts, caps), inputs, tensors, copied, key
            )
            for k, out in enumerate(outs):
                results[k][unit.id] = out
            for frag in frags:
                self.fragment_modes[frag.id] = "materialized"
        names = names_holder.get(sub.fragment.id) or [
            s.name for s in sub.fragment.root.output_symbols
        ]
        return [r[sub.fragment.id].batch.compact() for r in results], names

    def _replay_batch(self, caps: _Caps, build, inputs: list, tensors: list,
                      copied: set, key) -> list[Result]:
        """One unit for the K members: the first member through
        ``_retry_traced`` when the program is not stored yet (its
        warm-up and capture), then the others' replays back to back and
        one host read of all their words."""
        from trino_tpu_torch.exec import programs as PR

        copied = set(copied) | {"__params__"}
        member_inputs = [self._program_inputs(i, p) for i, p in zip(inputs, tensors)]
        pkeys = {self._program_key(key, i, copied) for i in member_inputs}
        if len(pkeys) != 1:
            raise BatchUnsupported("members' inputs differ in shape")
        pkey = pkeys.pop()
        outs: list[Result] = []
        if self.programs.get((pkey, caps.signature())) is None:
            self.params = tensors[0]
            outs.append(self._retry_traced(caps, build, inputs[0], copied, key))
        prog = self.programs.get((pkey, caps.signature()))
        if prog is None:
            raise BatchUnsupported("no stored program")
        words = []
        for inp in member_inputs[len(outs):]:
            inp = dict(zip(prog.input_keys, inp.values()))
            res, w = PR.replay(self.pool, prog, inp, copied)
            outs.append(res)
            words.append(w)
        n = len(words)
        if self._device_profiling:
            for _ in range(n):
                self._record_device_stats(prog.label, prog.device_stats)
        self.compile_stats["program_cache_hits"] += n
        self.programs.setdefault("__stats__", {"hits": 0, "misses": 0, "trace_count": 0,
                                               "compile_ms": 0.0})["hits"] += n
        if words:
            rows = PR.host_read(torch.stack(words), self.exchange_stats)
            merged = _BatchSummary(prog.meta).merge(rows)
            nf = len(prog.meta.flag_names)
            if any(merged[:nf]):
                raise BatchUnsupported("a capacity overflowed inside the batch")
            self._accumulate(prog.meta, merged[nf + len(prog.meta.needed_names):])
        return outs

    # --- eager fragments ------------------------------------------------------

    def _run_with_retries(self, fid: int, root: P.PlanNode, inputs,
                          layouts, frag: Optional[PlanFragment] = None,
                          skew=None) -> Result:
        """Run a fragment that is not one program (a node the program path
        does not take) eagerly, under the same overflow protocol: its
        flags in one host read a run, each fired site grown."""
        from trino_tpu_torch.exec.programs import host_read

        caps = self._caps(fid)
        for _ in range(MAX_ATTEMPTS):
            sized_before = set(caps.vals)
            tracer = _FragmentTracer(self, inputs, layouts, caps, fid, root, skew=skew)
            res = tracer._exec(root)
            if frag is not None:
                res = tracer.apply_output_exchange(frag, res)
            meta = _Meta()
            summary = _TracerSummary()
            summary.absorb(tracer)
            meta.capture(res, summary)
            words = _Meta.words(summary, self.device)
            vals = host_read(words, self.exchange_stats) if words.numel() else []
            if self._settle(meta, vals, caps, set(caps.vals) - sized_before):
                res.aux = tracer.aux_out
                return res
            # the failed attempt's intermediates die before the rerun
            del tracer, res
        raise CapacityRetryExceeded(
            "materialized-fragment", fragment_id=fid, capacities=caps.vals,
            attempts=MAX_ATTEMPTS,
        )

    def _try_streaming(
        self, frag: PlanFragment, names_holder: dict[int, list[str]],
        results: dict[int, Result],
    ) -> Optional[Result]:
        """Scan→(join)→agg fragments over large tables run as a chunk loop
        with carried state (exec/streaming.py) instead of materializing
        the probe scan. The build sides' inputs materialize first: scans
        through the table cache (a build scan past
        ``spill_threshold_rows`` keeps the fragment materialized, as in
        the reference), remote sources from the completed upstream
        fragments. An overflowed group budget or join site grows
        (``grow_or_raise``) and the stream reruns, at most 12 times; the
        fragment's ``_Caps`` are kept in the entry's store. None when the
        shape or the table does not qualify, or the step meets a shape it
        does not take (``FusedUnsupported``, counted in
        ``stream_fallbacks``)."""
        from trino_tpu_torch.exec.streaming import (
            StreamingAggregator,
            StreamOverflow,
            streamable_chain,
        )

        chain = streamable_chain(frag.root)
        if chain is None:
            return None
        agg, scan, build_roots = chain
        connector = self.catalogs.get(scan.catalog)
        est = connector.estimate_rows(scan.schema, scan.table)
        if est is None or est <= int(
            self.session.get("stream_scan_threshold_rows")
        ):
            return None
        build_inputs: dict[str, Batch] = {}
        build_layouts: dict[str, dict[str, int]] = {}
        bound = int(self.session.get("spill_threshold_rows"))
        for root in build_roots:
            for n in P.walk_plan(root):
                if isinstance(n, P.TableScan):
                    best = self.catalogs.get(n.catalog).estimate_rows(n.schema, n.table)
                    if best is not None and best > bound:
                        return None
                    res = self._scan_batch(n)
                    build_inputs[f"scan{id(n)}"] = res.batch
                    build_layouts[f"scan{id(n)}"] = res.layout
                elif isinstance(n, P.RemoteSource):
                    upstream = results[n.fragment_id]
                    build_inputs[f"remote{n.fragment_id}"] = upstream.batch
                    build_layouts[f"remote{n.fragment_id}"] = upstream.layout
        caps = self._caps("stream", frag.id)
        for _ in range(MAX_ATTEMPTS):
            stream = StreamingAggregator(
                self, frag, agg, scan, caps, build_roots=build_roots,
                build_inputs=build_inputs, build_layouts=build_layouts,
            )
            try:
                res = stream.run()
                break
            except FusedUnsupported:
                self._count("stream_fallbacks")
                return None
            except StreamOverflow as e:
                for nm in e.fresh - set(e.names):
                    caps.vals.pop(nm, None)
                for nm in e.names:
                    grow_or_raise(nm, caps, e.needed.get(nm))
                self.exchange_stats["overflow_retries"] += 1
        else:
            raise CapacityRetryExceeded(
                "streaming", fragment_id=frag.id, capacities=caps.vals,
                attempts=MAX_ATTEMPTS,
            )
        if build_roots:
            self.exchange_stats.setdefault("join_streams", []).append(
                {"fragment": frag.id, "chunks": stream.chunks,
                 "builds": len(stream.builds)}
            )
        # the stream's shape: its steps, the parts (shards) a step and the
        # rows a part holds
        self.exchange_stats.setdefault("streams", []).append(
            {"fragment": frag.id, "steps": stream.chunks, "parts": stream.n,
             "shard_cap": stream.shard_cap}
        )
        if isinstance(frag.root, P.Output):
            names_holder[frag.id] = list(frag.root.column_names)
            cols = [res.column(s) for s in frag.root.symbols]
            res = Result(
                Batch(cols, res.batch.capacity, res.batch.sel, res.batch.device),
                {s.name: i for i, s in enumerate(frag.root.symbols)},
            )
        return res
