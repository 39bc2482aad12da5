"""Fragmented execution of a distributed plan on one device.

Counterpart of ``trino_tpu/exec/fragments.py``: the plan is cut into
fragments at its exchanges (``planner/fragmenter.py``) and the fragments
run leaves first, each consumer reading its producers' results through
``RemoteSource`` nodes. This engine runs on a mesh of one device, so
every exchange (hash, broadcast, gather) is the identity.

A scan→(filter|project|join)*→aggregate fragment over a large table streams
(``exec/streaming.py``: the dense group-by kernel over the device-resident
slab, else the sort-based chunk step over the slab or host chunks, under
its own overflow retry; the joins on its probe spine build their tables
once and probe them with every chunk). Otherwise the fragment runs
materialized through :class:`_FragmentTracer`: completed build fragments
first prune its probe scans (dynamic filtering), then its joins run the
dense open-addressing tier (``ops/dense_join.py``, whose build is kernel
K2) or the sort tier, with fixed output capacities. Every capacity site
reports an overflow flag; the fragment reads all its flags in one host
read, grows each fired site (``_Caps``) and runs again, at most 12 times.

Nodes the reference's fused path does not trace run the local executor's
version inside the fragment: CROSS joins other than a scalar subquery,
LEFT joins with a non-equi ON filter (both through the sort tier),
windows, DISTINCT and set operations (the reference interprets a query
with any of them whole). FULL OUTER equi-joins trace: the probe runs as a
LEFT join that carries each build row's id, and the build rows no probe
row matched are appended after it.

A join site sizes its output to its matches on its first run (one host
read) and keeps that capacity; later runs of the same plan read nothing.
Capacities and the device table cache outlive the query (see
:class:`FragmentedExecutor`).

Not ported yet: fused multi-fragment programs, cross-query program
caching and batching, the history store, skew handling and operator
counters.
"""

from __future__ import annotations

from typing import Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, bucket_capacity
from trino_tpu_torch.exec.local import (
    SCALAR_ROWS_ERROR,
    ExecutionError,
    LocalExecutor,
    Result,
    agg_inputs_for,
    append_unmatched_build,
    bound_filter_mask,
    check_join_ported,
    flipped_right_join,
    join_output,
    mark_column,
    with_mark,
)
from trino_tpu_torch.ops import join as J
from trino_tpu_torch.ops.sort import sort_indices
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import PlanFragment, SubPlan, fragment_plan

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
                 builds: Optional[dict] = None):
        super().__init__(base.catalogs, base.session, base.device)
        self._inputs = inputs
        self._input_layouts = input_layouts
        self._memo: dict[int, Result] = {}
        self.caps = caps if caps is not None else _Caps()
        self.fragment_id = fragment_id
        self.overflows: list[tuple[str, torch.Tensor]] = []
        # output sites' match counts: an overflowed site grows to fit them
        self.needed: dict[str, torch.Tensor] = {}
        self._ordinals: dict[int, int] = {}
        if root is not None:
            joins = [n for n in P.walk_plan(root) if isinstance(n, P.Join)]
            self._ordinals = {id(n): k for k, n in enumerate(joins)}
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
        return self._memo[key]

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
        """(agg_inputs, specs) of an aggregate over ``res``."""
        try:
            agg_inputs, specs = agg_inputs_for(node, res)
        except ExecutionError as e:  # an unported aggregate shape
            raise FusedUnsupported(str(e)) from e
        return agg_inputs, specs

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
        """Final and partial TopN alike: on a mesh of one the partial
        step's shard (reference: TopNNode PARTIAL) is the whole input."""
        return self._traced_sort(self._exec(node.source), node.order_by, node.count)

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
        within the domain bound; with no history store ported, ``auto`` is
        ``dense``. Demoted sites are pinned to sort."""
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
        full = node.join_type == "FULL"
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
            mask = bound_filter_mask(expr, result.batch.columns, self.device)
            result = Result(
                Batch(result.batch.columns, cap, mask & out_sel), result.layout
            )
        return result

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
        pick = torch.argmax(rsel.to(torch.uint8))  # the first selected row
        has_row = cnt >= 1
        cap = left.batch.capacity
        cols = [left.column(s) for s in node.left.output_symbols]
        for s in node.right.output_symbols:
            c = right.column(s)
            val = c.data[pick]
            data = val.expand((cap,) + tuple(val.shape)).contiguous()
            valid = (c.valid_mask()[pick] & has_row).expand(cap).contiguous()
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


def _post_order(sub: SubPlan) -> list[PlanFragment]:
    """Fragments with every producer before its consumers."""
    out: list[PlanFragment] = []
    for child in sub.children:
        out.extend(_post_order(child))
    out.append(sub.fragment)
    return out


class FragmentedExecutor(LocalExecutor):
    """Distributed-mode executor: one plan fragment at a time.

    Capacities live in ``caps_store`` under ``(fingerprint, "join" |
    "stream", fragment id)``: the engine passes one store to every query
    with the fingerprint of its optimized plan, so a repeat of a query
    starts at the capacities its earlier runs grew to (reference: the
    ``("caps", frag.id)`` entries of the plan fingerprint's program store,
    ``trino_tpu/exec/fragments.py:1759``), and no other query's growth
    leaks into it. ``table_cache`` (a :class:`DeviceTableCache`) keeps
    scanned tables on the device across queries when the session's
    ``table_cache`` is on, within ``table_cache_bytes`` (the engine
    resolves the session's ``table_cache_max_bytes`` against the card,
    ``engine.table_cache_budget``)."""

    def __init__(self, catalogs, session, device,
                 caps_store: Optional[dict] = None, fingerprint: str = "",
                 table_cache=None, table_cache_bytes: int = 1 << 30,
                 memory_ctx=None):
        super().__init__(catalogs, session, device, memory_ctx=memory_ctx)
        self.exchange_stats: dict = {"overflow_retries": 0, "joinStrategy": {}}
        # fragment id -> "streamed" | "materialized" (which path ran)
        self.fragment_modes: dict[int, str] = {}
        self.caps_store: dict = caps_store if caps_store is not None else {}
        self.fingerprint = fingerprint
        # this query's materialized fragments' capacities, by fragment id
        self._caps: dict[int, _Caps] = {}
        self.table_cache = table_cache
        self.table_cache_bytes = table_cache_bytes
        self.ingest_stats: dict = {}

    def _fragment_caps(self, kind: str, fid: int) -> _Caps:
        return self.caps_store.setdefault((self.fingerprint, kind, fid), _Caps())

    def _scan_batch(self, node: P.TableScan) -> Result:
        """A fragment's table scan, through the device table cache when
        the session has it on (reference:
        ``trino_tpu/parallel/distributed.py:200-286``): a hit returns the
        device batch of an earlier scan of the same table version, columns
        and splits; a miss scans and admits the result."""
        if self.table_cache is None or not self.session.get("table_cache") or (
            node.limit is not None  # a limit hint stops reading early
        ):
            return LocalExecutor._exec_tablescan(self, node)
        from trino_tpu_torch.ingest import batch_nbytes, table_cache_key

        connector = self.catalogs.get(node.catalog)
        splits = self._scan_splits(node)
        key = table_cache_key(
            node.catalog, node.schema, node.table,
            connector.data_version(node.schema, node.table),
            node.column_names, splits, self.device,
        )
        stats = self.ingest_stats
        cached = self.table_cache.lookup(key)
        stats["tableCache"] = self.table_cache.snapshot()
        if cached is not None:
            stats["table_cache_hits"] = stats.get("table_cache_hits", 0) + 1
            return Result(cached, {s.name: i for i, s in enumerate(node.symbols)})
        stats["table_cache_misses"] = stats.get("table_cache_misses", 0) + 1
        res = LocalExecutor._exec_tablescan(self, node, splits)
        self.table_cache.admit(
            key, res.batch, batch_nbytes(res.batch), self.table_cache_bytes
        )
        stats["tableCache"] = self.table_cache.snapshot()
        return res

    def execute(self, node: P.PlanNode) -> tuple[Batch, list[str]]:
        return self._execute_fragments(fragment_plan(node, self.session))

    def _execute_fragments(self, sub: SubPlan) -> tuple[Batch, list[str]]:
        results: dict[int, Result] = {}
        names_holder: dict[int, list[str]] = {}
        for frag in _post_order(sub):
            results[frag.id] = self._run_fragment(frag, results, names_holder)
        for caps in self._caps.values():
            self.exchange_stats["joinStrategy"].update(caps.join_strategies)
        out = results[sub.fragment.id].batch.compact()
        names = names_holder.get(sub.fragment.id) or [
            s.name for s in sub.fragment.root.output_symbols
        ]
        return out, names

    def _df_build_lookup(self, results: dict[int, Result]):
        """Dynamic-filter domain accessor over completed fragment results:
        ``build_lookup(fid)`` gives ``(get_column, selected rows)``, where
        ``get_column(name)`` copies one build column and its live mask to
        the host, or None when the fragment has no result."""

        def build_lookup(fid):
            res = results.get(fid)
            if res is None:
                return None
            sel = res.batch.selection_mask()

            def get_column(name):
                idx = res.layout.get(name)
                if idx is None:
                    return None
                c = res.batch.columns[idx]
                return c.data.cpu().numpy(), (c.valid_mask() & sel).cpu().numpy()

            return get_column, int(sel.sum())

        return build_lookup

    def _run_fragment(
        self,
        frag: PlanFragment,
        results: dict[int, Result],
        names_holder: dict[int, list[str]],
    ) -> Result:
        streamed = self._try_streaming(frag, names_holder, results)
        if streamed is not None:
            self.fragment_modes[frag.id] = "streamed"
            return streamed
        from trino_tpu_torch.dynfilter import fragment_dynamic_filters

        # dynamic filtering: completed build fragments prune this
        # fragment's probe scans before any input materializes
        root = fragment_dynamic_filters(
            frag.root, self._df_build_lookup(results), self.session,
            self.dynamic_filters,
        )
        inputs: dict[str, Batch] = {}
        layouts: dict[str, dict[str, int]] = {}
        for n in P.walk_plan(root):
            if isinstance(n, P.TableScan):
                res = self._scan_batch(n)
                inputs[f"scan{id(n)}"] = res.batch
                layouts[f"scan{id(n)}"] = res.layout
            elif isinstance(n, P.RemoteSource):
                res = results[n.fragment_id]
                inputs[f"remote{n.fragment_id}"] = res.batch
                layouts[f"remote{n.fragment_id}"] = res.layout
            elif isinstance(n, P.Output):
                names_holder[frag.id] = list(n.column_names)
        self.fragment_modes[frag.id] = "materialized"
        # output exchanges are the identity on a mesh of one device
        return self._run_with_retries(frag.id, root, inputs, layouts)

    def _run_with_retries(self, fid: int, root: P.PlanNode, inputs,
                          layouts) -> Result:
        """Run a fragment under the capacity-overflow protocol: all its
        overflow flags come back in one host read per run; each fired site
        grows (``grow_or_raise``) and the fragment runs again."""
        caps = self._caps.setdefault(fid, self._fragment_caps("join", fid))
        for _ in range(MAX_ATTEMPTS):
            sized_before = set(caps.vals)
            tracer = _FragmentTracer(self, inputs, layouts, caps, fid, root)
            res = tracer._exec(root)
            if not tracer.overflows:
                return res
            needed = list(tracer.needed.items())
            read = torch.stack(
                [f.reshape(()).to(torch.int64) for _, f in tracer.overflows]
                + [t.reshape(()).to(torch.int64) for _, t in needed]
            ).cpu().tolist()
            flags, counts = read[: len(tracer.overflows)], read[len(tracer.overflows):]
            fired = [nm for (nm, _), f in zip(tracer.overflows, flags) if f]
            if not fired:
                return res
            totals = {nm: c for (nm, _), c in zip(needed, counts)}
            # sites first sized in this run from rows that an overflowed
            # site upstream may have cut short are sized again next run
            for nm in set(caps.vals) - sized_before - set(fired):
                del caps.vals[nm]
            for nm in fired:
                grow_or_raise(nm, caps, totals.get(nm))
            self.exchange_stats["overflow_retries"] += 1
            # the failed attempt's output and intermediates (the tracer's
            # memo of every node's output) die before the rerun allocates
            # its own
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
        fragment's ``_Caps`` are kept for later runs of the same plan
        (``caps_store``). None when the shape or the table does not
        qualify, or the step meets a shape it does not take
        (``FusedUnsupported``, counted in ``stream_fallbacks``)."""
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
        caps = self._fragment_caps("stream", frag.id)
        for _ in range(MAX_ATTEMPTS):
            stream = StreamingAggregator(
                self, frag, agg, scan, caps, build_roots=build_roots,
                build_inputs=build_inputs, build_layouts=build_layouts,
            )
            try:
                res = stream.run()
                break
            except FusedUnsupported:
                self.exchange_stats["stream_fallbacks"] = (
                    self.exchange_stats.get("stream_fallbacks", 0) + 1
                )
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
        for nm, strategy in caps.join_strategies.items():
            self.exchange_stats["joinStrategy"][nm] = strategy
        if isinstance(frag.root, P.Output):
            names_holder[frag.id] = list(frag.root.column_names)
            cols = [res.column(s) for s in frag.root.symbols]
            res = Result(
                Batch(cols, res.batch.capacity, res.batch.sel, res.batch.device),
                {s.name: i for i, s in enumerate(frag.root.symbols)},
            )
        return res
