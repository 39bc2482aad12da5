"""Fragmented execution of a distributed plan on one device.

Counterpart of ``trino_tpu/exec/fragments.py``: the plan is cut into
fragments at its exchanges (``planner/fragmenter.py``) and the fragments
run leaves first, each consumer reading its producers' results through
``RemoteSource`` nodes. This engine runs on a mesh of one device, so
every exchange (hash, broadcast, gather) is the identity.

A scan→(filter|project)*→aggregate fragment over a large table streams
(``exec/streaming.py``: the dense group-by kernel over the device-resident
slab, else the sort-based chunk step over the slab or host chunks, under
its own overflow retry). Otherwise the fragment runs
materialized through :class:`_FragmentTracer`: completed build fragments
first prune its probe scans (dynamic filtering), then its joins run the
dense open-addressing tier (``ops/dense_join.py``, whose build is kernel
K2) or the sort tier, with fixed output capacities. Every capacity site
reports an overflow flag; the fragment reads all its flags in one host
read, grows each fired site (``_Caps``) and runs again, at most 12 times.

Not ported yet: fused multi-fragment programs, cross-query program
caching and batching, the history store, skew handling, streaming joins
on the probe spine (``_prebuild``), and operator counters.
"""

from __future__ import annotations

from typing import Optional

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, bucket_capacity
from trino_tpu_torch.exec.local import (
    ExecutionError,
    LocalExecutor,
    Result,
    agg_inputs_for,
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


def grow_or_raise(name: str, caps: "_Caps") -> None:
    """Act on one fired flag: capacity sites grow for a rerun; ``err!``
    names are data-dependent runtime errors and fail the query."""
    if name.startswith("err!"):
        raise ExecutionError(name[4:])
    caps.grow(name, 4 if name.startswith(("agg", "spill", "hot")) else 2)


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
                 root: Optional[P.PlanNode] = None):
        super().__init__(base.catalogs, base.session, base.device)
        self._inputs = inputs
        self._input_layouts = input_layouts
        self._memo: dict[int, Result] = {}
        self.caps = caps if caps is not None else _Caps()
        self.fragment_id = fragment_id
        self.overflows: list[tuple[str, torch.Tensor]] = []
        self._ordinals: dict[int, int] = {}
        if root is not None:
            joins = [n for n in P.walk_plan(root) if isinstance(n, P.Join)]
            self._ordinals = {id(n): k for k, n in enumerate(joins)}

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
        from trino_tpu_torch.parallel.distributed import _sharded_probe

        if node.join_type in ("SEMI", "ANTI"):
            return self._exec_semi_join_traced(node)
        if node.join_type == "RIGHT":
            flipped = flipped_right_join(node)
            self._ordinals[id(flipped)] = self._ordinals.get(id(node), 0)
            return self._exec_join(flipped)
        check_join_ported(node)
        right = self._exec(node.right)
        left = self._exec(node.left)
        lkeys, rkeys = self._join_keys(left, right, node.criteria)
        ph, _ = J.hash_keys(lkeys)
        bh, _ = J.hash_keys(rkeys)
        probe_cols, build_cols, probe_keys, build_keys = [], [], [], []
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
        cap = self.caps.get(
            join_site, bucket_capacity(max(1024, 2 * left.batch.capacity))
        )
        strategy = self._join_strategy(node, lkeys)
        self.caps.join_strategies[dense_site] = strategy
        table_cap = None
        if strategy != "sort":
            # table slots: 4x the build rows (load factor <= 0.25: linear
            # probe clusters coalesce past the static window at 0.5)
            table_cap = self.caps.get(
                dense_site, bucket_capacity(max(1024, 4 * right.batch.capacity))
            )
        res = _sharded_probe(
            probe_cols, probe_keys, ph, left.batch.selection_mask(),
            build_cols, build_keys, bh, right.batch.selection_mask(),
            cap, node.join_type, len(lkeys),
            strategy=strategy, table_cap=table_cap,
        )
        if strategy == "sort":
            out_cols, out_sel, ovf = res
        else:
            out_cols, out_sel, ovf, table_ovf = res
            # graceful overflow: the rerun doubles the table and re-hashes
            self.overflows.append((dense_site, table_ovf))
        self.overflows.append((join_site, ovf))
        result = join_output(node, left, right, out_cols, cap, out_sel)
        if node.filter is not None:  # INNER only (check_join_ported)
            from trino_tpu_torch.compiler import ExprCompiler

            expr = self._bind(node.filter, result.layout)
            mask = ExprCompiler(result.batch.columns, device=self.device).predicate_mask(expr)
            result = Result(
                Batch(result.batch.columns, cap, mask & out_sel), result.layout
            )
        return result

    def _exec_semi_join_traced(self, node: P.Join) -> Result:
        """SEMI/ANTI as a membership mark: probe rows carry only their row
        id through the sort-tier probe, and the matches scatter back into a
        boolean mark column (reference: ``HashSemiJoinOperator.java`` —
        mark semantics incl. 3-valued IN). A residual correlated filter
        runs the local executor's version."""
        from trino_tpu_torch.parallel.distributed import _sharded_probe

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
        lkeys, rkeys = self._join_keys(left, right, node.criteria)
        ph, _ = J.hash_keys(lkeys)
        bh, bv_all = J.hash_keys(rkeys)
        row_ids = torch.arange(cap, dtype=torch.int64, device=lsel.device)
        probe_keys, build_keys = [], []
        for kd, kv in lkeys:
            probe_keys += [kd, kv]
        for kd, kv in rkeys:
            build_keys += [kd, kv]
        site = self._site("semi", node)
        out_cap = self.caps.get(site, bucket_capacity(max(1024, 2 * cap)))
        out_cols, out_sel, ovf = _sharded_probe(
            [row_ids, torch.ones_like(lsel)], probe_keys, ph, lsel,
            [], build_keys, bh, bsel, out_cap, "INNER", len(lkeys),
        )
        self.overflows.append((site, ovf))
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
    """Distributed-mode executor: one plan fragment at a time."""

    def __init__(self, catalogs, session, device,
                 stream_caps: Optional[dict] = None):
        super().__init__(catalogs, session, device)
        self.exchange_stats: dict = {"overflow_retries": 0, "joinStrategy": {}}
        # fragment id -> "streamed" | "materialized" (which path ran)
        self.fragment_modes: dict[int, str] = {}
        self._caps: dict[int, _Caps] = {}
        # streamed fragments' capacities by fragment id; the engine passes
        # one dict to every query so grown budgets are kept
        self.stream_caps: dict[int, _Caps] = (
            stream_caps if stream_caps is not None else {}
        )

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
        streamed = self._try_streaming(frag, names_holder)
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
                res = LocalExecutor._exec_tablescan(self, n)
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
        caps = self._caps.setdefault(fid, _Caps())
        for _ in range(MAX_ATTEMPTS):
            tracer = _FragmentTracer(self, inputs, layouts, caps, fid, root)
            res = tracer._exec(root)
            if not tracer.overflows:
                return res
            flags = torch.stack(
                [f.reshape(()).to(torch.int32) for _, f in tracer.overflows]
            ).cpu().tolist()
            fired = [nm for (nm, _), f in zip(tracer.overflows, flags) if f]
            if not fired:
                return res
            for nm in fired:
                grow_or_raise(nm, caps)
            self.exchange_stats["overflow_retries"] += 1
        raise CapacityRetryExceeded(
            "materialized-fragment", fragment_id=fid, capacities=caps.vals,
            attempts=MAX_ATTEMPTS,
        )

    def _try_streaming(
        self, frag: PlanFragment, names_holder: dict[int, list[str]]
    ) -> Optional[Result]:
        """Scan→agg fragments over large tables run as a chunk loop with
        carried state (exec/streaming.py) instead of materializing the
        scan. An overflowed group budget grows (``grow_or_raise``) and the
        stream reruns, at most 12 times; the fragment's ``_Caps`` are kept
        across queries (``stream_caps``). None when the shape or the table
        does not qualify."""
        from trino_tpu_torch.exec.streaming import (
            StreamingAggregator,
            StreamOverflow,
            streamable_chain,
        )

        chain = streamable_chain(frag.root)
        if chain is None:
            return None
        agg, scan, build_roots = chain
        if build_roots:
            return None  # joins on the probe spine: not ported yet
        connector = self.catalogs.get(scan.catalog)
        est = connector.estimate_rows(scan.schema, scan.table)
        if est is None or est <= int(
            self.session.get("stream_scan_threshold_rows")
        ):
            return None
        caps = self.stream_caps.setdefault(frag.id, _Caps())
        for _ in range(MAX_ATTEMPTS):
            try:
                res = StreamingAggregator(self, frag, agg, scan, caps).run()
                break
            except FusedUnsupported:
                return None
            except StreamOverflow as e:
                for nm in e.names:
                    grow_or_raise(nm, caps)
                self.exchange_stats["overflow_retries"] += 1
        else:
            raise CapacityRetryExceeded(
                "streaming", fragment_id=frag.id, capacities=caps.vals,
                attempts=MAX_ATTEMPTS,
            )
        if isinstance(frag.root, P.Output):
            names_holder[frag.id] = list(frag.root.column_names)
            cols = [res.column(s) for s in frag.root.symbols]
            res = Result(
                Batch(cols, res.batch.capacity, res.batch.sel, res.batch.device),
                {s.name: i for i, s in enumerate(frag.root.symbols)},
            )
        return res
