"""Fragmented execution of a distributed plan on one device.

Counterpart of ``trino_tpu/exec/fragments.py``: the plan is cut into
fragments at its exchanges (``planner/fragmenter.py``) and the fragments
run leaves first, each consumer reading its producers' results through
``RemoteSource`` nodes. This engine runs on a mesh of one device, so
every exchange (hash, broadcast, gather) is the identity.

A scan→(filter|project)*→partial-aggregate fragment over a large table
tries the streaming path first (``exec/streaming.py``: the device-resident
slab and the dense group-by kernel); otherwise the fragment runs
materialized through the local operators, with the partial and final
aggregate steps of :class:`~trino_tpu_torch.exec.local.LocalExecutor`.
Not ported yet: fused multi-fragment programs, cross-query program
batching, the capacity-retry ladder, skew handling and operator counters.
"""

from __future__ import annotations

from typing import Optional

from trino_tpu_torch.columnar import Batch
from trino_tpu_torch.exec.local import (
    ExecutionError,
    LocalExecutor,
    Result,
    agg_inputs_for,
)
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import PlanFragment, SubPlan, fragment_plan


class FusedUnsupported(Exception):
    """A fragment shape the streaming path does not take."""


class _FragmentTracer(LocalExecutor):
    """Executes one fragment's node chain over given inputs: table scans
    and remote sources read batches handed in by the caller (keyed
    ``scan{id(node)}`` / ``remote{fragment_id}``) instead of connectors."""

    def __init__(self, base: LocalExecutor, inputs, input_layouts):
        super().__init__(base.catalogs, base.session, base.device)
        self._inputs = inputs
        self._input_layouts = input_layouts
        self._memo: dict[int, Result] = {}

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
        return Result(Batch(cols, res.batch.num_rows, res.batch.sel), layout)

    def _agg_inputs(self, node: P.Aggregate, res: Result):
        """(agg_inputs, specs) of an aggregate over ``res``."""
        try:
            agg_inputs, specs = agg_inputs_for(node, res)
        except ExecutionError as e:  # an unported aggregate shape
            raise FusedUnsupported(str(e)) from e
        return agg_inputs, specs


def _post_order(sub: SubPlan) -> list[PlanFragment]:
    """Fragments with every producer before its consumers."""
    out: list[PlanFragment] = []
    for child in sub.children:
        out.extend(_post_order(child))
    out.append(sub.fragment)
    return out


class FragmentedExecutor(LocalExecutor):
    """Distributed-mode executor: one plan fragment at a time."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.exchange_stats: dict = {"overflow_retries": 0}
        # fragment id -> "streamed" | "materialized" (which path ran)
        self.fragment_modes: dict[int, str] = {}

    def execute(self, node: P.PlanNode) -> tuple[Batch, list[str]]:
        return self._execute_fragments(fragment_plan(node, self.session))

    def _execute_fragments(self, sub: SubPlan) -> tuple[Batch, list[str]]:
        results: dict[int, Result] = {}
        names_holder: dict[int, list[str]] = {}
        for frag in _post_order(sub):
            results[frag.id] = self._run_fragment(frag, results, names_holder)
        out = results[sub.fragment.id].batch.compact()
        names = names_holder.get(sub.fragment.id) or [
            s.name for s in sub.fragment.root.output_symbols
        ]
        return out, names

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
        inputs: dict[str, Batch] = {}
        layouts: dict[str, dict[str, int]] = {}
        for n in P.walk_plan(frag.root):
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
        return _FragmentTracer(self, inputs, layouts)._exec(frag.root)

    def _try_streaming(
        self, frag: PlanFragment, names_holder: dict[int, list[str]]
    ) -> Optional[Result]:
        """Scan→agg fragments over large tables run over the connector's
        device-resident slab (exec/streaming.py) instead of materializing
        the scan; None when the shape or the table does not qualify."""
        from trino_tpu_torch.exec.streaming import (
            StreamingAggregator,
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
        res = StreamingAggregator(self, frag, agg, scan).run()
        if res is None:
            return None
        if isinstance(frag.root, P.Output):
            names_holder[frag.id] = list(frag.root.column_names)
            cols = [res.column(s) for s in frag.root.symbols]
            res = Result(
                Batch(cols, res.batch.capacity, res.batch.sel),
                {s.name: i for i, s in enumerate(frag.root.symbols)},
            )
        return res
