"""Execution statistics: per-node stats chain + EXPLAIN ANALYZE rendering.

Reference: ``operator/OperatorStats.java`` rolled up through
Driver→Pipeline→Task→Stage→Query (``operator/DriverContext.java``,
``execution/QueryStats.java``), surfaced by ``ExplainAnalyzeOperator.java:34``
via ``sql/planner/planprinter/PlanPrinter.java:148``.

Our executor materializes one plan node at a time, so stats attach per
plan node (the reference's per-operator granularity at our altitude); the
fragmented executor reports one record per fragment. The port's copy of
``trino_tpu/stats.py``: the per-node collector, the plan, fragment and
capacity sections. The device-program, operator-counter and cluster
sections (``render_device_stats``, ``render_operator_stats``,
``render_distributed_plan``) read the profiler, the fused path's operator
counters and the cluster, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from trino_tpu_torch.planner import plan as P


@dataclasses.dataclass
class NodeStats:
    """One plan node's execution record (OperatorStats analog)."""

    node_type: str
    wall_seconds: float = 0.0
    output_rows: int = 0
    output_bytes: int = 0
    detail: str = ""


class StatsCollector:
    """Keyed by plan-node identity; nodes kept alive by the plan itself."""

    def __init__(self):
        self.by_node: dict[int, NodeStats] = {}
        self._inclusive: dict[int, float] = {}
        self._keep: list = []  # retain node refs so id() stays valid
        # fused execution reports per-FRAGMENT stats (one compiled program
        # per fragment has no per-operator boundaries to time)
        self.fragments: list[dict] = []

    def record_fragment(self, fragment_id, info: dict) -> None:
        self.fragments.append({"fragment": fragment_id, **info})

    def record(self, node, wall: float, rows: int, bytes_: int, detail: str = ""):
        """``wall`` is inclusive of children (the executor times the whole
        subtree); stored per-node time is exclusive — children's inclusive
        times are subtracted so nothing double-counts."""
        self._keep.append(node)
        self._inclusive[id(node)] = wall
        children = sum(self._inclusive.get(id(s), 0.0) for s in node.sources)
        self.by_node[id(node)] = NodeStats(
            type(node).__name__, max(0.0, wall - children), rows, bytes_, detail
        )

    def total_wall(self) -> float:
        if self.by_node:
            return sum(s.wall_seconds for s in self.by_node.values())
        return sum(f.get("wall_s", 0.0) for f in self.fragments)


def render_fragment_stats(fragments: list[dict]) -> str:
    """EXPLAIN ANALYZE section for fused execution: one compiled program
    per fragment (ref ExplainAnalyzeOperator.java:34 — here the unit of
    profiling matches the unit of compilation)."""
    lines = ["Fragments (fused single-program execution):"]
    for f in fragments:
        parts = [
            f"  fragment {f['fragment']}: mode={f.get('mode', 'fused')}",
            f"wall={f.get('wall_s', 0.0) * 1000:.1f}ms",
        ]
        # only report what was actually measured (streamed fragments have
        # no single compile attempt count or static input size)
        if "attempts" in f:
            parts.append(f"compile_attempts={f['attempts']}")
        if "input_rows" in f:
            parts.append(f"input_rows={f['input_rows']:,}")
        parts.append(f"output_rows={f.get('output_rows', 0):,}")
        lines.append(" ".join(parts))
    return "\n".join(lines)


def render_capacity_stats(capacities: dict) -> str:
    """EXPLAIN ANALYZE section for capacity sites: final value +
    provenance per site, with the estimated-vs-observed drift summary.
    A ``+grown``/``+halved`` suffix marks exactly where the estimate
    (default or seeded) missed and the retry ladder had to correct it;
    ``history``-provenance sites started from observed truth
    (obs/history.py) and should show no suffix on warm repeats."""
    lines = ["Capacity sites (final value, provenance):"]
    grown = halved = history = 0
    for name, ent in sorted(
        capacities.items(), key=lambda kv: str(kv[1].get("site", kv[0]))
    ):
        prov = str(ent.get("provenance", "default"))
        lines.append(f"  {ent.get('site', name)}: {ent.get('value')} ({prov})")
        if "+grown" in prov:
            grown += 1
        if "+halved" in prov:
            halved += 1
        if prov.startswith("history"):
            history += 1
    lines.append(
        f"  estimated vs observed: {grown} grown, {halved} halved, "
        f"{history} history-seeded of {len(capacities)} sites"
    )
    return "\n".join(lines)


EXCHANGE_FIELDS = ("exchanges", "shuffle_rows", "padded_shuffle_rows", "shuffle_bytes",
                   "padding_ratio", "hot_keys", "salted_rows", "overflow_retries")


def render_exchange_stats(exchange_stats: dict) -> str:
    """EXPLAIN ANALYZE section for a run on N shards: the query's exchange
    counters (the reference's stage ``exchange:`` line, ``:210-220``):
    hash exchanges run, live rows shuffled, the wire slots they padded
    to, their bytes, the padding ratio, hot keys and salted rows of the
    skew handling, and overflow reruns. The ``exch@`` sites' rows in and
    out are in the operator section."""
    parts = [f"{k}={exchange_stats.get(k, 0)}" for k in EXCHANGE_FIELDS]
    return "Exchanges (all shards):\n  " + " ".join(parts)


def render_plan_with_stats(
    node: P.PlanNode, collector: Optional[StatsCollector], indent: int = 0
) -> str:
    """PlanPrinter.textDistributedPlan-with-stats analog: the logical plan
    annotated with wall time / rows / bytes per node."""
    pad = "  " * indent
    line = f"{pad}{P.node_label(node)}"
    if collector is not None:
        st = collector.by_node.get(id(node))
        if st is not None:
            line += (
                f"   [wall: {st.wall_seconds * 1000:.1f}ms, "
                f"rows: {st.output_rows:,}, bytes: {st.output_bytes:,}]"
            )
    out = [line]
    for s in node.sources:
        out.append(render_plan_with_stats(s, collector, indent + 1))
    return "\n".join(out)


def _operator_rows(operators: dict, indent: str = "  ") -> list[str]:
    """One line per operator site: kind, rows in/out, selectivity
    (rows_out / rows_in; broadcast exchanges exceed 1.0 by design)."""
    lines = []
    for site, ent in sorted(operators.items()):
        if not isinstance(ent, dict):
            continue
        rin = int(ent.get("rows_in", 0) or 0)
        rout = int(ent.get("rows_out", 0) or 0)
        sel = f"{rout / rin:.4f}" if rin > 0 else "-"
        lines.append(
            f"{indent}{site}: {ent.get('kind', '?')} "
            f"rows_in={rin:,} rows_out={rout:,} selectivity={sel}"
        )
    return lines


def render_operator_stats(operators: dict) -> str:
    """EXPLAIN ANALYZE section for in-program operator telemetry
    (exec/fragments.py ``op!`` counter channel): per-site row flow keyed
    by restart-stable names. Partial-agg selectivity here IS the
    per-exchange reduction ratio the mid-query-adaptivity roadmap item
    consumes from history."""
    lines = ["Operators (in-program row flow, by stable site):"]
    lines.extend(_operator_rows(operators))
    ratios = [
        int(e.get("rows_out", 0) or 0) / max(1, int(e.get("rows_in", 0) or 0))
        for e in operators.values()
        if isinstance(e, dict)
        and e.get("kind") == "partial-agg"
        and int(e.get("rows_in", 0) or 0) > 0
    ]
    if ratios:
        lines.append(
            f"  worst partial-agg reduction ratio: {max(ratios):.4f}"
        )
    return "\n".join(lines)
