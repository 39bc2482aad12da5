"""Execution statistics: per-node stats chain + EXPLAIN ANALYZE rendering.

Reference: ``operator/OperatorStats.java`` rolled up through
Driver→Pipeline→Task→Stage→Query (``operator/DriverContext.java``,
``execution/QueryStats.java``), surfaced by ``ExplainAnalyzeOperator.java:34``
via ``sql/planner/planprinter/PlanPrinter.java:148``.

Our executor materializes one plan node at a time, so stats attach per
plan node (the reference's per-operator granularity at our altitude); the
fragmented executor reports one record per fragment. The port's copy of
``trino_tpu/stats.py``: the per-node collector, the plan, fragment,
device-program, capacity, exchange and operator sections, and the
cluster's (``render_distributed_plan``, the stages of a cluster run).
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


def render_device_stats(device_stats: dict) -> str:
    """EXPLAIN ANALYZE section for the device profiler: each captured
    program's CUDA caching-allocator numbers (``obs/profiler.py``) and the
    query rollup. Every field is optional and rendered only when
    captured (on the CPU a program has executions and compile ms only)."""
    lines = ["Device programs (CUDA caching allocator):"]
    for label, st in sorted((device_stats.get("programs") or {}).items()):
        parts = [f"  {label}:"]
        if "flops" in st:
            parts.append(f"flops={st['flops']:.4g}")
        if "bytes_accessed" in st:
            parts.append(f"bytes_accessed={int(st['bytes_accessed']):,}")
        if "peak_hbm_bytes" in st:
            parts.append(f"peak_hbm={int(st['peak_hbm_bytes']):,}B")
        if st.get("compile_ms"):
            parts.append(f"compile={st['compile_ms']:.1f}ms")
        parts.append(f"executions={st.get('executions', 0)}")
        lines.append(" ".join(parts))
    totals = []
    if device_stats.get("total_flops") is not None:
        totals.append(f"total_flops={device_stats['total_flops']:.4g}")
    if device_stats.get("peak_hbm_bytes") is not None:
        totals.append(f"peak_hbm={int(device_stats['peak_hbm_bytes']):,}B")
    if totals:
        lines.append("  query: " + " ".join(totals))
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


def render_distributed_plan(
    node: P.PlanNode,
    cluster_stats: dict,
    device_stats: Optional[dict] = None,
) -> str:
    """Trino-style distributed EXPLAIN ANALYZE
    (``PlanPrinter.textDistributedPlan`` analog): the logical plan
    followed by one section per stage, annotated with task counts, rows,
    wall, exchange bytes / padding ratio, the output pages (bytes, the
    device-to-host read and the serialization), the tasks' execution
    paths, and per-stage FLOPs / peak device memory — all merged by the
    coordinator from every worker's shipped task stats
    (``server/cluster.py::_finalize_query``). A copy of the reference's
    with the page and path lines added."""
    lines = ["Distributed plan:", render_plan_with_stats(node, None, 1), ""]
    lines.append("Stages (stats merged from worker tasks):")
    for st in cluster_stats.get("stages") or []:
        lines.append(
            f"Stage {st.get('stage')} "
            f"[tasks: {st.get('tasks', 0)}, attempts: {st.get('attempts', 0)},"
            f" wall: {st.get('elapsedMs', 0.0):.1f}ms]"
        )
        parts = []
        if st.get("rows") is not None:
            parts.append(f"output rows: {st['rows']:,}")
        if st.get("inputRows") is not None:
            parts.append(f"input rows: {st['inputRows']:,}")
        if st.get("outputBytes") is not None:
            parts.append(f"output bytes: {st['outputBytes']:,}")
        if parts:
            lines.append("    " + "  ".join(parts))
        te = st.get("taskElapsedMs")
        if te:
            lines.append(
                f"    task wall p50/p99/max: {te['p50']:.1f}/"
                f"{te['p99']:.1f}/{te['max']:.1f} ms"
            )
        ex = st.get("exchange") or {}
        exparts = [
            f"{k}={ex[k]}"
            for k in (
                "shuffle_rows", "shuffle_bytes", "padding_ratio",
                "hot_keys", "salted_rows", "overflow_retries",
            )
            if ex.get(k)
        ]
        if exparts:
            lines.append("    exchange: " + " ".join(exparts))
        pg = st.get("pages") or {}
        if pg:
            lines.append(
                f"    pages: {int(pg.get('pages_out', 0)):,} "
                f"({int(pg.get('page_bytes_out', 0)):,}B), "
                f"d2h {pg.get('d2h_ms', 0.0):.1f}ms, "
                f"serialize {pg.get('serialize_ms', 0.0):.1f}ms"
            )
        paths = st.get("executionPaths") or {}
        if paths:
            lines.append("    paths: " + " ".join(
                f"{k}={v}" for k, v in sorted(paths.items())))
        stage_caps = ex.get("capacities")
        if isinstance(stage_caps, dict) and stage_caps:
            cparts = []
            for name, ent in sorted(
                stage_caps.items(),
                key=lambda kv: str(kv[1].get("site", kv[0])),
            ):
                if isinstance(ent, dict):
                    cparts.append(
                        f"{ent.get('site', name)}="
                        f"{ent.get('value')}({ent.get('provenance', '?')})"
                    )
            if cparts:
                lines.append("    capacities: " + " ".join(cparts))
        stage_ops = ex.get("operators")
        if isinstance(stage_ops, dict) and stage_ops:
            lines.append("    operators:")
            lines.extend(_operator_rows(stage_ops, indent="      "))
        dparts = []
        if st.get("flops") is not None:
            dparts.append(f"flops={st['flops']:.4g}")
        if st.get("peakHbmBytes") is not None:
            dparts.append(f"peak_hbm={int(st['peakHbmBytes']):,}B")
        if st.get("compileMs"):
            dparts.append(f"compile={st['compileMs']:.1f}ms")
        if dparts:
            lines.append("    device: " + " ".join(dparts))
    counters = []
    for key, lab in (
        ("task_retries", "task retries"),
        ("speculative_attempts", "speculative attempts"),
        ("speculative_wins", "speculative wins"),
    ):
        if cluster_stats.get(key):
            counters.append(f"{lab}: {cluster_stats[key]}")
    if counters:
        lines.append("    " + "  ".join(counters))
    if device_stats:
        lines.extend(["", render_device_stats(device_stats)])
    return "\n".join(lines)


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
