"""The port's tracer and metrics registry against the reference's.

The same sequence of calls through ``trino_tpu/obs`` and
``trino_tpu_torch/obs`` gives the same spans (ids renumbered, wall times
dropped: they are the process's and the clock's), the same trace headers,
and the same registry snapshot and Prometheus text, byte for byte. The
engine's and executors' spans of one query (``TestTracingIsInert``, the
reference's ``tests/test_observability.py`` case) have the reference's
names and parentage in both execution modes, cold and warm.
"""

import pytest

from trino_tpu.obs import metrics as ref_metrics
from trino_tpu.obs import trace as ref_trace
from trino_tpu_torch.obs import metrics as port_metrics
from trino_tpu_torch.obs import trace as port_trace

MODULES = {"reference": (ref_trace, ref_metrics), "port": (port_trace, port_metrics)}


def _trace_scenario(mod) -> dict:
    tracer = mod.Tracer()
    dark = tracer.start_span("dark")
    assert dark is mod.NOOP_SPAN and not tracer.enabled
    tracer.record("dark_record", 1.0)  # no sink: nothing recorded
    sink = mod.InMemorySpanSink(max_traces=3, max_spans_per_trace=5)
    tracer.add_sink(sink)
    root = tracer.start_span("query", trace_id="q1", attrs={"queryId": "q1", "user": "u"})
    with tracer.activate(root):
        with tracer.span("plan", attrs={"stage": 0}) as plan:
            plan.set("nodes", 7)
            tracer.record("compile", 12.5, attrs={"program": "frag:1"})
        with pytest.raises(ValueError):
            with tracer.span("execute"):
                raise ValueError("boom")
        ctx = tracer.context()
    header = mod.format_trace_header(ctx)
    remote = tracer.start_span("task", *mod.parse_trace_header(header))
    remote.finish(status="OK", rows=3)
    root.finish(status="ERROR", state="FAILED")
    root.finish(status="OK")  # idempotent
    tracer.record("over", 1.0, trace_id="q1")  # past max_spans_per_trace
    tracer.record("orphan", 2.0, trace_id="q2", status="ERROR")
    tracer.record("third", 3.0, trace_id="q3")
    out = {"traces": sink.trace_ids(), "current": tracer.current()}
    ids: dict = {}

    def renumber(span_id):
        if span_id is None:
            return None
        return ids.setdefault(span_id, f"s{len(ids)}")

    for trace_id in ("q1", "q2", "q3"):
        spans = []
        for s in sink.spans_for(trace_id):
            s = dict(s)
            s.pop("startMs")
            if s["name"] not in ("compile", "orphan", "third"):
                s.pop("durationMs")  # measured on the clock
            s["spanId"] = renumber(s["spanId"])
            s["parentId"] = renumber(s["parentId"])
            spans.append(s)
        out[trace_id] = spans
    tracer.record("fourth", 4.0, trace_id="q4")  # evicts the oldest trace
    out["after_eviction"] = sink.trace_ids()
    tracer.remove_sink(sink)
    tracer.record("after_removal", 5.0, trace_id="q5")
    out["after_removal"] = sink.trace_ids()
    return out


def test_tracer_spans_equal_the_reference():
    ref = _trace_scenario(ref_trace)
    port = _trace_scenario(port_trace)
    assert port == ref
    # the sequence reached what it meant to: parentage through the
    # header, the error span, the recorded durations, the bounds
    assert ref["traces"] == ["q1", "q2", "q3"]
    assert [s["name"] for s in ref["q1"]] == ["compile", "plan", "execute", "task", "query"]
    assert ref["q1"][2]["status"] == "ERROR" and ref["q1"][4]["status"] == "ERROR"
    assert ref["q1"][3]["parentId"] == ref["q1"][4]["spanId"]
    assert ref["after_eviction"] == ref["after_removal"] == ["q2", "q3", "q4"]


def test_tracer_parentage_within_one_trace():
    """Before eviction, q1 holds the root, its children and the remote
    task span parented through the header (both packages alike)."""
    shapes = {}
    for name, (trace, _) in MODULES.items():
        tracer = trace.Tracer()
        sink = trace.InMemorySpanSink()
        tracer.add_sink(sink)
        root = tracer.start_span("query", trace_id="q1")
        with tracer.activate(root):
            with tracer.span("plan"):
                pass
            header = trace.format_trace_header(tracer.context())
        tracer.start_span("task", *trace.parse_trace_header(header)).finish()
        root.finish()
        spans = sink.spans_for("q1")
        by_id = {s["spanId"]: s["name"] for s in spans}
        shapes[name] = sorted((s["name"], by_id.get(s["parentId"])) for s in spans)
        assert trace.TRACE_HEADER == "X-Trino-Trace"
    assert shapes["port"] == shapes["reference"] == [
        ("plan", "query"), ("query", None), ("task", "query")]


@pytest.mark.parametrize("value", [
    None, "", "q1", "q1;", ";s1", "q1;s1", " q1 ; s1 ", "q1;s1;extra", "t;s-9",
])
def test_trace_header_parse_equals_the_reference(value):
    assert port_trace.parse_trace_header(value) == ref_trace.parse_trace_header(value)


@pytest.mark.parametrize("ctx", [None, ("", "s1"), ("q1", "s1"), ("q1", "")])
def test_trace_header_format_equals_the_reference(ctx):
    assert port_trace.format_trace_header(ctx) == ref_trace.format_trace_header(ctx)


def _metrics_scenario(mod):
    reg = mod.MetricsRegistry()
    reg.counter("trino_tpu_queries_total", state="FINISHED").inc()
    reg.counter("trino_tpu_queries_total", state="FINISHED").inc(2)
    reg.counter("trino_tpu_queries_total", state="FAILED").inc()
    reg.counter("trino_tpu_requests_shed_total", reason='quo"te\\back\nline').inc()
    reg.counter("trino_tpu_output_rows_total").inc(15000)
    reg.gauge("trino_tpu_http_open_connections").set(3)
    g = reg.gauge("trino_tpu_resource_group_queued", group="global.alice")
    g.inc(4)
    g.dec(1.5)
    h = reg.histogram("trino_tpu_query_elapsed_ms")
    for v in (0.2, 3.0, 7.5, 42.0, 950.0, 12_000.0, 10 ** 7):
        h.observe(v)
    reg.histogram("trino_tpu_resource_group_queue_wait_ms", group="root").observe(5.0)
    reg.histogram("custom_s", buckets=(0.1, 1.0, 10.0)).observe(0.5)
    empty = reg.histogram("trino_tpu_empty_ms")
    assert empty.quantile(0.5) is None
    return reg


def test_registry_snapshot_equals_the_reference():
    assert _metrics_scenario(port_metrics).snapshot() == \
        _metrics_scenario(ref_metrics).snapshot()


def test_registry_text_equals_the_reference():
    text = _metrics_scenario(port_metrics).render_prometheus()
    assert text == _metrics_scenario(ref_metrics).render_prometheus()
    assert "# TYPE trino_tpu_queries_total counter" in text
    assert 'le="+Inf"' in text


def test_registry_reset_and_percentile_equal_the_reference():
    for reg in (_metrics_scenario(ref_metrics), _metrics_scenario(port_metrics)):
        reg.reset()
        assert reg.snapshot() == ref_metrics.MetricsRegistry().snapshot()
    for values, q in (([], 50.0), ([3.0], 99.0), ([5.0, 1.0, 4.0, 2.0], 50.0),
                      ([1.0, 2.0, 3.0, 100.0], 99.0), ([7.0, 7.0], 0.0)):
        assert port_metrics.percentile(values, q) == ref_metrics.percentile(values, q)


def test_engine_runtime_metrics_read_the_registry():
    """``system.runtime.metrics`` reads the port's registry, as the
    reference's reads its own (``trino_tpu/engine.py:265``)."""
    from trino_tpu_torch.config import Session
    from trino_tpu_torch.engine import Engine

    engine = Engine(device="cpu")
    engine.execute_statement("select 1", Session())
    res = engine.execute_statement(
        "select name, kind, value from system.runtime.metrics "
        "where name like 'trino_tpu_queries_total%'", Session())
    rows = dict((r[0], (r[1], r[2])) for r in res.rows)
    assert rows['trino_tpu_queries_total{state="FINISHED"}'][0] == "counter"
    assert rows['trino_tpu_queries_total{state="FINISHED"}'][1] >= 1
    assert engine.runtime_metrics() and all(len(r) == 3 for r in engine.runtime_metrics())


_INERT_SQL = (
    "select l_returnflag, sum(l_extendedprice * (1 - l_discount)) "
    "from tpch.tiny.lineitem group by l_returnflag order by l_returnflag"
)
_INERT_JOIN = (
    "select n_name, count(*) from tpch.tiny.nation join tpch.tiny.region "
    "on n_regionkey = r_regionkey where r_name <> 'ASIA' group by n_name "
    "order by n_name"
)


def _span_tree(trace, runner, sql, mode):
    """Each run's spans as (name, parent's name) in emission order, a
    cold run then a warm one; times and ids dropped. The tracer is global,
    so the sink may also see another thread's trace: the run's own is the
    one whose root ``query`` span carries the id of the statement this
    runner's engine ran (a standalone query's trace id is its query id)."""
    runner.session.set("execution_mode", mode)
    runs = []
    for _ in range(2):
        sink = trace.InMemorySpanSink()
        trace.get_tracer().add_sink(sink)
        try:
            rows = runner.execute(sql)[0]
        finally:
            trace.get_tracer().remove_sink(sink)
        tid = [r for r in runner.engine._recent_queries if r["query"] == sql][-1]["queryId"]
        spans = sink.spans_for(tid)
        roots = [s for s in spans if s["parentId"] is None]
        assert [s["name"] for s in roots] == ["query"], roots
        assert roots[0]["attrs"]["queryId"] == tid
        names = {s["spanId"]: s["name"] for s in spans}
        runs.append([(s["name"], names.get(s["parentId"])) for s in spans])
    return runs, rows


class TestTracingIsInert:
    """``tests/test_observability.py::TestTracingIsInert`` on the port: the
    engine's and executors' spans of the same query (cold, then warm)
    have the reference's names and parentage, and rows are identical with
    the tracer on and off."""

    @pytest.mark.parametrize("sql", [_INERT_SQL, _INERT_JOIN], ids=["groupby", "join"])
    @pytest.mark.parametrize("mode", ["local", "distributed"])
    def test_span_trees_equal_the_reference(self, mode, sql):
        from trino_tpu.testing import LocalQueryRunner as RefRunner
        from trino_tpu_torch.testing import LocalQueryRunner

        want, ref_rows = _span_tree(ref_trace, RefRunner(), sql, mode)
        got, rows = _span_tree(port_trace, LocalQueryRunner(device="cpu"), sql, mode)
        assert got == want
        assert rows == ref_rows
        assert ("query", None) in got[0] and ("plan", "query") in got[0]

    def test_rows_identical_with_tracer_on(self):
        from trino_tpu_torch.testing import LocalQueryRunner

        runner = LocalQueryRunner(device="cpu")
        dark, _ = runner.execute(_INERT_SQL)
        sink = port_trace.InMemorySpanSink()
        port_trace.get_tracer().add_sink(sink)
        try:
            lit, _ = runner.execute(_INERT_SQL)
        finally:
            port_trace.get_tracer().remove_sink(sink)
        assert lit == dark
        assert sink.trace_ids()
