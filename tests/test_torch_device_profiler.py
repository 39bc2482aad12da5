"""The device profiler through trino_tpu_torch, against the reference.

The cases of ``tests/test_device_profiler.py``:

- the rollup, the merge and the finite filter: the same dicts through
  both packages' functions give the same results;
- capture, with this package's premise: a program's stats come from the
  CUDA caching allocator at its capture (``obs/profiler.py``), so on the
  CPU, where nothing is captured, a query's entries carry ``executions``
  and ``compile_ms`` only, as the reference's degraded backend does;
  ``capture_device_stats`` is held to its fields on a captured program's
  stand-in;
- EXPLAIN ANALYZE's device section, profiling on and off (identical rows,
  and the off run replays the on run's programs: ``device_profiling`` is
  no part of a fingerprint), the system tables, Prometheus conformance
  and bounded retention.
"""

import pytest
import torch

from trino_tpu.obs import profiler as ref_profiler
from trino_tpu_torch.config import Session
from trino_tpu_torch.obs import profiler as port_profiler

torch.set_num_threads(1)

Q_AGG = (
    "select o_orderpriority, count(*) c from tpch.tiny.orders "
    "where o_orderkey <= 6000 group by o_orderpriority "
    "order by o_orderpriority"
)


@pytest.fixture(scope="module")
def runner():
    from trino_tpu_torch.testing import DistributedQueryRunner

    return DistributedQueryRunner(device="cpu")


class TestCapture:
    def test_fragment_programs_recorded(self, runner):
        res = runner.engine.execute_statement(Q_AGG, runner.session)
        ds = res.device_stats
        assert ds is not None
        programs = ds["programs"]
        assert any(label.startswith(("frag:", "fused:")) for label in programs)
        assert ds["programs_profiled"] == len(programs)
        for st in programs.values():
            assert st["executions"] >= 1
            # nothing is captured on the CPU: no allocator fields
            assert set(st) <= {"executions", "compile_ms"}
        assert "peak_hbm_bytes" not in ds and "total_flops" not in ds

    def test_warm_cache_reuses_stats_without_recapture(self, runner):
        sql = Q_AGG.replace("6000", "5000")
        cold = runner.engine.execute_statement(sql, runner.session)
        warm = runner.engine.execute_statement(sql, runner.session)
        assert warm.rows == cold.rows
        assert warm.trace_count == 0 and warm.program_cache_hits > 0
        assert warm.device_stats is not None
        assert set(warm.device_stats["programs"]) >= {
            label for label in (cold.device_stats or {}).get("programs", {})
            if label.startswith(("frag:", "fused:"))
        }
        for st in warm.device_stats["programs"].values():
            assert st["compile_ms"] == 0.0

    def test_explain_analyze_device_section(self, runner):
        rows, _ = runner.execute("explain analyze " + Q_AGG)
        text = "\n".join(r[0] for r in rows)
        assert "Device programs (CUDA caching allocator)" in text
        assert "frag:" in text or "fused:" in text
        assert "executions=" in text

    def test_profiler_on_off_bit_identical(self, runner):
        sql = Q_AGG.replace("6000", "4000")
        on = runner.engine.execute_statement(sql, runner.session)
        assert on.device_stats is not None
        off = runner.engine.execute_statement(sql, Session(properties={
            "execution_mode": "distributed", "device_profiling": False}))
        assert off.device_stats is None
        assert on.rows == off.rows
        assert off.trace_count == 0 and off.program_cache_hits > 0

    def test_degraded_capture_reporting_nothing(self, runner, monkeypatch):
        monkeypatch.setattr(port_profiler, "capture_device_stats",
                            lambda program, window_peak=None: None)
        res = runner.engine.execute_statement(Q_AGG.replace("6000", "3000"), runner.session)
        assert res.rows
        for st in (res.device_stats or {"programs": {}})["programs"].values():
            assert st["executions"] >= 1


class TestProfilerUnit:
    @pytest.mark.parametrize("value", [-1, float("nan"), float("inf"), True, "3", 3.5, 0, 7])
    def test_finite_filters_unknown(self, value):
        assert port_profiler._finite(value) == ref_profiler._finite(value)

    def test_merge_accumulates_executions(self):
        out = {}
        for name, mod in (("reference", ref_profiler), ("port", port_profiler)):
            target: dict = {}
            mod.merge_device_stats(target, {"frag:1": {"executions": 1, "flops": 5.0,
                                                       "compile_ms": 10.0}})
            mod.merge_device_stats(target, {"frag:1": {"executions": 2, "flops": 5.0,
                                                       "compile_ms": 0.0},
                                            "fused:2+1": {"peak_hbm_bytes": 7}, "bad": 3})
            mod.merge_device_stats(target, None)
            out[name] = target
        assert out["port"] == out["reference"]
        assert out["port"]["frag:1"] == {"executions": 3, "compile_ms": 10.0, "flops": 5.0}

    @pytest.mark.parametrize("programs", [
        {"a": {"executions": 2, "flops": 10.0, "peak_hbm_bytes": 100},
         "b": {"executions": 1, "flops": 1.0, "peak_hbm_bytes": 300},
         "c": {"executions": 4}},
        {"frag:0": {"executions": 3, "compile_ms": 1.5}},
        {"fused:2+1+0": {"executions": 0, "argument_bytes": 10, "output_bytes": 4,
                         "temp_bytes": 8, "peak_hbm_bytes": 22, "bytes_accessed": 9.0}},
        {},
    ])
    def test_rollup_equals_the_reference(self, programs):
        got = port_profiler.rollup_device_stats(programs)
        assert got == ref_profiler.rollup_device_stats(programs)
        if "b" in programs:
            assert got["total_flops"] == 21.0 and got["peak_hbm_bytes"] == 300

    def _program(self, graph=True, capture_bytes=4096):
        """A captured program's stand-in: the attributes the profiler
        reads, on CPU tensors (two inputs sharing one storage)."""
        from types import SimpleNamespace

        from trino_tpu_torch import types as T
        from trino_tpu_torch.columnar import Batch, Column

        base = torch.zeros(256, dtype=torch.int64)
        col = Column(T.BIGINT, base[:128], torch.ones(128, dtype=torch.bool))
        inputs = {"scan0": Batch([col], 128), "__params__": base[128:]}
        out = Batch([Column(T.BIGINT, torch.zeros(64, dtype=torch.int64))], 64)
        return SimpleNamespace(
            graph=object() if graph else None, static_inputs=inputs,
            static_result=SimpleNamespace(batch=out),
            static_words=torch.zeros(3, dtype=torch.int64), capture_bytes=capture_bytes,
        )

    def test_capture_fields_from_the_allocator(self):
        prog = self._program()
        st = port_profiler.capture_device_stats(prog)
        # the inputs' one storage (2048 bytes) and its mask (128 bytes)
        assert st["argument_bytes"] == 2048 + 128
        assert st["output_bytes"] == 64 * 8 + 3 * 8
        assert st["temp_bytes"] == 4096 == prog.capture_bytes
        # no window: the conservative sum, as the reference's fallback
        assert st["peak_hbm_bytes"] == st["argument_bytes"] + st["output_bytes"] + 4096
        assert "flops" not in st and "bytes_accessed" not in st

    def test_capture_peak_from_a_window(self):
        prog = self._program()
        st = port_profiler.capture_device_stats(prog, window_peak=10_000)
        assert st["peak_hbm_bytes"] == 10_000 + st["argument_bytes"]
        # never below what the program holds at once
        low = port_profiler.capture_device_stats(prog, window_peak=0)
        assert low["peak_hbm_bytes"] == low["argument_bytes"] + low["output_bytes"]

    def test_nothing_captured_is_none(self):
        assert port_profiler.capture_device_stats(self._program(graph=False)) is None
        assert port_profiler.capture_device_stats(object()) is None

    def test_peak_window_is_inert_off_the_card(self):
        from trino_tpu_torch.exec.programs import ProgramPool

        pool = ProgramPool("cpu")
        with port_profiler.PeakWindow(pool) as w:
            pass
        assert w.peak is None and not pool.profile_lock.locked()
        with port_profiler.PeakWindow(None) as w:
            pass
        assert w.peak is None

    def test_record_sets_the_peak_gauge_never_flops(self):
        from trino_tpu_torch.obs.metrics import get_registry
        from trino_tpu_torch.parallel.distributed import DistributedExecutor

        ex = DistributedExecutor.__new__(DistributedExecutor)
        ex.device_stats = {}
        ex._record_device_stats("frag:77", {"peak_hbm_bytes": 5, "temp_bytes": 1}, 2.0)
        ex._record_device_stats("frag:77", None)
        snap = ex.device_stats_snapshot()
        assert snap["programs"]["frag:77"] == {
            "executions": 2, "compile_ms": 2.0, "peak_hbm_bytes": 5, "temp_bytes": 1}
        assert snap["peak_hbm_bytes"] == 5
        text = get_registry().render_prometheus()
        assert 'trino_tpu_program_peak_hbm_bytes{fragment="frag:77"} 5' in text
        assert "trino_tpu_program_flops" not in text


class TestSystemTables:
    def test_runtime_programs_matches_query_counters(self, runner):
        sql = ("select o_orderstatus, sum(o_totalprice) t from "
               "tpch.tiny.orders group by o_orderstatus")
        res = runner.engine.execute_statement(sql, runner.session)
        fp, _ = runner.engine.fingerprint(sql, runner.session)
        assert fp is not None
        rows = [p for p in runner.engine.runtime_programs() if p["fingerprint"] == fp]
        assert rows
        assert rows[0]["misses"] == res.program_cache_misses
        assert rows[0]["hits"] == res.program_cache_hits
        assert rows[0]["compile_ms"] == pytest.approx(res.compile_ms, abs=1.0)
        assert {p["program"] for p in rows} >= {
            label for label in (res.device_stats or {}).get("programs", {})
            if label.startswith(("frag:", "fused:"))
        }
        # the rollup's peak where captured (none on the CPU)
        assert all(p["peak_hbm_bytes"] is None and p["flops"] is None for p in rows)

    def test_runtime_programs_sql(self, runner):
        from trino_tpu_torch.testing import LocalQueryRunner

        runner.engine.execute_statement(Q_AGG, runner.session)
        rows, names = LocalQueryRunner(engine=runner.engine).execute(
            "select fingerprint, program, hits, misses, compile_ms, flops "
            "from system.runtime.programs")
        assert names[0] == "fingerprint" and rows
        assert any(r[1].startswith(("frag:", "fused:")) for r in rows)

    def test_runtime_metrics_sql(self, runner):
        from trino_tpu_torch.testing import LocalQueryRunner

        runner.engine.execute_statement(Q_AGG, runner.session)
        rows, _ = LocalQueryRunner(engine=runner.engine).execute(
            "select name, kind, value from system.runtime.metrics")
        assert rows and {r[1] for r in rows} <= {"counter", "gauge", "histogram"}
        names = {r[0] for r in rows}
        assert any(n.startswith("trino_tpu_program_compile_ms") for n in names)
        assert any(n.startswith("trino_tpu_device_pull_ms") for n in names)
        assert not any(n.startswith("trino_tpu_program_flops") for n in names)

    def test_runtime_tasks_sql_standalone_empty(self, runner):
        from trino_tpu_torch.testing import LocalQueryRunner

        rows, _ = LocalQueryRunner(engine=runner.engine).execute(
            "select task_id, state from system.runtime.tasks")
        assert rows == []


class TestPrometheusConformance:
    def test_histogram_buckets_cumulative_with_inf(self):
        from trino_tpu.obs.metrics import MetricsRegistry as RefRegistry
        from trino_tpu_torch.obs.metrics import MetricsRegistry

        texts = []
        for cls in (RefRegistry, MetricsRegistry):
            reg = cls()
            h = reg.histogram("conf_ms", buckets=(1.0, 10.0, 100.0))
            for v in (0.5, 5.0, 5.0, 50.0, 500.0):
                h.observe(v)
            texts.append(reg.render_prometheus())
        assert texts[0] == texts[1]
        lines = [ln for ln in texts[1].splitlines() if ln.startswith("conf_ms")]
        counts = [int(ln.rsplit(" ", 1)[1]) for ln in lines
                  if ln.startswith("conf_ms_bucket")]
        assert counts == sorted(counts) and counts[-1] == 5
        assert "conf_ms_count 5" in lines

    def test_label_values_escaped(self):
        from trino_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry()
        reg.counter("esc_total", fragment='say "hi"\\path\nnext').inc()
        text = reg.render_prometheus()
        assert 'esc_total{fragment="say \\"hi\\"\\\\path\\nnext"} 1' in text


class TestBoundedRetention:
    def test_span_sink_bounded(self):
        from trino_tpu_torch.obs.trace import InMemorySpanSink, Span

        sink = InMemorySpanSink(max_traces=8)
        for i in range(50):
            sink.record(Span(trace_id=f"q{i}", span_id=f"s{i}", parent_id=None,
                             name="query", start_epoch=0.0))
        assert len(sink.trace_ids()) <= 8 and sink.trace_ids()[-1] == "q49"

    def test_query_cache_and_history_bounded(self, runner):
        eng = runner.engine
        for i in range(5):
            eng.execute_statement(
                f"select count(*) c{i} from tpch.tiny.region where r_regionkey <= {i}",
                runner.session)
        assert len(eng._query_cache) <= eng._QUERY_CACHE_MAX
        assert eng._recent_queries.maxlen is not None
        store = eng.history_store(runner.session)
        assert store is not None and len(store.entries()) <= store.max_entries
